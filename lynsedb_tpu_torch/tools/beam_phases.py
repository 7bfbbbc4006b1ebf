#!/usr/bin/env python3
"""Where K17's walk (csrc/beam_search.cu) spends its cycles, on one CUDA card.

    python3 lynsedb_tpu_torch/tools/beam_phases.py [--batches 1 16 256] [--tiers f32 bf16]
                                                   [--no-prefetch]

Builds an instrumented copy of the kernel into build/beam_phases/ (git
ignores build/): clock64() around each part of a step of the expand-1 walk,
read by the block's first thread (warp 0 expands the nodes) — warp 0's
search for the first open pool entry, its adjacency row and lookups,
the wait at the barrier until the other warps have scored, warp 0's choice
of the next node, its expansion (for a fresh node its adjacency row and
lookups; the inserts, the compaction and, where on, the rows' prefetch),
the wait at the
barrier that closes the other warps' merge, and the step's end — plus the
starts' phase (with the first expansion) before the first step and the
whole walk. Then it walks
tile_times.py's K17 inputs (the 1M mixture, its degree-32 graph, cached in
build/) through the copy in the tiers asked for, at each B, and prints one
JSON line per tier and B: the steps a walk takes (mean and most), cycles a
step in each part, the starts' and the whole walk's kilocycles, and the SM
clock nvidia-smi reads after the run (clock64 counts its cycles) beside one
dependent global load's latency (graph.dependent_load_ms, a pointer chase).
The counters cost a few percent; the parts' shares are the reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "lynsedb_tpu_torch" / "csrc"
OUT = ROOT / "build" / "beam_phases"
PARTS = ("warp0_open_entry", "barrier_after_scoring", "choose", "expand", "merge_barrier",
         "step_end")


def _edit(text: str, edits: list) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


PREFETCH = "        if (a.prefetch) prefetch_node<TIER>(a, nb);\n"


def build(prefetch: bool = True) -> ctypes.CDLL:
    """The instrumented copy as a shared library (``prefetch`` False: without
    the L2 prefetch of the fresh nodes' rows, to weigh it)."""
    kernel = _edit((CSRC / "beam_search.cu").read_text(), [] if prefetch else [(PREFETCH, "")])
    kernel = _edit(kernel, [
        ('#include "metrics.cuh"\n',
         '#include "metrics.cuh"\n__device__ unsigned long long g_clk[12];\n'),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  const int64_t bq = blockIdx.x;\n",
         "  const unsigned long long k_start = clock64();\n"
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  const int64_t bq = blockIdx.x;\n"),
        ("    cur = ctl[2];\n    for (int step = 0; m >= 0; ++step) {\n",
         "    cur = ctl[2];\n    unsigned long long ck[8] = {}, t0 = clock64(), t1 = t0;\n"
         "    ck[6] = t0 - k_start;\n    for (int step = 0; m >= 0; ++step) {\n"
         "      t0 = clock64();\n"),
        ("        score_list<TIER, M, kWarps - 1>(a, qv, qc, list, m, keys, warp, lane);\n"
         "      }\n      __syncthreads();\n",
         "        score_list<TIER, M, kWarps - 1>(a, qv, qc, list, m, keys, warp, lane);\n"
         "      }\n      t1 = clock64();\n      ck[0] += t1 - t0;\n      __syncthreads();\n"
         "      t0 = clock64();\n      ck[1] += t0 - t1;\n"),
        ("        const int node = more ? choose(pk(cb), cnt, ppos, pid, m, keys, list, pos) : -1;\n",
         "        const int node = more ? choose(pk(cb), cnt, ppos, pid, m, keys, list, pos) : -1;\n"
         "        t1 = clock64();\n        ck[2] += t1 - t0;\n"),
        ("        if (node >= 0) mm = expand(nb, fr, nlist);\n",
         "        if (node >= 0) mm = expand(nb, fr, nlist);\n"
         "        t0 = clock64();\n        ck[3] += t0 - t1;\n"),
        ("      const int f = __syncthreads_count(tid < m && keys[tid] > -INFINITY);\n",
         "      const int f = __syncthreads_count(tid < m && keys[tid] > -INFINITY);\n"
         "      t1 = clock64();\n      ck[4] += t1 - t0;\n      ck[7] += 1;\n"),
        ("      int* tl = list;\n      list = nlist;\n      nlist = tl;\n    }\n",
         "      int* tl = list;\n      list = nlist;\n      nlist = tl;\n"
         "      ck[5] += clock64() - t1;\n    }\n    if (tid == 0) {\n"
         "      for (int i = 0; i < 8; ++i) atomicAdd(&g_clk[i], ck[i]);\n"
         "      atomicAdd(&g_clk[8], clock64() - k_start);\n      atomicAdd(&g_clk[9], 1ull);\n"
         "    }\n"),
    ])
    kernel += ('\nextern "C" void lt_beam_clock(unsigned long long* h) {\n'
               "  cudaMemcpyFromSymbol(h, g_clk, sizeof(g_clk));\n"
               "  const unsigned long long z[12] = {};\n"
               "  cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n}\n")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "beam_search.cu").write_text(kernel)
    lib_path = OUT / "libbeam_phases.so"
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(lib_path),
           str(OUT / "beam_search.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 256])
    ap.add_argument("--tiers", nargs="+", default=["f32", "bf16"],
                    choices=("f32", "bf16", "sq8", "pq", "metric"))
    ap.add_argument("--no-prefetch", action="store_true",
                    help="build the copy without the L2 prefetch of the fresh rows (on past one "
                         "block an SM), to weigh it")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from lynsedb_tpu_torch.ops import _cuda, graph
    from tile_times import walk_inputs, walk_queries

    if not torch.cuda.is_available():
        print("beam_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = build(not args.no_prefetch)
    lib.lt_beam_search.argtypes = list(_cuda._SIGNATURES["lt_beam_search"])
    lib.lt_beam_search.restype = ctypes.c_int
    plain_call = _cuda.call

    def call(name: str, *a) -> None:  # the walk through the instrumented copy
        if name != "lt_beam_search":
            return plain_call(name, *a)
        err = lib.lt_beam_search(*a)
        if err:
            raise RuntimeError(f"lt_beam_search: CUDA error {err}")

    _cuda.call = call
    dev = torch.device("cuda")
    x, adj, live, tiers = walk_inputs(dev)
    clk = (ctypes.c_ulonglong * 12)()
    load_ms = graph.dependent_load_ms(dev)
    for b in args.batches:
        q, starts = walk_queries(x, dev, b)
        for tier, kind, beam, targs in tiers:
            if tier not in args.tiers:
                continue
            ops = graph.beam_operands(tier, q, *targs, kind=kind)
            walk = (tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"], adj, starts, live)
            kw = dict(code=graph._KIND_CODE[kind], beam=beam, max_steps=2 * beam, expand=1)
            graph.beam_walk(*walk, **kw)  # warm-up
            torch.cuda.synchronize()
            lib.lt_beam_clock(clk)  # zero the counters
            graph.beam_walk(*walk, **kw)
            torch.cuda.synchronize()
            lib.lt_beam_clock(clk)
            sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
            parts, starts_c, steps, total, blocks = clk[:6], clk[6], clk[7], clk[8], clk[9]
            stats = {}
            graph.beam_walk_plain(*walk, **kw, stats=stats)
            print(json.dumps({
                "tier": tier, "kind": kind, "B": b, "beam": beam, "blocks": blocks,
                "steps_mean": steps / max(blocks, 1), "steps_most": stats["steps"],
                "cycles_a_step": {p: round(v / max(steps, 1), 1) for p, v in zip(PARTS, parts)},
                "kcycles_starts": round(starts_c / max(blocks, 1) / 1e3, 3),
                "kcycles_walk": round(total / max(blocks, 1) / 1e3, 3),
                "dependent_load_ns": round(load_ms * 1e6, 1), "sm_clock": sm,
                "prefetch": not args.no_prefetch,
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

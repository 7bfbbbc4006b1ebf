#!/usr/bin/env python3
"""Where K2's fused first pass (csrc/bf16_centered_topc.cu) spends its
cycles, on one CUDA card.

    python3 lynsedb_tpu_torch/tools/topc_phases.py [--batches 1 16 256] [--c 256]

Builds an instrumented copy of the kernel into build/topc_phases/ (git
ignores build/): clock64() around each phase of a warp's main loop — the
wait for the next stage and the block barrier, the MMA, the epilogue up to
its barrier, and each flush of a candidate list, split into loading the
pending entries, their register sort and the merge into the kept ones.
Then it runs the copy once at each B over a seeded 1,000,000 x 128 mixture
(chip_smoke.py's corpus kind) under IP and prints one JSON line per B: the
spans, the warps, kilocycles a warp in each phase, flushes a warp and
kilocycles a flush. The counters add a few percent to the kernel's time;
the phases' shares, not their sum, are the reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "lynsedb_tpu_torch" / "csrc"
OUT = ROOT / "build" / "topc_phases"


def _edit(text: str, edits: list) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build() -> ctypes.CDLL:
    """The instrumented copy as a shared library."""
    kernel = _edit((CSRC / "bf16_centered_topc.cu").read_text(), [
        ("  uint64_t* lists;         // device lists (null: shared memory)",
         "  unsigned long long* clk;\n  uint64_t* lists;         // device lists (null: shared memory)"),
        ("  for (int s = 0; s < steps; ++s) {\n    cp_async_wait<kStages - 2>();",
         "  unsigned long long c_wait = 0, c_mma = 0, c_epi = 0, t0, t1;\n"
         "  for (int s = 0; s < steps; ++s) {\n    t0 = clock64();\n    cp_async_wait<kStages - 2>();"),
        ("    cp_async_commit();\n    mma_stage<NT>(ring + (s % kStages) * kStageElems, acc);\n",
         "    cp_async_commit();\n    t1 = clock64();\n    c_wait += t1 - t0;\n"
         "    mma_stage<NT>(ring + (s % kStages) * kStageElems, acc);\n    t0 = clock64();\n"
         "    c_mma += t0 - t1;\n"),
        ("    const bool flush_all = __syncthreads_or(full);\n",
         "    const bool flush_all = __syncthreads_or(full);\n    c_epi += clock64() - t0;\n"),
        ("  cp_async_wait<0>();\n  const int64_t ld",
         "  if (lane == 0) {\n    atomicAdd(a.clk + 0, c_wait);\n    atomicAdd(a.clk + 1, c_mma);\n"
         "    atomicAdd(a.clk + 2, c_epi);\n    atomicAdd(a.clk + 3, 1ull);\n  }\n"
         "  cp_async_wait<0>();\n  const int64_t ld"),
        ("               ascending != 0, vec, p.groups, p.ql, p.span_rows, p.kp,",
         "               ascending != 0, vec, p.groups, p.ql, p.span_rows, p.kp, g_clk,"),
        ("extern \"C\" {\n",
         "unsigned long long* g_clk = nullptr;\nextern \"C\" {\n"
         "void lt_set_clk(void* p) { g_clk = (unsigned long long*)p; }\n"
         "void lt_get_flush_clk(unsigned long long* h) {\n"
         "  cudaMemcpyFromSymbol(h, g_fclk, sizeof(g_fclk));\n"
         "  const unsigned long long z[4] = {0, 0, 0, 0};\n"
         "  cudaMemcpyToSymbol(g_fclk, z, sizeof(z));\n}\n"),
    ])
    common = _edit((CSRC / "common.cuh").read_text(), [
        ("namespace lt {", "__device__ unsigned long long g_fclk[4];\nnamespace lt {"),
        ("    if (pend == 0) return;\n    const int lane = threadIdx.x & 31;\n",
         "    if (pend == 0) return;\n    const int lane = threadIdx.x & 31;\n"
         "    const unsigned long long f0 = clock64();\n"),
        ("    warp_sort256(v);\n    if (kp <= 256) {",
         "    const unsigned long long f1 = clock64();\n    warp_sort256(v);\n"
         "    const unsigned long long f2 = clock64();\n    if (kp <= 256) {"),
        ("    kept = min(kept + pend, k);\n    pend = 0;",
         "    if (lane == 0) {\n      atomicAdd(&g_fclk[0], f1 - f0);\n      atomicAdd(&g_fclk[1], f2 - f1);\n"
         "      atomicAdd(&g_fclk[2], clock64() - f2);\n      atomicAdd(&g_fclk[3], 1ull);\n    }\n"
         "    kept = min(kept + pend, k);\n    pend = 0;"),
    ])
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "bf16_centered_topc.cu").write_text(kernel)
    (OUT / "common.cuh").write_text(common)
    lib_path = OUT / "libtopc_phases.so"
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib_path), str(OUT / "bf16_centered_topc.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.lt_bf16_centered_topc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 4
    lib.lt_set_clk.argtypes = [ctypes.c_void_p]
    for name in ("lt_topc_spans", "lt_topc_scratch"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 256])
    ap.add_argument("--c", type=int, default=256, help="the shortlist C")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from lynsedb_tpu_torch.ops import scan
    from lynsedb_tpu_torch.ops.scan import DeviceCorpus

    if not torch.cuda.is_available():
        print("topc_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = build()
    rng = np.random.default_rng(0)
    n, d = 1_000_000, 128
    centers = rng.normal(size=(2000, d)).astype(np.float32)
    x = centers[rng.integers(0, 2000, n)] + 0.6 * rng.normal(size=(n, d)).astype(np.float32)
    corpus = DeviceCorpus(d, device="cuda")
    corpus.append(x)
    valid = corpus.valid_mask()
    aux = corpus.bf16_aux()
    x16 = corpus._dev16
    cap = x16.shape[0]
    clk = torch.zeros(4, dtype=torch.int64, device="cuda")
    lib.lt_set_clk(clk.data_ptr())
    for b in args.batches:
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).cuda()
        qc16, qc_sq, qm, q_sq = scan._query_terms(q, aux["mean"])
        spans = lib.lt_topc_spans(b, cap, d, args.c)
        scratch = lib.lt_topc_scratch(b, cap, d, args.c)
        keys = torch.empty((b, spans * args.c), device="cuda")
        ids = torch.empty((b, spans * args.c), dtype=torch.int32, device="cuda")
        lists = torch.empty(scratch, dtype=torch.int64, device="cuda") if scratch else None
        flush = (ctypes.c_ulonglong * 4)()
        lib.lt_get_flush_clk(flush)  # zero the flush counters
        clk.zero_()
        err = lib.lt_bf16_centered_topc(
            qc16.data_ptr(), x16.data_ptr(), qc_sq.data_ptr(), qm.data_ptr(), q_sq.data_ptr(),
            aux["xm"].data_ptr(), aux["xc_sq"].data_ptr(), aux["xsq_true"].data_ptr(),
            valid.data_ptr(), b, cap, d, args.c, 0, 0, keys.data_ptr(), ids.data_ptr(),
            None if lists is None else lists.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        lib.lt_get_flush_clk(flush)
        wait, mma, epi, warps = (float(v) for v in clk.cpu().numpy())
        load, sort, merge, flushes = (float(v) for v in flush)
        kc = lambda v, per: round(v / max(per, 1.0) / 1e3, 3)  # noqa: E731
        print(json.dumps({
            "B": b, "C": args.c, "spans": spans, "warps": warps,
            "kcycles_a_warp": {"wait": kc(wait, warps), "mma": kc(mma, warps),
                               "epilogue": kc(epi, warps),
                               "flush": kc(load + sort + merge, warps)},
            "flushes_a_warp": round(flushes / warps, 3),
            "kcycles_a_flush": {"load": kc(load, flushes), "sort": kc(sort, flushes),
                                "merge": kc(merge, flushes)},
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

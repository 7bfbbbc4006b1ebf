#!/usr/bin/env python3
"""Device times of the exact f32 tile (K1, K6a), K6c's f32 tile, K11's
shared-list tile, the integer tensor-core tiles (K6b, K12), the k-means
assignment and update (K15a, K15b), the graph walk (K17), the exact top-L
scan (K19), the robust prune (K20), K5's large-k selection, the binary
IVF block scan (K16b), K9's fused bf16 pass and the f32 IVF block scan (K16)
on one CUDA card, at chip_smoke.py's shapes.

    python3 lynsedb_tpu_torch/tools/tile_times.py [--package-root DIR] [--reps N]
                            [--only K1 K6a K6c K11 K6b K12 K15a K15b K17 K19 K20 K5 K16b
                                    K11q K3 K9 K16]
                            [--dump PREFIX] [--compare PREFIX]

K9 over the centred bf16 copy of a 1M x 128 mixture (every tenth row
masked) under L1, Chebyshev, Canberra and Bray-Curtis at B = 1, 16 and 256
and C = 256 and 80: the fused pass where the tree has it, else the
parent's chain, K6c's bf16 tile and K5's select, each also timed alone
(``tile_ms``, ``select_ms``); ``kernel_parts_ms`` splits each call by
kernel; (keys, ids) held to the plain chain and to the other tree's bit for
bit; L1 at C = 256 and B = 1, 2, 4, 8 and 16 with the pilot forced on and
off (``pilot=``). K16 on chip_smoke.py phase 6's IVF-L2 and IVF-IP (its
corpus, built through the client, 1,000 clusters, the postings cached
in build/; nprobe 32, the half filter) at B = 1, 4, 8, 12, 16, 32 and 256:
the scan on the route the batch takes and, where the tree has
``ivf.scan_blocks_route``, on the rows, tile and warp routes apart (the
rows and tile routes' keys bit for bit against each other, the warp
route's within K16's tolerance of them, the batch's own launch bit for bit
against the route it took), K5's select of fetch timed alone, the probe's shape
(max_bpc, slots, the share of empty slots, live rows scored, distinct
blocks, probes a probed block), the keys against the plain version and the
other tree's within K16's tolerance, and the ids after K5 that differ from
the other tree's (each a near-tie).

K5 (``topk.topk_select``) past k = 1,024 over 1,000,000 f32 keys a row
(normal, distinct) at k = 1,280 (the k = 1,000 search's shortlist) for B = 1
and 16 and at k = 4,000 (a quantized search's shortlist at 1M codes) for B
= 1, 16 and 64 (and at 16 with every other key -inf, a half filter), and
over 250,000 keys (a mesh shard's) at k = 4,000 and B = 1, beside
``torch.topk`` and the plain version, with ``kernel_parts_ms``
by kernel (the parent's chunk sort and merge levels, or the radix passes,
compaction and sort); the keys and indices held to the plain version's bit
for bit (max_abs_err 0, else inf), the sign of a zero included. K16b
(``ivf.ivf_binary_blocks``) over an IVF-HAMMING index built as
chip_smoke.py builds its own (1,010,000 ECFP-like rows of 1,024 bits from
2,000 scaffolds, the port's k-means into 1,000 clusters, blocks of 2,048
rows; the k-means cached in build/), every other row filtered out, nprobe =
32 clusters a query (its K6b -> K5 probe), queries from the scaffolds, at B
= 1, 4, 16, 32, 64 and 256, and IVF-JACCARD at 16 and 256, beside the plain
version (no library call), each route of the change timed apart
(``BINARY_TILE_MIN_B`` set to force it), the keys held to the plain
version's bit for bit and their SHA-256 to the other tree's.

K1 under IP over 1,000,000 x 128 f32 rows at B = 1, 16, 17, 64 and 256, beside
``q @ x.T`` (one f32 matmul, the same function without the mask); K6a under
correlation at B = 1, 16 and 256 and under Hellinger at B = 16, beside the
matmul of the transformed rows; K6c's f32 tile mode under L1, Chebyshev,
Canberra and Bray-Curtis over the same rows, Wasserstein and Jensen-Shannon
over them exponentiated (their cdf and probability transforms) and
Haversine over 1,000,000 points uniform on the sphere, each at B = 1, 16 and
256 (Canberra and Jensen-Shannon also at 4 and 8, where their routes cross),
beside ``torch.cdist`` (p=1 for L1, p=inf for Chebyshev; none for the
rest); K11 over a (1, 100,000) row list shared by
every query (every tenth row, as ``where="bucket = 3"`` gives) at B = 1, 16
and 256, beside the two calls ``qc16 @ x16.index_select(0, idx).T`` (a
gather, then a bf16 matmul: no one PyTorch call computes it); K6b under
Tanimoto over 1,000,000 x 1,024-bit rows (10% of the bits set) at B = 1, 16
and 256 and under Jaccard, Dice and Hamming at B = 16, beside the bf16
matmul of the {0, 1} rows; K12 over 1,000,000 x 128 int8 codes (SQ8, RaBitQ,
PolarVec under IP) at B = 1, 16 and 64, beside ``torch._int_mm`` of the
quantized queries and the codes at B = 64 (the dot alone; it takes no fewer
than 17 rows); K15a (``kmeans.kmeans_assign``) on a 1M x 128 mixture at
chip_smoke.py's four shapes (the IVF build's 256,000-row training sample
under L2 and IP and its 1M corpus under L2, K = 1,000; PQ's encode, the 1M
rows' first 8 columns, K = 256) and PQ's training sample (131,072 x 8, K =
256), beside ``x @ c.T`` (the f32 product alone, TF32 off); K17
(``graph.beam_walk``) in its five tiers on a degree-32 Vamana graph over a
1M mixture (cached in build/, so every tree of a call walks the same graph;
f32 under L2 and the metric tier under L1 at beam 100, bf16, SQ8 and PQ
under IP at beam 125) at B = 1, 16 and 256, no library call, its bytes bound
beside ``walk_bound_ms``, the longest walk's steps x two dependent load
latencies (a pointer chase); K15b (``kmeans.kmeans_update``) at the IVF build's Lloyd
step (256,000 rows of a 2,000-cluster mixture, 10% invalid, 1,000
centroids drawn from the rows, D = 128, assigned by ``kmeans_assign``), with
90% of the rows assigned to one centroid, and at PQ's (65,536 x 8 rows, 256
centroids), beside ``index_add_`` of the masked rows and ``torch.bincount``
of the valid rows' assignments (the same sums and counts with float atomics,
in any order); K19 (``graph.topl_scan``, its K5 merge included in ``ms``)
under L2 on a 4,096-query chunk of 1,000,000 x 128 rows at L = 64 (the
HNSW-L2 build's), beside ``torch.topk`` of ``2 q @ x.T - |x|^2`` a block of
131,072 rows at a time, and in its metric mode on 1,024 queries of
1,010,000 x 128 rows at L = 64 under L1 (the HNSW-L1 build's), beside
``torch.cdist(p=1)`` and ``torch.topk`` a block at a time, under
Jensen-Shannon over the rows exponentiated, and under Haversine on 1,024
queries of 1,000,000 points uniform on the sphere (no library call for
either); K20 (``graph.robust_prune``) in its prune mode on 4,096 nodes of
those 1,000,000 x 128 rows, each with its top 64 by K19 and 8 random
candidates (L = 72, r = 32, alpha 1.2: pass A of the HNSW build) under L2,
beside ``torch.bmm`` of the gathered rows (the Gram alone), under L1 (beside
``torch.cdist(p=1)`` of the gathered rows) and Jensen-Shannon over the same
rows (exponentiated) and under Haversine over the 1M points, and in its keys
mode on 1,024 nodes at L = 64 (an insert's shape) under L2. Each time is
the mean of ``--reps`` launches (K19's library calls: 3) between CUDA events
after a warm-up; each bound is chip_smoke.py's, from the same formulas
(``roofline.py`` beside this file: the bytes moved over 3.35 TB/s against
the operations over the f32 (K1, K6a, K19), bf16 (K11) or int8 (K6b, K12)
peak, K19's metric modes over the f32 instruction and special-function
rates). Beside the
event time (which includes the wrapper's own small PyTorch ops and, where the
host enqueues slower than the card runs, the host), ``kernel_ms`` is the
device time of the hand-written kernel alone per launch, from torch.profiler.
Each row also carries the largest error against the kernel's plain version
on the same inputs.

``--package-root DIR`` imports lynsedb_tpu_torch from DIR (an older commit
unpacked with ``git archive``), so parent and change are timed on one card
in one call. ``--dump PREFIX`` writes K19's keys and ids, K20's candidates
and outputs, K6c's keys (as their SHA-256), K15a's indices, K15b's four
outputs and K17's keys, ids and scanned at each shape to
PREFIX_<shape>.npz; ``--compare PREFIX`` reads another tree's and adds to
each K19 row whether the keys are equal to the bit and the ids equal (or
differ only between equal keys), and to each K6c, K15a, K15b, K17 and K20
row whether its outputs (and K20's candidates) are equal to the bit. Prints
the card's name and power limit, then one JSON line per kernel and shape.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# roofline.py sits beside this script (sys.path[0]), so this tree's formulas
# hold whichever --package-root is timed
from roofline import (assign_bound, binary_probe_bound, binary_tile_bound, code_scan_bound,
                      elem_tile_bound, elem_topc_bound, f32_tile_bound, gather_topc_bound,
                      ivf_probe_bound, kmeans_update_bound, prune_bound, rescore_bound,
                      select_bound, shared_list_bound, topl_bound, walk_bound, walk_bytes_bound)

N, DIM, SHARED_EVERY = 1_000_000, 128, 10
BITS_DIM, BITS_DENSITY = 1024, 0.1
TOPL_CHUNK, TOPL_L, TOPL_METRIC_CHUNK, TOPL_METRIC_N = 4096, 64, 1024, 1_010_000
# K19's Haversine keys: f32 instructions and special-function operations a
# pair (both points' radians and cosines formed for each pair)
HAVERSINE_OPS = (12, 6)
PRUNE_NODES, PRUNE_EXTRA, PRUNE_R, KEYS_NODES = 4096, 8, 32, 1024
KERNELS = ("K1", "K6a", "K6c", "K11", "K6b", "K12", "K15a", "K15b", "K17", "K19", "K20", "K5",
           "K16b", "K11q", "K3", "K9", "K16")
# the kernels' names, this tree's and earlier ones' (torch.profiler keys)
K1_NAMES, K11_NAMES = ("f32_tile_kernel", "tile_scores_kernel"), ("shared_list_kernel",
                                                                  "bf16_gather_kernel")
K6B_NAMES = ("int_tile_kernel", "binary_tile_kernel")
K12_NAMES = ("int_tile_kernel", "int8_scores_kernel", "quantize_queries_kernel")
K19_NAMES = ("topl_kernel",)
K20_NAMES = ("prune_kernel",)
K6C_NAMES = ("elem_f32_kernel", "haversine_tile_kernel", "elem_tile_kernel", "haversine_kernel")
K15B_NAMES = ("count_kernel", "scan_kernel", "scatter_kernel", "sum_kernel",
              "kmeans_update_kernel")
K15A_NAMES = ("assign_fma_kernel", "assign_small_kernel", "kmeans_assign_kernel")
K17_NAMES = ("beam_kernel",)
K5_NAMES = ("radix_count_kernel", "radix_compact_kernel", "radix_sort_kernel", "sort_chunk_kernel",
            "merge_runs_kernel", "Memset")
K16B_NAMES = ("ivf_binary_tile_kernel", "ivf_binary_rows_kernel", "ivf_binary_blocks_kernel")
# K16b: an IVF-HAMMING layout of the 1M fingerprints' size (chip_smoke.py
# phase 10: 1,010,000 rows, 1,000 clusters, nprobe 32), 10% of rows deleted
PROBE_N, PROBE_SCAFFOLDS, PROBE_CLUSTERS, PROBE_NPROBE = 1_010_000, 2000, 1000, 32
PROBE_CACHE = Path(__file__).resolve().parents[2] / "build" / "tile_times_probe_kmeans.npz"
KM_N, KM_K, KM_CENTERS, PQ_N, PQ_K, PQ_D = 256_000, 1000, 2000, 65_536, 256, 8
PQ_TRAIN = 131_072  # ops/quantize.py PQ.TRAIN_SAMPLE
# K17: a Vamana graph of degree 32 (HNSW's layer 0 at m = 16) over the 1M
# mixture, kept under build/ once built (every tree of a call walks the same
# graph); per-query starts, each query's 8 nearest of a 4,096-node sample
WALK_R, WALK_L, WALK_SAMPLE, WALK_STARTS = 32, 64, 4096, 8
WALK_CACHE = Path(__file__).resolve().parents[2] / "build" / "tile_times_walk_graph.npy"
# K11q: a quantized search's second stage at 1M codes and k = 10 (S = 4,000,
# C = 64), at the query slices; K3 at the two-pass plan's shortlists
SHORTLIST_S, SHORTLIST_C, SHORTLIST_B = 4000, 64, (1, 16, 64)
# K9: the centred bf16 copy of a 1M x 128 mixture, every tenth row masked,
# at the callers' C: 256 (the host-rescore tier's and K8's shortlist at 1M
# rows) and 80 (the approximate plan's k x oversample)
ELEM_TOPC_C, ELEM_TOPC_B = (256, 80), (1, 16, 256)
ELEM_TOPC_PILOT_B = (1, 2, 4, 8, 16)  # K9's pilot on and off, L1 at C = 256
# K16: chip_smoke.py phase 6's IVF-L2 and IVF-IP (its corpus, 1,000
# clusters, nprobe 32, the half filter, k = 10), the port's k-means cached
# in build/ so every tree of a call scans the same index
IVF_CLUSTERS, IVF_NPROBE, IVF_K = 1000, 32, 10
IVF_B = (1, 4, 8, 12, 16, 32, 256)
IVF_CACHE = Path(__file__).resolve().parents[2] / "build" / "tile_times_ivf_{}.npz"
RESCORE_CASES = [(c, b, k, m) for c, k in ((64, 10), (256, 10), (1280, 1000))
                 for b, m in ((1, "ip"), (16, "ip"), (256, "ip"), (16, "l2"), (16, "cosine"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--dump", help="write K6c's, K15a's, K15b's, K17's, K19's and K20's "
                                   "outputs to PREFIX_<shape>.npz")
    ap.add_argument("--compare", help="hold those outputs to another tree's PREFIX_<shape>.npz")
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("tile_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output", flush=True)

    def ms(fn, reps: int | None = None) -> float:
        reps = args.reps if reps is None else reps
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_ms(fn, names: tuple) -> dict:
        """Device ms a launch of each kernel whose name holds one of ``names``."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for ev in prof.key_averages():
            # names None: every kernel of the call by its name (a split of the call;
            # the operators' and the runtime's own events left out)
            if names is None:
                hit = None if ev.key.startswith(("aten::", "cuda", "Activity")) else ev.key[:72]
            else:
                hit = next((n for n in names if n in ev.key), None)
            if hit and getattr(ev, "self_device_time_total", 0.0):
                parts[hit] = parts.get(hit, 0.0) + ev.self_device_time_total / 1e3 / args.reps
        return parts

    def row(kernel, shape, fn, library, bnd, err, names, library_reps=None, plain=None,
            plain_reps=None, **extra):
        parts = kernel_ms(fn, names)
        if len(parts) > 1:
            extra["kernel_parts_ms"] = parts
        if plain is not None:
            extra["plain_ms"] = ms(plain, plain_reps)
        print(json.dumps({"package": str(args.package_root), "kernel": kernel, "shape": shape,
                          "ms": ms(fn), "kernel_ms": sum(parts.values()) if parts else None,
                          "library_ms": None if library is None else ms(library, library_reps),
                          "bound_ms": bnd[0], "bound_by": bnd[1],
                          "max_abs_err": err, **extra}), flush=True)

    if {"K1", "K6a", "K11"} & set(args.only):
        float_rows(args.only, row, dev)
    if "K6c" in args.only:
        elem_rows(row, dev, args.dump, args.compare)
    if "K6b" in args.only:
        binary_rows(row, dev)
    if "K12" in args.only:
        code_rows(row, dev)
    if "K15a" in args.only:
        assign_rows(row, dev, args.dump, args.compare)
    if "K15b" in args.only:
        kmeans_rows(row, dev, args.dump, args.compare)
    if "K17" in args.only:
        walk_rows(row, dev, args.dump, args.compare)
    if "K19" in args.only:
        topl_rows(row, dev, args.dump, args.compare)
    if "K20" in args.only:
        prune_rows(row, dev, args.dump, args.compare)
    if "K5" in args.only:
        select_rows(row, dev, args.dump, args.compare)
    if "K16b" in args.only:
        probe_rows(row, dev, args.dump, args.compare)
    if "K11q" in args.only:
        shortlist_rows(row, dev, args.dump, args.compare)
    if "K3" in args.only:
        rescore_rows(row, dev, args.dump, args.compare)
    if "K9" in args.only:
        elem_topc_rows(row, ms, dev, args.dump, args.compare)
    if "K16" in args.only:
        ivf_rows(row, ms, dev, args.dump, args.compare)
    return 0


def float_rows(only, row, dev) -> None:
    """K1 and K6a over 1M x 128 f32 rows, K11 over its shared list."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(N, DIM)).astype(np.float32)
    corpus = scan.DeviceCorpus(DIM, device=dev)
    corpus.append(x_np)
    x32, x16, aux = corpus._data[:N], corpus.data16[:N], corpus.bf16_aux()
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for b in (1, 16, 17, 64, 256) if "K1" in only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x32, None, None, live, Metric.IP)
        err = float((scan.flat_scores_f32(*a) - scan.flat_scores_f32_plain(*a)).abs().max())
        row("K1 flat_scores_f32", f"IP 1M x 128 B={b}", lambda: scan.flat_scores_f32(*a),
            lambda: q @ x32.T, f32_tile_bound(b, DIM, N, N), err, K1_NAMES)
    hist = torch.exp(0.5 * x32)
    for metric, rows, batches in ((Metric.CORRELATION, x32, (1, 16, 256)),
                                  (Metric.HELLINGER, hist, (16,))):
        if "K6a" not in only:
            break
        ct = D.corpus_transform(rows, metric)
        for b in batches:
            qt = D.query_transform(rows[:b] + 0.01, metric)
            lead, ql = scan._gemm_rows(ct, metric), scan._gemm_rows(qt, metric)
            got = scan.gemm_metric_scores(qt, ct, live, metric)
            want = scan.metric_keys_plain(qt, ct, live, metric)
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            row("K6a gemm_metric_scores", f"{metric.value} 1M x 128 B={b}",
                lambda: scan.gemm_metric_scores(qt, ct, live, metric), lambda: ql @ lead.T,
                f32_tile_bound(b, DIM, N, N, 8 if metric is Metric.CORRELATION else 5), err,
                K1_NAMES)
            del got, want
    idx = torch.arange(3, N, SHARED_EVERY, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(idx.shape, device=dev)
    s = idx.shape[1]
    # a tree older than the wrapper's `shared` flag takes any (1, S) list as shared
    kw = {"shared": True} if "shared" in inspect.signature(scan.bf16_gather_scores).parameters \
        else {}
    for b in (1, 16, 256) if "K11" in only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x16, aux, idx, slot, Metric.IP)
        got, want = scan.bf16_gather_scores(*a, **kw), scan.bf16_gather_scores_plain(*a, **kw)
        err = float((got - want).abs().max())
        qc16 = scan._query_terms(q, aux["mean"])[0]
        row("K11 bf16_gather_scores", f"IP shared S={s} B={b}",
            lambda: scan.bf16_gather_scores(*a, **kw),
            lambda: qc16 @ x16.index_select(0, idx[0]).T, shared_list_bound(b, DIM, s), err,
            K11_NAMES)


def held(dump, compare, tag: str, arrays: dict) -> dict:
    """Writes ``arrays`` to DUMP_<tag>.npz; with ``compare``, whether each
    equals (bits_equal) the other tree's at COMPARE_<tag>.npz."""
    if dump:
        np.savez(f"{dump}_{tag}.npz", **arrays)
    if not compare:
        return {}
    other = np.load(f"{compare}_{tag}.npz")
    return {"equal_to_other_tree": all(bits_equal(v, other[k]) for k, v in arrays.items())}


def elem_rows(row, dev, dump, compare) -> None:
    """K6c's f32 tile mode over 1M x 128 rows (every row live) under its six
    metrics with a per-dimension term and Haversine over 1M points, at B =
    1, 16 and 256; the keys' SHA-256 held to another tree's."""
    import hashlib

    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(N, DIM)).astype(np.float32)).to(dev)
    hist = torch.exp(0.5 * x)
    lon = rng.uniform(-180.0, 180.0, N)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, N)))
    geo = torch.from_numpy(np.stack([lon, lat], 1).astype(np.float32)).to(dev)
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for metric, rows in ((Metric.L1, x), (Metric.CHEBYSHEV, x), (Metric.CANBERRA, x),
                         (Metric.BRAY_CURTIS, x), (Metric.WASSERSTEIN, hist),
                         (Metric.JENSEN_SHANNON, hist), (Metric.HAVERSINE, geo)):
        ct = D.corpus_transform(rows, metric)
        lead = scan._elem_rows(ct, metric)
        extra = {Metric.WASSERSTEIN: 5, Metric.JENSEN_SHANNON: 9}.get(metric, 0)
        rolled = metric in (Metric.CANBERRA, Metric.JENSEN_SHANNON)  # where the routes cross
        for b in (1, 4, 8, 16, 256) if rolled else (1, 16, 256):
            qt = D.query_transform(rows[1000 : 1000 + b], metric)
            got = scan.elementwise_scores(qt, ct, live, metric)
            want = scan.metric_keys_plain(qt, ct, live, metric)
            fin = torch.isfinite(want)
            same_inf = torch.equal(torch.isinf(got), torch.isinf(want))
            err = float((got[fin] - want[fin]).abs().max()) if same_inf else float("inf")
            sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
            del got, want, fin
            ql = scan._elem_rows(qt, metric)
            p = {Metric.L1: 1.0, Metric.CHEBYSHEV: float("inf")}.get(metric)
            library = None if p is None else (lambda ql=ql, lead=lead, p=p:
                                               torch.cdist(ql, lead, p=p))
            row("K6c elementwise_scores", f"{metric.value} 1M x {lead.shape[1]} B={b}",
                lambda: scan.elementwise_scores(qt, ct, live, metric), library,
                elem_tile_bound(metric.value, b, lead.shape[1], N, N, extra), err, K6C_NAMES,
                library_reps=3 if b == 256 else None, keys_sha256=sha,
                **held(dump, compare, f"K6c_{metric.value}_{b}", {"sha256": np.array(sha)}))


def kmeans_rows(row, dev, dump, compare) -> None:
    """K15b at the IVF build's Lloyd step, with a skewed assignment, and at
    PQ's; each output held to the plain version (sums' largest error), to a
    second run (bits) and to another tree's (bits)."""
    import torch

    from lynsedb_tpu_torch.ops import kmeans

    rng = np.random.default_rng(6)
    centers = rng.normal(size=(KM_CENTERS, DIM)).astype(np.float32)
    x_np = centers[rng.integers(0, KM_CENTERS, KM_N)] + 0.6 * rng.normal(
        size=(KM_N, DIM)).astype(np.float32)
    data = torch.from_numpy(x_np).to(dev)
    cent = data[torch.from_numpy(rng.choice(KM_N, KM_K, replace=False)).to(dev)].clone()
    valid = torch.arange(KM_N, device=dev) < KM_N - KM_N // 10
    assign = kmeans.kmeans_assign(data, cent, False)
    skew = torch.where(torch.from_numpy(rng.random(KM_N) < 0.9).to(dev), 0, assign).to(torch.int32)
    pq = torch.from_numpy(rng.normal(size=(PQ_N, PQ_D)).astype(np.float32)).to(dev)
    pq_cent = pq[torch.from_numpy(rng.choice(PQ_N, PQ_K, replace=False)).to(dev)].clone()
    pq_valid = torch.ones(PQ_N, dtype=torch.bool, device=dev)
    cases = [("ivf", data, valid, assign, cent), ("skew90", data, valid, skew, cent),
             ("pq", pq, pq_valid, kmeans.kmeans_assign(pq, pq_cent, False), pq_cent)]
    for tag, x, ok, a, c in cases:
        n, d = x.shape
        k = c.shape[0]
        first = kmeans.kmeans_update(x, ok, a, c)
        second = kmeans.kmeans_update(x, ok, a, c)
        want = kmeans.kmeans_update_plain(x, ok, a, c)
        err = float((first[0] - want[0]).abs().max())
        repeat = all(torch.equal(u, v) for u, v in zip(first, second))
        counts = torch.equal(first[1], want[1])
        sums, a64, w = torch.zeros_like(c), a.long(), x * ok[:, None]
        weights = ok.to(torch.float32)

        def library(sums=sums, a64=a64, w=w, weights=weights, k=k):
            sums.index_add_(0, a64, w)
            torch.bincount(a64, weights=weights, minlength=k)

        outs = {name: t.cpu().numpy() for name, t in zip(("sums", "counts", "new", "moves"), first)}
        row("K15b kmeans_update", f"{tag} N={n} K={k} D={d}",
            lambda: kmeans.kmeans_update(x, ok, a, c), library,
            kmeans_update_bound(n, k, d, int(ok.sum())), err, K15B_NAMES,
            bit_identical_rerun=repeat, counts_equal_plain=counts,
            largest_cluster=int(torch.bincount(a64[ok], minlength=k).max()),
            **held(dump, compare, f"K15b_{tag}", outs))
        del first, second, want


def mixture(rng, n: int) -> np.ndarray:
    """n x 128 rows of a seeded mixture of KM_CENTERS gaussian clusters
    (spread 0.6, chip_smoke.py's corpus), made in blocks."""
    centers = rng.normal(size=(KM_CENTERS, DIM)).astype(np.float32)
    out = np.empty((n, DIM), dtype=np.float32)
    for lo in range(0, n, 1 << 18):
        m = min(1 << 18, n - lo)
        out[lo : lo + m] = centers[rng.integers(0, KM_CENTERS, m)] + 0.6 * rng.normal(
            size=(m, DIM)).astype(np.float32)
    return out


def assign_rows(row, dev, dump, compare) -> None:
    """K15a at chip_smoke.py's shapes (the IVF build's training sample of
    256,000 rows under L2 and IP and the 1M corpus under L2, K = 1,000, D =
    128; PQ's encode, 1M x 8, K = 256) and PQ's training sample (131,072 x 8,
    K = 256), beside ``x @ c.T`` (the f32 product alone, TF32 off). The
    indices are held to the plain version (``max_abs_err``: the largest gap
    between the plain scores of the two picks where they differ) and to
    another tree's (bits)."""
    import torch

    from lynsedb_tpu_torch.ops import kmeans

    rng = np.random.default_rng(7)
    x = torch.from_numpy(mixture(rng, N)).to(dev)
    cent = x[torch.from_numpy(rng.choice(N, KM_K, replace=False)).to(dev)].clone()
    sub = x[:, :PQ_D].contiguous()
    pq_cent = sub[torch.from_numpy(rng.choice(N, PQ_K, replace=False)).to(dev)].clone()
    for tag, data, c, ip in (("L2", x[:KM_N], cent, False), ("IP", x[:KM_N], cent, True),
                             ("L2", x, cent, False), ("L2", sub, pq_cent, False),
                             ("L2", sub[:PQ_TRAIN], pq_cent, False)):
        n, d = data.shape
        k = c.shape[0]
        got = kmeans.kmeans_assign(data, c, ip)
        want = kmeans.kmeans_assign_plain(data, c, ip)
        diff = torch.nonzero(got != want).flatten()
        err = 0.0
        if len(diff):
            sub_rows = data[diff]
            s = kmeans._ip_scores(sub_rows, c) if ip else kmeans._l2_scores(
                sub_rows, c, (c * c).sum(-1))
            pick = lambda i: s.gather(1, i[diff].long()[:, None])[:, 0]  # noqa: E731
            err = float((pick(got) - pick(want)).abs().max())
        shape = f"{tag} N={n} K={k} D={d}"
        row("K15a kmeans_assign", shape, lambda: kmeans.kmeans_assign(data, c, ip),
            lambda: data @ c.T, assign_bound(n, k, d, ip), err, K15A_NAMES,
            library_reps=3 if n == N and d == DIM else None, rows_differ_from_plain=len(diff),
            **held(dump, compare, f"K15a_{tag}_{n}_{k}_{d}", {"ids": got.cpu().numpy()}))
        del got, want


def walk_inputs(dev):
    """K17's inputs on the card: the 1M mixture, a degree-32 Vamana graph
    over it (built once into WALK_CACHE), every row live, and each guidance
    tier's (tier, kind, beam, beam_operands args): f32 under L2 and the
    metric tier under L1 at beam 100, bf16, SQ8 and PQ under IP at beam 125
    (DiskANN-IP's), the codes fitted as DiskANN fits them."""
    import torch

    from lynsedb_tpu_torch.index.diskann import _pq_row_terms
    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import graph, quantize, scan

    rng = np.random.default_rng(8)
    x_np = mixture(rng, N)
    x = torch.from_numpy(x_np).to(dev)
    if WALK_CACHE.exists():
        adj_np = np.load(WALK_CACHE)
    else:
        adj_np = graph.build_vamana(x, Metric.L2, r=WALK_R, l_build=WALK_L)
        WALK_CACHE.parent.mkdir(parents=True, exist_ok=True)
        np.save(WALK_CACHE, adj_np)
    adj = torch.from_numpy(np.ascontiguousarray(adj_np, dtype=np.int32)).to(dev)
    corpus = scan.DeviceCorpus(DIM, device=dev)
    corpus.append(x_np)
    aux = corpus.bf16_aux()
    sq = quantize.SQ8.fit(x_np)
    row_sq = (x_np.astype(np.float64) ** 2).sum(1).astype(np.float32)
    pq = quantize.PQ.fit(x_np[rng.choice(N, PQ_TRAIN, replace=False)], device=dev)
    pq_codes = pq.encode(x_np, device=dev)
    alpha, pq_row_sq = _pq_row_terms(pq, x_np, pq_codes)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tiers = [("f32", "l2", 100, (x,)),
             ("bf16", "ip", 125, (corpus.data16[:N], aux["mean"], aux["xm"][:N],
                                  aux["xc_sq"][:N], aux["xsq_true"][:N])),
             ("sq8", "ip", 125, (t(sq.encode(x_np)), t(sq.lo), t(sq.scale), t(row_sq))),
             ("pq", "ip", 125, (t(pq_codes), t(pq.codebooks), t(alpha), t(pq_row_sq))),
             ("metric", Metric.L1.value, 100, (graph.graph_space(x, Metric.L1),))]
    return x, adj, torch.ones(N, dtype=torch.bool, device=dev), tiers


def walk_queries(x, dev, b: int):
    """b mixture queries (seeded by b) and their (b, WALK_STARTS) starts:
    each query's nearest nodes of a WALK_SAMPLE-node entry sample."""
    import torch

    from lynsedb_tpu_torch.ops import graph

    sample = torch.from_numpy(graph.entry_sample_ids(N, WALK_SAMPLE)).to(dev)
    q = torch.from_numpy(mixture(np.random.default_rng(100 + b), b)).to(dev)
    near = torch.cdist(q, x[sample.long()]).topk(WALK_STARTS, dim=1, largest=False).indices
    return q, sample[near].to(torch.int32).contiguous()


def walk_rows(row, dev, dump, compare) -> None:
    """K17 in its five tiers (walk_inputs), 2 x beam steps at most, expand 1,
    at B = 1, 16 and 256; keys, ids and scanned held to the plain version on
    the card (``max_abs_err`` 0, else inf) and to another tree's (bits).
    Beside the bytes bound, ``walk_bound_ms``: the longest walk's steps (the
    plain version's lockstep count) x two dependent load latencies, timed by
    a pointer chase where the tree has one (``load_ms``)."""
    import torch

    from lynsedb_tpu_torch.ops import graph

    x, adj, live, tiers = walk_inputs(dev)
    load_ms = graph.dependent_load_ms(dev) if hasattr(graph, "dependent_load_ms") else None
    counts_steps = "stats" in inspect.signature(graph.beam_walk_plain).parameters
    for b in (1, 16, 256):
        q, starts = walk_queries(x, dev, b)
        for tier, kind, beam, args in tiers:
            ops = graph.beam_operands(tier, q, *args, kind=kind)
            walk = (tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"], adj, starts, live)
            kw = dict(code=graph._KIND_CODE[kind], beam=beam, max_steps=2 * beam, expand=1)
            got = graph.beam_walk(*walk, **kw)
            stats = {}
            want = graph.beam_walk_plain(*walk, **kw, **({"stats": stats} if counts_steps else {}))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            rb = ops["rows"].shape[1] * ops["rows"].element_size() + 4 * sum(
                a is not None for a in ops["aux"])
            bnd = walk_bytes_bound(int(got[2].sum()), rb, int((got[0] > float("-inf")).sum()),
                                   WALK_R, b, beam, DIM)
            extra = {"steps": stats.get("steps"), "load_ms": load_ms,
                     "scanned_mean": float(got[2].float().mean())}
            if load_ms is not None and "steps" in stats:
                extra["walk_bound_ms"] = walk_bound(stats["steps"], load_ms)[0]
            outs = {"keys": got[0].cpu().numpy(), "ids": got[1].cpu().numpy(),
                    "scanned": got[2].cpu().numpy()}
            row("K17 beam_search", f"{tier} {kind} B={b} beam={beam}",
                lambda: graph.beam_walk(*walk, **kw), None, bnd, 0.0 if same else float("inf"),
                K17_NAMES, **extra, **held(dump, compare, f"K17_{tier}_{b}", outs))
            del got, want


def binary_rows(row, dev) -> None:
    """K6b's tile mode over 1M x 1,024-bit rows, every row live."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    words = D.words_for(BITS_DIM)
    parts = [D.corpus_transform((torch.rand((min(1 << 16, N - lo), BITS_DIM), generator=gen,
                                            device=dev) < BITS_DENSITY).float(), Metric.TANIMOTO)
             for lo in range(0, N, 1 << 16)]
    ct = {leaf: torch.cat([p[leaf] for p in parts]) for leaf in ("bits", "cnt")}
    bits = ct["bits"]
    del parts
    x01 = torch.empty((N, 32 * words), dtype=torch.bfloat16, device=dev)
    for lo in range(0, N, 1 << 16):
        x01[lo : lo + (1 << 16)] = D.unpack_bits(bits[lo : lo + (1 << 16)])
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for metric, b in ((Metric.TANIMOTO, 1), (Metric.TANIMOTO, 16), (Metric.TANIMOTO, 256),
                      (Metric.JACCARD, 16), (Metric.DICE, 16), (Metric.HAMMING, 16)):
        q = (torch.rand((b, BITS_DIM), generator=gen, device=dev) < BITS_DENSITY).float()
        qt = D.query_transform(q, metric)
        got = scan.binary_scores(qt, ct, live, metric)
        want = scan.metric_keys_plain(qt, ct, live, metric)
        # the keys are equal to the bit, or the error is reported as inf
        err = 0.0 if torch.equal(got, want) else float("inf")
        del got, want
        q01 = D.unpack_bits(qt["bits"]).to(torch.bfloat16)
        row("K6b binary_scores", f"{metric.value} 1M x {BITS_DIM} bits B={b}",
            lambda: scan.binary_scores(qt, ct, live, metric), lambda: q01 @ x01.T,
            binary_tile_bound(b, words, N, N), err, K6B_NAMES)


def code_rows(row, dev) -> None:
    """K12 over 1M x 128 int8 codes under IP, every row live."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import quantize

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    signs = torch.from_numpy(quantize.rotation_signs(DIM, 1234)).to(dev)
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for kind in ("sq8", "rabitq", "polarvec"):
        codes = torch.randint(-127, 128, (N, DIM), generator=gen, device=dev, dtype=torch.int8)
        st = {"row_sq": torch.rand(N, generator=gen, device=dev) * 100 + 1.0}
        if kind == "sq8":
            st.update(codes=codes, lo=torch.rand(DIM, generator=gen, device=dev) - 2.0,
                      scale=torch.rand(DIM, generator=gen, device=dev) * 0.02 + 1e-3)
        elif kind == "rabitq":
            st.update(bits=codes, alpha=torch.rand(N, generator=gen, device=dev) * 0.1 + 0.05)
        else:
            st.update(codes=codes, lo=-0.3 * torch.rand(N, generator=gen, device=dev),
                      scale=torch.rand(N, generator=gen, device=dev) * 0.04 + 1e-3)
        row_bytes = {"sq8": 0, "rabitq": 4, "polarvec": 8}[kind]  # IP's per-row terms
        for b in (1, 16, 64):
            q = torch.randn((b, DIM), generator=gen, device=dev)
            q_rot = None if kind == "sq8" else quantize.rotate(q, signs, DIM)
            args = (kind, q, q_rot, st, live, Metric.IP)
            got, want = quantize.int8_code_scores(*args), quantize.int8_code_scores_plain(*args)
            err = float((got - want).abs().max())
            del got, want
            a = q * st["scale"][None, :] if kind == "sq8" else q_rot
            q_i8 = quantize.quantize_queries(a)[0]
            library = (lambda: torch._int_mm(q_i8, codes.T)) if b > 16 else None
            row("K12 int8_code_scores", f"{kind} IP 1M x {DIM} B={b}",
                lambda: quantize.int8_code_scores(*args), library,
                code_scan_bound(b, DIM, DIM, N, N, row_bytes), err, K12_NAMES)


def against(prefix: str, tag: str, keys: np.ndarray, ids: np.ndarray) -> dict:
    """K19's output held to another tree's at the same shape: the keys equal
    to the bit, the ids equal, or different only where the two keys at that
    position are equal (a tie between rows of equal keys)."""
    other = np.load(f"{prefix}_{tag}.npz")
    same_keys = bool(np.array_equal(keys.view(np.uint32), other["keys"].view(np.uint32)))
    diff = ids != other["ids"]
    return {"keys_equal_to_parent": same_keys, "ids_equal_to_parent": not bool(diff.any()),
            "ids_differ_only_at_equal_keys": bool((keys[diff] == other["keys"][diff]).all())}


def topl_rows(row, dev, dump, compare) -> None:
    """K19 under L2 over 1M x 128 rows (4,096 queries) and in its metric mode
    under L1 and Jensen-Shannon over 1.01M x 128 rows and Haversine over 1M
    points (1,024 queries), L = 64, each query its own row of the corpus
    (masked, as the build does)."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import graph

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(TOPL_METRIC_N, DIM)).astype(np.float32)).to(dev)
    xd = x[:N]
    xsq = (xd * xd).sum(-1)

    def l2_library():
        q = xd[:TOPL_CHUNK]
        for lo in range(0, N, 131072):
            torch.topk(2.0 * (q @ xd[lo : lo + 131072].T) - xsq[None, lo : lo + 131072],
                       TOPL_L, dim=1)

    q_ids = torch.arange(TOPL_CHUNK, dtype=torch.int32, device=dev)
    cases = [("L2", (xd[:TOPL_CHUNK], q_ids, xd, xsq[:TOPL_CHUNK], xsq, N, TOPL_L,
                     graph.TOPL_L2_RAW), l2_library, topl_bound(TOPL_CHUNK, DIM, N, TOPL_L),
              f"L2 chunk={TOPL_CHUNK} N={N} L={TOPL_L}")]
    b, n = TOPL_METRIC_CHUNK, TOPL_METRIC_N
    for metric, rows, ops in ((Metric.L1, x, (2, 0)),
                              (Metric.JENSEN_SHANNON, torch.exp(0.5 * x), (3, 1))):
        space = graph.graph_space(rows, metric)

        def cdist_library(space=space):
            q = space.rows[:b]
            for lo in range(0, n, 131072):
                torch.topk(-torch.cdist(q, space.rows[lo : lo + 131072], p=1), TOPL_L, dim=1)

        row_bytes = DIM * 4 + (12 if space.terms is not None else 0)
        cases.append((metric.value, (space[:b], q_ids[:b], space, None, None, n, TOPL_L,
                                     graph.TOPL_METRIC),
                      cdist_library if metric is Metric.L1 else None,
                      topl_bound(b, DIM, n, TOPL_L, DIM * ops[0], row_bytes, DIM * ops[1]),
                      f"{metric.value} chunk={b} N={n} L={TOPL_L}"))
    lon = rng.uniform(-180.0, 180.0, N)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, N)))
    geo = graph.graph_space(torch.from_numpy(np.stack([lon, lat], 1).astype(np.float32)).to(dev),
                            Metric.HAVERSINE)
    cases.append(("haversine", (geo[:b], q_ids[:b], geo, None, None, N, TOPL_L, graph.TOPL_METRIC),
                  None, topl_bound(b, 2, N, TOPL_L, HAVERSINE_OPS[0], 8, HAVERSINE_OPS[1]),
                  f"haversine chunk={b} N={N} L={TOPL_L}"))
    for tag, a, library, bnd, shape in cases:
        gk, gi = graph.topl_scan(*a)
        wk, _ = graph.topl_scan_plain(*a)
        fin = torch.isfinite(wk)
        err = float((gk[fin] - wk[fin]).abs().max()) if bool(fin.any()) else 0.0
        keys, ids = gk.cpu().numpy(), gi.cpu().numpy()
        del gk, gi, wk, fin
        if dump:
            np.savez(f"{dump}_{tag}.npz", keys=keys, ids=ids)
        extra = against(compare, tag, keys, ids) if compare else {}
        row("K19 topl_scan", shape, lambda: graph.topl_scan(*a), library, bnd, err, K19_NAMES,
            library_reps=3, **extra)


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal to the bit, every NaN counted equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind != "f":
        return bool(np.array_equal(a, b))
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all() and np.array_equal(a[~nan].view(np.uint32),
                                                              b[~nan].view(np.uint32)))


def prune_rows(row, dev, dump, compare) -> None:
    """K20 in its prune mode on 4,096 nodes (each its top 64 by K19 and 8
    random candidates) under L2 and L1 over 1M x 128 rows, Jensen-Shannon
    over them exponentiated and Haversine over 1M points; its keys mode on
    1,024 nodes at L = 64 under L2. Each output is held to the plain
    version's to the bit (max_abs_err 0, else inf)."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import graph

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(N, DIM)).astype(np.float32)).to(dev)
    lon = rng.uniform(-180.0, 180.0, N)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, N)))
    geo = torch.from_numpy(np.stack([lon, lat], 1).astype(np.float32)).to(dev)
    extra = torch.from_numpy(rng.integers(0, N, size=(PRUNE_NODES, PRUNE_EXTRA))
                             .astype(np.int32)).to(dev)
    q_ids = torch.arange(PRUNE_NODES, dtype=torch.int32, device=dev)
    m = TOPL_L + PRUNE_EXTRA + 1
    for metric, rows in ((Metric.L2, x), (Metric.L1, x),
                         (Metric.JENSEN_SHANNON, torch.exp(0.5 * x)), (Metric.HAVERSINE, geo)):
        space = graph.graph_space(rows, metric)
        if metric is Metric.L2:
            sq = (x * x).sum(-1)
            near = graph.topl_scan(x[:PRUNE_NODES], q_ids, x, sq[:PRUNE_NODES], sq, N, TOPL_L,
                                   graph.TOPL_L2_RAW)[1]
            lead, row_bytes = x, DIM * 4
        else:
            near = graph.topl_scan(space[:PRUNE_NODES], q_ids, space, None, None, N, TOPL_L,
                                   graph.TOPL_METRIC)[1]
            lead = space.rows
            row_bytes = lead.shape[1] * 4 + (12 if space.terms is not None else 0)
        cands = torch.cat([near, extra], 1).contiguous()
        kw = dict(metric=metric, r=PRUNE_R, alpha=1.2, descending=False)
        got = graph.robust_prune(space, q_ids, cands, **kw)
        err = 0.0 if torch.equal(got, graph.robust_prune_plain(space, q_ids, cands, **kw)) \
            else float("inf")
        bnd = prune_bound(PRUNE_NODES, m, lead.shape[1], metric.value, r=PRUNE_R,
                          row_bytes=row_bytes)
        gathered = lead[torch.cat([cands, q_ids[:, None]], 1).long()]
        library = {Metric.L2: lambda: torch.bmm(gathered, gathered.transpose(1, 2)),
                   Metric.L1: lambda: torch.cdist(gathered, gathered, p=1)}.get(metric)
        outs = {"cands": cands.cpu().numpy(), "out": got.cpu().numpy()}
        runs = [(f"{metric.value} nodes={PRUNE_NODES} L={m - 1} r={PRUNE_R}", f"K20_{metric.value}",
                 lambda: graph.robust_prune(space, q_ids, cands, **kw), library, bnd, err, outs)]
        if metric is Metric.L2:  # the keys mode at an insert's shape
            link, k_ids = cands[:KEYS_NODES, :TOPL_L].contiguous(), q_ids[:KEYS_NODES]
            gp, gq = graph.robust_prune(x, k_ids, link, metric=metric, keys_only=True)
            wp, wq = graph.robust_prune_plain(x, k_ids, link, metric=metric, keys_only=True)
            outs_k = {"cands": link.cpu().numpy(), "point": gp.cpu().numpy(),
                      "pair": gq.cpu().numpy()}
            same = bits_equal(outs_k["point"], wp.cpu().numpy()) and \
                bits_equal(outs_k["pair"], wq.cpu().numpy())
            runs.append((f"L2 keys nodes={KEYS_NODES} L={TOPL_L}", "K20_keys",
                          lambda: graph.robust_prune(x, k_ids, link, metric=metric,
                                                     keys_only=True), None,
                          prune_bound(KEYS_NODES, TOPL_L + 1, DIM), 0.0 if same else float("inf"),
                          outs_k))
            del gp, gq, wp, wq
        for shape, tag, fn, lib, bnd_, err_, arrays in runs:
            row("K20 robust_prune", shape, fn, lib, bnd_, err_, K20_NAMES,
                **held(dump, compare, tag, arrays))
        del got, gathered, near, cands


def select_rows(row, dev, dump, compare) -> None:
    """K5 past k = 1,024 at the main path's shapes, against the plain
    version bit for bit and beside torch.topk."""
    import torch

    from lynsedb_tpu_torch.ops import topk

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for b, n, k, masked in ((1, N, 1280, False), (16, N, 1280, False), (1, N, 4000, False),
                            (16, N, 4000, False), (64, N, 4000, False), (1, N // 4, 4000, False),
                            (16, N, 4000, True)):
        keys = torch.randn((b, n), generator=gen, device=dev)
        if masked:  # a half filter: every other row at -inf
            keys[:, 1::2] = float("-inf")
        got, want = topk.topk_select(keys, k), topk.topk_select_plain(keys, k)
        same = torch.equal(got[1], want[1]) and torch.equal(got[0].view(torch.int32),
                                                            want[0].view(torch.int32))
        outs = {"keys": got[0].cpu().numpy(), "idx": got[1].cpu().numpy()}
        row("K5 topk_select", f"B={b} N={n} k={k}{' half -inf' if masked else ''}",
            lambda: topk.topk_select(keys, k),
            lambda: torch.topk(keys, k), select_bound(b, n, k), 0.0 if same else float("inf"),
            K5_NAMES, plain=lambda: topk.topk_select_plain(keys, k),
            **held(dump, compare, f"K5_{b}_{n}_{k}{'_masked' if masked else ''}", outs))
        del keys, got, want


def probe_layout(dev):
    """An IVF-HAMMING index as chip_smoke.py phase 10 builds one: PROBE_N
    ECFP-like rows of BITS_DIM bits (one of PROBE_SCAFFOLDS scaffolds at
    BITS_DENSITY with 2% of its bits flipped), the port's k-means (L2 over
    the {0, 1} rows, seed 42) into PROBE_CLUSTERS clusters, the rows posted
    to their cluster in row order and laid out in blocks of 2,048 as
    index/ivf.py's _layout does, with their words and bit counts in block
    order (padding rows zero). The k-means result is cached in build/, so
    every tree of a call times the same index. Returns (cluster_blocks,
    blocks, counts, block_orig, centroids' transform, scaffolds) on ``dev``."""
    import torch

    from lynsedb_tpu_torch.index import ivf
    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops.kmeans import train_kmeans

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    protos = (torch.rand((PROBE_SCAFFOLDS, BITS_DIM), generator=gen, device=dev)
              < BITS_DENSITY).to(torch.uint8)
    rows01 = torch.empty((PROBE_N, BITS_DIM), dtype=torch.uint8, device=dev)
    for lo in range(0, PROBE_N, 1 << 16):
        m = min(1 << 16, PROBE_N - lo)
        pick = torch.randint(0, PROBE_SCAFFOLDS, (m,), generator=gen, device=dev)
        rows01[lo : lo + m] = protos[pick] ^ (torch.rand((m, BITS_DIM), generator=gen,
                                                         device=dev) < 0.02).to(torch.uint8)
    if PROBE_CACHE.exists():
        cached = np.load(PROBE_CACHE)
        centroids, assigns = cached["centroids"], cached["assigns"]
    else:
        centroids, assigns = train_kmeans(rows01.float().cpu().numpy(), PROBE_CLUSTERS, seed=42,
                                          device=dev)
        PROBE_CACHE.parent.mkdir(parents=True, exist_ok=True)
        np.savez(PROBE_CACHE, centroids=centroids, assigns=assigns)
    sizes = np.bincount(assigns, minlength=PROBE_CLUSTERS)
    bpc = -(-sizes // ivf.BLOCK_SIZE)
    cluster_blocks = np.full((PROBE_CLUSTERS, max(int(bpc.max()), 1)), -1, np.int32)
    block_orig = np.full((int(bpc.sum()), ivf.BLOCK_SIZE), -1, np.int32)
    order, at, nb = np.argsort(assigns, kind="stable").astype(np.int32), 0, 0
    for c, n in enumerate(sizes):
        for i in range(int(bpc[c])):
            seg = order[at + i * ivf.BLOCK_SIZE : at + min(n, (i + 1) * ivf.BLOCK_SIZE)]
            block_orig[nb, : len(seg)] = seg
            cluster_blocks[c, i] = nb
            nb += 1
        at += n
    words = D.words_for(BITS_DIM)
    bits = torch.empty((PROBE_N, words), dtype=torch.int32, device=dev)
    cnt = torch.empty(PROBE_N, dtype=torch.float32, device=dev)
    for lo in range(0, PROBE_N, 1 << 16):
        ct = D.corpus_transform(rows01[lo : lo + (1 << 16)].float(), Metric.HAMMING)
        bits[lo : lo + len(ct["cnt"])], cnt[lo : lo + len(ct["cnt"])] = ct["bits"], ct["cnt"]
    del rows01
    flat = torch.from_numpy(block_orig.reshape(-1)).to(dev)
    pad = flat >= 0
    blocks = (bits[flat.clamp_min(0).long()] * pad[:, None]).view(-1, ivf.BLOCK_SIZE, words)
    counts = cnt[flat.clamp_min(0).long()] * pad
    cent = D.corpus_transform(torch.from_numpy(centroids).to(dev), Metric.HAMMING)
    return torch.from_numpy(cluster_blocks).to(dev), blocks.contiguous(), counts, flat, cent, protos


def probe_rows(row, dev, dump, compare) -> None:
    """K16b at B = 1, 4, 16, 32, 64 and 256 under Hamming (and Jaccard at 16
    and 256), against the plain version bit for bit; the change's two
    routes apart."""
    import hashlib

    import torch

    from lynsedb_tpu_torch.index import ivf
    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D

    cluster_blocks, blocks, counts, block_orig, cent, protos = probe_layout(dev)
    w = blocks.shape[2]
    live = torch.arange(PROBE_N, device=dev) % 10 < 5  # chip_smoke.py's half filter
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    routes = [("auto", None)]
    if hasattr(ivf, "BINARY_TILE_MIN_B"):
        routes += [("rows", 1 << 20), ("tile", 1)]
    shapes = [(Metric.HAMMING, b) for b in (1, 4, 16, 32, 64, 256)]
    for metric, b in shapes + [(Metric.JACCARD, 16), (Metric.JACCARD, 256)]:
        pick = torch.randint(0, PROBE_SCAFFOLDS, (b,), generator=gen, device=dev)
        q = (protos[pick] ^ (torch.rand((b, BITS_DIM), generator=gen, device=dev) < 0.02)
             .to(torch.uint8)).float()
        qt = D.query_transform(q, metric)
        top_c = ivf._top_clusters(q, cent, metric, PROBE_NPROBE)
        args = (qt["bits"], qt["cnt"], top_c, cluster_blocks, blocks, counts, block_orig, live,
                metric)
        want = ivf.ivf_scan_blocks_plain(*args)
        slot_blk = cluster_blocks[top_c.long()].reshape(b, -1)
        distinct = torch.unique(slot_blk[slot_blk >= 0]).long()
        orig = block_orig.view(-1, ivf.BLOCK_SIZE)[distinct]
        real = orig >= 0
        n_live = int((real & live[orig.clamp_min(0).long()]).sum())
        bnd = binary_probe_bound(len(distinct), int(real.sum()), n_live, w, want.numel(),
                                 int(torch.isfinite(want).sum()))
        saved = getattr(ivf, "BINARY_TILE_MIN_B", None)
        for route, min_b in routes:
            if min_b is not None:
                ivf.BINARY_TILE_MIN_B = min_b
            try:
                got = ivf.ivf_binary_blocks(*args)
                err = 0.0 if torch.equal(got, want) else float("inf")
                sha = np.frombuffer(hashlib.sha256(got.cpu().numpy().tobytes()).digest(), np.uint8)
                del got
                extra = held(dump, compare, f"K16b_{metric.value}_{b}", {"sha": sha}) \
                    if route == "auto" else {}
                row("K16b ivf_binary_blocks", f"{metric.value} B={b} nprobe={PROBE_NPROBE} "
                    f"route={route}", lambda: ivf.ivf_binary_blocks(*args), None, bnd, err,
                    K16B_NAMES, plain=(lambda: ivf.ivf_scan_blocks_plain(*args))
                    if route == "auto" else None, plain_reps=1 if b > 16 else 3, **extra)
            finally:
                if saved is not None:
                    ivf.BINARY_TILE_MIN_B = saved
        del want

def unfused_stage(q, x16, aux, cand, top, metric, c):
    """The quantized search's second stage as two launches: K11's per-query
    mode writes the (B, S) keys, K5 takes their top C, a gather maps the
    slots to row ids (-1 where the key is -inf)."""
    import torch

    from lynsedb_tpu_torch.ops import scan, topk

    keys = scan.bf16_gather_scores(q, x16, aux, cand, top, metric)
    top2, j = topk.topk_select(keys, min(c, keys.shape[1]))
    return top2, torch.where(top2 > float("-inf"), cand.gather(1, j.long()), -1)


def plain_stage(q, x16, aux, cand, top, metric, c):
    """The second stage's plain version: K11's plain keys, the plain top C,
    the gather."""
    import torch

    from lynsedb_tpu_torch.ops import scan, topk

    keys = scan.bf16_gather_scores_plain(q, x16, aux, cand, top, metric)
    top2, j = topk.topk_select_plain(keys, min(c, keys.shape[1]))
    return top2, torch.where(top2 > float("-inf"), cand.gather(1, j.long()), -1)


def gather_tol(q, aux, ids, metric):
    """chip_smoke.py's check_gather tolerance a (query, row): 1e-5 |q - m|
    |x - m| + 1e-5, over the norms' product under cosine."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric

    safe = ids.clamp_min(0).long()
    tol = 1e-5 * (q - aux["mean"][None, :]).norm(dim=1)[:, None] * torch.sqrt(
        aux["xc_sq"][safe]) + 1e-5
    if metric is Metric.COSINE:
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][safe]).clamp_min(1e-30)
    return tol


def stage_against(q, x16, aux, metric, keys, ids, other: dict | None) -> dict:
    """The stage's keys against the plain keys of the same rows (within
    gather_tol) and, given the other tree's output, the slots that differ
    from it (ids, or keys to the bit, a zero's sign aside) and whether every
    row in one list but not the other is a near-tie: its plain key within
    twice the tolerance of the plain C-th key."""
    import torch

    from lynsedb_tpu_torch.ops import scan

    live = ids >= 0
    plain = scan.bf16_gather_scores_plain(q, x16, aux, ids, None, metric)
    tol = gather_tol(q, aux, ids, metric)
    err = torch.where(live, (keys - plain).abs(), 0.0)
    out = {"max_abs_err": float(err.max()), "within_tol": bool((err <= tol).all())}
    if other is None:
        return out
    o_keys = torch.from_numpy(other["keys"]).to(keys.device)
    o_ids = torch.from_numpy(other["ids"]).to(keys.device)
    differ = (o_ids != ids) | ((o_keys + 0.0).view(torch.int32) != (keys + 0.0).view(torch.int32))
    near = True
    for r in torch.nonzero(differ.any(1)).flatten().tolist():
        swapped = set(ids[r][live[r]].tolist()) ^ set(o_ids[r][o_ids[r] >= 0].tolist())
        if not swapped:
            continue
        rows = torch.tensor(sorted(swapped), dtype=torch.int32, device=keys.device)[None]
        k_rows = scan.bf16_gather_scores_plain(q[r : r + 1], x16, aux, rows, None, metric)[0]
        kth = float(plain[r][live[r]].min())
        t_max = float(torch.where(live[r], tol[r], 0.0).max())
        near &= bool(((k_rows - kth).abs() <= 2 * t_max).all())
    out.update({"slots_differ_from_other_tree": int(differ.sum()),
                "differing_rows_near_ties": near,
                "equal_to_other_tree": not bool(differ.any())})
    return out


def shortlist_rows(row, dev, dump, compare) -> None:
    """A quantized search's second stage after K5's top S = 4,000 of a 1M x
    128 mixture's first-pass keys (its K5 input): the fused launch where the
    tree has one, else the two-launch chain, and in a tree with both the
    chain too (route=unfused); IP, L2 and cosine at B = 1, 16 and 64, C = 64.
    ``kernel_parts_ms`` splits the call by kernel (every launch of it)."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import scan, topk

    rng = np.random.default_rng(11)
    corpus = scan.DeviceCorpus(DIM, device=dev)
    corpus.append(mixture(rng, N))
    x16, aux = corpus.data16, corpus.bf16_aux()
    valid = corpus.valid_mask()
    fused = hasattr(scan, "bf16_gather_topc")
    for metric in (Metric.IP, Metric.L2, Metric.COSINE):
        for b in SHORTLIST_B:
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
            first = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
            top, cand = topk.topk_select_plain(first, SHORTLIST_S)
            del first
            args = (q, x16, aux, cand, top, metric, SHORTLIST_C)
            n_live = int((top > float("-inf")).sum())
            bnd = gather_topc_bound(b, DIM, SHORTLIST_S, SHORTLIST_C, n_live,
                                    2 if metric is Metric.COSINE else 1)
            routes = [("auto", (lambda: scan.bf16_gather_topc(*args)) if fused
                       else (lambda: unfused_stage(*args)))]
            if fused:
                routes.append(("unfused", lambda: unfused_stage(*args)))
            for route, fn in routes:
                keys, ids = fn()
                tag = f"K11q_{metric.value}_{b}"
                other = dict(np.load(f"{compare}_{tag}.npz")) if compare and route == "auto" \
                    else None
                extra = stage_against(q, x16, aux, metric, keys, ids, other)
                if dump and route == "auto":
                    np.savez(f"{dump}_{tag}.npz", keys=(keys + 0.0).cpu().numpy(),
                             ids=ids.cpu().numpy())
                err = extra.pop("max_abs_err")
                row("K11q second stage", f"{metric.value} S={SHORTLIST_S} C={SHORTLIST_C} B={b} "
                    f"route={route}", fn, None, bnd, err, None,
                    plain=(lambda: plain_stage(*args)) if route == "auto" else None,
                    plain_reps=3, **extra)
                del keys, ids


def rescore_rows(row, dev, dump, compare) -> None:
    """K3 over 1M x 128 f32 mixture rows: shortlists of C = 64 and 256 (k =
    10) and 1,280 (k = 1,000: the route through K5) of random rows, keys
    descending, at B = 1, 16 and 256 under IP and at B = 16 under L2 and
    cosine, beside the plain version; where the tree chooses K3's block
    width (``_rescore_wide``), each width under IP apart (256 and 1,024
    threads, up to RESCORE_SORT_MAX slots). The distances and ids are held
    to the other tree's bit for bit."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import scan

    rng = np.random.default_rng(12)
    x32 = torch.from_numpy(mixture(rng, N)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for c, b, k, name in RESCORE_CASES:
        metric = Metric(name)
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        cand = torch.randint(0, N, (b, c), generator=gen, device=dev, dtype=torch.int32)
        keys = torch.sort(torch.randn((b, c), generator=gen, device=dev), dim=1,
                          descending=True).values
        args = (q, x32, keys, cand, k, metric)
        got_d, got_i = scan.rescore_topk(*args)
        want_d, want_i = scan.rescore_topk_plain(*args)
        fin = torch.isfinite(want_d)
        err = float((got_d[fin] - want_d[fin]).abs().max()) if bool(fin.any()) else 0.0
        routes = [("auto", {})]
        if hasattr(scan, "_rescore_wide") and c <= scan.RESCORE_SORT_MAX and name == "ip":
            routes += [("narrow", {"wide": False}), ("wide", {"wide": True})]
        for route, kw in routes:
            d_r, i_r = scan.rescore_topk(*args, **kw)
            same = bits_equal(d_r.cpu().numpy(), got_d.cpu().numpy()) and torch.equal(i_r, got_i)
            extra = held(dump, compare, f"K3_{name}_{c}_{b}",
                         {"d": got_d.cpu().numpy(), "i": got_i.cpu().numpy()}) \
                if route == "auto" else {"equal_to_auto_route": same}
            if route == "auto" and hasattr(scan, "_rescore_wide"):
                extra["wide"] = scan._rescore_wide(b, c)
            row("K3 rescore_topk", f"{name} C={c} B={b} k={k} route={route}",
                lambda: scan.rescore_topk(*args, **kw), None, rescore_bound(b, c, DIM, b * c, k),
                err, None, plain=(lambda: scan.rescore_topk_plain(*args))
                if route == "auto" else None, plain_reps=3, **extra)
        del got_d, got_i, want_d, want_i



def elem_topc_rows(row, ms, dev, dump, compare) -> None:
    """K9 over the centred bf16 copy of a 1M x 128 mixture (every tenth row
    masked) under L1, Chebyshev, Canberra and Bray-Curtis at B = 1, 16 and
    256 and C = 256 and 80: the fused pass (``scan.elementwise_topc``)
    where the tree has it, else the parent's chain (K6c's bf16 tile, then
    K5's select), with the chain's parts timed apart; (keys, ids) held to
    the plain chain and to the other tree's bit for bit. L1 at C = 256 and
    B = 1 to 16 with K9's pilot forced on and off, where the tree's wrapper
    takes ``pilot`` (the two results bit for bit)."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import scan, topk

    rng = np.random.default_rng(0)
    x = torch.from_numpy(mixture(rng, N)).to(dev)
    mean = x.mean(0)
    x16 = (x - mean[None, :]).to(torch.bfloat16).contiguous()
    del x
    valid = torch.arange(N, device=dev) % 10 != 3
    n_live = int(valid.sum())
    qall = torch.from_numpy(mixture(np.random.default_rng(1), 256)).to(dev)
    fused = hasattr(scan, "elementwise_topc")
    for metric in (Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS):
        for b in ELEM_TOPC_B:
            q = qall[:b].contiguous()
            qt = {"x": q}

            def tile(q=q, qt=qt, metric=metric):
                return scan.elementwise_scores(qt, {"x": x16}, valid, metric, mean=mean)

            plain = scan.metric_keys_plain(qt, {"x": x16}, valid, metric, mean=mean)
            for c in ELEM_TOPC_C:
                if fused:
                    fn = (lambda q=q, metric=metric, c=c:
                          scan.elementwise_topc(q, x16, mean, valid, metric, c))
                    extra = {}
                else:
                    fn = lambda tile=tile, c=c: topk.topk_select(tile(), c)  # noqa: E731
                    keys = tile()
                    extra = {"tile_ms": ms(tile),
                             "select_ms": ms(lambda keys=keys, c=c: topk.topk_select(keys, c))}
                    del keys
                got_k, got_i = fn()
                want_k, want_i = topk.topk_select_plain(plain, c)
                same = torch.equal(got_i, want_i) and torch.equal(got_k.view(torch.int32),
                                                                  want_k.view(torch.int32))
                err = float((got_k - want_k).abs().nan_to_num(0.0).max()) if not same else 0.0
                outs = {"keys": got_k.cpu().numpy(), "ids": got_i.cpu().numpy()}
                row("K9 elementwise_topc" if fused else "K9 elementwise bf16 -> K5",
                    f"{metric.value} bf16 1M x {DIM} B={b} C={c}", fn, None,
                    elem_topc_bound(metric.value, b, DIM, n_live, N, c), err, None,
                    plain_equal=same, **extra,
                    **held(dump, compare, f"K9_{metric.value}_{b}_{c}", outs))
            del plain
    if fused and "pilot" in inspect.signature(scan.elementwise_topc).parameters:
        for b in ELEM_TOPC_PILOT_B:
            q = qall[:b].contiguous()
            by_pilot = {}
            for pilot in (True, False):
                def fn(q=q, pilot=pilot):
                    return scan.elementwise_topc(q, x16, mean, valid, Metric.L1, 256, pilot=pilot)

                by_pilot[pilot] = fn()
                extra = {"pilot_by_rule": b >= scan.ELEM_TOPC_PILOT_MIN_B}
                if not pilot:
                    (ka, ia), (kb, ib) = by_pilot[True], by_pilot[False]
                    extra["bits_equal_to_pilot"] = bool(
                        torch.equal(ia, ib) and torch.equal(ka.view(torch.int32),
                                                            kb.view(torch.int32)))
                row("K9 elementwise_topc", f"l1 bf16 1M x {DIM} B={b} C=256 pilot={pilot}", fn,
                    None, elem_topc_bound("l1", b, DIM, n_live, N, 256), None, None, **extra)
            del by_pilot


def ivf_layout(dev, mode: str):
    """chip_smoke.py phase 6's IVF index ``mode`` (IVF-L2 or IVF-IP): its
    1M-row corpus (make_corpus with seed 0: a mixture of 2,000 gaussian
    clusters, spread 0.6, 1,000 rows duplicated), built through the client
    with 1,000 clusters (the postings cached in build/), laid out in blocks of
    2,048 rows as index/ivf.py does. Returns (corpus rows on ``dev``,
    centers, centroids' transform, cluster_blocks, blocks, block_sq,
    block_orig)."""
    import tempfile

    import torch

    import lynsedb_tpu_torch as lynse
    from lynsedb_tpu_torch.index import ivf
    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(2000, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 2000, N)]
    x += 0.6 * rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]
    cache = Path(str(IVF_CACHE).format(mode))
    if not cache.exists():
        cache.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=cache.parent) as root:
            client = lynse.VectorDBClient(root, device=dev)
            coll = client.create_database("t", drop_if_exists=True).require_collection(
                "v", dim=DIM)
            coll.add(vectors=x, batch_size=100_000)
            coll.commit()
            coll.build_index(mode, n_clusters=IVF_CLUSTERS)
            idx = coll._engine._index
            np.savez(cache, centroids=idx.centroids_np, postings=idx.postings)
            client.close()
    cached = np.load(cache)
    centroids, postings = cached["centroids"], cached["postings"]
    counts = np.bincount(postings[:, 0], minlength=IVF_CLUSTERS)
    bpc = (counts + ivf.BLOCK_SIZE - 1) // ivf.BLOCK_SIZE
    cluster_blocks = np.full((IVF_CLUSTERS, max(int(bpc.max()), 1)), -1, np.int32)
    block_orig = np.full((int(bpc.sum()), ivf.BLOCK_SIZE), -1, np.int32)
    offsets, nb = np.concatenate([[0], np.cumsum(counts)]), 0
    for c in range(IVF_CLUSTERS):
        rows_c = postings[offsets[c] : offsets[c + 1], 1]
        for i in range(int(bpc[c])):
            seg = rows_c[i * ivf.BLOCK_SIZE : (i + 1) * ivf.BLOCK_SIZE]
            block_orig[nb, : len(seg)] = seg
            cluster_blocks[c, i] = nb
            nb += 1
    metric = Metric.L2 if mode == "IVF-L2" else Metric.IP
    xd = torch.from_numpy(x).to(dev)
    flat = torch.from_numpy(block_orig.reshape(-1)).to(dev)
    blocks = xd[flat.clamp_min(0).long()] * (flat >= 0)[:, None]
    block_sq = None if metric is Metric.IP else D.corpus_transform(blocks, metric)["sq"]
    cent = D.corpus_transform(torch.from_numpy(centroids).to(dev), metric)
    return (centers, cent, torch.from_numpy(cluster_blocks).to(dev),
            blocks.view(-1, ivf.BLOCK_SIZE, DIM).contiguous(), block_sq, flat)


def ivf_rows(row, ms, dev, dump, compare) -> None:
    """K16 on phase 6's IVF-L2 and IVF-IP at IVF_B under the half filter:
    the scan alone (each route of the change apart, where the tree has
    ``ivf.scan_blocks_route``), then K5's select of ``fetch``; the probe's
    shape (max_bpc, slots a query, the share of slots holding no block, the
    live rows scored a query, probes a probed block); the keys held to the
    plain version within K16's tolerance with an equal -inf pattern, the
    rows and tile routes' to each other bit for bit, and to the other
    tree's (keys within the tolerance, ids after K5 equal or near-ties
    under it)."""
    import torch

    from lynsedb_tpu_torch.index import ivf
    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import topk

    def within(got, want):
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)):
            return float("inf")
        err = (got[fin] - want[fin]).abs()
        ok = bool((err <= 1e-4 + 1e-5 * want[fin].abs()).all())
        return float(err.max()) if ok and err.numel() else (0.0 if ok else float("inf"))

    for mode in ("IVF-L2", "IVF-IP"):
        centers, cent, cluster_blocks, blocks, block_sq, block_orig = ivf_layout(dev, mode)
        metric = Metric.L2 if mode == "IVF-L2" else Metric.IP
        fetch = IVF_K if metric is Metric.L2 else 2 * IVF_K  # IVF-IP posts two replicas
        n_rows = int((block_orig >= 0).sum())
        live = torch.arange(N, device=dev) % 10 < 5  # chip_smoke.py's half filter
        qrng = np.random.default_rng(11)
        for b in IVF_B:
            q = (centers[qrng.integers(0, 2000, b)]
                 + 0.6 * qrng.normal(size=(b, DIM)).astype(np.float32)).astype(np.float32)
            qd = torch.from_numpy(q).to(dev)
            qsq = (qd * qd).sum(-1)
            top_c = ivf._top_clusters(qd, cent, metric, IVF_NPROBE)
            args = (qd, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig, live, metric)
            want = ivf.ivf_scan_blocks_plain(*args)
            slot_blk = cluster_blocks[top_c.long()].reshape(b, -1)
            distinct = torch.unique(slot_blk[slot_blk >= 0]).long()
            orig = block_orig.view(-1, ivf.BLOCK_SIZE)[distinct]
            real = orig >= 0
            n_live = int((real & live[orig.clamp_min(0).long()]).sum())
            scored = int(torch.isfinite(want).sum())
            shape = {"max_bpc": int(cluster_blocks.shape[1]),
                     "slots_a_query": int(slot_blk.shape[1]),
                     "empty_slot_share": float((slot_blk < 0).float().mean()),
                     "live_rows_scored_a_query": scored / b, "distinct_blocks": len(distinct),
                     "probes_a_probed_block": int((slot_blk >= 0).sum()) / max(len(distinct), 1),
                     "corpus_rows": n_rows}
            bnd = ivf_probe_bound(len(distinct), int(real.sum()), n_live, DIM, want.numel(),
                                  scored, metric is not Metric.IP)
            routed = hasattr(ivf, "scan_blocks_route")
            auto_route = None
            if routed:  # the route the batch's launch takes (in the shared one, the card's)
                auto_route = ivf._scan_route(b)
                if auto_route == "shared":
                    auto_route = ivf.shared_route(top_c, cluster_blocks)
            by_route = {}
            for route in ("auto", "rows", "tile", "warp") if routed else ("auto",):
                if route == "auto":
                    def fn(args=args):
                        return ivf.ivf_scan_blocks(*args)
                else:
                    def fn(args=args, route=route):
                        return ivf.scan_blocks_route(*args, route)
                got = fn()
                extra = {}
                if route == "auto":
                    top, col = topk.topk_select(got, fetch)
                    outs = {"keys": got.cpu().numpy(), "top": top.cpu().numpy(),
                            "col": col.cpu().numpy()}
                    extra = {**shape, "select_ms": ms(lambda: topk.topk_select(got, fetch)),
                             **held(dump, None, f"K16_{mode}_{b}", outs)}
                    if routed:
                        extra["route"] = auto_route
                    if compare:
                        extra.update(ivf_against(compare, f"K16_{mode}_{b}", outs))
                    del outs, top, col
                elif route == "warp":
                    extra["within_tol_of_rows"] = within(got, by_route["rows"]) < float("inf")
                elif route == "tile":
                    extra["bits_equal_to_rows"] = torch.equal(got.view(torch.int32),
                                                              by_route["rows"].view(torch.int32))
                if route == auto_route:  # the batch's own route: the auto call's bits
                    extra["bits_equal_to_auto"] = torch.equal(got.view(torch.int32),
                                                              by_route["auto"].view(torch.int32))
                by_route[route] = got
                row("K16 ivf_scan_blocks", f"{mode} B={b} nprobe={IVF_NPROBE} route={route}",
                    fn, None, bnd, within(got, want), None,
                    plain=(lambda: ivf.ivf_scan_blocks_plain(*args))
                    if route == "auto" else None, plain_reps=1 if b > 16 else 3, **extra)
            del want, by_route


def ivf_against(prefix: str, tag: str, outs: dict) -> dict:
    """K16's keys held to another tree's within K16's tolerance (the -inf
    pattern equal), and the top-fetch columns after K5: equal, or different
    only where the two trees' keys at that position are within it (a
    near-tie); the count of such columns."""
    other = np.load(f"{prefix}_{tag}.npz")
    a, b = outs["keys"], other["keys"]
    fin = np.isfinite(b)
    same_inf = bool(np.array_equal(fin, np.isfinite(a)))
    err = np.abs(a[fin].astype(np.float64) - b[fin])
    keys_ok = same_inf and bool((err <= 1e-4 + 1e-5 * np.abs(b[fin])).all())
    diff = outs["col"] != other["col"]
    ta, tb = outs["top"][diff].astype(np.float64), other["top"][diff]
    near = bool((np.abs(ta - tb) <= 1e-4 + 1e-5 * np.abs(tb)).all())
    return {"keys_within_tol_of_other_tree": keys_ok,
            "max_abs_err_to_other_tree": float(err.max()) if err.size else 0.0,
            "ids_differing_from_other_tree": int(diff.sum()),
            "ids_differ_only_at_near_ties": near}


if __name__ == "__main__":
    sys.exit(main())

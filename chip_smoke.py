#!/usr/bin/env python3
"""Drive lynsedb_tpu_torch's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its seconds):
  1. device: the card's name and power limit; fails without a CUDA device.
  2. build: compiles the CUDA kernels in lynsedb_tpu_torch/csrc with nvcc
     (one process a source, all at once).
  3. kernels: each kernel against its plain PyTorch version at the shapes its
     path gives it, with times, bounds and a library call's time beside:
     K1 flat_scores_f32 (and at B=17, the first batch of its FMA route),
     K2 bf16_centered_topc (the fused first pass: its
     top C held to the plain keys of the same rows within K2's bound, its
     ids to the plain version's but at near-ties of the C-th key; yardstick
     torch.topk(qc16 @ x16.T, C)), K3 rescore_topk, K5 topk_select (bit-equal,
     on the first pass's (B, N) keys; yardstick torch.topk) at 1,000,000 x
     128 rows, B in {1, 16, 256}, k=10, C=256, IP/L2/cosine, a 10% mask,
     duplicated rows; K5 at k in {1,000, 1,025, 4,096, 4,097}, at k = 4,000
     (a quantized search's shortlist) for B in {1, 16, 64} beside torch.topk,
     and at k in {4,096, N} of 20,000 tied keys; K2 and K3 at C = 1,280;
     kmeans_assign at N in {256,000, 1,000,000}, K = 1,000 (L2 and IP) and
     kmeans_update at N = 256,000 (twice, bit-identical).
  4. flat path: VectorDBClient(device="cuda") -> create_database ->
     require_collection(dim=128, FLAT-IP) -> add 1,000,000 rows with
     fields {"bucket": i % 10} -> commit -> 100 single searches and batch
     searches at B=16 and B=256, each unfiltered and with where="bucket = 3"
     (100,000 rows: the gather route, K11 -> K5 -> K3, scanned_vectors
     100,000 + the shortlist); the engine's batch_search_submit at B=16,
     unfiltered and bucket = 3, against batch_search; then a 2,000-row
     collection (the exact K1 plan); also "bucket < 5" (phase 7b's
     reference). K11 against its plain version on the route's own (1, 100,000)
     row list and slot keys, B in {1, 16, 256, 33}, its bound at the bf16
     peak and the two calls qc16 @ x16.index_select(0, idx).T beside it.
  5. large k: search(k=1000) and search_range(max_results=1000) on the 1M
     collection (a shortlist of 1,280: K5's large-k mode, K3 via K5), each
     call's ms on the host clock.
     Then the quantized scans at 1,000,000 x 128: K12 int8_code_scores for
     SQ8 / RaBitQ / PolarVec x IP / L2 / cosine and K13 pq_adc_scores (M=16)
     at B in {1, 16, 64} with the 10% mask, K14 fwht_rotate at B in {1, 64},
     K11 bf16_gather_scores at S = 4,000 (a K2 shortlist), B in {1, 16, 64}:
     the per-query mode, and the fused second stage (bf16_gather_topc, its
     keys and top C = 64 in one cluster launch) against its plain chain
     (keys within K11's tolerance, rows but at near-ties) and, under IP,
     against the per-query mode and K5 bit for bit; timed under IP,
     and kmeans_assign at (1,000,000, 8) x 256 (PQ's encode) and at PQ's
     training sample, (131,072, 8) x 256.
  6. IVF path: build_index("IVF-L2", n_clusters=1000), then "IVF-IP", on the
     same collection; each answers 100 single queries (nprobe=32) and batches
     at B=16 and B=256, unfiltered and with where="bucket < 5" (half the
     rows, above the exact-filter route). ivf_scan_blocks then meets its
     plain version on each index at B in {1, 16, 256}.
  7. quantized path: the upstream gate's five quantized modes on the same
     collection (FLAT-IP-SQ8, FLAT-L2-SQ8, FLAT-IP-PQ, FLAT-IP-RABITQ,
     FLAT-IP-POLARVEC), each built and asked the IVF phase's queries,
     unfiltered and with where="bucket < 5".
  7b. mesh path: MESH_SHARDS = 4 virtual shards of the card
     (make_mesh(4, devices=["cuda:0"] * 4)). K21a (the sharded exact search:
     each shard's K1 -> K5, then the copies and K5's merge) at B in {1, 16,
     256}, k=10, IP and L2, under phase 4's bucket = 3 rows, held to the
     unsharded K1 -> K5 (keys within 1e-5 relative, each run reported
     bit-equal or not; ids equal but at near-ties), on a (2, 2) mesh at
     B=17 and k=1,000, and timed at IP beside the one-device K1 -> K5, the
     summed per-shard bounds and torch.topk(q @ x.T); K21b (the sharded
     Lloyd step's cross-shard reduce, csrc/mesh_reduce.cu) at 256,000 x
     1,000 x 128: counts equal to the one-device K15's, centroids within
     1e-5, bit-equal to its plain version twice, and at one shard to
     _lloyd_step; dryrun_multichip(4, "cuda"); then, under
     set_default_mesh, a fresh FLAT-IP collection of the 1M rows and fields:
     phase 4's queries unfiltered, "bucket = 3" (each shard's gather route)
     and "bucket < 5", against a float64 brute force on the card (recall@10
     >= 0.999) and phase 4's one-device ids (ties, or rows the per-shard
     shortlists found better, aside); 1% deleted and searched again;
     search_stream of 100; FLAT-IP-SQ8 (recall >= 0.95, against phase 7's
     one-device SQ8, deleted rows aside).
  8. graph path: build_index("HNSW-L2") (m=16: layer 0 of degree 32 from
     K19's exact top 64 and two K20 prune passes, upper layers by K19 with
     L = 16) on the same collection, the IVF phase's queries at nprobe=100
     (the gate's), unfiltered and with where="bucket < 5"; K17 (f32 and bf16
     tiers, beam 100, B in {1, 16, 256}; timed at B=16 and 256 beside its
     bytes bound and its latency bound, the longest walk's steps x two
     dependent loads of a pointer chase), K19 (one 4,096-query chunk, L=64)
     and K20 (one 4,096-node chunk, L=72) against their plain versions; then
     2,500 rows added and committed (the layer-0 insert: the f32 beam at
     B=1,024 and K20's pair keys) and searched again. build_index
     ("DISKANN-IP") (r=32, l=96, layered: PQ and SQ8 fitted) on the grown
     collection, the same queries, the SQ8 and PQ tiers (100 queries each),
     K17 in all four tiers at beam 125; then 0.25% of the rows tombstoned and
     committed (the delete repair) and searched again. HNSW-IP and
     DISKANN-L2 on a 100,000-row prefix collection.
  9. metrics path: the same collection rebuilt as FLAT-L1, -CHEBYSHEV,
     -CANBERRA, -BRAY-CURTIS and -CORRELATION; 1,000,000 x 128 histograms
     (the mixture exponentiated, 1,000 rows with a negative entry, 100 all
     zero) as FLAT-HELLINGER, -JENSEN-SHANNON, -WASSERSTEIN; 1,000,000 x
     1,024-bit fingerprints (2,000 scaffold prototypes at 10% density, 2% of
     bits flipped) as FLAT-TANIMOTO-, -JACCARD-, -DICE-, -HAMMING-BINARY;
     1,000,000 (lon, lat) points uniform on the sphere (100 with |lat| > 90)
     as FLAT-HAVERSINE; phase 4's 2,000-row collection as FLAT-L2 (K1). Each mode: 100 single queries and a batch at B=16 and
     B=256, unfiltered and with where="bucket = 3"; the L1 family also
     approx=True at B=16 (K9 -> K5's merge -> K6c gather -> K5); FLAT-L1 also
     search_range(max_results=1000). Every id and distance against a float64
     brute force on the card (recall@10 >= 0.999 exact, >= 0.90 approx, ties
     within the distance tolerance counted; no filtered-out row, no row at
     +inf). K6a / K6b / K6c against their plain versions on the staged
     transforms at B in {1, 16, 256}, with the gather mode; K9 (K6c's pass
     over the bf16 copy fused with its top C) under L1, Chebyshev, Canberra
     and Bray-Curtis at B in {1, 16, 256} and C in {80, 256}.
 10. index-metrics path: IVF-HAMMING and IVF-JACCARD on phase 9's
     fingerprints (n_clusters=1000, nprobe=32), HNSW-L1 and HNSW-HAVERSINE
     on the first 250,000 mixture rows and geo points, HNSW-CHEBYSHEV and
     -CORRELATION on phase 8's 100,000-row prefix, HNSW-HELLINGER,
     -WASSERSTEIN and -JENSEN-SHANNON on the histograms' first 100,000 rows
     (nprobe=100). Each mode: 100 single queries and a batch at B=16 and
     B=256, unfiltered and with where="bucket < 5", against the float64
     brute force (HNSW >= 0.90 unfiltered, IVF-HAMMING >= 0.85; IVF-JACCARD
     >= 0.999 against the exact answer over the clusters its probe picks,
     its full recall reported); 2,500 rows then added to HNSW-L1 and
     IVF-HAMMING, committed and searched again. K16b ivf_binary_blocks and
     the domain-metric forms of K17, K19 and K20 (K6g) against their plain
     versions at the path's shapes, with times, bounds and library calls.
 10b. streaming path: the card's pinned H2D rate (a 1 GiB copy); the 1M
     mixture in a fresh FLAT-IP collection (1,000 rows deleted), its budget
     (ops/scan.DEVICE_BYTES) set from the port's byte counts so the corpus
     takes the host-rescore tier, then the streaming tier (at least four
     blocks a pass): FLAT-IP with 30 single queries and B=16 and 256 under
     no filter, "bucket = 3" (the compact host scan when streaming) and
     "bucket < 5" (per-block masks), search_stream of 1,000 queries and
     search_range(max_results=1000); FLAT-L2 and FLAT-L1 with 20 singles
     and the batches; FLAT-TANIMOTO-BINARY on phase 9's fingerprints with 5
     singles. Each answer against a float64 brute force (recall@10 >=
     0.999, distances within the family's tolerance, no filtered-out or
     deleted row) and against the resident tier's ids (ties aside). K8 (a
     pass of every block) against its plain version on the card under IP
     (bf16 blocks through K2), L1 (bf16 blocks through K9) and Tanimoto
     (f32 blocks through K6b); search_stream of 1,000 resident queries, a
     submit a window. HNSW-L2 and DISKANN-IP on a 100,000-row
     collection forced to stream: HNSW's exact fallback (>= 0.999) and a
     deferred 2,500-row commit; DiskANN's lazy code fit, its SQ8 or PQ
     walk (>= 0.90) and a 2,500-row commit linked in place (every new row
     with in-edges, no backlog); 30 single queries each. An 8M x 128
     DeviceCorpus forced to stream at a 2 GiB budget (at least four blocks
     a pass): each pass's blocks, host fill rate, H2D and scan ms
     a block (CUDA events), the compute stream's busy share, the link
     bound, B=16 and 256 latency.
 11. checks: recall@10 and distances against a chunked float64 brute force
     on the card (torch's matmul and topk)
     (FLAT >= 0.999, IVF >= 0.85, SQ8 >= 0.95, PQ / RaBitQ / PolarVec >= 0.70,
     HNSW / DiskANN >= 0.90 unfiltered in every tier, the half filter
     reported; no repeated id, no filtered-out or deleted id), large k
     against the exact top 1,000.
 12. the launch counts of each path (counts set to 0 just before a path and
     read just after; every kernel of the path > 0); K5's row also splits
     them by mode (launches_by_mode: select for k <= 1,024, large_k above,
     merge for the merges of sorted runs), K11's (fused, per_query,
     shared) and K6c's (f32_tile, bf16: K9, gather: K10); the quantized
     and mesh paths' second stage is the fused launch alone (K11's
     per-query mode 0).
The corpus is seeded numpy: 1M x 128 f32 rows drawn from a mixture of 2,000
gaussian clusters (embedding-like data, on which a partition index has
structure to find), with 1,000 duplicated rows. The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Any
failed check exits non-zero before them.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

import lynsedb_tpu_torch as lynse
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import _cuda, kmeans, quantize, topk
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import graph
from lynsedb_tpu_torch.ops import scan
from lynsedb_tpu_torch.ops.scan import DeviceCorpus
from lynsedb_tpu_torch.parallel import dryrun
from lynsedb_tpu_torch.parallel import mesh as M
from lynsedb_tpu_torch.tools.flat_latency import GcClock, device_ms_per_call
from lynsedb_tpu_torch.tools.roofline import (BF16_FLOPS, ELEM_DIM_OPS, F32_OPS, HBM_BPS,
                                              assign_bound, binary_probe_bound,
                                              binary_tile_bound, bound, bound_t, code_scan_bound,
                                              elem_tile_bound, elem_topc_bound, f32_tile_bound,
                                              gather_topc_bound, ivf_probe_bound,
                                              kmeans_update_bound,
                                              prune_bound, rescore_bound, select_bound,
                                              shared_list_bound, topl_bound, walk_bound,
                                              walk_bytes_bound)

N, DIM, K, C = 1_000_000, 128, 10, 256
BATCHES = (1, 16, 256)
METRICS = (Metric.IP, Metric.L2, Metric.COSINE)
RECALL_FLOOR = 0.999
IVF_RECALL_FLOOR = 0.85  # the upstream project's IVF/SPANN gate
N_CLUSTERS, NPROBE = 1000, 32
N_CENTERS, SPREAD = 2000, 0.6  # the corpus's mixture
BIG_K = 1000
SEED = 0
DEV = torch.device("cuda")
# the upstream gate's quantized modes (benchmarks/gate_index_modes.py:39-43)
# and their recall@10 floors (SURVEY.md section 6)
QUANT_MODES = {"FLAT-IP-SQ8": 0.95, "FLAT-L2-SQ8": 0.95, "FLAT-IP-PQ": 0.70,
               "FLAT-IP-RABITQ": 0.70, "FLAT-IP-POLARVEC": 0.70}
SHORTLIST, QUANT_BATCHES = 4000, (1, 16, 64)  # S at 1M rows and k=10; the query slice
QUANT_C = 64  # the quantized search's C at k = 10: max(64, 4 k)
GC = GcClock()  # garbage-collection seconds, read around each timed batch call
# the upstream gate's graph modes and setting (benchmarks/gate_index_modes.py:49-52)
GRAPH_NPROBE, GRAPH_RECALL_FLOOR = 100, 0.90
# the rows a graph commit links and the share one deletes, sized to keep the
# script well inside its time limit
GRAPH_INSERT, GRAPH_DELETE, PREFIX = 2_500, 0.0025, 100_000

KERNELS = {  # name -> (wrapper, source, the JAX function it replaces)
    "K1 flat_scores_f32": (scan.flat_scores_f32, "lynsedb_tpu_torch/csrc/flat_scores_f32.cu",
                           "lynsedb_tpu/ops/scan.py:190"),
    "K2 bf16_centered_topc": (scan.bf16_centered_topc,
                              "lynsedb_tpu_torch/csrc/bf16_centered_topc.cu",
                              "lynsedb_tpu/ops/scan.py:291"),
    "K3 rescore_topk": (scan.rescore_topk, "lynsedb_tpu_torch/csrc/rescore_topk.cu",
                        "lynsedb_tpu/ops/scan.py:495"),
    "K5 topk_select": (topk.topk_select, "lynsedb_tpu_torch/csrc/topk_select.cu",
                       "lynsedb_tpu/ops/topk.py:37"),
    "K15 kmeans_assign": (kmeans.kmeans_assign, "lynsedb_tpu_torch/csrc/kmeans_assign.cu",
                          "lynsedb_tpu/ops/kmeans.py:114"),
    "K15 kmeans_update": (kmeans.kmeans_update, "lynsedb_tpu_torch/csrc/kmeans_update.cu",
                          "lynsedb_tpu/ops/kmeans.py:70"),
    "K16 ivf_scan_blocks": (ivf.ivf_scan_blocks, "lynsedb_tpu_torch/csrc/ivf_scan_blocks.cu",
                            "lynsedb_tpu/index/ivf.py:43"),
    "K11 bf16_gather_scores": (scan.bf16_gather_scores,
                               "lynsedb_tpu_torch/csrc/bf16_gather_scores.cu",
                               "lynsedb_tpu/ops/scan.py:416"),
    "K12 int8_code_scores": (quantize.int8_code_scores,
                             "lynsedb_tpu_torch/csrc/int8_code_scores.cu",
                             "lynsedb_tpu/ops/quantize.py:90"),
    "K13 pq_adc_scores": (quantize.pq_adc_scores, "lynsedb_tpu_torch/csrc/pq_adc_scores.cu",
                          "lynsedb_tpu/ops/quantize.py:391"),
    "K14 fwht_rotate": (quantize.fwht_rotate, "lynsedb_tpu_torch/csrc/fwht_rotate.cu",
                        "lynsedb_tpu/ops/quantize.py:59"),
    "K17 beam_search": (graph.beam_walk, "lynsedb_tpu_torch/csrc/beam_search.cu",
                        "lynsedb_tpu/ops/graph.py:108"),
    "K19 topl_scan": (graph.topl_scan, "lynsedb_tpu_torch/csrc/topl_scan.cu",
                      "lynsedb_tpu/ops/graph.py:510"),
    "K20 robust_prune": (graph.robust_prune, "lynsedb_tpu_torch/csrc/robust_prune.cu",
                         "lynsedb_tpu/ops/graph.py:554"),
    "K6a gemm_metric_scores": (scan.gemm_metric_scores, "lynsedb_tpu_torch/csrc/flat_scores_f32.cu",
                               "lynsedb_tpu/ops/distance.py:149"),
    "K6b binary_scores": (scan.binary_scores, "lynsedb_tpu_torch/csrc/binary_scores.cu",
                          "lynsedb_tpu/ops/distance.py:177"),
    "K6c elementwise_scores": (scan.elementwise_scores,
                               "lynsedb_tpu_torch/csrc/elementwise_scores.cu",
                               "lynsedb_tpu/ops/distance.py:199"),
    "K16b ivf_binary_blocks": (ivf.ivf_binary_blocks, "lynsedb_tpu_torch/csrc/ivf_scan_blocks.cu",
                               "lynsedb_tpu/index/ivf.py:43"),
    # K6c's pass over the centred bf16 copy fused with its top C (its
    # launches also count in K6c's row, mode bf16_topc)
    "K9 elementwise_topc": (scan.elementwise_topc, "lynsedb_tpu_torch/csrc/elementwise_scores.cu",
                            "lynsedb_tpu/ops/scan.py:681"),
    # K8 chains the kernels above (K2 or K6, then K5) in ops/scan.py
    "K8 stream_block": (scan.stream_block, "lynsedb_tpu_torch/ops/scan.py",
                        "lynsedb_tpu/ops/scan.py:610"),
    # K21a: each shard's K1 / K6 -> K5, then the copies and K5's merge
    # (COMPOSITE: its launches are topk.merge_shards' K5 merges)
    "K21 sharded_search": (topk.merge_shards, "lynsedb_tpu_torch/parallel/mesh.py",
                           "lynsedb_tpu/parallel/mesh.py:83"),
    "K21b kmeans_reduce_shards": (kmeans.kmeans_reduce_shards,
                                  "lynsedb_tpu_torch/csrc/mesh_reduce.cu",
                                  "lynsedb_tpu/parallel/mesh.py:117"),
}
# rows of the kernels line with no kernel of their own: what they chain, and
# what their launches count (a reader adding launches by kernel skips them)
COMPOSITE = {"K21 sharded_search": {
    "composite_of": ["K1 flat_scores_f32", "K5 topk_select"],
    "launches_are": "K5 merges across shards, also counted in K5's row"},
    "K9 elementwise_topc": {"launches_are": "K6c's bf16_topc mode, also counted in K6c's row"}}
# the kernels each path must launch
PATHS = {
    "flat": ("K1 flat_scores_f32", "K2 bf16_centered_topc", "K3 rescore_topk",
             "K5 topk_select", "K11 bf16_gather_scores"),
    "large_k": ("K2 bf16_centered_topc", "K3 rescore_topk", "K5 topk_select"),
    "ivf": ("K1 flat_scores_f32", "K5 topk_select", "K15 kmeans_assign", "K15 kmeans_update",
            "K16 ivf_scan_blocks"),
    "quantized": ("K3 rescore_topk", "K5 topk_select", "K11 bf16_gather_scores",
                  "K12 int8_code_scores", "K13 pq_adc_scores", "K14 fwht_rotate",
                  "K15 kmeans_assign"),
    "graph": ("K1 flat_scores_f32", "K5 topk_select", "K17 beam_search", "K19 topl_scan",
              "K20 robust_prune"),
    "metrics": ("K1 flat_scores_f32", "K5 topk_select", "K6a gemm_metric_scores", "K6b binary_scores",
                "K6c elementwise_scores", "K9 elementwise_topc"),
    "index_metrics": ("K5 topk_select", "K6b binary_scores", "K16b ivf_binary_blocks",
                      "K17 beam_search", "K19 topl_scan", "K20 robust_prune"),
    "streaming": ("K1 flat_scores_f32", "K2 bf16_centered_topc", "K5 topk_select",
                  "K6b binary_scores", "K6c elementwise_scores", "K8 stream_block",
                  "K9 elementwise_topc",
                  "K11 bf16_gather_scores", "K17 beam_search",
                  "K20 robust_prune"),
    "mesh": ("K1 flat_scores_f32", "K2 bf16_centered_topc", "K3 rescore_topk", "K5 topk_select",
             "K11 bf16_gather_scores", "K12 int8_code_scores", "K15 kmeans_assign",
             "K15 kmeans_update", "K21 sharded_search", "K21b kmeans_reduce_shards"),
}


def check(ok: bool, what: str) -> None:
    """A failed check ends the run (not an assert: python -O drops those)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                print(f"== phase {name}: ok, {time.perf_counter() - self.t0:.3f} s", flush=True)

    return _Phase()


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warmed up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# launches by mode of the kernels whose wrappers split them (read beside the
# kernels' counts as "<row's short name> <mode>"): K5 select / large_k /
# merge, K11 fused / per_query / shared, K6c f32_tile / bf16_topc (K9, the
# fused bf16 pass; also K9's row) / gather (K10), K16 rows / tile / warp /
# shared (the card's pick of tile or warp)
MODES = {"K5 topk_select": topk.topk_select.by_mode,
         "K11 bf16_gather_scores": scan.bf16_gather_scores.by_mode,
         "K6c elementwise_scores": scan.elementwise_scores.by_mode,
         "K16 ivf_scan_blocks": ivf.ivf_scan_blocks.by_mode}


def mode_key(name: str, mode: str) -> str:
    return f"{name.split()[0]} {mode}"


def set_counts(counts: dict) -> None:
    for name, (wrapper, _, _) in KERNELS.items():
        wrapper.launches = counts.get(name, 0)
    for name, modes in MODES.items():
        for mode in modes:
            modes[mode] = counts.get(mode_key(name, mode), 0)


def read_counts() -> dict:
    counts = {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
    counts.update({mode_key(name, mode): n for name, modes in MODES.items()
                   for mode, n in modes.items()})
    return counts


@contextlib.contextmanager
def uncounted():
    """Launches made to compare or time a kernel do not count for a path."""
    saved = read_counts()
    try:
        yield
    finally:
        set_counts(saved)


def make_corpus(rng):
    """1M rows from a mixture of N_CENTERS gaussian clusters, 1,000 rows
    duplicated (exact score ties). Returns (rows, centers)."""
    centers = rng.normal(size=(N_CENTERS, DIM)).astype(np.float32)
    x = centers[rng.integers(0, N_CENTERS, N)]
    x += SPREAD * rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]
    return x, centers


def mixture_queries(rng, centers, n):
    return (centers[rng.integers(0, N_CENTERS, n)]
            + SPREAD * rng.normal(size=(n, DIM)).astype(np.float32)).astype(np.float32)


def check_ids(got: np.ndarray, want: np.ndarray, want_keys: np.ndarray, tol: np.ndarray) -> None:
    """ids identical, except between entries whose plain keys lie within the
    row's tolerance of each other."""
    for r, c in zip(*np.nonzero(got != want)):
        j = np.nonzero(want[r] == got[r, c])[0]
        if not len(j) or abs(want_keys[r, j[0]] - want_keys[r, c]) > tol[r]:
            raise AssertionError(f"id mismatch at ({r}, {c}): {got[r, c]} vs {want[r, c]}")


def check_topc(q, aux, full, got, want, metric, what: str) -> float:
    """K2's fused pass against its plain version: each returned key within
    K2's bound (1e-5 |q - m| |x - m| + 1e-5; cosine: over its denominator)
    of the plain key of the same row (``full``, the plain (B, N) keys), keys
    descending, the same slots empty, no row twice, and the plain version's
    ids but for rows whose plain key lies within twice that bound of the
    plain C-th key. Returns the largest key error."""
    (gk, gi), (wk, wi) = got, want
    live = gi >= 0
    check(torch.equal(live, wi >= 0), f"{what}: empty slots differ")
    check(bool((gk[:, :-1] >= gk[:, 1:]).all()), f"{what}: keys not descending")
    rows = torch.where(live, gi, 0).long()
    xc = torch.sqrt(aux["xc_sq"][rows])
    tol = 1e-5 * (q - aux["mean"][None, :]).norm(dim=1)[:, None] * xc + 1e-5
    if metric is Metric.COSINE:  # the bound holds for the numerator
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][rows]).clamp_min(1e-30)
    err = torch.where(live, (gk - full.gather(1, rows)).abs(), 0.0)
    check(bool((err <= tol).all()), f"{what}: keys outside K2's bound")
    srt = torch.sort(gi, dim=1).values
    check(bool(((srt[:, 1:] != srt[:, :-1]) | (srt[:, 1:] < 0)).all()), f"{what}: a row twice")
    kth = torch.where(wi >= 0, wk, float("inf")).min(dim=1).values  # the plain C-th key
    tol_max = torch.where(live, tol, 0.0).max(dim=1).values
    for r in torch.nonzero((torch.sort(gi, 1).values != torch.sort(wi, 1).values).any(1)).flatten():
        for row in set(gi[r][live[r]].tolist()) ^ set(wi[r][wi[r] >= 0].tolist()):
            check(abs(float(full[r, row] - kth[r])) <= 2 * float(tol_max[r]),
                  f"{what}: row {row} of query {int(r)} is no near-tie of the C-th key")
    return float(err.max())


class Stats:
    """Per kernel: the largest error and, per shape label, the kernel's,
    the plain version's and the library call's ms and the bound."""

    def __init__(self):
        self.err = {name: 0.0 for name in (*KERNELS, *K6G)}
        self.rows = {name: {} for name in (*KERNELS, *K6G)}

    def error(self, name, err) -> None:
        self.err[name] = max(self.err[name], float(err))

    def time(self, name, label, fn, plain, library, bound_ms, reps: int = 10,
             plain_reps: int | None = None, **extra) -> None:
        with uncounted():
            self.rows[name][label] = {
                "ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, plain_reps or reps),
                "library_ms": None if library is None else cuda_ms(library, reps),
                "bound_ms": bound_ms[0], "bound_by": bound_ms[1], **extra}

    def table(self, card: str) -> None:
        print(f"   kernel times, ms per launch (CUDA events; {card}):")
        for name, rows in self.rows.items():
            for label, r in rows.items():
                lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                walk = f"  walk bound {r['walk_bound_ms']:.4f}" if "walk_bound_ms" in r else ""
                print(f"     {name:24s} {label:28s} kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}"
                      f"  library {lib}  bound {r['bound_ms']:.4f} ({r['bound_by']}){walk}")


def flat_kernel_phase(x: np.ndarray, rng, stats: Stats) -> DeviceCorpus:
    """K1, K2, K3 and K5 against their plain versions at the flat path's
    shapes, then K5 and K3 past k = 1,024. Returns the staged corpus."""
    corpus = DeviceCorpus(DIM, device=DEV)
    corpus.append(x)
    mask = rng.random(N) < 0.1
    corpus.set_tombstones(np.arange(N) % 997 == 0)
    valid = corpus.valid_mask(mask)
    # the timed launches run unfiltered (tombstones only), as the main path
    # does; their bounds read only the live rows
    live = corpus.valid_mask()
    n_live = int(live.sum())
    x16, aux, x32 = corpus._dev16, corpus.bf16_aux(), corpus._data
    rows = x32.shape[0]  # the staged capacity: every kernel writes a key a row
    keys16 = None
    for metric in METRICS:
        ct = D.corpus_transform(x32, metric)
        for b in BATCHES:
            ip = metric is Metric.IP
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
            qt = D.query_transform(q, metric)
            args1 = (q, x32, qt.get("sq"), ct.get("sq"), valid, metric)
            k1, p1 = scan.flat_scores_f32(*args1), scan.flat_scores_f32_plain(*args1)
            fin = torch.isfinite(p1)
            check(torch.equal(fin, torch.isfinite(k1)), "K1: masked entries differ")
            err1 = (k1[fin] - p1[fin]).abs()
            check(bool((err1 <= 1e-4 + 1e-5 * p1[fin].abs()).all()), f"K1 {metric} B={b}")
            stats.error("K1 flat_scores_f32", err1.max())
            if ip:
                args_t = (q, x32, None, None, live, metric)
                stats.time("K1 flat_scores_f32", f"IP B={b}", lambda: scan.flat_scores_f32(*args_t),
                           lambda: scan.flat_scores_f32_plain(*args_t), lambda: q @ x32.T,
                           f32_tile_bound(b, DIM, n_live, rows))
            del p1, fin, err1

            # K5 on K1's keys (k = 10) and on the first pass's (B, N) keys (k = C)
            k2 = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
            for keys, kk in ((k1, K), (k2, C)):
                got, want = topk.topk_select(keys, kk), topk.topk_select_plain(keys, kk)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"K5 {metric} B={b} k={kk}")
                if kk == C:
                    stats.error("K5 topk_select", (got[0] - want[0]).nan_to_num().abs().max())
                    if ip:
                        stats.time("K5 topk_select", f"IP B={b} k={C}",
                                   lambda: topk.topk_select(keys, C),
                                   lambda: topk.topk_select_plain(keys, C),
                                   lambda: torch.topk(keys, C), bound(b * rows * 4 + b * C * 8, 0))
            del k1

            # K2, the fused first pass: the top C without the (B, N) keys
            top, gid = scan.bf16_centered_topc(q, x16, aux, valid, metric, C)
            stats.error("K2 bf16_centered_topc",
                        check_topc(q, aux, k2, (top, gid),
                                   scan.bf16_centered_topc_plain(q, x16, aux, valid, metric, C),
                                   metric, f"K2 {metric} B={b}"))
            if ip:
                qc16 = scan._query_terms(q, aux["mean"])[0]
                # IP's epilogue reads a live row's m . (x - m) (4 B) and
                # every row's valid byte; it writes the (B, C) keys and ids
                stats.time("K2 bf16_centered_topc", f"IP B={b} C={C}",
                           lambda: scan.bf16_centered_topc(q, x16, aux, live, metric, C),
                           lambda: scan.bf16_centered_topc_plain(q, x16, aux, live, metric, C),
                           lambda: torch.topk(qc16 @ x16.T, C),
                           bound(n_live * (DIM * 2 + 4) + rows + b * DIM * 2 + b * C * 8,
                                 2 * b * n_live * DIM, BF16_FLOPS))
            if ip and b == 16:
                keys16 = k2
            del k2

            cand_keys, cand_idx = top, gid
            args3 = (q, x32, cand_keys, cand_idx, K, metric)
            n_cand = int((cand_keys > float("-inf")).sum())  # the rows K3 gathers
            gd, gi = scan.rescore_topk(*args3)
            wd, wi = scan.rescore_topk_plain(*args3)
            err3 = (gd - wd).abs()
            check(bool((err3 <= 1e-4 + 1e-5 * wd.abs()).all()), f"K3 {metric} B={b}")
            wd_np = wd.cpu().numpy()
            check_ids(gi.cpu().numpy(), wi.cpu().numpy(), wd_np,
                      1e-4 + 1e-5 * np.abs(wd_np).max(axis=1))
            stats.error("K3 rescore_topk", err3.max())
            if b == 16:
                # both block widths (256 and 1,024 threads) give the plan's
                # outputs bit for bit
                for wide in (False, True):
                    cd, ci = scan.rescore_topk(*args3, wide=wide)
                    check(torch.equal(cd.view(torch.int32), gd.view(torch.int32))
                          and torch.equal(ci, gi), f"K3 {metric} B={b} wide={wide}")
            if ip:
                stats.time("K3 rescore_topk", f"IP B={b} C={C}", lambda: scan.rescore_topk(*args3),
                           lambda: scan.rescore_topk_plain(*args3), None,
                           rescore_bound(b, C, DIM, n_cand, K))
        print(f"   {metric.value}: K1, K2, K3, K5 agree with their plain versions", flush=True)

    # K1 at the edge of its routes: B = 17 is the first batch on the FMA
    # route (a 32-query tile); a generator of its own leaves the data of the
    # checks below as they were
    q17 = torch.from_numpy(np.random.default_rng(SEED + 17).normal(size=(17, DIM))
                           .astype(np.float32)).to(DEV)
    args17 = (q17, x32, None, None, valid, Metric.IP)
    k17, p17 = scan.flat_scores_f32(*args17), scan.flat_scores_f32_plain(*args17)
    fin = torch.isfinite(p17)
    check(torch.equal(fin, torch.isfinite(k17)), "K1 B=17: masked entries differ")
    err17 = (k17[fin] - p17[fin]).abs()
    check(bool((err17 <= 1e-4 + 1e-5 * p17[fin].abs()).all()), "K1 ip B=17")
    stats.error("K1 flat_scores_f32", err17.max())
    del k17, p17, fin, err17
    print("   K1 at B=17 (the FMA route's first batch): agrees with its plain version",
          flush=True)

    # K5 up to the select's k = 4,096 and past it (sort and merge), exact,
    # ties included; K2 at the large-k path's shortlist
    for kk in (BIG_K, 1025, 4096, 4097):
        got, want = topk.topk_select(keys16, kk), topk.topk_select_plain(keys16, kk)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"K5 k={kk}")
    ties = np.round(rng.normal(size=(4, 20_000)), 1).astype(np.float32)
    ties[rng.random(ties.shape) < 0.05] = -np.inf
    ties_t = torch.from_numpy(ties).to(DEV)
    for kk in (4096, 20_000):
        got, want = topk.topk_select(ties_t, kk), topk.topk_select_plain(ties_t, kk)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K5 k = {kk} of 20,000 tied keys")
    c_big = corpus._shortlist_size(BIG_K, N)
    q1 = torch.from_numpy(rng.normal(size=(1, DIM)).astype(np.float32)).to(DEV)
    keys1 = scan.bf16_centered_scores_plain(q1, x16, aux, valid, Metric.IP)
    stats.time("K5 topk_select", f"IP B=1 k={c_big}", lambda: topk.topk_select(keys1, c_big),
               lambda: topk.topk_select_plain(keys1, c_big), lambda: torch.topk(keys1, c_big),
               bound(rows * 4 + c_big * 8, 0))
    stats.time("K5 topk_select", f"IP B=16 k={c_big}", lambda: topk.topk_select(keys16, c_big),
               lambda: topk.topk_select_plain(keys16, c_big), lambda: torch.topk(keys16, c_big),
               bound(16 * rows * 4 + 16 * c_big * 8, 0))
    # K5 at a quantized search's shortlist (S = 4,000 at 1M codes) at its
    # query slices, on the first pass's keys of 64 queries
    q64 = torch.from_numpy(rng.normal(size=(64, DIM)).astype(np.float32)).to(DEV)
    keys64 = scan.bf16_centered_scores_plain(q64, x16, aux, valid, Metric.IP)
    for b in QUANT_BATCHES:
        kb = keys64[:b].contiguous()
        got, want = topk.topk_select(kb, SHORTLIST), topk.topk_select_plain(kb, SHORTLIST)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K5 B={b} k={SHORTLIST}")
        stats.time("K5 topk_select", f"IP B={b} k={SHORTLIST}",
                   lambda: topk.topk_select(kb, SHORTLIST),
                   lambda: topk.topk_select_plain(kb, SHORTLIST),
                   lambda: torch.topk(kb, SHORTLIST), select_bound(b, rows, SHORTLIST))
    del keys64, kb, got, want
    # K3 with a shortlist above its shared-memory sort (C = 1,280)
    q16 = torch.from_numpy(rng.normal(size=(16, DIM)).astype(np.float32)).to(DEV)
    cand_keys, cand_idx = scan.bf16_centered_topc(q16, x16, aux, valid, Metric.IP, c_big)
    stats.error("K2 bf16_centered_topc", check_topc(
        q16, aux, scan.bf16_centered_scores_plain(q16, x16, aux, valid, Metric.IP),
        (cand_keys, cand_idx), scan.bf16_centered_topc_plain(q16, x16, aux, valid, Metric.IP,
                                                             c_big), Metric.IP, f"K2 C={c_big}"))
    args3 = (q16, x32, cand_keys, cand_idx, BIG_K, Metric.IP)
    n_cand = int((cand_keys > float("-inf")).sum())
    gd, gi = scan.rescore_topk(*args3)
    wd, wi = scan.rescore_topk_plain(*args3)
    err3 = (gd - wd).abs()
    check(bool((err3 <= 1e-4 + 1e-5 * wd.abs()).all()), f"K3 C={c_big}")
    wd_np = wd.cpu().numpy()
    check_ids(gi.cpu().numpy(), wi.cpu().numpy(), wd_np, 1e-4 + 1e-5 * np.abs(wd_np).max(axis=1))
    stats.error("K3 rescore_topk", err3.max())
    stats.time("K3 rescore_topk", f"IP B=16 C={c_big}", lambda: scan.rescore_topk(*args3),
               lambda: scan.rescore_topk_plain(*args3), None,
               rescore_bound(16, c_big, DIM, n_cand, BIG_K))
    print(f"   K5 at k in {{{BIG_K}, 1025, 4096, 4097}}, k = {SHORTLIST} at B in "
          f"{list(QUANT_BATCHES)} and k in {{4096, N = 20,000}} of tied keys, K2 and K3 at C = "
          f"{c_big}: agree with their plain versions", flush=True)
    return corpus


def kmeans_kernel_phase(x: np.ndarray, rng, stats: Stats) -> None:
    """kmeans_assign and kmeans_update against their plain versions at the
    IVF build's shapes: the training sample (256 rows a centroid) and the
    full corpus, K = N_CLUSTERS."""
    xd = torch.from_numpy(x).to(DEV)
    cent = xd[torch.from_numpy(rng.choice(N, N_CLUSTERS, replace=False)).to(DEV)].clone()
    n_train = N_CLUSTERS * 256
    for rows in (n_train, N):
        data = xd[:rows]
        for ip in (False, True):
            got = kmeans.kmeans_assign(data, cent, ip)
            want = kmeans.kmeans_assign_plain(data, cent, ip)
            diff = torch.nonzero(got != want).flatten()
            if len(diff):  # allowed only where the two best centroids nearly tie
                sub = data[diff]
                s = kmeans._ip_scores(sub, cent) if ip else -kmeans._l2_scores(
                    sub, cent, (cent * cent).sum(-1))
                top2 = s.topk(2, dim=1).values
                check(bool(((top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()).all()),
                      f"kmeans_assign rows={rows} ip={ip}: {len(diff)} differ beyond a near-tie")
            if rows == n_train or not ip:
                stats.time("K15 kmeans_assign", f"{'IP' if ip else 'L2'} N={rows} K={N_CLUSTERS}",
                           lambda: kmeans.kmeans_assign(data, cent, ip),
                           lambda: kmeans.kmeans_assign_plain(data, cent, ip), None,
                           assign_bound(rows, N_CLUSTERS, DIM, ip))
            print(f"   kmeans_assign N={rows} {'IP' if ip else 'L2'}: {len(diff)} near-tie "
                  "rows differ", flush=True)
    data = xd[:n_train]
    valid = torch.arange(n_train, device=DEV) < n_train - n_train // 10
    assign = kmeans.kmeans_assign(data, cent, False)
    first = kmeans.kmeans_update(data, valid, assign, cent)
    second = kmeans.kmeans_update(data, valid, assign, cent)
    want = kmeans.kmeans_update_plain(data, valid, assign, cent)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "kmeans_update: two runs are not bit-identical")
    err = (first[0] - want[0]).abs()
    check(bool((err <= 1e-4 + 1e-5 * want[0].abs()).all()), "kmeans_update sums")
    check(torch.equal(first[1], want[1]), "kmeans_update counts")
    check(bool(((first[2] - want[2]).abs() <= 1e-5 + 1e-5 * want[2].abs()).all()),
          "kmeans_update centroids")
    stats.error("K15 kmeans_update", err.max())
    sums, assign64, w = torch.zeros_like(cent), assign.long(), data * valid[:, None]
    weights = valid.to(torch.float32)

    def library():  # the sums (float atomics, any order) and the counts
        sums.index_add_(0, assign64, w)
        torch.bincount(assign64, weights=weights, minlength=N_CLUSTERS)

    n_valid = int(valid.sum())
    stats.time("K15 kmeans_update", f"N={n_train} K={N_CLUSTERS}",
               lambda: kmeans.kmeans_update(data, valid, assign, cent),
               lambda: kmeans.kmeans_update_plain(data, valid, assign, cent), library,
               kmeans_update_bound(n_train, N_CLUSTERS, DIM, n_valid))
    print("   kmeans_update: sums, counts and centroids agree; two runs bit-identical", flush=True)


def accepted(library):
    """``library`` if one call of it runs, else None: a yardstick call may
    refuse a shape, which is no fault of the port."""
    try:
        library()
        sync()
        return library
    except RuntimeError as err:
        print(f"   library call refused: {err}", flush=True)
        return None


def synthetic_code_state(kind: str, gen: torch.Generator) -> dict:
    """An int8-coded index of N x DIM codes on the card, drawn from a seeded
    generator in the value ranges of ``kind``'s codes and terms (the
    kernels' work does not depend on the values)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEV)

    def codes(lo, hi):
        return torch.randint(lo, hi, (N, DIM), generator=gen, device=DEV, dtype=torch.int8)

    if kind == "sq8":
        st = {"codes": codes(-128, 128), "lo": rand(DIM) - 2.0, "scale": rand(DIM) * 0.02 + 1e-3}
    elif kind == "rabitq":
        st = {"bits": (codes(0, 2) * 2 - 1).to(torch.int8), "alpha": rand(N) * 0.1 + 0.05}
    else:
        st = {"codes": codes(0, 16), "lo": -0.3 * rand(N), "scale": rand(N) * 0.04 + 1e-3}
    st["row_sq"] = rand(N) * 100 + 1.0
    return st


def check_gather(got, want, q, aux, ids, metric, what: str, stats: Stats) -> None:
    """K11's keys against its plain version's: the same empty slots, and
    each key within K2's tolerance (1e-5 of |q - mean| |x - mean|, over the
    norms for cosine): the same bf16 products summed in another order."""
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)), f"{what}: empty slots")
    safe = ids.clamp_min(0).long()
    qc_norm = (q - aux["mean"][None, :]).norm(dim=1)[:, None]
    tol = 1e-5 * qc_norm * torch.sqrt(aux["xc_sq"][safe]) + 1e-5
    if metric is Metric.COSINE:
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][safe]).clamp_min(1e-30)
    err = (got - want).abs()
    check(bool((err[fin] <= tol.expand_as(err)[fin]).all()), what)
    stats.error("K11 bf16_gather_scores", err[fin].max())


def check_gather_topc(got, want, q, x16, aux, metric, what: str, stats: Stats) -> int:
    """K11's fused stage against its plain chain: the same live slots, keys
    descending, each key within check_gather's tolerance of its row's plain
    key, the plain chain's rows but for near-ties of the C-th key (within
    twice the tolerance). Returns the number of queries whose rows differ."""
    (gk, gi), (wk, wi) = got, want
    live = gi >= 0
    check(torch.equal(live, wi >= 0) and torch.equal(live, gk > float("-inf")),
          f"{what}: empty slots")
    check(bool((gk[:, :-1] >= gk[:, 1:]).all()), f"{what}: keys not descending")
    plain = scan.bf16_gather_scores_plain(q, x16, aux, gi, None, metric)
    safe = gi.clamp_min(0).long()
    tol = 1e-5 * (q - aux["mean"][None, :]).norm(dim=1)[:, None] * torch.sqrt(
        aux["xc_sq"][safe]) + 1e-5
    if metric is Metric.COSINE:
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][safe]).clamp_min(1e-30)
    err = torch.where(live, (gk - plain).abs(), 0.0)
    check(bool((err <= tol).all()), f"{what}: keys outside the tolerance")
    stats.error("K11 bf16_gather_scores", err.max())
    rows = torch.nonzero((gi != wi).any(1)).flatten().tolist()
    for r in rows:
        swapped = set(gi[r][live[r]].tolist()) ^ set(wi[r][live[r]].tolist())
        if not swapped:
            continue
        ids = torch.tensor(sorted(swapped), dtype=torch.int32, device=gi.device)[None]
        k_rows = scan.bf16_gather_scores_plain(q[r : r + 1], x16, aux, ids, None, metric)[0]
        kth = float(wk[r][live[r]][-1])
        check(bool(((k_rows - kth).abs() <= 2 * tol[r][live[r]].max()).all()),
              f"{what}: query {r}'s rows {sorted(swapped)} are no near-ties of the C-th key")
    return len(rows)


def gather_route_phase(coll, rng, stats: Stats) -> None:
    """K11 against its plain version at the flat path's gather-route inputs:
    the engine's bucket = 3 handle over the 1M collection, its (1, 100,000)
    row list shared by every query and its slot keys, B in {1, 16, 256} and
    33 (two query groups of the shared-list tile), IP / L2 / cosine; timed
    under IP (the collection's metric) at B in {1, 16, 256}, its bound
    counting the flops at the bf16 tensor-core peak (the same work could run
    there, as K2's does), with the two calls qc16 @ x16.index_select(0,
    idx).T beside it (a gather and a matmul: no one PyTorch call, so no
    library time)."""
    eng = coll._engine
    corpus, handle = eng.corpus(), eng.resolve_filter("bucket = 3")
    check(handle.use_gather(corpus.n), "bucket = 3 takes the gather route")
    idx, slot = corpus.gather_inputs(handle)
    s = idx.shape[1]
    x16, aux = corpus.data16, corpus.bf16_aux()
    for metric in METRICS:
        for b in (*BATCHES, 33):
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
            got = scan.bf16_gather_scores(q, x16, aux, idx, slot, metric, shared=True)
            want = scan.bf16_gather_scores_plain(q, x16, aux, idx, slot, metric, shared=True)
            check(got.shape == (b, s), f"K11 shared list B={b}: shape {tuple(got.shape)}")
            check_gather(got, want, q, aux, idx, metric, f"K11 {metric} shared S={s} B={b}", stats)
            del got, want
            if metric is Metric.IP and b in BATCHES:  # rows, xm, the list and its slot keys
                stats.time("K11 bf16_gather_scores", f"IP B={b} shared S={s}",
                           lambda: scan.bf16_gather_scores(q, x16, aux, idx, slot, metric,
                                                           shared=True),
                           lambda: scan.bf16_gather_scores_plain(q, x16, aux, idx, slot, metric,
                                                                 shared=True),
                           None, shared_list_bound(b, DIM, s))
                qc16 = scan._query_terms(q, aux["mean"])[0]
                two = cuda_ms(lambda: qc16 @ x16.index_select(0, idx[0]).T)
                print(f"   K11 shared S={s} B={b}: two calls (index_select + bf16 matmul) "
                      f"{two:.4f} ms", flush=True)
    print(f"   K11 bf16_gather_scores over the shared (1, {s}) list: agrees with its plain "
          "version at B in [1, 16, 256, 33]", flush=True)


def quant_kernel_phase(corpus: DeviceCorpus, rng, stats: Stats) -> None:
    """K12, K13, K14, K11 and kmeans_assign against their plain versions at
    the quantized path's shapes: 1M x 128 codes, B in {1, 16, 64} (the
    query slice), S = 4,000, the 10% mask for the checks; the timed
    launches run unfiltered (tombstones only)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    valid = corpus.valid_mask(rng.random(N) < 0.1)
    live = corpus.valid_mask()
    n_live = int(live[:N].sum())
    signs = torch.from_numpy(quantize.rotation_signs(DIM, 1234)).to(DEV)
    stages = int(np.log2(DIM))

    for b in (1, 64):  # K14
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
        got, want = quantize.fwht_rotate(q, signs, DIM), quantize.rotate(q, signs, DIM)
        err = (got - want).abs()
        check(bool((err <= 1e-6 * want.abs()).all()), f"K14 B={b}")
        stats.error("K14 fwht_rotate", err.max())
        stats.time("K14 fwht_rotate", f"B={b}", lambda: quantize.fwht_rotate(q, signs, DIM),
                   lambda: quantize.rotate(q, signs, DIM), None,
                   bound(2 * b * DIM * 4 + DIM * 4, b * DIM * (stages + 2)))
    print("   K14 fwht_rotate agrees with its plain version (rtol 1e-6)", flush=True)

    for kind in ("sq8", "rabitq", "polarvec"):  # K12
        st = synthetic_code_state(kind, gen)
        codes = st["bits" if kind == "rabitq" else "codes"]
        row_bytes = {"sq8": 0, "rabitq": 4, "polarvec": 8}[kind]  # IP's per-row terms
        for metric in METRICS:
            for b in QUANT_BATCHES:
                q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
                q_rot = None if kind == "sq8" else quantize.rotate(q, signs, DIM)
                args = (kind, q, q_rot, st, valid, metric)
                got = quantize.int8_code_scores(*args)
                want = quantize.int8_code_scores_plain(*args)
                fin = torch.isfinite(want)
                check(torch.equal(fin, torch.isfinite(got)), f"K12 {kind} {metric} B={b}: masks")
                err = (got[fin] - want[fin]).abs()
                check(bool((err <= 1e-5 + 1e-5 * want[fin].abs()).all()),
                      f"K12 {kind} {metric} B={b}")
                stats.error("K12 int8_code_scores", err.max())
                del got, want, fin, err
                if metric is not Metric.IP:
                    continue
                args_t = (kind, q, q_rot, st, live, metric)
                library = None
                if b > 16:  # torch._int_mm takes more than 16 rows
                    a = q * st["scale"][None, :] if kind == "sq8" else q_rot
                    q_i8 = quantize.quantize_queries(a)[0]
                    library = accepted(lambda: torch._int_mm(q_i8, codes.T))
                stats.time("K12 int8_code_scores", f"{kind} IP B={b}",
                           lambda: quantize.int8_code_scores(*args_t),
                           lambda: quantize.int8_code_scores_plain(*args_t), library,
                           code_scan_bound(b, DIM, codes.shape[1], n_live, N, row_bytes))
        del st, codes
        print(f"   K12 {kind}: agrees with its plain version (IP, L2, cosine; B in "
              f"{QUANT_BATCHES})", flush=True)

    m, ds = 16, DIM // 16  # K13, PQ16
    codes = torch.randint(0, 256, (N, m), generator=gen, device=DEV, dtype=torch.uint8)
    books = torch.randn((m, 256, ds), generator=gen, device=DEV)
    row_sq = (books * books).sum(-1)[torch.arange(m, device=DEV)[None, :], codes.long()].sum(1)
    for metric in METRICS:
        for b in QUANT_BATCHES:
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
            got = quantize.pq_adc_scores(q, codes, books, row_sq, valid, metric)
            want = quantize.pq_adc_scores_plain(q, codes, books, row_sq, valid, metric)
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)), f"K13 {metric} B={b}: masks")
            # the tables' f32 sums run in another order: 1e-5 of the terms' size
            scale = (q * q).sum(-1)[:, None] + row_sq[None, :] + want.abs()
            err = (got - want).abs()
            check(bool((err[fin] <= 1e-4 + 1e-5 * scale[fin]).all()), f"K13 {metric} B={b}")
            stats.error("K13 pq_adc_scores", err[fin].max())
            del got, want, fin, scale, err
            if metric is Metric.IP:
                stats.time("K13 pq_adc_scores", f"M={m} IP B={b}",
                           lambda: quantize.pq_adc_scores(q, codes, books, row_sq, live, metric),
                           lambda: quantize.pq_adc_scores_plain(q, codes, books, row_sq, live,
                                                                metric), None,
                           bound(n_live * m + N + books.numel() * 4 + b * DIM * 4 + b * N * 4,
                                 2 * b * m * 256 * ds + b * n_live * m))
    print(f"   K13 pq_adc_scores M={m}: agrees with its plain version", flush=True)
    del codes, books, row_sq

    x16, aux = corpus._dev16, corpus.bf16_aux()  # K11 on a K2 shortlist
    for metric in METRICS:
        for b in QUANT_BATCHES:
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
            top, cand = scan.bf16_centered_topc(q, x16, aux, valid, metric, SHORTLIST)
            # the per-query mode (the route past GATHER_TOPC_MAX)
            got = scan.bf16_gather_scores(q, x16, aux, cand, top, metric)
            want = scan.bf16_gather_scores_plain(q, x16, aux, cand, top, metric)
            check_gather(got, want, q, aux, cand, metric, f"K11 {metric} B={b}", stats)
            # the fused second stage: keys, then the top C, in one launch
            args = (q, x16, aux, cand, top, metric, QUANT_C)
            fused = scan.bf16_gather_topc(*args)
            n_differ = check_gather_topc(fused, scan.bf16_gather_topc_plain(*args), q, x16, aux,
                                         metric, f"K11 fused {metric} B={b}", stats)
            two = scan.topk_select(got, QUANT_C)
            two = (two[0], torch.where(two[0] > float("-inf"), cand.gather(1, two[1].long()), -1))
            same = torch.equal(fused[1], two[1]) and torch.equal(
                (fused[0] + 0.0).view(torch.int32), (two[0] + 0.0).view(torch.int32))
            check(metric is not Metric.IP or same,
                  f"K11 fused IP B={b}: not bit-equal to K11's per-query mode and K5")
            print(f"   K11 fused {metric} B={b}: {n_differ} rows off the plain chain (near-ties), "
                  f"{'bit-equal' if same else 'not bit-equal'} to the two-launch chain",
                  flush=True)
            if metric is Metric.IP:
                n_cand = int((top > float("-inf")).sum())  # the rows it gathers
                stats.time("K11 bf16_gather_scores", f"IP B={b} S={SHORTLIST} C={QUANT_C} fused",
                           lambda: scan.bf16_gather_topc(*args),
                           lambda: scan.bf16_gather_topc_plain(*args), None,
                           gather_topc_bound(b, DIM, SHORTLIST, QUANT_C, n_cand))
            del got, want, fused, two
    print(f"   K11 bf16_gather_scores S={SHORTLIST}: the per-query mode and the fused stage "
          f"(C = {QUANT_C}) agree with their plain versions", flush=True)

    # kmeans_assign at PQ's shapes: every row's 8-wide subspace x 256 (the
    # encode) and the codebook fit's training sample (PQ.TRAIN_SAMPLE rows)
    sub = torch.from_numpy(np.ascontiguousarray(corpus.host_rows(np.arange(N))[:, :ds])).to(DEV)
    cent = sub[torch.from_numpy(rng.choice(N, 256, replace=False)).to(DEV)].clone()
    for rows in (N, quantize.PQ.TRAIN_SAMPLE):
        data = sub[:rows]
        got = kmeans.kmeans_assign(data, cent, False)
        want = kmeans.kmeans_assign_plain(data, cent, False)
        diff = torch.nonzero(got != want).flatten()
        if len(diff):  # allowed only where the two best codewords nearly tie
            top2 = (-kmeans._l2_scores(data[diff], cent, (cent * cent).sum(-1))).topk(
                2, dim=1).values
            check(bool(((top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs() + 1e-6).all()),
                  f"kmeans_assign ({rows}, {ds}) x 256: {len(diff)} differ beyond a near-tie")
        stats.time("K15 kmeans_assign", f"L2 N={rows} K=256 D={ds}",
                   lambda: kmeans.kmeans_assign(data, cent, False),
                   lambda: kmeans.kmeans_assign_plain(data, cent, False), None,
                   assign_bound(rows, 256, ds))
        print(f"   kmeans_assign ({rows}, {ds}) x 256: {len(diff)} near-tie rows differ",
              flush=True)


def exact_topk(x: np.ndarray, rows: np.ndarray, q: np.ndarray, k: int, metric=Metric.IP):
    """Chunked float64 brute force on the card (torch's matmul and topk,
    none of the port's kernels): the top-k of ``rows`` (global ids) by IP,
    or by L2 (ranked on 2 q.x - |x|^2), the earlier chunk first between
    equal keys. Returns (keys, ids) as numpy arrays."""
    qd = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(DEV, torch.float64)
    best_d = torch.empty((len(q), 0), dtype=torch.float64, device=DEV)
    best_i = torch.empty((len(q), 0), dtype=torch.int64, device=DEV)
    for lo in range(0, len(rows), 131072):
        ids = np.asarray(rows[lo : lo + 131072], dtype=np.int64)
        xc = torch.from_numpy(np.ascontiguousarray(x[ids], dtype=np.float32)).to(DEV)
        xc = xc.double()
        s = qd @ xc.T
        if metric is Metric.L2:
            s = 2.0 * s - (xc * xc).sum(1)[None, :]
        top, part = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_d = torch.cat([best_d, top], 1)
        best_i = torch.cat([best_i, torch.from_numpy(ids).to(DEV)[part]], 1)
        best_d, order = torch.sort(best_d, dim=1, descending=True, stable=True)
        best_d, best_i = best_d[:, :k], best_i.gather(1, order)[:, :k]
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def exact_dists(x, ids, q, metric):
    """float64 distances of rows ``ids`` to query ``q``, and the f32
    expansion's rounding scale (the distance tolerance's atol)."""
    rows, q64 = x[ids].astype(np.float64), q.astype(np.float64)
    if metric is Metric.IP:
        return rows @ q64, 1e-5
    d = ((rows - q64) ** 2).sum(1)
    return d, 1e-5 * (q64 @ q64 + (rows * rows).sum(1).max(initial=0.0))


def check_results(x, q, views, gt_i, label: str, metric=Metric.IP, floor=RECALL_FLOOR) -> float:
    """recall@10 against the ground truth, no repeated id, and every
    returned distance equal to the float64 distance of its row (rtol 1e-5)."""
    hits = 0
    for r, view in enumerate(views):
        ids = np.asarray(view.ids, dtype=np.int64)
        check(len(ids) == K, f"{label}: query {r} returned {len(ids)} rows")
        check(len(set(ids.tolist())) == len(ids), f"{label}: query {r} repeats an id")
        hits += len(set(ids.tolist()) & set(gt_i[r].tolist()))
        exact, atol = exact_dists(x, ids, q[r], metric)
        np.testing.assert_allclose(np.asarray(view.distances), exact, rtol=1e-5, atol=atol)
    recall = hits / (K * len(views))
    print(f"   {label}: recall@10 {recall:.4f} over {len(views)} queries", flush=True)
    check(recall >= floor, f"{label}: recall@10 {recall} < {floor}")
    return recall


def device_mallocs() -> int:
    """cudaMalloc calls the caching allocator has made so far."""
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def run_queries(coll, singles, b16, b256, where, **kw):
    """100 single searches (host clock each) and the batches; returns
    (views by batch size, single latencies (s), per batch size the seconds,
    garbage-collection seconds and new cudaMallocs of each call)."""
    lat, views = [], {1: []}
    for qv in singles:
        t0 = time.perf_counter()
        views[1].append(coll.search(qv, k=K, where=where, **kw))
        lat.append(time.perf_counter() - t0)
    calls = {}
    for b, blocks in ((16, b16), (256, b256)):
        views[b], calls[b] = [], {"s": [], "gc_s": [], "mallocs": []}
        for blk in blocks:
            GC.read()
            m0, t0 = device_mallocs(), time.perf_counter()
            views[b] += coll.batch_search(blk, k=K, where=where, **kw)
            calls[b]["s"].append(time.perf_counter() - t0)
            calls[b]["gc_s"].append(GC.read())
            calls[b]["mallocs"].append(device_mallocs() - m0)
    return views, np.array(lat), calls


def submit_phase(coll, rng) -> None:
    """The engine's async flat-path dispatch (the server's micro-batcher):
    batch_search_submit at B = 16, unfiltered and bucket = 3, resolved, with
    the ids and distances of batch_search on the same queries."""
    eng = coll._engine
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    for where in (None, "bucket = 3"):
        resolve = eng.batch_search_submit(q, K, where=where)
        check(resolve is not None, f"batch_search_submit({where!r}): None on a FLAT collection")
        got, want = resolve(), eng.batch_search(q, K, where=where)
        check(np.array_equal(np.asarray(got.ids), np.asarray(want.ids))
              and np.array_equal(np.asarray(got.distances), np.asarray(want.distances)),
              f"batch_search_submit({where!r}) differs from batch_search")
    print("   batch_search_submit at B=16 (unfiltered, bucket = 3): batch_search's ids and "
          "distances", flush=True)


def ivf_scan_phase(coll, q_sets, stats: Stats, mode: str) -> None:
    """K16 against its plain version on the built index, at B in {1, 16,
    256}, under the half filter: the route the batch takes, timed; the rows,
    tile and warp routes (ivf.scan_blocks_route) within K16's tolerance of
    the plain keys with the -inf pattern equal, rows and tile equal to each
    other to the bit; the shared launch forced to either side of its choice
    (min_share 0 and inf) equal to that route's keys to the bit, and the
    batch's own launch to the route it takes (ivf.shared_route)."""
    eng = coll._engine
    idx = eng._index
    state = idx._device_state(eng)
    live = eng.corpus().valid_mask(np.arange(N) % 10 < 5)
    metric = idx.metric
    with uncounted():
        for qs in q_sets:
            b = len(qs)
            qd = torch.from_numpy(qs).to(DEV)
            top_c = ivf._top_clusters(qd, state["centroids"], metric, NPROBE)
            args = (qd, (qd * qd).sum(-1), top_c, state["cluster_blocks"], state["blocks"],
                    state["block_sq"], state["block_orig"], live, metric)
            want = ivf.ivf_scan_blocks_plain(*args)
            fin = torch.isfinite(want)
            routes = {}
            for route in ("rows", "tile", "warp"):
                got = ivf.scan_blocks_route(*args, route)
                check(torch.equal(fin, torch.isfinite(got)),
                      f"ivf_scan_blocks {mode} B={b} {route}: masks")
                err = (got[fin] - want[fin]).abs()
                check(bool((err <= 1e-4 + 1e-5 * want[fin].abs()).all()),
                      f"ivf_scan_blocks {mode} B={b} {route}")
                stats.error("K16 ivf_scan_blocks", err.max())
                routes[route] = got.view(torch.int32)
            check(torch.equal(routes["rows"], routes["tile"]),
                  f"ivf_scan_blocks {mode} B={b}: the rows and tile routes' keys differ")
            for min_share, side in ((0.0, "tile"), (float("inf"), "warp")):
                got = ivf.scan_blocks_route(*args, "shared", min_share).view(torch.int32)
                check(torch.equal(got, routes[side]),
                      f"ivf_scan_blocks {mode} B={b}: the shared launch's {side} side differs")
            route = ivf._scan_route(b)
            taken = route if route == "rows" else ivf.shared_route(top_c, state["cluster_blocks"])
            check(torch.equal(ivf.ivf_scan_blocks(*args).view(torch.int32), routes[taken]),
                  f"ivf_scan_blocks {mode} B={b}: the batch's launch is not its {taken} route")
            del routes
            # bound: every distinct probed block's slot ids read once, the
            # live flag of its real rows, the data (and |x|^2 for L2) of its
            # live rows; the keys written
            blk = state["cluster_blocks"][top_c.long()].reshape(b, -1)
            distinct = torch.unique(blk[blk >= 0]).long()
            orig = state["block_orig"].view(-1, ivf.BLOCK_SIZE)[distinct]
            real = orig >= 0
            n_live = int((real & live[orig.clamp_min(0).long()]).sum())
            stats.time("K16 ivf_scan_blocks", f"{mode} B={b} nprobe={NPROBE}",
                       lambda: ivf.ivf_scan_blocks(*args), lambda: ivf.ivf_scan_blocks_plain(*args),
                       None, ivf_probe_bound(len(distinct), int(real.sum()), n_live, DIM,
                                             want.numel(), int(fin.sum()),
                                             metric is not Metric.IP),
                       route=route, route_on_card=taken,
                       probes_a_probed_block=ivf.probe_share(top_c, state["cluster_blocks"]),
                       empty_slot_share=float((blk < 0).float().mean()))
            del want, fin
    print(f"   {mode}: ivf_scan_blocks agrees with its plain version at B in "
          f"{[len(qs) for qs in q_sets]} on every route, rows and tile bit for bit, the "
          f"shared launch as it chose", flush=True)


def _keys64(q, x, ids, metric):
    """float64 keys (bigger = closer) of rows ``ids`` (B, L) for queries q."""
    rows = x[np.maximum(ids, 0)].astype(np.float64)
    q64 = q.astype(np.float64)[:, None, :]
    ip = (rows * q64).sum(-1)
    return ip if metric is Metric.IP else -((rows - q64) ** 2).sum(-1)


def beam_tier_args(tier: str, idx, corpus) -> tuple:
    """The arrays a guidance tier walks over (graph.beam_operands' args)."""
    if tier == "f32":
        return (corpus._data,)
    if tier == "bf16":
        aux = corpus.bf16_aux()
        return (corpus.data16, aux["mean"], aux["xm"], aux["xc_sq"], aux["xsq_true"])
    return idx._sq8_device() if tier == "sq8" else idx._pq_device()


@functools.cache
def load_latency_ms() -> float:
    """One dependent global load's ms on this card (graph.dependent_load_ms,
    a pointer chase), measured once."""
    ms = graph.dependent_load_ms(DEV)
    print(f"   dependent global load: {ms * 1e6:.1f} ns (pointer chase)", flush=True)
    return ms


def beam_phase(eng, tiers, kind: str, beam: int, q_sets, stats: Stats, label: str) -> None:
    """K17 against its plain version (on the card too, same operands) on the
    built index, at ``beam`` and B in {1, 16, 256}: the same pool keys, ids
    and visit counts. Times each tier at B=16 and B=256, beside the bytes
    bound and the latency bound (roofline.walk_bound)."""
    idx, corpus = eng._index, eng.corpus()
    live = corpus.valid_mask()[: idx.built_rows]
    hnsw = idx.kind == "hnsw"
    adj = idx._device(corpus)["layer0"] if hnsw else idx._graph()
    code = graph._KIND_CODE[kind]
    for tier in tiers:
        args = beam_tier_args(tier, idx, corpus)
        for qs in q_sets:
            b = len(qs)
            qd = torch.from_numpy(np.ascontiguousarray(qs)).to(DEV)
            starts = idx._starts(qd, corpus, live) if hnsw else idx._query_starts(eng, qd, live)
            ops = graph.beam_operands(tier, qd, *args, kind=kind)
            walk = (tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"], adj, starts, live)
            kw = dict(code=code, beam=beam, max_steps=2 * beam, expand=1)
            steps = {}
            got = graph.beam_walk(*walk, **kw)
            want = graph.beam_walk_plain(*walk, **kw, stats=steps)
            for g, w, what in zip(got, want, ("keys", "ids", "scanned")):
                check(torch.equal(g, w), f"K17 {label} {tier} B={b}: {what} differ")
            stats.error("K17 beam_search", 0.0)
            if b in (16, 256):
                # bytes bound: each visited node's row, aux terms and valid
                # byte, the adjacency row of each expanded node (at least the
                # pool's finite entries) read once, the pool written; beside
                # it the latency bound of the longest walk's steps
                row_bytes = ops["rows"].shape[1] * ops["rows"].element_size() + 4 * sum(
                    a is not None for a in ops["aux"])
                stats.time("K17 beam_search", f"{label} {tier} {kind} B={b} beam={beam}",
                           lambda: graph.beam_walk(*walk, **kw),
                           lambda: graph.beam_walk_plain(*walk, **kw), None,
                           walk_bytes_bound(int(got[2].sum()), row_bytes,
                                            int((got[0] > float("-inf")).sum()), adj.shape[1],
                                            b, beam, DIM), reps=3, plain_reps=1,
                           walk_bound_ms=walk_bound(steps["steps"], load_latency_ms())[0],
                           steps=steps["steps"])
        print(f"   K17 {label} {tier} ({kind}, beam {beam}): equal to its plain version at "
              f"B in {[len(qs) for qs in q_sets]}", flush=True)


def entry_scan_phase(eng, q_sets, report) -> None:
    """K18, the entry scan (K1 + K5, no kernel of its own) over the HNSW
    index's finest upper layer, against its plain version (K1's and K5's on
    the card), at B in {1, 16, 256}: the same entry ids except where two
    rows' keys lie within 1e-5 of each other. Times it at B=16."""
    idx, corpus = eng._index, eng.corpus()
    dev = idx._device(corpus)
    ids, ct = dev["upper_ids"], dev["upper_ct"]
    live = corpus.valid_mask()[: idx.built_rows]
    s = 4

    def plain(qd):
        qt = D.query_transform(qd, Metric.L2)
        keys = scan.flat_scores_f32_plain(qt["x"], ct["x"], qt["sq"], ct["sq"], live[ids.long()],
                                          Metric.L2)
        return ids[topk.topk_select_plain(keys, s)[1].long()]

    for qs in q_sets:
        qd = torch.from_numpy(np.ascontiguousarray(qs)).to(DEV)
        got = graph.entry_scan(qd, ct, ids, live, metric=Metric.L2, s=s)
        want = plain(qd)
        gi, wi = got.cpu().numpy(), want.cpu().numpy()
        local = np.arange(gi.size).reshape(gi.shape)  # keys of the gathered rows
        kg = _keys64(qs, corpus.host_rows(gi.ravel()), local, Metric.L2)
        kw = _keys64(qs, corpus.host_rows(wi.ravel()), local, Metric.L2)
        check(bool((np.abs(kg - kw) <= 1e-5 * np.abs(kw) + 1e-4).all()), "K18 entry scan ids")
        if len(qs) == 16:
            n_s = int(ids.shape[0])
            t = {"ms": cuda_ms(lambda: graph.entry_scan(qd, ct, ids, live, metric=Metric.L2, s=s)),
                 "plain_ms": cuda_ms(lambda: plain(qd)),
                 "library_ms": cuda_ms(lambda: torch.topk(qd @ ct["x"].T, s, dim=1))}
            t["bound_ms"], t["bound_by"] = bound(n_s * (DIM * 4 + 4 + 4 + 1) + 16 * DIM * 4
                                                 + 16 * s * 4, 2 * 16 * n_s * DIM)
            report[f"K18 entry_scan (K1 + K5) over {n_s} nodes, B=16"] = t
    print(f"   K18 entry_scan (K1 + K5) over {int(ids.shape[0])} upper-layer nodes: agrees with "
          "its plain version at B in [1, 16, 256]", flush=True)


def build_kernel_phase(eng, x: np.ndarray, rng, stats: Stats, build_phases: dict) -> None:
    """K19 on one 4,096-query chunk (the HNSW-L2 build's L=64 over all 1M
    rows) and K20 on one 4,096-node chunk of pass A (64 exact + 8 random
    candidates), each against its plain version on the card; K19's time
    printed beside the build's knn_candidates seconds (``build_phases``)."""
    corpus = eng.corpus()
    xd = corpus._data[:N]
    xsq = (xd * xd).sum(-1)
    chunk, l = 4096, 64
    q_ids = torch.arange(chunk, dtype=torch.int32, device=DEV)
    args = (xd[:chunk], q_ids, xd, xsq[:chunk], xsq, N, l, graph.TOPL_L2_RAW)
    gk, gi = graph.topl_scan(*args)
    wk, wi = graph.topl_scan_plain(*args)
    err = (gk - wk).abs()
    check(bool((err <= 1e-4 + 1e-5 * wk.abs()).all()), "K19: keys")
    gi_np, wi_np = gi.cpu().numpy(), wi.cpu().numpy()
    check(not (gi_np == np.arange(chunk)[:, None]).any(), "K19: a self-match")
    k_got, k_want = _keys64(x[:chunk], x, gi_np, Metric.L2), _keys64(x[:chunk], x, wi_np, Metric.L2)
    tol = 1e-5 * np.abs(k_want).max(axis=1, keepdims=True) + 1e-4
    check(bool((np.abs(k_got - k_want) <= tol).all()), "K19: ids differ beyond a near-tie")
    stats.error("K19 topl_scan", err.max())

    def library():
        for lo in range(0, N, 131072):
            torch.topk(2.0 * (xd[:chunk] @ xd[lo : lo + 131072].T) - xsq[None, lo : lo + 131072],
                       l, dim=1)

    label = f"L2 chunk={chunk} N={N} L={l}"
    stats.time("K19 topl_scan", label, lambda: graph.topl_scan(*args),
               lambda: graph.topl_scan_plain(*args), library, topl_bound(chunk, DIM, N, l), reps=3)
    print(f"   K19 topl_scan: a {chunk}-query chunk over {N} rows agrees with its plain "
          f"version (ids equal but at near-ties: {int((gi_np != wi_np).sum())} slots); "
          f"{stats.rows['K19 topl_scan'][label]['ms']:.4f} ms a chunk, the build's "
          f"knn_candidates phase {build_phases.get('knn_candidates', float('nan')):.3f} s",
          flush=True)

    extra = rng.integers(0, N, size=(chunk, 8)).astype(np.int32)
    cands = torch.cat([gi, torch.from_numpy(extra).to(DEV)], dim=1).contiguous()
    kw = dict(metric=Metric.L2, r=32, alpha=1.2, descending=False)
    got = graph.robust_prune(xd, q_ids, cands, **kw)
    want = graph.robust_prune_plain(xd, q_ids, cands, **kw)
    check(torch.equal(got, want), "K20: pruned lists differ")
    link = cands[:1024, :l].contiguous()  # the insert's shapes: 1,024 nodes, L = l_build
    pk, pp = graph.robust_prune(xd, q_ids[:1024], link, metric=Metric.L2, keys_only=True)
    wpk, wpp = graph.robust_prune_plain(xd, q_ids[:1024], link, metric=Metric.L2, keys_only=True)
    check(torch.equal(pk, wpk) and torch.equal(pp, wpp), "K20 keys mode differs")
    stats.error("K20 robust_prune", 0.0)
    m = cands.shape[1] + 1
    rows = xd[torch.cat([cands, q_ids[:, None]], 1).long()]
    stats.time("K20 robust_prune", f"L2 nodes={chunk} L={m - 1} r=32",
               lambda: graph.robust_prune(xd, q_ids, cands, **kw),
               lambda: graph.robust_prune_plain(xd, q_ids, cands, **kw),
               lambda: torch.bmm(rows, rows.transpose(1, 2)), prune_bound(chunk, m, DIM, r=32),
               reps=3)
    print(f"   K20 robust_prune: {chunk} nodes x {m - 1} candidates equal to its plain version "
          f"(both modes)", flush=True)


def graph_path(db, coll, x, centers, rng, q_sets, report, stats):
    """The graph phase: HNSW-L2 and DISKANN-IP at 1M (builds, searches,
    insert, delete), the deep tiers, the prefix modes, the kernel checks.
    Returns (results by label, the added rows, the deleted ids)."""
    out, eng = {}, coll._engine
    singles = q_sets[0]

    def build(c, mode):
        t0 = time.perf_counter()
        c.build_index(mode)
        report[f"{mode} build_s"] = time.perf_counter() - t0
        phases = c._engine._index.last_build_phases
        report[f"{mode} build_phases_s"] = phases
        print(f"   build_index({mode!r}): {report[f'{mode} build_s']:.2f} s {phases}", flush=True)
        t0 = time.perf_counter()
        c.search(centers[0], k=K, nprobe=GRAPH_NPROBE)  # stages the graph
        print(f"   first search: {time.perf_counter() - t0:.2f} s", flush=True)

    build(coll, "HNSW-L2")
    for where in (None, "bucket < 5"):
        out[("HNSW-L2", where)] = run_queries(coll, *q_sets, where, nprobe=GRAPH_NPROBE)
    sync()
    with uncounted():
        beam_phase(eng, ("f32", "bf16"), "l2", 100, [q_sets[0][:1], q_sets[1][0], q_sets[2][0]],
                   stats, "HNSW-L2")
        entry_scan_phase(eng, [q_sets[0][:1], q_sets[1][0], q_sets[2][0]], report)
        build_kernel_phase(eng, x, rng, stats, report["HNSW-L2 build_phases_s"])

    extra = mixture_queries(rng, centers, GRAPH_INSERT)
    t0 = time.perf_counter()
    coll.add(vectors=extra, fields=[{"bucket": i % 10} for i in range(N, N + GRAPH_INSERT)])
    coll.commit()  # links the rows into layer 0 in place
    sync()
    report["HNSW-L2 insert_s"] = time.perf_counter() - t0
    check(eng._index.built_rows == N + GRAPH_INSERT, "HNSW-L2: the new rows were not linked")
    print(f"   add + commit {GRAPH_INSERT} rows (layer-0 insert): "
          f"{report['HNSW-L2 insert_s']:.2f} s", flush=True)
    out[("HNSW-L2 inserted", None)] = run_queries(coll, singles, [], [], None, nprobe=GRAPH_NPROBE)

    build(coll, "DISKANN-IP")
    idx = eng._index
    check(idx.layered, "DISKANN-IP at 1M is layered (PQ and SQ8 fitted)")
    for where in (None, "bucket < 5"):
        out[("DISKANN-IP", where)] = run_queries(coll, *q_sets, where, nprobe=GRAPH_NPROBE)
    for tier in ("sq8", "pq"):
        setattr(idx, f"_force_{tier}", True)
        coll._engine._search_cache.clear()
        out[(f"DISKANN-IP {tier}", None)] = run_queries(coll, singles, [], [], None,
                                                        nprobe=GRAPH_NPROBE)
        setattr(idx, f"_force_{tier}", False)
    sync()
    with uncounted():
        beam_phase(eng, ("f32", "bf16", "sq8", "pq"), "ip", 125,
                   [q_sets[0][:1], q_sets[1][0], q_sets[2][0]], stats, "DISKANN-IP")

    n_all = N + GRAPH_INSERT
    dead = np.sort(rng.choice(n_all, int(GRAPH_DELETE * n_all), replace=False))
    t0 = time.perf_counter()
    coll.delete(dead.tolist())
    coll.commit()  # repairs the edges into the deleted nodes in place
    sync()
    report["DISKANN-IP delete_s"] = time.perf_counter() - t0
    print(f"   delete + commit {len(dead)} rows (edge repair): "
          f"{report['DISKANN-IP delete_s']:.2f} s", flush=True)
    out[("DISKANN-IP deleted", None)] = run_queries(coll, singles, [], [], None,
                                                    nprobe=GRAPH_NPROBE)

    pc = db.require_collection("prefix", dim=DIM)
    pc.add(vectors=x[:PREFIX], fields=[{"bucket": i % 10} for i in range(PREFIX)])
    pc.commit()
    for mode in ("HNSW-IP", "DISKANN-L2"):
        build(pc, mode)
        out[(f"{mode} prefix", None)] = run_queries(pc, *q_sets, None, nprobe=GRAPH_NPROBE)
    sync()
    return out, extra, dead


def check_graph(out, x, extra, dead, q_all, report) -> None:
    """recall@10 of every graph result set against the exact top 10 over
    the rows that set could return (>= 0.90 unfiltered; the half filter's
    recall reported, every id passing it); no repeated, filtered-out or
    deleted id; distances exact."""
    x_all = np.concatenate([x, extra])
    ids_all = np.arange(len(x_all))
    live = np.ones(len(x_all), dtype=bool)
    live[dead] = False
    cells = [  # label, metric, rows the index could return
        ("HNSW-L2", Metric.L2, ids_all[:N]),
        ("HNSW-L2 inserted", Metric.L2, ids_all),
        ("DISKANN-IP", Metric.IP, ids_all),
        ("DISKANN-IP sq8", Metric.IP, ids_all),
        ("DISKANN-IP pq", Metric.IP, ids_all),
        ("DISKANN-IP deleted", Metric.IP, ids_all[live]),
        ("HNSW-IP prefix", Metric.IP, ids_all[:PREFIX]),
        ("DISKANN-L2 prefix", Metric.L2, ids_all[:PREFIX]),
    ]
    for label, metric, rows in cells:
        for where in (None, "bucket < 5"):
            if (label, where) not in out:
                continue
            views, lat, calls = out[(label, where)]
            sel = rows if where is None else rows[rows % 10 < 5]
            n_q = 100 + sum(len(views[b]) for b in (16, 256) if b in views)
            _, gt = exact_topk(x_all, sel, q_all[:n_q], K, metric)
            name = f"{label} {'unfiltered' if where is None else where}"
            floor = GRAPH_RECALL_FLOOR if where is None else 0.0
            for b, lo, hi in ((1, 0, 100), (16, 100, 164), (256, 164, len(q_all))):
                if not views.get(b):
                    continue
                for v in views[b]:
                    got = np.asarray(v.ids, dtype=np.int64)
                    check(np.isin(got, sel).all(), f"{name} B={b}: an id outside the rows it "
                                                   "may return (filtered out or deleted)")
                report[f"{name} recall_b{b}"] = check_results(
                    x_all, q_all[lo:hi], views[b], gt[lo:hi], f"{name} B={b}", metric, floor)
                if b > 1:
                    report[f"{name} qps_b{b}"] = len(views[b]) / sum(calls[b]["s"])
            report[f"{name} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            report[f"{name} p99_ms"] = float(np.percentile(lat, 99) * 1e3)


# ── the metrics path: FLAT under the other 13 metrics ────────────────────

METRIC_MODES = {  # collection -> its FLAT modes
    "real": ("FLAT-L1", "FLAT-CHEBYSHEV", "FLAT-CANBERRA", "FLAT-BRAY-CURTIS", "FLAT-CORRELATION"),
    "hist": ("FLAT-HELLINGER", "FLAT-JENSEN-SHANNON", "FLAT-WASSERSTEIN"),
    "bits": ("FLAT-TANIMOTO-BINARY", "FLAT-JACCARD-BINARY", "FLAT-DICE-BINARY",
             "FLAT-HAMMING-BINARY"),
    "geo": ("FLAT-HAVERSINE",),
}
APPROX_MODES = ("FLAT-L1", "FLAT-CHEBYSHEV", "FLAT-CANBERRA", "FLAT-BRAY-CURTIS")
APPROX_RECALL_FLOOR = 0.90  # tests/test_approx.py:34
BITS_N, BITS_DIM, BITS_DENSITY, GEO_N = 1_000_000, 1024, 0.1, 1_000_000
# K9's C: 80 (K10's timed shortlist, K x 8; an approximate plan's k x
# oversample) and 256 (the host-rescore tier's and K8's shortlist at 1M rows,
# the timed one)
ELEM_TOPC_C = (80, 256)
N_MQ = 100 + 16 + 256  # the singles, one B=16 batch, one B=256 batch
SQUARED = (Metric.HELLINGER, Metric.JENSEN_SHANNON)  # held on the squared distance


def dist_tol(metric: Metric, d64: torch.Tensor) -> torch.Tensor:
    """A returned f32 distance's tolerance against float64 (on the squared
    distance for Hellinger and Jensen-Shannon): Hamming exact; Jaccard, Dice
    one f32 division; Wasserstein the cdf's cumulative sums; Haversine an f32
    angle's ulp (0.76 m of arc) on each coordinate; the rest f32 sums of D
    terms."""
    if metric is Metric.HAMMING:
        return torch.zeros_like(d64)
    if metric.is_binary:
        return torch.full_like(d64, 1e-6)
    if metric in SQUARED:  # f32 sums of D terms of about ln D (JS) or 1 / D (Hellinger)
        return torch.full_like(d64, 4e-7 * DIM)
    if metric is Metric.WASSERSTEIN:
        return 1e-4 * d64.abs() + 1e-5 * DIM
    if metric is Metric.HAVERSINE:
        return 1e-5 * d64 + 4.0
    return 1e-5 * d64.abs() + 1e-5


def _sq(metric: Metric, d: torch.Tensor) -> torch.Tensor:
    return d * d if metric in SQUARED else d


def _prob64(t: torch.Tensor):
    bad = (~torch.isfinite(t) | (t < 0)).any(1)
    t = torch.where(bad[:, None], 0.0, t)
    mass = t.sum(1)
    return t / torch.where(mass > 0, mass, 1.0)[:, None], mass, bad


def dist64(metric: Metric, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float64 (Q, C) distances, written from the metrics' definitions (the
    reference's policies for constant, zero-mass, invalid and out-of-range
    rows), independent of the port's code."""
    inf = float("inf")
    if metric is Metric.L1:
        return torch.cdist(q, x, p=1)
    if metric is Metric.CHEBYSHEV:
        return torch.cdist(q, x, p=inf)
    if metric is Metric.BRAY_CURTIS:
        num, den = torch.cdist(q, x, p=1), torch.cdist(q, -x, p=1)
        return torch.where(den == 0, torch.where(num == 0, 0.0, inf), num / den)
    if metric is Metric.CANBERRA:
        a, b = q[:, None], x[None]
        den = a.abs() + b.abs()
        return torch.where(den == 0, 0.0, (a - b).abs() / den).sum(-1)
    if metric is Metric.CORRELATION:
        qc, xc = q - q.mean(1, keepdim=True), x - x.mean(1, keepdim=True)
        vq, vx = (qc * qc).sum(1)[:, None], (xc * xc).sum(1)[None]
        r = (qc @ xc.T) / torch.sqrt(vq * vx)
        same = (vq <= 1e-12) & (vx <= 1e-12) & (q.mean(1)[:, None] == x.mean(1)[None])
        return torch.where((vq <= 1e-12) | (vx <= 1e-12), torch.where(same, 0.0, 1.0),
                           1.0 - r.clamp(-1.0, 1.0))
    if metric in (Metric.HELLINGER, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON):
        (pq, mq, bq), (px, mx, bx) = _prob64(q), _prob64(x)
        if metric is Metric.HELLINGER:
            d, zero = torch.sqrt((1.0 - torch.sqrt(pq) @ torch.sqrt(px).T).clamp_min(0.0)), 1.0
        elif metric is Metric.WASSERSTEIN:
            d, zero = torch.cdist(pq.cumsum(1)[:, :-1], px.cumsum(1)[:, :-1], p=1), inf
        else:
            a, b = pq[:, None], px[None]
            js = np.log(2.0) + 0.5 * (torch.xlogy(a, a) + torch.xlogy(b, b)
                                      - torch.xlogy(a + b, a + b)).sum(-1)
            d, zero = torch.sqrt(js.clamp_min(0.0)), float(np.sqrt(np.log(2.0)))
        zq, zx = (mq == 0)[:, None], (mx == 0)[None]
        d = torch.where(zq | zx, torch.where(zq & zx, 0.0, zero), d)
        return torch.where(bq[:, None] | bx[None], inf, d)
    if metric.is_binary:
        inter = q @ x.T
        cq, cx = q.sum(1)[:, None], x.sum(1)[None]
        if metric is Metric.HAMMING:
            return cq + cx - 2 * inter
        if metric is Metric.DICE:
            return torch.where(cq + cx == 0, 0.0, 1.0 - 2 * inter / (cq + cx))
        return torch.where(cq + cx - inter == 0, 0.0, 1.0 - inter / (cq + cx - inter))
    rad = np.pi / 180.0  # Haversine: (lon, lat) degrees, the IUGG mean radius
    lon1, lat1 = q[:, 0:1] * rad, q[:, 1:2] * rad
    lon2, lat2 = x[None, :, 0] * rad, x[None, :, 1] * rad
    h = torch.sin((lat2 - lat1) / 2) ** 2 + torch.cos(lat1) * torch.cos(lat2) * torch.sin(
        (lon2 - lon1) / 2) ** 2
    d = 2 * 6_371_008.8 * torch.asin(torch.sqrt(h.clamp(0.0, 1.0)))
    bad_q, bad_x = q[:, 1].abs() > 90, x[:, 1].abs() > 90
    return torch.where(bad_q[:, None] | bad_x[None], inf, d)


def brute64(metric: Metric, q64: torch.Tensor, rows: torch.Tensor, masks: dict, k: int) -> dict:
    """Chunked float64 brute force on the card: for each allowed-row mask,
    the k smallest distances (Q, k), ascending, and their row ids."""
    n, (nq, d) = rows.shape[0], q64.shape
    step = max(256, (1 << 26) // (nq * d)) if metric in (
        Metric.JENSEN_SHANNON, Metric.CANBERRA) else 1 << 16
    best = {name: None for name in masks}
    for lo in range(0, n, step):
        dd = dist64(metric, q64, rows[lo : lo + step].double())
        for name, ok in masks.items():
            part = torch.where(ok[lo : lo + step][None], dd, float("inf"))
            v, i = torch.topk(part, min(k, part.shape[1]), dim=1, largest=False)
            if best[name] is not None:
                v, i = torch.cat([best[name][0], v], 1), torch.cat([best[name][1], i + lo], 1)
                v, j = torch.topk(v, min(k, v.shape[1]), dim=1, largest=False)
                best[name] = (v, i.gather(1, j))
            else:
                best[name] = (v, i + lo)
    return best


def check_metric_views(metric, label, views, q64, rows, ok, kth, floor) -> float:
    """Every returned row allowed (filter, live), no repeat, no row at +inf,
    each distance within its tolerance of float64; recall@10 where a row
    counts when its float64 distance is at most the 10th true one plus the
    tolerance (Hamming's integer ties)."""
    hits = 0
    for lo in range(0, len(views), 50):
        blk = views[lo : lo + 50]
        ids = np.stack([np.asarray(v.ids, dtype=np.int64) for v in blk])
        check(ids.shape[1] == K, f"{label}: {ids.shape[1]} rows returned, {K} asked")
        check(all(len(set(r.tolist())) == K for r in ids), f"{label}: a repeated id")
        ids_d = torch.from_numpy(ids).to(DEV)
        check(bool(ok[ids_d].all()), f"{label}: a filtered-out or deleted row returned")
        got = torch.from_numpy(np.stack([np.asarray(v.distances) for v in blk])).to(DEV).double()
        nb = len(blk)
        full = dist64(metric, q64[lo : lo + nb], rows[ids_d.ravel()].double())
        d64 = full.view(nb, nb, K)[torch.arange(nb), torch.arange(nb)]  # each query's own rows
        check(bool(torch.isfinite(got).all()), f"{label}: a row at +inf distance returned")
        err = (_sq(metric, got) - _sq(metric, d64)).abs()
        check(bool((err <= dist_tol(metric, d64)).all()),
              f"{label}: a distance off float64 by {float(err.max())}")
        t = kth[lo : lo + nb, None]
        hits += int((_sq(metric, d64) <= _sq(metric, t) + dist_tol(metric, t)).sum())
    recall = hits / (K * len(views))
    print(f"   {label}: recall@10 {recall:.4f} over {len(views)} queries", flush=True)
    check(recall >= floor, f"{label}: recall@10 {recall} < {floor}")
    return recall


def keys_error(metric: Metric, got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """A distance kernel's keys against its plain version's: the binary
    family and Chebyshev equal; else the same -inf slots and distances within
    rtol 1e-5 (the squared distance for Hellinger and Jensen-Shannon, atol
    4e-7 x D; Haversine atol 1 m; Wasserstein atol 1e-5 x D): sums in
    another order."""
    if metric.is_binary or metric is Metric.CHEBYSHEV:
        check(torch.equal(got, want), f"{what}: keys differ from the plain version's")
        return 0.0
    check(torch.equal(torch.isinf(got), torch.isinf(want)), f"{what}: -inf slots differ")
    fin = torch.isfinite(want)
    g, w = -got[fin].double(), -want[fin].double()
    if metric in SQUARED:
        err, tol = (g * g - w * w).abs(), 4e-7 * DIM + 1e-5 * w * w
    else:
        atol = {Metric.HAVERSINE: 1.0, Metric.WASSERSTEIN: 1e-5 * DIM}.get(
            metric, 1e-5 * float(w.abs().max()))
        err, tol = (g - w).abs(), atol + 1e-5 * w.abs()
    check(bool((err <= tol).all()), f"{what}: off the plain version by {float(err.max())}")
    return float((g - w).abs().max()) if len(g) else 0.0


def metric_kernel_phase(corpus: DeviceCorpus, metric: Metric, qs: np.ndarray, stats: Stats,
                        timed: tuple) -> None:
    """K6a / K6b / K6c against their plain version at the path's shapes (the
    staged 1M-row transform, B in {1, 16, 256}; the L1 family's bf16 mode
    and every metric's gather mode over a shortlist of K x 8 rows at B = 16),
    timed at the batch sizes ``timed``."""
    ct, valid = corpus.transform(metric), corpus.valid_mask()
    rows, n_live, d = valid.shape[0], int(valid.sum()), corpus.dim
    if metric in D.BINARY_METRICS:
        name, w = "K6b binary_scores", D.words_for(d)
        x01 = torch.empty((rows, 32 * w), dtype=torch.bfloat16, device=DEV)
        for lo in range(0, rows, 1 << 16):
            x01[lo : lo + (1 << 16)] = D.unpack_bits(ct["bits"][lo : lo + (1 << 16)])
    elif metric in D.ELEMENTWISE_METRICS:
        name = "K6c elementwise_scores"
    else:
        name = "K6a gemm_metric_scores"
    for b in BATCHES:
        qd = torch.from_numpy(np.ascontiguousarray(qs[:b])).to(DEV)
        qt = D.query_transform(qd, metric)
        got = scan.metric_keys(qt, ct, valid, metric)
        want = scan.metric_keys_plain(qt, ct, valid, metric)
        stats.error(name, keys_error(metric, got, want, f"{name} {metric.value} B={b}"))
        del got, want
        if b not in timed:
            continue
        keys_bytes = b * rows * 4 + rows + b * d * 4
        library = None
        if name == "K6b binary_scores":
            q01 = D.unpack_bits(qt["bits"]).to(torch.bfloat16)
            library = lambda: q01 @ x01.T  # noqa: E731
            bd = binary_tile_bound(b, w, n_live, rows)
        elif name == "K6a gemm_metric_scores":
            lead = scan._gemm_rows(ct, metric)
            ql = scan._gemm_rows(qt, metric)
            library = lambda: ql @ lead.T  # noqa: E731
            bd = f32_tile_bound(b, d, n_live, rows, 8 if metric is Metric.CORRELATION else 5)
        else:
            x32 = corpus._data
            if metric in (Metric.L1, Metric.CHEBYSHEV):
                p = 1 if metric is Metric.L1 else float("inf")
                library = accepted(lambda: torch.cdist(qd, x32, p=p))
            # the lead rows' width (Wasserstein's cdf has d - 1 columns) and
            # the per-row terms: a mass and an invalid byte, and an entropy
            lead = scan._elem_rows(ct, metric).shape[1]
            extra = {Metric.WASSERSTEIN: 5, Metric.JENSEN_SHANNON: 9}.get(metric, 0)
            bd = elem_tile_bound(metric.value, b, lead, n_live, rows, extra)
        # at B = 256 the plain versions take 0.25-0.8 s a call: one timed
        # launch after the warm-up for the K6c metrics past L1
        reps = 10 if b < 256 else (1 if name == "K6c elementwise_scores" and
                                   metric is not Metric.L1 else 3)
        stats.time(name, f"{metric.value} B={b}", lambda: scan.metric_keys(qt, ct, valid, metric),
                   lambda: scan.metric_keys_plain(qt, ct, valid, metric), library, bd, reps=reps)
    # the gather mode (the approximate search's f32 rescore, K10) at B = 16
    qd = torch.from_numpy(np.ascontiguousarray(qs[:16])).to(DEV)
    qt = D.query_transform(qd, metric)
    c = K * 8
    ids = torch.randint(0, corpus.n, (16, c), device=DEV, dtype=torch.int32)
    ids[:, -4:] = -1
    got = scan.metric_keys(qt, ct, None, metric, ids=ids)
    want = scan.metric_keys_plain(qt, ct, None, metric, ids=ids)
    stats.error(name, keys_error(metric, got, want, f"{name} {metric.value} gather"))
    if metric is Metric.L1:
        n_cand = int((ids >= 0).sum())
        stats.time(name, f"l1 gather B=16 C={c}",
                   lambda: scan.metric_keys(qt, ct, None, metric, ids=ids),
                   lambda: scan.metric_keys_plain(qt, ct, None, metric, ids=ids), None,
                   bound_t(n_cand * d * 4 + 16 * c * 8 + 16 * d * 4,
                           n_cand * d * ELEM_DIM_OPS[metric.value][0] / F32_OPS))
    print(f"   {name} {metric.value}: agrees with its plain version at B in {BATCHES} and in "
          f"the gather mode", flush=True)
    if metric not in (Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS):
        return
    mean, x16 = corpus.bf16_aux()["mean"], corpus.data16  # K9: the fused bf16 pass
    for b in BATCHES:
        q = torch.from_numpy(np.ascontiguousarray(qs[:b])).to(DEV)
        full = scan.metric_keys_plain({"x": q}, {"x": x16}, valid, metric, mean=mean)
        for c in ELEM_TOPC_C:
            got = scan.elementwise_topc(q, x16, mean, valid, metric, c)
            stats.error("K9 elementwise_topc",
                        check_elem_topc(metric, got, full, c, f"K9 {metric.value} B={b} C={c}"))
            del got
        del full
        c = ELEM_TOPC_C[-1]
        stats.time("K9 elementwise_topc", f"{metric.value} B={b} C={c}",
                   lambda: scan.elementwise_topc(q, x16, mean, valid, metric, c),
                   lambda: scan.elementwise_topc_plain(q, x16, mean, valid, metric, c), None,
                   elem_topc_bound(metric.value, b, d, n_live, rows, c),
                   reps=10 if b < 256 else 3, plain_reps=1 if b == 256 else 3)
    print(f"   K9 {metric.value}: the fused bf16 pass agrees with its plain chain at B in "
          f"{BATCHES} and C in {ELEM_TOPC_C}", flush=True)


def check_elem_topc(metric: Metric, got, full: torch.Tensor, c: int, what: str) -> float:
    """K9's (keys, ids) against the plain keys ``full`` (B, N) of the same
    inputs: keys best first, each within keys_error's tolerance of the plain
    key of its row; the ids the plain top C's, but a row only one side holds
    lies within that tolerance of the plain C-th key (Chebyshev: equal to
    the plain chain's). Returns the largest key error."""
    keys, ids = got
    want_k, want_i = topk.topk_select_plain(full, c)
    if metric is Metric.CHEBYSHEV:
        check(torch.equal(keys, want_k) and torch.equal(ids, want_i), f"{what}: differs")
        return 0.0
    check(bool((keys[:, 1:] <= keys[:, :-1]).all()), f"{what}: keys out of order")
    err = keys_error(metric, keys, full.gather(1, ids.long()), what)
    fin = torch.isfinite(want_k)
    scale = float(want_k[fin].abs().max()) if bool(fin.any()) else 0.0
    diff = 0
    for r in range(len(ids)):
        only = torch.tensor(sorted(set(ids[r].tolist()) ^ set(want_i[r].tolist())),
                            dtype=torch.long, device=DEV)
        if len(only):
            diff += len(only)
            gap = (full[r, only].double() - want_k[r, -1].double()).abs()
            same_inf = torch.isinf(full[r, only]) & torch.isinf(want_k[r, -1])
            check(bool((same_inf | (gap <= 2e-5 * scale + 1e-5)).all()),
                  f"{what}: a row beyond a near-tie of the C-th key")
    if diff:
        print(f"   {what}: {diff} ids differ from the plain chain's, each a near-tie",
              flush=True)
    return err


def metric_collection(db, name: str, x: np.ndarray):
    coll = db.require_collection(name, dim=x.shape[1])
    t0 = time.perf_counter()
    coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(len(x))], batch_size=100_000)
    coll.commit()
    return coll, time.perf_counter() - t0


def fingerprints(gen: torch.Generator, protos: torch.Tensor, n: int) -> torch.Tensor:
    """ECFP-like {0, 1} rows: a scaffold prototype (10% density) with 2% of
    its bits flipped. (n, BITS_DIM) uint8 on the card."""
    out = torch.empty((n, BITS_DIM), dtype=torch.uint8, device=DEV)
    for lo in range(0, n, 1 << 16):
        m = min(1 << 16, n - lo)
        pick = torch.randint(0, protos.shape[0], (m,), generator=gen, device=DEV)
        flip = torch.rand((m, BITS_DIM), generator=gen, device=DEV) < 0.02
        out[lo : lo + m] = protos[pick] ^ flip
    return out


def metrics_path(db, coll, x, extra, dead, centers, rng, report, stats) -> None:
    """The metrics phase: the phase-4 collection rebuilt as FLAT-L1,
    -CHEBYSHEV, -CANBERRA, -BRAY-CURTIS and -CORRELATION; 1M x 128 histograms
    (Hellinger, Jensen-Shannon, Wasserstein); 1M x 1,024 fingerprints
    (Tanimoto, Jaccard, Dice, Hamming); 1M geo points (Haversine). Each mode:
    100 single queries and a batch at B = 16 and 256, unfiltered and
    ``bucket = 3``; the L1 family also approx=True at B = 16, FLAT-L1 also
    search_range(max_results=1000); every answer held to a float64 brute
    force on the card; the kernels against their plain versions. Returns the
    data sets by kind: (collection, rows, live mask or None, queries)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    x_real = np.concatenate([x, extra])
    live = np.ones(len(x_real), dtype=bool)
    live[dead] = False
    q_real = mixture_queries(rng, centers, N_MQ)
    x_hist = np.exp(x)
    x_hist[rng.choice(N, 1000, replace=False), rng.integers(0, DIM, 1000)] = -1.0  # invalid
    x_hist[rng.choice(N, 100, replace=False)] = 0.0  # zero mass
    q_hist = np.exp(mixture_queries(rng, centers, N_MQ)).astype(np.float32)
    protos = torch.rand((N_CENTERS, BITS_DIM), generator=gen, device=DEV) < BITS_DENSITY
    bits_dev, q_bits = fingerprints(gen, protos, BITS_N), fingerprints(gen, protos, N_MQ)
    lon, lat = rng.uniform(-180, 180, GEO_N), np.degrees(np.arcsin(rng.uniform(-1, 1, GEO_N)))
    lat[rng.choice(GEO_N, 100, replace=False)] = 95.0  # |lat| > 90: +inf
    x_geo = np.stack([lon, lat], 1).astype(np.float32)
    q_geo = np.stack([rng.uniform(-180, 180, N_MQ),
                      np.degrees(np.arcsin(rng.uniform(-1, 1, N_MQ)))], 1).astype(np.float32)
    sets = {"real": (coll, x_real, live, q_real), "hist": (None, x_hist, None, q_hist),
            "bits": (None, bits_dev, None, q_bits.cpu().numpy().astype(np.float32)),
            "geo": (None, x_geo, None, q_geo)}
    # K6c every metric, K6a and K6b their first ones, at B = 1, 16 and 256
    timed = {"FLAT-CORRELATION": BATCHES, "FLAT-HELLINGER": (16,), "FLAT-TANIMOTO-BINARY": BATCHES,
             **{f"FLAT-{m.value.upper().replace('_', '-')}": BATCHES
                for m in D.ELEMENTWISE_METRICS}}
    for kind, (c, rows, live_np, qs) in sets.items():
        if c is None:
            host = rows.cpu().numpy().astype(np.float32) if torch.is_tensor(rows) else rows
            c, t_add = metric_collection(db, kind, host)
            sets[kind] = (c, rows, live_np, qs)  # the index-metrics phase reuses them
            del host
            report[f"metrics {kind} add+commit_s"] = t_add
            print(f"   {kind}: add + commit {len(rows)} x {rows.shape[1]}: {t_add:.2f} s",
                  flush=True)
        n = rows.shape[0]
        rows_d = rows if torch.is_tensor(rows) else torch.from_numpy(rows).to(DEV)
        ok = torch.ones(n, dtype=torch.bool, device=DEV) if live_np is None else torch.from_numpy(
            live_np).to(DEV)
        masks = {None: ok, "bucket = 3": ok & (torch.arange(n, device=DEV) % 10 == 3)}
        q64 = torch.from_numpy(qs).to(DEV).double()
        gts = {}
        for mode in METRIC_MODES[kind]:
            metric = Metric.from_index_mode(mode)
            c.build_index(mode)
            t0 = time.perf_counter()
            c.search(qs[0], k=K)  # stages the metric's transform
            print(f"   {mode}: first search (the transform): {time.perf_counter() - t0:.2f} s",
                  flush=True)
            out = {where: run_queries(c, qs[:100], [qs[100:116]], [qs[116:]], where)
                   for where in masks}
            approx = []
            if mode in APPROX_MODES:
                approx = [v for blk in qs[:64].reshape(4, 16, -1)
                          for v in c.batch_search(blk, k=K, approx=True)]
            if mode == "FLAT-L1":
                big = [c.search(qv, k=BIG_K) for qv in qs[:4]]
                thresholds = [float(np.asarray(v.distances)[BIG_K // 2]) for v in big]
                ranged = [c.search_range(qv, t, max_results=BIG_K)
                          for qv, t in zip(qs[:4], thresholds)]
            sync()
            with uncounted():
                metric_kernel_phase(c._engine.corpus(), metric, qs, stats, timed.get(mode, (16,)))
            ref = Metric.JACCARD if metric is Metric.TANIMOTO else metric  # one formula
            if ref not in gts:
                gts[ref] = brute64(ref, q64, rows_d, masks, K)
            gt = gts[ref]
            for where, (views, lat, calls) in out.items():
                label = f"{mode} {'unfiltered' if where is None else where}"
                kth = gt[where][0][:, K - 1]
                for b, lo, hi in ((1, 0, 100), (16, 100, 116), (256, 116, N_MQ)):
                    report[f"{label} recall_b{b}"] = check_metric_views(
                        metric, f"{label} B={b}", views[b], q64[lo:hi], rows_d, masks[where],
                        kth[lo:hi], RECALL_FLOOR)
                    if b > 1:
                        report[f"{label} qps_b{b}"] = len(views[b]) / sum(calls[b]["s"])
                report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
                report[f"{label} p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            if approx:
                report[f"{mode} approx recall_b16"] = check_metric_views(
                    metric, f"{mode} approx=True B=16", approx, q64[:64], rows_d, masks[None],
                    gt[None][0][:64, K - 1], APPROX_RECALL_FLOOR)
            if mode == "FLAT-L1":
                top = brute64(metric, q64[:4], rows_d, {None: ok}, BIG_K)[None]
                for r, (view, t) in enumerate(zip(ranged, thresholds)):
                    got = torch.from_numpy(np.asarray(view.ids, dtype=np.int64)).to(DEV)
                    d64 = dist64(metric, q64[r : r + 1], rows_d[got].double())[0]
                    tol = 1e-5 * t + 1e-5
                    check(bool((d64 <= t + tol).all()), f"search_range L1: query {r} out of range")
                    inside = set(top[1][r][top[0][r] < t - tol].tolist())
                    check(inside <= set(got.tolist()), f"search_range L1: query {r} misses rows")
                print(f"   {mode} search_range(max_results={BIG_K}): every row in range, none "
                      "outside", flush=True)
        del rows_d, q64, masks, gts
        torch.cuda.empty_cache()
    return sets


# ── the index-metrics path: IVF under Hamming / Jaccard, HNSW under the
# ── domain metrics ──────────────────────────────────────────────────────

INDEX_METRIC_MODES = {  # data set -> its modes
    "bits": ("IVF-HAMMING", "IVF-JACCARD"),
    "real graph prefix": ("HNSW-L1",),
    "geo graph prefix": ("HNSW-HAVERSINE",),
    "real prefix": ("HNSW-CHEBYSHEV", "HNSW-CORRELATION"),
    "hist prefix": ("HNSW-HELLINGER", "HNSW-WASSERSTEIN", "HNSW-JENSEN-SHANNON"),
}
INSERTED = ("HNSW-L1", "IVF-HAMMING")  # INDEX_METRIC_INSERT rows added, searched again
# HNSW-L1 and HNSW-HAVERSINE build on the first rows of the mixture and of
# the geo points (each 1M build took 17-27 s; the phase's depth, not its
# paths, was cut to keep the script inside its time limit)
GRAPH_METRIC_ROWS = 250_000
INDEX_METRIC_INSERT = 2_500  # the rows INSERTED's modes take (phase 8: GRAPH_INSERT)
# recall@10 floors against the full brute force. IVF-JACCARD is held instead
# to the exact answer over the clusters its probe picks (probed_kth): the
# reference's probe, the query's Jaccard distance to the centroids
# thresholded at 0.5, ties the many centroids whose thresholded bits are few
# or none, and its recall on scaffold fingerprints is about 0.6 in both
# packages (PERF.md §6), so its full-brute-force recall is reported.
BINARY_IVF_FLOOR = {"IVF-HAMMING": IVF_RECALL_FLOOR, "IVF-JACCARD": 0.0}
TOPL_CHUNK = 1024  # K19's timed chunk under L1 (and its library call's)
# the domain-metric forms of K17, K19 and K20 (the JAX package's
# _keyed_pairwise inside its beam, _topl_generic and candidate_pair_keys),
# reported apart from their IP / L2 / cosine rows: name -> (the kernel, the
# JAX function it replaces)
K6G = {"K6g beam_search": ("K17 beam_search", "lynsedb_tpu/ops/graph.py:99"),
       "K6g topl_scan": ("K19 topl_scan", "lynsedb_tpu/ops/graph.py:815"),
       "K6g robust_prune": ("K20 robust_prune", "lynsedb_tpu/ops/graph.py:446")}


def binary_ivf_phase(coll, qs: np.ndarray, stats: Stats, mode: str) -> None:
    """K16b against its plain version on the built index, equal to the bit,
    at B in {1, 16, 256} under the half filter, timed at each."""
    eng = coll._engine
    idx = eng._index
    state = idx._device_state(eng)
    n = eng.corpus().n
    live = eng.corpus().valid_mask(np.arange(n) % 10 < 5)
    metric, w = idx.metric, state["blocks"].shape[2]
    with uncounted():
        for b in BATCHES:
            qd = torch.from_numpy(np.ascontiguousarray(qs[:b])).to(DEV)
            qt = D.query_transform(qd, metric)
            top_c = ivf._top_clusters(qd, state["centroids"], metric, NPROBE)
            args = (qt["bits"], qt["cnt"], top_c, state["cluster_blocks"], state["blocks"],
                    state["block_sq"], state["block_orig"], live, metric)
            got, want = ivf.ivf_binary_blocks(*args), ivf.ivf_scan_blocks_plain(*args)
            check(torch.equal(got, want), f"K16b {mode} B={b}: keys differ from the plain version")
            stats.error("K16b ivf_binary_blocks", 0.0)
            # bound (roofline.binary_probe_bound): the distinct probed blocks
            blk = state["cluster_blocks"][top_c.long()].reshape(b, -1)
            distinct = torch.unique(blk[blk >= 0]).long()
            orig = state["block_orig"].view(-1, ivf.BLOCK_SIZE)[distinct]
            real = orig >= 0
            n_live = int((real & live[orig.clamp_min(0).long()]).sum())
            stats.time("K16b ivf_binary_blocks", f"{mode} B={b} nprobe={NPROBE}",
                       lambda: ivf.ivf_binary_blocks(*args),
                       lambda: ivf.ivf_scan_blocks_plain(*args), None,
                       binary_probe_bound(len(distinct), int(real.sum()), n_live, w, got.numel(),
                                          int(torch.isfinite(got).sum())),
                       reps=3 if b == 256 else 10, plain_reps=1 if b > 1 else 3)
            del got, want
    print(f"   K16b {mode}: equal to its plain version at B in {list(BATCHES)}", flush=True)


def metric_graph_phase(eng, mode: str, qs: np.ndarray, stats: Stats, timed: bool,
                       build_phases: dict) -> None:
    """K17's metric tier (beam 100, B in {1, 16, 256}) and K20's pair tables
    (1,024 nodes of pass A's shape) equal to their plain versions to the
    bit, and K19's metric mode (256 queries of the build's L = 64 over every
    row) within the distance tolerance, on the built index. ``timed``: K19
    on a TOPL_CHUNK-query chunk beside the library's top-L and the build's
    knn_candidates seconds (``build_phases``), K20 on 4,096 nodes, every one
    against its bound."""
    idx, corpus = eng._index, eng.corpus()
    metric = idx.metric
    dev = idx._device(corpus)
    space, adj, n = dev["space"], dev["layer0"], idx.built_rows
    live = corpus.valid_mask()[:n]
    d = space.rows.shape[1]
    row_bytes = d * 4 + (12 if space.terms is not None else 0)
    elem_ops = 1 if metric is Metric.HAVERSINE else d * ELEM_DIM_OPS.get(metric.value, (2, 0))[0]
    code = graph._KIND_CODE[metric.value]
    kw = dict(code=code, beam=GRAPH_NPROBE, max_steps=2 * GRAPH_NPROBE, expand=1)
    with uncounted():
        for b in BATCHES if timed else (16,):
            qd = torch.from_numpy(np.ascontiguousarray(qs[:b])).to(DEV)
            ops = graph.beam_operands("metric", qd, space, kind=metric.value)
            walk = ("metric", ops["qop"], None, ops["rows"], ops["aux"], adj,
                    idx._starts(qd, corpus, live), live)
            steps = {}
            got = graph.beam_walk(*walk, **kw)
            want = graph.beam_walk_plain(*walk, **kw, stats=steps)
            for g, w, what in zip(got, want, ("keys", "ids", "scanned")):
                check(torch.equal(g, w), f"K17 {mode} B={b}: {what} differ")
            stats.error("K6g beam_search", 0.0)
            if b == 16:
                visits = int(got[2].sum())
                expanded = int((got[0] > float("-inf")).sum())
                stats.time("K6g beam_search", f"{mode} B={b} beam={GRAPH_NPROBE}",
                           lambda: graph.beam_walk(*walk, **kw),
                           lambda: graph.beam_walk_plain(*walk, **kw), None,
                           bound_t(visits * (row_bytes + 1) + expanded * adj.shape[1] * 4
                                   + b * GRAPH_NPROBE * 8, visits * elem_ops / F32_OPS), reps=3,
                           walk_bound_ms=walk_bound(steps["steps"], load_latency_ms())[0],
                           steps=steps["steps"])

        l = 64
        for chunk in (256, TOPL_CHUNK) if timed else (256,):
            q_ids = torch.arange(chunk, dtype=torch.int32, device=DEV)
            args = (space[:chunk], q_ids, space, None, None, n, l, graph.TOPL_METRIC)
            gk, gi = graph.topl_scan(*args)
            wk, wi = graph.topl_scan_plain(*args)
            err = keys_error(metric, gk, wk, f"K19 {mode} chunk={chunk}")
            rekeyed = scan.metric_keys_plain(space[:chunk].transform(), space.transform(), None,
                                             metric, ids=gi.clamp_min(0))
            keys_error(metric, torch.where(torch.isfinite(wk), rekeyed, wk), wk,
                       f"K19 {mode} chunk={chunk}: ids beyond a near-tie")
            stats.error("K6g topl_scan", err)
            del gk, gi, wk, wi, rekeyed
            if chunk == TOPL_CHUNK:
                x32, qx = space.rows, space.rows[:chunk]

                def library():
                    for lo in range(0, n, 131072):
                        torch.topk(-torch.cdist(qx, x32[lo : min(lo + 131072, n)], p=1), l, dim=1)

                label = f"{mode} chunk={chunk} N={n} L={l}"
                stats.time("K6g topl_scan", label,
                           lambda: graph.topl_scan(*args), lambda: graph.topl_scan_plain(*args),
                           accepted(library) if metric is Metric.L1 else None,
                           topl_bound(chunk, d, n, l, elem_ops, row_bytes), reps=1)
                print(f"   K19 {mode}: {stats.rows['K6g topl_scan'][label]['ms']:.4f} ms a "
                      f"{chunk}-query chunk, the build's knn_candidates phase "
                      f"{build_phases.get('knn_candidates', float('nan')):.3f} s", flush=True)
        print(f"   K6g {mode}: K17's metric tier equal to its plain version, K19's metric mode "
              f"within the distance tolerance", flush=True)

        rng = np.random.default_rng(SEED + 3)
        for nodes in (1024, 4096) if timed else (1024,):  # pass A: l exact + 8 random
            q_ids = torch.arange(nodes, dtype=torch.int32, device=DEV)
            _, near = graph.topl_scan(space[:nodes], q_ids, space, None, None, n, l,
                                      graph.TOPL_METRIC)
            extra = torch.from_numpy(rng.integers(0, n, size=(nodes, 8)).astype(np.int32)).to(DEV)
            cands = torch.cat([near, extra], dim=1).contiguous()
            pkw = dict(metric=metric, r=32, alpha=1.2)
            got = graph.robust_prune(space, q_ids, cands, **pkw)
            check(torch.equal(got, graph.robust_prune_plain(space, q_ids, cands, **pkw)),
                  f"K20 {mode}: pruned lists differ")
            gp, gq = graph.robust_prune(space, q_ids, cands, metric=metric, keys_only=True)
            wp, wq = graph.robust_prune_plain(space, q_ids, cands, metric=metric, keys_only=True)
            check(torch.equal(gp, wp) and torch.equal(gq, wq), f"K20 {mode}: keys mode differs")
            stats.error("K6g robust_prune", 0.0)
            if nodes == 4096:
                m = cands.shape[1] + 1
                rows = space.rows[torch.cat([cands, q_ids[:, None]], 1).long()]
                stats.time("K6g robust_prune", f"{mode} nodes={nodes} L={m - 1} r=32",
                           lambda: graph.robust_prune(space, q_ids, cands, **pkw),
                           lambda: graph.robust_prune_plain(space, q_ids, cands, **pkw),
                           accepted(lambda: torch.cdist(rows, rows, p=1))
                           if metric is Metric.L1 else None,
                           prune_bound(nodes, m, d, metric.value, r=32, row_bytes=row_bytes),
                           reps=3)
        print(f"   K6g {mode}: K20's pair tables equal to their plain version (both modes)",
              flush=True)


def index_metrics_path(db, sets: dict, prefix_coll, centers, rng, report, stats) -> None:
    """The index-metrics phase: IVF-HAMMING and IVF-JACCARD on the 1M
    fingerprints (n_clusters=1000, nprobe=32), HNSW-L1 on the mixture rows'
    and HNSW-HAVERSINE on the geo points' first GRAPH_METRIC_ROWS, HNSW-CHEBYSHEV and
    -CORRELATION on phase 8's 100,000-row mixture prefix, HNSW-HELLINGER,
    -WASSERSTEIN and -JENSEN-SHANNON on the histograms' 100,000-row prefix
    (nprobe=100 for every graph). Each mode: 100 single queries and a batch at
    B = 16 and 256, unfiltered and ``bucket < 5``, against the float64 brute
    force (graph >= 0.90 unfiltered, IVF >= 0.85; no repeated, filtered-out
    or deleted id); HNSW-L1 and IVF-HAMMING take INDEX_METRIC_INSERT new rows and
    answer again; the kernels against their plain versions."""
    c_hist, x_hist, _, q_hist = sets["hist"]
    hist_prefix, t_add = metric_collection(db, "hist_prefix", x_hist[:PREFIX])
    report["index metrics hist prefix add+commit_s"] = t_add
    data = {"bits": sets["bits"],
            "real prefix": (prefix_coll, sets["real"][1][:PREFIX], None, sets["real"][3]),
            "hist prefix": (hist_prefix, x_hist[:PREFIX], None, q_hist)}
    for kind in ("real", "geo"):  # the graph builds' prefixes
        rows, qs = sets[kind][1][:GRAPH_METRIC_ROWS], sets[kind][3]
        c, t_add = metric_collection(db, f"{kind}_graph_prefix", rows)
        report[f"index metrics {kind} graph prefix add+commit_s"] = t_add
        data[f"{kind} graph prefix"] = (c, rows, None, qs)
    for kind, modes in INDEX_METRIC_MODES.items():
        c, rows, live_np, qs = data[kind]
        rows_d = rows if torch.is_tensor(rows) else torch.from_numpy(rows).to(DEV)
        q64 = torch.from_numpy(qs).to(DEV).double()
        for mode in modes:
            metric = Metric.from_index_mode(mode)
            ivf_mode = mode.startswith("IVF")
            t0 = time.perf_counter()
            c.build_index(mode, **({"n_clusters": N_CLUSTERS} if ivf_mode else {}))
            report[f"{mode} build_s"] = time.perf_counter() - t0
            phases = getattr(c._engine._index, "last_build_phases", {})
            print(f"   build_index({mode!r}) on {len(rows)} rows: "
                  f"{report[f'{mode} build_s']:.2f} s {phases}", flush=True)
            nprobe, floor = (NPROBE, None) if ivf_mode else (GRAPH_NPROBE, GRAPH_RECALL_FLOOR)
            t0 = time.perf_counter()
            c.search(qs[0], k=K, nprobe=nprobe)  # stages the blocks or the graph
            print(f"   first search: {time.perf_counter() - t0:.2f} s", flush=True)
            for inserted in ((False, True) if mode in INSERTED else (False,)):
                if inserted:
                    m = INDEX_METRIC_INSERT
                    new = (fingerprints_like(rows_d, m) if ivf_mode
                           else torch.from_numpy(mixture_queries(rng, centers, m)).to(DEV))
                    n0 = len(rows_d)
                    t0 = time.perf_counter()
                    c.add(vectors=new.cpu().numpy().astype(np.float32),
                          fields=[{"bucket": i % 10} for i in range(n0, n0 + m)])
                    c.commit()  # links / posts the new rows in place
                    sync()
                    report[f"{mode} insert_{m}_s"] = time.perf_counter() - t0
                    check(c._engine._index.built_rows == n0 + m,
                          f"{mode}: the new rows were not indexed")
                    print(f"   add + commit {m} rows: {report[f'{mode} insert_{m}_s']:.2f} s",
                          flush=True)
                    rows_d = torch.cat([rows_d, new.to(rows_d.dtype)])
                    if live_np is not None:
                        live_np = np.concatenate([live_np, np.ones(m, bool)])
                n = len(rows_d)
                ok = (torch.ones(n, dtype=torch.bool, device=DEV) if live_np is None
                      else torch.from_numpy(live_np).to(DEV))
                masks = {None: ok}
                if not inserted:
                    masks["bucket < 5"] = ok & (torch.arange(n, device=DEV) % 10 < 5)
                out = {where: run_queries(c, qs[:100], [qs[100:116]], [qs[116:]], where,
                                          nprobe=nprobe) for where in masks}
                sync()
                if not inserted:
                    with uncounted():
                        if ivf_mode:
                            binary_ivf_phase(c, qs, stats, mode)
                        else:
                            metric_graph_phase(c._engine, mode, qs, stats, mode == "HNSW-L1",
                                               phases)
                gt = brute64(metric, q64, rows_d, masks, K)
                probe = probed_kth(c._engine._index, qs, rows_d, masks) if ivf_mode else {}
                for where, (views, lat, calls) in out.items():
                    label = (f"{mode}{' inserted' if inserted else ''} "
                             f"{'unfiltered' if where is None else where}")
                    kth = gt[where][0][:, K - 1]
                    for b, lo, hi in ((1, 0, 100), (16, 100, 116), (256, 116, N_MQ)):
                        if ivf_mode:  # the exact answer over the probed clusters
                            check_metric_views(metric, f"{label} B={b} (its probe's rows)",
                                               views[b], q64[lo:hi], rows_d, masks[where],
                                               probe[where][lo:hi], RECALL_FLOOR)
                        report[f"{label} recall_b{b}"] = check_metric_views(
                            metric, f"{label} B={b}", views[b], q64[lo:hi], rows_d,
                            masks[where], kth[lo:hi], BINARY_IVF_FLOOR[mode] if ivf_mode
                            else floor if where is None else 0.0)
                        if b > 1:  # each call's seconds, GC seconds and cudaMallocs
                            report[f"{label} qps_b{b}"] = len(views[b]) / sum(calls[b]["s"])
                            report[f"{label} calls_b{b}"] = calls[b]
                    report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
                    report[f"{label} p99_ms"] = float(np.percentile(lat, 99) * 1e3)
                del gt, out
        del rows_d, q64
        torch.cuda.empty_cache()


def probed_kth(idx, qs: np.ndarray, rows: torch.Tensor, masks: dict) -> dict:
    """For each mask, each query's 10th best float64 distance over the rows
    posted to the clusters the reference's probe picks: the query's bits
    against the centroids thresholded at 0.5, the f32 distance from exact
    counts as the JAX package forms it, the top NPROBE with the lower index
    first between ties. Written from the definitions, apart from the port."""
    metric = idx.metric
    cent = torch.from_numpy(idx.centroids_np > 0.5).to(DEV).double()
    qb = torch.from_numpy(qs > 0.5).to(DEV).double()
    inter = (qb @ cent.T).float()  # integers: exact
    cq, cx = qb.sum(1).float()[:, None], cent.sum(1).float()[None]
    if metric is Metric.HAMMING:
        dc = cq + cx - 2.0 * inter
    else:
        uni = cq + cx - inter
        dc = torch.where(uni == 0, 0.0, 1.0 - inter / torch.clamp_min(uni, 1.0))
    top = torch.sort(dc, dim=1, stable=True).indices[:, :NPROBE]
    member = torch.zeros(dc.shape, dtype=torch.bool, device=DEV).scatter_(1, top, True)
    post = torch.from_numpy(idx.postings.astype(np.int64)).to(DEV)
    cluster = torch.zeros(len(rows), dtype=torch.long, device=DEV)
    cluster[post[:, 1]] = post[:, 0]
    probed = member[:, cluster]  # (Q, N): the row lies in a probed cluster
    q64 = torch.from_numpy(qs).to(DEV).double()
    out = {}
    for where, ok in masks.items():
        best = None
        for lo in range(0, len(rows), 1 << 16):
            dd = dist64(metric, q64, rows[lo : lo + (1 << 16)].double())
            dd = torch.where(probed[:, lo : lo + (1 << 16)] & ok[None, lo : lo + (1 << 16)], dd,
                             float("inf"))
            v = torch.topk(dd, min(K, dd.shape[1]), dim=1, largest=False).values
            best = v if best is None else torch.topk(torch.cat([best, v], 1), K, dim=1,
                                                     largest=False).values
        out[where] = best[:, K - 1]
    return out


def fingerprints_like(rows: torch.Tensor, n: int) -> torch.Tensor:
    """n new ECFP-like rows: existing fingerprints with 2% of their bits
    flipped (the same scaffold families), (n, D) uint8 on the card."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 4)
    pick = torch.randint(0, rows.shape[0], (n,), generator=gen, device=DEV)
    flip = torch.rand((n, rows.shape[1]), generator=gen, device=DEV) < 0.02
    return rows[pick] ^ flip.to(rows.dtype)


# ── the streaming path: the host-rescore and streaming tiers ─────────────

STREAM_MODES = ("FLAT-IP", "FLAT-L2", "FLAT-L1")
STREAM_WHERES = (None, "bucket = 3", "bucket < 5")
STREAM_IP_Q = 30  # FLAT-IP's single queries in each tier
STREAM_REPEAT_Q = 20  # single queries of the repeated modes (L2, L1, Tanimoto)
STREAM_DELETED = 1000  # rows deleted from the streaming collection
STREAM_N_Q = 1000  # search_stream's queries
# the scale point: 8M x 128 at a 2 GiB budget, at least four blocks a pass
# at B = 16 (20M until the script neared its time limit)
SCALE_N, SCALE_BUDGET = 8_000_000, 2 << 30
GRAPH_STREAM_N = 100_000  # the graph collection forced to stream
GRAPH_STREAM_Q = 30  # its single queries a check


def tier_budget(corpus: DeviceCorpus, tier: str) -> int:
    """The device budget that puts ``corpus`` in ``tier``, from the port's
    own byte counts: the host-rescore tier's bytes, or (streaming) the bytes
    of the bf16 rows a pass pumps, so each of its two buffers holds at most
    a quarter of the corpus (at least four blocks a pass)."""
    if tier == "resident":
        return 0
    cap = corpus._cap_for(corpus.n)
    if tier == "host_rescore":
        return corpus.host_rescore_bytes(cap)
    return cap * (2 * corpus.dim + 13)


def force_tier(c, tier: str) -> None:
    """Restage a collection's corpus under the budget of ``tier``; its
    search cache is cleared, so every answer comes from that tier."""
    corpus = c._engine.corpus()
    budget = tier_budget(corpus, tier)
    if not (tier == corpus.tier == "resident" and scan.DEVICE_BYTES == budget == 0):
        scan.DEVICE_BYTES = budget
        corpus.restage()
    c._engine._search_cache.clear()
    check(corpus.tier == tier, f"a budget of {scan.DEVICE_BYTES} staged {corpus.tier}, not {tier}")
    check(corpus.would_stream() == (tier == "streaming"), "would_stream disagrees with staging")


def key64(metric: Metric, q64: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """float64 (Q, C) keys, smaller = better: -q.x (IP), |q - x|^2 (L2), else
    the metric's distance (dist64)."""
    if metric is Metric.IP:
        return -(q64 @ rows.T)
    if metric is Metric.L2:
        return (q64 * q64).sum(1)[:, None] + (rows * rows).sum(1)[None] - 2.0 * (q64 @ rows.T)
    return dist64(metric, q64, rows)


def key_tol(metric: Metric, key: torch.Tensor, q64: torch.Tensor, xsq_max: float):
    """A returned f32 distance's tolerance as a key: the f32 expansion's
    rounding (IP, L2: 1e-5 of |q|^2 + max |x|^2), else dist_tol."""
    if metric in (Metric.IP, Metric.L2):
        return 1e-5 * key.abs() + 1e-5 * ((q64 * q64).sum(1)[:, None] + xsq_max)
    return dist_tol(metric, key)


def brute_keys(metric: Metric, q64: torch.Tensor, rows: torch.Tensor, masks: dict):
    """The K smallest float64 keys (Q, K) under each mask."""
    best = {name: None for name in masks}
    step = 1 << 16
    for lo in range(0, rows.shape[0], step):
        kk = key64(metric, q64, rows[lo : lo + step].double())
        for name, ok in masks.items():
            part = torch.where(ok[lo : lo + step][None], kk, float("inf"))
            v = torch.topk(part, min(K, part.shape[1]), dim=1, largest=False).values
            best[name] = v if best[name] is None else torch.topk(
                torch.cat([best[name], v], 1), K, dim=1, largest=False).values
    return best


def check_stream_views(metric, label, views, q64, rows, ok, kth, ref_views, xsq_max) -> float:
    """K rows each, none repeated, none filtered out or deleted, each
    distance its row's float64 one within the tolerance; recall@10 >= the
    FLAT floor (a row counts at most the 10th true key plus the tolerance);
    and the resident tier's ids except between rows that tie."""
    hits = 0
    for r, (view, ref) in enumerate(zip(views, ref_views)):
        ids = np.asarray(view.ids, dtype=np.int64)
        check(len(ids) == K and len(set(ids.tolist())) == K, f"{label}: query {r} ids {ids}")
        ids_d = torch.from_numpy(ids).to(DEV)
        check(bool(ok[ids_d].all()), f"{label}: a filtered-out or deleted row returned")
        qr = q64[r : r + 1]
        kk = key64(metric, qr, rows[ids_d].double())[0]
        got = torch.from_numpy(np.asarray(view.distances, dtype=np.float64)).to(DEV)
        got = -got if metric is Metric.IP else got
        tol = key_tol(metric, kk[None], qr, xsq_max)[0]
        check(bool(((got - kk).abs() <= tol).all()), f"{label}: query {r} distances off float64")
        t = kth[r : r + 1]
        hits += int((kk <= t + key_tol(metric, t[None], qr, xsq_max)[0]).sum())
        diff = set(ids.tolist()) ^ set(np.asarray(ref.ids, dtype=np.int64).tolist())
        if diff:  # rows that differ from the resident tier's tie with its last row
            d = key64(metric, qr, rows[torch.tensor(sorted(diff), device=DEV)].double())[0]
            last = key64(metric, qr, rows[int(np.asarray(ref.ids)[-1])][None].double())[0]
            check(bool(((d - last).abs() <= key_tol(metric, last[None], qr, xsq_max)[0]).all()),
                  f"{label}: query {r} differs from the resident tier beyond a tie")
    recall = hits / (K * len(views))
    print(f"   {label}: recall@10 {recall:.4f} over {len(views)} queries", flush=True)
    check(recall >= RECALL_FLOOR, f"{label}: recall@10 {recall} < {RECALL_FLOOR}")
    return recall


def stream_queries(c, qs, n_single, where):
    """``n_single`` single searches and one batch at B = 16 and at B = 256:
    (views in query order, single latencies in s, batch seconds)."""
    lat, views = [], []
    for qv in qs[:n_single]:
        t0 = time.perf_counter()
        views.append(c.search(qv, k=K, where=where))
        lat.append(time.perf_counter() - t0)
    secs = {}
    for b, lo in ((16, 100), (256, 116)):
        t0 = time.perf_counter()
        views += c.batch_search(qs[lo : lo + b], k=K, where=where)
        secs[b] = time.perf_counter() - t0
    return views, np.array(lat), secs


def stream_mode_checks(c, mode, rows_d, ok, qs, n_single, tiers, report, stream_q=None):
    """One FLAT mode on a collection in each forced tier: its queries under
    every filter (and search_stream of ``stream_q``, search_range for IP)
    checked against the float64 brute force and the resident tier's
    answers."""
    metric = Metric.from_index_mode(mode)
    corpus = c._engine.corpus()
    n = rows_d.shape[0]
    ar = torch.arange(n, device=DEV)
    masks = {None: ok, "bucket = 3": ok & (ar % 10 == 3), "bucket < 5": ok & (ar % 10 < 5)}
    sel = np.r_[0:n_single, 100:N_MQ]
    q64 = torch.from_numpy(qs[sel]).to(DEV).double()
    kth = {w: v[:, K - 1] for w, v in brute_keys(metric, q64, rows_d, masks).items()}
    xsq_max = float((rows_d.double() ** 2).sum(1).max())
    with uncounted():
        force_tier(c, "resident")
        ref = {w: stream_queries(c, qs, n_single, w)[0] for w in masks}
        if stream_q is not None:
            ref_stream = c.search_stream(stream_q, k=K)
    for tier in tiers:
        force_tier(c, tier)
        for where in masks:
            label = f"{mode} {tier} {'unfiltered' if where is None else where}"
            views, lat, secs = stream_queries(c, qs, n_single, where)
            report[f"stream {label} recall"] = check_stream_views(
                metric, label, views, q64, rows_d, masks[where], kth[where], ref[where],
                xsq_max)
            report[f"stream {label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            report[f"stream {label} b16_s"], report[f"stream {label} b256_s"] = secs[16], secs[256]
        if stream_q is not None:
            t0 = time.perf_counter()
            got = c.search_stream(stream_q, k=K)
            report[f"stream {mode} {tier} search_stream_{len(stream_q)}_s"] = (
                time.perf_counter() - t0)
            s64 = torch.from_numpy(stream_q).to(DEV).double()
            skth = brute_keys(metric, s64, rows_d, {None: ok})[None][:, K - 1]
            report[f"stream {mode} {tier} search_stream recall"] = check_stream_views(
                metric, f"{mode} {tier} search_stream", got, s64, rows_d, ok, skth, ref_stream,
                xsq_max)
        if metric is Metric.IP:  # search_range(max_results=1000)
            for r in range(2):
                v = c.search(qs[r], k=BIG_K)
                t = float(np.asarray(v.distances)[BIG_K // 2])
                got = np.asarray(c.search_range(qs[r], t, max_results=BIG_K).ids, dtype=np.int64)
                kk = -key64(metric, q64[r : r + 1], rows_d[torch.from_numpy(got).to(DEV)]
                            .double())[0]
                check(bool((kk >= t - 1e-4).all()) and len(got) >= BIG_K // 2 - 5,
                      f"{mode} {tier} search_range: query {r}")
            print(f"   {mode} {tier} search_range(max_results={BIG_K}): every row in range",
                  flush=True)


def pinned_h2d_rate(nbytes: int = 1 << 30) -> float:
    """The card's pinned host-to-device rate, bytes/s: a plain non-blocking
    copy of a 1 GiB pinned tensor (CUDA events)."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    del src, dst
    return nbytes / (ms * 1e-3)


def pass_trace(corpus: DeviceCorpus, fn) -> dict:
    """Run one search with the pump's trace on: blocks, per block the fill
    seconds and bytes, the H2D and scan ms (events), the pass's span from
    the first H2D to the last scan, and the compute stream's busy share."""
    corpus.stream_trace = []
    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
    tr, corpus.stream_trace = corpus.stream_trace, None
    h2d = [e["events"][0].elapsed_time(e["events"][1]) for e in tr]
    scan_ms = [e["events"][2].elapsed_time(e["events"][3]) for e in tr]
    span = tr[0]["events"][0].elapsed_time(tr[-1]["events"][3])
    fill = sum(e["fill_s"] for e in tr)
    nbytes = sum(e["bytes"] for e in tr)
    return {"blocks": len(tr), "rows_per_block": tr[0]["rows"], "pass_ms": span,
            "wall_s": wall, "bytes": nbytes, "fill_gbps": nbytes / fill / 1e9,
            "h2d_ms_per_block": float(np.mean(h2d)), "scan_ms_per_block": float(np.mean(scan_ms)),
            "busy_share": sum(scan_ms) / span, "copy_share": sum(h2d) / span}


def k8_check(corpus: DeviceCorpus, qs: np.ndarray, stats: Stats, label: str, h2d_bps: float,
             timed: bool, metric: Metric = Metric.IP) -> None:
    """K8: a pass of every block on the card against the plain pass on the
    card over the same blocks: the same ids except between near-ties, keys
    within K2's tolerance (IP), or within rtol 1e-5 + 1e-4 under the other
    metrics: the L1 family through K6c's bf16 mode, the rest through their
    exact kernel over the pumped f32 rows."""
    qd = torch.from_numpy(qs).to(DEV)
    kind = "bf16" if metric in scan._BF16_PASS else "f32"
    c = corpus._shortlist_size(K, corpus.n) if kind == "bf16" else K
    with uncounted():
        keys, ids = corpus._stream_pass(qd, metric, kind, c, None)
        pk, pi = corpus._stream_pass(qd, metric, kind, c, None, step=scan.stream_block_plain)
        sync()
    ok = pk > float("-inf")
    check(torch.equal(ok, keys > float("-inf")), f"K8 {label}: empty slots differ")
    if metric is Metric.IP:
        mean = torch.from_numpy(corpus._mean_np).to(DEV)
        x_norm = float(np.sqrt(corpus._sq_host[: corpus.n].max()))
        tol = (1e-5 * (qd - mean).norm(dim=1) * x_norm + 1e-5)[:, None].expand_as(pk)
    else:
        tol = 1e-5 * pk.abs() + 1e-4
    err = (keys - pk).abs()[ok]
    check(bool((err <= tol[ok]).all()), f"K8 {label}: keys off the plain pass")
    for r, j in zip(*torch.nonzero((ids != pi) & ok, as_tuple=True)):
        m = torch.nonzero(pi[r] == ids[r, j]).flatten()
        check(len(m) > 0 and abs(float(pk[r, m[0]] - pk[r, j])) <= float(tol[r, j]),
              f"K8 {label}: ids differ beyond a near-tie")
    stats.error("K8 stream_block", err.max())
    print(f"   K8 {label}: the pass equals the plain pass on the card", flush=True)
    if timed:
        # bound: the pumped rows (bf16, three aux floats, the mask byte)
        # over the card's measured pinned H2D rate, or the bf16 products
        n, d = corpus.n, corpus.dim
        t_link, t_ops = n * (2 * d + 13) / h2d_bps, 2 * len(qs) * n * d / BF16_FLOPS
        stats.time("K8 stream_block", label,
                   lambda: corpus._stream_pass(qd, Metric.IP, "bf16", c, None),
                   lambda: corpus._stream_pass(qd, Metric.IP, "bf16", c, None,
                                               step=scan.stream_block_plain),
                   None, (max(t_link, t_ops) * 1e3, "bytes" if t_link >= t_ops else "operations"),
                   reps=3)


def windows_timing(c, qs: np.ndarray, report) -> None:
    """search_stream of 1,000 queries on the resident FLAT-IP corpus, a
    submit a window of 64 (K2's fused pass and K5's merge -> K3), three runs after a warm one,
    beside the same chain's plain versions on the card and its bound: each
    window reads the bf16 copy, its aux rows and the mask once."""
    corpus, w = c._engine.corpus(), 64

    def timed(fn) -> list:
        fn()
        sync()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return ts

    n, d, cap = corpus.n, corpus.dim, corpus.capacity
    ck = corpus._shortlist_size(K, n)
    aux, valid, x32 = corpus.bf16_aux(), corpus.valid_mask(), corpus._data
    qd = torch.from_numpy(qs).to(DEV)

    def plain():
        for s in range(0, len(qs), w):
            top, idx = scan.bf16_centered_topc_plain(qd[s : s + w], corpus._dev16, aux, valid,
                                                     Metric.IP, ck)
            scan.rescore_topk_plain(qd[s : s + w], x32, top, idx, K, Metric.IP)

    ts = timed(lambda: c.search_stream(qs, k=K, window=w))
    plain_ts = timed(plain)
    windows = -(-len(qs) // w)
    bound_s = max(windows * (n * (2 * d + 12) + cap) / HBM_BPS, 2 * len(qs) * n * d / BF16_FLOPS)
    report[f"search_stream_{len(qs)} resident"] = {"s": ts, "plain_s": plain_ts,
                                                   "bound_s": bound_s, "windows": windows}
    print(f"   search_stream({len(qs)}) resident, a submit a window of {w}: {min(ts):.4f} s, "
          f"the plain chain {min(plain_ts):.4f} s, bound {bound_s:.6f} s", flush=True)


def graph_stream_path(db, x, centers, rng, report) -> None:  # noqa: C901
    """HNSW-L2 and DISKANN-IP on a 100,000-row mixture collection forced to
    stream: HNSW by the exact fallback, a 2,500-row commit deferred;
    DiskANN's lazy PQ and SQ8 fit, its SQ8 or PQ walk, and a 2,500-row
    commit linked by _on_commit_streaming."""
    rows = x[:GRAPH_STREAM_N]
    qs = mixture_queries(rng, centers, GRAPH_STREAM_Q)
    extra = mixture_queries(rng, centers, GRAPH_INSERT)
    out = {}
    for mode in ("HNSW-L2", "DISKANN-IP"):
        g = db.require_collection(f"stream_{mode.lower()}", dim=DIM)
        g.add(vectors=rows)
        g.commit()
        g.build_index(mode)
        corpus = g._engine.corpus()
        force_tier(g, "streaming")
        idx = g._engine._index
        t0 = time.perf_counter()
        out[mode] = [g.search(qv, k=K, nprobe=GRAPH_NPROBE) for qv in qs]
        report[f"stream {mode} {GRAPH_STREAM_Q} singles_s"] = time.perf_counter() - t0
        if mode == "DISKANN-IP":
            check(idx.layered, "DISKANN-IP: no codes fitted on the streaming corpus")
            report["stream DISKANN-IP tier"] = idx._tier(corpus)
            check(report["stream DISKANN-IP tier"] in ("sq8", "pq"), "DISKANN-IP tier")
        t0 = time.perf_counter()
        g.add(vectors=extra)
        g.commit()
        sync()
        report[f"stream {mode} commit_{GRAPH_INSERT}_s"] = time.perf_counter() - t0
        n_all = GRAPH_STREAM_N + GRAPH_INSERT
        if mode == "HNSW-L2":
            check(idx.built_rows == GRAPH_STREAM_N, "HNSW-L2: the streaming commit linked rows")
        else:
            check(idx.built_rows == n_all, "DISKANN-IP: the new rows were not linked")
            check(len(idx._unlinked_ids) == 0, "DISKANN-IP: an unlinked backlog remains")
            linked = np.isin(np.arange(GRAPH_STREAM_N, n_all), idx.graph_np[idx.graph_np >= 0])
            check(bool(linked.all()), "DISKANN-IP: a new row has no in-edge")
            out["DISKANN-IP new rows"] = [g.search(qv, k=K, nprobe=GRAPH_NPROBE)
                                          for qv in extra[:GRAPH_STREAM_Q]]
        out[f"{mode} grown"] = [g.search(qv, k=K, nprobe=GRAPH_NPROBE) for qv in qs]
        print(f"   {mode} streaming: tier {corpus.tier}, commit of {GRAPH_INSERT} rows "
              f"{report[f'stream {mode} commit_{GRAPH_INSERT}_s']:.2f} s", flush=True)
        scan.DEVICE_BYTES = 0
    allx = np.concatenate([rows, extra])
    for mode, metric, floor in (("HNSW-L2", Metric.L2, RECALL_FLOOR),
                                ("DISKANN-IP", Metric.IP, GRAPH_RECALL_FLOOR)):
        for key, data in ((mode, rows), (f"{mode} grown", allx)):
            gt = exact_topk(data, np.arange(len(data)), qs, K, metric)[1]
            report[f"stream {key} recall"] = check_results(
                data, qs, out[key], gt, f"{key} streaming", metric, floor)
    # the linked rows are found: queries at the new rows, whose exact top 10
    # is mostly new rows
    gt = exact_topk(allx, np.arange(len(allx)), extra[:GRAPH_STREAM_Q], K)[1]
    report["stream DISKANN-IP new rows recall"] = check_results(
        allx, extra[:GRAPH_STREAM_Q], out["DISKANN-IP new rows"], gt,
        "DISKANN-IP linked rows streaming",
        Metric.IP, GRAPH_RECALL_FLOOR)
    report["stream DISKANN-IP new rows in the exact top 10"] = float(
        np.mean(gt >= GRAPH_STREAM_N))


def scale_point(rng, report, h2d_bps: float) -> None:
    """A SCALE_N x 128 DeviceCorpus of the mixture forced to stream at a 2 GiB
    budget: the host fill rate, K8's time per block and per pass against
    its link bound, the compute stream's busy share, B = 16 and 256
    latency."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 7)
    centers = torch.randn((N_CENTERS, DIM), generator=gen, device=DEV)
    x = np.empty((SCALE_N, DIM), dtype=np.float32)
    for lo in range(0, SCALE_N, 1 << 21):
        m = min(1 << 21, SCALE_N - lo)
        pick = torch.randint(0, N_CENTERS, (m,), generator=gen, device=DEV)
        x[lo : lo + m] = (centers[pick] + SPREAD * torch.randn((m, DIM), generator=gen,
                                                                device=DEV)).cpu().numpy()
    qs = (centers[torch.randint(0, N_CENTERS, (256,), generator=gen, device=DEV)]
          + SPREAD * torch.randn((256, DIM), generator=gen, device=DEV)).cpu().numpy()
    scan.DEVICE_BYTES = SCALE_BUDGET
    t0 = time.perf_counter()
    corpus = DeviceCorpus(DIM, device=DEV)
    corpus.append(x)
    del x
    corpus.finalize()
    report["scale stage_s"] = time.perf_counter() - t0
    check(corpus.streaming, "the scale corpus did not stream at a 2 GiB budget")
    for b in (16, 256):
        corpus.search(qs[:b], K, Metric.IP)  # warm
        tr = pass_trace(corpus, lambda: corpus.search(qs[:b], K, Metric.IP))
        lat = []
        for _ in range(2):
            t0 = time.perf_counter()
            d, i = corpus.search(qs[:b], K, Metric.IP)
            lat.append(time.perf_counter() - t0)
        check(d.shape == (b, K) and bool(np.isfinite(d).all()), f"scale B={b}: results")
        tr["latency_s"] = lat
        tr["link_bound_ms"] = tr["bytes"] / h2d_bps * 1e3
        check(tr["blocks"] >= 4, f"the scale pass took {tr['blocks']} blocks")
        report[f"scale {SCALE_N} B={b}"] = tr
        print(f"   {SCALE_N} x {DIM} streaming B={b}: {tr}", flush=True)
    # the answers of a slice against the exact top 10 over every row
    want = exact_topk(corpus._host[: corpus.n], np.arange(corpus.n), qs[:4], K)[1]
    got = corpus.search(qs[:4], K, Metric.IP)[1]
    hits = sum(len(set(got[r].tolist()) & set(want[r].tolist())) for r in range(4))
    report["scale recall@10 (4 queries)"] = hits / (4 * K)
    check(hits / (4 * K) >= RECALL_FLOOR, f"scale: recall {hits / (4 * K)}")
    scan.DEVICE_BYTES = 0
    del corpus


def streaming_path(db, x, centers, rng, sets, report, stats) -> None:
    """The streaming phase: the 1M mixture in a fresh FLAT-IP collection
    (1,000 rows deleted) forced into the host-rescore tier and then the
    streaming tier, under FLAT-IP (30 singles, B = 16 and 256, three
    filters, search_stream of 1,000, search_range), FLAT-L2 and FLAT-L1
    (20 singles and the batches); FLAT-TANIMOTO-BINARY on phase 9's
    fingerprints (5 singles and the batches); K8 against its plain version
    under IP, L1 and Tanimoto; the graph collections forced to stream; the scale
    point."""
    h2d_bps = pinned_h2d_rate()
    report["pinned H2D GB/s"] = h2d_bps / 1e9
    print(f"   pinned H2D: {h2d_bps / 1e9:.2f} GB/s", flush=True)
    c = db.require_collection("stream", dim=DIM)
    t0 = time.perf_counter()
    c.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
    c.commit()
    dead = np.sort(rng.choice(N, STREAM_DELETED, replace=False))
    c.delete(dead.tolist())
    c.commit()
    report["stream add+commit_s"] = time.perf_counter() - t0
    live = np.ones(N, dtype=bool)
    live[dead] = False
    rows_d = torch.from_numpy(x).to(DEV)
    ok = torch.from_numpy(live).to(DEV)
    qs = mixture_queries(rng, centers, N_MQ)
    stream_q = mixture_queries(rng, centers, STREAM_N_Q)
    corpus = c._engine.corpus()
    with uncounted():
        force_tier(c, "resident")
        windows_timing(c, stream_q, report)
    stream_mode_checks(c, "FLAT-IP", rows_d, ok, qs, STREAM_IP_Q, ("host_rescore", "streaming"),
                       report, stream_q)
    k8_check(corpus, qs[:16], stats, "IP B=16 N=1M", h2d_bps, True)
    k8_check(corpus, qs[:256], stats, "IP B=256 N=1M", h2d_bps, False)
    tr = pass_trace(corpus, lambda: corpus.search(qs[:16], K, Metric.IP))
    report["stream 1M B=16 pass"] = tr
    check(tr["blocks"] >= 4, f"the 1M streaming pass took {tr['blocks']} blocks")
    print(f"   1M streaming pass B=16: {tr}", flush=True)
    for mode in ("FLAT-L2", "FLAT-L1"):
        c.build_index(mode)
        stream_mode_checks(c, mode, rows_d, ok, qs, STREAM_REPEAT_Q, ("host_rescore", "streaming"),
                           report)
    k8_check(c._engine.corpus(), qs[:16], stats, "L1 B=16 N=1M", h2d_bps, False, Metric.L1)
    scan.DEVICE_BYTES = 0
    del rows_d, corpus
    db.drop_collection("stream")
    torch.cuda.empty_cache()

    bc, bits_rows, _, bits_q = sets["bits"]
    bc.build_index("FLAT-TANIMOTO-BINARY")
    bcorpus = bc._engine.corpus()
    n_bits = bcorpus.n  # phase 10 added rows: the collection's own rows
    bits_d = torch.empty((n_bits, bcorpus.dim), dtype=torch.uint8, device=DEV)
    for lo in range(0, n_bits, 1 << 17):
        hi = min(lo + (1 << 17), n_bits)
        bits_d[lo:hi] = torch.from_numpy(bcorpus._host[lo:hi]).to(DEV).to(torch.uint8)
    stream_mode_checks(bc, "FLAT-TANIMOTO-BINARY", bits_d,
                       torch.ones(n_bits, dtype=torch.bool, device=DEV), bits_q, 5,
                       ("host_rescore", "streaming"), report)
    k8_check(bcorpus, bits_q[:16], stats, f"Tanimoto B=16 N={n_bits}", h2d_bps, False,
             Metric.TANIMOTO)
    scan.DEVICE_BYTES = 0
    del bits_d
    torch.cuda.empty_cache()

    graph_stream_path(db, x, centers, rng, report)
    torch.cuda.empty_cache()
    scale_point(rng, report, h2d_bps)
    torch.cuda.empty_cache()


MESH_SHARDS = 4  # virtual shards of the one card
MESH_WHERES = (None, "bucket = 3", "bucket < 5")
MESH_DELETE = 0.01  # the share of the mesh collection's rows deleted


def card_topk(xd64: torch.Tensor, rows: torch.Tensor, q: np.ndarray, k: int) -> np.ndarray:
    """The exact IP top k of ``q`` over the rows where ``rows`` (N,) bool is
    set, from float64 scores on the card; the lower id first among equal
    scores (the duplicated rows), as phase 11's stable numpy sort orders
    them. Returns (B, k) ids."""
    out = []
    for lo in range(0, len(q), 128):
        qd = torch.from_numpy(q[lo : lo + 128]).to(DEV, torch.float64)
        s = torch.where(rows[None, :], qd @ xd64.T, float("-inf"))
        top, idx = torch.topk(s, k + 16, dim=1)
        top, idx = top.cpu().numpy(), idx.cpu().numpy()
        order = np.lexsort((idx, -top), axis=1)[:, :k]
        out.append(np.take_along_axis(idx, order, 1))
    return np.concatenate(out)


def check_against(x, q, views, ref_views, label: str, dead=(), slack: float = 0.0) -> int:
    """The mesh's ids against the one-device engine's on the same queries:
    equal, except where a row of the reference is missing from the mesh's
    list and is no better (float64 IP) than the mesh's 10th row, within
    1e-5 relative (a tie, or the per-shard shortlists, a superset of the
    merged one, found a better row), or was deleted since. At most ``slack``
    of the reference's ids may break that (an approximate index's shortlist).
    No deleted id. Returns the rows that differ."""
    differ, worse, total = 0, 0, 0
    dead = set(dead)
    for r, (got, want) in enumerate(zip(views, ref_views)):
        gi, wi = np.asarray(got.ids, dtype=np.int64), np.asarray(want.ids, dtype=np.int64)
        check(not set(gi.tolist()) & dead, f"{label}: query {r} returned a deleted row")
        total += len(wi)
        missing = sorted(set(wi.tolist()) - set(gi.tolist()) - dead)
        differ += len(missing)
        if not missing:
            continue
        q64 = q[r].astype(np.float64)
        worst = float((x[gi].astype(np.float64) @ q64).min())
        for row in missing:
            worse += float(x[row].astype(np.float64) @ q64) > worst + 1e-5 * abs(worst) + 1e-5
    check(worse <= slack * total,
          f"{label}: {worse} of the one-device engine's {total} ids beat the mesh's 10th row")
    return differ


def check_mesh_ids(got_i, want_i, want_d, valid: np.ndarray, what: str) -> None:
    """K21a's ids against the unsharded K5's: every id a valid row (never a
    shard's padding), and equal but at a position whose key ties another of
    the row within 1e-5 relative (or the last, which may tie the next)."""
    gi, wi = got_i.cpu().numpy(), want_i.long().cpu().numpy()
    check(bool((gi >= 0).all() and (gi < len(valid)).all()) and bool(valid[gi].all()),
          f"{what}: an id outside the valid rows")
    wd = want_d.cpu().numpy()
    for r, c in zip(*np.nonzero(gi != wi)):
        near = np.abs(wd[r] - wd[r, c]) <= 1e-5 * abs(wd[r, c]) + 1e-5
        check(int(near.sum()) > 1 or c == wd.shape[1] - 1,
              f"{what}: ids differ at ({r}, {c}) beyond a near-tie")


def mesh_kernel_phase(x: np.ndarray, rng, stats: Stats, report: dict) -> None:
    """K21a (the sharded exact search over MESH_SHARDS virtual shards) against
    the unsharded K1 -> K5 on the same rows, and K21b (the sharded Lloyd
    step's cross-shard reduce) against its plain version, the one-device
    K15 step and, at one shard, _lloyd_step; times beside the one-device
    plan's and the bounds. The sharded steps' launches count for the mesh
    path; the comparisons' and timings' do not."""
    mesh = M.make_mesh(MESH_SHARDS, devices=[DEV] * MESH_SHARDS)
    home = mesh.home
    valid = np.arange(N) % 10 == 3  # phase 4's bucket = 3 rows
    xs, vs = M.shard_corpus(mesh, x, valid)
    vs_all = M.Sharded(tuple(tuple(torch.ones_like(v) for v in row) for row in vs.parts))
    n_local = xs.parts[0][0].shape[0]
    xd, vd = torch.from_numpy(x).to(home), torch.from_numpy(valid).to(home)
    all_d = torch.ones(N, dtype=torch.bool, device=home)
    bits = {True: 0, False: 0}
    for metric in (Metric.IP, Metric.L2):
        ct = D.corpus_transform(xd, metric)
        step = M.sharded_search_fn(mesh, metric=metric, k=K)
        for b in BATCHES:
            q = rng.normal(size=(b, DIM)).astype(np.float32)
            qs, _ = M.shard_queries(mesh, q)
            got_d, got_i = step(xs, qs, vs)
            with uncounted():
                qd = torch.from_numpy(q).to(home)
                qt = D.query_transform(qd, metric)
                top, idx = topk.topk_select(scan.metric_keys(qt, ct, vd, metric), K)
                want_d = topk.unorient(top, metric.ascending)
                sync()
                same = torch.equal(got_d, want_d)
                # IP reads the rows as they are: the keys must be the bits
                check(same or metric is not Metric.IP, f"K21a ip B={b}: keys not bit-equal")
                bits[same] += 1
                err = (got_d - want_d).abs()
                check(bool((err <= 1e-5 * want_d.abs() + 1e-5).all()),
                      f"K21a {metric.value} B={b}: keys off the unsharded K1 -> K5")
                stats.error("K21 sharded_search", err.max())
                check_mesh_ids(got_i, idx, want_d, valid, f"K21a {metric.value} B={b}")
                if metric is Metric.IP:
                    args = (qd, xd, None, None, all_d, metric)
                    single = cuda_ms(lambda: topk.topk_select(scan.flat_scores_f32(*args), K))
                    # each shard's K1 and K5 bounds (every row live), and the merge's
                    k1, k1_by = f32_tile_bound(b, DIM, n_local, n_local)
                    k5 = bound(b * n_local * 4 + b * K * 8, 0)[0]
                    merge = bound(b * MESH_SHARDS * K * 8 + b * K * 8, 0)[0]
                    bound_ms = (MESH_SHARDS * (k1 + k5) + merge, k1_by)
                    plain = M.sharded_search_fn(mesh, metric=metric, k=K, plain=True)
                    stats.time("K21 sharded_search", f"IP B={b} S={MESH_SHARDS}",
                               lambda: step(xs, qs, vs_all), lambda: plain(xs, qs, vs_all),
                               lambda: torch.topk(qd @ xd.T, K), bound_ms,
                               plain_reps=2 if b == 256 else None, single_ms=single)
                    # the kernels' own device time (torch.profiler): what the
                    # events' time leaves is the host issuing the shards' launches
                    dev = [device_ms_per_call(torch, fn, range(10))[0] for fn in (
                        lambda _: step(xs, qs, vs_all),
                        lambda _: topk.topk_select(scan.flat_scores_f32(*args), K))]
                    report[f"K21a IP B={b} S={MESH_SHARDS} vs one device: events ms, "
                           "device ms"] = (
                        (stats.rows["K21 sharded_search"][f"IP B={b} S={MESH_SHARDS}"]["ms"],
                         single), tuple(dev))
            print(f"   K21a {metric.value} B={b}: {'bit-equal to' if same else 'within 1e-5 of'} "
                  f"the unsharded K1 -> K5, ids equal but ties", flush=True)
    report["K21a runs bit-equal / within 1e-5"] = (bits[True], bits[False])
    if bits[False]:  # L2's row norms: PyTorch sums a (250,000, 128) block and a (1M, 128) one
        print("   K21a: keys not bit-equal where the corpus transform's row norms, summed by "
              "PyTorch per shard, round otherwise than over the whole corpus", flush=True)

    # a (2, 2) mesh: the queries split over two data rows, an odd batch, k = 1,000
    mesh22 = M.make_mesh(MESH_SHARDS, data_axis=2, devices=[DEV] * MESH_SHARDS)
    xs22, vs22 = M.shard_corpus(mesh22, x, valid)
    q = rng.normal(size=(17, DIM)).astype(np.float32)
    qs, b_real = M.shard_queries(mesh22, q)
    got_d, got_i = M.sharded_search_fn(mesh22, metric=Metric.IP, k=BIG_K)(xs22, qs, vs22)
    with uncounted():
        qd = torch.from_numpy(q).to(home)
        top, idx = topk.topk_select(scan.flat_scores_f32(qd, xd, None, None, vd, Metric.IP), BIG_K)
        check(got_d.shape == (18, BIG_K), f"K21a (2, 2): shape {tuple(got_d.shape)}")
        err = (got_d[:b_real] - top).abs()
        check(bool((err <= 1e-5 * top.abs() + 1e-5).all()), "K21a (2, 2) k=1000: keys")
        check_mesh_ids(got_i[:b_real], idx, top, valid, "K21a (2, 2) k=1000")
    print(f"   K21a on a (2, 2) mesh, B=17 (padded to 18), k={BIG_K}: "
          f"{'bit-equal to' if torch.equal(got_d[:b_real], top) else 'within 1e-5 of'} the "
          "unsharded K1 -> K5", flush=True)
    del xs22, vs22

    # K21b at the IVF build's training shape over MESH_SHARDS shards
    n_train = N_CLUSTERS * 256
    valid_k = np.arange(n_train) < n_train - n_train // 10
    cent = xd[torch.from_numpy(rng.choice(N, N_CLUSTERS, replace=False)).to(home)].clone()
    xk, vk = M.shard_corpus(mesh, x[:n_train], valid_k)
    kstep = M.sharded_kmeans_step_fn(mesh)
    new, counts = kstep(xk, cent, vk)
    with uncounted():
        data, valid_d = xd[:n_train], torch.from_numpy(valid_k).to(home)
        want_new, want_counts, _ = kmeans._lloyd_step(data, valid_d, cent)
        check(torch.equal(counts, want_counts), "K21b: counts differ from one device's K15")
        check(bool(((new - want_new).abs() <= 1e-5 + 1e-5 * want_new.abs()).all()),
              "K21b: centroids outside f32 tolerance of one device's K15")
        sums, cnts = M.kmeans_partials(mesh, xk, cent, vk)
        for _ in range(2):
            got = kmeans.kmeans_reduce_shards(sums, cnts, cent)
            want = kmeans.kmeans_reduce_shards_plain(sums, cnts, cent)
            check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                  and torch.equal(got[1], want[1]), "K21b: not bit-equal to its plain version")
        one = M.make_mesh(1, devices=[DEV])
        x1, v1 = M.shard_corpus(one, x[:n_train], valid_k)
        new1, _ = M.sharded_kmeans_step_fn(one)(x1, cent, v1)
        check(torch.equal(new1.view(torch.int32), want_new.view(torch.int32)),
              "K21b at one shard: not bit-equal to _lloyd_step")
        s, kk, d = sums.shape
        stats.time("K21b kmeans_reduce_shards", f"S={s} K={kk} D={d}",
                   lambda: kmeans.kmeans_reduce_shards(sums, cnts, cent),
                   lambda: kmeans.kmeans_reduce_shards_plain(sums, cnts, cent), None,
                   bound((s * kk * d + 2 * kk * d + s * kk + kk) * 4, 0))
        report[f"K21b sharded step S={s} vs _lloyd_step ms"] = (
            cuda_ms(lambda: kstep(xk, cent, vk), 5),
            cuda_ms(lambda: kmeans._lloyd_step(data, valid_d, cent), 5))
        report["K21b reduce: device ms (torch.profiler)"] = device_ms_per_call(
            torch, lambda _: kmeans.kmeans_reduce_shards(sums, cnts, cent), range(10))
    print(f"   K21b over {MESH_SHARDS} shards at {n_train} x {N_CLUSTERS} x {DIM}: counts equal "
          "one device's K15, centroids within 1e-5; bit-equal to its plain version twice; at "
          "one shard bit-equal to _lloyd_step", flush=True)


def mesh_path(db, x, q_sets, flat_out, ivf_sets, quant_out, rng, report, stats) -> None:
    """The mesh phase: K21a / K21b on MESH_SHARDS virtual shards of the card
    (mesh_kernel_phase), dryrun_multichip, then a Collection served from a
    sharded corpus under set_default_mesh: a fresh FLAT-IP collection of the
    1M rows and fields, phase 4's queries under MESH_WHERES (against a
    float64 brute force and phase 4's one-device ids), 1% deleted, a
    search_stream of 100, FLAT-IP-SQ8 (against phase 7's one-device SQ8)."""
    mesh_kernel_phase(x, rng, stats, report)
    dryrun.dryrun_multichip(MESH_SHARDS, DEV)
    mesh = M.make_mesh(MESH_SHARDS, devices=[DEV] * MESH_SHARDS)
    singles, b16, b256 = q_sets
    qs = np.concatenate([singles, b16.reshape(-1, DIM), b256.reshape(-1, DIM)])
    with uncounted():
        xd64 = torch.from_numpy(x).to(DEV, torch.float64)
        ids_d = torch.arange(N, device=DEV)
    masks = {None: ids_d >= 0, "bucket = 3": ids_d % 10 == 3, "bucket < 5": ids_d % 10 < 5}
    # the one-device engine the mesh collection is held to after its deletes
    # (made before the default mesh is set, so it is not sharded)
    single = DeviceCorpus(DIM, device=DEV)
    single.append(x)
    M.set_default_mesh(mesh)
    try:
        mc = db.require_collection("mesh", dim=DIM)
        check(mc._engine.corpus().mesh is mesh, "the mesh collection's corpus is not sharded")
        t0 = time.perf_counter()
        mc.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
        mc.commit()
        t_add = time.perf_counter() - t0
        t_warm = mc.prewarm()
        print(f"   mesh collection: add+commit {N} rows {t_add:.2f} s; first search (staging "
              f"{MESH_SHARDS} shards) {t_warm:.2f} s", flush=True)
        for where in MESH_WHERES:
            label = f"MESH FLAT {'unfiltered' if where is None else where}"
            views, lat, calls = run_queries(mc, singles, b16, b256, where)
            with uncounted():
                gt = card_topk(xd64, masks[where], qs, K)
            check_results(x, singles, views[1], gt[:100], f"{label} single")
            check_results(x, qs[100:164], views[16], gt[100:164], f"{label} B=16")
            check_results(x, qs[164:], views[256], gt[164:], f"{label} B=256")
            ref = flat_out[where][0]
            differ = sum(check_against(x, qb, views[b], ref[b], f"{label} B={b}")
                         for b, qb in ((1, singles), (16, qs[100:164]), (256, qs[164:])))
            report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            report[f"{label} qps_b16 / b256"] = tuple(len(views[b]) / sum(calls[b]["s"])
                                                      for b in (16, 256))
            report[f"{label} rows differing from one device"] = differ
            report[f"{label} calls_b16"], report[f"{label} calls_b256"] = calls[16], calls[256]
            print(f"   {label}: phase 4's one-device ids but {differ} rows (ties or better)",
                  flush=True)
        with uncounted():  # fresh queries: the search cache holds the ones above
            fresh = rng.normal(size=(20, DIM)).astype(np.float32)
            report["MESH FLAT unfiltered device ms: a single, a B=256 batch"] = (
                device_ms_per_call(torch, lambda qv: mc.search(qv, k=K), fresh)[0],
                device_ms_per_call(torch, lambda qb: mc.batch_search(qb, k=K),
                                   [rng.normal(size=(256, DIM)).astype(np.float32)])[0])

        dead = np.sort(rng.choice(N, int(MESH_DELETE * N), replace=False))
        mc.delete(dead.tolist())
        mc.commit()
        live = torch.ones(N, dtype=torch.bool, device=DEV)
        live[torch.from_numpy(dead).to(DEV)] = False
        views = [mc.search(qv, k=K) for qv in singles]
        with uncounted():
            gt = card_topk(xd64, live, singles, K)
            tombs = np.zeros(N, dtype=bool)
            tombs[dead] = True
            single.set_tombstones(tombs)
            ref = [SimpleNamespace(ids=i) for i in single.search(singles, K, Metric.IP)[1]]
        check_results(x, singles, views, gt, "MESH FLAT after 1% deleted")
        check_against(x, singles, views, ref, "MESH FLAT after 1% deleted", dead.tolist())
        stream = mc.search_stream(singles, k=K)
        check(len(stream) == len(singles), "mesh search_stream: a result a query")
        check_results(x, singles, stream, gt, "MESH search_stream(100)")
        check_against(x, singles, stream, ref, "MESH search_stream(100)", dead.tolist())
        del single

        t0 = time.perf_counter()
        mc.build_index("FLAT-IP-SQ8")
        report["MESH FLAT-IP-SQ8 build_s"] = time.perf_counter() - t0
        ivf_q = np.concatenate([ivf_sets[0], ivf_sets[1].reshape(-1, DIM),
                                ivf_sets[2].reshape(-1, DIM)])
        for where in (None, "bucket < 5"):
            label = f"MESH FLAT-IP-SQ8 {'unfiltered' if where is None else where}"
            views, lat, _ = run_queries(mc, *ivf_sets, where)
            with uncounted():
                gt = card_topk(xd64, masks[where] & live, ivf_q, K)
            check_results(x, ivf_sets[0], views[1], gt[:100], f"{label} single", floor=0.95)
            check_results(x, ivf_q[100:164], views[16], gt[100:164], f"{label} B=16",
                          floor=0.95)
            check_results(x, ivf_q[164:], views[256], gt[164:], f"{label} B=256", floor=0.95)
            ref = quant_out[("FLAT-IP-SQ8", where)][0]
            differ = sum(check_against(x, qb, views[b], ref[b], f"{label} B={b}", dead.tolist(),
                                       slack=0.01)
                         for b, qb in ((1, ivf_sets[0]), (16, ivf_q[100:164]), (256, ivf_q[164:])))
            report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            report[f"{label} rows differing from one device"] = differ
            print(f"   {label}: recall@10 >= 0.95; phase 7's one-device ids but {differ} rows "
                  "(deleted, ties or better)", flush=True)
        sync()
    finally:
        M.set_default_mesh(None)
    db.drop_collection("mesh")
    del xd64


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    report = {}
    with phase("1 device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 would break the f32 paths")

    with phase("2 build"):
        t0 = time.perf_counter()
        path, log = _cuda.build()
        print(f"   {path} ({time.perf_counter() - t0:.1f} s)")
        print(log, file=sys.stderr)
        _cuda.library()

    rng = np.random.default_rng(SEED)
    x, centers = make_corpus(rng)
    stats = Stats()
    with phase("3 kernels vs plain"):
        corpus = flat_kernel_phase(x, rng, stats)
        torch.cuda.empty_cache()
        quant_kernel_phase(corpus, rng, stats)
        del corpus
        torch.cuda.empty_cache()
        kmeans_kernel_phase(x, rng, stats)
    torch.cuda.empty_cache()

    singles = rng.normal(size=(100, DIM)).astype(np.float32)
    b16 = rng.normal(size=(4, 16, DIM)).astype(np.float32)
    b256 = rng.normal(size=(4, 256, DIM)).astype(np.float32)
    small = rng.normal(size=(2000, DIM)).astype(np.float32)
    small_q = rng.normal(size=(20, DIM)).astype(np.float32)
    big_q = rng.normal(size=(4, DIM)).astype(np.float32)
    ivf_q = mixture_queries(rng, centers, 100 + 4 * 16 + 2 * 256)
    ivf_sets = (ivf_q[:100], ivf_q[100:164].reshape(4, 16, DIM), ivf_q[164:].reshape(2, 256, DIM))
    counts = {}

    with tempfile.TemporaryDirectory(prefix="lynse_smoke_") as root:
        set_counts({})
        with phase("4 flat path"):
            client = lynse.VectorDBClient(root, device=DEV)
            db = client.create_database("smoke", drop_if_exists=True)
            coll = db.require_collection("vectors", dim=DIM)
            t0 = time.perf_counter()
            coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
            coll.commit()
            t_add = time.perf_counter() - t0
            t_warm = coll.prewarm()  # stages the corpus (one dummy query)
            print(f"   add+commit {N} rows: {t_add:.2f} s; first search (staging): {t_warm:.2f} s")
            flat_out = {where: run_queries(coll, singles, b16, b256, where)
                        for where in MESH_WHERES}
            submit_phase(coll, np.random.default_rng(SEED + 3))
            sc = db.require_collection("small", dim=DIM)
            sc.add(vectors=small)
            sc.commit()
            small_views = [sc.search(qv, k=K) for qv in small_q]
            # bucket = 3 is 100,000 of 1M rows: the gather route scores them
            # and the shortlist, not the corpus
            prof = coll.search_profile(singles[0], k=K, where="bucket = 3")
            want = N // 10 + coll._engine.corpus()._shortlist_size(K, N // 10)
            check(prof["scanned_vectors"] == want,
                  f"bucket = 3: scanned_vectors {prof['scanned_vectors']}, want {want}")
            print(f"   bucket = 3: scanned_vectors {want} (the gather route)", flush=True)
            sync()
        counts["flat"] = read_counts()
        with uncounted():
            gather_route_phase(coll, np.random.default_rng(SEED + 2), stats)

        set_counts({})
        with phase("5 large k"):
            big_views, big_s = [], []
            for qv in big_q:  # each call ends in its result on the host
                t0 = time.perf_counter()
                big_views.append(coll.search(qv, k=BIG_K))
                big_s.append(time.perf_counter() - t0)
            # thresholds that keep about half of each query's top 1,000
            thresholds = [float(np.asarray(v.distances)[BIG_K // 2]) for v in big_views]
            range_views, range_s = [], []
            for qv, t in zip(big_q, thresholds):
                t0 = time.perf_counter()
                range_views.append(coll.search_range(qv, t, max_results=BIG_K))
                range_s.append(time.perf_counter() - t0)
            sync()
            report[f"FLAT k={BIG_K} ms"] = [s * 1e3 for s in big_s]
            report[f"FLAT search_range max_results={BIG_K} ms"] = [s * 1e3 for s in range_s]
        counts["large_k"] = read_counts()

        set_counts({})
        ivf_out = {}
        with phase("6 IVF path"):
            for mode in ("IVF-L2", "IVF-IP"):
                t0 = time.perf_counter()
                coll.build_index(mode, n_clusters=N_CLUSTERS)
                report[f"{mode} build_s"] = time.perf_counter() - t0
                sha = hashlib.sha256(coll._engine._index.centroids_np.tobytes()).hexdigest()
                print(f"   build_index({mode!r}, n_clusters={N_CLUSTERS}): "
                      f"{report[f'{mode} build_s']:.2f} s, centroids sha256 {sha}", flush=True)
                t0 = time.perf_counter()
                coll.search(centers[0], k=K, nprobe=NPROBE)  # stages the block copy
                print(f"   first search (block copy): {time.perf_counter() - t0:.2f} s")
                for where in (None, "bucket < 5"):
                    ivf_out[(mode, where)] = run_queries(coll, *ivf_sets, where, nprobe=NPROBE)
                sync()
                counts[f"ivf {mode}"] = read_counts()
                with uncounted():
                    ivf_scan_phase(coll, (ivf_q[:1], ivf_q[100:116], ivf_q[164:420]), stats, mode)
        counts["ivf"] = read_counts()

        set_counts({})
        quant_out = {}
        with phase("7 quantized path"):
            for mode in QUANT_MODES:
                t0 = time.perf_counter()
                coll.build_index(mode)
                report[f"{mode} build_s"] = time.perf_counter() - t0
                print(f"   build_index({mode!r}): {report[f'{mode} build_s']:.2f} s "
                      f"{coll._engine._aux_index.last_build_phases}", flush=True)
                t0 = time.perf_counter()
                coll.search(centers[0], k=K)  # stages the codes
                print(f"   first search (codes to the card): {time.perf_counter() - t0:.2f} s")
                for where in (None, "bucket < 5"):
                    quant_out[(mode, where)] = run_queries(coll, *ivf_sets, where)
                sync()
        counts["quantized"] = read_counts()

        set_counts({})
        with phase("7b mesh path"):
            mesh_path(db, x, (singles, b16, b256), flat_out, ivf_sets, quant_out,
                      np.random.default_rng(SEED + 16), report, stats)
        counts["mesh"] = read_counts()

        set_counts({})
        with phase("8 graph path"):
            graph_out, extra, dead = graph_path(db, coll, x, centers, rng, ivf_sets, report, stats)
        counts["graph"] = read_counts()

        set_counts({})
        with phase("9 metrics path"):
            sc.build_index("FLAT-L2")  # 2,000 rows: the exact plan, K1 under L2
            small_l2 = [sc.search(qv, k=K) for qv in small_q]
            sets = metrics_path(db, coll, x, extra, dead, centers, rng, report, stats)
        counts["metrics"] = read_counts()

        set_counts({})
        with phase("10 index metrics path"):
            index_metrics_path(db, sets, db.get_collection("prefix", warm_up=False), centers, rng,
                               report, stats)
        counts["index_metrics"] = read_counts()

        set_counts({})
        with phase("10b streaming path"):
            streaming_path(db, x, centers, np.random.default_rng(SEED + 8), sets, report, stats)
        counts["streaming"] = read_counts()
        client.close()

    with phase("11 checks against a float64 brute force"):
        all_rows = np.arange(N)
        for where, rows in ((None, all_rows), ("bucket = 3", np.nonzero(all_rows % 10 == 3)[0])):
            label = "unfiltered" if where is None else where
            views, lat, calls = flat_out[where]
            qs = np.concatenate([singles, b16.reshape(-1, DIM), b256.reshape(-1, DIM)])
            _, gt = exact_topk(x, rows, qs, K)
            report[f"FLAT recall_single {label}"] = check_results(
                x, singles, views[1], gt[:100], f"FLAT single {label}")
            check_results(x, qs[100:164], views[16], gt[100:164], f"FLAT B=16 {label}")
            check_results(x, qs[164:], views[256], gt[164:], f"FLAT B=256 {label}")
            report[f"FLAT p50_ms {label}"] = float(np.percentile(lat, 50) * 1e3)
            report[f"FLAT p99_ms {label}"] = float(np.percentile(lat, 99) * 1e3)
            for b in (16, 256):
                report[f"FLAT qps_b{b} {label}"] = len(views[b]) / sum(calls[b]["s"])
                report[f"FLAT calls_b{b} {label}"] = calls[b]

        gd, gi = exact_topk(small, np.arange(len(small)), small_q, K)
        for r, view in enumerate(small_views):
            check(np.array_equal(np.asarray(view.ids), gi[r]), f"small: ids differ at query {r}")
            np.testing.assert_allclose(np.asarray(view.distances), gd[r], rtol=1e-5, atol=1e-5)
        print(f"   small collection: {len(small_views)} queries equal the exact top-{K}")
        gi = exact_topk(small, np.arange(len(small)), small_q, K, Metric.L2)[1]
        check_results(small, small_q, small_l2, gi, "small FLAT-L2", Metric.L2)

        gd, gi = exact_topk(x, all_rows, big_q, BIG_K)
        hits = 0
        for r, view in enumerate(big_views):
            ids = np.asarray(view.ids, dtype=np.int64)
            check(len(ids) == BIG_K and len(set(ids.tolist())) == BIG_K, f"k={BIG_K}: query {r}")
            hits += len(set(ids.tolist()) & set(gi[r].tolist()))
            np.testing.assert_allclose(np.asarray(view.distances), x[ids].astype(np.float64)
                                       @ big_q[r].astype(np.float64), rtol=1e-5, atol=1e-5)
            t = thresholds[r]
            want = set(gi[r][gd[r] >= t + 1e-4].tolist())  # clearly inside the range
            got = np.asarray(range_views[r].ids, dtype=np.int64)
            check(want <= set(got.tolist()), f"search_range: query {r} misses rows in range")
            exact = x[got].astype(np.float64) @ big_q[r].astype(np.float64)
            check(bool((exact >= t - 1e-4).all()), f"search_range: query {r} out of range")
        report[f"FLAT recall@{BIG_K}"] = hits / (BIG_K * len(big_views))
        print(f"   search(k={BIG_K}): recall {report[f'FLAT recall@{BIG_K}']:.4f}; "
              f"search_range(max_results={BIG_K}): every row in range, none outside")
        check(report[f"FLAT recall@{BIG_K}"] >= RECALL_FLOOR, f"k={BIG_K} recall")

        gts = {}  # (metric, where) -> the exact top 10 of the mixture queries
        modes = [("IVF-L2", Metric.L2, IVF_RECALL_FLOOR, ivf_out),
                 ("IVF-IP", Metric.IP, IVF_RECALL_FLOOR, ivf_out)]
        modes += [(mode, Metric.L2 if "-L2-" in mode else Metric.IP, floor, quant_out)
                  for mode, floor in QUANT_MODES.items()]
        for mode, metric, floor, out in modes:
            for where, rows in ((None, all_rows), ("bucket < 5", np.nonzero(all_rows % 10 < 5)[0])):
                label = f"{mode} {'unfiltered' if where is None else where}"
                views, lat, calls = out[(mode, where)]
                if (metric, where) not in gts:
                    gts[(metric, where)] = exact_topk(x, rows, ivf_q, K, metric)[1]
                gt = gts[(metric, where)]
                report[f"{label} recall_single"] = check_results(
                    x, ivf_q[:100], views[1], gt[:100], f"{label} single", metric, floor)
                for b, lo, hi in ((16, 100, 164), (256, 164, len(ivf_q))):
                    report[f"{label} recall_b{b}"] = check_results(
                        x, ivf_q[lo:hi], views[b], gt[lo:hi], f"{label} B={b}", metric, floor)
                    report[f"{label} qps_b{b}"] = len(views[b]) / sum(calls[b]["s"])
                    report[f"{label} calls_b{b}"] = calls[b]
                report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
                report[f"{label} p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        check_graph(graph_out, x, extra, dead, ivf_q, report)

    with phase("12 launch counts"):
        by_path = {path: counts[path] for path in PATHS}
        for path, names in PATHS.items():
            print(f"   {path}: {by_path[path]}")
            for name in names:
                check(by_path[path][name] > 0, f"{name} was never launched on the {path} path")
        for path in ("quantized", "mesh"):  # the second stage: one fused launch
            check(by_path[path]["K11 fused"] > 0 and by_path[path]["K11 per_query"] == 0,
                  f"{path}: K11's second stage did not run fused")
        for route in ("rows", "shared"):  # the card picks tile or warp in the shared launch
            check(by_path["ivf"][f"K16 {route}"] > 0, f"ivf: K16's {route} launch never ran")
        ivf_l2 = counts["ivf IVF-L2"]
        for name in PATHS["ivf"]:  # the IP build and queries launch them again
            check(counts["ivf"][name] > ivf_l2[name], f"{name} not launched for IVF-IP")

    print(f"main path timings ({card}; host clock around each call, ending in a device sync):")
    for key, val in report.items():
        print(f"   {key}: {val}")
    stats.table(card)
    shown = {"K1 flat_scores_f32": "IP B=16", "K2 bf16_centered_topc": f"IP B=16 C={C}",
             "K3 rescore_topk": f"IP B=16 C={C}", "K5 topk_select": f"IP B=16 k={C}",
             "K15 kmeans_assign": f"L2 N={N_CLUSTERS * 256} K={N_CLUSTERS}",
             "K15 kmeans_update": f"N={N_CLUSTERS * 256} K={N_CLUSTERS}",
             "K16 ivf_scan_blocks": f"IVF-L2 B=16 nprobe={NPROBE}",
             "K11 bf16_gather_scores": f"IP B=16 S={SHORTLIST} C={QUANT_C} fused",
             "K12 int8_code_scores": "sq8 IP B=16", "K13 pq_adc_scores": "M=16 IP B=16",
             "K14 fwht_rotate": "B=64", "K17 beam_search": "DISKANN-IP bf16 ip B=16 beam=125",
             "K19 topl_scan": f"L2 chunk=4096 N={N} L=64",
             "K20 robust_prune": "L2 nodes=4096 L=72 r=32",
             "K6a gemm_metric_scores": "correlation B=16", "K6b binary_scores": "tanimoto B=16",
             "K6c elementwise_scores": "l1 B=16", "K9 elementwise_topc": "l1 B=16 C=256",
             "K16b ivf_binary_blocks": f"IVF-HAMMING B=16 nprobe={NPROBE}",
             "K6g beam_search": f"HNSW-L1 B=16 beam={GRAPH_NPROBE}",
             "K6g topl_scan": f"HNSW-L1 chunk={TOPL_CHUNK} N={GRAPH_METRIC_ROWS} L=64",
             "K6g robust_prune": "HNSW-L1 nodes=4096 L=72 r=32",
             "K8 stream_block": "IP B=16 N=1M",
             "K21 sharded_search": f"IP B=16 S={MESH_SHARDS}",
             "K21b kmeans_reduce_shards": f"S={MESH_SHARDS} K={N_CLUSTERS} D={DIM}"}
    kernels = []
    # the K6g rows: K17, K19 and K20 under the domain metrics, whose launches
    # are their kernels' on the index-metrics path
    rows = [(name, name, src, rep, list(by_path)) for name, (_, src, rep) in KERNELS.items()]
    rows += [(name, kern, KERNELS[kern][1], rep, ["index_metrics"])
             for name, (kern, rep) in K6G.items()]
    for name, kern, src, rep, paths in rows:
        row = stats.rows[name][shown[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path[p][kern] for p in paths),
            "launches_by_path": {p: by_path[p][kern] for p in paths},
            "max_abs_err": stats.err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shown[name],
            **COMPOSITE.get(name, {}),
            **({"launches_by_mode": {m: sum(by_path[p][mode_key(kern, m)] for p in paths)
                                     for m in MODES[kern]}} if name in MODES else {}),
            **({"walk_bound_ms": row["walk_bound_ms"]} if "walk_bound_ms" in row else {}),
            **({"single_device_ms": row["single_ms"]} if "single_ms" in row else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

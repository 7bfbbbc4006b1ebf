"""The flat-scan engine: a corpus on the device and the searches over it.

Port of lynsedb_tpu/ops/scan.py. The corpus keeps

  * an exact f32 mirror of every row in host RAM (numpy, spilled to a
    temp-file memmap past ``MIRROR_RAM_BYTES``), the source every device
    array is staged from;
  * on the device, as far as the device budget (``DEVICE_BYTES``) allows: a
    mean-centred **bf16** copy (the first-pass scan array), its per-row aux
    arrays (``xm``, ``xc_sq``, ``xsq_true``), an **f32** copy (the exact scan
    and the rescore gather from it), the validity mask and the corpus
    transform of the metric searched last (norms, centred or probability
    rows, bit-packed rows; ops/distance.py).

Three tiers, chosen at staging from the port's byte counts:

  * **resident**: every copy fits (``device_bytes``);
  * **host-rescore**: the f32 copy does not fit but the bf16 copy, its aux
    arrays, the mask and the search scratch do; the first pass runs on the
    device and returns ids only, and the resolver rescores them exactly from
    the host mirror;
  * **streaming**: not even the bf16 copy fits; it moves to a host mirror and
    each search pumps fixed blocks through two pinned staging buffers while
    K8 carries a top-C state from block to block.

A search runs one of these plans, each a chain of hand-written kernels:

  * **exact** (every metric below ``TWO_PASS_MIN_ROWS`` rows or under
    ``mode="exact"``, and always for the 13 metrics outside IP/L2/cosine): the
    metric's distance kernel scores every row of its transform — K1
    ``flat_scores_f32`` (IP, L2, cosine), K6a ``gemm_metric_scores``
    (correlation, Hellinger), K6b ``binary_scores`` (Hamming, Jaccard,
    Tanimoto, Dice) or K6c ``elementwise_scores`` (the rest) — and K5
    ``topk_select`` takes the top k. Off the resident tier the f32 rows are
    pumped from the host mirror block by block (K8 over the f32 blocks);
  * **two-pass** (IP/L2/cosine): K2 ``bf16_centered_topc`` scores the
    centred bf16 copy on the tensor cores and keeps each span's top C in
    shared memory, K5 merges the spans' lists into the top-C shortlist
    (the (B, N) keys never reach device memory), K3 ``rescore_topk``
    rescores it exactly in f32 and sorts on (score, id) — or, off the
    resident tier, the host mirror does;
  * **gather** (IP/L2/cosine under a selective filter: at most
    ``GATHER_MAX_ROWS`` rows and at most a quarter of the corpus, K4): K11
    ``bf16_gather_scores`` scores only the filter's rows from the centred
    copy, K5 takes the top C of them, K3 rescores with global ids. A
    streaming corpus scores the filter's rows exactly on the host instead.

Every other filter is a mask on its plan's pass. ``search_approx`` for the L1
family is K9 (K6c's pass over the bf16 copy fused with its top C, then K5's
merge of the spans' lists), then K6c over the shortlist's f32 rows (K10);
off the resident tier the L1 family always runs that plan, its
rescore over rows gathered from the host mirror. Range search is the
top-(max_results) search with a threshold test (K10); ``rescore`` of explicit
rows runs on the host mirror for IP/L2/cosine and through the distance
kernels' gather mode for the rest (K10).

The quantized FLAT indexes (index/quantized.py) end in the same K3 rescore:
their code scan's top S goes through :func:`shortlist_device_rescore_ids`
(K5, then K11's fused stage ``bf16_gather_topc``: the bf16 rescore of those
rows from the centred copy and its top C in one cluster launch; past
``GATHER_TOPC_MAX`` K11's per-query mode, then K5).

On a mesh (parallel/mesh.py: a ``(data, corpus)`` grid of devices, a device
may repeat, so several virtual shards can share one card) the corpus shards
its rows over the corpus devices and stays resident (a mesh never streams;
staging that does not fit raises). Each shard holds its slice of the centred
bf16 copy, its aux rows, f32 copy and valid mask on its device, centred with
the corpus-wide mean. The resident plans are written once over a view of
the rows (``DeviceCorpus.views``): the whole corpus on one device, or each
shard of a mesh, where every plan ends in the shard's top k with global ids
(two-pass: each shard's K3 rescores its own shortlist; gather: the filter's
rows split by shard, the route chosen on the global counts), and K21a's
merge (``topk.merge_shards``: the copies to the home device, then K5) keeps
the best k.

Each kernel's wrapper launches it for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; the plain versions are what the CPU tests
hold against the JAX package.
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..metrics import Metric
from . import _cuda
from . import distance as D
from ..parallel import get_default_mesh
from .topk import merge_runs, merge_shards, topk_select, topk_select_plain, unorient

# Metrics served by the bf16 first pass + exact f32 rescore.
TWO_PASS_METRICS = (Metric.IP, Metric.L2, Metric.COSINE)
# Below this row count the one-pass f32 exact scan serves every search.
TWO_PASS_MIN_ROWS = 4096
# Filters this selective (and at most a quarter of the corpus) gather their
# rows instead of masking a full scan (reference: engine.rs:95-102).
GATHER_MAX_ROWS = 100_000
# Device arrays hold the row count rounded up to this (the kernels need no
# padding; the slack lets small appends restage in place). Padded rows are
# invalid, so they never reach a result.
ROW_ALIGN = 128
# Largest (B, rows) f32 score matrix one search materialises (1 GB); larger
# query batches are split on the host.
SCORE_BUDGET = 1 << 28
# Rows converted per host staging step.
STAGE_ROWS = 1 << 17
# Largest (B, rows, D) element count one step of an elementwise plain version
# materialises.
PLAIN_ELEMENTS = 1 << 25

# Largest shortlist K3 selects in shared memory; a larger one goes through K5.
RESCORE_SORT_MAX = 1024
# K3 gives a query a 1,024-thread block (32 warps of 4 rows) in place of 256
# threads (8 warps of 8) for shortlists of at least RESCORE_WIDE_MIN_C slots
# (three or more rounds of the smaller block) at up to RESCORE_WIDE_MAX_B
# queries: measured on the H100 (PERF.md, K3), it is ahead at C = 256 to B =
# 16 and behind at C = 64 and at B = 256.
RESCORE_WIDE_MIN_C = 129
RESCORE_WIDE_MAX_B = 16

# K11's fused second stage of a quantized search (bf16_gather_topc): the
# largest C it keeps (C = max(64, 4 k), so k <= 64; above it K11's per-query
# mode writes the (B, S) keys and K5 selects).
GATHER_TOPC_MAX = 256
# Its plan: the fewest slots a block of a query's cluster takes, and each
# warp's cp.async ring in bytes (rows of D not a multiple of 8, unaligned
# ones and those whose ring of one row a stage would not fit the block's
# shared memory load straight from memory).
TOPC_MIN_SLOTS = 256
TOPC_RING_BYTES = 4096
# Its block's layout (csrc/bf16_gather_scores.cu kTopcWarps, kTopcStages,
# kTopcChunk) and the dynamic shared memory a block may take: the card's
# 227 KiB less 1 KiB kept for the kernel's static arrays, as
# lt_bf16_gather_topc checks it.
TOPC_WARPS = 16
TOPC_STAGES = 4
TOPC_CHUNK = 1024
TOPC_SMEM_BYTES = 227 * 1024 - 1024

# The device budget of one corpus in bytes. 0 (the default) is the card's
# free memory plus what the corpus holds already (no limit for a CPU corpus).
DEVICE_BYTES = int(os.environ.get("LYNSE_DEVICE_BYTES", "0"))
# Rows one streaming block holds, in bytes of its pumped rows.
STREAM_BLOCK_BYTES = 1 << 30
# The bytes both pinned staging buffers of a streaming pass hold together.
STREAM_INFLIGHT_BYTES = 3 << 30
# Host mirrors larger than this spill to a temp-file memmap (the reference
# scans mmap'd segments the same way, flat_mmap.rs:89).
MIRROR_RAM_BYTES = 16 << 30
# Host threads that copy mirror rows into a pinned staging buffer.
FILL_THREADS = 4

RESIDENT, HOST_RESCORE, STREAMING = "resident", "host_rescore", "streaming"

# The kernels' metric codes (csrc/common.cuh lt::Metric, lt::BinaryMetric).
_METRIC_CODE = {Metric.IP: 0, Metric.L2: 1, Metric.COSINE: 2}
_GEMM_CODE = {**_METRIC_CODE, Metric.CORRELATION: 3, Metric.HELLINGER: 4}
# the widest bit rows K6b's tile mode takes (130,944 bits): a group of 8
# queries fits in the tile's 128 KB of shared memory (csrc/mma_int.cuh)
BINARY_TILE_WORDS = 4092
_BINARY_CODE = {Metric.HAMMING: 0, Metric.JACCARD: 1, Metric.TANIMOTO: 1, Metric.DICE: 2}
_ELEM_CODE = {Metric.L1: 5, Metric.CHEBYSHEV: 6, Metric.CANBERRA: 7, Metric.BRAY_CURTIS: 8,
              Metric.WASSERSTEIN: 9, Metric.JENSEN_SHANNON: 10, Metric.HAVERSINE: 11}
# the metrics K9's pass over the bf16 copy serves (the rows themselves, not a
# transform)
_BF16_ELEM = (Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS)
# the metrics whose first pass reads the centred bf16 copy off the resident
# tier; the other nine stream their exact f32 rows
_BF16_PASS = TWO_PASS_METRICS + _BF16_ELEM
# K9's spans hold at least this many times C rows: each span's list takes C
# entries however good they are, and K5's merge reads spans x C a query
ELEM_TOPC_SPAN_C = 8
# K9's pilot: over at least ELEM_TOPC_PILOT x 4 x C rows, the C-th key of
# the first ELEM_TOPC_PILOT x C rows is where every list starts (no row below
# it can be in the top C), so a span's list takes only the rows at or above
# it rather than its first C and their successors (on an H100, L1 at B = 16
# over 1M rows 0.957 -> 0.566 ms with it, PERF.md §6)
ELEM_TOPC_PILOT = 32
# ... taken from this many queries: below it the pilot's launches cost more
# than its start saves (L1, C = 256 over 1M rows on an H100, events ms with
# and without it: B = 1 0.239 / 0.227, 4 0.440 / 0.320, 8 0.477 / 0.681,
# 16 0.586 / 0.955; PERF.md §6)
ELEM_TOPC_PILOT_MIN_B = 8


def resolve_device(device) -> torch.device:
    """The explicit device of a corpus: "cuda" needs a card (never a silent
    CPU fallback), "cpu" runs the kernels' plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the kernels' plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _alloc_rows(n_rows: int, dim: int, np_dtype) -> np.ndarray:
    """A zeroed (n_rows, dim) host mirror: in RAM up to MIRROR_RAM_BYTES, an
    anonymous temp-file memmap above (the OS pages it)."""
    nbytes = n_rows * dim * np.dtype(np_dtype).itemsize
    if nbytes <= MIRROR_RAM_BYTES:
        return np.zeros((n_rows, dim), dtype=np_dtype)
    f = tempfile.TemporaryFile(prefix="lynse_mirror_")
    f.truncate(nbytes)
    mm = np.memmap(f, dtype=np_dtype, mode="r+", shape=(n_rows, dim))
    mm._lynse_backing = f  # the file lives as long as the array
    return mm


@functools.cache
def _fill_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(FILL_THREADS, thread_name_prefix="lynse_fill")


def _copy_rows(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[:] = src over FILL_THREADS host threads (numpy copies release the
    GIL), so a pinned buffer fills at more than one core's copy rate."""
    n = len(src)
    if n < 4 * FILL_THREADS * 1024:
        np.copyto(dst, src)
        return
    step = -(-n // FILL_THREADS)
    parts = [_fill_pool().submit(np.copyto, dst[lo : lo + step], src[lo : lo + step])
             for lo in range(0, n, step)]
    for part in parts:
        part.result()


def _kernel_metric(name: str, metric: Metric) -> int:
    """The code of a kernel that serves IP, L2 and cosine only."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"{name} serves IP, L2 and cosine, not {metric.value}")
    return _METRIC_CODE[metric]


def _to_key(scores: torch.Tensor, ascending: bool, valid: torch.Tensor) -> torch.Tensor:
    """Oriented selection keys with NaN and masked rows at -inf."""
    keys = -scores if ascending else scores
    keys = torch.where(torch.isnan(keys), float("-inf"), keys)
    return torch.where(valid[None, :], keys, float("-inf")).contiguous()


# ── K1: exact f32 scores ─────────────────────────────────────────────────


def flat_scores_f32_plain(q, x, qsq, xsq, valid, metric: Metric) -> torch.Tensor:
    """Plain version of :func:`flat_scores_f32`."""
    qt = {"x": q} if metric is Metric.IP else {"x": q, "sq": qsq}
    ct = {"x": x} if metric is Metric.IP else {"x": x, "sq": xsq}
    return _to_key(D.pairwise(qt, ct, metric), metric.ascending, valid)


def flat_scores_f32(q: torch.Tensor, x: torch.Tensor, qsq: Optional[torch.Tensor],
                    xsq: Optional[torch.Tensor], valid: torch.Tensor,
                    metric: Metric) -> torch.Tensor:
    """Oriented, masked exact f32 keys (B, N) of queries ``q`` (B, D) against
    corpus rows ``x`` (N, D). ``qsq``/``xsq`` are the squared row norms (for
    L2 and cosine; None for IP); ``valid`` (N,) bool."""
    if q.device.type == "cpu":
        return flat_scores_f32_plain(q, x, qsq, xsq, valid, metric)
    code = _kernel_metric("flat_scores_f32", metric)
    b, d = q.shape
    n = x.shape[0]
    if metric is Metric.IP:  # the kernel reads no norms for IP
        qsq = xsq = None
    elif qsq is None or xsq is None or qsq.shape != (b,) or xsq.shape != (n,):
        raise ValueError("flat_scores_f32: qsq (B,) and xsq (N,) norms expected for L2/cosine")
    _cuda.require_cuda("flat_scores_f32", q, x, qsq, xsq, valid)
    if q.dtype != torch.float32 or x.dtype != torch.float32 or x.shape[1] != d:
        raise ValueError("flat_scores_f32: q (B, D) and x (N, D) must be float32")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("flat_scores_f32: valid (N,) bool expected")
    keys = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_gemm_metric_scores", q.data_ptr(), x.data_ptr(), _cuda.ptr(qsq), None, None,
        _cuda.ptr(xsq), None, None, valid.data_ptr(), None, b, n, d, 0, code,
        int(metric.ascending), keys.data_ptr(), _cuda.stream_of(q),
    )
    flat_scores_f32.launches += 1
    return keys


flat_scores_f32.launches = 0


# ── K6: the distance kernels of the other metrics ────────────────────────


def metric_keys_plain(qt: dict, ct: dict, valid, metric: Metric, ids=None,
                      mean=None) -> torch.Tensor:
    """Plain version of the distance kernels: D.pairwise of the transforms,
    oriented and masked. Tile mode (``ids`` None): (B, N) over every row of
    ``ct``, masked by ``valid`` (N,); the binary and elementwise forms run a
    step of rows at a time (``PLAIN_ELEMENTS`` unpacked bits or (B, rows, D)
    terms). Gather mode: (B, C) over the rows ``ids`` (B, C), -inf at NaN
    and where an id is negative. ``mean`` (D,): ``ct["x"]`` is the centred
    bf16 copy, the mean added back in f32 (K9's keys)."""
    if mean is not None:
        ct = {"x": ct["x"].to(torch.float32) + mean[None, :]}
    if ids is not None:
        rows = []
        for b in range(ids.shape[0]):
            safe = ids[b].clamp_min(0).long()
            qb = {name: leaf[b : b + 1] for name, leaf in qt.items()}
            rows.append(D.pairwise(qb, {name: leaf[safe] for name, leaf in ct.items()}, metric)[0])
        scores = torch.stack(rows)
        keys = -scores if metric.ascending else scores
        return torch.where((ids >= 0) & ~torch.isnan(keys), keys, float("-inf")).contiguous()
    if metric in D.GEMM_METRICS:
        return _to_key(D.pairwise(qt, ct, metric), metric.ascending, valid)
    n = valid.shape[0]
    if metric in D.BINARY_METRICS:  # a product of the rows unpacked a step at a time
        per_row = 32 * ct["bits"].shape[1]
    else:  # (B, rows, D) elementwise terms
        per_row = next(iter(qt.values())).shape[0] * max(
            leaf.shape[1] if leaf.dim() == 2 else 1 for leaf in ct.values())
    step = max(1, PLAIN_ELEMENTS // max(per_row, 1))
    parts = [D.pairwise(qt, {name: leaf[lo : lo + step] for name, leaf in ct.items()}, metric)
             for lo in range(0, n, step)]
    return _to_key(torch.cat(parts, dim=1), metric.ascending, valid)


def _side_terms(t: dict, metric: Metric):
    """(a, b, invalid) per-row terms a GEMM-family epilogue reads."""
    if metric is Metric.CORRELATION:
        return t["var"], t["mean"], None
    if metric is Metric.HELLINGER:
        return t["mass"], None, t["invalid"]
    return t.get("sq"), None, None


def _gemm_rows(t: dict, metric: Metric) -> torch.Tensor:
    """The rows a GEMM-family product reads: centred (correlation), square
    roots (Hellinger) or the rows."""
    return t[{Metric.CORRELATION: "xc", Metric.HELLINGER: "s"}.get(metric, "x")]


def _check_ids(name: str, ids, b: int) -> None:
    if ids is not None and (ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != b):
        raise ValueError(f"{name}: ids (B, C) int32 expected")


def gemm_metric_scores(qt: dict, ct: dict, valid: Optional[torch.Tensor], metric: Metric,
                       ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6a: oriented, masked keys of the GEMM family (IP, L2, cosine,
    correlation, Hellinger) from the f32 product of the transformed rows
    (``xc`` for correlation, ``s`` for Hellinger) and the per-row terms.
    Tile mode (``ids`` None): (B, N), masked by ``valid`` (N,) bool. Gather
    mode: (B, C) over the rows ``ids`` (B, C) int32, -inf where an id is
    negative (the flat plan runs K1 for IP/L2/cosine; this serves the other
    two and every explicit-row rescore of the family)."""
    q, x = _gemm_rows(qt, metric), _gemm_rows(ct, metric)
    if q.device.type == "cpu":
        return metric_keys_plain(qt, ct, valid, metric, ids)
    b, d = q.shape
    n = x.shape[0]
    _check_ids("gemm_metric_scores", ids, b)
    qa, qb, qinv = _side_terms(qt, metric)
    xa, xb, xinv = _side_terms(ct, metric)
    _cuda.require_cuda("gemm_metric_scores", q, x, qa, qb, qinv, xa, xb, xinv,
                       valid if ids is None else None, ids)
    if q.dtype != torch.float32 or x.dtype != torch.float32 or x.shape[1] != d:
        raise ValueError("gemm_metric_scores: transformed rows (B, D), (N, D) float32 expected")
    if ids is None and (valid is None or valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("gemm_metric_scores: valid (N,) bool expected")
    c = 0 if ids is None else ids.shape[1]
    keys = torch.empty((b, n if ids is None else c), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_gemm_metric_scores", q.data_ptr(), x.data_ptr(), _cuda.ptr(qa), _cuda.ptr(qb),
        _cuda.ptr(qinv), _cuda.ptr(xa), _cuda.ptr(xb), _cuda.ptr(xinv),
        None if ids is not None else valid.data_ptr(), _cuda.ptr(ids), b, n, d, c,
        _GEMM_CODE[metric], int(metric.ascending), keys.data_ptr(), _cuda.stream_of(q),
    )
    gemm_metric_scores.launches += 1
    return keys


gemm_metric_scores.launches = 0


def binary_scores(qt: dict, ct: dict, valid: Optional[torch.Tensor], metric: Metric,
                  ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6b: oriented, masked keys of the binary family (Hamming, Jaccard,
    Tanimoto, Dice) from the popcounts of bit-packed rows (``bits`` (N, W)
    int32 words, ``cnt`` (N,) bit counts). Tile mode and gather mode as
    :func:`gemm_metric_scores`. Equal to the bit to the plain version."""
    q, x = qt["bits"], ct["bits"]
    if q.device.type == "cpu":
        return metric_keys_plain(qt, ct, valid, metric, ids)
    b, w = q.shape
    n = x.shape[0]
    _check_ids("binary_scores", ids, b)
    _cuda.require_cuda("binary_scores", q, x, qt["cnt"], ct["cnt"],
                       valid if ids is None else None, ids)
    if q.dtype != torch.int32 or x.dtype != torch.int32 or x.shape[1] != w:
        raise ValueError("binary_scores: bits (B, W) and (N, W) int32 words expected")
    if ids is None and w > BINARY_TILE_WORDS:
        raise ValueError(f"binary_scores: the tile mode takes at most {BINARY_TILE_WORDS} words")
    if ids is None and (valid is None or valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("binary_scores: valid (N,) bool expected")
    c = 0 if ids is None else ids.shape[1]
    keys = torch.empty((b, n if ids is None else c), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_binary_scores", q.data_ptr(), x.data_ptr(), qt["cnt"].data_ptr(),
        ct["cnt"].data_ptr(), None if ids is not None else valid.data_ptr(), _cuda.ptr(ids),
        b, n, w, c, _BINARY_CODE[metric], keys.data_ptr(), _cuda.stream_of(q),
    )
    binary_scores.launches += 1
    return keys


binary_scores.launches = 0


def _elem_rows(t: dict, metric: Metric) -> torch.Tensor:
    if metric is Metric.WASSERSTEIN:
        return t["cdf"]
    return t["p"] if metric is Metric.JENSEN_SHANNON else t["x"]


def elementwise_scores(qt: dict, ct: dict, valid: Optional[torch.Tensor], metric: Metric,
                       ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6c: oriented, masked keys of the elementwise family (L1, Chebyshev,
    Canberra, Bray-Curtis, Haversine, Wasserstein over ``cdf``,
    Jensen-Shannon over ``p``). Tile mode and gather mode as
    :func:`gemm_metric_scores`. The pass over the centred bf16 copy is
    :func:`elementwise_topc` (K9)."""
    q, x = _elem_rows(qt, metric), _elem_rows(ct, metric)
    if q.device.type == "cpu":
        return metric_keys_plain(qt, ct, valid, metric, ids)
    b, d = q.shape
    n = x.shape[0]
    _check_ids("elementwise_scores", ids, b)
    if q.dtype != torch.float32 or x.dtype != torch.float32 or x.shape[1] != d:
        raise ValueError("elementwise_scores: rows (B, D) and (N, D) float32 expected")
    if ids is None and (valid is None or valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("elementwise_scores: valid (N,) bool expected")
    prob = metric in (Metric.WASSERSTEIN, Metric.JENSEN_SHANNON)
    terms = [t.get(name) if prob else None for t in (qt, ct) for name in ("mass", "ent", "invalid")]
    _cuda.require_cuda("elementwise_scores", q, x, *terms, valid if ids is None else None, ids)
    c = 0 if ids is None else ids.shape[1]
    keys = torch.empty((b, n if ids is None else c), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_elementwise_scores", q.data_ptr(), x.data_ptr(), *(_cuda.ptr(t) for t in terms),
        None if ids is not None else valid.data_ptr(), _cuda.ptr(ids), b, n, d, c,
        _ELEM_CODE[metric], keys.data_ptr(), _cuda.stream_of(q),
    )
    elementwise_scores.launches += 1
    elementwise_scores.by_mode["f32_tile" if ids is None else "gather"] += 1
    return keys


elementwise_scores.launches = 0
# K6c's launches by mode: the f32 tile, the bf16 pass fused with its top C
# (K9) and its keys unfused (K9's route by shape for Canberra; both also
# counted by elementwise_topc), and gather (K10)
elementwise_scores.by_mode = {"f32_tile": 0, "bf16_topc": 0, "bf16": 0, "gather": 0}


def elementwise_topc_plain(q, x16, mean, valid, metric: Metric, c: int, start=None):
    """Plain version of :func:`elementwise_topc`: every key of K6c over the
    centred copy with the mean added back (metric_keys_plain), then K5's
    plain top C (of the keys at or above ``start``)."""
    keys = metric_keys_plain({"x": q}, {"x": x16}, valid, metric, mean=mean)
    if start is None:
        return topk_select_plain(keys, c)
    top, ids = topk_select_plain(torch.where(keys >= start[:, None], keys, float("-inf")), c)
    return top, torch.where(top < start[:, None], -1, ids)


def elementwise_topc(q: torch.Tensor, x16: torch.Tensor, mean: torch.Tensor,
                     valid: torch.Tensor, metric: Metric, c: int,
                     start: Optional[torch.Tensor] = None,
                     pilot: Optional[bool] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K9, K6c's pass over the mean-centred bf16 copy fused with its top C:
    the keys of L1, Chebyshev, Canberra or Bray-Curtis between f32 queries
    ``q`` (B, D) and the rows ``x16`` (N, D) bfloat16 with ``mean`` (D,)
    added back in f32, oriented and masked by ``valid`` (N,) bool, and their
    exact top C: (keys (B, C) f32, row ids (B, C) int32), best first, the
    lower row first between equal keys, what ``topk_select`` of those keys
    returns (masked rows' -inf keys in id order; 1 <= C <= N). ``start``
    (B,) f32: only keys at or above ``start[b]`` may enter query b's list
    (K8 passes its carried state's C-th key: nothing below it can enter the
    merge), the slots past them hold (-inf, -1). The kernel keeps each
    span's top C as it scores it and never writes the (B, N) keys; K5
    merges the spans' sorted lists (:func:`topk.merge_runs`). Without a
    start, a corpus of at least 4 x ELEM_TOPC_PILOT x C rows takes a pilot
    launch over its first ELEM_TOPC_PILOT x C rows first, whose C-th key
    starts the main launch's lists: from ELEM_TOPC_PILOT_MIN_B queries, or
    as ``pilot`` (True / False) forces it (the same results). Where the kernel file's route by shape
    does not fuse (its plan has no spans: L1, Canberra and Bray-Curtis past
    its bytes route) the 64-row tile's keys and K5. Its launches count here
    and on :func:`elementwise_scores` (modes ``bf16_topc``, ``bf16``)."""
    b, d = q.shape
    n = x16.shape[0]
    if not 1 <= c <= n:
        raise ValueError(f"elementwise_topc: C={c} outside [1, {n}]")
    if metric not in _BF16_ELEM:
        raise ValueError(f"elementwise_topc serves {[m.value for m in _BF16_ELEM]}, "
                         f"not {metric.value}")
    if start is not None and (start.shape != (b,) or start.dtype != torch.float32):
        raise ValueError("elementwise_topc: start (B,) float32 expected")
    if q.device.type == "cpu":
        return elementwise_topc_plain(q, x16, mean, valid, metric, c, start)
    _cuda.require_cuda("elementwise_topc", q, x16, mean, valid, start)
    if (q.dtype != torch.float32 or x16.dtype != torch.bfloat16 or x16.shape[1] != d
            or mean.shape != (d,) or mean.dtype != torch.float32 or valid.shape != (n,)
            or valid.dtype != torch.bool):
        raise ValueError("elementwise_topc: q (B, D) float32, x16 (N, D) bfloat16, mean (D,) "
                         "float32 and valid (N,) bool expected")
    vec = _topc_vec(q, x16, mean)
    plan = _elem_topc_plan(b, n, d, c, _ELEM_CODE[metric], vec, ELEM_TOPC_SPAN_C)
    if plan[0] == 0:
        keys = _elem_bf16_keys(q, x16, mean, valid, metric)
        if start is not None:
            keys = torch.where(keys >= start[:, None], keys, float("-inf"))
        top, ids = topk_select(keys, c)
        return top, ids if start is None else torch.where(top < start[:, None], -1, ids)
    if pilot is None:
        pilot = b >= ELEM_TOPC_PILOT_MIN_B
    if pilot and start is None and n >= 4 * ELEM_TOPC_PILOT * c:
        m = ELEM_TOPC_PILOT * c  # the pilot's spans: C rows or more each
        pilot = _elem_topc_plan(b, m, d, c, _ELEM_CODE[metric], vec, 1)
        keys, _ = _elem_topc_launch(q, x16[:m], mean, valid[:m], metric, c, None, 1, vec, pilot)
        keys, ids = _elem_topc_launch(q, x16, mean, valid, metric, c,
                                      keys[:, c - 1].contiguous(), ELEM_TOPC_SPAN_C, vec, plan)
        return keys, ids  # the pilot's C rows are at or above its start: C real entries
    keys, ids = _elem_topc_launch(q, x16, mean, valid, metric, c,
                                  None if start is None else start.contiguous(), ELEM_TOPC_SPAN_C,
                                  vec, plan)
    if start is not None:
        ids = torch.where(keys < start[:, None], -1, ids)
    return keys, ids


def _topc_vec(q, x16, mean) -> bool:
    """K9's 16-byte copies: D a multiple of 8 and 16-byte aligned bases."""
    return q.shape[1] % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, x16, mean))


def _elem_bf16_keys(q, x16, mean, valid, metric: Metric) -> torch.Tensor:
    """K9's route by shape past its fused routes: the (B, N) keys of the
    64-row tile over the centred copy (K6c's bf16 keys), for K5 to select
    from."""
    b, d = q.shape
    n = x16.shape[0]
    keys = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.call("lt_elementwise_bf16_keys", q.data_ptr(), x16.data_ptr(), mean.data_ptr(),
               valid.data_ptr(), b, n, d, _ELEM_CODE[metric], keys.data_ptr(),
               _cuda.stream_of(q))
    elementwise_topc.launches += 1
    elementwise_scores.launches += 1
    elementwise_scores.by_mode["bf16"] += 1
    return keys


@functools.lru_cache(maxsize=256)
def _elem_topc_plan(b: int, n: int, d: int, c: int, code: int, vec: bool,
                    span_c: int) -> tuple[int, int]:
    """K9's plan for these shapes (lt_elem_topc_plan, asked once a shape):
    (spans, device list entries); (0, 0) where the kernel file routes the
    shapes to the 64-row tile's keys and K5."""
    lib = _cuda.library()
    plan = tuple(int(lib.lt_elem_topc_plan(b, n, d, c, code, int(vec), span_c, what))
                 for what in (0, 1))
    if plan[0] < 0 or plan[1] < 0 or (plan[0] > 0) != (plan[1] > 0):
        raise RuntimeError(f"elementwise_topc: no plan for B={b}, N={n}, D={d}, C={c}")
    return plan


def _elem_topc_launch(q, x16, mean, valid, metric: Metric, c: int, start, span_c: int,
                      vec: bool, plan: tuple[int, int]):
    """One launch of K9's kernel on its ``plan`` (then K5's merge of its
    spans' lists)."""
    b, d = q.shape
    n = x16.shape[0]
    spans, entries = plan
    if spans < 1:
        raise RuntimeError(f"elementwise_topc: B={b}, N={n}, D={d}, C={c} is not fused")
    lists = torch.empty(entries, dtype=torch.int64, device=q.device)
    keys = torch.empty((b, spans * c), dtype=torch.float32, device=q.device)
    ids = torch.empty((b, spans * c), dtype=torch.int32, device=q.device)
    _cuda.call("lt_elementwise_topc", q.data_ptr(), x16.data_ptr(), mean.data_ptr(),
               valid.data_ptr(), _cuda.ptr(start), b, n, d, c, _ELEM_CODE[metric], int(vec),
               span_c, spans, lists.data_ptr(), keys.data_ptr(), ids.data_ptr(),
               _cuda.stream_of(q))
    elementwise_topc.launches += 1
    elementwise_scores.launches += 1
    elementwise_scores.by_mode["bf16_topc"] += 1
    if spans == 1:
        return keys, ids
    return merge_runs(keys, ids, c)


elementwise_topc.launches = 0


def metric_keys(qt: dict, ct: dict, valid: Optional[torch.Tensor], metric: Metric,
                ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Oriented, masked keys of any metric through its family's kernel: K1
    for IP/L2/cosine over every row, K6a, K6b or K6c otherwise (tile mode
    over every row masked by ``valid``, or gather mode over ``ids``)."""
    if metric in D.BINARY_METRICS:
        return binary_scores(qt, ct, valid, metric, ids)
    if metric in D.ELEMENTWISE_METRICS:
        return elementwise_scores(qt, ct, valid, metric, ids)
    if metric in _METRIC_CODE and ids is None:
        return flat_scores_f32(qt["x"], ct["x"], qt.get("sq"), ct.get("sq"), valid, metric)
    return gemm_metric_scores(qt, ct, valid, metric, ids)


# ── K2: centred bf16 first pass, fused with its top-C selection ────────


def _query_terms(q: torch.Tensor, mean: torch.Tensor):
    """Per-query terms of the first pass: the bf16-rounded centred query and
    |q - m|^2, q.m, |q|^2 (all from the f32 values)."""
    qc = q - mean[None, :]
    return (qc.to(torch.bfloat16).contiguous(), (qc * qc).sum(-1), (q * mean[None, :]).sum(-1),
            (q * q).sum(-1))


def bf16_centered_scores_plain(q, x16, aux: dict, valid, metric: Metric) -> torch.Tensor:
    """The first pass's oriented, masked keys (B, N): the bf16 operands are
    upcast to f32 before the product (JAX's preferred_element_type=f32).
    The score function of :func:`bf16_centered_topc_plain`."""
    qc16, qc_sq, qm, q_sq = _query_terms(q, aux["mean"])
    ip_c = qc16.to(torch.float32) @ x16.to(torch.float32).T
    if metric is Metric.IP:
        scores = ip_c + aux["xm"][None, :]
    elif metric is Metric.L2:
        scores = torch.clamp_min(qc_sq[:, None] + aux["xc_sq"][None, :] - 2.0 * ip_c, 0.0)
    elif metric is Metric.COSINE:  # true numerator over true norms
        num = ip_c + aux["xm"][None, :] + qm[:, None]
        denom = torch.sqrt(q_sq[:, None] * aux["xsq_true"][None, :])
        scores = torch.where(denom < 1e-30, 1.0, 1.0 - num / torch.clamp_min(denom, 1e-30))
    else:
        _kernel_metric("bf16_centered_topc", metric)
    return _to_key(scores, metric.ascending, valid)


def bf16_centered_topc_plain(q, x16, aux: dict, valid, metric: Metric, c: int):
    """Plain version of :func:`bf16_centered_topc`: every key, then the
    exact top C, with id -1 in the slots a masked row or NaN would fill."""
    top, idx = topk_select_plain(bf16_centered_scores_plain(q, x16, aux, valid, metric), c)
    return top, torch.where(top > float("-inf"), idx, -1)


def bf16_centered_topc(q: torch.Tensor, x16: torch.Tensor, aux: dict, valid: torch.Tensor,
                       metric: Metric, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top C of the first-pass keys of f32 queries ``q`` (B, D)
    against the mean-centred bf16 corpus ``x16`` (N, D): (keys (B, C) f32,
    row ids (B, C) int32), key descending and the lower row id first between
    equal keys, (-inf, -1) in slots no live row fills. ``aux``: mean (D,),
    xm / xc_sq / xsq_true (N,) f32 (see DeviceCorpus._convert_block);
    ``valid`` (N,) bool. The kernel keeps each span's top C in shared memory
    and never writes the (B, N) keys; K5 merges the spans' sorted lists
    (:func:`topk.merge_runs`). 1 <= C <= N."""
    b, d = q.shape
    n = x16.shape[0]
    if not 1 <= c <= n:
        raise ValueError(f"bf16_centered_topc: C={c} outside [1, {n}]")
    if q.device.type == "cpu":
        return bf16_centered_topc_plain(q, x16, aux, valid, metric, c)
    code = _kernel_metric("bf16_centered_topc", metric)
    qc16, qc_sq, qm, q_sq = _query_terms(q, aux["mean"])
    _cuda.require_cuda("bf16_centered_topc", q, x16, aux["xm"], aux["xc_sq"], aux["xsq_true"],
                       valid)
    if x16.dtype != torch.bfloat16 or x16.shape[1] != d or q.dtype != torch.float32:
        raise ValueError("bf16_centered_topc: q (B, D) float32 and x16 (N, D) bfloat16 expected")
    if any(aux[key].shape != (n,) for key in ("xm", "xc_sq", "xsq_true")) or valid.shape != (n,):
        raise ValueError("bf16_centered_topc: aux arrays and valid must be (N,)")
    lib = _cuda.library()
    spans, scratch = lib.lt_topc_spans(b, n, d, c), lib.lt_topc_scratch(b, n, d, c)
    keys = torch.empty((b, spans * c), dtype=torch.float32, device=q.device)
    ids = torch.empty((b, spans * c), dtype=torch.int32, device=q.device)
    lists = torch.empty(scratch, dtype=torch.int64, device=q.device) if scratch else None
    _cuda.call(
        "lt_bf16_centered_topc", qc16.data_ptr(), x16.data_ptr(), qc_sq.data_ptr(),
        qm.data_ptr(), q_sq.data_ptr(), aux["xm"].data_ptr(), aux["xc_sq"].data_ptr(),
        aux["xsq_true"].data_ptr(), valid.data_ptr(), b, n, d, c, code, int(metric.ascending),
        keys.data_ptr(), ids.data_ptr(), _cuda.ptr(lists), _cuda.stream_of(q),
    )
    bf16_centered_topc.launches += 1
    if spans == 1:
        return keys, ids
    return merge_runs(keys, ids, c)


bf16_centered_topc.launches = 0


# ── K3: exact rescore of the shortlist ───────────────────────────────────


def _exact_scores(q: torch.Tensor, rows: torch.Tensor, metric: Metric) -> torch.Tensor:
    ip = torch.einsum("bd,bcd->bc", q, rows)
    if metric is Metric.IP:
        return ip
    q_sq = (q * q).sum(-1, keepdim=True)
    r_sq = (rows * rows).sum(-1)
    if metric is Metric.L2:
        return torch.clamp_min(q_sq + r_sq - 2.0 * ip, 0.0)
    denom = torch.sqrt(q_sq * r_sq)
    return torch.where(denom < 1e-30, 1.0, 1.0 - ip / torch.clamp_min(denom, 1e-30))


def rescore_topk_plain(q, x32, cand_keys, cand_idx, k: int, metric: Metric):
    """Plain version of :func:`rescore_topk`."""
    ok = cand_keys > float("-inf")
    safe = torch.where(ok, cand_idx, 0).long()
    exact = _exact_scores(q, x32[safe], metric)
    key = -exact if metric.ascending else exact
    key = torch.where(ok & torch.isfinite(key), key, float("-inf"))
    # (key desc, id asc): a stable sort by id, then a stable sort by key
    by_id = torch.sort(safe, dim=1, stable=True).indices
    by_key = torch.sort(key.gather(1, by_id), dim=1, descending=True, stable=True).indices
    order = by_id.gather(1, by_key)[:, :k]
    kept = key.gather(1, order) > float("-inf")
    fill = float("inf") if metric.ascending else float("-inf")
    dists = torch.where(kept, exact.gather(1, order), fill)
    return dists.contiguous(), torch.where(kept, safe.gather(1, order), -1).contiguous()


def _rescore_wide(b: int, c: int) -> bool:
    """Whether K3 takes its 1,024-thread block a query (RESCORE_WIDE_MIN_C
    <= C <= RESCORE_SORT_MAX at B <= RESCORE_WIDE_MAX_B)."""
    return RESCORE_WIDE_MIN_C <= c <= RESCORE_SORT_MAX and b <= RESCORE_WIDE_MAX_B


def rescore_topk(q: torch.Tensor, x32: torch.Tensor, cand_keys: torch.Tensor,
                 cand_idx: torch.Tensor, k: int, metric: Metric, wide: Optional[bool] = None):
    """Exact f32 rescore of a (B, C) shortlist (``cand_idx`` int32 row ids,
    ``cand_keys`` the first-pass keys, -inf for an empty slot) against the f32
    corpus ``x32``: best k by (score desc, id asc), non-finite scores dropped.
    Returns (dists (B, k) f32, ids (B, k) int64) with +inf/-inf and -1 in
    the slots nothing filled. Up to ``RESCORE_SORT_MAX`` slots one kernel
    scores and selects (a 1,024-thread block a query where ``wide``, else
    256 threads; :func:`_rescore_wide`'s choice when None); above it the
    kernel writes the (B, C) exact keys and K5 selects the top k with the
    row ids as its tie-break."""
    if q.device.type == "cpu":
        return rescore_topk_plain(q, x32, cand_keys, cand_idx, k, metric)
    code = _kernel_metric("rescore_topk", metric)
    b, d = q.shape
    c = cand_idx.shape[1]
    _cuda.require_cuda("rescore_topk", q, x32, cand_keys, cand_idx)
    if q.dtype != torch.float32 or x32.dtype != torch.float32 or x32.shape[1] != d:
        raise ValueError("rescore_topk: q (B, D) and x32 (N, D) must be float32")
    if cand_idx.dtype != torch.int32 or cand_keys.shape != (b, c) or cand_idx.shape != (b, c):
        raise ValueError("rescore_topk: cand_keys (B, C) float32 and cand_idx (B, C) int32 expected")
    if not 1 <= k <= c:
        raise ValueError(f"rescore_topk: need 1 <= k <= C, got k={k}, C={c}")
    stream = _cuda.stream_of(q)
    if c <= RESCORE_SORT_MAX:
        if wide is None:
            wide = _rescore_wide(b, c)
        dists = torch.empty((b, k), dtype=torch.float32, device=q.device)
        ids = torch.empty((b, k), dtype=torch.int64, device=q.device)
        _cuda.call(
            "lt_rescore_topk", q.data_ptr(), x32.data_ptr(), cand_keys.data_ptr(),
            cand_idx.data_ptr(), b, c, d, k, code, int(metric.ascending), int(wide),
            dists.data_ptr(), ids.data_ptr(), stream,
        )
        rescore_topk.launches += 1
        return dists, ids
    keys = torch.empty((b, c), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_rescore_keys", q.data_ptr(), x32.data_ptr(), cand_keys.data_ptr(),
        cand_idx.data_ptr(), b, c, d, code, int(metric.ascending), keys.data_ptr(), stream,
    )
    rescore_topk.launches += 1
    top, top_ids = topk_select(keys, k, ids=cand_idx)
    kept = top > float("-inf")
    fill = float("inf") if metric.ascending else float("-inf")
    return (torch.where(kept, unorient(top, metric.ascending), fill),
            torch.where(kept, top_ids.long(), -1))


rescore_topk.launches = 0


# ── K11: bf16 rescore of a gathered shortlist ────────────────────────────


def _gather_stride(idx: torch.Tensor, b: int, shared: bool) -> int:
    """The batch stride of K11's index list: 0 for one list shared by every
    query (1, S), else S. A (1, S) list under B > 1 can only be shared; at
    B = 1 ``shared`` says which it is."""
    if idx.dim() != 2 or idx.shape[0] not in (1, b) or (shared and idx.shape[0] != 1):
        raise ValueError("bf16_gather_scores: idx (B, S), or (1, S) when shared, expected")
    return 0 if shared or idx.shape[0] != b else idx.shape[1]


def bf16_gather_scores_plain(q, x16, aux: dict, idx, slot_keys, metric: Metric, *,
                             shared: bool = False) -> torch.Tensor:
    """Plain version of :func:`bf16_gather_scores`: the bf16 operands are
    upcast to f32 before the product (JAX's preferred_element_type=f32)."""
    _gather_stride(idx, q.shape[0], shared)
    ok = idx >= 0
    if slot_keys is not None:
        ok = ok & (slot_keys > float("-inf"))
    ok = ok.expand(q.shape[0], -1)
    safe = torch.where(ok, idx, 0).long()
    qc16, qc_sq, qm, q_sq = _query_terms(q, aux["mean"])
    ip_c = torch.einsum("bd,bsd->bs", qc16.to(torch.float32), x16[safe].to(torch.float32))
    if metric is Metric.IP:
        scores = ip_c + aux["xm"][safe]
    elif metric is Metric.L2:
        scores = torch.clamp_min(qc_sq[:, None] + aux["xc_sq"][safe] - 2.0 * ip_c, 0.0)
    elif metric is Metric.COSINE:  # true numerator over true norms
        num = ip_c + aux["xm"][safe] + qm[:, None]
        denom = torch.sqrt(q_sq[:, None] * aux["xsq_true"][safe])
        scores = torch.where(denom < 1e-30, 1.0, 1.0 - num / torch.clamp_min(denom, 1e-30))
    else:
        _kernel_metric("bf16_gather_scores", metric)
    keys = -scores if metric.ascending else scores
    return torch.where(ok & ~torch.isnan(keys), keys, float("-inf")).contiguous()


def bf16_gather_scores(q: torch.Tensor, x16: torch.Tensor, aux: dict, idx: torch.Tensor,
                       slot_keys: Optional[torch.Tensor], metric: Metric, *,
                       shared: bool = False) -> torch.Tensor:
    """Oriented keys (B, S) of f32 queries ``q`` (B, D) against the rows
    ``idx`` of the mean-centred bf16 corpus ``x16``, with K2's corrections
    (``aux`` as for bf16_centered_topc). ``idx`` int32 is (B, S), one list
    a query (the kernel's per-query route), or (1, S) with ``shared``, one
    list for every query (its shared-list tile; a (1, S) list under B > 1 is
    shared in any case); a slot is empty (key -inf) where its id is negative
    or, when ``slot_keys`` (laid out as ``idx``) is given, where its key is
    -inf."""
    if q.device.type == "cpu":
        return bf16_gather_scores_plain(q, x16, aux, idx, slot_keys, metric, shared=shared)
    code = _kernel_metric("bf16_gather_scores", metric)
    b, d = q.shape
    s = idx.shape[1]
    stride = _gather_stride(idx, b, shared)
    if idx.dtype != torch.int32:
        raise ValueError("bf16_gather_scores: idx int32 expected")
    if slot_keys is not None and slot_keys.shape != idx.shape:
        raise ValueError("bf16_gather_scores: slot_keys must be shaped like idx")
    if x16.dtype != torch.bfloat16 or x16.shape[1] != d or q.dtype != torch.float32:
        raise ValueError("bf16_gather_scores: q (B, D) float32 and x16 (N, D) bfloat16 expected")
    qc16, qc_sq, qm, q_sq = _query_terms(q, aux["mean"])
    _cuda.require_cuda("bf16_gather_scores", q, x16, idx, slot_keys, aux["xm"], aux["xc_sq"],
                       aux["xsq_true"])
    keys = torch.empty((b, s), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_bf16_gather_scores", qc16.data_ptr(), x16.data_ptr(), idx.data_ptr(), stride,
        _cuda.ptr(slot_keys), qc_sq.data_ptr(),
        qm.data_ptr(), q_sq.data_ptr(), aux["xm"].data_ptr(), aux["xc_sq"].data_ptr(),
        aux["xsq_true"].data_ptr(), b, s, d, code, int(metric.ascending), keys.data_ptr(),
        _cuda.stream_of(q),
    )
    bf16_gather_scores.launches += 1
    bf16_gather_scores.by_mode["shared" if stride == 0 else "per_query"] += 1
    return keys


bf16_gather_scores.launches = 0
# K11's launches by mode: the fused second stage (bf16_gather_topc), one
# list a query, one list shared by every query
bf16_gather_scores.by_mode = {"fused": 0, "per_query": 0, "shared": 0}


def bf16_gather_topc_plain(q, x16, aux: dict, cand, top, metric: Metric, c: int):
    """Plain version of :func:`bf16_gather_topc`: K11's plain keys of the
    slots, their top C, the slots mapped to row ids."""
    keys = bf16_gather_scores_plain(q, x16, aux, cand, top, metric)
    top2, j = topk_select_plain(keys, min(c, keys.shape[1]))
    return top2, torch.where(top2 > float("-inf"), cand.gather(1, j.long()), -1)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gather_topc_smem(d: int, c: int, rw: int) -> int:
    """The fused stage's dynamic shared memory in bytes at width ``d``, C
    ``c`` and ``rw`` rows a ring stage: the cluster's 8 lists of kp entries,
    the block's next list, a chunk's entries and live slots, the query, and
    each warp's ring of rows and their two aux words."""
    kp = 8
    while kp < c:
        kp *= 2
    return ((9 * kp + TOPC_CHUNK) * 8 + ((d + 3) & ~3) * 4 + TOPC_CHUNK * 8
            + TOPC_WARPS * TOPC_STAGES * rw * (2 * d + 8))


def _gather_topc_plan(b: int, s: int, d: int, c: int, aligned: bool = True, sms: int = 132):
    """The fused stage's launch: (cs, rw). cs blocks a query (a cluster of
    1, 2, 4 or 8 over disjoint slot ranges): the most that keep B x cs
    within 1.75 blocks an SM (two of its 512-thread blocks fit an SM; the
    margin keeps the clusters of a batch in one wave) and at least
    TOPC_MIN_SLOTS slots a block. rw rows a stage of each warp's four-stage
    cp.async ring (TOPC_RING_BYTES a warp, 1 to 16 rows), for D a multiple
    of 8 over a 16-byte aligned corpus, the most whose shared memory fits
    TOPC_SMEM_BYTES at this D and C; else 0, the rows loaded straight from
    memory."""
    cs = 8
    while cs > 1 and (b * cs > 7 * sms // 4 or s // cs < TOPC_MIN_SLOTS):
        cs //= 2
    rw = 0
    if d % 8 == 0 and aligned:
        rw = max(1, min(16, TOPC_RING_BYTES // (4 * 2 * d)))
        while rw > 0 and _gather_topc_smem(d, c, rw) > TOPC_SMEM_BYTES:
            rw -= 1
    return cs, rw


def bf16_gather_topc(q: torch.Tensor, x16: torch.Tensor, aux: dict, cand: torch.Tensor,
                     top: torch.Tensor, metric: Metric, c: int):
    """K11's fused second stage: the bf16 keys of the rows ``cand`` (B, S)
    int32 of the mean-centred corpus ``x16`` for f32 queries ``q`` (B, D),
    as :func:`bf16_gather_scores` forms them (a slot is empty where its id
    is negative or its K5 key in ``top`` (B, S) is -inf), and their top
    min(C, S) in one launch: (keys (B, C) f32 in K5's order, key descending
    and the lower slot first between equal keys, row ids (B, C) int32; -inf
    and -1 past the live slots). A query's slots are split over a cluster of
    blocks, each keeping its best C in shared memory; the first block merges
    them through distributed shared memory. The (B, S) keys never reach
    device memory. C <= GATHER_TOPC_MAX. A refused launch raises."""
    b, d = q.shape
    s = cand.shape[1]
    c = min(c, s)
    if q.device.type == "cpu":
        return bf16_gather_topc_plain(q, x16, aux, cand, top, metric, c)
    code = _kernel_metric("bf16_gather_topc", metric)
    if not 1 <= c <= GATHER_TOPC_MAX:
        raise ValueError(f"bf16_gather_topc: C={c} outside [1, {GATHER_TOPC_MAX}]")
    if cand.dtype != torch.int32 or cand.shape != (b, s) or top.shape != (b, s) \
            or top.dtype != torch.float32:
        raise ValueError("bf16_gather_topc: cand (B, S) int32 and top (B, S) float32 expected")
    if x16.dtype != torch.bfloat16 or x16.shape[1] != d or q.dtype != torch.float32:
        raise ValueError("bf16_gather_topc: q (B, D) float32 and x16 (N, D) bfloat16 expected")
    _cuda.require_cuda("bf16_gather_topc", q, aux["mean"], x16, aux["xm"], aux["xc_sq"],
                       aux["xsq_true"], top, cand)
    cs, rw = _gather_topc_plan(b, s, d, c, x16.data_ptr() % 16 == 0, _sm_count(q.device))
    keys = torch.empty((b, c), dtype=torch.float32, device=q.device)
    ids = torch.empty((b, c), dtype=torch.int32, device=q.device)
    _cuda.call(
        "lt_bf16_gather_topc", q.data_ptr(), aux["mean"].data_ptr(), x16.data_ptr(),
        aux["xm"].data_ptr(), aux["xc_sq"].data_ptr(), aux["xsq_true"].data_ptr(),
        top.data_ptr(), cand.data_ptr(), b, s, d, c, cs, rw, code, int(metric.ascending),
        keys.data_ptr(), ids.data_ptr(), _cuda.stream_of(q),
    )
    bf16_gather_scores.launches += 1
    bf16_gather_scores.by_mode["fused"] += 1
    return keys, ids


def shortlist_device_rescore_ids(q: torch.Tensor, approx_keys: torch.Tensor, x16: torch.Tensor,
                                 aux: dict, metric: Metric, s: int, c: int):
    """The quantized indexes' second stage: the top S of the approximate
    code-scan keys (B, N) (K5), then a bf16 rescore of those S rows gathered
    from the centred corpus and its top C: K11's fused stage in one launch
    (:func:`bf16_gather_topc`) up to GATHER_TOPC_MAX, else K11's per-query
    mode and K5. Returns (keys (B, C) f32, row ids (B, C) int32): the ids
    and keys K3 rescores exactly, -inf and -1 in slots nothing filled."""
    top, cand = topk_select(approx_keys, min(s, approx_keys.shape[1]))
    c = min(c, top.shape[1])
    if c <= GATHER_TOPC_MAX:
        return bf16_gather_topc(q, x16, aux, cand, top, metric, c)
    keys = bf16_gather_scores(q, x16, aux, cand, top, metric)
    top2, j = topk_select(keys, c)
    gid = cand.gather(1, j.long())
    return top2, torch.where(top2 > float("-inf"), gid, -1)


# ── K8: one block of the streaming scan ──────────────────────────────────


class StreamBlock(NamedTuple):
    """One corpus block on the scan's device: rows [base, base + len(x)).
    ``kind`` "bf16": ``x`` the centred bf16 rows, ``aux`` their xm / xc_sq
    / xsq_true, ``mean`` (D,); "f32": ``x`` the exact rows. ``valid`` (r,)
    bool is the block's mask (range, tombstones, filter)."""

    kind: str
    x: torch.Tensor
    aux: Optional[dict]
    valid: torch.Tensor
    base: int
    mean: Optional[torch.Tensor]


def _block_top(q: torch.Tensor, qt: Optional[dict], blk: StreamBlock, metric: Metric, c: int,
               plain: bool, start: Optional[torch.Tensor] = None):
    """One block's top C with global row ids, -inf / -1 in empty slots: K2's
    fused pass over a bf16 block (IP, L2, cosine), K9's (the L1 family;
    ``start``, the carried state's C-th key, keeps out what cannot enter the
    merge), or the metric's exact kernel over the transform of an f32 block
    (``qt`` its query transform) and K5.
    ``plain``: the kernels' plain versions, on any device."""
    c = min(c, blk.x.shape[0])
    if blk.kind == "bf16" and metric in TWO_PASS_METRICS:
        fn = bf16_centered_topc_plain if plain else bf16_centered_topc
        top, loc = fn(q, blk.x, {"mean": blk.mean, **blk.aux}, blk.valid, metric, c)
    elif blk.kind == "bf16":
        fn = elementwise_topc_plain if plain else elementwise_topc
        top, loc = fn(q, blk.x, blk.mean, blk.valid, metric, c, start)
    else:
        ct = D.corpus_transform(blk.x, metric)
        keys = (metric_keys_plain if plain else metric_keys)(qt, ct, blk.valid, metric)
        top, loc = (topk_select_plain if plain else topk_select)(keys, c)
    return top, torch.where(top > float("-inf"), loc + blk.base, -1).to(torch.int32)


def stream_block(q: torch.Tensor, qt: Optional[dict], blk: StreamBlock, keys: torch.Tensor,
                 ids: torch.Tensor, metric: Metric, c: int):
    """K8: advance one query chunk's carried top-C state (``keys`` (B, C)
    f32, ``ids`` (B, C) int32 global row ids, -inf / -1 in empty slots)
    across one block: the block's top C with global ids (:func:`_block_top`)
    and K5 merging the two sorted runs, state and block (best key first, the
    lower id between equal keys). Returns the new (keys, ids)."""
    top, gid = _block_top(q, qt, blk, metric, c, plain=False, start=keys[:, -1].contiguous())
    if top.shape[1] < c:  # a block shorter than C: pad its list to a run of C
        top = torch.nn.functional.pad(top, (0, c - top.shape[1]), value=float("-inf"))
        gid = torch.nn.functional.pad(gid, (0, c - gid.shape[1]), value=-1)
    out = merge_runs(torch.cat([keys, top], dim=1), torch.cat([ids, gid], dim=1), c)
    if q.device.type == "cuda":
        stream_block.launches += 1
    return out


stream_block.launches = 0


def stream_block_plain(q: torch.Tensor, qt: Optional[dict], blk: StreamBlock,
                       keys: torch.Tensor, ids: torch.Tensor, metric: Metric, c: int):
    """Plain version of :func:`stream_block`, on the inputs' device."""
    top, gid = _block_top(q, qt, blk, metric, c, plain=True)
    return topk_select_plain(torch.cat([keys, top], dim=1), c, ids=torch.cat([ids, gid], dim=1))


# ── host-side exact scores ───────────────────────────────────────────────


def host_exact_scores(q: np.ndarray, rows: np.ndarray, metric: Metric) -> np.ndarray:
    """Exact f32 scores for (B, C, D) candidate rows against (B, D) queries,
    computed on the host mirror."""
    q = q.astype(np.float32)
    rows = rows.astype(np.float32)
    ip = np.einsum("bcd,bd->bc", rows, q)
    if metric is Metric.IP:
        return ip
    q_sq = np.sum(q * q, axis=-1, keepdims=True)
    r_sq = np.sum(rows * rows, axis=-1)
    if metric is Metric.L2:
        return np.maximum(q_sq + r_sq - 2.0 * ip, 0.0)
    if metric is Metric.COSINE:
        denom = np.sqrt(q_sq * r_sq)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = 1.0 - ip / np.maximum(denom, 1e-30)
        return np.where(denom < 1e-30, 1.0, out).astype(np.float32)
    raise ValueError(f"host rescore does not support {metric}")


class FilterHandle:
    """A resolved row filter: host mask + count, with the device mask and the
    gather route's index list staged lazily and cached per corpus epoch.
    Collections cache these per where-string so repeated filtered queries pay
    no re-upload."""

    __slots__ = ("mask", "count", "_epoch", "_cache")

    def __init__(self, mask: np.ndarray):
        self.mask = np.asarray(mask, dtype=bool)
        self.count = int(self.mask.sum())
        self._epoch = -1
        self._cache: dict = {}

    def use_gather(self, total_rows: int) -> bool:
        """Reference policy engine.rs:95-102: gather the subset when it is
        small absolutely and relatively."""
        return 0 < self.count <= GATHER_MAX_ROWS and self.count * 4 <= max(total_rows, 1)

    def _staged(self, key: tuple, epoch: int, make: Callable[[], np.ndarray],
                device: torch.device) -> torch.Tensor:
        if self._epoch != epoch:
            self._cache, self._epoch = {}, epoch
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(make()).to(device)
        return self._cache[key]

    def device_mask(self, lo: int, rows: int, epoch: int, device: torch.device) -> torch.Tensor:
        """(rows,) bool: the mask of the corpus rows [lo, lo + rows), False
        past its end."""
        def make():
            part = np.zeros(rows, dtype=bool)
            seg = self.mask[lo : lo + rows]
            part[: len(seg)] = seg
            return part
        return self._staged(("mask", lo, rows, device), epoch, make, device)

    def device_indices(self, lo: int, hi: int, epoch: int, device: torch.device) -> torch.Tensor:
        """(1, S) int32: the passing rows in [lo, hi), ascending, less ``lo``
        (the gather route's row list of a view, in the view's row ids)."""
        return self._staged(("idx", lo, hi, device), epoch,
                            lambda: (np.nonzero(self.mask[lo:hi])[0].astype(np.int32))[None],
                            device)


def _handle(filter_mask) -> Optional[FilterHandle]:
    if filter_mask is None or isinstance(filter_mask, FilterHandle):
        return filter_mask
    return FilterHandle(filter_mask)


def _empty(b: int) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    out = (np.zeros((b, 0), dtype=np.float32), np.zeros((b, 0), dtype=np.int64))
    return lambda: out


class _View:
    """Rows [lo, lo + rows) of a corpus's capacity on ``device``, ``n`` of
    them real rows: what each resident plan runs on. A one-device corpus is
    one view of all its rows (``whole``), whose arrays are the corpus's own.
    A mesh corpus has a view a shard, which holds its slice of the centred
    bf16 copy (``x16``) and of its aux rows (``aux``, with the corpus-wide
    mean), and stages on first use its f32 rows (``x32``), its valid mask
    (``valid``, per epoch) and the transform of the metric searched last
    (``transform``). ``DeviceCorpus.view_*`` hand out a view's arrays."""

    __slots__ = ("device", "lo", "rows", "n", "whole", "x16", "aux", "x32", "valid",
                 "valid_epoch", "transform")

    def __init__(self, device: torch.device, lo: int, rows: int, n: int, whole: bool = False):
        self.device, self.lo, self.rows, self.n, self.whole = device, lo, rows, n, whole
        self.x16 = self.aux = self.x32 = self.valid = self.transform = None
        self.valid_epoch = -1

    def tensors(self) -> list:
        extra = [] if self.transform is None else list(self.transform[1].values())
        return [self.x16, self.x32, self.valid, *(self.aux or {}).values(), *extra]

    def to_global(self, ids: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The view's row ids as the corpus's, int64, -1 where ``live`` is
        False (None: where ``ids`` holds -1 already, as K3 leaves them)."""
        if live is None:
            if self.lo == 0:
                return ids
            live = ids >= 0
        ids = ids.long()
        return torch.where(live, ids + self.lo if self.lo else ids, -1)


class DeviceCorpus:
    """The corpus of one vector field (the role of the reference's
    FlatMmap, src/storage/flat_mmap.rs:89): the exact f32 host mirror, and on
    ``device`` what its tier holds — the centred bf16 copy, its aux arrays,
    the f32 copy and the validity mask (resident), the bf16 copy, aux and
    mask (host-rescore), or nothing corpus-sized (streaming: a bf16 host
    mirror pumped through the card). ``device`` is explicit: "cuda" needs a
    card and runs the kernels; "cpu" runs their plain versions.

    ``mesh`` (parallel/mesh.py; the process-wide default mesh if None): the
    rows shard over the mesh's corpus devices, which must be of ``device``'s
    type, and ``device`` becomes the mesh's home device. A mesh corpus is
    resident only: its capacity is a multiple of ``ROW_ALIGN`` times the
    shard count, shard ``s`` holds rows [s n_local, (s + 1) n_local) of it
    on its device (a :class:`_View`), centred with the corpus-wide mean, and
    every resident plan runs on each shard and ends in K21a's merge
    (``topk.merge_shards``). Whole arrays (``_data``, ``data16``,
    ``bf16_aux``, ``valid_mask``, ``transform``) are staged on the home
    device on request, for the indexes that read them, within the same
    budget."""

    APPROX_MIN_ROWS = 65_536  # approx engage threshold (approx_search.rs:49)

    def __init__(self, dim: int, dtype: str = "float32", *, device, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else get_default_mesh()
        if self.mesh is not None:
            kinds = {dev.type for dev in self.mesh.corpus_devices}
            if kinds != {self.device.type}:
                raise ValueError(f"a corpus on {self.device} cannot shard over a mesh of "
                                 f"{sorted(kinds)} devices")
            self.device = self.mesh.home
        self._shards: Optional[list] = None  # a mesh corpus's staged shard views
        self.dim = int(dim)
        self.dtype = dtype
        self.n = 0
        self.capacity = 0
        self.epoch = 0
        self.tier = RESIDENT
        self._host = np.zeros((0, self.dim), dtype=np.float32)  # exact mirror
        self._host16: Optional[np.ndarray] = None  # streaming: (cap, dim) bf16 bits, int16
        self._dev16: Optional[torch.Tensor] = None  # (cap, dim) centred bf16
        self._dev32: Optional[torch.Tensor] = None  # lazy (cap, dim) f32
        self._tombs_np = np.zeros(0, dtype=bool)
        # centring state: the bf16 copy stores x - mean so its rounding is
        # spent on the discriminative component; rankings are restored by the
        # per-row xm = mean.(x - mean) correction
        self._mean_np: Optional[np.ndarray] = None  # (D,) f32
        self._sq_host: Optional[np.ndarray] = None  # (cap,) centred-row norms
        self._xm_host: Optional[np.ndarray] = None  # (cap,)
        self._xsqtrue_host: Optional[np.ndarray] = None  # (cap,) true row norms
        self._aux: Optional[dict] = None  # device copies of mean and the aux rows
        self._valid_base: Optional[torch.Tensor] = None
        # (metric, corpus transform) of the metric searched last: one at a time
        self._transform: Optional[tuple[Metric, dict]] = None
        self._dirty = True
        self._dirty_lo = 0
        # rows scored by the most recent search (QueryProfile.scanned_vectors)
        self.last_scanned = 0
        # a list to append each streamed block's timing events to (None: off)
        self.stream_trace: Optional[list] = None

    # ── the device budget and the tiers ──────────────────────────────────

    def _cap_for(self, n: int) -> int:
        shards = 1 if self.mesh is None else self.mesh.shape["corpus"]
        return _round_up(max(n, 1), ROW_ALIGN * shards)

    def _scratch_bytes(self, cap: int) -> int:
        """One search's scratch: the (B, cap) score matrix at the largest
        batch, and K5's two buffers, which hold at most cap (key, index)
        pairs a row for any k."""
        b_max = max(1, SCORE_BUDGET // cap)
        return b_max * cap * 4 + 2 * b_max * cap * 8

    def device_bytes(self, cap: int, metric: Optional[Metric] = None) -> int:
        """Device memory the resident tier needs at its largest: the bf16
        and f32 copies, the aux rows and masks, the corpus transform of
        ``metric`` (none if None), and one search's scratch."""
        copies = cap * self.dim * (2 + 4) + cap * (4 * 3 + 2)
        if metric is not None:
            copies += cap * D.transform_row_bytes(metric, self.dim)
        return copies + self._scratch_bytes(cap)

    def host_rescore_bytes(self, cap: int) -> int:
        """Device memory the host-rescore tier needs: the bf16 copy, its aux
        rows, the masks and one search's scratch."""
        return cap * self.dim * 2 + cap * (4 * 3 + 2) + self._scratch_bytes(cap)

    def _whole_bytes(self) -> int:
        """Device bytes of the whole copies, aux rows and mask staged now."""
        held = [self._dev16, self._dev32, self._valid_base, *(self._aux or {}).values()]
        return sum(t.numel() * t.element_size() for t in held if t is not None)

    def _shard_bytes(self, dev: torch.device) -> int:
        """Device bytes a mesh corpus's shards hold on ``dev`` now."""
        return sum(t.numel() * t.element_size() for sh in self._shards or ()
                   for t in sh.tensors() if t is not None and t.device == dev)

    def _held_bytes(self) -> int:
        """Device bytes of the copies, aux rows and mask staged now (a mesh
        corpus: on the home device, its shards' included)."""
        return self._whole_bytes() + self._shard_bytes(self.device)

    def _transform_bytes(self) -> int:
        if self._transform is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._transform[1].values()
                   if isinstance(t, torch.Tensor) and t is not self._dev32)

    def _free_bytes(self) -> int:
        free, _ = torch.cuda.mem_get_info(self.device)
        return free + torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(
            self.device)

    def budget(self) -> int:
        """The device bytes this corpus may hold: DEVICE_BYTES where set,
        else the card's free memory plus what the corpus holds (no limit for
        a CPU corpus)."""
        if DEVICE_BYTES > 0:
            return DEVICE_BYTES
        if self.device.type != "cuda":
            return sys.maxsize
        return self._free_bytes() + self._held_bytes() + self._transform_bytes()

    def _tier_for(self, cap: int) -> str:
        """The tier of the copies alone: a metric's transform is staged
        beside the resident copies where it fits, and a search whose
        transform does not fit pumps its exact rows instead (``_submit``),
        so no metric moves the corpus off its tier. A mesh corpus is
        resident or raises."""
        if self.mesh is not None:
            self._check_mesh_fits(cap)
            return RESIDENT
        budget = self.budget()
        if self.device_bytes(cap) <= budget:
            return RESIDENT
        if self.host_rescore_bytes(cap) <= budget:
            return HOST_RESCORE
        return STREAMING

    def _check_fits(self) -> None:
        """Raise where not even a streaming pass fits the budget: two
        ROW_ALIGN-row blocks of the f32 pump (the widest) and a 64-query
        chunk's keys with K5's buffers."""
        need = 2 * ROW_ALIGN * (self.dim * 4 + 1) + 64 * ROW_ALIGN * (4 + 16)
        budget = self.budget()
        if need > budget:
            raise RuntimeError(
                f"a corpus of {self.n} x {self.dim} rows cannot be searched on {self.device}: "
                f"even one streamed block of {ROW_ALIGN} rows and its scratch need {need} bytes, "
                f"but the device budget is {budget} (LYNSE_DEVICE_BYTES)")

    def _check_mesh_fits(self, cap: int, metric: Optional[Metric] = None, whole: int = 0) -> None:
        """Raise unless each device of the mesh holds the copies of every
        shard it carries (and their ``metric`` transform) and one search's
        scratch, and the home device also ``whole`` bytes of whole arrays
        (:meth:`_stage_whole`): a mesh corpus never moves to another tier or
        to the CPU."""
        devs = self.mesh.corpus_devices
        n_local = cap // len(devs)
        per = n_local * self.dim * (2 + 4) + n_local * (4 * 3 + 2)
        if metric is not None:
            per += n_local * D.transform_row_bytes(metric, self.dim)
        for dev in dict.fromkeys(devs + (self.device,)):
            count = devs.count(dev)
            at_home = whole if dev == self.device else 0
            need = count * per + self._scratch_bytes(n_local) + at_home
            if DEVICE_BYTES > 0:
                budget = DEVICE_BYTES
            elif dev.type != "cuda":
                continue
            else:
                free, _ = torch.cuda.mem_get_info(dev)
                held = self._shard_bytes(dev) + (
                    self._whole_bytes() + self._transform_bytes() if dev == self.device else 0)
                budget = (free + torch.cuda.memory_reserved(dev)
                          - torch.cuda.memory_allocated(dev) + held)
            if need > budget:
                raise RuntimeError(
                    f"a mesh corpus of {self.n} x {self.dim} rows needs {need} bytes on {dev} "
                    f"for its {count} shard(s) of {n_local} rows, {at_home} bytes of whole "
                    f"arrays and one search's scratch, but the device budget is {budget} "
                    f"(LYNSE_DEVICE_BYTES); a mesh corpus is resident only")

    def _stage_whole(self, nbytes: int) -> None:
        """Before a mesh corpus stages a whole array of ``nbytes`` on its home
        device (the indexes read whole arrays): raise unless it fits there
        beside the shards and the whole arrays staged already."""
        if self.mesh is not None:
            self._check_mesh_fits(self.capacity, whole=self._whole_bytes()
                                  + self._transform_bytes() + nbytes)

    def would_stream(self) -> bool:
        """Whether (re)staging at the current row count streams: the tier
        staged if nothing is pending, else the tier staging would choose,
        without staging anything (write paths ask before the first search
        after a commit). A mesh corpus never streams."""
        if self.n == 0 or self.mesh is not None:
            return False
        if not self._dirty:
            return self.tier == STREAMING
        return self._tier_for(self._cap_for(self.n)) == STREAMING

    @property
    def streaming(self) -> bool:
        """True when the staged tier is the streaming one."""
        return self.tier == STREAMING

    def restage(self) -> None:
        """Drop every staged array and stage again under the current budget
        (the tier may change)."""
        self._dirty, self._dirty_lo = True, 0
        self._transform = None
        self._ensure_staged()

    def _fits(self, metric: Metric) -> bool:
        """Whether ``metric``'s transform fits beside the resident copies."""
        if self._transform is not None and self._transform[0] is metric:
            return True
        return self.device_bytes(self.capacity, metric) <= self.budget()

    # ── staging ──────────────────────────────────────────────────────────

    def _ensure_staged(self) -> None:
        """Stage (or refresh) the tier's arrays from the host mirror.

        Writes touch only the host mirror; the device arrays (or the
        streaming bf16 mirror) are rebuilt here on demand. A small
        contiguous tail at unchanged capacity and tier updates in place;
        anything else restages fully, dropping the old arrays first."""
        if not self._dirty or self.n == 0:
            return
        cap = self._cap_for(self.n)
        tier = self._tier_for(cap)
        incremental = (
            tier == self.tier
            and cap == self.capacity
            and self.mesh is None
            and self._mean_np is not None
            and (self._dev16 is not None or self._host16 is not None)
            and (self.n - self._dirty_lo) * 2 <= self.n
        )
        if incremental:
            lo = self._dirty_lo
            tail16, sq, xm, xsqt = self._convert_block(lo, self.n)
            self._sq_host[lo : self.n] = sq
            self._xm_host[lo : self.n] = xm
            self._xsqtrue_host[lo : self.n] = xsqt
            self._aux = None  # host aux changed; restage lazily
            if tier == STREAMING:
                self._host16[lo : self.n] = tail16.view(torch.int16).numpy()
            else:
                self._dev16[lo : self.n] = tail16.to(self.device)
                if self._dev32 is not None:
                    self._dev32[lo : self.n] = torch.from_numpy(
                        np.ascontiguousarray(self._host[lo : self.n])).to(self.device)
        else:
            self._dev16 = self._dev32 = self._host16 = None  # free before reallocating
            self._aux = self._valid_base = self._shards = None
            self._transform = None
            self.tier = tier
            if tier == STREAMING:
                self._check_fits()
            self._compute_mean()
            full16 = _alloc_rows(cap, self.dim, np.int16)  # bf16 bits
            self._sq_host = np.zeros(cap, dtype=np.float32)
            self._xm_host = np.zeros(cap, dtype=np.float32)
            self._xsqtrue_host = np.zeros(cap, dtype=np.float32)
            for lo in range(0, self.n, STAGE_ROWS):
                hi = min(lo + STAGE_ROWS, self.n)
                block16, sq, xm, xsqt = self._convert_block(lo, hi)
                full16[lo:hi] = block16.view(torch.int16).numpy()
                self._sq_host[lo:hi] = sq
                self._xm_host[lo:hi] = xm
                self._xsqtrue_host[lo:hi] = xsqt
            if tier == STREAMING:
                self._host16 = full16
            elif self.mesh is not None:
                self._stage_shards(full16, cap)
            else:
                self._dev16 = torch.from_numpy(full16).view(torch.bfloat16).to(self.device)
            self.capacity = cap
        self._valid_base = None
        self._dirty = False
        self._dirty_lo = self.n

    def _stage_shards(self, full16: np.ndarray, cap: int) -> None:
        """A mesh corpus's staging: each shard's slice of the centred bf16
        copy and of its aux rows, on the shard's device."""
        devs = self.mesh.corpus_devices
        n_local = cap // len(devs)
        shards = []
        for s, dev in enumerate(devs):
            lo = s * n_local
            sh = _View(dev, lo, n_local, max(0, min(self.n - lo, n_local)))
            sh.x16 = torch.from_numpy(full16[lo : lo + n_local]).view(torch.bfloat16).to(dev)
            sh.aux = {"mean": torch.from_numpy(self._mean_np).to(dev),
                      **{name: torch.from_numpy(arr[lo : lo + n_local]).to(dev)
                         for name, arr in self._aux_host()}}
            shards.append(sh)
        self._shards = shards

    def _compute_mean(self) -> None:
        """Column mean over the live rows, accumulated in float64."""
        acc = np.zeros(self.dim, dtype=np.float64)
        for lo in range(0, self.n, STAGE_ROWS):
            hi = min(lo + STAGE_ROWS, self.n)
            acc += self._host[lo:hi].sum(axis=0, dtype=np.float64)
        self._mean_np = (acc / max(self.n, 1)).astype(np.float32)

    def _convert_block(self, lo: int, hi: int):
        """Centre + round rows [lo, hi) to bf16 (nearest even). Returns (bf16
        block, centred-row norms, xm = mean.(x - mean), true row norms), the
        aux taken from the rounded rows."""
        m = self._mean_np
        block16 = torch.from_numpy(self._host[lo:hi] - m[None, :]).to(torch.bfloat16)
        xc32 = block16.to(torch.float32).numpy()
        sq = (xc32**2).sum(axis=1)
        xm = xc32 @ m
        xsqt = (np.asarray(self._host[lo:hi], dtype=np.float32) ** 2).sum(axis=1)
        return block16, sq, xm, xsqt

    # ── data management ──────────────────────────────────────────────────

    def _invalidate(self) -> None:
        self.epoch += 1
        self._valid_base = None
        self._transform = None

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (*, {self.dim}) rows, got {rows.shape}")
        m = rows.shape[0]
        if m == 0:
            return
        if self.n + m > len(self._host):
            # double the mirror, or fit it exactly to one append past that
            new_len = max(8192, 2 * len(self._host), self.n + m)
            host = _alloc_rows(new_len, self.dim, np.float32)
            for lo in range(0, self.n, STAGE_ROWS):
                hi = min(lo + STAGE_ROWS, self.n)
                host[lo:hi] = self._host[lo:hi]
            self._host = host
        self._host[self.n : self.n + m] = rows
        self._dirty_lo = min(self._dirty_lo, self.n)
        self._dirty = True
        self.n += m
        self._invalidate()

    def _overwrite_aux(self, ids: np.ndarray, rows: np.ndarray) -> torch.Tensor:
        """Centred bf16 rows + refreshed host aux for overwritten rows."""
        m = self._mean_np
        xc16 = torch.from_numpy(rows - m[None, :]).to(torch.bfloat16)
        xc32 = xc16.to(torch.float32).numpy()
        self._sq_host[ids] = (xc32**2).sum(axis=1)
        self._xm_host[ids] = xc32 @ m
        self._xsqtrue_host[ids] = (rows**2).sum(axis=1)
        self._aux = None
        return xc16

    def overwrite(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        """Positional overwrite (upsert path). Overwritten rows centre with
        the existing mean (any fixed mean preserves rankings); a streaming
        corpus rewrites its bf16 mirror in place."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        ids = np.asarray(row_ids, dtype=np.int64)
        self._host[ids] = rows
        if self._dirty or self._mean_np is None or self.mesh is not None:
            self._dirty_lo = 0  # scattered rows (or a mesh corpus): full restage
            self._dirty = True
        elif self._host16 is not None:
            self._host16[ids] = self._overwrite_aux(ids, rows).view(torch.int16).numpy()
        elif self._dev16 is not None:
            xc16 = self._overwrite_aux(ids, rows)
            idx = torch.from_numpy(ids).to(self.device)
            self._dev16[idx] = xc16.to(self.device)
            if self._dev32 is not None:
                self._dev32[idx] = torch.from_numpy(rows).to(self.device)
        else:
            self._dirty_lo = 0
            self._dirty = True
        self._invalidate()

    def set_tombstones(self, tombs: np.ndarray) -> None:
        """Replace the tombstone mask from the host bitset (first n rows)."""
        self._tombs_np = np.asarray(tombs, dtype=bool)
        self._valid_base = None
        self.epoch += 1

    def finalize(self) -> None:
        """Stage pending changes and trim growth slack (called at commit
        boundaries) so the first post-commit search pays no staging."""
        if self.n and self.capacity != self._cap_for(self.n):
            self._dirty = True  # capacity change forces a full restage
        self._ensure_staged()

    def reset(self) -> None:
        self.n = 0
        self.capacity = 0
        self.tier = RESIDENT
        self._host = np.zeros((0, self.dim), dtype=np.float32)
        self._host16 = None
        self._dev16 = None
        self._dev32 = None
        self._tombs_np = np.zeros(0, dtype=bool)
        self._sq_host = None
        self._mean_np = None
        self._xm_host = None
        self._xsqtrue_host = None
        self._aux = None
        self._shards = None
        self._dirty = True
        self._dirty_lo = 0
        self._invalidate()

    # ── derived state ────────────────────────────────────────────────────

    @property
    def _data(self) -> torch.Tensor:
        """The f32 device copy (cap, D), staged on first use: the exact scan
        reads it and the rescore gathers from it. A streaming corpus has
        none."""
        self._ensure_staged()
        if self.tier == STREAMING:
            raise ValueError(
                "the corpus's bf16 copy exceeds the device budget (LYNSE_DEVICE_BYTES); the "
                "f32 device copy is unavailable in streaming mode, where searches use the "
                "blockwise streaming scan")
        if self._dev32 is None:
            if self.capacity == 0:
                raise ValueError("empty corpus")
            self._stage_whole(self.capacity * self.dim * 4)
            full = torch.zeros((self.capacity, self.dim), dtype=torch.float32, device=self.device)
            for lo in range(0, self.n, STAGE_ROWS):
                hi = min(lo + STAGE_ROWS, self.n)
                full[lo:hi] = torch.from_numpy(np.ascontiguousarray(self._host[lo:hi])).to(
                    self.device)
            self._dev32 = full
        return self._dev32

    def host_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Exact f32 rows from the host mirror (no device traffic)."""
        return self._host[np.asarray(row_ids, dtype=np.int64)]

    @property
    def data16(self) -> torch.Tensor:
        """The staged mean-centred bf16 copy (cap, D): the graph beams score
        their guidance from it with the bf16_aux corrections."""
        self._ensure_staged()
        if self._dev16 is None and self._shards:  # a mesh corpus: gathered on first use
            self._stage_whole(self.capacity * self.dim * 2)
            self._dev16 = torch.cat([sh.x16.to(self.device) for sh in self._shards])
        if self._dev16 is None:
            raise ValueError("bf16 device array unavailable (streaming or empty corpus)")
        return self._dev16

    def host_sq_norms(self) -> np.ndarray:
        """True squared row norms (n,) from the staging aux (the graph
        indexes pin the top-norm band into their IP entry samples)."""
        self._ensure_staged()
        return self._xsqtrue_host[: self.n]

    def bf16_aux(self) -> dict:
        """Device aux arrays of the centred bf16 copy: mean (D,), xm (cap,),
        xc_sq (cap,), xsq_true (cap,) — see bf16_centered_topc."""
        self._ensure_staged()
        if self._aux is None:
            self._stage_whole(self.capacity * 4 * 3 + self.dim * 4)
            self._aux = {
                name: torch.from_numpy(arr).to(self.device)
                for name, arr in (("mean", self._mean_np), ("xm", self._xm_host),
                                  ("xc_sq", self._sq_host), ("xsq_true", self._xsqtrue_host))
            }
        return self._aux

    def transform(self, metric: Metric) -> dict:
        """The corpus transform of ``metric`` over the f32 copy. One metric's
        is staged at a time: another metric's replaces it. A transform that
        does not fit the budget beside the resident copies raises (the scan
        pumps that metric's rows from the host mirror instead)."""
        if self._transform is None or self._transform[0] is not metric:
            self._ensure_staged()
            if self.tier == STREAMING:
                return self._data  # raises: no f32 device copy to transform
            self._transform = None  # free before staging another
            if self.mesh is not None:
                self._stage_whole(self.capacity * D.transform_row_bytes(metric, self.dim))
            elif self.tier != RESIDENT or not self._fits(metric):
                raise RuntimeError(
                    f"the {metric.value} transform of {self.n} x {self.dim} rows does not fit "
                    f"the device budget beside the corpus copies; the corpus is in the "
                    f"{self.tier} tier, whose scan pumps this metric's rows from the host mirror")
            self._transform = (metric, D.corpus_transform(self._data, metric))
        return self._transform[1]

    def _host_valid(self, handle: Optional[FilterHandle]) -> np.ndarray:
        """(n,) bool on the host: not tombstoned and passing the filter."""
        valid = np.ones(self.n, dtype=bool)
        m = min(len(self._tombs_np), self.n)
        valid[:m] &= ~self._tombs_np[:m]
        if handle is not None:
            m = min(len(handle.mask), self.n)
            valid[:m] &= handle.mask[:m]
            valid[m:] = False
        return valid

    def valid_mask(self, filter_mask=None) -> torch.Tensor:
        """(cap,) bool: rows in range, not tombstoned, and passing the filter."""
        self._ensure_staged()
        if self._valid_base is None:
            self._stage_whole(self.capacity)
            host_valid = np.zeros(self.capacity, dtype=bool)
            host_valid[: self.n] = self._host_valid(None)
            self._valid_base = torch.from_numpy(host_valid).to(self.device)
        handle = _handle(filter_mask)
        if handle is None:
            return self._valid_base
        return self._valid_base & handle.device_mask(0, self.capacity, self.epoch, self.device)

    # ── the streaming pump ───────────────────────────────────────────────

    def _stream_block_rows(self, qc: int, row_bytes: int) -> int:
        """Rows of one streamed block: within STREAM_BLOCK_BYTES, both
        buffers within STREAM_INFLIGHT_BYTES and a quarter of the budget
        each, a query chunk's keys within half the budget and within
        SCORE_BUDGET; a multiple of ROW_ALIGN. The budget here is what the
        staged copies leave of it."""
        budget = self.budget() - self._held_bytes() - self._transform_bytes()
        rows = min(STREAM_BLOCK_BYTES // row_bytes, STREAM_INFLIGHT_BYTES // (2 * row_bytes),
                   (budget // 4) // row_bytes, (budget // 2) // (20 * qc), SCORE_BUDGET // qc)
        return max(ROW_ALIGN, rows // ROW_ALIGN * ROW_ALIGN)

    def _blocks(self, kind: str, rows: int, valid: np.ndarray):
        """Yield the StreamBlocks of rows [0, n), ``rows`` at a time, on the
        corpus's device: "bf16" blocks of the centred copy with their aux,
        or "f32" blocks of the exact mirror, each with its slice of the
        host mask ``valid``. A CPU corpus yields views of the mirrors; a
        CUDA corpus pumps them (:meth:`_pump`)."""
        mean = None if kind == "f32" else torch.from_numpy(self._mean_np).to(self.device)
        if self.device.type == "cuda":
            yield from self._pump(kind, rows, valid, mean)
            return
        for lo in range(0, self.n, rows):
            hi = min(lo + rows, self.n)
            if kind == "bf16":
                x = torch.from_numpy(self._host16[lo:hi]).view(torch.bfloat16)
                aux = {name: torch.from_numpy(arr[lo:hi]) for name, arr in self._aux_host()}
            else:
                x, aux = torch.from_numpy(np.ascontiguousarray(self._host[lo:hi])), None
            yield StreamBlock(kind, x, aux, torch.from_numpy(valid[lo:hi]), lo, mean)

    def _aux_host(self):
        return (("xm", self._xm_host), ("xc_sq", self._sq_host), ("xsq_true", self._xsqtrue_host))

    def _pump(self, kind: str, rows: int, valid: np.ndarray, mean):
        """The CUDA pump: two pinned staging buffers, each filled from the
        (possibly memmapped) mirrors by FILL_THREADS host threads, and two
        device buffers. Block i+1's H2D runs on a second stream while block
        i is scanned on the current one; events order both ways: a device
        buffer is overwritten only after the scan that read it
        (``scanned``), a pinned buffer is refilled only after the copy out
        of it (``copied``). So at most two blocks are in flight, as
        STREAM_INFLIGHT_BYTES bounds them, and nothing waits on a fetch."""
        dev, d = self.device, self.dim
        es = 2 if kind == "bf16" else 4
        x_bytes = _round_up(rows * d * es, 256)
        aux_stride = _round_up(rows * 4, 256)
        v_off = x_bytes + (3 * aux_stride if kind == "bf16" else 0)
        size = v_off + _round_up(rows, 256)
        pinned = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        bufs = [torch.empty(size, dtype=torch.uint8, device=dev) for _ in range(2)]
        copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        copied = [torch.cuda.Event() for _ in range(2)]
        scanned = [torch.cuda.Event() for _ in range(2)]
        used = [False, False]
        trace = self.stream_trace
        src_x = self._host16 if kind == "bf16" else self._host
        for i, lo in enumerate(range(0, self.n, rows)):
            s, hi = i % 2, min(lo + rows, self.n)
            r = hi - lo
            if used[s]:
                copied[s].synchronize()
            t0 = time.perf_counter()
            host = pinned[s].numpy()
            _copy_rows(host[: r * d * es].view(src_x.dtype).reshape(r, d), src_x[lo:hi])
            if kind == "bf16":
                for j, (_, arr) in enumerate(self._aux_host()):
                    off = x_bytes + j * aux_stride
                    host[off : off + r * 4].view(np.float32)[:] = arr[lo:hi]
            host[v_off : v_off + r] = valid[lo:hi].view(np.uint8)
            fill_s = time.perf_counter() - t0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if trace is not None \
                else None
            with torch.cuda.stream(copy_stream):
                if used[s]:
                    copy_stream.wait_event(scanned[s])
                if ev:
                    ev[0].record(copy_stream)
                bufs[s].copy_(pinned[s], non_blocking=True)
                if ev:
                    ev[1].record(copy_stream)
                copied[s].record(copy_stream)
            compute.wait_event(copied[s])
            used[s] = True
            buf = bufs[s]
            x = buf[: r * d * es].view(torch.bfloat16 if kind == "bf16" else torch.float32)
            aux = None
            if kind == "bf16":
                aux = {name: buf[x_bytes + j * aux_stride : x_bytes + j * aux_stride + r * 4]
                       .view(torch.float32) for j, (name, _) in enumerate(self._aux_host())}
            if ev:
                ev[2].record(compute)
            yield StreamBlock(kind, x.view(r, d), aux, buf[v_off : v_off + r].view(torch.bool),
                              lo, mean)
            if ev:
                ev[3].record(compute)
                trace.append({"rows": r, "bytes": size, "fill_s": fill_s, "events": ev})
            scanned[s].record(compute)

    def _stream_pass(self, qd: torch.Tensor, metric: Metric, kind: str, c: int,
                     handle: Optional[FilterHandle], step: Callable = stream_block):
        """One pass over every block (K8 for each query chunk of 16 or 64
        queries, all chunks sharing the block): (keys (B, C), ids (B, C)),
        the best C of every valid row, -inf / -1 in empty slots. ``step``:
        K8 or its plain version."""
        b = qd.shape[0]
        qc = 16 if b <= 16 else 64
        chunks = [qd[s : s + qc] for s in range(0, b, qc)]
        qts = [D.query_transform(ch, metric) if kind == "f32" else None for ch in chunks]
        row_bytes = self.dim * (2 if kind == "bf16" else 4) + (12 if kind == "bf16" else 0) + 1
        rows = self._stream_block_rows(qc, row_bytes)
        state = [(torch.full((len(ch), c), float("-inf"), device=self.device),
                  torch.full((len(ch), c), -1, dtype=torch.int32, device=self.device))
                 for ch in chunks]
        for blk in self._blocks(kind, rows, self._host_valid(handle)):
            for i, ch in enumerate(chunks):
                state[i] = step(ch, qts[i], blk, *state[i], metric, c)
        return torch.cat([s[0] for s in state]), torch.cat([s[1] for s in state])

    # ── search entry points ──────────────────────────────────────────────

    def _shortlist_size(self, k: int, limit: int, oversample: int = 4) -> int:
        c = max(64, oversample * k) if k <= 64 else (
            2 * k if k <= 512 else int(1.25 * k))
        c = max(c, k)
        # scale the cushion with corpus size: when scores concentrate (e.g.
        # uniform data) the proxy ranking is noisy within a band of near-ties,
        # and a fixed-64 shortlist drops true top-k rows at 1M scale; ~0.025%
        # of the corpus keeps the rescore negligible
        c = max(c, min(1024, limit // 4096))
        return min(_round_up(c, 64), max(limit, 1))

    def search_submit(
        self,
        queries: np.ndarray,
        k: int,
        metric: Metric,
        filter_mask=None,
        mode: str = "auto",
        oversample: int = 4,
    ) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
        """Launch a search; returns a zero-arg resolver that waits for the
        device and returns (dists (B, k'), row ids (B, k')) trimmed of empty
        slots (ids -1 pad rows that found fewer). Distances are exact f32.
        ``mode``: "auto" picks the plan by metric, size, filter and tier;
        "exact" forces the one-pass scan; "approx" is search_approx's plan."""
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        b = q.shape[0]
        if self.n == 0:
            return _empty(b)
        handle = _handle(filter_mask)
        if handle is not None and handle.count == 0:
            return _empty(b)
        self._ensure_staged()
        # keep the (B, cap) score matrix within SCORE_BUDGET by splitting
        # oversized batches; every part is launched before any is resolved
        # (a streaming pass chunks its queries itself)
        max_b = max(1, SCORE_BUDGET // self.capacity)
        if b > max_b and self.tier != STREAMING:
            resolvers = [
                self._submit(q[s : s + max_b], k, metric, handle, mode, oversample)
                for s in range(0, b, max_b)
            ]
            return lambda: _concat_parts([r() for r in resolvers])
        return self._submit(q, k, metric, handle, mode, oversample)

    def _submit(self, q: np.ndarray, k: int, metric: Metric, handle, mode: str, oversample: int):
        """Route one search to its plan by tier (the module docstring)."""
        qd = torch.from_numpy(q).to(self.device)
        exact = mode == "exact" or metric not in _BF16_PASS or self.n < TWO_PASS_MIN_ROWS
        if self.tier == RESIDENT:  # a mesh corpus's only tier
            return self._resident_submit(q, qd, k, metric, handle, mode, oversample, exact)
        if self.tier == STREAMING or exact:
            return self._stream_submit(q, qd, k, metric, handle, oversample, exact)
        if metric in TWO_PASS_METRICS:
            self.last_scanned = 0
            first = self._first_pass(self._whole(), qd, k, metric, handle, oversample)
            if first is None:
                return _empty(q.shape[0])
            return lambda: self._rescore_fetched(q, *first, metric, k)
        return self._bf16_elem_submit(q, qd, k, metric, handle, oversample, mode == "approx")

    def _resident_submit(self, q: np.ndarray, qd: torch.Tensor, k: int, metric: Metric, handle,
                         mode: str, oversample: int, exact: bool):
        """The resident tier's plans, each written once over a view of the
        corpus (:meth:`views`: the whole corpus, or each shard of a mesh
        corpus) and ending in the view's top k with global ids: the
        approximate plan of the L1 family, the two-pass plan (or its gather
        route) of IP/L2/cosine, and the exact plan. A mesh corpus's parts
        are merged by K21a's merge on the home device; there each shard's K3
        rescores its own shortlist, a superset of the merged shortlist's
        rescore, never worse. ``last_scanned`` counts the rows scored on
        every view."""
        if mode == "approx" and metric not in TWO_PASS_METRICS:
            plan = functools.partial(self._approx_part,
                                     c=min(max(k * oversample, k), self.capacity))
        elif not exact and metric in TWO_PASS_METRICS:
            plan = functools.partial(self._two_pass_part, oversample=oversample)
        elif self.mesh is None and not self._fits(metric):
            # its transform does not fit beside the copies: pump its exact rows
            return self._stream_submit(q, qd, k, metric, handle, oversample, True)
        else:
            plan = self._exact_part
        self.last_scanned = 0
        parts = [part for part in (plan(v, qd.to(v.device), k, metric, handle)
                                   for v in self.views()) if part is not None]
        if not parts:
            return _empty(q.shape[0])
        if len(parts) == 1:
            dists, ids = parts[0]
        else:
            dists, ids = merge_shards(parts, k, metric.ascending, self.device)
        return lambda: _trim_results(*_fetch(dists, ids))

    def _exact_part(self, v: _View, qs: torch.Tensor, k: int, metric: Metric, handle):
        """The exact plan on a view: the metric's distance kernel (K1, K6a,
        K6b or K6c) scores every row, K5 takes the top k. Rows at +inf
        distance (and NaN) get a -inf key and never reach a result."""
        self.last_scanned += v.n  # masked scans still touch every row
        keys = metric_keys(D.query_transform(qs, metric), self.view_transform(v, metric),
                           self.view_valid(v, handle), metric)
        top, idx = topk_select(keys, min(k, v.rows))
        return unorient(top, metric.ascending), v.to_global(idx, top > float("-inf"))

    def _first_pass(self, v: _View, qs: torch.Tensor, k: int, metric: Metric, handle,
                    oversample: int):
        """The two-pass plan's first pass over a view's centred bf16 rows:
        K2's fused pass (its span lists merged by K5), or the gather route
        of a selective filter, chosen on the corpus's counts (K4: K11 -> K5
        over the filter's rows in the view). Returns (keys (B, C), the
        view's row ids (B, C), -1 in empty slots), or None where the view
        holds none of the filter's rows."""
        if handle is not None and handle.use_gather(self.n):
            idx, slot = self.gather_inputs(handle, v)
            if idx.shape[1] == 0:
                return None
            c = min(self._shortlist_size(k, handle.count, oversample), idx.shape[1])
            self.last_scanned += idx.shape[1] + c  # the subset + exact rescore rows
            keys = bf16_gather_scores(qs, self.view_x16(v), self.view_aux(v), idx, slot, metric,
                                      shared=True)
            top, local = topk_select(keys, c)
            return top, torch.where(top > float("-inf"), idx[0][local.long()], -1)
        c = min(self._shortlist_size(k, self.n, oversample), v.rows)
        self.last_scanned += v.n + c  # full first pass + exact rescore rows
        return bf16_centered_topc(qs, self.view_x16(v), self.view_aux(v),
                                  self.view_valid(v, handle), metric, c)

    def _two_pass_part(self, v: _View, qs: torch.Tensor, k: int, metric: Metric, handle, *,
                       oversample: int):
        """The two-pass plan on a view: its first pass, then K3 rescores the
        shortlist exactly in f32 from the view's rows and sorts on (score,
        id)."""
        first = self._first_pass(v, qs, k, metric, handle, oversample)
        if first is None:
            return None
        top, cand = first
        dists, ids = rescore_topk(qs, self.view_x32(v), top, cand, min(k, top.shape[1]), metric)
        return dists, v.to_global(ids)

    def _approx_part(self, v: _View, qs: torch.Tensor, k: int, metric: Metric, handle, *,
                     c: int):
        """The L1 family's approximate plan on a view: K9 scores the centred
        bf16 rows with the mean added back and keeps a shortlist of k x
        oversample, K6c's gather mode rescores its f32 rows (K10) and K5
        orders them on (score, id)."""
        c = min(c, v.rows)
        self.last_scanned += v.n + c
        qt = {"x": qs}
        top, cand = elementwise_topc(qs, self.view_x16(v), self.view_aux(v)["mean"],
                                     self.view_valid(v, handle), metric, c)
        cand = torch.where(top > float("-inf"), cand, -1)
        exact = elementwise_scores(qt, {"x": self.view_x32(v)}, None, metric, ids=cand)
        best, ids = topk_select(exact, min(k, c), ids=cand)
        return unorient(best, metric.ascending), v.to_global(ids, best > float("-inf"))

    def _bf16_elem_submit(self, q: np.ndarray, qd: torch.Tensor, k: int, metric: Metric, handle,
                          oversample: int, approx: bool):
        """The L1 family in the host-rescore tier: K9's shortlist over the
        device's centred copy, the exact rescore of its rows gathered from
        the host mirror (K6c's gather mode)."""
        if approx:
            c = min(max(k * oversample, k), self.capacity)
        else:
            c = self._shortlist_size(k, self.n, oversample)
        self.last_scanned = self.n + c
        top, cand = elementwise_topc(qd, self._dev16, self.bf16_aux()["mean"],
                                     self.valid_mask(handle), metric, c)
        return lambda: self._rescore_fetched(q, top, cand, metric, k)

    def _stream_submit(self, q: np.ndarray, qd: torch.Tensor, k: int, metric: Metric, handle,
                       oversample: int, exact: bool):
        """A pass of the streaming pump (:meth:`_stream_pass`): the bf16
        blocks (IP, L2, cosine and the L1 family) and a top-C shortlist the
        host mirror rescores exactly, or the exact f32 blocks (the other
        metrics, ``mode="exact"``, and small corpora) and their top k. A
        selective filter under IP/L2/cosine on a streaming corpus scores
        its rows exactly on the host instead."""
        if (not exact and self.tier == STREAMING and metric in TWO_PASS_METRICS
                and handle is not None and handle.use_gather(self.n)):
            return self._compact_submit(q, k, metric, handle)
        if exact:
            kk = min(k, self.n)
            self.last_scanned = self.n
            keys, ids = self._stream_pass(qd, metric, "f32", kk, handle)
            dists = unorient(keys, metric.ascending)
            ids = torch.where(keys > float("-inf"), ids.long(), -1)
            return lambda: _trim_results(*_fetch(dists, ids))
        c = self._shortlist_size(k, self.n, oversample)
        self.last_scanned = self.n + c
        keys, ids = self._stream_pass(qd, metric, "bf16", c, handle)
        return lambda: self._rescore_fetched(q, keys, ids, metric, k)

    def _compact_submit(self, q: np.ndarray, k: int, metric: Metric, handle: FilterHandle):
        """A selective filter on a streaming corpus: the exact scores of the
        filter's rows straight off the host mirror (no device pass)."""
        idx = np.nonzero(handle.mask[: self.n])[0]
        self.last_scanned = len(idx)

        def resolve():
            sub = self._host[idx]  # (S, D)
            ip = q @ sub.T
            if metric is Metric.IP:
                exact = ip
            else:
                q_sq = (q * q).sum(-1, keepdims=True)
                s_sq = (sub * sub).sum(-1)
                if metric is Metric.L2:
                    exact = np.maximum(q_sq + s_sq[None, :] - 2.0 * ip, 0.0)
                else:
                    denom = np.sqrt(q_sq * s_sq[None, :])
                    with np.errstate(invalid="ignore", divide="ignore"):
                        exact = np.where(denom < 1e-30, 1.0, 1.0 - ip / np.maximum(denom, 1e-30))
            m = min(len(self._tombs_np), self.n)
            dead = np.zeros(len(idx), dtype=bool)
            dead[idx < m] = self._tombs_np[idx[idx < m]]
            exact = np.where(dead[None, :], np.nan, exact)
            keyed = np.where(np.isnan(exact), -np.inf, -exact if metric.ascending else exact)
            order = _stable_top(-keyed, k)
            d = np.take_along_axis(exact, order, axis=1).astype(np.float32)
            kept = np.isfinite(np.take_along_axis(keyed, order, axis=1))
            return _trim_results(d, idx[order].astype(np.int64), kept)

        return resolve

    def _rescore_fetched(self, q: np.ndarray, keys: torch.Tensor, ids: torch.Tensor,
                         metric: Metric, k: int):
        """Fetch a first pass's (B, C) shortlist and rescore it on the host."""
        keys_np, ids_np = keys.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
        keep = (keys_np > -np.inf) & (ids_np >= 0)
        return self._rescore_topk(q, ids_np, keep, metric, k)

    def _rescore_topk(self, q: np.ndarray, ids: np.ndarray, keep: np.ndarray, metric: Metric,
                      k: int):
        """The host second pass: exact f32 scores of the shortlist rows from
        the host mirror (host_exact_scores for IP/L2/cosine, the K6 kernels'
        gather mode over the rows uploaded otherwise), ordered on (score
        desc, id asc), trimmed to k."""
        b, c = ids.shape
        safe = np.where(keep, ids, 0)
        # flat 1-D gather then reshape (2-D fancy indexing is slower)
        rows = self._host[safe.ravel()].reshape(b, c, self.dim)
        if metric in TWO_PASS_METRICS:
            exact = host_exact_scores(q, rows, metric)
        else:
            exact = self._rows_dists(q, rows, keep, metric)
        key = -exact if metric.ascending else exact
        key = np.where(keep & np.isfinite(key), key, -np.inf)
        order = np.lexsort((safe, -key), axis=1)[:, :k]
        d = np.take_along_axis(exact, order, axis=1).astype(np.float32)
        i = np.take_along_axis(ids, order, axis=1)
        kept = np.take_along_axis(key, order, axis=1) > -np.inf
        return _trim_results(d, i, kept)

    def _rows_dists(self, q: np.ndarray, rows: np.ndarray, keep: np.ndarray,
                    metric: Metric) -> np.ndarray:
        """(B, C) exact distances of explicit (B, C, D) rows uploaded to the
        device: the metric's kernel in gather mode over their transform
        (the JAX package's rescore_rows), NaN where ``keep`` is False."""
        b, c = keep.shape
        qd = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(self.device)
        flat = torch.from_numpy(np.ascontiguousarray(rows.reshape(b * c, self.dim),
                                                     dtype=np.float32)).to(self.device)
        ids = np.where(keep, np.arange(b * c, dtype=np.int32).reshape(b, c), -1).astype(np.int32)
        keys = metric_keys(D.query_transform(qd, metric), D.corpus_transform(flat, metric), None,
                           metric, ids=torch.from_numpy(ids).to(self.device))
        return np.where(keep, unorient(keys, metric.ascending).cpu().numpy(), np.nan)

    # ── views: the rows each resident plan reads ─────────────────────────

    def _whole(self) -> _View:
        return _View(self.device, 0, self.capacity, self.n, whole=True)

    def views(self) -> list:
        """The views the resident plans run on: the whole corpus, or a mesh
        corpus's shards that hold real rows, in shard order."""
        self._ensure_staged()
        if self.mesh is None:
            return [self._whole()]
        return [v for v in self._shards if v.n]

    def view_x16(self, v: _View) -> torch.Tensor:
        """The view's centred bf16 rows (rows, D)."""
        return self._dev16 if v.whole else v.x16

    def view_aux(self, v: _View) -> dict:
        """The aux arrays of the view's centred bf16 rows (bf16_aux's)."""
        return self.bf16_aux() if v.whole else v.aux

    def view_x32(self, v: _View) -> torch.Tensor:
        """The view's f32 rows (rows, D), staged on first use."""
        if v.whole:
            return self._data
        if v.x32 is None:
            x32 = torch.zeros((v.rows, self.dim), dtype=torch.float32, device=v.device)
            x32[: v.n] = torch.from_numpy(
                np.ascontiguousarray(self._host[v.lo : v.lo + v.n])).to(v.device)
            v.x32 = x32
        return v.x32

    def view_valid(self, v: _View, filter_mask=None) -> torch.Tensor:
        """(rows,) bool on the view's device: its rows in range, not
        tombstoned and passing the filter."""
        if v.whole:
            return self.valid_mask(filter_mask)
        if v.valid is None or v.valid_epoch != self.epoch:
            valid = np.zeros(v.rows, dtype=bool)
            valid[: v.n] = self._host_valid(None)[v.lo : v.lo + v.n]
            v.valid, v.valid_epoch = torch.from_numpy(valid).to(v.device), self.epoch
        handle = _handle(filter_mask)
        if handle is None:
            return v.valid
        return v.valid & handle.device_mask(v.lo, v.rows, self.epoch, v.device)

    def view_transform(self, v: _View, metric: Metric) -> dict:
        """The corpus transform of ``metric`` over the view's f32 rows."""
        if v.whole:
            return self.transform(metric)
        if v.transform is None or v.transform[0] is not metric:
            v.transform = None  # free before staging another
            self._check_mesh_fits(self.capacity, metric)
            v.transform = (metric, D.corpus_transform(self.view_x32(v), metric))
        return v.transform[1]

    def gather_inputs(self, handle: FilterHandle, v: Optional[_View] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The gather route's K11 inputs over view ``v`` (the whole corpus by
        default): the filter's (1, S) int32 rows in it, in the view's row
        ids and shared by every query, and their (1, S) slot keys (-inf for
        a deleted row, else 0)."""
        v = self._whole() if v is None else v
        idx = handle.device_indices(v.lo, v.lo + v.n, self.epoch, v.device)
        return idx, torch.where(self.view_valid(v)[idx.long()], 0.0, float("-inf"))

    def search(self, queries: np.ndarray, k: int, metric: Metric, filter_mask=None,
               mode: str = "auto"):
        """Top-k search: (dists (B,k'), row_ids (B,k')) trimmed of invalid
        entries; distances are exact f32."""
        return self.search_submit(queries, k, metric, filter_mask, mode=mode)()

    def search_approx(self, queries: np.ndarray, k: int, metric: Metric, eps: float = 1e-4,
                      filter_mask=None):
        """Approximate scan (explicit opt-in, reference approx_search.rs):
        eps steers the shortlist's oversample. IP/L2/cosine take the default
        two-pass plan, the L1 family its approximate plan (K9, _approx_part).
        Below the engage threshold it is the exact search
        (approx_search.rs:49); a streaming corpus's pass is already a
        two-pass plan."""
        if self.n <= self.APPROX_MIN_ROWS or not metric.supports_flat_approx:
            return self.search(queries, k, metric, filter_mask)
        self._ensure_staged()
        if self.tier == STREAMING:
            return self.search(queries, k, metric, filter_mask)
        oversample = 4 if eps >= 1e-3 else (8 if eps >= 1e-5 else 16)
        return self.search_submit(queries, k, metric, filter_mask, mode="approx",
                                  oversample=oversample)()

    def range_search(self, query: np.ndarray, threshold: float, metric: Metric,
                     max_results: int = 1000, filter_mask=None):
        """All rows within ``threshold`` (<= for ascending metrics, >= for
        IP), best first, capped at max_results (reference: engine.rs:6410):
        the top-(max_results) search with a threshold test. For the 13
        metrics outside IP/L2/cosine that search is the exact plan over every
        row (K6, then K5), which replaces the JAX package's full (1, N) score
        fetch (K10) with the same answer: its stable ascending sort keeps the
        lower id first among ties, as K5 does."""
        if self.n == 0:
            return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)
        qv = np.asarray(query, dtype=np.float32).reshape(1, -1)
        d, i = self.search(qv, max_results, metric, filter_mask=filter_mask)
        d, i = d[0], i[0]
        ok = i >= 0
        ok &= (d <= threshold) if metric.ascending else (d >= threshold)
        return d[ok].astype(np.float32), i[ok].astype(np.int64)

    def rescore(self, queries: np.ndarray, cand_ids: np.ndarray, metric: Metric) -> np.ndarray:
        """Exact (B, C) distances of explicit candidate rows, NaN where an id
        is negative. ``cand_ids`` is (B, C), or (C,) shared by every query.
        IP/L2/cosine rescore on the host mirror; the other metrics through
        their distance kernel's gather mode over the staged transform (K10),
        or over the rows uploaded from the host mirror off the resident
        tier."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        ids = np.asarray(cand_ids)
        if ids.ndim == 1:
            ids = np.broadcast_to(ids, (q.shape[0], ids.shape[0]))
        valid = ids >= 0
        safe = np.where(valid, ids, 0)
        if metric in TWO_PASS_METRICS:
            # flat 1-D gather then reshape (2-D fancy indexing is slower)
            rows = self._host[safe.ravel()].reshape(safe.shape + (self.dim,))
            return np.where(valid, host_exact_scores(q, rows, metric), np.nan)
        if ids.shape[1] == 0:
            return np.zeros(ids.shape, dtype=np.float32)
        self._ensure_staged()
        if self.tier != RESIDENT or self.mesh is not None or not self._fits(metric):
            rows = self._host[safe.ravel()].reshape(safe.shape + (self.dim,))
            return self._rows_dists(q, rows, valid, metric)
        ct = self.transform(metric)
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        ids_d = torch.from_numpy(np.where(valid, ids, -1).astype(np.int32)).to(self.device)
        keys = metric_keys(D.query_transform(qd, metric), ct, None, metric, ids=ids_d)
        return np.where(valid, unorient(keys, metric.ascending).cpu().numpy(), np.nan)



def _stable_top(a: np.ndarray, k: int) -> np.ndarray:
    """The first k columns of each row of a stable ascending argsort of the
    (B, S) array ``a``, without sorting all S: a partition finds each row's
    k-th value, and only the entries at or below it (every tie included) are
    sorted, stably."""
    k = min(k, a.shape[1])
    if k == 0 or k == a.shape[1]:
        return np.argsort(a, axis=1, kind="stable")[:, :k]
    kth = np.partition(a, k - 1, axis=1)[:, k - 1]
    out = np.empty((a.shape[0], k), dtype=np.int64)
    for r in range(a.shape[0]):
        cand = np.flatnonzero(a[r] <= kth[r])
        out[r] = cand[np.argsort(a[r, cand], kind="stable")[:k]]
    return out


def _fetch(dists: torch.Tensor, ids: torch.Tensor):
    """Device -> host: (dists, ids, keep) with keep = slot holds a row."""
    ids_np = ids.cpu().numpy()
    return dists.cpu().numpy(), ids_np, ids_np >= 0


def _concat_parts(parts: list) -> tuple[np.ndarray, np.ndarray]:
    width = max(p[0].shape[1] for p in parts)

    def padto(a, fill):
        if a.shape[1] == width:
            return a
        pad = np.full((a.shape[0], width - a.shape[1]), fill, a.dtype)
        return np.concatenate([a, pad], axis=1)

    return (
        np.concatenate([padto(p[0], 0.0) for p in parts], axis=0),
        np.concatenate([padto(p[1], -1) for p in parts], axis=0),
    )


def _trim_results(dists: np.ndarray, ids: np.ndarray, keep: np.ndarray):
    """Compact each row's surviving entries (order-preserving)."""
    counts = keep.sum(axis=1)
    width = int(counts.max(initial=0))
    # stable partition: kept entries first, original order preserved
    order = np.argsort(~keep, axis=1, kind="stable")[:, :width]
    live = np.arange(width)[None, :] < counts[:, None]
    out_d = np.where(live, np.take_along_axis(dists, order, axis=1), 0.0).astype(np.float32)
    out_i = np.where(live, np.take_along_axis(ids, order, axis=1), -1).astype(np.int64)
    return out_d, out_i

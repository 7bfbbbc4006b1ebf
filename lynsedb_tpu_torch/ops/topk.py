"""Masked top-k selection and cross-block merge (K5).

Every metric is oriented into a "bigger is better" key, NaN and invalid rows
become -inf, and the top k are taken best first with the lower index winning
ties: the order ``jax.lax.top_k`` gives in the JAX package
(lynsedb_tpu/ops/topk.py). ``masked_top_c`` is exact here; the JAX package's
``approx_max_k`` lowers to the same exact top-k on the CPU.

:func:`topk_select` is the kernel's wrapper: on a CUDA tensor it launches the
select kernel (csrc/topk_select.cu), on a CPU tensor it runs the plain
version beside it. Any 1 <= k <= N runs a hand-written kernel: k <= 1,024
reads each key once and keeps a running top k a warp for every span of a
row (then the same kernel merges the spans' lists); up to ``RADIX_CAP`` a
radix select finds the k-th key in a few passes over the row, writes the
entries at and above it in column order and sorts only those in shared
memory; a larger k sorts 4,096-key chunks and merges the sorted runs.
:func:`merge_runs` is K5 over rows of runs already sorted (the fused first
pass's span lists, K8's state): pairwise merges in one or two launches.
``topk_select.by_mode`` splits K5's launches: ``select`` (k <= 1,024),
``large_k`` (k > 1,024) and ``merge`` (:func:`merge_runs`' own launches).
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = float("-inf")
SELECT_MAX = 1024  # the largest k of the one-read select
RADIX_CAP = 16384  # the largest k of the radix select (survivors sorted in shared memory)


def orient(scores: torch.Tensor, ascending: bool) -> torch.Tensor:
    """Map scores into descending-key space (bigger = more similar)."""
    return -scores if ascending else scores


def unorient(keys: torch.Tensor, ascending: bool) -> torch.Tensor:
    return -keys if ascending else keys


def topk_select_plain(keys: torch.Tensor, k: int, ids: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`topk_select`: a stable descending sort keeps
    the lower index first among equal keys (with ``ids``: a stable sort by id
    first, so the lower id is first)."""
    keys = torch.where(torch.isnan(keys), NEG_INF, keys)
    if ids is None:
        vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
        return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    by_key = torch.sort(keys.gather(1, by_id), dim=-1, descending=True, stable=True).indices
    order = by_id.gather(1, by_key)[:, :k]
    return keys.gather(1, order).contiguous(), ids.gather(1, order).to(torch.int32).contiguous()


def topk_select(keys: torch.Tensor, k: int, ids: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a (B, N) f32 key matrix (bigger first, lower index first
    between equal keys, NaN as -inf). Returns (keys (B, k) f32, column
    indices (B, k) int32). 0 <= k <= N. ``ids`` (B, N) int32, if given,
    takes the column index's place: it breaks ties and is returned."""
    b, n = keys.shape
    if not 0 <= k <= n:
        raise ValueError(f"topk_select: k={k} outside [0, {n}]")
    if ids is not None and (ids.shape != keys.shape or ids.dtype != torch.int32):
        raise ValueError("topk_select: ids must be int32 and shaped like keys")
    if keys.device.type == "cpu":
        return topk_select_plain(keys, k, ids)
    _cuda.require_cuda("topk_select", keys, ids)
    if keys.dtype != torch.float32:
        raise ValueError(f"topk_select: keys must be float32, got {keys.dtype}")
    out_keys = torch.empty((b, k), dtype=torch.float32, device=keys.device)
    out_idx = torch.empty((b, k), dtype=torch.int32, device=keys.device)
    if k == 0 or b == 0:
        return out_keys, out_idx
    entries = _cuda.library().lt_topk_scratch(b, n, k)
    # the two buffers' keys (f32) and ids (int32): four rows of one allocation
    scratch = torch.empty((4, entries), dtype=torch.int32, device=keys.device)
    at = scratch.data_ptr()
    _cuda.call(
        "lt_topk_select", keys.data_ptr(), _cuda.ptr(ids), b, n, k, out_keys.data_ptr(),
        out_idx.data_ptr(), *(at + i * entries * 4 for i in range(4)), _cuda.stream_of(keys),
    )
    topk_select.launches += 1
    topk_select.by_mode["select" if k <= SELECT_MAX else "large_k"] += 1
    return out_keys, out_idx


topk_select.launches = 0
topk_select.by_mode = {"select": 0, "large_k": 0, "merge": 0}

MERGE_RUN_MAX = 256  # the longest run the merge of sorted runs takes
# Rows with more runs than this merge in two launches, groups of this many
# runs in parallel blocks first: one block a row would wait on memory once a
# level for every level of a long merge.
MERGE_GROUP = 16


def merge_runs(keys: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 over sorted runs: ``keys`` (B, L * k) f32 and ``ids`` (B, L * k)
    int32 hold L runs of k entries each, every run sorted best first (key
    descending, the lower id first between equal keys), as the fused first
    pass's span lists and K8's state are. Returns the best k of each row,
    what ``topk_select(keys, k, ids=ids)`` returns. Runs of at most
    ``MERGE_RUN_MAX`` entries merge pairwise in the kernel
    (csrc/topk_select.cu, each launch counted as K5's): in one launch, or in
    groups of ``MERGE_GROUP`` runs and then the groups' results; longer runs
    go to :func:`topk_select`."""
    b, n = keys.shape
    if ids.shape != keys.shape or ids.dtype != torch.int32 or n % k:
        raise ValueError("merge_runs: ids int32 shaped like keys, and whole runs of k expected")
    if keys.device.type == "cpu":
        return topk_select_plain(keys, k, ids)
    if k > MERGE_RUN_MAX:
        return topk_select(keys, k, ids=ids)
    _cuda.require_cuda("merge_runs", keys, ids)
    runs = n // k
    # groups of about sqrt(runs) runs (at least MERGE_GROUP): two launches
    per = max(MERGE_GROUP, math.isqrt(runs - 1) + 1) if runs > MERGE_GROUP else runs
    groups = -(-runs // per)
    out_keys = torch.empty((b, groups * k), dtype=torch.float32, device=keys.device)
    out_idx = torch.empty((b, groups * k), dtype=torch.int32, device=keys.device)
    scratch = torch.empty(_cuda.library().lt_topk_merge_scratch(b, runs, k, per),
                          dtype=torch.int64, device=keys.device)
    _cuda.call("lt_topk_merge_runs", keys.data_ptr(), ids.data_ptr(), b, runs, k, per,
               out_keys.data_ptr(), out_idx.data_ptr(), scratch.data_ptr(), _cuda.stream_of(keys))
    topk_select.launches += 1
    topk_select.by_mode["merge"] += 1
    if groups == 1:
        return out_keys, out_idx
    return merge_runs(out_keys, out_idx, k)


def _masked_keys(scores: torch.Tensor, ascending: bool, valid: torch.Tensor | None) -> torch.Tensor:
    keyed = orient(scores.to(torch.float32), ascending)
    if valid is not None:
        keyed = torch.where(valid if valid.dim() == 2 else valid[None, :], keyed, NEG_INF)
    return keyed.contiguous()


def masked_top_k(scores: torch.Tensor, k: int, ascending: bool, valid: torch.Tensor | None = None):
    """Top-k of a (B, N) score matrix.

    Returns ``(dists (B,k), idx (B,k))`` in the metric's native orientation.
    Invalid rows come back with ``dist == +inf`` (ascending) / ``-inf``
    (descending); callers drop them by checking the oriented key for -inf.
    """
    k = min(k, scores.shape[-1])
    top, idx = topk_select(_masked_keys(scores, ascending, valid), k)
    return unorient(top, ascending), idx


def masked_top_c(scores: torch.Tensor, c: int, ascending: bool, valid: torch.Tensor | None = None):
    """Shortlist top-C for the two-pass search: the same exact selection as
    :func:`masked_top_k` (the shortlist is rescored exactly afterwards)."""
    return masked_top_k(scores, c, ascending, valid)


def merge_top_k(dists: torch.Tensor, ids: torch.Tensor, k: int, ascending: bool):
    """Merge per-block top-k candidate lists: ``dists``/``ids`` are (B, M)
    concatenated, already globally indexed results; ties go to the lower
    position. Returns (B, min(k, M)) merged results."""
    k = min(k, dists.shape[-1])
    top, pos = topk_select(_masked_keys(dists, ascending, None), k)
    return unorient(top, ascending), torch.gather(ids, 1, pos.long())


def merge_shards(parts, k: int, ascending: bool, home: torch.device, *, plain: bool = False):
    """K21a's cross-shard stage: every shard's ``(dists (B, k_s), ids (B,
    k_s))``, in shard order, copied to ``home`` (``non_blocking``: nothing
    on a shared device, a peer copy between cards) and merged into the best
    ``min(k, sum k_s)`` by K5 over their concatenation (:func:`merge_top_k`:
    oriented keys, NaN as -inf, ties to the lower position, so to the lower
    shard). ``plain``: K5's plain version. Returns (dists, ids) on
    ``home``. ``merge_shards.launches`` counts its K5 launches, which
    ``topk_select.launches`` counts too."""
    d = torch.cat([p[0].to(home, non_blocking=True) for p in parts], dim=1)
    i = torch.cat([p[1].to(home, non_blocking=True) for p in parts], dim=1)
    if plain:
        top, pos = topk_select_plain(orient(d, ascending), min(k, d.shape[1]))
        return unorient(top, ascending), torch.gather(i, 1, pos.long())
    out = merge_top_k(d, i, k, ascending)
    if home.type == "cuda":
        merge_shards.launches += 1
    return out


merge_shards.launches = 0

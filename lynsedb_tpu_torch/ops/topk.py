"""Masked top-k selection and cross-block merge (K5).

Every metric is oriented into a "bigger is better" key, NaN and invalid rows
become -inf, and the top k are taken best first with the lower index winning
ties: the order ``jax.lax.top_k`` gives in the JAX package
(lynsedb_tpu/ops/topk.py). ``masked_top_c`` is exact here; the JAX package's
``approx_max_k`` lowers to the same exact top-k on the CPU.

:func:`topk_select` is the kernel's wrapper: on a CUDA tensor it launches the
bitonic select kernel (csrc/topk_select.cu), on a CPU tensor it runs the plain
version beside it. Any 1 <= k <= N runs a hand-written kernel: k <= 1,024
selects in shared memory, a larger k sorts 4,096-key chunks and merges the
sorted runs.
"""

from __future__ import annotations

import torch

from . import _cuda

NEG_INF = float("-inf")


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
    s_keys = torch.empty((2, entries), dtype=torch.float32, device=keys.device)
    s_idx = torch.empty((2, entries), dtype=torch.int32, device=keys.device)
    _cuda.call(
        "lt_topk_select", keys.data_ptr(), _cuda.ptr(ids), b, n, k, out_keys.data_ptr(),
        out_idx.data_ptr(), s_keys[0].data_ptr(), s_idx[0].data_ptr(), s_keys[1].data_ptr(),
        s_idx[1].data_ptr(), _cuda.stream_of(keys),
    )
    topk_select.launches += 1
    return out_keys, out_idx


topk_select.launches = 0


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

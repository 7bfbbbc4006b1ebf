"""The flat-scan engine: a device-resident corpus and the searches over it.

Port of lynsedb_tpu/ops/scan.py. The corpus keeps

  * an exact f32 mirror of every row in host RAM (numpy), the source every
    device array is staged from;
  * on the device: a mean-centred **bf16** copy (the first-pass scan array),
    its per-row aux arrays (``xm``, ``xc_sq``, ``xsq_true``), an **f32** copy
    (the exact scan and the rescore gather from it) and the validity mask.

A search runs one of two plans, each a chain of hand-written kernels:

  * **exact** (fewer than ``TWO_PASS_MIN_ROWS`` rows, or ``mode="exact"``):
    K1 ``flat_scores_f32`` scores every row in f32, K5 ``topk_select`` takes
    the top k;
  * **two-pass** (IP/L2/cosine): K2 ``bf16_centered_scores`` scores the
    centred bf16 copy, K5 takes a top-C shortlist, K3 ``rescore_topk``
    rescores it exactly in f32 and sorts on (score, id).

Every filter is a mask on that pass: the JAX package's gather route for
selective filters (K4) is not ported, and gives the same answer. Neither are
its host-rescore route and its streaming tier for corpora whose copies do not
fit on the device (ROADMAP A.5): staging such a corpus raises.

Each kernel's wrapper launches it for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; the plain versions are what the CPU tests
hold against the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..metrics import Metric
from . import _cuda
from . import distance as D
from .topk import topk_select, unorient

# Metrics served by the bf16 first pass + exact f32 rescore.
TWO_PASS_METRICS = (Metric.IP, Metric.L2, Metric.COSINE)
# Below this row count the one-pass f32 exact scan serves every search.
TWO_PASS_MIN_ROWS = 4096
# Device arrays hold the row count rounded up to this (the kernels need no
# padding; the slack lets small appends restage in place). Padded rows are
# invalid, so they never reach a result.
ROW_ALIGN = 128
# Largest (B, rows) f32 score matrix one search materialises (1 GB); larger
# query batches are split on the host.
SCORE_BUDGET = 1 << 28
# Rows converted per host staging step.
STAGE_ROWS = 1 << 17

# Largest shortlist K3 sorts in shared memory; a larger one goes through K5.
RESCORE_SORT_MAX = 1024

_METRIC_CODE = {Metric.IP: 0, Metric.L2: 1, Metric.COSINE: 2}


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


def _kernel_metric(name: str, metric: Metric) -> int:
    if metric not in _METRIC_CODE:
        raise NotImplementedError(f"{name}: metric {metric.value} is not ported yet (ROADMAP K6)")
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
        "lt_flat_scores_f32", q.data_ptr(), x.data_ptr(), _cuda.ptr(qsq), _cuda.ptr(xsq),
        valid.data_ptr(), b, n, d, code, int(metric.ascending), keys.data_ptr(),
        _cuda.stream_of(q),
    )
    flat_scores_f32.launches += 1
    return keys


flat_scores_f32.launches = 0


# ── K2: centred bf16 first pass ──────────────────────────────────────────


def _query_terms(q: torch.Tensor, mean: torch.Tensor):
    """Per-query terms of the first pass: the bf16-rounded centred query and
    |q - m|^2, q.m, |q|^2 (all from the f32 values)."""
    qc = q - mean[None, :]
    return (qc.to(torch.bfloat16).contiguous(), (qc * qc).sum(-1), (q * mean[None, :]).sum(-1),
            (q * q).sum(-1))


def bf16_centered_scores_plain(q, x16, aux: dict, valid, metric: Metric) -> torch.Tensor:
    """Plain version of :func:`bf16_centered_scores`: the bf16 operands are
    upcast to f32 before the product (JAX's preferred_element_type=f32)."""
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
        D.check_supported(metric)
    return _to_key(scores, metric.ascending, valid)


def bf16_centered_scores(q: torch.Tensor, x16: torch.Tensor, aux: dict, valid: torch.Tensor,
                         metric: Metric) -> torch.Tensor:
    """Oriented, masked first-pass keys (B, N) of f32 queries ``q`` (B, D)
    against the mean-centred bf16 corpus ``x16`` (N, D). ``aux``: mean (D,),
    xm / xc_sq / xsq_true (N,) f32 (see DeviceCorpus._convert_block)."""
    if q.device.type == "cpu":
        return bf16_centered_scores_plain(q, x16, aux, valid, metric)
    code = _kernel_metric("bf16_centered_scores", metric)
    b, d = q.shape
    n = x16.shape[0]
    qc16, qc_sq, qm, q_sq = _query_terms(q, aux["mean"])
    _cuda.require_cuda("bf16_centered_scores", q, x16, aux["xm"], aux["xc_sq"], aux["xsq_true"],
                       valid)
    if x16.dtype != torch.bfloat16 or x16.shape[1] != d or q.dtype != torch.float32:
        raise ValueError("bf16_centered_scores: q (B, D) float32 and x16 (N, D) bfloat16 expected")
    if any(aux[key].shape != (n,) for key in ("xm", "xc_sq", "xsq_true")) or valid.shape != (n,):
        raise ValueError("bf16_centered_scores: aux arrays and valid must be (N,)")
    keys = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.call(
        "lt_bf16_centered_scores", qc16.data_ptr(), x16.data_ptr(), qc_sq.data_ptr(),
        qm.data_ptr(), q_sq.data_ptr(), aux["xm"].data_ptr(), aux["xc_sq"].data_ptr(),
        aux["xsq_true"].data_ptr(), valid.data_ptr(), b, n, d, code, int(metric.ascending),
        keys.data_ptr(), _cuda.stream_of(q),
    )
    bf16_centered_scores.launches += 1
    return keys


bf16_centered_scores.launches = 0


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


def rescore_topk(q: torch.Tensor, x32: torch.Tensor, cand_keys: torch.Tensor,
                 cand_idx: torch.Tensor, k: int, metric: Metric):
    """Exact f32 rescore of a (B, C) shortlist (``cand_idx`` int32 row ids,
    ``cand_keys`` the first-pass keys, -inf for an empty slot) against the f32
    corpus ``x32``: best k by (score desc, id asc), non-finite scores dropped.
    Returns (dists (B, k) f32, ids (B, k) int64) with +inf/-inf and -1 in
    the slots nothing filled. Up to ``RESCORE_SORT_MAX`` slots one kernel
    scores and sorts; above it the kernel writes the (B, C) exact keys and
    K5 selects the top k with the row ids as its tie-break."""
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
        dists = torch.empty((b, k), dtype=torch.float32, device=q.device)
        ids = torch.empty((b, k), dtype=torch.int64, device=q.device)
        _cuda.call(
            "lt_rescore_topk", q.data_ptr(), x32.data_ptr(), cand_keys.data_ptr(),
            cand_idx.data_ptr(), b, c, d, k, code, int(metric.ascending), dists.data_ptr(),
            ids.data_ptr(), stream,
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
    """A resolved row filter: host mask + count, with the device mask staged
    lazily and cached per corpus epoch. Collections cache these per
    where-string so repeated filtered queries pay no re-upload."""

    __slots__ = ("mask", "count", "_epoch", "_dev_mask")

    def __init__(self, mask: np.ndarray):
        self.mask = np.asarray(mask, dtype=bool)
        self.count = int(self.mask.sum())
        self._epoch = -1
        self._dev_mask: Optional[torch.Tensor] = None

    def device_mask(self, n_pad: int, epoch: int, device: torch.device) -> torch.Tensor:
        if self._dev_mask is None or self._epoch != epoch or self._dev_mask.shape[0] != n_pad:
            full = np.zeros(n_pad, dtype=bool)
            m = min(len(self.mask), n_pad)
            full[:m] = self.mask[:m]
            self._dev_mask = torch.from_numpy(full).to(device)
            self._epoch = epoch
        return self._dev_mask


def _handle(filter_mask) -> Optional[FilterHandle]:
    if filter_mask is None or isinstance(filter_mask, FilterHandle):
        return filter_mask
    return FilterHandle(filter_mask)


def _empty(b: int) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    out = (np.zeros((b, 0), dtype=np.float32), np.zeros((b, 0), dtype=np.int64))
    return lambda: out


class DeviceCorpus:
    """Device-resident corpus for one vector field (the role of the
    reference's FlatMmap, src/storage/flat_mmap.rs:89): the exact f32 host
    mirror, and on ``device`` the centred bf16 copy, its aux arrays, the f32
    copy and the validity mask. ``device`` is explicit: "cuda" needs a card
    and runs the kernels; "cpu" runs their plain versions."""

    APPROX_MIN_ROWS = 65_536  # approx engage threshold (approx_search.rs:49)

    def __init__(self, dim: int, dtype: str = "float32", *, device):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.dtype = dtype
        self.n = 0
        self.capacity = 0
        self.epoch = 0
        self._host = np.zeros((0, self.dim), dtype=np.float32)  # exact mirror
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
        self._transforms: dict[Metric, dict] = {}
        self._dirty = True
        self._dirty_lo = 0
        # rows scored by the most recent search (QueryProfile.scanned_vectors)
        self.last_scanned = 0

    # ── staging ──────────────────────────────────────────────────────────

    def _cap_for(self, n: int) -> int:
        return _round_up(max(n, 1), ROW_ALIGN)

    def device_bytes(self, cap: int) -> int:
        """Device memory a corpus of ``cap`` rows needs at its largest: the
        bf16 and f32 copies, the aux rows and masks, and one search's scratch
        (the (B, cap) score matrix at the largest batch, and K5's two
        buffers, which hold at most cap (key, index) pairs a row for any k)."""
        copies = cap * self.dim * (2 + 4) + cap * (4 * 3 + 2)
        b_max = max(1, SCORE_BUDGET // cap)
        return copies + b_max * cap * 4 + 2 * b_max * cap * 8

    def _check_fits(self, cap: int) -> None:
        """Raise before staging a corpus whose device copies and search
        scratch do not fit the card's free memory. Such corpora need the
        host-rescore route or the streaming tier, which are not ported."""
        if self.device.type != "cuda":
            return
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        need = self.device_bytes(cap)
        if need > free:
            raise RuntimeError(
                f"a corpus of {self.n} x {self.dim} rows needs {need} bytes on {self.device} "
                f"(bf16 and f32 copies plus search scratch) but {free} are free; the host-rescore "
                "route and the streaming tier for such corpora are not ported yet (ROADMAP A.5)"
            )

    def _ensure_staged(self) -> None:
        """Stage (or refresh) the device arrays from the host mirror.

        Writes touch only the host mirror; the device arrays are rebuilt here
        on demand. A small contiguous tail at unchanged capacity updates in
        place; anything else restages fully, dropping the old arrays first."""
        if not self._dirty or self.n == 0:
            return
        cap = self._cap_for(self.n)
        incremental = (
            self._dev16 is not None
            and cap == self.capacity
            and self._mean_np is not None
            and (self.n - self._dirty_lo) * 2 <= self.n
        )
        if incremental:
            lo = self._dirty_lo
            tail16, sq, xm, xsqt = self._convert_block(lo, self.n)
            self._sq_host[lo : self.n] = sq
            self._xm_host[lo : self.n] = xm
            self._xsqtrue_host[lo : self.n] = xsqt
            self._dev16[lo : self.n] = tail16.to(self.device)
            self._aux = None  # host aux changed; restage lazily
            if self._dev32 is not None:
                self._dev32[lo : self.n] = torch.from_numpy(self._host[lo : self.n]).to(self.device)
        else:
            self._dev16 = None  # free before reallocating
            self._dev32 = None
            self._aux = None
            self._check_fits(cap)
            self._compute_mean()
            full16 = torch.zeros((cap, self.dim), dtype=torch.bfloat16)
            self._sq_host = np.zeros(cap, dtype=np.float32)
            self._xm_host = np.zeros(cap, dtype=np.float32)
            self._xsqtrue_host = np.zeros(cap, dtype=np.float32)
            for lo in range(0, self.n, STAGE_ROWS):
                hi = min(lo + STAGE_ROWS, self.n)
                block16, sq, xm, xsqt = self._convert_block(lo, hi)
                full16[lo:hi] = block16
                self._sq_host[lo:hi] = sq
                self._xm_host[lo:hi] = xm
                self._xsqtrue_host[lo:hi] = xsqt
            self._dev16 = full16.to(self.device)
            self.capacity = cap
        self._valid_base = None
        self._dirty = False
        self._dirty_lo = self.n

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
        self._transforms.clear()

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (*, {self.dim}) rows, got {rows.shape}")
        m = rows.shape[0]
        if m == 0:
            return
        if self.n + m > len(self._host):
            new_len = max(8192, len(self._host))
            while new_len < self.n + m:
                new_len *= 2
            host = np.zeros((new_len, self.dim), dtype=np.float32)
            host[: self.n] = self._host[: self.n]
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
        the existing mean (any fixed mean preserves rankings)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        ids = np.asarray(row_ids, dtype=np.int64)
        self._host[ids] = rows
        if self._dev16 is not None and not self._dirty and self._mean_np is not None:
            xc16 = self._overwrite_aux(ids, rows)
            idx = torch.from_numpy(ids).to(self.device)
            self._dev16[idx] = xc16.to(self.device)
            if self._dev32 is not None:
                self._dev32[idx] = torch.from_numpy(rows).to(self.device)
        else:
            self._dirty_lo = 0  # scattered rows: full restage
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
        self._host = np.zeros((0, self.dim), dtype=np.float32)
        self._dev16 = None
        self._dev32 = None
        self._tombs_np = np.zeros(0, dtype=bool)
        self._sq_host = None
        self._mean_np = None
        self._xm_host = None
        self._xsqtrue_host = None
        self._aux = None
        self._dirty = True
        self._dirty_lo = 0
        self._invalidate()

    # ── derived state ────────────────────────────────────────────────────

    @property
    def _data(self) -> torch.Tensor:
        """The f32 device copy (cap, D), staged on first use: the exact scan
        reads it and the rescore gathers from it."""
        self._ensure_staged()
        if self._dev32 is None:
            if self.capacity == 0:
                raise ValueError("empty corpus")
            full = torch.zeros((self.capacity, self.dim), dtype=torch.float32, device=self.device)
            full[: self.n] = torch.from_numpy(self._host[: self.n]).to(self.device)
            self._dev32 = full
        return self._dev32

    def host_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Exact f32 rows from the host mirror (no device traffic)."""
        return self._host[np.asarray(row_ids, dtype=np.int64)]

    def bf16_aux(self) -> dict:
        """Device aux arrays of the centred bf16 copy: mean (D,), xm (cap,),
        xc_sq (cap,), xsq_true (cap,) — see bf16_centered_scores."""
        self._ensure_staged()
        if self._aux is None:
            self._aux = {
                name: torch.from_numpy(arr).to(self.device)
                for name, arr in (("mean", self._mean_np), ("xm", self._xm_host),
                                  ("xc_sq", self._sq_host), ("xsq_true", self._xsqtrue_host))
            }
        return self._aux

    def transform(self, metric: Metric) -> dict:
        ct = self._transforms.get(metric)
        if ct is None:
            ct = D.corpus_transform(self._data, metric)
            self._transforms[metric] = ct
        return ct

    def valid_mask(self, filter_mask=None) -> torch.Tensor:
        """(cap,) bool: rows in range, not tombstoned, and passing the filter."""
        self._ensure_staged()
        if self._valid_base is None:
            host_valid = np.zeros(self.capacity, dtype=bool)
            host_valid[: self.n] = True
            m = min(len(self._tombs_np), self.n)
            host_valid[:m] &= ~self._tombs_np[:m]
            self._valid_base = torch.from_numpy(host_valid).to(self.device)
        handle = _handle(filter_mask)
        if handle is None:
            return self._valid_base
        return self._valid_base & handle.device_mask(self.capacity, self.epoch, self.device)

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
        slots (ids -1 pad rows that found fewer). Distances are exact f32."""
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
        max_b = max(1, SCORE_BUDGET // self.capacity)
        if b > max_b:
            resolvers = [
                self._submit(q[s : s + max_b], k, metric, handle, mode, oversample)
                for s in range(0, b, max_b)
            ]
            return lambda: _concat_parts([r() for r in resolvers])
        return self._submit(q, k, metric, handle, mode, oversample)

    def _submit(self, q: np.ndarray, k: int, metric: Metric, handle, mode: str, oversample: int):
        qd = torch.from_numpy(q).to(self.device)
        valid = self.valid_mask(handle)
        two_pass = mode != "exact" and metric in TWO_PASS_METRICS and self.n >= TWO_PASS_MIN_ROWS
        if not two_pass:
            return self._exact_submit(qd, k, metric, valid)
        c = self._shortlist_size(k, self.n, oversample)
        self.last_scanned = self.n + c  # full first pass + exact rescore rows
        keys = bf16_centered_scores(qd, self._dev16, self.bf16_aux(), valid, metric)
        cand_keys, cand_idx = topk_select(keys, c)
        del keys
        dists, ids = rescore_topk(qd, self._data, cand_keys, cand_idx, min(k, c), metric)
        return lambda: _trim_results(*_fetch(dists, ids))

    def _exact_submit(self, qd: torch.Tensor, k: int, metric: Metric, valid: torch.Tensor):
        """One-pass f32 exact scan: K1 scores, K5 top-k."""
        self.last_scanned = self.n  # masked scans still touch every row
        ct = self.transform(metric)
        qt = D.query_transform(qd, metric)
        keys = flat_scores_f32(qt["x"], ct["x"], qt.get("sq"), ct.get("sq"), valid, metric)
        top, idx = topk_select(keys, min(k, self.capacity))
        del keys
        dists = unorient(top, metric.ascending)
        ids = torch.where(top > float("-inf"), idx.long(), -1)
        return lambda: _trim_results(*_fetch(dists, ids))

    def search(self, queries: np.ndarray, k: int, metric: Metric, filter_mask=None,
               mode: str = "auto"):
        """Top-k search: (dists (B,k'), row_ids (B,k')) trimmed of invalid
        entries; distances are exact f32."""
        return self.search_submit(queries, k, metric, filter_mask, mode=mode)()

    def search_approx(self, queries: np.ndarray, k: int, metric: Metric, eps: float = 1e-4,
                      filter_mask=None):
        """Approximate two-pass scan (explicit opt-in, reference
        approx_search.rs): the default two-pass plan with eps steering the
        shortlist's oversample. Below the engage threshold it is the exact
        search (approx_search.rs:49)."""
        if self.n <= self.APPROX_MIN_ROWS or not metric.supports_flat_approx:
            return self.search(queries, k, metric, filter_mask)
        if metric not in TWO_PASS_METRICS:
            raise NotImplementedError(
                f"approximate search for {metric.value} is not ported yet (ROADMAP K9)")
        oversample = 4 if eps >= 1e-3 else (8 if eps >= 1e-5 else 16)
        return self.search_submit(queries, k, metric, filter_mask, oversample=oversample)()

    def range_search(self, query: np.ndarray, threshold: float, metric: Metric,
                     max_results: int = 1000, filter_mask=None):
        """All rows within ``threshold`` (<= for ascending metrics, >= for
        IP), best first, capped at max_results (reference: engine.rs:6410):
        the top-(max_results) search with a threshold test."""
        if self.n == 0:
            return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)
        if metric not in TWO_PASS_METRICS:
            raise NotImplementedError(
                f"range search for {metric.value} is not ported yet (ROADMAP K10)")
        qv = np.asarray(query, dtype=np.float32).reshape(1, -1)
        d, i = self.search(qv, max_results, metric, filter_mask=filter_mask)
        d, i = d[0], i[0]
        ok = i >= 0
        ok &= (d <= threshold) if metric.ascending else (d >= threshold)
        return d[ok].astype(np.float32), i[ok].astype(np.int64)


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

"""k-means on the card: k-means++ init, then Lloyd iterations.

Port of lynsedb_tpu/ops/kmeans.py. One Lloyd step is two hand-written
kernels: :func:`kmeans_assign` (csrc/kmeans_assign.cu; an f32 tile product
whose epilogue keeps each row's nearest centroid, so the (N, K) matrix is
never written; it is also the JAX package's ``assign_clusters``) and
:func:`kmeans_update` (csrc/kmeans_update.cu; a stable counting sort of
the rows by centroid, then per-centroid sums in row order, deterministic,
plus the new centroids and their moves; its scratch comes from PyTorch's
caching allocator). A sharded step (parallel/mesh.py) adds the shards'
partial sums in :func:`kmeans_reduce_shards` (csrc/mesh_reduce.cu, K21b).
Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors.

The k-means++ seeding runs as PyTorch ops with a ``torch.Generator`` seeded
from ``seed``: k sequential draws over a pool of at most 16 k rows at build
time. It cannot reproduce ``jax.random``'s bits, so the same seed gives other
initial centroids than the JAX package; :func:`_lloyd` takes the initial
centroids so a test can start both packages from the same ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .scan import resolve_device

ASSIGN_CHUNK = 65536


def _l2_scores(x: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """(N, K) squared-L2 distances; x (N, D), c (K, D)."""
    x_sq = (x * x).sum(-1, keepdim=True)
    return torch.clamp_min(x_sq + c_sq[None, :] - 2.0 * (x @ c.T), 0.0)


def _ip_scores(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, K) inner products (bigger = closer for the IP metric)."""
    return x @ c.T


def _check(name: str, data: torch.Tensor, centroids: torch.Tensor) -> None:
    if data.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(f"{name}: data and centroids must be float32")
    if data.dim() != 2 or centroids.dim() != 2 or data.shape[1] != centroids.shape[1]:
        raise ValueError(f"{name}: data (N, D) and centroids (K, D) expected")


# ── kmeans_assign ─────────────────────────────────────────────────────────


def kmeans_assign_plain(data: torch.Tensor, centroids: torch.Tensor, ip: bool) -> torch.Tensor:
    """Plain version of :func:`kmeans_assign`, in row chunks."""
    c_sq = (centroids * centroids).sum(-1)
    out = []
    for lo in range(0, data.shape[0], ASSIGN_CHUNK):
        x = data[lo : lo + ASSIGN_CHUNK]
        if ip:
            out.append(torch.argmax(_ip_scores(x, centroids), dim=-1))
        else:
            out.append(torch.argmin(_l2_scores(x, centroids, c_sq), dim=-1))
    return torch.cat(out).to(torch.int32)


def kmeans_assign(data: torch.Tensor, centroids: torch.Tensor, ip: bool) -> torch.Tensor:
    """(N,) int32 index of each row's nearest centroid: the smallest clamped
    squared L2 distance, or the largest inner product when ``ip``; the lower
    index between equal scores."""
    _check("kmeans_assign", data, centroids)
    if data.device.type == "cpu":
        return kmeans_assign_plain(data, centroids, ip)
    _cuda.require_cuda("kmeans_assign", data, centroids)
    n, d = data.shape
    k = centroids.shape[0]
    c_sq = None if ip else (centroids * centroids).sum(-1)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    _cuda.call("lt_kmeans_assign", data.data_ptr(), centroids.data_ptr(), _cuda.ptr(c_sq), n, k,
               d, int(ip), out.data_ptr(), _cuda.stream_of(data))
    kmeans_assign.launches += 1
    return out


kmeans_assign.launches = 0


# ── kmeans_update ─────────────────────────────────────────────────────────


def kmeans_update_plain(data: torch.Tensor, valid: torch.Tensor, assign: torch.Tensor,
                        centroids: torch.Tensor):
    """Plain version of :func:`kmeans_update`: the JAX step's one-hot
    product, chunk by chunk."""
    k, d = centroids.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    for lo in range(0, data.shape[0], ASSIGN_CHUNK):
        hi = lo + ASSIGN_CHUNK
        one_hot = torch.nn.functional.one_hot(assign[lo:hi].long(), k).to(torch.float32)
        one_hot = one_hot * valid[lo:hi, None].to(torch.float32)
        sums = sums + one_hot.T @ data[lo:hi]
        counts = counts + one_hot.sum(0)
    new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), centroids)
    return sums, counts, new, ((new - centroids) ** 2).sum(-1)


def kmeans_update(data: torch.Tensor, valid: torch.Tensor, assign: torch.Tensor,
                  centroids: torch.Tensor):
    """One Lloyd update. ``data`` (N, D) f32, ``valid`` (N,) bool, ``assign``
    (N,) int32, ``centroids`` (K, D) f32. Returns (sums (K, D), counts (K,),
    new centroids (K, D): the mean of the valid rows assigned to each, or the
    old centroid where none is, moves (K,): each centroid's squared move).
    Deterministic on the card: bit-identical from run to run."""
    _check("kmeans_update", data, centroids)
    n, d = data.shape
    if valid.shape != (n,) or valid.dtype != torch.bool or assign.shape != (n,):
        raise ValueError("kmeans_update: valid (N,) bool and assign (N,) expected")
    if data.device.type == "cpu":
        return kmeans_update_plain(data, valid, assign, centroids)
    _cuda.require_cuda("kmeans_update", data, valid, assign, centroids)
    if assign.dtype != torch.int32:
        raise ValueError("kmeans_update: assign must be int32")
    k = centroids.shape[0]
    sums = torch.empty((k, d), dtype=torch.float32, device=data.device)
    new = torch.empty_like(sums)
    counts = torch.empty(k, dtype=torch.float32, device=data.device)
    moves = torch.empty_like(counts)
    # -1 (refused shapes) leaves no scratch, and the launch then raises
    scratch = torch.empty(max(int(_cuda.library().lt_kmeans_update_scratch(n, k)), 0),
                          dtype=torch.uint8, device=data.device)
    _cuda.call("lt_kmeans_update", data.data_ptr(), assign.data_ptr(), valid.data_ptr(),
               centroids.data_ptr(), n, k, d, sums.data_ptr(), counts.data_ptr(), new.data_ptr(),
               moves.data_ptr(), scratch.data_ptr(), _cuda.stream_of(data))
    kmeans_update.launches += 1
    return sums, counts, new, moves


kmeans_update.launches = 0


# ── kmeans_reduce_shards (K21b) ───────────────────────────────────────────


def _check_partials(sums: torch.Tensor, counts: torch.Tensor, centroids: torch.Tensor) -> None:
    if sums.dim() != 3 or counts.shape != sums.shape[:2] or centroids.shape != sums.shape[1:]:
        raise ValueError("kmeans_reduce_shards: sums (S, K, D), counts (S, K) and centroids "
                         "(K, D) expected")
    if any(t.dtype != torch.float32 for t in (sums, counts, centroids)) or sums.shape[0] < 1:
        raise ValueError("kmeans_reduce_shards: float32 partials of at least one shard expected")


def kmeans_reduce_shards_plain(sums: torch.Tensor, counts: torch.Tensor,
                               centroids: torch.Tensor):
    """Plain version of :func:`kmeans_reduce_shards`: the same adds in the
    same order (shard 0's partial, then + shard 1's, ...), and the division
    by a tensor (PyTorch divides a CUDA tensor by a Python scalar through its
    rounded reciprocal)."""
    _check_partials(sums, counts, centroids)
    acc, cnt = sums[0].clone(), counts[0].clone()
    for s in range(1, sums.shape[0]):
        acc = acc + sums[s]
        cnt = cnt + counts[s]
    new = torch.where(cnt[:, None] > 0, acc / torch.clamp_min(cnt[:, None], 1.0), centroids)
    return new, cnt


def kmeans_reduce_shards(sums: torch.Tensor, counts: torch.Tensor, centroids: torch.Tensor):
    """K21b, the cross-shard reduce of one sharded Lloyd step
    (csrc/mesh_reduce.cu): the shards' partial ``sums`` (S, K, D) and
    ``counts`` (S, K) added in shard order ``s = 0..S-1`` (no float atomics,
    so every run gives the same bits, K15's rule), then each new centroid
    ``sum / max(count, 1)`` where its count is positive, else the old
    ``centroids`` (K, D). Returns (new centroids (K, D), counts (K,)), equal
    to the bit to :func:`kmeans_reduce_shards_plain`."""
    _check_partials(sums, counts, centroids)
    if sums.device.type == "cpu":
        return kmeans_reduce_shards_plain(sums, counts, centroids)
    _cuda.require_cuda("kmeans_reduce_shards", sums, counts, centroids)
    s, k, d = sums.shape
    new = torch.empty((k, d), dtype=torch.float32, device=sums.device)
    out_counts = torch.empty(k, dtype=torch.float32, device=sums.device)
    _cuda.call("lt_kmeans_reduce_shards", sums.data_ptr(), counts.data_ptr(),
               centroids.data_ptr(), s, k, d, new.data_ptr(), out_counts.data_ptr(),
               _cuda.stream_of(sums))
    kmeans_reduce_shards.launches += 1
    return new, out_counts


kmeans_reduce_shards.launches = 0


# ── the algorithm ─────────────────────────────────────────────────────────


def _kmeans_pp_init(data: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding on (already subsampled) data, on data's device."""
    n, d = data.shape
    gen = torch.Generator(device=data.device)
    gen.manual_seed(int(seed))
    first = torch.randint(0, n, (1,), generator=gen, device=data.device)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    centroids[0:1] = data[first]
    min_d = ((data - data[first]) ** 2).sum(-1)
    uniform = torch.full_like(min_d, 1.0 / n)
    for i in range(1, k):
        total = min_d.sum()
        # sample proportional to squared distance (uniform fallback if all 0)
        probs = torch.where(total > 0, min_d / torch.clamp_min(total, 1e-30), uniform)
        c = data[torch.multinomial(probs, 1, generator=gen)]
        centroids[i : i + 1] = c
        min_d = torch.minimum(min_d, ((data - c) ** 2).sum(-1))
    return centroids


def _lloyd_step(data: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor,
                ip: bool = False):
    """One Lloyd iteration. Returns (new_centroids, counts, shift) where
    shift is the largest squared centroid move. ``ip=True`` assigns rows to
    the max-inner-product centroid; the update stays the arithmetic mean."""
    assign = kmeans_assign(data, centroids, ip)
    _, counts, new, moves = kmeans_update(data, valid, assign, centroids)
    return new, counts, moves.max()


def _lloyd(train: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, ip: bool,
           max_iters: int, tol: float) -> torch.Tensor:
    """Lloyd iterations from the given centroids until the largest squared
    move is at most ``tol`` or ``max_iters`` steps ran."""
    for _ in range(max_iters):
        centroids, _, shift = _lloyd_step(train, valid, centroids, ip=ip)
        if float(shift) <= tol:
            break
    return centroids


def _default_iters() -> int:
    """Lloyd iteration budget from config (LYNSE_KMEANS_EPOCHS, default 100
    — the reference's own default)."""
    try:
        from ..configs.config import config

        return int(config.LYNSE_KMEANS_EPOCHS)
    except Exception:
        return 100


def train_kmeans(
    data: np.ndarray,
    k: int,
    *,
    max_iters: int | None = None,
    seed: int = 42,
    normalize: bool = False,
    assign_ip: bool = False,
    tol: float = 1e-6,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Train k-means on ``device`` ("cuda" runs the kernels, "cpu" their
    plain versions). Returns (centroids (k, D) f32, assignments (N,) int32).

    ``normalize=True`` L2-normalizes rows first (cosine-metric routing);
    ``assign_ip=True`` assigns under max-inner-product (IP-metric routing).
    The subsample, its padding and the init pool are the JAX package's,
    drawn from the same numpy generator.
    """
    dev = resolve_device(device)
    if max_iters is None:
        max_iters = _default_iters()
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    k = min(k, n)
    if normalize:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        data = data / np.maximum(norms, 1e-30)

    # adaptive subsample for init + training (reference seeds on a subsample)
    rng = np.random.default_rng(seed)
    train_cap = max(k * 256, 16_384)
    if n > train_cap:
        sample_idx = rng.choice(n, train_cap, replace=False)
        train_np = data[sample_idx]
    else:
        train_np = data

    # pad training rows to a chunk-friendly multiple (the padding is invalid)
    t = train_np.shape[0]
    chunk = min(ASSIGN_CHUNK, 8192)
    t_pad = ((t + chunk - 1) // chunk) * chunk
    padded = np.zeros((t_pad, d), dtype=np.float32)
    padded[:t] = train_np
    train = torch.from_numpy(padded).to(dev)
    valid = torch.from_numpy(np.arange(t_pad) < t).to(dev)

    init_pool = train_np[rng.choice(t, min(t, max(k * 16, 1024)), replace=False)]
    centroids = _kmeans_pp_init(torch.from_numpy(init_pool).to(dev), k, seed)
    centroids = _lloyd(train, valid, centroids, assign_ip, max_iters, tol)
    del train, valid

    # full-corpus assignment (the kernel takes any row count: no padding)
    assigns = kmeans_assign(torch.from_numpy(data).to(dev), centroids, assign_ip)
    return centroids.cpu().numpy(), assigns.cpu().numpy().astype(np.int32)

"""A model of K3, the exact rescore (csrc/rescore_topk.cu), in numpy, held
to the plain version on the CPU.

The model runs the kernel's plan: the query's live slots (a first-pass key
above -inf) listed once, split over the block's warps U rows at a time (8
warps of 8 rows, or 32 warps of 4 on the 1,024-thread route); each row's
exact sums in the kernel's float32 order (lane l adds dimensions l, l + 32,
... with fmaf, then the warp's butterfly: xor 16, 8, 4, 2, 1), |q|^2 the
same way; non-finite scores dropped; then the selection: each live entry
ranked by count on its packed (key, id) value (the key's order-preserving
code, -0.0 as +0.0, over INT_MAX - id), equal values (a row listed twice) by
slot, the best k written in rank order and +/-inf, -1 past them.

Tolerances: the model's IP keys are the kernel's bit for bit (the card test
``test_rescore_topk_routes_match_plain`` holds them there); against the
plain version, which sums in another order, distances rtol 1e-5, atol 1e-4
and ids equal but between entries within that of each other. On rows and
queries of small integers every sum is exact, and the model's selection
equals the plain version's bit for bit: ties, duplicates, NaN and +/-inf
rows, k above the live slots.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import scan
from test_torch_cuda_kernels import fmaf32

INT_MAX = 2**31 - 1
F32 = np.float32


def fma(a, b, c) -> np.ndarray:
    """fmaf on float32 arrays, non-finite operands as IEEE has them."""
    a, b, c = (np.ascontiguousarray(v, dtype=F32) for v in np.broadcast_arrays(a, b, c))
    with np.errstate(invalid="ignore", over="ignore"):
        out = (a.astype(np.float64) * b + c).astype(F32)
    fin = np.isfinite(a) & np.isfinite(b) & np.isfinite(c)
    if fin.any():
        out[fin] = fmaf32(a[fin], b[fin], c[fin])
    return out


def lane_sums(q: np.ndarray, rows: np.ndarray):
    """(q . row, |row|^2) of each row in K3's order: lane l's fmaf chain
    over d = l, l + 32, ..., then the 32 lanes' butterfly."""
    m, d = rows.shape
    ip = np.zeros((m, 32), F32)
    rs = np.zeros((m, 32), F32)
    lanes = np.arange(32)
    for j in range(-(-d // 32)):
        dd = lanes + 32 * j
        ok = dd < d
        xv = rows[:, dd[ok]]
        ip[:, ok] = fma(np.broadcast_to(q[dd[ok]], xv.shape), xv, ip[:, ok])
        rs[:, ok] = fma(xv, xv, rs[:, ok])
    with np.errstate(invalid="ignore", over="ignore"):
        for o in (16, 8, 4, 2, 1):
            ip = ip + ip[:, lanes ^ o]
            rs = rs + rs[:, lanes ^ o]
    return ip[:, 0], rs[:, 0]


def exact_keys(q: np.ndarray, rows: np.ndarray, metric: Metric) -> np.ndarray:
    """The kernel's oriented keys of the rows (IP to the bit; L2 and cosine
    in its formula's float32 operations, whose contraction the model does
    not fix), non-finite ones -inf."""
    ip, rs = lane_sums(q, rows)
    q_sq = lane_sums(q, q[None])[1][0]
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        if metric is Metric.IP:
            s = ip
        elif metric is Metric.L2:
            s = (q_sq + rs) - F32(2) * ip
            s = np.where(s < 0, F32(0), s)
        else:
            denom = np.sqrt(q_sq * rs)
            s = np.where(denom < F32(1e-30), F32(1),
                         F32(1) - ip / np.maximum(denom, F32(1e-30)))
        kv = (-s if metric.ascending else s).astype(F32)
    return np.where(np.isfinite(kv), kv, F32(-np.inf)).astype(F32)


def packed(keys: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The (key, id) entries as common.cuh pack_entry forms them."""
    u = (keys.astype(F32) + F32(0)).view(np.uint32).astype(np.uint64)
    u = np.where(u >> np.uint64(31), u ^ np.uint64(0xFFFFFFFF), u ^ np.uint64(0x80000000))
    return (u << np.uint64(32)) | (INT_MAX - ids.astype(np.int64)).astype(np.uint64)


def row_split(n_live: int, warps: int, u: int) -> list:
    """The kernel's batches: warp w scores listed rows base .. base + U - 1
    for base = w U, w U + warps U, ... Returns (warp, rows) pairs."""
    out = []
    for w in range(warps):
        for base in range(w * u, n_live, warps * u):
            out.append((w, list(range(base, min(base + u, n_live)))))
    return out


def select(keys: np.ndarray, ids: np.ndarray, k: int, ascending: bool):
    """The selection: rank by count on the packed values, equal values by
    slot; the best k in rank order, then +/-inf and -1."""
    real = keys > -np.inf
    v = packed(keys, ids)
    slots = np.nonzero(real)[0]
    rank = np.array([int(((v[real] > v[s]) | ((v[real] == v[s]) & (slots < s))).sum())
                     for s in slots], dtype=np.int64)
    d = np.full(k, np.inf if ascending else -np.inf, F32)
    out_i = np.full(k, -1, np.int64)
    for s, r in zip(slots, rank):
        if r < k:
            d[r] = -keys[s] if ascending else keys[s]
            out_i[r] = ids[s]
    return d, out_i


def rescore_model(q, x, cand_keys, cand_idx, k: int, metric: Metric, warps: int = 8, u: int = 8):
    """K3 on (B, D) queries, (N, D) rows and a (B, C) shortlist: (dists (B,
    k) f32, ids (B, k) int64)."""
    b, c = cand_idx.shape
    dists = np.zeros((b, k), F32)
    out_ids = np.zeros((b, k), np.int64)
    for r in range(b):
        live = np.nonzero(cand_keys[r] > -np.inf)[0]
        keys = np.full(c, -np.inf, F32)
        for _, rows in row_split(len(live), warps, u):
            slots = live[rows]
            keys[slots] = exact_keys(q[r], x[cand_idx[r, slots]], metric)
        dists[r], out_ids[r] = select(keys, cand_idx[r], k, metric.ascending)
    return dists, out_ids


@pytest.mark.parametrize("n_live", [0, 1, 7, 63, 64, 65, 200, 1024])
@pytest.mark.parametrize("warps,u", [(8, 8), (32, 4)])
def test_row_split_scores_each_live_slot_once(n_live, warps, u):
    rows = [r for _, batch in row_split(n_live, warps, u) for r in batch]
    assert sorted(rows) == list(range(n_live))
    assert all(len(batch) <= u for _, batch in row_split(n_live, warps, u))


def _data(seed: int, n: int, d: int, b: int, c: int, ints: bool = False):
    rng = np.random.default_rng(seed)
    if ints:  # every product and sum exact in float32
        x = rng.integers(-4, 5, size=(n, d)).astype(F32)
        q = rng.integers(-4, 5, size=(b, d)).astype(F32)
    else:
        x = rng.normal(size=(n, d)).astype(F32)
        q = rng.normal(size=(b, d)).astype(F32)
    x[10:14] = x[20]  # duplicated rows: exact ties
    x[30, 0], x[31, d - 1], x[32, 0] = np.nan, np.inf, -np.inf
    cand = rng.integers(0, n, size=(b, c)).astype(np.int32)
    cand[:, : min(c, 7)] = np.array([10, 11, 12, 20, 30, 31, 32])[: min(c, 7)]
    if c > 9:
        cand[:, 9] = cand[:, 8]  # a row listed twice
    keys = rng.normal(size=(b, c)).astype(F32)
    keys[:, c - c // 4 :] = -np.inf  # empty slots
    if b > 1:
        keys[1] = -np.inf  # an all-empty query
    return x, q, keys, cand


@pytest.mark.parametrize("metric", [Metric.IP, Metric.L2, Metric.COSINE])
@pytest.mark.parametrize("c,d,k", [(64, 128, 10), (256, 96, 10), (40, 130, 40), (300, 7, 25)])
def test_sum_order_against_plain(metric, c, d, k):
    """The model's distances within K3's tolerance of the plain version's,
    its ids the plain ones but between near-equal distances; both block
    widths the same to the bit (the sum order does not depend on the split)."""
    x, q, keys, cand = _data(c + d, 400, d, 3, c)
    got_d, got_i = rescore_model(q, x, keys, cand, k, metric)
    wide = rescore_model(q, x, keys, cand, k, metric, warps=32, u=4)
    assert np.array_equal(got_d.view(np.uint32), wide[0].view(np.uint32))
    assert np.array_equal(got_i, wide[1])
    want_d, want_i = (t.numpy() for t in scan.rescore_topk_plain(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(keys), torch.from_numpy(cand),
        k, metric))
    fin = np.isfinite(want_d)
    assert np.array_equal(fin, np.isfinite(got_d))
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=1e-5, atol=1e-4)
    tol = 1e-5 * np.abs(np.where(fin, want_d, 0)).max(axis=1) + 1e-4
    for r, j in zip(*np.nonzero(got_i != want_i)):
        at = np.nonzero(want_i[r] == got_i[r, j])[0]
        assert len(at) and abs(want_d[r, at[0]] - want_d[r, j]) <= tol[r], (r, j)


@pytest.mark.parametrize("metric", [Metric.IP, Metric.L2, Metric.COSINE])
@pytest.mark.parametrize("c,k", [(64, 10), (64, 64), (256, 200), (16, 16), (1280, 1000)])
def test_selection_exact_on_exact_sums(metric, c, k):
    """On small integers every sum is exact, so the model's keys are the
    plain version's and its selection must be too, bit for bit: ties broken
    by id, a row listed twice kept twice, NaN and +/-inf rows dropped, k
    above the live slots filled with +/-inf and -1, an all-empty query."""
    x, q, keys, cand = _data(c + k, 300, 24, 4, c, ints=True)
    got_d, got_i = rescore_model(q, x, keys, cand, k, metric)
    want_d, want_i = (t.numpy() for t in scan.rescore_topk_plain(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(keys), torch.from_numpy(cand),
        k, metric))
    assert np.array_equal(got_i, want_i)
    assert np.array_equal(got_d.view(np.uint32), want_d.view(np.uint32))
    assert (got_i[1] == -1).all() and np.isinf(got_d[1]).all()
    if k > c - c // 4:
        assert (got_i[:, c - c // 4 :] == -1).all()


@pytest.mark.parametrize("c", [1, 64, 128, 129, 256, 1024, 1025])
@pytest.mark.parametrize("b", [1, 16, 17, 256])
def test_wide_route_is_chosen_by_batch(b, c):
    """_rescore_wide: the 1,024-thread route for 129 <= C <= 1,024 at B <=
    16, where it measured ahead; else 256 threads (C <= 1,024) or the keys
    kernel and K5. The choice changes no output (the card test holds both)."""
    assert scan._rescore_wide(b, c) == (129 <= c <= 1024 and b <= 16)
    assert scan.RESCORE_SORT_MAX == 1024

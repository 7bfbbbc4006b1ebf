"""A model of K9's fused pass (csrc/elementwise_scores.cu,
``lt_elementwise_topc``) in numpy, held to the plain chain and to the JAX
package on the CPU.

The model runs the kernel's plan: the route by B and metric gives the tile's
rows (TM) and queries (TN); the spans are sized from B so that the grid is
one wave of the blocks the card holds (at an assumed occupancy here; the
card's own comes from the kernel) and spans x C stays at most an eighth of
N. Each block walks its span a tile of rows at a time in ascending row
order and offers each (row, query) key to its query's list: the packed
(key, id) entry joins the pending ones only if it is strictly larger than
the threshold, the C-th kept entry or (-inf, INT_MAX) while fewer are kept,
so masked rows' -inf keys join in id order; after a tile, a list that could
not take another tile merges its pending entries into the kept ones
(WarpTopk's flush: the best kp of both, kept = min(kept + pending, C), the
threshold raised once C are kept). Each span writes its best C, (-inf,
INT_MAX) past the kept ones; K5 merges the spans' sorted runs.

The model's keys are K6c's over the centred bf16 copy with the mean added
back in f32, each pair's terms added in dimension order with the kernel's
rounded f32 operations (metrics.cuh accumulate<M>).

Tolerances: the model's selection equals ``topk_select_plain`` over the
model's own keys bit for bit (keys and ids). Its keys against
``metric_keys_plain(..., mean=)`` (the same terms summed in PyTorch's order):
Chebyshev equal (a max of exact terms), the others rtol 1e-5, atol 1e-5 x
the largest key (K6c's tolerance). Against the JAX package's
``bf16_flat_topk`` at the same C: the keys of the rows both return within
that tolerance, and a row only one returns lies within twice it of the C-th
key (a near-tie); Chebyshev equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops.scan import bf16_flat_topk
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import scan, topk

KPEND = 256  # common.cuh WarpTopk's pending entries
INT_MAX = 2**31 - 1
PAD = np.uint64(0x007FFFFF00000000)  # pack(-inf, INT_MAX)
SMS, RESIDENT = 132, 2  # the plan's arithmetic at an assumed occupancy
METRICS = [Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS]


def route(metric: Metric, b: int, vec: bool = True):
    """topc_route: the fused tile's (rows, queries) for this batch: the
    bytes route to B = 16 (Canberra 8), Chebyshev's FMA route past it; the
    other metrics select from the 64-row tile's keys with K5 there."""
    bytes_max = 8 if metric is Metric.CANBERRA else 16
    if vec and b <= bytes_max:
        return 128, next(qb for qb in (1, 4, bytes_max) if b <= qb)
    assert metric is Metric.CHEBYSHEV
    return 128, 64 if b <= 64 else 128


def plan(b: int, n: int, c: int, tm: int, tn: int, resident: int = RESIDENT, sms: int = SMS):
    """topc_run's grid: (groups, spans, span_rows)."""
    groups = -(-b // tn)
    tiles = -(-n // tm)
    most = max(1, n // (8 * c))
    wave = max(1, resident * sms // groups)
    want = max(1, min(tiles, most, wave))
    span_rows = -(-tiles // want) * tm
    return groups, -(-n // span_rows), span_rows


def bf16_rows(x: np.ndarray, mean: np.ndarray) -> np.ndarray:
    """The centred bf16 copy's values as float32 (round to nearest even)."""
    return torch.from_numpy(x - mean).to(torch.bfloat16).to(torch.float32).numpy()


def model_keys(q: np.ndarray, x16f: np.ndarray, mean: np.ndarray, valid: np.ndarray,
               metric: Metric) -> np.ndarray:
    """(B, N) keys: x16 + mean (one rounded f32 add), then each pair's terms
    in dimension order, each f32 operation rounded, the distance negated and
    masked (NaN and masked rows -inf)."""
    xf = (x16f + mean[None, :]).astype(np.float32)
    b, n = q.shape[0], xf.shape[0]
    a = np.zeros((b, n), np.float32)
    den = np.zeros((b, n), np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for d in range(q.shape[1]):
            u, v = q[:, d][:, None], xf[:, d][None, :]
            diff = np.abs(u - v)
            if metric is Metric.L1:
                a = a + diff
            elif metric is Metric.CHEBYSHEV:
                a = np.where((diff > a) | np.isnan(diff), diff, a)
            elif metric is Metric.CANBERRA:
                s = np.abs(u) + np.abs(v)
                term = diff / np.maximum(s, np.float32(1e-45))
                a = a + np.where(s == 0, np.float32(0.0), term).astype(np.float32)
            else:
                a = a + diff
                den = den + np.abs(u + v)
        if metric is Metric.BRAY_CURTIS:
            ratio = a / np.maximum(den, np.float32(1e-45))
            a = np.where(den == 0, np.where(a == 0, np.float32(0.0), np.float32(np.inf)), ratio)
    keys = (-a).astype(np.float32)
    return np.where(valid[None, :] & ~np.isnan(keys), keys, np.float32(-np.inf))


def pack(key: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """common.cuh pack_entry: an order-preserving code of the key (-0 folded
    into +0), then INT_MAX - id."""
    u = (np.asarray(key, np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    u = np.where(u >> np.uint64(31), u ^ np.uint64(0xFFFFFFFF), u ^ np.uint64(0x80000000))
    return (u << np.uint64(32)) | (np.uint64(INT_MAX) - np.asarray(ids, np.uint64))


def unpack(v: np.ndarray):
    u = (v >> np.uint64(32)).astype(np.uint32)
    u = np.where(u >> np.uint32(31), u ^ np.uint32(0x80000000), ~u).astype(np.uint32)
    return u.view(np.float32), (INT_MAX - (v & np.uint64(0xFFFFFFFF)).astype(np.int64)).astype(
        np.int32)


class ModelList:
    """One query's list over one span (WarpTopk with an unwritten start)."""

    def __init__(self, c: int):
        self.c, self.kp = c, max(8, 1 << (c - 1).bit_length())
        self.kept, self.thr = 0, PAD
        self.entries = np.full(self.kp, PAD, np.uint64)
        self.pending: list = []
        self.flushes = 0

    def offer(self, v: np.ndarray) -> None:
        self.pending.extend(v[v > self.thr].tolist())  # a strict '>'
        assert len(self.pending) <= KPEND

    def flush(self) -> None:
        if not self.pending:
            return
        held = self.entries if self.kept > 0 else np.full(self.kp, PAD, np.uint64)
        both = np.concatenate([held, np.array(self.pending, np.uint64)])
        self.entries = np.sort(both)[::-1][: self.kp]
        self.kept = min(self.kept + len(self.pending), self.c)
        self.pending = []
        self.flushes += 1
        if self.kept == self.c:
            self.thr = self.entries[self.c - 1]

    def out(self) -> np.ndarray:
        return np.where(np.arange(self.c) < self.kept, self.entries[: self.c], PAD)


def model_topc(keys: np.ndarray, c: int, tm: int, tn: int, span_rows: int, stats=None):
    """The fused pass's selection over ``keys`` (B, N): each span's lists,
    written (B, spans * C), then K5's merge of the sorted runs."""
    b, n = keys.shape
    spans = -(-n // span_rows)
    out = np.empty((b, spans * c), np.uint64)
    for s in range(spans):
        lo, hi = s * span_rows, min(n, (s + 1) * span_rows)
        lists = [ModelList(c) for _ in range(b)]
        for t0 in range(lo, hi, tm):
            t1 = min(hi, t0 + tm)
            v = pack(keys[:, t0:t1], np.arange(t0, t1)[None, :].repeat(b, 0))
            for j in range(b):
                lists[j].offer(v[j])
            for lst in lists:  # after the tile's barrier
                if len(lst.pending) > KPEND - tm:
                    lst.flush()
        for j, lst in enumerate(lists):
            lst.flush()
            out[j, s * c : (s + 1) * c] = lst.out()
            if stats is not None:
                stats.append(lst.flushes)
    k, i = unpack(out)
    runs_k, runs_i = torch.from_numpy(k.copy()), torch.from_numpy(i.copy())
    if spans == 1:
        return runs_k, runs_i
    return topk.merge_runs(runs_k, runs_i, c)  # the plain version on the CPU


def corpus(rng, n: int, d: int, ties: bool = False):
    """Rows and queries; ``ties``: small integers (every L1 / Chebyshev
    distance an integer, many equal keys)."""
    if ties:
        x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        q = rng.integers(-3, 4, size=(20, d)).astype(np.float32)
    else:
        x = (rng.normal(size=(n, d)) + 0.3).astype(np.float32)
        q = rng.normal(size=(20, d)).astype(np.float32)
    mean = x.mean(0).astype(np.float32)
    return x, q, mean


def assert_bits(got, want):
    gk, gi = got
    wk, wi = want
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(gk.numpy().view(np.int32), wk.numpy().view(np.int32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b, c, n, d", [(1, 1, 3000, 24), (3, 80, 3000, 24), (9, 500, 2000, 16),
                                        (17, 2000, 2000, 8), (40, 64, 2500, 40)])
def test_model_selection_matches_topk(metric, b, c, n, d):
    """The plan's selection over the model's keys equals K5's plain top C
    bit for bit: C = 1, C past a span's rows, C = N, a 40% mask with a run
    of masked rows, on each route's tile shape."""
    if metric is not Metric.CHEBYSHEV:  # fused to B = 16 (Canberra 8)
        b = min(b, 8 if metric is Metric.CANBERRA else 16)
    rng = np.random.default_rng(b * 7 + c)
    x, q, mean = corpus(rng, n, d)
    valid = rng.random(n) < 0.6
    valid[:150] = False
    keys = model_keys(q[:b], bf16_rows(x, mean), mean, valid, metric)
    tm, tn = route(metric, b)
    _, _, span_rows = plan(b, n, c, tm, tn)
    got = model_topc(keys, c, tm, tn, span_rows)
    assert_bits(got, topk.topk_select_plain(torch.from_numpy(keys), c))


@pytest.mark.parametrize("metric", METRICS)
def test_model_ties_all_masked_and_small_spans(metric):
    """Integer rows (ties by the hundred: the lower row first), every row
    masked (the lowest ids at -inf), and spans of one tile each."""
    rng = np.random.default_rng(4)
    x, q, mean = corpus(rng, 1500, 12, ties=True)
    x16f = bf16_rows(x, mean)
    for valid in (np.ones(1500, bool), np.zeros(1500, bool)):
        keys = model_keys(q[:5], x16f, mean, valid, metric)
        for c, span_rows in ((10, 128), (64, 256), (300, 1500)):
            got = model_topc(keys, c, 128, 8, span_rows)
            assert_bits(got, topk.topk_select_plain(torch.from_numpy(keys), c))
        if not valid.any():
            assert np.array_equal(got[1].numpy(), np.tile(np.arange(300, dtype=np.int32), (5, 1)))


@pytest.mark.parametrize("b, n, c", [(1, 1_000_000, 256), (16, 1_000_000, 256),
                                     (256, 1_000_000, 256), (16, 1_000_000, 80),
                                     (256, 5000, 1000), (3, 100, 100), (70, 20_000_000, 1024)])
@pytest.mark.parametrize("metric", [Metric.L1, Metric.CANBERRA, Metric.BRAY_CURTIS])
def test_plan_spans(metric, b, n, c):
    """Spans cover the rows in whole tiles, the grid is at most one wave, and
    spans x C stays at most an eighth of N (one span where C > N / 8)."""
    if metric is not Metric.CHEBYSHEV:
        b = min(b, 8 if metric is Metric.CANBERRA else 16)
    tm, tn = route(metric, b)
    groups, spans, span_rows = plan(b, n, c, tm, tn)
    assert span_rows % tm == 0 and (spans - 1) * span_rows < n <= spans * span_rows
    assert groups * spans <= max(RESIDENT * SMS, groups)
    assert spans * c <= max(n // 8, c)


def test_flushes_are_few_after_the_first_tiles():
    """Each span's list merges about C ln(span / C) entries: with a
    threshold, most of a long span's rows are one compare."""
    rng = np.random.default_rng(9)
    keys = rng.normal(size=(4, 60_000)).astype(np.float32)
    flushes = []
    model_topc(keys, 256, 128, 4, 30_000, flushes)
    # 2 x 30,000 rows a query: the fill (2 tiles), then ~C ln(117) ~ 1,200
    # entries, a flush each 129-256
    assert max(flushes) <= 16


@pytest.mark.parametrize("metric", METRICS)
def test_model_keys_match_plain(metric):
    """The model's keys (dimension order) against metric_keys_plain's."""
    rng = np.random.default_rng(2)
    x, q, mean = corpus(rng, 2000, 40)
    x16f = bf16_rows(x, mean)
    valid = rng.random(2000) < 0.9
    got = model_keys(q, x16f, mean, valid, metric)
    x16 = torch.from_numpy(x - mean).to(torch.bfloat16)
    want = scan.metric_keys_plain({"x": torch.from_numpy(q)}, {"x": x16}, torch.from_numpy(valid),
                                  metric, mean=torch.from_numpy(mean)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if metric is Metric.CHEBYSHEV:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[fin]).max())


def test_wrapper_on_cpu_is_the_plain_chain():
    """elementwise_topc on CPU tensors is the plain chain: the keys of
    metric_keys_plain(..., mean=) and K5's plain top C."""
    rng = np.random.default_rng(6)
    x, q, mean = corpus(rng, 1000, 16)
    x16 = torch.from_numpy(x - mean).to(torch.bfloat16)
    valid = torch.from_numpy(rng.random(1000) < 0.8)
    qt, mt = torch.from_numpy(q[:4]), torch.from_numpy(mean)
    got = scan.elementwise_topc(qt, x16, mt, valid, Metric.L1, 50)
    want = topk.topk_select_plain(
        scan.metric_keys_plain({"x": qt}, {"x": x16}, valid, Metric.L1, mean=mt), 50)
    assert_bits(got, want)
    # with a start: the entries at or above it, then (-inf, -1)
    start = got[0][:, 20].contiguous()
    keys, ids = scan.elementwise_topc(qt, x16, mt, valid, Metric.L1, 50, start=start)
    real = keys >= start[:, None]
    assert torch.equal(real, got[0] >= start[:, None])
    assert torch.equal(ids[real], got[1][real]) and torch.equal(keys[real], got[0][real])
    assert bool((ids[~real] == -1).all()) and bool(torch.isneginf(keys[~real]).all())
    with pytest.raises(ValueError):
        scan.elementwise_topc(qt, x16, mt, valid, Metric.L1, 1001)
    with pytest.raises(ValueError):
        scan.elementwise_topc(qt, x16, mt, valid, Metric.L2, 5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("ties", [False, True])
def test_model_against_jax(metric, ties):
    """The model's (keys, ids) against the JAX package's bf16_flat_topk at
    the same C (its chunked top C and merge), 10% of the rows masked."""
    rng = np.random.default_rng(11 + ties)
    n, d, b, c = 3000, 24, 6, 64
    x, q, mean = corpus(rng, n, d, ties)
    x16f = bf16_rows(x, mean)
    valid = np.arange(n) % 10 != 3
    keys = model_keys(q[:b], x16f, mean, valid, metric)
    tm, tn = route(metric, b)
    gk, gi = (t.numpy() for t in model_topc(keys, c, tm, tn, plan(b, n, c, tm, tn)[2]))
    jd, ji = bf16_flat_topk(jnp.asarray(q[:b]), jnp.asarray(x - mean, dtype=jnp.bfloat16),
                            jnp.asarray(mean), jnp.asarray(valid), metric=JMetric[metric.name],
                            k=c, chunk=1024)
    jk, ji = -np.asarray(jd, np.float32), np.asarray(ji)
    if metric is Metric.CHEBYSHEV:
        np.testing.assert_array_equal(gk, jk)
        np.testing.assert_array_equal(gi, ji)
        return
    scale = np.abs(keys[np.isfinite(keys)]).max()
    tol = 1e-5 * scale
    for r in range(b):
        both = np.intersect1d(gi[r], ji[r])
        kg = dict(zip(gi[r].tolist(), gk[r].tolist()))
        kj = dict(zip(ji[r].tolist(), jk[r].tolist()))
        for i in both.tolist():
            assert abs(kg[i] - kj[i]) <= tol + 1e-5 * abs(kj[i]), (r, i)
        kth = gk[r, -1]
        for i in set(gi[r].tolist()) ^ set(ji[r].tolist()):
            k = keys[r, i]
            assert abs(k - kth) <= 2 * tol, (r, i, k, kth)

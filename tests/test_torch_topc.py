"""K2's fused first pass (``scan.bf16_centered_topc``) and K5's span
threshold select, on the CPU.

Two parts:

  * the port's plain route of the fused pass against the JAX package's
    ``bf16_pass_ids`` and ``masked_top_c(_bf16_scores(...))`` on the same
    staged copies (both packages stage a bit-identical centred bf16 copy),
    under IP, L2 and cosine, with tombstones, filters and duplicated rows;
  * a plain Python model of the kernels' two-level selection (each span of
    a row offers its entries in rounds of 128 to a warp's list, whose
    pending entries keep every entry better than its k-th best kept so far
    and are merged into the kept ones before they could overflow; the list
    pads to k; the spans' lists then go through the same select in ids mode
    until one span is left), held bit for bit against
    ``topk_select_plain`` / ``bf16_centered_topc_plain``: heavy ties, NaN,
    wholly masked spans, rows not a multiple of the span, C greater than a
    span, C = N, k of 1, 256, 1,024 and 4,096, and the kernels' own plans.

Tolerances: keys against the JAX package's within 1e-5 |q - m| |x - m| +
1e-5 (cosine: over its denominator), the bound of K2 (the bf16 products are
exact in f32; only the summation order differs); ids the same set except
for rows whose key lies within that tolerance of the C-th key, and the
same at each position except between keys within it. The model is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lynsedb_tpu.ops.scan as jax_scan
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu.ops.topk import masked_top_c
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import scan, topk
from lynsedb_tpu_torch.ops.scan import DeviceCorpus

DIM, N = 24, 9000
METRICS = ("ip", "l2", "cosine")
INT_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def staged():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(N, DIM)).astype(np.float32) + 0.3
    x[N // 2 : N // 2 + 60] = x[:60]  # duplicated rows: exact ties broken by id
    q = rng.normal(size=(17, DIM)).astype(np.float32)
    q[2] = x[7]  # its best rows are a duplicated pair
    tombs = rng.random(N) < 0.05
    jc, tc = jax_scan.DeviceCorpus(DIM), DeviceCorpus(DIM, device="cpu")
    for c in (jc, tc):
        c.append(x)
        c.set_tombstones(tombs)
        c.finalize()
    masks = {"none": None, "half": rng.random(N) < 0.5, "few": np.isin(np.arange(N), [4, 900, 8999])}
    return jc, tc, q, masks


def _tol(tc: DeviceCorpus, q: np.ndarray, metric: Metric) -> np.ndarray:
    """(B, cap) K2's key bound at each row."""
    aux = tc.bf16_aux()
    qc = q - aux["mean"].numpy()[None, :]
    tol = 1e-5 * np.linalg.norm(qc, axis=1)[:, None] * np.sqrt(aux["xc_sq"].numpy())[None, :] + 1e-5
    if metric is Metric.COSINE:
        den = np.sqrt((q * q).sum(1)[:, None] * aux["xsq_true"].numpy()[None, :])
        tol = tol / np.maximum(den, 1e-30)
    return tol


def _assert_near(got_k, got_i, want_k, want_i, tol):
    """The same empty slots, keys within tol at each position, positions
    swapped only between keys within tol, and ids the same set except for
    rows within tol of the C-th key."""
    np.testing.assert_array_equal(got_i < 0, want_i < 0)
    live = want_i >= 0
    for r in range(got_k.shape[0]):
        t = tol[r].max()
        np.testing.assert_allclose(got_k[r][live[r]], want_k[r][live[r]], rtol=0, atol=t)
        for c in np.nonzero((got_i[r] != want_i[r]) & live[r])[0]:
            j = np.nonzero(want_i[r] == got_i[r, c])[0]
            if len(j):
                assert abs(want_k[r, j[0]] - want_k[r, c]) <= 2 * t, (r, c)
            else:  # left the other's list: it sits at the C-th key
                assert abs(got_k[r, c] - want_k[r][live[r]][-1]) <= 2 * t, (r, c)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("filt", ["none", "half", "few"])
@pytest.mark.parametrize("b,c", [(1, 64), (17, 256)])
def test_topc_plain_matches_bf16_pass_ids(staged, metric, filt, b, c):
    """The port's fused first pass (its CPU route) returns the JAX package's
    bf16_pass_ids shortlist: the same ids, -1 in the same empty slots."""
    jc, tc, q, masks = staged
    m, jm = Metric(metric), JaxMetric(metric)
    mask = masks[filt]
    keys, ids = scan.bf16_centered_topc(torch.from_numpy(q[:b]), tc._dev16, tc.bf16_aux(),
                                        tc.valid_mask(mask), m, c)
    want_ids = np.asarray(jax_scan.bf16_pass_ids(jnp.asarray(q[:b]), jc._dev16, jc.bf16_aux(),
                                                 jc.valid_mask(mask), metric=jm, k=c,
                                                 ascending=jm.ascending))
    scores = jax_scan._bf16_scores(jnp.asarray(q[:b]), jc._dev16, jc.bf16_aux(), jm)
    wd, _ = masked_top_c(scores, c, jm.ascending, jc.valid_mask(mask))
    want_keys = -np.asarray(wd) if jm.ascending else np.asarray(wd)
    _assert_near(keys.numpy(), ids.numpy(), want_keys, want_ids, _tol(tc, q[:b], m))
    if filt == "few":  # fewer live rows than C: the tail is (-inf, -1)
        assert (ids.numpy() >= 0).sum(1).max() <= 3
        assert np.isneginf(keys.numpy()[ids.numpy() < 0]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_topc_plain_is_the_scores_top_c(staged, metric):
    """bf16_centered_topc_plain is topk_select_plain over the plain keys,
    with -1 where the key is -inf; C = N and C = 1 included."""
    _, tc, q, masks = staged
    m = Metric(metric)
    qt, valid = torch.from_numpy(q[:3]), tc.valid_mask(masks["half"])
    full = scan.bf16_centered_scores_plain(qt, tc._dev16, tc.bf16_aux(), valid, m)
    for c in (1, 100, tc.capacity):
        keys, ids = scan.bf16_centered_topc(qt, tc._dev16, tc.bf16_aux(), valid, m, c)
        wk, wi = topk.topk_select_plain(full, c)
        assert torch.equal(keys, wk)
        assert torch.equal(ids, torch.where(wk > float("-inf"), wi, -1))
    with pytest.raises(ValueError):
        scan.bf16_centered_topc(qt, tc._dev16, tc.bf16_aux(), valid, m, tc.capacity + 1)


# ── a plain model of the kernels' span threshold select ──────────────────


def _next_pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _better(ka, ia, kb, ib):
    return (ka > kb) | ((ka == kb) & (ia < ib))


def _span_select(keys, ids, k, start, rnd=128, pend_cap=256):
    """One warp's WarpTopk over one span: rounds of ``rnd`` offers in order;
    an entry joins the pending ones if it beats the threshold (``start``
    while fewer than k are kept, else the k-th kept); the pending entries
    are merged into the kept ones before a round could overflow them and at
    the end. Returns the best k sorted, padded with (-inf, INT_MAX)."""
    thr_k, thr_i = start
    kk = np.empty(0, np.float32)
    ki = np.empty(0, np.int64)
    pk, pi = [], []

    def flush(kk, ki):
        allk = np.concatenate([kk] + pk)
        alli = np.concatenate([ki] + pi)
        order = np.lexsort((alli, -allk.astype(np.float64)))[:k]
        pk.clear()
        pi.clear()
        return allk[order], alli[order]

    for r0 in range(0, len(keys), rnd):
        if sum(len(x) for x in pk) > pend_cap - rnd:
            kk, ki = flush(kk, ki)
            if len(kk) == k:
                thr_k, thr_i = kk[-1], ki[-1]
        ks, is_ = keys[r0 : r0 + rnd], ids[r0 : r0 + rnd]
        ks = np.where(np.isnan(ks), -np.inf, ks).astype(np.float32)
        keep = _better(ks, is_, thr_k, thr_i)
        pk.append(ks[keep])
        pi.append(is_[keep])
        assert sum(len(x) for x in pk) <= pend_cap
    kk, ki = flush(kk, ki)
    pad = k - len(kk)
    return (np.concatenate([kk, np.full(pad, -np.inf, np.float32)]),
            np.concatenate([ki, np.full(pad, INT_MAX, np.int64)]))


def _select_spans(rows: int, n: int, k: int, wave: int = 2 * 8 * 132) -> tuple[int, int]:
    """topk_select.cu select_spans: (spans, span length) for a card that
    holds ``wave`` warps at once."""
    most = max(1, n // max(16 * k, 2048))
    count = max(1, min(most, wave // rows))
    length = (-(-n // count) + 3) // 4 * 4
    return -(-n // length), length


def _k5_model(keys: np.ndarray, k: int, ids=None, span=None):
    """topk_select.cu's select path: levels of per-span selects, each level
    in ids mode over the last one's lists, until one span is left.
    ``span``: the first level's span length (else the kernel's plan, as
    every later level takes)."""
    b, n = keys.shape
    ids = np.broadcast_to(np.arange(n), (b, n)) if ids is None else ids
    while True:
        spans, length = _select_spans(b, n, k) if span is None else (-(-n // span), span)
        span = None
        outs = [[_span_select(keys[r, s * length : (s + 1) * length],
                              ids[r, s * length : (s + 1) * length], k, (-np.inf, INT_MAX))
                 for s in range(spans)] for r in range(b)]
        keys = np.stack([np.concatenate([o[0] for o in row]) for row in outs])
        ids = np.stack([np.concatenate([o[1] for o in row]) for row in outs])
        if spans == 1:
            return keys, ids
        n = keys.shape[1]


def _fused_model(keys: np.ndarray, c: int, span: int):
    """bf16_centered_topc.cu: each span's rows in id order, a tile of 128 a
    round, offered from the (-inf, -1) start (masked rows and NaN never
    join), lists padded with (-inf, -1), then K5's ids mode over the spans'
    lists."""
    b, n = keys.shape
    lists_k, lists_i = [], []
    for r in range(b):
        rk, ri = [], []
        for s0 in range(0, n, span):
            lk, li = _span_select(keys[r, s0 : s0 + span], np.arange(s0, min(n, s0 + span)), c,
                                  (-np.inf, -1))
            li = np.where(np.isneginf(lk), -1, li)
            rk.append(lk)
            ri.append(li)
        lists_k.append(np.concatenate(rk))
        lists_i.append(np.concatenate(ri))
    lk, li = np.stack(lists_k), np.stack(lists_i)
    if lk.shape[1] == c:
        return lk, li
    return _k5_model(lk, c, ids=li)


def _tie_keys(rng, b, n, masked_spans=()):
    keys = np.round(rng.normal(size=(b, n)), 1).astype(np.float32)  # many exact ties
    keys[rng.random((b, n)) < 0.05] = -np.inf
    keys[rng.random((b, n)) < 0.01] = np.nan
    for lo, hi in masked_spans:
        keys[:, lo:hi] = -np.inf
    return keys


_K5_CASES = [  # (b, n, k, span or None for the kernel's plan)
    (2, 20_000, 1, None), (2, 20_000, 256, None), (1, 30_001, 1024, None),
    (1, 40_000, 4096, None), (3, 9_000, 256, 2048), (2, 5_000, 1024, 1500),
    (2, 3_000, 3_000, None), (1, 4_097, 4_096, 1024), (2, 10_000, 700, 600),
    (1, 100, 100, 8), (4, 50, 7, 12), (300, 64, 3, None),
]


@pytest.mark.parametrize("b,n,k,span", _K5_CASES)
def test_k5_model_equals_plain(b, n, k, span):
    """K5's one-read select (the model) is topk_select_plain bit for bit:
    ties to the lower column, NaN as -inf, -inf entries kept with their
    columns, spans shorter than k, k = N."""
    keys = _tie_keys(np.random.default_rng(n + k), b, n)
    got_k, got_i = _k5_model(keys, k, span=span)
    want_k, want_i = topk.topk_select_plain(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())


@pytest.mark.parametrize("k", [1, 256, 1024, 4096])
def test_k5_model_ids_mode_equals_plain(k):
    """K5 in ids mode (the caller's ids break ties and come back), over
    lists that carry many (-inf, -1) entries, as the fused pass's are."""
    rng = np.random.default_rng(k)
    keys = _tie_keys(rng, 2, 12_000)
    ids = np.stack([rng.permutation(1 << 20)[:12_000] for _ in range(2)]).astype(np.int64)
    ids[keys == -np.inf] = -1
    got_k, got_i = _k5_model(keys, k, ids=ids)
    want_k, want_i = topk.topk_select_plain(torch.from_numpy(keys), k,
                                            ids=torch.from_numpy(ids.astype(np.int32)))
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())


_FUSED_CASES = [  # (b, n, c, span, masked column ranges)
    (2, 9_000, 256, 1024, ()), (3, 9_000, 64, 3840, [(0, 3840)]),
    (2, 5_000, 1024, 640, [(1000, 2600)]), (1, 4_095, 4_095, 1280, ()),
    (2, 3_000, 300, 128, [(128, 1024)]), (1, 257, 1, 128, ()),
    (2, 20_000, 4096, 5120, ()), (1, 6_000, 256, 6_016, [(0, 5_990)]),
]


@pytest.mark.parametrize("b,n,c,span,masked", _FUSED_CASES)
def test_fused_model_equals_plain(b, n, c, span, masked):
    """K2's two-level selection (per-span lists from strict thresholds over
    rows in id order, then K5's ids merge) is bf16_centered_topc_plain's
    answer bit for bit: heavy ties, NaN, wholly masked spans, N not a
    multiple of the span, C greater than a span, C = N."""
    keys = _tie_keys(np.random.default_rng(n + c), b, n, masked)
    got_k, got_i = _fused_model(keys, c, span)
    want_k, want_i = topk.topk_select_plain(torch.from_numpy(keys), c)
    want_i = torch.where(want_k > float("-inf"), want_i, -1)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())


def _topc_plan(b: int, n: int, c: int, per_sm: int, sms: int = 132) -> tuple[int, int, int]:
    """bf16_centered_topc.cu plan_for on a card that holds ``per_sm`` blocks
    an SM: (queries a block, spans, span rows)."""
    kp = max(8, _next_pow2(c))

    def smem(ql):  # the ring, the score tile, the lists
        qn = -(-ql // 8) * 8
        return 3 * (128 + qn) * 72 * 2 + qn * 132 * 4 + ql * (kp + 256) * 8

    ql = min(b, 32, max(8, -(-(-(-b // 8)) // 8) * 8))
    while ql > 0 and smem(ql) > 225 * 1024:
        ql -= 1
    if ql == 0:
        ql = min(b, 8)
    groups = -(-b // ql)
    spans = max(1, min(max(1, n // (8 * c)), per_sm * sms // groups))
    rows = -(-(-(-n // spans)) // 128) * 128
    return ql, -(-n // rows), rows


@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("b,n,c", [(1, 1_000_000, 256), (16, 1_000_000, 256),
                                   (256, 1_000_000, 256), (16, 1_000_000, 1280),
                                   (1, 1_000_000, 4000), (2, 100_000, 20_000), (7, 4_097, 1024)])
def test_plans_cut_the_work(b, n, c, per_sm):
    """The kernels' plans at the main path's shapes: the fused pass is one
    wave of the blocks the card holds (never a partial second one), its
    spans keep at most an eighth of N, and every level of K5's merge is one
    wave of warps, keeps at most a sixteenth of its input and ends in one
    span."""
    ql, spans, rows = _topc_plan(b, n, c, per_sm)
    assert 1 <= ql <= 32 and spans * rows >= n > (spans - 1) * rows
    assert spans * c <= max(c, n // 8)
    assert -(-b // ql) * spans <= max(-(-b // ql), per_sm * 132)
    m, levels = spans * c, 0
    while c <= 1024:  # a larger C merges by sort and merge
        count, _ = _select_spans(b, m, c)
        assert b * count <= max(b, 2 * 8 * 132)
        levels += 1
        if count == 1:
            break
        assert count * c <= m // 16
        m = count * c
    assert levels <= 3


@pytest.mark.parametrize("runs,r", [(1, 64), (5, 100), (33, 256), (2, 1)])
def test_merge_runs_cpu_route(runs, r):
    """K5 over sorted runs on the CPU is topk_select_plain in ids mode, and
    refuses ids that are not int32, not shaped like the keys, or rows that
    are not whole runs."""
    rng = np.random.default_rng(runs + r)
    keys = np.round(rng.normal(size=(3, runs, r)), 1).astype(np.float32)
    ids = rng.permutation(1 << 20)[: 3 * runs * r].reshape(3, runs, r).astype(np.int32)
    order = np.lexsort((ids, -keys), axis=2)
    kt = torch.from_numpy(np.take_along_axis(keys, order, 2).reshape(3, -1))
    it = torch.from_numpy(np.take_along_axis(ids, order, 2).reshape(3, -1))
    got, want = topk.merge_runs(kt, it, r), topk.topk_select_plain(kt, r, it)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        topk.merge_runs(kt, it.long(), r)
    if r > 1:
        with pytest.raises(ValueError):
            topk.merge_runs(kt[:, 1:], it[:, 1:], r)

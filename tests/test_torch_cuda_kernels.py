"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel's wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors; here both run on the same CUDA inputs at small shapes.
CUDA kernels have no interpret mode, so these tests are marked ``cuda`` and
skip without a card; ``python3 chip_smoke.py`` repeats the comparisons at the
main path's full shapes.

Tolerances: K5 (selection, and its merge of sorted runs) exact, at any k; K1, K3 and ivf_scan_blocks
distances rtol=1e-5, atol=1e-4 (f32 sums in another order; ivf_scan_blocks's rows
and tile routes equal to the bit, both summing in dimension order); K9's fused keys
K6c's tolerance of the plain keys of their rows, its ids the plain top C's
but at near-ties of the C-th key (Chebyshev equal); K2 (the fused
first pass) keys |d| <= 1e-5 * |qc| * |xc| + 1e-5 at the same row id (a
bf16 product is exact in f32, only the tensor cores' summation order
differs); its ids the plain version's set, except for rows whose plain key
lies within twice that tolerance of the plain C-th key; K3's ids identical
except between entries whose plain keys lie within its tolerance. kmeans_assign: ids equal except where a
row's two best centroids lie within 1e-5 relative; kmeans_update: sums
rtol=1e-5, atol=1e-4, counts exact, two runs bit-identical. K14 rtol=1e-6
(the same additions in the same order); K12 keys rtol=1e-5, atol=1e-5 (the
integer dot is exact; the epilogue's roundings may contract differently);
K13 and K11's per-query mode keys rtol=1e-5, atol=1e-4 (f32 sums in another
order); K11's shared-list tile K2's bound (the same bf16 products summed on
the tensor cores). K6b
(the binary family) and K6c's Chebyshev equal (integer counts, the same f32
operations; a max of exact terms); the other K6a / K6c distances rtol=1e-5,
atol=1e-5 x the largest (Haversine atol 1 m; Hellinger and Jensen-Shannon
on the squared distance, atol 1e-5, as their terms cancel).
"""

from __future__ import annotations

import shutil
from fractions import Fraction

import numpy as np
import pytest
import torch

import lynsedb_tpu_torch
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import graph as graph_ops
from lynsedb_tpu_torch.ops import kmeans, quantize, scan, topk
from lynsedb_tpu_torch.ops.scan import DeviceCorpus, FilterHandle

pytestmark = pytest.mark.cuda

METRICS = [Metric.IP, Metric.L2, Metric.COSINE]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tie_keys(rng, b, n):
    keys = np.round(rng.normal(size=(b, n)), 1).astype(np.float32)  # many exact ties
    keys[rng.random((b, n)) < 0.05] = -np.inf
    keys[rng.random((b, n)) < 0.01] = np.nan
    return keys


@pytest.mark.parametrize("b,n,k", [(1, 1, 1), (3, 5000, 10), (4, 20000, 256), (2, 70000, 1024),
                                   (5, 100, 100), (2, 4096, 4096 // 4), (2, 5000, 1025),
                                   (3, 70000, 1025), (2, 9000, 4096), (1, 4097, 1500),
                                   (2, 20000, 20000), (2, 3000, 3000), (70000, 16, 3),
                                   (3, 70001, 4000), (2, 4097, 4097), (16, 1_000_000, 4096),
                                   (256, 1_000_000, 256), (7, 100_003, 1),
                                   (64, 1_000_000, 4000), (1, 250_000, 4000),
                                   (16, 1_000_000, 1280), (2, 16384, 16384), (2, 16385, 16384),
                                   (3, 50_000, 16385), (1, 16386, 1025)])
def test_topk_select_matches_plain(dev, b, n, k):
    keys = torch.from_numpy(_tie_keys(np.random.default_rng(n), b, n)).to(dev)
    got_k, got_i = topk.topk_select(keys, k)
    want_k, want_i = topk.topk_select_plain(keys, k)
    torch.cuda.synchronize()
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("ids", [False, True])
def test_topk_select_large_k_signed_zeros(dev, ids):
    """K5 past k = 1,024 returns each key as it came, -0.0 kept apart from
    +0.0 in its sign (the two tie as one key: lower column or id first), as
    the plain version does."""
    rng = np.random.default_rng(5)
    keys = np.where(rng.random((3, 40_000)) < 0.5, 0.0, -0.0).astype(np.float32)
    keys[:, ::7] = rng.normal(size=keys[:, ::7].shape).astype(np.float32)
    kt = torch.from_numpy(keys).to(dev)
    it = torch.from_numpy(rng.integers(0, 30_000, size=keys.shape).astype(np.int32)).to(dev)
    for k in (1025, 6000, 16384):
        got = topk.topk_select(kt, k, ids=it if ids else None)
        want = topk.topk_select_plain(kt, k, it if ids else None)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _sorted_runs(rng, b, runs, r):
    """(B, runs * r) keys and distinct int32 ids, each run sorted best first
    (many tied keys, lower id first), some runs ending in (-inf, -1)."""
    keys = np.round(rng.normal(size=(b, runs, r)), 1).astype(np.float32)
    ids = rng.permutation(1 << 24)[: b * runs * r].reshape(b, runs, r).astype(np.int32)
    order = np.lexsort((ids, -keys), axis=2)
    keys, ids = np.take_along_axis(keys, order, 2), np.take_along_axis(ids, order, 2)
    tail = rng.integers(0, r + 1, size=(b, runs))
    tail[:, 0] = 0
    cut = np.arange(r)[None, None, :] >= (r - tail)[:, :, None]
    keys[cut], ids[cut] = -np.inf, -1
    return keys.reshape(b, runs * r), ids.reshape(b, runs * r)


@pytest.mark.parametrize("b,runs,r", [(1, 261, 256), (16, 131, 256), (3, 1, 64), (2, 5, 100),
                                      (256, 2, 256), (4, 7, 8), (2, 33, 192), (1, 2, 1)])
def test_merge_runs_matches_plain(dev, b, runs, r):
    """K5 over sorted runs (the fused pass's span lists, K8's state) equals
    topk_select_plain in ids mode, ties and (-inf, -1) tails included."""
    keys, ids = _sorted_runs(np.random.default_rng(runs * r + b), b, runs, r)
    kt, it = torch.from_numpy(keys).to(dev), torch.from_numpy(ids).to(dev)
    got = topk.merge_runs(kt, it, r)
    want = topk.topk_select_plain(kt, r, it)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assert_ids_match(got_ids, want_ids, want_keys, tol):
    """ids equal, except where the plain keys of the two swapped entries lie
    within ``tol`` of each other."""
    bad = got_ids != want_ids
    for r, c in zip(*np.nonzero(bad)):
        j = np.nonzero(want_ids[r] == got_ids[r, c])[0]
        assert len(j) and abs(want_keys[r, j[0]] - want_keys[r, c]) <= tol[r], (r, c)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_scores_f32_matches_plain(dev, metric):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(3000, 48)).astype(np.float32)).to(dev)
    x[7] = 0.0  # zero-norm row: cosine policy
    valid = torch.from_numpy(rng.random(3000) < 0.8).to(dev)
    qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
    args = (q, x, qt.get("sq"), ct.get("sq"), valid, metric)
    got, want = scan.flat_scores_f32(*args), scan.flat_scores_f32_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


_TILE_METRICS = [Metric.IP, Metric.L2, Metric.COSINE, Metric.CORRELATION, Metric.HELLINGER]


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("d,offset", [(1, 0), (7, 0), (48, 0), (128, 0), (130, 0), (128, 1)])
@pytest.mark.parametrize("b", [1, 2, 15, 16, 17, 64, 65, 256])
def test_f32_tile_routes_match_plain(dev, b, d, offset):
    """K1 and K6a's tile mode at the edges of its routes: the bytes route
    (B <= 16, the batch rounded up to 1, 2 or 16 queries), the FMA route
    (B = 17, 64, 65, 256: 32-, 64- and 128-query tiles, one and two query
    groups), 16-byte copies (D = 48, 128) and scalar loads (D = 1, 7, 130,
    and D = 128 from a base 4 bytes past 16-byte alignment); N = 2,333 (no
    multiple of a tile or a span), a 30% mask, a zero-norm row and a NaN
    row, under IP, L2, cosine (K1), correlation and Hellinger (K6a)."""
    rng = np.random.default_rng(1000 * b + 10 * d + offset)
    n = 2333
    x_np = rng.normal(size=(n, d)).astype(np.float32)
    q_np = rng.normal(size=(b, d)).astype(np.float32)
    x_np[7] = 0.0
    x_np[11, 0] = np.nan
    valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    for metric in _TILE_METRICS:
        hist = metric is Metric.HELLINGER
        x = torch.from_numpy(np.abs(x_np) if hist else x_np).to(dev)
        q = torch.from_numpy(np.abs(q_np) if hist else q_np).to(dev)
        if offset:
            x = _unaligned(x)
        qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
        if metric in METRICS:
            args = (q, x, qt.get("sq"), ct.get("sq"), valid, metric)
            got, want = scan.flat_scores_f32(*args), scan.flat_scores_f32_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(torch.isinf(got), torch.isinf(want)), metric
            assert bool(torch.isinf(got[:, 11]).all())
            fin = torch.isfinite(want)
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
        else:
            got = scan.gemm_metric_scores(qt, ct, valid, metric)
            want = scan.metric_keys_plain(qt, ct, valid, metric)
            torch.cuda.synchronize()
            _assert_keys_close(metric, got, want)


@pytest.mark.parametrize("d", [1, 4, 7, 8, 16])
@pytest.mark.parametrize("b", [17, 64, 256])
def test_f32_fma_route_one_stage_tiles(dev, b, d):
    """K1's FMA route where a row tile is a single stage of dimensions (D <=
    16 for the 32- and 64-query tiles, D <= 8 for the 128-query tile), so
    every step ends a tile and the shared score tile is rewritten at the
    next step: over 1,000,003 rows, so a block's span holds many tiles,
    under IP, L2 and cosine at rtol 1e-5, atol 1e-4."""
    rng = np.random.default_rng(10 * b + d)
    n = 1_000_003
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for metric in METRICS:
        qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
        args = (q, x, qt.get("sq"), ct.get("sq"), valid, metric)
        got, want = scan.flat_scores_f32(*args), scan.flat_scores_f32_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want)), metric
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
        del got, want, fin


def test_batch_split_on_the_card(dev, monkeypatch):
    """A batch over the score budget is split into parts, each a K2 -> K5 ->
    K3 chain; the answers equal the plain versions'."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9000, 32)).astype(np.float32)
    q = rng.normal(size=(10, 32)).astype(np.float32)
    monkeypatch.setattr(scan, "SCORE_BUDGET", 3 * 9088)  # capacity 9088: parts of 3
    results = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(32, device=device)
        corpus.append(x)
        results.append(corpus.search(q, 10, Metric.IP))
    (gd, gi), (wd, wi) = results
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)


def _aux(x_np, device):
    corpus = DeviceCorpus(x_np.shape[1], device=device)
    corpus.append(x_np)
    return corpus


def _assert_topc_close(q, x16, aux, valid, metric, c, got, want):
    """K2's fused pass against its plain version: every returned key within
    |d| <= 1e-5 |q - m| |x - m| + 1e-5 (cosine: over its denominator) of
    the plain key of the same row, keys descending, the same slots empty,
    and the ids the same set but for rows whose plain key lies within that
    tolerance of the plain C-th key."""
    full = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
    qc = q - aux["mean"][None, :]
    tol = 1e-5 * qc.norm(dim=1)[:, None] * x16.float().norm(dim=1)[None, :] + 1e-5
    if metric is Metric.COSINE:  # the bound is on the numerator; scale by the denominator
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][None, :]).clamp_min(1e-30)
    (gk, gi), (wk, wi) = got, want
    assert gk.shape == wk.shape == gi.shape == (q.shape[0], c)
    assert torch.equal(gi < 0, wi < 0) and torch.equal(gi < 0, torch.isinf(gk) & (gk < 0))
    assert bool((gk[:, :-1] >= gk[:, 1:]).all())
    live = gi >= 0
    rows = torch.where(live, gi, 0).long()
    assert bool(((gk - full.gather(1, rows)).abs() <= tol.gather(1, rows))[live].all())
    for r in range(q.shape[0]):
        got_set = set(gi[r][live[r]].tolist())
        want_set = set(wi[r][wi[r] >= 0].tolist())
        assert len(got_set) == int(live[r].sum())  # no row twice
        kth = wk[r][wi[r] >= 0][-1] if want_set else None
        for row in got_set ^ want_set:
            assert abs(float(full[r, row] - kth)) <= 2 * float(tol[r, row]), (r, row)


_TOPC_CASES = [  # (d, n, b, c): every D, N, B and C of the fused pass's routes
    (128, 100_000, 1, 256), (128, 100_000, 16, 256), (128, 100_000, 256, 256),
    (128, 100_000, 17, 1024), (128, 100_000, 7, 64), (768, 100_000, 16, 256),
    (100, 4097, 7, 1024), (3, 4095, 17, 64), (1, 4097, 1, 256), (1, 1, 1, 1),
    (768, 4095, 256, 1024), (3, 100_000, 256, 64), (100, 100_000, 1, 1024),
    (128, 4095, 16, 4095), (128, 100_000, 3, 5000), (128, 100_000, 2, 20_000),
]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d,n,b,c", _TOPC_CASES)
def test_bf16_centered_scores_matches_plain(dev, metric, d, n, b, c):
    """K2, the fused first pass (tensor-core scores and each span's top C),
    against its plain version on duplicated rows and a mask."""
    rng = np.random.default_rng(d * 7 + n)
    x = rng.normal(size=(n, d)).astype(np.float32) + 0.5
    x[n // 2 : n // 2 + min(1000, n // 4)] = x[: min(1000, n // 4)]  # duplicated rows
    corpus = _aux(x, dev)
    corpus.set_tombstones(np.arange(n) % 13 == 5)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    valid = corpus.valid_mask(rng.random(n) < 0.7)
    c = min(c, x16.shape[0])
    got = scan.bf16_centered_topc(q, x16, aux, valid, metric, c)
    want = scan.bf16_centered_topc_plain(q, x16, aux, valid, metric, c)
    torch.cuda.synchronize()
    _assert_topc_close(q, x16, aux, valid, metric, c, got, want)


def test_bf16_centered_topc_masked_spans(dev):
    """Wholly masked spans, rows past n (capacity padding) and fewer live
    rows than C: the empty slots come back (-inf, -1)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(50_000, 64)).astype(np.float32)
    corpus = _aux(x, dev)
    mask = np.zeros(50_000, bool)
    mask[[3, 17, 40_000, 49_999]] = True
    mask[20_000:20_100] = True
    valid = corpus.valid_mask(mask)
    q = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32)).to(dev)
    for c in (64, 256):
        got = scan.bf16_centered_topc(q, corpus._dev16, corpus.bf16_aux(), valid, Metric.L2, c)
        want = scan.bf16_centered_topc_plain(q, corpus._dev16, corpus.bf16_aux(), valid,
                                             Metric.L2, c)
        torch.cuda.synchronize()
        assert int((got[1] >= 0).sum(1).min()) == min(c, 104)
        _assert_topc_close(q, corpus._dev16, corpus.bf16_aux(), valid, Metric.L2, c, got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_topk_matches_plain(dev, metric):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, 96)).astype(np.float32)
    x[100:110] = x[200]  # duplicated rows: exact ties broken by id
    x32 = torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.normal(size=(9, 96)).astype(np.float32)).to(dev)
    cand = np.stack([rng.choice(5000, 300, replace=False) for _ in range(9)]).astype(np.int32)
    cand[:, :12] = np.arange(100, 112)
    keys = rng.normal(size=(9, 300)).astype(np.float32)
    keys[:, -40:] = -np.inf  # empty shortlist slots
    args = (q, x32, torch.from_numpy(keys).to(dev), torch.from_numpy(cand).to(dev), 10, metric)
    got_d, got_i = scan.rescore_topk(*args)
    want_d, want_i = scan.rescore_topk_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    wd = want_d.cpu().numpy()
    _assert_ids_match(got_i.cpu().numpy(), want_i.cpu().numpy(), wd,
                      1e-5 * np.abs(wd).max(axis=1) + 1e-4)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [2000, 20000])
@pytest.mark.parametrize("filt,k", [("half", 10), ("four_rows", 100)])
def test_device_corpus_cuda_matches_cpu(dev, metric, n, filt, k):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    if filt == "half":
        mask = rng.random(n) < 0.5
    else:  # fewer live rows than k: empty slots come back trimmed
        mask = np.zeros(n, bool)
        mask[[1, 5, 700, n - 1]] = True
    results = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(32, device=device)
        corpus.append(x)
        corpus.set_tombstones(np.arange(n) % 17 == 0)
        results.append(corpus.search(q, k, metric, filter_mask=mask))
    (gd, gi), (wd, wi) = results
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)


def test_topk_select_ids_match_plain(dev):
    """K5 with caller ids (the large-shortlist K3 path): ties go to the
    lower id, and the ids come back."""
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(_tie_keys(rng, 3, 9000)).to(dev)
    ids = torch.from_numpy(np.stack([rng.permutation(50000)[:9000] for _ in range(3)])
                           .astype(np.int32)).to(dev)
    for k in (10, 2000, 4096, 5000):
        got, want = topk.topk_select(keys, k, ids=ids), topk.topk_select_plain(keys, k, ids)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # (256, 1M) with caller ids: the fused pass's merge at its largest
    keys = torch.from_numpy(_tie_keys(rng, 256, 1_000_000)).to(dev)
    # distinct ids up to 2^30 in scrambled order (an odd multiplier is a bijection mod 2^30)
    ids = (torch.arange(1_000_000, device=dev) * 1_000_003 % (1 << 30)).to(torch.int32)
    ids = ids.expand(256, -1).contiguous()
    for k in (256, 4096):
        got, want = topk.topk_select(keys, k, ids=ids), topk.topk_select_plain(keys, k, ids)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # (16, 1,280) in ids mode: the k = 1,000 search's span merge, over 1M keys
    # and over a merge's width of sorted runs, ids tied and (-inf, -1) tails
    for n in (1_000_000, 131 * 1280):
        keys = torch.from_numpy(_tie_keys(rng, 16, n)).to(dev)
        ids = torch.from_numpy(rng.integers(-1, 4000, size=(16, n)).astype(np.int32)).to(dev)
        got, want = topk.topk_select(keys, 1280, ids=ids), topk.topk_select_plain(keys, 1280, ids)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_topk_large_shortlist_matches_plain(dev, metric):
    """C = 1,280 (search_range's default max_results) goes through K5."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20000, 64)).astype(np.float32)
    x[100:110] = x[200]
    x32 = torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(dev)
    cand = np.stack([rng.choice(20000, 1280, replace=False) for _ in range(3)]).astype(np.int32)
    cand[:, :12] = np.arange(100, 112)
    keys = rng.normal(size=(3, 1280)).astype(np.float32)
    keys[:, -100:] = -np.inf
    args = (q, x32, torch.from_numpy(keys).to(dev), torch.from_numpy(cand).to(dev), 1000, metric)
    got_d, got_i = scan.rescore_topk(*args)
    want_d, want_i = scan.rescore_topk_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    wd = want_d.cpu().numpy()
    _assert_ids_match(got_i.cpu().numpy(), want_i.cpu().numpy(), wd,
                      1e-5 * np.abs(wd).max(axis=1) + 1e-4)


@pytest.mark.parametrize("ip", [False, True])
def test_kmeans_assign_matches_plain(dev, ip):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(5000, 48)).astype(np.float32)).to(dev)
    c = x[torch.from_numpy(rng.choice(5000, 70, replace=False)).to(dev)].clone()
    c[40] = c[3]  # equal centroids: the lower index wins
    got, want = kmeans.kmeans_assign(x, c, ip), kmeans.kmeans_assign_plain(x, c, ip)
    torch.cuda.synchronize()
    scores = kmeans._ip_scores(x, c) if ip else -kmeans._l2_scores(x, c, (c * c).sum(-1))
    top2 = scores.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    assert bool(((got == want) | near).all())
    assert not bool((got == 40).any())


ASSIGN_DIMS = [1, 7, 8, 9, 15, 16, 31, 128, 129]
ASSIGN_KS = [1, 255, 256, 257, 1000]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", ASSIGN_KS)
@pytest.mark.parametrize("d", ASSIGN_DIMS)
def test_kmeans_assign_routes(dev, d, k, offset):
    """K15a's two routes (a row a thread below D = 16, the FMA tile from 16)
    at their edges, L2 and IP, on 2,053 rows (no multiple of a block) with a
    duplicated centroid (the lower index wins) and NaN rows (index 0), on
    aligned and unaligned bases (scalar loads): the plain version's index
    but where a row's two best centroids lie within 1e-5 relative."""
    rng = np.random.default_rng(d * 1000 + k)
    x = rng.normal(size=(2053, d)).astype(np.float32)
    c = x[rng.choice(len(x), k, replace=False)].copy()
    if k >= 3:
        c[k - 1] = c[1]  # equal centroids
    x[[5, 700]] = np.nan
    x[33, 0] = np.nan
    xd, cd = torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)
    if offset:
        xd, cd = _unaligned(xd), _unaligned(cd)
    for ip in (False, True):
        got, want = kmeans.kmeans_assign(xd, cd, ip), kmeans.kmeans_assign_plain(xd, cd, ip)
        torch.cuda.synchronize()
        assert int(got[5]) == int(got[700]) == int(got[33]) == 0
        scores = kmeans._ip_scores(xd, cd) if ip else -kmeans._l2_scores(xd, cd, (cd * cd).sum(-1))
        ok = torch.isfinite(scores).all(1)
        if k >= 2:
            top2 = scores.topk(2, dim=1).values
            near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
        else:
            near = torch.zeros_like(ok)
        assert bool(((got == want) | near | ~ok).all()), (d, k, ip)
        if k >= 3:
            assert not bool((got == k - 1).any())


def test_kmeans_assign_small_d_past_shared_memory(dev):
    """D < 16 whose centroids overflow the small route's shared memory (8 x
    2,500) takes the FMA tile: the plain version's index but at near-ties."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5000, 8)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(2500, 8)).astype(np.float32)).to(dev)
    got, want = kmeans.kmeans_assign(x, c, False), kmeans.kmeans_assign_plain(x, c, False)
    top2 = (-kmeans._l2_scores(x, c, (c * c).sum(-1))).topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    assert bool(((got == want) | near).all())


def test_kmeans_update_matches_plain_and_repeats(dev):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(6000, 40)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(np.arange(6000) < 5500).to(dev)
    assign = torch.from_numpy(rng.integers(0, 50, 6000).astype(np.int32)).to(dev)
    assign[assign == 7] = 8  # an empty centroid keeps its value
    c = torch.from_numpy(rng.normal(size=(50, 40)).astype(np.float32)).to(dev)
    first = kmeans.kmeans_update(x, valid, assign, c)
    second = kmeans.kmeans_update(x, valid, assign, c)
    want = kmeans.kmeans_update_plain(x, valid, assign, c)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    torch.testing.assert_close(first[0], want[0], rtol=1e-5, atol=1e-4)
    assert torch.equal(first[1], want[1])
    torch.testing.assert_close(first[2], want[2], rtol=1e-5, atol=1e-5)
    assert torch.equal(first[2][7], c[7])
    torch.testing.assert_close(first[3], want[3], rtol=1e-4, atol=1e-5)


def fmaf32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """CUDA's fmaf on float32 arrays: a * b + c rounded once, to nearest with
    ties to even. The product is exact in float64; where the float64 sum is
    not (TwoSum's error is nonzero), the float32 result is picked exactly
    among the neighbours of the rounded sum."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    t = s - c64
    err = (p - t) + (c64 - (s - t))
    out = s.astype(np.float32)
    for i in np.flatnonzero(err != 0):
        exact = Fraction(float(p.flat[i])) + Fraction(float(c64.flat[i]))
        f = out.flat[i]
        cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
        out.flat[i] = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                                int(v.view(np.uint32)) & 1))
    return out


def move_tree(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """K15b's squared moves (K,) in its move tree: 256 threads, thread t's
    fmaf sum of the squared differences over d = t, t + 256, ... in order,
    a butterfly within each warp of 32, the eight warp sums in order."""
    k, d = new.shape
    steps = -(-d // 256)
    diff = np.zeros((k, steps * 256), np.float32)
    diff[:, :d] = (new - old).astype(np.float32)
    cols = diff.reshape(k, steps, 256)
    per = np.zeros((k, 256), np.float32)
    for j in range(steps):
        per = fmaf32(cols[:, j], cols[:, j], per)
    lanes = per.reshape(k, 8, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    moves = np.zeros(k, np.float32)
    for w in range(8):
        moves = moves + lanes[:, w, 0]
    return moves


def _row_order_update(x: np.ndarray, valid: np.ndarray, assign: np.ndarray, old: np.ndarray):
    """K15b's contract on the CPU in float32: each centroid's sum over its
    valid rows in row order, one rounded add at a time; the count; the mean
    or the old centroid; the move in the kernel's move tree."""
    k, d = old.shape
    sums = np.zeros((k, d), np.float32)
    counts = np.zeros(k, np.int64)
    for r in np.nonzero(valid & (assign >= 0) & (assign < k))[0]:
        sums[assign[r]] += x[r]
        counts[assign[r]] += 1
    cnt = counts.astype(np.float32)
    new = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, np.float32(1))[:, None], old)
    new = new.astype(np.float32)
    return sums, cnt, new, move_tree(new, old)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).view(np.uint32)


UPDATE_CASES = ["mixed", "all_invalid", "k_over_valid", "skew90", "pq", "d1", "d130",
                "k_past_shared", "unaligned", "d768", "d12289"]


@pytest.mark.parametrize("case", UPDATE_CASES)
def test_kmeans_update_row_order_bits(dev, case):
    """K15b's outputs equal, to the bit, a float32 row-order sum formed on
    the CPU (and the means and moves from it), counts exact, two runs
    bit-identical: 20,011 rows (no multiple of a chunk), 10% invalid, empty
    clusters keeping their centroid, assignments out of range counted
    nowhere; every row invalid; more centroids (300) than valid rows (100);
    90% of the rows on one centroid; PQ's shape (65,536 x 8, K = 256); D = 1
    and D = 130 (scalar loads); K = 20,000 (the histogram past shared
    memory); an unaligned base (scalar loads); D = 768 and D = 12,289 (more
    than 8 slabs a centroid, several dimensions a thread of the move tree,
    which the last slab forms from the other slabs' new centroids)."""
    rng = np.random.default_rng(UPDATE_CASES.index(case))
    n, d, k = {"pq": (65_536, 8, 256), "d1": (20_011, 1, 50), "d130": (20_011, 130, 40),
               "k_past_shared": (50_000, 4, 20_000), "k_over_valid": (5_000, 16, 300),
               "d768": (20_011, 768, 16), "d12289": (1_500, 12_289, 3)}.get(
        case, (20_011, 48, 64))
    x = rng.normal(size=(n, d)).astype(np.float32)
    old = rng.normal(size=(k, d)).astype(np.float32)
    assign = rng.integers(0, k, n).astype(np.int32)
    valid = rng.random(n) >= 0.1
    if case == "mixed":
        assign[assign == 7] = 8  # an empty cluster keeps its centroid
        assign[:5] = [-1, k, k + 3, -7, 0]  # outside [0, K): counted nowhere
    elif case == "all_invalid":
        valid[:] = False
    elif case == "k_over_valid":
        valid = np.arange(n) % 50 == 0
    elif case == "skew90":
        assign[rng.random(n) < 0.9] = 3
    xd = torch.from_numpy(x).to(dev)
    if case == "unaligned":
        xd = _unaligned(xd)
    args = (xd, torch.from_numpy(valid).to(dev), torch.from_numpy(assign).to(dev),
            torch.from_numpy(old).to(dev))
    first = [t.cpu().numpy() for t in kmeans.kmeans_update(*args)]
    second = [t.cpu().numpy() for t in kmeans.kmeans_update(*args)]
    for a, b in zip(first, second):
        assert np.array_equal(_bits(a), _bits(b))
    want = _row_order_update(x, valid, assign, old)
    for name, got, exp in zip(("sums", "counts", "new", "moves"), first, want):
        assert np.array_equal(_bits(got), _bits(exp)), name
    if case == "mixed":
        assert np.array_equal(first[2][7], old[7])


@pytest.mark.parametrize("mode", ["IVF-L2", "IVF-IP", "IVF-COS", "SPANN-L2"])
def test_ivf_index_cuda_matches_cpu(dev, tmp_path, mode):
    """An index built on the card answers as the plain versions do on the
    same index files, and its scan kernel equals the plain scan."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(9, 32)).astype(np.float32)
    kw = {"replica_count": 2} if mode.startswith("SPANN") else {}
    answers = []
    for device in (dev, "cpu"):
        client = lynsedb_tpu_torch.VectorDBClient(tmp_path, device=device)
        db = client.get_database("d") if answers else client.create_database("d")
        coll = db.require_collection("c", dim=32)
        if not answers:
            coll.add(vectors=x, fields=[{"b": i % 2} for i in range(6000)])
            coll.commit()
            coll.build_index(mode, n_clusters=24, **kw)
        answers.append([coll.batch_search(q, k=10, nprobe=p, where=w)
                        for p in (1, 6) for w in (None, "b = 0")])
        eng = coll._engine
        if device == dev:
            idx, state = eng._index, eng._index._device_state(eng)
            qd = torch.from_numpy(q).to(dev)
            top_c = ivf._top_clusters(qd, state["centroids"], idx.metric, 6)
            qsq = (qd * qd).sum(-1)
            args = (qd, qsq, top_c, state["cluster_blocks"], state["blocks"], state["block_sq"],
                    state["block_orig"], eng.corpus().valid_mask(np.arange(6000) % 3 == 0),
                    idx.metric)
            got, want = ivf.ivf_scan_blocks(*args), ivf.ivf_scan_blocks_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(torch.isfinite(got), torch.isfinite(want))
            fin = torch.isfinite(want)
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
        client.close()
    for got, want in zip(*answers):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5, atol=1e-4)
            wd = np.asarray(w.distances)[None]
            _assert_ids_match(np.asarray(g.ids)[None], np.asarray(w.ids)[None], wd,
                              1e-5 * np.abs(wd).max(axis=1) + 1e-4)


# ── the quantized indexes: K11-K14 ───────────────────────────────────────


@pytest.mark.parametrize("d", [8, 100, 128, 2048])
def test_fwht_rotate_matches_plain(dev, d):
    rng = np.random.default_rng(d)
    dim_pad = quantize._next_pow2(d)
    q = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(dev)
    signs = torch.from_numpy(quantize.rotation_signs(dim_pad, 7)).to(dev)
    got, want = quantize.fwht_rotate(q, signs, dim_pad), quantize.rotate(q, signs, dim_pad)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


def _code_state(kind, rng, n, d, dev):
    """Random codes and terms of an int8-coded index, as the card holds them."""
    if kind == "sq8":
        codes = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
        st = {"codes": codes, "lo": rng.normal(size=d), "scale": rng.random(d) * 0.02 + 1e-3}
    elif kind == "rabitq":
        st = {"bits": np.where(rng.random((n, d)) < 0.5, 1, -1).astype(np.int8),
              "alpha": rng.random(n) + 0.1}
    else:
        st = {"codes": rng.integers(0, 16, size=(n, d)).astype(np.int8),
              "lo": -rng.random(n), "scale": rng.random(n) * 0.1 + 1e-3}
    st["row_sq"] = rng.random(n) * 50 + 1.0
    st["row_sq"][3] = 0.0  # a zero-norm row: cosine's 1.0 policy
    return {k: torch.from_numpy(quantize.pad_codes(v) if v.dtype == np.int8 else
                                v.astype(np.float32)).to(dev) for k, v in st.items()}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["sq8", "rabitq", "polarvec"])
def test_int8_code_scores_matches_plain(dev, kind, metric):
    rng = np.random.default_rng(11)
    n, d = 5000, 100 if kind == "sq8" else 128
    st = _code_state(kind, rng, n, d, dev)
    valid = torch.from_numpy(rng.random(n + 64) < 0.8).to(dev)
    for b in (1, 3, 16, 70):
        q = torch.from_numpy(rng.normal(size=(b, 100)).astype(np.float32)).to(dev)
        if b > 1:
            q[0] = 0.0  # a zero query: scale 1, every code 0
        q_rot = None
        if kind != "sq8":
            signs = torch.from_numpy(quantize.rotation_signs(128, 3)).to(dev)
            q_rot = quantize.rotate(q, signs, 128)
        got = quantize.int8_code_scores(kind, q, q_rot, st, valid, metric)
        want = quantize.int8_code_scores_plain(kind, q, q_rot, st, valid, metric)
        torch.cuda.synchronize()
        assert got.shape == (b, n)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dp", [16, 112, 128, 784])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["sq8", "rabitq", "polarvec"])
def test_int8_code_tile_routes(dev, kind, metric, dp):
    """K12's tensor-core tile at the edges of its routes: Dp = 16 (one half
    k-step), 112 (Dp % 32 == 16: the last k-step zero-filled), 128 and 784
    (several 128-byte stages a row; 160 queries a group, so B = 200 takes
    two); B in {1, 9, 64, 65, 200} across the tile's query configurations;
    a zero query and a zero-norm row; N = 30,000 rows (16-byte key stores,
    several row tiles a block)."""
    rng = np.random.default_rng(dp)
    n, d = 30_000, {16: 13, 112: 100, 128: 128, 784: 784}[dp]
    st = _code_state(kind, rng, n, d, dev)
    assert st["bits" if kind == "rabitq" else "codes"].shape[1] == dp
    valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    for b in (1, 9, 64, 65, 200):
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        q_rot = None if kind == "sq8" else torch.from_numpy(
            rng.normal(size=(b, d)).astype(np.float32)).to(dev)
        if b > 1:
            q[0] = 0.0  # a zero query: scale 1, every code 0
            if q_rot is not None:
                q_rot[0] = 0.0
        got = quantize.int8_code_scores(kind, q, q_rot, st, valid, metric)
        want = quantize.int8_code_scores_plain(kind, q, q_rot, st, valid, metric)
        torch.cuda.synchronize()
        assert got.shape == (b, n)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m,ds", [(16, 8), (12, 4), (64, 2), (240, 1)])
def test_pq_adc_scores_matches_plain(dev, metric, m, ds):
    """M=16 (16-byte code loads), 12 (byte loads), 64 (a 64 KB table: opt-in
    shared memory) and 240 (a 240 KB table: built in two groups)."""
    rng = np.random.default_rng(m)
    n = 9000
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, m)).astype(np.uint8)).to(dev)
    books = torch.from_numpy(rng.normal(size=(m, 256, ds)).astype(np.float32)).to(dev)
    row_sq = torch.from_numpy((rng.random(n) * 10).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for b in (1, 7):
        q = torch.from_numpy(rng.normal(size=(b, m * ds)).astype(np.float32)).to(dev)
        got = quantize.pq_adc_scores(q, codes, books, row_sq, valid, metric)
        want = quantize.pq_adc_scores_plain(q, codes, books, row_sq, valid, metric)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [100, 128])
def test_bf16_gather_scores_matches_plain(dev, metric, d):
    """Per-query lists with empty slots (a -1 id, a -inf slot key) and one
    list shared by every query (stride 0); D=128 reads 16 bytes a lane, D=100
    one bf16 at a time."""
    rng = np.random.default_rng(d)
    corpus = _aux(rng.normal(size=(7000, d)).astype(np.float32) + 0.5, dev)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(6, d)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 7000, size=(6, 300)).astype(np.int32)).to(dev)
    idx[:, :4] = -1
    slot_keys = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32)).to(dev)
    slot_keys[:, -7:] = float("-inf")
    for ids, sk in ((idx, slot_keys), (idx[:1].contiguous(), None)):
        got = scan.bf16_gather_scores(q, x16, aux, ids, sk, metric)
        want = scan.bf16_gather_scores_plain(q, x16, aux, ids, sk, metric)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["FLAT-IP-SQ8", "FLAT-L2-SQ8", "FLAT-IP-PQ", "FLAT-IP-RABITQ",
                                  "FLAT-COS-POLARVEC"])
def test_quantized_index_cuda_matches_cpu(dev, tmp_path, mode):
    """An index built on the card answers as the plain versions do on the
    same index files, through the device route and, with rows past the
    encode, the host route."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6000, 64)).astype(np.float32)
    extra = rng.normal(size=(200, 64)).astype(np.float32)
    q = rng.normal(size=(9, 64)).astype(np.float32)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "card", device=dev)
    coll = client.create_database("d").require_collection("c", dim=64)
    coll.add(vectors=x, fields=[{"b": i % 2} for i in range(6000)])
    coll.commit()
    coll.build_index(mode)
    client.close()
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    answers = []
    for device, root in ((dev, tmp_path / "card"), ("cpu", tmp_path / "cpu")):
        client = lynsedb_tpu_torch.VectorDBClient(root, device=device)
        coll = client.get_database("d").get_collection("c")
        got = [coll.batch_search(q, k=k, where=w) for k in (10, 100) for w in (None, "b = 0")]
        coll.add(vectors=extra, fields=[{"b": 0}] * 200)  # uncommitted: the host route
        got += [coll.batch_search(q, k=10, where=w) for w in (None, "b = 0")]
        answers.append(got)
        client.close()
    for got, want in zip(*answers):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5, atol=1e-4)
            wd = np.asarray(w.distances)[None]
            _assert_ids_match(np.asarray(g.ids)[None], np.asarray(w.ids)[None], wd,
                              1e-5 * np.abs(wd).max(axis=1) + 1e-4)


# ── the graph kernels (K17 beam_search, K19 topl_scan, K20 robust_prune) ──
# K17 and K20 form every key as the same chain of separately rounded f32
# operations as their plain versions, so kernel and plain agree exactly: the
# same pool keys, ids and visit counts, the same pruned lists. K19's product
# is tiled FMA, so its keys agree to rtol 1e-5 and its ids up to swaps
# between keys within that tolerance.

_GRAPH_DIM = 40  # not a multiple of 32: the lane sums' ragged tail


def _graph_inputs(dev, seed=11, n=3000, d=_GRAPH_DIM, r=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) + 0.3
    x[n // 2 : n // 2 + 50] = x[:50]  # duplicated rows: exact key ties
    xd = torch.from_numpy(x).to(dev)
    graph = torch.from_numpy(graph_ops.build_vamana(xd, Metric.L2, r=r, l_build=32)).to(dev)
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(dev)  # a 10% mask
    return rng, x, xd, graph, valid


def _tier_args(tier, rng, x, xd, dev):
    """The arrays of one guidance tier on the card (beam_operands' args)."""
    n, d = x.shape
    if tier == "f32":
        return (xd,)
    if tier == "bf16":
        corpus = _aux(x, dev)
        aux = corpus.bf16_aux()
        return (corpus.data16[:n], aux["mean"], aux["xm"][:n], aux["xc_sq"][:n],
                aux["xsq_true"][:n])
    row_sq = torch.from_numpy((x * x).sum(1)).to(dev)
    if tier == "sq8":
        codes = torch.from_numpy(rng.integers(-128, 128, size=(n, d), dtype=np.int8)).to(dev)
        lo = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(dev)
        scale = torch.from_numpy(rng.random(d).astype(np.float32) * 0.02 + 1e-3).to(dev)
        return (codes, lo, scale, row_sq)
    m = 8
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, m), dtype=np.uint8)).to(dev)
    books = torch.from_numpy(rng.normal(size=(m, 256, d // m)).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(rng.random(n).astype(np.float32) + 0.5).to(dev)
    return (codes, books, alpha, row_sq)


def _walk_both(tier, kind, q, args, graph, starts, valid, beam, expand):
    """K17 and its plain version (on the card too) on the same operands."""
    ops = graph_ops.beam_operands(tier, q, *args, kind=kind)
    kw = dict(code=graph_ops._KIND_CODE[kind], beam=beam, max_steps=2 * beam, expand=expand)
    got = graph_ops.beam_walk(tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"], graph,
                              starts, valid, **kw)
    before = graph_ops.beam_walk.launches
    want = graph_ops.beam_walk_plain(tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"],
                                     graph, starts, valid, **kw)
    assert graph_ops.beam_walk.launches == before  # the plain version counts nothing
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("kind", ["ip", "l2", "cos"])
@pytest.mark.parametrize("tier", ["f32", "bf16", "sq8", "pq"])
def test_beam_search_matches_plain(dev, tier, kind, expand):
    rng, x, xd, graph, valid = _graph_inputs(dev)
    args = _tier_args(tier, rng, x, xd, dev)
    q = torch.from_numpy(x[rng.integers(0, len(x), 6)] + 0.1 * rng.normal(size=(6, x.shape[1]))
                         .astype(np.float32)).to(dev)
    per_query = torch.from_numpy(rng.integers(0, len(x), size=(6, 5), dtype=np.int32)).to(dev)
    shared = torch.from_numpy(rng.choice(len(x), 600, replace=False).astype(np.int32)).to(dev)
    for starts in (per_query, shared):  # 600 shared starts enter in three chunks
        got, want = _walk_both(tier, kind, q, args, graph, starts, valid, 48, expand)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (tier, kind, expand)
        assert (got[2] > 0).all()
        ids = got[1].cpu().numpy()
        assert valid.cpu().numpy()[ids[ids >= 0]].all()  # the filter prunes the walk


def test_beam_search_large_pool_matches_plain(dev):
    """A pool above 1,024 (k=1,000 under IP: 1,250) in shared memory."""
    rng, x, xd, graph, valid = _graph_inputs(dev, n=4000)
    q = torch.from_numpy(rng.normal(size=(2, x.shape[1])).astype(np.float32)).to(dev)
    starts = torch.from_numpy(np.array([5, 77, 900], dtype=np.int32)).to(dev)
    got, want = _walk_both("f32", "ip", q, (xd,), graph, starts, valid, 1250, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[1] >= 0).sum(1).min()) >= 1000


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("tier", ["f32", "bf16", "sq8", "pq", "metric"])
def test_beam_search_bitmap_route(dev, tier, expand):
    """A beam whose walk bound (its starts + 2 x beam x expand x R) passes
    the shared-memory visited table keeps the device bitmap: every tier
    equal to the plain version, keys, ids and scanned."""
    rng, x, xd, graph, valid = _graph_inputs(dev)
    beam, r = 520, graph.shape[1]
    starts = torch.from_numpy(rng.choice(len(x), 700, replace=False).astype(np.int32)).to(dev)
    assert graph_ops.visited_table_cap(700, beam, 2 * beam, expand, r) == 0
    if tier == "metric":
        args, kind = (graph_ops.graph_space(xd, Metric.L1),), Metric.L1.value
    else:
        args, kind = _tier_args(tier, rng, x, xd, dev), "l2"
    q = torch.from_numpy(x[rng.integers(0, len(x), 3)] + 0.1).to(dev)
    got, want = _walk_both(tier, kind, q, args, graph, starts, valid, beam, expand)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (tier, expand)


@pytest.mark.parametrize("case", ["r40", "dup_slots", "b300"])
def test_beam_search_step_routes(dev, case):
    """The walk's step routes beside the one-warp step: R = 40 (> 32, the
    block-wide step at expand 1); adjacency rows that hold a node in two
    slots (both fresh in one step, as in the reference, scanned once); 300
    queries with the on-chip visited set. Equal to the plain version."""
    rng, x, xd, graph, valid = _graph_inputs(dev)
    if case == "r40":  # 24 more neighbours a node, -1 padding among them
        extra = rng.integers(-1, len(x), size=(len(x), 24)).astype(np.int32)
        graph = torch.cat([graph, torch.from_numpy(extra).to(dev)], 1).contiguous()
    if case == "dup_slots":
        graph = graph.clone()
        graph[::3, 1] = graph[::3, 0]
    b = 300 if case == "b300" else 6
    q = torch.from_numpy(x[rng.integers(0, len(x), b)] + 0.1).to(dev)
    starts = torch.from_numpy(rng.integers(0, len(x), size=(b, 5), dtype=np.int32)).to(dev)
    assert graph_ops.visited_table_cap(5, 48, 96, 1, graph.shape[1]) > 0
    for kind in ("ip", "l2"):
        got, want = _walk_both("f32", kind, q, (xd,), graph, starts, valid, 48, 1)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, kind)


def _keys64(q, x, ids, mode):
    """float64 keys of rows ``ids`` (B, L) for K19's modes."""
    rows = x[np.maximum(ids, 0)].astype(np.float64)
    q64 = q.astype(np.float64)[:, None, :]
    ip = (rows * q64).sum(-1)
    if mode == graph_ops.TOPL_DOT:
        return ip
    qsq, xsq = (q64 * q64).sum(-1), (rows * rows).sum(-1)
    if mode == graph_ops.TOPL_COS:
        return ip / np.sqrt(qsq * xsq) - 1.0
    return -(qsq + xsq - 2 * ip)


def _check_topl_chunk(x, xd, sq, lo, hi, n_real, l, mode):
    """K19 on queries [lo, hi) of the corpus against its plain version: keys
    within rtol 1e-5 + atol 1e-4, no self-match, no row >= n_real, ids
    swapped only between rows whose float64 keys agree within 1e-5 of the
    row's largest key + 1e-4."""
    dev = xd.device
    q_ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    args = (xd[lo:hi], q_ids, xd, sq[lo:hi], sq, n_real, l, mode)
    gk, gi = graph_ops.topl_scan(*args)
    wk, wi = graph_ops.topl_scan_plain(*args)
    torch.cuda.synchronize()
    gi, wi = gi.cpu().numpy(), wi.cpu().numpy()
    assert not (gi == np.arange(lo, hi)[:, None]).any()  # self-matches masked
    assert (gi < n_real).all()
    np.testing.assert_allclose(gk.cpu().numpy(), wk.cpu().numpy(), rtol=1e-5, atol=1e-4)
    exact = _keys64(x[lo:hi], x, gi, mode)
    want = _keys64(x[lo:hi], x, wi, mode)
    tol = 1e-5 * np.abs(want).max(axis=1, keepdims=True) + 1e-4
    assert (np.abs(exact - want) <= tol).all()  # ids differ only at near-ties


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("l", [16, 64, 96])
def test_topl_scan_matches_plain(dev, l, mode):
    rng = np.random.default_rng(l + mode)
    n, d = 20_000, 48
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[100:110] = x[5]  # exact ties: the lower id first
    xd = torch.from_numpy(x).to(dev)
    sq = (xd * xd).sum(-1)
    for lo, hi in ((0, 4096), (4096, 4096 + 37), (n - 300, n)):  # ragged chunks
        _check_topl_chunk(x, xd, sq, lo, hi, n - 7, l, mode)  # 7 rows past n_real


# (N, D, L): D = 1 and 7 the one-stage tiles of the scalar-load route (a
# barrier after each epilogue), D = 130 a ragged last stage, L = 256 the
# 32-query tile, N = 300,000 spans of many tiles and many list flushes,
# N = 1,000 at L = 256 spans shorter than L (a chunk of one query spreads
# over every SM: (-inf, INT_MAX) pads that K5's merge must drop)
_TOPL_EDGES = [(20_000, 1, 64), (20_000, 7, 64), (20_000, 130, 64), (20_000, 48, 256),
               (300_000, 48, 64), (300_000, 128, 256), (1_000, 16, 256)]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n,d,l", _TOPL_EDGES)
def test_topl_scan_plan_edges(dev, n, d, l, mode):
    """K19 at its plan's edges, on chunks of 1, 37 and 300 queries (one
    query group, a ragged one, the corpus's last rows) against its plain
    version."""
    rng = np.random.default_rng(n + d + l)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[100:110] = x[5]
    xd = torch.from_numpy(x).to(dev)
    sq = (xd * xd).sum(-1)
    for lo, hi in ((0, 1), (n // 2, n // 2 + 37), (n - 300, n)):
        _check_topl_chunk(x, xd, sq, lo, hi, n - 7, l, mode)


# K20's shapes, (L, D, nodes): M = L + 1 table rows with node ids, L in the
# keys mode without; 64 / 65 an insert's keys, 73 pass A (at 700 nodes the
# shape these tests first took), 97 a delete repair, 201 several rounds of
# tiles, 215 and 221 the shallower stages a large M takes to fit its shared
# memory (16 and 8 dimensions in both modes), L = 37 and M = 73 not multiples
# of the 4-row tile, D = 1 and 130 a ragged last stage, one node
_PRUNE_SHAPES = [(72, 40, 700), (64, 40, 300), (72, 128, 300), (96, 130, 200), (200, 40, 60),
                 (215, 130, 40), (221, 40, 20), (37, 1, 300), (72, 128, 1)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit, every NaN counted equal to any NaN."""
    nan = torch.isnan(a)
    if a.shape != b.shape or not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _prune_both_modes(dev, space, metric: Metric, n: int, l: int, bs: int, seed: int):
    """K20 against its plain version to the bit in its prune mode and both
    keys modes, on candidates with -1s, self candidates, duplicates and the
    rows 0-8 (the corner rows) among them."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(n, bs, replace=False).astype(np.int32)
    cands = rng.integers(0, n, size=(bs, l)).astype(np.int32)
    cands[rng.random(cands.shape) < 0.1] = -1
    cands[:, min(5, l - 1)] = nodes  # self candidates are dropped
    if l > 12:
        cands[:, 9] = cands[:, 10]  # duplicate candidates: equal keys
        cands[:, 11] = np.arange(bs) % 9  # the corner rows
        cands[:, 12] = (np.arange(bs) + 4) % 9
    cands = torch.from_numpy(cands).to(dev)
    nodes = torch.from_numpy(nodes).to(dev)
    desc = metric is Metric.IP
    kw = dict(metric=metric, r=32, alpha=1.2, descending=desc)
    got = graph_ops.robust_prune(space, nodes, cands, **kw)
    want = graph_ops.robust_prune_plain(space, nodes, cands, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # more than one id a node kept; a lone node may keep one (under L2 its
    # zero corner row is nearer than every other candidate and prunes them)
    assert (got >= 0).sum() > (bs if bs > 1 else 0)
    for node_ids in (nodes, None):  # the keys mode, with and without point keys
        gp, gq = graph_ops.robust_prune(space, node_ids, cands, metric=metric, keys_only=True)
        wp, wq = graph_ops.robust_prune_plain(space, node_ids, cands, metric=metric,
                                              keys_only=True)
        torch.cuda.synchronize()
        assert _bits_equal(gq, wq)
        assert (gp is None) == (wp is None) and (gp is None or _bits_equal(gp, wp))


@pytest.mark.parametrize("l,d,bs", _PRUNE_SHAPES)
@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE, Metric.IP])
def test_robust_prune_matches_plain(dev, metric, l, d, bs):
    n = 5000
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[200:210] = x[3]
    x[:3] = 0.0  # zero rows: cosine's zero-norm policy
    x[6, 0], x[7, 0], x[8, 0] = np.nan, np.inf, -np.inf  # NaN keys
    _prune_both_modes(dev, torch.from_numpy(x).to(dev), metric, n, l, bs, l + d)


@pytest.mark.parametrize("mode", ["HNSW-L2", "HNSW-IP", "DISKANN-L2", "DISKANN-IP", "DISKANN-COS"])
def test_graph_index_cuda_matches_cpu(dev, tmp_path, mode):
    """The same collection indexed and searched on the card and on the CPU:
    the same graph (K19 and K20 against their plain versions inside the
    build), the same answers."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    answers, graphs = [], []
    for i, device in enumerate((dev, "cpu")):
        client = lynsedb_tpu_torch.VectorDBClient(tmp_path / f"root{i}", device=device)
        try:
            coll = client.create_database("d").require_collection("c", dim=32)
            coll.add(vectors=x, fields=[{"b": i % 2} for i in range(len(x))])
            coll.commit()
            coll.build_index(mode)
            idx = coll._engine._index
            graphs.append(idx.layer0_np if mode.startswith("HNSW") else idx.graph_np)
            answers.append([(np.asarray(r.ids), np.asarray(r.distances))
                            for where in (None, "b = 1")
                            for r in coll.batch_search(q, k=10, where=where, nprobe=64)])
        finally:
            client.close()
    assert (graphs[0] == graphs[1]).all(axis=1).mean() >= 0.99  # near-tie rows may differ
    same = np.mean([np.array_equal(g[0], w[0]) for g, w in zip(*answers)])
    assert same >= 0.95
    for (gi, gd), (wi, wd) in zip(*answers):
        if np.array_equal(gi, wi):
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


# ── K6a, K6b, K6c: the distance kernels of the other 13 metrics ──────────

OTHER_METRICS = [m for m in Metric if m not in METRICS]
EXACT_KEYS = (Metric.HAMMING, Metric.JACCARD, Metric.TANIMOTO, Metric.DICE, Metric.CHEBYSHEV)


def _metric_rows(metric: Metric, rng, n: int, d: int) -> np.ndarray:
    """Rows in a metric's domain with its corner rows: invalid and zero-mass
    probability rows, constant rows (correlation), |lat| > 90 (Haversine),
    all-zero rows (Canberra's and Bray-Curtis's 0/0), empty fingerprints."""
    if metric is Metric.HAVERSINE:
        x = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], 1)
        x[:3, 1] = 95.0
    elif metric in (Metric.HELLINGER, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON):
        x = np.exp(rng.normal(size=(n, d)))
        x[:3, 0] = -1.0
        x[3:6] = 0.0
    elif metric.is_binary:
        x = (rng.random((n, d)) < 0.1).astype(np.float64)
        x[:3] = 0.0
    else:
        x = rng.normal(size=(n, d))
        x[:3] = 0.0
        x[3:5] = 2.5  # constant rows
    return x.astype(np.float32)


def _assert_keys_close(metric: Metric, got: torch.Tensor, want: torch.Tensor) -> None:
    """The kernel's keys against the plain version's: the binary family and
    Chebyshev equal; otherwise the same -inf slots and the distances within
    the family's tolerance (Hellinger and Jensen-Shannon on the squared
    distance: sums in another order move the cancelling terms by ulps)."""
    if metric in EXACT_KEYS:
        assert torch.equal(got, want)
        return
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    g, w = -got[fin].double(), -want[fin].double()
    if metric in (Metric.HELLINGER, Metric.JENSEN_SHANNON):
        torch.testing.assert_close(g * g, w * w, rtol=1e-5, atol=1e-5)
    elif metric is Metric.HAVERSINE:
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1.0)
    else:
        scale = float(w.abs().max()) if len(w) else 0.0  # every key -inf: nothing to scale
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("metric", OTHER_METRICS, ids=[m.value for m in OTHER_METRICS])
@pytest.mark.parametrize("b,d", [(1, 48), (5, 48), (40, 70), (3, 1100)])
def test_metric_kernels_match_plain(dev, metric, b, d):
    """K6a / K6b / K6c in tile mode (every row, masked) and gather mode
    (explicit rows, -1 slots empty) against their plain version on the
    card; D = 1,100 is 35 words a binary row (more than one staged chunk)."""
    if metric is Metric.HAVERSINE:
        d = 2
    rng = np.random.default_rng(d + b)
    x = torch.from_numpy(_metric_rows(metric, rng, 3000, d)).to(dev)
    q = torch.from_numpy(_metric_rows(metric, rng, b + 3, d)[3:]).to(dev)
    if b > 1:
        q[0] = x[7]  # a query's own row
    qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
    valid = torch.from_numpy(rng.random(3000) < 0.8).to(dev)
    got = scan.metric_keys(qt, ct, valid, metric)
    want = scan.metric_keys_plain(qt, ct, valid, metric)
    torch.cuda.synchronize()
    _assert_keys_close(metric, got, want)
    ids = torch.from_numpy(rng.integers(0, 3000, size=(b, 300)).astype(np.int32)).to(dev)
    ids[:, -20:] = -1
    got = scan.metric_keys(qt, ct, None, metric, ids=ids)
    want = scan.metric_keys_plain(qt, ct, None, metric, ids=ids)
    torch.cuda.synchronize()
    _assert_keys_close(metric, got, want)


BINARY = [Metric.HAMMING, Metric.JACCARD, Metric.TANIMOTO, Metric.DICE]


@pytest.mark.parametrize("w", [1, 2, 7, 8, 9, 32, 35])
@pytest.mark.parametrize("metric", BINARY, ids=[m.value for m in BINARY])
def test_binary_tile_routes(dev, metric, w):
    """K6b's b1 tensor-core tile equal to its plain version: W in {1, 2, 7,
    8, 9, 32, 35} words (a partial 256-bit k-step below 8 and at 9 and 35;
    the 4-byte copy route where W % 4 != 0), B in {1, 7, 8, 9, 33, 256} and
    300, past the 256 queries a group; N = 100,003 rows, so a block walks
    several row tiles, the last one ragged, and the keys leave in 4-byte
    stores. Rows at 10% density with pad bits, empty rows and queries
    (Jaccard's and Dice's empty-union policy), a query's own row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(w)
    n, d = 100_003, 32 * w - (w % 3)
    x = (torch.rand((n, d), generator=gen, device=dev) < 0.1).float()
    x[:3] = 0.0
    ct = D.corpus_transform(x, metric)
    valid = torch.rand(n, generator=gen, device=dev) < 0.8
    for b in (1, 7, 8, 9, 33, 256, 300):
        q = (torch.rand((b, d), generator=gen, device=dev) < 0.1).float()
        if b > 1:
            q[0] = 0.0
            q[1] = x[7]
        qt = D.query_transform(q, metric)
        got = scan.binary_scores(qt, ct, valid, metric)
        want = scan.metric_keys_plain(qt, ct, valid, metric)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (b, int((got != want).sum()))


@pytest.mark.parametrize("offset", [1, 4])
def test_binary_tile_unaligned_terms(dev, offset):
    """K6b's tile with its per-row terms at unaligned addresses: the bit
    counts 4 bytes off a 16-byte boundary (4-byte copies) and the mask
    ``offset`` bytes off (1: plain byte loads; 4: 4-byte copies), as views of
    larger tensors; equal to the plain version on the same views."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(offset)
    n, d = 20_011, 1024
    x = (torch.rand((n, d), generator=gen, device=dev) < 0.1).float()
    ct = D.corpus_transform(x, Metric.JACCARD)
    cnt = torch.zeros(n + 1, device=dev)
    cnt[1:] = ct["cnt"]
    ct = {"bits": ct["bits"], "cnt": cnt[1:]}
    valid = torch.zeros(n + offset, dtype=torch.bool, device=dev)
    valid[offset:] = torch.rand(n, generator=gen, device=dev) < 0.8
    valid = valid[offset:]
    assert ct["cnt"].data_ptr() % 16 == 4 and valid.data_ptr() % 4 == offset % 4
    for b in (1, 9):
        qt = D.query_transform((torch.rand((b, d), generator=gen, device=dev) < 0.1).float(),
                               Metric.JACCARD)
        got = scan.binary_scores(qt, ct, valid, Metric.JACCARD)
        want = scan.metric_keys_plain(qt, ct, valid, Metric.JACCARD)
        torch.cuda.synchronize()
        assert torch.equal(got, want), b


def _assert_elem_topc(metric, got, full, c):
    """K9's fused (keys, ids) against the plain keys ``full`` (B, N) of the
    same inputs: best first with distinct ids, each key within the family's
    tolerance of the plain key of its row (-inf where that is -inf), and the
    ids the plain top C's but for rows whose plain key lies within that
    tolerance of the plain C-th key (Chebyshev exactly the plain chain's)."""
    keys, ids = got
    want_k, want_i = topk.topk_select_plain(full, c)
    if metric in EXACT_KEYS:
        assert torch.equal(ids, want_i) and torch.equal(keys, want_k)
        return
    assert bool((keys[:, 1:] <= keys[:, :-1]).all())
    for r in range(len(ids)):
        assert len(set(ids[r].tolist())) == c
    _assert_keys_close(metric, keys, full.gather(1, ids.long()))
    fin = torch.isfinite(want_k)
    scale = float(want_k[fin].abs().max()) if bool(fin.any()) else 0.0
    kth = want_k[:, -1:].double()
    for r in range(len(ids)):
        differ = set(ids[r].tolist()) ^ set(want_i[r].tolist())
        for i in differ:
            k = full[r, i].double()
            assert bool(torch.isinf(k) & torch.isinf(kth[r, 0])) or \
                float((k - kth[r, 0]).abs()) <= 2e-5 * scale + 1e-5 * abs(float(k)), (r, i)


@pytest.mark.parametrize("metric", [Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA,
                                    Metric.BRAY_CURTIS])
@pytest.mark.parametrize("b", [1, 16, 70])
def test_elementwise_bf16_mode_matches_plain(dev, metric, b):
    """K9, K6c's pass over the centred bf16 copy with the mean added back,
    fused with its top C, against its plain chain."""
    rng = np.random.default_rng(b)
    corpus = _aux(rng.normal(size=(5000, 40)).astype(np.float32) + 0.3, dev)
    mean, x16 = corpus.bf16_aux()["mean"], corpus._dev16
    q = torch.from_numpy(rng.normal(size=(b, 40)).astype(np.float32)).to(dev)
    valid = corpus.valid_mask()
    full = scan.metric_keys_plain({"x": q}, {"x": x16}, valid, metric, mean=mean)
    for c in (1, 80, 300):
        got = scan.elementwise_topc(q, x16, mean, valid, metric, c)
        torch.cuda.synchronize()
        _assert_elem_topc(metric, got, full, c)


@pytest.mark.parametrize("metric", [Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA,
                                    Metric.BRAY_CURTIS])
@pytest.mark.parametrize("b", [2, 5, 8, 9, 17, 33, 64, 65, 256])
@pytest.mark.parametrize("d", [8, 37, 128])
def test_elementwise_topc_routes_match_plain(dev, metric, b, d):
    """K9 on each route by B (the bytes route to 16, Canberra's to 8,
    Chebyshev's FMA route on 64 / 128-query tiles past it, the 64-row tile's
    keys and K5 for the others past it), D = 37 (the scalar loads, or the
    tile's keys), an unaligned query block, 40% of the rows masked, a run of
    masked rows at the start, C = 1 (with the pilot), C past a span's rows
    and C = N."""
    rng = np.random.default_rng(b * d)
    n = 3001
    x = rng.normal(size=(n, d)).astype(np.float32)
    corpus = _aux(x, dev)
    mean, x16 = corpus.bf16_aux()["mean"], corpus._dev16
    qbuf = torch.from_numpy(rng.normal(size=(b * d + 1,)).astype(np.float32)).to(dev)
    q = qbuf[1:].view(b, d) if d == 37 else qbuf[: b * d].view(b, d)
    valid = corpus.valid_mask() & torch.from_numpy(rng.random(len(x16)) < 0.6).to(dev)
    valid[:300] = False
    full = scan.metric_keys_plain({"x": q}, {"x": x16}, valid, metric, mean=mean)
    for c in (1, 500, len(x16)):
        got = scan.elementwise_topc(q, x16, mean, valid, metric, c)
        torch.cuda.synchronize()
        _assert_elem_topc(metric, got, full, c)


@pytest.mark.parametrize("metric", [Metric.L1, Metric.CHEBYSHEV, Metric.BRAY_CURTIS])
@pytest.mark.parametrize("b", [3, 40])
def test_elementwise_topc_pilot_and_start(dev, metric, b):
    """K9's pilot launch (40,000 rows, C of 16 and 64: the first 32 C rows'
    C-th key starts the main launch's lists) against the plain chain, the
    pilot forced on and off bit for bit against the default, and a caller's
    start: the real entries are the unstarted result's at or above
    it, the rest (-inf, -1)."""
    rng = np.random.default_rng(b + 7)
    corpus = _aux(rng.normal(size=(40_000, 32)).astype(np.float32), dev)
    mean, x16 = corpus.bf16_aux()["mean"], corpus._dev16
    q = torch.from_numpy(rng.normal(size=(b, 32)).astype(np.float32)).to(dev)
    valid = corpus.valid_mask() & torch.from_numpy(rng.random(len(x16)) < 0.9).to(dev)
    full = scan.metric_keys_plain({"x": q}, {"x": x16}, valid, metric, mean=mean)
    for c in (16, 64):
        got = scan.elementwise_topc(q, x16, mean, valid, metric, c)
        torch.cuda.synchronize()
        _assert_elem_topc(metric, got, full, c)
        for pilot in (True, False):  # forced either way: the same bits
            keys, ids = scan.elementwise_topc(q, x16, mean, valid, metric, c, pilot=pilot)
            assert torch.equal(ids, got[1]) and torch.equal(keys.view(torch.int32),
                                                            got[0].view(torch.int32))
        start = got[0][:, c // 2].contiguous()
        keys, ids = scan.elementwise_topc(q, x16, mean, valid, metric, c, start=start)
        torch.cuda.synchronize()
        real = keys >= start[:, None]
        assert torch.equal(real, got[0] >= start[:, None])
        assert torch.equal(torch.where(real, keys, 0.0), torch.where(real, got[0], 0.0))
        assert torch.equal(torch.where(real, ids, -1), ids)
        assert torch.equal(ids[real], got[1][real])
        assert bool(torch.isneginf(keys[~real]).all())


def test_elementwise_topc_all_masked(dev):
    """Every row masked: the -inf keys of the lowest row ids, as K5 over
    the keys returns them, on a bytes-route and an FMA-route batch."""
    rng = np.random.default_rng(3)
    corpus = _aux(rng.normal(size=(4000, 64)).astype(np.float32), dev)
    mean, x16 = corpus.bf16_aux()["mean"], corpus._dev16
    valid = torch.zeros(len(x16), dtype=torch.bool, device=dev)
    for b in (3, 40):
        q = torch.from_numpy(rng.normal(size=(b, 64)).astype(np.float32)).to(dev)
        keys, ids = scan.elementwise_topc(q, x16, mean, valid, Metric.L1, 100)
        torch.cuda.synchronize()
        assert bool(torch.isneginf(keys).all())
        assert torch.equal(ids.cpu(), torch.arange(100, dtype=torch.int32).expand(b, 100))


ELEM_TILE = [Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS, Metric.WASSERSTEIN,
             Metric.JENSEN_SHANNON, Metric.HAVERSINE]


def _elem_corpus(metric: Metric, rng, n: int, d: int) -> np.ndarray:
    """n rows in the metric's domain: _metric_rows' corner rows where n has
    room for them (a NaN entry too for the real-valued metrics), else its
    plain rows; Haversine's include both poles and both sides of the
    antimeridian."""
    x = _metric_rows(metric, rng, max(n, 24), d)
    if metric is Metric.HAVERSINE:
        x[8:16] = [[180.0, 10.0], [-180.0, 10.0], [179.99, -45.0], [-179.99, -45.0],
                   [0.0, 90.0], [33.0, -90.0], [-120.0, 90.0], [45.0, 0.0]]
    elif metric in (Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS):
        x[11, 0] = np.nan
    return x if n >= 24 else x[-n:]


def _elem_check(dev, metric: Metric, x: np.ndarray, q: np.ndarray, valid, unaligned=False):
    xd, qd = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    qt, ct = D.query_transform(qd, metric), D.corpus_transform(xd, metric)
    if unaligned:  # the lead rows one element past a 16-byte boundary: the scalar loads
        lead = {Metric.WASSERSTEIN: "cdf", Metric.JENSEN_SHANNON: "p"}.get(metric, "x")
        ct[lead] = _unaligned(ct[lead])
    got = scan.elementwise_scores(qt, ct, valid, metric)
    want = scan.metric_keys_plain(qt, ct, valid, metric)
    torch.cuda.synchronize()
    _assert_keys_close(metric, got, want)


@pytest.mark.parametrize("b", [1, 2, 8, 9, 15, 16, 17, 64, 65, 256, 300])
@pytest.mark.parametrize("metric", ELEM_TILE, ids=[m.value for m in ELEM_TILE])
def test_elementwise_tile_routes(dev, metric, b):
    """K6c's f32 tile mode at the edges of its routes: the bytes route (B <=
    16: 1, 2, 8 and 16 real queries; Canberra and Jensen-Shannon to B = 8),
    the FMA route (B = 17, 64, 65, 256, 300: 32-, 64- and 128-query tiles,
    one to three query groups; Bray-Curtis on 64-query tiles), Canberra and
    Jensen-Shannon from B = 9 on the 64-row tile (16 queries a block to B =
    16, then 64), D in {1, 3, 7, 32, 33, 128, 130} (one and several stages; 16-byte copies at 32 and
    128, 4-byte copies at the rest and from an unaligned base), N in {1,
    127, 128, 2,333}; the corner rows (zero, constant, NaN, invalid and
    zero-mass probability rows, |lat| > 90, the poles and the antimeridian),
    a 30% mask, a query's own row."""
    rng = np.random.default_rng(100 * b + ELEM_TILE.index(metric))
    dims = (2,) if metric is Metric.HAVERSINE else (1, 3, 7, 32, 33, 128, 130)
    for d in dims:
        for n in (1, 127, 128, 2333):
            x = _elem_corpus(metric, rng, n, d)
            q = _elem_corpus(metric, rng, max(b, 24), d)[:b].copy()
            q[0] = x[-1]  # a query's own row
            valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
            _elem_check(dev, metric, x, q, valid, unaligned=(d == 128 and n == 2333))


@pytest.mark.parametrize("b", [1, 16, 65, 300])
@pytest.mark.parametrize("metric", ELEM_TILE, ids=[m.value for m in ELEM_TILE])
def test_elementwise_tile_long_spans(dev, metric, b):
    """K6c's f32 tile mode over 1,000,003 rows (a span holds many tiles; no
    multiple of a tile), D = 7 and D = 33 (Haversine 2), 10% masked."""
    rng = np.random.default_rng(7 * b + ELEM_TILE.index(metric))
    n = 1_000_003
    for d in (2,) if metric is Metric.HAVERSINE else (7, 33):
        x = _elem_corpus(metric, rng, n, d)
        q = _elem_corpus(metric, rng, max(b, 24), d)[:b].copy()
        valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        _elem_check(dev, metric, x, q, valid)


def test_bf16_gather_scores_shared_list_with_mask(dev):
    """K11 with one (1, S) index list for every query and slot keys that
    empty the deleted rows' slots: the gather route's first pass (K4)."""
    rng = np.random.default_rng(12)
    corpus = _aux(rng.normal(size=(8000, 64)).astype(np.float32), dev)
    corpus.set_tombstones(np.arange(8000) % 7 == 0)
    idx = torch.from_numpy(np.nonzero(np.arange(8000) % 10 == 3)[0].astype(np.int32))[None].to(dev)
    slot = torch.where(corpus.valid_mask()[idx.long()], 0.0, float("-inf"))
    q = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(dev)
    for metric in METRICS:
        args = (q, corpus._dev16, corpus.bf16_aux(), idx, slot, metric)
        got = scan.bf16_gather_scores(*args, shared=True)
        want = scan.bf16_gather_scores_plain(*args, shared=True)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        assert bool(torch.isinf(got[:, torch.isinf(slot[0])]).all())
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def _assert_gather_k2_bound(q, aux, idx, got, want, metric):
    """K11's shared-list tile against its plain version: the same empty
    slots, and each key within K2's bound, 1e-5 |q - m| |x - m| + 1e-5
    (cosine: over its denominator)."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    safe = idx.clamp_min(0).long()
    tol = 1e-5 * (q - aux["mean"][None, :]).norm(dim=1)[:, None] * torch.sqrt(
        aux["xc_sq"][safe]) + 1e-5
    if metric is Metric.COSINE:
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][safe]).clamp_min(1e-30)
    fin = torch.isfinite(want)
    assert bool(((got - want).abs() <= tol.expand_as(got))[fin].all())


def _gather_corpus(rng, d: int, dev, n: int = 3000) -> DeviceCorpus:
    corpus = _aux(rng.normal(size=(n, d)).astype(np.float32) + 0.5, dev)
    corpus.set_tombstones(np.arange(n) % 7 == 3)
    return corpus


@pytest.mark.parametrize("d", [7, 64, 130])
@pytest.mark.parametrize("s", [1, 127, 128, 129])
@pytest.mark.parametrize("b", [1, 8, 9, 32, 33, 256])
def test_bf16_gather_shared_list_routes(dev, b, s, d):
    """K11's shared-list tile (one (1, S) list for every query) at the edges
    of its shapes: one n-tile of 8 queries and two (B = 8, 9), one and two
    query groups (B = 32, 33, 256), a partial, a whole and a second row tile
    (S = 127, 128, 129), 16-byte copies (D = 64) and scalar loads (D = 7,
    130); deleted rows' slots (-inf slot keys) and -1 ids empty."""
    rng = np.random.default_rng(100 * b + 10 * s + d)
    corpus = _gather_corpus(rng, d, dev)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    idx = torch.from_numpy(np.sort(rng.choice(3000, s, replace=False)).astype(np.int32))[None]
    idx = idx.to(dev)
    if s > 1:
        idx[0, 5 % s] = -1
    slot = torch.where(corpus.valid_mask()[idx.clamp_min(0).long()], 0.0, float("-inf"))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    for metric in METRICS:
        args = (q, x16, aux, idx, slot, metric)
        got = scan.bf16_gather_scores(*args, shared=True)
        want = scan.bf16_gather_scores_plain(*args, shared=True)
        torch.cuda.synchronize()
        assert got.shape == (b, s)
        dead = (idx[0] < 0) | torch.isinf(slot[0])
        assert bool(torch.isinf(got[:, dead]).all())
        _assert_gather_k2_bound(q, aux, idx, got, want, metric)


@pytest.mark.parametrize("case", ["all_empty", "unaligned", "per_query_4000",
                                  "per_query_4000_b1"])
def test_bf16_gather_scores_edges(dev, case):
    """K11 where every slot of the shared list is empty (-inf keys), the
    shared list from a corpus base 2 bytes past 16-byte alignment (scalar
    loads at D = 64), and the per-query mode at the quantized path's
    S = 4,000 with empty slots, at B = 40 and at B = 1 (a (1, S) list that
    is not shared: the per-query route, unchanged: rtol 1e-5, atol 1e-4)."""
    rng = np.random.default_rng(21)
    corpus = _gather_corpus(rng, 64, dev)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    b = 1 if case == "per_query_4000_b1" else 40
    q = torch.from_numpy(rng.normal(size=(b, 64)).astype(np.float32)).to(dev)
    per_query = case.startswith("per_query")
    if per_query:
        idx = torch.from_numpy(rng.integers(0, 3000, size=(b, 4000)).astype(np.int32)).to(dev)
        idx[:, :9] = -1
        slot = torch.from_numpy(rng.normal(size=(b, 4000)).astype(np.float32)).to(dev)
        slot[:, -11:] = float("-inf")
    else:
        idx = torch.from_numpy(np.arange(0, 3000, 5).astype(np.int32))[None].to(dev)
        slot = torch.zeros(idx.shape, device=dev)
        if case == "all_empty":
            slot[:] = float("-inf")
        else:
            x16 = _unaligned(x16)
    for metric in METRICS:
        args = (q, x16, aux, idx, slot, metric)
        got = scan.bf16_gather_scores(*args, shared=not per_query)
        want = scan.bf16_gather_scores_plain(*args, shared=not per_query)
        torch.cuda.synchronize()
        if case == "all_empty":
            assert bool((got == float("-inf")).all())
        elif case == "unaligned":
            _assert_gather_k2_bound(q, aux, idx, got, want, metric)
        else:
            assert torch.equal(torch.isinf(got), torch.isinf(want))
            fin = torch.isfinite(want)
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", OTHER_METRICS, ids=[m.value for m in OTHER_METRICS])
def test_metric_corpus_cuda_matches_cpu(dev, monkeypatch, metric):
    """DeviceCorpus on the card against the CPU (plain versions): search
    unfiltered and filtered, range search, rescore; the L1 family's
    approximate search with APPROX_MIN_ROWS lowered to engage it."""
    monkeypatch.setattr(DeviceCorpus, "APPROX_MIN_ROWS", 1000)
    rng = np.random.default_rng(13)
    d = 2 if metric is Metric.HAVERSINE else 24
    x = _metric_rows(metric, rng, 6000, d)
    q = _metric_rows(metric, rng, 12, d)[3:]
    mask = rng.random(6000) < 0.3
    cand = rng.integers(0, 6000, size=(len(q), 40))
    cand[:, -5:] = -1
    out = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(d, device=device)
        corpus.append(x)
        corpus.set_tombstones(np.arange(6000) % 13 == 0)
        top = corpus.search(q, 11, metric)
        res = [top, corpus.search(q, 10, metric, filter_mask=mask)]
        if metric.supports_flat_approx:
            res.append(corpus.search_approx(q, 10, metric))
        threshold = float((top[0][0, 9] + top[0][0, 10]) / 2)  # between two rows
        res.append(corpus.range_search(q[0], threshold, metric, max_results=50))
        out.append((res, corpus.rescore(q, cand, metric)))
    (g_res, g_re), (w_res, w_re) = out
    for (gd, gi), (wd, wi) in zip(g_res, w_res):
        gd, gi, wd, wi = (np.atleast_2d(a) for a in (gd, gi, wd, wi))
        assert gi.shape == wi.shape
        _assert_keys_close(metric, torch.from_numpy(-gd), torch.from_numpy(-wd))
        _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)
    np.testing.assert_array_equal(np.isnan(g_re), np.isnan(w_re))
    fin = np.isfinite(w_re)
    _assert_keys_close(metric, torch.from_numpy(-g_re[fin]), torch.from_numpy(-w_re[fin]))


@pytest.mark.parametrize("metric", METRICS)
def test_gather_route_cuda_matches_cpu(dev, metric):
    """A filter of a tenth of the rows takes the gather route (K11 over the
    shared list, K5, K3) on the card and the CPU alike, scanned rows
    included."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(20000, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    mask = np.arange(20000) % 10 == 3
    out = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(32, device=device)
        corpus.append(x)
        corpus.set_tombstones(np.arange(20000) % 17 == 0)
        out.append(corpus.search(q, 10, metric, filter_mask=FilterHandle(mask)))
        assert corpus.last_scanned == 2000 + corpus._shortlist_size(10, 2000)
    (gd, gi), (wd, wi) = out
    assert np.all(mask[gi]) and not np.any(gi % 17 == 0)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)


# ── K16b and K6g: the binary IVF scan, the graph kernels' domain metrics ──

GRAPH_DOMAIN = list(graph_ops.DOMAIN_METRICS)


def _domain_space(metric: Metric, dev, seed: int, n: int, d: int = _GRAPH_DIM):
    """Rows of a domain metric with their corner rows, on the card, and the
    MetricRows the graph kernels read."""
    x = _metric_rows(metric, np.random.default_rng(seed), n, d)
    xd = torch.from_numpy(x).to(dev)
    return x, xd, graph_ops.graph_space(xd, metric)


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("metric", GRAPH_DOMAIN, ids=[m.value for m in GRAPH_DOMAIN])
def test_beam_search_metric_tier_matches_plain(dev, metric, expand):
    """K17's metric tier equal to its plain version to the bit (the same
    lane-ordered sums, the same epilogue operations), on a graph built on the
    card under the same metric."""
    x, xd, space = _domain_space(metric, dev, 21, 3000)
    rng = np.random.default_rng(22)
    graph = torch.from_numpy(graph_ops.build_vamana(space, metric, r=16, l_build=32)).to(dev)
    valid = torch.from_numpy(rng.random(len(x)) >= 0.1).to(dev)
    q = xd[torch.from_numpy(rng.integers(0, len(x), 6)).to(dev)] * 1.01
    per_query = torch.from_numpy(rng.integers(0, len(x), size=(6, 5), dtype=np.int32)).to(dev)
    shared = torch.from_numpy(rng.choice(len(x), 600, replace=False).astype(np.int32)).to(dev)
    for starts in (per_query, shared):
        got, want = _walk_both("metric", metric.value, q, (space,), graph, starts, valid, 48,
                               expand)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (metric, expand)
        ids = got[1].cpu().numpy()
        assert valid.cpu().numpy()[ids[ids >= 0]].all()


@pytest.mark.parametrize("l", [16, 64])
@pytest.mark.parametrize("metric", GRAPH_DOMAIN, ids=[m.value for m in GRAPH_DOMAIN])
def test_topl_scan_metric_matches_plain(dev, metric, l):
    """K19's metric mode against its plain version: the same -inf slots,
    keys within the family's tolerance, ids swapped only between near-equal
    keys, self-matches and rows past n_real masked."""
    n = 12_000
    x, xd, space = _domain_space(metric, dev, l, n, 48)
    for lo, hi in ((0, 1024), (1024, 1024 + 37), (n - 300, n)):  # ragged chunks
        q_ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        args = (space[lo:hi], q_ids, space, None, None, n - 7, l, graph_ops.TOPL_METRIC)
        gk, gi = graph_ops.topl_scan(*args)
        wk, wi = graph_ops.topl_scan_plain(*args)
        torch.cuda.synchronize()
        _assert_keys_close(metric, gk, wk)
        ids, fin = gi.cpu().numpy(), torch.isfinite(wk)
        assert not ((ids == np.arange(lo, hi)[:, None]) & fin.cpu().numpy()).any()
        assert (ids < n - 7).all()  # an invalid row's -inf slots fill in id order
        qt = space[lo:hi].transform()
        ct = space.transform()
        rekeyed = scan.metric_keys_plain(qt, ct, None, metric, ids=gi.clamp_min(0))
        _assert_keys_close(metric, torch.where(fin, rekeyed, wk), wk)


_INVALID_ROWS = [Metric.HELLINGER, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON, Metric.HAVERSINE]


@pytest.mark.parametrize("l", [64, 256])
@pytest.mark.parametrize("metric", _INVALID_ROWS, ids=[m.value for m in _INVALID_ROWS])
def test_topl_scan_metric_invalid_rows(dev, metric, l):
    """Rows 0-2 of ``_metric_rows`` are invalid (a negative probability,
    |lat| > 90): such a query has no finite distance, and its list is the
    rows in id order at -inf, exactly as the plain version's (its own row
    among them). Chunks of one and 37 queries over 300,000 rows, so each
    span holds many tiles."""
    n = 300_000
    _, _, space = _domain_space(metric, dev, 31, n, 48)
    for lo, hi in ((0, 1), (0, 37)):
        q_ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        args = (space[lo:hi], q_ids, space, None, None, n, l, graph_ops.TOPL_METRIC)
        gk, gi = graph_ops.topl_scan(*args)
        wk, wi = graph_ops.topl_scan_plain(*args)
        torch.cuda.synchronize()
        dead = torch.isneginf(wk).all(1)
        assert bool(dead[:3].all())
        assert torch.equal(gk[dead], wk[dead]) and torch.equal(gi[dead], wi[dead])
        assert torch.equal(gi[dead][0].long().cpu(), torch.arange(l))
        if bool(dead.all()):  # a chunk of one invalid query: nothing finite to compare
            continue
        _assert_keys_close(metric, gk, wk)
        rekeyed = scan.metric_keys_plain(space[lo:hi].transform(), space.transform(), None,
                                         metric, ids=gi.clamp_min(0))
        _assert_keys_close(metric, torch.where(torch.isfinite(wk), rekeyed, wk), wk)


_METRIC_PRUNE_CASES = [(m, l, 2 if m is Metric.HAVERSINE else d, bs, "corners")
                       for m in GRAPH_DOMAIN for l, d, bs in _PRUNE_SHAPES]
_METRIC_PRUNE_CASES.append((Metric.HAVERSINE, 72, 2, 300, "poles"))


@pytest.mark.parametrize("metric,l,d,bs,data", _METRIC_PRUNE_CASES,
                         ids=[f"{c[0].value}-{c[1]}-{c[2]}-{c[3]}-{c[4]}"
                              for c in _METRIC_PRUNE_CASES])
def test_robust_prune_metric_matches_plain(dev, metric, l, d, bs, data):
    """K20's pair tables under a domain metric equal to the plain version's
    to the bit: the prune and both keys modes, over the corner rows (invalid,
    zero-mass and constant rows, |lat| > 90) and NaN and infinite entries;
    Haversine's whole table also over points near the poles and the
    antimeridian."""
    n = 5000
    rng = np.random.default_rng(l + d)
    if data == "poles":
        x = np.stack([rng.choice([-180.0, 180.0], n) + rng.normal(scale=1e-3, size=n),
                      rng.choice([-1.0, 1.0], n) * (90.0 - np.abs(rng.normal(scale=0.5, size=n)))],
                     1).astype(np.float32)
        x[::7, 0] = 179.9999  # the antimeridian from both sides
        x[1::7, 0] = -179.9999
    else:
        x = _metric_rows(metric, rng, n, d)
        x[6, 0], x[7, 0], x[8, -1] = np.nan, np.inf, -np.inf
    xd = torch.from_numpy(x).to(dev)
    _prune_both_modes(dev, graph_ops.graph_space(xd, metric), metric, n, l, bs, 4 + l)


@pytest.mark.parametrize("bits", [100, 1024])
@pytest.mark.parametrize("mode", ["IVF-HAMMING", "IVF-JACCARD"])
def test_binary_ivf_index_cuda_matches_cpu(dev, tmp_path, mode, bits):
    """An IVF-HAMMING / -JACCARD index built on the card: K16b equal to its
    plain version to the bit, and the answers on the card those of the plain
    versions on the CPU over a copy of the index files, before and after the
    same rows are added and committed in both."""
    rng = np.random.default_rng(bits)
    protos = rng.random((40, bits)) < 0.2
    rows = protos[rng.integers(0, 40, 6300)] ^ (rng.random((6300, bits)) < 0.03)
    x, extra, q = (rows[:6000].astype(np.float32), rows[6000:6291].astype(np.float32),
                   rows[6291:].astype(np.float32))
    answers = []
    for device, root in ((dev, tmp_path / "card"), ("cpu", tmp_path / "host")):
        if answers:
            shutil.copytree(tmp_path / "built", root)
        client = lynsedb_tpu_torch.VectorDBClient(root, device=device)
        db = client.get_database("d") if answers else client.create_database("d")
        coll = db.require_collection("c", dim=bits)
        if not answers:
            coll.add(vectors=x, fields=[{"b": i % 2} for i in range(6000)])
            coll.commit()
            coll.build_index(mode, n_clusters=24)
            shutil.copytree(root, tmp_path / "built")
        out = [coll.batch_search(q, k=10, nprobe=p, where=w)
               for p in (1, 6) for w in (None, "b = 0")]
        eng = coll._engine
        if device == dev:
            idx, state = eng._index, eng._index._device_state(eng)
            qd = torch.from_numpy(q).to(dev)
            qt = D.query_transform(qd, idx.metric)
            top_c = ivf._top_clusters(qd, state["centroids"], idx.metric, 6)
            args = (qt["bits"], qt["cnt"], top_c, state["cluster_blocks"], state["blocks"],
                    state["block_sq"], state["block_orig"],
                    eng.corpus().valid_mask(np.arange(6000) % 3 == 0), idx.metric)
            got, want = ivf.ivf_binary_blocks(*args), ivf.ivf_scan_blocks_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        coll.add(vectors=extra, fields=[{"b": i % 2} for i in range(6000, 6291)])
        coll.commit()  # on_commit posts the rows by L2 to the float centroids
        answers.append(out + [coll.batch_search(q, k=10, nprobe=6)])
        client.close()
    for got, want in zip(*answers):  # ids may differ only among equal distances
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.distances, w.distances)


def binary_probe_state(rng, bits: int, sizes, n_rows: int, live_frac: float = 0.8):
    """An IVF-HAMMING index's device arrays by hand: cluster c holds sizes[c]
    rows (a cluster of more than 2 x 2,048 rows spans three blocks, a cluster
    of 0 rows none), its blocks -1 padded in ``cluster_blocks``, the rows'
    bit-packed words and counts in block order with zero padding rows; the
    last block's rows all deleted. Returns (cluster_blocks, blocks, counts,
    block_orig, live) as CPU tensors."""
    bs = ivf.BLOCK_SIZE
    bpc = [-(-n // bs) for n in sizes]
    max_bpc = max(max(bpc), 1)
    cluster_blocks = np.full((len(sizes), max_bpc), -1, np.int32)
    block_orig = np.full((max(sum(bpc), 1), bs), -1, np.int32)
    rows = rng.permutation(n_rows)
    at = nb = 0
    for c, n in enumerate(sizes):
        for i in range(bpc[c]):
            seg = rows[at + i * bs : at + min(n, (i + 1) * bs)]
            block_orig[nb, : len(seg)] = seg
            cluster_blocks[c, i] = nb
            nb += 1
        at += n
    x = torch.from_numpy(rng.random((n_rows, bits)) < 0.2).float()
    ct = D.corpus_transform(x, Metric.HAMMING)
    flat = torch.from_numpy(block_orig.reshape(-1))
    pad = flat >= 0
    words = (ct["bits"][flat.clamp_min(0).long()] * pad[:, None]).view(-1, bs, ct["bits"].shape[1])
    counts = ct["cnt"][flat.clamp_min(0).long()] * pad
    live = torch.from_numpy(rng.random(n_rows) < live_frac)
    live[torch.from_numpy(block_orig[nb - 1][block_orig[nb - 1] >= 0]).long()] = False
    return torch.from_numpy(cluster_blocks), words.contiguous(), counts, flat, live


@pytest.mark.parametrize("bits", [100, 1024])
@pytest.mark.parametrize("b", [1, 16, 17, 256])
@pytest.mark.parametrize("metric", [Metric.HAMMING, Metric.JACCARD])
def test_binary_ivf_blocks_routes_match_plain(dev, metric, b, bits):
    """K16b on both routes (a row a thread, and the inverted probe's b1 tile)
    at B in {1, 16, 17, 256}, W = 4 and 32, equal to the bit to the plain
    version: clusters of 0 to three blocks, padding, deleted rows, a block
    whose rows are all deleted, queries probing a popular cluster together."""
    rng = np.random.default_rng(b * bits)
    sizes = [5000, 0, 2048, 1, 700, 3000] + [int(v) for v in rng.integers(1, 900, 20)]
    n_rows = sum(sizes)
    state = [t.to(dev) for t in binary_probe_state(rng, bits, sizes, n_rows)]
    cluster_blocks, blocks, counts, block_orig, live = state
    nprobe = 6
    q = torch.from_numpy(rng.random((b, bits)) < 0.2).float().to(dev)
    qt = D.query_transform(q, metric)
    top_c = torch.from_numpy(np.stack([rng.permutation(len(sizes))[:nprobe] for _ in range(b)])
                             .astype(np.int32)).to(dev)
    top_c[: b // 2, 0] = 0  # half the batch probes the three-block cluster
    args = (qt["bits"], qt["cnt"], top_c, cluster_blocks, blocks, counts, block_orig, live, metric)
    want = ivf.ivf_scan_blocks_plain(*args)
    saved = ivf.BINARY_TILE_MIN_B
    try:
        for route_min_b in (1, 1 << 20):
            ivf.BINARY_TILE_MIN_B = route_min_b
            got = ivf.ivf_binary_blocks(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    finally:
        ivf.BINARY_TILE_MIN_B = saved


def f32_probe_state(rng, d: int, sizes, n_rows: int):
    """An f32 IVF index's device arrays by hand, laid out as
    binary_probe_state lays out its own (a cluster of three blocks, empty
    clusters, padding, a last block whose rows are all deleted): returns
    (cluster_blocks, blocks, block_sq, block_orig, live) as CPU tensors."""
    bs = ivf.BLOCK_SIZE
    cluster_blocks, _, _, block_orig, live = binary_probe_state(rng, 32, sizes, n_rows)
    x = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32))
    pad = block_orig >= 0
    blocks = x[block_orig.clamp_min(0).long()] * pad[:, None]
    block_sq = D.corpus_transform(blocks, Metric.L2)["sq"]
    return cluster_blocks, blocks.view(-1, bs, d).contiguous(), block_sq, block_orig, live


@pytest.mark.parametrize("d", [7, 32, 128])
@pytest.mark.parametrize("b", [1, 8, 9, 15, 16, 17, 256])
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_scan_routes_match_plain(dev, metric, b, d):
    """K16 on every route (a row a thread, the inverted probe over the
    listed blocks, a warp a row) at B around the crossovers and past them,
    D = 7 on the scalar loads: keys within K16's tolerance of the plain
    version's, the -inf pattern equal, the rows and tile routes equal to
    the bit; a cluster of three blocks, empty clusters, a block with no
    live row, half the batch probing the widest cluster; the shared launch
    pushed to either side (min_share 0 and inf) equal to that route to the
    bit, and the batch's own launch to the route it takes."""
    rng = np.random.default_rng(b * d + 1)
    sizes = [5000, 0, 2048, 1, 700, 3000] + [int(v) for v in rng.integers(1, 900, 20)]
    n_rows = sum(sizes)
    cluster_blocks, blocks, block_sq, block_orig, live = [
        t.to(dev) for t in f32_probe_state(rng, d, sizes, n_rows)]
    nprobe = 6
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    top_c = torch.from_numpy(np.stack([rng.permutation(len(sizes))[:nprobe] for _ in range(b)])
                             .astype(np.int32)).to(dev)
    top_c[: b // 2, 0] = 0
    args = (q, (q * q).sum(-1), top_c, cluster_blocks, blocks, block_sq, block_orig, live, metric)
    want = ivf.ivf_scan_blocks_plain(*args)
    fin = torch.isfinite(want)
    got = {}
    for route in ("rows", "tile", "warp"):
        got[route] = ivf.scan_blocks_route(*args, route)
        torch.cuda.synchronize()
        assert torch.equal(torch.isfinite(got[route]), fin), route
        err = (got[route][fin] - want[fin]).abs()
        assert bool((err <= 1e-4 + 1e-5 * want[fin].abs()).all()), route
    assert torch.equal(got["tile"].view(torch.int32), got["rows"].view(torch.int32))
    for min_share, side in ((0.0, "tile"), (float("inf"), "warp")):
        shared = ivf.scan_blocks_route(*args, "shared", min_share)
        assert torch.equal(shared.view(torch.int32), got[side].view(torch.int32)), side
    route = ivf._scan_route(b)
    taken = ivf.shared_route(top_c, cluster_blocks) if route == "shared" else route
    auto = ivf.ivf_scan_blocks(*args).view(torch.int32)
    assert torch.equal(auto, got[taken].view(torch.int32))


@pytest.mark.parametrize("mode", ["HNSW-L1", "HNSW-JENSEN-SHANNON", "HNSW-HAVERSINE"])
def test_domain_hnsw_index_cuda_matches_cpu(dev, tmp_path, mode):
    """The same collection indexed, searched, grown and searched again on the
    card and on the CPU: nearly the same graph (K19's sums run in another
    order than the plain version's, so a near-tie may flip an edge) and the
    same answers in nearly every query."""
    metric = Metric.from_index_mode(mode)
    d = 2 if metric is Metric.HAVERSINE else 32
    rng = np.random.default_rng(9)
    x = _metric_rows(metric, rng, 4200, d)
    q = _metric_rows(metric, np.random.default_rng(10), 20, d)[5:]
    answers, graphs = [], []
    for i, device in enumerate((dev, "cpu")):
        client = lynsedb_tpu_torch.VectorDBClient(tmp_path / f"root{i}", device=device)
        try:
            coll = client.create_database("d").require_collection("c", dim=d)
            coll.add(vectors=x[:4000], fields=[{"b": i % 2} for i in range(4000)])
            coll.commit()
            coll.build_index(mode)
            res = [coll.batch_search(q, k=10, where=where, nprobe=64) for where in (None, "b = 1")]
            coll.add(vectors=x[4000:], fields=[{"b": i % 2} for i in range(4000, 4200)])
            coll.commit()  # the in-place insert: the metric tier and K20's keys
            res.append(coll.batch_search(q, k=10, nprobe=64))
            graphs.append(coll._engine._index.layer0_np)
            answers.append([(np.asarray(r.ids), np.asarray(r.distances)) for rs in res for r in rs])
        finally:
            client.close()
    assert (graphs[0] == graphs[1]).all(axis=1).mean() >= 0.97
    same = np.mean([np.array_equal(g[0], w[0]) for g, w in zip(*answers)])
    assert same >= 0.9
    for (gi, gd), (wi, wd) in zip(*answers):
        if np.array_equal(gi, wi):
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


# ── the streaming pump (K8) and the query windows (K7) ───────────────────


def _streaming_corpus(monkeypatch, dev, n=9_000, d=24, seed=0):
    """A card corpus forced to stream in blocks of 1,152 rows (not a
    multiple of the 16- or 64-query chunk; a 930-row tail block), with
    tombstones and a filter that cross the block boundaries."""
    monkeypatch.setattr(scan, "DEVICE_BYTES", 1 << 20)
    monkeypatch.setattr(scan, "STREAM_BLOCK_BYTES", 1152 * (2 * d + 13))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) + 0.25
    corpus = DeviceCorpus(d, device=dev)
    corpus.append(x)
    tombs = np.zeros(n, dtype=bool)
    tombs[1150:1160] = True  # across the first block boundary
    corpus.set_tombstones(tombs)
    corpus.finalize()
    assert corpus.streaming
    mask = rng.random(n) < 0.5
    mask[2300:2310] = True
    return corpus, x, rng.normal(size=(70, d)).astype(np.float32), FilterHandle(mask)


@pytest.mark.parametrize("metric", [Metric.IP, Metric.L2, Metric.COSINE, Metric.L1,
                                    Metric.HAMMING, Metric.CORRELATION])
@pytest.mark.parametrize("b", [5, 70])
@pytest.mark.parametrize("filtered", [False, True])
def test_stream_pump_matches_plain_loop(dev, monkeypatch, metric, b, filtered):
    """A pass of the pump (pinned buffers, the copy stream, K8) against the
    plain loop on the card over the same blocks: the same ids, keys within
    K2's tolerance (the exact f32 pump of the other metrics: rtol 1e-5)."""
    corpus, _, q, handle = _streaming_corpus(monkeypatch, dev)
    qd = torch.from_numpy(q[:b]).to(dev)
    kind = "bf16" if metric in scan._BF16_PASS else "f32"
    c = 64
    handle = handle if filtered else None
    before = scan.stream_block.launches
    keys, ids = corpus._stream_pass(qd, metric, kind, c, handle)
    blocks = -(-corpus.n // corpus._stream_block_rows(16 if b <= 16 else 64,
                                                     24 * (2 if kind == "bf16" else 4)
                                                     + (13 if kind == "bf16" else 1)))
    assert scan.stream_block.launches - before == blocks * -(-b // (16 if b <= 16 else 64))
    pk, pi = corpus._stream_pass(qd, metric, kind, c, handle, step=scan.stream_block_plain)
    torch.cuda.synchronize()
    ok = pk > float("-inf")
    tol = 1e-5 * pk.abs() + 1e-4
    assert torch.equal(ok, keys > float("-inf"))
    assert bool(((keys - pk).abs()[ok] <= tol[ok]).all())
    diff = (ids != pi) & ok
    for r, j in zip(*torch.nonzero(diff, as_tuple=True)):  # only between near-ties
        m = torch.nonzero(pi[r] == ids[r, j]).flatten()
        assert len(m) and abs(float(pk[r, m[0]] - pk[r, j])) <= float(tol[r, j])
    valid = corpus._host_valid(handle)
    got = ids[ok].cpu().numpy()
    assert valid[got].all()  # no tombstoned or filtered-out row


def test_stream_block_ids_past_2_24(dev):
    """K8 carries int32 global ids: a block based past 2^24 (where an f32
    id would round) keeps every id exact."""
    rng = np.random.default_rng(3)
    d, r, base = 32, 700, (1 << 24) + 3
    x = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(dev)
    mean = x.mean(0)
    x16 = (x - mean).to(torch.bfloat16)
    xf = x16.float()
    aux = {"xm": (xf @ mean).contiguous(), "xc_sq": (xf * xf).sum(1),
           "xsq_true": (x * x).sum(1)}
    blk = scan.StreamBlock("bf16", x16, aux, torch.ones(r, dtype=torch.bool, device=dev), base,
                           mean)
    q = torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32)).to(dev)
    state = (torch.full((4, 64), float("-inf"), device=dev),
             torch.full((4, 64), -1, dtype=torch.int32, device=dev))
    keys, ids = scan.stream_block(q, None, blk, *state, Metric.IP, 64)
    pk, pi = scan.stream_block_plain(q, None, blk, *state, Metric.IP, 64)
    assert bool((ids >= base).all()) and bool((ids < base + r).all())
    assert torch.equal(torch.sort(ids, 1).values, torch.sort(pi, 1).values)


def test_pump_refills_a_buffer_only_after_its_scan(dev, monkeypatch):
    """Each block's H2D into a device buffer starts after the scan of the
    block that used the buffer before it (two blocks back) ended."""
    corpus, _, q, _ = _streaming_corpus(monkeypatch, dev)
    corpus.stream_trace = []
    corpus.search(q[:16], 10, Metric.IP)
    torch.cuda.synchronize()
    trace = corpus.stream_trace
    assert len(trace) >= 4
    for i in range(2, len(trace)):
        prev_scan_end, h2d_start = trace[i - 2]["events"][3], trace[i]["events"][0]
        assert prev_scan_end.elapsed_time(h2d_start) >= 0, i


@pytest.mark.parametrize("tier", ["resident", "host_rescore"])
def test_query_windows_match_search(dev, monkeypatch, tmp_path, tier):
    """search_stream's windows (a submit each: K2 -> K5 -> K3, or the host
    rescore off the resident tier) give the answers of a search of the
    same rows."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12_000, 32)).astype(np.float32)
    q = rng.normal(size=(100, 32)).astype(np.float32)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "r", device=dev)
    try:
        coll = client.create_database("d").require_collection("c", dim=32,
                                                              default_index="FLAT-L2")
        coll.add(vectors=x)
        coll.commit()
        corpus = coll._engine.corpus()
        if tier == "host_rescore":
            monkeypatch.setattr(scan, "DEVICE_BYTES",
                                corpus.host_rescore_bytes(corpus._cap_for(12_000)))
            corpus.restage()
        got = coll.search_stream(q, k=10, window=16)
        assert corpus.tier == tier
        for r, res in enumerate(got):
            want = coll.search(q[r], k=10)
            np.testing.assert_array_equal(np.asarray(res.ids), np.asarray(want.ids))
            np.testing.assert_allclose(np.asarray(res.distances), np.asarray(want.distances),
                                       rtol=1e-6, atol=1e-6)
    finally:
        client.close()

# ── K21b: the cross-shard k-means reduce; K21a: the sharded search ───────


@pytest.mark.parametrize("s,k,d", [(1, 1000, 128), (4, 1000, 128), (2, 5, 1), (7, 33, 130),
                                   (3, 1, 3), (4, 4000, 8), (5, 17, 0)])
def test_kmeans_reduce_shards_matches_plain(dev, s, k, d):
    rng = np.random.default_rng(s * 1000 + k + d)
    sums = (rng.normal(size=(s, k, d)) * 10.0 ** rng.integers(-4, 5, size=(s, k, d)))
    sums = torch.from_numpy(sums.astype(np.float32)).to(dev)
    if d:
        sums[0, 0, 0] = -0.0  # a negative zero sum keeps its sign at one shard
    counts = torch.from_numpy(rng.integers(0, 300, size=(s, k)).astype(np.float32)).to(dev)
    counts[:, k // 2] = 0.0  # an empty cluster
    old = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).to(dev)
    for _ in range(2):  # bit-identical from run to run
        got = kmeans.kmeans_reduce_shards(sums, counts, old)
        want = kmeans.kmeans_reduce_shards_plain(sums, counts, old)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[0][k // 2], old[k // 2])


def test_sharded_kmeans_step_one_shard_is_lloyd_step(dev):
    from lynsedb_tpu_torch.parallel import mesh as M

    rng = np.random.default_rng(9)
    x = rng.normal(size=(20_000, 64)).astype(np.float32)
    valid = rng.random(20_000) < 0.9
    cent = torch.from_numpy(x[:100].copy()).to(dev)
    one = M.make_mesh(1, devices=[dev])
    xs, vs = M.shard_corpus(one, x, valid)
    got, counts = M.sharded_kmeans_step_fn(one)(xs, cent, vs)
    want, want_counts, _ = kmeans._lloyd_step(torch.from_numpy(x).to(dev),
                                              torch.from_numpy(valid).to(dev), cent)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(counts, want_counts)
    four = M.make_mesh(4, devices=[dev] * 4)
    xs, vs = M.shard_corpus(four, x, valid)
    got4, counts4 = M.sharded_kmeans_step_fn(four)(xs, cent, vs)
    plain4 = M.sharded_kmeans_step_fn(four, plain=True)(xs, cent, vs)
    assert torch.equal(counts4, want_counts)
    assert bool(((got4 - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    assert torch.equal(counts4, plain4[1])


@pytest.mark.parametrize("metric", [Metric.IP, Metric.L2, Metric.L1])
@pytest.mark.parametrize("data_axis,b,k", [(1, 1, 10), (1, 16, 10), (2, 17, 1000)])
def test_sharded_search_matches_unsharded(dev, metric, data_axis, b, k):
    from lynsedb_tpu_torch.parallel import mesh as M

    rng = np.random.default_rng(b + k)
    n, d = 100_003, 48
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    valid = rng.random(n) < 0.5
    mesh = M.make_mesh(4, data_axis=data_axis, devices=[dev] * 4)
    xs, vs = M.shard_corpus(mesh, x, valid)
    qs, _ = M.shard_queries(mesh, q)
    got_d, got_i = M.sharded_search_fn(mesh, metric=metric, k=k)(xs, qs, vs)
    xd, qd = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    keys = scan.metric_keys(D.query_transform(qd, metric), D.corpus_transform(xd, metric),
                            torch.from_numpy(valid).to(dev), metric)
    top, idx = topk.topk_select(keys, k)
    torch.cuda.synchronize()
    want_d = topk.unorient(top, metric.ascending)
    got_d, got_i = got_d[:b], got_i[:b]
    err = (got_d - want_d).abs()
    assert bool((err <= 1e-5 * want_d.abs() + 1e-5).all())
    for r in range(b):  # an id may differ only at a tie of its key within the row
        for c in torch.nonzero(got_i[r] != idx[r].long()).flatten().tolist():
            near = (want_d[r] - want_d[r, c]).abs() <= 1e-5 * want_d[r, c].abs() + 1e-5
            assert int(near.sum()) > 1, (r, c)


INT_MAX = 2**31 - 1


def _shortlist(rng, b: int, s: int, n: int, dev, dups: bool = False):
    """A top-S shortlist a query as K5 leaves it: row ids (B, S) int32 and
    keys descending; a -1 id at slot 3, -inf keys on the last 5 slots and
    K5's pad id (INT_MAX) on the last 3 of them; with ``dups`` slot 1 lists
    slot 0's row again; query 0 of a batch of more than 2 all empty."""
    cand = np.stack([rng.choice(n, s, replace=n < s) for _ in range(b)]).astype(np.int32)
    keys = -np.sort(-rng.normal(size=(b, s)).astype(np.float32), axis=1)
    if dups and s > 4:
        cand[:, 1] = cand[:, 0]
    if s > 8:
        cand[:, 3] = -1
        keys[:, -5:] = -np.inf
        cand[:, -3:] = INT_MAX
    if b > 2:
        keys[0] = -np.inf
    return torch.from_numpy(cand).to(dev), torch.from_numpy(keys).to(dev)


def _gather_tol(q, aux, ids, metric):
    """K2's bound a (query, row): 1e-5 |q - m| |x - m| + 1e-5 (cosine: over
    its denominator)."""
    safe = ids.clamp_min(0).long()
    tol = 1e-5 * (q - aux["mean"][None, :]).norm(dim=1)[:, None] * torch.sqrt(
        aux["xc_sq"][safe]) + 1e-5
    if metric is Metric.COSINE:
        tol = tol / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][safe]).clamp_min(1e-30)
    return tol


def _two_launch_stage(q, x16, aux, cand, top, metric, c):
    """The second stage as two kernels: K11's per-query mode, then K5."""
    keys = scan.bf16_gather_scores(q, x16, aux, cand, top, metric)
    top2, j = topk.topk_select(keys, min(c, keys.shape[1]))
    return top2, torch.where(top2 > float("-inf"), cand.gather(1, j.long()), -1)


def _assert_stage(q, x16, aux, metric, got, want, chain=None):
    """The fused stage against the plain chain: the same live slots, keys
    descending, each key within K2's bound of its row's plain key, the plain
    chain's rows but for near-ties of the C-th key (within twice the bound);
    under IP against the two-launch kernel chain (``chain``) bit for bit,
    the sign of a zero aside."""
    (gk, gi), (wk, wi) = got, want
    assert gk.shape == wk.shape and gi.shape == wi.shape and gi.dtype == torch.int32
    live = gi >= 0
    assert torch.equal(live, wi >= 0) and torch.equal(live, gk > float("-inf"))
    assert bool((gk[:, :-1] >= gk[:, 1:]).all())
    plain = scan.bf16_gather_scores_plain(q, x16, aux, gi, None, metric)
    tol = _gather_tol(q, aux, gi, metric)
    assert bool(((gk - plain).abs() <= tol)[live].all())
    for r in torch.nonzero((gi != wi).any(1)).flatten().tolist():
        swapped = set(gi[r][live[r]].tolist()) ^ set(wi[r][live[r]].tolist())
        if not swapped:
            continue
        rows = torch.tensor(sorted(swapped), dtype=torch.int32, device=gi.device)[None]
        k_rows = scan.bf16_gather_scores_plain(q[r : r + 1], x16, aux, rows, None, metric)[0]
        kth = float(wk[r][live[r]][-1])
        assert bool(((k_rows - kth).abs() <= 2 * tol[r][live[r]].max()).all()), (r, swapped)
    if chain is not None and metric is Metric.IP:
        assert torch.equal(gi, chain[1])
        assert torch.equal((gk + 0.0).view(torch.int32), (chain[0] + 0.0).view(torch.int32))


_STAGE_CASES = [  # (b, s, d, c, dups): each cluster size, route and edge of the fused stage
    (1, 4000, 128, 64, False), (16, 4000, 128, 64, True), (64, 4000, 128, 64, False),
    (300, 3000, 64, 100, False), (5, 3000, 130, 256, True), (3, 2500, 7, 64, False),
    (4, 1500, 256, 64, False), (2, 1000, 768, 256, False), (2, 700, 2560, 16, True),
    (9, 50, 64, 64, False), (70_000, 16, 8, 8, False), (2, 1000, 1536, 256, False),
    (3, 800, 1536, 64, True), (3, 800, 2048, 64, False),
]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,s,d,c,dups", _STAGE_CASES)
def test_bf16_gather_topc_matches_plain(dev, metric, b, s, d, c, dups):
    """K11's fused second stage against the plain chain and the two-launch
    kernel chain: clusters of 8, 4 and 1 blocks (B = 1 and 16, 64, 300 and
    70,000: past one grid dimension), several 1,024-slot chunks a block (B
    = 300), the half-warp and whole-warp ring (D <= 128, D = 256 and 768;
    one row a stage at D = 1,536 and C = 64), the direct route (D = 7 and
    130, not multiples of 8; D = 1,536 at C = 256 and D = 2,048 and 2,560,
    where no ring fits the block's shared memory), C not a power of two and
    at its limit of 256, S below C, a row
    listed twice, -1 and INT_MAX ids, -inf slots and an all-empty query."""
    rng = np.random.default_rng(b + s + d)
    n = 5000 if d > 1000 else 20_000
    corpus = _gather_corpus(rng, d, dev, n)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    cand, top = _shortlist(rng, b, s, n, dev, dups)
    args = (q, x16, aux, cand, top, metric, c)
    got = scan.bf16_gather_topc(*args)
    want = scan.bf16_gather_topc_plain(*args)
    # K11's per-query mode takes at most 65,535 queries (a grid dimension)
    chain = _two_launch_stage(*args) if b <= 65_535 else None
    torch.cuda.synchronize()
    assert got[0].shape == (b, min(c, s))
    if b > 2:
        assert bool((got[1][0] == -1).all())
    _assert_stage(q, x16, aux, metric, got, want, chain)


def test_bf16_gather_topc_unaligned_and_routing(dev):
    """The fused stage over a corpus base 2 bytes past 16-byte alignment
    (the direct route at D = 64), and shortlist_device_rescore_ids' routes:
    C <= GATHER_TOPC_MAX one fused launch, above it K11's per-query mode and
    K5 (two launches), the same rows but at near-ties."""
    rng = np.random.default_rng(31)
    corpus = _gather_corpus(rng, 64, dev, 20_000)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)).to(dev)
    cand, top = _shortlist(rng, 6, 2000, 20_000, dev)
    for metric in METRICS:
        args = (q, _unaligned(x16), aux, cand, top, metric, 64)
        got, want = scan.bf16_gather_topc(*args), scan.bf16_gather_topc_plain(*args)
        torch.cuda.synchronize()
        _assert_stage(q, x16, aux, metric, got, want)
    approx = torch.from_numpy(rng.normal(size=(6, 20_000)).astype(np.float32)).to(dev)
    for c in (64, scan.GATHER_TOPC_MAX, 300):
        before = dict(scan.bf16_gather_scores.by_mode)
        got = scan.shortlist_device_rescore_ids(q, approx, x16, aux, Metric.IP, 2000, c)
        mode = "fused" if c <= scan.GATHER_TOPC_MAX else "per_query"
        assert scan.bf16_gather_scores.by_mode[mode] == before[mode] + 1
        t, cd = topk.topk_select(approx, 2000)
        _assert_stage(q, x16, aux, Metric.IP, got,
                      scan.bf16_gather_topc_plain(q, x16, aux, cd, t, Metric.IP, c))


_RESCORE_CASES = [  # (b, c, d, k): the rank and sort selections, every D step, B past a grid dim
    (1, 64, 128, 10), (16, 256, 128, 10), (3, 1, 96, 1), (5, 100, 130, 100), (2, 257, 7, 20),
    (4, 1024, 1, 1000), (33, 64, 96, 64), (70_000, 16, 8, 4),
]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,c,d,k", _RESCORE_CASES)
def test_rescore_topk_routes_match_plain(dev, metric, b, c, d, k):
    """K3 in both block widths (256 and 1,024 threads) and the plan's own
    choice against each other bit for bit and against the plain version
    (K3's tolerance, ids equal but
    at ties within it), with duplicated rows and a row listed twice (ties
    broken by id, both copies kept), rows with a NaN or an infinity (scores
    dropped), empty slots and k above the live slots; under IP against the
    model of the kernel's float32 sum order (tests/test_torch_rescore_plan.py)
    bit for bit."""
    from test_torch_rescore_plan import rescore_model

    rng = np.random.default_rng(b + c + d + k)
    n = 3000
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[10:14] = x[20]
    x[30, 0], x[31, -1] = np.nan, np.inf
    x32 = torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    cand = rng.integers(0, n, size=(b, c)).astype(np.int32)
    cand[:, : min(c, 6)] = np.array([10, 11, 12, 20, 30, 31])[: min(c, 6)]
    if c > 8:
        cand[:, 7] = cand[:, 6]
    keys = rng.normal(size=(b, c)).astype(np.float32)
    keys[:, c - c // 3 :] = -np.inf
    args = (q, x32, torch.from_numpy(keys).to(dev), torch.from_numpy(cand).to(dev), k, metric)
    outs = [scan.rescore_topk(*args)] + [scan.rescore_topk(*args, wide=w) for w in (False, True)]
    want_d, want_i = scan.rescore_topk_plain(*args)
    torch.cuda.synchronize()
    nd, ni = outs[0]
    for wd_, wi_ in outs[1:]:
        assert torch.equal(nd.view(torch.int32), wd_.view(torch.int32)) and torch.equal(ni, wi_)
    fin = torch.isfinite(want_d)
    assert torch.equal(fin, torch.isfinite(nd))
    torch.testing.assert_close(nd[fin], want_d[fin], rtol=1e-5, atol=1e-4)
    wd = torch.where(fin, want_d, 0.0).cpu().numpy()
    _assert_ids_match(ni.cpu().numpy(), want_i.cpu().numpy(), wd,
                      1e-5 * np.abs(wd).max(axis=1) + 1e-4)
    if metric is Metric.IP and b <= 64:
        md, mi = rescore_model(q.cpu().numpy(), x, keys, cand, k, metric)
        assert np.array_equal(nd.cpu().numpy().view(np.uint32), md.view(np.uint32))
        assert np.array_equal(ni.cpu().numpy(), mi)

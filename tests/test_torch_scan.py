"""lynsedb_tpu_torch's DeviceCorpus on the CPU (the kernels' plain versions)
against lynsedb_tpu.ops.scan.DeviceCorpus, on the same seeded inputs.

Sizes: N=2,000 (the exact K1 plan) and N=20,000 (the two-pass K2 -> K5 -> K3
plan), D=32. Parameters: IP/L2/cosine, B in {1, 16}, k in {1, 10, 100},
tombstones, no filter / a 50% filter / a 10% filter (the JAX package gathers
the 10% one, K4; the port masks it), duplicated rows.

Tolerances: the centred bf16 copies are bit-identical as uint16; the mean and
aux arrays agree to rtol=1e-6; distances agree to rtol=1e-5, atol=1e-4 (f32
sums taken in another order); ids are identical except where the two rows at
a position are a near-tie, their float64 distances within that tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lynsedb_tpu.ops.scan as jax_scan
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops.scan import DeviceCorpus, FilterHandle, host_exact_scores

DIM = 32
SIZES = (2000, 20000)
METRICS = ("ip", "l2", "cosine")


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op torch thread for a test module. The plain versions run
    many small torch ops, which one thread runs about as fast, and parallel
    test workers then do not oversubscribe the cores (each worker's torch
    would start a thread a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n: int):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, DIM)).astype(np.float32) + 0.25
    x[n // 2 : n // 2 + 40] = x[:40]  # duplicated rows: exact ties broken by id
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    q[3] = x[5]  # a query whose best rows are a duplicated pair
    tombs = rng.random(n) < 0.05
    masks = {"none": None, "half": rng.random(n) < 0.5, "tenth": rng.random(n) < 0.1}
    return x, q, tombs, masks


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for n in SIZES:
        x, q, tombs, masks = _data(n)
        jc = jax_scan.DeviceCorpus(DIM)
        tc = DeviceCorpus(DIM, device="cpu")
        for c in (jc, tc):
            c.append(x[: n // 2])
            c.append(x[n // 2 :])
            c.set_tombstones(tombs)
            c.finalize()
        out[n] = (jc, tc, q, masks)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_staged_copies_match(corpora, n):
    jc, tc, _, _ = corpora[n]
    j16 = np.asarray(jc._dev16)[: jc.n].view(np.uint16)
    t16 = tc._dev16[: tc.n].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(t16, j16)
    np.testing.assert_allclose(tc._mean_np, jc._mean_np, rtol=1e-6)
    for name in ("_sq_host", "_xm_host", "_xsqtrue_host"):
        np.testing.assert_allclose(getattr(tc, name)[: n], getattr(jc, name)[: n], rtol=1e-6,
                                   atol=1e-6)


def _dist64(row: np.ndarray, q: np.ndarray, metric: str) -> float:
    row, q = row.astype(np.float64), q.astype(np.float64)
    if metric == "ip":
        return float(row @ q)
    if metric == "l2":
        return float(((row - q) ** 2).sum())
    return float(1.0 - row @ q / np.sqrt((row @ row) * (q @ q)))


def assert_same_ids(ti, ji, x, q, metric):
    """ids identical, except at a position where the two engines' rows are a
    near-tie: their float64 distances agree within the distance tolerance
    (f32 sums in another order may swap them)."""
    assert ti.shape == ji.shape
    for r, c in zip(*np.nonzero(ti != ji)):
        assert ti[r, c] >= 0 and ji[r, c] >= 0, (r, c)
        d_t, d_j = (_dist64(x[i], q[r], metric) for i in (ti[r, c], ji[r, c]))
        assert abs(d_t - d_j) <= 1e-4 + 1e-5 * abs(d_j), (r, c, d_t, d_j)


def _compare(jc, tc, q, k, metric, mask):
    jd, ji = jc.search(q, k, JaxMetric(metric), filter_mask=mask)
    td, ti = tc.search(q, k, Metric(metric), filter_mask=None if mask is None else FilterHandle(mask))
    assert_same_ids(ti, ji, tc._host, q, metric)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    # every returned distance is its row's exact score on the host mirror
    rows = tc.host_rows(np.where(ti >= 0, ti, 0).ravel()).reshape(ti.shape + (DIM,))
    exact = host_exact_scores(q, rows, Metric(metric))
    np.testing.assert_allclose(td[ti >= 0], exact[ti >= 0], rtol=1e-5, atol=1e-4)
    return ti


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("filt", ["none", "half", "tenth"])
def test_search_matches_jax(corpora, n, metric, k, filt):
    jc, tc, q, masks = corpora[n]
    for b in (1, 16):
        ids = _compare(jc, tc, q[:b], k, metric, masks[filt])
        assert not np.isin(ids[ids >= 0], np.nonzero(jc._tombs_np)[0]).any()
    if filt != "none":
        assert np.all(masks[filt][ids[ids >= 0]])


@pytest.mark.parametrize("metric", METRICS)
def test_exact_mode_matches_jax(corpora, metric):
    jc, tc, q, _ = corpora[20000]
    jd, ji = jc.search(q, 10, JaxMetric(metric), mode="exact")
    td, ti = tc.search(q, 10, Metric(metric), mode="exact")
    assert_same_ids(ti, ji, tc._host, q, metric)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)


def test_writes_after_staging_match_jax():
    """Overwrites, appends and tombstones after a search keep both engines
    in step (incremental and full restaging)."""
    x, q, tombs, _ = _data(6000)
    rng = np.random.default_rng(7)
    jc, tc = jax_scan.DeviceCorpus(DIM), DeviceCorpus(DIM, device="cpu")
    for c in (jc, tc):
        c.append(x[:5000])
        c.finalize()
    for step in range(3):
        rows = rng.normal(size=(8, DIM)).astype(np.float32)
        ids = rng.choice(5000, 8, replace=False)
        for c in (jc, tc):
            c.overwrite(ids, rows)
            c.set_tombstones(tombs[: c.n])
        for metric in METRICS:
            _compare(jc, tc, q, 10, metric, None)
    for c in (jc, tc):
        c.append(x[5000:])
        c.set_tombstones(tombs)
    for metric in METRICS:
        _compare(jc, tc, q, 10, metric, None)


def test_overflow_scores_are_dropped(monkeypatch):
    """Scores that overflow to +inf are dropped, the JAX host rescore's rule
    (its device rescore keeps them), so the JAX side runs the host route."""
    monkeypatch.setattr(jax_scan, "DEVICE_RESCORE", False)
    n = 20000
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    x[:10, 0] = 1e20  # q . x overflows to +inf
    x[10:20, 0] = -1e20  # ... and to -inf; together they keep the mean small
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    q[:, 0] = 1e19
    jc, tc = jax_scan.DeviceCorpus(DIM), DeviceCorpus(DIM, device="cpu")
    with np.errstate(over="ignore", invalid="ignore"):
        for c in (jc, tc):
            c.append(x)
        ti = _compare(jc, tc, q, 10, "ip", None)
    assert ti.shape == (4, 10) and not np.isin(ti, np.arange(20)).any()


@pytest.mark.parametrize("n", SIZES)
def test_split_batches_match_jax(corpora, monkeypatch, n):
    """A batch whose (B, rows) score matrix exceeds the budget is split on
    the host; the parts give the same answers."""
    import lynsedb_tpu_torch.ops.scan as torch_scan

    jc, tc, q, masks = corpora[n]
    monkeypatch.setattr(torch_scan, "SCORE_BUDGET", 3 * tc.capacity)  # parts of 3 queries
    _compare(jc, tc, q, 10, "l2", masks["half"])


def test_filter_with_fewer_rows_than_k(corpora):
    jc, tc, q, _ = corpora[20000]
    mask = np.zeros(20000, bool)
    mask[[7, 700, 7000, 19999]] = True
    ti = _compare(jc, tc, q, 10, "ip", mask)
    assert ti.shape[1] <= 4 and set(ti[ti >= 0]) <= {7, 700, 7000, 19999}


def test_empty_and_fully_filtered():
    tc = DeviceCorpus(DIM, device="cpu")
    d, i = tc.search(np.zeros((2, DIM), np.float32), 5, Metric.IP)
    assert d.shape == (2, 0) and i.shape == (2, 0)
    tc.append(np.ones((10, DIM), np.float32))
    d, i = tc.search(np.zeros((2, DIM), np.float32), 5, Metric.IP,
                     filter_mask=np.zeros(10, bool))
    assert i.shape == (2, 0)
    d, i = tc.search(np.zeros((1, DIM), np.float32), 5, Metric.L1)  # every metric is served
    np.testing.assert_array_equal(i, [[0, 1, 2, 3, 4]])
    np.testing.assert_array_equal(d, np.full((1, 5), DIM, np.float32))


@pytest.mark.parametrize("metric", METRICS)
def test_large_k_matches_jax(corpora, metric):
    """k = 2,000 (a shortlist of 2,560: K5's sort-and-merge path and K3's
    K5-backed path on the card) under a 50% filter."""
    jc, tc, q, masks = corpora[20000]
    ti = _compare(jc, tc, q[:2], 2000, metric, masks["half"])
    assert ti.shape == (2, 2000)


@pytest.mark.parametrize("metric", METRICS)
def test_range_search_matches_jax(corpora, metric):
    """search_range at its default max_results=1000 (a shortlist of 1,280),
    with a threshold that keeps about half of those rows."""
    jc, tc, q, _ = corpora[20000]
    d_all, _ = tc.search(q[:1], 1000, Metric(metric))
    threshold = float(d_all[0, 500])
    jd, ji = jc.range_search(q[0], threshold, JaxMetric(metric), max_results=1000)
    td, ti = tc.range_search(q[0], threshold, Metric(metric), max_results=1000)
    assert 400 < len(ti) <= 1000
    assert_same_ids(ti[None], ji[None], tc._host, q[:1], metric)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)

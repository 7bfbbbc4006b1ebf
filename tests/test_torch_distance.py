"""The port's distances (lynsedb_tpu_torch.ops.distance, the plain version of
the distance kernels, and lynsedb_tpu_torch.backend on the CPU) against
lynsedb_tpu.ops.distance, lynsedb_tpu.backend and the float64 formulas of
tests/np_reference.py, for all 16 metrics, on seeded inputs.

Tolerances against the JAX package: the binary family and Chebyshev equal
(integer counts then the same f32 operations; a max of exact terms);
Hellinger and Jensen-Shannon rtol=1e-4, atol=1e-5 on the squared distance
(1 - bc and ln 2 + (ent - mix) / 2 cancel, and the square root magnifies
what is left near 0); Wasserstein rtol=1e-4, atol=1e-5 * D (cumulative sums
in another order); Haversine rtol=1e-5, atol=1 m (an f32 angle's ulp is 0.76
m of arc); the rest rtol=1e-5, atol=1e-5 * the largest distance (f32 sums in
another order). Against float64: rtol=2e-3, atol=2e-4 * scale, the tolerance
of tests/test_distance_kernels.py; Hamming's counts exactly, at D = 3,072 too
(Jaccard and Dice rtol=1e-6: exact counts, then one f32 division). The
kernels' gather mode (explicit rows, K10) gives the tile mode's keys of those
rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lynsedb_tpu.backend as jax_backend
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu.ops import distance as JD
from lynsedb_tpu_torch import backend
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import scan
from np_reference import FNS
from test_torch_scan import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ALL = [m for m in Metric]
EXACT = (Metric.HAMMING, Metric.JACCARD, Metric.TANIMOTO, Metric.DICE, Metric.CHEBYSHEV)


def _data(metric: Metric, rng, n=37, d=33) -> np.ndarray:
    if metric is Metric.HAVERSINE:
        lon = rng.uniform(-180, 180, size=(n, 1))
        lat = rng.uniform(-90, 90, size=(n, 1))
        return np.concatenate([lon, lat], axis=1).astype(np.float32)
    if metric in D.PROBABILITY_METRICS:
        return rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    if metric.is_binary:
        return (rng.uniform(0, 1, size=(n, d)) > 0.5).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _plain(q: np.ndarray, x: np.ndarray, metric) -> np.ndarray:
    """(B, N) distances through the plain form (the kernels' reference)."""
    metric = D.parse_metric(metric)
    q, x = torch.from_numpy(np.atleast_2d(q)), torch.from_numpy(np.atleast_2d(x))
    return D.pairwise(D.query_transform(q, metric), D.corpus_transform(x, metric), metric).numpy()


def _assert_matches_jax(metric: Metric, got: np.ndarray, want: np.ndarray, dim: int) -> None:
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    got, want = got[fin].astype(np.float64), want[fin].astype(np.float64)
    if metric in EXACT:
        np.testing.assert_array_equal(got, want)
        return
    scale = max(1.0, float(np.abs(want).max(initial=1.0)))
    if metric in (Metric.HELLINGER, Metric.JENSEN_SHANNON):
        np.testing.assert_allclose(got**2, want**2, rtol=1e-4, atol=1e-5)
    elif metric is Metric.WASSERSTEIN:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * dim)
    elif metric is Metric.HAVERSINE:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1.0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("metric", ALL, ids=[m.value for m in ALL])
def test_pairwise_matches_jax_and_numpy(metric, rng):
    x = _data(metric, rng)
    q = _data(metric, rng, n=5)
    x[3] = q[1]  # a query's own row
    got = _plain(q, x, metric)
    want = np.asarray(JD.pairwise_distances(q, x, JaxMetric(metric.value)))
    _assert_matches_jax(metric, got, want, x.shape[1])
    ref = np.array([[FNS[metric.value](a, b) for b in x] for a in q])
    scale = max(1.0, np.abs(ref[np.isfinite(ref)]).max(initial=1.0))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4 * scale)


CORNERS = [  # (metric, a, b, the reference value)
    ("cosine", np.zeros(8), np.ones(8), 1.0),
    ("correlation", np.full(8, 3.0), np.full(8, 3.0), 0.0),
    ("correlation", np.full(8, 3.0), np.full(8, 5.0), 1.0),
    ("correlation", np.full(8, 3.0), np.arange(8.0), 1.0),
    ("js", np.zeros(8), np.zeros(8), 0.0),
    ("js", np.zeros(8), np.ones(8), np.sqrt(np.log(2))),
    ("hellinger", np.zeros(8), np.zeros(8), 0.0),
    ("hellinger", np.zeros(8), np.ones(8), 1.0),
    ("wasserstein", np.zeros(8), np.ones(8), np.inf),
    ("hellinger", [0.5, -0.1, 0.6], [0.3, 0.3, 0.4], np.inf),
    ("wasserstein", [0.5, -0.1, 0.6], [0.3, 0.3, 0.4], np.inf),
    ("js", [0.5, -0.1, 0.6], [0.3, 0.3, 0.4], np.inf),
    ("haversine", [0.0, 95.0], [0.0, 10.0], np.inf),
    ("braycurtis", np.zeros(4), np.zeros(4), 0.0),
    ("braycurtis", [1.0, -1.0], [-1.0, 1.0], np.inf),
    ("canberra", np.zeros(4), np.zeros(4), 0.0),
    ("jaccard", np.zeros(16), np.zeros(16), 0.0),
    ("dice", np.zeros(16), np.zeros(16), 0.0),
]


@pytest.mark.parametrize("name,a,b,value", CORNERS)
def test_corner_cases_match_jax(name, a, b, value):
    """The corner rows of tests/test_distance_kernels.py (constant, zero-mass,
    invalid and out-of-range rows), through both packages."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    got = backend.compute_distance(a, b, name, device="cpu")
    assert got == JD.compute_distance(a, b, name)
    np.testing.assert_allclose(got, value, rtol=1e-5)
    assert _plain(a, b, name)[0, 0] == got


def test_haversine_known_distance():
    london = np.array([-0.1278, 51.5074], dtype=np.float32)  # (lon, lat)
    paris = np.array([2.3522, 48.8566], dtype=np.float32)
    d = backend.compute_distance(london, paris, "haversine", device="cpu")
    assert 340_000 < d < 348_000
    np.testing.assert_allclose(d, JD.compute_distance(london, paris, "haversine"), rtol=1e-6)


@pytest.mark.parametrize("metric", D.BINARY_METRICS, ids=[m.value for m in D.BINARY_METRICS])
def test_binary_counts_are_exact_at_high_dim(metric, rng):
    """Bit-packed popcounts at D = 3,072 (96 words a row), equal to float64
    and to the JAX package's bf16 product."""
    d = 3072
    a = (rng.uniform(0, 1, size=(2, d)) > 0.3).astype(np.float32)
    b = (rng.uniform(0, 1, size=(5, d)) > 0.7).astype(np.float32)
    b[4] = 0.0
    ct = D.corpus_transform(torch.from_numpy(b), metric)
    assert ct["bits"].shape == (5, 96) and ct["bits"].dtype == torch.int32
    np.testing.assert_array_equal(D.unpack_bits(ct["bits"]).numpy(), b)
    got = _plain(a, b, metric)
    want = np.array([[FNS[metric.value](r, s) for s in b] for r in a])
    if metric is Metric.HAMMING:  # a count: exact
        np.testing.assert_array_equal(got, want)
    else:  # exact counts, one f32 division
        np.testing.assert_allclose(got, want, rtol=1e-6)
    want = np.asarray(JD.pairwise_distances(a, b, JaxMetric(metric.value)))
    np.testing.assert_array_equal(got, want)


def test_bit_packing_pads_with_zeros():
    x = np.ones((3, 40), np.float32)
    bits = D.pack_bits(torch.from_numpy(x))
    assert bits.shape == (3, 2)
    assert bits[0, 0].item() == -1 and bits[0, 1].item() == 0xFF  # bit 31 set; 8 live bits
    np.testing.assert_array_equal(D.unpack_bits(bits)[:, 40:].numpy(), 0.0)


@pytest.mark.parametrize("metric", ALL, ids=[m.value for m in ALL])
def test_backend_matches_jax(metric, rng):
    """backend.top_k_search / batch_top_k_search / pairwise_distances on the
    CPU against lynsedb_tpu.backend: the same ids but at near-ties, the
    distances within the family's tolerance."""
    x = _data(metric, rng, n=200, d=16)
    qs = _data(metric, rng, n=4, d=16)
    qs[0] = x[9]
    m = metric.value
    bi, bd = backend.batch_top_k_search(qs, x, k=7, metric=m, device="cpu")
    ji, jd = jax_backend.batch_top_k_search(qs, x, k=7, metric=m)
    si, sd = backend.top_k_search(qs[1], x, k=7, metric=m, device="cpu")
    sji, sjd = jax_backend.top_k_search(qs[1], x, k=7, metric=m)
    for gi, gd, wi, wd, q in ((bi, bd, ji, jd, qs), (si[None], sd[None], sji[None], sjd[None],
                                                      qs[1:2])):
        _assert_matches_jax(metric, gd, np.asarray(wd), x.shape[1])
        got = np.array([[FNS[m](r, x[i]) for i in row] for r, row in zip(q, gi)])
        want = np.array([[FNS[m](r, x[i]) for i in row] for r, row in zip(q, np.asarray(wi))])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # a swap only at a near-tie
    got = backend.pairwise_distances(qs, x, m, device="cpu")
    want = np.asarray(jax_backend.pairwise_distances(qs, x, JaxMetric(m)))
    _assert_matches_jax(metric, got, want, x.shape[1])


def test_backend_device_is_explicit():
    x = np.eye(4, dtype=np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            backend.top_k_search(x[0], x, k=2)
    with pytest.raises(ValueError, match="unknown metric"):
        backend.compute_distance(x[0], x[1], "not_a_metric", device="cpu")


@pytest.mark.parametrize("metric", [m for m in ALL if m not in scan.TWO_PASS_METRICS],
                         ids=[m.value for m in ALL if m not in scan.TWO_PASS_METRICS])
def test_gather_mode_matches_tile_mode(metric, rng):
    """The distance kernels' plain version over explicit rows (the rescore,
    K10) gives the keys of those rows over every row; empty slots -inf."""
    x = torch.from_numpy(_data(metric, rng, n=60, d=16))
    q = torch.from_numpy(_data(metric, rng, n=3, d=16))
    qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
    full = scan.metric_keys(qt, ct, torch.ones(60, dtype=torch.bool), metric)
    ids = torch.from_numpy(rng.integers(0, 60, size=(3, 9)).astype(np.int32))
    ids[:, -2:] = -1
    got = scan.metric_keys(qt, ct, None, metric, ids=ids)
    want = torch.where(ids >= 0, full.gather(1, ids.clamp_min(0).long()), float("-inf"))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

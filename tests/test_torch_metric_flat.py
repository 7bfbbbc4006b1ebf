"""FLAT-<metric> collections of the port (on the CPU: the kernels' plain
versions) against lynsedb_tpu's, under all 16 metrics, on the same seeded
rows; and the gather route of selective filters (K4).

Four shapes, as users of these metrics run them, at a small size:
  * real-valued embeddings (a gaussian mixture, 6,000 x 32, 40 duplicated
    rows): L1, Chebyshev, Canberra, Bray-Curtis, correlation (and IP, L2,
    cosine for the gather route);
  * histograms (3,000 x 32 exponentiated mixture rows, 30 with a negative
    entry, 12 all zero; one zero query): Hellinger, Jensen-Shannon,
    Wasserstein;
  * fingerprints (3,000 x 64 bits at 10% density): Tanimoto, Jaccard, Dice,
    Hamming;
  * geo points (3,000 (lon, lat) pairs uniform on the sphere, 20 with
    |lat| > 90): Haversine.
Each collection is built by both packages and asked the same ``search``
(k=10, unfiltered and ``bucket = 3``), ``search_range`` and corpus
``rescore``; the L1 family also ``search(approx=True)``, with
``APPROX_MIN_ROWS`` lowered in both packages so 6,000 rows engage it.

Tolerances (distances against the JAX package's): the binary family and
Chebyshev equal (integer counts then the same f32 operations; a max of
exact terms); Haversine rtol=1e-5, atol=1 m (an ulp of an f32 angle in
radians is 0.76 m of arc, and the latitude and longitude differences
cancel);
Hellinger and Jensen-Shannon on the squared distances, rtol=1e-4,
atol=1e-5 (1 - bc and ln 2 + (ent - mix) / 2 cancel to a few ulps of 1 and
of ln D, which the square root magnifies near 0); Wasserstein rtol=1e-4, atol=1e-5 * D (the
cdf's cumulative sums run in another order); the rest rtol=1e-5,
atol=1e-5 * the largest distance (f32 sums in another order). ids are equal
except where two rows' float64 distances (tests/np_reference.py) lie within
that tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest

import lynsedb_tpu
import lynsedb_tpu.ops.scan as jax_scan
import lynsedb_tpu_torch
import lynsedb_tpu_torch.ops.scan as torch_scan
from np_reference import FNS
from test_torch_scan import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
K = 10
SHAPES = {
    "real": ["L1", "CHEBYSHEV", "CANBERRA", "BRAY-CURTIS", "CORRELATION"],
    "hist": ["HELLINGER", "JENSEN-SHANNON", "WASSERSTEIN"],
    "bits": ["TANIMOTO-BINARY", "JACCARD-BINARY", "DICE-BINARY", "HAMMING-BINARY"],
    "geo": ["HAVERSINE"],
}
APPROX = ["L1", "CHEBYSHEV", "CANBERRA", "BRAY-CURTIS"]
EXACT_FAMILY = ("hamming", "jaccard", "tanimoto", "dice", "chebyshev")


SQUARED = ("hellinger", "jensen_shannon")  # compared as squared distances


def _tolerance(metric: str, scale: float, dim: int):
    """(rtol, atol) of a metric's distances (squared distances for
    Hellinger and Jensen-Shannon) against the JAX package's."""
    if metric in EXACT_FAMILY:
        return 0.0, 0.0
    if metric == "haversine":
        return 1e-5, 1.0
    if metric in SQUARED:
        return 1e-4, 1e-5
    if metric == "wasserstein":
        return 1e-4, 1e-5 * dim
    return 1e-5, 1e-5 * scale


def _mixture(rng, n, dim, centers=40):
    c = rng.normal(size=(centers, dim)).astype(np.float32)
    return (c[rng.integers(0, centers, n)] + 0.5 * rng.normal(size=(n, dim))).astype(np.float32)


def _shape_data(shape: str):
    """(rows, queries) of a shape, from a seed."""
    rng = np.random.default_rng(len(shape))
    if shape == "real":
        x = _mixture(rng, 6000, 32)
        x[3000:3040] = x[:40]  # duplicated rows: exact ties broken by id
        q = _mixture(rng, 6, 32)
        q[2] = x[7]
    elif shape == "hist":
        x = np.exp(_mixture(rng, 3000, 32) * 0.5).astype(np.float32)
        x[rng.choice(3000, 30, replace=False), rng.integers(0, 32, 30)] = -0.5  # invalid rows
        x[100:112] = 0.0  # zero mass
        q = np.exp(_mixture(rng, 6, 32) * 0.5).astype(np.float32)
        q[3] = 0.0  # a zero-mass query: the zero rows first, then every row at the policy value
        q[4] = x[500]
    elif shape == "bits":
        x = (rng.random((3000, 64)) < 0.1).astype(np.float32)
        x[200:210] = x[0]
        q = x[rng.choice(3000, 6, replace=False)].copy()
        q[:, :8] = (rng.random((6, 8)) < 0.1)  # perturbed fingerprints
        q[5] = 0.0  # an empty fingerprint: union 0 against the empty rows
        x[300:303] = 0.0
    else:
        lon = rng.uniform(-180, 180, 3000)
        lat = np.degrees(np.arcsin(rng.uniform(-1, 1, 3000)))  # uniform on the sphere
        lat[rng.choice(3000, 20, replace=False)] = 95.0  # invalid rows
        x = np.stack([lon, lat], 1).astype(np.float32)
        q = np.stack([rng.uniform(-180, 180, 6), rng.uniform(-80, 80, 6)], 1).astype(np.float32)
    return x, q


def _client(pkg, root):
    return pkg.VectorDBClient(str(root), **({"device": "cpu"} if pkg is lynsedb_tpu_torch else {}))


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """shape -> (rows, queries, {package: (client, collection)})."""
    out = {}
    for shape in SHAPES:
        x, q = _shape_data(shape)
        pair = {}
        for pkg in (lynsedb_tpu, lynsedb_tpu_torch):
            client = _client(pkg, tmp_path_factory.mktemp(f"{shape}_{pkg.__name__}"))
            coll = client.create_database("d").require_collection("c", dim=x.shape[1])
            coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(len(x))])
            coll.commit()
            pair[pkg] = (client, coll)
        out[shape] = (x, q, pair)
    yield out
    for _, _, pair in out.values():
        for client, _ in pair.values():
            client.close()


def _assert_close(metric: str, got, want, dim: int) -> None:
    fin = np.isfinite(want)
    scale = float(np.abs(want[fin]).max(initial=1.0))
    rtol, atol = _tolerance(metric, scale, dim)
    if metric in SQUARED:
        got, want = np.square(got.astype(np.float64)), np.square(want.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _dist64(metric: str, x, q, ids):
    return np.array([FNS[metric](q.astype(np.float64), x[i].astype(np.float64)) for i in ids])


def _assert_same(metric, x, q, got, want):
    """ids equal but at float64 near-ties; distances within the metric's
    tolerance; no row at +inf distance."""
    (gi, gd), (wi, wd) = got, want
    assert gi.shape == wi.shape, (gi, wi)
    assert np.isfinite(gd).all()
    _assert_close(metric, gd, wd, x.shape[1])
    diff = np.nonzero(gi != wi)[0]
    if len(diff):
        _assert_close(metric, _dist64(metric, x, q, gi[diff]), _dist64(metric, x, q, wi[diff]),
                      x.shape[1])


def _result(view):
    return np.asarray(view.ids, dtype=np.int64), np.asarray(view.distances, dtype=np.float32)


def _modes():
    return [(shape, mode) for shape, modes in SHAPES.items() for mode in modes]


@pytest.mark.parametrize("shape,mode", _modes())
def test_metric_flat_matches_jax(collections, shape, mode):
    """search (unfiltered and 10%), search_range and the corpus rescore."""
    x, q, pair = collections[shape]
    for _, coll in pair.values():
        coll.build_index(f"FLAT-{mode}")
    (_, jc), (_, tc) = pair[lynsedb_tpu], pair[lynsedb_tpu_torch]
    metric = tc._engine.metric.value
    assert jc._engine.metric.value == metric
    for where in (None, "bucket = 3"):
        got = tc.batch_search(q, k=K, where=where)
        want = jc.batch_search(q, k=K, where=where)
        for r in range(len(q)):
            gi, _ = _result(got[r])
            _assert_same(metric, x, q[r], _result(got[r]), _result(want[r]))
            if where is not None:
                assert np.all(gi % 10 == 3)

    wd = np.asarray(jc.search(q[0], k=50).distances)
    threshold = float((wd[29] + wd[30]) / 2)  # between two rows: no boundary within an ulp
    got = tc.search_range(q[0], threshold, max_results=40)
    want = jc.search_range(q[0], threshold, max_results=40)
    _assert_same(metric, x, q[0], _result(got), _result(want))

    cand = np.random.default_rng(1).integers(0, len(x), size=(len(q), 30))
    cand[:, -4:] = -1
    jm, tm = jc._engine.metric, tc._engine.metric
    want = jc._engine.corpus().rescore(q, cand, jm)
    got = tc._engine.corpus().rescore(q, cand, tm)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _assert_close(metric, got[fin], want[fin], x.shape[1])


@pytest.mark.parametrize("mode", APPROX)
def test_approx_matches_jax(collections, monkeypatch, mode):
    """search(approx=True) of the L1 family: the bf16 shortlist (K9), its
    f32 rescore (K10), ordered on (score, id)."""
    monkeypatch.setattr(jax_scan.DeviceCorpus, "APPROX_MIN_ROWS", 1000)
    monkeypatch.setattr(torch_scan.DeviceCorpus, "APPROX_MIN_ROWS", 1000)
    x, q, pair = collections["real"]
    for _, coll in pair.values():
        coll.build_index(f"FLAT-{mode}")
    (_, jc), (_, tc) = pair[lynsedb_tpu], pair[lynsedb_tpu_torch]
    metric = tc._engine.metric.value
    for where in (None, "bucket = 3"):
        got = tc.batch_search(q, k=K, where=where, approx=True)
        want = jc.batch_search(q, k=K, where=where, approx=True)
        assert tc._engine.corpus().last_scanned == len(x) + K * 8  # eps 1e-4: 8 x oversample
        exact = tc.batch_search(q, k=K, where=where)
        for r in range(len(q)):
            _assert_same(metric, x, q[r], _result(got[r]), _result(want[r]))
            hits = len(set(got[r].ids) & set(exact[r].ids))
            assert hits >= 9, (r, hits)  # tests/test_approx.py's 0.90 floor


@pytest.mark.parametrize("mode", ["IP", "L2", "COS"])
def test_gather_route_matches_jax(collections, mode):
    """A filter of at most 100,000 rows and a quarter of the corpus takes
    the gather route (K11 over the filter's rows, K5, K3) in both packages:
    the same ids and distances, and scanned_vectors = count + the shortlist."""
    x, q, pair = collections["real"]
    for _, coll in pair.values():
        coll.build_index(f"FLAT-{mode}")
    (_, jc), (_, tc) = pair[lynsedb_tpu], pair[lynsedb_tpu_torch]
    metric = {"IP": "ip", "L2": "l2", "COS": "cosine"}[mode]
    count = int(np.sum(np.arange(len(x)) % 10 == 3))
    assert tc._engine.n_rows >= torch_scan.TWO_PASS_MIN_ROWS and 4 * count <= len(x)
    got = tc.batch_search(q, k=K, where="bucket = 3")
    want = jc.batch_search(q, k=K, where="bucket = 3")
    for r in range(len(q)):
        _assert_same(metric, x, q[r], _result(got[r]), _result(want[r]))
        assert np.all(np.asarray(got[r].ids) % 10 == 3)
    c = tc._engine.corpus()._shortlist_size(K, count)
    tp = tc.search_profile(q[0], k=K, where="bucket = 3")
    jp = jc.search_profile(q[0], k=K, where="bucket = 3")
    assert tp["scanned_vectors"] == jp["scanned_vectors"] == count + c
    assert tp["filter_matches"] == jp["filter_matches"] == count
    # a half filter is above the gather policy: a masked full scan
    tp = tc.search_profile(q[0], k=K, where="bucket < 5")
    assert tp["scanned_vectors"] == len(x) + tc._engine.corpus()._shortlist_size(K, len(x))


def test_transform_that_does_not_fit_raises(rng, monkeypatch):
    """The device budget counts a metric's transform beside the corpus
    copies and the search scratch: at a budget of exactly what an L1 search
    stages (no array beyond the f32 copy), asking for the Jensen-Shannon
    transform (an extra (N, D) f32 array) raises, and a Jensen-Shannon
    search stages nothing but pumps its exact f32 rows from the host mirror
    with the same answers, the corpus staying resident. A corpus that not
    even one streamed block of fits still raises at staging, for a card's
    corpus as for any."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric

    x = np.abs(rng.normal(size=(5000, 16))).astype(np.float32)
    q = np.abs(rng.normal(size=(3, 16))).astype(np.float32)
    resident = torch_scan.DeviceCorpus(16, device="cpu")
    corpus = torch_scan.DeviceCorpus(16, device="cpu")
    for c in (resident, corpus):
        c.append(x)
    corpus.search(q, K, Metric.L1)  # stages the bf16 and f32 copies and the mask
    cap, held = corpus.capacity, corpus._held_bytes()
    assert held == cap * 16 * (2 + 4) + cap
    need_l1 = corpus.device_bytes(cap, Metric.L1)
    need_js = corpus.device_bytes(cap, Metric.JENSEN_SHANNON)
    assert need_js - need_l1 >= cap * 16 * 4
    monkeypatch.setattr(torch_scan, "DEVICE_BYTES", need_l1)
    corpus._transform = None
    assert corpus.transform(Metric.L1)["x"].shape == (cap, 16)  # fits exactly
    assert corpus.tier == torch_scan.RESIDENT
    got = corpus.search(q, K, Metric.JENSEN_SHANNON)
    assert corpus.tier == torch_scan.RESIDENT and corpus._dev32 is not None
    assert corpus._transform[0] is Metric.L1  # the Jensen-Shannon transform was not staged
    monkeypatch.setattr(torch_scan, "DEVICE_BYTES", 0)
    want = resident.search(q, K, Metric.JENSEN_SHANNON)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(torch_scan, "DEVICE_BYTES", need_l1)
    with pytest.raises(RuntimeError, match="jensen_shannon transform"):
        corpus.transform(Metric.JENSEN_SHANNON)
    tiny = torch_scan.DeviceCorpus(16, device="cpu")
    tiny.append(x)
    tiny.device = torch.device("cuda")  # the card's free memory is the budget
    monkeypatch.setattr(torch_scan, "DEVICE_BYTES", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1 << 12, 1 << 40))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)
    with pytest.raises(RuntimeError, match="even one streamed block"):
        tiny._ensure_staged()

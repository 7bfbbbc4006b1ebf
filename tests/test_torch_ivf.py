"""The port's IVF / SPANN index (on the CPU: the kernels' plain versions)
against lynsedb_tpu.index.ivf, on the same seeded inputs.

Each package opens an index directory the other built and gives the same
answers, at nprobe 1, 4 and 16, unfiltered and under a 50% filter, and after
rows are added past the build (the exactly scanned tail, then the commit's
incremental insert). The port's probe is held against the JAX package's
``_ivf_search_kernel`` on the same index, and the recall floors of
tests/test_kmeans_ivf.py hold for the port's own builds.

Tolerances: distances rtol=1e-5, atol=1e-4 (f32 sums in another order); ids
identical except at a near-tie (float64 distances within that tolerance).
"""

from __future__ import annotations

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynsedb_tpu
import lynsedb_tpu_torch
from lynsedb_tpu.index.ivf import _ivf_search_kernel
from lynsedb_tpu.ops.scan import unpack_search_step
from lynsedb_tpu_torch.configs.config import config as torch_config
from np_reference import FNS
from test_torch_scan import assert_same_ids, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DIM, N, K = 32, 5000, 10
MODES = [("IVF-L2", {}, "l2"), ("IVF-IP", {}, "ip"), ("IVF-COS", {}, "cosine"),
         ("SPANN-L2", {"replica_count": 2}, "l2")]


@pytest.fixture(autouse=True)
def _lloyd_budget(monkeypatch):
    """The port's builds run the default 100 Lloyd steps, whatever
    LYNSE_KMEANS_EPOCHS another test left in the environment."""
    monkeypatch.setattr(torch_config, "LYNSE_KMEANS_EPOCHS", 100)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    x[100:105] = x[7]  # duplicated rows: exact ties broken by id
    extra = rng.normal(size=(300, DIM)).astype(np.float32)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    q[2] = x[7]
    return x, extra, q


def _fields(lo: int, n: int):
    return [{"bucket": (lo + i) % 2} for i in range(n)]


def _open(pkg, root):
    kw = {"device": "cpu"} if pkg is lynsedb_tpu_torch else {}
    client = pkg.VectorDBClient(root, **kw)
    return client, client.get_database("d").get_collection("c")


def _build(pkg, root, mode, kw, x):
    extra = {"device": "cpu"} if pkg is lynsedb_tpu_torch else {}
    client = pkg.VectorDBClient(root, **extra)
    coll = client.create_database("d").require_collection("c", dim=DIM)
    coll.add(vectors=x, fields=_fields(0, len(x)))
    coll.commit()
    coll.build_index(mode, n_clusters=32, **kw)
    client.close()


def _answers(coll, q):
    out = []
    for nprobe in (1, 4, 16):
        for where in (None, "bucket = 0"):  # half the rows: above the exact-filter route
            res = coll.batch_search(q, k=K, where=where, nprobe=nprobe)
            out.append([(np.asarray(r.ids), np.asarray(r.distances)) for r in res])
    return out


def _assert_same(got, want, rows, q, metric):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for r, ((gi, gd), (wi, wd)) in enumerate(zip(g, w)):
            assert len(set(gi.tolist())) == len(gi)  # replicas never repeat an id
            assert_same_ids(gi[None], wi[None], rows, q[r : r + 1], metric)
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode,kw,metric", MODES)
def test_jax_index_opens_in_port(tmp_path, mode, kw, metric):
    x, extra, q = _inputs()
    _build(lynsedb_tpu, tmp_path / "j", mode, kw, x)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        assert tcoll._engine._index.kind == jcoll._engine._index.kind
        assert tcoll._engine._index.replica_count == jcoll._engine._index.replica_count
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), x, q, metric)
        allx = np.concatenate([x, extra])
        for c in (jcoll, tcoll):  # past the build, uncommitted: the exact tail
            c.add(vectors=extra, fields=_fields(N, len(extra)))
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), allx, q, metric)
        for c in (jcoll, tcoll):  # the commit posts them to their centroids
            c.commit()
        assert tcoll._engine._index.built_rows == N + len(extra)
        np.testing.assert_array_equal(tcoll._engine._index.postings,
                                      jcoll._engine._index.postings)
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), allx, q, metric)
    finally:
        jclient.close()
        tclient.close()


@pytest.mark.parametrize("mode,kw,metric", [MODES[0], MODES[1]])
def test_port_index_opens_in_jax(tmp_path, mode, kw, metric):
    x, _, q = _inputs()
    _build(lynsedb_tpu_torch, tmp_path / "t", mode, kw, x)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        files = np.load(tcoll._engine.root / "index" / "ivf.npz")  # the JAX package's layout
        assert files["centroids"].dtype == np.float32 and files["postings"].dtype == np.int32
        assert jcoll._engine._index.replica_count == tcoll._engine._index.replica_count
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), x, q, metric)
    finally:
        jclient.close()
        tclient.close()


@pytest.mark.parametrize("mode,kw,metric", MODES)
def test_probe_matches_jax_kernel(tmp_path, mode, kw, metric):
    """The port's probe (K1 -> K5 -> ivf_scan_blocks -> K5, as plain
    versions) against _ivf_search_kernel on the same index, before the
    dedup: the same live keys and ids, and -inf in the same slots."""
    x, _, q = _inputs()
    _build(lynsedb_tpu, tmp_path / "j", mode, kw, x)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        jeng, teng = jcoll._engine, tcoll._engine
        jidx, tidx = jeng._index, teng._index
        mask = np.arange(N) % 3 == 0
        jdev, tdev = jidx._device_state(jeng), tidx._device_state(teng)
        live_t = teng.corpus().valid_mask(mask)
        for nprobe, fetch in ((2, 10), (40, 25)):  # nprobe above n_clusters is clamped
            packed = _ivf_search_kernel(
                jnp.asarray(q), jdev["centroids"], jdev["blocks"], jdev["block_orig"],
                jdev["cluster_blocks"], jeng.corpus().valid_mask(mask), k=fetch,
                nprobe=min(nprobe, 32), metric=jidx.metric, ascending=jidx.metric.ascending)
            jd, ji = unpack_search_step(np.asarray(packed))
            td, ti = tidx._probe(torch.from_numpy(q), tdev, live_t, fetch, min(nprobe, 32))
            assert td.shape == jd.shape == (len(q), fetch)
            np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
            fin = np.isfinite(jd)
            np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
            assert_same_ids(np.where(fin, ti, 0), np.where(fin, ji, 0), x, q, metric)
            assert np.all(mask[ti[fin]])
    finally:
        jclient.close()
        tclient.close()


# ── the port's own builds: the recall floors of tests/test_kmeans_ivf.py ──


def _recall(got_ids, want_ids) -> float:
    got = set(int(i) for i in got_ids if i >= 0)
    return len(got & set(int(i) for i in want_ids)) / max(len(want_ids), 1)


@pytest.fixture
def port_coll(tmp_path):
    rng = np.random.default_rng(42)
    data = rng.normal(size=(N, DIM)).astype(np.float32)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "r", device="cpu")
    coll = client.create_database("d").require_collection("ivf", dim=DIM)
    coll.add(list(range(N)), vectors=data)
    coll.commit()
    yield coll, data, rng
    client.close()


def test_ivf_recall_improves_with_nprobe(port_coll):
    coll, data, rng = port_coll
    coll.build_index("IVF-L2", n_clusters=32)
    q = rng.normal(size=(10, DIM)).astype(np.float32)
    want = np.argsort(((data[None] - q[:, None]) ** 2).sum(-1), axis=1)[:, :K]

    def recall_at(nprobe):
        return np.mean([_recall(coll.search(q[i], k=K, nprobe=nprobe).ids, want[i])
                        for i in range(len(q))])

    r_small, r_mid, r_big = recall_at(1), recall_at(8), recall_at(32)
    assert r_big >= r_small and r_big >= 0.99  # probing every partition is exact
    assert r_mid >= r_small and r_mid >= 0.5
    prof = coll._engine.search(q[0], k=K, nprobe=1, profile=True).profile
    assert prof["index_path"] == "ivf" and 0 < prof["scanned_vectors"] < N


def test_ivf_ip_mode(port_coll):
    coll, data, rng = port_coll
    coll.build_index("IVF-IP", n_clusters=16)
    q = rng.normal(size=(DIM,)).astype(np.float32)
    res = coll.search(q, k=K, nprobe=16)
    assert _recall(res.ids, np.argsort(-(data @ q))[:K]) >= 0.99
    assert all(res.distances[i] >= res.distances[i + 1] for i in range(len(res.distances) - 1))


def test_spann_replicas_dedup(port_coll):
    coll, data, rng = port_coll
    coll.build_index("SPANN-L2", n_clusters=16, replica_count=2)
    q = rng.normal(size=(DIM,)).astype(np.float32)
    res = coll.search(q, k=K, nprobe=4)
    assert len(res.ids) == len(set(res.ids.tolist())) == K
    assert _recall(res.ids, np.argsort(((data - q) ** 2).sum(-1))[:K]) >= 0.6


def test_ivf_incremental_insert_no_rebuild(tmp_path):
    rng = np.random.default_rng(42)
    n0, d = 4000, 16
    base = rng.normal(size=(n0, d)).astype(np.float32)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "r", device="cpu")
    try:
        coll = client.create_database("d").require_collection("ivf_inc", dim=d)
        coll.add(list(range(n0)), vectors=base)
        coll.commit()
        coll.build_index("IVF-L2", n_clusters=32)
        idx = coll._engine._index
        rebuilds = {"n": 0}
        orig = idx.rebuild
        idx.rebuild = lambda c: (rebuilds.__setitem__("n", rebuilds["n"] + 1), orig(c))
        fresh = rng.normal(size=(1200, d)).astype(np.float32)
        coll.add(list(range(n0, n0 + 1200)), vectors=fresh)
        coll.commit()
        assert rebuilds["n"] == 0
        assert idx.built_rows == n0 + 1200 and idx.postings[:, 1].max() == n0 + 1199
        allv = np.concatenate([base, fresh])
        hits = 0
        for q in rng.normal(size=(15, d)).astype(np.float32):
            want = set(np.argsort(((allv - q) ** 2).sum(1))[:K].tolist())
            hits += len(set(int(i) for i in coll.search(q, k=K, nprobe=16).ids) & want)
        assert hits / (15 * K) >= 0.85
        more = rng.normal(size=(1500, d)).astype(np.float32)
        coll.add(list(range(n0 + 1200, n0 + 2700)), vectors=more)
        coll.commit()  # growth past half the trained corpus retrains
        assert rebuilds["n"] == 1
    finally:
        client.close()


@pytest.mark.parametrize("mode", ["IVF-HAMMING", "IVF-JACCARD"])
def test_binary_ivf_raises(port_coll, mode):
    """The binary IVF modes build and serve on the port (they raised before
    the bit-packed block scan, K16b, was ported): the blocks hold packed
    words, and probing every cluster answers as a float64 brute force over
    the rows thresholded at 0.5 (Hamming exact, Jaccard 1e-6)."""
    coll, data, _ = port_coll
    coll.build_index(mode, n_clusters=32)
    fn = FNS[mode.split("-")[1].lower()]
    for r, view in enumerate(coll.batch_search(data[:4], k=K, nprobe=32)):
        want = np.sort([fn(data[r], row) for row in data])[:K]
        assert len(set(np.asarray(view.ids).tolist())) == K
        np.testing.assert_allclose(view.distances, want, rtol=0, atol=1e-6)
    assert coll._engine._index._dev["blocks"].dtype == torch.int32

"""The port's mesh plane (lynsedb_tpu_torch.parallel.mesh and DeviceCorpus's
mesh mode; on the CPU: the kernels' plain versions over 8 virtual CPU shards)
against lynsedb_tpu.parallel.mesh on conftest's 8-device virtual CPU mesh, on
the same seeded inputs.

Every case of tests/test_mesh.py runs through both packages: the (2, 1),
(4, 1), (4, 2), (8, 2) and (8, 1) meshes, an odd remainder, an odd query
batch, tombstones, L2, k larger than a shard, the k-means step and
``make_mesh``'s device lists; K21a also under cosine, L1 and Tanimoto. K21b's
plain version adds in shard order and keeps an empty cluster's centroid. A
Collection on a mesh (add, search, filters, delete, search_stream, the
two-pass and gather plans, FLAT-IP-SQ8 and FLAT-IP-PQ, IVF-L2, HNSW-L2 and
DISKANN-L2) answers as the port on one device and as the JAX package on its
mesh, and ``dryrun_multichip(8, "cpu")`` passes.

Tolerances: distances and centroids rtol=1e-5 (f32 sums in another order;
atol 1e-4 for distances, 1e-5 for centroids); ids identical except where
keys tie (ids compared as sets at tied keys, or at a near-tie of their
float64 distances, ``assert_same_ids``); k-means counts exactly.
"""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

import lynsedb_tpu
import lynsedb_tpu_torch
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu.parallel import mesh as jmesh
from lynsedb_tpu.ops.scan import DeviceCorpus as JaxCorpus
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import kmeans
from lynsedb_tpu_torch.ops.scan import DeviceCorpus
from lynsedb_tpu_torch.parallel import mesh as tmesh
from lynsedb_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_scan import assert_same_ids, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _meshes(n_devices: int, data_axis: int):
    return (jmesh.make_mesh(n_devices, data_axis=data_axis, platform="cpu"),
            tmesh.make_mesh(n_devices, data_axis=data_axis, platform="cpu"))


def _data(n, b, d=16, seed=7, binary=False):
    rng = np.random.default_rng(seed)
    if binary:
        return ((rng.random((n, d)) < 0.3).astype(np.float32),
                (rng.random((b, d)) < 0.3).astype(np.float32))
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(b, d)).astype(np.float32)


def _reference_topk(corpus, queries, valid, metric, k):
    """test_mesh.py's numpy ground truth (IP, L2), best first."""
    if metric == "ip":
        keyed = queries @ corpus.T
    else:
        keyed = -((queries[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    keyed = np.where(valid[None, :], keyed, -np.inf)
    return np.argsort(-keyed, axis=1, kind="stable")[:, :k]


def _assert_tie_sets(got_i, got_d, want_i, want_d):
    """Distances equal at rtol 1e-5; ids equal as a set within each run of
    tied distances (the last run may be cut at k in either package)."""
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    for r in range(got_i.shape[0]):
        d = want_d[r]
        last = np.isclose(d, d[-1], rtol=1e-5, atol=1e-4)
        assert set(got_i[r][~last].tolist()) == set(want_i[r][~last].tolist()), r
        # a row in the tied last run of one list is tied in the other's
        extra = set(got_i[r][last].tolist()) ^ set(want_i[r][last].tolist())
        assert len(extra) % 2 == 0, r


def _run_both(n_devices, data_axis, n, b, k=5, metric="ip", tombstones=None, binary=False):
    jm, tm = _meshes(n_devices, data_axis)
    corpus, queries = _data(n, b, binary=binary)
    valid = np.ones(n, dtype=bool)
    if tombstones is not None:
        valid[tombstones] = False

    xs, vs = jmesh.shard_corpus(jm, corpus, valid)
    qs, b_real = jmesh.shard_queries(jm, queries)
    jd, ji = jmesh.sharded_search_fn(jm, metric=JaxMetric(metric), k=k)(xs, qs, vs)
    jd, ji = np.asarray(jd)[:b_real], np.asarray(ji)[:b_real]

    txs, tvs = tmesh.shard_corpus(tm, corpus, valid)
    tqs, tb = tmesh.shard_queries(tm, queries)
    td, ti = tmesh.sharded_search_fn(tm, metric=Metric(metric), k=k)(txs, tqs, tvs)
    assert tb == b_real and td.shape[0] == -(-b // data_axis) * data_axis
    td, ti = td.numpy()[:tb], ti.numpy()[:tb]
    assert ti.shape == ji.shape == (b, min(k, n))
    _assert_tie_sets(ti, td, ji, jd)
    return corpus, queries, valid, td, ti


@pytest.mark.parametrize("n_devices,data_axis", [(2, 1), (4, 1), (4, 2), (8, 2), (8, 1)])
def test_sharded_search_matches_jax(n_devices, data_axis):
    corpus, queries, valid, _, ti = _run_both(n_devices, data_axis, n=256, b=4)
    want = _reference_topk(corpus, queries, valid, "ip", 5)
    for r in range(4):
        assert set(ti[r].tolist()) == set(want[r].tolist())


def test_sharded_search_odd_remainder():
    # 251 rows over 4 shards: padding rows never appear in a result
    _, _, _, _, ti = _run_both(4, 1, n=251, b=3, k=7)
    assert ti.max() < 251


def test_sharded_search_odd_query_batch():
    # 5 queries over data_axis=2: the query padding is trimmed
    _run_both(8, 2, n=128, b=5, k=3)


def test_sharded_search_tombstones():
    tomb = np.random.default_rng(0).choice(200, size=60, replace=False)
    _, _, _, _, ti = _run_both(4, 1, n=200, b=4, k=5, tombstones=tomb)
    assert not set(ti.ravel().tolist()) & set(tomb.tolist())


def test_sharded_search_l2_metric():
    corpus, queries, valid, _, ti = _run_both(4, 2, n=192, b=4, metric="l2")
    want = _reference_topk(corpus, queries, valid, "l2", 5)
    for r in range(4):
        assert set(ti[r].tolist()) == set(want[r].tolist())


def test_sharded_search_k_larger_than_shard():
    # k=40 over 8 shards of 8 rows: each shard's top k is capped at 8, the
    # merge still returns the global top 40
    corpus, queries, valid, _, ti = _run_both(8, 1, n=64, b=2, k=40)
    want = _reference_topk(corpus, queries, valid, "ip", 40)
    for r in range(2):
        assert set(ti[r].tolist()) == set(want[r].tolist())


@pytest.mark.parametrize("metric", ["cosine", "l1", "tanimoto"])
def test_sharded_search_other_metrics(metric):
    _run_both(4, 2, n=300, b=5, k=6, metric=metric, binary=metric == "tanimoto")


def test_sharded_search_plain_flag_matches_kernel_route():
    tm = tmesh.make_mesh(4, platform="cpu")
    corpus, queries = _data(130, 3)
    xs, vs = tmesh.shard_corpus(tm, corpus, np.ones(130, dtype=bool))
    qs, _ = tmesh.shard_queries(tm, queries)
    a = tmesh.sharded_search_fn(tm, metric=Metric.L2, k=9)(xs, qs, vs)
    b = tmesh.sharded_search_fn(tm, metric=Metric.L2, k=9, plain=True)(xs, qs, vs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sharded_kmeans_step_matches_jax():
    jm, tm = _meshes(8, 2)
    rng = np.random.default_rng(3)
    n, d, kc = 300, 8, 6
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[::9] = False
    centroids = corpus[:kc].copy()

    xs, vs = jmesh.shard_corpus(jm, corpus, valid)
    jc, jn = jmesh.sharded_kmeans_step_fn(jm)(xs, jax.numpy.asarray(centroids), vs)
    txs, tvs = tmesh.shard_corpus(tm, corpus, valid)
    tc, tn = tmesh.sharded_kmeans_step_fn(tm)(txs, torch.from_numpy(centroids), tvs)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert float(tn.sum()) == valid.sum()

    # the single-host Lloyd step of test_mesh.py
    assign = ((corpus[:, None, :] - centroids[None, :, :]) ** 2).sum(-1).argmin(1)
    for j in range(kc):
        m = (assign == j) & valid
        assert tn[j] == m.sum()
        if m.any():
            np.testing.assert_allclose(tc[j].numpy(), corpus[m].mean(0), rtol=1e-5, atol=1e-5)


def test_make_mesh_explicit_devices():
    cpus = [torch.device("cpu")] * 8
    mesh = tmesh.make_mesh(4, data_axis=2, devices=cpus)
    assert dict(mesh.shape) == dict(jmesh.make_mesh(4, data_axis=2,
                                                    devices=jax.devices("cpu")).shape)
    assert dict(mesh.shape) == {"data": 2, "corpus": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh(len(cpus) + 1, devices=cpus)
    with pytest.raises(ValueError):
        jmesh.make_mesh(len(jax.devices("cpu")) + 1, devices=jax.devices("cpu"))


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: make_mesh() takes it")
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(2)


def test_mesh_corpus_refuses_another_device_type():
    mesh = tmesh.make_mesh(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises((ValueError, RuntimeError)):
        DeviceCorpus(8, device="cpu", mesh=mesh)


# ── K21b's plain version ─────────────────────────────────────────────────


def test_reduce_shards_plain_adds_in_shard_order():
    rng = np.random.default_rng(5)
    s, k, d = 5, 7, 3
    sums = (rng.normal(size=(s, k, d)) * 10.0 ** rng.integers(-3, 4, size=(s, k, d))
            ).astype(np.float32)
    counts = rng.integers(0, 4, size=(s, k)).astype(np.float32)
    counts[:, 2] = 0  # an empty cluster
    old = rng.normal(size=(k, d)).astype(np.float32)
    new, cnt = kmeans.kmeans_reduce_shards(torch.from_numpy(sums), torch.from_numpy(counts),
                                           torch.from_numpy(old))
    acc, tot = sums[0].copy(), counts[0].copy()
    for i in range(1, s):  # float32 adds, shard 0 first
        acc = (acc + sums[i]).astype(np.float32)
        tot = (tot + counts[i]).astype(np.float32)
    want = np.where(tot[:, None] > 0, acc / np.maximum(tot[:, None], 1.0), old)
    assert np.array_equal(cnt.numpy(), tot)
    assert np.array_equal(new.numpy(), want.astype(np.float32))
    assert np.array_equal(new[2].numpy(), old[2])  # the empty cluster keeps its centroid


def test_reduce_shards_one_shard_is_kmeans_update():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(500, 12)).astype(np.float32))
    valid = torch.from_numpy(rng.random(500) < 0.9)
    cent = x[:9].clone()
    cent[4] += 100.0  # a centroid no row picks
    assign = kmeans.kmeans_assign(x, cent, False)
    sums, counts, new, _ = kmeans.kmeans_update_plain(x, valid, assign, cent)
    got, got_counts = kmeans.kmeans_reduce_shards_plain(sums[None], counts[None], cent)
    assert torch.equal(got, new) and torch.equal(got_counts, counts)
    assert counts[4] == 0 and torch.equal(got[4], cent[4])


def test_reduce_shards_refuses_bad_shapes():
    with pytest.raises(ValueError):
        kmeans.kmeans_reduce_shards(torch.zeros(2, 3, 4), torch.zeros(2, 4), torch.zeros(3, 4))


# ── a Collection on a mesh ───────────────────────────────────────────────


@pytest.fixture
def meshes8():
    jm, tm = _meshes(8, 1)
    jmesh.set_default_mesh(jm)
    tmesh.set_default_mesh(tm)
    yield jm, tm
    jmesh.set_default_mesh(None)
    tmesh.set_default_mesh(None)


def _client(pkg, root):
    return pkg.VectorDBClient(str(root), **({"device": "cpu"} if pkg is lynsedb_tpu_torch else {}))


def _collection(pkg, root, vecs, fields, **kw):
    client = _client(pkg, root)
    coll = client.create_database("d", drop_if_exists=True).require_collection(
        "c", dim=vecs.shape[1], drop_if_exists=True, **kw)
    coll.add(list(range(len(vecs))), vectors=vecs, fields=fields)
    coll.commit()
    return client, coll


def _same(a, b, vecs, q, metric="ip"):
    ai, bi = np.asarray(a.ids)[None], np.asarray(b.ids)[None]
    assert ai.shape == bi.shape
    assert_same_ids(ai, bi, vecs, np.atleast_2d(q), metric)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [500, 8192])
def test_collection_on_mesh_crud_parity(tmp_path, meshes8, n):
    """500 rows: the exact plan; 8,192: the two-pass plan, ``b = 1`` (a
    third of the rows) a mask on it and ``g = 1`` (2%) the gather route."""
    jm, tm = meshes8
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(n, 12)).astype(np.float32)
    fields = [{"b": i % 3, "g": int(i % 50 == 0)} for i in range(n)]

    tclient, tcoll = _collection(lynsedb_tpu_torch, tmp_path / "t", vecs, fields)
    assert tcoll._engine.corpus().mesh is tm
    jclient, jcoll = _collection(lynsedb_tpu, tmp_path / "j", vecs, fields)
    assert jcoll._engine.corpus().mesh is jm
    tmesh.set_default_mesh(None)
    rclient, ref = _collection(lynsedb_tpu_torch, tmp_path / "r", vecs, fields)
    assert ref._engine.corpus().mesh is None
    tmesh.set_default_mesh(tm)
    try:
        colls = (tcoll, ref, jcoll)
        for q in (vecs[17], vecs[3] + 0.5):
            for where in (None, "b = 1", "g = 1"):
                a, r, j = (c.search(q, k=7, where=where) for c in colls)
                _same(a, r, vecs, q)
                _same(a, j, vecs, q)
        big = tcoll.batch_search(vecs[:5] - 0.1, k=9, where="b = 1")
        for row, res in enumerate(ref.batch_search(vecs[:5] - 0.1, k=9, where="b = 1")):
            _same(big[row], res, vecs, vecs[row] - 0.1)
        for c in colls:
            c.delete([17])
        for c in colls:
            assert 17 not in np.asarray(c.search(vecs[17], k=7).ids).tolist()
        _same(tcoll.search(vecs[17], k=7), ref.search(vecs[17], k=7), vecs, vecs[17])
        _same(tcoll.search(vecs[17], k=7), jcoll.search(vecs[17], k=7), vecs, vecs[17])

        rs = tcoll.search_stream(vecs[:10], k=3, window=4)
        js = jcoll.search_stream(vecs[:10], k=3, window=4)
        assert len(rs) == len(js) == 10
        live = np.ones(n, dtype=bool)
        live[17] = False
        for qi in range(10):
            _same(rs[qi], js[qi], vecs, vecs[qi])
            scores = np.where(live, vecs[qi] @ vecs.T, -np.inf)
            assert int(rs[qi].ids[0]) == int(np.argmax(scores))

        rng_d, rng_j = (c.search_range(vecs[4], 8.0, max_results=50) for c in (tcoll, jcoll))
        _same(rng_d, rng_j, vecs, vecs[4])
    finally:
        for c in (tclient, jclient, rclient):
            c.close()


def test_gather_route_scans_each_shards_rows(tmp_path, meshes8):
    _, tm = meshes8
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(8192, 8)).astype(np.float32)
    client, coll = _collection(lynsedb_tpu_torch, tmp_path / "t", vecs,
                               [{"g": int(i % 40 == 0)} for i in range(8192)])
    try:
        corpus = coll._engine.corpus()
        prof = coll.search_profile(vecs[40], k=5, where="g = 1")
        rows = np.arange(0, 8192, 40)
        per_shard = [int(((rows >= sh.lo) & (rows < sh.lo + sh.n)).sum()) for sh in corpus.views()]
        c = corpus._shortlist_size(5, len(rows))
        assert prof["scanned_vectors"] == len(rows) + sum(min(c, m) for m in per_shard if m)
        assert int(coll.search(vecs[40], k=5, where="g = 1").ids[0]) == 40
    finally:
        client.close()


def test_device_corpus_mesh_two_pass(meshes8):
    """The two-pass plan at 8,192 rows (above TWO_PASS_MIN_ROWS) under IP,
    L2 and cosine, against the JAX package's mesh corpus and numpy."""
    jm, tm = meshes8
    rng = np.random.default_rng(42)
    n, d, k = 8192, 32, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(3, d)).astype(np.float32)
    tc, jc = DeviceCorpus(d, device="cpu"), JaxCorpus(d)
    assert tc.mesh is tm and jc.mesh is jm
    tc.append(x)
    jc.append(x)
    shards = tc.views()
    assert len(shards) == 8 and shards[0].rows * 8 == tc.capacity
    for metric in ("ip", "l2", "cosine"):
        td, ti = tc.search(q, k, Metric(metric))
        jd, ji = jc.search(q, k, JaxMetric(metric))
        assert_same_ids(ti, ji, x, q, metric)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)
    assert tc.last_scanned == n + sum(min(tc._shortlist_size(k, n), sh.rows)
                                      for sh in tc.views())
    want = np.argsort(-(q @ x.T), axis=1)[:, :k]
    ti = tc.search(q, k, Metric.IP)[1]
    for b in range(3):
        assert set(ti[b].tolist()) == set(want[b].tolist())


def test_device_corpus_mesh_metrics_and_approx(meshes8):
    """The exact plan (L1, Hamming) and the L1 family's approximate plan
    over shards, against the port on one device."""
    _, tm = meshes8
    rng = np.random.default_rng(4)
    n = 70_000  # above APPROX_MIN_ROWS
    x = rng.random((n, 8)).astype(np.float32)
    q = rng.random((2, 8)).astype(np.float32)
    mc = DeviceCorpus(8, device="cpu")
    tmesh.set_default_mesh(None)
    one = DeviceCorpus(8, device="cpu")
    tmesh.set_default_mesh(tm)
    assert mc.mesh is tm and one.mesh is None
    for c in (mc, one):
        c.append(x)
        c.set_tombstones(np.arange(n) % 7 == 0)
    for metric in (Metric.L1, Metric.HAMMING):
        md, mi = mc.search(q, 5, metric)
        od, oi = one.search(q, 5, metric)
        np.testing.assert_allclose(md, od, rtol=1e-5, atol=1e-5)
        assert np.array_equal(mi, oi)  # Hamming's ties: the lower id first in both
    md, mi = mc.search_approx(q, 5, Metric.L1)
    od, oi = one.search_approx(q, 5, Metric.L1)
    np.testing.assert_allclose(md, od, rtol=1e-5, atol=1e-5)
    assert not (mi % 7 == 0).any()
    got = mc.rescore(q, mi, Metric.L1)
    np.testing.assert_allclose(got, md, rtol=1e-5, atol=1e-5)


def test_mesh_corpus_budget_raises(meshes8, monkeypatch):
    from lynsedb_tpu_torch.ops import scan

    c = DeviceCorpus(16, device="cpu")
    c.append(np.zeros((5000, 16), np.float32))
    monkeypatch.setattr(scan, "DEVICE_BYTES", 1 << 20)
    with pytest.raises(RuntimeError, match="LYNSE_DEVICE_BYTES"):
        c.search(np.zeros((1, 16), np.float32), 3, Metric.IP)
    assert not c.would_stream()


def test_mesh_corpus_whole_arrays_within_budget(meshes8, monkeypatch):
    """The whole arrays the indexes read on the home device count against
    the budget beside the shards: with room for the shards and the gathered
    bf16 copy only, staging the whole f32 copy raises naming the budget."""
    from lynsedb_tpu_torch.ops import scan

    n, d = 5000, 16
    c = DeviceCorpus(d, device="cpu")
    c.append(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32))
    cap = c._cap_for(n)
    n_local = cap // 8
    shards = 8 * n_local * (d * (2 + 4) + 4 * 3 + 2) + c._scratch_bytes(n_local)
    monkeypatch.setattr(scan, "DEVICE_BYTES", shards + cap * d * 2)
    _, ids = c.search(np.ones((1, d), np.float32), 3, Metric.IP)
    assert ids.shape == (1, 3)
    assert c.data16.shape == (cap, d)
    with pytest.raises(RuntimeError, match="LYNSE_DEVICE_BYTES"):
        c._data  # noqa: B018
    monkeypatch.setattr(scan, "DEVICE_BYTES", shards + cap * d * (2 + 4))
    assert c._data.shape == (cap, d)


@pytest.mark.parametrize("mode", ["FLAT-IP-SQ8", "FLAT-IP-PQ"])
def test_quantized_index_on_mesh_parity(tmp_path, meshes8, mode):
    """Per-row code arrays split by the corpus's shards, per-dimension
    parameters copied: the same answers as the port on one device (and, for
    SQ8, whose codes both packages encode to the same bytes, as the JAX
    package on its mesh), also after a tail of rows the mesh does not split
    evenly, where the JAX package's search raises (ROADMAP C)."""
    jm, tm = meshes8
    rng = np.random.default_rng(23)
    vecs = rng.random((800, 16), dtype=np.float32)
    extra = rng.random((100, 16), dtype=np.float32)
    tclient, tcoll = _collection(lynsedb_tpu_torch, tmp_path / "t", vecs, None,
                                 default_index=None)
    tcoll.build_index(mode)
    tmesh.set_default_mesh(None)
    rclient, ref = _collection(lynsedb_tpu_torch, tmp_path / "r", vecs, None, default_index=None)
    ref.build_index(mode)
    tmesh.set_default_mesh(tm)
    jclient = None
    try:
        colls = [tcoll, ref]
        if mode.endswith("SQ8"):
            jclient, jcoll = _collection(lynsedb_tpu, tmp_path / "j", vecs, None,
                                         default_index=None)
            jcoll.build_index(mode)
            colls.append(jcoll)
        for qi in (3, 99, 512):
            got = tcoll.search(vecs[qi], k=5)
            for other in colls[1:]:
                _same(got, other.search(vecs[qi], k=5), vecs, vecs[qi])
        assert len(tcoll._engine._aux_index._dev) > 1  # a part a shard
        for c in colls:  # 900 rows: shards of 128 rows, the last short
            c.add(list(range(800, 900)), vectors=extra)
            c.commit()
        allv = np.concatenate([vecs, extra])
        for qi in (3, 850):
            _same(tcoll.search(allv[qi], k=5), ref.search(allv[qi], k=5), allv, allv[qi])
        if len(colls) == 3:  # the JAX package's row sharding needs 8 | encoded rows
            with pytest.raises(ValueError):
                colls[2].search(allv[3], k=5)
    finally:
        for c in (tclient, rclient, jclient):
            if c is not None:
                c.close()


@pytest.mark.parametrize("mode,metric", [("IVF-L2", "l2"), ("HNSW-L2", "l2"),
                                         ("DISKANN-L2", "l2")])
def test_index_on_mesh_answers_as_jax(tmp_path, meshes8, mode, metric):
    """The JAX package builds and searches these indexes on its mesh; the
    port opens the same index on its mesh and answers the same, and builds
    its own on the mesh as on one device."""
    rng = np.random.default_rng(31)
    vecs = rng.normal(size=(1200, 16)).astype(np.float32)
    q = vecs[[5, 700, 1199]] + 0.05
    kw = {"n_clusters": 16} if mode.startswith("IVF") else {}
    jclient, jcoll = _collection(lynsedb_tpu, tmp_path / "j", vecs, None, default_index=None)
    jcoll.build_index(mode, **kw)
    want = jcoll.batch_search(q, k=8, nprobe=8)
    jclient.close()
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    tclient = _client(lynsedb_tpu_torch, tmp_path / "t")
    try:
        tcoll = tclient.get_database("d").get_collection("c")
        assert tcoll._engine.corpus().mesh is not None
        got = tcoll.batch_search(q, k=8, nprobe=8)
        for r in range(len(q)):
            _same(got[r], want[r], vecs, q[r], metric)
    finally:
        tclient.close()
    bclient, built = _collection(lynsedb_tpu_torch, tmp_path / "b", vecs, None,
                                 default_index=None)
    built.build_index(mode, **kw)
    tmesh.set_default_mesh(None)
    oclient, one = _collection(lynsedb_tpu_torch, tmp_path / "o", vecs, None, default_index=None)
    one.build_index(mode, **kw)
    try:
        for a, b, r in zip(built.batch_search(q, k=8, nprobe=8), one.batch_search(q, k=8, nprobe=8),
                           range(len(q))):
            _same(a, b, vecs, q[r], metric)
    finally:
        bclient.close()
        oclient.close()


def test_dryrun_multichip_cpu():
    dryrun_multichip(8, "cpu")
    assert tmesh.get_default_mesh() is None

"""The port's HNSW and DiskANN indexes (on the CPU: the kernels' plain
versions) against lynsedb_tpu.index.{hnsw,diskann}, on the same seeded
inputs.

Each package opens an index directory the other built and gives the same
answers, unfiltered and under a 50% filter (ids identical except at a
near-tie: float64 distances within rtol 1e-5, atol 1e-4; distances rtol 1e-5,
atol 1e-4). The port's own builds hold the upstream gate's recall@10 floor of
0.90 (benchmarks/gate_index_modes.py:49-52), filtered results respect the
filter, deleted rows never surface, in-place inserts and deletes apply the
same updates as the JAX package's, rows past the build are served by the
exact tail, the layered SQ8 and PQ tiers hold the floor, and a batch past the
beam's bitmap cap splits into sub-batches with the same answers.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

import lynsedb_tpu
import lynsedb_tpu_torch
from lynsedb_tpu_torch.index import diskann as port_diskann
from lynsedb_tpu_torch.ops import graph as port_graph
from test_torch_scan import assert_same_ids, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
DIM, N, K = 32, 1200, 10
MODES = [("HNSW-L2", "l2"), ("HNSW-IP", "ip"), ("HNSW-COS", "cosine"), ("DISKANN-L2", "l2"),
         ("DISKANN-IP", "ip")]


def _inputs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    return rng, x, q


def _client(pkg, root):
    return pkg.VectorDBClient(root, **({"device": "cpu"} if pkg is lynsedb_tpu_torch else {}))


def _build(pkg, root, mode, x, **kw):
    client = _client(pkg, root)
    coll = client.create_database("d").require_collection("c", dim=DIM)
    coll.add(list(range(len(x))), vectors=x, fields=[{"b": i % 2} for i in range(len(x))])
    coll.commit()
    coll.build_index(mode, **kw)
    client.close()


def _open(pkg, root):
    client = _client(pkg, root)
    return client, client.get_database("d").get_collection("c")


def _answers(coll, q, wheres=(None, "b = 1")):
    return [[(np.asarray(r.ids), np.asarray(r.distances))
             for r in coll.batch_search(q, k=K, where=where, nprobe=80)] for where in wheres]


def _assert_same(got, want, x, q, metric):
    for g, w in zip(got, want):
        for r, ((gi, gd), (wi, wd)) in enumerate(zip(g, w)):
            assert len(set(gi.tolist())) == len(gi) == K
            assert_same_ids(gi[None], wi[None], x, q[r : r + 1], metric)
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


def _want(x, q, metric, rows=None):
    rows = np.arange(len(x)) if rows is None else rows
    xs = x[rows]
    if metric == "l2":
        score = -((xs[None] - q[:, None]) ** 2).sum(-1)
    elif metric == "ip":
        score = q @ xs.T
    else:
        score = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            xs / np.linalg.norm(xs, axis=1, keepdims=True)).T
    return rows[np.argsort(-score, axis=1)[:, :K]]


def _recall(ids_rows, want) -> float:
    return np.mean([len(set(map(int, g)) & set(map(int, w))) / K for g, w in zip(ids_rows, want)])


@pytest.mark.parametrize("mode,metric", MODES)
def test_jax_index_opens_in_port(tmp_path, mode, metric):
    _, x, q = _inputs()
    _build(lynsedb_tpu, tmp_path / "j", mode, x)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        assert tcoll._engine._index.kind == jcoll._engine._index.kind
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), x, q, metric)
    finally:
        jclient.close()
        tclient.close()


@pytest.mark.parametrize("mode,metric", MODES)
def test_port_index_opens_in_jax_and_holds_recall(tmp_path, mode, metric):
    _, x, q = _inputs(1)
    _build(lynsedb_tpu_torch, tmp_path / "t", mode, x)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        name = "hnsw.npz" if mode.startswith("HNSW") else "graph.npz"
        files = np.load(tcoll._engine.root / "index" / name)  # the JAX package's layout
        graph = files["layer0" if mode.startswith("HNSW") else "graph"]
        assert graph.dtype == np.int32 and graph.shape[0] == N
        got = _answers(tcoll, q)
        _assert_same(got, _answers(jcoll, q), x, q, metric)
        assert _recall([g[0] for g in got[0]], _want(x, q, metric)) >= 0.9
        odd = np.arange(1, N, 2)
        assert _recall([g[0] for g in got[1]], _want(x, q, metric, odd)) >= 0.9
        assert all((g[0] % 2 == 1).all() for g in got[1])  # the filter holds
    finally:
        jclient.close()
        tclient.close()


def test_deletes_and_medoid_delete(tmp_path):
    _, x, q = _inputs(2)
    _build(lynsedb_tpu_torch, tmp_path / "t", "DISKANN-L2", x, r=16, l=40)
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        idx = coll._engine._index
        target = int(np.argmin(((x - q[1]) ** 2).sum(-1)))
        dead = [target] + [int(s) for s in idx._starts_np.tolist()]
        coll.delete(dead)
        coll.commit()  # repairs in place; the medoid moves to a live row
        assert int(idx.medoid) not in dead
        res = coll.search(q[1], k=5, nprobe=64)
        assert len(res.ids) == 5 and not set(dead) & set(res.ids.tolist())
        assert not np.isin(idx.graph_np[dead], np.arange(N)).any()  # deleted lists cleared
    finally:
        client.close()


@pytest.mark.parametrize("mode,kw", [("DISKANN-L2", {"r": 16, "l": 40}),
                                     ("HNSW-L2", {"m": 8, "ef_construction": 48})])
def test_in_place_updates_match_jax(tmp_path, mode, kw):
    """The same deletes and inserts committed in both packages on copies of
    one index: the same in-place updates (no rebuild), the same answers."""
    rng, x, q = _inputs(3, n=1500)
    _build(lynsedb_tpu, tmp_path / "j", mode, x, **kw)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        fresh = rng.normal(size=(150, DIM)).astype(np.float32)
        dead = [int(i) for i in rng.choice(1500, 100, replace=False)] if mode.startswith("D") else []
        for c in (jcoll, tcoll):
            if dead:
                c.delete(dead)
            c.add(list(range(1500, 1650)), vectors=fresh,
                  fields=[{"b": i % 2} for i in range(1500, 1650)])
            c.commit()
        jidx, tidx = jcoll._engine._index, tcoll._engine._index
        assert tidx.built_rows == jidx.built_rows == 1650  # linked, not tail-scanned
        tg = tidx.graph_np if mode.startswith("D") else tidx.layer0_np
        jg = jidx.graph_np if mode.startswith("D") else jidx.layer0_np
        assert (tg == jg).all(axis=1).mean() >= 0.99  # a near-tie prune may flip a row
        allx = np.concatenate([x, fresh])
        got = _answers(tcoll, q, (None,))
        assert _recall([g[0] for g in got[0]], _want(allx, q, "l2")) >= 0.9
        same = np.mean([np.array_equal(g[0], w[0]) for g, w in zip(got[0], _answers(jcoll, q, (None,))[0])])
        assert same >= 0.85
        assert not set(dead) & set(np.concatenate([g[0] for g in got[0]]).tolist())
    finally:
        jclient.close()
        tclient.close()


def test_tail_and_reload(tmp_path):
    """Rows added without a commit are served by the exact tail; the index
    reloads from disk."""
    rng, x, q = _inputs(4, n=1000)
    _build(lynsedb_tpu_torch, tmp_path / "t", "HNSW-L2", x)
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        new = (rng.normal(size=(1, DIM)) + 9.0).astype(np.float32)
        coll.add([7777], vectors=new)
        assert coll._engine._index.built_rows == 1000
        assert coll.search(new[0], k=1).ids[0] == 7777
    finally:
        client.close()
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        assert coll._engine._index.kind == "hnsw"
        res = coll.search(q[0], k=5, nprobe=64)
        assert len(res.ids) == 5
    finally:
        client.close()


@pytest.fixture(scope="module")
def jax_layered(tmp_path_factory):
    """A layered DiskANN-L2 index (PQ and SQ8 fitted) built once by the JAX
    package, with its rows and queries."""
    import lynsedb_tpu.index.diskann as jax_diskann

    root = tmp_path_factory.mktemp("layered")
    _, x, q = _inputs(5, n=1500)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_diskann, "LAYERED_MIN_ROWS", 1000)
        _build(lynsedb_tpu, root, "DISKANN-L2", x)
    return root, x, q


@pytest.mark.parametrize("tier", ["bf16", "sq8", "pq"])
def test_layered_tiers_match_jax(tmp_path, jax_layered, tier):
    """A layered DiskANN index (PQ and SQ8 fitted; built by the JAX package)
    walked by each guidance tier in both packages: the same answers, the
    gate's recall floor, exact distances."""
    root, x, q = jax_layered
    shutil.copytree(root, tmp_path / "j")
    shutil.copytree(root, tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        for c in (jcoll, tcoll):
            idx = c._engine._index
            assert idx.layered and idx.sq8_codes is not None
            if tier != "bf16":
                setattr(idx, f"_force_{tier}", True)
        got = _answers(tcoll, q, (None,))
        _assert_same(got, _answers(jcoll, q, (None,)), x, q, "l2")
        assert _recall([g[0] for g in got[0]], _want(x, q, "l2")) >= 0.9
        for r, (ids, dists) in enumerate(got[0]):  # exact distances (the host rescore)
            np.testing.assert_allclose(dists, ((x[ids] - q[r]) ** 2).sum(-1), rtol=1e-4, atol=1e-4)
    finally:
        jclient.close()
        tclient.close()


def test_port_layered_build_and_insert(tmp_path, monkeypatch):
    """The port's own layered build: the code tiers cover in-place inserts
    (row scales, norms and SQ8 codes included) and reload."""
    monkeypatch.setattr(port_diskann, "LAYERED_MIN_ROWS", 1000)
    n = 1200
    rng, x, q = _inputs(6, n=n)
    _build(lynsedb_tpu_torch, tmp_path / "t", "DISKANN-IP", x)
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        extra = rng.normal(size=(50, DIM)).astype(np.float32)
        coll.add(list(range(n, n + 50)), vectors=extra)
        coll.commit()
        idx = coll._engine._index
        assert idx.layered
        assert len(idx.pq_codes) == len(idx.pq_alpha) == len(idx.sq8_codes) == n + 50
        allx = np.concatenate([x, extra])
        for tier in ("sq8", "pq"):
            setattr(idx, f"_force_{tier}", True)
            res = coll.batch_search(q, k=K, nprobe=80)
            assert _recall([np.asarray(r.ids) for r in res], _want(allx, q, "ip")) >= 0.9
            setattr(idx, f"_force_{tier}", False)
        assert n + 49 in coll.search(extra[-1] * 3, k=5, nprobe=80).ids.tolist()
    finally:
        client.close()
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        assert coll._engine._index.layered and len(coll._engine._index.pq_codes) == n + 50
    finally:
        client.close()


def test_search_subbatches_past_beam_cap(tmp_path, monkeypatch):
    _, x, _ = _inputs(7)
    _build(lynsedb_tpu_torch, tmp_path / "t", "DISKANN-IP", x)
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        monkeypatch.setattr(port_graph, "bitmap_budget", lambda device: 1)
        assert port_graph.beam_batch_cap(N, coll._engine.device) == 16
        qs = x[:40] + np.float32(0.01)
        rows = coll.batch_search(qs, K, nprobe=80)
        assert len(rows) == 40
        for i in range(4):  # a single search agrees with the split batch
            solo = coll.search(qs[i], k=K, nprobe=80)
            assert solo.ids.tolist() == np.asarray(rows[i].ids).tolist()
        assert _recall([np.asarray(r.ids) for r in rows], _want(x, qs, "ip")) >= 0.9
    finally:
        client.close()


@pytest.mark.parametrize("mode", ["HNSW-L1", "HNSW-CHEBYSHEV"])
def test_hnsw_domain_metrics_raise_k6(tmp_path, mode):
    """HNSW under a domain metric builds and serves on the port (it raised
    before the graph's domain-metric keys, K6g, were ported): every row
    finds itself first, at distance 0, and the best ten are a float64 brute
    force's within rtol 1e-5."""
    rng = np.random.default_rng(16)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    client = _client(lynsedb_tpu_torch, tmp_path / "t")
    try:
        coll = client.create_database("d").require_collection("c", dim=8)
        coll.add(vectors=x)
        coll.build_index(mode, m=6)
        p = 1 if mode == "HNSW-L1" else np.inf
        for r, view in enumerate(coll.batch_search(x[:5], k=K, nprobe=80)):
            assert view.ids[0] == r and view.distances[0] == 0.0
            want = np.sort(np.linalg.norm(x.astype(np.float64) - x[r], ord=p, axis=1))[:K]
            np.testing.assert_allclose(view.distances, want, rtol=1e-5, atol=1e-6)
    finally:
        client.close()

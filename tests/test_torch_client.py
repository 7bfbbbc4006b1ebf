"""The port's embedded slice end to end against the JAX package.

The same add / commit / search / where / upsert / delete sequence runs
through ``lynsedb_tpu.VectorDBClient`` and ``lynsedb_tpu_torch.VectorDBClient
(device="cpu")``; a root directory written by either package opens in the
other and answers the same searches; and the port imports neither JAX,
the JAX package, msgpack nor ml_dtypes.

Tolerances: distances rtol=1e-5, atol=1e-4 (f32 sums in another order); ids
identical except at a near-tie (float64 distances within that tolerance).
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import lynsedb_tpu
import lynsedb_tpu_torch
from test_torch_scan import assert_same_ids

DIM = 16
REPO = Path(__file__).resolve().parent.parent


def _rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    fields = [{"bucket": int(i % 10), "name": f"doc-{seed}-{i}"} for i in range(n)]
    return x, fields


def _drive(coll, queries):
    """The slice's calls; returns what each search answered."""
    out = []
    for where in (None, "bucket = 3", "bucket >= 8"):
        for q in queries[:4]:
            r = coll.search(q, k=10, where=where)
            out.append((np.asarray(r.ids), np.asarray(r.distances)))
        for r in coll.batch_search(queries, k=10, where=where):
            out.append((np.asarray(r.ids), np.asarray(r.distances)))
    return out


def _sequence(client, seed: int = 0):
    """add (small: exact plan) -> search -> add more (two-pass plan) ->
    upsert / delete -> commit -> search."""
    db = client.create_database("slice", drop_if_exists=True)
    coll = db.require_collection("vecs", dim=DIM)
    x1, f1 = _rows(seed, 3000)
    coll.add(vectors=x1, fields=f1)
    coll.commit()
    queries = np.random.default_rng(seed + 99).normal(size=(12, DIM)).astype(np.float32)
    answers = _drive(coll, queries)
    x2, f2 = _rows(seed + 1, 6000)
    coll.add(vectors=x2, fields=f2)
    coll.upsert([5, 17, 4000], vectors=x2[:3] * 2.0, fields=[{"bucket": 3}] * 3)
    coll.delete([1, 2, 3, 4100])
    coll.commit()
    answers += _drive(coll, queries)
    answers.append((coll.query(where="bucket = 3", return_ids_only=True), None))
    return coll, queries, answers


def _assert_same_answers(a, b, corpus, queries):
    assert len(a) == len(b)
    for j, ((ia, da), (ib, db)) in enumerate(zip(a, b)):
        if da is None:
            np.testing.assert_array_equal(ia, ib)
            continue
        pos = j % (4 + len(queries))  # _drive: 4 single searches, then the batch
        q = queries[pos if pos < 4 else pos - 4]
        assert_same_ids(ia[None, :], ib[None, :], corpus, q[None, :], "ip")
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-4)


def _corpus(coll) -> np.ndarray:
    return coll.query_vectors().vectors


def test_slice_matches_jax(tmp_path):
    jclient = lynsedb_tpu.VectorDBClient(tmp_path / "jax")
    tclient = lynsedb_tpu_torch.VectorDBClient(tmp_path / "torch", device="cpu")
    try:
        jcoll, queries, jans = _sequence(jclient)
        tcoll, _, tans = _sequence(tclient)
        assert jcoll.shape == tcoll.shape
        full = np.concatenate([_rows(0, 3000)[0], _rows(1, 6000)[0]])
        full[[5, 17, 4000]] = _rows(1, 6000)[0][:3] * 2.0
        _assert_same_answers(tans, jans, full, queries)
        assert tcoll.stats()["live_rows"] == jcoll.stats()["live_rows"]
    finally:
        jclient.close()
        tclient.close()


def test_port_opens_a_root_the_jax_package_wrote(tmp_path):
    root = tmp_path / "root"
    jclient = lynsedb_tpu.VectorDBClient(root)
    jcoll, queries, _ = _sequence(jclient, seed=3)
    jcoll.checkpoint()  # idmap / field snapshots, then more log records on top
    x3, f3 = _rows(5, 500)
    jcoll.add(vectors=x3, fields=f3)
    jcoll.delete([10, 11])
    jcoll.commit()
    corpus = _corpus(jcoll)
    jans = _drive(jcoll, queries)
    jclient.close()

    tclient = lynsedb_tpu_torch.VectorDBClient(root, device="cpu")
    try:
        tcoll = tclient.get_database("slice").get_collection("vecs")
        assert tcoll.shape == (9500, DIM)
        assert tcoll.max_id() == 9499
        assert sorted(tcoll.list_deleted_ids()) == [1, 2, 3, 10, 11, 4100]
        assert tcoll.query(filter_ids=[42])["fields"][0]["name"] == "doc-3-42"
        _assert_same_answers(_drive(tcoll, queries), jans, corpus, queries)
    finally:
        tclient.close()


_PORT_WRITER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import lynsedb_tpu_torch as lt
    root = sys.argv[1]
    rng = np.random.default_rng(8)
    client = lt.VectorDBClient(root, device="cpu")
    coll = client.create_database("w").require_collection("c", dim=8)
    x = rng.normal(size=(5000, 8)).astype(np.float32)
    coll.add(vectors=x[:4000], fields=[{"bucket": i % 10} for i in range(4000)])
    coll.commit()
    coll.add(["s1", "s2"], vectors=x[4000:4002], fields=[{"bucket": 3}, None])
    coll.delete([7])
    r = coll.search(x[4000], k=3, where="bucket = 3")
    banned = ("jax", "jaxlib", "lynsedb_tpu", "msgpack", "ml_dtypes")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    print(json.dumps({"ids": [str(i) for i in r.ids], "loaded": loaded}), flush=True)
    os._exit(0)  # no close: the last writes live only in the WAL and logs
""")


def test_port_imports_no_jax_and_jax_opens_its_root(tmp_path):
    root = tmp_path / "written_by_port"
    proc = subprocess.run([sys.executable, "-c", _PORT_WRITER, str(root)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["ids"][0] == "s1"

    jclient = lynsedb_tpu.VectorDBClient(root)  # recovers the WAL the port left
    try:
        jcoll = jclient.get_database("w").get_collection("c")
        assert jcoll.shape == (4002, 8)
        assert jcoll.is_id_exists("s2")
        assert jcoll.list_deleted_ids() == [7]
        x = np.random.default_rng(8).normal(size=(5000, 8)).astype(np.float32)
        r = jcoll.search(x[4000], k=3, where="bucket = 3")
        assert [str(i) for i in r.ids] == out["ids"]
    finally:
        jclient.close()


def test_float16_storage_matches_jax(tmp_path):
    """f16 on-disk rows (the port casts with numpy, the JAX package with its
    native codec; both round to nearest even) give the same answers, and
    each package reads the other's f16 segments."""
    x, fields = _rows(21, 5000)
    q = np.random.default_rng(22).normal(size=(3, DIM)).astype(np.float32)
    answers = []
    for pkg, kw, root in ((lynsedb_tpu, {}, "j16"), (lynsedb_tpu_torch, {"device": "cpu"}, "t16")):
        client = pkg.VectorDBClient(tmp_path / root, **kw)
        coll = client.create_database("d").require_collection("c", dim=DIM, dtypes="float16")
        coll.add(vectors=x, fields=fields)
        coll.commit()
        answers.append([coll.search(v, k=5) for v in q])
        client.close()
    x16 = x.astype(np.float16).astype(np.float32)
    for r, (a, b) in enumerate(zip(*answers)):
        assert_same_ids(np.asarray(b.ids)[None], np.asarray(a.ids)[None], x16, q[r : r + 1], "ip")
        np.testing.assert_allclose(b.distances, a.distances, rtol=1e-5, atol=1e-4)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "j16", device="cpu")
    try:
        rows = client.get_database("d").get_collection("c").head(3).vectors
        np.testing.assert_array_equal(rows, x[:3].astype(np.float16).astype(np.float32))
    finally:
        client.close()


def test_device_is_explicit(tmp_path):
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            lynsedb_tpu_torch.VectorDBClient(tmp_path / "a")
    with pytest.raises(NotImplementedError, match="A.11"):
        lynsedb_tpu_torch.VectorDBClient("http://localhost:7637", device="cpu")
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "b", device="cpu")
    try:
        coll = client.create_database("d").require_collection("c", dim=4)
        coll.add(vectors=np.eye(4, dtype=np.float32))
        with pytest.raises(NotImplementedError, match="A.10"):
            coll.build_index("HNSW-L2")
        with pytest.raises(NotImplementedError, match="A.13"):
            coll.bm25_search("hello")
        assert coll.search(np.eye(4, dtype=np.float32)[2], k=1).ids.tolist() == [2]
    finally:
        client.close()

"""The port's quantized FLAT indexes (SQ8, PQ, RaBitQ, PolarVec; on the CPU:
the kernels' plain versions) against lynsedb_tpu.index.quantized, on the same
seeded inputs.

Each of FLAT-{IP,L2,COS}-{SQ8,PQ,RABITQ,POLARVEC} (and FLAT-IP-PQ32,
FLAT-L2-POLARVEC6) is built by one package and opened by the other, in both
directions, and both answer the same searches
at k in {1, 10, 100}, unfiltered and under a 50% filter. Rows added past the
encode are served by the host route (``_search_host``: encoded_rows <
n_rows) until the commit encodes them (``on_commit``). SQ8, RaBitQ and
PolarVec write the same ``aux.npz`` arrays in both packages. The recall
floors of tests/test_quantized.py hold for the port's own builds, and an
index whose codes and search scratch do not fit the card raises before it
is staged.

Tolerances: distances rtol=1e-5, atol=1e-4 (exact f32 scores, sums taken in
another order); ids identical except at a near-tie (float64 distances within
that tolerance).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

import lynsedb_tpu
import lynsedb_tpu_torch
from lynsedb_tpu_torch.index import resolve_index_mode
from test_torch_scan import assert_same_ids, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
DIM, N, K_MAX = 64, 5000, 100
KINDS = ("SQ8", "PQ", "RABITQ", "POLARVEC")
METRIC = {"IP": "ip", "L2": "l2", "COS": "cosine"}
MODES = [f"FLAT-{m}-{k}" for m in METRIC for k in KINDS]
SIZED = ["FLAT-IP-PQ32", "FLAT-L2-POLARVEC6"]  # 32 subspaces; 6 bits a dimension


def _inputs():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(N, DIM)) + 0.2).astype(np.float32)
    x[100:105] = x[7]  # duplicated rows: exact ties broken by id
    extra = (rng.normal(size=(300, DIM)) + 0.2).astype(np.float32)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    q[2] = x[7]
    q[5] = extra[3]  # a query whose best row is in the tail
    return x, extra, q


def _fields(lo: int, n: int):
    return [{"bucket": (lo + i) % 2} for i in range(n)]


def _client(pkg, root):
    return pkg.VectorDBClient(root, **({"device": "cpu"} if pkg is lynsedb_tpu_torch else {}))


def _open(pkg, root):
    client = _client(pkg, root)
    return client, client.get_database("d").get_collection("c")


def _build(pkg, root, mode, x):
    client = _client(pkg, root)
    coll = client.create_database("d").require_collection("c", dim=DIM)
    coll.add(vectors=x, fields=_fields(0, len(x)))
    coll.commit()
    coll.build_index(mode)
    client.close()


def _answers(coll, q):
    out = []
    for k in (1, 10, K_MAX):
        for where in (None, "bucket = 0"):  # half the rows: above the exact-filter route
            res = coll.batch_search(q, k=k, where=where)
            out.append([(np.asarray(r.ids), np.asarray(r.distances)) for r in res])
    return out


def _assert_same(got, want, rows, q, metric):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for r, ((gi, gd), (wi, wd)) in enumerate(zip(g, w)):
            assert len(set(gi.tolist())) == len(gi)
            assert_same_ids(gi[None], wi[None], rows, q[r : r + 1], metric)
            np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


def _pair(tmp_path, built_by, mode, x):
    """Build with ``built_by``, copy the root, open both: (jax client, jax
    collection, port client, port collection)."""
    src, dst = ("j", "t") if built_by is lynsedb_tpu else ("t", "j")
    _build(built_by, tmp_path / src, mode, x)
    shutil.copytree(tmp_path / src, tmp_path / dst)
    return (*_open(lynsedb_tpu, tmp_path / "j"), *_open(lynsedb_tpu_torch, tmp_path / "t"))


@pytest.mark.parametrize("built_by", [lynsedb_tpu, lynsedb_tpu_torch], ids=["jax_built", "port_built"])
@pytest.mark.parametrize("mode", MODES + SIZED)
def test_index_opens_in_the_other_package(tmp_path, mode, built_by):
    x, _, q = _inputs()
    jclient, jcoll, tclient, tcoll = _pair(tmp_path, built_by, mode, x)
    try:
        jidx, tidx = jcoll._engine._aux_index, tcoll._engine._aux_index
        assert tidx.kind == jidx.kind == resolve_index_mode(mode).quantizer
        assert tidx.encoded_rows == jidx.encoded_rows == N
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), x, q, METRIC[mode.split("-")[1]])
    finally:
        jclient.close()
        tclient.close()


@pytest.mark.parametrize("mode", ["FLAT-IP-SQ8", "FLAT-L2-RABITQ", "FLAT-COS-POLARVEC"])
def test_aux_files_equal_jax(tmp_path, mode):
    """Both packages, the same rows: the same aux.npz arrays and meta."""
    x, _, _ = _inputs()
    _build(lynsedb_tpu, tmp_path / "j", mode, x)
    _build(lynsedb_tpu_torch, tmp_path / "t", mode, x)
    idx = [next((tmp_path / p).rglob("aux.npz")).parent for p in ("j", "t")]
    jz, tz = (np.load(p / "aux.npz") for p in idx)
    assert sorted(jz.files) == sorted(tz.files)
    for key in jz.files:
        assert jz[key].dtype == tz[key].dtype, key
        np.testing.assert_array_equal(tz[key], jz[key], err_msg=key)
    assert (idx[0] / "aux_meta.json").read_text() == (idx[1] / "aux_meta.json").read_text()


@pytest.mark.parametrize("mode", ["FLAT-IP-SQ8", "FLAT-L2-PQ", "FLAT-COS-RABITQ",
                                  "FLAT-IP-POLARVEC"])
def test_tail_rows_match_jax(tmp_path, mode):
    """Rows past the encode: both packages serve them through the host route
    (an exact scan of the tail merged with the rescored shortlist), then the
    commit encodes them and the device route serves every row."""
    x, extra, q = _inputs()
    metric = METRIC[mode.split("-")[1]]
    jclient, jcoll, tclient, tcoll = _pair(tmp_path, lynsedb_tpu, mode, x)
    try:
        allx = np.concatenate([x, extra])
        for c in (jcoll, tcoll):  # past the encode, uncommitted
            c.add(vectors=extra, fields=_fields(N, len(extra)))
        teng = tcoll._engine
        assert teng._aux_index.encoded_rows == N < teng.n_rows
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), allx, q, metric)
        assert tcoll.search(q[5], k=1).ids[0] == N + 3  # the tail row is found
        for c in (jcoll, tcoll):  # the commit encodes the tail
            c.commit()
        jidx, tidx = jcoll._engine._aux_index, teng._aux_index
        assert tidx.encoded_rows == jidx.encoded_rows == N + len(extra) == teng.n_rows
        for key, val in jidx.state.items():
            if mode.endswith("PQ") and key in ("codes", "row_sq"):
                # PQ's tail codes: kmeans_assign against _pq_assign_all
                assert np.mean(tidx.state[key] == val) > 0.999, key
            else:
                np.testing.assert_array_equal(tidx.state[key], val, err_msg=key)
        _assert_same(_answers(tcoll, q), _answers(jcoll, q), allx, q, metric)
    finally:
        jclient.close()
        tclient.close()


# ── the port's own builds: tests/test_quantized.py's floors ──────────────


def _recall(got_ids, want_ids) -> float:
    got = set(int(i) for i in np.asarray(got_ids).ravel() if i >= 0)
    return len(got & set(int(i) for i in want_ids)) / max(len(want_ids), 1)


@pytest.fixture(scope="module")
def quant_data():
    rng = np.random.default_rng(11)
    n, d = 4000, 64
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    queries = rng.normal(size=(8, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    want = np.argsort(-(queries @ data.T), axis=1)[:, :10]
    return data, queries, want


@pytest.fixture
def db(tmp_path):
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "r", device="cpu")
    yield client.create_database("d")
    client.close()


def _coll(db, name, rows, fields=None):
    coll = db.require_collection(name, dim=rows.shape[1], drop_if_exists=True, default_index=None)
    coll.add(list(range(len(rows))), vectors=rows, fields=fields)
    coll.commit()
    return coll


@pytest.mark.parametrize("mode,floor", [("FLAT-IP-SQ8", 0.95), ("FLAT-IP-PQ", 0.70),
                                        ("FLAT-IP-RABITQ", 0.70), ("FLAT-IP-POLARVEC", 0.70)])
def test_port_recall_floor(db, quant_data, mode, floor):
    data, queries, want = quant_data
    coll = _coll(db, "q_" + mode.replace("-", "_").lower(), data)
    coll.build_index(mode)
    total = sum(_recall(coll.search(queries[i], k=10).ids, want[i]) for i in range(len(queries)))
    assert total / len(queries) >= floor, f"{mode} recall {total / len(queries):.3f} < {floor}"
    prof = coll._engine.search(queries[0], k=10, profile=True).profile
    assert prof["index_path"] == mode.split("-")[2].lower() and prof["scanned_vectors"] > 0


def test_port_sq8_l2_mode(db, quant_data):
    data, queries, _ = quant_data
    coll = _coll(db, "q_l2_sq8", data)
    coll.build_index("FLAT-L2-SQ8")
    want = np.argsort(((data - queries[0]) ** 2).sum(-1))[:10]
    res = coll.search(queries[0], k=10)
    assert _recall(res.ids, want) >= 0.9
    assert all(np.diff(res.distances) >= -1e-6)


def test_port_filtered_search_no_leaks(db, quant_data):
    data, queries, _ = quant_data
    coll = _coll(db, "q_filt", data, fields=[{"bucket": i % 4} for i in range(len(data))])
    coll.build_index("FLAT-IP-PQ")
    res = coll.search(queries[0], k=50, where="bucket = 2", return_fields=True)
    assert len(res.ids) > 0
    assert all(i % 4 == 2 for i in res.ids.tolist())


def test_port_tail_rows_visible(db, quant_data):
    data, _, _ = quant_data
    coll = _coll(db, "q_tail", data[:1000])
    coll.build_index("FLAT-IP-SQ8")
    coll.add([5000], vectors=data[1500:1501] * 3.0)  # past the encode: the host route
    assert coll.search(data[1500] * 3.0, k=1).ids[0] == 5000
    coll.commit()  # encoded incrementally
    assert coll._engine._aux_index.encoded_rows == 1001
    assert coll.search(data[1500] * 3.0, k=1).ids[0] == 5000


def test_port_index_persists(db, quant_data):
    data, queries, _ = quant_data
    coll = _coll(db, "q_persist", data[:500])
    coll.build_index("FLAT-IP-RABITQ")
    from lynsedb_tpu_torch.engine.collection import Collection

    eng = Collection(coll._engine.root, "q_persist", device="cpu")
    assert eng._aux_index is not None and eng._aux_index.kind == "rabitq"
    d, i = eng._aux_index.search(eng, queries[:1], 5)
    assert i.shape[1] == 5
    np.testing.assert_array_equal(i, coll._engine._aux_index.search(coll._engine, queries[:1], 5)[1])
    eng.close()


def test_port_index_that_does_not_fit_raises(db, quant_data, monkeypatch):
    """The codes (padded to 16 columns) and a 64-query search's scratch are
    counted before anything is staged: too little free memory raises."""
    data, _, _ = quant_data
    coll = _coll(db, "q_fit", data[:, :40])  # SQ8 codes padded to 48 columns
    coll.build_index("FLAT-IP-SQ8")
    idx = coll._engine._aux_index
    arrays = idx._staged_arrays()
    assert arrays["codes"].shape == (4000, 48) and not arrays["codes"][:, 40:].any()
    need = idx.device_bytes(arrays)
    assert need >= sum(a.nbytes for a in arrays.values()) + 64 * 4000 * 4
    idx._dev, idx.device = None, torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (need - 1, 10 * need))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)
    with pytest.raises(RuntimeError, match="free"):
        idx._device()

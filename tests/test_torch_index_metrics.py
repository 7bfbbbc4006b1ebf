"""The port's last index modes (on the CPU: the kernels' plain versions)
against the JAX package, on the same seeded inputs: IVF-HAMMING and
IVF-JACCARD (K16b, the bit-packed block scan) and HNSW under the seven domain
metrics (K6g: K17's metric tier, K19's metric mode, K20's pair tables, the
entry scan as K6 + K5).

Held:
  * knn_candidates, exact_knn_graph, entry_scan, the exact beam and
    candidate_pair_keys against lynsedb_tpu.ops.graph under each domain
    metric; build_vamana's adjacency row for row;
  * the port's binary probe (K6b over the thresholded centroids, K5, K16b's
    plain scan, K5) against _ivf_search_kernel on the same index;
  * each of the nine modes built by each package and opened by the other,
    answering the same queries unfiltered and under a half filter, and again
    after rows are added and committed (the index's on_commit);
  * the recall@10 floors of the port's own builds against a float64 brute
    force (graph 0.90, IVF 0.85; a row whose distance ties the 10th within
    the tolerance counts).

Tolerances (PERF.md §2): distances Hamming exact, Jaccard 1e-6, L1,
Chebyshev and correlation rtol 1e-5, Wasserstein rtol 1e-4 + 1e-5 x D,
Hellinger and Jensen-Shannon 4e-7 x D on the squared distance, Haversine
rtol 1e-5 + 4 m; f32 sums in another order. Ids are equal except where the
two rows at a position are a near-tie, their float64 distances within that
tolerance. A prune decision at a float near-tie may flip (ROADMAP C), so
built adjacencies agree row for row in at least 97% of the rows.
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
from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops import graph as JG
from lynsedb_tpu.ops.scan import unpack_search_step
from lynsedb_tpu_torch.configs.config import config as torch_config
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import graph as G
from np_reference import FNS
from test_torch_scan import one_torch_thread  # noqa: F401 (pytestmark's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DOMAIN = ["L1", "CHEBYSHEV", "CORRELATION", "HELLINGER", "WASSERSTEIN", "JENSEN_SHANNON",
          "HAVERSINE"]
MODES = ["HNSW-L1", "HNSW-CHEBYSHEV", "HNSW-CORRELATION", "HNSW-HELLINGER", "HNSW-WASSERSTEIN",
         "HNSW-JENSEN-SHANNON", "HNSW-HAVERSINE", "IVF-HAMMING", "IVF-JACCARD"]
N, DIM, N_BITS, BITS, K = 600, 12, 800, 64, 10
SQUARED = ("HELLINGER", "JENSEN_SHANNON")
HNSW_OPTS = {"m": 6, "ef_construction": 48}  # layer 0: r = 12, l_build = 24
IVF_OPTS = {"n_clusters": 16}
NPROBE = {"HNSW": 60, "IVF": 4}
# the modes whose on_commit is held to the JAX package's (the ones the card's
# path inserts into, and Haversine's (lon, lat) rows)
COMMITTED = ("HNSW-L1", "HNSW-HAVERSINE", "IVF-HAMMING", "IVF-JACCARD")


@pytest.fixture(autouse=True)
def _lloyd_budget(monkeypatch):
    """The port's builds run the default 100 Lloyd steps, whatever
    LYNSE_KMEANS_EPOCHS another test left in the environment."""
    monkeypatch.setattr(torch_config, "LYNSE_KMEANS_EPOCHS", 100)


def _kind(metric: str) -> str:
    if metric in ("HELLINGER", "WASSERSTEIN", "JENSEN_SHANNON"):
        return "hist"
    return {"HAVERSINE": "geo", "HAMMING": "bits", "JACCARD": "bits"}.get(metric, "real")


def _data(kind: str):
    """(rows, queries) of one data shape, from a seed: a gaussian mixture;
    its exponent as histograms (row 5 invalid, row 7 of zero mass); (lon,
    lat) points on the sphere (row 9 at |lat| > 90); bit rows around 12
    prototypes (5% of the bits flipped)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(20, DIM))
    x = (centers[rng.integers(0, 20, N)] + 0.5 * rng.normal(size=(N, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 8)] + 0.5 * rng.normal(size=(8, DIM))).astype(np.float32)
    if kind == "hist":
        x, q = np.exp(x), np.exp(q)
        x[5, 2], x[7] = -1.0, 0.0
    elif kind == "geo":
        pts = np.stack([rng.uniform(-180, 180, N + 8),
                        np.degrees(np.arcsin(rng.uniform(-1, 1, N + 8)))], 1).astype(np.float32)
        x, q = pts[:N], pts[N:]
        x[9, 1] = 95.0
    elif kind == "bits":
        protos = rng.random((12, BITS)) < 0.3
        pick = rng.integers(0, 12, N_BITS + 8)
        b = protos[pick] ^ (rng.random((N_BITS + 8, BITS)) < 0.05)
        x, q = b[:N_BITS].astype(np.float32), b[N_BITS:].astype(np.float32)
    return x, q


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _d64(metric: str, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """float64 distances (len(q), len(rows)) from tests/np_reference.py."""
    fn = FNS[metric.lower()]
    return np.array([[fn(qq, r) for r in rows] for qq in q])


def _tol(metric: str, d: np.ndarray) -> np.ndarray:
    """A distance's tolerance against another engine's (PERF.md §2), on the
    squared distance for Hellinger and Jensen-Shannon."""
    d = np.abs(np.where(np.isfinite(d), d, 0.0))
    if metric == "HAMMING":
        return np.zeros_like(d)
    if metric == "JACCARD":
        return np.full_like(d, 1e-6)
    if metric in SQUARED:
        return np.full_like(d, 4e-7 * DIM)
    if metric == "WASSERSTEIN":
        return 1e-4 * d + 1e-5 * DIM
    if metric == "HAVERSINE":
        return 1e-5 * d + 4.0
    return 1e-5 * d + 1e-5


def _sq(metric: str, d):
    return d * d if metric in SQUARED else d


def _close(metric: str, got, want) -> np.ndarray:
    """Elementwise: equal (infinities included) or within the tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        near = np.abs(_sq(metric, got) - _sq(metric, want)) <= _tol(metric, want)
    return (got == want) | near


def _same_ids(metric: str, got, want, rows, q) -> None:
    """ids equal, except where the two rows are a near-tie for their query."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    assert got.shape == want.shape
    for r, c in zip(*np.nonzero(got != want)):
        assert got[r, c] >= 0 and want[r, c] >= 0, (r, c)
        dg, dw = _d64(metric, q[r : r + 1], rows[[got[r, c], want[r, c]]])[0]
        assert _close(metric, dg, dw), (metric, r, c, dg, dw)


# ── K6g: the graph operations under each domain metric ───────────────────


@pytest.mark.parametrize("metric", DOMAIN)
def test_knn_candidates_metric(metric):
    x, _ = _data(_kind(metric))
    want = JG.knn_candidates(jnp.asarray(x), JMetric[metric], l=16, chunk=256, block=1024)
    got = G.knn_candidates(_t(x), Metric[metric], l=16, chunk=256)
    np.testing.assert_array_equal(got < 0, want < 0)
    ok = want[:, 0] >= 0  # the invalid row has no finite neighbour in either
    _same_ids(metric, got[ok], want[ok], x, x[ok])
    assert not (got == np.arange(N)[:, None]).any()


@pytest.mark.parametrize("metric", DOMAIN)
def test_exact_knn_graph_metric(metric):
    x, _ = _data(_kind(metric))
    want = JG.exact_knn_graph(jnp.asarray(x), JMetric[metric], 8, block=256)
    got = G.exact_knn_graph(_t(x), Metric[metric], 8, chunk=256)
    _same_ids(metric, got, want, x, x)


@pytest.mark.parametrize("metric", DOMAIN)
def test_entry_scan_metric(metric):
    x, q = _data(_kind(metric))
    rng = np.random.default_rng(1)
    ids = np.sort(rng.choice(N, 200, replace=False)).astype(np.int32)
    valid = rng.random(N) >= 0.1
    want = JG.entry_scan(jnp.asarray(q), jnp.asarray(x[ids]), jnp.asarray(ids),
                         jnp.asarray(valid), metric=JMetric[metric], s=8)
    ct = D.corpus_transform(_t(x[ids]), Metric[metric])
    got = G.entry_scan(_t(q), ct, _t(ids), _t(valid), metric=Metric[metric], s=8)
    _same_ids(metric, got.numpy(), np.asarray(want), x, q)


@pytest.mark.parametrize("metric", DOMAIN)
def test_build_and_beam_metric(metric):
    """build_vamana's adjacency, then the exact beam over the JAX package's
    graph (K17's metric tier): the same pools, keys within the tolerance."""
    x, q = _data(_kind(metric))
    want_graph = JG.build_vamana(jnp.asarray(x), JMetric[metric], r=12, l_build=24)
    got_graph = G.build_vamana(_t(x), Metric[metric], r=12, l_build=24)
    assert (got_graph == want_graph).all(axis=1).mean() >= 0.97
    valid = np.random.default_rng(2).random(N) >= 0.1
    for starts in (np.array([3, 17], np.int32),
                   np.array([[11 + i, 40 + i] for i in range(len(q))], np.int32)):
        want = JG.beam_search(jnp.asarray(q), jnp.asarray(x), jnp.asarray(want_graph),
                              jnp.asarray(starts), jnp.asarray(valid), metric=JMetric[metric],
                              beam=32, max_steps=64, k=16)
        got = G.beam_search(_t(q), _t(x), _t(want_graph), _t(starts), _t(valid),
                            metric=Metric[metric], beam=32, max_steps=64, k=16)
        (gk, gi, gs), (wk, wi, ws) = ([np.asarray(a) for a in w] for w in (got, want))
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gi >= 0, wi >= 0)
        fin = wi >= 0
        assert _close(metric, -gk[fin], -wk[fin]).all()
        _same_ids(metric, np.where(fin, gi, 0), np.where(fin, wi, 0), x, q)
        assert valid[gi[gi >= 0]].all()


@pytest.mark.parametrize("metric", DOMAIN)
def test_candidate_pair_keys_metric(metric):
    x, _ = _data(_kind(metric))
    rng = np.random.default_rng(3)
    cands = rng.integers(-1, N, size=(40, 20)).astype(np.int32)
    want = np.asarray(JG.candidate_pair_keys(jnp.asarray(x[np.maximum(cands, 0)]),
                                             JMetric[metric]))
    got = G.candidate_pair_keys(_t(x), _t(cands), Metric[metric]).numpy()
    assert _close(metric, -got, -want).all()
    point, _ = G.robust_prune(_t(x), _t(np.arange(40, dtype=np.int32)), _t(cands),
                              metric=Metric[metric], keys_only=True)
    rows = x[np.maximum(cands, 0)]
    d64 = np.stack([_d64(metric, x[i : i + 1], rows[i])[0] for i in range(40)])
    assert _close(metric, -point.numpy(), d64).all()


# ── K16b: the binary probe against _ivf_search_kernel ────────────────────


def _fields(lo: int, n: int):
    return [{"b": (lo + i) % 2} for i in range(n)]


def _client(pkg, root):
    return pkg.VectorDBClient(root, **({"device": "cpu"} if pkg is lynsedb_tpu_torch else {}))


def _build(pkg, root, mode, x):
    client = _client(pkg, root)
    coll = client.create_database("d").require_collection("c", dim=x.shape[1])
    coll.add(vectors=x, fields=_fields(0, len(x)))
    coll.commit()
    coll.build_index(mode, **(HNSW_OPTS if mode.startswith("HNSW") else IVF_OPTS))
    client.close()


def _open(pkg, root):
    client = _client(pkg, root)
    return client, client.get_database("d").get_collection("c")


@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_binary_probe_matches_jax_kernel(tmp_path, metric):
    """The port's probe (K6b -> K5 -> K16b -> K5, as plain versions) against
    _ivf_search_kernel on the same index, before the dedup: the same keys
    and -inf slots, ids equal but at a tie, every id passing the filter."""
    x, q = _data("bits")
    _build(lynsedb_tpu, tmp_path / "j", f"IVF-{metric}", x)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jclient, jcoll = _open(lynsedb_tpu, tmp_path / "j")
    tclient, tcoll = _open(lynsedb_tpu_torch, tmp_path / "t")
    try:
        jeng, teng = jcoll._engine, tcoll._engine
        jidx, tidx = jeng._index, teng._index
        mask = np.arange(N_BITS) % 3 == 0
        jdev, tdev = jidx._device_state(jeng), tidx._device_state(teng)
        assert tdev["blocks"].dtype == torch.int32  # bit-packed words, not f32 rows
        live_t = teng.corpus().valid_mask(mask)
        qj = jnp.asarray((q > 0.5).astype(np.float32))  # the JAX search thresholds first
        for nprobe, fetch in ((2, 10), (6, 25)):
            packed = _ivf_search_kernel(
                qj, jdev["centroids"], jdev["blocks"], jdev["block_orig"], jdev["cluster_blocks"],
                jeng.corpus().valid_mask(mask), k=fetch, nprobe=nprobe, metric=jidx.metric,
                ascending=True)
            jd, ji = unpack_search_step(np.asarray(packed))
            td, ti = tidx._probe(_t(q), tdev, live_t, fetch, nprobe)
            np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
            fin = np.isfinite(jd)
            np.testing.assert_array_equal(td[fin], jd[fin])  # equal to the bit
            _same_ids(metric, np.where(fin, ti, 0), np.where(fin, ji, 0), x, q)
            assert np.all(mask[ti[fin]])
    finally:
        jclient.close()
        tclient.close()


# ── the nine modes across the two packages ───────────────────────────────


def _metric_of(mode: str) -> str:
    return Metric.from_index_mode(mode).name


def _answers(coll, q, mode):
    nprobe = NPROBE[mode.split("-")[0]]
    return [[(np.asarray(r.ids), np.asarray(r.distances))
             for r in coll.batch_search(q, k=K, where=where, nprobe=nprobe)]
            for where in (None, "b = 1")]


def _assert_same(mode, got, want, rows, q):
    metric = _metric_of(mode)
    for g, w in zip(got, want):
        for r, ((gi, gd), (wi, wd)) in enumerate(zip(g, w)):
            assert len(set(gi.tolist())) == len(gi) == len(wi)
            _same_ids(metric, gi, wi, rows, q[r : r + 1])
            assert _close(metric, gd, wd).all(), (mode, r, gd, wd)


@pytest.mark.parametrize("mode", MODES)
def test_index_opens_across_packages(tmp_path, mode):
    """Each package opens the other's index files and answers as it does;
    then (COMMITTED) rows added to the JAX package's index and committed
    (on_commit) give the same answers in both."""
    x, q = _data(_kind(_metric_of(mode)))
    n = len(x)
    extra = (x[:60] + (0.01 if mode.startswith("HNSW") else 0.0)).astype(np.float32)
    if mode == "HNSW-HAVERSINE":
        extra = x[:60] + np.float32(0.5)
    _build(lynsedb_tpu, tmp_path / "j", mode, x)
    _build(lynsedb_tpu_torch, tmp_path / "t", mode, x)
    for src, dst in (("j", "jt"), ("t", "tj")):
        shutil.copytree(tmp_path / src, tmp_path / dst)
    pairs = [(_open(lynsedb_tpu, tmp_path / "j"), _open(lynsedb_tpu_torch, tmp_path / "jt")),
             (_open(lynsedb_tpu, tmp_path / "tj"), _open(lynsedb_tpu_torch, tmp_path / "t"))]
    try:
        for (_, jcoll), (_, tcoll) in pairs:
            assert tcoll._engine._index.kind == jcoll._engine._index.kind
            _assert_same(mode, _answers(tcoll, q, mode), _answers(jcoll, q, mode), x, q)
        if mode not in COMMITTED:
            return
        (_, jcoll), (_, tcoll) = pairs[0]
        for c in (jcoll, tcoll):  # the commit links or posts the new rows
            c.add(vectors=extra, fields=_fields(n, len(extra)))
            c.commit()
        assert tcoll._engine._index.built_rows == jcoll._engine._index.built_rows == n + 60
        if mode.startswith("IVF"):
            np.testing.assert_array_equal(tcoll._engine._index.postings,
                                          jcoll._engine._index.postings)
        _assert_same(mode, _answers(tcoll, q, mode), _answers(jcoll, q, mode),
                     np.concatenate([x, extra]), q)
    finally:
        for pair in pairs:
            for client, _ in pair:
                client.close()


@pytest.mark.parametrize("mode", MODES)
def test_recall_floor(tmp_path, mode):
    """The port's own build: recall@10 against a float64 brute force (ties
    within the tolerance counted), unfiltered and under the half filter, no
    repeated or filtered-out id, every distance its row's."""
    metric = _metric_of(mode)
    x, q = _data(_kind(metric))
    _build(lynsedb_tpu_torch, tmp_path / "t", mode, x)
    client, coll = _open(lynsedb_tpu_torch, tmp_path / "t")
    floor = 0.90 if mode.startswith("HNSW") else 0.85
    try:
        d64 = _d64(metric, q, x)
        for (where, views), allowed in zip(
                zip((None, "b = 1"), _answers(coll, q, mode)),
                (np.ones(len(x), bool), np.arange(len(x)) % 2 == 1)):
            d = np.where(allowed[None, :], d64, np.inf)
            kth = np.sort(d, axis=1)[:, K - 1]
            hits = 0
            for r, (ids, dist) in enumerate(views):
                assert len(ids) == K and len(set(ids.tolist())) == K and allowed[ids].all()
                assert _close(metric, dist, d[r, ids]).all()
                hits += int(((d[r, ids] <= kth[r]) | _close(metric, d[r, ids], kth[r])).sum())
            assert hits / (K * len(q)) >= floor, (mode, where, hits)
    finally:
        client.close()


# ── binary IVF recall: the reference's probe, in both packages ───────────
# (the same index answers the same in both, test_index_opens_across_packages;
# each package's own build differs by its k-means start, so the script below
# reports the recall of both instead of holding one to the other)


def binary_ivf_recall(pkg, root, mode: str, *, scaffolds: int, n: int, clusters: int,
                      nprobes, bits: int = 1024, seed: int = 0) -> list:
    """recall@10 of ``pkg``'s IVF-HAMMING or IVF-JACCARD at each nprobe, on
    ``n`` seeded scaffold fingerprints (``scaffolds`` prototypes at 10%
    density, 2% of the bits flipped) and 100 queries of the same families,
    against the exact distances of the bits (a row tying the 10th counts)."""
    rng = np.random.default_rng(seed)
    protos = rng.random((scaffolds, bits)) < 0.1
    rows = protos[rng.integers(0, scaffolds, n + 100)] ^ (rng.random((n + 100, bits)) < 0.02)
    x, q = rows[:n], rows[n:]
    inter = q.astype(np.float64) @ x.T.astype(np.float64)
    cq, cx = q.sum(1)[:, None], x.sum(1)[None]
    d = cq + cx - 2 * inter if mode == "IVF-HAMMING" else 1 - inter / (cq + cx - inter)
    kth = np.sort(d, axis=1)[:, K - 1]
    client = _client(pkg, root)
    try:
        coll = client.create_database("d").require_collection("c", dim=bits)
        coll.add(vectors=x.astype(np.float32))
        coll.commit()
        coll.build_index(mode, n_clusters=clusters)
        out = []
        for nprobe in nprobes:
            res = coll.batch_search(q.astype(np.float32), k=K, nprobe=nprobe)
            hits = sum(int((d[i, np.asarray(r.ids)] <= kth[i] + 1e-6).sum())
                       for i, r in enumerate(res))
            out.append(hits / (K * len(q)))
        return out
    finally:
        client.close()


if __name__ == "__main__":
    # python tests/test_torch_index_metrics.py: both packages' binary IVF
    # recall on 20,000 x 1,024 fingerprints of 200 scaffolds, 100 clusters
    # (the card's rows-per-cluster and nprobe share, at a CPU's size)
    import tempfile
    from pathlib import Path

    torch.set_num_threads(4)
    for pkg in (lynsedb_tpu_torch, lynsedb_tpu):
        for mode in ("IVF-HAMMING", "IVF-JACCARD"):
            with tempfile.TemporaryDirectory() as tmp:
                r = binary_ivf_recall(pkg, Path(tmp), mode, scaffolds=200, n=20_000,
                                      clusters=100, nprobes=(3, 10))
            print(f"{pkg.__name__} {mode}: recall@10 {r[0]:.3f} at nprobe 3, {r[1]:.3f} at 10")

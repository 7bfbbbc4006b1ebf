"""The port's graph operations (on the CPU: the kernels' plain versions)
against lynsedb_tpu.ops.graph, on the same seeded inputs.

Held:
  * entry_sample_ids, robust_prune_batch, _reverse_candidates,
    _mask_dup_cands: equal (host code, copied);
  * _robust_prune_dev on the same point and pair keys (ties and -inf
    included): equal ids;
  * candidate_pair_keys: rtol 1e-5, atol 1e-4 (f32 sums in another order);
  * knn_candidates, exact_knn_graph, the chunk prune: equal ids, except a
    swap between rows whose float64 keys agree within 1e-5 relative;
  * build_vamana: equal adjacency, row for row (L2 and cosine, on data
    without near-ties);
  * beam_search in the f32, bf16, SQ8 and PQ tiers, expand 1 and 2, over the
    JAX package's graph: the same pool ids and visit counts; keys rtol 1e-5
    (f32, SQ8, PQ) or 1e-3 (bf16);
  * entry_scan: equal ids;
  * the in-place updates (insert, delete repair): equal adjacency.

The walks start from nodes other than 0: the JAX package's initial visited
scatter writes False for the pool's empty slots at node 0 (ROADMAP §C), which
the port does not copy.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops import graph as JG
from lynsedb_tpu.ops.quantize import SQ8 as JSQ8
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import graph as G
from test_torch_scan import one_torch_thread  # noqa: F401 (pytestmark's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
N, DIM = 1500, 24
METRICS = ["L2", "IP", "COSINE"]


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=(n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys64(q, x, ids, metric):
    """float64 oriented keys of rows ``ids`` (B, L) for queries q (B, D)."""
    rows = x[np.maximum(ids, 0)].astype(np.float64)
    q64 = q.astype(np.float64)[:, None, :]
    ip = (rows * q64).sum(-1)
    if metric == "IP":
        return ip
    if metric == "L2":
        return -((rows - q64) ** 2).sum(-1)
    return ip / np.sqrt((q64 * q64).sum(-1) * (rows * rows).sum(-1))


def _assert_ids_near(got, want, q, x, metric, rtol=1e-5):
    """ids equal, except where the two rows' float64 keys agree within rtol."""
    assert got.shape == want.shape
    bad = got != want
    if bad.any():
        kg, kw = _keys64(q, x, got, metric), _keys64(q, x, want, metric)
        tol = rtol * np.abs(kw).max(axis=1, keepdims=True) + 1e-6
        assert (np.abs(kg - kw)[bad] <= np.broadcast_to(tol, kg.shape)[bad]).all()


# ── host helpers copied as they are ──────────────────────────────────────


@pytest.mark.parametrize("n,sample,top", [(50_000, 16_384, 4_096), (1000, 16_384, 0),
                                          (17_000, 16_384, 4_096), (3000, 512, 64)])
def test_entry_sample_ids_equal(n, sample, top):
    sq = np.random.default_rng(n).normal(size=n).astype(np.float32) ** 2
    kw = {"sq_norms": sq, "norm_top": top} if top else {}
    np.testing.assert_array_equal(G.entry_sample_ids(n, sample, **kw),
                                  JG.entry_sample_ids(n, sample, **kw))


@pytest.mark.parametrize("descending", [False, True])
def test_robust_prune_batch_equal(descending):
    rng = np.random.default_rng(1)
    bs, l, r = 64, 40, 12
    point = np.round(rng.normal(size=(bs, l)), 1).astype(np.float32)  # ties
    point[rng.random((bs, l)) < 0.1] = -np.inf
    pair = rng.normal(size=(bs, l, l)).astype(np.float32)
    cands = rng.integers(-1, 500, size=(bs, l))
    np.testing.assert_array_equal(
        G.robust_prune_batch(point, pair, cands, 1.2, r, descending),
        JG.robust_prune_batch(point, pair, cands, 1.2, r, descending))


def test_reverse_candidates_and_dup_mask_equal():
    rng = np.random.default_rng(2)
    fwd = rng.integers(-1, 300, size=(300, 10)).astype(np.int32)
    np.testing.assert_array_equal(G._reverse_candidates(fwd, 300, 10),
                                  JG._reverse_candidates(fwd, 300, 10))
    a, b = fwd.copy(), fwd.copy()
    G._mask_dup_cands(a)
    JG._mask_dup_cands(b)
    np.testing.assert_array_equal(a, b)


# ── K20: the robust prune ────────────────────────────────────────────────


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 1.2, 2.0])
def test_robust_prune_dev_same_keys(descending, alpha):
    rng = np.random.default_rng(3)
    bs, l, r = 128, 48, 16
    point = np.round(rng.normal(size=(bs, l)), 1).astype(np.float32)
    point[rng.random((bs, l)) < 0.1] = -np.inf
    pair = np.round(rng.normal(size=(bs, l, l)), 2).astype(np.float32)
    cands = rng.integers(-1, 1000, size=(bs, l)).astype(np.int32)
    want = JG._robust_prune_dev(jnp.asarray(point), jnp.asarray(pair), jnp.asarray(cands),
                                jnp.float32(alpha), r=r, descending=descending)
    got = G._robust_prune_dev_plain(_t(point), _t(pair), _t(cands).long(), alpha, r, descending)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("metric", METRICS)
def test_candidate_pair_keys_close(metric):
    rng, x = _data(4)
    cands = rng.integers(-1, N, size=(50, 30)).astype(np.int32)
    want = JG.candidate_pair_keys(jnp.asarray(x[np.maximum(cands, 0)]), JMetric[metric])
    got = G.candidate_pair_keys(_t(x), _t(cands), Metric[metric])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_prune_chunk_equal(metric):
    rng, x = _data(5)
    nodes = rng.choice(N, 256, replace=False).astype(np.int32)
    cands = rng.integers(0, N, size=(256, 40)).astype(np.int32)
    cands[:, 3] = nodes  # self candidates are dropped
    cands[rng.random(cands.shape) < 0.1] = -1
    desc = metric == "IP"
    want = np.asarray(JG._prune_chunk_kernel(
        jnp.asarray(x), jnp.asarray(nodes), jnp.asarray(cands), jnp.float32(1.2),
        metric=JMetric[metric], r=12, descending=desc))
    got = G.robust_prune(_t(x), _t(nodes), _t(cands), metric=Metric[metric], r=12, alpha=1.2,
                         descending=desc).numpy()
    rows_equal = (got == want).all(axis=1)
    assert rows_equal.mean() >= 0.99  # a prune decision at a float near-tie may flip
    for i in np.nonzero(~rows_equal)[0]:  # such a row keeps the same prefix up to the flip
        j = int(np.argmax(got[i] != want[i]))
        assert np.array_equal(got[i, :j], want[i, :j])


# ── K19: the exact top-L scan ────────────────────────────────────────────


@pytest.mark.parametrize("l", [16, 64])
@pytest.mark.parametrize("metric", METRICS)
def test_knn_candidates_equal(metric, l):
    _, x = _data(6)
    want = JG.knn_candidates(jnp.asarray(x), JMetric[metric], l=l, chunk=512, block=1024)
    got = G.knn_candidates(_t(x), Metric[metric], l=l, chunk=512)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "COSINE" else x
    _assert_ids_near(got, want, xn, xn, "IP" if metric == "COSINE" else metric)
    assert not (got == np.arange(N)[:, None]).any()


@pytest.mark.parametrize("r", [5, 16])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_knn_graph_equal(metric, r):
    _, x = _data(7, n=700)
    want = JG.exact_knn_graph(jnp.asarray(x), JMetric[metric], r, block=256)
    got = G.exact_knn_graph(_t(x), Metric[metric], r, chunk=256)
    _assert_ids_near(got, want, x, x, metric)


# ── the Vamana build ─────────────────────────────────────────────────────


@pytest.mark.parametrize("metric,seed", [("L2", 0), ("COSINE", 0), ("IP", 8)])
def test_build_vamana_equal(metric, seed):
    _, x = _data(seed)
    want = JG.build_vamana(jnp.asarray(x), JMetric[metric], r=12, l_build=32)
    got = G.build_vamana(_t(x), Metric[metric], r=12, l_build=32)
    np.testing.assert_array_equal(got, want)


def test_build_vamana_phases_and_small_graph():
    _, x = _data(9, n=600)
    phases = {}
    G.build_vamana(_t(x), Metric.L2, r=8, l_build=16, phases=phases)
    assert set(phases) == {"knn_candidates", "prune_a", "prune_b"}
    tiny = G.build_vamana(_t(x[:6]), Metric.L2, r=8)
    np.testing.assert_array_equal(tiny, JG.build_vamana(jnp.asarray(x[:6]), JMetric.L2, r=8))


# ── K17: the beam search ─────────────────────────────────────────────────


@pytest.fixture(scope="module")
def walk_inputs():
    rng, x = _data(10)
    x = x + 0.5  # an offset: centring matters for the bf16 tier
    x[700:720] = x[20:40]  # duplicated rows: exact key ties
    graph = JG.build_vamana(jnp.asarray(x), JMetric.L2, r=12, l_build=32)
    q = (x[rng.integers(0, N, 6)] + 0.2 * rng.normal(size=(6, DIM))).astype(np.float32)
    valid = rng.random(N) >= 0.1
    return rng, x, graph, q, valid


def _same_walk(got, want, rtol):
    gk, gi, gs = (np.asarray(a) for a in got)
    wk, wi, ws = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(np.isfinite(gk), np.isfinite(wk))
    fin = np.isfinite(wk)
    np.testing.assert_allclose(gk[fin], wk[fin], rtol=rtol, atol=rtol)
    for r, c in zip(*np.nonzero(gi != wi)):  # a swap only between near-equal keys
        j = np.nonzero(wi[r] == gi[r, c])[0]
        assert len(j) and abs(wk[r, j[0]] - wk[r, c]) <= rtol * abs(wk[r, c]) + rtol


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_f32_equal(walk_inputs, metric, expand):
    _, x, graph, q, valid = walk_inputs
    for starts in (np.array([3, 17], np.int32), np.array([[5 + i, 40 + i] for i in range(6)],
                                                        np.int32)):
        want = JG.beam_search(jnp.asarray(q), jnp.asarray(x), jnp.asarray(graph),
                              jnp.asarray(starts), jnp.asarray(valid), metric=JMetric[metric],
                              beam=40, max_steps=80, k=20, expand=expand)
        got = G.beam_search(_t(q), _t(x), _t(graph), _t(starts), _t(valid),
                            metric=Metric[metric], beam=40, max_steps=80, k=20, expand=expand)
        _same_walk(got, want, 1e-5)
        assert valid[np.asarray(got[1])[np.asarray(got[1]) >= 0]].all()


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("kind", ["ip", "l2", "cos"])
def test_beam_search_bf16_equal(walk_inputs, kind, expand):
    _, x, graph, q, valid = walk_inputs
    mean = x.mean(axis=0)
    x16 = torch.from_numpy(x - mean[None, :]).to(torch.bfloat16)
    xc = x16.to(torch.float32).numpy()
    aux = (mean, xc @ mean, (xc * xc).sum(1), (x * x).sum(1))
    starts = np.array([3, 17], np.int32)
    want = JG.beam_search_bf16(jnp.asarray(q), jnp.asarray(xc, dtype=jnp.bfloat16),
                               *(jnp.asarray(a) for a in aux), jnp.asarray(graph),
                               jnp.asarray(starts), jnp.asarray(valid), metric_kind=kind,
                               beam=40, max_steps=80, expand=expand)
    got = G.beam_search_bf16(_t(q), x16, *(_t(a) for a in aux), _t(graph), _t(starts), _t(valid),
                             metric_kind=kind, beam=40, max_steps=80, expand=expand)
    _same_walk(got, want, 1e-3)


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("kind", ["ip", "l2", "cos"])
def test_beam_search_sq8_equal(walk_inputs, kind, expand):
    _, x, graph, q, valid = walk_inputs
    sq = JSQ8.fit(x)
    codes = sq.encode(x)
    row_sq = (x * x).sum(1)
    starts = np.array([3, 17], np.int32)
    args = (codes, sq.lo, sq.scale, row_sq, graph, starts, valid)
    want = JG.beam_search_sq8(jnp.asarray(q), *(jnp.asarray(a) for a in args), metric_kind=kind,
                              beam=40, max_steps=80, expand=expand)
    got = G.beam_search_sq8(_t(q), *(_t(a) for a in args), metric_kind=kind, beam=40,
                            max_steps=80, expand=expand)
    _same_walk(got, want, 1e-5)


@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("kind", ["ip", "l2", "cos"])
def test_beam_search_pq_equal(walk_inputs, kind, expand):
    rng, x, graph, q, valid = walk_inputs
    m = 6
    books = rng.normal(size=(m, 256, DIM // m)).astype(np.float32)
    codes = rng.integers(0, 256, size=(N, m)).astype(np.uint8)
    alpha = (rng.random(N) + 0.5).astype(np.float32)
    row_sq = (x * x).sum(1)
    starts = np.array([3, 17], np.int32)
    args = (codes, books, alpha, row_sq, graph, starts, valid)
    want = JG.beam_search_pq(jnp.asarray(q), *(jnp.asarray(a) for a in args), metric_kind=kind,
                             beam=40, max_steps=80, expand=expand)
    got = G.beam_search_pq(_t(q), *(_t(a) for a in args), metric_kind=kind, beam=40,
                           max_steps=80, expand=expand)
    _same_walk(got, want, 1e-5)


def test_beam_search_large_start_set(walk_inputs):
    """More starts than the pool: the pool begins as the best `beam` of them."""
    rng, x, graph, q, valid = walk_inputs
    starts = rng.choice(np.arange(1, N), 300, replace=False).astype(np.int32)
    want = JG.beam_search(jnp.asarray(q), jnp.asarray(x), jnp.asarray(graph), jnp.asarray(starts),
                          jnp.asarray(valid), metric=JMetric.L2, beam=32, max_steps=64, k=32)
    got = G.beam_search(_t(q), _t(x), _t(graph), _t(starts), _t(valid), metric=Metric.L2,
                        beam=32, max_steps=64, k=32)
    _same_walk(got, want, 1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_entry_scan_equal(walk_inputs, metric):
    rng, x, _, q, valid = walk_inputs
    ids = np.sort(rng.choice(N, 400, replace=False)).astype(np.int32)
    want = JG.entry_scan(jnp.asarray(q), jnp.asarray(x[ids]), jnp.asarray(ids), jnp.asarray(valid),
                         metric=JMetric[metric], s=16)
    from lynsedb_tpu_torch.ops import distance as D

    ct = D.corpus_transform(_t(x[ids]), Metric[metric])
    got = G.entry_scan(_t(q), ct, _t(ids), _t(valid), metric=Metric[metric], s=16)
    _assert_ids_near(got.numpy(), np.asarray(want), q, x, metric)


def test_mask_step_dups_equal():
    rng = np.random.default_rng(12)
    nbrs = rng.integers(0, 20, size=(5, 24)).astype(np.int32)
    fresh = rng.random((5, 24)) < 0.7
    want = JG._mask_step_dups(jnp.asarray(fresh), jnp.asarray(nbrs), jnp.arange(5)[:, None])
    got = G._mask_step_dups(_t(fresh), _t(nbrs).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fetches_round_trip():
    keys = torch.tensor([[1.5, -np.inf], [0.25, 2.0]], dtype=torch.float32)
    ids = torch.tensor([[7, -1], [2**30, 3]], dtype=torch.int32)
    scanned = torch.tensor([4, 9], dtype=torch.int32)
    k, i, s = G.fetch_keys_pool_scanned(keys, ids, scanned)
    np.testing.assert_array_equal(k, keys.numpy())
    np.testing.assert_array_equal(i, ids.numpy().astype(np.int64))
    assert s == 9
    i2, s2 = G.fetch_pool_scanned(ids, scanned)
    np.testing.assert_array_equal(i2, ids.numpy())
    assert s2 == 9


# ── in-place updates ─────────────────────────────────────────────────────


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_insert_points_equal(metric):
    rng, x = _data(13, n=1200)
    base = 1000
    graph = JG.build_vamana(jnp.asarray(x[:base]), JMetric[metric], r=12, l_build=32)
    live = np.ones(len(x), dtype=bool)
    live[base + 7] = False
    new_ids = np.arange(base, len(x))[live[base:]]
    starts = np.array([3, 11], np.int32)
    want = JG.insert_points(graph.copy(), new_ids, jnp.asarray(x), jnp.asarray(starts), live,
                            metric=JMetric[metric], r=12, l_build=32, alpha=1.2, batch=128)
    got = G.insert_points(graph.copy(), new_ids, _t(x), _t(starts), live,
                          metric=Metric[metric], r=12, l_build=32, alpha=1.2, batch=128)
    assert (got == want).all(axis=1).mean() >= 0.995  # a near-tie prune may flip a row
    assert (got[new_ids] >= 0).any(axis=1).all()


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_repair_deleted_edges_equal(metric):
    rng, x = _data(14, n=1200)
    graph = JG.build_vamana(jnp.asarray(x), JMetric[metric], r=12, l_build=32)
    dead = rng.random(len(x)) < 0.05
    want, got = graph.copy(), graph.copy()
    n_j = JG.repair_deleted_edges(want, dead, jnp.asarray(x), metric=JMetric[metric], r=12,
                                  alpha=1.2)
    n_t = G.repair_deleted_edges(got, dead, _t(x), metric=Metric[metric], r=12, alpha=1.2)
    assert n_j == n_t > 0
    assert (got == want).all(axis=1).mean() >= 0.995
    assert (got[dead] == -1).all()
    live_edges = got[~dead]
    assert not dead[live_edges[live_edges >= 0]].any()


def test_repair_candidates_match_the_loop():
    """The vectorised candidate lists of repair_deleted_edges equal the JAX
    package's per-node loop (live neighbours, then the deleted neighbours'
    live out-lists, first occurrence kept, the first 3r)."""
    rng = np.random.default_rng(15)
    n, r = 400, 8
    graph = rng.integers(-1, n, size=(n, r)).astype(np.int32)
    dm = rng.random(n) < 0.2
    chunk = np.nonzero(((graph >= 0) & dm[np.maximum(graph, 0)]).any(1) & ~dm)[0]
    got = G._repair_candidates(graph, dm, chunk, 3 * r)
    for row_i, node in enumerate(chunk):
        kept, stitched = [], []
        for nbr in graph[node]:
            if nbr < 0:
                continue
            if dm[nbr]:
                stitched.extend(int(v) for v in graph[nbr] if v >= 0 and not dm[v] and v != node)
            else:
                kept.append(int(nbr))
        merged = list(dict.fromkeys(kept + stitched))[: 3 * r]
        want = np.full(3 * r, -1)
        want[: len(merged)] = merged
        np.testing.assert_array_equal(got[row_i], want)


def test_domain_metric_raises_k6():
    """knn_candidates and exact_knn_graph serve a domain metric (they raised
    before K19's metric mode, K6g, was ported): under L1 the same ids as the
    JAX package's _topl_generic and _knn_block, but at a near-tie."""
    _, x = _data(16, n=100)
    got = [G.knn_candidates(_t(x), Metric.L1, l=8, chunk=64),
           G.exact_knn_graph(_t(x), Metric.L1, 8, chunk=64)]
    want = [JG.knn_candidates(jnp.asarray(x), JMetric.L1, l=8, chunk=64, block=1024),
            JG.exact_knn_graph(jnp.asarray(x), JMetric.L1, 8, block=64)]
    x64 = x.astype(np.float64)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (100, 8)
        d_g = np.abs(x64[np.maximum(g, 0)] - x64[:, None]).sum(-1)
        d_w = np.abs(x64[np.maximum(w, 0)] - x64[:, None]).sum(-1)
        assert (np.abs(d_g - d_w)[g != w] <= 1e-5 * d_w[g != w] + 1e-6).all()

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel's wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors; here both run on the same CUDA inputs at small shapes.
CUDA kernels have no interpret mode, so these tests are marked ``cuda`` and
skip without a card; ``python3 chip_smoke.py`` repeats the comparisons at the
main path's full shapes.

Tolerances: K5 (selection) exact, at any k; K1, K3 and ivf_scan_blocks
distances rtol=1e-5, atol=1e-4 (f32 sums in another order); K2 keys
|d| <= 1e-5 * |qc| * |xc| + 1e-5 (a bf16 product is exact in f32, only the
summation order differs); ids identical except between entries whose plain
keys lie within that tolerance. kmeans_assign: ids equal except where a
row's two best centroids lie within 1e-5 relative; kmeans_update: sums
rtol=1e-5, atol=1e-4, counts exact, two runs bit-identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lynsedb_tpu_torch
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import kmeans, scan, topk
from lynsedb_tpu_torch.ops.scan import DeviceCorpus

pytestmark = pytest.mark.cuda

METRICS = [Metric.IP, Metric.L2, Metric.COSINE]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tie_keys(rng, b, n):
    keys = np.round(rng.normal(size=(b, n)), 1).astype(np.float32)  # many exact ties
    keys[rng.random((b, n)) < 0.05] = -np.inf
    keys[rng.random((b, n)) < 0.01] = np.nan
    return keys


@pytest.mark.parametrize("b,n,k", [(1, 1, 1), (3, 5000, 10), (4, 20000, 256), (2, 70000, 1024),
                                   (5, 100, 100), (2, 4096, 4096 // 4), (2, 5000, 1025),
                                   (3, 70000, 1025), (2, 9000, 4096), (1, 4097, 1500),
                                   (2, 20000, 20000), (2, 3000, 3000), (70000, 16, 3)])
def test_topk_select_matches_plain(dev, b, n, k):
    keys = torch.from_numpy(_tie_keys(np.random.default_rng(n), b, n)).to(dev)
    got_k, got_i = topk.topk_select(keys, k)
    want_k, want_i = topk.topk_select_plain(keys, k)
    torch.cuda.synchronize()
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_i, want_i)


def _assert_ids_match(got_ids, want_ids, want_keys, tol):
    """ids equal, except where the plain keys of the two swapped entries lie
    within ``tol`` of each other."""
    bad = got_ids != want_ids
    for r, c in zip(*np.nonzero(bad)):
        j = np.nonzero(want_ids[r] == got_ids[r, c])[0]
        assert len(j) and abs(want_keys[r, j[0]] - want_keys[r, c]) <= tol[r], (r, c)


@pytest.mark.parametrize("metric", METRICS)
def test_flat_scores_f32_matches_plain(dev, metric):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(3000, 48)).astype(np.float32)).to(dev)
    x[7] = 0.0  # zero-norm row: cosine policy
    valid = torch.from_numpy(rng.random(3000) < 0.8).to(dev)
    qt, ct = D.query_transform(q, metric), D.corpus_transform(x, metric)
    args = (q, x, qt.get("sq"), ct.get("sq"), valid, metric)
    got, want = scan.flat_scores_f32(*args), scan.flat_scores_f32_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def test_batch_split_on_the_card(dev, monkeypatch):
    """A batch over the score budget is split into parts, each a K2 -> K5 ->
    K3 chain; the answers equal the plain versions'."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9000, 32)).astype(np.float32)
    q = rng.normal(size=(10, 32)).astype(np.float32)
    monkeypatch.setattr(scan, "SCORE_BUDGET", 3 * 9088)  # capacity 9088: parts of 3
    results = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(32, device=device)
        corpus.append(x)
        results.append(corpus.search(q, 10, Metric.IP))
    (gd, gi), (wd, wi) = results
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)


def _aux(x_np, device):
    corpus = DeviceCorpus(x_np.shape[1], device=device)
    corpus.append(x_np)
    return corpus


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_centered_scores_matches_plain(dev, metric):
    rng = np.random.default_rng(2)
    corpus = _aux(rng.normal(size=(6000, 64)).astype(np.float32) + 0.5, dev)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(17, 64)).astype(np.float32)).to(dev)
    valid = corpus.valid_mask()
    got = scan.bf16_centered_scores(q, x16, aux, valid, metric)
    want = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
    torch.cuda.synchronize()
    qc = q - aux["mean"][None, :]
    bound = 1e-5 * qc.norm(dim=1)[:, None] * x16.float().norm(dim=1)[None, :] + 1e-5
    if metric is Metric.COSINE:  # the bound is on the numerator; scale by the denominator
        bound = bound / torch.sqrt((q * q).sum(-1)[:, None] * aux["xsq_true"][None, :]).clamp_min(1e-30)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert bool(((got - want).abs()[fin] <= bound[fin]).all())


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_topk_matches_plain(dev, metric):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, 96)).astype(np.float32)
    x[100:110] = x[200]  # duplicated rows: exact ties broken by id
    x32 = torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.normal(size=(9, 96)).astype(np.float32)).to(dev)
    cand = np.stack([rng.choice(5000, 300, replace=False) for _ in range(9)]).astype(np.int32)
    cand[:, :12] = np.arange(100, 112)
    keys = rng.normal(size=(9, 300)).astype(np.float32)
    keys[:, -40:] = -np.inf  # empty shortlist slots
    args = (q, x32, torch.from_numpy(keys).to(dev), torch.from_numpy(cand).to(dev), 10, metric)
    got_d, got_i = scan.rescore_topk(*args)
    want_d, want_i = scan.rescore_topk_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    wd = want_d.cpu().numpy()
    _assert_ids_match(got_i.cpu().numpy(), want_i.cpu().numpy(), wd,
                      1e-5 * np.abs(wd).max(axis=1) + 1e-4)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [2000, 20000])
@pytest.mark.parametrize("filt,k", [("half", 10), ("four_rows", 100)])
def test_device_corpus_cuda_matches_cpu(dev, metric, n, filt, k):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    if filt == "half":
        mask = rng.random(n) < 0.5
    else:  # fewer live rows than k: empty slots come back trimmed
        mask = np.zeros(n, bool)
        mask[[1, 5, 700, n - 1]] = True
    results = []
    for device in (dev, "cpu"):
        corpus = DeviceCorpus(32, device=device)
        corpus.append(x)
        corpus.set_tombstones(np.arange(n) % 17 == 0)
        results.append(corpus.search(q, k, metric, filter_mask=mask))
    (gd, gi), (wd, wi) = results
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    _assert_ids_match(gi, wi, wd, 1e-5 * np.abs(wd).max(axis=1) + 1e-4)


def test_topk_select_ids_match_plain(dev):
    """K5 with caller ids (the large-shortlist K3 path): ties go to the
    lower id, and the ids come back."""
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(_tie_keys(rng, 3, 9000)).to(dev)
    ids = torch.from_numpy(np.stack([rng.permutation(50000)[:9000] for _ in range(3)])
                           .astype(np.int32)).to(dev)
    for k in (10, 2000):
        got, want = topk.topk_select(keys, k, ids=ids), topk.topk_select_plain(keys, k, ids)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_topk_large_shortlist_matches_plain(dev, metric):
    """C = 1,280 (search_range's default max_results) goes through K5."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20000, 64)).astype(np.float32)
    x[100:110] = x[200]
    x32 = torch.from_numpy(x).to(dev)
    q = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).to(dev)
    cand = np.stack([rng.choice(20000, 1280, replace=False) for _ in range(3)]).astype(np.int32)
    cand[:, :12] = np.arange(100, 112)
    keys = rng.normal(size=(3, 1280)).astype(np.float32)
    keys[:, -100:] = -np.inf
    args = (q, x32, torch.from_numpy(keys).to(dev), torch.from_numpy(cand).to(dev), 1000, metric)
    got_d, got_i = scan.rescore_topk(*args)
    want_d, want_i = scan.rescore_topk_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    wd = want_d.cpu().numpy()
    _assert_ids_match(got_i.cpu().numpy(), want_i.cpu().numpy(), wd,
                      1e-5 * np.abs(wd).max(axis=1) + 1e-4)


@pytest.mark.parametrize("ip", [False, True])
def test_kmeans_assign_matches_plain(dev, ip):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(5000, 48)).astype(np.float32)).to(dev)
    c = x[torch.from_numpy(rng.choice(5000, 70, replace=False)).to(dev)].clone()
    c[40] = c[3]  # equal centroids: the lower index wins
    got, want = kmeans.kmeans_assign(x, c, ip), kmeans.kmeans_assign_plain(x, c, ip)
    torch.cuda.synchronize()
    scores = kmeans._ip_scores(x, c) if ip else -kmeans._l2_scores(x, c, (c * c).sum(-1))
    top2 = scores.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    assert bool(((got == want) | near).all())
    assert not bool((got == 40).any())


def test_kmeans_update_matches_plain_and_repeats(dev):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(6000, 40)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(np.arange(6000) < 5500).to(dev)
    assign = torch.from_numpy(rng.integers(0, 50, 6000).astype(np.int32)).to(dev)
    assign[assign == 7] = 8  # an empty centroid keeps its value
    c = torch.from_numpy(rng.normal(size=(50, 40)).astype(np.float32)).to(dev)
    first = kmeans.kmeans_update(x, valid, assign, c)
    second = kmeans.kmeans_update(x, valid, assign, c)
    want = kmeans.kmeans_update_plain(x, valid, assign, c)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    torch.testing.assert_close(first[0], want[0], rtol=1e-5, atol=1e-4)
    assert torch.equal(first[1], want[1])
    torch.testing.assert_close(first[2], want[2], rtol=1e-5, atol=1e-5)
    assert torch.equal(first[2][7], c[7])
    torch.testing.assert_close(first[3], want[3], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["IVF-L2", "IVF-IP", "IVF-COS", "SPANN-L2"])
def test_ivf_index_cuda_matches_cpu(dev, tmp_path, mode):
    """An index built on the card answers as the plain versions do on the
    same index files, and its scan kernel equals the plain scan."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(9, 32)).astype(np.float32)
    kw = {"replica_count": 2} if mode.startswith("SPANN") else {}
    answers = []
    for device in (dev, "cpu"):
        client = lynsedb_tpu_torch.VectorDBClient(tmp_path, device=device)
        db = client.get_database("d") if answers else client.create_database("d")
        coll = db.require_collection("c", dim=32)
        if not answers:
            coll.add(vectors=x, fields=[{"b": i % 2} for i in range(6000)])
            coll.commit()
            coll.build_index(mode, n_clusters=24, **kw)
        answers.append([coll.batch_search(q, k=10, nprobe=p, where=w)
                        for p in (1, 6) for w in (None, "b = 0")])
        eng = coll._engine
        if device == dev:
            idx, state = eng._index, eng._index._device_state(eng)
            qd = torch.from_numpy(q).to(dev)
            top_c = ivf._top_clusters(qd, state["centroids"], idx.metric, 6)
            qsq = (qd * qd).sum(-1)
            args = (qd, qsq, top_c, state["cluster_blocks"], state["blocks"], state["block_sq"],
                    state["block_orig"], eng.corpus().valid_mask(np.arange(6000) % 3 == 0),
                    idx.metric)
            got, want = ivf.ivf_scan_blocks(*args), ivf.ivf_scan_blocks_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(torch.isfinite(got), torch.isfinite(want))
            fin = torch.isfinite(want)
            torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)
        client.close()
    for got, want in zip(*answers):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5, atol=1e-4)
            wd = np.asarray(w.distances)[None]
            _assert_ids_match(np.asarray(g.ids)[None], np.asarray(w.ids)[None], wd,
                              1e-5 * np.abs(wd).max(axis=1) + 1e-4)

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
rtol=1e-5, atol=1e-4, counts exact, two runs bit-identical. K14 rtol=1e-6
(the same additions in the same order); K12 keys rtol=1e-5, atol=1e-5 (the
integer dot is exact; the epilogue's roundings may contract differently);
K13 and K11 keys rtol=1e-5, atol=1e-4 (f32 sums in another order).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

import lynsedb_tpu_torch
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import kmeans, quantize, scan, topk
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


# ── the quantized indexes: K11-K14 ───────────────────────────────────────


@pytest.mark.parametrize("d", [8, 100, 128, 2048])
def test_fwht_rotate_matches_plain(dev, d):
    rng = np.random.default_rng(d)
    dim_pad = quantize._next_pow2(d)
    q = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(dev)
    signs = torch.from_numpy(quantize.rotation_signs(dim_pad, 7)).to(dev)
    got, want = quantize.fwht_rotate(q, signs, dim_pad), quantize.rotate(q, signs, dim_pad)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


def _code_state(kind, rng, n, d, dev):
    """Random codes and terms of an int8-coded index, as the card holds them."""
    if kind == "sq8":
        codes = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
        st = {"codes": codes, "lo": rng.normal(size=d), "scale": rng.random(d) * 0.02 + 1e-3}
    elif kind == "rabitq":
        st = {"bits": np.where(rng.random((n, d)) < 0.5, 1, -1).astype(np.int8),
              "alpha": rng.random(n) + 0.1}
    else:
        st = {"codes": rng.integers(0, 16, size=(n, d)).astype(np.int8),
              "lo": -rng.random(n), "scale": rng.random(n) * 0.1 + 1e-3}
    st["row_sq"] = rng.random(n) * 50 + 1.0
    st["row_sq"][3] = 0.0  # a zero-norm row: cosine's 1.0 policy
    return {k: torch.from_numpy(quantize.pad_codes(v) if v.dtype == np.int8 else
                                v.astype(np.float32)).to(dev) for k, v in st.items()}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["sq8", "rabitq", "polarvec"])
def test_int8_code_scores_matches_plain(dev, kind, metric):
    rng = np.random.default_rng(11)
    n, d = 5000, 100 if kind == "sq8" else 128
    st = _code_state(kind, rng, n, d, dev)
    valid = torch.from_numpy(rng.random(n + 64) < 0.8).to(dev)
    for b in (1, 3, 16, 70):
        q = torch.from_numpy(rng.normal(size=(b, 100)).astype(np.float32)).to(dev)
        if b > 1:
            q[0] = 0.0  # a zero query: scale 1, every code 0
        q_rot = None
        if kind != "sq8":
            signs = torch.from_numpy(quantize.rotation_signs(128, 3)).to(dev)
            q_rot = quantize.rotate(q, signs, 128)
        got = quantize.int8_code_scores(kind, q, q_rot, st, valid, metric)
        want = quantize.int8_code_scores_plain(kind, q, q_rot, st, valid, metric)
        torch.cuda.synchronize()
        assert got.shape == (b, n)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m,ds", [(16, 8), (12, 4), (64, 2), (240, 1)])
def test_pq_adc_scores_matches_plain(dev, metric, m, ds):
    """M=16 (16-byte code loads), 12 (byte loads), 64 (a 64 KB table: opt-in
    shared memory) and 240 (a 240 KB table: built in two groups)."""
    rng = np.random.default_rng(m)
    n = 9000
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, m)).astype(np.uint8)).to(dev)
    books = torch.from_numpy(rng.normal(size=(m, 256, ds)).astype(np.float32)).to(dev)
    row_sq = torch.from_numpy((rng.random(n) * 10).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for b in (1, 7):
        q = torch.from_numpy(rng.normal(size=(b, m * ds)).astype(np.float32)).to(dev)
        got = quantize.pq_adc_scores(q, codes, books, row_sq, valid, metric)
        want = quantize.pq_adc_scores_plain(q, codes, books, row_sq, valid, metric)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [100, 128])
def test_bf16_gather_scores_matches_plain(dev, metric, d):
    """Per-query lists with empty slots (a -1 id, a -inf slot key) and one
    list shared by every query (stride 0); D=128 reads 16 bytes a lane, D=100
    one bf16 at a time."""
    rng = np.random.default_rng(d)
    corpus = _aux(rng.normal(size=(7000, d)).astype(np.float32) + 0.5, dev)
    aux, x16 = corpus.bf16_aux(), corpus._dev16
    q = torch.from_numpy(rng.normal(size=(6, d)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 7000, size=(6, 300)).astype(np.int32)).to(dev)
    idx[:, :4] = -1
    slot_keys = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32)).to(dev)
    slot_keys[:, -7:] = float("-inf")
    for ids, sk in ((idx, slot_keys), (idx[:1].contiguous(), None)):
        got = scan.bf16_gather_scores(q, x16, aux, ids, sk, metric)
        want = scan.bf16_gather_scores_plain(q, x16, aux, ids, sk, metric)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["FLAT-IP-SQ8", "FLAT-L2-SQ8", "FLAT-IP-PQ", "FLAT-IP-RABITQ",
                                  "FLAT-COS-POLARVEC"])
def test_quantized_index_cuda_matches_cpu(dev, tmp_path, mode):
    """An index built on the card answers as the plain versions do on the
    same index files, through the device route and, with rows past the
    encode, the host route."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6000, 64)).astype(np.float32)
    extra = rng.normal(size=(200, 64)).astype(np.float32)
    q = rng.normal(size=(9, 64)).astype(np.float32)
    client = lynsedb_tpu_torch.VectorDBClient(tmp_path / "card", device=dev)
    coll = client.create_database("d").require_collection("c", dim=64)
    coll.add(vectors=x, fields=[{"b": i % 2} for i in range(6000)])
    coll.commit()
    coll.build_index(mode)
    client.close()
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    answers = []
    for device, root in ((dev, tmp_path / "card"), ("cpu", tmp_path / "cpu")):
        client = lynsedb_tpu_torch.VectorDBClient(root, device=device)
        coll = client.get_database("d").get_collection("c")
        got = [coll.batch_search(q, k=k, where=w) for k in (10, 100) for w in (None, "b = 0")]
        coll.add(vectors=extra, fields=[{"b": 0}] * 200)  # uncommitted: the host route
        got += [coll.batch_search(q, k=10, where=w) for w in (None, "b = 0")]
        answers.append(got)
        client.close()
    for got, want in zip(*answers):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5, atol=1e-4)
            wd = np.asarray(w.distances)[None]
            _assert_ids_match(np.asarray(g.ids)[None], np.asarray(w.ids)[None], wd,
                              1e-5 * np.abs(wd).max(axis=1) + 1e-4)

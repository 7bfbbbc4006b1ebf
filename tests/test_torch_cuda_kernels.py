"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel's wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors; here both run on the same CUDA inputs at small shapes.
CUDA kernels have no interpret mode, so these tests are marked ``cuda`` and
skip without a card; ``python3 chip_smoke.py`` repeats the comparisons at the
main path's full shapes.

Tolerances: K5 (selection) exact; K1 and K3 distances rtol=1e-5, atol=1e-4
(f32 sums in another order); K2 keys |d| <= 1e-5 * |qc| * |xc| + 1e-5 (a bf16
product is exact in f32, only the summation order differs); ids identical
except between entries whose plain keys lie within that tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import scan, topk
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
                                   (5, 100, 100), (2, 4096, 4096 // 4)])
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

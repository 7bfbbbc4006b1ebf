"""K19's plan (``graph.topl_scan``, csrc/topl_scan.cu), on the CPU.

A plain Python model of the kernel's two-level selection: the corpus cut
into the plan's spans (a whole number of 128-row tiles each); in each span
a query's keys are offered a tile of 128 rows at a time to its list, whose
threshold stays fixed for the tile: every entry better than the L-th best
kept so far (from a start of (-inf, INT_MAX), so -inf entries are kept in id
order) joins the pending entries (at most 192), which are merged into the
kept ones after a tile that leaves more than 64 and at the span's end; each
span writes its best L, padded with (-inf, INT_MAX); K5's ids merge (the
model of ``test_torch_topc``) then takes the best L of the spans' lists.
Held:

  * bit for bit against ``topl_scan_plain`` on the same keys
    (``topl_keys_plain``): L of 1, 64 and 256, spans shorter than L, an
    ``n_real`` that cuts a span, a chunk of one query, exact ties, and a
    domain metric's invalid rows (every key -inf: the rows in id order);
  * against the JAX package's ``_topl_scan`` and ``_topl_generic`` (run on
    the CPU) on the same inputs: keys within rtol 1e-5 + atol 1e-4 of each
    other where the JAX key is finite (JAX's carried merge starts from
    (-inf, -1) slots, so an invalid row keeps -1 there: ROADMAP C), and ids
    the same but where the float64 keys of the two rows agree within 1e-5
    of the row's largest key + 1e-4 (a near-tie summed in another order);
  * the plan at the main path's shapes: one wave of the blocks the card
    holds, spans a whole number of tiles that cover the corpus.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops import graph as JG
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import graph as G
from test_torch_topc import INT_MAX, _k5_model, _span_select

TM, PEND = 128, 192  # the tile's rows (FmaTile::TM), a list's pending entries (kPend)
D = 16


def _topl_plan(b: int, n: int, per_sm: int = 2, sms: int = 132) -> tuple[int, int, int]:
    """topl_scan.cu plan_for on a card that holds ``per_sm`` blocks an SM:
    (queries a block, spans, span rows)."""
    tn = 64
    groups = -(-b // tn)
    tiles = -(-n // TM)
    spans = max(1, min(tiles, per_sm * sms // groups))
    rows = -(-tiles // spans) * TM
    return tn, -(-n // rows), rows


def _topl_model(keys: np.ndarray, l: int, span_rows: int):
    """K19's selection over the (B, N) keys (NaN and masked rows already
    -inf): each span's list, then K5's ids merge of the spans' lists."""
    b, n = keys.shape
    lists_k, lists_i = [], []
    for r in range(b):
        parts = [_span_select(keys[r, s0 : s0 + span_rows], np.arange(s0, min(n, s0 + span_rows)),
                              l, (-np.inf, INT_MAX), rnd=TM, pend_cap=PEND)
                 for s0 in range(0, n, span_rows)]
        lists_k.append(np.concatenate([p[0] for p in parts]))
        lists_i.append(np.concatenate([p[1] for p in parts]))
    return _k5_model(np.stack(lists_k), l, ids=np.stack(lists_i))


def _rows(seed: int, n: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    x[100:110] = x[5]  # exact ties: the lower id first
    x[n // 2 : n // 2 + 50] = x[:50]
    return x


def _plain_args(x, lo, hi, n_real, l, mode):
    xt = torch.from_numpy(x)
    sq = (xt * xt).sum(-1)
    q_ids = torch.arange(lo, hi, dtype=torch.int32)
    return (xt[lo:hi], q_ids, xt, sq[lo:hi], sq, n_real, l, mode)


def _assert_model_is_plain(args, l, span_rows):
    """The model over topl_keys_plain's keys equals topl_scan_plain bit for
    bit. Returns the model's (keys, ids)."""
    q, q_ids, x, qsq, xsq, n_real, _, mode = args
    keys = G.topl_keys_plain(q, q_ids, x, qsq, xsq, n_real, mode, 0, len(x)).numpy()
    got_k, got_i = _topl_model(keys, l, span_rows)
    want_k, want_i = G.topl_scan_plain(*args)
    np.testing.assert_array_equal(got_k.view(np.uint32), want_k.numpy().view(np.uint32))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    return got_k, got_i


def _jax_padded(x: np.ndarray, block: int) -> np.ndarray:
    pad = -len(x) % block
    return np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])


def _assert_near_jax(got_k, got_i, jk, ji, keys64):
    """Keys within rtol 1e-5 + atol 1e-4 where JAX's is finite; ids the same
    but between rows whose float64 keys (``keys64(ids)``) agree within 1e-5
    of the row's largest key + 1e-4."""
    jk, ji = np.asarray(jk), np.asarray(ji)
    fin = np.isfinite(jk)
    np.testing.assert_allclose(got_k[fin], jk[fin], rtol=1e-5, atol=1e-4)
    g64, j64 = keys64(np.where(fin, got_i, 0)), keys64(np.where(fin, ji, 0))
    tol = 1e-5 * np.abs(np.where(fin, j64, 0)).max(axis=1, keepdims=True) + 1e-4
    assert (np.abs(g64 - j64)[fin] <= np.broadcast_to(tol, fin.shape)[fin]).all()


# (b, n, l, span rows or None for the kernel's plan, n_real): L = 1, 64, 256;
# spans of 128 rows at L = 256 (shorter than L); n_real inside a span; one
# query; two query groups over explicit spans
_CASES = [(5, 3000, 1, None, 2993), (5, 3000, 64, None, 2993), (5, 3000, 256, None, 2993),
          (1, 3000, 64, None, 1505), (1, 3000, 256, None, 1505), (70, 5000, 64, 640, 4000),
          (37, 2000, 256, 1024, 1999)]


@pytest.mark.parametrize("mode", [G.TOPL_L2_RAW, G.TOPL_DOT])
@pytest.mark.parametrize("b,n,l,span,n_real", _CASES)
def test_topl_model_equals_plain_and_jax(b, n, l, span, n_real, mode):
    """The model equals topl_scan_plain bit for bit and the JAX package's
    _topl_scan up to near-ties, under L2 (K19's mode 0) and the dot product
    (mode 1)."""
    x = _rows(n + l, n)
    span = _topl_plan(b, n)[2] if span is None else span
    lo = n // 3
    args = _plain_args(x, lo, lo + b, n_real, l, mode)
    got_k, got_i = _assert_model_is_plain(args, l, span)
    q = x[lo : lo + b].astype(np.float64)
    block = 512
    jk, ji = JG._topl_scan(jnp.asarray(x[lo : lo + b]), jnp.arange(lo, lo + b, dtype=jnp.int32),
                           jnp.asarray(_jax_padded(x, block)), n_real,
                           metric_id=0 if mode == G.TOPL_L2_RAW else 1, l=l, block=block)

    def keys64(ids):
        rows = x[ids].astype(np.float64)
        ip = (rows * q[:, None, :]).sum(-1)
        if mode == G.TOPL_DOT:
            return ip
        return -((q * q).sum(-1)[:, None] + (rows * rows).sum(-1) - 2 * ip)

    _assert_near_jax(got_k, got_i, jk, ji, keys64)
    assert not (got_i == np.arange(lo, lo + b)[:, None]).any()  # self-matches masked
    assert (got_i < n_real).all()


@pytest.mark.parametrize("metric", [Metric.HELLINGER, Metric.L1])
@pytest.mark.parametrize("l", [1, 64, 256])
def test_topl_model_metric_mode(metric, l):
    """The metric mode: the model over the plain keys of the transform
    equals topl_scan_plain bit for bit, and the JAX package's _topl_generic
    on the raw rows up to near-ties. Hellinger's rows 0-2 are invalid (a
    negative entry): their lists are every row at -inf in id order."""
    n, b = 3000, 9
    x = np.exp(np.random.default_rng(l).normal(size=(n, D))).astype(np.float32)
    x[:3, 0] = -1.0
    x[200:210] = x[7]
    space = G.graph_space(torch.from_numpy(x), metric)
    q_ids = torch.arange(b, dtype=torch.int32)
    args = (space[:b], q_ids, space, None, None, n - 5, l, G.TOPL_METRIC)
    got_k, got_i = _assert_model_is_plain(args, l, _topl_plan(b, n)[2])
    if metric is Metric.HELLINGER:
        assert np.isneginf(got_k[:3]).all()
        np.testing.assert_array_equal(got_i[:3], np.broadcast_to(np.arange(l), (3, l)))
    block = 512
    jk, ji = JG._topl_generic(jnp.asarray(x[:b]), jnp.arange(b, dtype=jnp.int32),
                              jnp.asarray(_jax_padded(x, block)), n - 5,
                              metric=JMetric(metric.value), l=l, block=block)
    x64 = x.astype(np.float64)

    def keys64(ids):
        rows, q = x64[ids], x64[:b, None, :]
        if metric is Metric.L1:
            return -np.abs(rows - q).sum(-1)
        bc = (np.sqrt(np.maximum(rows, 0) * np.maximum(q, 0))).sum(-1)
        mass = np.sqrt(rows.sum(-1) * q.sum(-1))
        return -np.sqrt(np.maximum(1 - bc / mass, 0))

    _assert_near_jax(got_k, got_i, jk, ji, keys64)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("b,n", [(4096, 1_000_000), (1024, 1_010_000), (4096, 62_500),
                                 (1, 1_000_000), (37, 100_000), (1, 1_000)])
def test_topl_plan_is_one_wave(b, n, per_sm):
    """The plan at the builds' shapes (the HNSW-L2 and -L1 chunks, an upper
    layer's, a chunk of one query, a corpus of a few tiles): one wave of the
    blocks the card holds, spans a whole number of 128-row tiles that cover
    the corpus, and no more spans than tiles."""
    tn, spans, rows = _topl_plan(b, n, per_sm)
    groups = -(-b // tn)
    assert rows % TM == 0 and spans * rows >= n > (spans - 1) * rows
    assert groups * spans <= max(groups, per_sm * 132)
    assert spans <= -(-n // TM)

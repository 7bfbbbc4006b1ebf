"""The property K20's pair table rests on, and K20's plain version against
the JAX package, on the CPU.

K20 (csrc/robust_prune.cu) fills only the upper triangle of each node's
(M, M) table and mirrors it. That is exact only if the plain table
(ops/graph.py _table_seq) is symmetric to the bit: each entry is a chain over
the dimensions of one commutative, separately rounded step of the two rows'
values (a product for the Gram, |u - v| for L1, Chebyshev and Wasserstein,
u + v before Jensen-Shannon's m log m). Held here over rows with duplicates,
zeros, subnormals and infinities, at the table sizes the callers use (M = 64
and 65: an insert's keys; 73: the build's pass A; 97: a delete repair). NaN
entries (inf - inf, inf * 0) are compared as NaN, whatever their payload.

At the same M, the port's plain K20 (prune and keys modes) is held to the JAX
package's _prune_chunk_kernel, candidate_pair_keys and point keys with
tests/test_torch_graph.py's tolerance: keys rtol 1e-5, atol 1e-4 (f32 sums
in another order); at least 99% of the pruned rows equal, the rest equal up
to the first flip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops import graph as JG
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import graph as G
from test_torch_scan import one_torch_thread  # noqa: F401 (pytestmark's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TABLE_M = [64, 65, 73, 97]
# the table each metric fills: the Gram over raw rows (IP, L2, cosine) or
# over correlation's and Hellinger's lead rows; the elementwise metrics over
# their transforms
TABLE_METRICS = [Metric.L2, Metric.CORRELATION, Metric.HELLINGER, Metric.L1, Metric.CHEBYSHEV,
                 Metric.WASSERSTEIN, Metric.JENSEN_SHANNON]


def _corner_rows(rng, m: int, d: int) -> np.ndarray:
    """(m, d) rows: gaussian, with duplicates, a zero row, subnormal and
    infinite entries and non-negative histograms' zeros."""
    x = rng.normal(size=(m, d)).astype(np.float32)
    x[1] = x[0]  # duplicated rows
    x[2] = 0.0
    x[3, : d // 2] = np.float32(1e-40)  # subnormals
    x[4, :3] = np.float32(-3e-39)
    x[5, 0], x[6, 1], x[6, 2] = np.inf, -np.inf, np.inf
    x[7, ::2] = 0.0
    x[m - 1] = x[5]  # an infinite row twice
    return x


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("m", TABLE_M)
@pytest.mark.parametrize("metric", TABLE_METRICS, ids=[m.value for m in TABLE_METRICS])
def test_table_seq_symmetric_to_the_bit(metric, m):
    rng = np.random.default_rng(m)
    bs, d = 3, 24
    x = np.concatenate([_corner_rows(rng, m, d) for _ in range(bs)])
    space = G.graph_space(torch.from_numpy(x), metric)
    rows = (space.rows if isinstance(space, G.MetricRows) else space).reshape(bs, m, -1)
    g = G._table_seq(rows, metric)
    assert g.shape == (bs, m, m)
    assert _same_bits(g, g.transpose(1, 2))
    assert bool(torch.isfinite(g).any())


def _prune_inputs(seed: int, l: int, bs: int = 48, n: int = 1200, d: int = 24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n // 2 : n // 2 + 20] = x[:20]  # duplicated rows
    nodes = rng.choice(n, bs, replace=False).astype(np.int32)
    cands = rng.integers(0, n, size=(bs, l)).astype(np.int32)
    cands[:, 3] = nodes  # self candidates are dropped
    cands[rng.random(cands.shape) < 0.1] = -1
    return x, nodes, cands


@pytest.mark.parametrize("m", TABLE_M)
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_plain_prune_against_jax(metric, m):
    """M = 64 is the keys mode without node ids (L = 64); every other M has
    the node as its last row (L = M - 1): both keys modes and the prune."""
    with_node = m != 64
    l = m - 1 if with_node else m
    x, nodes, cands = _prune_inputs(m, l)
    xt, nt, ct = torch.from_numpy(x), torch.from_numpy(nodes), torch.from_numpy(cands)
    jm, tm = JMetric[metric], Metric[metric]
    safe = np.maximum(cands, 0)
    want_pair = np.asarray(JG.candidate_pair_keys(jnp.asarray(x[safe]), jm))
    point, pair = G.robust_prune(xt, nt if with_node else None, ct, metric=tm, keys_only=True)
    np.testing.assert_allclose(pair.numpy(), want_pair, rtol=1e-5, atol=1e-4)
    if not with_node:
        assert point is None
        return
    want_point = np.asarray(jax.vmap(lambda q, c: JG._keyed_pairwise(q[None], c, jm)[0])(
        jnp.asarray(x[nodes]), jnp.asarray(x[safe])))
    np.testing.assert_allclose(point.numpy(), want_point, rtol=1e-5, atol=1e-4)
    desc = metric == "IP"
    want = np.asarray(JG._prune_chunk_kernel(
        jnp.asarray(x), jnp.asarray(nodes), jnp.asarray(cands), jnp.float32(1.2), metric=jm,
        r=32, descending=desc))
    got = G.robust_prune(xt, nt, ct, metric=tm, r=32, alpha=1.2, descending=desc).numpy()
    rows_equal = (got == want).all(axis=1)
    assert rows_equal.mean() >= 0.99  # a prune decision at a float near-tie may flip
    for i in np.nonzero(~rows_equal)[0]:  # such a row keeps the same prefix up to the flip
        j = int(np.argmax(got[i] != want[i]))
        assert np.array_equal(got[i, :j], want[i, :j])

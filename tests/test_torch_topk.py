"""lynsedb_tpu_torch.ops.topk (K5's plain version on the CPU) against
lynsedb_tpu.ops.topk on the same seeded inputs.

Tolerance: none. The selections must be equal value for value and index for
index, ties included (the lower index wins), with NaN and masked rows at -inf
and k larger than N clamped to N. masked_top_c in the JAX package is
approx_max_k, exact on the CPU in its values but in no fixed order among
equal keys, so there the tied entries at the cut are compared as sets. Tie data carries no negative zeros: the JAX
selection orders -0.0 below +0.0, the port treats them as one key.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.ops import topk as jax_topk
from lynsedb_tpu_torch.ops import topk


def _scores(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = (np.round(rng.normal(size=(b, n)), 1) + 0.0).astype(np.float32)  # many exact ties
    s[rng.random((b, n)) < 0.02] = np.nan
    s[rng.random((b, n)) < 0.02] = np.inf
    s[rng.random((b, n)) < 0.02] = -np.inf
    return s


def _mask(seed: int, n: int, frac: float):
    return np.random.default_rng(seed + 1).random(n) < frac


CASES = [(1, 1, 1), (3, 50, 10), (4, 300, 64), (2, 40, 100), (5, 1000, 1)]


@pytest.mark.parametrize("fn", ["masked_top_k", "masked_top_c"])
@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("b,n,k", CASES)
@pytest.mark.parametrize("mask", [None, "rows", "matrix"])
def test_masked_selection_matches_jax(fn, ascending, b, n, k, mask):
    s = _scores(b * n + k, b, n)
    valid = None
    if mask == "rows":
        valid = _mask(n, n, 0.5)
    elif mask == "matrix":
        valid = np.random.default_rng(n).random((b, n)) < 0.5
    jd, ji = getattr(jax_topk, fn)(jnp.asarray(s), k, ascending,
                                   None if valid is None else jnp.asarray(valid))
    td, ti = getattr(topk, fn)(torch.from_numpy(s), k, ascending,
                               None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if fn == "masked_top_k":
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        return
    # approx_max_k returns the exact values, but equal keys in no fixed
    # order: every index must carry its own key, and the rows strictly above
    # the k-th key must be the same set
    keyed = np.where(np.isnan(s), -np.inf, -s if ascending else s)
    if valid is not None:
        keyed = np.where(valid, keyed, -np.inf)
    want = -td.numpy() if ascending else td.numpy()
    for idx in (ti.numpy(), np.asarray(ji)):
        np.testing.assert_array_equal(np.take_along_axis(keyed, idx.astype(np.int64), 1), want)
    for r in range(b):
        above = want[r] > want[r, -1]
        assert set(ti.numpy()[r][above]) == set(np.asarray(ji)[r][above])


@pytest.mark.parametrize("ascending", [False, True])
@pytest.mark.parametrize("b,m,k", [(2, 30, 10), (3, 64, 64), (1, 5, 9)])
def test_merge_top_k_matches_jax(ascending, b, m, k):
    d = _scores(m, b, m)
    ids = np.random.default_rng(k).permutation(10 * m)[: b * m].reshape(b, m).astype(np.int32)
    jd, ji = jax_topk.merge_top_k(jnp.asarray(d), jnp.asarray(ids), k, ascending)
    td, ti = topk.merge_top_k(torch.from_numpy(d), torch.from_numpy(ids), k, ascending)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_select_plain_order_and_bounds():
    keys = torch.tensor([[1.0, float("nan"), 3.0, 3.0, float("-inf"), 1.0]])
    vals, idx = topk.topk_select(keys, 6)
    assert idx.tolist() == [[2, 3, 0, 5, 1, 4]]
    assert idx.dtype == torch.int32
    assert vals[0, :4].tolist() == [3.0, 3.0, 1.0, 1.0]
    with pytest.raises(ValueError):
        topk.topk_select(keys, 7)


def test_topk_select_plain_with_ids():
    """With ``ids`` the ids break ties and come back in place of columns."""
    keys = torch.tensor([[1.0, 3.0, 3.0, float("nan"), 1.0, 2.0]])
    ids = torch.tensor([[50, 9, 4, 1, 7, 30]], dtype=torch.int32)
    vals, out = topk.topk_select(keys, 5, ids=ids)
    assert out.tolist() == [[4, 9, 30, 7, 50]]
    assert vals.tolist() == [[3.0, 3.0, 2.0, 1.0, 1.0]]
    with pytest.raises(ValueError):
        topk.topk_select(keys, 2, ids=ids.long())

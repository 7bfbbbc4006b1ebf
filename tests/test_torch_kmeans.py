"""lynsedb_tpu_torch.ops.kmeans on the CPU (the kernels' plain versions)
against lynsedb_tpu.ops.kmeans, on the same seeded inputs.

The port seeds k-means++ with a torch.Generator, which cannot reproduce
jax.random's bits, so the Lloyd loop is compared from the JAX package's own
initial centroids. Every call passes ``max_iters`` explicitly
(LYNSE_KMEANS_EPOCHS can leak into a test worker from other tests).

Tolerances: one Lloyd step's centroids rtol=1e-5, atol=1e-6 (f32 sums taken
in another order), counts exact, the shift rtol=1e-4; assignments equal; the
full loop's centroids rtol=1e-4 (the step's rounding, carried over up to 20
steps) with assignments equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.ops import kmeans as jk
from lynsedb_tpu_torch.ops import kmeans as tk


def _clustered(seed: int, n_clusters: int = 8, per: int = 200, d: int = 16, spread: float = 0.05):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3
    data = np.concatenate([centers[i] + spread * rng.normal(size=(per, d)).astype(np.float32)
                           for i in range(n_clusters)])
    return data.astype(np.float32), np.repeat(np.arange(n_clusters), per)


def _step_inputs(seed: int):
    """4,096 rows (the last 596 padding, invalid), 12 centroids drawn from
    the rows, and a duplicated row so equal distances occur."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(4096, 16)).astype(np.float32)
    data[3500:] = 0.0
    data[10:20] = data[5]
    valid = np.arange(4096) < 3500
    cent = data[rng.choice(3500, 12, replace=False)].copy()
    return data, valid, cent


@pytest.mark.parametrize("ip", [False, True])
def test_lloyd_step_matches_jax(ip):
    data, valid, cent = _step_inputs(1)
    jc, jn, js = jk._lloyd_step(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(cent), 1024,
                                ip=ip)
    tc, tn, ts = tk._lloyd_step(torch.from_numpy(data), torch.from_numpy(valid),
                                torch.from_numpy(cent), ip=ip)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)


@pytest.mark.parametrize("ip", [False, True])
def test_kmeans_assign_matches_jax_assign_clusters(ip):
    data, _, cent = _step_inputs(2)
    cent[3] = cent[7]  # equal centroids: the lower index must win
    want = np.asarray(jk.assign_clusters(jnp.asarray(data), jnp.asarray(cent), 1024, ip=ip))
    got = tk.kmeans_assign(torch.from_numpy(data), torch.from_numpy(cent), ip)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.any(got.numpy() == 7)


def test_update_keeps_empty_centroids():
    data, valid, cent = _step_inputs(3)
    assign = torch.zeros(4096, dtype=torch.int32)  # every row to centroid 0
    sums, counts, new, moves = tk.kmeans_update(torch.from_numpy(data), torch.from_numpy(valid),
                                                assign, torch.from_numpy(cent))
    assert counts.tolist() == [3500.0] + [0.0] * 11
    np.testing.assert_allclose(new[0].numpy(), data[:3500].mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(new[1:].numpy(), cent[1:])
    assert moves[1:].abs().max() == 0 and moves[0] > 0


@pytest.mark.parametrize("ip", [False, True])
def test_lloyd_loop_from_jax_init_matches_jax(ip):
    data, _ = _clustered(4, n_clusters=10, per=300)
    k, chunk, iters, tol = 10, 1024, 20, 1e-6
    t = len(data)
    padded = np.zeros((4096, data.shape[1]), np.float32)
    padded[:t] = data
    valid = np.arange(4096) < t
    pool = data[np.random.default_rng(5).choice(t, 1024, replace=False)]
    init = np.array(jk._kmeans_pp_init(jnp.asarray(pool), k, jnp.asarray([5])))

    jc = jnp.asarray(init)
    for _ in range(iters):  # the JAX package's train_kmeans loop
        jc, _, shift = jk._lloyd_step(jnp.asarray(padded), jnp.asarray(valid), jc, chunk, ip=ip)
        if float(shift) <= tol:
            break
    tc = tk._lloyd(torch.from_numpy(padded), torch.from_numpy(valid), torch.from_numpy(init), ip,
                   iters, tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    want = np.asarray(jk.assign_clusters(jnp.asarray(padded), jc, chunk, ip=ip))[:t]
    got = tk.kmeans_assign(torch.from_numpy(data), tc, ip).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmeans_pp_init_draws_pool_rows():
    pool, _ = _clustered(6, n_clusters=4, per=50)
    cent = tk._kmeans_pp_init(torch.from_numpy(pool), 4, seed=3).numpy()
    for c in cent:
        assert np.any(np.all(pool == c, axis=1))
    # k-means++ spreads the seeds: one per well-separated cluster
    assert len({int(np.argmin(((pool - c) ** 2).sum(1))) // 50 for c in cent}) == 4


def test_train_kmeans_recovers_clusters():
    """The port's counterpart of test_kmeans_recovers_clusters."""
    data, labels = _clustered(7)
    centroids, assigns = tk.train_kmeans(data, 8, seed=7, max_iters=100, device="cpu")
    assert centroids.shape == (8, 16) and assigns.dtype == np.int32
    for c in range(8):
        cluster_assigns = assigns[labels == c]
        assert np.bincount(cluster_assigns).max() / len(cluster_assigns) > 0.95


@pytest.mark.parametrize("kw", [{}, {"assign_ip": True}, {"normalize": True}])
def test_train_kmeans_deterministic(kw):
    data, _ = _clustered(8, n_clusters=4, per=100)
    c1, a1 = tk.train_kmeans(data, 4, seed=3, max_iters=50, device="cpu", **kw)
    c2, a2 = tk.train_kmeans(data, 4, seed=3, max_iters=50, device="cpu", **kw)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(c1, c2)


def test_train_kmeans_subsamples_like_jax():
    """Above the training cap both packages train on the same numpy
    subsample and pool, and assign every row."""
    data, _ = _clustered(9, n_clusters=4, per=5000, d=8)  # 20,000 rows > 16,384
    centroids, assigns = tk.train_kmeans(data, 4, seed=1, max_iters=30, device="cpu")
    assert centroids.shape == (4, 8) and assigns.shape == (20000,)
    np.testing.assert_array_equal(
        assigns, tk.kmeans_assign(torch.from_numpy(data), torch.from_numpy(centroids), False).numpy())

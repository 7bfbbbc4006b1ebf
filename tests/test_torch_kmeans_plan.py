"""K15b's plan (``kmeans.kmeans_update``, csrc/kmeans_update.cu), on the CPU.

A PyTorch model of the kernel's four launches: the rows cut into the plan's
chunks (at most one a 2,048 rows and 2^18 histogram entries in all, each a
multiple of 32 rows); each chunk's histogram of its valid rows' centroids; the
exclusive prefix of the histograms in centroid-major order (each
(centroid, chunk)'s base offset, each centroid's list start); the scatter,
a chunk 32 rows at a time, each row's slot its rank among the earlier rows
of its centroid in the piece plus the chunk's running count; then each
centroid's sum over its list, one rounded float32 add at a time, the mean
(or the old centroid where the count is 0) and the move in the kernel's
tree (256 threads' fmaf sums over d = t, t + 256, ..., a butterfly within each
warp of 32, the eight warp sums in order). Held:

  * the model's row lists equal ``torch.argsort(assign, stable=True)`` of
    the valid rows, split by centroid (a stable counting sort);
  * its sums equal, to the bit, a float32 row-by-row loop;
  * its new centroids, counts and largest move match the JAX package's
    ``lynsedb_tpu.ops.kmeans._lloyd_step`` on the same rows and centroids
    (the assignment from ``assign_clusters``): counts exact, centroids
    rtol 1e-5 (its one-hot product adds in another order), the move rtol
    1e-4;
  * cases: invalid rows, empty clusters, N no multiple of a chunk, K = 1,
    K > N, D = 1, D = 8 and D = 600 (several dimensions a thread of the
    move tree), a centroid that holds 90% of the rows;
  * the plan at the main path's shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.ops import kmeans as jk
from lynsedb_tpu_torch.ops import kmeans as tk
from test_torch_cuda_kernels import move_tree

CHUNK_MIN, MAX_HIST = 2048, 1 << 18  # kChunkMin, kMaxHist


def _plan(n: int, k: int) -> tuple[int, int]:
    """kmeans_update.cu plan_of: (chunks, rows a chunk)."""
    chunks = max(1, min(-(-n // CHUNK_MIN), MAX_HIST // k))
    rows = -(-(-(-n // chunks)) // 32) * 32
    return -(-n // rows), rows


def _k15b_model(x: torch.Tensor, valid: torch.Tensor, assign: torch.Tensor, old: torch.Tensor):
    """The kernel's launches in PyTorch. Returns (the row lists by centroid,
    sums, counts, new centroids, moves)."""
    n, d = x.shape
    k = old.shape[0]
    chunks, rows = _plan(n, k)
    live = valid & (assign >= 0) & (assign < k)
    a64 = assign.long()
    hist = torch.zeros((k, chunks), dtype=torch.int64)  # count
    for c in range(chunks):
        sl = slice(c * rows, (c + 1) * rows)
        hist[:, c] = torch.bincount(a64[sl][live[sl]], minlength=k)
    flat = hist.reshape(-1)  # scan
    offsets = (torch.cumsum(flat, 0) - flat).reshape(k, chunks)
    starts = torch.cat([offsets[:, 0], flat.sum().reshape(1)])
    order = torch.full((int(live.sum()),), -1, dtype=torch.int64)  # scatter
    for c in range(chunks):
        run = offsets[:, c].clone()
        for base in range(c * rows, min(n, (c + 1) * rows), 32):
            r = torch.arange(base, min(base + 32, (c + 1) * rows, n))
            piece = r[live[r]]
            a = a64[piece]
            rank = torch.tril(a[:, None] == a[None, :], diagonal=-1).sum(1)
            order[run[a] + rank] = piece
            run += torch.bincount(a, minlength=k)
    assert bool((order >= 0).all())
    lists = [order[starts[c] : starts[c + 1]] for c in range(k)]
    sums = torch.zeros((k, d), dtype=torch.float32)  # sum
    for c, lst in enumerate(lists):
        acc = torch.zeros(d, dtype=torch.float32)
        for r in lst.tolist():
            acc = acc + x[r]
        sums[c] = acc
    counts = (starts[1:] - starts[:-1]).to(torch.float32)
    new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], old)
    return lists, sums, counts, new, _moves(new, old)


def _moves(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The kernel's tree of each centroid's squared move."""
    return torch.from_numpy(move_tree(new.numpy(), old.numpy()))


CASES = ["mixed", "k1", "k_over_n", "d1", "d8", "skew90", "d600"]


def _inputs(case: str):
    """(rows, valid, centroids) of a case, from a seeded numpy generator."""
    rng = np.random.default_rng(CASES.index(case))
    n, d, k = {"k1": (3000, 16, 1), "k_over_n": (50, 8, 80), "d1": (9001, 1, 30),
               "d8": (9001, 8, 256), "skew90": (9001, 16, 40), "d600": (3000, 600, 6)}.get(
        case, (9001, 24, 50))
    x = rng.normal(size=(n, d)).astype(np.float32)
    cent = x[rng.choice(n, min(k, n), replace=False)].copy()
    if k > n:
        cent = np.concatenate([cent, 50.0 + rng.normal(size=(k - n, d)).astype(np.float32)])
    if case == "mixed":
        cent[7] += 100.0  # far from every row: an empty cluster
    if case == "skew90":
        near = rng.random(n) < 0.9
        x[near] = cent[3] + 0.01 * rng.normal(size=(int(near.sum()), d)).astype(np.float32)
    valid = rng.random(n) >= 0.1
    valid[-(n // 7):] = False  # a padded tail, as train_kmeans pads
    return x, valid, cent


@pytest.mark.parametrize("case", CASES)
def test_model_lists_sums_and_jax_step(case):
    x, valid, cent = _inputs(case)
    n = x.shape[0]
    assign = np.asarray(jk.assign_clusters(jnp.asarray(x), jnp.asarray(cent))).astype(np.int32)
    xt, vt, at, ct = (torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(assign),
                      torch.from_numpy(cent))
    lists, sums, counts, new, moves = _k15b_model(xt, vt, at, ct)
    # a stable counting sort: the valid rows in argsort order, split by centroid
    rows = torch.nonzero(vt).flatten()
    order = rows[torch.argsort(at[rows], stable=True)]
    assert torch.equal(torch.cat(lists), order)
    # the sums of a float32 row-by-row loop, to the bit
    loop = torch.zeros_like(sums)
    for r in rows.tolist():
        loop[assign[r]] = loop[assign[r]] + xt[r]
    assert torch.equal(sums.view(torch.int32), loop.view(torch.int32))
    # the JAX package's Lloyd step on the same rows and centroids
    jc, jn, js = jk._lloyd_step(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(cent), n)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    np.testing.assert_allclose(new.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(moves.max()), float(js), rtol=1e-4, atol=1e-7)
    # and the port's plain version (the one-hot product the CPU wrapper runs)
    _, pc, pn, pm = tk.kmeans_update(xt, vt, at, ct)
    assert torch.equal(pc, counts)
    torch.testing.assert_close(pn, new, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pm, moves, rtol=1e-4, atol=1e-7)
    if case == "mixed":
        assert len(lists[7]) == 0 and torch.equal(new[7], ct[7])
    if case == "skew90":
        assert len(lists[3]) >= 0.85 * len(rows)


@pytest.mark.parametrize("n,k,chunks,rows", [
    (256_000, 1000, 125, 2048),  # the IVF build's Lloyd step at 1,000 clusters
    (1_000_000, 4096, 64, 15_648),  # 4,096 clusters: the histogram's cap
    (65_536, 256, 32, 2048),  # a PQ codebook's
    (9001, 50, 5, 1824), (50, 80, 1, 64), (50_000, 300_000, 1, 50_016)])
def test_plan_at_main_path_shapes(n, k, chunks, rows):
    """The chunks cover the rows, each a multiple of 32 rows, at most one a
    2,048 rows; the histogram holds at most 2^18 entries unless there is
    one chunk."""
    assert _plan(n, k) == (chunks, rows)
    assert rows % 32 == 0 and chunks * rows >= n > (chunks - 1) * rows
    assert chunks <= -(-n // CHUNK_MIN)
    assert chunks == 1 or k * chunks <= MAX_HIST

"""K17's and K15a's plans (csrc/beam_search.cu, csrc/kmeans_assign.cu), on
the CPU.

K17 (``graph.beam_walk``): a Python model of the kernel's walk for one query,
step by step as the kernel takes it: the starts in chunks (a rank sort, then
the merge), the visited set as the kernel keeps it (the shared-memory table:
cap slots from ``graph.visited_table_cap``, -1 empty, the multiplicative hash,
linear probing; or the device bitmap where the table would not fit), every
neighbour looked up before any is inserted, ``scanned`` the number of
inserts; at expand 1 and R <= 32 warp 0's step (the compacted fresh list,
and the next node chosen before the merge from the old pool and the fresh
keys, held to the merged pool's own pick) and the merge of the fresh entries
unsorted, by counts; otherwise the block-wide step (duplicate masks
across the expanded nodes, a rank sort, the merge of the sorted entries by
binary searches). Held:

  * the table's inserts and lookups against a set, over its bound of
    inserts (it never fills), and the route to the bitmap past
    ``VISITED_TABLE_MAX``;
  * the model's keys, ids and scanned equal ``beam_walk_plain``'s to the
    bit, under the table and the bitmap, expand 1 and 2, R 12 and 40,
    adjacency rows holding a node twice; and its ids and scanned equal the
    JAX package's ``_beam_core`` (through ``beam_search``; keys rtol 1e-5);
  * both merges keep the plain version's tie order on crafted equal keys (a
    pool entry before a fresh one, fresh ones by slot).

K15a (``kmeans.kmeans_assign``): the small route's |x|^2, a replay of
``lt::warp_sum``'s tree over the row's squares, equals the warp's
lane-strided fmaf sums met in that butterfly, bit for bit, at D in {1, 7,
8, 9, 32, 33}; both routes' folds (the FMA tile's split of the centroids
over 16 threads, each folding strictly in index order, then a shuffle tree
by (score, index); the small route's one sequential fold) pick the same
index as a sequential argmin on crafted ties, NaN and infinities; and the
plain version's indices equal the JAX package's ``assign_clusters`` with
duplicated centroids and NaN rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops import graph as JG
from lynsedb_tpu.ops import kmeans as jk
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import graph as G
from lynsedb_tpu_torch.ops import kmeans as tk
from test_torch_cuda_kernels import fmaf32

NEG = np.float32(-np.inf)


# ── K17's visited set ─────────────────────────────────────────────────────


class VisitedTable:
    """The kernel's shared-memory visited set (csrc/beam_search.cu Visited)."""

    def __init__(self, cap: int):
        assert cap >= 64 and cap & (cap - 1) == 0
        self.slots = np.full(cap, -1, dtype=np.int64)
        self.shift = 32 - (cap.bit_length() - 1)
        self.mask = cap - 1
        self.inserts = 0

    def _slot(self, i: int) -> int:
        return ((int(i) * 2654435761) & 0xFFFFFFFF) >> self.shift

    def contains(self, i: int) -> bool:
        h = self._slot(i)
        while True:
            v = self.slots[h]
            if v == i:
                return True
            if v < 0:
                return False
            h = (h + 1) & self.mask

    def insert(self, i: int) -> bool:
        h = self._slot(i)
        while True:
            v = self.slots[h]
            if v < 0:
                self.slots[h] = i
                self.inserts += 1
                return True
            if v == i:
                return False
            h = (h + 1) & self.mask


class VisitedBitmap:
    """The bitmap route: a bit a node; an insert counts where it sets one."""

    def __init__(self, n: int):
        self.bits = np.zeros((n + 31) // 32, dtype=np.uint32)
        self.inserts = 0

    def contains(self, i: int) -> bool:
        return bool((self.bits[i >> 5] >> np.uint32(i & 31)) & np.uint32(1))

    def insert(self, i: int) -> bool:
        if self.contains(i):
            return False
        self.bits[i >> 5] |= np.uint32(1) << np.uint32(i & 31)
        self.inserts += 1
        return True


@pytest.mark.parametrize("bound", [1, 63, 64, 65, 1000, 6500, 8125, 16383])
def test_visited_table_holds_its_bound(bound):
    """A table of visited_table_cap's slots takes ``bound`` distinct inserts
    (a full table would leave a lookup probing forever) and answers every
    lookup as a set does; a second insert of an id counts nothing."""
    cap = G.visited_table_cap(bound, bound, 0, 1, 1)
    assert cap > bound and cap & (cap - 1) == 0 and cap >= 64
    rng = np.random.default_rng(bound)
    ids = rng.choice(50_000_000, size=bound + 300, replace=False)
    table, seen = VisitedTable(cap), set()
    for i in ids[:bound]:
        assert table.insert(int(i)) and not table.insert(int(i))
        seen.add(int(i))
    assert table.inserts == bound == len(seen)
    assert all(table.contains(int(i)) == (int(i) in seen) for i in ids)


def test_visited_table_route():
    """The walk's bound (its min(S, beam) starts and max_steps x expand x R
    inserts) sets the table; past VISITED_TABLE_MAX slots the walk keeps the
    bitmap (0)."""
    assert G.visited_table_cap(8, 100, 200, 1, 32) == 8192  # 6,408 inserts at most
    assert G.visited_table_cap(300, 125, 250, 1, 32) == 8192  # 125 + 8,000 = 8,125
    assert G.visited_table_cap(300, 128, 256, 1, 32) == 16_384  # 128 + 8,192
    assert G.visited_table_cap(8, 250, 500, 1, 32) == 16_384  # 16,008
    assert G.visited_table_cap(8, 260, 520, 1, 32) == 0  # 16,648: a table of 32,768
    assert G.visited_table_cap(700, 520, 1040, 1, 16) == 0
    assert G.visited_table_cap(2, 5, 0, 1, 4) == 64
    bound = G.VISITED_TABLE_MAX - 1
    assert G.visited_table_cap(bound, bound, 0, 1, 1) == G.VISITED_TABLE_MAX
    assert G.visited_table_cap(bound + 1, bound + 1, 0, 1, 1) == 0


# ── K17's step, modelled ──────────────────────────────────────────────────


def rank_order(keys: np.ndarray, finite_only: bool) -> np.ndarray:
    """rank_sort: the slots best first, the lower slot first between equal
    keys (the finite ones only when ``finite_only``)."""
    slots = np.arange(len(keys))
    if finite_only:
        slots = slots[keys > NEG]
    return slots[np.lexsort((slots, -keys[slots].astype(np.float64)))]


def merge_counts(pool: list, fresh: list, beam: int, cur: int):
    """merge_fresh, the expand-1 step's merge: the m fresh entries [(key,
    id)] in slot order, unsorted; pool entry i lands at i + (finite fresh
    keys above it), a finite fresh entry j at (pool keys at or above it) +
    (fresh keys above it, or equal in an earlier slot); every pool entry is
    copied. Returns the new pool, the cursor (as merge_pool) and the count of
    finite fresh entries."""
    fk = np.array([f[0] for f in fresh], dtype=np.float32)
    pk = np.array([p[0] for p in pool], dtype=np.float32)
    f = int((fk > NEG).sum())
    out = [None] * min(beam, len(pool) + f)
    ncur = beam
    for i, (v, pid, pe) in enumerate(pool):
        c = int((fk > v).sum())
        if i + c < beam:
            out[i + c] = (v, pid, pe)
            if i == cur:
                ncur = min(ncur, i + c)
    for j, (v, fid) in enumerate(fresh):
        if not v > NEG:
            continue
        lo = int((pk >= v).sum())  # the pool is sorted: its binary search
        lo += int(((fk > v) | ((fk == v) & (np.arange(len(fk)) < j))).sum())
        if lo < beam:
            out[lo] = (v, fid, False)
            ncur = min(ncur, lo)
    assert all(e is not None for e in out)
    return out, ncur, f


def merge_pool(pool: list, fresh: list, beam: int, cur: int):
    """merge, of the sorted pool [(key, id, expanded)] with the sorted fresh
    [(key, id)]: a pool entry i lands at i + (fresh keys above it), a fresh
    entry j at j + (pool keys at or above it), each by a binary search; the
    best ``beam`` kept. Returns the new pool and the cursor: the lowest new
    place of the pool entry at ``cur`` and of every fresh entry."""
    fk = np.array([f[0] for f in fresh], dtype=np.float32)
    pk = np.array([p[0] for p in pool], dtype=np.float32)
    out = [None] * min(beam, len(pool) + len(fresh))
    ncur = beam
    for i, (v, pid, pe) in enumerate(pool):
        c = int(np.searchsorted(-fk, -v, side="left")) if len(fk) else 0
        if i + c < beam:
            out[i + c] = (v, pid, pe)
            if i == cur:
                ncur = min(ncur, i + c)
    for j, (v, fid) in enumerate(fresh):
        lo, hi = 0, len(pool)
        while lo < hi:
            mid = (lo + hi) // 2
            if pk[mid] >= v:
                lo = mid + 1
            else:
                hi = mid
        if j + lo < beam:
            out[j + lo] = (v, fid, False)
            ncur = min(ncur, j + lo)
    assert all(e is not None for e in out)
    return out, ncur


def choose_next(pool: list, fresh: list, cur: int, beam: int):
    """Warp 0's choice of the next node before the merge: the first
    unexpanded finite pool entry from the cursor (p*) or the best finite fresh
    entry (f*, the lower slot between equal keys) where it lands within the
    beam and beats p* (a pool entry first between equal keys). Returns (id,
    place in the merged pool) or None."""
    fk = np.array([f[0] for f in fresh], dtype=np.float32)
    ppos = next((p for p in range(cur, len(pool)) if not pool[p][2] and pool[p][0] > NEG), -1)
    pkey = pool[ppos][0] if ppos >= 0 else NEG
    if len(fk) and fk.max() > NEG:
        best = int(np.flatnonzero(fk == fk.max())[0])
        lo = sum(1 for p in pool if p[0] >= fk[best])
        if lo < beam and (ppos < 0 or fk[best] > pkey):
            return fresh[best][1], lo
    if ppos < 0:
        return None
    return pool[ppos][1], ppos + int((fk > pkey).sum())


def pick(pool: list, cur: int, e: int):
    """Warp 0's pick: the first ``e`` unexpanded entries with a finite key,
    scanned 32 at a time from the cursor, stopping at the first chunk that
    holds a -inf key. Returns (chosen places, the first unexpanded place)."""
    chosen, first = [], -1
    for base in range(cur, len(pool), 32):
        chunk = range(base, min(base + 32, len(pool)))
        unexp = [p for p in chunk if not pool[p][2]]
        if first < 0 and unexp:
            first = unexp[0]
        chosen += [p for p in unexp if pool[p][0] > NEG][: e - len(chosen)]
        if len(chosen) >= e or any(not pool[p][0] > NEG for p in chunk):
            break
    return chosen, (len(pool) if first < 0 else first)


def walk_model(key_of, graph: np.ndarray, starts: np.ndarray, valid: np.ndarray, *, beam: int,
               max_steps: int, expand: int, table_cap: int):
    """One query's walk as the kernel takes it. ``key_of``: node ids ->
    their float32 keys. Returns (keys (beam,), ids (beam,), scanned)."""
    n, r = graph.shape
    vis = VisitedTable(table_cap) if table_cap else VisitedBitmap(n)
    fresh_slots = max(expand * r, 256)

    def score(ids: np.ndarray) -> np.ndarray:
        keys = np.full(len(ids), NEG, dtype=np.float32)
        live = (ids >= 0) & valid[np.maximum(ids, 0)]
        if live.any():
            keys[live] = key_of(ids[live])
        return np.where(np.isnan(keys), NEG, keys).astype(np.float32)

    pool = []
    for c0 in range(0, len(starts), fresh_slots):
        chunk = starts[c0 : c0 + fresh_slots]
        ids = np.where((chunk >= 0) & (chunk < n), chunk, -1)
        keys = score(ids)
        pool, _ = merge_pool(pool, [(keys[s], int(ids[s])) for s in rank_order(keys, False)],
                             beam, -1)
    for _, pid, _ in pool:
        if pid >= 0:
            vis.insert(pid)
    cur = 0
    for _ in range(max_steps):
        chosen, first = pick(pool, cur, 1 if expand == 1 and r <= 32 else expand)
        cur = first
        if not chosen:
            break
        for p in chosen:
            pool[p] = (pool[p][0], pool[p][1], True)
        nbrs = np.concatenate([graph[pool[p][1]] for p in chosen])
        fresh = [0 <= nb < n and not vis.contains(int(nb)) for nb in nbrs]  # every lookup first
        if expand > 1:  # two parents may share a neighbour: its first slot in the step
            fresh = [f and not any(fresh[u] and nbrs[u] == nb for u in range(t))
                     for t, (f, nb) in enumerate(zip(fresh, nbrs))]
        for nb, f in zip(nbrs, fresh):
            if f:
                vis.insert(int(nb))
        if expand == 1 and r <= 32:  # warp 0's compacted list, merged by counts
            ids = np.array([nb for nb, f in zip(nbrs, fresh) if f], dtype=np.int64)
            entries = list(zip(score(ids), ids.tolist()))
            ahead = choose_next(pool, entries, cur, beam)  # before the merge, as warp 0 does
            if len(ids):
                pool, ncur, _ = merge_counts(pool, entries, beam, cur)
                cur = min(ncur, len(pool))
            after, _ = pick(pool, cur, 1)
            assert ahead == ((pool[after[0]][1], after[0]) if after else None)
            if after:  # the cursor: the next node's place (all before it are expanded)
                cur = after[0]
            continue
        else:
            ids = np.where(fresh, nbrs, -1)
            keys = score(ids)
            entries = [(keys[s], int(ids[s])) for s in rank_order(keys, True)]
        if entries:
            pool, ncur = merge_pool(pool, entries, beam, cur)
            cur = min(ncur, len(pool))
    keys = np.full(beam, NEG, dtype=np.float32)
    out_ids = np.full(beam, -1, dtype=np.int32)
    for i, (v, pid, _) in enumerate(pool):
        keys[i] = v
        out_ids[i] = pid if v > NEG else -1
    return keys, out_ids, vis.inserts


N, DIM = 1500, 24


@pytest.fixture(scope="module")
def walk_inputs():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(N, DIM)).astype(np.float32) + 0.5
    x[700:720] = x[20:40]  # duplicated rows: exact key ties
    graph = np.asarray(JG.build_vamana(jnp.asarray(x), JMetric.L2, r=12, l_build=32))
    q = (x[rng.integers(0, N, 4)] + 0.2 * rng.normal(size=(4, DIM))).astype(np.float32)
    valid = rng.random(N) >= 0.1
    return rng, x, graph, q, valid


def _model_walks(x, graph, q, starts, valid, metric, *, beam, max_steps, expand, table_cap):
    kind = {"IP": "ip", "L2": "l2"}[metric]
    ops = G.beam_operands("f32", torch.from_numpy(q), torch.from_numpy(x), kind=kind)
    xt = torch.from_numpy(x)
    out = []
    for b in range(len(q)):
        def key_of(ids, b=b):
            ids_t = torch.from_numpy(np.asarray(ids, dtype=np.int64))[None]
            return G._tier_keys_plain(0, G._KIND_CODE[kind], ops["qop"][b : b + 1],
                                      ops["qconst"][b : b + 1], xt, (), ids_t)[0].numpy()

        s = starts if starts.ndim == 1 else starts[b]
        out.append(walk_model(key_of, graph, s, valid, beam=beam, max_steps=max_steps,
                              expand=expand, table_cap=table_cap))
    keys, ids, scanned = zip(*out)
    return np.stack(keys), np.stack(ids), np.array(scanned, dtype=np.int32)


@pytest.mark.parametrize("route", ["table", "bitmap"])
@pytest.mark.parametrize("expand", [1, 2])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_walk_model_matches_plain_and_jax(walk_inputs, metric, expand, route):
    """The modelled walk, under the visited table and the bitmap, equals
    beam_walk_plain to the bit and the JAX package's _beam_core (its ids and
    visit counts; keys rtol 1e-5), from shared and per-query starts."""
    _, x, graph, q, valid = walk_inputs
    beam, steps = 40, 80
    for starts in (np.array([3, 17], np.int32),
                   np.array([[5 + i, 40 + i, 900 + i] for i in range(len(q))], np.int32)):
        cap = G.visited_table_cap(starts.shape[-1], beam, steps, expand, graph.shape[1])
        assert cap > 0
        got = _model_walks(x, graph, q, starts, valid, metric, beam=beam, max_steps=steps,
                           expand=expand, table_cap=cap if route == "table" else 0)
        plain = G.beam_search(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(graph),
                              torch.from_numpy(starts), torch.from_numpy(valid),
                              metric=Metric[metric], beam=beam, max_steps=steps, k=beam,
                              expand=expand)
        for g, w in zip(got, plain):
            w = np.asarray(w)
            assert np.array_equal(g.view(np.uint32) if g.dtype == np.float32 else g,
                                  w.view(np.uint32) if w.dtype == np.float32 else w)
        jk_, ji, js = (np.asarray(a) for a in JG.beam_search(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(graph), jnp.asarray(starts),
            jnp.asarray(valid), metric=JMetric[metric], beam=beam, max_steps=steps, k=beam,
            expand=expand))
        np.testing.assert_array_equal(got[2], js)
        fin = np.isfinite(jk_)
        np.testing.assert_array_equal(np.isfinite(got[0]), fin)
        np.testing.assert_allclose(got[0][fin], jk_[fin], rtol=1e-5, atol=1e-5)
        for r, c in zip(*np.nonzero(got[1] != ji)):  # a swap only between near-equal keys
            j = np.nonzero(ji[r] == got[1][r, c])[0]
            assert len(j) and abs(jk_[r, j[0]] - jk_[r, c]) <= 1e-5 * abs(jk_[r, c]) + 1e-5


@pytest.mark.parametrize("case", ["r40", "dup_slots"])
def test_walk_model_step_routes(walk_inputs, case):
    """The block-wide step at expand 1 (R = 40 > 32) and adjacency rows that
    hold a node in two slots (both fresh in one step, scanned once): the
    model equals beam_walk_plain to the bit."""
    rng, x, graph, q, valid = walk_inputs
    graph = graph.copy()
    if case == "r40":
        graph = np.concatenate([graph, rng.integers(-1, N, size=(N, 28)).astype(np.int32)], 1)
    else:
        graph[::3, 1] = graph[::3, 0]
    starts = np.array([3, 17], np.int32)
    cap = G.visited_table_cap(2, 32, 64, 1, graph.shape[1])
    got = _model_walks(x, graph, q, starts, valid, "L2", beam=32, max_steps=64, expand=1,
                       table_cap=cap)
    plain = G.beam_search(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(graph),
                          torch.from_numpy(starts), torch.from_numpy(valid), metric=Metric.L2,
                          beam=32, max_steps=64, k=32)
    np.testing.assert_array_equal(got[0].view(np.uint32), np.asarray(plain[0]).view(np.uint32))
    np.testing.assert_array_equal(got[1], np.asarray(plain[1]))
    np.testing.assert_array_equal(got[2], np.asarray(plain[2]))


@pytest.mark.parametrize("seed", range(6))
def test_count_merge_keeps_the_tie_order(seed):
    """merge_counts on crafted equal keys (a few values, -inf among them, a
    pool holding the same values) gives the plain version's stable top over
    concat(pool, fresh): a pool entry before a fresh one, fresh ones by slot,
    -inf fresh ones left out; and merge_pool over the rank-sorted fresh
    entries gives the same."""
    rng = np.random.default_rng(seed)
    vals = np.array([3.0, 1.5, 1.5, -2.0, -np.inf], np.float32)
    fk = rng.choice(vals, 32)
    if seed == 0:
        fk[:] = 1.5  # every key equal
    pk = np.sort(rng.choice(vals[:4], 20))[::-1].astype(np.float32)
    pool = [(pk[i], i, bool(i % 3 == 0)) for i in range(len(pk))]
    fresh = [(fk[j], 100 + j) for j in range(len(fk))]
    for beam in (20, 30, 60):
        got, _, f = merge_counts(pool, fresh, beam, 0)
        keys = torch.from_numpy(np.concatenate([pk, fk]))[None]
        ids = [p[1] for p in pool] + [e[1] for e in fresh]
        top_keys, pos = G._stable_top(keys, beam)
        want = [ids[i] for i in pos[0].tolist()]
        assert f == int((fk > NEG).sum())
        assert [o[1] for o in got] == want[: len(got)]
        assert [o[0] for o in got] == top_keys[0].tolist()[: len(got)]
        order = rank_order(fk, True)
        same, _ = merge_pool(pool, [fresh[j] for j in order], beam, 0)
        assert same == got


def test_merge_keeps_the_pool_first():
    """merge_pool (the starts and the block-wide step) on equal keys: a pool
    entry before a fresh one, fresh ones in their sorted order, as the plain
    version's stable top over concat(pool, fresh)."""
    pool = [(np.float32(v), i, False) for i, v in enumerate([5, 5, 3, 3, 1, -np.inf])]
    fresh = [(np.float32(v), 100 + j) for j, v in enumerate([5, 3, 3, 2])]
    for beam in (6, 8, 10):
        out, _ = merge_pool(pool, fresh, beam, 0)
        keys = torch.tensor([[p[0] for p in pool] + [f[0] for f in fresh]])
        ids = [p[1] for p in pool] + [f[1] for f in fresh]
        top_keys, pos = G._stable_top(keys, beam)
        assert [o[1] for o in out] == [ids[i] for i in pos[0].tolist()][: len(out)]
        assert [o[0] for o in out] == top_keys[0].tolist()[: len(out)]


# ── K15a ──────────────────────────────────────────────────────────────────


def warp_row_sq(x: np.ndarray) -> np.float32:
    """|x|^2 as a warp forms it: lane l's fmaf sum over d = l, l + 32, ...
    from 0, then lt::warp_sum (lane l adds lane l ^ o, o = 16 .. 1), lane 0's."""
    lanes = np.zeros(32, np.float32)
    for d0 in range(0, len(x), 32):
        part = np.zeros(32, np.float32)
        part[: len(x[d0 : d0 + 32])] = x[d0 : d0 + 32]
        lanes = np.where(np.arange(32) < len(x) - d0, fmaf32(part, part, lanes), lanes)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    return lanes[0]


def replay_row_sq(x: np.ndarray) -> np.float32:
    """The small route's row_sq_tree, a row a thread: u[l] = v[l] + v[l +
    16], then u[l] += u[l + o] for o = 8, 4, 2, 1 (lane l's fmaf sums v[l]
    as the warp forms them)."""
    v = np.zeros(32, np.float32)
    for d in range(len(x)):
        v[d % 32] = fmaf32(x[d : d + 1], x[d : d + 1], v[d % 32 : d % 32 + 1])[0]
    u = v[:16] + v[16:]
    for o in (8, 4, 2, 1):
        u[:o] = u[:o] + u[o : 2 * o]
    return u[0]


@pytest.mark.parametrize("d", [1, 7, 8, 9, 32, 33])
def test_row_sq_replay_is_the_warp_sum(d):
    rng = np.random.default_rng(d)
    rows = (rng.normal(size=(300, d)) * 10.0 ** rng.integers(-6, 7, size=(300, 1))).astype(
        np.float32)
    for x in rows:
        assert warp_row_sq(x).view(np.uint32) == replay_row_sq(x).view(np.uint32)


def fold_sequential(scores: np.ndarray, ip: bool) -> np.ndarray:
    """The small route: every centroid in index order, a strict comparison
    from +inf (L2) / -inf (IP); index 0 where nothing beat it."""
    out = np.zeros(len(scores), np.int64)
    for r, row in enumerate(scores):
        best, best_i = (-np.inf if ip else np.inf), -1
        for k, v in enumerate(row):
            if (v > best) if ip else (v < best):
                best, best_i = v, k
        out[r] = max(best_i, 0)
    return out


def fold_tile(scores: np.ndarray, ip: bool) -> np.ndarray:
    """The FMA route: 128-centroid tiles in order; thread tr folds its
    centroids (i // 4) 64 + 4 tr + i % 4 of each tile strictly; then the 16
    threads meet by xor 8, 4, 2, 1, the better (score, index) kept."""
    n, k = scores.shape
    big = 2**31 - 1
    best = np.full((n, 16), -np.inf if ip else np.inf)
    best_i = np.full((n, 16), big)
    for c0 in range(0, k, 128):
        for tr in range(16):
            for i in range(8):
                ci = c0 + (i // 4) * 64 + 4 * tr + i % 4
                if ci >= k:
                    continue
                v = scores[:, ci]
                take = (v > best[:, tr]) if ip else (v < best[:, tr])
                best[:, tr] = np.where(take, v, best[:, tr])
                best_i[:, tr] = np.where(take, ci, best_i[:, tr])
    for o in (8, 4, 2, 1):
        ov, oi = best[:, np.arange(16) ^ o], best_i[:, np.arange(16) ^ o]
        better = ((ov > best) if ip else (ov < best)) | ((ov == best) & (oi < best_i))
        best, best_i = np.where(better, ov, best), np.where(better, oi, best_i)
    return np.where(best_i[:, 0] == big, 0, best_i[:, 0])


@pytest.mark.parametrize("ip", [False, True])
def test_assign_folds_agree_on_ties_and_nan(ip):
    """Both routes' folds give the sequential answer on scores with many
    exact ties, NaN (never picked) and infinities; rows without NaN give
    the plain version's argmin / argmax."""
    rng = np.random.default_rng(int(ip))
    scores = np.round(rng.normal(size=(400, 300)), 1).astype(np.float32)
    scores[rng.random(scores.shape) < 0.02] = np.nan
    scores[5] = np.nan  # a NaN row: index 0
    scores[6] = np.inf if not ip else -np.inf  # nothing beats the start: index 0
    scores[7, 200:] = -np.inf if not ip else np.inf  # the best at the end
    seq = fold_sequential(scores, ip)
    np.testing.assert_array_equal(fold_tile(scores, ip), seq)
    assert seq[5] == seq[6] == 0 and seq[7] == 200
    clean = ~np.isnan(scores).any(1)
    t = torch.from_numpy(scores[clean])
    want = (torch.argmax(t, 1) if ip else torch.argmin(t, 1)).numpy()
    np.testing.assert_array_equal(seq[clean], want)


@pytest.mark.parametrize("ip", [False, True])
def test_assign_ties_and_nan_rows_match_jax(ip):
    """kmeans_assign (its plain version on the CPU) against the JAX
    package's assign_clusters with duplicated centroids (the lower index)
    and NaN rows (index 0); the kernels' sequential fold over the plain
    scores gives the same index."""
    rng = np.random.default_rng(4 + int(ip))
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    c = x[rng.choice(2000, 50, replace=False)].copy()
    c[[10, 30]] = c[3]
    x[[7, 1500]] = np.nan
    got = tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c), ip).numpy()
    want = np.asarray(jk.assign_clusters(jnp.asarray(x), jnp.asarray(c), chunk=2000, ip=ip))
    np.testing.assert_array_equal(got, want)
    assert got[7] == got[1500] == 0 and not np.isin(got, [10, 30]).any()
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    s = (tk._ip_scores(xt, ct) if ip else tk._l2_scores(xt, ct, (ct * ct).sum(-1))).numpy()
    np.testing.assert_array_equal(fold_sequential(s, ip), got)

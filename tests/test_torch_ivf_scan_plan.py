"""A model of K16's routes (csrc/ivf_scan_blocks.cu, the f32 IVF block
scan under IP, L2 and cosine) in numpy, held to the plain version and to
the JAX package on the CPU, as tests/test_torch_probe_plan.py models K16b,
and the route policy (index/ivf.py _scan_route) on CPU tensors.

Row route (small B): a block of threads per (query, slot, quarter of the
block's 2,048 rows). A slot past its cluster's blocks is -inf at once.
Otherwise the quarter's row ids come first, with each real row's live flag,
and give its last real row; its rows up to that one are scored (a dead row
-inf, never read) and the rest are -inf.

Tile route (large B): each probe counted against its cluster, a scan of
the counts giving each cluster's list offset and listing the probed
(cluster, block) pairs in cluster order, each probe placed in its cluster's
list (in any order; the block sorts its list into probe order); a block of
threads per listed pair and quarter of its rows reads the cluster's probes
(in rounds of LIST_CAP) and serves them in tiles of TILE_Q on the FMA
route: the quarter's rows up to its last real row are read once a tile
(dead rows never), each
key goes to its probe's slot, and the quarter's rows past its last real one
are -inf; a pass of its own writes -inf to every slot past its cluster's
blocks.

Warp route (the port's first design): a block of threads per (query, slot),
a warp a row, lane l summing dimensions l, l + 32, ... in one FMA chain,
then a butterfly over the 32 lanes.

The model checks that every (query, slot) key is written exactly once, and
that each probed block is read once for each tile of its probes. Each key is
the kernels' arithmetic: the dot product one f32 FMA chain over the
dimensions in order (each FMA's single rounding modelled in float64, whose
product of two f32 is exact), then probe_key's f32 operations.

Tolerances: the rows and tile routes' keys equal bit for bit (the same
chain); the warp route's within the plain version's tolerance. Against
``ivf_scan_blocks_plain`` (PyTorch's product, another order): the -inf
pattern equal and |key - plain| <= 1e-4 + 1e-5 |plain| (chip_smoke.py's
K16 tolerance). After K5, against the JAX package's ``_ivf_search_kernel``
under IP, L2 and cosine: the distances within the same tolerance, and an id
only one side returns lies within twice it of the fetch-th key (a
near-tie).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.index.ivf import _ivf_search_kernel
from lynsedb_tpu.metrics import Metric as JMetric
from lynsedb_tpu.ops.scan import unpack_search_step
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import topk
from test_torch_probe_plan import layout

BS = ivf.BLOCK_SIZE
PARTS, PART_ROWS = 4, BS // 4  # the row route's quarters
TILE_Q, TILE_ROWS = 32, 128  # the tile route's FmaTile<32, 4, 16>
LIST_CAP = 1024  # probes a round of a block's list
METRICS = [Metric.IP, Metric.L2, Metric.COSINE]


def f32(v):
    return np.asarray(v, np.float32)


def fma_dot(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(rows, queries) dot products, each one f32 FMA chain over the
    dimensions in order from +0."""
    acc = np.zeros((x.shape[0], q.shape[0]), np.float32)
    for d in range(x.shape[1]):
        acc = f32(x[:, d].astype(np.float64)[:, None] * q[:, d].astype(np.float64)[None, :]
                  + acc.astype(np.float64))
    return acc


def probe_key(ip, q_sq, x_sq, metric: Metric) -> np.ndarray:
    """ivf_scan_blocks.cu probe_key: the oriented key from the dot product
    and the two squared norms (L2: one FMA of -2 ip onto q_sq + x_sq)."""
    ip = f32(ip)
    if metric is Metric.IP:
        return ip
    if metric is Metric.L2:
        s = f32(f32(q_sq) + f32(x_sq))
        d = f32(-2.0 * ip.astype(np.float64) + s.astype(np.float64))
        return -np.maximum(d, np.float32(0.0))
    denom = np.sqrt(f32(f32(q_sq) * f32(x_sq)))
    with np.errstate(divide="ignore", invalid="ignore"):
        dist = np.where(denom < 1e-30, np.float32(1.0),
                        f32(np.float32(1.0) - ip / np.maximum(denom, np.float32(1e-30))))
    return -f32(dist)


def warp_dot(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(rows,) dot products of the warp route: lane l's FMA chain over
    dimensions l, l + 32, ..., then lt::warp_sum's butterfly (xor 16, 8, 4,
    2, 1), each add rounded to f32."""
    lanes = np.zeros((x.shape[0], 32), np.float32)
    for d in range(x.shape[1]):
        lane = d % 32
        lanes[:, lane] = f32(x[:, d].astype(np.float64) * np.float64(q[d])
                             + lanes[:, lane].astype(np.float64))
    for o in (16, 8, 4, 2, 1):
        lanes = f32(lanes + lanes[:, np.arange(32) ^ o])
    return lanes[:, 0]


def to_key(k: np.ndarray, ok: np.ndarray) -> np.ndarray:
    return np.where(ok & ~np.isnan(k), k, np.float32(-np.inf)).astype(np.float32)


def block_facts(block_orig, live, blk):
    """A block's live flags and its last real row + 1 (the fill)."""
    orig = block_orig[blk]
    flags = (orig >= 0) & live[np.maximum(orig, 0)]
    real = np.nonzero(orig >= 0)[0]
    return flags, (int(real.max()) + 1 if len(real) else 0)


def model_rows(q, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig, live,
               metric: Metric, reads: dict) -> np.ndarray:
    """The row route's keys (B, nprobe * max_bpc * BS); ``reads`` counts the
    rows read, by block."""
    b, nprobe = top_c.shape
    max_bpc = cluster_blocks.shape[1]
    slots = nprobe * max_bpc
    keys = np.full((b, slots, BS), np.nan, np.float32)
    writes = np.zeros((b, slots, BS), np.int64)
    for i in range(b):
        for s in range(slots):
            blk = cluster_blocks[top_c[i, s // max_bpc], s % max_bpc]
            for part in range(PARTS):
                p0 = part * PART_ROWS
                sl = slice(p0, p0 + PART_ROWS)
                writes[i, s, sl] += 1
                if blk < 0:
                    keys[i, s, sl] = -np.inf
                    continue
                orig = block_orig[blk, sl]
                flags = (orig >= 0) & live[np.maximum(orig, 0)]
                real = np.nonzero(orig >= 0)[0]
                fill = int(real.max()) + 1 if len(real) else 0
                out = np.full(PART_ROWS, -np.inf, np.float32)
                rows = np.nonzero(flags[:fill])[0]  # the rows read
                reads[blk] = reads.get(blk, 0) + len(rows)
                if len(rows):
                    ip = fma_dot(blocks[blk, p0 + rows], q[i : i + 1])[:, 0]
                    xs = block_sq[blk, p0 + rows] if metric is not Metric.IP else 0.0
                    out[rows] = to_key(probe_key(ip, qsq[i], xs, metric), np.ones(len(rows), bool))
                keys[i, s, sl] = out
    assert np.all(writes == 1), "every key written exactly once"
    assert not np.isnan(keys).any()
    return keys.reshape(b, -1)


def probed_pairs(top_c, cluster_blocks) -> list:
    """The mark-and-scan list: c * max_bpc + j for each block j of each
    cluster some probe names, in cluster order."""
    max_bpc = cluster_blocks.shape[1]
    marks = np.zeros(cluster_blocks.shape[0], bool)
    marks[top_c.reshape(-1)] = True
    return [c * max_bpc + j for c in np.nonzero(marks)[0]
            for j in range(max_bpc) if cluster_blocks[c, j] >= 0]


def probe_lists(top_c, n_clusters: int) -> list:
    """Each cluster's probes (b * nprobe + p), counted, placed and sorted
    into probe order, as the kernels' count / scan / place passes and the
    tile kernel's sort give them."""
    probes = top_c.reshape(-1)
    counts = np.bincount(probes, minlength=n_clusters)
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    plist = np.empty(len(probes), np.int64)
    seen = np.zeros(n_clusters, np.int64)
    for e in np.random.default_rng(0).permutation(len(probes)):  # any atomic order
        c = probes[e]
        plist[offsets[c] + seen[c]] = e
        seen[c] += 1
    return [np.sort(plist[offsets[c] : offsets[c] + counts[c]]) for c in range(n_clusters)]


def model_tile(q, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig, live,
               metric: Metric, reads: dict) -> np.ndarray:
    """The tile route's keys; ``reads`` counts, by (block, part), the times
    the part's rows are streamed."""
    b, nprobe = top_c.shape
    max_bpc = cluster_blocks.shape[1]
    keys = np.full((b * nprobe * max_bpc, BS), np.nan, np.float32)
    writes = np.zeros((b * nprobe * max_bpc, BS), np.int64)
    probes = top_c.reshape(-1)
    # the pass of its own: slots past their cluster's blocks
    for e in range(len(probes)):
        for j in range(max_bpc):
            if cluster_blocks[probes[e], j] < 0:
                keys[e * max_bpc + j] = -np.inf
                writes[e * max_bpc + j] += 1
    lists = probe_lists(top_c, cluster_blocks.shape[0])
    for cj in probed_pairs(top_c, cluster_blocks):
        c, j = divmod(cj, max_bpc)
        blk = cluster_blocks[c, j]
        mine = lists[c]
        assert np.array_equal(mine, np.nonzero(probes == c)[0])  # in probe order
        for part in range(PARTS):
            p0 = part * PART_ROWS
            orig = block_orig[blk, p0 : p0 + PART_ROWS]
            flags = (orig >= 0) & live[np.maximum(orig, 0)]
            real = np.nonzero(orig >= 0)[0]
            fill = int(real.max()) + 1 if len(real) else 0
            for lo in range(0, len(mine), LIST_CAP):
                lst = mine[lo : lo + LIST_CAP]
                keys[lst * max_bpc + j, p0 + fill : p0 + PART_ROWS] = -np.inf
                writes[lst * max_bpc + j, p0 + fill : p0 + PART_ROWS] += 1
                for q0 in range(0, len(lst), TILE_Q):
                    if fill == 0:
                        break
                    tile = lst[q0 : q0 + TILE_Q]
                    reads[(blk, part)] = reads.get((blk, part), 0) + 1
                    ok = flags[:fill]
                    x = np.where(ok[:, None], blocks[blk, p0 : p0 + fill], np.float32(0.0))
                    ip = fma_dot(x, q[tile // nprobe])  # (rows, probes)
                    xs = np.where(ok, block_sq[blk, p0 : p0 + fill], np.float32(0.0))[:, None] \
                        if metric is not Metric.IP else np.float32(0.0)
                    k = to_key(probe_key(ip, qsq[tile // nprobe][None, :], xs, metric),
                               ok[:, None])
                    keys[tile * max_bpc + j, p0 : p0 + fill] = k.T
                    writes[tile * max_bpc + j, p0 : p0 + fill] += 1
    assert np.all(writes == 1), "every key written exactly once"
    assert not np.isnan(keys).any()
    return keys.reshape(b, -1)


def model_warp(q, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig, live,
               metric: Metric) -> np.ndarray:
    """The warp route's keys (B, nprobe * max_bpc * BS): every row of a
    probed block keyed (-inf where padding or not live), every row of a
    slot past its cluster's blocks -inf."""
    b, nprobe = top_c.shape
    max_bpc = cluster_blocks.shape[1]
    slots = nprobe * max_bpc
    keys = np.full((b, slots, BS), -np.inf, np.float32)
    for i in range(b):
        for s in range(slots):
            blk = cluster_blocks[top_c[i, s // max_bpc], s % max_bpc]
            if blk < 0:
                continue
            flags, _ = block_facts(block_orig, live, blk)
            ip = warp_dot(blocks[blk], q[i])
            xs = block_sq[blk] if metric is not Metric.IP else np.float32(0.0)
            keys[i, s] = to_key(probe_key(ip, qsq[i], xs, metric), flags)
    return keys.reshape(b, -1)


SIZES = [4500, 700, 0, 2048, 1, 1300, 2049, 30, 900, 1700]  # 4,500 rows: three blocks


def case(d: int, b: int, seed: int):
    """Rows near their cluster's centre, the layout, a block all deleted,
    queries near the centres, each cluster's mean as its centroid (a random
    one for the empty cluster)."""
    rng = np.random.default_rng(seed)
    owner = rng.permutation(np.repeat(np.arange(len(SIZES)), SIZES))
    centres = rng.normal(size=(len(SIZES), d)).astype(np.float32) * 3
    x = (centres[owner] + rng.normal(size=(len(owner), d))).astype(np.float32)
    block_orig, cluster_blocks = layout(owner, len(SIZES))
    live = rng.random(len(owner)) < 0.8
    live[block_orig[-1][block_orig[-1] >= 0]] = False  # a block all deleted
    q = (centres[rng.integers(0, len(SIZES), b)] + rng.normal(size=(b, d))).astype(np.float32)
    centroids = np.stack([x[owner == c].mean(0) if size else rng.normal(size=d)
                          for c, size in enumerate(SIZES)]).astype(np.float32)
    return x, q, centroids, block_orig, cluster_blocks, live


def device_arrays(x, block_orig, metric: Metric):
    """The port's block arrays, as IVFIndex._device_state forms them."""
    flat = torch.from_numpy(block_orig.reshape(-1))
    blocks = torch.from_numpy(x)[flat.clamp_min(0).long()] * (flat >= 0)[:, None]
    block_sq = D.corpus_transform(blocks, Metric.L2)["sq"]
    return flat, blocks.view(-1, BS, x.shape[1]), block_sq


def assert_near_plain(got: np.ndarray, want: np.ndarray) -> None:
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert bool((err <= 1e-4 + 1e-5 * np.abs(want[fin])).all()), float(err.max())


@pytest.mark.parametrize("d", [7, 32])
@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("metric", METRICS)
def test_routes_match_plain_and_jax(metric, b, d):
    """Both routes' models: equal to each other bit for bit, near the plain
    version, and through K5 near the JAX kernel; a cluster of three blocks,
    an empty one, one of a single row, a block all deleted."""
    x, q, centroids, block_orig, cluster_blocks, live = case(d, b, d + b)
    nprobe, fetch = 4, 30
    flat, blocks, block_sq = device_arrays(x, block_orig, metric)
    qd = torch.from_numpy(q)
    top_c = ivf._top_clusters(qd, D.corpus_transform(torch.from_numpy(centroids), metric),
                              metric, nprobe)
    qsq = (qd * qd).sum(-1)
    args = (qd, qsq, top_c, torch.from_numpy(cluster_blocks), blocks, block_sq, flat,
            torch.from_numpy(live), metric)
    want = ivf.ivf_scan_blocks_plain(*args).numpy()
    np_args = (q, qsq.numpy(), top_c.numpy(), cluster_blocks, blocks.numpy(),
               block_sq.view(-1, BS).numpy(), block_orig, live, metric)
    rows = model_rows(*np_args, reads={})
    reads = {}
    tile = model_tile(*np_args, reads=reads)
    np.testing.assert_array_equal(rows.view(np.int32), tile.view(np.int32))
    assert_near_plain(rows, want)
    # each probed block's parts read once (every cluster's probes fit one tile)
    probed = {int(c) for c in top_c.reshape(-1)}
    blks = {int(blk) for c in probed for blk in cluster_blocks[c] if blk >= 0}
    assert {blk for blk, _ in reads} <= blks and set(reads.values()) <= {1}
    # then K5 and the ids, against the JAX kernel on the same index
    top, col = topk.topk_select_plain(torch.from_numpy(rows), fetch)
    slot_blk = cluster_blocks[top_c.numpy()].reshape(b, -1)
    blk = np.take_along_axis(slot_blk, (col.numpy() // BS).astype(np.int64), 1)
    ids = np.where(blk >= 0, block_orig.reshape(-1)[np.maximum(blk, 0) * BS + col.numpy() % BS],
                   -1)
    dists = top.numpy() if metric is Metric.IP else -top.numpy()
    blocks_np = np.where((block_orig >= 0)[..., None], x[np.maximum(block_orig, 0)], 0.0)
    packed = _ivf_search_kernel(jnp.asarray(q), jnp.asarray(centroids),
                                jnp.asarray(blocks_np.astype(np.float32)),
                                jnp.asarray(block_orig), jnp.asarray(cluster_blocks),
                                jnp.asarray(live), k=fetch, nprobe=nprobe,
                                metric=JMetric[metric.name], ascending=metric.ascending)
    jd, ji = unpack_search_step(np.asarray(packed))
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(dists), fin)
    tol = 1e-4 + 1e-5 * np.abs(jd[fin])
    assert bool((np.abs(dists[fin] - jd[fin]) <= tol).all())
    for r in range(b):
        kth = abs(float(jd[r][fin[r]][-1])) if fin[r].any() else 0.0
        for i in set(ids[r][fin[r]].tolist()) ^ set(ji[r][fin[r]].tolist()):
            where = np.nonzero(ids[r] == i)[0]
            dist = dists[r, where[0]] if len(where) else jd[r, np.nonzero(ji[r] == i)[0][0]]
            assert abs(abs(float(dist)) - kth) <= 2 * (1e-4 + 1e-5 * kth), (r, i)


def test_tile_route_serves_many_probes_in_tiles():
    """A popular cluster probed by 150 queries: each quarter of each of its
    blocks is read once a tile of 32 (five tiles), rows past a quarter's last
    real row are never read, a second round of the list where more probes
    than LIST_CAP name one cluster, the routes still equal."""
    global LIST_CAP
    x, q, centroids, block_orig, cluster_blocks, live = case(16, 150, 5)
    metric = Metric.L2
    flat, blocks, block_sq = device_arrays(x, block_orig, metric)
    rng = np.random.default_rng(6)
    top_c = np.stack([rng.permutation(len(SIZES))[:3] for _ in range(150)]).astype(np.int32)
    top_c[:, 0] = 0  # every query probes the three-block cluster first
    top_c[:, 1:] = np.where(top_c[:, 1:] == 0, 2, top_c[:, 1:])
    qd = torch.from_numpy(q)
    qsq = (qd * qd).sum(-1)
    np_args = (q, qsq.numpy(), top_c, cluster_blocks, blocks.numpy(),
               block_sq.view(-1, BS).numpy(), block_orig, live, metric)
    want = ivf.ivf_scan_blocks_plain(qd, qsq, torch.from_numpy(top_c),
                                     torch.from_numpy(cluster_blocks), blocks, block_sq, flat,
                                     torch.from_numpy(live), metric).numpy()
    rows = model_rows(*np_args, reads={})
    saved = LIST_CAP
    try:
        for cap in (1024, 100):  # one round of the list, then two (100 + 50 probes)
            LIST_CAP = cap
            reads = {}
            got = model_tile(*np_args, reads=reads)
            np.testing.assert_array_equal(got.view(np.int32), rows.view(np.int32))
            # cluster 0's blocks: 150 probes in tiles of 32 (5), or 100 + 50 (4 + 2);
            # a quarter that is all padding is never read
            per_tile = 5 if cap == 1024 else 6
            for blk in cluster_blocks[0]:
                for part in range(PARTS):
                    orig = block_orig[blk, part * PART_ROWS : (part + 1) * PART_ROWS]
                    assert reads.get((int(blk), part), 0) == (per_tile if (orig >= 0).any()
                                                              else 0)
    finally:
        LIST_CAP = saved
    assert_near_plain(rows, want)


def test_probed_pairs_lists_each_probed_block_once():
    """The mark-and-scan list: each block of each probed cluster once, in
    cluster order, none of an unprobed cluster; empty clusters list
    nothing."""
    _, _, _, block_orig, cluster_blocks, _ = case(4, 1, 1)
    top_c = np.array([[6, 0, 2], [0, 6, 9]], np.int32)
    pairs = probed_pairs(top_c, cluster_blocks)
    max_bpc = cluster_blocks.shape[1]
    want = [c * max_bpc + j for c in (0, 6, 9) for j in range(max_bpc) if cluster_blocks[c, j] >= 0]
    assert pairs == want and len(pairs) == len(set(pairs))
    assert cluster_blocks[2, 0] < 0  # cluster 2 is empty: no block listed


def test_row_route_reads_only_live_rows():
    """The row route reads each live row of a probed slot once a query and
    no dead or padding row."""
    x, q, centroids, block_orig, cluster_blocks, live = case(8, 2, 3)
    metric = Metric.IP
    flat, blocks, block_sq = device_arrays(x, block_orig, metric)
    top_c = np.array([[0, 5], [0, 3]], np.int32)
    reads = {}
    model_rows(q, (q * q).sum(-1), top_c, cluster_blocks, blocks.numpy(),
               block_sq.view(-1, BS).numpy(), block_orig, live, metric, reads)
    for blk, n in reads.items():
        flags, _ = block_facts(block_orig, live, blk)
        probes = int((cluster_blocks[top_c.reshape(-1)] == blk).sum())
        assert n == probes * int(flags.sum())


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("metric", METRICS)
def test_warp_route_near_plain(metric, b):
    """The warp route's model (lanes over D, a butterfly) near the plain
    version with the same -inf pattern, D = 40 (lanes of two and one
    dimensions)."""
    x, q, centroids, block_orig, cluster_blocks, live = case(40, b, 11 + b)
    flat, blocks, block_sq = device_arrays(x, block_orig, metric)
    qd = torch.from_numpy(q)
    top_c = ivf._top_clusters(qd, D.corpus_transform(torch.from_numpy(centroids), metric),
                              metric, 3)
    qsq = (qd * qd).sum(-1)
    want = ivf.ivf_scan_blocks_plain(qd, qsq, top_c, torch.from_numpy(cluster_blocks), blocks,
                                     block_sq, flat, torch.from_numpy(live), metric).numpy()
    got = model_warp(q, qsq.numpy(), top_c.numpy(), cluster_blocks, blocks.numpy(),
                     block_sq.view(-1, BS).numpy(), block_orig, live, metric)
    assert_near_plain(got, want)


def share_by_count(top_c: np.ndarray, cluster_blocks: np.ndarray) -> float:
    """Probes a probed block, counted one (probe, block) pair at a time."""
    pairs = [int(blk) for c in top_c.reshape(-1) for blk in cluster_blocks[c] if blk >= 0]
    return len(pairs) / max(len(set(pairs)), 1)


@pytest.mark.parametrize("b", [1, 3, 9, 40])
def test_probe_share_counts_pairs_over_distinct_blocks(b):
    """ivf.probe_share on CPU tensors: the (probe, block) pairs a batch scans
    over the distinct blocks they reach, as a count pair by pair gives it
    (clusters of zero to three blocks, repeated probes of one cluster)."""
    _, _, _, _, cluster_blocks, _ = case(4, 1, 1)
    rng = np.random.default_rng(b)
    top_c = np.stack([rng.permutation(len(SIZES))[:4] for _ in range(b)]).astype(np.int32)
    top_c[: b // 2, 0] = 0
    got = ivf.probe_share(torch.from_numpy(top_c), torch.from_numpy(cluster_blocks))
    assert got == pytest.approx(share_by_count(top_c, cluster_blocks), rel=1e-12)


@pytest.mark.parametrize("b", [1, 8, 9, 64])
def test_scan_route_by_batch_and_share(b):
    """_scan_route: rows up to SCAN_ROWS_MAX_B queries, else the shared
    launch; shared_route (the card's pick in it, mirrored): tile where the
    probes share blocks (every query probing the same clusters: a share of
    B) at least SCAN_TILE_MIN_SHARE times, warp where they do not (each
    probed block once: a share of 1); min_share 0 always the tile, inf
    always the warp."""
    n_clusters = 2 * b * 4
    cluster_blocks = torch.arange(n_clusters, dtype=torch.int32)[:, None]  # a block a cluster
    shared = torch.arange(4, dtype=torch.int32).repeat(b, 1)
    apart = torch.arange(b * 4, dtype=torch.int32).view(b, 4)
    assert ivf.probe_share(shared, cluster_blocks) == b
    assert ivf.probe_share(apart, cluster_blocks) == 1
    assert ivf._scan_route(b) == ("rows" if b <= ivf.SCAN_ROWS_MAX_B else "shared")
    assert ivf.shared_route(shared, cluster_blocks) == (
        "tile" if b >= ivf.SCAN_TILE_MIN_SHARE else "warp")
    assert ivf.shared_route(apart, cluster_blocks) == (
        "tile" if ivf.SCAN_TILE_MIN_SHARE <= 1 else "warp")
    for top_c in (shared, apart):
        assert ivf.shared_route(top_c, cluster_blocks, 0.0) == "tile"
        assert ivf.shared_route(top_c, cluster_blocks, float("inf")) == "warp"

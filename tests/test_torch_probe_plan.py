"""A model of K16b's inverted probe (csrc/ivf_scan_blocks.cu, the tile
route) in numpy, held to the plain version and to the JAX package on the
CPU.

The model runs the kernel's plan: the blocks of threads of (cluster, block
slot j of the cluster) gather, in order, the probes (b * nprobe + p) whose
top_c entry is its cluster, in rounds of LIST_CAP, and serve them in tiles
of TILE_Q queries; they read the block's ids (each row's live flag, the
last real row), stream its rows up to the last real one once for each tile
(split over up to four blocks of threads, a run of row tiles each), key
each (row, query) from the popcount of the ANDed words and the two bit
counts with the JAX package's f32 operations (common.cuh binary_distance),
and write -inf for padding and dead rows, for the rows past the last real
one and for every slot of a cluster with fewer blocks than the widest. The
model checks that every (query, slot) key is written exactly once and that
each probed block is read once for each tile of its probes.

Tolerance: none. The model's keys equal ``ivf_scan_blocks_plain``'s bit for
bit; after K5 the probe's distances equal ``_ivf_search_kernel``'s (the JAX
package's bf16 product of the {0, 1} rows, exact for these counts) bit for
bit and its ids id for id (both select the lower column first between equal
keys over the same slot order).
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

BS = ivf.BLOCK_SIZE
TILE_Q, TILE_ROWS, LIST_CAP = 64, 128, 4096
POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def layout(owner: np.ndarray, n_clusters: int):
    """index/ivf.py _layout: each cluster's rows (in row order, as the
    cluster-sorted postings give them) in blocks of BS, -1 padded:
    (block_orig (n_blocks, BS), cluster_blocks (Kc, max_bpc))."""
    sizes = np.bincount(owner, minlength=n_clusters)
    bpc = -(-sizes // BS)
    cluster_blocks = np.full((n_clusters, max(int(bpc.max()), 1)), -1, np.int32)
    block_orig = np.full((max(int(bpc.sum()), 1), BS), -1, np.int32)
    order = np.argsort(owner, kind="stable")
    at = nb = 0
    for c, n in enumerate(sizes):
        for i in range(int(bpc[c])):
            seg = order[at + i * BS : at + min(n, (i + 1) * BS)]
            block_orig[nb, : len(seg)] = seg
            cluster_blocks[c, i] = nb
            nb += 1
        at += n
    return block_orig, cluster_blocks


def binary_distance(metric: Metric, inter, cq, cx) -> np.ndarray:
    """common.cuh binary_distance in f32, each operation rounded."""
    inter, cq, cx = (np.asarray(v, np.float32) for v in (inter, cq, cx))
    two = np.float32(2.0)
    if metric is Metric.HAMMING:
        return (cq + cx) - two * inter
    uni = (cq + cx) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.float32(1.0) - inter / np.maximum(uni, np.float32(1.0))
    return np.where(uni == 0, np.float32(0.0), d).astype(np.float32)


def model_probe(qwords, qcnt, top_c, cluster_blocks, block_words, block_cnt, block_orig, live,
                metric: Metric, reads: dict) -> np.ndarray:
    """K16b's tile route: (B, nprobe * max_bpc * BS) f32 keys; ``reads``
    counts the times each block is streamed."""
    b, nprobe = top_c.shape
    kc, max_bpc = cluster_blocks.shape
    keys = np.full((b * nprobe * max_bpc, BS), np.nan, np.float32)  # NaN: not written
    writes = np.zeros(b * nprobe * max_bpc, np.int64)
    probes = top_c.reshape(-1)
    for c in range(kc):
        for j in range(max_bpc):
            blk = cluster_blocks[c, j]
            mine = np.nonzero(probes == c)[0]  # in order: the block's scan of top_c
            for lo in range(0, len(mine), LIST_CAP):
                lst = mine[lo : lo + LIST_CAP]
                out = lst * max_bpc + j
                if blk < 0:
                    keys[out] = -np.inf
                    writes[out] += 1
                    continue
                orig = block_orig[blk]
                valid = (orig >= 0) & live[np.maximum(orig, 0)]
                fill = int(np.nonzero(orig >= 0)[0].max()) + 1
                tiles = -(-fill // TILE_ROWS)
                for q0 in range(0, len(lst), TILE_Q):
                    tile = lst[q0 : q0 + TILE_Q]
                    reads[blk] = reads.get(blk, 0) + 1
                    rows = block_words[blk, : tiles * TILE_ROWS].view(np.uint8)
                    qs = qwords[tile // nprobe].view(np.uint8)
                    inter = POP8[rows[:, None, :] & qs[None, :, :]].sum(-1)  # (rows, queries)
                    r = np.arange(tiles * TILE_ROWS)
                    live_r = (r < fill) & valid[: tiles * TILE_ROWS]
                    d = binary_distance(metric, inter, qcnt[tile // nprobe][None, :],
                                        block_cnt[blk, : tiles * TILE_ROWS][:, None])
                    k = np.where(live_r[:, None] & ~np.isnan(-d), -d, np.float32(-np.inf))
                    keys[out[q0 : q0 + TILE_Q], : tiles * TILE_ROWS] = k.T
                    keys[out[q0 : q0 + TILE_Q], tiles * TILE_ROWS :] = -np.inf
                    writes[out[q0 : q0 + TILE_Q]] += 1
    assert np.all(writes == 1), "every (query, slot) written exactly once"
    assert not np.isnan(keys).any()
    return keys.reshape(b, nprobe * max_bpc * BS)


SIZES = [4500, 700, 0, 2048, 1, 1300, 2049, 30, 900, 1700]  # 4,500 rows: three blocks


def case(bits: int, b: int, seed: int):
    """Rows near one prototype of their cluster, the layout, a block all
    deleted, queries near the prototypes, each cluster's mean as its
    centroid (a random one for the empty cluster)."""
    rng = np.random.default_rng(seed)
    owner = rng.permutation(np.repeat(np.arange(len(SIZES)), SIZES))
    protos = rng.random((len(SIZES), bits)) < 0.25
    x01 = (protos[owner] ^ (rng.random((len(owner), bits)) < 0.05)).astype(np.float32)
    block_orig, cluster_blocks = layout(owner, len(SIZES))
    live = rng.random(len(owner)) < 0.8
    live[block_orig[-1][block_orig[-1] >= 0]] = False  # a block all deleted
    q01 = (protos[rng.integers(0, len(SIZES), b)] ^ (rng.random((b, bits)) < 0.05)).astype(
        np.float32)
    centroids = np.stack([x01[owner == c].mean(0) if size else rng.random(bits)
                          for c, size in enumerate(SIZES)]).astype(np.float32)
    return x01, q01, centroids, block_orig, cluster_blocks, live


@pytest.mark.parametrize("bits", [100, 1024])
@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("metric", [Metric.HAMMING, Metric.JACCARD])
def test_probe_model_matches_plain_and_jax(metric, b, bits):
    """W = 4 and 32; B = 1 and 17; a cluster of three blocks, an empty one,
    one of a single row, a block whose rows are all deleted."""
    x01, q01, centroids, block_orig, cluster_blocks, live = case(bits, b, bits + b)
    nprobe, fetch = 4, 30
    # the port's device arrays (as IVFIndex._device_state forms them), on the CPU
    ct = D.corpus_transform(torch.from_numpy(x01), metric)
    flat = torch.from_numpy(block_orig.reshape(-1))
    pad = flat >= 0
    words = (ct["bits"][flat.clamp_min(0).long()] * pad[:, None]).view(-1, BS, ct["bits"].shape[1])
    cnt = ct["cnt"][flat.clamp_min(0).long()] * pad
    qt = D.query_transform(torch.from_numpy(q01), metric)
    top_c = ivf._top_clusters(torch.from_numpy(q01),
                              D.corpus_transform(torch.from_numpy(centroids), metric), metric,
                              nprobe)
    cb, lv = torch.from_numpy(cluster_blocks), torch.from_numpy(live)
    want = ivf.ivf_scan_blocks_plain(qt["bits"], qt["cnt"], top_c, cb, words, cnt, flat, lv,
                                     metric)
    reads = {}
    got = model_probe(qt["bits"].numpy(), qt["cnt"].numpy(), top_c.numpy(), cluster_blocks,
                      words.numpy(), cnt.view(-1, BS).numpy(), block_orig, live, metric, reads)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))
    # each probed block read once (every cluster's probes fit one tile here)
    probed = {int(c) for c in top_c.reshape(-1)}
    assert reads == {int(blk): 1 for c in probed for blk in cluster_blocks[c] if blk >= 0}
    # then K5 and the ids, against the JAX kernel on the same index
    top, col = topk.topk_select_plain(torch.from_numpy(got), fetch)
    slot_blk = cluster_blocks[top_c.numpy()].reshape(b, -1)
    blk = np.take_along_axis(slot_blk, (col.numpy() // BS).astype(np.int64), 1)
    ids = np.where(blk >= 0, block_orig.reshape(-1)[np.maximum(blk, 0) * BS + col.numpy() % BS],
                   -1)
    dists = -top.numpy()
    jmetric = JMetric[metric.name]
    blocks01 = np.where((block_orig >= 0)[..., None], x01[np.maximum(block_orig, 0)], 0.0)
    packed = _ivf_search_kernel(jnp.asarray(q01), jnp.asarray(centroids),
                                jnp.asarray(blocks01.astype(np.float32)), jnp.asarray(block_orig),
                                jnp.asarray(cluster_blocks), jnp.asarray(live), k=fetch,
                                nprobe=nprobe, metric=jmetric, ascending=True)
    jd, ji = unpack_search_step(np.asarray(packed))
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(dists), fin)
    np.testing.assert_array_equal(dists[fin].view(np.int32), jd[fin].view(np.int32))
    np.testing.assert_array_equal(ids[fin], ji[fin])


def test_probe_model_serves_many_queries_in_tiles():
    """A popular cluster probed by 150 queries: each of its blocks serves
    them in three tiles of at most 64, reading the block once a tile (150
    reads a block on a route of a block a (query, slot)); a second round of
    the list where more probes than LIST_CAP name one cluster."""
    global LIST_CAP
    x01, q01, centroids, block_orig, cluster_blocks, live = case(100, 150, 5)
    metric = Metric.HAMMING
    ct = D.corpus_transform(torch.from_numpy(x01), metric)
    flat = torch.from_numpy(block_orig.reshape(-1))
    pad = flat >= 0
    words = (ct["bits"][flat.clamp_min(0).long()] * pad[:, None]).view(-1, BS, ct["bits"].shape[1])
    cnt = ct["cnt"][flat.clamp_min(0).long()] * pad
    qt = D.query_transform(torch.from_numpy(q01), metric)
    rng = np.random.default_rng(6)
    top_c = np.stack([rng.permutation(len(SIZES))[:3] for _ in range(150)]).astype(np.int32)
    top_c[:, 0] = 0  # every query probes the three-block cluster first
    top_c[:, 1:] = np.where(top_c[:, 1:] == 0, 2, top_c[:, 1:])
    args = (qt["bits"], qt["cnt"], torch.from_numpy(top_c), torch.from_numpy(cluster_blocks),
            words, cnt, flat, torch.from_numpy(live), metric)
    want = ivf.ivf_scan_blocks_plain(*args).numpy()
    saved = LIST_CAP
    try:
        for cap in (4096, 100):  # one round of the list, then two (100 + 50 probes)
            LIST_CAP = cap
            reads = {}
            got = model_probe(qt["bits"].numpy(), qt["cnt"].numpy(), top_c, cluster_blocks,
                              words.numpy(), cnt.view(-1, BS).numpy(), block_orig, live, metric,
                              reads)
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            # cluster 0's three blocks, each read once a tile: 64 + 64 + 22, or
            # 64 + 36 then 50
            assert [reads[int(blk)] for blk in cluster_blocks[0]] == [3, 3, 3]
    finally:
        LIST_CAP = saved

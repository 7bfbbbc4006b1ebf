"""The H100 SXM's peak rates and the least time a kernel's work can take on
them, for chip_smoke.py and tools/tile_times.py (one copy of each rate and
of each formula the two share). Standard library only: tile_times.py loads
it beside an older tree's package."""

from __future__ import annotations

# NVIDIA's data sheet: HBM bytes/s, f32 and dense bf16 flop/s, dense int8 op/s
HBM_BPS, F32_FLOPS, BF16_FLOPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12
# f32 instructions a second outside the tensor cores (67 TFLOP/s counts an
# FMA as two flops), and the special-function units' and popcount's rate:
# 132 SMs x 16 a clock x 1.98 GHz (a reciprocal, a logarithm, a popcount)
F32_OPS, SFU_OPS = F32_FLOPS / 2, 132 * 16 * 1.98e9


def bound_t(bytes_moved: float, t_ops: float):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of its bytes over the memory rate and its operations' time
    ``t_ops`` in seconds."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, t_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(bytes_moved: float, flops: float, peak_flops: float = F32_FLOPS):
    return bound_t(bytes_moved, flops / peak_flops)


def f32_tile_bound(b: int, d: int, n_live: int, rows: int, row_bytes: int = 0):
    """K1 / K6a's tile mode: each live row read once (d f32 and
    ``row_bytes`` of per-row terms), every row's valid byte, the queries
    read and the (B, rows) keys written; 2 B n_live d flops at the f32
    peak."""
    return bound(n_live * (d * 4 + row_bytes) + rows + b * d * 4 + b * rows * 4,
                 2 * b * n_live * d)


def binary_tile_bound(b: int, w: int, n_live: int, rows: int):
    """K6b's tile mode over W-word bit rows: each live row's words and bit
    count read once, every row's valid byte, the queries' words and counts
    read and the (B, rows) keys written; 2 B n_live 32 W bit-operations (an
    AND and a count a bit pair) on the integer tensor cores. The data sheet
    gives no b1 rate; its int8 rate is the nearest one it gives."""
    return bound(n_live * (w * 4 + 4) + rows + b * (w * 4 + 4) + b * rows * 4,
                 2 * b * n_live * 32 * w, INT8_OPS)


def code_scan_bound(b: int, d: int, dp: int, n_live: int, rows: int, row_bytes: int):
    """K12 over (rows, dp) int8 codes: each live row's codes and its
    ``row_bytes`` of epilogue terms read once, every row's valid byte, the
    (B, d) f32 queries read and the (B, rows) keys written; 2 B n_live dp
    operations at the int8 tensor-core rate."""
    return bound(n_live * (dp + row_bytes) + rows + b * d * 4 + b * rows * 4,
                 2 * b * n_live * dp, INT8_OPS)


def shared_list_bound(b: int, d: int, s: int):
    """K11 over a (1, S) list shared by every query: each gathered bf16 row,
    its m . (x - m) word, its id and slot key read once, the queries read
    and the (B, S) keys written; 2 B S d flops at the bf16 peak (the same
    products run on the tensor cores)."""
    return bound(s * (d * 2 + 4 + 8) + b * s * 4 + b * d * 4, 2 * b * s * d, BF16_FLOPS)


def topl_bound(b: int, d: int, n: int, l: int, ops_per_pair: float | None = None,
               row_bytes: int | None = None, sfu_per_pair: float = 0.0):
    """K19 over n rows for b queries: each row read once (``row_bytes``: by
    default d f32 and a squared norm), the queries and their norms read, the
    (b, l) lists written as key and id; the pairs' work 2 b n d flops at the
    f32 peak, or under an elementwise metric ``ops_per_pair`` f32
    instructions and ``sfu_per_pair`` special-function operations a pair at
    F32_OPS and SFU_OPS, the slower of the two."""
    row_bytes = d * 4 + 4 if row_bytes is None else row_bytes
    moved = n * row_bytes + b * (d + 1) * 4 + b * l * 8
    if ops_per_pair is None:
        return bound(moved, 2 * b * n * d)
    return bound_t(moved, max(b * n * ops_per_pair / F32_OPS, b * n * sfu_per_pair / SFU_OPS))


# The f32 instructions and special-function operations of a (pair,
# dimension) of metrics.cuh's accumulate<M>, by the Metric's value: a
# difference and an add of its absolute value (L1, Chebyshev's compare and
# select, Wasserstein over the cdf), Canberra's two absolute sums, select and
# add around an IEEE division, Bray-Curtis's two sums, Jensen-Shannon's sum,
# product and add around a logarithm. K20's table under any other graph
# metric (IP, L2, cosine, correlation and Hellinger over their lead rows)
# runs the Gram, whose multiply and add count as two, since the bit contract
# forbids an FMA.
ELEM_DIM_OPS = {"l1": (2, 0), "chebyshev": (2, 0), "canberra": (4, 1), "bray_curtis": (4, 0),
                "wasserstein": (2, 0), "jensen_shannon": (3, 1)}
# Haversine's whole m x m table: a pair's f32 instructions (two differences,
# two halvings, five products, a sum, a two-sided clip) and special-function
# operations (two sines, a square root, an arcsine), and a row's, formed once
# (metrics.cuh GeoRow: two products to radians, one cosine)
HAVERSINE_PAIR_OPS, HAVERSINE_ROW_OPS = (12, 4), (2, 1)


def prune_bound(nodes: int, m: int, d: int, metric: str = "l2", *, r: int = 0,
                row_bytes: int | None = None):
    """K20 over ``nodes`` nodes of m table rows each (L = m - 1 candidates
    and the node) under ``metric`` (a Metric's value): each node's m rows
    read once (``row_bytes``: by default d f32), its L candidate ids and node
    id read, and its r pruned ids written (``r`` 0: the keys mode's L point
    keys and (L, L) pair keys); the table's work at F32_OPS and SFU_OPS, the
    slower of the two: the symmetric half's m (m + 1) / 2 pairs over d
    dimensions at ELEM_DIM_OPS, or Haversine's m x m pairs and m rows."""
    l = m - 1
    row_bytes = d * 4 if row_bytes is None else row_bytes
    out = r * 4 if r else (l * l + l) * 4
    moved = nodes * (m * row_bytes + l * 4 + 4 + out)
    if metric == "haversine":
        (f, s), (rf, rs) = HAVERSINE_PAIR_OPS, HAVERSINE_ROW_OPS
        f32, sfu = nodes * (m * m * f + m * rf), nodes * (m * m * s + m * rs)
    else:
        work = nodes * m * (m + 1) // 2 * d
        f, s = ELEM_DIM_OPS.get(metric, (2, 0))
        f32, sfu = work * f, work * s
    return bound_t(moved, max(f32 / F32_OPS, sfu / SFU_OPS))


def elem_tile_bound(metric: str, b: int, d: int, n_live: int, rows: int, row_bytes: int = 0):
    """K6c's f32 tile mode under ``metric`` (a Metric's value) over d-wide
    lead rows (Wasserstein's cdf, Jensen-Shannon's probabilities, the rows
    otherwise; Haversine's d = 2 points): each live row read once (d f32 and
    ``row_bytes`` of per-row terms), every row's valid byte, the queries read
    and the (B, rows) keys written; the pairs' work at F32_OPS and SFU_OPS,
    the slower of the two: d (pair, dimension)s at ELEM_DIM_OPS, or
    Haversine's HAVERSINE_PAIR_OPS a pair and HAVERSINE_ROW_OPS a row and a
    query (the kernel forms each point's radians and cosine once)."""
    moved = n_live * (d * 4 + row_bytes) + rows + b * (d * 4 + row_bytes) + b * rows * 4
    if metric == "haversine":
        (f, s), (rf, rs) = HAVERSINE_PAIR_OPS, HAVERSINE_ROW_OPS
        f32, sfu = b * n_live * f + (n_live + b) * rf, b * n_live * s + (n_live + b) * rs
    else:
        f, s = ELEM_DIM_OPS[metric]
        f32, sfu = b * n_live * d * f, b * n_live * d * s
    return bound_t(moved, max(f32 / F32_OPS, sfu / SFU_OPS))


def kmeans_update_bound(n: int, k: int, d: int, n_valid: int):
    """K15b, one Lloyd update of k centroids from n rows: every row's
    assignment (int32) and valid byte read, each valid row's d f32 read once,
    the old centroids read and the sums, new centroids, counts and moves
    written; n_valid d adds at F32_OPS."""
    return bound_t(n * 5 + n_valid * d * 4 + k * (3 * d + 2) * 4, n_valid * d / F32_OPS)


# f32 instructions a (row, centroid) pair's epilogue takes in K15a beside its
# d FMAs: L2 |x|^2 + |c|^2, the fused -2 x.c, the clamp and the compare with
# the row's best; IP the compare
ASSIGN_EPI_OPS = {"l2": 4, "ip": 1}


def assign_bound(n: int, k: int, d: int, ip: bool = False):
    """K15a, the nearest of k centroids for n rows of d f32: the rows read
    once, the centroids and their squared norms read, (n,) int32 written;
    n k (d + the epilogue's ASSIGN_EPI_OPS) f32 instructions at F32_OPS (an
    FMA one instruction, as the 67 TFLOP/s counts it two flops)."""
    epi = ASSIGN_EPI_OPS["ip" if ip else "l2"]
    return bound_t(n * d * 4 + k * (d + 1) * 4 + n * 4, n * k * (d + epi) / F32_OPS)


def walk_bytes_bound(visits: int, row_bytes: int, expanded: int, r: int, b: int, beam: int,
                     d: int):
    """K17's bytes bound: each visited node's guidance row, aux terms and
    valid byte (``row_bytes`` + 1), the adjacency row of each expanded node
    (at least the pool's finite entries) read once, the (B, beam) pool
    written; one multiply-add a dimension of a visited node. The visited set
    is left out."""
    return bound(visits * (row_bytes + 1) + expanded * r * 4 + b * beam * 8, 2 * visits * d)


def walk_bound(steps: int, load_ms: float):
    """K17's latency bound: the longest walk's ``steps``, each waiting for
    two dependent global loads (the expanded node's adjacency row, then its
    neighbours' rows) of ``load_ms`` each (ops/graph.py dependent_load_ms, a
    pointer chase timed on the card)."""
    return 2 * steps * load_ms, "latency"


def select_bound(b: int, n: int, k: int, ids: bool = False):
    """K5 over a (B, N) key matrix: each key (and with ``ids`` each caller
    id) read once, the (B, k) keys and indices written; its compares bound
    nothing."""
    return bound(b * n * (8 if ids else 4) + b * k * 8, 0)


def binary_probe_bound(blocks: int, real: int, n_live: int, w: int, keys: int, scored: int):
    """K16b over the distinct probed ``blocks``: each block's 2,048 row ids
    read once, the live flag of its ``real`` rows, the W words and bit count
    of its ``n_live`` live rows, the ``keys`` f32 keys written; a popcount a
    word of every ``scored`` (query, row) pair at the popcount rate."""
    return bound_t(blocks * 2048 * 4 + real + n_live * (w * 4 + 4) + keys * 4,
                   scored * w / SFU_OPS)


def ivf_probe_bound(blocks: int, real: int, n_live: int, d: int, keys: int, scored: int,
                    sq: bool):
    """K16 over the distinct probed ``blocks``: each block's 2,048 row ids
    read once, the live flag of its ``real`` rows, the d f32 (and with
    ``sq``, under L2 and cosine, the |x|^2) of its ``n_live`` live rows, the
    ``keys`` f32 keys written; an FMA (two flops) a dimension of every
    ``scored`` (query, row) pair at the f32 peak."""
    return bound(blocks * 2048 * 4 + real + n_live * (d * 4 + (4 if sq else 0)) + keys * 4,
                 2 * scored * d)


def elem_topc_bound(metric: str, b: int, d: int, n_live: int, rows: int, c: int):
    """K9, K6c's bf16 pass fused with its top C, under ``metric`` (a
    Metric's value) over the mean-centred bf16 copy: each live row's d bf16
    read once, every row's valid byte, the mean and the f32 queries read,
    the (B, C) lists of key and id written (no (B, N) keys); the pairs'
    work as elem_tile_bound's: d (pair, dimension)s at ELEM_DIM_OPS over
    F32_OPS and SFU_OPS, the slower of the two (the mean's add, once a row
    value, is left out)."""
    moved = n_live * d * 2 + rows + d * 4 + b * d * 4 + b * c * 8
    f, s = ELEM_DIM_OPS[metric]
    return bound_t(moved, max(b * n_live * d * f / F32_OPS, b * n_live * d * s / SFU_OPS))


def gather_topc_bound(b: int, d: int, s: int, c: int, n_live: int, aux_words: int = 1):
    """K11's fused second stage (a quantized search after K5's top S): each
    live slot's bf16 row and its ``aux_words`` per-row terms read once (IP
    and L2 one, cosine two), the (B, S) slot keys and row ids read, the f32
    queries and the mean read, the (B, C) keys and row ids written; 2 n_live
    d flops at the bf16 peak (the products of bf16 operands). The (B, S)
    keys of the two-launch route are not counted: the fused kernel keeps
    them on chip."""
    return bound(n_live * (2 * d + 4 * aux_words) + b * s * 8 + (b + 1) * d * 4 + b * c * 8,
                 2 * n_live * d, BF16_FLOPS)


def rescore_bound(b: int, c: int, d: int, n_live: int, k: int):
    """K3, the exact rescore of a (B, C) shortlist: each live slot's f32 row
    read once, the queries and the (B, C) first-pass keys and row ids read,
    the (B, k) f32 distances and int64 ids written; two FMAs (four flops) a
    live element at the f32 peak."""
    return bound(n_live * d * 4 + b * d * 4 + b * c * 8 + b * k * 12, 4 * n_live * d)

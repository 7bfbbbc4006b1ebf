"""Graph-ANN kernels: the batched beam search, the exact top-L scan and the
robust prune, with the Vamana build and the in-place updates around them.

Port of lynsedb_tpu/ops/graph.py (reference behaviour: src/index/hnsw.rs:625
search_layer, src/index/diskann.rs:602 beam, :798-1084 Vamana build,
:1337/:1496 in-place delete and insert). Three hand-written kernels carry the
device work, each beside its plain PyTorch version:

  * K17 :func:`beam_walk` (csrc/beam_search.cu) — one block a query walks the
    graph best first inside one launch, with the pool in shared memory and
    the visited set there too, as a hash set of node ids (a bitmap in device
    memory where its table would not fit, :func:`visited_table_cap`). Four
    guidance tiers (exact f32, centred bf16, SQ8 codes, PQ tables) differ
    only in how a node is scored.
  * K19 :func:`topl_scan` (csrc/topl_scan.cu) — the exact top-L of a query
    chunk over the whole corpus, self-matches masked: K1's pipelined f32
    tile over a span of rows a block, each query's running top L in a list
    in device memory (K2's WarpTopk merges), K5 merging the spans' lists; it
    feeds the Vamana build (L = l_build) and wires the HNSW upper layers
    (L = m).
  * K20 :func:`robust_prune` (csrc/robust_prune.cu) — gathers a node's
    candidate rows, forms the point and pair keys in f32 and runs the alpha
    prune; a second mode writes only the keys for the host prune.

K18, the entry scan over a fixed node sample, is the metric's distance kernel
(K1 for IP, L2 and cosine; K6a or K6c under a domain metric) and K5
``topk_select``. Keys are oriented: bigger is better, whatever the metric.

Under the HNSW family's domain metrics (correlation, Hellinger, L1,
Chebyshev, Wasserstein, Jensen-Shannon, Haversine; the JAX package's
``_keyed_pairwise``) the three kernels read a :class:`MetricRows`: the lead
rows of the metric's corpus transform and their per-row terms, with the
formulas of csrc/metrics.cuh (K17's metric tier, K19's metric mode, K20's
pair tables). The transform is row-wise, so a key formed from a corpus
transform's rows is the key of the JAX package's per-gathered-row transform.
The search glue both graph indexes share (batch cap, entry sample, exact
tail, final ranking) closes the module.

Bitwise contract of K17 and K20 with their plain versions: every dot product,
sum or max is a chain of separately rounded f32 operations in a fixed order (a
lane-strided warp reduction for K17, a sequential one over the dimensions for
K20), and the plain versions compute the same chains with elementwise torch
ops, so kernel and plain agree exactly on every key, and so on every walk and
prune.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..metrics import Metric
from . import _cuda
from . import distance as D
from .scan import _ELEM_CODE, _GEMM_CODE, metric_keys, metric_keys_plain
from .topk import topk_select

NEG_INF = float("-inf")
# The metrics the HNSW family serves beside IP, L2 and cosine (the reference
# keeps Canberra and Bray-Curtis exact-only, src/index/mod.rs:426-497).
DOMAIN_METRICS = (Metric.CORRELATION, Metric.HELLINGER, Metric.L1, Metric.CHEBYSHEV,
                  Metric.WASSERSTEIN, Metric.JENSEN_SHANNON, Metric.HAVERSINE)
_CODES = {**_GEMM_CODE, **_ELEM_CODE}
# guidance kind -> K17's metric code: IP, L2, cosine, then the domain metrics
# (the metric tier; csrc/common.cuh lt::Metric)
_KIND_CODE = {"ip": 0, "l2": 1, "cos": 2, **{m.value: _CODES[m] for m in DOMAIN_METRICS}}
_TIERS = {"f32": 0, "bf16": 1, "sq8": 2, "pq": 3, "metric": 4}
# the block's shared memory (H100: 227 KB); a larger pool raises
SMEM_LIMIT = 232_448
# fresh-candidate slots a K17 block scores per merge (also its start chunk)
_FRESH_MIN = 256
# K17's visited set stays in shared memory while its table takes at most this
# many int32 slots (64 KB: three blocks an SM beside the pools); a walk whose
# bound needs more keeps the device bitmap
VISITED_TABLE_MAX = 16_384
# K19's longest list: each block keeps its queries' running top L over one
# span of rows and writes L candidates a query; K5 merges the spans (their
# count and the lists' device buffer are the kernel's plan, lt_topl_spans
# and lt_topl_scratch)
TOPL_MAX_L = 256
# K19 epilogues: -(|q|^2 + |x|^2 - 2 q.x) unclamped (_topl_scan's L2), the
# dot product, the oriented pairwise keys of L2 (clamped) and cosine, and
# -distance under a domain metric over MetricRows
TOPL_L2_RAW, TOPL_DOT, TOPL_L2, TOPL_COS, TOPL_METRIC = 0, 1, 2, 3, 4


def graph_metric_code(name: str, metric: Metric) -> int:
    """The metric code of a graph kernel (K17, K19, K20), which serves IP,
    L2, cosine and the HNSW family's domain metrics."""
    if metric not in _METRIC_KIND and metric not in DOMAIN_METRICS:
        raise ValueError(f"{name} serves IP, L2, cosine and the graph indexes' domain metrics "
                         f"({', '.join(m.value for m in DOMAIN_METRICS)}), not {metric.value}")
    return _CODES[metric]


class MetricRows:
    """What the graph kernels read under a domain metric: the lead rows of a
    corpus transform (N, W) f32 (ops/distance.py LEAD) and their per-row
    terms (3, N) f32 — a, b and the invalid flag as 1.0 or 0.0 — or None for
    L1, Chebyshev and Haversine, which have none. Indexing takes rows (and
    their terms) as a tensor would."""

    def __init__(self, metric: Metric, rows: torch.Tensor, terms: Optional[torch.Tensor]):
        self.metric, self.rows, self.terms = metric, rows, terms

    @classmethod
    def of(cls, t: dict, metric: Metric) -> "MetricRows":
        rows = t[D.LEAD.get(metric, "x")].to(torch.float32).contiguous()
        a, b, inv = D.terms(t, metric)
        if a is None:
            return cls(metric, rows, None)
        zero = torch.zeros_like(a, dtype=torch.float32)
        parts = [a, zero if b is None else b, zero if inv is None else inv]
        return cls(metric, rows, torch.stack([v.to(torch.float32) for v in parts]).contiguous())

    def __len__(self) -> int:
        return self.rows.shape[0]

    def __getitem__(self, idx) -> "MetricRows":
        return MetricRows(self.metric, self.rows[idx].contiguous(),
                          None if self.terms is None else self.terms[:, idx].contiguous())

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def side(self, axis: Optional[int] = None) -> tuple:
        """(a, b, invalid) for D.finish, unsqueezed at ``axis`` when given."""
        if self.terms is None:
            return (None, None, None)
        out = (self.terms[0], self.terms[1], self.terms[2] != 0.0)
        return out if axis is None else tuple(v.unsqueeze(axis) for v in out)

    def transform(self) -> dict:
        """The transform dict these rows came from (the plain versions score
        it with ops/distance.py)."""
        t = {D.LEAD.get(self.metric, "x"): self.rows}
        names = D.TERMS.get(self.metric, ())
        for name, v in zip(names, self.side()):
            if name is not None:
                t[name] = v
        return t


def graph_space(x, metric: Metric):
    """The rows the graph kernels read under ``metric``: f32 rows under IP,
    L2 and cosine; a :class:`MetricRows` under a domain metric (raw rows are
    transformed, MetricRows pass through)."""
    if metric in _METRIC_KIND:
        return x.to(torch.float32).contiguous()
    if isinstance(x, MetricRows):
        return x
    return MetricRows.of(D.corpus_transform(x.to(torch.float32), metric), metric)


def _resolve_expand(expand: int | None, beam: int) -> int:
    """The expansion width of a beam step: ``expand`` (default 1, classic
    best-first) clamped to [1, beam]."""
    return max(1, min(expand if expand is not None else 1, beam))


def _stable_top(keys: torch.Tensor, k: int):
    """lax.top_k's order: descending, the lower position first among ties."""
    vals, idx = torch.sort(keys, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _mask_step_dups(fresh: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """Within one beam step, mask all but the first occurrence of each
    neighbour id a row (two expanded nodes sharing a neighbour)."""
    b = fresh.shape[0]
    sort_key = torch.where(fresh, nbrs, 2**30)
    srt, order = torch.sort(sort_key, dim=1, stable=True)
    dup_sorted = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=fresh.device),
                            (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < 2**30)], dim=1)
    dup = torch.zeros_like(fresh).scatter(1, order, dup_sorted)
    return fresh & ~dup


def entry_sample_ids(n: int, sample: int, *, sq_norms=None,
                     norm_top: int = 0, seed: int = 1234) -> np.ndarray:
    """Deterministic entry-scan node sample of a fixed size: ``sample``
    random rows, or, with a top-norm band (raw MIPS), ``min(sample, n - top)``
    random rows of the band's complement plus the band itself."""
    rng = np.random.default_rng(seed + n)
    if sq_norms is not None and norm_top > 0 and n > sample:
        top = min(norm_top, n)
        band = np.argpartition(-np.asarray(sq_norms)[:n], top - 1)[:top]
        band = band.astype(np.int32)
        mask = np.ones(n, dtype=bool)
        mask[band] = False
        rest = np.nonzero(mask)[0].astype(np.int32)
        c = min(sample, rest.size)
        picked = rng.choice(rest, size=c, replace=False) if c < rest.size else rest
        return np.sort(np.concatenate([picked.astype(np.int32), band]))
    c = min(n, sample)
    return (np.sort(rng.choice(n, size=c, replace=False))
            if c < n else np.arange(n)).astype(np.int32)


def _nan_to_neg_inf(keys: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(keys), NEG_INF, keys)


# ── K17: the beam search ─────────────────────────────────────────────────


def _lane_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in K17's order: lane l of a warp adds elements
    l, l + 32, ... one at a time from 0, then the 32 lanes meet in a
    butterfly (lane l adds lane l ^ o, o = 16, 8, 4, 2, 1)."""
    pad = (-p.shape[-1]) % 32
    if pad:
        p = torch.nn.functional.pad(p, (0, pad))
    parts = p.reshape(*p.shape[:-1], -1, 32)
    acc = torch.zeros(parts.shape[:-2] + (32,), dtype=torch.float32, device=p.device)
    for j in range(parts.shape[-2]):
        acc = acc + parts[..., j, :]
    lanes = torch.arange(32, device=p.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _pairwise_key(ip, sa, sb, code: int) -> torch.Tensor:
    """Oriented IP / L2 / cosine key from a dot product and the two squared
    norms, with D.pairwise's operation order (K17's f32 tier and K20)."""
    if code == 0:
        return ip
    if code == 1:
        return -torch.clamp_min((sa + sb) - 2.0 * ip, 0.0)
    denom = torch.sqrt(sa * sb)
    return -torch.where(denom < 1e-30, 1.0, 1.0 - ip / torch.clamp_min(denom, 1e-30))


_CODE_METRIC = {code: m for m, code in _CODES.items()}


def _elem_terms(metric: Metric, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One dimension's term of a summed elementwise metric (L1, Wasserstein,
    Jensen-Shannon), as csrc/metrics.cuh accumulate forms it."""
    if metric is Metric.JENSEN_SHANNON:
        m = u + v
        pos = m > 0.0
        return torch.where(pos, m * torch.log(torch.where(pos, m, 1.0)), 0.0)
    return (u - v).abs()


def _metric_dists_plain(code: int, qop, rows, aux, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K17's metric tier (csrc/beam_search.cu metric_key):
    the distances (B, C) of the nodes ``ids`` under a domain metric, the
    query's lead row and terms packed in ``qop`` (B, W + 3), the nodes' lead
    ``rows`` and their terms ``aux``, each sum in the warp's lane order."""
    metric = _CODE_METRIC[code]
    w = rows.shape[1]
    q, x = qop[:, None, :w], rows[ids]  # (B, 1, W), (B, C, W)
    if metric is Metric.HAVERSINE:
        return D.haversine(q[..., 0], q[..., 1], x[..., 0], x[..., 1])
    qs = (qop[:, w, None], qop[:, w + 1, None], qop[:, w + 2, None] != 0.0)
    xs = (aux[0][ids], aux[1][ids], aux[2][ids] != 0.0) if aux else (None,) * 3
    if metric in (Metric.CORRELATION, Metric.HELLINGER):
        acc = _lane_sum(q * x)
    elif metric is Metric.CHEBYSHEV:
        acc = (q - x).abs().amax(-1)
    else:
        acc = _lane_sum(_elem_terms(metric, q, x))
    return D.finish(metric, acc, qs, xs)


def _tier_keys_plain(tier: int, code: int, qop, qconst, rows, aux, ids: torch.Tensor):
    """Plain version of K17's node scoring: (B, C) node ids -> oriented keys
    (per-query constants dropped, as the JAX tiers drop them)."""
    if tier == 4:  # a domain metric: every metric is ascending
        return _nan_to_neg_inf(-_metric_dists_plain(code, qop, rows, aux, ids))
    if tier == 3:  # PQ: gather-sum of the query's (M, 256) table
        m = rows.shape[1]
        codes = rows[ids].long()  # (B, C, M)
        lut = qop.reshape(qop.shape[0], m, 256)
        vals = lut[torch.arange(lut.shape[0], device=ids.device)[:, None, None],
                   torch.arange(m, device=ids.device)[None, None, :], codes]
        ip = aux[0][ids] * _lane_sum(vals)
        if code == 0:
            keys = ip
        elif code == 1:
            keys = 2.0 * ip - aux[1][ids]
        else:
            keys = ip * aux[2][ids]
        return _nan_to_neg_inf(keys)
    x = rows[ids].to(torch.float32)  # (B, C, D)
    ip = _lane_sum(qop[:, None, :] * x)
    if tier == 0:
        keys = _pairwise_key(ip, qconst[:, None], _lane_sum(x * x), code)
    elif tier == 1:  # centred bf16: K2's rank-1 corrections
        if code == 0:
            keys = ip + aux[0][ids]
        elif code == 1:
            keys = 2.0 * ip - aux[1][ids]
        else:
            keys = ((ip + aux[0][ids]) + qconst[:, None]) * aux[2][ids]
    else:  # SQ8 codes
        if code == 0:
            keys = ip
        elif code == 1:
            keys = 2.0 * ip - aux[0][ids]
        else:
            keys = (ip + qconst[:, None]) * aux[1][ids]
    return _nan_to_neg_inf(keys)


def _beam_core_plain(keyed_ids, graph, starts, valid, b, *, beam, max_steps, expand,
                     stats: Optional[dict] = None):
    """Plain version of K17's walk (the JAX package's _beam_core): each step
    expands the best ``expand`` unexpanded pool entries, scores their fresh
    neighbours and keeps the best ``beam`` of pool and fresh, pool entries
    first between equal keys. Returns (keys (B, beam), ids (B, beam) int32,
    scanned (B,) int32), best first, ids -1 where the pool ran dry. The steps
    run in lockstep, so their count, put in ``stats["steps"]``, is the
    longest walk's."""
    n, r = graph.shape
    dev = graph.device
    starts_b = (starts[None, :].expand(b, -1) if starts.dim() == 1 else starts).long()
    s = starts_b.shape[1]
    in_range = (starts_b >= 0) & (starts_b < n)
    safe0 = starts_b.clamp(0, n - 1)
    keys0 = torch.where(in_range & valid[safe0], keyed_ids(safe0), NEG_INF)
    m0 = min(s, beam)
    top0, idx0 = _stable_top(keys0, m0)
    pool_keys = torch.full((b, beam), NEG_INF, dtype=torch.float32, device=dev)
    pool_ids = torch.full((b, beam), -1, dtype=torch.long, device=dev)
    pool_exp = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    pool_keys[:, :m0] = top0
    pool_ids[:, :m0] = torch.where(in_range.gather(1, idx0), starts_b.gather(1, idx0), -1)
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    ok = pool_ids >= 0
    visited[rows.expand_as(pool_ids)[ok], pool_ids[ok]] = True
    e = expand
    for steps in range(max_steps + 1):
        if steps == max_steps or not bool(
                (~pool_exp & (pool_ids >= 0) & (pool_keys > NEG_INF)).any()):
            break
        cand_key = torch.where(pool_exp | (pool_ids < 0), NEG_INF, pool_keys)
        top_cand, best = _stable_top(cand_key, e)
        has_work = top_cand > NEG_INF
        pool_exp = pool_exp.scatter(1, best, True)
        nbrs = graph[pool_ids.gather(1, best).clamp_min(0)].reshape(b, e * r).long()
        nbr_ok = (((nbrs >= 0) & (nbrs < n)).reshape(b, e, r) & has_work[:, :, None]).reshape(b, -1)
        safe = nbrs.clamp(0, n - 1)
        fresh = nbr_ok & ~visited.gather(1, safe)
        if e > 1:
            fresh = _mask_step_dups(fresh, nbrs)
        visited[rows.expand_as(safe)[fresh], safe[fresh]] = True
        keys = torch.where(fresh & valid[safe], keyed_ids(safe), NEG_INF)
        all_keys = torch.cat([pool_keys, keys], dim=1)
        all_ids = torch.cat([pool_ids, torch.where(fresh, nbrs, -1)], dim=1)
        all_exp = torch.cat([pool_exp, torch.zeros_like(fresh)], dim=1)
        pool_keys, pos = _stable_top(all_keys, beam)
        pool_ids, pool_exp = all_ids.gather(1, pos), all_exp.gather(1, pos)
    if stats is not None:
        stats["steps"] = steps
    pool_ids = torch.where(pool_keys > NEG_INF, pool_ids, -1)
    return pool_keys, pool_ids.to(torch.int32), visited.sum(1, dtype=torch.int32)


def beam_walk_plain(tier: str, qop, qconst, rows, aux, graph, starts, valid, *, code: int,
                    beam: int, max_steps: int, expand: int, stats: Optional[dict] = None):
    """Plain version of :func:`beam_walk`, on the inputs' device (``stats``:
    see _beam_core_plain)."""
    t = _TIERS[tier]

    def keyed(ids):
        return _tier_keys_plain(t, code, qop, qconst, rows, aux, ids)

    return _beam_core_plain(keyed, graph, starts, valid, qop.shape[0], beam=beam,
                            max_steps=max_steps, expand=expand, stats=stats)


def dependent_load_ms(device, *, span_bytes: int = 1 << 29, hops: int = 20_000) -> float:
    """Milliseconds of one global load whose address comes from the load
    before, on a CUDA ``device``: csrc/latency_probe.cu chases one cycle
    through ``span_bytes`` of int32 successors (by default 512 MB, the 1M x
    128 f32 rows' footprint, ten times the L2 cache), timed by CUDA events
    over ``hops`` loads. K17's walk waits for two such loads a step
    (tools/roofline.py walk_bound). The cycle is a full-period linear
    congruential sequence modulo a power of two, so its addresses jump."""
    n = 1 << max(10, (span_bytes // 4).bit_length() - 1)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    nxt = ((idx * 1103515245 + 12345) & (n - 1)).to(torch.int32)
    del idx
    out = torch.empty(1, dtype=torch.int32, device=device)

    def chase(h: int) -> None:
        _cuda.call("lt_pointer_chase", nxt.data_ptr(), 0, h, out.data_ptr(),
                   _cuda.stream_of(nxt))

    chase(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    chase(hops)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / hops


def _f(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.float32).contiguous()


def _beam_smem(beam: int, fresh: int, qw: int, expand: int, table_cap: int) -> int:
    """Dynamic shared memory of a K17 block (csrc/beam_search.cu beam_smem):
    two pools, the fresh slots, the query operand and the control words, and
    ``table_cap`` int32 slots of the visited set."""
    def round16(n: int) -> int:
        return (n + 15) // 16 * 16

    return (round16(18 * beam) + round16(19 * fresh) + round16(4 * qw + 4 * (16 + expand))
            + 4 * table_cap)


def visited_table_cap(n_starts: int, beam: int, max_steps: int, expand: int, r: int) -> int:
    """Slots of K17's visited set in shared memory for a walk: the smallest
    power of two (at least 64) above the most inserts the walk can make (the
    pool's min(S, beam) starts and max_steps x expand x R neighbours), so the
    table never fills; 0 where that is above VISITED_TABLE_MAX, and the walk
    keeps a (B, ceil(N/32)) bitmap in device memory instead."""
    bound = min(n_starts, beam) + max_steps * expand * r
    cap = max(64, 1 << bound.bit_length())
    return cap if cap <= VISITED_TABLE_MAX else 0


def beam_walk(tier: str, qop: torch.Tensor, qconst: Optional[torch.Tensor], rows: torch.Tensor,
              aux: tuple, graph: torch.Tensor, starts: torch.Tensor, valid: torch.Tensor, *,
              code: int, beam: int, max_steps: int, expand: int):
    """K17: the batched best-first walk over ``graph`` (N, R) int32 (-1
    padded) from ``starts`` ((S,) shared or (B, S) per query, int32), under
    the live mask ``valid`` (N,) bool. ``tier`` picks how a node is scored
    from the per-query operand ``qop`` (B, W) f32, ``qconst`` (B,) and the
    rows ``rows`` with their per-row ``aux`` arrays (see the public wrappers
    and beam_operands; ``code`` is the metric's, _KIND_CODE). Returns (keys
    (B, beam) f32, ids (B, beam) int32, scanned (B,) int32): the pool best
    first, ids -1 where it ran dry, and the number of nodes each walk
    visited."""
    if qop.device.type == "cpu":
        return beam_walk_plain(tier, qop, qconst, rows, aux, graph, starts, valid, code=code,
                               beam=beam, max_steps=max_steps, expand=expand)
    t = _TIERS[tier]
    b = qop.shape[0]
    n, r = graph.shape
    fresh = max(expand * r, _FRESH_MIN)
    cap = visited_table_cap(starts.shape[-1], beam, max_steps, expand, r)
    if _beam_smem(beam, fresh, qop.shape[1], expand, cap) > SMEM_LIMIT:
        cap = 0
    smem = _beam_smem(beam, fresh, qop.shape[1], expand, cap)
    if smem > SMEM_LIMIT:
        raise ValueError(f"beam_walk: a pool of {beam} needs {smem} bytes of shared memory "
                         f"(limit {SMEM_LIMIT})")
    if graph.dtype != torch.int32 or starts.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("beam_walk: graph and starts int32, valid bool expected")
    if valid.shape[0] < n or qop.dtype != torch.float32 or starts.dim() not in (1, 2):
        raise ValueError("beam_walk: valid (>= N,) and qop (B, W) float32 expected")
    if starts.dim() == 2 and starts.shape[0] != b:
        raise ValueError("beam_walk: per-query starts must be (B, S)")
    width = {0: rows.shape[1], 1: rows.shape[1], 2: rows.shape[1], 3: rows.shape[1] * 256,
             4: rows.shape[1] + 3}[t]
    if qop.shape[1] != width:
        raise ValueError(f"beam_walk: qop width {qop.shape[1]} != {width}")
    want_dtype = {0: torch.float32, 1: torch.bfloat16, 2: torch.int8, 3: torch.uint8,
                  4: torch.float32}[t]
    if rows.dtype != want_dtype:
        raise ValueError(f"beam_walk: {tier} rows must be {want_dtype}, got {rows.dtype}")
    aux = tuple(aux) + (None,) * (3 - len(aux))
    # the per-row arrays each tier's keys read (csrc/beam_search.cu aux_use)
    needs = {0: (), 1: (0, 1, 2) if code == 2 else (0, 1), 2: (0, 1) if code == 2 else (0,),
             3: (0, 1, 2) if code == 2 else (0, 1),
             4: (0, 1, 2) if _CODE_METRIC[code] in D.TERMS else ()}[t]
    if any(aux[i] is None or aux[i].shape != (aux[i].shape[0],) or aux[i].shape[0] < n
           or aux[i].dtype != torch.float32 for i in needs) or rows.shape[0] < n:
        raise ValueError(f"beam_walk: the {tier} tier needs rows and f32 aux arrays covering "
                         f"all {n} graph nodes")
    if t in (0, 1, 2) and (qconst is None or qconst.shape != (b,)):
        raise ValueError("beam_walk: qconst (B,) expected")
    _cuda.require_cuda("beam_walk", qop, qconst, rows, graph, starts, valid, *aux)
    # the bitmap route's visited set (zeroed); the table route keeps it on chip
    words = (n + 31) // 32 if cap == 0 else 0
    visited = torch.zeros((b, words), dtype=torch.int32, device=qop.device) if words else None
    keys = torch.empty((b, beam), dtype=torch.float32, device=qop.device)
    ids = torch.empty((b, beam), dtype=torch.int32, device=qop.device)
    scanned = torch.empty((b,), dtype=torch.int32, device=qop.device)
    _cuda.call(
        "lt_beam_search", t, qop.data_ptr(), qop.shape[1], _cuda.ptr(qconst), rows.data_ptr(),
        rows.shape[1], _cuda.ptr(aux[0]), _cuda.ptr(aux[1]), _cuda.ptr(aux[2]),
        graph.data_ptr(), n, r, starts.data_ptr(), starts.shape[-1],
        starts.shape[1] if starts.dim() == 2 else 0, valid.data_ptr(), b, beam, max_steps,
        expand, code, fresh, cap, _cuda.ptr(visited), words, keys.data_ptr(), ids.data_ptr(),
        scanned.data_ptr(), smem, _cuda.stream_of(qop),
    )
    beam_walk.launches += 1
    return keys, ids, scanned


beam_walk.launches = 0


def _rinv(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(max(x, 1e-30)): the cosine tiers' per-row rsqrt factor."""
    return 1.0 / torch.sqrt(torch.clamp_min(x.to(torch.float32), 1e-30))


def beam_operands(tier: str, q: torch.Tensor, *args, kind: str) -> dict:
    """The torch glue of a guidance tier: beam_walk's per-query operand, its
    per-query constant, the rows and the per-row aux arrays, from the
    queries ``q`` (B, D) and the tier's arrays ``args``:

      * "f32" (corpus,): the exact rows; qconst = |q|^2;
      * "bf16" (dev16, mean, xm, xc_sq, xsq_true): the centred bf16 copy
        with K2's corrections; the operand is bf16(q - mean), qconst = q.mean;
      * "sq8" (codes, lo, scale, row_sq): q.x_hat = (q * scale).c +
        q.(lo + 128 scale), so the operand is q * scale;
      * "pq" (codes, codebooks, alpha, row_sq): the (B, M, 256) table of
        partial inner products, each row's sum scaled by its ``alpha``;
      * "metric" (MetricRows of the corpus, ``kind`` a domain metric's
        name): the query's lead row with its three terms appended (``q``
        raw rows, transformed here, or MetricRows), the corpus's lead rows
        and terms.

    The cosine keys' 1 / sqrt(max(norm, 1e-30)) is an aux array too, so the
    kernel and its plain version read the same bits."""
    if tier == "metric":
        (space,) = args
        qm = graph_space(q, Metric(kind))
        qterms = (torch.zeros((len(qm), 3), dtype=torch.float32, device=qm.device)
                  if qm.terms is None else qm.terms.T)
        return {"qop": torch.cat([qm.rows, qterms], 1).contiguous(), "qconst": None,
                "rows": space.rows, "aux": () if space.terms is None else tuple(space.terms)}
    q = q.to(torch.float32)
    cos = kind == "cos"
    if tier == "f32":
        (corpus,) = args
        qop = q.contiguous()
        return {"qop": qop, "qconst": (qop * qop).sum(-1), "rows": corpus, "aux": ()}
    if tier == "bf16":
        dev16, mean, xm, xc_sq, xsq_true = args
        qop = (q - mean[None, :]).to(torch.bfloat16).to(torch.float32).contiguous()
        return {"qop": qop, "qconst": (q * mean[None, :]).sum(-1), "rows": dev16,
                "aux": (_f(xm), _f(xc_sq), _rinv(xsq_true) if cos else None)}
    if tier == "sq8":
        codes, lo, scale, row_sq = args
        return {"qop": (q * scale[None, :]).contiguous(),
                "qconst": (q * (lo + 128.0 * scale)[None, :]).sum(-1), "rows": codes,
                "aux": (_f(row_sq), _rinv(row_sq) if cos else None)}
    codes, codebooks, alpha, row_sq = args
    b = q.shape[0]
    m, _, ds = codebooks.shape
    lut = torch.einsum("bms,mks->bmk", q.reshape(b, m, ds), codebooks).reshape(b, m * 256)
    return {"qop": lut.contiguous(), "qconst": None, "rows": codes,
            "aux": (_f(alpha), _f(row_sq), _rinv(row_sq) if cos else None)}


def _walk(tier, q, args, graph, starts, valid, kind, beam, max_steps, expand):
    ops = beam_operands(tier, q, *args, kind=kind)
    return beam_walk(tier, ops["qop"], ops["qconst"], ops["rows"], ops["aux"], graph, starts,
                     valid, code=_KIND_CODE[kind], beam=beam, max_steps=max_steps,
                     expand=_resolve_expand(expand, beam))


_METRIC_KIND = {Metric.IP: "ip", Metric.L2: "l2", Metric.COSINE: "cos"}


def beam_search(q, corpus, graph, starts, valid, *, metric: Metric, beam: int,
                max_steps: int, k: int, expand: int | None = None):
    """Beam search over EXACT keys: the f32 rows ``corpus`` under IP, L2 and
    cosine (the in-place inserts), the metric tier under a domain metric
    (``corpus`` its MetricRows or raw rows; the HNSW search and inserts).
    Returns (keys (B, k), ids (B, k) int32, scanned (B,)): oriented keys best
    first, ids -1 where the pool ran dry."""
    graph_metric_code("beam_search", metric)
    if metric in _METRIC_KIND:
        tier, kind = "f32", _METRIC_KIND[metric]
    else:
        tier, kind = "metric", metric.value
    keys, ids, scanned = _walk(tier, q, (graph_space(corpus, metric),), graph, starts, valid,
                               kind, beam, max_steps, expand)
    k_eff = min(k, beam)
    return keys[:, :k_eff], ids[:, :k_eff], scanned


def beam_search_bf16(q, dev16, mean, xm, xc_sq, xsq_true, graph, starts, valid, *,
                     metric_kind: str, beam: int, max_steps: int, expand: int | None = None):
    """Beam search guided by the resident centred-bf16 copy ``dev16`` with
    K2's rank-1 corrections (``xm``, ``xc_sq``, ``xsq_true`` per row). The
    per-query constants are dropped; the caller rescores the pool exactly.
    Returns (keys (B, beam), ids (B, beam), scanned (B,))."""
    return _walk("bf16", q, (dev16, mean, xm, xc_sq, xsq_true), graph, starts, valid,
                 metric_kind, beam, max_steps, expand)


def beam_search_sq8(q, codes, lo, scale, row_sq, graph, starts, valid, *,
                    metric_kind: str, beam: int, max_steps: int, expand: int | None = None):
    """Beam search guided by SQ8 codes ``codes`` (N, D) int8 (u8 - 128) with
    the rows' true squared norms ``row_sq``."""
    return _walk("sq8", q, (codes, lo, scale, row_sq), graph, starts, valid, metric_kind, beam,
                 max_steps, expand)


def beam_search_pq(q, codes, codebooks, alpha, row_sq, graph, starts, valid, *,
                   metric_kind: str, beam: int, max_steps: int, expand: int | None = None):
    """Beam search guided by PQ codes ``codes`` (N, M) uint8 and
    ``codebooks`` (M, 256, Ds), each row's table sum scaled by its
    least-squares ``alpha``; the L2 and cosine keys use the true squared
    norms ``row_sq``."""
    return _walk("pq", q, (codes, codebooks, alpha, row_sq), graph, starts, valid, metric_kind,
                 beam, max_steps, expand)


# ── K18: the entry scan (K1 or K6, then K5) ──────────────────────────────


def entry_scan(q: torch.Tensor, sample_ct: dict, sample_ids: torch.Tensor, valid: torch.Tensor,
               *, metric: Metric, s: int) -> torch.Tensor:
    """Per-query graph entry points: the metric's distance kernel (K1 for
    IP, L2 and cosine, K6a or K6c under a domain metric) scores the fixed
    node sample (its corpus transform ``sample_ct``, ids ``sample_ids``
    int32) and K5 keeps each query's top ``s``. Returns (B, s) int32 node
    ids."""
    qt = D.query_transform(q.to(torch.float32), metric)
    keys = metric_keys(qt, sample_ct, valid[sample_ids.long()], metric)
    _, idx = topk_select(keys, min(s, sample_ids.shape[0]))
    return sample_ids[idx.long()].to(torch.int32)


# ── K20: the robust prune ────────────────────────────────────────────────


def robust_prune_batch(
    point_keys: np.ndarray,  # (BS, L) key(point, candidate), bigger = closer
    pair_keys: np.ndarray,  # (BS, L, L) key(candidate_i, candidate_j)
    cand_ids: np.ndarray,  # (BS, L) int, -1 padded
    alpha: float,
    r: int,
    descending: bool = False,
) -> np.ndarray:
    """Vectorized alpha-pruning on the host (reference: diskann.rs robust
    prune :820-875), in key space (bigger = closer): for ascending metrics
    drop c when key(p, c) < alpha * key(kept, c); for inner product
    (``descending``) the rule is additive in log space, key(p, c) <
    key(kept, c) - ln(alpha). Returns (BS, r) pruned ids, -1 padded."""
    ln_alpha = float(np.log(max(alpha, 1.0)))
    bs, l = point_keys.shape
    order = np.argsort(-point_keys, axis=1, kind="stable")
    out = np.full((bs, r), -1, dtype=np.int64)
    out_n = np.zeros(bs, dtype=np.int64)
    pruned = cand_ids < 0  # (BS, L) candidates already dropped
    pruned |= ~np.isfinite(point_keys)

    for rank in range(l):
        idx = order[:, rank]  # (BS,)
        rows = np.arange(bs)
        active = (~pruned[rows, idx]) & (out_n < r)
        sel_rows = rows[active]
        if len(sel_rows) == 0:
            continue
        sel_idx = idx[active]
        out[sel_rows, out_n[sel_rows]] = cand_ids[sel_rows, sel_idx]
        out_n[sel_rows] += 1
        pruned[sel_rows, sel_idx] = True
        kept_keys = pair_keys[sel_rows, sel_idx, :]  # (n_sel, L)
        if descending:
            dominated = point_keys[sel_rows] < kept_keys - ln_alpha
        else:
            dominated = point_keys[sel_rows] < alpha * kept_keys
        pruned[sel_rows] |= dominated
    return out


def _table_seq(rows: torch.Tensor, metric: Metric) -> torch.Tensor:
    """(BS, M, D) rows -> (BS, M, M) pair table in K20's order, each entry a
    sequential chain over the dimensions of separately rounded operations:
    dot products (IP, L2, cosine; correlation and Hellinger over their lead
    rows), or the sum or max of an elementwise metric's terms."""
    bs, m, d = rows.shape
    g = torch.zeros((bs, m, m), dtype=torch.float32, device=rows.device)
    for j in range(d):
        col = rows[:, :, j]
        u, v = col[:, :, None], col[:, None, :]
        if metric is Metric.CHEBYSHEV:
            g = torch.maximum(g, (u - v).abs())
        elif metric in (Metric.L1, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON):
            g = g + _elem_terms(metric, u, v)
        else:
            g = g + u * v
    return g


def _robust_prune_dev_plain(point, pair, cand, alpha: float, r: int, descending: bool):
    """The alpha prune over ranks of a stable descending sort of the point
    keys (the JAX package's _robust_prune_dev). Returns (BS, r) int32."""
    bs, l = point.shape
    dev = point.device
    order = torch.sort(-point, dim=1, stable=True).indices
    pruned = (cand < 0) | ~torch.isfinite(point)
    out = torch.full((bs, r), -1, dtype=torch.int32, device=dev)
    out_n = torch.zeros(bs, dtype=torch.long, device=dev)
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    ln_alpha = torch.tensor(_ln_alpha(alpha), dtype=torch.float32, device=dev)
    rows = torch.arange(bs, device=dev)
    for rank in range(l):
        idx = order[:, rank]
        active = ~pruned[rows, idx] & (out_n < r)
        slot = out_n.clamp_max(r - 1)
        out[rows, slot] = torch.where(active, cand[rows, idx].to(torch.int32), out[rows, slot])
        pruned[rows, idx] |= active
        kept = pair[rows, idx, :]
        dom = point < (kept - ln_alpha) if descending else point < alpha_t * kept
        pruned |= dom & active[:, None]
        out_n += active.long()
    return out


def _ln_alpha(alpha: float) -> float:
    return float(np.log(np.float32(max(alpha, 1.0))))


def _prune_keys_plain(x, node_ids, cand_ids, code: int):
    """Plain version of K20's keys: (point (BS, L) or None, pair (BS, L, L))
    from the rows of max(id, 0) (``x`` rows, or MetricRows under a domain
    metric), the node row last in the table, key(i, j) with row i on the
    query side."""
    cand = cand_ids.long().clamp_min(0)
    l = cand.shape[1]
    idx = cand if node_ids is None else torch.cat([cand, node_ids.long().clamp_min(0)[:, None]], 1)
    if isinstance(x, MetricRows):
        t = x[idx]  # (BS, M, W) rows, (3, BS, M) terms
        rows = t.rows
        if x.metric is Metric.HAVERSINE:
            d = D.haversine(rows[:, :, None, 0], rows[:, :, None, 1], rows[:, None, :, 0],
                            rows[:, None, :, 1])
        else:
            d = D.finish(x.metric, _table_seq(rows, x.metric), t.side(2), t.side(1))
        keys = -d
    else:
        g = _table_seq(x[idx].to(torch.float32), _CODE_METRIC[code])
        sq = torch.diagonal(g, dim1=1, dim2=2)
        keys = _pairwise_key(g, sq[:, :, None], sq[:, None, :], code)
    return (None if node_ids is None else keys[:, l, :l]), keys[:, :l, :l]


def robust_prune_plain(x, node_ids, cand_ids, *, metric: Metric, r: int = 0, alpha: float = 1.0,
                       descending: bool = False, keys_only: bool = False):
    """Plain version of :func:`robust_prune`, on the inputs' device."""
    code = graph_metric_code("robust_prune", metric)
    point, pair = _prune_keys_plain(graph_space(x, metric), node_ids, cand_ids, code)
    if keys_only:
        return point, pair
    cand = cand_ids.long()
    bad = (cand < 0) | (cand == node_ids.long()[:, None])
    point = torch.where(bad, NEG_INF, point)
    return _robust_prune_dev_plain(point, pair, torch.where(bad, -1, cand), alpha, r, descending)


def robust_prune(x, node_ids: Optional[torch.Tensor], cand_ids: torch.Tensor, *,
                 metric: Metric, r: int = 0, alpha: float = 1.0, descending: bool = False,
                 keys_only: bool = False):
    """K20 over a chunk of nodes ``node_ids`` (BS,) int32 with candidates
    ``cand_ids`` (BS, L) int32 (-1 padded) in the rows ``x``: (N, D) f32
    under IP, L2 and cosine; under a domain metric its MetricRows (or raw
    rows, transformed here).

    Default mode (the JAX package's _prune_chunk_kernel): point keys of each
    node against its candidates (-inf for -1 and self), pair keys among the
    candidates, then the alpha prune. Returns (BS, r) int32, -1 padded.

    ``keys_only`` (candidate_pair_keys, with the point keys when node ids are
    given): returns (point (BS, L) or None, pair (BS, L, L)) f32 for the
    host prune; rows of -1 candidates are row 0's, as the JAX gather gives.
    """
    code = graph_metric_code("robust_prune", metric)
    x = graph_space(x, metric)
    if x.device.type == "cpu":
        return robust_prune_plain(x, node_ids, cand_ids, metric=metric, r=r, alpha=alpha,
                                  descending=descending, keys_only=keys_only)
    x, terms = (x.rows, x.terms) if isinstance(x, MetricRows) else (x, None)
    bs, l = cand_ids.shape
    n, d = x.shape
    if x.dtype != torch.float32 or cand_ids.dtype != torch.int32 or (
            node_ids is not None and (node_ids.dtype != torch.int32 or node_ids.shape != (bs,))):
        raise ValueError("robust_prune: x (N, D) f32, node_ids (BS,) and cand_ids (BS, L) int32")
    if not keys_only and (node_ids is None or not 1 <= r):
        raise ValueError("robust_prune: the prune needs node ids and r >= 1")
    _cuda.require_cuda("robust_prune", x, terms, node_ids, cand_ids)
    out = point = pair = None
    if keys_only:
        pair = torch.empty((bs, l, l), dtype=torch.float32, device=x.device)
        if node_ids is not None:
            point = torch.empty((bs, l), dtype=torch.float32, device=x.device)
    else:
        out = torch.empty((bs, max(r, 1)), dtype=torch.int32, device=x.device)
    if bs:
        _cuda.call(
            "lt_robust_prune", x.data_ptr(), n, d, _cuda.ptr(terms), _cuda.ptr(node_ids),
            cand_ids.data_ptr(), bs, l, code, r, float(np.float32(alpha)), _ln_alpha(alpha),
            int(descending), int(keys_only), _cuda.ptr(out), _cuda.ptr(point), _cuda.ptr(pair),
            _cuda.stream_of(x),
        )
        robust_prune.launches += 1
    return (point, pair) if keys_only else out


robust_prune.launches = 0


def prune_gathered(node_rows: torch.Tensor, cand_rows: torch.Tensor, node_ids, cand_ids,
                   alpha: float, *, metric: Metric, r: int, descending: bool) -> np.ndarray:
    """K20 over pre-gathered rows (the JAX package's prune_gathered): the
    (m, D) node rows and their (m, L, D) candidate rows, gathered from the
    host mirror by a caller whose corpus has no device copy, form one small
    local corpus; a candidate that is -1 or the node itself is dropped.
    Returns the (m, r) pruned global ids, -1 padded."""
    m, l, d = cand_rows.shape
    dev = node_rows.device
    node_ids = torch.as_tensor(np.asarray(node_ids, dtype=np.int64), device=dev)
    cand = torch.as_tensor(np.asarray(cand_ids, dtype=np.int64), device=dev)
    x = torch.cat([node_rows.reshape(m, d), cand_rows.reshape(m * l, d)]).to(torch.float32)
    local = m + torch.arange(m * l, device=dev).reshape(m, l)
    local = torch.where((cand < 0) | (cand == node_ids[:, None]), -1, local).to(torch.int32)
    out = robust_prune(x.contiguous(), torch.arange(m, dtype=torch.int32, device=dev),
                       local.contiguous(), metric=metric, r=r, alpha=alpha,
                       descending=descending).long()
    glob = torch.where(out >= m, cand.reshape(-1)[(out - m).clamp_min(0)], -1)
    return glob.cpu().numpy()


def candidate_pair_keys(x, cand_ids: torch.Tensor, metric: Metric) -> torch.Tensor:
    """(BS, L, L) similarity keys among each point's candidates (rows of
    max(id, 0)), for the host prune."""
    return robust_prune(x, None, cand_ids, metric=metric, keys_only=True)[1]


# ── K19: the exact top-L scan ────────────────────────────────────────────


def topl_keys_plain(q, q_ids, x, qsq, xsq, n_real: int, mode: int, lo: int,
                    hi: int) -> torch.Tensor:
    """The keys (B, hi - lo) of rows [lo, hi) that :func:`topl_scan_plain`
    selects from: the product's (or, in the metric mode, the metric's plain
    distances over the transform, as the FLAT scan's plain version forms
    them), NaN, each query's own row and rows >= ``n_real`` at -inf."""
    blk = x[lo:hi]
    dev = q.device
    if mode == TOPL_METRIC:
        ok = torch.ones(len(blk), dtype=torch.bool, device=dev)
        kb = metric_keys_plain(q.transform(), blk.transform(), ok, q.metric)
    else:
        ip = q @ blk.T
        if mode == TOPL_DOT:
            kb = ip
        elif mode == TOPL_COS:
            kb = _pairwise_key(ip, qsq[:, None], xsq[None, lo:hi], 2)
        else:
            d2 = (qsq[:, None] + xsq[None, lo:hi]) - 2.0 * ip
            kb = -d2 if mode == TOPL_L2_RAW else -torch.clamp_min(d2, 0.0)
    bids = torch.arange(lo, lo + len(blk), device=dev)
    return torch.where((bids[None, :] == q_ids.long()[:, None]) | (bids[None, :] >= n_real),
                       NEG_INF, _nan_to_neg_inf(kb))


def topl_scan_plain(q, q_ids, x, qsq, xsq, n_real: int, l: int, mode: int,
                    block: int = 131072):
    """Plain version of :func:`topl_scan`: the keys a block of rows at a
    time (:func:`topl_keys_plain`) with a carried top-L merge (the lower row
    id first between equal keys)."""
    b = len(q)
    dev = q.device
    keys = torch.full((b, 0), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.zeros((b, 0), dtype=torch.long, device=dev)
    for lo in range(0, len(x), block):
        hi = min(lo + block, len(x))
        kb = topl_keys_plain(q, q_ids, x, qsq, xsq, n_real, mode, lo, hi)
        keys, pos = _stable_top(torch.cat([keys, kb], 1), l)
        bids = torch.arange(lo, hi, device=dev)
        ids = torch.cat([ids, bids[None, :].expand(b, -1)], 1).gather(1, pos)
    return keys, ids.to(torch.int32)


def topl_scan(q, q_ids: torch.Tensor, x, qsq: Optional[torch.Tensor],
              xsq: Optional[torch.Tensor], n_real: int, l: int, mode: int):
    """K19: the exact top ``l`` rows of ``x`` for each query of ``q``, the
    query's own row ``q_ids`` (B,) int32 and rows >= ``n_real`` masked; keys
    by ``mode`` (TOPL_*). Modes 0-3: ``q`` (B, D) and ``x`` (N, D) f32,
    ``qsq``/``xsq`` squared norms for the L2 and cosine modes. TOPL_METRIC:
    ``q`` and ``x`` MetricRows of one domain metric, keys -distance. Returns
    (keys (B, l) f32, ids (B, l) int32), best first, the lower id first
    between equal keys."""
    if q.device.type == "cpu":
        return topl_scan_plain(q, q_ids, x, qsq, xsq, n_real, l, mode)
    qterms = xterms = None
    code = 0
    if mode == TOPL_METRIC:
        code = graph_metric_code("topl_scan", q.metric)
        q, qterms, x, xterms = q.rows, q.terms, x.rows, x.terms
    b, d = q.shape
    n = x.shape[0]
    if not 1 <= l <= min(TOPL_MAX_L, n) or x.shape[1] != d:
        raise ValueError(f"topl_scan: need 1 <= l <= min({TOPL_MAX_L}, N) and matching D")
    if q.dtype != torch.float32 or x.dtype != torch.float32 or q_ids.dtype != torch.int32:
        raise ValueError("topl_scan: q, x float32 and q_ids int32 expected")
    if mode in (TOPL_L2_RAW, TOPL_L2, TOPL_COS) and (qsq is None or xsq is None):
        raise ValueError("topl_scan: the L2 and cosine modes need qsq and xsq")
    if mode in (TOPL_DOT, TOPL_METRIC):
        qsq = xsq = None
    _cuda.require_cuda("topl_scan", q, q_ids, x, qsq, xsq, qterms, xterms)
    lib = _cuda.library()
    spans = int(lib.lt_topl_spans(b, n, d, l, mode, code))
    entries = int(lib.lt_topl_scratch(b, n, d, l, mode, code))
    if spans < 1 or entries < 1:
        raise RuntimeError(f"topl_scan: no plan for B={b}, N={n}, D={d}, L={l}")
    lists = torch.empty(entries, dtype=torch.int64, device=q.device)  # the lists' entries
    part_keys = torch.empty((b, spans * l), dtype=torch.float32, device=q.device)
    part_ids = torch.empty((b, spans * l), dtype=torch.int32, device=q.device)
    _cuda.call("lt_topl_scan", q.data_ptr(), q_ids.data_ptr(), x.data_ptr(), _cuda.ptr(qsq),
               _cuda.ptr(xsq), _cuda.ptr(qterms), _cuda.ptr(xterms), b, n, d, n_real, l,
               spans, mode, code, lists.data_ptr(), part_keys.data_ptr(), part_ids.data_ptr(),
               _cuda.stream_of(q))
    topl_scan.launches += 1
    return topk_select(part_keys, l, ids=part_ids)


topl_scan.launches = 0


def _norm_rows(rows: torch.Tensor) -> torch.Tensor:
    return rows / torch.clamp_min(torch.linalg.norm(rows, dim=1, keepdim=True), 1e-30)


def knn_candidates(corpus_rows, metric: Metric, *, l: int, chunk: int = 4096) -> np.ndarray:
    """Exact top-``l`` neighbours (construction space) of every row through
    K19, a query chunk per launch: ``corpus_rows`` (N, D) rows, or under a
    domain metric its MetricRows. Returns (N, l) int32, -1 padded."""
    rows = graph_space(corpus_rows, metric)
    n = len(rows)
    l_eff = min(l, n - 1)
    xsq = None
    if metric is Metric.L2:
        mode = TOPL_L2_RAW
        xsq = (rows * rows).sum(-1)
    elif metric is Metric.COSINE:
        mode, rows = TOPL_DOT, _norm_rows(rows).contiguous()
    else:
        mode = TOPL_DOT if metric is Metric.IP else TOPL_METRIC
    out = np.full((n, l), -1, dtype=np.int32)
    if l_eff <= 0:
        return out
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q_ids = torch.arange(lo, hi, dtype=torch.int32, device=rows.device)
        keys, ids = topl_scan(rows[lo:hi], q_ids, rows, None if xsq is None else xsq[lo:hi],
                              xsq, n, l_eff, mode)
        ids = torch.where(torch.isfinite(keys) & (ids < n), ids, -1)
        out[lo:hi, :l_eff] = ids.cpu().numpy()
    return out


def exact_knn_graph(rows, metric: Metric, r: int, chunk: int = 4096) -> np.ndarray:
    """Exact kNN graph (self excluded) of ``rows`` under ``metric``'s
    pairwise keys, for the HNSW upper layers: K19 with L = min(r, n - 1).
    Returns (n, r) int32, -1 padded."""
    rows = graph_space(rows, metric)
    n = len(rows)
    take = min(r, n - 1)
    out = np.full((n, r), -1, dtype=np.int32)
    if take <= 0:
        return out
    mode = {Metric.IP: TOPL_DOT, Metric.L2: TOPL_L2, Metric.COSINE: TOPL_COS}.get(metric,
                                                                                 TOPL_METRIC)
    sq = None if mode in (TOPL_DOT, TOPL_METRIC) else (rows * rows).sum(-1)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q_ids = torch.arange(lo, hi, dtype=torch.int32, device=rows.device)
        _, ids = topl_scan(rows[lo:hi], q_ids, rows, None if sq is None else sq[lo:hi], sq,
                           n, take, mode)
        out[lo:hi, :take] = ids.cpu().numpy()
    return out


# ── the Vamana build ─────────────────────────────────────────────────────


def _reverse_candidates(forward: np.ndarray, n: int, width: int) -> np.ndarray:
    """(N, width) reverse-edge requesters per node. Capping is deterministic
    first-come by forward-edge order (no random subsampling)."""
    r = forward.shape[1]
    flat_pts = np.repeat(np.arange(forward.shape[0], dtype=np.int64), r)
    flat_nbrs = forward.ravel().astype(np.int64)
    ok = (flat_nbrs >= 0) & (flat_nbrs < n)
    pts, nbrs = flat_pts[ok], flat_nbrs[ok]
    out = np.full((n, width), -1, dtype=np.int32)
    if len(nbrs) == 0:
        return out
    order = np.argsort(nbrs, kind="stable")
    pts, nbrs = pts[order], nbrs[order]
    uniq, group_start, counts = np.unique(nbrs, return_index=True, return_counts=True)
    rank = np.arange(len(nbrs)) - np.repeat(group_start, counts)
    keep = rank < width
    out[nbrs[keep], rank[keep]] = pts[keep]
    return out


def _mask_dup_cands(cands: np.ndarray) -> None:
    """In-place: set duplicate candidate ids within each row to -1 (keeps the
    first occurrence). Vectorized — no per-row Python loops."""
    srt_idx = np.argsort(cands, axis=1, kind="stable")
    srt = np.take_along_axis(cands, srt_idx, axis=1)
    dup_sorted = np.zeros_like(srt, dtype=bool)
    dup_sorted[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    dup = np.zeros_like(cands, dtype=bool)
    np.put_along_axis(dup, srt_idx, dup_sorted, axis=1)
    cands[dup] = -1


def _construction_space(metric: Metric, rows):
    """Graph construction geometry: inner product builds in L2 over
    row-normalised rows (the alpha prune needs a triangle inequality to keep
    long-range edges); the other metrics build in their own space (a domain
    metric over its MetricRows, graph_space)."""
    if metric is Metric.IP:
        return Metric.L2, _norm_rows(rows.to(torch.float32))
    return metric, graph_space(rows, metric)


def _clock(phases: Optional[dict], name: str, t0: float) -> float:
    """Add the seconds since ``t0`` (after a device sync) to phases[name]."""
    if phases is None:
        return t0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    now = time.perf_counter()
    phases[name] = phases.get(name, 0.0) + now - t0
    return now


def build_vamana(corpus_rows, metric: Metric, *, r: int = 16, l_build: int = 64,
                 alpha: float = 1.2, seed: int = 42, chunk: int = 4096,
                 phases: Optional[dict] = None) -> np.ndarray:
    """Vamana-quality construction with no insert-order dependency chain:

      1. exact top-``max(l_build, 2r)`` candidates of every node (K19);
      2. pass A: K20 prunes each node's candidates plus 8 random long-range
         ones (numpy ``default_rng(seed)``, the JAX package's draws) into
         forward edges;
      3. pass B: forward and reverse candidates merged and pruned again (K20).

    Returns (N, r) int32 adjacency, -1 padded. ``phases`` (optional) gathers
    the seconds of each stage."""
    t0 = time.perf_counter()
    metric, rows = _construction_space(metric, corpus_rows)
    n = len(rows)
    dev = rows.device
    rng = np.random.default_rng(seed)
    if n <= r + 1:
        graph = np.full((n, r), -1, dtype=np.int32)
        for i in range(n):
            others = [j for j in range(n) if j != i]
            graph[i, : len(others)] = others
        return graph

    l = max(l_build, 2 * r)
    n_rand = min(8, max(n - l - 1, 0))
    cand_ids = knn_candidates(rows, metric, l=l, chunk=chunk)
    t0 = _clock(phases, "knn_candidates", t0)
    descending = not metric.ascending

    def prune(lo: int, cands: np.ndarray) -> np.ndarray:
        ids = torch.arange(lo, lo + len(cands), dtype=torch.int32, device=dev)
        return robust_prune(rows, ids, torch.from_numpy(np.ascontiguousarray(cands)).to(dev),
                            metric=metric, r=r, alpha=alpha, descending=descending).cpu().numpy()

    forward = np.empty((n, r), dtype=np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        cands = cand_ids[lo:hi]
        if n_rand:
            extra = rng.integers(0, n, size=(hi - lo, n_rand), dtype=np.int64).astype(np.int32)
            cands = np.concatenate([cands, extra], axis=1)
        forward[lo:hi] = prune(lo, cands)
    t0 = _clock(phases, "prune_a", t0)

    rev = _reverse_candidates(forward, n, width=r)
    graph = np.empty((n, r), dtype=np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        cands = np.concatenate([forward[lo:hi], rev[lo:hi]], axis=1)
        _mask_dup_cands(cands)
        graph[lo:hi] = prune(lo, cands)
    _clock(phases, "prune_b", t0)
    return graph


# ── in-place updates ─────────────────────────────────────────────────────


def _host_keys(rows, node_ids: np.ndarray, cands: np.ndarray, metric: Metric):
    """K20's keys mode for the host prune: (point (m, L), pair (m, L, L))."""
    dev = rows.device
    point, pair = robust_prune(
        rows, torch.from_numpy(node_ids.astype(np.int32)).to(dev),
        torch.from_numpy(cands.astype(np.int32)).to(dev), metric=metric, keys_only=True)
    point = np.where(cands >= 0, point.cpu().numpy(), -np.inf).astype(np.float32)
    return point, pair.cpu().numpy()


def _link_points_batch(graph: np.ndarray, graph_dev: torch.Tensor, ids: np.ndarray,
                       corpus_rows, starts: torch.Tensor, valid: torch.Tensor, *,
                       metric: Metric, r: int, l_build: int, alpha: float) -> torch.Tensor:
    """Link one batch of points into the graph: the exact beam (expand 1;
    ``corpus_rows`` in construction space, graph_space) finds candidates,
    K20 forms their pair keys and the host prune picks the points' own
    lists; reverse edges go into the chosen neighbours, whose lists re-prune
    on overflow (reference: diskann.rs:1084 / :1496).
    ``graph_dev`` is the device adjacency; only mutated rows are written
    back. Returns ``graph_dev``."""
    dev = corpus_rows.device
    ids = np.asarray(ids, dtype=np.int64)
    q = corpus_rows[torch.from_numpy(ids).to(dev)]
    keys, cands, _ = beam_search(q, corpus_rows, graph_dev, starts, valid, metric=metric,
                                 beam=l_build, max_steps=l_build * 2, k=l_build, expand=1)
    keys = keys.cpu().numpy()
    cands = cands.cpu().numpy().astype(np.int64)
    # drop self-candidates
    self_mask = cands == ids[:, None]
    cands = np.where(self_mask, -1, cands)
    keys = np.where(self_mask, -np.inf, keys).astype(np.float32)
    pair = candidate_pair_keys(corpus_rows, torch.from_numpy(cands.astype(np.int32)).to(dev),
                               metric).cpu().numpy()
    pruned = robust_prune_batch(keys, pair, cands, alpha, r, descending=not metric.ascending)
    graph[ids] = pruned.astype(np.int32)
    touched: set[int] = set(int(x) for x in ids)
    overflow: dict[int, list[int]] = {}
    placed: set[int] = set()
    # reverse edges: group (point -> nbr) pairs by nbr, rank within each
    # group, and place the rank-th point into the nbr's rank-th free slot
    flat_pts = np.repeat(ids, pruned.shape[1])
    flat_nbrs = pruned.ravel().astype(np.int64)
    ok = flat_nbrs >= 0
    pts, nbrs = flat_pts[ok], flat_nbrs[ok]
    if len(nbrs):
        order = np.argsort(nbrs, kind="stable")
        pts, nbrs = pts[order], nbrs[order]
        uniq, group_start, counts = np.unique(nbrs, return_index=True, return_counts=True)
        rank = np.arange(len(nbrs)) - np.repeat(group_start, counts)
        u_of_pair = np.repeat(np.arange(len(uniq)), counts)
        rows_u = graph[uniq]  # (U, r) snapshot
        free_counts = (rows_u < 0).sum(axis=1)
        slot_pos = np.argsort(rows_u >= 0, axis=1, kind="stable")
        fits = rank < free_counts[u_of_pair]
        if fits.any():
            tgt_nbrs = nbrs[fits]
            tgt_slots = slot_pos[u_of_pair[fits], rank[fits]]
            graph[tgt_nbrs, tgt_slots] = pts[fits]
            placed.update(int(p) for p in pts[fits])
            touched.update(int(x) for x in tgt_nbrs)
        for p, nb in zip(pts[~fits], nbrs[~fits]):
            overflow.setdefault(int(nb), []).append(int(p))
    if overflow:
        _reprune_nodes(graph, overflow, corpus_rows, metric, alpha, r)
        touched.update(overflow.keys())
        for node, reqs in overflow.items():
            survivors = set(int(x) for x in graph[node] if x >= 0)
            placed.update(req for req in reqs if req in survivors)
    # reachability floor: a point whose reverse edges were all pruned gets a
    # forced back-edge from its closest neighbour
    for row_i, point in enumerate(ids):
        if int(point) in placed:
            continue
        nearest = next((int(x) for x in pruned[row_i] if x >= 0), -1)
        if nearest >= 0:
            graph[nearest, r - 1] = point
            touched.add(nearest)
    rows = np.fromiter(touched, dtype=np.int64, count=len(touched))
    graph_dev[torch.from_numpy(rows).to(dev)] = torch.from_numpy(graph[rows]).to(dev)
    return graph_dev


def insert_points(graph: np.ndarray, new_ids: np.ndarray, corpus_rows,
                  starts: torch.Tensor, live_mask: np.ndarray, *, metric: Metric, r: int,
                  l_build: int, alpha: float, batch: int = 1024) -> np.ndarray:
    """In-place insert (IP-DiskANN, reference diskann.rs:1496): grow the
    adjacency to cover ``corpus_rows`` and link the new points a batch at a
    time. Returns the (possibly reallocated) graph."""
    metric, corpus_rows = _construction_space(metric, corpus_rows)
    dev = corpus_rows.device
    n_total = len(corpus_rows)
    if n_total > graph.shape[0]:
        grown = np.full((n_total, graph.shape[1]), -1, dtype=np.int32)
        grown[: graph.shape[0]] = graph
        graph = grown
    valid = torch.from_numpy(np.ascontiguousarray(live_mask[:n_total])).to(dev)
    graph_dev = torch.from_numpy(graph).to(dev)
    starts = starts.to(dev).to(torch.int32)
    for i in range(0, len(new_ids), batch):
        graph_dev = _link_points_batch(
            graph, graph_dev, new_ids[i : i + batch], corpus_rows, starts, valid,
            metric=metric, r=r, l_build=l_build, alpha=alpha)
    return graph


def _repair_candidates(graph: np.ndarray, dm: np.ndarray, chunk: np.ndarray,
                       width: int) -> np.ndarray:
    """Repair candidates of each node in ``chunk``: its live neighbours, then
    the live out-neighbours (not itself) of its deleted neighbours, in list
    order, first occurrence kept, the first ``width``. (m, width) int64."""
    g = graph[chunk].astype(np.int64)  # (m, r)
    ok = g >= 0
    dead = ok & dm[np.maximum(g, 0)]
    kept = np.where(ok & ~dead, g, -1)
    nb = graph[np.maximum(g, 0)].astype(np.int64)  # (m, r, r)
    st_ok = dead[:, :, None] & (nb >= 0) & ~dm[np.maximum(nb, 0)] & (nb != chunk[:, None, None])
    merged = np.concatenate([kept, np.where(st_ok, nb, -1).reshape(len(chunk), -1)], axis=1)
    _mask_dup_cands(merged)
    order = np.argsort(merged < 0, axis=1, kind="stable")  # live entries first, in order
    merged = np.take_along_axis(merged, order, axis=1)[:, :width]
    if merged.shape[1] < width:
        merged = np.pad(merged, ((0, 0), (0, width - merged.shape[1])), constant_values=-1)
    return merged


def repair_deleted_edges(graph: np.ndarray, deleted_mask: np.ndarray, corpus_rows,
                         *, metric: Metric, r: int, alpha: float, batch: int = 1024) -> int:
    """Delete repair (IP-DiskANN, reference diskann.rs:1337 + Alg-6
    consolidation :502-560): every live node with an edge into a deleted node
    re-prunes its list over its live neighbours plus the deleted nodes'
    out-neighbourhoods (K20's keys, the host prune). Deleted nodes' lists
    are cleared. Returns the number of nodes repaired."""
    metric, corpus_rows = _construction_space(metric, corpus_rows)
    n = graph.shape[0]
    dm = np.zeros(n, dtype=bool)
    dm[: min(len(deleted_mask), n)] = deleted_mask[: min(len(deleted_mask), n)]
    if not dm.any():
        return 0
    safe = np.maximum(graph, 0)
    edge_to_deleted = (graph >= 0) & dm[safe]
    affected = np.nonzero(edge_to_deleted.any(axis=1) & ~dm)[0]
    for i in range(0, len(affected), batch):
        chunk = affected[i : i + batch]
        cands = _repair_candidates(graph, dm, chunk, 3 * r)
        point, pair = _host_keys(corpus_rows, chunk, cands, metric)
        pruned = robust_prune_batch(point, pair, cands, alpha, r,
                                    descending=not metric.ascending)
        graph[chunk] = pruned.astype(np.int32)
    graph[dm] = -1
    return len(affected)


def reconnect_orphans(graph: np.ndarray, live_mask: np.ndarray, corpus_rows,
                      starts: torch.Tensor, *, metric: Metric, r: int, l_build: int,
                      alpha: float) -> int:
    """Re-link live nodes with zero in-degree (restored-from-tombstone rows
    or stitching casualties) so they stay reachable. Returns #relinked."""
    n = graph.shape[0]
    flat = graph[graph >= 0]
    indeg = np.bincount(flat, minlength=n) if len(flat) else np.zeros(n, dtype=np.int64)
    live = np.zeros(n, dtype=bool)
    live[: min(len(live_mask), n)] = live_mask[: min(len(live_mask), n)]
    orphans = np.nonzero(live & (indeg == 0))[0]
    orphans = orphans[~np.isin(orphans, starts.cpu().numpy())]
    if len(orphans) == 0:
        return 0
    insert_points(graph, orphans, corpus_rows, starts, live,
                  metric=metric, r=r, l_build=l_build, alpha=alpha)
    return len(orphans)


def _reprune_nodes(graph: np.ndarray, overflow: dict[int, list[int]], corpus_rows,
                   metric: Metric, alpha: float, r: int, batch: int = 1024) -> None:
    """Batched alpha re-prune of nodes whose adjacency overflowed with
    reverse edges: candidates = current neighbours + pending requests."""
    nodes = np.fromiter(overflow.keys(), dtype=np.int64)
    c_width = 2 * r
    for i in range(0, len(nodes), batch):
        chunk = nodes[i : i + batch]
        cands = np.full((len(chunk), c_width), -1, dtype=np.int64)
        for row_i, node in enumerate(chunk):
            merged = [x for x in graph[node] if x >= 0]
            for req in overflow[int(node)]:
                if req not in merged and req != node:
                    merged.append(req)
            cands[row_i, : min(len(merged), c_width)] = merged[:c_width]
        point, pair = _host_keys(corpus_rows, chunk, cands, metric)
        pruned = robust_prune_batch(point, pair, cands, alpha, r,
                                    descending=not metric.ascending)
        graph[chunk] = pruned.astype(np.int32)


# ── fetches ──────────────────────────────────────────────────────────────


def fetch_pool_scanned(pool: torch.Tensor, scanned: torch.Tensor) -> tuple[np.ndarray, int]:
    """One device-to-host copy of a beam's pool ids and visit counts.
    Returns (ids (B, P) int64, the most nodes any walk visited)."""
    packed = torch.cat([pool.to(torch.int32), scanned.to(torch.int32)[:, None]], 1).cpu().numpy()
    return packed[:, :-1].astype(np.int64), int(packed[:, -1].max(initial=0))


def fetch_keys_pool_scanned(keys: torch.Tensor, ids: torch.Tensor, scanned: torch.Tensor):
    """One device-to-host copy of an exact beam's (keys, ids, scanned), the
    keys carried as their int32 bits. Returns (keys (B, P) f32, ids (B, P)
    int64, the most nodes any walk visited)."""
    p = ids.shape[1]
    packed = torch.cat([keys.to(torch.float32).contiguous().view(torch.int32),
                        ids.to(torch.int32), scanned.to(torch.int32)[:, None]], 1).cpu().numpy()
    return (np.ascontiguousarray(packed[:, :p]).view(np.float32), packed[:, p : 2 * p].astype(np.int64),
            int(packed[:, -1].max(initial=0)))


# ── search glue of both graph indexes ────────────────────────────────────

# the guidance kind of a metric (beam_operands' ``kind``)
METRIC_KIND = {Metric.IP: "ip", Metric.L2: "l2", Metric.COSINE: "cos"}
# a CPU corpus's visited bitmaps (one bool a node, as the plain walk keeps
# them) may take this much host memory
CPU_BITMAP_BUDGET = 1 << 30


def bitmap_budget(device: torch.device) -> int:
    """Bytes the beam's visited bitmaps may take: an eighth of the device
    budget where ops/scan.DEVICE_BYTES sets one, else of the card's free
    memory, or the CPU budget."""
    from . import scan

    if scan.DEVICE_BYTES > 0:
        return scan.DEVICE_BYTES // 8
    if device.type != "cuda":
        return CPU_BITMAP_BUDGET // 8
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return free // 8


def beam_batch_cap(n: int, device: torch.device) -> int:
    """Largest query sub-batch of a beam over an n-row graph: each walk
    keeps a visited bitmap of n bits on the card (n bools on the CPU), and
    the batch's bitmaps stay within bitmap_budget; floored at 16."""
    per_query = (n + 31) // 32 * 4 if device.type == "cuda" else n
    budget = max(bitmap_budget(device), 1)
    for b in (1024, 256, 64):
        if b * per_query <= budget:
            return b
    return 16


def finalize_ranked(dists: np.ndarray, ids: np.ndarray, k: int, metric: Metric):
    """Order candidates, drop invalid/dup entries, truncate to k."""
    b = dists.shape[0]
    keyed = -dists if metric.ascending else dists
    out_d, out_i = [], []
    for row in range(b):
        order = np.argsort(-keyed[row], kind="stable")
        seen = set()
        dd, ii = [], []
        for j in order:
            rid = int(ids[row, j])
            if rid < 0 or not np.isfinite(keyed[row, j]) or rid in seen:
                continue
            seen.add(rid)
            dd.append(dists[row, j])
            ii.append(rid)
            if len(ii) >= k:
                break
        out_d.append(dd)
        out_i.append(ii)
    width = max((len(x) for x in out_i), default=0)
    d_arr = np.zeros((b, width), dtype=np.float32)
    i_arr = np.full((b, width), -1, dtype=np.int64)
    for row in range(b):
        d_arr[row, : len(out_d[row])] = out_d[row]
        i_arr[row, : len(out_i[row])] = out_i[row]
    return d_arr, i_arr


def entry_sample(corpus, n: int, metric: Metric, device, sample: int, norm_top: int,
                 pinned: Optional[np.ndarray] = None):
    """A fixed entry-scan node sample on the card: (ids int32, the rows'
    corpus transform); ``norm_top`` pins the top-norm band (raw MIPS),
    ``pinned`` adds rows the graph cannot reach (DiskANN's unlinked rows)."""
    ids = entry_sample_ids(n, sample, sq_norms=corpus.host_sq_norms() if norm_top else None,
                           norm_top=norm_top)
    if pinned is not None and len(pinned):
        ids = np.concatenate([ids, np.asarray(pinned, dtype=np.int32)])
    rows = corpus.host_rows(ids.astype(np.int64)).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            D.corpus_transform(torch.from_numpy(rows).to(device), metric))


def merge_tail(coll, corpus, q, k, metric, handle, built_rows, dists, ids):
    """Append the exact top-k of the rows added after the build."""
    if built_rows >= coll.n_rows:
        return dists, ids
    tail_mask = np.zeros(coll.n_rows, dtype=bool)
    tail_mask[built_rows:] = True
    if handle is not None:
        tail_mask &= handle.mask[: coll.n_rows]
    td, ti = corpus.search(q, k, metric, filter_mask=tail_mask)
    if not td.shape[1]:
        return dists, ids
    return (np.concatenate([dists, td.astype(np.float32)], axis=1),
            np.concatenate([ids, ti.astype(np.int64)], axis=1))

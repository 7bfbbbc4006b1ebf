"""Quantizers of the FLAT shortlist indexes (SQ8, PQ, RaBitQ, PolarVec) and
their scans on the card.

Port of lynsedb_tpu/ops/quantize.py. The codecs are the JAX package's numpy
code, so SQ8, RaBitQ and PolarVec encode to the same bytes in both packages;
``PQ.fit`` trains its codebooks with the port's k-means, and ``PQ.encode``
assigns every subspace with K15 ``kmeans_assign`` (the JAX package's
``_pq_assign_all``).

Three hand-written kernels score queries against the codes (reference
behaviour: src/quantizer/mod.rs, storage/{pq,rabitq,polarvec}_mmap.rs):

  * K14 :func:`fwht_rotate` (csrc/fwht_rotate.cu): pad, random signs, the
    orthonormal Walsh-Hadamard transform of the RaBitQ / PolarVec queries;
  * K12 :func:`int8_code_scores` (csrc/int8_code_scores.cu): the query
    quantized to int8 per row, an exact int32 dot with the int8 codes and
    the quantizer's epilogue;

      SQ8      x ~ lo_d + (c+128)*s_d       -> q.x ~ q.lo' + (q*s).c
      RaBitQ   rot(x) ~ alpha * sgn         -> q.x ~ alpha * (rot(q).sgn)
      PolarVec rot(x) ~ lo_r + c*s_r        -> q.x ~ lo_r*sum(rot(q)) + s_r*(rot(q).c)

  * K13 :func:`pq_adc_scores` (csrc/pq_adc_scores.cu): the (M, 256) lookup
    table of one query and a gather-sum over each row's M codes.

K12 and K13 write oriented, masked keys (NaN and invalid rows -> -inf) for
K5. Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it (``rotate``, ``sq8_scores``, ``rabitq_scores``,
``polarvec_scores``, ``pq_scores``) for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import Metric
from . import _cuda
from .kmeans import kmeans_assign, train_kmeans
from .scan import _kernel_metric, _round_up, _to_key

METRIC_KIND = {Metric.IP: "ip", Metric.L2: "l2", Metric.COSINE: "cosine"}
_KIND_CODE = {"sq8": 0, "rabitq": 1, "polarvec": 2}
# the int8 codes' row width on the card: a multiple of 16 bytes (the K12
# kernel reads them 16 bytes at a time); the padded columns are zero
CODE_ALIGN = 16
# rows a PQ encode step assigns (M kmeans_assign launches each)
PQ_ENCODE_CHUNK = 1 << 18
# rows of the plain scans' (B, rows) products at a time
PLAIN_CHUNK = 1 << 17

# ── Hadamard rotation (K14) ──────────────────────────────────────────────


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def rotation_signs(dim_pad: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1.0, 1.0], dtype=np.float32), size=dim_pad)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (power-of-2 dim),
    normalized by 1/sqrt(D) so it is orthonormal."""
    d = x.shape[-1]
    h = 1
    while h < d:
        x = x.reshape(x.shape[:-1] + (d // (2 * h), 2, h))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(x.shape[:-3] + (d,))
        h *= 2
    return x / float(np.sqrt(np.float32(d)))  # the f32 square root, as JAX's


def rotate(x: torch.Tensor, signs: torch.Tensor, dim_pad: int) -> torch.Tensor:
    """Plain version of :func:`fwht_rotate`: pad to 2^m, apply the random
    signs, then the FWHT (the RHT of RaBitQ / PolarVec)."""
    pad = dim_pad - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return fwht(x * signs)


def fwht_rotate(q: torch.Tensor, signs: torch.Tensor, dim_pad: int) -> torch.Tensor:
    """(B, dim_pad) f32 rotation of the queries ``q`` (B, D) f32 with the
    index's ``signs`` (dim_pad,) f32."""
    if q.device.type == "cpu":
        return rotate(q, signs, dim_pad)
    _cuda.require_cuda("fwht_rotate", q, signs)
    b, d = q.shape
    if q.dtype != torch.float32 or signs.dtype != torch.float32 or signs.shape != (dim_pad,):
        raise ValueError("fwht_rotate: q (B, D) and signs (dim_pad,) float32 expected")
    out = torch.empty((b, dim_pad), dtype=torch.float32, device=q.device)
    _cuda.call("lt_fwht_rotate", q.data_ptr(), signs.data_ptr(), b, d, dim_pad, out.data_ptr(),
               _cuda.stream_of(q))
    fwht_rotate.launches += 1
    return out


fwht_rotate.launches = 0


def rotate_host(x: np.ndarray, signs: np.ndarray, dim_pad: int) -> np.ndarray:
    """Numpy twin of :func:`rotate` for BUILD-time encoding of large
    corpora: a million-row rotation is log2(D) vectorized passes on the
    host."""
    x = np.asarray(x, dtype=np.float32)
    pad = dim_pad - x.shape[-1]
    if pad:
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    x = x * signs
    d = x.shape[-1]
    h = 1
    while h < d:
        x = x.reshape(x.shape[:-1] + (d // (2 * h), 2, h))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = np.concatenate([a + b, a - b], axis=-1).reshape(x.shape[:-3] + (d,))
        h *= 2
    return x / np.sqrt(np.float32(d))


# ── the int8 code scan (K12) ─────────────────────────────────────────────


def quantize_queries(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The query side of :func:`_int8_dot`: each row quantized to int8
    (symmetric, 127 levels). Returns (codes (B, D) int8, scale (B, 1))."""
    amax = a.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    return torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8), scale


def _int8_dot(a: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """f32 (B, D) x int8 codes (N, Dc), Dc >= D (columns past D are the zero
    padding of the card's copy): the query quantized per row, an exact
    integer dot, times the query's scale. The integer products are summed
    in floating point, exact while every partial sum stays below 2^24
    (f32 up to 1,032 columns, else f64)."""
    q_i8, scale = quantize_queries(a)
    dc = codes.shape[1]
    ftype = torch.float32 if dc * 127 * 128 < (1 << 24) else torch.float64
    qf = torch.nn.functional.pad(q_i8.to(ftype), (0, dc - a.shape[1]))
    acc = torch.cat([qf @ codes[lo : lo + PLAIN_CHUNK].to(ftype).T
                     for lo in range(0, codes.shape[0], PLAIN_CHUNK)], dim=1)
    return acc.to(torch.float32) * scale


def _metric_scores(ip: torch.Tensor, q_sq: torch.Tensor, row_sq: torch.Tensor,
                   metric_kind: str) -> torch.Tensor:
    """The approximate inner product (B, N) as the metric's score; ``q_sq``
    (B,) and ``row_sq`` (N,) squared norms."""
    if metric_kind == "ip":
        return ip
    if metric_kind == "l2":
        return torch.clamp_min(q_sq[:, None] + row_sq[None, :] - 2.0 * ip, 0.0)
    denom = torch.sqrt(q_sq[:, None] * row_sq[None, :])
    return torch.where(denom < 1e-30, 1.0, 1.0 - ip / torch.clamp_min(denom, 1e-30))


def sq8_scores(q, codes, lo, scale, row_sq, metric_kind: str) -> torch.Tensor:
    """Approximate scores against SQ8 codes: q.x_hat = q.(lo + 128*scale) +
    (q*scale).c, one int8 product."""
    base = q @ (lo + 128.0 * scale)
    ip = base[:, None] + _int8_dot(q * scale[None, :], codes)
    return _metric_scores(ip, (q * q).sum(-1), row_sq, metric_kind)


def rabitq_scores(q_rot, bits, alpha, row_sq, q_sq, metric_kind: str) -> torch.Tensor:
    """Estimated scores: <rot q, rot x> ~ alpha * <rot q, sgn>."""
    ip = alpha[None, :] * _int8_dot(q_rot, bits)
    return _metric_scores(ip, q_sq, row_sq, metric_kind)


def polarvec_scores(q_rot, codes, lo, scale, row_sq, q_sq, metric_kind: str) -> torch.Tensor:
    qsum = q_rot.sum(-1)
    ip = lo[None, :] * qsum[:, None] + scale[None, :] * _int8_dot(q_rot, codes)
    return _metric_scores(ip, q_sq, row_sq, metric_kind)


def int8_code_scores_plain(kind: str, q, q_rot, state: dict, valid, metric: Metric):
    """Plain version of :func:`int8_code_scores`."""
    codes = state["bits"] if kind == "rabitq" else state["codes"]
    row_sq = state["row_sq"]
    mk = METRIC_KIND[metric]
    q_sq = (q * q).sum(-1)
    if kind == "sq8":
        scores = sq8_scores(q, codes, state["lo"], state["scale"], row_sq, mk)
    elif kind == "rabitq":
        scores = rabitq_scores(q_rot, codes, state["alpha"], row_sq, q_sq, mk)
    else:
        scores = polarvec_scores(q_rot, codes, state["lo"], state["scale"], row_sq, q_sq, mk)
    return _to_key(scores, metric.ascending, valid[: row_sq.shape[0]])


def int8_code_scores(kind: str, q: torch.Tensor, q_rot: torch.Tensor | None, state: dict,
                     valid: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Oriented, masked keys (B, N) of the queries against an int8-coded
    index of ``kind`` "sq8", "rabitq" or "polarvec". ``q`` (B, D) f32 is the
    query; ``q_rot`` (B, dim_pad) its K14 rotation (None for SQ8). ``state``
    holds the index's device arrays: the codes (N, Dc) int8 ("codes", or
    "bits" for RaBitQ; Dc a multiple of 16 on the card), "row_sq" (N,) and
    SQ8's per-dimension "lo"/"scale" (D,), RaBitQ's "alpha" (N,), PolarVec's
    per-row "lo"/"scale" (N,). ``valid`` holds at least N entries."""
    if q.device.type == "cpu":
        return int8_code_scores_plain(kind, q, q_rot, state, valid, metric)
    codes = state["bits"] if kind == "rabitq" else state["codes"]
    row_sq = state["row_sq"]
    n = row_sq.shape[0]
    code = _kernel_metric("int8_code_scores", metric)
    a = q if kind == "sq8" else q_rot
    b, d = a.shape
    dc = codes.shape[1]
    if codes.dtype != torch.int8 or codes.shape[0] != n or dc % CODE_ALIGN or dc < d:
        raise ValueError("int8_code_scores: codes (N, Dc) int8 with Dc a multiple of 16 expected")
    if a.dtype != torch.float32 or valid.dtype != torch.bool or valid.shape[0] < n:
        raise ValueError("int8_code_scores: float32 queries and a (>= N,) bool mask expected")
    q_sq = (q * q).sum(-1)
    dim_scale = q_base = q_sum = row_a = row_b = None
    if kind == "sq8":
        dim_scale = state["scale"]
        q_base = q @ (state["lo"] + 128.0 * dim_scale)
    elif kind == "rabitq":
        row_a = state["alpha"]
    else:
        row_a, row_b, q_sum = state["scale"], state["lo"], q_rot.sum(-1)
    _cuda.require_cuda("int8_code_scores", a, dim_scale, codes, q_base, q_sq, q_sum, row_a, row_b,
                       row_sq, valid)
    q_i8 = torch.empty((b, dc), dtype=torch.int8, device=a.device)
    q_scale = torch.empty(b, dtype=torch.float32, device=a.device)
    keys = torch.empty((b, n), dtype=torch.float32, device=a.device)
    _cuda.call(
        "lt_int8_code_scores", a.data_ptr(), _cuda.ptr(dim_scale), codes.data_ptr(),
        _cuda.ptr(q_base), q_sq.data_ptr(), _cuda.ptr(q_sum), _cuda.ptr(row_a), _cuda.ptr(row_b),
        row_sq.data_ptr(), valid.data_ptr(), b, n, d, dc, _KIND_CODE[kind], code,
        int(metric.ascending), q_i8.data_ptr(), q_scale.data_ptr(), keys.data_ptr(),
        _cuda.stream_of(a),
    )
    int8_code_scores.launches += 1
    return keys


int8_code_scores.launches = 0


# ── SQ8 ──────────────────────────────────────────────────────────────────


class SQ8:
    """Per-dimension min/max scalar quantizer (quantizer/mod.rs:115).
    Codes are centered int8 (c = u8 - 128) so the int8 product applies."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        self.lo = lo.astype(np.float32)
        self.scale = ((hi - lo) / 255.0).astype(np.float32)
        self.scale[self.scale == 0] = 1e-30

    @classmethod
    def fit(cls, data: np.ndarray) -> "SQ8":
        return cls(data.min(axis=0), data.max(axis=0))

    def encode(self, data: np.ndarray) -> np.ndarray:
        # chunked + in-place: the naive broadcast expression allocates six
        # full-corpus temps and np.round is the slow path
        inv = (1.0 / self.scale).astype(np.float32)
        neg_lo = (-self.lo).astype(np.float32)
        out = np.empty(data.shape, dtype=np.int8)
        for lo_i in range(0, data.shape[0], 131072):
            hi = min(lo_i + 131072, data.shape[0])
            u = (data[lo_i:hi] + neg_lo) * inv
            np.rint(u, out=u)
            np.clip(u, 0.0, 255.0, out=u)
            u -= 128.0
            out[lo_i:hi] = u.astype(np.int8)
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return (codes.astype(np.float32) + 128.0) * self.scale + self.lo

    def row_sq_from_codes(self, codes: np.ndarray) -> np.ndarray:
        """||decode(c)||^2 without materializing the decode: decoded_d =
        a_d c_d + b_d, so the squared norm is (c^2)@a^2 + c@(2ab) + sum b^2."""
        a = self.scale.astype(np.float64)
        b = (self.lo + 128.0 * self.scale).astype(np.float64)
        a2 = (a * a).astype(np.float32)
        ab2 = (2.0 * a * b).astype(np.float32)
        bb = np.float32((b * b).sum())
        out = np.empty(codes.shape[0], dtype=np.float32)
        for lo_i in range(0, codes.shape[0], 131072):
            hi = min(lo_i + 131072, codes.shape[0])
            cf = codes[lo_i:hi].astype(np.float32)
            out[lo_i:hi] = (cf * cf) @ a2 + cf @ ab2 + bb
        return out



# ── RaBitQ (1-bit + RHT) ─────────────────────────────────────────────────


class RaBitQ:
    """1 bit/dim in the rotated domain: rot(x) ~ alpha * sign(rot(x)) with
    alpha = mean |rot(x)| per row (the L1-optimal 1-bit scale)."""

    def __init__(self, signs: np.ndarray, dim: int, dim_pad: int):
        self.signs = signs
        self.dim = dim
        self.dim_pad = dim_pad

    @classmethod
    def fit(cls, dim: int, seed: int = 1234) -> "RaBitQ":
        dim_pad = _next_pow2(dim)
        return cls(rotation_signs(dim_pad, seed), dim, dim_pad)

    def encode(self, data: np.ndarray) -> dict:
        n = data.shape[0]
        bits = np.empty((n, self.dim_pad), dtype=np.int8)
        alpha = np.empty(n, dtype=np.float32)
        row_sq = np.empty(n, dtype=np.float32)
        for lo_i in range(0, n, 131072):
            hi = min(lo_i + 131072, n)
            blk = data[lo_i:hi]
            rot = rotate_host(blk, self.signs, self.dim_pad)
            alpha[lo_i:hi] = np.abs(rot).mean(axis=-1)
            bits[lo_i:hi] = np.where(rot > 0, 1, -1)
            row_sq[lo_i:hi] = np.einsum("ij,ij->i", blk, blk)
        return {"bits": bits, "alpha": alpha, "row_sq": row_sq}


# ── PolarVec (training-free multi-bit + RHT) ────────────────────────────


class PolarVec:
    """Multi-bit (default 4) uniform quantization per row in the rotated
    domain: rot(x) ~ lo_r + c * s_r, c in [0, 2^bits)."""

    def __init__(self, signs: np.ndarray, dim: int, dim_pad: int, bits: int = 4):
        self.signs = signs
        self.dim = dim
        self.dim_pad = dim_pad
        self.bits = bits
        self.levels = (1 << bits) - 1

    @classmethod
    def fit(cls, dim: int, bits: int = 4, seed: int = 5678) -> "PolarVec":
        return cls(rotation_signs(_next_pow2(dim), seed), dim, _next_pow2(dim), bits)

    def encode(self, data: np.ndarray) -> dict:
        n = data.shape[0]
        codes = np.empty((n, self.dim_pad), dtype=np.int8)
        lo_all = np.empty(n, dtype=np.float32)
        scale_all = np.empty(n, dtype=np.float32)
        row_sq = np.empty(n, dtype=np.float32)
        for lo_i in range(0, n, 131072):
            hi_i = min(lo_i + 131072, n)
            blk = data[lo_i:hi_i]
            rot = rotate_host(blk, self.signs, self.dim_pad)
            lo = rot.min(axis=-1)
            hi = rot.max(axis=-1)
            scale = (hi - lo) / max(self.levels, 1)
            scale[scale == 0] = 1e-30
            rot -= lo[:, None]
            rot /= scale[:, None]
            np.rint(rot, out=rot)
            np.clip(rot, 0.0, float(self.levels), out=rot)
            codes[lo_i:hi_i] = rot.astype(np.int8)
            lo_all[lo_i:hi_i] = lo
            scale_all[lo_i:hi_i] = scale
            row_sq[lo_i:hi_i] = np.einsum("ij,ij->i", blk, blk)
        return {"codes": codes, "lo": lo_all, "scale": scale_all, "row_sq": row_sq}


# ── Product quantization (K13) ───────────────────────────────────────────


def parse_n_subspaces(dim: int, requested: int | None) -> int:
    """Pick a subspace count that divides the (padded) dim; default 16
    (pq_mmap.rs M=16)."""
    m = requested or 16
    m = min(m, dim)
    while dim % m != 0:
        m -= 1
    return max(m, 1)


class PQ:
    """Per-subspace 256-entry codebooks trained with the port's k-means
    (quantizer/mod.rs:420 ProductQuantizer, pq_mmap.rs ADC scan)."""

    def __init__(self, codebooks: np.ndarray):
        self.codebooks = codebooks.astype(np.float32)  # (M, 256, Ds)
        self.m = codebooks.shape[0]
        self.ds = codebooks.shape[2]

    # codebooks train on a row sample: k-means quality saturates well below
    # full-corpus size for 256 centroids (the standard PQ practice)
    TRAIN_SAMPLE = 131_072

    @classmethod
    def fit(cls, data: np.ndarray, n_subspaces: int | None = None, seed: int = 42, *,
            device) -> "PQ":
        n, dim = data.shape
        m = parse_n_subspaces(dim, n_subspaces)
        ds = dim // m
        k = min(256, max(2, n))
        if n > cls.TRAIN_SAMPLE:
            sel = np.random.default_rng(seed).choice(n, cls.TRAIN_SAMPLE, replace=False)
            sel.sort()
            data = data[sel]
        books = np.zeros((m, 256, ds), dtype=np.float32)
        for s in range(m):
            sub = np.ascontiguousarray(data[:, s * ds : (s + 1) * ds])
            cents, _ = train_kmeans(sub, k, seed=seed + s, max_iters=15, device=device)
            books[s, : cents.shape[0]] = cents
            if cents.shape[0] < 256:
                books[s, cents.shape[0] :] = cents[0]
        return cls(books)

    def encode(self, data: np.ndarray, *, device) -> np.ndarray:
        """(N, M) uint8: each subspace's nearest codeword by L2, the lower
        index between equal distances (K15 kmeans_assign a subspace)."""
        n = data.shape[0]
        codes = np.empty((n, self.m), dtype=np.uint8)
        books = torch.from_numpy(self.codebooks).to(device)
        for lo in range(0, n, PQ_ENCODE_CHUNK):
            x = torch.from_numpy(np.ascontiguousarray(data[lo : lo + PQ_ENCODE_CHUNK],
                                                      dtype=np.float32)).to(device)
            cols = [kmeans_assign(x[:, s * self.ds : (s + 1) * self.ds].contiguous(), books[s],
                                  False) for s in range(self.m)]
            codes[lo : lo + len(x)] = torch.stack(cols, dim=1).to(torch.uint8).cpu().numpy()
        return codes

    def row_sq_norm_table(self) -> np.ndarray:
        """(M, 256) per-subspace centroid squared norms: reconstructed row
        norms are a gather-sum over this (subvectors are disjoint)."""
        return np.einsum("mks,mks->mk", self.codebooks, self.codebooks).astype(np.float32)

    def row_sq_from_codes(self, codes: np.ndarray) -> np.ndarray:
        tab = self.row_sq_norm_table()
        out = np.zeros(codes.shape[0], dtype=np.float32)
        for s in range(self.m):
            out += tab[s, codes[:, s]]
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        n = codes.shape[0]
        out = np.zeros((n, self.m * self.ds), dtype=np.float32)
        for s in range(self.m):
            out[:, s * self.ds : (s + 1) * self.ds] = self.codebooks[s][codes[:, s]]
        return out


def pq_scores(q: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor, row_sq: torch.Tensor,
              metric_kind: str) -> torch.Tensor:
    """Plain version of :func:`pq_adc_scores`: the (B, M, 256) table of
    per-subspace partial inner products, then a gather-sum over each row's
    codes in subspace order, in row chunks."""
    b = q.shape[0]
    m, _, ds = codebooks.shape
    lut = torch.einsum("bms,mks->bmk", q.reshape(b, m, ds), codebooks)
    parts = []
    for lo in range(0, codes.shape[0], PLAIN_CHUNK):
        c = codes[lo : lo + PLAIN_CHUNK].long()
        ip = torch.zeros((b, c.shape[0]), dtype=torch.float32, device=q.device)
        for s in range(m):
            ip = ip + lut[:, s, c[:, s]]
        parts.append(ip)
    return _metric_scores(torch.cat(parts, dim=1), (q * q).sum(-1), row_sq, metric_kind)


def pq_adc_scores_plain(q, codes, codebooks, row_sq, valid, metric: Metric) -> torch.Tensor:
    """Plain version of :func:`pq_adc_scores`."""
    scores = pq_scores(q, codes, codebooks, row_sq, METRIC_KIND[metric])
    return _to_key(scores, metric.ascending, valid[: codes.shape[0]])


def pq_adc_scores(q: torch.Tensor, codes: torch.Tensor, codebooks: torch.Tensor,
                  row_sq: torch.Tensor, valid: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Oriented, masked keys (B, N) of queries ``q`` (B, M * Ds) f32 against
    PQ ``codes`` (N, M) uint8 with ``codebooks`` (M, 256, Ds) f32;
    ``row_sq`` (N,) the rows' reconstructed squared norms, ``valid`` at
    least N entries."""
    n = codes.shape[0]
    if q.device.type == "cpu":
        return pq_adc_scores_plain(q, codes, codebooks, row_sq, valid, metric)
    code = _kernel_metric("pq_adc_scores", metric)
    b, d = q.shape
    m, k, ds = codebooks.shape
    if (codes.dtype != torch.uint8 or codes.shape[1] != m or k != 256 or m * ds != d
            or q.dtype != torch.float32 or codebooks.dtype != torch.float32):
        raise ValueError("pq_adc_scores: q (B, M*Ds) f32, codes (N, M) uint8 and codebooks "
                         "(M, 256, Ds) f32 expected")
    if valid.dtype != torch.bool or valid.shape[0] < n or row_sq.shape != (n,):
        raise ValueError("pq_adc_scores: row_sq (N,) and a (>= N,) bool mask expected")
    q_sq = (q * q).sum(-1)
    _cuda.require_cuda("pq_adc_scores", q, codes, codebooks, q_sq, row_sq, valid)
    keys = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _cuda.call("lt_pq_adc_scores", q.data_ptr(), codes.data_ptr(), codebooks.data_ptr(),
               q_sq.data_ptr(), row_sq.data_ptr(), valid.data_ptr(), b, n, m, ds, code,
               int(metric.ascending), keys.data_ptr(), _cuda.stream_of(q))
    pq_adc_scores.launches += 1
    return keys


pq_adc_scores.launches = 0


def pad_codes(codes: np.ndarray) -> np.ndarray:
    """int8 codes (N, D) with zero columns up to a multiple of CODE_ALIGN."""
    pad = _round_up(codes.shape[1], CODE_ALIGN) - codes.shape[1]
    return np.pad(codes, ((0, 0), (0, pad))) if pad else codes

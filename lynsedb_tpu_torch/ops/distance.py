"""Pairwise distances for all 16 metrics: the transforms and the plain forms.

Port of lynsedb_tpu/ops/distance.py. Each metric is factored into a per-row
``corpus_transform`` (norms, centring, sqrt / cdf / probability transforms,
bit-packing), the same ``query_transform`` for a query batch and the
``pairwise`` form. The transforms run once a corpus as torch ops. ``pairwise``
is the plain version of the three distance kernels, the reference every
kernel is held against; on the card the kernels compute it (ops/scan.py):

  * GEMM family (IP, L2, cosine: K1; correlation, Hellinger: K6a) — one f32
    product plus rank-1 corrections, ``csrc/flat_scores_f32.cu``;
  * binary family (Hamming, Jaccard, Tanimoto, Dice: K6b) — popcounts of
    bit-packed rows, ``csrc/binary_scores.cu``;
  * elementwise family (L1, Chebyshev, Canberra, Bray-Curtis, Haversine,
    Wasserstein, Jensen-Shannon: K6c) — (B, N, D) reductions,
    ``csrc/elementwise_scores.cu``.

Semantics follow the JAX package term for term (cosine's zero-norm policy,
correlation's constant rows, the probability metrics' invalid and zero-mass
rows, Haversine's latitude check, the Canberra and Bray-Curtis 0/0 rules).
All distances are f32 "scores" in the metric's native orientation (callers
use ``Metric.ascending`` to order them). f32 products stay full f32: the JAX
package uses Precision.HIGHEST, and TF32 must stay off on the card. The
user-facing ``compute_distance`` and ``pairwise_distances`` are in
lynsedb_tpu_torch/backend.py, on the device the caller names.
"""

from __future__ import annotations

import math

import torch

from ..metrics import Metric

_SQRT_LN2 = math.sqrt(math.log(2.0))
_LN2 = math.log(2.0)
INF = float("inf")

GEMM_METRICS = (Metric.IP, Metric.L2, Metric.COSINE, Metric.CORRELATION, Metric.HELLINGER)
BINARY_METRICS = (Metric.HAMMING, Metric.JACCARD, Metric.DICE, Metric.TANIMOTO)
ELEMENTWISE_METRICS = (Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS,
                       Metric.HAVERSINE, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON)
PROBABILITY_METRICS = (Metric.HELLINGER, Metric.WASSERSTEIN, Metric.JENSEN_SHANNON)
# rows packed per step of the binary transform (bounds its int64 scratch)
PACK_ROWS = 1 << 16


def words_for(dim: int) -> int:
    """uint32 words of one bit-packed binary row."""
    return (dim + 31) // 32


def transform_row_bytes(metric: Metric, dim: int) -> int:
    """Device bytes a row's corpus transform adds beyond the f32 copy (an
    ``x`` leaf is the f32 copy itself)."""
    if metric in (Metric.IP, Metric.L1, Metric.CHEBYSHEV, Metric.CANBERRA, Metric.BRAY_CURTIS,
                  Metric.HAVERSINE):
        return 0
    if metric in (Metric.L2, Metric.COSINE):
        return 4
    if metric is Metric.CORRELATION:
        return dim * 4 + 8
    if metric is Metric.HELLINGER:
        return dim * 4 + 5
    if metric in BINARY_METRICS:
        return words_for(dim) * 4 + 4
    if metric is Metric.WASSERSTEIN:
        return (dim - 1) * 4 + 5
    return dim * 4 + 9  # Jensen-Shannon


def _row_invalid_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Rows holding a non-finite or negative entry (the probability metrics
    give +inf for these)."""
    return (~torch.isfinite(x) | (x < 0.0)).any(dim=-1)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(N, D) f32 -> (N, ceil(D/32)) int32 words of the bits ``x > 0.5``,
    bit j of word w holding column 32 w + j, pad bits zero (the kernel reads
    the words as uint32)."""
    n, d = x.shape
    w = words_for(d)
    out = torch.empty((n, w), dtype=torch.int32, device=x.device)
    weights = torch.tensor([1 << j for j in range(32)], dtype=torch.int64, device=x.device)
    for lo in range(0, n, PACK_ROWS):
        b = torch.zeros((min(PACK_ROWS, n - lo), w * 32), dtype=torch.int64, device=x.device)
        b[:, :d] = x[lo : lo + PACK_ROWS] > 0.5
        v = (b.view(-1, w, 32) * weights).sum(-1)
        out[lo : lo + PACK_ROWS] = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return out


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, 32 W) f32 {0, 1} rows (pad columns 0)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[:, :, None] >> shifts) & 1).reshape(bits.shape[0], -1).to(torch.float32)


# ── corpus / query transforms ────────────────────────────────────────────


def corpus_transform(x: torch.Tensor, metric: Metric) -> dict:
    """Per-row preprocessing of a corpus block ``x`` (N, D). Every leaf has
    leading dimension N."""
    x = x.to(torch.float32)
    if metric is Metric.IP:
        return {"x": x}
    if metric in (Metric.L2, Metric.COSINE):
        return {"x": x, "sq": (x * x).sum(dim=-1)}
    if metric is Metric.CORRELATION:
        mean = x.mean(dim=-1)
        xc = x - mean[:, None]
        return {"xc": xc.contiguous(), "var": (xc * xc).sum(dim=-1), "mean": mean}
    if metric in BINARY_METRICS:
        bits = pack_bits(x)
        cnt = (x > 0.5).sum(dim=-1, dtype=torch.int32).to(torch.float32)
        return {"bits": bits, "cnt": cnt}
    if metric in PROBABILITY_METRICS:
        invalid = _row_invalid_nonneg(x)
        safe = torch.where(invalid[:, None], 0.0, x)
        mass = safe.sum(dim=-1)
        if metric is Metric.HELLINGER:
            return {"s": torch.sqrt(safe), "mass": mass, "invalid": invalid}
        inv = torch.where(mass > 0.0, 1.0 / mass, 0.0)
        if metric is Metric.WASSERSTEIN:
            cdf = torch.cumsum(safe * inv[:, None], dim=-1)[:, :-1].contiguous()
            return {"cdf": cdf, "mass": mass, "invalid": invalid}
        p = safe * inv[:, None]
        pos = p > 0.0
        ent = torch.where(pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0).sum(dim=-1)
        return {"p": p, "ent": ent, "mass": mass, "invalid": invalid}
    return {"x": x}  # the pure elementwise metrics keep the raw rows


def query_transform(q: torch.Tensor, metric: Metric) -> dict:
    """Same preprocessing for a query batch ``q`` (B, D)."""
    return corpus_transform(q, metric)


# ── pairwise scoring (the plain version of the kernels) ─────────────────


def pairwise(qt: dict, ct: dict, metric: Metric) -> torch.Tensor:
    """Score a query batch against a corpus block: (B, N) f32."""
    return _PAIRWISE[metric](qt, ct)


def _pw_ip(qt, ct):
    return qt["x"] @ ct["x"].T


def _pw_l2(qt, ct):
    ip = qt["x"] @ ct["x"].T
    return torch.clamp_min(qt["sq"][:, None] + ct["sq"][None, :] - 2.0 * ip, 0.0)


def _pw_cosine(qt, ct):
    ip = qt["x"] @ ct["x"].T
    denom = torch.sqrt(qt["sq"][:, None] * ct["sq"][None, :])
    # reference policy: denom < 1e-30 -> distance 1.0
    return torch.where(denom < 1e-30, 1.0, 1.0 - ip / torch.clamp_min(denom, 1e-30))


def _pw_correlation(qt, ct):
    m = Metric.CORRELATION
    return finish(m, qt["xc"] @ ct["xc"].T, terms(qt, m, 1), terms(ct, m, 0))


def _pw_hellinger(qt, ct):
    m = Metric.HELLINGER
    return finish(m, qt["s"] @ ct["s"].T, terms(qt, m, 1), terms(ct, m, 0))


def _binary_parts(qt, ct):
    # the f32 product of the {0, 1} rows: every partial sum is an integer
    # below 2^24, so the count is exact in any order
    inter = unpack_bits(qt["bits"]) @ unpack_bits(ct["bits"]).T
    return inter, qt["cnt"][:, None], ct["cnt"][None, :]


def _pw_hamming(qt, ct):
    inter, cq, cx = _binary_parts(qt, ct)
    return cq + cx - 2.0 * inter


def _pw_jaccard(qt, ct):
    inter, cq, cx = _binary_parts(qt, ct)
    union = cq + cx - inter
    return torch.where(union == 0.0, 0.0, 1.0 - inter / torch.clamp_min(union, 1.0))


def _pw_dice(qt, ct):
    inter, cq, cx = _binary_parts(qt, ct)
    total = cq + cx
    return torch.where(total == 0.0, 0.0, 1.0 - 2.0 * inter / torch.clamp_min(total, 1.0))


def _absdiff(qt, ct, key="x"):
    return (qt[key][:, None, :] - ct[key][None, :, :]).abs()


def _pw_l1(qt, ct):
    return _absdiff(qt, ct).sum(dim=-1)


def _pw_chebyshev(qt, ct):
    return _absdiff(qt, ct).amax(dim=-1)


def _pw_canberra(qt, ct):
    a, b = qt["x"][:, None, :], ct["x"][None, :, :]
    denom = a.abs() + b.abs()
    term = torch.where(denom == 0.0, 0.0, (a - b).abs() / torch.clamp_min(denom, 1e-45))
    return term.sum(dim=-1)


def _pw_bray_curtis(qt, ct):
    a, b = qt["x"][:, None, :], ct["x"][None, :, :]
    num = (a - b).abs().sum(dim=-1)
    den = (a + b).abs().sum(dim=-1)
    return torch.where(den == 0.0, torch.where(num == 0.0, 0.0, INF),
                       num / torch.clamp_min(den, 1e-45))


def haversine(lon1, lat1, lon2, lat2) -> torch.Tensor:
    """Haversine distances in meters between (lon, lat) points in degrees
    (broadcast tensors), IUGG mean Earth radius; +inf where a point has a
    non-finite coordinate or |lat| > 90."""
    r = 6_371_008.8
    deg2rad = math.pi / 180.0
    l1, p1, l2, p2 = lon1 * deg2rad, lat1 * deg2rad, lon2 * deg2rad, lat2 * deg2rad
    sin_lat = torch.sin((p2 - p1) * 0.5)
    sin_lon = torch.sin((l2 - l1) * 0.5)
    h = torch.clamp(sin_lat * sin_lat + torch.cos(p1) * torch.cos(p2) * sin_lon * sin_lon, 0.0, 1.0)
    d = 2.0 * r * torch.asin(torch.sqrt(h))
    bad = (~torch.isfinite(lon1) | ~torch.isfinite(lat1) | (lat1.abs() > 90.0)
           | ~torch.isfinite(lon2) | ~torch.isfinite(lat2) | (lat2.abs() > 90.0))
    return torch.where(bad, INF, d)


def _pw_haversine(qt, ct):
    q, x = qt["x"], ct["x"]
    return haversine(q[:, 0:1], q[:, 1:2], x[None, :, 0], x[None, :, 1])


def _pw_wasserstein(qt, ct):
    m = Metric.WASSERSTEIN
    return finish(m, _absdiff(qt, ct, "cdf").sum(dim=-1), terms(qt, m, 1), terms(ct, m, 0))


def _pw_jensen_shannon(qt, ct):
    m = qt["p"][:, None, :] + ct["p"][None, :, :]
    pos = m > 0.0
    mix = torch.where(pos, m * torch.log(torch.where(pos, m, 1.0)), 0.0).sum(dim=-1)
    js = Metric.JENSEN_SHANNON
    return finish(js, mix, terms(qt, js, 1), terms(ct, js, 0))


# ── the shared epilogues ─────────────────────────────────────────────────

# The lead leaf of a metric's transform (the rows its accumulation reads) and
# its per-row terms (a, b, invalid), as the kernels read them
# (csrc/metrics.cuh): a pair's distance is ``finish`` of one accumulated value
# over the two rows' lead values (a dot product, a sum or a max) and the two
# rows' terms. The metrics not listed lead with "x" and have no terms.
LEAD = {Metric.CORRELATION: "xc", Metric.HELLINGER: "s", Metric.WASSERSTEIN: "cdf",
        Metric.JENSEN_SHANNON: "p"}
TERMS = {Metric.CORRELATION: ("var", "mean", None), Metric.HELLINGER: ("mass", None, "invalid"),
         Metric.WASSERSTEIN: ("mass", None, "invalid"),
         Metric.JENSEN_SHANNON: ("ent", "mass", "invalid")}


def terms(t: dict, metric: Metric, axis: int | None = None) -> tuple:
    """A transform's per-row terms (a, b, invalid) of ``metric`` (None where
    it has none), unsqueezed at ``axis`` when given."""
    out = tuple(None if name is None else t[name] for name in TERMS.get(metric, (None,) * 3))
    return out if axis is None else tuple(None if v is None else v.unsqueeze(axis) for v in out)


def _mass_policy(d, mass_q, inv_q, mass_x, inv_x, zero_value):
    zero_q, zero_x = mass_q == 0.0, mass_x == 0.0
    d = torch.where(zero_q | zero_x, torch.where(zero_q & zero_x, 0.0, zero_value), d)
    return torch.where(inv_q | inv_x, INF, d)


def finish(metric: Metric, acc: torch.Tensor, q: tuple, x: tuple) -> torch.Tensor:
    """The distance of ``metric`` from a pair's accumulated value ``acc`` (the
    dot product of the lead rows for correlation and Hellinger; the sum or
    max of the elementwise terms otherwise) and the two rows' terms ``q`` and
    ``x`` (a, b, invalid), broadcast against ``acc``: the plain form of the
    kernels' epilogues, with the JAX package's policies for constant,
    zero-mass and invalid rows."""
    (qa, qb, qi), (xa, xb, xi) = q, x
    if metric is Metric.CORRELATION:  # a the centred sum of squares, b the mean
        denom = torch.sqrt(qa * xa)
        const_pair = (qa <= 1e-12) | (xa <= 1e-12)
        # constant-row policy: two equal constant rows -> 0, otherwise 1
        same = (qa <= 1e-12) & (xa <= 1e-12) & (qb == xb)
        r = torch.clamp(acc / torch.clamp_min(denom, 1e-30), -1.0, 1.0)
        return torch.where(const_pair, torch.where(same, 0.0, 1.0), 1.0 - r)
    if metric is Metric.HELLINGER:  # a the mass
        denom = torch.sqrt(qa * xa)
        bc = torch.clamp(acc / torch.clamp_min(denom, 1e-30), 0.0, 1.0)
        return _mass_policy(torch.sqrt(1.0 - bc), qa, qi, xa, xi, 1.0)
    if metric is Metric.WASSERSTEIN:  # a the mass
        return _mass_policy(acc, qa, qi, xa, xi, INF)
    if metric is Metric.JENSEN_SHANNON:  # a the entropy sum, b the mass
        div = _LN2 + 0.5 * (qa + xa - acc)
        return _mass_policy(torch.sqrt(torch.clamp_min(div, 0.0)), qb, qi, xb, xi, _SQRT_LN2)
    return acc


_PAIRWISE = {
    Metric.IP: _pw_ip,
    Metric.L2: _pw_l2,
    Metric.COSINE: _pw_cosine,
    Metric.CORRELATION: _pw_correlation,
    Metric.HELLINGER: _pw_hellinger,
    Metric.HAMMING: _pw_hamming,
    Metric.JACCARD: _pw_jaccard,
    Metric.TANIMOTO: _pw_jaccard,  # the reference maps Tanimoto to Jaccard
    Metric.DICE: _pw_dice,
    Metric.L1: _pw_l1,
    Metric.CHEBYSHEV: _pw_chebyshev,
    Metric.CANBERRA: _pw_canberra,
    Metric.BRAY_CURTIS: _pw_bray_curtis,
    Metric.HAVERSINE: _pw_haversine,
    Metric.WASSERSTEIN: _pw_wasserstein,
    Metric.JENSEN_SHANNON: _pw_jensen_shannon,
}


def parse_metric(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    m = Metric.parse(metric)
    if m is None:
        raise ValueError(f"unknown metric: {metric}")
    return m


"""Distance metric registry (the same contract as lynsedb_tpu/metrics.py).

Defines the 16 distance metrics supported by the framework, string parsing
(including index-mode token parsing), result ordering, dimension contracts and
feature gating. Mirrors the metric *contract* of the reference engine
(reference: src/distance/mod.rs:19-190); the port computes IP, L2 and
cosine in :mod:`lynsedb_tpu_torch.ops.distance` and the CUDA kernels.
"""

from __future__ import annotations

import enum
from typing import Optional


class Metric(str, enum.Enum):
    IP = "ip"
    L2 = "l2"
    COSINE = "cosine"
    HAMMING = "hamming"
    JACCARD = "jaccard"
    L1 = "l1"
    HAVERSINE = "haversine"
    CORRELATION = "correlation"
    HELLINGER = "hellinger"
    WASSERSTEIN = "wasserstein"
    DICE = "dice"
    TANIMOTO = "tanimoto"
    JENSEN_SHANNON = "jensen_shannon"
    CHEBYSHEV = "chebyshev"
    CANBERRA = "canberra"
    BRAY_CURTIS = "bray_curtis"

    # ── parsing ──────────────────────────────────────────────────────────

    @classmethod
    def parse(cls, s: str) -> Optional["Metric"]:
        """Parse a metric name with the same aliases as the reference
        (src/distance/mod.rs:39-64)."""
        return _ALIASES.get(s.strip().lower())

    @classmethod
    def from_index_mode(cls, mode: str) -> Optional["Metric"]:
        """Parse the metric token embedded in an index mode string such as
        ``HNSW-CORRELATION`` or ``FLAT-TANIMOTO-BINARY``
        (reference precedence: src/distance/mod.rs:67-109)."""
        tokens = mode.upper().split("-")
        has = lambda v: v in tokens  # noqa: E731
        if has("JENSENSHANNON") or has("JS") or (has("JENSEN") and has("SHANNON")):
            return cls.JENSEN_SHANNON
        if has("CHEBYSHEV") or has("CHEBYCHEV") or has("LINF"):
            return cls.CHEBYSHEV
        if has("CANBERRA"):
            return cls.CANBERRA
        if has("BRAYCURTIS") or (has("BRAY") and has("CURTIS")):
            return cls.BRAY_CURTIS
        if has("TANIMOTO"):
            return cls.TANIMOTO
        if has("JACCARD"):
            return cls.JACCARD
        if has("HAMMING"):
            return cls.HAMMING
        if has("DICE") or has("SORENSEN"):
            return cls.DICE
        if has("HAVERSINE") or has("GEO"):
            return cls.HAVERSINE
        if has("CORRELATION") or has("PEARSON"):
            return cls.CORRELATION
        if has("HELLINGER"):
            return cls.HELLINGER
        if has("WASSERSTEIN") or has("WASSERSTEIN1D") or has("EMD"):
            return cls.WASSERSTEIN
        if has("L1") or has("MANHATTAN") or has("CITYBLOCK"):
            return cls.L1
        if has("L2") or has("L2SQ"):
            return cls.L2
        if has("COS") or has("COSINE"):
            return cls.COSINE
        if has("IP"):
            return cls.IP
        return None

    # ── contracts ────────────────────────────────────────────────────────

    @property
    def ascending(self) -> bool:
        """True when a smaller score means "more similar". Inner product is
        the only descending metric (src/distance/mod.rs:111-117)."""
        return self is not Metric.IP

    @property
    def is_binary(self) -> bool:
        """Metrics evaluated on thresholded one-bit rows in the flat hot
        path (src/distance/mod.rs:161-168)."""
        return self in (Metric.HAMMING, Metric.JACCARD, Metric.DICE, Metric.TANIMOTO)

    def accepts_dimension(self, dim: int) -> bool:
        if self is Metric.HAVERSINE:
            return dim == 2
        return dim > 0

    @property
    def supports_flat_approx(self) -> bool:
        """Metrics with an ``approx=True`` flat implementation
        (src/distance/mod.rs:177-190)."""
        return self in (
            Metric.IP,
            Metric.L2,
            Metric.COSINE,
            Metric.L1,
            Metric.CHEBYSHEV,
            Metric.CANBERRA,
            Metric.BRAY_CURTIS,
        )

    @property
    def flat_index_mode(self) -> str:
        return _FLAT_MODES[self]

    @property
    def display_name(self) -> str:
        """Human-facing metric name used by ResultView."""
        return _DISPLAY[self]


_ALIASES = {}
for _m, _names in {
    Metric.IP: ("ip", "inner_product", "inner", "dot"),
    Metric.L2: ("l2", "l2sq", "l2_squared", "euclidean"),
    Metric.COSINE: ("cosine", "cos", "cosine_distance"),
    Metric.HAMMING: ("hamming",),
    Metric.JACCARD: ("jaccard",),
    Metric.L1: ("l1", "manhattan", "cityblock"),
    Metric.HAVERSINE: ("haversine", "haversine_m", "haversine-m", "geo"),
    Metric.CORRELATION: ("correlation", "pearson"),
    Metric.HELLINGER: ("hellinger",),
    Metric.WASSERSTEIN: (
        "wasserstein",
        "wasserstein1d",
        "wasserstein_1d",
        "wasserstein-1d",
        "emd",
    ),
    Metric.DICE: ("dice", "sorensen", "sorensen_dice", "sorensen-dice"),
    Metric.TANIMOTO: ("tanimoto",),
    Metric.JENSEN_SHANNON: ("jensen_shannon", "jensen-shannon", "jensenshannon", "js"),
    Metric.CHEBYSHEV: ("chebyshev", "chebychev", "linf", "l_inf", "l-infinity"),
    Metric.CANBERRA: ("canberra",),
    Metric.BRAY_CURTIS: ("bray_curtis", "bray-curtis", "braycurtis"),
}.items():
    for _n in _names:
        _ALIASES[_n] = _m

_FLAT_MODES = {
    Metric.IP: "FLAT-IP",
    Metric.L2: "FLAT-L2",
    Metric.COSINE: "FLAT-COS",
    Metric.HAMMING: "FLAT-HAMMING-BINARY",
    Metric.JACCARD: "FLAT-JACCARD-BINARY",
    Metric.L1: "FLAT-L1",
    Metric.HAVERSINE: "FLAT-HAVERSINE",
    Metric.CORRELATION: "FLAT-CORRELATION",
    Metric.HELLINGER: "FLAT-HELLINGER",
    Metric.WASSERSTEIN: "FLAT-WASSERSTEIN",
    Metric.DICE: "FLAT-DICE-BINARY",
    Metric.TANIMOTO: "FLAT-TANIMOTO-BINARY",
    Metric.JENSEN_SHANNON: "FLAT-JENSEN-SHANNON",
    Metric.CHEBYSHEV: "FLAT-CHEBYSHEV",
    Metric.CANBERRA: "FLAT-CANBERRA",
    Metric.BRAY_CURTIS: "FLAT-BRAY-CURTIS",
}

_DISPLAY = {
    Metric.IP: "IP",
    Metric.L2: "L2",
    Metric.COSINE: "Cosine",
    Metric.HAMMING: "Hamming",
    Metric.JACCARD: "Jaccard",
    Metric.L1: "L1",
    Metric.HAVERSINE: "Haversine",
    Metric.CORRELATION: "Correlation",
    Metric.HELLINGER: "Hellinger",
    Metric.WASSERSTEIN: "Wasserstein-1D",
    Metric.DICE: "Dice",
    Metric.TANIMOTO: "Tanimoto",
    Metric.JENSEN_SHANNON: "Jensen-Shannon",
    Metric.CHEBYSHEV: "Chebyshev",
    Metric.CANBERRA: "Canberra",
    Metric.BRAY_CURTIS: "Bray-Curtis",
}

#: Metrics whose pairwise form is one matrix product after a per-row
#: transform (the rest are elementwise reductions).
MATMUL_METRICS = frozenset(
    {
        Metric.IP,
        Metric.L2,
        Metric.COSINE,
        Metric.CORRELATION,
        Metric.HELLINGER,
        Metric.HAMMING,
        Metric.JACCARD,
        Metric.DICE,
        Metric.TANIMOTO,
    }
)

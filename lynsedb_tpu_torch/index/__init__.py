"""Index registry: mode alias resolution, build options, build/load dispatch.

Mirrors the reference's index-mode taxonomy and gating
(reference: src/index/mod.rs:228-497 — alias map, binary metrics Flat-only,
Canberra/Bray-Curtis exact-only; IndexBuildOptions :510-648 — unknown keys
rejected, inapplicable keys filtered per family; engine aux quantized modes
FLAT-*-PQ/RABITQ/POLARVEC engine.rs:4576-4595).

Index families (FLAT serves all 16 metrics; IVF also Hamming and Jaccard; HNSW
also the domain metrics but Canberra and Bray-Curtis; SPANN and DiskANN
IP/L2/cosine):
  FLAT    — no index object; the engine scans the device corpus directly.
  IVF     — k-means partitions, probe top-nprobe partitions on device.
  SPANN   — IVF with boundary replicas.
  HNSW    — layered small-world graph: an entry scan of the finest upper
            layer, then a bf16-guided beam walk of layer 0 on the card.
  DISKANN — Vamana graph: a sampled entry scan, then a bf16-guided beam walk
            (SQ8 / PQ guidance tiers fitted past 200,000 rows).
Aux (FLAT-only) quantized shortlist indexes: PQ, RABITQ, POLARVEC, SQ8
(index/quantized.py).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, fields as dc_fields
from pathlib import Path
from typing import Optional

from ..engine.errors import InvalidArgument
from ..metrics import Metric

FAMILIES = ("FLAT", "IVF", "SPANN", "HNSW", "DISKANN")

_ANN_METRICS = (Metric.IP, Metric.L2, Metric.COSINE)

# Domain metrics allowed on FLAT and HNSW (not IVF/SPANN/DiskANN), except
# Canberra / Bray-Curtis which stay exact-only (src/index/mod.rs:426-497).
_DOMAIN_METRICS = (
    Metric.L1,
    Metric.HAVERSINE,
    Metric.CORRELATION,
    Metric.HELLINGER,
    Metric.WASSERSTEIN,
    Metric.JENSEN_SHANNON,
    Metric.CHEBYSHEV,
    Metric.CANBERRA,
    Metric.BRAY_CURTIS,
)


@dataclass
class IndexBuildOptions:
    n_clusters: Optional[int] = None
    m: Optional[int] = None
    ef_construction: Optional[int] = None
    ef_search: Optional[int] = None
    max_level: Optional[int] = None
    r: Optional[int] = None
    l: Optional[int] = None
    alpha: Optional[float] = None
    max_degree: Optional[int] = None
    nprobe: Optional[int] = None
    replica_count: Optional[int] = None

    KNOWN = (
        "n_clusters",
        "n_centroids",
        "m",
        "ef_construction",
        "ef_search",
        "max_level",
        "r",
        "l",
        "alpha",
        "max_degree",
        "nprobe",
        "replica_count",
    )

    @classmethod
    def from_kwargs(cls, kwargs: dict) -> "IndexBuildOptions":
        for key in kwargs:
            if key not in cls.KNOWN:
                raise InvalidArgument(
                    f"unknown index build parameter '{key}'; supported keys: "
                    + ", ".join(cls.KNOWN)
                )
        kw = dict(kwargs)
        if "n_centroids" in kw:
            kw.setdefault("n_clusters", kw.pop("n_centroids"))
            kw.pop("n_centroids", None)
        opts = cls(**kw)
        opts.validate()
        return opts

    def validate(self) -> None:
        for name in ("n_clusters", "m", "ef_construction", "ef_search", "r", "l",
                     "max_degree", "nprobe", "replica_count"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise InvalidArgument(f"{name} must be greater than 0")
        if self.alpha is not None:
            a = float(self.alpha)
            if not (a >= 1.0 and a == a and a != float("inf")):
                raise InvalidArgument("alpha must be a finite value >= 1.0")

    def filtered_for(self, family: str) -> "IndexBuildOptions":
        keep = {
            "FLAT": (),
            "HNSW": ("m", "ef_construction", "ef_search", "max_level"),
            "DISKANN": ("r", "l", "alpha", "max_degree"),
            "IVF": ("n_clusters", "nprobe"),
            "SPANN": ("n_clusters", "nprobe", "replica_count"),
        }[family]
        return IndexBuildOptions(**{f.name: getattr(self, f.name) if f.name in keep else None
                                     for f in dc_fields(self)})


@dataclass
class ResolvedMode:
    family: str
    metric: Metric
    quantizer: Optional[str]  # None | "sq8" | "binary" | "pq" | "rabitq" | "polarvec"
    canonical: str
    pq_subspaces: Optional[int] = None
    polarvec_bits: Optional[int] = None


def resolve_index_mode(alias: str, dim: Optional[int] = None) -> ResolvedMode:
    u = alias.strip().upper()
    parts = u.split("-")
    family = parts[0]
    if family not in FAMILIES:
        raise InvalidArgument(f"unknown index mode: {alias!r}")
    metric = Metric.from_index_mode(u)
    if metric is None:
        raise InvalidArgument(f"index mode {alias!r} has no recognizable metric")

    quantizer = None
    pq_subspaces = None
    polarvec_bits = None
    if "SQ8" in parts:
        quantizer = "sq8"
    elif any(p.startswith("PQ") for p in parts[1:]):
        quantizer = "pq"
        for p in parts[1:]:
            m = re.fullmatch(r"PQ(\d+)?", p)
            if m and m.group(1):
                pq_subspaces = int(m.group(1))
    elif "RABITQ" in parts:
        quantizer = "rabitq"
    elif any(p.startswith("POLARVEC") for p in parts[1:]):
        quantizer = "polarvec"
        for p in parts[1:]:
            m = re.fullmatch(r"POLARVEC(\d+)?", p)
            if m and m.group(1):
                polarvec_bits = int(m.group(1))
    elif metric.is_binary:
        quantizer = "binary"

    # ── gating (src/index/mod.rs:426-497) ────────────────────────────────
    if metric.is_binary:
        if family not in ("FLAT", "IVF"):
            raise InvalidArgument(f"binary metric {metric.value} supports FLAT/IVF only")
        if family == "IVF" and metric in (Metric.DICE, Metric.TANIMOTO):
            raise InvalidArgument(f"IVF supports hamming/jaccard binary metrics only")
        if quantizer not in (None, "binary"):
            raise InvalidArgument(f"binary metrics cannot combine with {quantizer}")
        quantizer = "binary"
    elif metric in _ANN_METRICS:
        if quantizer in ("pq", "rabitq", "polarvec") and family not in ("FLAT", "DISKANN"):
            raise InvalidArgument(f"{quantizer} applies to FLAT/DISKANN modes only")
        if quantizer in ("rabitq", "polarvec") and family != "FLAT":
            raise InvalidArgument(f"{quantizer} applies to FLAT modes only")
    else:
        # domain metrics: FLAT always; HNSW except Canberra/Bray-Curtis
        if family == "FLAT":
            pass
        elif family == "HNSW":
            if metric in (Metric.CANBERRA, Metric.BRAY_CURTIS):
                raise InvalidArgument(f"{metric.value} is exact-only (FLAT)")
        else:
            raise InvalidArgument(
                f"metric {metric.value} supports FLAT{'':s} (and HNSW) modes only"
            )
        if quantizer is not None:
            raise InvalidArgument(f"domain metric {metric.value} cannot combine with {quantizer}")

    if dim is not None and not metric.accepts_dimension(dim):
        raise InvalidArgument(f"metric {metric.value} rejects dimension {dim}")

    return ResolvedMode(
        family=family,
        metric=metric,
        quantizer=quantizer,
        canonical=u,
        pq_subspaces=pq_subspaces,
        polarvec_bits=polarvec_bits,
    )


def index_family(alias: str) -> str:
    return resolve_index_mode(alias).family


# ── build / load dispatch ────────────────────────────────────────────────


def _index_dir(coll) -> Path:
    return coll.root / "index"


_AUX_QUANTIZERS = ("sq8", "pq", "rabitq", "polarvec")


def build_index(coll, index_mode: str, options: dict) -> None:
    mode = resolve_index_mode(index_mode, coll.dim)
    opts = IndexBuildOptions.from_kwargs(options).filtered_for(mode.family)

    # clear any previous index artifacts
    import shutil

    idx_dir = _index_dir(coll)
    if idx_dir.exists():
        shutil.rmtree(idx_dir)
    idx_dir.mkdir(parents=True, exist_ok=True)
    coll._index = None
    coll._aux_index = None
    coll.index_mode = mode.canonical

    if mode.family == "FLAT" and mode.quantizer in _AUX_QUANTIZERS:
        from .quantized import build_aux_index

        coll._aux_index = build_aux_index(coll, mode, opts)
    elif mode.family in ("IVF", "SPANN"):
        from .ivf import IVFIndex

        coll._index = IVFIndex.build(coll, mode, opts)
    elif mode.family == "HNSW":
        from .hnsw import HNSWIndex

        coll._index = HNSWIndex.build(coll, mode, opts)
    elif mode.family == "DISKANN":
        from .diskann import DiskANNIndex

        coll._index = DiskANNIndex.build(coll, mode, opts)

    meta = {
        "index_mode": mode.canonical,
        "family": mode.family,
        "metric": mode.metric.value,
        "quantizer": mode.quantizer,
        "options": {f.name: getattr(opts, f.name) for f in dc_fields(opts)},
    }
    from ..storage.vector_store import write_atomic

    write_atomic(idx_dir / "index_meta.json", json.dumps(meta).encode())


def load_index(coll):
    """Reload a persisted index at collection open. Returns (index,
    aux_index): (None, None) for the FLAT family without a quantizer, which
    needs no index object."""
    idx_dir = _index_dir(coll)
    meta_path = idx_dir / "index_meta.json"
    if not meta_path.exists() or coll.index_mode is None:
        return None, None
    meta = json.loads(meta_path.read_text())
    mode = resolve_index_mode(meta["index_mode"], coll.dim)
    opts = IndexBuildOptions(**meta.get("options", {}))
    if mode.family == "FLAT" and mode.quantizer in _AUX_QUANTIZERS:
        from .quantized import load_aux_index

        return None, load_aux_index(coll, mode, opts)
    if mode.family in ("IVF", "SPANN"):
        from .ivf import IVFIndex

        return IVFIndex.load(coll, mode, opts), None
    if mode.family == "HNSW":
        from .hnsw import HNSWIndex

        return HNSWIndex.load(coll, mode, opts), None
    if mode.family == "DISKANN":
        from .diskann import DiskANNIndex

        return DiskANNIndex.load(coll, mode, opts), None
    return None, None

"""ResultView — unified result container for all query operations.

API-compatible with the reference's ResultView
(reference: python/lynse/result_view.py:75 — ids/distances/vectors/fields,
tuple unpacking, slicing, to_* conversions, rich repr).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .metrics import Metric


def _parse_index_mode(index_mode: Optional[str]) -> Tuple[str, str]:
    """Extract (index_type, distance_metric) from an index mode string."""
    if not index_mode:
        return ("Flat", "IP")
    family = index_mode.upper().split("-")[0]
    idx_type = {
        "FLAT": "Flat",
        "IVF": "IVF",
        "SPANN": "SPANN",
        "HNSW": "HNSW",
        "DISKANN": "DiskANN",
    }.get(family, family)
    metric = Metric.from_index_mode(index_mode)
    return idx_type, (metric.display_name if metric else "IP")


class ResultView:
    __slots__ = (
        "_ids",
        "_distances",
        "_vectors",
        "_fields",
        "_k",
        "_distance",
        "_index",
        "_result_type",
        "_components",
    )

    def __init__(
        self,
        *,
        ids: Optional[np.ndarray] = None,
        distances: Optional[np.ndarray] = None,
        vectors: Optional[np.ndarray] = None,
        fields: Optional[List[Dict[str, Any]]] = None,
        k: Optional[int] = None,
        distance: Optional[str] = None,
        index: Optional[str] = None,
        result_type: str = "search",
    ):
        self._ids = ids
        self._distances = distances
        self._vectors = vectors
        self._fields = fields if fields is not None else []
        self._k = k
        self._distance = distance
        self._index = index
        self._result_type = result_type
        # Fixed component tuples per result type so tuple unpacking is stable
        # (reference: python/lynse/result_view.py:126 _build_components —
        # search always yields (ids, distances, fields), data always yields
        # (vectors, ids, fields), query yields (ids, fields) or (ids,)):
        if result_type == "search":
            comps = [self._ids, self._distances, self._fields]
        elif result_type == "data":
            comps = [self._vectors, self._ids, self._fields]
        elif self._fields:
            # NOTE: deliberately truthiness-based, matching the reference
            # (result_view.py:142): a zero-match query unpacks as (ids,),
            # a matching one as (ids, fields) — data-dependent arity is the
            # reference's documented contract for query views
            comps = [self._ids, self._fields]
        else:
            comps = [self._ids]
        self._components = comps

    # ── accessors ────────────────────────────────────────────────────────

    @property
    def ids(self):
        return self._ids

    @property
    def distances(self):
        return self._distances

    @property
    def vectors(self):
        return self._vectors

    @property
    def fields(self):
        return self._fields

    @property
    def k(self):
        return self._k

    @property
    def distance_metric(self):
        return self._distance

    @property
    def index_type(self):
        return self._index

    @property
    def result_type(self):
        return self._result_type

    # ── container protocol ───────────────────────────────────────────────

    def __len__(self) -> int:
        if self._ids is not None:
            return len(self._ids)
        if self._distances is not None:
            return len(self._distances)
        if self._vectors is not None:
            return self._vectors.shape[0]
        if self._fields:
            return len(self._fields)
        return 0

    def __iter__(self):
        return iter(self._components)

    def __getitem__(self, key):
        """Key-based access plus a row-slice extension.

        String keys match the reference contract (python/lynse/
        result_view.py:197 — "ids"/"fields" for all result types,
        "distance"/"distances"/"k"/"measure"/"index" for search,
        "vectors"/"n" for data); non-string, non-slice indices raise
        TypeError and unknown keys raise KeyError. Slices return a narrowed
        ResultView (an extension the reference does not offer).
        """
        if isinstance(key, slice):
            return ResultView(
                ids=self._ids[key] if self._ids is not None else None,
                distances=self._distances[key] if self._distances is not None else None,
                vectors=self._vectors[key] if self._vectors is not None else None,
                fields=self._fields[key] if self._fields else None,
                k=len(self._ids[key]) if self._ids is not None else self._k,
                distance=self._distance,
                index=self._index,
                result_type=self._result_type,
            )
        if not isinstance(key, str):
            raise TypeError(
                f"ResultView indices must be strings, not {type(key).__name__}"
            )
        if key == "ids":
            return self._ids
        if key in ("distance", "distances"):
            return self._distances
        if key == "vectors":
            return self._vectors
        if key == "fields":
            return self._fields
        if key == "k":
            return self._k
        if key == "measure":
            return self._distance
        if key == "index":
            return self._index
        if key == "n":
            return len(self)
        raise KeyError(f"ResultView has no key {key!r}")

    def __bool__(self) -> bool:
        return len(self) > 0

    def __eq__(self, other):
        if not isinstance(other, ResultView):
            return NotImplemented
        if self._result_type != other._result_type or len(self) != len(other):
            return False
        for mine, theirs in (
            (self._ids, other._ids),
            (self._distances, other._distances),
            (self._vectors, other._vectors),
        ):
            if (mine is None) != (theirs is None):
                return False
            if mine is not None and not np.array_equal(mine, theirs):
                return False
        return self._fields == other._fields

    # ── conversions ──────────────────────────────────────────────────────

    def to_list(self) -> list:
        out = []
        n = len(self._ids) if self._ids is not None else 0
        for i in range(n):
            rec = {"id": self._ids[i].item() if hasattr(self._ids[i], "item") else self._ids[i]}
            if self._distances is not None:
                rec["distance"] = float(self._distances[i])
            if self._vectors is not None:
                rec["vector"] = np.asarray(self._vectors[i]).tolist()
            if self._fields:
                rec["fields"] = self._fields[i]
            out.append(rec)
        return out

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {}
        if self._ids is not None:
            out["ids"] = np.asarray(self._ids).tolist()
        if self._distances is not None:
            out["distances"] = np.asarray(self._distances).tolist()
        if self._vectors is not None:
            out["vectors"] = np.asarray(self._vectors).tolist()
        if self._fields:
            out["fields"] = self._fields
        return out

    def to_numpy(self):
        if self._vectors is not None:
            return np.asarray(self._vectors)
        if self._distances is not None:
            return np.asarray(self._distances)
        return np.asarray(self._ids)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_list())

    def to_polars(self):
        import polars as pl  # optional dependency

        return pl.DataFrame(self.to_list())

    def to_arrow(self):
        import pyarrow as pa

        return pa.Table.from_pylist(self.to_list())

    # ── repr ─────────────────────────────────────────────────────────────

    def __repr__(self) -> str:
        parts = [f"ResultView(type={self._result_type!r}"]
        if self._ids is not None:
            preview = np.asarray(self._ids)[:5]
            parts.append(f"n={len(self._ids)}, ids={preview.tolist()}...")
        if self._distances is not None:
            parts.append(f"distances={np.round(np.asarray(self._distances)[:5], 4).tolist()}...")
        if self._distance:
            parts.append(f"metric={self._distance}")
        if self._index:
            parts.append(f"index={self._index}")
        return ", ".join(parts) + ")"

    __str__ = __repr__

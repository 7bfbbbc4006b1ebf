"""Record-batch normalization for the public collection API.

The engine's write surface accepts loosely-typed user input (scalar or
sequence IDs, 1-D or 2-D vectors, per-record field dicts, raw document
strings). This module canonicalizes all of it into the strict batch shape
the engine consumes: ``list`` of int/str IDs, contiguous (N, D) f32 vector
matrix, length-N field list with documents folded in under
``DOCUMENT_FIELD``. Same API contract as the reference's record layer
(reference: python/lynse/api/_records.py), implemented against this repo's
numpy-batch engine interface.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

DOCUMENT_FIELD = "document"

_ID_KIND_ERROR = "record IDs must be int or str, got {kind}"


def normalize_id(value) -> str | int:
    """Canonicalize one external ID. ints must be >= 0, strings non-empty;
    bool is rejected explicitly (it subclasses int and would silently map to
    row 0/1)."""
    if isinstance(value, bool):
        raise TypeError(_ID_KIND_ERROR.format(kind="bool"))
    if isinstance(value, np.integer):
        value = int(value)
    if isinstance(value, int):
        if value < 0:
            raise ValueError(f"negative ID not allowed: {value}")
        return value
    if isinstance(value, str):
        if value == "":
            raise ValueError("empty-string ID not allowed")
        return value
    raise TypeError(_ID_KIND_ERROR.format(kind=type(value).__name__))


def normalize_external_ids(ids) -> tuple[list, bool]:
    """Canonicalize an ID argument that may be a scalar or a sequence.
    Returns (id_list, was_scalar) so callers can unwrap scalar results."""
    if isinstance(ids, (str, int, np.integer)) and not isinstance(ids, bool):
        return [normalize_id(ids)], True
    if isinstance(ids, np.ndarray):
        seq = ids.tolist()
    elif isinstance(ids, Iterable) and not isinstance(ids, (bytes, dict)):
        seq = list(ids)
    else:
        raise TypeError(_ID_KIND_ERROR.format(kind=type(ids).__name__))
    if not seq:
        raise ValueError("at least one ID is required")
    return [normalize_id(v) for v in seq], False


def validate_unique_external_ids(ids: list) -> None:
    """Reject int/str-distinct duplicates within one batch (1 and "1" are
    different IDs; 1 and 1 are not)."""
    seen: set = set()
    for v in ids:
        tagged = (type(v) is int, v)
        if tagged in seen:
            raise ValueError(f"ID {v!r} appears more than once in this batch")
        seen.add(tagged)


def normalize_documents(documents, n: Optional[int] = None) -> tuple[Optional[list], bool]:
    """Canonicalize the documents argument (None, one string, or a sequence
    of strings). Returns (doc_list_or_None, was_scalar)."""
    if documents is None:
        return None, False
    if isinstance(documents, str):
        return [documents], True
    if not isinstance(documents, Iterable):
        raise TypeError(f"documents must be str or sequence of str, got {type(documents).__name__}")
    docs = list(documents)
    bad = next((d for d in docs if not isinstance(d, str)), None)
    if bad is not None:
        raise TypeError(f"documents must be str, got {type(bad).__name__}")
    if n is not None and len(docs) != n:
        raise ValueError(f"got {len(docs)} documents for {n} records")
    return docs, False


def normalize_vectors(vectors, n: int) -> np.ndarray:
    """Canonicalize to a contiguous (n, D) f32 matrix."""
    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"vectors must be 1-D or 2-D, got {arr.ndim}-D")
    if arr.shape[0] != n:
        raise ValueError(f"got {arr.shape[0]} vectors for {n} records")
    return np.ascontiguousarray(arr)


def normalize_fields(fields, n: int) -> list:
    """Canonicalize to a length-n list of dict-or-None."""
    if fields is None:
        return [None] * n
    if isinstance(fields, dict):
        fields = [fields]
    out = list(fields)
    if len(out) != n:
        raise ValueError(f"got {len(out)} field dicts for {n} records")
    bad = next((f for f in out if f is not None and not isinstance(f, dict)), None)
    if bad is not None:
        raise TypeError(f"fields entries must be dict or None, got {type(bad).__name__}")
    return out


def attach_documents(field_list: list, docs: Optional[list]) -> list:
    """Fold document strings into the field dicts under DOCUMENT_FIELD
    (non-destructively — callers may reuse their dicts)."""
    if docs is None:
        return field_list
    return [
        {**(f or {}), DOCUMENT_FIELD: d}
        for f, d in zip(field_list, docs)
    ]

"""Vector storage dtypes (reference: src/storage/dtype.rs)."""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float32": (np.float32, 4),
    "float16": (np.float16, 2),
}


def parse_dtype(name: str):
    key = str(name).lower()
    if key in ("f32", "float", "float32"):
        key = "float32"
    elif key in ("f16", "half", "float16"):
        key = "float16"
    if key not in _DTYPES:
        raise ValueError(f"unsupported vector dtype: {name!r} (float32/float16)")
    return key


def np_dtype(name: str):
    return _DTYPES[parse_dtype(name)][0]


def byte_width(name: str) -> int:
    return _DTYPES[parse_dtype(name)][1]


# ── bulk codecs ──────────────────────────────────────────────────────────
# the single entry points behind f16 disk storage; numpy's astype rounds to
# nearest even, as the JAX package's native F16C codec does


def cast_rows(rows: np.ndarray, name: str) -> np.ndarray:
    """f32 rows -> the storage/wire dtype (no copy when already there)."""
    if parse_dtype(name) == "float16":
        return np.ascontiguousarray(rows, dtype=np.float16)
    return np.ascontiguousarray(rows, dtype=np.float32)


def rows_to_f32(rows: np.ndarray) -> np.ndarray:
    """Storage/wire-dtype rows -> f32 (no copy when already f32)."""
    if rows.dtype == np.float16:
        return rows.astype(np.float32)
    return np.ascontiguousarray(rows, dtype=np.float32)


def decode_f32(buf: bytes, name: str) -> np.ndarray:
    """Raw LE bytes in the given dtype -> flat f32 array."""
    return rows_to_f32(np.frombuffer(buf, dtype=np_dtype(name)))

"""Columnar metadata field store with vectorized filtering.

Host-side replacement for the reference's FieldStore on ApexBase
(reference: src/storage/field_store.rs:694 — SQL WHERE execution :1203,
in-memory equality-index fast path :711, per-element array index for
CONTAINS :354, blob table :793). Persistence is an append-only CRC'd
msgpack log compacted into a snapshot at checkpoint; filtering compiles the
where string via :mod:`lynsedb_tpu_torch.storage.filter` into a row bitmask that
the engine ships to the device.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any, Optional

from . import _msgpack as msgpack
import numpy as np

from .filter import ColumnProvider, equality_conjuncts, evaluate, parse_where

_REC = struct.Struct("<BQI")

_OP_SET = 0  # (internal_id, fields) — insert or full replace
_OP_UPDATE = 1  # (internal_id, fields) — merge keys


class FieldStore(ColumnProvider):
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.snapshot_path = self.root / "fields.snapshot"
        self.log_path = self.root / "fields.log"
        self._rows: list[Optional[dict]] = []
        # the snapshot+log replay is deferred to first access: opening a
        # collection must not pay a full metadata decode (the reference's
        # startup is ~2 ms because its store opens lazily too)
        self._loaded = False
        self._pending_truncate: Optional[int] = None
        self._log_fh = open(self.log_path, "ab")
        self._columns: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._eq_index: dict[str, dict] = {}
        self._index_dirty = True

    # ── persistence ──────────────────────────────────────────────────────

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._loaded = True
            self._load()
            if self._pending_truncate is not None and len(self._rows) > self._pending_truncate:
                self._rows = self._rows[: self._pending_truncate]
            self._pending_truncate = None

    def _load(self) -> None:
        if self.snapshot_path.exists():
            rows = msgpack.unpackb(self.snapshot_path.read_bytes(), raw=False, strict_map_key=False)
            self._rows = [r if r is not None else None for r in rows]
        if self.log_path.exists():
            raw = self.log_path.read_bytes()
            pos = 0
            while pos + _REC.size <= len(raw):
                op, blen, crc = _REC.unpack_from(raw, pos)
                body = raw[pos + _REC.size : pos + _REC.size + blen]
                if len(body) < blen or zlib.crc32(body) != crc:
                    break
                iid, fields = msgpack.unpackb(body, raw=False, strict_map_key=False)
                self._apply(op, iid, fields)
                pos += _REC.size + blen

    def _append_log(self, op: int, iid: int, fields: Optional[dict], flush: bool = True) -> None:
        body = msgpack.packb([iid, fields], use_bin_type=True)
        self._log_fh.write(_REC.pack(op, len(body), zlib.crc32(body)) + body)
        if flush:
            self._log_fh.flush()

    def _apply(self, op: int, iid: int, fields: Optional[dict]) -> None:
        while len(self._rows) <= iid:
            self._rows.append(None)
        if op == _OP_SET:
            self._rows[iid] = fields
        else:
            cur = self._rows[iid] or {}
            cur.update(fields or {})
            self._rows[iid] = cur

    def checkpoint(self) -> None:
        from .vector_store import write_atomic
        self._ensure_loaded()

        write_atomic(self.snapshot_path, msgpack.packb(self._rows, use_bin_type=True))
        self._log_fh.close()
        self.log_path.unlink(missing_ok=True)
        self._log_fh = open(self.log_path, "ab")

    def close(self) -> None:
        if self._log_fh:
            self._log_fh.close()
            self._log_fh = None

    # ── writes ───────────────────────────────────────────────────────────

    def store_at(self, iid: int, fields: Optional[dict]) -> None:
        self._ensure_loaded()
        self._apply(_OP_SET, iid, fields)
        self._append_log(_OP_SET, iid, fields)
        self._invalidate()

    def batch_store_at(self, iids, field_list) -> None:
        self._ensure_loaded()
        dirty = False
        for iid, fields in zip(iids, field_list):
            self._apply(_OP_SET, iid, fields)
            if fields is not None:
                # None rows need no log record — absent rows read back as {}
                self._append_log(_OP_SET, iid, fields, flush=False)
                dirty = True
        if dirty:
            self._log_fh.flush()
        self._invalidate()

    def replace_at(self, iid: int, fields: Optional[dict]) -> None:
        self.store_at(iid, fields)

    def update_at(self, iid: int, fields: dict) -> None:
        self._ensure_loaded()
        self._apply(_OP_UPDATE, iid, fields)
        self._append_log(_OP_UPDATE, iid, fields)
        self._invalidate()

    def truncate_at_or_above(self, boundary: int) -> None:
        if not self._loaded:
            # recovery calls this at every open — defer so opening stays
            # O(1); the boundary applies when the store actually loads
            self._pending_truncate = (
                boundary if self._pending_truncate is None
                else min(self._pending_truncate, boundary)
            )
            return
        if len(self._rows) > boundary:
            self._rows = self._rows[:boundary]
            self._invalidate()

    def remap(self, mapping: np.ndarray) -> None:
        """Apply a compaction row mapping (old -> new, -1 = dropped)."""
        self._ensure_loaded()
        new_rows: list[Optional[dict]] = [None] * int((mapping >= 0).sum())
        for old, new in enumerate(mapping):
            if new >= 0 and old < len(self._rows):
                new_rows[int(new)] = self._rows[old]
        self._rows = new_rows
        self._invalidate()
        self.checkpoint()

    def _invalidate(self) -> None:
        self._columns.clear()
        self._eq_index.clear()
        self._index_dirty = True

    # ── reads ────────────────────────────────────────────────────────────

    def n_rows(self) -> int:
        self._ensure_loaded()
        return len(self._rows)

    def retrieve(self, iid: int) -> dict:
        self._ensure_loaded()
        if 0 <= iid < len(self._rows) and self._rows[iid] is not None:
            return dict(self._rows[iid])
        return {}

    def retrieve_many(self, iids) -> list[dict]:
        return [self.retrieve(int(i)) for i in iids]

    def list_fields(self) -> list[str]:
        self._ensure_loaded()
        keys: set[str] = set()
        for r in self._rows:
            if r:
                keys.update(r.keys())
        return sorted(keys)

    def column(self, field: str):
        self._ensure_loaded()
        cached = self._columns.get(field)
        if cached is not None:
            return cached
        n = len(self._rows)
        values = np.empty(n, dtype=object)
        present = np.zeros(n, dtype=bool)
        for i, r in enumerate(self._rows):
            if r is not None and field in r and r[field] is not None:
                values[i] = r[field]
                present[i] = True
        self._columns[field] = (values, present)
        return values, present

    # ── filtering ────────────────────────────────────────────────────────

    @staticmethod
    def _eq_key(v):
        """Type-tagged index key: bool/int/str share Python hash buckets
        (True == 1 == 1.0), but filter semantics keep the families apart —
        bools only match bools, numbers match numbers, strings strings."""
        if isinstance(v, bool):
            return ("b", v)
        if isinstance(v, (int, float)):
            return ("n", float(v))
        return ("s", v)

    def _build_eq_index(self) -> None:
        if not self._index_dirty:
            return
        self._eq_index.clear()
        for i, r in enumerate(self._rows):
            if not r:
                continue
            for key, val in r.items():
                if isinstance(val, (str, int, float, bool)):
                    self._eq_index.setdefault(key, {}).setdefault(
                        self._eq_key(val), []
                    ).append(i)
        self._index_dirty = False

    def query_mask(self, where: Optional[str]) -> np.ndarray:
        """Compile + evaluate a where string into a bool row mask."""
        self._ensure_loaded()  # a filtered query may be the FIRST touch after open
        n = len(self._rows)
        if where is None or not str(where).strip():
            return np.ones(n, dtype=bool)
        ast = parse_where(where)
        eqs = equality_conjuncts(ast)
        if eqs is not None and all(
            isinstance(v, (str, bool, int, float)) for _, v in eqs
        ):
            self._build_eq_index()
            mask = None
            for field, value in eqs:
                ids = self._eq_index.get(field, {}).get(self._eq_key(value), [])
                m = np.zeros(n, dtype=bool)
                if ids:
                    m[np.asarray(ids)] = True
                mask = m if mask is None else (mask & m)
            return mask if mask is not None else np.ones(n, dtype=bool)
        return evaluate(ast, self)

    def query_ids(self, where: Optional[str]) -> np.ndarray:
        return np.nonzero(self.query_mask(where))[0]

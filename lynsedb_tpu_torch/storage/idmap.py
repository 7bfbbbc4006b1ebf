"""External (string/int) ID <-> internal row ID mapping with a delta log.

Reference behavior: engine.rs:160-357 — JSON+binary persisted map with a
delta log and recovery repair. Here: a msgpack snapshot plus an append-only
delta log, compacted on checkpoint.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

from . import _msgpack as msgpack

_REC = struct.Struct("<QI")


def normalize_external_id(eid):
    """External IDs are strings or non-negative ints."""
    if isinstance(eid, bool):
        raise ValueError("external id must be str or int")
    if isinstance(eid, int):
        if eid < 0:
            raise ValueError("integer external ids must be non-negative")
        return eid
    if isinstance(eid, str):
        if not eid:
            raise ValueError("external id strings must be non-empty")
        return eid
    raise ValueError(f"external id must be str or int, got {type(eid).__name__}")


class IdMap:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.snapshot_path = self.root / "idmap.snapshot"
        self.log_path = self.root / "idmap.log"
        self._fwd: dict = {}  # external -> internal
        self._rev: dict[int, object] = {}  # internal -> external
        # Parsing a million-entry snapshot costs ~300 ms; open defers it so
        # embedded startup stays milliseconds (the reference's 2 ms startup
        # is the same lazy-open design — first use pays the load instead).
        self._loaded = False
        self._pending_truncate: int | None = None
        self._log_fh = open(self.log_path, "ab")

    def _ensure(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._load()
        if self._pending_truncate is not None:
            b = self._pending_truncate
            self._pending_truncate = None
            self.truncate_internal_at_or_above(b)

    def _load(self) -> None:
        if self.snapshot_path.exists():
            snap = msgpack.unpackb(self.snapshot_path.read_bytes(), raw=False, strict_map_key=False)
            for eid, iid in snap:
                self._fwd[eid] = iid
                self._rev[iid] = eid
        if self.log_path.exists():
            raw = self.log_path.read_bytes()
            pos = 0
            while pos + _REC.size <= len(raw):
                blen, crc = _REC.unpack_from(raw, pos)
                body = raw[pos + _REC.size : pos + _REC.size + blen]
                if len(body) < blen or zlib.crc32(body) != crc:
                    break
                op, eid, iid = msgpack.unpackb(body, raw=False)
                if op == 0:
                    self._fwd[eid] = iid
                    self._rev[iid] = eid
                elif op == 1:
                    self._fwd.pop(eid, None)
                    self._rev.pop(iid, None)
                elif op == 2:  # range insert: eid is a list, iid the start
                    for off, e in enumerate(eid):
                        self._fwd[e] = iid + off
                        self._rev[iid + off] = e
                pos += _REC.size + blen

    def _log(self, op: int, eid, iid: int, flush: bool = True) -> None:
        body = msgpack.packb([op, eid, iid], use_bin_type=True)
        self._log_fh.write(_REC.pack(len(body), zlib.crc32(body)) + body)
        if flush:
            self._log_fh.flush()

    # ── API ──────────────────────────────────────────────────────────────

    def insert(self, eid, iid: int) -> None:
        self._ensure()
        eid = normalize_external_id(eid)
        self._fwd[eid] = iid
        self._rev[iid] = eid
        self._log(0, eid, iid)

    def insert_many(self, eids, start_iid: int) -> None:
        """Bulk insert of contiguous internal ids; a single range log record
        (op=2) instead of one record per id."""
        self._ensure()
        eids = [normalize_external_id(e) for e in eids]
        for off, eid in enumerate(eids):
            iid = start_iid + off
            self._fwd[eid] = iid
            self._rev[iid] = eid
        body = msgpack.packb([2, eids, start_iid], use_bin_type=True)
        self._log_fh.write(_REC.pack(len(body), zlib.crc32(body)) + body)
        self._log_fh.flush()

    def remove(self, eid) -> None:
        self._ensure()
        iid = self._fwd.pop(eid, None)
        if iid is not None:
            self._rev.pop(iid, None)
            self._log(1, eid, iid)

    def get_internal(self, eid):
        self._ensure()
        return self._fwd.get(eid)

    def get_external(self, iid: int):
        self._ensure()
        return self._rev.get(iid)

    def __contains__(self, eid) -> bool:
        self._ensure()
        return eid in self._fwd

    def __len__(self) -> int:
        self._ensure()
        return len(self._fwd)

    def max_int_id(self) -> int:
        """Largest integer external id (-1 when none); used for auto-ID
        assignment (reference: LocalCollection.add start_id logic)."""
        self._ensure()
        best = -1
        for eid in self._fwd:
            if isinstance(eid, int) and eid > best:
                best = eid
        return best

    def items(self):
        self._ensure()
        return self._fwd.items()

    def truncate_internal_at_or_above(self, boundary: int) -> None:
        """Drop mappings to internal ids >= boundary (rollback/recovery).
        Before the lazy load has run this only records the boundary; the
        load applies it (the common clean-open case never parses eagerly)."""
        if not self._loaded:
            self._pending_truncate = (
                boundary if self._pending_truncate is None
                else min(self._pending_truncate, boundary)
            )
            return
        drop = [(eid, iid) for eid, iid in self._fwd.items() if iid >= boundary]
        for eid, iid in drop:
            self._fwd.pop(eid, None)
            self._rev.pop(iid, None)

    def checkpoint(self) -> None:
        """Compact the delta log into the snapshot."""
        from .vector_store import write_atomic

        self._ensure()
        data = msgpack.packb(list(self._fwd.items()), use_bin_type=True)
        write_atomic(self.snapshot_path, data)
        self._log_fh.close()
        self.log_path.unlink(missing_ok=True)
        self._log_fh = open(self.log_path, "ab")

    def close(self) -> None:
        if self._log_fh:
            self._log_fh.close()
            self._log_fh = None

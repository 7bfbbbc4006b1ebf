"""Crash-safe write-ahead log.

Plays the role of the reference WAL (reference: src/storage/wal.rs:251 —
32-byte header, CRC-checked segments, commit status, rotation, replay
iterator) with a simpler but equivalent record format:

    file   := header record*
    header := magic b"LTW1" | version u32 | dim u64 | dtype u8 | pad[15]
    record := kind u8 | payload_len u64 | crc32 u32 | payload

Records are msgpack-framed envelopes carrying add/upsert batches. Torn tails
(partial writes, CRC mismatches) terminate replay cleanly — everything before
the tear is recovered, matching the reference's torn-tail contract.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from pathlib import Path
from typing import Iterator

from . import _msgpack as msgpack
import numpy as np

MAGIC = b"LTW1"
VERSION = 1
HEADER_SIZE = 32
REC_HEADER = struct.Struct("<BQI")

KIND_ADD = 1
KIND_UPSERT = 2
KIND_DELETE = 3
KIND_RESTORE = 4
KIND_FIELD_UPDATE = 5

ROTATE_BYTES = 1 << 30  # 1 GB, matching the reference's rotation budget


class WALStorage:
    def __init__(self, wal_dir: str | Path, dim: int, dtype: str = "float32"):
        self.dir = Path(wal_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.dim = int(dim)
        self.dtype = dtype
        self._fh: io.BufferedWriter | None = None
        self._path: Path | None = None
        self._open_segment()

    # ── segments ─────────────────────────────────────────────────────────

    def _segments(self) -> list[Path]:
        return sorted(self.dir.glob("wal-*.log"))

    def _open_segment(self) -> None:
        segs = self._segments()
        if segs:
            self._path = segs[-1]
            self._fh = open(self._path, "ab")
        else:
            self._rotate()

    def _rotate(self) -> None:
        if self._fh:
            self._fh.close()
        idx = len(self._segments())
        self._path = self.dir / f"wal-{idx:05d}.log"
        self._fh = open(self._path, "ab")
        if self._path.stat().st_size == 0:
            header = MAGIC + struct.pack("<IQB", VERSION, self.dim, 4 if self.dtype == "float32" else 2)
            header += b"\x00" * (HEADER_SIZE - len(header))
            self._fh.write(header)
            self._fh.flush()

    # ── writes ───────────────────────────────────────────────────────────

    def append(self, kind: int, payload: dict) -> None:
        body = msgpack.packb(payload, use_bin_type=True)
        rec = REC_HEADER.pack(kind, len(body), zlib.crc32(body)) + body
        self._fh.write(rec)
        self._fh.flush()
        if self._path.stat().st_size > ROTATE_BYTES:
            self._rotate()

    def log_add(self, internal_ids: list[int], vectors: np.ndarray, external_ids, fields,
                include_vectors: bool = True) -> None:
        """Log an add. ``include_vectors=False`` writes a metadata-only
        record for the bulk-ingest path where vectors go straight to segment
        storage in the same call — the WAL then only needs the ids/fields
        for idempotent recovery (recovery truncates metadata past the
        durable vector boundary), halving ingest write volume."""
        payload = {
            "iids": internal_ids,
            "dim": int(vectors.shape[1]),
            "eids": external_ids,
            "fields": fields,
        }
        if include_vectors:
            payload["vec"] = np.ascontiguousarray(vectors, dtype=np.float32).tobytes()
        self.append(KIND_ADD, payload)

    def log_upsert(self, internal_ids: list[int], vectors: np.ndarray, fields) -> None:
        self.append(
            KIND_UPSERT,
            {
                "iids": internal_ids,
                "vec": np.ascontiguousarray(vectors, dtype=np.float32).tobytes(),
                "dim": int(vectors.shape[1]),
                "fields": fields,
            },
        )

    def sync(self) -> None:
        if self._fh:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    # ── replay / cleanup ─────────────────────────────────────────────────

    def replay(self) -> Iterator[tuple[int, dict]]:
        """Yield (kind, payload) for every intact record across segments.
        Stops at the first torn or corrupt record in the final segment."""
        self.sync()
        for path in self._segments():
            raw = path.read_bytes()
            pos = HEADER_SIZE
            if raw[:4] != MAGIC:
                continue
            while pos + REC_HEADER.size <= len(raw):
                kind, plen, crc = REC_HEADER.unpack_from(raw, pos)
                body_start = pos + REC_HEADER.size
                if body_start + plen > len(raw):
                    return  # torn tail
                body = raw[body_start : body_start + plen]
                if zlib.crc32(body) != crc:
                    return  # corrupt record — stop replay here
                yield kind, msgpack.unpackb(body, raw=False, strict_map_key=False)
                pos = body_start + plen

    def cleanup(self) -> None:
        """Drop all segments after a successful checkpoint."""
        if self._fh:
            self._fh.close()
            self._fh = None
        for path in self._segments():
            path.unlink()
        self._rotate()

    def pending_bytes(self) -> int:
        return sum(max(p.stat().st_size - HEADER_SIZE, 0) for p in self._segments())

    def has_pending(self) -> bool:
        return self.pending_bytes() > 0

    def close(self) -> None:
        if self._fh:
            self._fh.flush()
            self._fh.close()
            self._fh = None

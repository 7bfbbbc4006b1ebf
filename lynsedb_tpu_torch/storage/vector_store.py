"""Segmented raw-vector storage with an atomic manifest.

Host-side replacement for the reference's VectorStore/FlatMmap pair
(reference: src/storage/vector_store.rs:144 — manifest-managed segments,
positional-overwrite journal, compaction; src/storage/flat_mmap.rs — the scan
engine, which in this build lives on-device in
:mod:`lynsedb_tpu_torch.ops.scan.DeviceCorpus`).

Layout:
    segments/vectors.seg-N.bin   raw little-endian rows, append-only
    manifest.json                dim, dtype, segment row counts, row_count
    updates.journal              pending positional overwrites (crash safety)

The manifest's ``row_count`` is the durable row boundary: rows beyond it are
recovered from the WAL on open. Manifest writes are atomic (tmp + rename),
mirroring the reference's write_atomic (vector_store.rs:100).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from .dtype import byte_width, cast_rows, np_dtype, parse_dtype, rows_to_f32

TARGET_SEGMENT_BYTES = int(os.environ.get("LYNSE_SEGMENT_BYTES", 256 * 1024 * 1024))


def write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class VectorStore:
    def __init__(self, root: str | Path, dim: int | None, dtype: str = "float32"):
        self.root = Path(root)
        self.seg_dir = self.root / "segments"
        self.seg_dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.root / "manifest.json"
        self.journal_path = self.root / "updates.journal"

        if self.manifest_path.exists():
            m = json.loads(self.manifest_path.read_text())
            self.dim = m["dim"]
            self.dtype = m["dtype"]
            if dim is not None and m["dim"] not in (None, dim):
                raise ValueError(f"dimension mismatch: stored {m['dim']}, requested {dim}")
            self._segments = m["segments"]
            self.row_count = m["row_count"]
        else:
            self.dim = dim
            self.dtype = parse_dtype(dtype)
            self._segments = []
            self.row_count = 0
            if dim is not None:
                self._write_manifest()
        self._trim_to_manifest()
        self._recover_journal()

    def _trim_to_manifest(self) -> None:
        """Discard bytes past the durable boundary (crash between append and
        checkpoint leaves file tails the manifest never published)."""
        for seg in self._segments:
            path = self._seg_path(seg["name"])
            want = seg["rows"] * self.row_bytes
            if path.exists() and path.stat().st_size > want:
                with open(path, "r+b") as fh:
                    fh.truncate(want)

    # ── manifest ─────────────────────────────────────────────────────────

    @property
    def row_bytes(self) -> int:
        return self.dim * byte_width(self.dtype)

    def _write_manifest(self) -> None:
        data = json.dumps(
            {
                "dim": self.dim,
                "dtype": self.dtype,
                "segments": self._segments,
                "row_count": self.row_count,
            }
        ).encode()
        write_atomic(self.manifest_path, data)

    def set_dim(self, dim: int) -> None:
        if self.dim is None:
            self.dim = int(dim)
            self._write_manifest()
        elif self.dim != dim:
            raise ValueError(f"dimension mismatch: stored {self.dim}, got {dim}")

    # ── append path ──────────────────────────────────────────────────────

    def _seg_path(self, name: str) -> Path:
        return self.seg_dir / name

    def append(self, rows: np.ndarray) -> None:
        """Append rows (not yet durable — call checkpoint() to publish)."""
        rows = cast_rows(np.asarray(rows), self.dtype)
        if self.dim is None:
            self.set_dim(rows.shape[1])
        if rows.shape[1] != self.dim:
            raise ValueError(f"dimension mismatch: stored {self.dim}, got {rows.shape[1]}")
        data = memoryview(rows).cast("B")  # zero-copy byte view
        target_rows = max(TARGET_SEGMENT_BYTES // self.row_bytes, 1)
        offset = 0
        n = rows.shape[0]
        while offset < n:
            if not self._segments or self._segments[-1]["rows"] >= target_rows:
                name = f"vectors.seg-{len(self._segments):05d}.bin"
                self._segments.append({"name": name, "rows": 0})
                self._seg_path(name).touch()
            seg = self._segments[-1]
            room = target_rows - seg["rows"]
            take = min(room, n - offset)
            with open(self._seg_path(seg["name"]), "ab") as fh:
                fh.write(data[offset * self.row_bytes : (offset + take) * self.row_bytes])
            seg["rows"] += take
            offset += take
        self.row_count += n

    def checkpoint(self, fsync: bool = True) -> None:
        """Publish the durable row boundary."""
        if fsync:
            for seg in self._segments:
                with open(self._seg_path(seg["name"]), "rb") as fh:
                    os.fsync(fh.fileno())
        self._write_manifest()
        self._clear_journal()

    # ── reads ────────────────────────────────────────────────────────────

    def _locate(self, row: int) -> tuple[Path, int]:
        for seg in self._segments:
            if row < seg["rows"]:
                return self._seg_path(seg["name"]), row
            row -= seg["rows"]
        raise IndexError("row out of range")

    def read_rows(self, start: int, count: int) -> np.ndarray:
        """Read rows [start, start+count) as f32."""
        out = np.empty((count, self.dim), dtype=np_dtype(self.dtype))
        filled = 0
        row = start
        while filled < count:
            path, local = self._locate(row)
            mm = np.memmap(path, dtype=np_dtype(self.dtype), mode="r")
            seg_rows = mm.shape[0] // self.dim
            take = min(seg_rows - local, count - filled)
            out[filled : filled + take] = mm[local * self.dim : (local + take) * self.dim].reshape(
                take, self.dim
            )
            filled += take
            row += take
        return rows_to_f32(out)

    def read_all(self) -> np.ndarray:
        if self.row_count == 0:
            return np.zeros((0, self.dim or 0), dtype=np.float32)
        return self.read_rows(0, self.row_count)

    def row(self, i: int) -> np.ndarray:
        return self.read_rows(i, 1)[0]

    def read_rows_at(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        for j, i in enumerate(ids):
            out[j] = self.row(int(i))
        return out

    # ── positional overwrite with journal (upsert crash safety) ─────────

    def overwrite_rows(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        rows = cast_rows(np.asarray(rows), self.dtype)
        # Journal first (reference: vector_store.rs:900-939).
        with open(self.journal_path, "ab") as jf:
            for rid, row in zip(np.asarray(row_ids, dtype=np.int64), rows):
                body = row.tobytes()
                jf.write(struct.pack("<QQI", int(rid), len(body), zlib.crc32(body)) + body)
            jf.flush()
            os.fsync(jf.fileno())
        self._apply_overwrites(np.asarray(row_ids, dtype=np.int64), rows)

    def _apply_overwrites(self, row_ids: np.ndarray, rows: np.ndarray) -> None:
        for rid, row in zip(row_ids, rows):
            path, local = self._locate(int(rid))
            with open(path, "r+b") as fh:
                fh.seek(local * self.row_bytes)
                fh.write(row.tobytes())

    def _recover_journal(self) -> None:
        if not self.journal_path.exists():
            return
        raw = self.journal_path.read_bytes()
        pos = 0
        hdr = struct.Struct("<QQI")
        ids, rows = [], []
        while pos + hdr.size <= len(raw):
            rid, blen, crc = hdr.unpack_from(raw, pos)
            body = raw[pos + hdr.size : pos + hdr.size + blen]
            if len(body) < blen or zlib.crc32(body) != crc:
                break
            if rid < self.row_count:
                ids.append(rid)
                rows.append(np.frombuffer(body, dtype=np_dtype(self.dtype)))
            pos += hdr.size + blen
        if ids:
            self._apply_overwrites(np.asarray(ids), np.stack(rows))
        self._clear_journal()

    def _clear_journal(self) -> None:
        if self.journal_path.exists():
            self.journal_path.unlink()

    # ── maintenance ──────────────────────────────────────────────────────

    def truncate_to(self, rows: int) -> None:
        """Discard appended-but-uncommitted rows past the durable boundary."""
        remaining = rows
        kept = []
        for seg in self._segments:
            take = min(seg["rows"], remaining)
            if take > 0:
                with open(self._seg_path(seg["name"]), "r+b") as fh:
                    fh.truncate(take * self.row_bytes)
                kept.append({"name": seg["name"], "rows": take})
            else:
                self._seg_path(seg["name"]).unlink(missing_ok=True)
            remaining -= take
        self._segments = kept
        self.row_count = rows
        self._write_manifest()

    def compact_rows(self, keep_mask: np.ndarray) -> np.ndarray:
        """Rewrite storage keeping only rows where keep_mask is True.
        Returns old_row -> new_row mapping (-1 for dropped rows)."""
        data = self.read_all()
        keep_mask = np.asarray(keep_mask, dtype=bool)[: len(data)]
        kept = data[keep_mask]
        for seg in self._segments:
            self._seg_path(seg["name"]).unlink(missing_ok=True)
        self._segments = []
        self.row_count = 0
        self.append(kept.astype(np_dtype(self.dtype)))
        self.checkpoint()
        mapping = np.full(len(data), -1, dtype=np.int64)
        mapping[keep_mask] = np.arange(keep_mask.sum())
        return mapping

    def disk_bytes(self) -> int:
        return sum(
            self._seg_path(s["name"]).stat().st_size
            for s in self._segments
            if self._seg_path(s["name"]).exists()
        )

"""Collection: the central orchestrator.

One Collection owns vectors + metadata + WAL + tombstones + ID maps + the
device-resident scan corpus, mirroring the reference's Collection
(reference: src/engine.rs:118-155) with the compute plane on a torch device
carried explicitly from the client (``device``):

  * adds buffer in RAM + WAL and flush to segment storage at thresholds
    (reference pending-ingest: engine.rs:165-247, 10k rows / 32 MB)
  * search = where-mask (host, columnar) fused into the device scan
    (reference: engine.rs:4697/4718 dispatch)
  * commit/checkpoint/flush mirror the layered durability contract
    (engine.rs:4425-4485); crash recovery replays the WAL past the durable
    manifest boundary (engine.rs:1760-1785)
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..configs.config import config
from ..metrics import Metric
from ..ops.scan import DeviceCorpus, FilterHandle
from .search_cache import SearchCache
from ..storage.bitset import BitSet
from ..storage.field_store import FieldStore
from ..storage.idmap import IdMap, normalize_external_id
from ..storage.vector_store import VectorStore, write_atomic
from ..storage.wal import (
    KIND_ADD,
    KIND_DELETE,
    KIND_FIELD_UPDATE,
    KIND_RESTORE,
    KIND_UPSERT,
    WALStorage,
)
from .errors import (
    CollectionClosed,
    DimensionMismatch,
    InvalidArgument,
    LynseError,
    ReadOnly,
)

PENDING_FLUSH_ROWS = 10_000
PENDING_FLUSH_BYTES = 32 * 1024 * 1024

# ANN + filter policy: prefer the exact filtered scan when the subset is
# small in absolute and relative terms (reference: engine.rs:95-102).
EXACT_FILTER_MAX_ROWS = 100_000


def should_use_exact_filtered_search(subset: int, total: int) -> bool:
    return subset <= EXACT_FILTER_MAX_ROWS and subset * 4 <= total


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the CUDA engine yet (ROADMAP A.13)")


@dataclass
class SearchResult:
    ids: np.ndarray  # internal row ids
    distances: np.ndarray
    distance_metric: str
    index_type: str
    profile: Optional[dict] = None


@dataclass
class QueryProfile:
    """Per-query explain (reference: engine.rs:6906-6920)."""

    index_path: str = "flat"
    filter_matches: int = 0
    scanned_vectors: int = 0
    filter_us: int = 0
    search_us: int = 0
    rerank_us: int = 0
    total_us: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class Collection:
    def __init__(
        self,
        root: str | Path,
        name: str,
        dim: Optional[int] = None,
        dtype: str = "float32",
        description: Optional[str] = None,
        read_only: bool = False,
        *,
        device,
    ):
        self.root = Path(root)
        self.device = torch.device(device)
        self.name = name
        self.read_only = read_only
        self._closed = False
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()

        self.config_path = self.root / "collection.json"
        cfg = {}
        if self.config_path.exists():
            cfg = json.loads(self.config_path.read_text())
        self.dim: Optional[int] = cfg.get("dim", dim)
        if dim is not None and cfg.get("dim") is not None and cfg["dim"] != dim:
            raise DimensionMismatch(f"collection has dim {cfg['dim']}, requested {dim}")
        self.dtype = cfg.get("dtype", dtype)
        self.description = description if description is not None else cfg.get("description")
        self.index_mode: Optional[str] = cfg.get("index_mode")

        self.store = VectorStore(self.root / "vectors", self.dim, self.dtype)
        if self.dim is None and self.store.dim is not None:
            self.dim = self.store.dim
        self.fields = FieldStore(self.root / "fields")
        self.idmap = IdMap(self.root / "idmap")
        self.wal = WALStorage(self.root / "wal", self.dim or 0, self.dtype)

        tomb_path = self.root / "tombstones.bin"
        self.tombstones = (
            BitSet.from_bytes(tomb_path.read_bytes()) if tomb_path.exists() else BitSet()
        )

        # pending rows: appended to WAL, not yet in VectorStore
        self._pending: list[np.ndarray] = []
        self._pending_rows = 0
        self._pending_bytes = 0

        # device mirror
        self._corpus: Optional[DeviceCorpus] = None
        self._device_rows = 0
        self._tombs_dirty = True

        # where-string -> FilterHandle cache, invalidated by write version
        self._write_version = 0
        self._filter_cache: dict[str, tuple[int, int, FilterHandle]] = {}

        # search-result cache (reference: SEARCH_CACHE_* config surface);
        # keys include the write version, so writes invalidate implicitly
        self._search_cache = SearchCache(
            config.LYNSE_SEARCH_CACHE_SIZE, config.LYNSE_SEARCH_CACHE_EXPIRE_SECONDS
        )

        # secondary indexes (IVF/SPANN/HNSW/DiskANN/PQ/... ) — set by build_index
        self._index = None
        self._aux_index = None

        # optional subsystems, attached lazily
        self._sparse = None
        self._text = None
        self._named_fields: dict[str, "Collection"] = {}

        self._recover()
        self._write_config()
        self._load_index()
        self._load_named_fields()

    # ── config / recovery ────────────────────────────────────────────────

    def _write_config(self) -> None:
        if self.read_only:
            return
        write_atomic(
            self.config_path,
            json.dumps(
                {
                    "dim": self.dim,
                    "dtype": self.dtype,
                    "description": self.description,
                    "index_mode": self.index_mode,
                    "named_fields": sorted(self._named_fields.keys()) if hasattr(self, "_named_fields") else [],
                }
            ).encode(),
        )

    def _recover(self) -> None:
        """WAL replay past the durable manifest boundary
        (reference: engine.rs:1760-1785, recover_wal :2391)."""
        durable = self.store.row_count
        recovered = 0
        for kind, payload in self.wal.replay():
            if kind == KIND_ADD:
                iids = payload["iids"]
                dim = payload["dim"]
                raw = payload.get("vec")
                if raw is not None:
                    vecs = np.frombuffer(raw, dtype=np.float32).reshape(-1, dim)
                    new = [i for i, iid in enumerate(iids) if iid >= durable + self._pending_rows]
                    if new:
                        rows = vecs[new]
                        self._pending.append(rows)
                        self._pending_rows += len(new)
                        self._pending_bytes += rows.nbytes
                        recovered += len(new)
                # metadata-only (bulk) records: vectors were appended to the
                # store directly; rows past the store boundary are lost with
                # their metadata truncated below
                # fields + idmap have their own logs; re-apply is idempotent
                for i, iid in enumerate(iids):
                    if payload.get("fields") is not None:
                        self.fields.store_at(iid, payload["fields"][i])
                    if payload.get("eids") is not None:
                        self.idmap.insert(payload["eids"][i], iid)
            elif kind == KIND_UPSERT:
                iids = payload["iids"]
                dim = payload["dim"]
                vecs = np.frombuffer(payload["vec"], dtype=np.float32).reshape(-1, dim)
                for i, iid in enumerate(iids):
                    self._write_row(iid, vecs[i], durable_boundary=durable)
                    if payload.get("fields") is not None and payload["fields"][i] is not None:
                        self.fields.store_at(iid, payload["fields"][i])
            elif kind == KIND_DELETE:
                for iid in payload["iids"]:
                    self.tombstones.set(iid, True)
            elif kind == KIND_RESTORE:
                for iid in payload["iids"]:
                    self.tombstones.set(iid, False)
            elif kind == KIND_FIELD_UPDATE:
                for iid, f in zip(payload["iids"], payload["fields"]):
                    self.fields.update_at(iid, f)
        total = self.n_rows
        self.fields.truncate_at_or_above(total)
        self.idmap.truncate_internal_at_or_above(total)
        if recovered and not self.read_only:
            # make recovered rows durable immediately
            self._flush_pending()
            self.checkpoint()

    def _load_index(self) -> None:
        from ..index import load_index

        self._index, self._aux_index = load_index(self)

    def _load_named_fields(self) -> None:
        nf_dir = self.root / "named_fields"
        if nf_dir.exists():
            for child in sorted(nf_dir.iterdir()):
                if child.is_dir():
                    self._named_fields[child.name] = Collection(
                        child, f"{self.name}.{child.name}", read_only=self.read_only,
                        device=self.device,
                    )

    # ── basic state ──────────────────────────────────────────────────────

    @property
    def n_rows(self) -> int:
        return self.store.row_count + self._pending_rows

    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.dim or 0)

    def max_id(self) -> int:
        return self.idmap.max_int_id()

    def is_id_exists(self, eid) -> bool:
        return eid in self.idmap

    def _check_open(self) -> None:
        if self._closed:
            raise CollectionClosed(f"collection {self.name!r} is closed")

    def _check_writable(self) -> None:
        self._check_open()
        if self.read_only:
            raise ReadOnly("collection is read-only")

    def _ensure_dim(self, vectors: np.ndarray) -> None:
        if vectors.ndim != 2:
            raise InvalidArgument("vectors must be 2D")
        if self.dim is None:
            self.dim = int(vectors.shape[1])
            self.store.set_dim(self.dim)
            self._write_config()
        elif vectors.shape[1] != self.dim:
            raise DimensionMismatch(
                f"expected dim {self.dim}, got {vectors.shape[1]}"
            )

    # ── write path ───────────────────────────────────────────────────────

    def add_records(self, vectors, external_ids, fields=None) -> list:
        """Add rows with explicit external string/int IDs
        (reference: engine.rs:3953 add_records)."""
        with self._lock:
            self._check_writable()
            self._write_version += 1
            vectors = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
            self._ensure_dim(vectors)
            n = vectors.shape[0]
            if len(external_ids) != n:
                raise InvalidArgument("ids length must match vectors")
            eids = [normalize_external_id(e) for e in external_ids]
            if len(set(eids)) != len(eids):
                raise InvalidArgument("duplicate external ids in batch")
            for e in eids:
                if e in self.idmap:
                    raise InvalidArgument(f"external id already exists: {e!r}")
            if fields is not None and len(fields) != n:
                raise InvalidArgument("fields length must match vectors")

            start = self.n_rows
            iids = list(range(start, start + n))
            bulk = n >= PENDING_FLUSH_ROWS and not self._pending
            # Bulk path: the batch flushes to segment storage in this very
            # call, so the WAL carries metadata only (ids/fields) — vector
            # bytes hit disk exactly once. Recovery replays the metadata
            # idempotently and truncates past the durable vector boundary,
            # the same contract as the buffered path (engine.rs:1760-1785).
            self.wal.log_add(iids, vectors, eids, fields, include_vectors=not bulk)
            field_list = fields if fields is not None else [None] * n
            self.fields.batch_store_at(iids, field_list)
            self._text_upsert(iids, field_list)
            self.idmap.insert_many(eids, start)
            if bulk:
                self.store.append(vectors)
                # publish the row boundary now: the WAL has no vector bytes
                # for this batch, so the manifest is what makes these rows
                # visible to recovery (same buffered-write durability class
                # as an unsynced WAL record)
                self.store.checkpoint(fsync=False)
            else:
                self._pending.append(vectors)
                self._pending_rows += n
                self._pending_bytes += vectors.nbytes
                self._maybe_flush_pending()
            return eids

    def add_items(self, vectors, ids, fields=None) -> list:
        """Integer-ID add used by the auto-ID path."""
        return self.add_records(vectors, list(ids), fields)

    def _maybe_flush_pending(self) -> None:
        if self._pending_rows >= PENDING_FLUSH_ROWS or self._pending_bytes >= PENDING_FLUSH_BYTES:
            self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        rows = self._pending[0] if len(self._pending) == 1 else np.concatenate(self._pending, axis=0)
        self.store.append(rows)
        self._pending = []
        self._pending_rows = 0
        self._pending_bytes = 0

    def _write_row(self, iid: int, row: np.ndarray, durable_boundary: Optional[int] = None) -> None:
        """Positional overwrite across durable storage and pending buffer."""
        boundary = self.store.row_count if durable_boundary is None else durable_boundary
        if iid < boundary:
            self.store.overwrite_rows(np.array([iid]), row[None, :])
        else:
            self._write_pending_row(iid, row, boundary)
        if self._corpus is not None and iid < self._device_rows:
            self._corpus.overwrite(np.array([iid]), row[None, :])

    def _write_pending_row(self, iid: int, row: np.ndarray, boundary: int) -> None:
        off = iid - boundary
        for chunk in self._pending:
            if off < len(chunk):
                chunk[off] = row
                return
            off -= len(chunk)
        # row beyond any pending chunk: ignore (stale WAL entry)

    def upsert_items(self, vectors, external_ids, fields=None) -> list:
        """Overwrite-or-insert by external ID (reference: engine.rs:5949)."""
        with self._lock:
            self._check_writable()
            self._write_version += 1
            vectors = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
            self._ensure_dim(vectors)
            n = vectors.shape[0]
            eids = [normalize_external_id(e) for e in external_ids]
            field_list = fields if fields is not None else [None] * n

            new_rows, new_eids, new_fields = [], [], []
            up_iids, up_rows, up_fields = [], [], []
            for i, e in enumerate(eids):
                iid = self.idmap.get_internal(e)
                if iid is None:
                    new_rows.append(vectors[i])
                    new_eids.append(e)
                    new_fields.append(field_list[i])
                else:
                    up_iids.append(iid)
                    up_rows.append(vectors[i])
                    up_fields.append(field_list[i])
            if up_iids:
                up_arr = np.stack(up_rows)
                self.wal.log_upsert(up_iids, up_arr, up_fields)
                # batch positional overwrites: one store call for rows below
                # the durable boundary, one device overwrite for staged rows
                boundary = self.store.row_count
                iid_arr = np.asarray(up_iids, dtype=np.int64)
                below = iid_arr < boundary
                if below.any():
                    self.store.overwrite_rows(iid_arr[below], up_arr[below])
                for pos in np.nonzero(~below)[0]:
                    self._write_pending_row(int(iid_arr[pos]), up_arr[pos], boundary)
                if self._corpus is not None and self._device_rows:
                    on_dev = iid_arr < self._device_rows
                    if on_dev.any():
                        self._corpus.overwrite(iid_arr[on_dev], up_arr[on_dev])
                for iid, f in zip(up_iids, up_fields):
                    if f is not None:
                        self.fields.store_at(iid, f)
                        self._text_upsert([iid], [f])
                    self.tombstones.set(iid, False)
                self._tombs_dirty = True
            if new_eids:
                self.add_records(np.stack(new_rows), new_eids, new_fields)
            return eids

    def update_items(self, external_ids, fields) -> int:
        """Update metadata fields only (reference: engine.rs:6072)."""
        with self._lock:
            self._check_writable()
            self._write_version += 1
            iids, flist = [], []
            for e, f in zip(external_ids, fields):
                iid = self.idmap.get_internal(e)
                if iid is None:
                    raise InvalidArgument(f"id not found: {e!r}")
                iids.append(iid)
                flist.append(f)
            self.wal.append(KIND_FIELD_UPDATE, {"iids": iids, "fields": flist})
            for iid, f in zip(iids, flist):
                self.fields.update_at(iid, f)
                self._text_upsert([iid], [self.fields.retrieve(iid) or None])
            return len(iids)

    def delete_items(self, external_ids) -> int:
        with self._lock:
            self._check_writable()
            self._write_version += 1
            iids = []
            for e in external_ids:
                iid = self.idmap.get_internal(e)
                if iid is not None and not self.tombstones.get(iid):
                    iids.append(iid)
            if iids:
                self.wal.append(KIND_DELETE, {"iids": iids})
                for iid in iids:
                    self.tombstones.set(iid, True)
                self._tombs_dirty = True
            return len(iids)

    def restore_items(self, external_ids) -> int:
        with self._lock:
            self._check_writable()
            self._write_version += 1
            iids = []
            for e in external_ids:
                iid = self.idmap.get_internal(e)
                if iid is not None and self.tombstones.get(iid):
                    iids.append(iid)
            if iids:
                self.wal.append(KIND_RESTORE, {"iids": iids})
                for iid in iids:
                    self.tombstones.set(iid, False)
                self._tombs_dirty = True
            return len(iids)

    def list_deleted_ids(self) -> list:
        out = []
        for iid in self.tombstones.iter_set_bits():
            eid = self.idmap.get_external(int(iid))
            if eid is not None:
                out.append(eid)
        return out

    # ── durability ───────────────────────────────────────────────────────

    def commit(self) -> None:
        """Fast logical durability boundary (reference: engine.rs:4485)."""
        with self._lock:
            self._check_writable()
            self._flush_pending()
            self.store.checkpoint(fsync=False)
            self._save_tombstones()
            self._save_text()
            if self._sparse is not None:
                self._sparse.save()
            self.wal.cleanup()
            if self._corpus is not None:
                self.corpus()  # stage any pending rows, then trim growth slack
                self._corpus.finalize()
            if self._index is not None:
                self._index.on_commit(self)
            if self._aux_index is not None:
                self._aux_index.on_commit(self)

    def checkpoint(self) -> None:
        """Fsync'd durable barrier + log compaction (engine.rs:4435)."""
        with self._lock:
            self._check_writable()
            self._flush_pending()
            self.store.checkpoint(fsync=True)
            self.fields.checkpoint()
            self.idmap.checkpoint()
            self._save_tombstones()
            self._save_text()
            if self._sparse is not None:
                self._sparse.save()
            self.wal.cleanup()
            if self._corpus is not None:
                self.corpus()  # stage any pending rows, then trim growth slack
                self._corpus.finalize()
            if self._index is not None:
                self._index.on_commit(self)
            if self._aux_index is not None:
                self._aux_index.on_commit(self)

    def flush(self) -> None:
        with self._lock:
            self._check_writable()
            self._flush_pending()
            self.wal.sync()

    def close(self) -> None:
        with self._lock:
            if self._closed:  # idempotent (reference: close twice is a no-op)
                return
            self._closed = True
            if not self.read_only:
                if self._pending:
                    self._flush_pending()
                    self.store.checkpoint(fsync=True)
                    self.wal.cleanup()
                self._save_tombstones()
            self.wal.close()
            self.fields.close()
            self.idmap.close()
            for nf in self._named_fields.values():
                nf.close()

    def _save_tombstones(self) -> None:
        write_atomic(self.root / "tombstones.bin", self.tombstones.to_bytes())
        self._tombs_dirty = True

    # ── device mirror ────────────────────────────────────────────────────

    def corpus(self) -> DeviceCorpus:
        with self._lock:
            if self.dim is None:
                raise LynseError("collection has no vectors yet")
            if self._corpus is None:
                self._corpus = DeviceCorpus(self.dim, self.dtype, device=self.device)
                self._device_rows = 0
            total = self.n_rows
            if self._device_rows < total:
                durable = self.store.row_count
                if self._device_rows < durable:
                    self._corpus.append(self.store.read_rows(self._device_rows, durable - self._device_rows))
                    self._device_rows = durable
                if self._pending:
                    offset = self._device_rows - durable
                    rows = np.concatenate(self._pending, axis=0)[offset:]
                    if len(rows):
                        self._corpus.append(rows)
                        self._device_rows = total
            if self._tombs_dirty:
                self._corpus.set_tombstones(self.tombstones.to_bool_array(total))
                self._tombs_dirty = False
            return self._corpus

    def _reset_device(self) -> None:
        self._corpus = None
        self._device_rows = 0
        self._tombs_dirty = True

    # ── search ───────────────────────────────────────────────────────────

    @property
    def metric(self) -> Metric:
        mode = self.index_mode or "FLAT-IP"
        m = Metric.from_index_mode(mode)
        return m if m is not None else Metric.IP

    @property
    def index_type(self) -> str:
        mode = self.index_mode or "FLAT-IP"
        family = mode.split("-")[0]
        return {
            "FLAT": "Flat",
            "IVF": "IVF",
            "SPANN": "SPANN",
            "HNSW": "HNSW",
            "DISKANN": "DiskANN",
        }.get(family, family)

    def resolve_filter(self, where: Optional[str], filter_ids=None) -> Optional[FilterHandle]:
        """where string + optional external-ID allowlist -> cached filter
        handle (reference: engine.rs:3097 resolve_where_subset). Handles are
        cached per where-string and invalidated by the write version, so
        repeated filtered queries pay no mask rebuild or device re-upload."""
        n = self.n_rows
        if where and filter_ids is None:
            cached = self._filter_cache.get(where)
            if cached is not None and cached[0] == self._write_version and cached[1] == n:
                return cached[2]
        mask = None
        if where:
            m = self.fields.query_mask(where)
            if len(m) < n:
                m = np.concatenate([m, np.zeros(n - len(m), dtype=bool)])
            mask = m[:n]
        if filter_ids is not None:
            m2 = np.zeros(n, dtype=bool)
            for e in filter_ids:
                # reject bool/negative/empty ids up front (same contract as
                # add/upsert; a bare bool would silently alias row 0/1)
                try:
                    e = normalize_external_id(e)
                except ValueError as exc:
                    raise InvalidArgument(f"invalid filter id {e!r}: {exc}") from exc
                iid = self.idmap.get_internal(e)
                if iid is not None and iid < n:
                    m2[iid] = True
            mask = m2 if mask is None else (mask & m2)
        if mask is None:
            return None
        handle = FilterHandle(mask)
        if where and filter_ids is None:
            if len(self._filter_cache) >= 32:
                self._filter_cache.pop(next(iter(self._filter_cache)))
            self._filter_cache[where] = (self._write_version, n, handle)
        return handle

    def search(
        self,
        vector,
        k: int = 10,
        *,
        where: Optional[str] = None,
        filter_ids=None,
        field_name: str = "default",
        nprobe: int = 10,
        approx: bool = False,
        eps: float = 1e-4,
        profile: bool = False,
    ) -> SearchResult:
        res = self.batch_search(
            np.atleast_2d(np.asarray(vector, dtype=np.float32)),
            k,
            where=where,
            filter_ids=filter_ids,
            field_name=field_name,
            nprobe=nprobe,
            approx=approx,
            eps=eps,
            profile=profile,
        )
        # batch rows are rectangular (-1 padded when a row found < k);
        # a single result strips its pads
        live = np.asarray(res.ids[0]) >= 0
        return SearchResult(
            ids=np.asarray(res.ids[0])[live],
            distances=np.asarray(res.distances[0])[live],
            distance_metric=res.distance_metric,
            index_type=res.index_type,
            profile=res.profile,
        )

    def batch_search(
        self,
        vectors,
        k: int = 10,
        *,
        where: Optional[str] = None,
        filter_ids=None,
        field_name: str = "default",
        nprobe: int = 10,
        approx: bool = False,
        eps: float = 1e-4,
        profile: bool = False,
    ) -> SearchResult:
        self._check_open()
        if approx and not np.isfinite(eps):
            raise InvalidArgument(f"approx eps must be finite, got {eps!r}")
        if field_name != "default":
            sub = self._named_fields.get(field_name)
            if sub is None:
                raise InvalidArgument(f"unknown vector field: {field_name!r}")
            return sub.batch_search(
                vectors, k, where=where, filter_ids=filter_ids, nprobe=nprobe,
                approx=approx, eps=eps, profile=profile,
            )
        with self._lock:
            t0 = time.perf_counter()
            q = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
            if self.dim is not None and q.shape[1] != self.dim:
                raise DimensionMismatch(f"query dim {q.shape[1]} != collection dim {self.dim}")
            cache_key = None
            if self._search_cache.enabled and filter_ids is None and not profile:
                cache_key = SearchCache.query_key(
                    q.tobytes(), k, where, field_name, nprobe, approx, round(eps, 12),
                    self._write_version, self.index_mode,
                )
                cached = self._search_cache.get(cache_key)
                if cached is not None:
                    return cached
            metric = self.metric
            if not metric.accepts_dimension(q.shape[1]):
                raise InvalidArgument(f"metric {metric.value} rejects dim {q.shape[1]}")
            if self.n_rows == 0:
                empty = np.zeros((len(q), 0))
                return SearchResult(
                    ids=empty.astype(np.int64),
                    distances=empty.astype(np.float32),
                    distance_metric=metric.display_name,
                    index_type=self.index_type,
                )

            handle = self.resolve_filter(where, filter_ids)
            t1 = time.perf_counter()
            corpus = self.corpus()
            index_path = "flat"
            subset = handle.count if handle is not None else self.n_rows

            use_exact = handle is not None and should_use_exact_filtered_search(subset, self.n_rows)
            if self._index is not None and not use_exact:
                # the handle caches its staged device mask per corpus epoch
                dists, ids = self._index.search(self, q, k, mask=handle, nprobe=nprobe)
                index_path = self._index.kind
                scanned = getattr(self._index, "last_scanned", subset)
            elif self._aux_index is not None and not use_exact:
                # pass the handle itself: its staged device mask is cached
                # per corpus epoch, so repeat filtered queries skip the H2D
                dists, ids = self._aux_index.search(
                    self, q, k, nprobe=nprobe, mask=handle
                )
                index_path = self._aux_index.kind
                scanned = getattr(self._aux_index, "last_scanned", subset)
            elif approx and metric.supports_flat_approx:
                dists, ids = corpus.search_approx(q, k, metric, eps=eps, filter_mask=handle)
                index_path = "approx_flat"
                scanned = corpus.last_scanned
            else:
                dists, ids = corpus.search(q, k, metric, filter_mask=handle)
                scanned = corpus.last_scanned
            t2 = time.perf_counter()

            prof = None
            if profile:
                # scanned_vectors = rows whose distance was actually computed
                # on this query's path (reference engine.rs:6906): probed
                # cluster rows for IVF, visited nodes for graphs, N (+exact
                # rescore shortlist) for flat two-pass, the filter's rows
                # (+ the shortlist) for a filter on the gather route
                prof = QueryProfile(
                    index_path=index_path,
                    filter_matches=subset,
                    scanned_vectors=int(scanned),
                    filter_us=int((t1 - t0) * 1e6),
                    search_us=int((t2 - t1) * 1e6),
                    total_us=int((t2 - t0) * 1e6),
                ).to_dict()
            out = SearchResult(
                ids=ids,
                distances=dists,
                distance_metric=metric.display_name,
                index_type=self.index_type,
                profile=prof,
            )
            if cache_key is not None:
                self._search_cache.put(cache_key, out)
            return out

    def batch_search_submit(self, vectors, k: int = 10, *, where: Optional[str] = None):
        """Async flat-path batched dispatch: returns a zero-arg resolver
        producing the same SearchResult as :meth:`batch_search`, or None
        when an index/aux path (or empty collection) requires the
        synchronous path. The kernels are enqueued on the card before this
        returns; the resolver waits for them and fetches the rows, so a
        caller keeps two dispatches in flight and one's fetch overlaps the
        next one's scan (the server's micro-batcher)."""
        self._check_open()
        if self._index is not None or self._aux_index is not None or self.n_rows == 0:
            return None
        with self._lock:
            q = np.ascontiguousarray(np.atleast_2d(vectors), dtype=np.float32)
            if self.dim is not None and q.shape[1] != self.dim:
                raise DimensionMismatch(f"query dim {q.shape[1]} != collection dim {self.dim}")
            metric = self.metric
            if not metric.accepts_dimension(q.shape[1]):
                raise InvalidArgument(f"metric {metric.value} rejects dim {q.shape[1]}")
            handle = self.resolve_filter(where)
            resolver = self.corpus().search_submit(q, k, metric, filter_mask=handle)

        def resolve() -> SearchResult:
            dists, ids = resolver()
            return SearchResult(
                ids=ids,
                distances=dists,
                distance_metric=metric.display_name,
                index_type=self.index_type,
            )

        return resolve

    def prewarm(self) -> float:
        """Build the kernels and stage the corpus with one dummy search, so
        the first live query pays neither. Returns seconds spent. Safe no-op
        on an empty collection."""
        if self.n_rows == 0:
            return 0.0
        with self._lock:
            t0 = time.perf_counter()
            corpus = self.corpus()
            corpus.search_submit(np.zeros((1, self.dim), np.float32), 10, self.metric)()
            return time.perf_counter() - t0

    def search_stream(
        self,
        vectors,
        k: int = 10,
        *,
        where: Optional[str] = None,
        window: Optional[int] = None,
    ) -> list[SearchResult]:
        """Single-query stream over the flat scan path, micro-batched into
        windows with up to two windows in flight, so the host work of one
        window overlaps the device work of the next. On a streaming corpus
        the whole stream is one submit, whose chunks share one pump of the
        corpus. Falls back to sequential searches when an ANN/aux index is
        active."""
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(vectors, dtype=np.float32)))
        if window is None:
            window = 16 if len(q) <= 32 else 64
        if self._index is not None or self._aux_index is not None or self.n_rows == 0:
            return [self.search(q[i], k, where=where) for i in range(len(q))]
        with self._lock:
            metric = self.metric
            handle = self.resolve_filter(where)
            corpus = self.corpus()
            window = max(1, int(window))
            n_q = len(q)
            in_flight: list = []
            results: list[SearchResult] = []

            def drain_one():
                dists, ids = in_flight.pop(0)()
                for row in range(dists.shape[0]):
                    live = ids[row] >= 0
                    results.append(
                        SearchResult(
                            ids=ids[row][live],
                            distances=dists[row][live],
                            distance_metric=metric.display_name,
                            index_type=self.index_type,
                        )
                    )

            if corpus.would_stream():
                in_flight.append(corpus.search_submit(q, k, metric, filter_mask=handle))
            else:
                for s in range(0, n_q, window):
                    in_flight.append(
                        corpus.search_submit(q[s : s + window], k, metric, filter_mask=handle)
                    )
                    if len(in_flight) > 2:
                        drain_one()
            while in_flight:
                drain_one()
            return results

    def search_range(self, vector, threshold: float, max_results: int = 1000, where=None):
        with self._lock:
            q = np.asarray(vector, dtype=np.float32).reshape(-1)
            mask = self.resolve_filter(where)
            corpus = self.corpus()
            dists, ids = corpus.range_search(q, threshold, self.metric, max_results, filter_mask=mask)
            return SearchResult(
                ids=ids,
                distances=dists,
                distance_metric=self.metric.display_name,
                index_type=self.index_type,
            )

    # ── data retrieval ───────────────────────────────────────────────────

    def internal_to_external(self, iids: np.ndarray) -> list:
        return [self.idmap.get_external(int(i)) for i in iids]

    def external_to_internal(self, eids) -> list:
        return [self.idmap.get_internal(e) for e in eids]

    def row_vector(self, iid: int) -> np.ndarray:
        durable = self.store.row_count
        if iid < durable:
            return self.store.row(iid)
        off = iid - durable
        for chunk in self._pending:
            if off < len(chunk):
                return np.array(chunk[off])
            off -= len(chunk)
        raise InvalidArgument(f"row {iid} out of range")

    def query(self, where=None, filter_ids=None, limit: Optional[int] = None):
        """Metadata query: internal row ids passing the filter, live only."""
        with self._lock:
            self._check_open()
            n = self.n_rows
            handle = self.resolve_filter(where, filter_ids)
            mask = np.ones(n, dtype=bool) if handle is None else handle.mask.copy()
            tombs = self.tombstones.to_bool_array(n)
            mask &= ~tombs
            ids = np.nonzero(mask)[0]
            if limit is not None:
                ids = ids[:limit]
            return ids

    def head_ids(self, n: int = 5) -> np.ndarray:
        return self.query()[:n]

    def tail_ids(self, n: int = 5) -> np.ndarray:
        ids = self.query()
        return ids[-n:] if len(ids) else ids

    def get_vectors(self, iids: np.ndarray) -> np.ndarray:
        self._check_open()
        if len(iids) == 0:
            return np.zeros((0, self.dim or 0), dtype=np.float32)
        return np.stack([self.row_vector(int(i)) for i in iids])

    # ── index management ─────────────────────────────────────────────────

    def build_index(self, index_mode: str = "FLAT-IP", **options) -> None:
        from ..index import build_index as _build

        with self._lock:
            self._check_writable()
            self._flush_pending()
            _build(self, index_mode, options)
            self._write_config()

    def remove_index(self) -> None:
        with self._lock:
            self._check_writable()
            metric = self.metric
            self.index_mode = metric.flat_index_mode
            self._index = None
            self._aux_index = None
            idx_dir = self.root / "index"
            if idx_dir.exists():
                shutil.rmtree(idx_dir)
            self._write_config()

    # ── maintenance ──────────────────────────────────────────────────────

    def compact(self) -> int:
        """Physically drop tombstoned rows (reference: engine.rs:6494).
        Returns the number of rows reclaimed."""
        with self._lock:
            self._check_writable()
            self._write_version += 1
            self._flush_pending()
            n = self.n_rows
            tombs = self.tombstones.to_bool_array(n)
            reclaimed = int(tombs.sum())
            if reclaimed == 0:
                return 0
            mapping = self.store.compact_rows(~tombs)
            self.fields.remap(mapping)
            new_fwd = {}
            for eid, iid in list(self.idmap.items()):
                new = mapping[iid] if iid < len(mapping) else -1
                if new >= 0:
                    new_fwd[eid] = int(new)
            # rebuild idmap
            for eid in list(self.idmap._fwd.keys()):
                self.idmap.remove(eid)
            for eid, iid in new_fwd.items():
                self.idmap.insert(eid, iid)
            self.idmap.checkpoint()
            self.tombstones = BitSet(self.store.row_count)
            self._save_tombstones()
            self.wal.cleanup()
            self._reset_device()
            if self._index is not None:
                self._index.rebuild(self)
            if self._aux_index is not None:
                self._aux_index.rebuild(self)
            # remap sparse rows; rebuild the text index from remapped fields
            if self._sparse is None and (self.root / "sparse.msgpack").exists():
                self.sparse()
            if self._sparse is not None and not self._sparse.is_empty():
                old = dict(self._sparse._rows)
                self._sparse._rows = {
                    int(mapping[iid]): rows
                    for iid, rows in old.items()
                    if iid < len(mapping) and mapping[iid] >= 0
                }
                self._sparse._csr = None
                self._sparse.save()
            if self._text is not None or (self.root / "text_index.msgpack").exists():
                self._text = None
                (self.root / "text_index.msgpack").unlink(missing_ok=True)
                (self.root / "text_index.rows").unlink(missing_ok=True)
                self.text()  # rebuild from remapped fields
                self._save_text()
            return reclaimed

    def stats(self) -> dict:
        n = self.n_rows
        deleted = self.tombstones.count()
        return {
            "name": self.name,
            "rows": n,
            "live_rows": n - deleted,
            "deleted_rows": deleted,
            "dim": self.dim,
            "dtype": self.dtype,
            "index_mode": self.index_mode,
            "disk_bytes": self.store.disk_bytes(),
            "wal_bytes": self.wal.pending_bytes(),
            "description": self.description,
            "vector_fields": sorted(self._named_fields.keys()),
        }

    # ── blobs (reference: engine.rs:6296-6331) ──────────────────────────

    def _blob_path(self, key: str) -> Path:
        safe = key.replace("/", "_").replace("..", "_")
        return self.root / "blobs" / safe

    def write_blob(self, key: str, value: bytes) -> None:
        self._check_writable()
        path = self._blob_path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(path, value)

    def read_blob(self, key: str) -> Optional[bytes]:
        path = self._blob_path(key)
        return path.read_bytes() if path.exists() else None

    def read_blob_range(self, key: str, offset: int, length: int) -> Optional[bytes]:
        path = self._blob_path(key)
        if not path.exists():
            return None
        with open(path, "rb") as fh:
            fh.seek(offset)
            return fh.read(length)

    def delete_blob(self, key: str) -> bool:
        self._check_writable()
        path = self._blob_path(key)
        if path.exists():
            path.unlink()
            return True
        return False

    # ── snapshot / export (reference: engine.rs:6847/6608) ──────────────

    def snapshot_to(self, snapshot_path: str | Path) -> None:
        with self._lock:
            if not self.read_only:
                self.checkpoint()
            dst = Path(snapshot_path)
            if dst.exists():
                raise InvalidArgument(f"snapshot path already exists: {dst}")
            shutil.copytree(self.root, dst)
            manifest = {
                "format": "lynse_tpu_snapshot_v1",
                "collection": self.name,
                "rows": self.n_rows,
                "dim": self.dim,
                "created_at": time.time(),
            }
            write_atomic(dst / "snapshot.manifest.json", json.dumps(manifest).encode())

    def export_to(self, export_path: str | Path) -> None:
        """Portable export: vectors.f32 + metadata.jsonl."""
        with self._lock:
            self._flush_pending()
            dst = Path(export_path)
            dst.mkdir(parents=True, exist_ok=True)
            data = self.store.read_all()
            data.astype(np.float32).tofile(dst / "vectors.f32")
            with open(dst / "metadata.jsonl", "w") as fh:
                for iid in range(self.n_rows):
                    rec = {
                        "id": self.idmap.get_external(iid),
                        "fields": self.fields.retrieve(iid),
                        "deleted": self.tombstones.get(iid),
                    }
                    fh.write(json.dumps(rec) + "\n")
            write_atomic(
                dst / "export.manifest.json",
                json.dumps(
                    {
                        "format": "lynse_tpu_export_v1",
                        "rows": self.n_rows,
                        "dim": self.dim,
                        "dtype": "float32",
                        "index_mode": self.index_mode,
                    }
                ).encode(),
            )

    # ── named vector fields (reference: engine.rs:521-543, 4042-4388) ───

    def create_vector_field(self, field_name: str, dim: Optional[int] = None,
                            metric: str = "ip", dtype: str = "float32") -> None:
        with self._lock:
            self._check_writable()
            if field_name in self._named_fields or field_name == "default":
                raise InvalidArgument(f"vector field already exists: {field_name!r}")
            m = Metric.parse(metric)
            if m is None:
                raise InvalidArgument(f"unknown metric: {metric!r}")
            sub = Collection(self.root / "named_fields" / field_name,
                             f"{self.name}.{field_name}", dim=dim, device=self.device)
            sub.index_mode = m.flat_index_mode
            sub._write_config()
            self._named_fields[field_name] = sub
            self._write_config()

    def list_vector_fields(self) -> list[str]:
        return sorted(self._named_fields.keys())

    def vector_field(self, field_name: str) -> "Collection":
        sub = self._named_fields.get(field_name)
        if sub is None:
            raise InvalidArgument(f"unknown vector field: {field_name!r}")
        return sub

    def add_named_vectors(self, field_name: str, external_ids, vectors) -> None:
        sub = self.vector_field(field_name)
        sub.upsert_items(vectors, external_ids)
        sub.commit()

    # ── sparse vectors, BM25 text and hybrid fusion: not ported yet ──────

    def sparse(self):
        _not_ported("sparse vector storage")

    def add_sparse_vectors(self, external_ids, sparse_vectors) -> None:
        _not_ported("sparse vector storage")

    def search_sparse(self, query, k: int = 10, where: Optional[str] = None) -> SearchResult:
        _not_ported("sparse vector search")

    def text(self):
        _not_ported("the BM25 text index")

    def _text_upsert(self, iids, field_list) -> None:
        """Keep the text index current when it has been materialized."""
        if self._text is not None:
            for iid, f in zip(iids, field_list):
                self._text.upsert_document(iid, f)

    def _save_text(self) -> None:
        if self._text is not None:
            self._text.save()
            (self.root / "text_index.rows").write_text(str(self.n_rows))

    def text_search(self, query_text: str, k: int = 10, *, text_fields=None,
                    where: Optional[str] = None) -> SearchResult:
        _not_ported("BM25 text search")

    def hybrid_search(self, vector=None, query_text: Optional[str] = None, k: int = 10,
                      **options) -> SearchResult:
        _not_ported("hybrid search")

    def fuse_hybrid(self, vres, tres, k: int, **options) -> SearchResult:
        _not_ported("hybrid search")

    def hybrid_search_stream(self, vectors=None, texts=None, k: int = 10,
                             **options) -> list[SearchResult]:
        _not_ported("hybrid search")

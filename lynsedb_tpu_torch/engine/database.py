"""DatabaseEngine / DatabaseManager: collection and database registries.

Reference: engine.rs:7240-7745 (DatabaseEngine) and :9652-10292
(DatabaseManager with exclusive `.manager.lock`, `.fingerprint`-scanned dirs).
The torch ``device`` every collection searches on is threaded from the
manager down to each Collection.
"""

from __future__ import annotations

import fcntl
import json
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

from ..storage.vector_store import write_atomic
from .collection import Collection
from .errors import (
    CollectionNotFound,
    DatabaseNotFound,
    DimensionMismatch,
    InvalidArgument,
    ReadOnly,
    validate_resource_name,
)

MAX_DATABASES = 64
FINGERPRINT = ".fingerprint"


class FileLock:
    """Exclusive advisory file lock (reference: engine.rs:360-412)."""

    def __init__(self, path: Path, shared: bool = False):
        self.path = path
        self._fh = open(path, "a+")
        flag = fcntl.LOCK_SH if shared else fcntl.LOCK_EX
        try:
            fcntl.flock(self._fh.fileno(), flag | fcntl.LOCK_NB)
        except OSError as e:
            self._fh.close()
            raise InvalidArgument(f"storage is locked by another process: {path}") from e

    def release(self) -> None:
        if self._fh:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None


class DatabaseEngine:
    """Per-database collection registry."""

    def __init__(self, root: Path, name: str, read_only: bool = False, *, device):
        self.root = root
        self.name = name
        self.read_only = read_only
        self.device = torch.device(device)
        self._collections: dict[str, Collection] = {}
        self._lock = threading.RLock()
        self.root.mkdir(parents=True, exist_ok=True)
        fp = self.root / FINGERPRINT
        if not fp.exists() and not read_only:
            fp.write_text(json.dumps({"kind": "lynse_tpu_db", "name": name}))

    def list_collections(self) -> list[str]:
        out = []
        for child in sorted(self.root.iterdir()):
            if child.is_dir() and (child / "collection.json").exists():
                out.append(child.name)
        return out

    def collection_exists(self, name: str) -> bool:
        return (self.root / name / "collection.json").exists()

    def require_collection(
        self,
        name: str,
        dim: Optional[int] = None,
        drop_if_exists: bool = False,
        description: Optional[str] = None,
        dtype: str = "float32",
    ) -> Collection:
        validate_resource_name(name)
        with self._lock:
            if self.read_only and not self.collection_exists(name):
                raise ReadOnly("database is read-only: cannot create collection")
            if drop_if_exists:
                self.drop_collection(name)
            coll = self._collections.get(name)
            if coll is not None and coll._closed:
                # a closed handle stays cached until someone re-opens;
                # reopen from disk instead of handing back a dead engine
                self._collections.pop(name, None)
                coll = None
            if coll is None:
                coll = Collection(
                    self.root / name,
                    name,
                    dim=dim,
                    dtype=dtype,
                    description=description,
                    read_only=self.read_only,
                    device=self.device,
                )
                self._collections[name] = coll
            elif dim is not None and coll.dim is not None and coll.dim != dim:
                raise DimensionMismatch(f"collection {name} has dim {coll.dim}, requested {dim}")
            return coll

    def get_collection(self, name: str, dim: Optional[int] = None) -> Collection:
        with self._lock:
            if name in self._collections and not self._collections[name]._closed:
                return self._collections[name]
            if not self.collection_exists(name):
                raise CollectionNotFound(f"collection not found: {name!r}")
            return self.require_collection(name, dim=dim)

    def drop_collection(self, name: str) -> bool:
        validate_resource_name(name)
        with self._lock:
            if self.read_only:
                raise ReadOnly("database is read-only")
            coll = self._collections.pop(name, None)
            if coll is not None:
                coll.close()
            path = self.root / name
            if path.exists():
                shutil.rmtree(path)
                return True
            return False

    def update_collection_description(self, name: str, description: str) -> None:
        coll = self.get_collection(name)
        coll._check_writable()
        coll.description = description
        coll._write_config()

    def show_collections_details(self) -> dict:
        out = {}
        for name in self.list_collections():
            cfg = json.loads((self.root / name / "collection.json").read_text())
            out[name] = cfg
        return out

    # ── snapshot / restore (reference: engine.rs:7249-7734) ─────────────

    def snapshot_to(self, snapshot_path: str | Path) -> None:
        dst = Path(snapshot_path)
        if dst.exists():
            raise InvalidArgument(f"snapshot path already exists: {dst}")
        with self._lock:
            for coll in self._collections.values():
                if not coll.read_only:
                    coll.checkpoint()
            shutil.copytree(self.root, dst)
            write_atomic(
                dst / "snapshot.manifest.json",
                json.dumps({"format": "lynse_tpu_db_snapshot_v1", "database": self.name}).encode(),
            )

    def restore_collection_from_snapshot(self, snapshot_path: str | Path, name: str) -> Collection:
        src = Path(snapshot_path)
        if not src.exists():
            raise InvalidArgument(f"snapshot not found: {src}")
        validate_resource_name(name)
        with self._lock:
            if self.collection_exists(name):
                raise InvalidArgument(f"collection already exists: {name!r}")
            shutil.copytree(src, self.root / name)
            for junk in ("snapshot.manifest.json",):
                (self.root / name / junk).unlink(missing_ok=True)
            return self.get_collection(name)

    def import_collection_from_export(self, export_path: str | Path, name: str) -> Collection:
        import numpy as np

        src = Path(export_path)
        manifest = json.loads((src / "export.manifest.json").read_text())
        validate_resource_name(name)
        with self._lock:
            if self.collection_exists(name):
                raise InvalidArgument(f"collection already exists: {name!r}")
            coll = self.require_collection(name, dim=manifest["dim"])
            vectors = np.fromfile(src / "vectors.f32", dtype=np.float32).reshape(-1, manifest["dim"])
            eids, fields, deleted = [], [], []
            with open(src / "metadata.jsonl") as fh:
                for line in fh:
                    rec = json.loads(line)
                    eids.append(rec["id"])
                    fields.append(rec["fields"] or None)
                    deleted.append(rec.get("deleted", False))
            if len(eids):
                coll.add_records(vectors, eids, fields)
                dels = [e for e, d in zip(eids, deleted) if d]
                if dels:
                    coll.delete_items(dels)
            if manifest.get("index_mode"):
                coll.build_index(manifest["index_mode"])
            coll.checkpoint()
            return coll

    def close(self) -> None:
        with self._lock:
            for coll in self._collections.values():
                coll.close()
            self._collections.clear()


class DatabaseManager:
    """Root-level multi-database manager with an exclusive manager lock."""

    def __init__(self, root_path: str, read_only: bool = False, *, device):
        self.root = Path(root_path)
        self.read_only = read_only
        self.device = torch.device(device)
        self.root.mkdir(parents=True, exist_ok=True)
        self._dbs: dict[str, DatabaseEngine] = {}
        self._lock = threading.RLock()
        self._file_lock = None if read_only else FileLock(self.root / ".manager.lock")

    def list_databases(self) -> list[str]:
        out = []
        for child in sorted(self.root.iterdir()):
            if child.is_dir() and (child / FINGERPRINT).exists():
                out.append(child.name)
        return out

    def database_exists(self, name: str) -> bool:
        return (self.root / name / FINGERPRINT).exists()

    def create_database(self, name: str, drop_if_exists: bool = False) -> DatabaseEngine:
        validate_resource_name(name)
        with self._lock:
            if self.read_only:
                raise ReadOnly("manager is read-only")
            if drop_if_exists:
                self.drop_database(name)
            if not self.database_exists(name) and len(self.list_databases()) >= MAX_DATABASES:
                raise InvalidArgument(f"too many databases (max {MAX_DATABASES})")
            return self.get_database(name, create=True)

    def get_database(self, name: str, create: bool = False) -> DatabaseEngine:
        validate_resource_name(name)
        with self._lock:
            db = self._dbs.get(name)
            if db is None:
                if not create and not self.database_exists(name):
                    raise DatabaseNotFound(f"database not found: {name!r}")
                db = DatabaseEngine(self.root / name, name, read_only=self.read_only,
                                    device=self.device)
                self._dbs[name] = db
            return db

    def restore_database_from_snapshot(self, snapshot_path: str | Path, name: str) -> DatabaseEngine:
        """Materialize a database snapshot (DatabaseEngine.snapshot_to) under a
        new database name (reference: engine.rs:7249-7734 snapshot/restore)."""
        validate_resource_name(name)
        src = Path(snapshot_path)
        if not src.exists():
            raise InvalidArgument(f"snapshot not found: {src}")
        with self._lock:
            if self.read_only:
                raise ReadOnly("manager is read-only")
            if self.database_exists(name):
                raise InvalidArgument(f"database already exists: {name!r}")
            if len(self.list_databases()) >= MAX_DATABASES:
                raise InvalidArgument(f"too many databases (max {MAX_DATABASES})")
            shutil.copytree(src, self.root / name)
            (self.root / name / "snapshot.manifest.json").unlink(missing_ok=True)
            return self.get_database(name)

    def drop_database(self, name: str) -> bool:
        validate_resource_name(name)
        with self._lock:
            if self.read_only:
                raise ReadOnly("manager is read-only")
            db = self._dbs.pop(name, None)
            if db is not None:
                db.close()
            path = self.root / name
            if path.exists():
                shutil.rmtree(path)
                return True
            return False

    # convenience passthroughs used by clients
    def collection_exists(self, database: str, collection: str) -> bool:
        try:
            return self.get_database(database).collection_exists(collection)
        except DatabaseNotFound:
            return False

    def require_collection(self, database, collection, dim=None, drop_if_exists=False,
                           description=None, dtype="float32") -> Collection:
        return self.get_database(database, create=True).require_collection(
            collection, dim=dim, drop_if_exists=drop_if_exists,
            description=description, dtype=dtype,
        )

    def get_collection(self, database: str, collection: str, dim=None) -> Collection:
        return self.get_database(database).get_collection(collection, dim=dim)

    def close(self) -> None:
        with self._lock:
            for db in self._dbs.values():
                db.close()
            self._dbs.clear()
            if self._file_lock:
                self._file_lock.release()
                self._file_lock = None

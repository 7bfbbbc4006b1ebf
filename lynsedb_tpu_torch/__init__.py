"""lynsedb_tpu_torch — the LynseDB vector database on PyTorch and CUDA.

The embedded client API of :mod:`lynsedb_tpu` (reference:
python/lynse/__init__.py:12 VectorDBClient) over an engine whose device
compute is PyTorch plus hand-written CUDA kernels for Hopper
(``lynsedb_tpu_torch/csrc``). It reads and writes the same on-disk format as
the JAX package. The torch device is explicit: ``device="cuda"`` needs a card
and never falls back to the CPU; ``device="cpu"`` runs each kernel's plain
PyTorch version.
"""

from __future__ import annotations

import threading as _threading
from pathlib import Path
from typing import Union

import torch

from .metrics import Metric  # noqa: F401
from .ops.scan import resolve_device
from .result_view import ResultView  # noqa: F401

__version__ = "0.1.0"

MAX_DATABASES = 64

# In-process manager cache keyed by (resolved root, read_only, device),
# refcounted: a second VectorDBClient on the same root shares the live
# DatabaseManager instead of colliding on the exclusive .manager.lock
# (reference: python/lynse/_backend.py:88 caches managers the same way).
# close() releases the lock only when the last client sharing it closes.
_MANAGER_CACHE: dict = {}
_MANAGER_CACHE_LOCK = _threading.Lock()


def _acquire_manager(root_path: str, read_only: bool, device: torch.device):
    from .engine.database import DatabaseManager

    key = (root_path, bool(read_only), str(device))
    with _MANAGER_CACHE_LOCK:
        entry = _MANAGER_CACHE.get(key)
        if entry is not None:
            entry["refs"] += 1
            return entry["manager"]
        manager = DatabaseManager(root_path, read_only=read_only, device=device)
        _MANAGER_CACHE[key] = {"manager": manager, "refs": 1}
        return manager


def _release_manager(manager) -> None:
    with _MANAGER_CACHE_LOCK:
        for key, entry in list(_MANAGER_CACHE.items()):
            if entry["manager"] is manager:
                entry["refs"] -= 1
                if entry["refs"] <= 0:
                    del _MANAGER_CACHE[key]
                    manager.close()
                return
    manager.close()  # not cached (shouldn't happen) — close directly


class VectorDBClient:
    """Entry-point client for the embedded engine: data under the root path
    ``uri`` (or the configured default root), searched on ``device``."""

    def __init__(
        self,
        uri: Union[str, None, Path] = None,
        api_key: str = None,
        read_only: bool = False,
        timeout: float = 120.0,
        device: Union[str, torch.device] = "cuda",
    ):
        del timeout  # HTTP-only; kept for signature parity with lynsedb_tpu
        if isinstance(uri, Path):
            uri = uri.as_posix()
        if isinstance(uri, str) and uri.startswith(("http://", "https://")):
            raise NotImplementedError(
                "the HTTP client is not ported yet (ROADMAP A.11); pass a local root path"
            )
        from .configs.config import config

        self._api_key = api_key
        self.device = resolve_device(device)
        root_path = (
            str(Path(uri).resolve()) if uri is not None else str(config.LYNSE_DEFAULT_ROOT_PATH)
        )
        self._root_path = root_path
        self._manager = _acquire_manager(root_path, read_only, self.device)

    @property
    def is_read_only(self) -> bool:
        """Whether this client was opened read-only (reference:
        python/lynse/api/local_client.py:47)."""
        return bool(self._manager is not None and self._manager.read_only)

    # ── databases ────────────────────────────────────────────────────────

    def create_database(self, database_name: str, drop_if_exists: bool = False):
        self._manager.create_database(database_name, drop_if_exists=drop_if_exists)
        from .api.local_client import LocalClient

        return LocalClient(self._manager, database_name)

    def create_collection(
        self,
        database_name: str,
        collection: str,
        dim: int = None,
        n_threads: Union[int, None] = 10,
        warm_up: bool = False,
        drop_if_exists: bool = False,
        description: str = None,
        dtypes: str = "float32",
        default_index: Union[str, None] = "FLAT-IP",
        drop_database_if_exists: bool = False,
    ):
        """Create or open a database and collection in one call (reference:
        python/lynse/__init__.py:147)."""
        if drop_database_if_exists or database_name not in self.list_databases():
            db = self.create_database(database_name, drop_if_exists=drop_database_if_exists)
        else:
            db = self.get_database(database_name)
        return db.require_collection(
            collection,
            dim=dim,
            n_threads=n_threads,
            warm_up=warm_up,
            drop_if_exists=drop_if_exists,
            description=description,
            dtypes=dtypes,
            default_index=default_index,
        )

    def snapshot_database(self, database_name: str, snapshot_path) -> None:
        """Create a filesystem snapshot of a database (reference:
        python/lynse/__init__.py:254)."""
        self.get_database(database_name).snapshot_database(snapshot_path)

    def get_database(self, database_name: str):
        self._manager.get_database(database_name)
        from .api.local_client import LocalClient

        return LocalClient(self._manager, database_name)

    def list_databases(self) -> list:
        return self._manager.list_databases()

    def drop_database(self, database_name: str) -> None:
        self._manager.drop_database(database_name)

    def database_exists(self, database_name: str) -> bool:
        return self._manager.database_exists(database_name)

    def restore_database(self, snapshot_path, database_name: str):
        """Materialize a database snapshot under a new database name
        (reference: engine.rs:7249)."""
        self._manager.restore_database_from_snapshot(snapshot_path, database_name)
        from .api.local_client import LocalClient

        return LocalClient(self._manager, database_name)

    def close(self) -> None:
        if self._manager is not None:
            _release_manager(self._manager)
            self._manager = None

    def __repr__(self):
        return f"VectorDBClient({self._root_path!r}, device={str(self.device)!r})"

"""Embedded-mode client: LocalClient (database handle) + LocalCollection.

API-compatible with the reference's local client surface
(reference: python/lynse/api/local_client.py:35/:278) — the engine underneath
is :class:`lynsedb_tpu_torch.engine.Collection` on the client's torch device
instead of a PyO3 bridge.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ..engine import Collection as EngineCollection
from ..engine.database import DatabaseManager
from ..result_view import ResultView
from .embedding import embed_documents
from .records import (
    attach_documents,
    normalize_documents,
    normalize_external_ids,
    normalize_fields,
    normalize_vectors,
    validate_unique_external_ids,
)
from .rerank import apply_external_rerank, should_fetch_fields
from .session import DataInsertionSession

DEFAULT_COLLECTION_INDEX = "FLAT-IP"


class LocalClient:
    """Embedded-mode database handle."""

    def __init__(self, manager: DatabaseManager, database_name: str):
        self._manager = manager
        self.database_name = database_name

    @property
    def is_read_only(self) -> bool:
        return self._manager.read_only

    def require_collection(
        self,
        collection: str,
        dim: int = None,
        n_threads: Union[int, None] = 10,
        warm_up: bool = False,
        drop_if_exists: bool = False,
        description: str = None,
        dtypes: str = "float32",
        default_index: Union[str, None] = DEFAULT_COLLECTION_INDEX,
    ) -> "LocalCollection":
        existed_before = (
            self._manager.collection_exists(self.database_name, collection)
            if not drop_if_exists
            else False
        )
        coll = self._manager.require_collection(
            self.database_name,
            collection,
            dim=dim,
            drop_if_exists=drop_if_exists,
            description=description,
            dtype=dtypes,
        )
        lc = LocalCollection(
            self,
            coll,
            default_index=default_index if not existed_before else None,
        )
        if warm_up and coll.n_rows > 0:
            lc.warm_up()
        return lc

    def get_collection(self, collection: str, warm_up: bool = True) -> "LocalCollection":
        coll = self._manager.get_collection(self.database_name, collection)
        lc = LocalCollection(self, coll, default_index=None)
        if warm_up and coll.n_rows > 0:
            lc.warm_up()
        return lc

    def drop_collection(self, collection: str) -> None:
        self._manager.get_database(self.database_name, create=True).drop_collection(collection)

    def restore_database(self, snapshot_path, overwrite: bool = False) -> dict:
        """Restore THIS database from a filesystem snapshot (reference:
        python/lynse/api/local_client.py:191 — same name + overwrite flag).
        Refuses to clobber an existing database unless ``overwrite``."""
        from pathlib import Path

        from ..engine.errors import InvalidArgument

        if not Path(snapshot_path).exists():
            # validate BEFORE any drop: a bad path must never cost the
            # existing database
            raise InvalidArgument(f"snapshot not found: {snapshot_path}")
        if self._manager.database_exists(self.database_name):
            if not overwrite:
                raise InvalidArgument(
                    f"database already exists: {self.database_name!r} "
                    "(pass overwrite=True to replace it)"
                )
            self._manager.drop_database(self.database_name)
        self._manager.restore_database_from_snapshot(
            str(snapshot_path), self.database_name
        )
        return {"status": "success"}

    def drop_database(self) -> None:
        self._manager.drop_database(self.database_name)

    def database_exists(self) -> bool:
        return self._manager.database_exists(self.database_name)

    def show_collections(self) -> list:
        try:
            return self._manager.get_database(self.database_name).list_collections()
        except Exception:
            return []

    def show_collections_details(self) -> dict:
        return self._manager.get_database(self.database_name).show_collections_details()

    def update_collection_description(self, collection: str, description: str) -> None:
        self._manager.get_database(self.database_name).update_collection_description(
            collection, description
        )

    def snapshot_collection(self, collection: str, snapshot_path) -> None:
        self._manager.get_collection(self.database_name, collection).snapshot_to(snapshot_path)

    def export_collection(self, collection: str, export_path) -> None:
        self._manager.get_collection(self.database_name, collection).export_to(export_path)

    def restore_collection(self, snapshot_path, collection: str) -> "LocalCollection":
        db = self._manager.get_database(self.database_name, create=True)
        db.restore_collection_from_snapshot(snapshot_path, collection)
        return self.get_collection(collection, warm_up=False)

    def import_collection(self, export_path, collection: str) -> "LocalCollection":
        db = self._manager.get_database(self.database_name, create=True)
        db.import_collection_from_export(export_path, collection)
        return self.get_collection(collection, warm_up=False)

    def snapshot_database(self, snapshot_path) -> None:
        self._manager.get_database(self.database_name).snapshot_to(snapshot_path)

    def __repr__(self):
        return f"LocalClient(database={self.database_name!r})"

    __str__ = __repr__


class LocalCollection:
    """Embedded-mode collection handle."""

    def __init__(self, client: LocalClient, engine: EngineCollection, default_index=DEFAULT_COLLECTION_INDEX):
        self._client = client
        self._engine = engine
        self._default_index = default_index
        self._lock = threading.RLock()
        self.COMMIT_FLAG = True

    # ── meta ─────────────────────────────────────────────────────────────

    @property
    def name(self) -> str:
        return self._engine.name

    @property
    def dim(self) -> Optional[int]:
        return self._engine.dim

    @property
    def is_read_only(self) -> bool:
        return self._engine.read_only

    @property
    def vector_dtype(self) -> str:
        return self._engine.dtype

    @property
    def index_mode(self) -> Optional[str]:
        return self._engine.index_mode

    def exists(self) -> bool:
        return self._engine.config_path.exists()

    def warm_up(self) -> None:
        """Stage the corpus into device memory and build the kernels."""
        if self._engine.n_rows > 0 and self._engine.dim:
            try:
                probe = np.zeros((1, self._engine.dim), dtype=np.float32)
                self._engine.search(probe, k=1)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None and not self.COMMIT_FLAG and not self.is_read_only:
            self.commit()
        return False

    # ── writes ───────────────────────────────────────────────────────────

    def _maybe_build_default_index(self) -> None:
        if self._default_index and self._engine.index_mode is None:
            self._engine.build_index(self._default_index)

    def add(
        self,
        ids=None,
        *,
        vectors=None,
        documents=None,
        embed_func: Optional[Callable[[List[str]], Any]] = None,
        fields=None,
        batch_size: int = 1000,
        wire_dtype: str = "float32",
    ):
        """Add records. When ``ids`` is omitted, sequential integer IDs are
        assigned after the current max ID. Provide ``vectors`` or
        ``documents`` (lazy embedding)."""
        del wire_dtype  # embedded mode has no wire; kept for HTTPClient API parity
        if not isinstance(batch_size, int) or batch_size <= 0:
            raise ValueError("batch_size must be a positive integer")

        docs, _ = normalize_documents(documents) if documents is not None else (None, False)
        if vectors is None:
            if docs is None:
                raise ValueError("add() requires vectors or documents")
            vec_array = embed_documents(docs, embed_func=embed_func)
            n = vec_array.shape[0]
        else:
            vec_array = np.asarray(vectors, dtype=np.float32)
            if vec_array.ndim == 1:
                vec_array = vec_array.reshape(1, -1)
            elif vec_array.ndim != 2:
                raise ValueError("vectors must be a 1D vector or a 2D matrix")
            n = vec_array.shape[0]
            if n == 0:
                raise ValueError("vectors cannot be empty")
            if docs is not None and len(docs) != n:
                raise ValueError("documents length must match vectors row count")

        single = False
        if ids is None:
            start = self._engine.max_id() + 1
            eids = list(range(start, start + n))
        else:
            eids, single = normalize_external_ids(ids)
            if len(eids) != n:
                raise ValueError("ids length must match vectors")
            validate_unique_external_ids(eids)

        field_list = attach_documents(normalize_fields(fields, n), docs)
        has_fields = any(f is not None for f in field_list)

        with self._lock:
            added = []
            for i in range(0, n, batch_size):
                j = min(i + batch_size, n)
                added.extend(
                    self._engine.add_records(
                        vec_array[i:j], eids[i:j], field_list[i:j] if has_fields else None
                    )
                )
        self._maybe_build_default_index()
        self.COMMIT_FLAG = False
        return added[0] if (single or (ids is None and n == 1)) else added

    def upsert(
        self,
        ids,
        *,
        vectors=None,
        documents=None,
        embed_func=None,
        fields=None,
        wire_dtype: str = "float32",
    ):
        del wire_dtype  # embedded mode has no wire; kept for HTTPClient API parity
        eids, single = normalize_external_ids(ids)
        n = len(eids)
        docs, _ = normalize_documents(documents, n) if documents is not None else (None, False)
        if vectors is None:
            if docs is None:
                raise ValueError("upsert() requires vectors or documents")
            vec_array = embed_documents(docs, embed_func=embed_func)
        else:
            vec_array = normalize_vectors(vectors, n)
        field_list = attach_documents(normalize_fields(fields, n), docs)
        with self._lock:
            self._engine.upsert_items(vec_array, eids, field_list)
        self._maybe_build_default_index()
        self.COMMIT_FLAG = False
        return eids[0] if single else eids

    def update_fields(self, ids, fields) -> int:
        eids, _ = normalize_external_ids(ids)
        field_list = normalize_fields(fields, len(eids))
        n = self._engine.update_items(eids, field_list)
        self.COMMIT_FLAG = False
        return n

    def delete(self, ids) -> int:
        eids, _ = normalize_external_ids(ids)
        n = self._engine.delete_items(eids)
        self.COMMIT_FLAG = False
        return n

    def restore(self, ids) -> int:
        eids, _ = normalize_external_ids(ids)
        n = self._engine.restore_items(eids)
        self.COMMIT_FLAG = False
        return n

    def list_deleted_ids(self) -> list:
        return self._engine.list_deleted_ids()

    def insert_session(self, batch_size: int = 50_000) -> DataInsertionSession:
        return DataInsertionSession(self, batch_size)

    # ── durability ───────────────────────────────────────────────────────

    def commit(self) -> None:
        self._engine.commit()
        self.COMMIT_FLAG = True

    def flush(self) -> None:
        self._engine.flush()

    def prewarm(self) -> float:
        """Build the kernels and stage the corpus ahead of the first query
        (see engine/collection.py prewarm). Returns seconds spent."""
        return self._engine.prewarm()

    def checkpoint(self) -> None:
        self._engine.checkpoint()
        self.COMMIT_FLAG = True

    def close(self) -> None:
        self._engine.close()

    def snapshot_to(self, snapshot_path) -> None:
        self._engine.snapshot_to(snapshot_path)

    def export_to(self, export_path) -> None:
        self._engine.export_to(export_path)

    # ── blobs ────────────────────────────────────────────────────────────

    def write_blob(self, key: str, value: bytes) -> None:
        self._engine.write_blob(key, value)

    def read_blob(self, key: str) -> Optional[bytes]:
        return self._engine.read_blob(key)

    def read_blob_range(self, key: str, offset: int, length: int) -> Optional[bytes]:
        return self._engine.read_blob_range(key, offset, length)

    def delete_blob(self, key: str) -> bool:
        return self._engine.delete_blob(key)

    # ── info ─────────────────────────────────────────────────────────────

    def is_id_exists(self, id) -> bool:
        return self._engine.is_id_exists(id)

    def max_id(self) -> int:
        return self._engine.max_id()

    def compact(self) -> int:
        return self._engine.compact()

    def stats(self) -> dict:
        return self._engine.stats()

    @property
    def shape(self) -> tuple:
        return self._engine.shape()

    def list_fields(self) -> list:
        return self._engine.fields.list_fields()

    @property
    def description(self):
        return self._engine.description

    def update_description(self, description: str) -> None:
        self._engine._check_writable()
        self._engine.description = description
        self._engine._write_config()

    # ── index ────────────────────────────────────────────────────────────

    def build_index(self, index_mode: str = "FLAT-IP", **kwargs) -> None:
        self._engine.build_index(index_mode, **kwargs)

    def remove_index(self, field_name: str = "default") -> None:
        if field_name == "default":
            self._engine.remove_index()
        else:
            self._engine.vector_field(field_name).remove_index()

    # ── named vector fields ──────────────────────────────────────────────

    def create_vector_field(self, field_name: str, dim: int = None, metric: str = "ip",
                            dtypes: str = "float32") -> None:
        self._engine.create_vector_field(field_name, dim=dim, metric=metric, dtype=dtypes)

    def list_vector_fields(self) -> list:
        return self._engine.list_vector_fields()

    def add_named_vectors(self, field_name: str, ids, vectors) -> None:
        eids, _ = normalize_external_ids(ids)
        self._engine.add_named_vectors(field_name, eids, vectors)
        self.COMMIT_FLAG = False

    def build_vector_field_index(self, field_name: str, index_mode: str = "FLAT-IP", **kwargs):
        self._engine.vector_field(field_name).build_index(index_mode, **kwargs)

    # ── search ───────────────────────────────────────────────────────────

    def _map_and_fields(self, internal_ids, fetch_fields: bool):
        eids = self._engine.internal_to_external(np.asarray(internal_ids))
        arr = np.array(eids, dtype=object)
        # only collapse to int64 when every id IS an int — numpy's astype
        # would happily parse the string id "1" into the int 1
        if all(type(e) is int for e in eids):
            try:
                arr = arr.astype(np.int64)
            except (TypeError, ValueError, OverflowError):
                pass
        fields = self._engine.fields.retrieve_many(np.asarray(internal_ids)) if fetch_fields else []
        return arr, fields

    def search(
        self,
        vector=None,
        k: int = 10,
        *,
        document: Optional[str] = None,
        embed_func=None,
        where: Optional[str] = None,
        return_fields: bool = False,
        vector_field: str = "default",
        reranker: Optional[Callable[[Dict[str, Any]], Any]] = None,
        rerank_k: Optional[int] = None,
        rerank_with_fields: bool = False,
        nprobe: int = 10,
        approx: bool = False,
        eps: float = 1e-4,
        wire_dtype: str = "float32",
    ) -> ResultView:
        del wire_dtype  # embedded mode has no wire; kept for HTTPClient API parity
        eps = float(eps)
        if (vector is None) == (document is None):
            raise ValueError("search() requires exactly one of vector or document")
        if document is not None:
            vec = embed_documents([document], embed_func=embed_func)[0]
        else:
            vec = np.ascontiguousarray(vector, dtype=np.float32).ravel()

        result = self._engine.search(
            vec, k=k, where=where, field_name=vector_field, nprobe=nprobe,
            approx=approx, eps=eps,
        )
        need_fields = should_fetch_fields(
            return_fields=return_fields, reranker=reranker, rerank_with_fields=rerank_with_fields
        )
        target_engine = self._engine if vector_field == "default" else self._engine.vector_field(vector_field)
        eids = target_engine.internal_to_external(result.ids)
        ext = np.array(eids, dtype=object)
        # see _map_and_fields: only collapse to int64 when every id IS an int
        if all(type(e) is int for e in eids):
            try:
                ext = ext.astype(np.int64)
            except (TypeError, ValueError, OverflowError):
                pass
        raw_fields = (
            self._fields_for_external_ids(eids) if need_fields else []
        )
        ids, distances, reranked_fields = apply_external_rerank(
            ids=ext,
            scores=result.distances,
            fields=raw_fields,
            reranker=reranker,
            query={
                "type": "document_search" if document is not None else "vector_search",
                "document": document,
                "vector_field": vector_field,
                "vector": vec.tolist(),
                "where": where,
                "nprobe": nprobe,
                "approx": approx,
                "eps": eps,
            },
            rerank_k=rerank_k,
        )
        return ResultView(
            ids=ids,
            distances=distances,
            fields=reranked_fields if return_fields else [],
            k=len(ids),
            distance=result.distance_metric,
            index=result.index_type,
            result_type="search",
        )

    def _fields_for_external_ids(self, eids) -> list:
        iids = self._engine.external_to_internal(eids)
        return [self._engine.fields.retrieve(i) if i is not None else {} for i in iids]

    def _finish_search(self, result, *, return_fields, reranker, rerank_k,
                       rerank_with_fields, query) -> ResultView:
        need_fields = should_fetch_fields(
            return_fields=return_fields, reranker=reranker, rerank_with_fields=rerank_with_fields
        )
        ids, raw_fields = self._map_and_fields(result.ids, need_fields)
        out_ids, distances, reranked_fields = apply_external_rerank(
            ids=ids,
            scores=result.distances,
            fields=raw_fields if need_fields else [],
            reranker=reranker,
            query=query,
            rerank_k=rerank_k,
        )
        return ResultView(
            ids=out_ids,
            distances=distances,
            fields=reranked_fields if return_fields else [],
            k=len(out_ids),
            distance=result.distance_metric,
            index=result.index_type,
            result_type="search",
        )

    def add_sparse_vectors(self, vectors, ids) -> dict:
        """Attach sparse feature vectors to existing IDs."""
        eids, _ = normalize_external_ids(ids)
        self._engine.add_sparse_vectors(eids, vectors)
        self.COMMIT_FLAG = False
        return {"status": "success"}

    def search_sparse(
        self,
        vector,
        k: int = 10,
        *,
        where: Optional[str] = None,
        return_fields: bool = False,
        reranker: Optional[Callable[[Dict[str, Any]], Any]] = None,
        rerank_k: Optional[int] = None,
        rerank_with_fields: bool = True,
    ) -> ResultView:
        """Sparse vector search using inner product."""
        result = self._engine.search_sparse(vector, k=k, where=where)
        return self._finish_search(
            result,
            return_fields=return_fields,
            reranker=reranker,
            rerank_k=rerank_k,
            rerank_with_fields=rerank_with_fields,
            query={"type": "sparse_search", "vector": vector, "where": where},
        )

    def bm25_search(
        self,
        text: str,
        k: int = 10,
        *,
        text_fields: Optional[List[str]] = None,
        where: Optional[str] = None,
        return_fields: bool = False,
        reranker: Optional[Callable[[Dict[str, Any]], Any]] = None,
        rerank_k: Optional[int] = None,
        rerank_with_fields: bool = True,
    ) -> ResultView:
        """BM25 keyword search over metadata fields."""
        result = self._engine.text_search(text, k=k, text_fields=text_fields, where=where)
        return self._finish_search(
            result,
            return_fields=return_fields,
            reranker=reranker,
            rerank_k=rerank_k,
            rerank_with_fields=rerank_with_fields,
            query={"type": "bm25_search", "text": text, "text_fields": text_fields, "where": where},
        )

    def hybrid_search(
        self,
        vector=None,
        text: Optional[str] = None,
        k: int = 10,
        *,
        where: Optional[str] = None,
        text_fields: Optional[List[str]] = None,
        fusion: str = "rrf",
        vector_weight: float = 1.0,
        text_weight: float = 1.0,
        rrf_k: float = 60.0,
        candidate_limit: Optional[int] = None,
        nprobe: int = 10,
        return_fields: bool = False,
        reranker: Optional[Callable[[Dict[str, Any]], Any]] = None,
        rerank_k: Optional[int] = None,
        rerank_with_fields: bool = True,
    ) -> ResultView:
        """Hybrid vector + BM25 text search with RRF or weighted fusion."""
        vec = None if vector is None else np.ascontiguousarray(vector, dtype=np.float32).ravel()
        result = self._engine.hybrid_search(
            vector=vec,
            query_text=text,
            k=k,
            where=where,
            text_fields=text_fields,
            fusion=fusion,
            vector_weight=vector_weight,
            text_weight=text_weight,
            rrf_k=rrf_k,
            candidate_limit=candidate_limit or 0,
            nprobe=nprobe,
        )
        return self._finish_search(
            result,
            return_fields=return_fields,
            reranker=reranker,
            rerank_k=rerank_k,
            rerank_with_fields=rerank_with_fields,
            query={
                "type": "hybrid_search",
                "vector": None if vec is None else vec.tolist(),
                "text": text,
                "text_fields": text_fields,
                "where": where,
                "fusion": fusion,
                "vector_weight": float(vector_weight),
                "text_weight": float(text_weight),
                "rrf_k": float(rrf_k),
                "candidate_limit": candidate_limit,
                "nprobe": nprobe,
            },
        )

    def hybrid_search_stream(
        self,
        vectors=None,
        texts: Optional[List[str]] = None,
        k: int = 10,
        *,
        where: Optional[str] = None,
        text_fields: Optional[List[str]] = None,
        fusion: str = "rrf",
        vector_weight: float = 1.0,
        text_weight: float = 1.0,
        rrf_k: float = 60.0,
        candidate_limit: Optional[int] = None,
        nprobe: int = 10,
    ) -> List[ResultView]:
        """Pipelined hybrid stream: one fused batched device dispatch for all
        vector scans, BM25 host scoring overlapped (engine
        hybrid_search_stream). Throughput-oriented twin of hybrid_search."""
        vecs = None if vectors is None else np.ascontiguousarray(
            np.atleast_2d(np.asarray(vectors, dtype=np.float32)))
        results = self._engine.hybrid_search_stream(
            vectors=vecs, texts=texts, k=k, where=where,
            text_fields=text_fields, fusion=fusion,
            vector_weight=vector_weight, text_weight=text_weight,
            rrf_k=rrf_k, candidate_limit=candidate_limit or 0, nprobe=nprobe,
        )
        out = []
        for res in results:
            ids, _ = self._map_and_fields(res.ids, False)
            out.append(ResultView(
                ids=ids, distances=res.distances, fields=[], k=len(ids),
                distance=res.distance_metric, index=res.index_type,
                result_type="search"))
        return out

    def search_profile(self, vector, k: int = 10, *, where=None, nprobe: int = 10,
                       reranker=None, rerank_k: Optional[int] = None) -> dict:
        """Per-query explain (reference: engine.rs:5005 search_with_profile).
        When a reranker participates, its wall time lands in rerank_us."""
        result = self._engine.search(vector, k=k, where=where, nprobe=nprobe, profile=True)
        prof = dict(result.profile)
        if reranker is not None:
            import time as _time

            t0 = _time.perf_counter()
            eids = self._engine.internal_to_external(result.ids)
            apply_external_rerank(
                ids=np.array(eids, dtype=object),
                scores=result.distances,
                fields=self._fields_for_external_ids(eids),
                reranker=reranker,
                query={"type": "vector_search", "where": where, "nprobe": nprobe},
                rerank_k=rerank_k,
            )
            prof["rerank_us"] = int((_time.perf_counter() - t0) * 1e6)
            prof["total_us"] = prof.get("total_us", 0) + prof["rerank_us"]
        return prof

    def batch_search(
        self,
        vectors,
        k: int = 10,
        *,
        where: Optional[str] = None,
        return_fields: bool = False,
        vector_field: str = "default",
        nprobe: int = 10,
        approx: bool = False,
        eps: float = 1e-4,
        wire_dtype: str = "float32",
    ) -> List[ResultView]:
        del wire_dtype  # embedded mode has no wire; kept for HTTPClient API parity
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(vectors, dtype=np.float32)))
        res = self._engine.batch_search(
            q, k=k, where=where, field_name=vector_field, nprobe=nprobe, approx=approx, eps=eps
        )
        out = []
        for b in range(len(q)):
            live = np.asarray(res.ids[b]) >= 0  # strip rectangular -1 pads
            ids, fields = self._map_and_fields(np.asarray(res.ids[b])[live], return_fields)
            out.append(
                ResultView(
                    ids=ids,
                    distances=np.asarray(res.distances[b])[live],
                    fields=fields if return_fields else [],
                    k=len(ids),
                    distance=res.distance_metric,
                    index=res.index_type,
                    result_type="search",
                )
            )
        return out

    def search_stream(
        self,
        vectors,
        k: int = 10,
        *,
        where: Optional[str] = None,
        window: Optional[int] = None,
        return_fields: bool = False,
    ) -> List[ResultView]:
        """Pipelined per-query search stream (throughput-oriented serving)."""
        results = self._engine.search_stream(vectors, k, where=where, window=window)
        out = []
        for res in results:
            ids, fields = self._map_and_fields(res.ids, return_fields)
            out.append(
                ResultView(
                    ids=ids,
                    distances=res.distances,
                    fields=fields if return_fields else [],
                    k=len(ids),
                    distance=res.distance_metric,
                    index=res.index_type,
                    result_type="search",
                )
            )
        return out

    def search_range(self, vector, threshold, max_results: int = 1000, *, where=None) -> ResultView:
        res = self._engine.search_range(vector, float(threshold), max_results, where=where)
        ids, _ = self._map_and_fields(res.ids, False)
        return ResultView(
            ids=ids,
            distances=res.distances,
            k=len(ids),
            distance=res.distance_metric,
            index=res.index_type,
            result_type="search",
        )

    # ── data queries ─────────────────────────────────────────────────────

    def query(self, where=None, filter_ids=None, return_ids_only: bool = False):
        iids = self._engine.query(where=where, filter_ids=filter_ids)
        ids, fields = self._map_and_fields(iids, not return_ids_only)
        if return_ids_only:
            return ids
        return ResultView(ids=ids, fields=fields, result_type="query")

    def query_vectors(self, where=None, filter_ids=None) -> ResultView:
        iids = self._engine.query(where=where, filter_ids=filter_ids)
        vectors = self._engine.get_vectors(iids)
        ids, fields = self._map_and_fields(iids, True)
        return ResultView(ids=ids, vectors=vectors, fields=fields, result_type="data")

    def head(self, n: int = 5) -> ResultView:
        iids = self._engine.head_ids(n)
        vectors = self._engine.get_vectors(iids)
        ids, fields = self._map_and_fields(iids, True)
        return ResultView(ids=ids, vectors=vectors, fields=fields, result_type="data")

    def tail(self, n: int = 5) -> ResultView:
        iids = self._engine.tail_ids(n)
        vectors = self._engine.get_vectors(iids)
        ids, fields = self._map_and_fields(iids, True)
        return ResultView(ids=ids, vectors=vectors, fields=fields, result_type="data")

    def __repr__(self):
        return (
            f"LocalCollection(name={self.name!r}, shape={self.shape}, "
            f"index_mode={self.index_mode!r})"
        )

    __str__ = __repr__

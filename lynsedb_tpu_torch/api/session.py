"""Batched insert session (reference: python/lynse/execution_layer/session.py:16).

``with collection.insert_session() as s: s.add(...)`` — buffers adds, flushes
in batches, rolls back unflushed rows on exception, commits on clean exit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DEFAULT_BATCH = 50_000


class DataInsertionSession:
    def __init__(self, collection, batch_size: int = DEFAULT_BATCH):
        self._coll = collection
        self._batch = int(batch_size)
        self._ids: list = []
        self._vectors: list = []
        self._fields: list = []
        self._failed = False

    def add(self, ids=None, *, vectors=None, fields=None):
        from .records import normalize_external_ids, normalize_fields, normalize_vectors

        if vectors is None:
            raise ValueError("session.add() requires vectors")
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        n = arr.shape[0]
        if ids is None:
            eids = [None] * n
        else:
            eids, _ = normalize_external_ids(ids)
            if len(eids) != n:
                raise ValueError("ids length must match vectors")
        flist = normalize_fields(fields, n)
        self._ids.extend(eids)
        self._vectors.append(arr)
        self._fields.extend(flist)
        if sum(len(v) for v in self._vectors) >= self._batch:
            self.flush()

    def flush(self):
        if not self._vectors:
            return
        vectors = np.concatenate(self._vectors, axis=0)
        ids = self._ids
        fields = self._fields
        self._ids, self._vectors, self._fields = [], [], []
        if all(i is None for i in ids):
            self._coll.add(vectors=vectors, fields=fields)
        else:
            if any(i is None for i in ids):
                raise ValueError("cannot mix auto and explicit ids in one session")
            self._coll.add(ids, vectors=vectors, fields=fields)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # discard buffered, unflushed rows
            self._ids, self._vectors, self._fields = [], [], []
            return False
        self.flush()
        self._coll.commit()
        return False

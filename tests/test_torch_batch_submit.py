"""``Collection.batch_search_submit`` of the port against the JAX package's.

The same seeded rows with a ``bucket`` field go into a collection of each
package (``lynsedb_tpu_torch`` on the CPU); each asks for an async flat-path
resolver: unfiltered, under ``where="bucket = 1"``, after
``build_index("IVF-L2")`` (None: the index path is synchronous), on an empty
collection (None) and with a query of the wrong width (DimensionMismatch).

Tolerances: ids equal except at a near-tie (float64 distances within the
distance tolerance: f32 sums in another order may swap them); distances rtol
1e-5, atol 1e-4. The port's resolver returns exactly what its own
``batch_search`` returns.
"""

from __future__ import annotations

import numpy as np
import pytest

import lynsedb_tpu
import lynsedb_tpu_torch
from lynsedb_tpu.engine.errors import DimensionMismatch as JaxDimensionMismatch
from lynsedb_tpu_torch.engine.errors import DimensionMismatch
from test_torch_scan import assert_same_ids

DIM, N, B, K = 16, 3000, 7, 10
CASES = ("unfiltered", "bucket = 1", "IVF-L2", "empty", "dim mismatch")


def _rows():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(N, DIM)).astype(np.float32),
            rng.normal(size=(B, DIM)).astype(np.float32))


def _engine(client, x: np.ndarray, case: str):
    db = client.create_database("bss", drop_if_exists=True)
    coll = db.require_collection("c", dim=DIM)
    if case != "empty":
        coll.add(list(range(N)), vectors=x, fields=[{"bucket": i % 3} for i in range(N)])
        coll.commit()
    if case == "IVF-L2":
        coll.build_index("IVF-L2", n_clusters=8)
    return coll._engine


@pytest.mark.parametrize("case", CASES)
def test_batch_search_submit_matches_jax(tmp_path, case):
    x, q = _rows()
    jeng = _engine(lynsedb_tpu.VectorDBClient(str(tmp_path / "jax")), x, case)
    teng = _engine(lynsedb_tpu_torch.VectorDBClient(str(tmp_path / "torch"), device="cpu"), x,
                   case)
    if case == "dim mismatch":
        bad = np.zeros((2, DIM + 1), np.float32)
        with pytest.raises(JaxDimensionMismatch):
            jeng.batch_search_submit(bad, K)
        with pytest.raises(DimensionMismatch):
            teng.batch_search_submit(bad, K)
        return
    where = case if case.startswith("bucket") else None
    jres, tres = (eng.batch_search_submit(q, K, where=where) for eng in (jeng, teng))
    if case in ("IVF-L2", "empty"):
        assert jres is None and tres is None
        return
    want, got = jres(), tres()
    ids = np.asarray(got.ids)
    assert ids.shape == np.asarray(want.ids).shape == (B, K)
    assert_same_ids(ids, np.asarray(want.ids), x, q, teng.metric.value)
    np.testing.assert_allclose(np.asarray(got.distances), np.asarray(want.distances), rtol=1e-5,
                               atol=1e-4)
    assert (got.distance_metric, got.index_type) == (want.distance_metric, want.index_type)
    if where is not None:
        assert (ids % 3 == 1).all()
    sync = teng.batch_search(q, K, where=where)
    np.testing.assert_array_equal(ids, np.asarray(sync.ids))
    np.testing.assert_array_equal(np.asarray(got.distances), np.asarray(sync.distances))
    assert (got.distance_metric, got.index_type) == (sync.distance_metric, sync.index_type)

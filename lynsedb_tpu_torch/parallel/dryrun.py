"""A dry run of the mesh plane over virtual shards on one device.

Port of the JAX package's ``dryrun_multichip`` (__graft_entry__.py:32):

    python -c "from lynsedb_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(4, 'cuda')"

runs, over ``n_devices`` virtual shards of ``device`` (``"cuda"``: one card
runs the kernels; ``"cpu"``: their plain versions), one sharded search step
(K21a), one sharded k-means step (K21b), the Collection plane (add, commit,
search, a filter, delete, search_stream) and the quantized plane
(FLAT-IP-SQ8), each checked against numpy. Raises on any mismatch.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from ..metrics import Metric
from . import mesh as M


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    import lynsedb_tpu_torch as lynse

    from ..ops.scan import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    data_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = M.make_mesh(n_devices, data_axis=data_axis, devices=[dev] * n_devices)

    rng = np.random.default_rng(0)
    n, d, b, k = 64 * n_devices, 32, 2 * data_axis, 5
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    queries = rng.normal(size=(b, d)).astype(np.float32)

    xs, vs = M.shard_corpus(mesh, corpus, valid)
    qs, _ = M.shard_queries(mesh, queries)
    dists, ids = M.sharded_search_fn(mesh, metric=Metric.IP, k=k)(xs, qs, vs)
    ids = ids.cpu().numpy()
    _check(ids.shape == (b, k), f"search ids shaped {ids.shape}")
    want = np.argsort(-(queries @ corpus.T), axis=1)[:, :k]
    _check(np.array_equal(np.sort(ids, axis=1), np.sort(want, axis=1)), "sharded merge mismatch")

    centroids = corpus[:8].copy()
    new_c, counts = M.sharded_kmeans_step_fn(mesh)(xs, torch.from_numpy(centroids), vs)
    _check(tuple(new_c.shape) == centroids.shape, "k-means centroids' shape")
    _check(float(counts.sum()) == float(valid.sum()), "k-means counts")

    M.set_default_mesh(mesh)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            client = lynse.VectorDBClient(tmp + "/db", device=dev)
            db = client.create_database("dry", drop_if_exists=True)
            coll = db.require_collection("c", dim=d, drop_if_exists=True)
            coll.add(list(range(n)), vectors=corpus, fields=[{"b": i % 3} for i in range(n)])
            coll.commit()
            _check(coll._engine.corpus().mesh is mesh, "the collection's corpus is not sharded")

            res = coll.search(corpus[5], k=k)
            want = np.argsort(-(corpus[5] @ corpus.T))[:k]
            _check(set(int(x) for x in res.ids) == set(want.tolist()), "search")

            resf = coll.search(corpus[5], k=k, where="b = 1")
            scores = corpus[5] @ corpus.T
            wantf = [i for i in np.argsort(-scores) if i % 3 == 1][:k]
            _check([int(x) for x in resf.ids] == wantf, "filtered search")

            coll.delete([int(want[0])])
            res2 = coll.search(corpus[5], k=k)
            _check(int(want[0]) not in [int(x) for x in res2.ids], "a deleted row returned")

            stream = coll.search_stream(corpus[:6], k=3, window=4)
            _check(len(stream) == 6, "search_stream")

            coll.build_index("FLAT-IP-SQ8")
            resq = coll.search(corpus[7], k=k)
            scores_q = corpus[7] @ corpus.T
            scores_q[int(want[0])] = -np.inf  # deleted above
            wantq = np.argsort(-scores_q)[:k]
            _check(set(int(x) for x in resq.ids) == set(wantq.tolist()), "FLAT-IP-SQ8")
            client.close()
    finally:
        M.set_default_mesh(None)

    print(f"dryrun_multichip OK on {n_devices} virtual shards of {dev} (mesh {mesh.shape}; "
          f"sharded search, k-means step, Collection and quantized planes verified)", flush=True)

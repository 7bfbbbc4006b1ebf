#!/usr/bin/env python3
"""Search latency of lynsedb_tpu_torch on one CUDA card, by corpus and index
mode.

    python3 lynsedb_tpu_torch/tools/flat_latency.py [--corpus isotropic mixture hist geo]
                                                    [--index FLAT-IP FLAT-IP-SQ8 ...]
                                                    [--nprobe N] [--n-clusters N] [--insert N]
                                                    [--where FILTER] [--mesh-shards S]
                                                    [--tier resident host_rescore] [--approx]
                                                    [--package-root DIR]

Drives what chip_smoke.py's flat phase drives, unfiltered: a collection of
1,000,000 x 128 f32 rows with fields {"bucket": i % 10}, then for each
``--index`` mode (default FLAT-IP; any other mode, such as FLAT-IP-SQ8 or
HNSW-L2, is built first, and its build seconds reported, with the seconds of
each build phase where the index records them and a SHA-256 of what the
build decided: a graph's adjacency, IVF's centroids; ``--n-clusters`` sets
IVF's and SPANN's) 100 distinct single
searches, then 4 batch searches at B=16 and 4 at B=256 (k=10, ``--nprobe``,
the client's default 10 unless given; host clock around each call). The
corpora are seeded numpy: ``isotropic`` is gaussian rows, ``mixture``
chip_smoke.py's mixture of 2,000 gaussian clusters (both duplicate 1,000
rows), ``hist`` that mixture exponentiated (histograms, for
FLAT-JENSEN-SHANNON, -HELLINGER, -WASSERSTEIN; the queries exponentiated
gaussians), ``geo`` 1,000,000 (lon, lat) points uniform on the sphere (for
FLAT-HAVERSINE and HNSW-HAVERSINE; the queries too). Then 20 more single
searches run under torch.profiler to read the device time of one search, in
all and by kernel. ``--insert N``
then adds N more rows of the corpus's kind, commits them (an index links or
posts them in place), reports the commit's seconds and times the mode again.
``--where FILTER`` runs every timed search under that filter (for example
``"bucket = 3"``: 100,000 rows, the gather route K11 -> K5 -> K3), after one
untimed search has resolved it. ``--mesh-shards S`` serves the collection
from a corpus sharded over S virtual shards of the card (``make_mesh(S,
devices=["cuda:0"] * S)`` as the default mesh). ``--tier host_rescore``
restages the corpus under the device budget of its host-rescore tier (the
centred bf16 copy on the card, the f32 rows on the host; the port's own
byte count) after each mode's build, and ``--approx`` runs every timed
search with ``approx=True`` (the L1 family's K9 -> K5 -> K10 -> K5 plan).

``--package-root DIR`` imports lynsedb_tpu_torch from DIR (for example an
older commit unpacked with ``git archive``), so one script times two trees on
the same card and data. Prints one JSON line per corpus and mode: p50/p99 ms,
q/s, device ms per single search and per B=256 batch (two more batches of
fresh queries, profiled) (null where the profiler saw no device time) and
by kernel name, and the seconds the garbage collector took during the timed
calls.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N, DIM, K, N_CENTERS, SPREAD, SEED = 1_000_000, 128, 10, 2000, 0.6, 0


def sphere_points(rng, n: int) -> np.ndarray:
    """n (lon, lat) points in degrees, uniform on the sphere."""
    lon, lat = rng.uniform(-180.0, 180.0, n), np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, n)))
    return np.stack([lon, lat], 1).astype(np.float32)


def make_corpus(kind: str, rng) -> np.ndarray:
    if kind == "geo":
        return sphere_points(rng, N)
    if kind == "isotropic":
        x = rng.normal(size=(N, DIM)).astype(np.float32)
    else:
        centers = rng.normal(size=(N_CENTERS, DIM)).astype(np.float32)
        x = centers[rng.integers(0, N_CENTERS, N)]
        x += SPREAD * rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]
    return np.exp(x) if kind == "hist" else x


def make_queries(kind: str, rng, *shape: int) -> np.ndarray:
    """Queries of the corpus's kind, shape + (its width,)."""
    if kind == "geo":
        return sphere_points(rng, int(np.prod(shape))).reshape(*shape, 2)
    q = rng.normal(size=(*shape, DIM)).astype(np.float32)
    return np.exp(q) if kind == "hist" else q


class GcClock:
    """Seconds spent in garbage collections since the last read."""

    def __init__(self):
        self.total, self._t0 = 0.0, 0.0
        gc.callbacks.append(self._tick)

    def _tick(self, phase, _info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._t0

    def read(self) -> float:
        total, self.total = self.total, 0.0
        return total


def device_ms_per_call(torch, search, queries) -> tuple[float | None, dict]:
    """Mean device time of one call ``search(queries[i])``: the sum of the
    kernels torch.profiler saw, and that sum by kernel name (the top 8)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for qv in queries:
            search(qv)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None) or getattr(
                ev, "self_cuda_time_total", 0.0)
            by_name[ev.key[:60]] = by_name.get(ev.key[:60], 0.0) + us / 1e3 / len(queries)
    total = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return (total if total > 0 else None), top


def timed(torch, coll, singles, b16, b256, extra, extra256, nprobe: int, where,
          clock: GcClock, approx: bool = False) -> dict:
    """p50 / p99 of the single searches, q/s of the batches, the garbage
    collector's seconds, the device time of one search and of one B=256
    batch (torch.profiler)."""
    kw = {"k": K, "nprobe": nprobe, "where": where, **({"approx": True} if approx else {})}
    coll.search(singles[0] + 2.0, **kw)  # resolves the filter
    clock.read()
    lat = []
    for qv in singles:
        t0 = time.perf_counter()
        coll.search(qv, **kw)
        lat.append(time.perf_counter() - t0)
    out = {"p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3), "single_gc_s": clock.read()}
    for b, blocks in ((16, b16), (256, b256)):
        secs = []
        for blk in blocks:
            t0 = time.perf_counter()
            coll.batch_search(blk, **kw)
            secs.append(time.perf_counter() - t0)
        out[f"qps_b{b}"] = b * len(blocks) / sum(secs)
        out[f"call_s_b{b}"] = secs
        out[f"gc_s_b{b}"] = clock.read()
    out["device_ms_single"], out["device_ms_by_kernel"] = device_ms_per_call(
        torch, lambda qv: coll.search(qv, **kw), extra)
    out["device_ms_b256"], out["device_ms_b256_by_kernel"] = device_ms_per_call(
        torch, lambda blk: coll.batch_search(blk, **kw), extra256)
    return out


def built_sha256(index) -> dict:
    """SHA-256 of what a build decided, so two trees' builds compare in one
    call: a graph's adjacency (HNSW's layer 0, DiskANN's graph) and IVF's
    centroids (empty for other modes)."""
    out = {}
    for key, attrs in (("adjacency_sha256", ("layer0_np", "graph_np")),
                       ("centroids_sha256", ("centroids_np",))):
        arr = next((getattr(index, a) for a in attrs if getattr(index, a, None) is not None), None)
        if arr is not None:
            out[key] = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def run(lynse, torch, kind: str, modes: list, nprobe: int, n_clusters, insert: int, where,
        root: str, clock: GcClock, tier: str = "resident", approx: bool = False):
    """Yields one result per index mode on one corpus (two with ``insert``)."""
    rng = np.random.default_rng(SEED)
    x = make_corpus(kind, rng)
    singles = make_queries(kind, rng, 100)
    b16 = make_queries(kind, rng, 4, 16)
    b256 = make_queries(kind, rng, 4, 256)
    extra = make_queries(kind, rng, 20)
    extra256 = make_queries(kind, rng, 2, 256)
    client = lynse.VectorDBClient(root, device="cuda")
    db = client.create_database(kind, drop_if_exists=True)
    coll = db.require_collection("vectors", dim=x.shape[1])
    coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
    coll.commit()
    coll.prewarm()
    for mode in modes:
        out = {"corpus": kind, "index": mode, "nprobe": nprobe, "where": where, "approx": approx}
        if mode != "FLAT-IP":
            kw = {"n_clusters": n_clusters} if n_clusters and mode.startswith(("IVF", "SPANN")) \
                else {}
            t0 = time.perf_counter()
            coll.build_index(mode, **kw)
            out["build_s"] = time.perf_counter() - t0
            index = coll._engine._index
            out["build_phases_s"] = getattr(index, "last_build_phases", None)
            out.update(built_sha256(index))
            coll.search(singles[0] + 1.0, k=K, nprobe=nprobe)  # stages the index
        if tier == "host_rescore":
            from lynsedb_tpu_torch.ops import scan

            corpus = coll._engine.corpus()
            scan.DEVICE_BYTES = corpus.host_rescore_bytes(corpus._cap_for(corpus.n))
            corpus.restage()
            coll._engine._search_cache.clear()
        out["tier"] = coll._engine.corpus().tier
        yield {**out, **timed(torch, coll, singles, b16, b256, extra, extra256, nprobe, where,
                              clock, approx)}
        if insert:
            rows = make_corpus(kind, np.random.default_rng(SEED + 1))[:insert]
            t0 = time.perf_counter()
            coll.add(vectors=rows, fields=[{"bucket": i % 10} for i in range(insert)])
            coll.commit()
            torch.cuda.synchronize()
            out.update({"inserted": insert, "insert_s": time.perf_counter() - t0})
            coll.search(singles[0] + 1.0, k=K, nprobe=nprobe)  # stages the grown index
            yield {**out, **timed(torch, coll, singles, b16, b256, extra, extra256, nprobe, where,
                              clock, approx)}
    client.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", nargs="+", choices=("isotropic", "mixture", "hist", "geo"),
                    default=["isotropic", "mixture"])
    ap.add_argument("--index", nargs="+", default=["FLAT-IP"],
                    help="index modes, e.g. FLAT-IP FLAT-IP-SQ8 FLAT-IP-PQ HNSW-L2")
    ap.add_argument("--nprobe", type=int, default=10,
                    help="the searches' nprobe (IVF probes; HNSW / DiskANN beam width)")
    ap.add_argument("--n-clusters", type=int, default=None,
                    help="IVF's and SPANN's cluster count (the index's default unless given)")
    ap.add_argument("--insert", type=int, default=0,
                    help="rows added and committed after a mode's timings, then timed again")
    ap.add_argument("--where", default=None,
                    help='a filter every timed search runs under, e.g. "bucket = 3"')
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="serve from this many virtual shards of the card (0: no mesh)")
    ap.add_argument("--tier", choices=("resident", "host_rescore"), default="resident",
                    help="the corpus's device tier (host_rescore: the bf16 copy on the card)")
    ap.add_argument("--approx", action="store_true", help="every timed search with approx=True")
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

    import lynsedb_tpu_torch as lynse

    if not torch.cuda.is_available():
        print("flat_latency: needs a CUDA card", file=sys.stderr)
        return 2
    if args.mesh_shards:
        from lynsedb_tpu_torch.parallel.mesh import make_mesh, set_default_mesh

        set_default_mesh(make_mesh(args.mesh_shards, devices=["cuda:0"] * args.mesh_shards))
    clock = GcClock()
    for kind in args.corpus:
        with tempfile.TemporaryDirectory(prefix="lynse_flat_") as root:
            for out in run(lynse, torch, kind, args.index, args.nprobe, args.n_clusters,
                           args.insert, args.where, root, clock, args.tier, args.approx):
                out["package"] = str(Path(lynse.__file__).resolve().parent)
                out["mesh_shards"] = args.mesh_shards
                print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""FLAT search latency of lynsedb_tpu_torch on one CUDA card, by corpus.

    python3 lynsedb_tpu_torch/tools/flat_latency.py [--corpus isotropic mixture]
                                                    [--package-root DIR]

Drives what chip_smoke.py's flat phase drives, unfiltered: a FLAT-IP
collection of 1,000,000 x 128 f32 rows with fields {"bucket": i % 10}, 100
distinct single searches, then 4 batch searches at B=16 and 4 at B=256
(k=10, host clock around each call). The corpora are seeded numpy:
``isotropic`` is gaussian rows, ``mixture`` chip_smoke.py's mixture of 2,000
gaussian clusters; both duplicate 1,000 rows. Then 20 more single searches
run under torch.profiler to read the device time of one search.

``--package-root DIR`` imports lynsedb_tpu_torch from DIR (for example an
older commit unpacked with ``git archive``), so one script times two trees on
the same card and data. Prints one JSON line per corpus: p50/p99 ms, q/s,
device ms per single search (null where the profiler saw no device time) and
the seconds the garbage collector took during the timed calls.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N, DIM, K, N_CENTERS, SPREAD, SEED = 1_000_000, 128, 10, 2000, 0.6, 0


def make_corpus(kind: str, rng) -> np.ndarray:
    if kind == "isotropic":
        x = rng.normal(size=(N, DIM)).astype(np.float32)
    else:
        centers = rng.normal(size=(N_CENTERS, DIM)).astype(np.float32)
        x = centers[rng.integers(0, N_CENTERS, N)]
        x += SPREAD * rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]
    return x


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


def device_ms_per_search(torch, coll, queries) -> float | None:
    """Mean device time of one search (sum of the kernels torch.profiler saw)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for qv in queries:
            coll.search(qv, k=K)
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us += getattr(ev, "self_device_time_total", None) or getattr(
                ev, "self_cuda_time_total", 0.0)
    return us / 1e3 / len(queries) if us > 0 else None


def run(lynse, torch, kind: str, root: str, clock: GcClock) -> dict:
    rng = np.random.default_rng(SEED)
    x = make_corpus(kind, rng)
    singles = rng.normal(size=(100, DIM)).astype(np.float32)
    b16 = rng.normal(size=(4, 16, DIM)).astype(np.float32)
    b256 = rng.normal(size=(4, 256, DIM)).astype(np.float32)
    extra = rng.normal(size=(20, DIM)).astype(np.float32)
    client = lynse.VectorDBClient(root, device="cuda")
    db = client.create_database(kind, drop_if_exists=True)
    coll = db.require_collection("vectors", dim=DIM)
    coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
    coll.commit()
    coll.prewarm()
    clock.read()
    lat = []
    for qv in singles:
        t0 = time.perf_counter()
        coll.search(qv, k=K)
        lat.append(time.perf_counter() - t0)
    out = {"corpus": kind, "p50_ms": float(np.percentile(lat, 50) * 1e3),
           "p99_ms": float(np.percentile(lat, 99) * 1e3), "single_gc_s": clock.read()}
    for b, blocks in ((16, b16), (256, b256)):
        secs = []
        for blk in blocks:
            t0 = time.perf_counter()
            coll.batch_search(blk, k=K)
            secs.append(time.perf_counter() - t0)
        out[f"qps_b{b}"] = b * len(blocks) / sum(secs)
        out[f"call_s_b{b}"] = secs
        out[f"gc_s_b{b}"] = clock.read()
    out["device_ms_single"] = device_ms_per_search(torch, coll, extra)
    client.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", nargs="+", choices=("isotropic", "mixture"),
                    default=["isotropic", "mixture"])
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

    import lynsedb_tpu_torch as lynse

    if not torch.cuda.is_available():
        print("flat_latency: needs a CUDA card", file=sys.stderr)
        return 2
    clock = GcClock()
    for kind in args.corpus:
        with tempfile.TemporaryDirectory(prefix="lynse_flat_") as root:
            out = run(lynse, torch, kind, root, clock)
        out["package"] = str(Path(lynse.__file__).resolve().parent)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

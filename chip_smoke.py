#!/usr/bin/env python3
"""Drive lynsedb_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its seconds):
  1. device: the card's name and power limit; fails without a CUDA device.
  2. build: compiles the CUDA kernels in lynsedb_tpu_torch/csrc with nvcc.
  3. kernels: each kernel (K1 flat_scores_f32, K2 bf16_centered_scores,
     K3 rescore_topk, K5 topk_select) against its plain PyTorch version at
     the main path's shapes (1,000,000 x 128 rows, B in {1, 16, 256}, k=10,
     C=256, IP/L2/cosine, a 10% mask, duplicated rows), with times.
  4. main path: VectorDBClient(device="cuda") -> create_database ->
     require_collection(dim=128, FLAT-IP) -> add 1,000,000 rows with
     fields {"bucket": i % 10} -> commit -> 100 single searches and batch
     searches at B=16 and B=256, each unfiltered and with where="bucket = 3";
     recall@10 and distances against a chunked numpy brute force.
  5. small collection: 2,000 rows (the exact K1 plan) equal numpy's top-10.
  6. launch counts of every kernel over phases 4-5 (each must be > 0).
The data is seeded numpy, shaped as bench.py's (1M x 128 f32, k=10). The
line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero before them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import lynsedb_tpu_torch as lynse
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import _cuda, topk
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import scan
from lynsedb_tpu_torch.ops.scan import DeviceCorpus

N, DIM, K, C = 1_000_000, 128, 10, 256
BATCHES = (1, 16, 256)
METRICS = (Metric.IP, Metric.L2, Metric.COSINE)
RECALL_FLOOR = 0.999
SEED = 0

KERNELS = {  # name -> (wrapper, source, the JAX function it replaces)
    "K1 flat_scores_f32": (scan.flat_scores_f32, "lynsedb_tpu_torch/csrc/flat_scores_f32.cu",
                           "lynsedb_tpu/ops/scan.py:190"),
    "K2 bf16_centered_scores": (scan.bf16_centered_scores,
                                "lynsedb_tpu_torch/csrc/bf16_centered_scores.cu",
                                "lynsedb_tpu/ops/scan.py:291"),
    "K3 rescore_topk": (scan.rescore_topk, "lynsedb_tpu_torch/csrc/rescore_topk.cu",
                        "lynsedb_tpu/ops/scan.py:495"),
    "K5 topk_select": (topk.topk_select, "lynsedb_tpu_torch/csrc/topk_select.cu",
                       "lynsedb_tpu/ops/topk.py:37"),
}


def check(ok: bool, what: str) -> None:
    """A failed check ends the run (not an assert: python -O drops those)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str):
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                print(f"== phase {name}: ok, {time.perf_counter() - self.t0:.3f} s", flush=True)

    return _Phase()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warmed up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_corpus(rng) -> np.ndarray:
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]  # duplicated rows: exact score ties
    return x


def check_ids(got: np.ndarray, want: np.ndarray, want_keys: np.ndarray, tol: np.ndarray) -> None:
    """ids identical, except between entries whose plain keys lie within the
    row's tolerance of each other."""
    for r, c in zip(*np.nonzero(got != want)):
        j = np.nonzero(want[r] == got[r, c])[0]
        if not len(j) or abs(want_keys[r, j[0]] - want_keys[r, c]) > tol[r]:
            raise AssertionError(f"id mismatch at ({r}, {c}): {got[r, c]} vs {want[r, c]}")


def kernel_phase(x: np.ndarray, rng, card: str) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    corpus = DeviceCorpus(DIM, device=dev)
    corpus.append(x)
    mask = rng.random(N) < 0.1
    corpus.set_tombstones(np.arange(N) % 997 == 0)
    valid = corpus.valid_mask(mask)
    x16, aux, x32 = corpus._dev16, corpus.bf16_aux(), corpus._data
    stats = {name: {"max_abs_err": 0.0, "ms": {}, "plain_ms": {}} for name in KERNELS}

    def record(name, err, b, metric, fn, plain):
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], float(err))
        if metric is Metric.IP:
            s["ms"][b], s["plain_ms"][b] = cuda_ms(fn), cuda_ms(plain)

    for metric in METRICS:
        ct = D.corpus_transform(x32, metric)
        for b in BATCHES:
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
            qt = D.query_transform(q, metric)
            args1 = (q, x32, qt.get("sq"), ct.get("sq"), valid, metric)
            k1, p1 = scan.flat_scores_f32(*args1), scan.flat_scores_f32_plain(*args1)
            fin = torch.isfinite(p1)
            check(torch.equal(fin, torch.isfinite(k1)), "K1: masked entries differ")
            err1 = (k1[fin] - p1[fin]).abs()
            check(bool((err1 <= 1e-4 + 1e-5 * p1[fin].abs()).all()), f"K1 {metric} B={b}")
            record("K1 flat_scores_f32", err1.max(), b, metric,
                   lambda: scan.flat_scores_f32(*args1), lambda: scan.flat_scores_f32_plain(*args1))
            del p1, fin, err1

            for keys, kk in ((k1, K), (None, C)):
                if keys is None:
                    keys = scan.bf16_centered_scores(q, x16, aux, valid, metric)
                    k2 = keys
                got, want = topk.topk_select(keys, kk), topk.topk_select_plain(keys, kk)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"K5 {metric} B={b} k={kk}")
                if kk == C:
                    err5 = (got[0] - want[0]).nan_to_num().abs().max()  # -inf - -inf -> 0
                    record("K5 topk_select", err5, b, metric, lambda: topk.topk_select(keys, C),
                           lambda: topk.topk_select_plain(keys, C))
            del k1

            p2 = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
            fin = torch.isfinite(p2)
            check(torch.equal(fin, torch.isfinite(k2)), "K2: masked entries differ")
            qc_norm = (q - aux["mean"][None, :]).norm(dim=1)[:, None]
            bound = 1e-5 * qc_norm * torch.sqrt(aux["xc_sq"])[None, :] + 1e-5
            if metric is Metric.COSINE:  # the bound holds for the numerator
                bound = bound / torch.sqrt(
                    (q * q).sum(-1)[:, None] * aux["xsq_true"][None, :]).clamp_min(1e-30)
            err2 = (k2 - p2).abs()
            check(bool((err2[fin] <= bound[fin]).all()), f"K2 {metric} B={b}")
            record("K2 bf16_centered_scores", err2[fin].max(), b, metric,
                   lambda: scan.bf16_centered_scores(q, x16, aux, valid, metric),
                   lambda: scan.bf16_centered_scores_plain(q, x16, aux, valid, metric))
            del p2, fin, bound, err2

            cand_keys, cand_idx = topk.topk_select(k2, C)
            del k2
            args3 = (q, x32, cand_keys, cand_idx, K, metric)
            gd, gi = scan.rescore_topk(*args3)
            wd, wi = scan.rescore_topk_plain(*args3)
            err3 = (gd - wd).abs()
            check(bool((err3 <= 1e-4 + 1e-5 * wd.abs()).all()), f"K3 {metric} B={b}")
            wd_np = wd.cpu().numpy()
            check_ids(gi.cpu().numpy(), wi.cpu().numpy(), wd_np,
                      1e-4 + 1e-5 * np.abs(wd_np).max(axis=1))
            record("K3 rescore_topk", err3.max(), b, metric, lambda: scan.rescore_topk(*args3),
                   lambda: scan.rescore_topk_plain(*args3))
        print(f"   {metric.value}: K1, K2, K3, K5 agree with their plain versions", flush=True)

    print(f"   kernel times, IP, ms per launch (CUDA events; {card}):")
    for name, s in stats.items():
        for b in BATCHES:
            print(f"     {name:26s} B={b:<4d} kernel {s['ms'][b]:.4f}  plain {s['plain_ms'][b]:.4f}")
    return stats


def exact_topk(x: np.ndarray, rows: np.ndarray, q: np.ndarray, k: int):
    """Chunked numpy brute force: IP top-k among ``rows`` (global ids)."""
    best_d = np.full((len(q), 0), -np.inf, np.float32)
    best_i = np.zeros((len(q), 0), np.int64)
    for lo in range(0, len(rows), 131072):
        ids = rows[lo : lo + 131072]
        s = q @ x[ids].T
        part = np.argpartition(-s, min(k, s.shape[1] - 1), axis=1)[:, :k]
        best_d = np.concatenate([best_d, np.take_along_axis(s, part, 1)], axis=1)
        best_i = np.concatenate([best_i, ids[part]], axis=1)
        order = np.argsort(-best_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(best_d, order, 1)
        best_i = np.take_along_axis(best_i, order, 1)
    return best_d, best_i


def check_results(x, q, views, gt_i, label: str) -> float:
    """recall@10 against the ground truth; every returned distance equals
    the float64 inner product of its row (rtol 1e-5)."""
    hits = 0
    for r, view in enumerate(views):
        ids = np.asarray(view.ids, dtype=np.int64)
        check(len(ids) == K, f"{label}: query {r} returned {len(ids)} rows")
        hits += len(set(ids.tolist()) & set(gt_i[r].tolist()))
        exact = x[ids].astype(np.float64) @ q[r].astype(np.float64)
        np.testing.assert_allclose(np.asarray(view.distances), exact, rtol=1e-5, atol=1e-5)
    recall = hits / (K * len(views))
    print(f"   {label}: recall@10 {recall:.4f} over {len(views)} queries", flush=True)
    check(recall >= RECALL_FLOOR, f"{label}: recall@10 {recall} < {RECALL_FLOOR}")
    return recall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    report = {}
    with phase("1 device"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 would break the f32 paths")

    with phase("2 build"):
        t0 = time.perf_counter()
        path, log = _cuda.build()
        print(f"   {path} ({time.perf_counter() - t0:.1f} s)")
        print(log, file=sys.stderr)
        _cuda.library()

    rng = np.random.default_rng(SEED)
    x = make_corpus(rng)
    with phase("3 kernels vs plain"):
        stats = kernel_phase(x, rng, card)
    torch.cuda.empty_cache()

    singles = rng.normal(size=(100, DIM)).astype(np.float32)
    b16 = rng.normal(size=(4, 16, DIM)).astype(np.float32)
    b256 = rng.normal(size=(4, 256, DIM)).astype(np.float32)
    small = rng.normal(size=(2000, DIM)).astype(np.float32)
    small_q = rng.normal(size=(20, DIM)).astype(np.float32)

    with tempfile.TemporaryDirectory(prefix="lynse_smoke_") as root:
        for wrapper, _, _ in KERNELS.values():
            wrapper.launches = 0
        with phase("4 main path"):
            client = lynse.VectorDBClient(root, device="cuda")
            db = client.create_database("smoke", drop_if_exists=True)
            coll = db.require_collection("vectors", dim=DIM)
            t0 = time.perf_counter()
            coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
            coll.commit()
            t_add = time.perf_counter() - t0
            t_warm = coll.prewarm()  # stages the corpus (one dummy query)
            print(f"   add+commit {N} rows: {t_add:.2f} s; first search (staging): {t_warm:.2f} s")
            out = {}
            for where in (None, "bucket = 3"):
                lat, views = [], []
                for qv in singles:
                    t0 = time.perf_counter()
                    views.append(coll.search(qv, k=K, where=where))
                    lat.append(time.perf_counter() - t0)
                out[(where, 1)] = (views, np.array(lat))
                for name, blocks in (("16", b16), ("256", b256)):
                    t0 = time.perf_counter()
                    views = [v for blk in blocks for v in coll.batch_search(blk, k=K, where=where)]
                    out[(where, int(name))] = (views, time.perf_counter() - t0)
            torch.cuda.synchronize()

        with phase("5 small collection"):
            sc = db.require_collection("small", dim=DIM)
            sc.add(vectors=small)
            sc.commit()
            small_views = [sc.search(qv, k=K) for qv in small_q]
        counts = {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
        client.close()

    with phase("4b recall against numpy brute force"):
        all_rows = np.arange(N)
        bucket3 = np.nonzero(all_rows % 10 == 3)[0]
        for where, rows in ((None, all_rows), ("bucket = 3", bucket3)):
            label = "unfiltered" if where is None else where
            views, lat = out[(where, 1)]
            _, gt = exact_topk(x, rows, singles, K)
            report[f"recall_single_{label}"] = check_results(x, singles, views, gt, f"single {label}")
            report[f"p50_ms_{label}"] = float(np.percentile(lat, 50) * 1e3)
            report[f"p99_ms_{label}"] = float(np.percentile(lat, 99) * 1e3)
            for b, blocks in ((16, b16), (256, b256)):
                views, secs = out[(where, b)]
                qs = blocks.reshape(-1, DIM)
                _, gt = exact_topk(x, rows, qs, K)
                check_results(x, qs, views, gt, f"batch B={b} {label}")
                report[f"qps_b{b}_{label}"] = len(qs) / secs

    with phase("5b small collection exact"):
        gd, gi = exact_topk(small, np.arange(len(small)), small_q, K)
        for r, view in enumerate(small_views):
            check(np.array_equal(np.asarray(view.ids), gi[r]), f"small: ids differ at query {r}")
            np.testing.assert_allclose(np.asarray(view.distances), gd[r], rtol=1e-5, atol=1e-5)
        print(f"   {len(small_views)} queries equal numpy's exact top-{K}")

    with phase("6 launch counts"):
        print(f"   {counts}")
        for name, n in counts.items():
            check(n > 0, f"{name} was never launched on the main path")

    print(f"main path timings ({card}; host clock around each call, ending in a device sync):")
    for key, val in report.items():
        print(f"   {key}: {val:.4f}")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"][16], "plain_ms": stats[name]["plain_ms"][16]}
        for name, (_, src, rep) in KERNELS.items()
    ]
    print(f"kernel ms / plain_ms below: IP, B=16, N={N}, D={DIM}, k={K}, C={C}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

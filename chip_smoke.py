#!/usr/bin/env python3
"""Drive lynsedb_tpu_torch's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its seconds):
  1. device: the card's name and power limit; fails without a CUDA device.
  2. build: compiles the CUDA kernels in lynsedb_tpu_torch/csrc with nvcc
     (one process a source, all at once).
  3. kernels: each kernel against its plain PyTorch version at the shapes its
     path gives it, with times, bounds and a library call's time beside:
     K1 flat_scores_f32, K2 bf16_centered_scores, K3 rescore_topk, K5
     topk_select at 1,000,000 x 128 rows, B in {1, 16, 256}, k=10, C=256,
     IP/L2/cosine, a 10% mask, duplicated rows; K5 past k = 1,024 (k in
     {1,000, 1,025, 4,096}, and k = N at N = 20,000) and K3 at C = 1,280;
     kmeans_assign at N in {256,000, 1,000,000}, K = 1,000 (L2 and IP) and
     kmeans_update at N = 256,000 (twice, bit-identical).
  4. flat path: VectorDBClient(device="cuda") -> create_database ->
     require_collection(dim=128, FLAT-IP) -> add 1,000,000 rows with
     fields {"bucket": i % 10} -> commit -> 100 single searches and batch
     searches at B=16 and B=256, each unfiltered and with where="bucket = 3";
     then a 2,000-row collection (the exact K1 plan).
  5. large k: search(k=1000) and search_range(max_results=1000) on the 1M
     collection (a shortlist of 1,280: K5's sort-and-merge path, K3 via K5).
  6. IVF path: build_index("IVF-L2", n_clusters=1000), then "IVF-IP", on the
     same collection; each answers 100 single queries (nprobe=32) and batches
     at B=16 and B=256, unfiltered and with where="bucket < 5" (half the
     rows, above the exact-filter route). ivf_scan_blocks then meets its
     plain version on each index at B in {1, 16, 256}.
  7. checks: recall@10 and distances against a chunked numpy brute force
     (FLAT >= 0.999, IVF >= 0.85 with no repeated id), large k against the
     exact top 1,000, and the launch counts of each path (counts set to 0
     just before a path and read just after; every kernel of the path > 0).
The corpus is seeded numpy: 1M x 128 f32 rows drawn from a mixture of 2,000
gaussian clusters (embedding-like data, on which a partition index has
structure to find), with 1,000 duplicated rows. The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}. Any
failed check exits non-zero before them.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import lynsedb_tpu_torch as lynse
from lynsedb_tpu_torch.index import ivf
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import _cuda, kmeans, topk
from lynsedb_tpu_torch.ops import distance as D
from lynsedb_tpu_torch.ops import scan
from lynsedb_tpu_torch.ops.scan import DeviceCorpus
from lynsedb_tpu_torch.tools.flat_latency import GcClock

N, DIM, K, C = 1_000_000, 128, 10, 256
BATCHES = (1, 16, 256)
METRICS = (Metric.IP, Metric.L2, Metric.COSINE)
RECALL_FLOOR = 0.999
IVF_RECALL_FLOOR = 0.85  # the upstream project's IVF/SPANN gate
N_CLUSTERS, NPROBE = 1000, 32
N_CENTERS, SPREAD = 2000, 0.6  # the corpus's mixture
BIG_K = 1000
SEED = 0
DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 and dense bf16 flop/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
GC = GcClock()  # garbage-collection seconds, read around each timed batch call

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
    "K15 kmeans_assign": (kmeans.kmeans_assign, "lynsedb_tpu_torch/csrc/kmeans_assign.cu",
                          "lynsedb_tpu/ops/kmeans.py:114"),
    "K15 kmeans_update": (kmeans.kmeans_update, "lynsedb_tpu_torch/csrc/kmeans_update.cu",
                          "lynsedb_tpu/ops/kmeans.py:70"),
    "K16 ivf_scan_blocks": (ivf.ivf_scan_blocks, "lynsedb_tpu_torch/csrc/ivf_scan_blocks.cu",
                            "lynsedb_tpu/index/ivf.py:43"),
}
# the kernels each path must launch
PATHS = {
    "flat": ("K1 flat_scores_f32", "K2 bf16_centered_scores", "K3 rescore_topk",
             "K5 topk_select"),
    "large_k": ("K2 bf16_centered_scores", "K3 rescore_topk", "K5 topk_select"),
    "ivf": ("K1 flat_scores_f32", "K5 topk_select", "K15 kmeans_assign", "K15 kmeans_update",
            "K16 ivf_scan_blocks"),
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


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warmed up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def set_counts(counts: dict) -> None:
    for name, (wrapper, _, _) in KERNELS.items():
        wrapper.launches = counts.get(name, 0)


def read_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


@contextlib.contextmanager
def uncounted():
    """Launches made to compare or time a kernel do not count for a path."""
    saved = read_counts()
    try:
        yield
    finally:
        set_counts(saved)


def bound(bytes_moved: float, flops: float, peak_flops: float = F32_FLOPS):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_corpus(rng):
    """1M rows from a mixture of N_CENTERS gaussian clusters, 1,000 rows
    duplicated (exact score ties). Returns (rows, centers)."""
    centers = rng.normal(size=(N_CENTERS, DIM)).astype(np.float32)
    x = centers[rng.integers(0, N_CENTERS, N)]
    x += SPREAD * rng.normal(size=(N, DIM)).astype(np.float32)
    x[N // 2 : N // 2 + 1000] = x[:1000]
    return x, centers


def mixture_queries(rng, centers, n):
    return (centers[rng.integers(0, N_CENTERS, n)]
            + SPREAD * rng.normal(size=(n, DIM)).astype(np.float32)).astype(np.float32)


def check_ids(got: np.ndarray, want: np.ndarray, want_keys: np.ndarray, tol: np.ndarray) -> None:
    """ids identical, except between entries whose plain keys lie within the
    row's tolerance of each other."""
    for r, c in zip(*np.nonzero(got != want)):
        j = np.nonzero(want[r] == got[r, c])[0]
        if not len(j) or abs(want_keys[r, j[0]] - want_keys[r, c]) > tol[r]:
            raise AssertionError(f"id mismatch at ({r}, {c}): {got[r, c]} vs {want[r, c]}")


class Stats:
    """Per kernel: the largest error and, per shape label, the kernel's,
    the plain version's and the library call's ms and the bound."""

    def __init__(self):
        self.err = {name: 0.0 for name in KERNELS}
        self.rows = {name: {} for name in KERNELS}

    def error(self, name, err) -> None:
        self.err[name] = max(self.err[name], float(err))

    def time(self, name, label, fn, plain, library, bound_ms) -> None:
        with uncounted():
            self.rows[name][label] = {
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
                "library_ms": None if library is None else cuda_ms(library),
                "bound_ms": bound_ms[0], "bound_by": bound_ms[1]}

    def table(self, card: str) -> None:
        print(f"   kernel times, ms per launch (CUDA events; {card}):")
        for name, rows in self.rows.items():
            for label, r in rows.items():
                lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                print(f"     {name:24s} {label:28s} kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}"
                      f"  library {lib}  bound {r['bound_ms']:.4f} ({r['bound_by']})")


def flat_kernel_phase(x: np.ndarray, rng, stats: Stats) -> None:
    """K1, K2, K3 and K5 against their plain versions at the flat path's
    shapes, then K5 and K3 past k = 1,024."""
    corpus = DeviceCorpus(DIM, device=DEV)
    corpus.append(x)
    mask = rng.random(N) < 0.1
    corpus.set_tombstones(np.arange(N) % 997 == 0)
    valid = corpus.valid_mask(mask)
    # the timed launches run unfiltered (tombstones only), as the main path
    # does; their bounds read only the live rows
    live = corpus.valid_mask()
    n_live = int(live.sum())
    x16, aux, x32 = corpus._dev16, corpus.bf16_aux(), corpus._data
    rows = x32.shape[0]  # the staged capacity: every kernel writes a key a row
    keys16 = None
    for metric in METRICS:
        ct = D.corpus_transform(x32, metric)
        for b in BATCHES:
            ip = metric is Metric.IP
            q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(DEV)
            qt = D.query_transform(q, metric)
            args1 = (q, x32, qt.get("sq"), ct.get("sq"), valid, metric)
            k1, p1 = scan.flat_scores_f32(*args1), scan.flat_scores_f32_plain(*args1)
            fin = torch.isfinite(p1)
            check(torch.equal(fin, torch.isfinite(k1)), "K1: masked entries differ")
            err1 = (k1[fin] - p1[fin]).abs()
            check(bool((err1 <= 1e-4 + 1e-5 * p1[fin].abs()).all()), f"K1 {metric} B={b}")
            stats.error("K1 flat_scores_f32", err1.max())
            if ip:
                args_t = (q, x32, None, None, live, metric)
                stats.time("K1 flat_scores_f32", f"IP B={b}", lambda: scan.flat_scores_f32(*args_t),
                           lambda: scan.flat_scores_f32_plain(*args_t), lambda: q @ x32.T,
                           bound(n_live * DIM * 4 + rows + b * DIM * 4 + b * rows * 4,
                                 2 * b * n_live * DIM))
            del p1, fin, err1

            for keys, kk in ((k1, K), (None, C)):
                if keys is None:
                    keys = scan.bf16_centered_scores(q, x16, aux, valid, metric)
                    k2 = keys
                got, want = topk.topk_select(keys, kk), topk.topk_select_plain(keys, kk)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"K5 {metric} B={b} k={kk}")
                if kk == C:
                    stats.error("K5 topk_select", (got[0] - want[0]).nan_to_num().abs().max())
                    if ip:
                        stats.time("K5 topk_select", f"IP B={b} k={C}",
                                   lambda: topk.topk_select(keys, C),
                                   lambda: topk.topk_select_plain(keys, C),
                                   lambda: torch.topk(keys, C), bound(b * rows * 4 + b * C * 8, 0))
            del k1

            p2 = scan.bf16_centered_scores_plain(q, x16, aux, valid, metric)
            fin = torch.isfinite(p2)
            check(torch.equal(fin, torch.isfinite(k2)), "K2: masked entries differ")
            qc_norm = (q - aux["mean"][None, :]).norm(dim=1)[:, None]
            tol = 1e-5 * qc_norm * torch.sqrt(aux["xc_sq"])[None, :] + 1e-5
            if metric is Metric.COSINE:  # the bound holds for the numerator
                tol = tol / torch.sqrt(
                    (q * q).sum(-1)[:, None] * aux["xsq_true"][None, :]).clamp_min(1e-30)
            err2 = (k2 - p2).abs()
            check(bool((err2[fin] <= tol[fin]).all()), f"K2 {metric} B={b}")
            stats.error("K2 bf16_centered_scores", err2[fin].max())
            if ip:
                qc16 = scan._query_terms(q, aux["mean"])[0]
                # IP's epilogue reads a live row's m . (x - m) (4 B) and
                # every row's valid byte
                stats.time("K2 bf16_centered_scores", f"IP B={b}",
                           lambda: scan.bf16_centered_scores(q, x16, aux, live, metric),
                           lambda: scan.bf16_centered_scores_plain(q, x16, aux, live, metric),
                           lambda: qc16 @ x16.T,
                           bound(n_live * (DIM * 2 + 4) + rows + b * DIM * 2 + b * rows * 4,
                                 2 * b * n_live * DIM, BF16_FLOPS))
            del p2, fin, tol, err2

            cand_keys, cand_idx = topk.topk_select(k2, C)
            if ip and b == 16:
                keys16 = k2
            del k2
            args3 = (q, x32, cand_keys, cand_idx, K, metric)
            n_cand = int((cand_keys > float("-inf")).sum())  # the rows K3 gathers
            gd, gi = scan.rescore_topk(*args3)
            wd, wi = scan.rescore_topk_plain(*args3)
            err3 = (gd - wd).abs()
            check(bool((err3 <= 1e-4 + 1e-5 * wd.abs()).all()), f"K3 {metric} B={b}")
            wd_np = wd.cpu().numpy()
            check_ids(gi.cpu().numpy(), wi.cpu().numpy(), wd_np,
                      1e-4 + 1e-5 * np.abs(wd_np).max(axis=1))
            stats.error("K3 rescore_topk", err3.max())
            if ip:
                stats.time("K3 rescore_topk", f"IP B={b} C={C}", lambda: scan.rescore_topk(*args3),
                           lambda: scan.rescore_topk_plain(*args3), None,
                           bound(n_cand * DIM * 4 + b * DIM * 4 + b * C * 8 + b * K * 12,
                                 4 * n_cand * DIM))
        print(f"   {metric.value}: K1, K2, K3, K5 agree with their plain versions", flush=True)

    # K5 past the shared-memory select (sort and merge), exact, ties included
    for kk in (BIG_K, 1025, 4096):
        got, want = topk.topk_select(keys16, kk), topk.topk_select_plain(keys16, kk)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"K5 k={kk}")
    ties = np.round(rng.normal(size=(4, 20_000)), 1).astype(np.float32)
    ties[rng.random(ties.shape) < 0.05] = -np.inf
    ties_t = torch.from_numpy(ties).to(DEV)
    got, want = topk.topk_select(ties_t, 20_000), topk.topk_select_plain(ties_t, 20_000)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "K5 k = N = 20,000")
    c_big = corpus._shortlist_size(BIG_K, N)
    q1 = torch.from_numpy(rng.normal(size=(1, DIM)).astype(np.float32)).to(DEV)
    keys1 = scan.bf16_centered_scores(q1, x16, aux, valid, Metric.IP)
    stats.time("K5 topk_select", f"IP B=1 k={c_big}", lambda: topk.topk_select(keys1, c_big),
               lambda: topk.topk_select_plain(keys1, c_big), lambda: torch.topk(keys1, c_big),
               bound(rows * 4 + c_big * 8, 0))
    stats.time("K5 topk_select", f"IP B=16 k={c_big}", lambda: topk.topk_select(keys16, c_big),
               lambda: topk.topk_select_plain(keys16, c_big), lambda: torch.topk(keys16, c_big),
               bound(16 * rows * 4 + 16 * c_big * 8, 0))
    # K3 with a shortlist above its shared-memory sort (C = 1,280)
    q16 = torch.from_numpy(rng.normal(size=(16, DIM)).astype(np.float32)).to(DEV)
    cand_keys, cand_idx = topk.topk_select(
        scan.bf16_centered_scores(q16, x16, aux, valid, Metric.IP), c_big)
    args3 = (q16, x32, cand_keys, cand_idx, BIG_K, Metric.IP)
    n_cand = int((cand_keys > float("-inf")).sum())
    gd, gi = scan.rescore_topk(*args3)
    wd, wi = scan.rescore_topk_plain(*args3)
    err3 = (gd - wd).abs()
    check(bool((err3 <= 1e-4 + 1e-5 * wd.abs()).all()), f"K3 C={c_big}")
    wd_np = wd.cpu().numpy()
    check_ids(gi.cpu().numpy(), wi.cpu().numpy(), wd_np, 1e-4 + 1e-5 * np.abs(wd_np).max(axis=1))
    stats.error("K3 rescore_topk", err3.max())
    stats.time("K3 rescore_topk", f"IP B=16 C={c_big}", lambda: scan.rescore_topk(*args3),
               lambda: scan.rescore_topk_plain(*args3), None,
               bound(n_cand * DIM * 4 + 16 * DIM * 4 + 16 * c_big * 8 + 16 * BIG_K * 12,
                     4 * n_cand * DIM))
    print(f"   K5 at k in {{{BIG_K}, 1025, 4096}} and k = N = 20,000, K3 at C = {c_big}: "
          "equal to their plain versions", flush=True)


def kmeans_kernel_phase(x: np.ndarray, rng, stats: Stats) -> None:
    """kmeans_assign and kmeans_update against their plain versions at the
    IVF build's shapes: the training sample (256 rows a centroid) and the
    full corpus, K = N_CLUSTERS."""
    xd = torch.from_numpy(x).to(DEV)
    cent = xd[torch.from_numpy(rng.choice(N, N_CLUSTERS, replace=False)).to(DEV)].clone()
    n_train = N_CLUSTERS * 256
    for rows in (n_train, N):
        data = xd[:rows]
        for ip in (False, True):
            got = kmeans.kmeans_assign(data, cent, ip)
            want = kmeans.kmeans_assign_plain(data, cent, ip)
            diff = torch.nonzero(got != want).flatten()
            if len(diff):  # allowed only where the two best centroids nearly tie
                sub = data[diff]
                s = kmeans._ip_scores(sub, cent) if ip else -kmeans._l2_scores(
                    sub, cent, (cent * cent).sum(-1))
                top2 = s.topk(2, dim=1).values
                check(bool(((top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()).all()),
                      f"kmeans_assign rows={rows} ip={ip}: {len(diff)} differ beyond a near-tie")
            if rows == n_train or not ip:
                stats.time("K15 kmeans_assign", f"{'IP' if ip else 'L2'} N={rows} K={N_CLUSTERS}",
                           lambda: kmeans.kmeans_assign(data, cent, ip),
                           lambda: kmeans.kmeans_assign_plain(data, cent, ip), None,
                           bound(rows * DIM * 4 + N_CLUSTERS * (DIM + 1) * 4 + rows * 4,
                                 2 * rows * N_CLUSTERS * DIM))
            print(f"   kmeans_assign N={rows} {'IP' if ip else 'L2'}: {len(diff)} near-tie "
                  "rows differ", flush=True)
    data = xd[:n_train]
    valid = torch.arange(n_train, device=DEV) < n_train - n_train // 10
    assign = kmeans.kmeans_assign(data, cent, False)
    first = kmeans.kmeans_update(data, valid, assign, cent)
    second = kmeans.kmeans_update(data, valid, assign, cent)
    want = kmeans.kmeans_update_plain(data, valid, assign, cent)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "kmeans_update: two runs are not bit-identical")
    err = (first[0] - want[0]).abs()
    check(bool((err <= 1e-4 + 1e-5 * want[0].abs()).all()), "kmeans_update sums")
    check(torch.equal(first[1], want[1]), "kmeans_update counts")
    check(bool(((first[2] - want[2]).abs() <= 1e-5 + 1e-5 * want[2].abs()).all()),
          "kmeans_update centroids")
    stats.error("K15 kmeans_update", err.max())
    sums, assign64, w = torch.zeros_like(cent), assign.long(), data * valid[:, None]
    # every row's assignment and valid byte, the valid rows' data, the old
    # centroids in and the sums, centroids, counts and moves out
    n_valid = int(valid.sum())
    stats.time("K15 kmeans_update", f"N={n_train} K={N_CLUSTERS}",
               lambda: kmeans.kmeans_update(data, valid, assign, cent),
               lambda: kmeans.kmeans_update_plain(data, valid, assign, cent),
               lambda: sums.index_add_(0, assign64, w),
               bound(n_train * 5 + n_valid * DIM * 4 + N_CLUSTERS * (3 * DIM + 2) * 4,
                     n_valid * DIM))
    print("   kmeans_update: sums, counts and centroids agree; two runs bit-identical", flush=True)


def exact_topk(x: np.ndarray, rows: np.ndarray, q: np.ndarray, k: int, metric=Metric.IP,
               xsq: np.ndarray | None = None):
    """Chunked numpy brute force: the top-k of ``rows`` (global ids) by IP,
    or by L2 (ranked on 2 q.x - |x|^2). Returns (keys, ids)."""
    best_d = np.full((len(q), 0), -np.inf, np.float32)
    best_i = np.zeros((len(q), 0), np.int64)
    for lo in range(0, len(rows), 131072):
        ids = rows[lo : lo + 131072]
        s = q @ x[ids].T
        if metric is Metric.L2:
            s = 2.0 * s - xsq[ids][None, :]
        part = np.argpartition(-s, min(k, s.shape[1] - 1), axis=1)[:, :k]
        best_d = np.concatenate([best_d, np.take_along_axis(s, part, 1)], axis=1)
        best_i = np.concatenate([best_i, ids[part]], axis=1)
        order = np.argsort(-best_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(best_d, order, 1)
        best_i = np.take_along_axis(best_i, order, 1)
    return best_d, best_i


def exact_dists(x, ids, q, metric):
    """float64 distances of rows ``ids`` to query ``q``, and the f32
    expansion's rounding scale (the distance tolerance's atol)."""
    rows, q64 = x[ids].astype(np.float64), q.astype(np.float64)
    if metric is Metric.IP:
        return rows @ q64, 1e-5
    d = ((rows - q64) ** 2).sum(1)
    return d, 1e-5 * (q64 @ q64 + (rows * rows).sum(1).max(initial=0.0))


def check_results(x, q, views, gt_i, label: str, metric=Metric.IP, floor=RECALL_FLOOR) -> float:
    """recall@10 against the ground truth, no repeated id, and every
    returned distance equal to the float64 distance of its row (rtol 1e-5)."""
    hits = 0
    for r, view in enumerate(views):
        ids = np.asarray(view.ids, dtype=np.int64)
        check(len(ids) == K, f"{label}: query {r} returned {len(ids)} rows")
        check(len(set(ids.tolist())) == len(ids), f"{label}: query {r} repeats an id")
        hits += len(set(ids.tolist()) & set(gt_i[r].tolist()))
        exact, atol = exact_dists(x, ids, q[r], metric)
        np.testing.assert_allclose(np.asarray(view.distances), exact, rtol=1e-5, atol=atol)
    recall = hits / (K * len(views))
    print(f"   {label}: recall@10 {recall:.4f} over {len(views)} queries", flush=True)
    check(recall >= floor, f"{label}: recall@10 {recall} < {floor}")
    return recall


def device_mallocs() -> int:
    """cudaMalloc calls the caching allocator has made so far."""
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def run_queries(coll, singles, b16, b256, where, **kw):
    """100 single searches (host clock each) and the batches; returns
    (views by batch size, single latencies (s), per batch size the seconds,
    garbage-collection seconds and new cudaMallocs of each call)."""
    lat, views = [], {1: []}
    for qv in singles:
        t0 = time.perf_counter()
        views[1].append(coll.search(qv, k=K, where=where, **kw))
        lat.append(time.perf_counter() - t0)
    calls = {}
    for b, blocks in ((16, b16), (256, b256)):
        views[b], calls[b] = [], {"s": [], "gc_s": [], "mallocs": []}
        for blk in blocks:
            GC.read()
            m0, t0 = device_mallocs(), time.perf_counter()
            views[b] += coll.batch_search(blk, k=K, where=where, **kw)
            calls[b]["s"].append(time.perf_counter() - t0)
            calls[b]["gc_s"].append(GC.read())
            calls[b]["mallocs"].append(device_mallocs() - m0)
    return views, np.array(lat), calls


def ivf_scan_phase(coll, q_sets, stats: Stats, mode: str) -> None:
    """ivf_scan_blocks against its plain version on the built index, at
    B in {1, 16, 256}, under the half filter."""
    eng = coll._engine
    idx = eng._index
    state = idx._device_state(eng)
    live = eng.corpus().valid_mask(np.arange(N) % 10 < 5)
    metric = idx.metric
    with uncounted():
        for qs in q_sets:
            b = len(qs)
            qd = torch.from_numpy(qs).to(DEV)
            top_c = ivf._top_clusters(qd, state["centroids"], metric, NPROBE)
            args = (qd, (qd * qd).sum(-1), top_c, state["cluster_blocks"], state["blocks"],
                    state["block_sq"], state["block_orig"], live, metric)
            got, want = ivf.ivf_scan_blocks(*args), ivf.ivf_scan_blocks_plain(*args)
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)), f"ivf_scan_blocks {mode} B={b}: masks")
            err = (got[fin] - want[fin]).abs()
            check(bool((err <= 1e-4 + 1e-5 * want[fin].abs()).all()),
                  f"ivf_scan_blocks {mode} B={b}")
            stats.error("K16 ivf_scan_blocks", err.max())
            # bound: every distinct probed block's slot ids read once, the
            # live flag of its real rows, the data (and |x|^2 for L2) of its
            # live rows; the keys written
            blk = state["cluster_blocks"][top_c.long()].reshape(b, -1)
            distinct = torch.unique(blk[blk >= 0]).long()
            orig = state["block_orig"].view(-1, ivf.BLOCK_SIZE)[distinct]
            real = orig >= 0
            n_real = int(real.sum())
            n_live = int((real & live[orig.clamp_min(0).long()]).sum())
            row_bytes = DIM * 4 + (0 if metric is Metric.IP else 4)
            scored = int(fin.sum())
            stats.time("K16 ivf_scan_blocks", f"{mode} B={b} nprobe={NPROBE}",
                       lambda: ivf.ivf_scan_blocks(*args), lambda: ivf.ivf_scan_blocks_plain(*args),
                       None, bound(orig.numel() * 4 + n_real + n_live * row_bytes
                                   + got.numel() * 4, 2 * scored * DIM))
            del got, want, fin
    print(f"   {mode}: ivf_scan_blocks agrees with its plain version at B in "
          f"{[len(qs) for qs in q_sets]}", flush=True)


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
    x, centers = make_corpus(rng)
    stats = Stats()
    with phase("3 kernels vs plain"):
        flat_kernel_phase(x, rng, stats)
        torch.cuda.empty_cache()
        kmeans_kernel_phase(x, rng, stats)
    torch.cuda.empty_cache()

    singles = rng.normal(size=(100, DIM)).astype(np.float32)
    b16 = rng.normal(size=(4, 16, DIM)).astype(np.float32)
    b256 = rng.normal(size=(4, 256, DIM)).astype(np.float32)
    small = rng.normal(size=(2000, DIM)).astype(np.float32)
    small_q = rng.normal(size=(20, DIM)).astype(np.float32)
    big_q = rng.normal(size=(4, DIM)).astype(np.float32)
    ivf_q = mixture_queries(rng, centers, 100 + 4 * 16 + 2 * 256)
    ivf_sets = (ivf_q[:100], ivf_q[100:164].reshape(4, 16, DIM), ivf_q[164:].reshape(2, 256, DIM))
    counts = {}

    with tempfile.TemporaryDirectory(prefix="lynse_smoke_") as root:
        set_counts({})
        with phase("4 flat path"):
            client = lynse.VectorDBClient(root, device=DEV)
            db = client.create_database("smoke", drop_if_exists=True)
            coll = db.require_collection("vectors", dim=DIM)
            t0 = time.perf_counter()
            coll.add(vectors=x, fields=[{"bucket": i % 10} for i in range(N)], batch_size=100_000)
            coll.commit()
            t_add = time.perf_counter() - t0
            t_warm = coll.prewarm()  # stages the corpus (one dummy query)
            print(f"   add+commit {N} rows: {t_add:.2f} s; first search (staging): {t_warm:.2f} s")
            flat_out = {where: run_queries(coll, singles, b16, b256, where)
                        for where in (None, "bucket = 3")}
            sc = db.require_collection("small", dim=DIM)
            sc.add(vectors=small)
            sc.commit()
            small_views = [sc.search(qv, k=K) for qv in small_q]
            sync()
        counts["flat"] = read_counts()

        set_counts({})
        with phase("5 large k"):
            big_views = [coll.search(qv, k=BIG_K) for qv in big_q]
            # thresholds that keep about half of each query's top 1,000
            thresholds = [float(np.asarray(v.distances)[BIG_K // 2]) for v in big_views]
            range_views = [coll.search_range(qv, t, max_results=BIG_K)
                           for qv, t in zip(big_q, thresholds)]
            sync()
        counts["large_k"] = read_counts()

        set_counts({})
        ivf_out = {}
        with phase("6 IVF path"):
            for mode in ("IVF-L2", "IVF-IP"):
                t0 = time.perf_counter()
                coll.build_index(mode, n_clusters=N_CLUSTERS)
                report[f"{mode} build_s"] = time.perf_counter() - t0
                print(f"   build_index({mode!r}, n_clusters={N_CLUSTERS}): "
                      f"{report[f'{mode} build_s']:.2f} s", flush=True)
                t0 = time.perf_counter()
                coll.search(centers[0], k=K, nprobe=NPROBE)  # stages the block copy
                print(f"   first search (block copy): {time.perf_counter() - t0:.2f} s")
                for where in (None, "bucket < 5"):
                    ivf_out[(mode, where)] = run_queries(coll, *ivf_sets, where, nprobe=NPROBE)
                sync()
                counts[f"ivf {mode}"] = read_counts()
                with uncounted():
                    ivf_scan_phase(coll, (ivf_q[:1], ivf_q[100:116], ivf_q[164:420]), stats, mode)
        counts["ivf"] = read_counts()
        client.close()

    with phase("7 checks against numpy brute force"):
        all_rows = np.arange(N)
        for where, rows in ((None, all_rows), ("bucket = 3", np.nonzero(all_rows % 10 == 3)[0])):
            label = "unfiltered" if where is None else where
            views, lat, calls = flat_out[where]
            qs = np.concatenate([singles, b16.reshape(-1, DIM), b256.reshape(-1, DIM)])
            _, gt = exact_topk(x, rows, qs, K)
            report[f"FLAT recall_single {label}"] = check_results(
                x, singles, views[1], gt[:100], f"FLAT single {label}")
            check_results(x, qs[100:164], views[16], gt[100:164], f"FLAT B=16 {label}")
            check_results(x, qs[164:], views[256], gt[164:], f"FLAT B=256 {label}")
            report[f"FLAT p50_ms {label}"] = float(np.percentile(lat, 50) * 1e3)
            report[f"FLAT p99_ms {label}"] = float(np.percentile(lat, 99) * 1e3)
            for b in (16, 256):
                report[f"FLAT qps_b{b} {label}"] = len(views[b]) / sum(calls[b]["s"])
                report[f"FLAT calls_b{b} {label}"] = calls[b]

        gd, gi = exact_topk(small, np.arange(len(small)), small_q, K)
        for r, view in enumerate(small_views):
            check(np.array_equal(np.asarray(view.ids), gi[r]), f"small: ids differ at query {r}")
            np.testing.assert_allclose(np.asarray(view.distances), gd[r], rtol=1e-5, atol=1e-5)
        print(f"   small collection: {len(small_views)} queries equal numpy's exact top-{K}")

        gd, gi = exact_topk(x, all_rows, big_q, BIG_K)
        hits = 0
        for r, view in enumerate(big_views):
            ids = np.asarray(view.ids, dtype=np.int64)
            check(len(ids) == BIG_K and len(set(ids.tolist())) == BIG_K, f"k={BIG_K}: query {r}")
            hits += len(set(ids.tolist()) & set(gi[r].tolist()))
            np.testing.assert_allclose(np.asarray(view.distances), x[ids].astype(np.float64)
                                       @ big_q[r].astype(np.float64), rtol=1e-5, atol=1e-5)
            t = thresholds[r]
            want = set(gi[r][gd[r] >= t + 1e-4].tolist())  # clearly inside the range
            got = np.asarray(range_views[r].ids, dtype=np.int64)
            check(want <= set(got.tolist()), f"search_range: query {r} misses rows in range")
            exact = x[got].astype(np.float64) @ big_q[r].astype(np.float64)
            check(bool((exact >= t - 1e-4).all()), f"search_range: query {r} out of range")
        report[f"FLAT recall@{BIG_K}"] = hits / (BIG_K * len(big_views))
        print(f"   search(k={BIG_K}): recall {report[f'FLAT recall@{BIG_K}']:.4f}; "
              f"search_range(max_results={BIG_K}): every row in range, none outside")
        check(report[f"FLAT recall@{BIG_K}"] >= RECALL_FLOOR, f"k={BIG_K} recall")

        xsq = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        for mode, metric in (("IVF-L2", Metric.L2), ("IVF-IP", Metric.IP)):
            for where, rows in ((None, all_rows), ("bucket < 5", np.nonzero(all_rows % 10 < 5)[0])):
                label = f"{mode} {'unfiltered' if where is None else where}"
                views, lat, calls = ivf_out[(mode, where)]
                _, gt = exact_topk(x, rows, ivf_q, K, metric, xsq)
                report[f"{label} recall_single"] = check_results(
                    x, ivf_q[:100], views[1], gt[:100], f"{label} single", metric, IVF_RECALL_FLOOR)
                for b, lo, hi in ((16, 100, 164), (256, 164, len(ivf_q))):
                    report[f"{label} recall_b{b}"] = check_results(
                        x, ivf_q[lo:hi], views[b], gt[lo:hi], f"{label} B={b}", metric,
                        IVF_RECALL_FLOOR)
                    report[f"{label} qps_b{b}"] = len(views[b]) / sum(calls[b]["s"])
                    report[f"{label} calls_b{b}"] = calls[b]
                report[f"{label} p50_ms"] = float(np.percentile(lat, 50) * 1e3)
                report[f"{label} p99_ms"] = float(np.percentile(lat, 99) * 1e3)

    with phase("8 launch counts"):
        by_path = {"flat": counts["flat"], "large_k": counts["large_k"], "ivf": counts["ivf"]}
        for path, names in PATHS.items():
            print(f"   {path}: {by_path[path]}")
            for name in names:
                check(by_path[path][name] > 0, f"{name} was never launched on the {path} path")
        ivf_l2 = counts["ivf IVF-L2"]
        for name in PATHS["ivf"]:  # the IP build and queries launch them again
            check(counts["ivf"][name] > ivf_l2[name], f"{name} not launched for IVF-IP")

    print(f"main path timings ({card}; host clock around each call, ending in a device sync):")
    for key, val in report.items():
        print(f"   {key}: {val}")
    stats.table(card)
    shown = {"K1 flat_scores_f32": "IP B=16", "K2 bf16_centered_scores": "IP B=16",
             "K3 rescore_topk": f"IP B=16 C={C}", "K5 topk_select": f"IP B=16 k={C}",
             "K15 kmeans_assign": f"L2 N={N_CLUSTERS * 256} K={N_CLUSTERS}",
             "K15 kmeans_update": f"N={N_CLUSTERS * 256} K={N_CLUSTERS}",
             "K16 ivf_scan_blocks": f"IVF-L2 B=16 nprobe={NPROBE}"}
    kernels = []
    for name, (_, src, rep) in KERNELS.items():
        row = stats.rows[name][shown[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path[p][name] for p in by_path),
            "launches_by_path": {p: by_path[p][name] for p in by_path},
            "max_abs_err": stats.err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shown[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

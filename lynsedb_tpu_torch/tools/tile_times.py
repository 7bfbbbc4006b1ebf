#!/usr/bin/env python3
"""Device times of the exact f32 tile (K1, K6a) and of K11's shared-list tile
on one CUDA card, at chip_smoke.py's shapes.

    python3 lynsedb_tpu_torch/tools/tile_times.py [--package-root DIR] [--reps N]
                                                  [--only K1 K6a K11]

K1 under IP over 1,000,000 x 128 f32 rows at B = 1, 16, 17, 64 and 256, beside
``q @ x.T`` (one f32 matmul, the same function without the mask); K6a under
correlation at B = 1, 16 and 256 and under Hellinger at B = 16, beside the
matmul of the transformed rows; K11 over a (1, 100,000) row list shared by
every query (every tenth row, as ``where="bucket = 3"`` gives) at B = 1, 16
and 256, beside the two calls ``qc16 @ x16.index_select(0, idx).T`` (a
gather, then a bf16 matmul: no one PyTorch call computes it). Each time is
the mean of ``--reps`` launches between CUDA events after a warm-up; each
bound is chip_smoke.py's, from the same formulas (``roofline.py`` beside
this file: the bytes moved over 3.35 TB/s against the flops over the f32
(K1, K6a) or bf16 (K11) peak). Beside the
event time (which includes the wrapper's own small PyTorch ops and, where the
host enqueues slower than the card runs, the host), ``kernel_ms`` is the
device time of the hand-written kernel alone per launch, from torch.profiler.
Each row also carries the largest error against the kernel's plain version
on the same inputs.

``--package-root DIR`` imports lynsedb_tpu_torch from DIR (an older commit
unpacked with ``git archive``), so parent and change are timed on one card
in one call. Prints the card's name and power limit, then one JSON line per
kernel and shape.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# roofline.py sits beside this script (sys.path[0]), so this tree's formulas
# hold whichever --package-root is timed
from roofline import f32_tile_bound, shared_list_bound

N, DIM, SHARED_EVERY = 1_000_000, 128, 10
# the kernels' names, this tree's and earlier ones' (torch.profiler keys)
K1_NAMES, K11_NAMES = ("f32_tile_kernel", "tile_scores_kernel"), ("shared_list_kernel",
                                                                  "bf16_gather_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=("K1", "K6a", "K11"),
                    default=["K1", "K6a", "K11"])
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    if not torch.cuda.is_available():
        print("tile_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output", flush=True)

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def kernel_ms(fn, names: tuple) -> float | None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                 if any(n in ev.key for n in names))
        return us / 1e3 / args.reps if us else None

    def row(kernel, shape, fn, library, bnd, err, names):
        print(json.dumps({"package": str(args.package_root), "kernel": kernel, "shape": shape,
                          "ms": ms(fn), "kernel_ms": kernel_ms(fn, names),
                          "library_ms": ms(library), "bound_ms": bnd[0], "bound_by": bnd[1],
                          "max_abs_err": err}), flush=True)

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(N, DIM)).astype(np.float32)
    corpus = scan.DeviceCorpus(DIM, device=dev)
    corpus.append(x_np)
    x32, x16, aux = corpus._data[:N], corpus.data16[:N], corpus.bf16_aux()
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for b in (1, 16, 17, 64, 256) if "K1" in args.only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x32, None, None, live, Metric.IP)
        err = float((scan.flat_scores_f32(*a) - scan.flat_scores_f32_plain(*a)).abs().max())
        row("K1 flat_scores_f32", f"IP 1M x 128 B={b}", lambda: scan.flat_scores_f32(*a),
            lambda: q @ x32.T, f32_tile_bound(b, DIM, N, N), err, K1_NAMES)
    hist = torch.exp(0.5 * x32)
    for metric, rows, batches in ((Metric.CORRELATION, x32, (1, 16, 256)),
                                  (Metric.HELLINGER, hist, (16,))):
        if "K6a" not in args.only:
            break
        ct = D.corpus_transform(rows, metric)
        for b in batches:
            qt = D.query_transform(rows[:b] + 0.01, metric)
            lead, ql = scan._gemm_rows(ct, metric), scan._gemm_rows(qt, metric)
            got = scan.gemm_metric_scores(qt, ct, live, metric)
            want = scan.metric_keys_plain(qt, ct, live, metric)
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            row("K6a gemm_metric_scores", f"{metric.value} 1M x 128 B={b}",
                lambda: scan.gemm_metric_scores(qt, ct, live, metric), lambda: ql @ lead.T,
                f32_tile_bound(b, DIM, N, N, 8 if metric is Metric.CORRELATION else 5), err,
                K1_NAMES)
            del got, want
    idx = torch.arange(3, N, SHARED_EVERY, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(idx.shape, device=dev)
    s = idx.shape[1]
    # a tree older than the wrapper's `shared` flag takes any (1, S) list as shared
    kw = {"shared": True} if "shared" in inspect.signature(scan.bf16_gather_scores).parameters \
        else {}
    for b in (1, 16, 256) if "K11" in args.only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x16, aux, idx, slot, Metric.IP)
        got, want = scan.bf16_gather_scores(*a, **kw), scan.bf16_gather_scores_plain(*a, **kw)
        err = float((got - want).abs().max())
        qc16 = scan._query_terms(q, aux["mean"])[0]
        row("K11 bf16_gather_scores", f"IP shared S={s} B={b}",
            lambda: scan.bf16_gather_scores(*a, **kw),
            lambda: qc16 @ x16.index_select(0, idx[0]).T, shared_list_bound(b, DIM, s), err,
            K11_NAMES)
    return 0


if __name__ == "__main__":
    sys.exit(main())

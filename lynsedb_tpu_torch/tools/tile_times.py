#!/usr/bin/env python3
"""Device times of the exact f32 tile (K1, K6a), K11's shared-list tile and
the integer tensor-core tiles (K6b, K12) on one CUDA card, at chip_smoke.py's
shapes.

    python3 lynsedb_tpu_torch/tools/tile_times.py [--package-root DIR] [--reps N]
                                                  [--only K1 K6a K11 K6b K12]

K1 under IP over 1,000,000 x 128 f32 rows at B = 1, 16, 17, 64 and 256, beside
``q @ x.T`` (one f32 matmul, the same function without the mask); K6a under
correlation at B = 1, 16 and 256 and under Hellinger at B = 16, beside the
matmul of the transformed rows; K11 over a (1, 100,000) row list shared by
every query (every tenth row, as ``where="bucket = 3"`` gives) at B = 1, 16
and 256, beside the two calls ``qc16 @ x16.index_select(0, idx).T`` (a
gather, then a bf16 matmul: no one PyTorch call computes it); K6b under
Tanimoto over 1,000,000 x 1,024-bit rows (10% of the bits set) at B = 1, 16
and 256 and under Jaccard, Dice and Hamming at B = 16, beside the bf16
matmul of the {0, 1} rows; K12 over 1,000,000 x 128 int8 codes (SQ8, RaBitQ,
PolarVec under IP) at B = 1, 16 and 64, beside ``torch._int_mm`` of the
quantized queries and the codes at B = 64 (the dot alone; it takes no fewer
than 17 rows). Each time is
the mean of ``--reps`` launches between CUDA events after a warm-up; each
bound is chip_smoke.py's, from the same formulas (``roofline.py`` beside
this file: the bytes moved over 3.35 TB/s against the operations over the
f32 (K1, K6a), bf16 (K11) or int8 (K6b, K12) peak). Beside the
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
from roofline import binary_tile_bound, code_scan_bound, f32_tile_bound, shared_list_bound

N, DIM, SHARED_EVERY = 1_000_000, 128, 10
BITS_DIM, BITS_DENSITY = 1024, 0.1
KERNELS = ("K1", "K6a", "K11", "K6b", "K12")
# the kernels' names, this tree's and earlier ones' (torch.profiler keys)
K1_NAMES, K11_NAMES = ("f32_tile_kernel", "tile_scores_kernel"), ("shared_list_kernel",
                                                                  "bf16_gather_kernel")
K6B_NAMES = ("int_tile_kernel", "binary_tile_kernel")
K12_NAMES = ("int_tile_kernel", "int8_scores_kernel", "quantize_queries_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=list(KERNELS))
    args = ap.parse_args()
    sys.path.insert(0, str(args.package_root.resolve()))
    import torch

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
                          "library_ms": None if library is None else ms(library),
                          "bound_ms": bnd[0], "bound_by": bnd[1],
                          "max_abs_err": err}), flush=True)

    if {"K1", "K6a", "K11"} & set(args.only):
        float_rows(args.only, row, dev)
    if "K6b" in args.only:
        binary_rows(row, dev)
    if "K12" in args.only:
        code_rows(row, dev)
    return 0


def float_rows(only, row, dev) -> None:
    """K1 and K6a over 1M x 128 f32 rows, K11 over its shared list."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(N, DIM)).astype(np.float32)
    corpus = scan.DeviceCorpus(DIM, device=dev)
    corpus.append(x_np)
    x32, x16, aux = corpus._data[:N], corpus.data16[:N], corpus.bf16_aux()
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for b in (1, 16, 17, 64, 256) if "K1" in only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x32, None, None, live, Metric.IP)
        err = float((scan.flat_scores_f32(*a) - scan.flat_scores_f32_plain(*a)).abs().max())
        row("K1 flat_scores_f32", f"IP 1M x 128 B={b}", lambda: scan.flat_scores_f32(*a),
            lambda: q @ x32.T, f32_tile_bound(b, DIM, N, N), err, K1_NAMES)
    hist = torch.exp(0.5 * x32)
    for metric, rows, batches in ((Metric.CORRELATION, x32, (1, 16, 256)),
                                  (Metric.HELLINGER, hist, (16,))):
        if "K6a" not in only:
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
    for b in (1, 16, 256) if "K11" in only else ():
        q = torch.from_numpy(rng.normal(size=(b, DIM)).astype(np.float32)).to(dev)
        a = (q, x16, aux, idx, slot, Metric.IP)
        got, want = scan.bf16_gather_scores(*a, **kw), scan.bf16_gather_scores_plain(*a, **kw)
        err = float((got - want).abs().max())
        qc16 = scan._query_terms(q, aux["mean"])[0]
        row("K11 bf16_gather_scores", f"IP shared S={s} B={b}",
            lambda: scan.bf16_gather_scores(*a, **kw),
            lambda: qc16 @ x16.index_select(0, idx[0]).T, shared_list_bound(b, DIM, s), err,
            K11_NAMES)


def binary_rows(row, dev) -> None:
    """K6b's tile mode over 1M x 1,024-bit rows, every row live."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import distance as D
    from lynsedb_tpu_torch.ops import scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    words = D.words_for(BITS_DIM)
    parts = [D.corpus_transform((torch.rand((min(1 << 16, N - lo), BITS_DIM), generator=gen,
                                            device=dev) < BITS_DENSITY).float(), Metric.TANIMOTO)
             for lo in range(0, N, 1 << 16)]
    ct = {leaf: torch.cat([p[leaf] for p in parts]) for leaf in ("bits", "cnt")}
    bits = ct["bits"]
    del parts
    x01 = torch.empty((N, 32 * words), dtype=torch.bfloat16, device=dev)
    for lo in range(0, N, 1 << 16):
        x01[lo : lo + (1 << 16)] = D.unpack_bits(bits[lo : lo + (1 << 16)])
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for metric, b in ((Metric.TANIMOTO, 1), (Metric.TANIMOTO, 16), (Metric.TANIMOTO, 256),
                      (Metric.JACCARD, 16), (Metric.DICE, 16), (Metric.HAMMING, 16)):
        q = (torch.rand((b, BITS_DIM), generator=gen, device=dev) < BITS_DENSITY).float()
        qt = D.query_transform(q, metric)
        got = scan.binary_scores(qt, ct, live, metric)
        want = scan.metric_keys_plain(qt, ct, live, metric)
        # the keys are equal to the bit, or the error is reported as inf
        err = 0.0 if torch.equal(got, want) else float("inf")
        del got, want
        q01 = D.unpack_bits(qt["bits"]).to(torch.bfloat16)
        row("K6b binary_scores", f"{metric.value} 1M x {BITS_DIM} bits B={b}",
            lambda: scan.binary_scores(qt, ct, live, metric), lambda: q01 @ x01.T,
            binary_tile_bound(b, words, N, N), err, K6B_NAMES)


def code_rows(row, dev) -> None:
    """K12 over 1M x 128 int8 codes under IP, every row live."""
    import torch

    from lynsedb_tpu_torch.metrics import Metric
    from lynsedb_tpu_torch.ops import quantize

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    signs = torch.from_numpy(quantize.rotation_signs(DIM, 1234)).to(dev)
    live = torch.ones(N, dtype=torch.bool, device=dev)
    for kind in ("sq8", "rabitq", "polarvec"):
        codes = torch.randint(-127, 128, (N, DIM), generator=gen, device=dev, dtype=torch.int8)
        st = {"row_sq": torch.rand(N, generator=gen, device=dev) * 100 + 1.0}
        if kind == "sq8":
            st.update(codes=codes, lo=torch.rand(DIM, generator=gen, device=dev) - 2.0,
                      scale=torch.rand(DIM, generator=gen, device=dev) * 0.02 + 1e-3)
        elif kind == "rabitq":
            st.update(bits=codes, alpha=torch.rand(N, generator=gen, device=dev) * 0.1 + 0.05)
        else:
            st.update(codes=codes, lo=-0.3 * torch.rand(N, generator=gen, device=dev),
                      scale=torch.rand(N, generator=gen, device=dev) * 0.04 + 1e-3)
        row_bytes = {"sq8": 0, "rabitq": 4, "polarvec": 8}[kind]  # IP's per-row terms
        for b in (1, 16, 64):
            q = torch.randn((b, DIM), generator=gen, device=dev)
            q_rot = None if kind == "sq8" else quantize.rotate(q, signs, DIM)
            args = (kind, q, q_rot, st, live, Metric.IP)
            got, want = quantize.int8_code_scores(*args), quantize.int8_code_scores_plain(*args)
            err = float((got - want).abs().max())
            del got, want
            a = q * st["scale"][None, :] if kind == "sq8" else q_rot
            q_i8 = quantize.quantize_queries(a)[0]
            library = (lambda: torch._int_mm(q_i8, codes.T)) if b > 16 else None
            row("K12 int8_code_scores", f"{kind} IP 1M x {DIM} B={b}",
                lambda: quantize.int8_code_scores(*args), library,
                code_scan_bound(b, DIM, DIM, N, N, row_bytes), err, K12_NAMES)


if __name__ == "__main__":
    sys.exit(main())

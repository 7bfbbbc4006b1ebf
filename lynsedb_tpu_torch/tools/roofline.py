"""The H100 SXM's peak rates and the least time a kernel's work can take on
them, for chip_smoke.py and tools/tile_times.py (one copy of each rate and
of each formula the two share). Standard library only: tile_times.py loads
it beside an older tree's package."""

from __future__ import annotations

# NVIDIA's data sheet: HBM bytes/s, f32 and dense bf16 flop/s, dense int8 op/s
HBM_BPS, F32_FLOPS, BF16_FLOPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12
# f32 instructions a second outside the tensor cores (67 TFLOP/s counts an
# FMA as two flops), and the special-function units' and popcount's rate:
# 132 SMs x 16 a clock x 1.98 GHz (a reciprocal, a logarithm, a popcount)
F32_OPS, SFU_OPS = F32_FLOPS / 2, 132 * 16 * 1.98e9


def bound_t(bytes_moved: float, t_ops: float):
    """(ms, "bytes" or "operations"): the least time for the work, the
    larger of its bytes over the memory rate and its operations' time
    ``t_ops`` in seconds."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, t_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(bytes_moved: float, flops: float, peak_flops: float = F32_FLOPS):
    return bound_t(bytes_moved, flops / peak_flops)


def f32_tile_bound(b: int, d: int, n_live: int, rows: int, row_bytes: int = 0):
    """K1 / K6a's tile mode: each live row read once (d f32 and
    ``row_bytes`` of per-row terms), every row's valid byte, the queries
    read and the (B, rows) keys written; 2 B n_live d flops at the f32
    peak."""
    return bound(n_live * (d * 4 + row_bytes) + rows + b * d * 4 + b * rows * 4,
                 2 * b * n_live * d)


def shared_list_bound(b: int, d: int, s: int):
    """K11 over a (1, S) list shared by every query: each gathered bf16 row,
    its m . (x - m) word, its id and slot key read once, the queries read
    and the (B, S) keys written; 2 B S d flops at the bf16 peak (the same
    products run on the tensor cores)."""
    return bound(s * (d * 2 + 4 + 8) + b * s * 4 + b * d * 4, 2 * b * s * d, BF16_FLOPS)

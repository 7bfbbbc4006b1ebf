"""Pairwise distances for the matmul metrics: IP, L2 and cosine.

Port of lynsedb_tpu/ops/distance.py for the three metrics the flat search
serves. Each metric is factored into a per-row ``corpus_transform`` (norms),
the same ``query_transform`` and the ``pairwise`` form (one f32 product plus
rank-1 corrections). ``pairwise`` is the plain version of the K1 kernel's
score; on the card the kernel computes it (ops/scan.py flat_scores_f32). The
other thirteen metrics are not ported yet (ROADMAP K6) and raise.

All distances are f32 "scores" in the metric's native orientation (callers
use ``Metric.ascending`` to order them). f32 products stay full f32: the JAX
package uses Precision.HIGHEST, and TF32 must stay off on the card.
"""

from __future__ import annotations

import torch

from ..metrics import Metric

SUPPORTED = (Metric.IP, Metric.L2, Metric.COSINE)


def check_supported(metric: Metric) -> None:
    if metric not in SUPPORTED:
        raise NotImplementedError(
            f"metric {metric.value} is not ported to the CUDA engine yet (ROADMAP K6)"
        )


def corpus_transform(x: torch.Tensor, metric: Metric) -> dict:
    """Per-row preprocessing of a corpus block ``x`` (N, D)."""
    check_supported(metric)
    x = x.to(torch.float32)
    if metric is Metric.IP:
        return {"x": x}
    return {"x": x, "sq": (x * x).sum(dim=-1)}


def query_transform(q: torch.Tensor, metric: Metric) -> dict:
    """Same preprocessing for a query batch ``q`` (B, D)."""
    return corpus_transform(q, metric)


def pairwise(qt: dict, ct: dict, metric: Metric) -> torch.Tensor:
    """Score a query batch against a corpus block: (B, N) f32."""
    check_supported(metric)
    ip = qt["x"] @ ct["x"].T
    if metric is Metric.IP:
        return ip
    if metric is Metric.L2:
        return torch.clamp_min(qt["sq"][:, None] + ct["sq"][None, :] - 2.0 * ip, 0.0)
    denom = torch.sqrt(qt["sq"][:, None] * ct["sq"][None, :])
    # reference policy: denom < 1e-30 -> distance 1.0
    return torch.where(denom < 1e-30, 1.0, 1.0 - ip / torch.clamp_min(denom, 1e-30))

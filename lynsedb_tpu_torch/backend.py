"""Low-level compute passthroughs beside the collection API (reference:
python/lynse/_backend.py:251 compute_distance / :260 top_k_search), over the
ported distance kernels and K5.

Each entry point runs on ``device``: "cuda" (the default) scores with the
metric's distance kernel (K1, K6a, K6b or K6c) and selects with K5, and needs
a card; "cpu" runs the kernels' plain versions. Distances come from the
oriented keys, so a NaN distance comes back as the metric's worst value (+inf,
or -inf for IP), as the JAX package's top-k returns it.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import Metric
from .ops import distance as D
from .ops.scan import metric_keys, resolve_device
from .ops.topk import topk_select, unorient


def _keys(q, x, metric: Metric, device) -> torch.Tensor:
    dev = resolve_device(device)
    qd = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(np.asarray(q, dtype=np.float32))))
    xd = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(np.asarray(x, dtype=np.float32))))
    qd, xd = qd.to(dev), xd.to(dev)
    valid = torch.ones(xd.shape[0], dtype=torch.bool, device=dev)
    return metric_keys(D.query_transform(qd, metric), D.corpus_transform(xd, metric), valid,
                       metric)


def pairwise_distances(q, x, metric: str | Metric, device="cuda") -> np.ndarray:
    """(B, N) distances of queries ``q`` (B, D) to rows ``x`` (N, D)."""
    metric = D.parse_metric(metric)
    return unorient(_keys(q, x, metric, device), metric.ascending).cpu().numpy()


def compute_distance(a, b, metric: str | Metric, device="cuda") -> float:
    """Single-pair distance, mirroring ``lynse._core.compute_distance``."""
    return float(pairwise_distances(np.reshape(a, (1, -1)), np.reshape(b, (1, -1)), metric,
                                    device)[0, 0])


def batch_top_k_search(queries, candidates, k: int = 10, metric: str | Metric = "ip",
                       device="cuda"):
    """Exact top-k of each query against a candidate matrix. Returns
    (indices (B, k') int64, distances (B, k') f32) best first, the lower
    index first among ties."""
    metric = D.parse_metric(metric)
    keys = _keys(queries, candidates, metric, device)
    top, idx = topk_select(keys, min(k, keys.shape[1]))
    return (idx.cpu().numpy().astype(np.int64),
            unorient(top, metric.ascending).cpu().numpy().astype(np.float32))


def top_k_search(query, candidates, k: int = 10, metric: str | Metric = "ip", device="cuda"):
    """:func:`batch_top_k_search` of one query: (indices (k',), distances (k',))."""
    idx, dists = batch_top_k_search(np.reshape(query, (1, -1)), candidates, k, metric, device)
    return idx[0], dists[0]

"""Mesh-sharded search and k-means: the multi-device data plane.

Port of lynsedb_tpu/parallel/mesh.py (reference: src/cluster.rs:25
RustReadCoordinator, merge_search_blocks :327). The JAX package shards a
corpus over a ``(data, corpus)`` mesh of devices with ``shard_map``: each
corpus shard takes a local top-k, and the shards' winners are all-gathered
and merged; k-means reduces per-shard sums with ``psum``.

The port keeps the JAX package's single-controller shape: one process drives
every shard. A :class:`Mesh` is a ``(data, corpus)`` grid of torch devices,
and a device may repeat, so several virtual shards can share one card (or
the CPU in the tests), as JAX's ``xla_force_host_platform_device_count``
shares one host. ``torch.distributed`` is not used: NCCL takes no two ranks
on one card, so one card would run a world of one and the merge would never
run, and every rank would need a Collection of its own.

K21 is two functions:

  * **K21a**, :func:`sharded_search_fn`: each corpus shard scores its rows
    with the port's distance kernels (``scan.metric_keys``: K1 for
    IP/L2/cosine, K6a/b/c for the rest) and takes its top k with K5; the ids
    become global (``i + shard * n_local``). ``topk.merge_shards`` then
    copies every shard's (B, k) winners to the home device of their data
    row, in shard order (``tensor.to(home, non_blocking=True)``: nothing on a
    shared device, a peer copy between cards), and merges them with K5
    (``topk.merge_top_k``), ties to the lower position, so to the lower
    shard and the lower global id. ``DeviceCorpus``'s mesh mode ends every
    plan in the same merge.
  * **K21b**, :func:`sharded_kmeans_step_fn`: one Lloyd step. Each shard runs
    K15a's assignment and K15b's update on its rows; the partial sums and
    counts are copied to the home device and ``kmeans.kmeans_reduce_shards``
    (csrc/mesh_reduce.cu) adds them in shard order, with no float atomics,
    and forms the new centroids.

:func:`set_default_mesh` makes every new ``DeviceCorpus`` shard its rows over
the mesh, which is how a Collection serves from a sharded corpus.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..metrics import Metric
from ..ops import distance as D
from ..ops import kmeans as KM
from ..ops import scan
from ..ops.topk import merge_shards, topk_select, topk_select_plain, unorient
from . import get_default_mesh, set_default_mesh  # noqa: F401  (the JAX module's names)


class Mesh:
    """A ``(data, corpus)`` grid of torch devices (``devices[r][s]``). A
    device may appear more than once: shards on one device run one after
    another on it. ``shape`` is ``{"data": rows, "corpus": columns}``; the
    home device, ``devices[0][0]``, receives every merged result."""

    def __init__(self, devices):
        grid = tuple(tuple(_normal(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = grid
        self.shape = {"data": len(grid), "corpus": len(grid[0])}

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def corpus_devices(self) -> tuple:
        """The devices of the corpus shards, in shard order (data row 0: the
        corpus is the same on every data row)."""
        return self.devices[0]


def _normal(device) -> torch.device:
    """A torch device with its index, so devices compare equal by value."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, data_axis: int = 1, devices=None,
              platform: str | None = None) -> Mesh:
    """Build a ``(data, corpus)`` mesh of ``n_devices`` devices.

    ``devices`` is an explicit list, which may repeat a device (virtual
    shards). Otherwise ``platform="cpu"`` gives ``n_devices`` virtual CPU
    shards, and the default is every visible CUDA device: without a card that
    raises (no CPU fallback), as ``scan.resolve_device`` does. Raises
    ValueError when fewer devices than ``n_devices`` are given."""
    if devices is None:
        if platform == "cpu":
            devices = [torch.device("cpu")] * (n_devices or 1)
        elif platform in (None, "cuda", "gpu"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh: no CUDA device is visible; pass platform='cpu' for virtual "
                    "CPU shards or an explicit device list")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            raise ValueError(f"make_mesh: unknown platform {platform!r}")
    devices = list(devices)
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if data_axis < 1 or n % data_axis:
        raise ValueError(f"{n} devices do not split into {data_axis} data rows")
    cols = n // data_axis
    return Mesh([devices[r * cols : (r + 1) * cols] for r in range(data_axis)])


class Sharded(NamedTuple):
    """Arrays placed on a mesh: ``parts[r][s]`` is the block of data row
    ``r`` and corpus shard ``s`` on ``mesh.devices[r][s]``. Corpus arrays
    hold shard ``s``'s rows on every data row; query arrays hold data row
    ``r``'s queries on every shard."""

    parts: tuple


def _on_mesh(mesh: Mesh, blocks) -> Sharded:
    """Shard ``s``'s block ``blocks[s]`` on every data row's device of
    shard ``s``: copied once to data row 0's device, then from there (``.to``
    of a tensor on its own device is the tensor, so shards that share a
    device share the block)."""
    first = [b.to(dev) for b, dev in zip(blocks, mesh.corpus_devices)]
    return Sharded(tuple(tuple(first[s].to(dev) for s, dev in enumerate(row))
                         for row in mesh.devices))


def shard_corpus(mesh: Mesh, corpus, valid):
    """Place a host corpus (N, D) and its valid mask (N,) onto the mesh,
    padded to shard evenly: shard ``s`` holds rows ``[s n_local, (s + 1)
    n_local)``, the padding invalid."""
    corpus = np.ascontiguousarray(corpus, dtype=np.float32)
    valid = np.asarray(valid, dtype=bool)
    n_shards = mesh.shape["corpus"]
    n = corpus.shape[0]
    n_pad = -(-n // n_shards) * n_shards
    if n_pad != n:
        corpus = np.concatenate([corpus, np.zeros((n_pad - n, corpus.shape[1]), np.float32)])
        valid = np.concatenate([valid, np.zeros(n_pad - n, dtype=bool)])
    n_local = n_pad // n_shards
    xb = [torch.from_numpy(corpus[s * n_local : (s + 1) * n_local]) for s in range(n_shards)]
    vb = [torch.from_numpy(valid[s * n_local : (s + 1) * n_local]) for s in range(n_shards)]
    return _on_mesh(mesh, xb), _on_mesh(mesh, vb)


def shard_queries(mesh: Mesh, queries):
    """Place (B, D) queries onto the mesh, padded to a multiple of the data
    rows, each data row's slice on every shard of its row. Returns
    (sharded queries, B)."""
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    n_data = mesh.shape["data"]
    b = queries.shape[0]
    b_pad = -(-b // n_data) * n_data
    if b_pad != b:
        queries = np.concatenate([queries, np.zeros((b_pad - b, queries.shape[1]), np.float32)])
    per = b_pad // n_data
    cols = mesh.shape["corpus"]
    blocks = []
    for r in range(n_data):
        q = torch.from_numpy(queries[r * per : (r + 1) * per]).to(mesh.devices[r][0])
        blocks.append([q] * cols)
    return Sharded(tuple(tuple(blocks[r][s].to(dev) for s, dev in enumerate(row))
                         for r, row in enumerate(mesh.devices))), b


# ── K21a: the sharded exact search ───────────────────────────────────────


def sharded_search_fn(mesh: Mesh, *, metric: Metric, k: int, plain: bool = False):
    """The sharded exact search step (K21a).

    Inputs: ``xs`` the corpus and ``vs`` its valid mask from
    :func:`shard_corpus`, ``qs`` the queries from :func:`shard_queries`.
    Output: (dists (B_pad, k), ids (B_pad, k)) on the mesh's home device,
    the data rows in order; ids are global row ids (a masked row keeps its
    id and an infinite distance, as in the JAX package). ``plain``: every
    kernel's plain version."""
    keys_fn = scan.metric_keys_plain if plain else scan.metric_keys
    select = topk_select_plain if plain else topk_select

    def step(xs: Sharded, qs: Sharded, vs: Sharded):
        outs = []
        for r, row in enumerate(mesh.devices):
            parts = []
            for s in range(len(row)):
                x, q, v = xs.parts[r][s], qs.parts[r][s], vs.parts[r][s]
                n_local = x.shape[0]
                keys = keys_fn(D.query_transform(q, metric), D.corpus_transform(x, metric), v,
                               metric)
                top, idx = select(keys, min(k, n_local))
                parts.append((unorient(top, metric.ascending), idx.long() + s * n_local))
            outs.append(merge_shards(parts, k, metric.ascending, row[0], plain=plain))
        home = mesh.home
        return (torch.cat([o[0].to(home) for o in outs]),
                torch.cat([o[1].to(home) for o in outs]))

    return step


# ── K21b: the sharded Lloyd step ─────────────────────────────────────────


def kmeans_partials(mesh: Mesh, xs: Sharded, centroids, vs: Sharded, *, plain: bool = False):
    """Each corpus shard's K15a assignment (L2) and K15b update: (sums (S,
    K, D), counts (S, K)) stacked on the home device in shard order. Every
    data row holds the same rows, so data row 0's shards compute them."""
    home = mesh.home
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    assign_fn = KM.kmeans_assign_plain if plain else KM.kmeans_assign
    update_fn = KM.kmeans_update_plain if plain else KM.kmeans_update
    sums, counts = [], []
    for s, dev in enumerate(mesh.corpus_devices):
        x, v, c = xs.parts[0][s], vs.parts[0][s], centroids.to(dev)
        part_sums, part_counts, _, _ = update_fn(x, v, assign_fn(x, c, False), c)
        sums.append(part_sums.to(home, non_blocking=True))
        counts.append(part_counts.to(home, non_blocking=True))
    return torch.stack(sums), torch.stack(counts)


def sharded_kmeans_step_fn(mesh: Mesh, *, plain: bool = False):
    """One sharded Lloyd iteration (K21b): ``step(xs, centroids, vs)`` ->
    (new centroids (K, D), counts (K,)) on the home device: the shards'
    partial sums and counts (:func:`kmeans_partials`) added in shard order,
    each centroid the mean of its valid rows, or unchanged where it has
    none. ``plain``: every kernel's plain version."""
    reduce_fn = KM.kmeans_reduce_shards_plain if plain else KM.kmeans_reduce_shards

    def step(xs: Sharded, centroids, vs: Sharded):
        sums, counts = kmeans_partials(mesh, xs, centroids, vs, plain=plain)
        c = torch.as_tensor(centroids, dtype=torch.float32).to(mesh.home)
        return reduce_fn(sums, counts, c)

    return step

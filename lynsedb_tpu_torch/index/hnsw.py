"""HNSW-style hierarchical graph index on the card.

Port of lynsedb_tpu/index/hnsw.py (reference behaviour: src/index/hnsw.rs —
multi-layer small-world graph, ef_search beam (nprobe maps to ef),
m/ef_construction build parameters). Layer 0 is a Vamana graph of degree
2m (ops/graph.build_vamana: K19 candidates, K20 prunes); the upper layers
are geometric subsamples wired by exact kNN (K19 with L = m). A search
takes its entry points from one exact scan of the finest upper layer (K18 =
K1 + K5; for IP also a sampled entry scan and the top-norm rows), walks
layer 0 with K17 guided by the resident centred-bf16 copy, and rescores the
pool exactly from the host mirror. Under a domain metric (HNSW-L1,
-CHEBYSHEV, -CORRELATION, -HELLINGER, -WASSERSTEIN, -JENSEN-SHANNON,
-HAVERSINE) every stage reads the metric's transform: K19's metric mode and
K20's pair tables build, the entry scan is K6a or K6c + K5, and K17's metric
tier walks the corpus's staged transform with exact keys, which are the
distances returned (the JAX package's f32 tier: no rescore). Rows added
after the build are linked into layer 0 in place at the next commit.

On a corpus that streams (its bf16 copy past the device budget) the graph
has no device rows to walk: a search is the exact streaming scan, and a
commit defers linking until the corpus is on the card again (the JAX
package's hnsw.py:207-216, 301-307).

The files are the JAX package's (``index/hnsw.npz``, ``index/hnsw_meta.json``),
so each package opens the other's index.
"""

from __future__ import annotations

import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..metrics import Metric
from ..ops import distance as D
from ..ops.graph import (
    METRIC_KIND,
    MetricRows,
    beam_batch_cap,
    beam_search,
    beam_search_bf16,
    build_vamana,
    entry_sample,
    entry_scan,
    exact_knn_graph,
    fetch_keys_pool_scanned,
    fetch_pool_scanned,
    finalize_ranked,
    insert_points,
    merge_tail,
)
from ..ops.scan import _handle
from ..storage.vector_store import write_atomic

DEFAULT_M = 16
DEFAULT_EF_CONSTRUCTION = 128
DEFAULT_EF_SEARCH = 50
LAYER_DECAY = 16  # upper layer subsample ratio
# Layer 0 gets incremental inserts (reference: hnsw.rs:784 insert_point); a
# full rebuild (which also refreshes the upper layers) is the backstop past
# this growth fraction.
REBUILD_GROWTH_FRACTION = 0.5


class HNSWIndex:
    kind = "hnsw"

    ENTRY_SAMPLE = 16384  # the IP entry scan's sample (as DiskANN's)
    ENTRY_TOP = 16
    ENTRY_NORM_TOP = 4096

    def __init__(self, coll, mode, opts, layer0: np.ndarray, upper: list[dict],
                 entry: int, built_rows: int, m: int, efc: int, efs: int):
        self.mode = mode
        self.metric: Metric = mode.metric
        self.device = coll.device
        self.layer0_np = layer0
        self.upper = upper  # [{"nodes": (Ni,), "graph": (Ni, m)}] coarse -> fine
        self.entry = int(entry)
        self.built_rows = int(built_rows)
        self.m = m
        self.ef_construction = efc
        self.ef_search = efs
        self.ip_starts = np.zeros(0, dtype=np.int32)
        self.last_scanned = 0
        self.last_build_phases: dict = {}
        self._dev = None
        self._ip_entry_dev = None

    @classmethod
    def build(cls, coll, mode, opts) -> "HNSWIndex":
        t0 = time.perf_counter()
        data = coll.store.read_all()
        n = data.shape[0]
        if n == 0:
            raise ValueError("cannot build an HNSW index on an empty collection")
        m = opts.m or DEFAULT_M
        efc = opts.ef_construction or DEFAULT_EF_CONSTRUCTION
        efs = opts.ef_search or DEFAULT_EF_SEARCH
        phases = {"read": time.perf_counter() - t0}
        rows = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(coll.device)

        # layer 0 has degree 2m (the reference's m0)
        layer0 = build_vamana(rows, mode.metric, r=2 * m, l_build=max(efc // 2, m * 2),
                              alpha=1.2, phases=phases)

        # upper layers: geometric subsamples with exact kNN wiring
        t0 = time.perf_counter()
        rng = np.random.default_rng(7)
        upper: list[dict] = []
        max_level = opts.max_level or max(int(math.log(max(n, 2), LAYER_DECAY)), 0)
        nodes = np.arange(n)
        for _ in range(max_level):
            if len(nodes) <= max(m * 2, 8):
                break
            nodes = np.sort(rng.choice(nodes, size=max(len(nodes) // LAYER_DECAY, 4),
                                       replace=False))
            graph = exact_knn_graph(rows[torch.from_numpy(nodes).to(coll.device)], mode.metric, m)
            upper.insert(0, {"nodes": nodes.astype(np.int32), "graph": graph})
        del rows
        entry = int(upper[0]["nodes"][0]) if upper else 0
        idx = cls(coll, mode, opts, layer0, upper, entry, n, m, efc, efs)
        idx.ip_starts = idx._compute_ip_starts(np.asarray(data))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        phases["upper_layers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.save(coll)
        phases["save"] = time.perf_counter() - t0
        idx.last_build_phases = phases
        return idx

    def _compute_ip_starts(self, data: np.ndarray) -> np.ndarray:
        """Extra fixed entry points for inner product: the highest-norm rows
        (MIPS winners concentrate at large norms)."""
        if self.metric is not Metric.IP or len(data) == 0:
            return np.zeros(0, dtype=np.int32)
        norms = np.linalg.norm(np.asarray(data, dtype=np.float32), axis=1)
        return np.unique(np.argsort(-norms)[:4].astype(np.int32))

    # ── persistence ──────────────────────────────────────────────────────

    def save(self, coll) -> None:
        idx_dir = coll.root / "index"
        idx_dir.mkdir(parents=True, exist_ok=True)
        arrays = {"layer0": self.layer0_np, "ip_starts": self.ip_starts}
        for i, layer in enumerate(self.upper):
            arrays[f"u{i}_nodes"] = layer["nodes"]
            arrays[f"u{i}_graph"] = layer["graph"]
        np.savez(idx_dir / "hnsw.npz", **arrays)
        write_atomic(
            idx_dir / "hnsw_meta.json",
            json.dumps(
                {
                    "entry": self.entry,
                    "built_rows": self.built_rows,
                    "m": self.m,
                    "ef_construction": self.ef_construction,
                    "ef_search": self.ef_search,
                    "n_upper": len(self.upper),
                }
            ).encode(),
        )

    @classmethod
    def load(cls, coll, mode, opts) -> Optional["HNSWIndex"]:
        idx_dir = coll.root / "index"
        if not (idx_dir / "hnsw.npz").exists():
            return None
        meta = json.loads((idx_dir / "hnsw_meta.json").read_text())
        data = np.load(idx_dir / "hnsw.npz")
        upper = [
            {"nodes": data[f"u{i}_nodes"], "graph": data[f"u{i}_graph"]}
            for i in range(meta["n_upper"])
        ]
        idx = cls(coll, mode, opts, data["layer0"], upper, meta["entry"],
                  meta["built_rows"], meta["m"], meta["ef_construction"], meta["ef_search"])
        if "ip_starts" in data.files:
            idx.ip_starts = data["ip_starts"]
        return idx

    # ── search ───────────────────────────────────────────────────────────

    def _device(self, corpus):
        """Layer 0 on the card, the finest upper layer's ids and corpus
        transform (its rows from the host mirror) for the entry scan, and
        under a domain metric the MetricRows of the corpus's staged
        transform that the walk reads."""
        if self._dev is None:
            self._dev = {"layer0": torch.from_numpy(np.ascontiguousarray(self.layer0_np))
                         .to(self.device)}
            if self.metric not in METRIC_KIND:
                self._dev["space"] = MetricRows.of(corpus.transform(self.metric), self.metric)
            if self.upper:
                nodes = self.upper[-1]["nodes"]
                self._dev["upper_ids"] = torch.from_numpy(nodes.astype(np.int32)).to(self.device)
                rows = np.asarray(corpus.host_rows(nodes), dtype=np.float32)
                self._dev["upper_ct"] = D.corpus_transform(
                    torch.from_numpy(rows).to(self.device), self.metric)
        return self._dev

    def _ip_entry_state(self, corpus):
        """The IP entry scan's fixed node sample (random rows and the
        top-norm band): (ids int32, the rows' corpus transform)."""
        if self._ip_entry_dev is None:
            self._ip_entry_dev = entry_sample(corpus, self.built_rows, self.metric, self.device,
                                               self.ENTRY_SAMPLE, self.ENTRY_NORM_TOP)
        return self._ip_entry_dev

    def _descend(self, qd: torch.Tensor, corpus, live: torch.Tensor) -> torch.Tensor:
        """Entry selection: one exact scan over the finest upper layer's
        nodes (upper layers are nested, so its top picks dominate the
        per-layer greedy descent). Returns (B, S) int32 node ids."""
        dev = self._device(corpus)
        if "upper_ids" not in dev:
            return torch.full((qd.shape[0], 1), self.entry, dtype=torch.int32, device=self.device)
        ids = dev["upper_ids"]
        return entry_scan(qd, dev["upper_ct"], ids, live, metric=self.metric,
                          s=int(min(4, ids.shape[0])))

    def _starts(self, qd: torch.Tensor, corpus, live: torch.Tensor) -> torch.Tensor:
        """(B, S) per-query entry points: the descent's, and for IP the
        sampled entry scan's top ENTRY_TOP and the fixed high-norm starts."""
        starts = self._descend(qd, corpus, live)
        if self.metric is Metric.IP:
            ids_d, ct = self._ip_entry_state(corpus)
            parts = [starts, entry_scan(qd, ct, ids_d, live, metric=self.metric,
                                        s=self.ENTRY_TOP)]
            if len(self.ip_starts):
                fixed = torch.from_numpy(self.ip_starts.astype(np.int32)).to(self.device)
                parts.append(fixed[None, :].expand(starts.shape[0], -1))
            starts = torch.cat(parts, dim=1)
        return starts.contiguous()

    def search(self, coll, q: np.ndarray, k: int, mask, nprobe: int):
        metric = self.metric
        corpus = coll.corpus()
        handle = _handle(mask)
        q2 = np.ascontiguousarray(np.atleast_2d(q), dtype=np.float32)
        if corpus.would_stream():
            # no device rows for the walk: the exact blockwise streaming scan
            dists, ids = corpus.search(q2, k, metric, filter_mask=handle)
            self.last_scanned = int(corpus.n)
            return finalize_ranked(dists.astype(np.float32), ids.astype(np.int64), k, metric)
        dev = self._device(corpus)
        ef = max(int(nprobe or 0), self.ef_search, k)
        if metric is Metric.IP:
            ef = ef * 5 // 4  # +25% for raw MIPS (as DiskANN's IP oversample)
        live = corpus.valid_mask(handle)[: self.built_rows]

        def dispatch(qd: torch.Tensor, q_np: np.ndarray):
            """The walk of layer 0 over a (<= cap)-query part: (ids, dists,
            scanned). IP, L2, cosine: bf16-guided, then the exact host
            rescore of the pool; a domain metric: exact keys over the
            metric's transform, the best k of the pool."""
            starts = self._starts(qd, corpus, live)
            if "space" in dev:
                keys, ids, scanned = beam_search(qd, dev["space"], dev["layer0"], starts, live,
                                                 metric=metric, beam=ef, max_steps=ef * 2, k=k)
                keys, ids, n_sc = fetch_keys_pool_scanned(keys, ids, scanned)
                return ids, -keys, n_sc  # every domain metric is ascending
            aux = corpus.bf16_aux()
            _, pool, scanned = beam_search_bf16(
                qd, corpus.data16, aux["mean"], aux["xm"], aux["xc_sq"], aux["xsq_true"],
                dev["layer0"], starts, live, metric_kind=METRIC_KIND[metric], beam=ef,
                max_steps=ef * 2)
            ids, n_sc = fetch_pool_scanned(pool, scanned)
            return ids, corpus.rescore(q_np, ids, metric), n_sc

        qd = torch.from_numpy(q2).to(self.device)
        cap = beam_batch_cap(self.built_rows, self.device)
        parts = [dispatch(qd[i : i + cap], q2[i : i + cap]) for i in range(0, len(q2), cap)]
        ids = np.concatenate([p[0] for p in parts])
        dists = np.concatenate([p[1] for p in parts]).astype(np.float32)
        self.last_scanned = max(p[2] for p in parts)
        dists, ids = merge_tail(coll, corpus, q2, k, metric, handle, self.built_rows, dists, ids)
        return finalize_ranked(dists, ids, k, metric)

    # ── lifecycle ────────────────────────────────────────────────────────

    def on_commit(self, coll) -> None:
        """Incremental layer-0 insert of rows added since the last commit
        (reference: hnsw.rs:784 insert_point, batched as the Vamana link
        step). The upper layers keep their subsample until the growth
        rebuild refreshes them: they only seed the descent."""
        n = coll.n_rows
        if n <= self.built_rows:
            return
        base = getattr(self, "_rows_at_build", self.built_rows)
        grown = getattr(self, "_inserted_since_build", 0) + (n - self.built_rows)
        corpus = coll.corpus()
        if corpus.would_stream():
            # the streaming search is the exact scan, and linking (or a
            # rebuild) needs the f32 rows on the card: built_rows stays, so
            # the first commit with the corpus on the card links the tail
            return
        if grown > REBUILD_GROWTH_FRACTION * max(base, 1):
            self.rebuild(coll)
            return
        tombs = coll.tombstones.to_bool_array(n)
        live = np.ones(n, dtype=bool)
        live[: len(tombs)] &= ~tombs
        new_ids = np.arange(self.built_rows, n, dtype=np.int64)
        new_ids = new_ids[live[self.built_rows : n]]
        starts = np.unique(
            np.concatenate([[self.entry], self.upper[-1]["nodes"] if self.upper else []])
        ).astype(np.int32)
        self.layer0_np = insert_points(
            self.layer0_np, new_ids, corpus._data[:n], torch.from_numpy(starts), live,
            metric=self.metric, r=self.layer0_np.shape[1],
            l_build=max(self.ef_construction // 2, self.m * 2), alpha=1.2,
        )
        self._inserted_since_build = grown
        self.built_rows = n
        self._dev = None
        self._ip_entry_dev = None  # the sample tracks the grown corpus
        self.save(coll)

    def rebuild(self, coll) -> None:
        from . import IndexBuildOptions

        opts = IndexBuildOptions(
            m=self.m, ef_construction=self.ef_construction, ef_search=self.ef_search
        )
        self._dev = self._ip_entry_dev = None
        fresh = HNSWIndex.build(coll, self.mode, opts)
        self.__dict__.update(fresh.__dict__)
        self._inserted_since_build = 0
        self._rows_at_build = self.built_rows

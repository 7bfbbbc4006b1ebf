"""DiskANN-style Vamana index on the card.

Port of lynsedb_tpu/index/diskann.py (reference behaviour: src/index/
diskann.rs — Vamana build :798-1084, beam search :602, in-place insert and
delete repair :1337/:1496). The build is ops/graph.build_vamana (K19 exact
candidates, two K20 prune passes); a search takes per-query entry points
from an exact scan of a fixed node sample (K18 = K1 + K5), walks the graph
with K17 guided by the resident centred-bf16 copy, and rescores the pool
exactly from the host mirror.

Layered mode (past LAYERED_MIN_ROWS rows, reference diskann.rs:276): the
build also fits SQ8 codes and PQ codes with per-row scale corrections, the
guidance of K17's deeper tiers. The port has no streaming tier (ROADMAP
A.5), so the resident bf16 tier serves every search; the ``_force_sq8`` /
``_force_pq`` hooks walk the deeper tiers on a resident corpus, as the JAX
package's tests do.

The files are the JAX package's (``index/graph.npz``,
``index/graph_meta.json``), so each package opens the other's index.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..metrics import Metric
from ..ops.graph import (
    METRIC_KIND,
    beam_batch_cap,
    beam_search,
    beam_search_bf16,
    beam_search_pq,
    beam_search_sq8,
    build_vamana,
    entry_sample,
    entry_scan,
    fetch_keys_pool_scanned,
    fetch_pool_scanned,
    finalize_ranked,
    insert_points,
    merge_tail,
    reconnect_orphans,
    repair_deleted_edges,
)
from ..ops.quantize import PQ, SQ8
from ..ops.scan import _handle
from ..storage.vector_store import write_atomic

DEFAULT_R = 32
DEFAULT_L = 96
DEFAULT_ALPHA = 1.2
# In-place insert/delete repair is the update mechanism (reference
# IP-DiskANN, diskann.rs:1337/:1496); a full rebuild is only the backstop
# once accumulated churn passes this fraction of the built corpus.
REBUILD_CHURN_FRACTION = 0.5
# Past this row count the build also fits the SQ8 and PQ guidance tiers
# (the reference flips to the disk graph + PQ codes, diskann.rs:276).
LAYERED_MIN_ROWS = 200_000
PQ_FIT_SAMPLE = 131072
def _pq_row_terms(pq: PQ, data: np.ndarray, codes: np.ndarray):
    """Per-row PQ guidance terms: the least-squares scale alpha = x.x_hat /
    x_hat.x_hat (1 where x_hat is 0) and the true squared norm."""
    dec = pq.decode(codes)
    num = np.einsum("nd,nd->n", data, dec)
    den = np.einsum("nd,nd->n", dec, dec)
    alpha = np.where(den > 0, num / np.maximum(den, 1e-30), 1.0).astype(np.float32)
    return alpha, np.einsum("nd,nd->n", data, data).astype(np.float32)


class DiskANNIndex:
    kind = "diskann"

    # entry scan (same 1M raw-MIPS sweep as the JAX package's diskann.py):
    # a 16,384-node sample, each query's top 16, and for IP the top-norm band
    ENTRY_SAMPLE = 16384
    ENTRY_TOP = 16
    ENTRY_NORM_TOP = 4096

    def __init__(self, coll, mode, opts, graph: np.ndarray, medoid: int, built_rows: int,
                 r: int, l: int, alpha: float, starts: Optional[np.ndarray] = None):
        self.mode = mode
        self.metric: Metric = mode.metric
        self.device = coll.device
        self.graph_np = graph
        self.medoid = int(medoid)
        self.built_rows = int(built_rows)
        self.r = r
        self.l = l
        self.alpha = alpha
        self._starts_np = starts if starts is not None else np.asarray([medoid], dtype=np.int32)
        self._graph_dev = None
        self._entry_dev = None  # (sample ids, sample corpus transform) of the entry scan
        self.last_scanned = 0
        self.last_build_phases: dict = {}
        # layered-mode artifacts (None when not layered)
        self.pq: Optional[PQ] = None
        self.pq_codes: Optional[np.ndarray] = None  # (built_rows, M) uint8
        self.pq_alpha: Optional[np.ndarray] = None  # (built_rows,) f32 row scale
        self.pq_row_sq: Optional[np.ndarray] = None  # (built_rows,) f32 true norms^2
        self._pq_dev = None
        self.sq8_codes: Optional[np.ndarray] = None  # (built_rows, D) int8
        self.sq8_lo: Optional[np.ndarray] = None
        self.sq8_scale: Optional[np.ndarray] = None
        self._sq8_dev = None

    # ── build ────────────────────────────────────────────────────────────

    @classmethod
    def build(cls, coll, mode, opts) -> "DiskANNIndex":
        t0 = time.perf_counter()
        data = coll.store.read_all()
        n = data.shape[0]
        if n == 0:
            raise ValueError("cannot build a DiskANN index on an empty collection")
        r = opts.r or DEFAULT_R
        l = opts.l or DEFAULT_L
        alpha = float(opts.alpha or DEFAULT_ALPHA)
        if opts.max_degree:
            r = min(r, opts.max_degree)
        phases = {"read": time.perf_counter() - t0}
        rows = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(coll.device)
        graph = build_vamana(rows, mode.metric, r=r, l_build=l, alpha=alpha, phases=phases)
        t0 = time.perf_counter()
        medoid = int(((rows - rows.mean(0)) ** 2).sum(1).argmin())
        del rows
        idx = cls(coll, mode, opts, graph, medoid, n, r, l, alpha)
        idx._starts_np = idx._compute_starts(data)
        if mode.metric in METRIC_KIND and n >= LAYERED_MIN_ROWS:
            idx._fit_pq(data)
        phases["pq_sq8_fit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.save(coll)
        phases["save"] = time.perf_counter() - t0
        idx.last_build_phases = phases
        return idx

    def _fit_pq(self, data: np.ndarray) -> None:
        """Train and encode the layered guidance tiers: SQ8 codes (1 byte a
        dimension) and PQ codes with the least-squares row scale and the
        true squared norms."""
        data = np.asarray(data, dtype=np.float32)
        sample = data if len(data) <= PQ_FIT_SAMPLE else data[
            np.random.default_rng(7).choice(len(data), PQ_FIT_SAMPLE, replace=False)
        ]
        self.pq = PQ.fit(sample, device=self.device)
        self.pq_codes = self.pq.encode(data, device=self.device)
        self.pq_alpha, self.pq_row_sq = _pq_row_terms(self.pq, data, self.pq_codes)
        self._pq_dev = None
        sq = SQ8.fit(data)
        self.sq8_codes = sq.encode(data)
        self.sq8_lo = sq.lo
        self.sq8_scale = sq.scale
        self._sq8_dev = None

    def _extend_codes(self, tail: np.ndarray) -> None:
        """Encode rows added in place into every code tier (the codebooks and
        the SQ8 range stay fixed; a rebuild refits them). The JAX package's
        resident commit extends only the PQ codes; the port keeps the row
        scales, norms and SQ8 codes in step, so a forced deep tier never
        reads past them."""
        codes = self.pq.encode(tail, device=self.device)
        self.pq_codes = np.concatenate([self.pq_codes, codes])
        if self.pq_alpha is not None:
            alpha, row_sq = _pq_row_terms(self.pq, tail, codes)
            self.pq_alpha = np.concatenate([self.pq_alpha, alpha])
            self.pq_row_sq = np.concatenate([self.pq_row_sq, row_sq])
        if self.sq8_codes is not None:
            sq = SQ8(self.sq8_lo, self.sq8_lo + self.sq8_scale * 255.0)
            self.sq8_codes = np.concatenate([self.sq8_codes, sq.encode(tail)])
        self._pq_dev = self._sq8_dev = None

    @property
    def layered(self) -> bool:
        return self.pq_codes is not None

    def _pq_row_sq(self, codes: np.ndarray) -> np.ndarray:
        """Reconstructed squared norms (a legacy index without true norms)."""
        return self.pq.row_sq_from_codes(codes)

    def _starts_from_sample(self, rows: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Entry points from live (rows, ids): the medoid, plus the four
        highest-norm rows for IP."""
        centroid = rows.mean(axis=0)
        self.medoid = int(ids[np.argmin(((rows - centroid) ** 2).sum(1))])
        starts = [self.medoid]
        if self.metric is Metric.IP:
            norms = np.linalg.norm(rows, axis=1)
            starts.extend(int(x) for x in ids[np.argsort(-norms)[:4]])
        return np.unique(np.asarray(starts, dtype=np.int32))

    def _compute_starts(self, data: np.ndarray) -> np.ndarray:
        """Entry points: the medoid plus, for inner product, the
        highest-norm rows (MIPS winners concentrate at large norms)."""
        starts = [self.medoid]
        if self.metric is Metric.IP:
            norms = np.linalg.norm(data, axis=1)
            starts.extend(np.argsort(-norms)[:4].tolist())
        return np.unique(np.asarray(starts, dtype=np.int32))

    # ── persistence ──────────────────────────────────────────────────────

    def save(self, coll) -> None:
        idx_dir = coll.root / "index"
        idx_dir.mkdir(parents=True, exist_ok=True)
        arrays = {"graph": self.graph_np, "starts": self._starts_np}
        if self.layered:
            arrays["pq_codes"] = self.pq_codes
            arrays["pq_codebooks"] = self.pq.codebooks
            if self.pq_alpha is not None:
                arrays["pq_alpha"] = self.pq_alpha
                arrays["pq_row_sq"] = self.pq_row_sq
            if self.sq8_codes is not None:
                arrays["sq8_codes"] = self.sq8_codes
                arrays["sq8_lo"] = self.sq8_lo
                arrays["sq8_scale"] = self.sq8_scale
        np.savez(idx_dir / "graph.npz", **arrays)
        write_atomic(
            idx_dir / "graph_meta.json",
            json.dumps(
                {
                    "kind": self.kind,
                    "medoid": self.medoid,
                    "built_rows": self.built_rows,
                    "r": self.r,
                    "l": self.l,
                    "alpha": self.alpha,
                }
            ).encode(),
        )

    @classmethod
    def load(cls, coll, mode, opts) -> Optional["DiskANNIndex"]:
        idx_dir = coll.root / "index"
        if not (idx_dir / "graph.npz").exists():
            return None
        meta = json.loads((idx_dir / "graph_meta.json").read_text())
        data = np.load(idx_dir / "graph.npz")
        if "unlinked" in data.files and len(data["unlinked"]):
            raise NotImplementedError(
                "this DiskANN index holds rows linked while its corpus streamed; the streaming "
                "tier is not ported yet (ROADMAP A.5)")
        starts = data["starts"] if "starts" in data.files else None
        idx = cls(coll, mode, opts, data["graph"], meta["medoid"], meta["built_rows"],
                  meta["r"], meta["l"], meta["alpha"], starts=starts)
        if "pq_codes" in data.files:
            idx.pq = PQ(data["pq_codebooks"])
            idx.pq_codes = data["pq_codes"]
            if "pq_alpha" in data.files:
                idx.pq_alpha = data["pq_alpha"]
                idx.pq_row_sq = data["pq_row_sq"]
            else:  # legacy layered index: uncorrected guidance
                idx.pq_alpha = np.ones(len(idx.pq_codes), dtype=np.float32)
                idx.pq_row_sq = idx._pq_row_sq(idx.pq_codes)
            if "sq8_codes" in data.files:
                idx.sq8_codes = data["sq8_codes"]
                idx.sq8_lo = data["sq8_lo"]
                idx.sq8_scale = data["sq8_scale"]
        return idx

    # ── search ───────────────────────────────────────────────────────────

    def _graph(self) -> torch.Tensor:
        if self._graph_dev is None:
            self._graph_dev = torch.from_numpy(np.ascontiguousarray(self.graph_np)).to(self.device)
        return self._graph_dev

    def _entry_state(self, coll):
        """The entry scan's fixed node sample on the card: (ids int32, the
        rows' corpus transform). For IP it includes the top-norm band."""
        if self._entry_dev is None:
            self._entry_dev = entry_sample(
                coll.corpus(), self.built_rows, self.metric, self.device, self.ENTRY_SAMPLE,
                self.ENTRY_NORM_TOP if self.metric is Metric.IP else 0)
        return self._entry_dev

    def _query_starts(self, coll, qd: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """(B, S) per-query entry points: the sampled entry scan's top
        ENTRY_TOP, then the global starts (medoid, and top-norm rows for IP)."""
        ids_d, ct = self._entry_state(coll)
        per_q = entry_scan(qd, ct, ids_d, live, metric=self.metric, s=self.ENTRY_TOP)
        fixed = torch.from_numpy(self._starts_np.astype(np.int32)).to(self.device)
        return torch.cat([per_q, fixed[None, :].expand(per_q.shape[0], -1)], dim=1).contiguous()

    def _pq_device(self):
        if self._pq_dev is None:
            alpha = self.pq_alpha if self.pq_alpha is not None else \
                np.ones(len(self.pq_codes), dtype=np.float32)
            row_sq = self.pq_row_sq if self.pq_row_sq is not None else \
                self._pq_row_sq(self.pq_codes)
            self._pq_dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.pq_codes, self.pq.codebooks, alpha, row_sq))
        return self._pq_dev

    def _sq8_device(self):
        if self._sq8_dev is None:
            row_sq = self.pq_row_sq if self.pq_row_sq is not None else \
                self._pq_row_sq(self.pq_codes)
            self._sq8_dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.sq8_codes, self.sq8_lo, self.sq8_scale, row_sq))
        return self._sq8_dev

    def _tier(self) -> str:
        """The guidance tier, as the JAX package picks it on a resident
        corpus: bf16, unless a test hook (``_force_sq8`` / ``_force_pq``)
        forces a streaming tier: SQ8 or PQ when the index is layered, else
        the exact f32 walk."""
        force_pq = getattr(self, "_force_pq", False)
        force_sq8 = getattr(self, "_force_sq8", False)
        if not (force_pq or force_sq8):
            return "bf16"
        if self.layered:
            return "sq8" if force_sq8 else "pq"
        return "f32"

    def search(self, coll, q: np.ndarray, k: int, mask, nprobe: int):
        metric = self.metric
        corpus = coll.corpus()
        handle = _handle(mask)
        beam = max(int(nprobe or 0), self.l, k)
        if metric is Metric.IP:
            # raw inner product needs a wider pool than L2 at equal recall
            beam = beam * 5 // 4
        live = corpus.valid_mask(handle)[: self.built_rows]
        q2 = np.ascontiguousarray(np.atleast_2d(q), dtype=np.float32)
        qd = torch.from_numpy(q2).to(self.device)
        guided, tier = METRIC_KIND[metric], self._tier()

        def dispatch(qc: torch.Tensor, q_np: np.ndarray):
            """One beam over a (<= cap)-query part: (ids, dists, scanned)."""
            sc = self._query_starts(coll, qc, live)
            if tier == "bf16":
                aux = corpus.bf16_aux()
                _, pool, scanned = beam_search_bf16(
                    qc, corpus.data16, aux["mean"], aux["xm"], aux["xc_sq"], aux["xsq_true"],
                    self._graph(), sc, live, metric_kind=guided, beam=beam, max_steps=beam * 2)
            elif tier == "sq8":
                beam_q = beam * 5 // 4
                c_d, lo_d, sc_d, rsq_d = self._sq8_device()
                _, pool, scanned = beam_search_sq8(
                    qc, c_d, lo_d, sc_d, rsq_d, self._graph(), sc, live,
                    metric_kind=guided, beam=beam_q, max_steps=beam_q * 2)
            elif tier == "pq":
                beam_pq = 2 * beam  # the PQ proxy smears ranking: a 2x pool
                codes_d, books_d, alpha_d, row_sq_d = self._pq_device()
                _, pool, scanned = beam_search_pq(
                    qc, codes_d, books_d, alpha_d, row_sq_d, self._graph(), sc, live,
                    metric_kind=guided, beam=beam_pq, max_steps=beam_pq * 2)
            else:
                keys, ids, scanned = beam_search(
                    qc, corpus._data, self._graph(), sc, live,
                    metric=metric, beam=beam, max_steps=beam * 2, k=k)
                keys, ids, n_sc = fetch_keys_pool_scanned(keys, ids, scanned)
                return ids, -keys if metric.ascending else keys, n_sc
            ids, n_sc = fetch_pool_scanned(pool, scanned)
            return ids, corpus.rescore(q_np, ids, metric), n_sc + ids.shape[1]

        cap = beam_batch_cap(self.built_rows, self.device)
        parts = [dispatch(qd[i : i + cap], q2[i : i + cap]) for i in range(0, len(q2), cap)]
        ids = np.concatenate([p[0] for p in parts])
        dists = np.concatenate([p[1] for p in parts]).astype(np.float32)
        self.last_scanned = max(p[2] for p in parts)
        dists, ids = merge_tail(coll, corpus, q2, k, metric, handle, self.built_rows, dists, ids)
        return finalize_ranked(dists, ids, k, metric)

    # ── lifecycle: in-place updates (reference IP-DiskANN) ───────────────

    def on_commit(self, coll) -> None:
        """Bring the graph up to date in place: repair edges into newly
        tombstoned nodes (diskann.rs:1337 + Alg-6 consolidation :502-560),
        link rows added since the last commit (:1496), and re-link any live
        node that lost all in-edges. A full rebuild runs only when the churn
        passes REBUILD_CHURN_FRACTION."""
        n = coll.n_rows
        if n == 0 or self.built_rows == 0:
            return
        inserted = getattr(self, "_inserted_since_build", 0) + max(n - self.built_rows, 0)
        tomb_count = coll.tombstones.count()
        base = getattr(self, "_rows_at_build", self.built_rows)
        corpus = coll.corpus()
        if max(inserted, tomb_count) > REBUILD_CHURN_FRACTION * max(base, 1):
            self.rebuild(coll)
            return
        self._inserted_since_build = inserted

        tombs = coll.tombstones.to_bool_array(n)
        rows_dev = corpus._data[:n]
        live = np.ones(n, dtype=bool)
        live[: len(tombs)] &= ~tombs
        changed = False

        # entry points must stay live (a dead medoid strands the beam)
        if not live[self._starts_np].all():
            live_rows = np.nonzero(live)[0]
            if len(live_rows) == 0:
                return
            rows = np.asarray(corpus.host_rows(live_rows), dtype=np.float32)
            self._starts_np = self._starts_from_sample(rows, live_rows)
            changed = True
        starts = torch.from_numpy(self._starts_np.astype(np.int32)).to(self.device)

        repaired = repair_deleted_edges(
            self.graph_np, tombs[: self.built_rows], rows_dev,
            metric=self.metric, r=self.r, alpha=self.alpha,
        )
        changed = changed or bool(repaired)

        if n > self.built_rows:
            new_ids = np.arange(self.built_rows, n, dtype=np.int64)
            new_ids = new_ids[live[self.built_rows : n]]
            self.graph_np = insert_points(
                self.graph_np, new_ids, rows_dev, starts, live,
                metric=self.metric, r=self.r, l_build=self.l, alpha=self.alpha,
            )
            if self.layered:
                self._extend_codes(np.asarray(
                    corpus.host_rows(np.arange(self.built_rows, n)), dtype=np.float32))
            self.built_rows = n
            changed = True

        relinked = reconnect_orphans(
            self.graph_np, live[: self.built_rows], rows_dev, starts,
            metric=self.metric, r=self.r, l_build=self.l, alpha=self.alpha,
        )
        changed = changed or bool(relinked)

        if changed:
            self._graph_dev = None
            self._entry_dev = None  # the sample tracks the grown / culled corpus
            self.save(coll)

    def rebuild(self, coll) -> None:
        from . import IndexBuildOptions

        opts = IndexBuildOptions(r=self.r, l=self.l, alpha=self.alpha)
        self._graph_dev = self._entry_dev = self._pq_dev = self._sq8_dev = None
        fresh = DiskANNIndex.build(coll, self.mode, opts)
        self.__dict__.update(fresh.__dict__)
        self._inserted_since_build = 0
        self._rows_at_build = self.built_rows

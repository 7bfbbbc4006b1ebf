"""IVF / SPANN partition indexes on the card.

Port of lynsedb_tpu/index/ivf.py (reference behaviour: src/index/ivf.rs:19,
src/index/spann.rs:24). Rows are gathered into cluster-contiguous blocks of
2,048 f32 rows in device memory. A query scores the centroid table (K1
``flat_scores_f32``), takes the top ``nprobe`` clusters (K5
``topk_select``), scans their blocks exactly (:func:`ivf_scan_blocks`,
csrc/ivf_scan_blocks.cu) and takes the top ``fetch`` keys (K5). Rows added
after the build sit in an exactly scanned tail (the corpus's flat search)
until the next commit posts them to their nearest centroids.

IVF-HAMMING and IVF-JACCARD train k-means (L2) on the rows thresholded at 0.5
as f32 {0, 1} rows, probe the centroids thresholded the same way (K6b
``binary_scores``, then K5) and scan blocks of bit-packed rows with their bit
counts (:func:`ivf_binary_blocks`, K16b); new rows post to their nearest float
centroid by L2, as the JAX package does.

The files are the JAX package's (``index/ivf.npz``, ``index/ivf_meta.json``)
byte for byte, so each package opens the other's index.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..metrics import Metric
from ..ops import _cuda, scan
from ..ops import distance as D
from ..ops.kmeans import train_kmeans
from ..ops.scan import _handle, _kernel_metric, _to_key
from ..ops.topk import topk_select, unorient
from ..storage.vector_store import write_atomic

BLOCK_SIZE = 2048
DEFAULT_N_CLUSTERS = 256
DEFAULT_NPROBE = 32
DEFAULT_REPLICAS = 1
# corpus rows scored against the centroids per K1 launch when posting rows
TOP_R_CHUNK = 65536


# ── ivf_scan_blocks ──────────────────────────────────────────────────────


def ivf_scan_blocks_plain(q, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig, live,
                          metric: Metric) -> torch.Tensor:
    """Plain version of :func:`ivf_scan_blocks` and, under a binary metric,
    of :func:`ivf_binary_blocks` (``q`` and ``blocks`` bit-packed words,
    ``qsq`` and ``block_sq`` their bit counts), one query at a time (the JAX
    kernel's lax.map)."""
    b = q.shape[0]
    bs, w = blocks.shape[1:]
    slot_blk = cluster_blocks[top_c.long()].reshape(b, -1)
    lead, term = ("bits", "cnt") if metric.is_binary else ("x", "sq")
    out = []
    for i in range(b):
        safe = slot_blk[i].clamp_min(0).long()
        orig = torch.where((slot_blk[i] >= 0)[:, None], block_orig.view(-1, bs)[safe], -1)
        orig = orig.reshape(-1)
        valid = (orig >= 0) & live[orig.clamp_min(0).long()]
        ct = {lead: blocks[safe].reshape(-1, w)}
        qt = {lead: q[i : i + 1]}
        if metric is not Metric.IP:
            ct[term] = block_sq.view(-1, bs)[safe].reshape(-1)
            qt[term] = qsq[i : i + 1]
        out.append(_to_key(D.pairwise(qt, ct, metric), metric.ascending, valid))
    return torch.cat(out)


def ivf_scan_blocks(q: torch.Tensor, qsq: Optional[torch.Tensor], top_c: torch.Tensor,
                    cluster_blocks: torch.Tensor, blocks: torch.Tensor,
                    block_sq: Optional[torch.Tensor], block_orig: torch.Tensor,
                    live: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Oriented, masked exact keys (B, nprobe * max_bpc * BLOCK_SIZE) of
    queries ``q`` (B, D) against the blocks of their probed clusters
    ``top_c`` (B, nprobe) int32. Slot s of a query is block
    ``cluster_blocks[top_c[s // max_bpc], s % max_bpc]``; a key is -inf where
    that is -1, where ``block_orig`` (n_blocks * BLOCK_SIZE,) is -1, or where
    ``live[orig]`` is false. ``qsq`` (B,) and ``block_sq`` are the squared
    norms (L2 / cosine; None for IP)."""
    if q.device.type == "cpu":
        return ivf_scan_blocks_plain(q, qsq, top_c, cluster_blocks, blocks, block_sq, block_orig,
                                     live, metric)
    code = _kernel_metric("ivf_scan_blocks", metric)
    if metric is Metric.IP:
        qsq = block_sq = None
    elif qsq is None or block_sq is None:
        raise ValueError("ivf_scan_blocks: qsq and block_sq expected for L2/cosine")
    _cuda.require_cuda("ivf_scan_blocks", q, qsq, top_c, cluster_blocks, blocks, block_sq,
                       block_orig, live)
    b, d = q.shape
    nprobe = top_c.shape[1]
    max_bpc = cluster_blocks.shape[1]
    if (q.dtype != torch.float32 or blocks.dtype != torch.float32
            or blocks.shape[1:] != (BLOCK_SIZE, d) or top_c.dtype != torch.int32
            or cluster_blocks.dtype != torch.int32 or block_orig.dtype != torch.int32
            or live.dtype != torch.bool):
        raise ValueError("ivf_scan_blocks: unexpected dtypes or shapes")
    keys = torch.empty((b, nprobe * max_bpc * BLOCK_SIZE), dtype=torch.float32, device=q.device)
    _cuda.call("lt_ivf_scan_blocks", q.data_ptr(), _cuda.ptr(qsq), top_c.data_ptr(), b, nprobe,
               cluster_blocks.data_ptr(), max_bpc, blocks.data_ptr(), _cuda.ptr(block_sq),
               block_orig.data_ptr(), live.data_ptr(), d, code, int(metric.ascending),
               keys.data_ptr(), _cuda.stream_of(q))
    ivf_scan_blocks.launches += 1
    return keys


ivf_scan_blocks.launches = 0


def ivf_binary_blocks(q: torch.Tensor, qcnt: torch.Tensor, top_c: torch.Tensor,
                      cluster_blocks: torch.Tensor, blocks: torch.Tensor, block_cnt: torch.Tensor,
                      block_orig: torch.Tensor, live: torch.Tensor, metric: Metric) -> torch.Tensor:
    """K16b: :func:`ivf_scan_blocks` under Hamming or Jaccard, over blocks of
    bit-packed rows: ``q`` (B, W) int32 words of the thresholded queries,
    ``qcnt`` (B,) their bit counts, ``blocks`` (n_blocks, BLOCK_SIZE, W)
    int32 words and ``block_cnt`` (n_blocks * BLOCK_SIZE,) bit counts. Keys
    as ivf_scan_blocks', equal to the bit to the plain version's."""
    if q.device.type == "cpu":
        return ivf_scan_blocks_plain(q, qcnt, top_c, cluster_blocks, blocks, block_cnt,
                                     block_orig, live, metric)
    if metric not in (Metric.HAMMING, Metric.JACCARD):
        raise ValueError(f"ivf_binary_blocks serves Hamming and Jaccard, not {metric.value}")
    _cuda.require_cuda("ivf_binary_blocks", q, qcnt, top_c, cluster_blocks, blocks, block_cnt,
                       block_orig, live)
    b, w = q.shape
    nprobe = top_c.shape[1]
    max_bpc = cluster_blocks.shape[1]
    if (q.dtype != torch.int32 or blocks.dtype != torch.int32
            or blocks.shape[1:] != (BLOCK_SIZE, w) or qcnt.shape != (b,)
            or top_c.dtype != torch.int32 or cluster_blocks.dtype != torch.int32
            or block_orig.dtype != torch.int32 or live.dtype != torch.bool):
        raise ValueError("ivf_binary_blocks: unexpected dtypes or shapes")
    keys = torch.empty((b, nprobe * max_bpc * BLOCK_SIZE), dtype=torch.float32, device=q.device)
    _cuda.call("lt_ivf_binary_blocks", q.data_ptr(), qcnt.data_ptr(), top_c.data_ptr(), b, nprobe,
               cluster_blocks.data_ptr(), max_bpc, blocks.data_ptr(), block_cnt.data_ptr(),
               block_orig.data_ptr(), live.data_ptr(), w, scan._BINARY_CODE[metric],
               keys.data_ptr(), _cuda.stream_of(q))
    ivf_binary_blocks.launches += 1
    return keys


ivf_binary_blocks.launches = 0


def _top_clusters(q: torch.Tensor, ct: dict, metric: Metric, r: int) -> torch.Tensor:
    """(B, r) int32: each row's r best centroids (the metric's distance
    kernel over the centroids' transform: K1, or K6b for the binary metrics;
    K5 selects, the lower index winning ties, as lax.top_k does)."""
    qt = D.query_transform(q, metric)
    valid = torch.ones(next(iter(ct.values())).shape[0], dtype=torch.bool, device=q.device)
    return topk_select(scan.metric_keys(qt, ct, valid, metric), r)[1]


class IVFIndex:
    """IVF (and SPANN when replica_count > 1) over device-resident blocks."""

    kind = "ivf"

    def __init__(self, coll, mode, opts, centroids: np.ndarray, postings: np.ndarray,
                 built_rows: int, replica_count: int):
        self.mode = mode
        self.metric: Metric = mode.metric
        self.device = coll.device
        self.n_clusters = centroids.shape[0]
        self.nprobe_default = opts.nprobe or DEFAULT_NPROBE
        self.replica_count = replica_count
        self.centroids_np = centroids
        self.postings = postings  # (M, 2) [cluster, row] pairs, cluster-sorted
        self.built_rows = built_rows
        self.kind = "spann" if replica_count > 1 else "ivf"
        self.last_scanned = 0
        self._dev = None  # device state (lazy)

    # ── build ────────────────────────────────────────────────────────────

    @classmethod
    def build(cls, coll, mode, opts) -> "IVFIndex":
        data = coll.store.read_all()
        n = data.shape[0]
        if n == 0:
            raise ValueError("cannot build an IVF index on an empty collection")
        n_clusters = opts.n_clusters or DEFAULT_N_CLUSTERS
        n_clusters = max(1, min(n_clusters, n))
        normalize = mode.metric is Metric.COSINE
        assign_ip = mode.metric is Metric.IP
        if mode.metric.is_binary:  # k-means over the thresholded {0, 1} rows
            data = (data > 0.5).astype(np.float32)
        if mode.family == "SPANN":
            replicas = opts.replica_count or DEFAULT_REPLICAS
        elif assign_ip:
            # the MIPS Voronoi is leaky: boundary replicas restore probe
            # coverage the same way SPANN's do
            replicas = opts.replica_count or 2
        else:
            replicas = 1
        centroids, assigns = train_kmeans(data, n_clusters, normalize=normalize,
                                          assign_ip=assign_ip, seed=42, device=coll.device)
        if replicas > 1:
            postings = cls._replica_postings(data, centroids, replicas, ip=assign_ip,
                                             device=coll.device)
        else:
            postings = np.stack([assigns.astype(np.int32), np.arange(n, dtype=np.int32)], axis=1)
        order = np.argsort(postings[:, 0], kind="stable")
        postings = postings[order]

        idx = cls(coll, mode, opts, centroids.astype(np.float32), postings, n, replicas)
        idx.save(coll)
        return idx

    @staticmethod
    def _replica_postings(data: np.ndarray, centroids: np.ndarray, replicas: int,
                          ip: bool = False, *, device) -> np.ndarray:
        """SPANN boundary replicas: each row posts to its <= R closest
        centroids (reference: spann.rs:130), by max-inner-product when
        ``ip``. K1 scores a chunk of rows against the centroids, K5 keeps
        each row's top R."""
        n = data.shape[0]
        r = min(replicas, centroids.shape[0])
        metric = Metric.IP if ip else Metric.L2
        ct = D.corpus_transform(torch.from_numpy(centroids).to(device), metric)
        tops = np.concatenate([
            _top_clusters(torch.from_numpy(data[lo : lo + TOP_R_CHUNK]).to(device), ct, metric,
                          r).cpu().numpy()
            for lo in range(0, n, TOP_R_CHUNK)
        ])
        rows = np.repeat(np.arange(n, dtype=np.int32), r)
        clusters = tops.astype(np.int32).reshape(-1)
        return np.stack([clusters, rows], axis=1)

    # ── persistence ──────────────────────────────────────────────────────

    def save(self, coll) -> None:
        idx_dir = coll.root / "index"
        idx_dir.mkdir(parents=True, exist_ok=True)
        np.savez(idx_dir / "ivf.npz", centroids=self.centroids_np, postings=self.postings)
        write_atomic(
            idx_dir / "ivf_meta.json",
            json.dumps(
                {
                    "built_rows": self.built_rows,
                    "replica_count": self.replica_count,
                    "nprobe": self.nprobe_default,
                }
            ).encode(),
        )

    @classmethod
    def load(cls, coll, mode, opts) -> Optional["IVFIndex"]:
        idx_dir = coll.root / "index"
        path = idx_dir / "ivf.npz"
        if not path.exists():
            return None
        data = np.load(path)
        meta = json.loads((idx_dir / "ivf_meta.json").read_text())
        return cls(coll, mode, opts, data["centroids"], data["postings"], meta["built_rows"],
                   meta["replica_count"])

    # ── device layout ────────────────────────────────────────────────────

    def _layout(self):
        """Host layout of the postings: (block_orig (n_blocks, BLOCK_SIZE)
        original row ids, -1 padded; cluster_blocks (n_clusters, max_bpc)
        block ids, -1 padded)."""
        clusters = self.postings[:, 0]
        rows = self.postings[:, 1]
        counts = np.bincount(clusters, minlength=self.n_clusters)
        bpc = (counts + BLOCK_SIZE - 1) // BLOCK_SIZE
        max_bpc = max(int(bpc.max(initial=1)), 1)
        n_blocks = int(bpc.sum()) or 1
        block_orig = np.full((n_blocks, BLOCK_SIZE), -1, dtype=np.int32)
        cluster_blocks = np.full((self.n_clusters, max_bpc), -1, dtype=np.int32)
        next_block = 0
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for c in range(self.n_clusters):
            rows_c = rows[offsets[c] : offsets[c + 1]]
            for b in range(int(bpc[c])):
                cluster_blocks[c, b] = next_block
                seg = rows_c[b * BLOCK_SIZE : (b + 1) * BLOCK_SIZE]
                block_orig[next_block, : len(seg)] = seg
                next_block += 1
        return block_orig, cluster_blocks

    def device_bytes(self, n_blocks: int, dim: int) -> int:
        """Device memory of the block copy (rows, or their packed words under
        a binary metric; norms or bit counts; ids) and of one search's
        scratch (the key matrix within SCORE_BUDGET and K5's two buffers
        beside it)."""
        row = D.words_for(dim) * 4 if self.metric.is_binary else dim * 4
        return n_blocks * BLOCK_SIZE * (row + 8) + scan.SCORE_BUDGET * (4 + 2 * 8)

    def _check_fits(self, n_blocks: int, dim: int) -> None:
        if self.device.type != "cuda":
            return
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        need = self.device_bytes(n_blocks, dim)
        if need > free:
            raise RuntimeError(
                f"the IVF block copy ({n_blocks} blocks of {BLOCK_SIZE} x {dim} rows) and its "
                f"search scratch need {need} bytes on {self.device} but {free} are free")

    def _device_state(self, coll):
        """The index's device arrays. The blocks are gathered from the
        corpus's f32 device copy (or its staged transform), so on a streaming
        corpus this raises the corpus's ValueError, as the JAX package's IVF
        does through ``corpus._data``."""
        if self._dev is not None:
            return self._dev
        corpus = coll.corpus()  # ensures device rows are current
        block_orig, cluster_blocks = self._layout()
        self._check_fits(block_orig.shape[0], corpus.dim)
        flat = torch.from_numpy(block_orig.reshape(-1)).to(self.device)
        pad = (flat >= 0)[:, None]
        centroids = torch.from_numpy(self.centroids_np).to(self.device)
        dev = {"block_orig": flat,
               "cluster_blocks": torch.from_numpy(cluster_blocks).to(self.device),
               "centroids": D.corpus_transform(centroids, self.metric)}
        if self.metric.is_binary:
            # the rows' packed words and bit counts in block order, from the
            # corpus's staged transform; padding rows are zero
            ct = corpus.transform(self.metric)
            dev["blocks"] = (ct["bits"][flat.clamp_min(0).long()] * pad).view(
                -1, BLOCK_SIZE, ct["bits"].shape[1])
            dev["block_sq"] = ct["cnt"][flat.clamp_min(0).long()] * pad[:, 0]
        else:
            # gather the rows on the device in block order; padding rows are zero
            blocks = corpus._data[flat.clamp_min(0).long()]
            blocks.mul_(pad)
            dev["blocks"] = blocks.view(-1, BLOCK_SIZE, corpus.dim)
            # the rows' corpus_transform terms, once, as D.pairwise reads them
            dev["block_sq"] = None if self.metric is Metric.IP else torch.cat([
                D.corpus_transform(blocks[lo : lo + scan.STAGE_ROWS], self.metric)["sq"]
                for lo in range(0, blocks.shape[0], scan.STAGE_ROWS)
            ])
        self._dev = dev
        return dev

    # ── search ───────────────────────────────────────────────────────────

    def _probe(self, qd: torch.Tensor, dev: dict, live: torch.Tensor, fetch: int, nprobe: int):
        """Probe one part of a batch: (dists (B, fetch'), ids (B, fetch'))
        on the host, -inf/+inf and any id where nothing live was found."""
        metric = self.metric
        top_c = _top_clusters(qd, dev["centroids"], metric, nprobe)
        scan_args = (top_c, dev["cluster_blocks"], dev["blocks"], dev["block_sq"],
                     dev["block_orig"], live, metric)
        if metric.is_binary:  # the queries thresholded at 0.5 and bit-packed
            qt = D.query_transform(qd, metric)
            keys = ivf_binary_blocks(qt["bits"], qt["cnt"], *scan_args)
        else:
            qsq = None if metric is Metric.IP else (qd * qd).sum(-1)
            keys = ivf_scan_blocks(qd, qsq, *scan_args)
        top, col = topk_select(keys, min(fetch, keys.shape[1]))
        del keys
        # each column -> its slot's block -> the row's original id
        slot_blk = dev["cluster_blocks"][top_c.long()].reshape(qd.shape[0], -1)
        blk = slot_blk.gather(1, (col // BLOCK_SIZE).long())
        at = blk.clamp_min(0).long() * BLOCK_SIZE + (col % BLOCK_SIZE).long()
        ids = torch.where(blk >= 0, dev["block_orig"][at], -1)
        return unorient(top, metric.ascending).cpu().numpy(), ids.long().cpu().numpy()

    def search(self, coll, q: np.ndarray, k: int, mask, nprobe: int):
        """Top-k of each query row over the probed clusters and the tail.
        ``mask`` is a row filter (a bool array or a FilterHandle) or None."""
        metric = self.metric
        nprobe = int(nprobe or self.nprobe_default)
        dev = self._device_state(coll)
        corpus = coll.corpus()
        handle = _handle(mask)
        live = corpus.valid_mask(handle)
        fetch = k * 2 if self.replica_count > 1 else k
        q = np.ascontiguousarray(np.atleast_2d(q), dtype=np.float32)
        qd = torch.from_numpy(q).to(self.device)
        nprobe = min(nprobe, self.n_clusters)
        max_bpc = dev["cluster_blocks"].shape[1]
        # rows in the probed clusters: probed slots scaled by the global
        # fill factor (real rows / total slots), as the JAX package reports
        total_slots = max(dev["block_orig"].shape[0], 1)
        fill = min(self.built_rows / total_slots, 1.0)
        self.last_scanned = min(int(round(nprobe * max_bpc * BLOCK_SIZE * fill)), self.built_rows)
        # keep the (B, slots) key matrix within SCORE_BUDGET (and B within
        # the scan's grid) by splitting oversized batches
        max_b = min(65535, max(1, scan.SCORE_BUDGET // (nprobe * max_bpc * BLOCK_SIZE)))
        parts = [self._probe(qd[s : s + max_b], dev, live, fetch, nprobe)
                 for s in range(0, len(q), max_b)]
        dists = np.concatenate([p[0] for p in parts])
        ids = np.concatenate([p[1] for p in parts])

        # exact-scanned tail for rows added after build
        if self.built_rows < coll.n_rows:
            tail_mask = np.zeros(coll.n_rows, dtype=bool)
            tail_mask[self.built_rows :] = True
            if handle is not None:
                tail_mask &= handle.mask[: coll.n_rows]
            td, ti = corpus.search(q, k, metric, filter_mask=tail_mask)
            width = td.shape[1]
            if width:
                fill_d = np.inf if metric.ascending else -np.inf
                pad = np.full((dists.shape[0], width), fill_d, np.float32)
                pad_ids = np.full((dists.shape[0], width), -1, np.int64)
                pad[:, : td.shape[1]] = td
                pad_ids[:, : ti.shape[1]] = ti
                dists = np.concatenate([dists, pad], axis=1)
                ids = np.concatenate([ids, pad_ids], axis=1)

        return self._finalize(dists, ids, k, metric)

    def _finalize(self, dists: np.ndarray, ids: np.ndarray, k: int, metric: Metric):
        """Order, dedup (SPANN replicas), trim invalid, truncate to k."""
        b = dists.shape[0]
        keyed = -dists if metric.ascending else dists
        out_d = []
        out_i = []
        for r in range(b):
            order = np.argsort(-keyed[r], kind="stable")
            seen = set()
            dd, ii = [], []
            for j in order:
                rid = int(ids[r, j])
                if rid < 0 or not np.isfinite(keyed[r, j]):
                    continue
                if rid in seen:
                    continue
                seen.add(rid)
                dd.append(dists[r, j])
                ii.append(rid)
                if len(ii) >= k:
                    break
            out_d.append(dd)
            out_i.append(ii)
        width = max((len(x) for x in out_i), default=0)
        d_arr = np.zeros((b, width), dtype=np.float32)
        i_arr = np.full((b, width), -1, dtype=np.int64)
        for r in range(b):
            d_arr[r, : len(out_d[r])] = out_d[r]
            i_arr[r, : len(out_i[r])] = out_i[r]
        return d_arr, i_arr

    # ── lifecycle ────────────────────────────────────────────────────────

    def on_commit(self, coll) -> None:
        """Incremental insert: rows added since the last commit are posted
        to their nearest existing centroid(s); the block layout regenerates
        lazily. k-means retrains once accumulated growth passes half the
        trained corpus."""
        n = coll.n_rows
        if n <= self.built_rows:
            return
        base = getattr(self, "_rows_at_train", self.built_rows)
        grown = getattr(self, "_inserted_since_train", 0) + (n - self.built_rows)
        if grown > 0.5 * max(base, 1):
            self.rebuild(coll)
            return
        corpus = coll.corpus()
        new_rows = corpus.host_rows(np.arange(self.built_rows, n))
        if self.metric.is_binary:  # posted by L2 to the float centroids
            new_rows = (new_rows > 0.5).astype(np.float32)
        elif self.metric is Metric.COSINE:
            norms = np.linalg.norm(new_rows, axis=1, keepdims=True)
            new_rows = new_rows / np.maximum(norms, 1e-30)
        r = self.replica_count if self.replica_count > 1 else 1
        fresh = self._replica_postings(new_rows, self.centroids_np, r,
                                       ip=self.metric is Metric.IP, device=self.device)
        fresh[:, 1] += self.built_rows  # local row index -> global row id
        merged = np.concatenate([self.postings, fresh.astype(self.postings.dtype)])
        order = np.argsort(merged[:, 0], kind="stable")
        self.postings = merged[order]
        self.built_rows = n
        self._inserted_since_train = grown
        self._dev = None  # blocked layout regenerates on next search
        self.save(coll)

    def rebuild(self, coll) -> None:
        from . import IndexBuildOptions

        opts = IndexBuildOptions(
            n_clusters=self.n_clusters,
            nprobe=self.nprobe_default,
            replica_count=self.replica_count if self.replica_count > 1 else None,
        )
        self._dev = None  # free the old block copy before the new build
        fresh = IVFIndex.build(coll, self.mode, opts)
        self.__dict__.update(fresh.__dict__)
        self._inserted_since_train = 0
        self._rows_at_train = self.built_rows

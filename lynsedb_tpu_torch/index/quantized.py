"""Aux quantized shortlist indexes for FLAT modes: SQ8 / PQ / RaBitQ / PolarVec.

Port of lynsedb_tpu/index/quantized.py (reference: engine.rs:5504 aux
quantized path, pq_mmap.rs / rabitq_mmap.rs / polarvec_mmap.rs). A search is
one chain of kernels on the card:

  1. RaBitQ / PolarVec: K14 ``fwht_rotate`` rotates the queries;
  2. the code scan over every encoded row: K12 ``int8_code_scores`` (SQ8,
     RaBitQ, PolarVec) or K13 ``pq_adc_scores`` (PQ) writes approximate keys;
  3. K5 takes the top S, K11 ``bf16_gather_scores`` rescores them from the
     centred bf16 corpus copy, K5 takes the top C
     (``scan.shortlist_device_rescore_ids``);
  4. K3 ``rescore_topk`` rescores the C rows exactly in f32 from the corpus
     copy and keeps the best k by (score, id), dropping non-finite scores.

Off the corpus's resident tier step 4 runs on the host mirror instead (the
JAX package's host-rescore ending). A streaming corpus (no bf16 copy on the
card to rescore from) and rows added after the last encode (an uncommitted
tail) are served by :meth:`AuxQuantIndex._search_host`: the code scan's top S
rescored on the host mirror, an exact scan of the tail and a merge that
removes duplicates.

The files are the JAX package's (``index/aux.npz``, ``index/aux_meta.json``):
SQ8, RaBitQ and PolarVec encode to the same bytes in both packages, and each
package opens the other's index. Not ported: the JAX package's
batch-bucket padding (the port has no compiled shapes to share, ROADMAP A.1).

The chain runs once a view of the corpus (``DeviceCorpus.views``): the
whole corpus, or each shard of a mesh corpus (ops/scan.py's mesh mode,
parallel/mesh.py). A shard's per-row arrays (codes, bits, row_sq, alpha;
PolarVec's per-row lo and scale) are the slice of its rows, on its device,
and the per-dimension ones (SQ8's lo and scale, signs, codebooks) a copy
(:meth:`AuxQuantIndex._device`). Each shard runs steps 1-4 on its rows, the
ids made global, and K21a's merge (``topk.merge_shards``, K5) keeps the
best k: each shard's K3 rescores its own top C, a superset of the merged
list's rows.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..metrics import Metric
from ..ops import quantize as Q
from ..ops import scan
from ..ops.scan import (_concat_parts, _fetch, _handle, _trim_results, rescore_topk,
                        shortlist_device_rescore_ids)
from ..ops.topk import merge_shards, topk_select
from ..storage.vector_store import write_atomic

OVERSAMPLE = {"sq8": 4, "pq": 8, "rabitq": 16, "polarvec": 8}
# from this many codes on, a batch is searched in slices of QUERY_SLICE
# queries: the (B, N) code keys and K5's buffers stay a few hundred MB
SLICE_MIN_CODES = 262_144
QUERY_SLICE = 64
SHORTLIST_MAX = 16384
# the per-row arrays of each kind's state (a mesh corpus splits them by shard)
_ROW_KEYS = {"sq8": ("codes", "row_sq"), "pq": ("codes", "row_sq"),
             "rabitq": ("bits", "alpha", "row_sq"), "polarvec": ("codes", "lo", "scale", "row_sq")}


class AuxQuantIndex:
    def __init__(self, coll, mode, opts, kind: str, state: dict, encoded_rows: int):
        self.mode = mode
        self.metric: Metric = mode.metric
        self.kind = kind
        self.device = coll.device
        self.state = state  # numpy arrays (host copies)
        self.encoded_rows = encoded_rows
        self.last_scanned = 0
        self._dev: Optional[dict] = None  # the staged arrays, by (row range, device)

    # ── build / encode ───────────────────────────────────────────────────

    @classmethod
    def build(cls, coll, mode, opts) -> "AuxQuantIndex":
        import time

        phases = {}
        t0 = time.perf_counter()
        data = coll.store.read_all()
        phases["read_s"] = round(time.perf_counter() - t0, 2)
        if data.shape[0] == 0:
            raise ValueError("cannot build a quantized index on an empty collection")
        kind = mode.quantizer
        t0 = time.perf_counter()
        state = cls._fit_encode(kind, data, mode, coll.device)
        phases["encode_s"] = round(time.perf_counter() - t0, 2)
        idx = cls(coll, mode, opts, kind, state, data.shape[0])
        t0 = time.perf_counter()
        idx.save(coll)
        phases["save_s"] = round(time.perf_counter() - t0, 2)
        idx.last_build_phases = phases  # build-cost attribution for gates
        return idx

    @staticmethod
    def _fit_encode(kind: str, data: np.ndarray, mode, device) -> dict:
        if kind == "sq8":
            sq = Q.SQ8.fit(data)
            codes = sq.encode(data)
            return {"codes": codes, "lo": sq.lo, "scale": sq.scale,
                    "row_sq": sq.row_sq_from_codes(codes)}
        if kind == "rabitq":
            rq = Q.RaBitQ.fit(data.shape[1])
            enc = rq.encode(data)
            return {"signs": rq.signs, "dim_pad": np.int64(rq.dim_pad), **enc}
        if kind == "polarvec":
            bits = mode.polarvec_bits or 4
            pv = Q.PolarVec.fit(data.shape[1], bits=bits)
            enc = pv.encode(data)
            return {"signs": pv.signs, "dim_pad": np.int64(pv.dim_pad),
                    "bits": np.int64(bits), **enc}
        if kind == "pq":
            pq = Q.PQ.fit(data, mode.pq_subspaces, device=device)
            codes = pq.encode(data, device=device)
            return {"codes": codes, "codebooks": pq.codebooks,
                    "row_sq": pq.row_sq_from_codes(codes)}
        raise ValueError(f"unknown quantizer kind: {kind}")

    def _encode_tail(self, data: np.ndarray) -> dict:
        """Encode new rows with the existing trained parameters."""
        s = self.state
        if self.kind == "sq8":
            sq = Q.SQ8(s["lo"], s["lo"] + s["scale"] * 255.0)
            codes = sq.encode(data)
            return {"codes": codes, "row_sq": sq.row_sq_from_codes(codes)}
        if self.kind == "rabitq":
            rq = Q.RaBitQ(s["signs"], data.shape[1], int(s["dim_pad"]))
            return rq.encode(data)
        if self.kind == "polarvec":
            pv = Q.PolarVec(s["signs"], data.shape[1], int(s["dim_pad"]), int(s["bits"]))
            return pv.encode(data)
        if self.kind == "pq":
            pq = Q.PQ(s["codebooks"])
            codes = pq.encode(data, device=self.device)
            return {"codes": codes, "row_sq": pq.row_sq_from_codes(codes)}
        raise ValueError(self.kind)

    # ── persistence ──────────────────────────────────────────────────────

    def save(self, coll) -> None:
        idx_dir = coll.root / "index"
        idx_dir.mkdir(parents=True, exist_ok=True)
        np.savez(idx_dir / "aux.npz", **{k: np.asarray(v) for k, v in self.state.items()})
        write_atomic(
            idx_dir / "aux_meta.json",
            json.dumps({"kind": self.kind, "encoded_rows": int(self.encoded_rows)}).encode(),
        )

    @classmethod
    def load(cls, coll, mode, opts) -> Optional["AuxQuantIndex"]:
        idx_dir = coll.root / "index"
        path = idx_dir / "aux.npz"
        if not path.exists():
            return None
        data = np.load(path)
        meta = json.loads((idx_dir / "aux_meta.json").read_text())
        state = {k: data[k] for k in data.files}
        return cls(coll, mode, opts, meta["kind"], state, meta["encoded_rows"])

    # ── device state ─────────────────────────────────────────────────────

    def _staged_arrays(self) -> dict:
        """The host arrays the card holds: every array of the state, the
        int8 codes padded to a multiple of 16 columns."""
        out = {}
        for key, val in self.state.items():
            if not (isinstance(val, np.ndarray) and val.ndim >= 1):
                continue  # scalars: dim_pad, PolarVec's bit count
            if val.dtype == np.int8:  # SQ8 / PolarVec codes, RaBitQ bits
                val = Q.pad_codes(val)
            out[key] = val
        return out

    def device_bytes(self, arrays: dict, rows: Optional[int] = None) -> int:
        """Device memory of the staged arrays and of one search's scratch at
        its largest batch: the (B, N) code keys, K5's two buffers for the
        top S (at most N (key, index) pairs a row each) and the shortlist's
        keys and ids (at most N a row). ``rows``: the encoded rows the
        arrays hold (a mesh shard's); the batch is sliced by the whole
        index's row count."""
        b = self._max_batch(max(self.encoded_rows, 1))
        rows = max(self.encoded_rows if rows is None else rows, 1)
        staged = sum(int(a.nbytes) for a in arrays.values())
        return staged + b * rows * (4 + 2 * 8) + b * min(SHORTLIST_MAX, rows) * (4 + 4 + 8)

    def _check_fits(self, arrays: dict, device: Optional[torch.device] = None,
                    rows: Optional[int] = None) -> None:
        """Raise before staging an index (or a mesh shard's part of it, of
        ``rows`` encoded rows) whose arrays and search scratch do not fit the
        card's free memory."""
        device = self.device if device is None else device
        if device.type != "cuda":
            return
        free, _ = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        need = self.device_bytes(arrays, rows)
        if need > free:
            raise RuntimeError(
                f"the {self.kind} index of {self.encoded_rows if rows is None else rows} rows "
                f"needs {need} bytes on {device} (codes plus search scratch) but {free} are "
                f"free")

    def _device(self, lo: int = 0, hi: Optional[int] = None,
                device: Optional[torch.device] = None) -> dict:
        """The staged arrays of the encoded rows [lo, hi) on ``device`` (the
        whole index on the index's device by default): the per-row arrays'
        slice, the others whole, cached by range and device."""
        hi = self.encoded_rows if hi is None else hi
        device = self.device if device is None else device
        key = (lo, hi, device)
        if self._dev is None:
            self._dev = {}
        if key not in self._dev:
            arrays = self._staged_arrays()
            if (lo, hi) != (0, self.encoded_rows):
                arrays = {k: np.ascontiguousarray(v[lo:hi]) if k in _ROW_KEYS[self.kind] else v
                          for k, v in arrays.items()}
            self._check_fits(arrays, device, hi - lo)
            self._dev[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                              for k, v in arrays.items()}
        return self._dev[key]

    # ── search ───────────────────────────────────────────────────────────

    def _code_keys(self, qd: torch.Tensor, valid: torch.Tensor,
                   dev: Optional[dict] = None) -> torch.Tensor:
        """Oriented, masked approximate keys (B, rows) of the queries over
        the rows of ``dev`` (the whole index by default): K14 + K12, or K13
        for PQ."""
        dev = self._device() if dev is None else dev
        if self.kind == "pq":
            return Q.pq_adc_scores(qd, dev["codes"], dev["codebooks"], dev["row_sq"], valid,
                                   self.metric)
        q_rot = None
        if self.kind in ("rabitq", "polarvec"):
            q_rot = Q.fwht_rotate(qd, dev["signs"], int(self.state["dim_pad"]))
        return Q.int8_code_scores(self.kind, qd, q_rot, dev, valid, self.metric)

    def _shortlist_width(self, k: int, n_codes: int) -> int:
        # scale-aware shortlist: a fixed k-multiple collapses at large N; the
        # floor terms keep ~0.4% of the corpus in play, capped so the exact
        # rescore stays cheap
        return min(
            max(k * OVERSAMPLE[self.kind], 1024, n_codes // 250),
            n_codes, SHORTLIST_MAX,
        )

    @staticmethod
    def _max_batch(n_codes: int) -> int:
        """Queries one search pass takes: QUERY_SLICE from SLICE_MIN_CODES
        codes on, else as many as keep the (B, N) keys within the score
        budget."""
        if n_codes >= SLICE_MIN_CODES:
            return QUERY_SLICE
        return max(QUERY_SLICE, scan.SCORE_BUDGET // max(n_codes, 1))

    def search(self, coll, q: np.ndarray, k: int, nprobe: int = 0, mask=None):
        q = np.ascontiguousarray(np.atleast_2d(np.asarray(q, dtype=np.float32)))
        n_codes = self.encoded_rows
        max_b = self._max_batch(n_codes)
        if q.shape[0] > max_b:
            return _concat_parts([self.search(coll, q[s : s + max_b], k, nprobe, mask)
                                  for s in range(0, q.shape[0], max_b)])
        corpus = coll.corpus()
        if corpus.would_stream() or not (n_codes >= coll.n_rows and n_codes > 0):
            return self._search_host(coll, q, k, mask)
        handle = _handle(mask)
        s = self._shortlist_width(k, n_codes)
        c = min(s, max(64, 4 * k))
        self.last_scanned = n_codes
        parts = []
        for v in corpus.views():
            hi = min(v.lo + v.rows, n_codes)
            if hi <= v.lo:
                continue
            s_v, c_v = min(s, hi - v.lo), min(c, hi - v.lo)
            self.last_scanned += s_v
            qd = torch.from_numpy(q).to(v.device)
            keys = self._code_keys(qd, corpus.view_valid(v, handle),
                                   self._device(v.lo, hi, v.device))
            cand_keys, cand_ids = shortlist_device_rescore_ids(
                qd, keys, corpus.view_x16(v), corpus.view_aux(v), self.metric, s_v, c_v)
            del keys
            if corpus.tier != scan.RESIDENT:  # one device's host-rescore tier: one view
                return corpus._rescore_fetched(q, cand_keys, cand_ids, self.metric, k)
            dists, ids = rescore_topk(qd, corpus.view_x32(v), cand_keys, cand_ids,
                                      min(k, c_v), self.metric)
            parts.append((dists, v.to_global(ids)))
        if len(parts) == 1:
            dists, ids = parts[0]
        else:
            dists, ids = merge_shards(parts, k, self.metric.ascending, corpus.device)
        return _trim_results(*_fetch(dists, ids))

    def _search_host(self, coll, q: np.ndarray, k: int, mask=None):
        """The two-fetch route of streaming corpora and of collections with
        an unencoded tail: the code scan's top S rescored on the host mirror,
        an exact scan of the tail, and a merge."""
        metric = self.metric
        corpus = coll.corpus()
        n_codes = self.encoded_rows
        handle = _handle(mask)
        live = corpus.valid_mask(handle)
        shortlist = self._shortlist_width(k, n_codes)
        self.last_scanned = n_codes + shortlist
        top, cand = topk_select(self._code_keys(torch.from_numpy(q).to(self.device), live),
                                shortlist)
        # a slot past the live rows holds no candidate (the JAX package's
        # host route rescores it anyway)
        cand_np = torch.where(top > float("-inf"), cand.long(), -1).cpu().numpy()

        # exact re-rank of shortlisted candidates from the f32 host mirror
        exact = corpus.rescore(q, cand_np, metric)  # (B, shortlist), NaN where empty

        # exact-scanned tail for rows added after the last encode
        if n_codes < coll.n_rows:
            tail_mask = np.zeros(coll.n_rows, dtype=bool)
            tail_mask[n_codes:] = True
            if handle is not None:
                tail_mask &= handle.mask[: coll.n_rows]
            extra_d, extra_i = corpus.search(q, k, metric, filter_mask=tail_mask)
            if extra_i.shape[1]:
                exact = np.concatenate(
                    [exact, np.where(extra_i >= 0, extra_d, np.nan)], axis=1)
                cand_np = np.concatenate([cand_np, extra_i], axis=1)
        return _merge(exact, cand_np, k, metric)

    # ── lifecycle ────────────────────────────────────────────────────────

    def on_commit(self, coll) -> None:
        n = coll.store.row_count
        if n > self.encoded_rows:
            tail = coll.store.read_rows(self.encoded_rows, n - self.encoded_rows)
            enc = self._encode_tail(tail)
            for key, val in enc.items():
                cur = self.state.get(key)
                if isinstance(cur, np.ndarray) and cur.ndim >= 1 and cur.shape[0] == self.encoded_rows:
                    self.state[key] = np.concatenate([cur, val], axis=0)
            self.encoded_rows = n
            self._dev = None
            self.save(coll)

    def rebuild(self, coll) -> None:
        self._dev = None  # free the old device copies before the new encode
        data = coll.store.read_all()
        self.state = self._fit_encode(self.kind, data, self.mode, self.device)
        self.encoded_rows = data.shape[0]
        self.save(coll)


def _merge(exact: np.ndarray, cand: np.ndarray, k: int, metric: Metric):
    """Best k of each row of (B, W) exact distances and candidate ids (NaN
    or a negative id = empty): best first with the lower id between equal
    distances, a repeated id kept once. Returns (dists, ids) trimmed to the
    widest row, 0.0 / -1 padded."""
    keyed = np.where(np.isnan(exact), -np.inf, -exact if metric.ascending else exact)
    keyed = np.where(cand >= 0, keyed, -np.inf)
    safe = np.where(cand >= 0, cand, np.iinfo(np.int64).max)
    order = np.lexsort((safe, -keyed), axis=1)
    d_s = np.take_along_axis(exact, order, axis=1)
    i_s = np.take_along_axis(cand, order, axis=1)
    keep = np.take_along_axis(keyed, order, axis=1) > -np.inf
    # sorted by (key, id): a repeated id with an equal score is adjacent;
    # one seen earlier in its row with another score is found by the set
    for b in np.nonzero((np.diff(np.sort(np.where(keep, i_s, -1), axis=1), axis=1) == 0)
                        .any(axis=1))[0]:
        seen: set = set()
        for j in np.nonzero(keep[b])[0]:
            rid = int(i_s[b, j])
            if rid in seen:
                keep[b, j] = False
            seen.add(rid)
    d_arr, i_arr = _trim_results(d_s, i_s, keep)
    return d_arr[:, :k], i_arr[:, :k]


def build_aux_index(coll, mode, opts) -> AuxQuantIndex:
    return AuxQuantIndex.build(coll, mode, opts)


def load_aux_index(coll, mode, opts) -> Optional[AuxQuantIndex]:
    return AuxQuantIndex.load(coll, mode, opts)

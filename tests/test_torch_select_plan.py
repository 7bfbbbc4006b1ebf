"""A model of K5's radix select (csrc/topk_select.cu, 1,024 < k <= 16,384)
in numpy, held to the plain version and to the JAX package on the CPU.

The model runs the kernel's plan step for step: each entry's 64-bit value
(the key's order-preserving code, NaN as -inf and -0.0 as +0.0, over
INT_MAX - id), the blocks a row is cut into, the digit passes (12, 12 and 8
bits of the code, then of the id in ids mode) with each block's counts, the
row's bucket walk to the k-th entry, the end of the select (the survivors
fit 2 kp, or every bit is resolved), the blocks' offsets, the stable
compaction in column order and the sort of the survivors (ranked through
4,096 ranges of their values: the ranges above, then the survivors of their
own range one by one). A row of N <= 16,384 is sorted the same way, whole.

Tolerance: none. The model's keys and indices equal ``topk_select_plain``'s
bit for bit (the sign of a zero included) and the JAX package's
``masked_top_k`` / ``merge_top_k`` value for value and index for index on
data without negative zeros (the JAX selection orders -0.0 below +0.0; the
port treats the two as one key, ROADMAP C). Ids mode has no JAX
counterpart: it is held to the plain version.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynsedb_tpu.ops import topk as jax_topk
from lynsedb_tpu_torch.ops import topk

INT_MAX = 2**31 - 1
DIGITS = [(52, 12), (40, 12), (32, 8), (20, 12), (8, 12), (0, 8)]  # (shift, bits)
MIN_SPAN, SMS = 8192, 132


def list_kp(k: int) -> int:
    p = 8
    while p < k:
        p <<= 1
    return p


def plan(rows: int, n: int, k: int) -> dict:
    """radix_plan: blocks a row (about two waves of four blocks an SM, each
    at least MIN_SPAN keys), their span, the survivors' cap and the ints a
    row of scratch needs for each part."""
    want = -(-2 * 4 * SMS // rows)
    blocks = max(1, min(want, n // MIN_SPAN))
    span = (-(-n // blocks) + 3) // 4 * 4
    blocks = -(-n // span)
    fit_cap = min(topk.RADIX_CAP, 2 * list_kp(k))
    return {"blocks": blocks, "span": span, "fit_cap": fit_cap,
            "ctrl": 4096 + 32 + 2 * blocks, "record": blocks * (4096 + 4), "survivors": fit_cap}


def values(keys: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The 64-bit value of each (key, id): larger is better (a bigger key, or
    at an equal key a lower id)."""
    k = np.where(np.isnan(keys), np.float32(-np.inf), keys).astype(np.float32) + np.float32(0.0)
    u = k.view(np.uint32).astype(np.uint64)
    code = np.where(u >> 31, u ^ np.uint64(0xFFFFFFFF), u ^ np.uint64(0x80000000))
    low = (INT_MAX - ids.astype(np.int64)).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    return (code << np.uint64(32)) | low


def select_row(keys: np.ndarray, ids: np.ndarray | None, k: int, p: dict, trace: dict):
    """One row through the passes and the compaction: the survivors' keys
    and ids in slot order. ``trace`` records how the select ended."""
    n = keys.shape[0]
    ids_v = np.arange(n, dtype=np.int64) if ids is None else ids
    v = values(keys, ids_v)
    raw = np.where(np.isnan(keys), np.float32(-np.inf), keys).astype(np.float32)
    spans = [(j * p["span"], min(n, (j + 1) * p["span"])) for j in range(p["blocks"])]
    pre = msk = np.uint64(0)
    above = 0
    last = len(DIGITS) - 1 if ids is not None else 2
    for pas in range(last + 1):
        shift, bits = DIGITS[pas]
        bins = 1 << bits
        m = v & msk
        digit = ((v >> np.uint64(shift)) & np.uint64(bins - 1)).astype(np.int64)
        hists, aboves = [], []
        for lo, hi in spans:  # each block's counts
            cand = m[lo:hi] == pre
            hists.append(np.bincount(digit[lo:hi][cand], minlength=bins))
            aboves.append(int((m[lo:hi] > pre).sum()))
        g = np.sum(hists, axis=0)
        suffix = np.concatenate([np.cumsum(g[::-1])[::-1], [0]])
        need = k - above
        hits = np.nonzero((suffix[:-1] >= need) & (suffix[1:] < need))[0]
        assert len(hits) == 1  # the k-th entry lies in exactly one bucket
        b = int(hits[0])
        new_above = above + int(suffix[b + 1])
        in_bucket = int(g[b])
        pre2 = pre | (np.uint64(b) << np.uint64(shift))
        msk2 = msk | (np.uint64(bins - 1) << np.uint64(shift))
        fits = new_above + in_bucket <= p["fit_cap"]
        if not fits and pas < last:
            pre, msk, above = pre2, msk2, new_above
            continue
        trace.update(passes=pas + 1, end="fits" if fits else "exact")
        pre, msk = pre2, msk2
        break
    # each block's survivors above the tie class (A) and in it (E), their
    # offsets in block order, then the stable compaction in column order
    m = v & msk
    cls_a = (m > pre) | ((m == pre) if fits else False)
    cls_e = np.zeros(n, bool) if fits else (m == pre)
    a_j = [int(cls_a[lo:hi].sum()) for lo, hi in spans]
    e_j = [int(cls_e[lo:hi].sum()) for lo, hi in spans]
    total_a = sum(a_j)
    assert total_a == (new_above + in_bucket if fits else new_above)
    take = k - new_above  # the tie class's first entries in column order
    count = total_a if fits else k
    assert k <= count <= p["fit_cap"]
    s_keys = np.empty(count, np.float32)
    s_ids = np.empty(count, np.int64)
    off_a = np.concatenate([[0], np.cumsum(a_j)])
    off_e = np.concatenate([[0], np.cumsum(e_j)])
    for j, (lo, hi) in enumerate(spans):
        at_a, at_e = off_a[j], off_e[j]
        for c in range(lo, hi):
            if cls_a[c]:
                s_keys[at_a], s_ids[at_a] = raw[c], ids_v[c]
                at_a += 1
            elif cls_e[c]:
                if at_e < take:
                    s_keys[total_a + at_e], s_ids[total_a + at_e] = raw[c], ids_v[c]
                at_e += 1
    return s_keys, s_ids


SORT_BUCKET_BITS = 12  # the sort's value ranges: 4,096


def sort_survivors(s_keys: np.ndarray, s_ids: np.ndarray, k: int):
    """The survivors' sort as the kernel runs it: the span of their values
    cut into 4,096 ranges ((v - min) >> shift), each survivor ranked as the
    survivors of the ranges above its own plus those of its own range before
    it (a larger value, or an equal one at a lower slot), compared one by
    one; ranks below k are written."""
    v = values(s_keys, s_ids)
    count = len(v)
    lo, span = v.min(), int(v.max() - v.min())
    shift = max(0, span.bit_length() - SORT_BUCKET_BITS)
    rng = ((v - lo) >> np.uint64(shift)).astype(np.int64)
    assert rng.max() < 1 << SORT_BUCKET_BITS
    hist = np.bincount(rng, minlength=1 << SORT_BUCKET_BITS)
    above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])  # survivors past each range
    out_k = np.full(k, np.nan, np.float32)
    out_i = np.full(k, -2, np.int64)
    ranks = np.empty(count, np.int64)
    for b in np.unique(rng):
        members = np.nonzero(rng == b)[0]  # slots, ascending
        mv = v[members]
        for x, slot in enumerate(members):
            ranks[slot] = above[b] + int((mv > mv[x]).sum() + (mv[:x] == mv[x]).sum())
    np.testing.assert_array_equal(np.sort(ranks), np.arange(count))  # every rank once
    hit = ranks < k
    out_k[ranks[hit]], out_i[ranks[hit]] = s_keys[hit], s_ids[hit]
    return out_k, out_i.astype(np.int32)


def model_select(keys: np.ndarray, k: int, ids: np.ndarray | None = None, traces=None):
    """K5 for 1,024 < k <= RADIX_CAP as the kernels run it: (B, k) keys and
    (B, k) int32 indices (or ids)."""
    b, n = keys.shape
    assert topk.SELECT_MAX < k <= topk.RADIX_CAP and k <= n
    out_k = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    p = plan(b, n, k) if n > topk.RADIX_CAP else None
    if p is not None:  # the scratch a row stays within its cap of N pairs
        assert max(p["ctrl"], p["record"], p["survivors"]) <= n
    for r in range(b):
        row_ids = None if ids is None else ids[r]
        trace = {"passes": 0, "end": "whole row"}
        if p is None:  # the row is the survivors
            raw = np.where(np.isnan(keys[r]), np.float32(-np.inf), keys[r]).astype(np.float32)
            s_ids = np.arange(n) if row_ids is None else row_ids.astype(np.int64)
            s_keys = raw
        else:
            s_keys, s_ids = select_row(keys[r], row_ids, k, p, trace)
        out_k[r], out_i[r] = sort_survivors(s_keys, s_ids, k)
        if traces is not None:
            traces.append(trace)
    return out_k, out_i


def tie_keys(rng, b: int, n: int, *, zeros: bool = True) -> np.ndarray:
    keys = np.round(rng.normal(size=(b, n)), 1).astype(np.float32)  # many exact ties
    if zeros:
        keys[rng.random((b, n)) < 0.03] = -0.0
    else:
        keys += np.float32(0.0)
    keys[rng.random((b, n)) < 0.05] = -np.inf
    keys[rng.random((b, n)) < 0.01] = np.nan
    return keys


def held_to_plain(keys: np.ndarray, k: int, ids: np.ndarray | None = None, traces=None):
    got_k, got_i = model_select(keys, k, ids, traces)
    want_k, want_i = topk.topk_select_plain(torch.from_numpy(keys), k,
                                            None if ids is None else torch.from_numpy(ids))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_k.view(np.int32), want_k.numpy().view(np.int32))
    return got_k, got_i


@pytest.mark.parametrize("b,n,k", [(2, 20_000, 1025), (3, 40_000, 4000), (1, 70_001, 16_384),
                                   (2, 16_384, 16_384), (3, 9000, 1025), (2, 5000, 5000),
                                   (1, 250_000, 4000)])
def test_select_model_matches_plain_and_jax(b, n, k):
    """Ties, NaN, -inf and (against the plain version) -0.0 beside +0.0; k
    from 1,025 to N and to 16,384, through the passes and the whole-row
    sort. Against the JAX package's masked_top_k on the same keys without
    negative zeros."""
    rng = np.random.default_rng(n + k)
    held_to_plain(tie_keys(rng, b, n), k)
    keys = tie_keys(rng, b, n, zeros=False)
    got_k, got_i = held_to_plain(keys, k)
    jd, ji = jax_topk.masked_top_k(jnp.asarray(keys), k, False)
    np.testing.assert_array_equal(got_k, np.asarray(jd))
    np.testing.assert_array_equal(got_i, np.asarray(ji))


@pytest.mark.parametrize("ascending", [False, True])
def test_select_model_merge_top_k_matches_jax(ascending):
    """merge_top_k over (B, M) candidate lists with distinct global ids at k
    = 1,280 (the k = 1,000 search's shortlist): the selection on the
    oriented keys (column ties), then the ids gathered, as the JAX package
    does."""
    rng = np.random.default_rng(12)
    d = tie_keys(rng, 3, 30_000, zeros=False)
    ids = rng.permutation(1 << 24)[: d.size].reshape(d.shape).astype(np.int32)
    keys = -d if ascending else d
    got_k, got_i = held_to_plain(np.where(np.isnan(keys), np.float32(-np.inf), keys), 1280)
    jd, ji = jax_topk.merge_top_k(jnp.asarray(d), jnp.asarray(ids), 1280, ascending)
    np.testing.assert_array_equal(-got_k if ascending else got_k, np.asarray(jd))
    np.testing.assert_array_equal(np.take_along_axis(ids, got_i.astype(np.int64), 1),
                                  np.asarray(ji))


def test_select_model_ends_exact_on_a_wide_tie():
    """A row whose k-th key sits in a bucket larger than the survivor buffer
    (30,000 entries equal to it): every bit of the code is resolved and the
    tied entries are taken in column order, the first k - above of them."""
    rng = np.random.default_rng(3)
    keys = np.full((2, 60_000), 0.5, np.float32)
    keys[:, rng.permutation(60_000)[:3000]] = rng.normal(size=(2, 3000)).astype(np.float32) + 3
    keys[1, ::5] = -np.inf
    traces = []
    held_to_plain(keys, 4000, traces=traces)
    assert [t["end"] for t in traces] == ["exact", "exact"]
    assert [t["passes"] for t in traces] == [3, 3]


def test_select_model_all_neg_inf_rows():
    """Rows of -inf (and NaN): every entry ties; the lowest columns win."""
    keys = np.full((2, 30_000), -np.inf, np.float32)
    keys[1, ::3] = np.nan
    traces = []
    _, idx = held_to_plain(keys, 2000, traces=traces)
    np.testing.assert_array_equal(idx, np.tile(np.arange(2000, dtype=np.int32), (2, 1)))
    assert [t["end"] for t in traces] == ["exact", "exact"]


@pytest.mark.parametrize("k", [1025, 1280, 6000])
def test_select_model_ids_with_ties(k):
    """Ids mode with repeated ids among tied keys (the span merge's lists and
    their (-inf, -1) tails): ties go to the lower id, then the lower column;
    the passes go on into the id's bits where the code alone leaves too many
    tied entries."""
    rng = np.random.default_rng(k)
    keys = tie_keys(rng, 3, 40_000)
    ids = rng.integers(-1, 3000, size=keys.shape).astype(np.int32)
    keys[2, 1000:] = -np.inf
    ids[2, 1000:] = -1
    traces = []
    held_to_plain(keys, k, ids, traces)
    assert traces[2]["passes"] == 6 and traces[2]["end"] == "exact"


def test_select_model_fits_ends_early():
    """Distinct keys: the bucket of the k-th key fits 2 kp after one or two
    passes, so the select ends early and sorts every survivor."""
    rng = np.random.default_rng(4)
    keys = rng.normal(size=(2, 100_000)).astype(np.float32)
    traces = []
    held_to_plain(keys, 4000, traces=traces)
    assert all(t["end"] == "fits" and t["passes"] <= 2 for t in traces)


def test_select_plan_scratch_fits_the_row():
    """lt_topk_scratch's rule: a row's scratch is at most its N (key,
    index) pairs in each buffer, for every N past RADIX_CAP and any batch."""
    for n in (16_385, 20_000, 65_536, 250_000, 1_000_000, 10_000_000):
        for rows in (1, 16, 64, 65_535):
            for k in (1025, 4000, 16_384):
                p = plan(rows, n, k)
                assert max(p["ctrl"], p["record"], p["survivors"]) <= n
                assert p["blocks"] * p["span"] >= n > (p["blocks"] - 1) * p["span"]

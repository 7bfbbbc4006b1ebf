"""A model of K11's fused second stage (csrc/bf16_gather_scores.cu,
``lt_bf16_gather_topc``) in numpy, held to the plain chain and to the JAX
package on the CPU.

The model runs the kernel's plan: the query's S slots cut into the ranges of
its cluster's blocks (``scan._gather_topc_plan``: cs blocks, the most that
keep B x cs within 1.75 blocks an SM and TOPC_MIN_SLOTS slots a block); each
block lists its live slots (a non-negative id and a K5 key above -inf: K5's
pads carry id INT_MAX and -inf) 1,024 at a time in slot order, scores them
into entries (the key's order-preserving code over INT_MAX - slot, so equal
keys go to the lower slot, K5's order; a -inf key is no entry), and ranks
the chunk's entries and its running best C together by count, keeping the
best C (the entries are distinct, a slot each, so the ranks are a
permutation); the leader places every block's entries by rank (its place
in its own list and its count above in the others) and writes the keys
and the slots' row ids, -inf and -1 past the live ones. Beside it, the
sum of a row as the kernel forms it on 16 lanes (a lane's 16-byte word, 8
fmaf, then a butterfly of xor 8, 4, 2, 1) against the per-query mode's 32
(the same, after an xor-16 step that adds the other half-warp's zeros).

Tolerances: the model's keys and ids equal the plain chain's
(``bf16_gather_topc_plain``: K11's plain keys, ``topk_select_plain``, the
gather) bit for bit, the sign of a zero aside (the packed code reads -0.0 as
+0.0); the 16-lane sum equals the 32-lane one bit for bit but for the sign
of an exact zero. Against the JAX package's
``shortlist_device_rescore_ids``, which sums the bf16 products in another
order: the same rows but for near-ties of the C-th key (within 1e-5
relative).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynsedb_tpu.ops.scan as jax_scan
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import scan
from lynsedb_tpu_torch.ops.scan import DeviceCorpus, _to_key
from test_torch_cuda_kernels import fmaf32
from test_torch_rescore_plan import packed

INT_MAX = 2**31 - 1
CHUNK = 1024
F32 = np.float32


def block_ranges(s: int, cs: int) -> list:
    per = -(-s // cs)
    return [(min(s, r * per), min(s, min(s, r * per) + per)) for r in range(cs)]


def entry_key(v: int) -> float:
    u = np.uint32(v >> 32)
    bits = u ^ np.uint32(0x80000000) if u >> np.uint32(31) else ~u
    return float(np.array([bits], np.uint32).view(F32)[0])


def rank_keep(entries: list, c: int) -> list:
    """The kernel's ranking: each entry's rank is the count of entries above
    it (distinct values: a permutation); the ranks below C are kept, in rank
    order."""
    v = np.array(entries, np.uint64)
    rank = (v[None, :] > v[:, None]).sum(1)
    out = [0] * min(c, len(entries))
    for e, r in zip(entries, rank):
        if r < c:
            out[r] = e
    return out


def fused_model(keys: np.ndarray, cand: np.ndarray, top: np.ndarray, c: int, cs: int):
    """The fused stage on (B, S) slot keys (K11's, -inf where a slot is
    empty), K5's ids and keys: (keys (B, min(C, S)) f32, ids int32)."""
    b, s = cand.shape
    c = min(c, s)
    out_k = np.full((b, c), -np.inf, F32)
    out_i = np.full((b, c), -1, np.int32)
    for r in range(b):
        blocks = []
        for lo, hi in block_ranges(s, cs):
            best = []
            for c0 in range(lo, hi, CHUNK):
                live = np.array([t for t in range(c0, min(hi, c0 + CHUNK))
                                 if cand[r, t] >= 0 and top[r, t] > -np.inf], np.int64)
                live = live[keys[r, live] > -np.inf] if len(live) else live
                best = rank_keep(best + [int(v) for v in packed(keys[r, live], live)], c)
            blocks.append(best)
        # the leader: an entry's place is its place in its list and its count
        # above in the others
        best = [0] * min(c, sum(len(lst) for lst in blocks))
        for w, lst in enumerate(blocks):
            mine = np.array(lst, np.uint64)
            others = np.array([e for v, o in enumerate(blocks) if v != w for e in o], np.uint64)
            at = np.arange(len(lst)) + (others[None, :] > mine[:, None]).sum(1)
            for e, a in zip(lst, at):
                if a < c:
                    best[a] = e
        for p in range(len(best)):
            out_k[r, p] = entry_key(best[p])
            out_i[r, p] = cand[r, INT_MAX - (best[p] & 0xFFFFFFFF)]
    return out_k, out_i


def _bits(a: np.ndarray) -> np.ndarray:
    return (np.asarray(a, F32) + F32(0)).view(np.uint32)


@pytest.mark.parametrize("s", [1, 16, 255, 256, 511, 2048, 4000, 16_384])
@pytest.mark.parametrize("b", [1, 2, 16, 17, 33, 64, 65, 132, 256, 70_000])
def test_cluster_plan(b, s):
    """cs is 1, 2, 4 or 8: the largest with B x cs within 1.75 blocks of 132
    SMs and S / cs at least TOPC_MIN_SLOTS; the blocks' ranges cut [0, S)."""
    cs, _ = scan._gather_topc_plan(b, s, 128, 64)
    assert cs in (1, 2, 4, 8)
    fits = lambda n: b * n <= 231 and s // n >= scan.TOPC_MIN_SLOTS  # noqa: E731
    assert cs == 1 or fits(cs)
    assert cs == 8 or not fits(2 * cs)
    ranges = block_ranges(s, cs)
    assert [t for lo, hi in ranges for t in range(lo, hi)] == list(range(s))


@pytest.mark.parametrize("d,c,aligned,rw", [
    (8, 64, True, 16), (64, 64, True, 8), (128, 256, True, 4), (256, 256, True, 2),
    (768, 256, True, 1), (1536, 64, True, 1), (1536, 128, True, 1), (1536, 256, True, 0),
    (2048, 8, True, 0), (2048, 64, True, 0), (2560, 64, True, 0), (7, 64, True, 0),
    (130, 64, True, 0), (128, 64, False, 0)])
def test_ring_plan(d, c, aligned, rw):
    """Rows a stage of a warp's four-stage ring: TOPC_RING_BYTES a warp, 1
    to 16 rows, as many as the block's shared memory takes at this D and C;
    none (the direct route) for D not a multiple of 8, an unaligned corpus,
    or where one row a stage does not fit (D = 1,536 at C = 256, D =
    2,048)."""
    assert scan._gather_topc_plan(1, 4000, d, c, aligned)[1] == rw


@pytest.mark.parametrize("c", [1, 8, 9, 64, 100, 132, 256])
def test_ring_plan_fits_shared_memory(c):
    """At every D a multiple of 8 to 12,288 (the per-query mode's widest),
    the plan's shared memory fits TOPC_SMEM_BYTES, one row more a stage
    would not (or the ring is at its cap), and the direct route always
    fits, so the fused stage serves every width the two-launch chain does."""
    for d in range(8, 12_289, 8):
        rw = scan._gather_topc_plan(1, 4000, d, c)[1]
        cap = max(1, min(16, scan.TOPC_RING_BYTES // (8 * d)))
        assert 0 <= rw <= cap
        assert scan._gather_topc_smem(d, c, rw) <= scan.TOPC_SMEM_BYTES
        assert rw == cap or scan._gather_topc_smem(d, c, rw + 1) > scan.TOPC_SMEM_BYTES


def test_ring_plan_mirrors_the_kernel():
    """The plan's layout constants are the kernel's, and its shared-memory
    sum is the one lt_bf16_gather_topc checks (the same terms, in the
    source)."""
    src = (Path(scan.__file__).parents[1] / "csrc" / "bf16_gather_scores.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (kTopc\w+) = (\d+);", src)}
    assert const["kTopcThreads"] // 32 == scan.TOPC_WARPS
    assert const["kTopcStages"] == scan.TOPC_STAGES
    assert const["kTopcChunk"] == scan.TOPC_CHUNK
    assert "kTopcSmemMax = 227 * 1024 - 1024;" in src
    assert scan.TOPC_SMEM_BYTES == 227 * 1024 - 1024
    assert "(size_t)(9 * kp + kTopcChunk) * sizeof(uint64_t)" in src
    assert "kTopcWarps * kTopcStages * rw * (2 * D + 2 * sizeof(float))" in src


def _ties(rng, b: int, s: int) -> tuple:
    """Slot keys with many exact ties (and signed zeros), K5's ids and keys
    with -1 ids, INT_MAX pads at -inf, -inf slots and an all-empty query."""
    keys = np.round(rng.normal(size=(b, s)), 1).astype(F32)
    keys[keys == 0] = np.where(rng.random(int((keys == 0).sum())) < 0.5, -0.0, 0.0)
    cand = rng.integers(0, 10 * s, size=(b, s)).astype(np.int32)
    top = -np.sort(-rng.normal(size=(b, s)).astype(F32), axis=1)
    cand[:, 2::17] = -1
    if s > 8:
        top[:, -5:] = -np.inf
        cand[:, -3:] = INT_MAX
    if b > 1:
        top[1] = -np.inf
    return keys, cand, top


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("b,s,c", [(3, 4000, 64), (2, 3000, 256), (4, 50, 64), (3, 1100, 100),
                                   (2, 9, 8), (2, 1, 1)])
def test_model_matches_plain_selection(b, s, c, cs):
    """On keys with ties, signed zeros and empty slots of every kind, the
    model (any cluster size) and the plain
    selection (top C of the slot keys, K5's order, the gather) agree bit for
    bit, the sign of a zero aside."""
    rng = np.random.default_rng(b * s + c + cs)
    keys, cand, top = _ties(rng, b, s)
    live = (cand >= 0) & (top > -np.inf)
    masked = torch.from_numpy(np.where(live, keys, -np.inf).astype(F32))
    wk, j = scan.topk_select_plain(masked, min(c, s))
    wi = torch.where(wk > float("-inf"), torch.from_numpy(cand).gather(1, j.long()), -1)
    gk, gi = fused_model(keys, cand, top, c, cs)
    assert np.array_equal(gi, wi.numpy())
    assert np.array_equal(_bits(gk), _bits(wk.numpy()))
    if b > 1:
        assert (gi[1] == -1).all()


@pytest.fixture(scope="module")
def corpora():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6000, 64)) + 0.3).astype(F32)
    x[200:205] = x[7]  # duplicated rows: equal keys
    q = rng.normal(size=(6, 64)).astype(F32)
    jc, tc = jax_scan.DeviceCorpus(64), DeviceCorpus(64, device="cpu")
    for corpus in (jc, tc):
        corpus.append(x)
        corpus.set_tombstones(np.arange(6000) % 23 == 0)
        corpus.finalize()
    return x, q, jc, tc


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
@pytest.mark.parametrize("c", [64, 256])
def test_model_on_k11_keys(corpora, metric, c):
    """The model on K11's plain keys of a top-S shortlist (S = 2,048 of a
    noisy first pass, half the rows filtered) equals the port's stage on the
    CPU (``shortlist_device_rescore_ids``: the plain chain) bit for bit, the
    plan's own cluster size and every other; and holds the JAX package's
    rows but at near-ties of the C-th key."""
    x, q, jc, tc = corpora
    rng = np.random.default_rng(9)
    n = len(x)
    approx = (q @ x.T + rng.normal(size=(len(q), n)).astype(F32)).astype(F32)
    if metric != "ip":
        approx = -approx
    mask = rng.random(n) < 0.5
    m = Metric(metric)
    s = 2048
    keys_all = _to_key(torch.from_numpy(approx), m.ascending, tc.valid_mask(mask)[:n])
    qt = torch.from_numpy(q)
    top, cand = scan.topk_select_plain(keys_all, s)
    slot_keys = scan.bf16_gather_scores_plain(qt, tc._dev16, tc.bf16_aux(), cand, top, m).numpy()
    want_k, want_i = scan.shortlist_device_rescore_ids(qt, keys_all, tc._dev16, tc.bf16_aux(),
                                                       m, s, c)
    plan_cs = scan._gather_topc_plan(len(q), s, 64, c)[0]
    for cs in sorted({plan_cs, 1, 2, 8}):
        gk, gi = fused_model(slot_keys, cand.numpy(), top.numpy(), c, cs)
        assert np.array_equal(gi, want_i.numpy())
        assert np.array_equal(_bits(gk), _bits(want_k.numpy()))
    jax_ids = np.asarray(jax_scan.shortlist_device_rescore_ids(
        jnp.asarray(q), jnp.asarray(approx), jc.data16, jc.bf16_aux(), jc.valid_mask(mask),
        metric=JaxMetric(metric), s=s, c=c))
    for r in range(len(q)):
        diff = set(gi[r].tolist()) ^ set(jax_ids[r].tolist())
        if not diff:
            continue
        ids = torch.from_numpy(np.array(sorted(diff), np.int32))[None]
        k_diff = scan.bf16_gather_scores_plain(qt[r : r + 1], tc._dev16, tc.bf16_aux(), ids, None,
                                               m).numpy()
        kth = float(gk[r, -1])
        assert np.all(np.abs(k_diff - kth) <= 1e-5 * abs(kth) + 1e-5), (r, diff)


def _word_sums(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(rows, 32) lane partials of the 16-byte-word order: lane l sums its
    words l, l + 32, ... (8 fmaf a word, in order); lanes past D / 8 hold
    +0.0."""
    m, d = x.shape
    acc = np.zeros((m, 32), F32)
    for lane in range(32):
        for v in range(lane, d // 8, 32):
            for j in range(8):
                col = 8 * v + j
                acc[:, lane] = fmaf32(x[:, col], np.full(m, q[col], F32), acc[:, lane])
    return acc


def _butterfly(acc: np.ndarray, width: int) -> np.ndarray:
    lanes = np.arange(32)
    o = width // 2
    while o:
        acc = acc + acc[:, lanes ^ o]
        o //= 2
    return acc[:, 0]


@pytest.mark.parametrize("d", [8, 48, 64, 128])
def test_half_warp_sum_matches_warp_sum(d):
    """At D <= 128 a row's words sit on lanes 0..15: the fused stage's
    16-lane butterfly gives the per-query mode's 32-lane sum bit for bit
    but for the sign of an exact zero (its xor-16 step adds +0.0 to each
    lane, turning a -0.0 partial into +0.0)."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(300, d)).astype(F32)
    x = x.astype(jnp.bfloat16).astype(F32)  # the rows as bf16 values
    q = rng.normal(size=d).astype(F32).astype(jnp.bfloat16).astype(F32)
    x[:3] = 0.0
    x[1, :8] = -0.0  # -0.0 products: a lane partial of -0.0
    q[1] = q[0]
    x[2, :2] = 0.5, -0.5  # a lane's two products cancel: an exact +0.0
    acc = _word_sums(x, q)
    sixteen, thirty_two = _butterfly(acc, 16), _butterfly(acc, 32)
    zero = (sixteen == 0) & (thirty_two == 0)
    assert np.array_equal(_bits(sixteen)[~zero], _bits(thirty_two)[~zero])
    assert zero[:3].all()

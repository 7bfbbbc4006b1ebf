"""lynsedb_tpu_torch.ops.quantize and the quantized shortlist stage of
ops/scan.py on the CPU (the kernels' plain versions) against
lynsedb_tpu.ops.quantize and lynsedb_tpu.ops.scan, on the same seeded inputs.

Sizes: N=5,000 rows, D=64 (and D=100, whose codes and rotation are padded).

Tolerances: the SQ8 / RaBitQ / PolarVec encodings are equal arrays (the same
numpy code); the rotation rtol=1e-6 (the same additions in the same order);
the int8 query codes and the integer dot are equal; the approximate scores
rtol=1e-5, atol=1e-5 (f32 sums of the f32 terms taken in another order); PQ
codes from the same codebooks equal except where a row's two nearest
codewords lie within 1e-5 relative (float64 distances); host rescores
rtol=1e-5, atol=1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynsedb_tpu.index as jindex
import lynsedb_tpu.ops.scan as jax_scan
from lynsedb_tpu.index.quantized import AuxQuantIndex as JaxAux
from lynsedb_tpu.metrics import Metric as JaxMetric
from lynsedb_tpu.ops import quantize as JQ
from lynsedb_tpu_torch import index as tindex
from lynsedb_tpu_torch.index.quantized import AuxQuantIndex as PortAux
from lynsedb_tpu_torch.index.quantized import _merge
from lynsedb_tpu_torch.metrics import Metric
from lynsedb_tpu_torch.ops import quantize as TQ
from lynsedb_tpu_torch.ops import scan
from lynsedb_tpu_torch.ops.scan import DeviceCorpus, _to_key
from test_torch_scan import one_torch_thread  # noqa: F401 (pytestmark's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
N = 5000
KINDS = ("sq8", "rabitq", "polarvec", "pq")
METRICS = ("ip", "l2", "cosine")
MODE = {"sq8": "FLAT-IP-SQ8", "rabitq": "FLAT-IP-RABITQ", "polarvec": "FLAT-IP-POLARVEC",
        "pq": "FLAT-IP-PQ"}


def _data(d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, d)) + 0.3).astype(np.float32)
    x[200:205] = x[7]  # duplicated rows
    q = rng.normal(size=(8, d)).astype(np.float32)
    q[1] = 0.0  # a zero query: its int8 scale is 1
    q[2] = x[7]
    return x, q


@pytest.fixture(scope="module")
def jax_states():
    """The JAX package's encodings at D=64, each kind built once."""
    x, q = _data(64)
    states = {kind: JaxAux._fit_encode(kind, x, jindex.resolve_index_mode(MODE[kind], 64))
              for kind in KINDS}
    return x, q, states


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("kind", ["sq8", "rabitq", "polarvec"])
def test_codec_arrays_equal_jax(kind, d):
    x, _ = _data(d, seed=d)
    jstate = JaxAux._fit_encode(kind, x, jindex.resolve_index_mode(MODE[kind], d))
    tstate = PortAux._fit_encode(kind, x, tindex.resolve_index_mode(MODE[kind], d), "cpu")
    assert sorted(jstate) == sorted(tstate)
    for key, val in jstate.items():
        assert np.asarray(tstate[key]).dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(tstate[key], val, err_msg=key)


@pytest.mark.parametrize("d", [8, 64, 100])
def test_rotate_matches_jax(d):
    x, _ = _data(d, seed=d + 1)
    dim_pad = TQ._next_pow2(d)
    signs = TQ.rotation_signs(dim_pad, 1234)
    want = np.asarray(JQ.rotate(x[:300], signs, dim_pad))
    got = TQ.fwht_rotate(torch.from_numpy(x[:300]), torch.from_numpy(signs), dim_pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(TQ.rotate_host(x[:300], signs, dim_pad), want, rtol=1e-6)


def test_int8_query_codes_and_dot_equal_jax(jax_states):
    x, q, states = jax_states
    a = np.concatenate([q, q * 1e-3, np.full((1, 64), 0.5, np.float32)])
    a[-1, 0] = 127.0  # scale 1: every other entry sits on a rounding tie (0.5)
    amax = jnp.max(jnp.abs(a), axis=-1, keepdims=True)  # _int8_dot's query side
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    want = np.asarray(jnp.clip(jnp.round(a / scale), -127, 127).astype(jnp.int8))
    got, got_scale = TQ.quantize_queries(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(scale))
    for codes in (states["sq8"]["codes"], states["rabitq"]["bits"]):
        j = np.asarray(JQ._int8_dot(jnp.asarray(a), jnp.asarray(codes).T))
        t = TQ._int8_dot(torch.from_numpy(a), torch.from_numpy(codes))
        np.testing.assert_array_equal(t.numpy(), j)
        # the card's copy pads the codes to 16-column multiples with zeros
        t_pad = TQ._int8_dot(torch.from_numpy(a), torch.from_numpy(np.pad(codes, ((0, 0), (0, 16)))))
        np.testing.assert_array_equal(t_pad.numpy(), j)


def _jax_scores(kind, state, q, mk):
    qj = jnp.asarray(q)
    if kind == "sq8":
        return JQ.sq8_scores(qj, state["codes"], state["lo"], state["scale"], state["row_sq"], mk)
    if kind == "pq":
        return JQ.pq_scores(qj, state["codes"], state["codebooks"], state["row_sq"], mk)
    q_rot = JQ.rotate(qj, state["signs"], int(state["dim_pad"]))
    q_sq = jnp.sum(qj * qj, axis=-1)
    if kind == "rabitq":
        return JQ.rabitq_scores(q_rot, state["bits"], state["alpha"], state["row_sq"], q_sq, mk)
    return JQ.polarvec_scores(q_rot, state["codes"], state["lo"], state["scale"], state["row_sq"],
                              q_sq, mk)


def _port_state(kind, state):
    """The arrays as the index stages them (int8 codes padded to 16 columns)."""
    out = {}
    for key, val in state.items():
        if isinstance(val, np.ndarray) and val.ndim >= 1:
            out[key] = torch.from_numpy(TQ.pad_codes(val) if val.dtype == np.int8 else val)
    return out


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", KINDS)
def test_scores_match_jax(jax_states, kind, metric):
    x, q, states = jax_states
    state = states[kind]
    want = np.asarray(_jax_scores(kind, state, q, metric))
    qt = torch.from_numpy(q)
    st = {k: torch.from_numpy(v) for k, v in state.items() if isinstance(v, np.ndarray) and v.ndim}
    if kind == "sq8":
        got = TQ.sq8_scores(qt, st["codes"], st["lo"], st["scale"], st["row_sq"], metric)
    elif kind == "pq":
        got = TQ.pq_scores(qt, st["codes"], st["codebooks"], st["row_sq"], metric)
    else:
        q_rot = TQ.rotate(qt, st["signs"], int(state["dim_pad"]))
        q_sq = (qt * qt).sum(-1)
        if kind == "rabitq":
            got = TQ.rabitq_scores(q_rot, st["bits"], st["alpha"], st["row_sq"], q_sq, metric)
        else:
            got = TQ.polarvec_scores(q_rot, st["codes"], st["lo"], st["scale"], st["row_sq"], q_sq,
                                     metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    # the wrappers (K12 / K13 with K14) on CPU tensors: oriented, masked keys
    m = Metric(metric)
    valid = torch.from_numpy(np.random.default_rng(3).random(N + 100) < 0.5)
    dev = _port_state(kind, state)
    if kind == "pq":
        keys = TQ.pq_adc_scores(qt, dev["codes"], dev["codebooks"], dev["row_sq"], valid, m)
    else:
        q_rot = None if kind == "sq8" else TQ.fwht_rotate(qt, dev["signs"], int(state["dim_pad"]))
        keys = TQ.int8_code_scores(kind, qt, q_rot, dev, valid, m)
    want_keys = _to_key(torch.from_numpy(want.copy()), m.ascending, valid[:N]).numpy()
    assert keys.shape == (len(q), N)
    np.testing.assert_array_equal(np.isinf(keys.numpy()), np.isinf(want_keys))
    fin = np.isfinite(want_keys)
    np.testing.assert_allclose(keys.numpy()[fin], want_keys[fin], rtol=1e-5, atol=1e-5)


def test_pq_encode_matches_jax(jax_states):
    """PQ.encode (kmeans_assign a subspace) from the JAX package's trained
    codebooks gives its codes, except at a float64 near-tie."""
    x, _, states = jax_states
    books = states["pq"]["codebooks"]
    want = JQ.PQ(books).encode(x)
    got = TQ.PQ(books).encode(x, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (N, 16)
    ds = books.shape[2]
    for r, s in zip(*np.nonzero(got != want)):
        sub = x[r, s * ds : (s + 1) * ds].astype(np.float64)
        d_got, d_want = (((sub - books[s, c]) ** 2).sum() for c in (got[r, s], want[r, s]))
        assert abs(d_got - d_want) <= 1e-5 * max(d_want, 1e-6), (r, s, d_got, d_want)
    np.testing.assert_array_equal(TQ.PQ(books).row_sq_from_codes(want),
                                  JQ.PQ(books).row_sq_from_codes(want))


def test_pq_fit_port():
    x, _ = _data(64)
    pq = TQ.PQ.fit(x, None, device="cpu")
    assert pq.codebooks.shape == (16, 256, 4) and np.isfinite(pq.codebooks).all()
    codes = pq.encode(x, device="cpu")
    # the reconstruction is far closer than the rows' spread
    err = ((pq.decode(codes) - x) ** 2).sum(1).mean()
    assert err < 0.5 * ((x - x.mean(0)) ** 2).sum(1).mean()


@pytest.fixture(scope="module")
def corpora():
    x, q = _data(64, seed=5)
    jc, tc = jax_scan.DeviceCorpus(64), DeviceCorpus(64, device="cpu")
    for c in (jc, tc):
        c.append(x)
        c.set_tombstones(np.arange(N) % 23 == 0)
        c.finalize()
    return x, q, jc, tc


@pytest.mark.parametrize("metric", METRICS)
def test_shortlist_device_rescore_matches_jax(corpora, metric):
    """Top S of the approximate keys, the bf16 rescore of the S rows (K11's
    plain version), top C: the same ids as the JAX chain, except where two
    rows' bf16 scores nearly tie at the C-th place."""
    x, q, jc, tc = corpora
    rng = np.random.default_rng(9)
    approx = (q @ x.T + rng.normal(size=(len(q), N)).astype(np.float32)).astype(np.float32)
    if metric != "ip":
        approx = -approx  # ascending metrics: smaller is better
    mask = rng.random(N) < 0.5
    s, c = 1024, 64
    want = np.asarray(jax_scan.shortlist_device_rescore_ids(
        jnp.asarray(q), jnp.asarray(approx), jc.data16, jc.bf16_aux(), jc.valid_mask(mask),
        metric=JaxMetric(metric), s=s, c=c))
    m = Metric(metric)
    valid = tc.valid_mask(mask)
    keys = _to_key(torch.from_numpy(approx), m.ascending, valid[:N])
    qt = torch.from_numpy(q)
    got_keys, got = scan.shortlist_device_rescore_ids(qt, keys, tc._dev16, tc.bf16_aux(), m, s, c)
    got = got.numpy()
    assert got.shape == want.shape == (len(q), c)
    assert np.all(mask[got] & ~jc._tombs_np[got])
    for r in range(len(q)):
        diff = set(got[r]) ^ set(want[r])
        if not diff:
            continue
        # every swapped id's bf16 key lies within 1e-5 relative of the C-th
        ids = torch.from_numpy(np.array(sorted(diff), np.int32))[None]
        k_diff = scan.bf16_gather_scores_plain(qt[r : r + 1], tc._dev16, tc.bf16_aux(), ids, None,
                                               m).numpy()
        kth = float(got_keys[r, -1])
        assert np.all(np.abs(k_diff - kth) <= 1e-5 * abs(kth) + 1e-5), (r, diff)


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_gather_scores_shared_list(corpora, metric):
    """A list shared by every query (stride 0, the K4 layout) and per-query
    lists give the same keys; empty slots are -inf."""
    x, q, _, tc = corpora
    m = Metric(metric)
    ids = np.arange(0, 2 * 300, 2, dtype=np.int32)
    ids[:5] = -1
    shared = torch.from_numpy(ids)[None]
    qt = torch.from_numpy(q)
    a = scan.bf16_gather_scores(qt, tc._dev16, tc.bf16_aux(), shared, None, m)
    b = scan.bf16_gather_scores(qt, tc._dev16, tc.bf16_aux(), shared.expand(len(q), -1).contiguous(),
                                None, m)
    assert torch.equal(a, b) and bool(torch.isinf(a[:, :5]).all())
    full = scan.bf16_centered_scores_plain(qt, tc._dev16, tc.bf16_aux(),
                                           torch.ones(tc.capacity, dtype=torch.bool), m)
    torch.testing.assert_close(a[:, 5:], full[:, ids[5:]], rtol=1e-5, atol=1e-5)


def test_bf16_gather_scores_list_layout(corpora):
    """K11's list layout: a (1, S) list at B = 1 gives the same keys whether
    it is one query's list or marked ``shared`` (the two routes of the
    kernel); ``shared`` with a list a query, or a list count that is
    neither 1 nor B, is refused."""
    x, q, _, tc = corpora
    ids = torch.from_numpy(np.arange(1, 2 * 300, 2, dtype=np.int32))[None]
    qt = torch.from_numpy(q)
    args = (tc._dev16, tc.bf16_aux(), ids, None, Metric.IP)
    one = scan.bf16_gather_scores(qt[:1], *args)
    assert torch.equal(one, scan.bf16_gather_scores(qt[:1], *args, shared=True))
    assert torch.equal(one, scan.bf16_gather_scores(qt, *args)[:1])
    per_query = ids.expand(len(q), -1).contiguous()
    with pytest.raises(ValueError):
        scan.bf16_gather_scores(qt, tc._dev16, tc.bf16_aux(), per_query, None, Metric.IP,
                                shared=True)
    with pytest.raises(ValueError):
        scan.bf16_gather_scores(qt, tc._dev16, tc.bf16_aux(), per_query[:2], None, Metric.IP)


@pytest.mark.parametrize("metric", METRICS)
def test_host_rescore_matches_jax(corpora, metric):
    x, q, jc, tc = corpora
    cand = np.random.default_rng(4).integers(0, N, size=(len(q), 50))
    cand[:, -3:] = -1
    want = jc.rescore(q, cand, JaxMetric(metric))
    got = tc.rescore(q, cand, Metric(metric))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    shared = tc.rescore(q, cand[0], Metric(metric))  # one list for every query
    assert shared.shape == (len(q), 50)
    # the other metrics rescore through their distance kernel's gather mode
    want = jc.rescore(q, cand, JaxMetric.L1)
    got = tc.rescore(q, cand, Metric.L1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_merge_drops_repeats_and_empty_slots():
    exact = np.array([[3.0, 1.0, np.nan, 1.0, 2.0, 5.0]], np.float32)
    cand = np.array([[4, 9, 2, 9, 7, -1]])
    d, i = _merge(exact, cand, 3, Metric.IP)
    np.testing.assert_array_equal(i, [[4, 7, 9]])
    np.testing.assert_array_equal(d, [[3.0, 2.0, 1.0]])
    d, i = _merge(exact, cand, 10, Metric.L2)  # ascending: 1.0 first, 9 once
    np.testing.assert_array_equal(i, [[9, 7, 4]])

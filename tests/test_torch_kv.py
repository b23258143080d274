"""The port's quantized KV cache (`repro_torch.compression.kv`) and its
flash-decode attention (`repro_torch.kernels.kv_attention`) against the
JAX package.

Part one holds `quantize_kv`, `dequantize_kv` and `kv_error_bound_holds`
bit for bit against `repro.compression.kv` on every `QuantizedKV` plane.
Part two holds `kv_decode_attention` (its plain version, which a CPU
tensor gets) against the reference's Pallas kernel in interpret mode and
against its oracle, within rtol = atol = 2e-5, the tolerance the
reference holds its own kernel to (tests/test_kernel_attention.py): the
sums run in another order.  Both packages get the same numpy inputs.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.compression import kv as JKV
from repro.core import QuantizerConfig as JCfg
from repro.kernels.kv_attention import kv_decode_attention as j_attention
from repro.kernels.ref import kv_decode_attention_ref as j_oracle
from repro_torch.compression import kv as TKV
from repro_torch.core import interop
from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import kv_attention as TA
from repro_torch.kernels import ref as TR

RNG = np.random.default_rng(1308)
TOL = dict(rtol=2e-5, atol=2e-5)


def make_cache(b, g, s, d, sinks=True):
    """K and V as N(0, 1) * 0.7 with attention-sink outliers (token 0, the
    first D/4 channels x80), as tests/test_kernel_attention.py makes them."""
    k = (RNG.standard_normal((b, g, s, d)) * 0.7).astype(np.float32)
    v = (RNG.standard_normal((b, g, s, d)) * 0.7).astype(np.float32)
    if sinks:
        k[:, :, 0, : d // 4] *= 80.0
        v[:, :, 0, : d // 4] *= 80.0
    return k, v


def _planes_equal(jq, tq):
    for f in TKV.QuantizedKV._fields:
        a, t = np.asarray(getattr(jq, f)), getattr(tq, f).numpy()
        assert a.dtype == t.dtype and a.shape == t.shape, f
        if a.dtype == np.float32:
            a, t = a.view(np.uint32), t.view(np.uint32)
        np.testing.assert_array_equal(a, t, err_msg=f)


def _both(x, eb_rel=2.0 ** -6):
    jq = JKV.quantize_kv(jnp.asarray(x), JCfg(mode="abs", error_bound=eb_rel,
                                               bin_bits=8))
    tq = TKV.quantize_kv(torch.from_numpy(x),
                         TCfg(mode="abs", error_bound=eb_rel, bin_bits=8))
    return jq, tq


# ------------------------------------------------- part one: the cache --

def test_kv_constants_match_reference():
    from repro.models import serve as JS
    assert (TKV.PAGE, TKV.CAP) == (JS.PAGE, JS.CAP)
    assert TKV.kv_quantizer_config() == TCfg(
        **dataclasses.asdict(JKV.kv_quantizer_config()))
    for fn in ("quantize_kv", "dequantize_kv", "kv_error_bound_holds"):
        jp = inspect.signature(getattr(JKV, fn)).parameters
        tp = inspect.signature(getattr(TKV, fn)).parameters
        for name in ("page", "cap"):
            if name in jp:
                assert tp[name].default == jp[name].default, (fn, name)
    jp = inspect.signature(j_attention).parameters
    tp = inspect.signature(TA.kv_decode_attention).parameters
    assert (tp["page"].default, tp["cap"].default) == (
        jp["page"].default, jp["cap"].default)


@pytest.mark.parametrize("eb_rel", [2.0 ** -4, 2.0 ** -5, 2.0 ** -6])
@pytest.mark.parametrize("b,g,s,d", [(2, 2, 256, 128), (1, 3, 384, 64)])
def test_quantize_kv_matches_reference(b, g, s, d, eb_rel):
    k, _ = make_cache(b, g, s, d)
    jq, tq = _both(k, eb_rel)
    _planes_equal(jq, tq)
    assert not bool(tq.overflow.any())
    y = TKV.dequantize_kv(tq)
    np.testing.assert_array_equal(np.asarray(JKV.dequantize_kv(jq)).view(
        np.uint32), y.numpy().view(np.uint32))
    cfg = TCfg(mode="abs", error_bound=eb_rel, bin_bits=8)
    assert bool(TKV.kv_error_bound_holds(torch.from_numpy(k), tq, cfg))
    # the per-page bound in float64 against the original
    x = k.reshape(b, g, s // 128, -1).astype(np.float64)
    err = np.abs(x - y.numpy().reshape(x.shape)).max(-1)
    assert np.all(err <= eb_rel * np.abs(x).max(-1) + 1e-30)


def test_quantize_kv_outlier_table_matches_reference():
    """Pages with 0, a few, exactly cap and more than cap outliers
    (non-finite values, NaN payloads, -0.0), a page of zeros (a degenerate
    bound: every value an outlier), and a 3-D cache."""
    k, _ = make_cache(2, 2, 512, 128, sinks=False)
    flat = k.reshape(2, 2, 4, -1)
    picks = RNG.permutation(flat.shape[-1])
    flat[0, 0, 1, picks[:3]] = [np.nan, np.inf, -np.inf]
    flat[0, 1, 2, picks[:8]] = np.uint32(0x7FC00123).view(np.float32)
    flat[1, 0, 3, picks[:11]] = np.nan
    flat[1, 1, 0] = 0.0
    flat[1, 1, 0, 5] = -0.0
    jq, tq = _both(k)
    _planes_equal(jq, tq)
    assert tq.overflow.numpy().tolist() == [[[False] * 4, [False] * 4],
                                            [[False, False, False, True],
                                             [True, False, False, False]]]
    np.testing.assert_array_equal(
        np.asarray(JKV.dequantize_kv(jq)).view(np.uint32),
        TKV.dequantize_kv(tq).numpy().view(np.uint32))
    jq3, tq3 = _both(k[0])
    _planes_equal(jq3, tq3)


def test_kv_undersized_bound_surfaces_overflow():
    """eb_rel below the int8 sizing limit cannot be honoured: both
    packages flag the same pages, and the bound holds where not flagged."""
    k, _ = make_cache(1, 1, 256, 128)
    jq, tq = _both(k, 2.0 ** -8)
    _planes_equal(jq, tq)
    assert bool(tq.overflow.any())
    cfg = TCfg(mode="abs", error_bound=2.0 ** -8, bin_bits=8)
    jcfg = JCfg(mode="abs", error_bound=2.0 ** -8, bin_bits=8)
    assert bool(TKV.kv_error_bound_holds(torch.from_numpy(k), tq, cfg))
    assert bool(JKV.kv_error_bound_holds(jnp.asarray(k), jq, jcfg))
    # a corrupted bin on a page not flagged fails the check
    bins = tq.bins.clone()
    bins[0, 0, 1, 1] += 5
    bad = tq._replace(bins=bins, overflow=torch.zeros_like(tq.overflow))
    assert not bool(TKV.kv_error_bound_holds(torch.from_numpy(k), bad, cfg))


# --------------------------------------------- part two: the attention --

def _attention_cases():
    return [(2, 2, 4, 256, 128), (1, 1, 8, 512, 128), (2, 4, 2, 128, 128),
            (1, 2, 6, 384, 128)]


def _run_all(q, jk, jv, tk, tv, lengths):
    j_k = np.asarray(j_attention(jnp.asarray(q), jk, jv, jnp.asarray(lengths),
                                 interpret=True))
    j_o = np.asarray(j_oracle(jnp.asarray(q), jk, jv, jnp.asarray(lengths)))
    t = TA.kv_decode_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(lengths)).numpy()
    return j_k, j_o, t


@pytest.mark.parametrize("b,g,hg,s,d", _attention_cases())
def test_kv_attention_matches_reference(b, g, hg, s, d):
    k, v = make_cache(b, g, s, d)
    jk, tk = _both(k)
    jv, tv = _both(v)
    q = RNG.standard_normal((b, g, hg, d)).astype(np.float32)
    lengths = RNG.integers(1, s + 1, b).astype(np.int32)
    if hg == 6:                         # ragged: one past a page, one whole
        lengths = np.array([s // 2 + 1], np.int32)
    j_k, j_o, t = _run_all(q, jk, jv, tk, tv, lengths)
    np.testing.assert_allclose(t, j_k, **TOL)
    np.testing.assert_allclose(t, j_o, **TOL)
    t_o = TR.kv_decode_attention_ref(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(t_o, j_o, **TOL)


@pytest.mark.parametrize("lengths", [[1, 128], [127, 384], [129, 383]])
def test_kv_attention_ragged_lengths(lengths):
    k, v = make_cache(2, 2, 384, 128)
    jk, tk = _both(k)
    jv, tv = _both(v)
    q = RNG.standard_normal((2, 2, 6, 128)).astype(np.float32)
    j_k, j_o, t = _run_all(q, jk, jv, tk, tv, np.array(lengths, np.int32))
    np.testing.assert_allclose(t, j_k, **TOL)
    np.testing.assert_allclose(t, j_o, **TOL)


def test_kv_attention_non_finite_value_gives_reference_nans():
    """An inf in V at token 100, channel 5, with length 90: token 100 lies
    in the last page read, where 0 * inf puts NaN in channel 5 of every
    head, in the port and in both JAX functions."""
    k, v = make_cache(1, 1, 256, 128, sinks=False)
    v[0, 0, 100, 5] = np.inf
    jk, tk = _both(k)
    jv, tv = _both(v)
    q = RNG.standard_normal((1, 1, 2, 128)).astype(np.float32)
    j_k, j_o, t = _run_all(q, jk, jv, tk, tv, np.array([90], np.int32))
    nan = np.isnan(t)
    assert np.argwhere(nan).tolist() == [[0, 0, 0, 5], [0, 0, 1, 5]]
    np.testing.assert_array_equal(nan, np.isnan(j_k))
    np.testing.assert_array_equal(nan, np.isnan(j_o))
    np.testing.assert_allclose(t[~nan], j_k[~nan], **TOL)


def test_kv_attention_skips_pages_past_the_length():
    """ROADMAP C-port-3: a page wholly past the length is not read, so a
    non-finite V value there leaves the output as it is without it; with
    length 0 the output is NaN, as the reference's oracle gives."""
    k, v = make_cache(1, 1, 256, 128, sinks=False)
    jk, tk = _both(k)
    _, tv = _both(v)
    v[0, 0, 200, 5] = np.inf
    _, tv_inf = _both(v)
    q = torch.from_numpy(
        RNG.standard_normal((1, 1, 2, 128)).astype(np.float32))
    lengths = torch.tensor([90], dtype=torch.int32)
    np.testing.assert_array_equal(
        TA.kv_decode_attention(q, tk, tv, lengths).numpy(),
        TA.kv_decode_attention(q, tk, tv_inf, lengths).numpy())
    empty = TA.kv_decode_attention(q, tk, tv,
                                   torch.tensor([0], dtype=torch.int32))
    assert bool(torch.isnan(empty).all())
    assert bool(torch.isnan(TR.kv_decode_attention_ref(
        q, tk, tv, torch.tensor([0], dtype=torch.int32))).all())


# ----------------------------------- the split over pages (flash-decoding) --

SPLIT_S = 768                       # 6 pages


@pytest.fixture(scope="module")
def split_case():
    """One cache (B = 2, G = 1, Hg = 4, 6 pages), its q, and the JAX
    kernel's (interpret mode) and oracle's outputs by lengths, made once."""
    k, v = make_cache(2, 1, SPLIT_S, 128)
    jk, tk = _both(k)
    jv, tv = _both(v)
    q = RNG.standard_normal((2, 1, 4, 128)).astype(np.float32)
    refs = {}

    def ref(lengths):
        key = tuple(lengths)
        if key not in refs:
            lens = jnp.asarray(np.array(lengths, np.int32))
            refs[key] = (
                np.asarray(j_attention(jnp.asarray(q), jk, jv, lens,
                                       interpret=True)),
                np.asarray(j_oracle(jnp.asarray(q), jk, jv, lens)))
        return refs[key]

    return dict(q=q, jk=jk, jv=jv, tk=tk, tv=tv, ref=ref)


def _split_lengths():
    """(pages_per_split, lengths): one before, on and one after a split
    boundary (pps * 128 tokens); "all" is one split of every page."""
    cases = []
    for pps in (1, 2, 3, "all"):
        edge = SPLIT_S if pps == "all" else pps * 128
        after = [1, SPLIT_S] if pps == "all" else [edge + 1, 1]
        cases += [(pps, [edge - 1, edge]), (pps, after)]
    return cases


@pytest.mark.parametrize("pps,lengths", _split_lengths())
def test_kv_attention_split_matches_reference(split_case, pps, lengths):
    """The plain version split into runs of pps pages and merged, as the
    kernel is, against the JAX kernel and oracle."""
    c = split_case
    n = SPLIT_S // 128 if pps == "all" else pps
    t = TA.kv_decode_attention(torch.from_numpy(c["q"]), c["tk"], c["tv"],
                               torch.tensor(lengths, dtype=torch.int32),
                               pages_per_split=n).numpy()
    j_k, j_o = c["ref"](lengths)
    np.testing.assert_allclose(t, j_k, **TOL)
    np.testing.assert_allclose(t, j_o, **TOL)


@pytest.mark.parametrize("pps", [1, 2, 3, 6])
def test_kv_attention_split_length_zero_is_nan(split_case, pps):
    """Length 0 reads no page and no split: NaN, as the oracle gives; the
    other row is untouched by it."""
    c = split_case
    lengths = torch.tensor([0, 300], dtype=torch.int32)
    t = TA.kv_decode_attention(torch.from_numpy(c["q"]), c["tk"], c["tv"],
                               lengths, pages_per_split=pps).numpy()
    assert np.isnan(t[0]).all() and not np.isnan(t[1]).any()
    _, j_o = c["ref"](lengths.tolist())
    assert np.isnan(j_o[0]).all()
    np.testing.assert_allclose(t[1], j_o[1], **TOL)


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_kv_attention_split_keeps_the_unsplit_nans(pps):
    """An inf in V at a masked token of the last page read (token 300,
    length 290) gives NaN in its channel of every head, split or not."""
    k, v = make_cache(1, 2, SPLIT_S, 128, sinks=False)
    v[0, 1, 300, 5] = np.inf
    _, tk = _both(k)
    _, tv = _both(v)
    q = torch.from_numpy(RNG.standard_normal((1, 2, 3, 128))
                         .astype(np.float32))
    lengths = torch.tensor([290], dtype=torch.int32)
    whole = TA.kv_decode_attention(q, tk, tv, lengths,
                                   pages_per_split=SPLIT_S // 128).numpy()
    t = TA.kv_decode_attention(q, tk, tv, lengths,
                               pages_per_split=pps).numpy()
    nan = np.isnan(t)
    assert np.argwhere(nan).tolist() == [[0, 1, h, 5] for h in range(3)]
    np.testing.assert_array_equal(nan, np.isnan(whole))
    np.testing.assert_allclose(t[~nan], whole[~nan], **TOL)


def test_kv_attention_default_split_uses_shapes_only(split_case):
    """The default pages per split comes from B, G, the page count and the
    SM count: 16 at decode_32k's B = 32 on 132 SMs, fewer for one user."""
    assert TA.default_pages_per_split(32, 8, 256) == 16
    assert TA.default_pages_per_split(1, 8, 256) == 8
    assert TA.default_pages_per_split(1, 1, 1) == 1
    with pytest.raises(ValueError, match="pages_per_split"):
        c = split_case
        TA.kv_decode_attention(torch.from_numpy(c["q"]), c["tk"], c["tv"],
                               torch.tensor([1, 1], dtype=torch.int32),
                               pages_per_split=0)


def test_kv_attention_refuses_bad_operands():
    k, v = make_cache(1, 1, 128, 128)
    tk, tv = (TKV.quantize_kv(torch.from_numpy(x), TKV.kv_quantizer_config())
              for x in (k, v))
    q = torch.zeros((1, 1, 2, 128))
    with pytest.raises(ValueError, match="lengths"):
        TA.kv_decode_attention(q, tk, tv, torch.tensor([1]))
    with pytest.raises(NotImplementedError, match="float32"):
        TA.kv_decode_attention(q.double(), tk, tv,
                               torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="cap"):
        TA.kv_decode_attention(q, tk, tv, torch.tensor([1], dtype=torch.int32),
                               cap=4)


# ------------------------------------------------ the cache across both --

def test_interop_carries_a_cache_across_both_packages():
    """A cache quantized by JAX feeds the port's attention, and one
    quantized by the port feeds JAX's, with the same result."""
    k, v = make_cache(1, 2, 256, 128)
    jk, tk = _both(k)
    jv, tv = _both(v)
    q = RNG.standard_normal((1, 2, 6, 128)).astype(np.float32)
    lengths = np.array([200], np.int32)
    from_jax_k = interop.quantized_kv_from_numpy(jk, device="cpu")
    from_jax_v = interop.quantized_kv_from_numpy(jv, device="cpu")
    _planes_equal(jk, from_jax_k)
    t = TA.kv_decode_attention(torch.from_numpy(q), from_jax_k, from_jax_v,
                               torch.from_numpy(lengths)).numpy()
    to_jax_k = JKV.QuantizedKV(*map(jnp.asarray,
                                    interop.quantized_kv_to_numpy(tk)))
    to_jax_v = JKV.QuantizedKV(*map(jnp.asarray,
                                    interop.quantized_kv_to_numpy(tv)))
    _planes_equal(to_jax_k, tk)
    j = np.asarray(j_attention(jnp.asarray(q), to_jax_k, to_jax_v,
                               jnp.asarray(lengths), interpret=True))
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_array_equal(t, TA.kv_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(lengths)).numpy())

"""Port parity: `repro_torch.core.config` and `repro_torch.core.bitops`
against the JAX package's `repro.core.config` / `repro.core.bitops`.

Every constant and every bit-level helper must agree bit for bit (no
tolerance): the constants are frozen into the wire, and the REL
log2approx/pow2approx bits are what decode reproduces on every backend.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitops as jbits
from repro.core.config import QuantizerConfig as JCfg
from repro.core.oracle_np import log2approx as np_log2, pow2approx as np_pow2
from repro_torch.core import bitops as tbits
from repro_torch.core.config import QuantizerConfig as TCfg

RNG = np.random.default_rng(1101)


def _bits(v):
    a = np.asarray(v)
    return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bin_bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_config_constants_match_reference(mode, bin_bits, dtype):
    for eb in (1e-3, 0.1, 1.0, 3.0e-7):
        j = JCfg(mode=mode, error_bound=eb, bin_bits=bin_bits, dtype=dtype,
                 outlier_cap_frac=1 / 64)
        t = TCfg(mode=mode, error_bound=eb, bin_bits=bin_bits, dtype=dtype,
                 outlier_cap_frac=1 / 64)
        assert (t.maxbin, t.tighten, t.eb_floor) == (j.maxbin, j.tighten,
                                                     j.eb_floor)
        for a, b in zip(t.abs_constants(), j.abs_constants()):
            assert _bits(a) == _bits(b)
        for a, b in zip(t.abs_constants(eb=2.5e-4), j.abs_constants(eb=2.5e-4)):
            assert _bits(a) == _bits(b)
        for a, b in zip(t.rel_constants(), j.rel_constants()):
            assert _bits(a) == _bits(b)
        assert _bits(t.rel_screen_threshold()) == _bits(j.rel_screen_threshold())
        for n in (1, 63, 64, 65, 4097, 1 << 27):
            assert t.outlier_cap(n) == j.outlier_cap(n)


@pytest.mark.parametrize("kw", [
    dict(mode="xyz"), dict(error_bound=0.0), dict(error_bound=float("nan")),
    dict(error_bound=float("inf")), dict(bin_bits=12),
    dict(mode="abs", error_bound=2.0 ** -121)])
def test_config_rejects_like_reference(kw):
    with pytest.raises(ValueError):
        JCfg(**kw)
    with pytest.raises(ValueError):
        TCfg(**kw)


def _positive_f32(n):
    """Normal positives over the whole exponent range plus powers of two."""
    x = np.ldexp(RNG.uniform(1.0, 2.0, n), RNG.integers(-126, 128, n))
    x[:64] = np.ldexp(1.0, np.arange(-126, 128, 4)[:64])
    return x.astype(np.float32)


def test_bitops_f32_match_reference():
    x = _positive_f32(4096)
    got = tbits.log2approx(torch.from_numpy(x)).numpy()
    want = np.asarray(jbits.log2approx(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # pow2approx on exact pow2-step products, as the quantizer feeds it
    step = np.float32(2.0 ** -10)
    bins = RNG.integers(-(1 << 17), 1 << 17, 4096).astype(np.float32)
    lf = bins * step
    got = tbits.pow2approx(torch.from_numpy(lf)).numpy()
    want = np.asarray(jbits.pow2approx(jnp.asarray(lf)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # pow2_floor on normals and the bit helpers on specials
    got = tbits.pow2_floor(torch.from_numpy(x)).numpy()
    want = np.asarray(jbits.pow2_floor(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    sp = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42,
                   np.uint32(0x7FC00123).view(np.float32)], np.float32)
    tb = tbits.float_to_bits(torch.from_numpy(sp))
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), sp.view(np.uint32))
    back = tbits.bits_to_float(tb, torch.float32).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), sp.view(np.uint32))


def test_bitops_f64_match_numpy_oracle():
    """float64 has no JAX twin with x64 off; the numpy oracle stands in."""
    x = np.ldexp(RNG.uniform(1.0, 2.0, 2048), RNG.integers(-1000, 1000, 2048))
    got = tbits.log2approx(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), np_log2(x).view(np.uint64))
    lf = RNG.integers(-(1 << 20), 1 << 20, 2048).astype(np.float64) * 2.0 ** -12
    got = tbits.pow2approx(torch.from_numpy(lf)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), np_pow2(lf).view(np.uint64))


def test_pow2approx_truncates_toward_zero_like_reference():
    """`astype(int)` in the reference is a C cast (toward zero), so biased
    values in (-1, 0) and (0, 1) both give exponent 0; the shift of a
    negative exponent wraps in 32 bits."""
    lf = np.array([-127.5, -127.0, -126.75, -128.25, -200.0, 0.0, 127.5],
                  np.float32)
    got = tbits.pow2approx(torch.from_numpy(lf)).numpy()
    want = np.asarray(jbits.pow2approx(jnp.asarray(lf)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), np_pow2(lf).view(np.uint32))

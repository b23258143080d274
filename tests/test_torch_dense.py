"""The port's dense-layout quantize/dequantize (`repro_torch.kernels.dense`,
re-exported by `kernels.ops`) against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain torch version, and only because the
tensor it was given lies on the CPU.  Here those plain versions are held
bit for bit, on every plane and every decoded float, against
`repro.kernels.ops` and `repro.kernels.dequantize.dequantize_rel_pallas`
in interpret mode, on the same numpy inputs.  The kernel-vs-plain tests
need the card and live in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import QuantizerConfig as JCfg
from repro.core.bitops import float_to_bits as j_float_to_bits
from repro.kernels import dequantize as JDQ
from repro.kernels import ops as JO
from repro_torch.core.bitops import float_to_bits
from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import dense as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

RNG = np.random.default_rng(1307)
SHAPES = [(1,), (4096,), (65537,), (128, 128), (3, 5, 7)]
LANES = 128


def _mix(shape):
    """Normal values and the special values of tests/test_packed_codec.py:
    NaN (and a NaN payload), +-inf, +-0, a denormal, the largest float32,
    a value near a bin border."""
    x = (RNG.standard_normal(shape) * 10).astype(np.float32)
    flat = x.reshape(-1)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
                         np.finfo(np.float32).max, 5e-4, -1e-42,
                         np.uint32(0x7FC00123).view(np.float32)], np.float32)
    m = min(flat.size, specials.size)
    flat[:m] = specials[:m]
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _same(jax_planes, torch_planes):
    assert len(jax_planes) == len(torch_planes)
    for a, t in zip(jax_planes, torch_planes):
        a, t = np.asarray(a), t.numpy()
        assert a.shape == t.shape and a.dtype == t.dtype
        np.testing.assert_array_equal(_bits(a), _bits(t))


@pytest.mark.parametrize("eb", [1e-2, 1e-5])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_abs_matches_pallas(shape, eb):
    x = _mix(shape)
    k = JO.quantize_abs(jnp.asarray(x), JCfg(mode="abs", error_bound=eb),
                        interpret=True)
    cfg = TCfg(mode="abs", error_bound=eb)
    t = TO.quantize_abs(torch.from_numpy(x), cfg)
    assert t.sign is None
    _same(k[:3], t[:3])
    _same(TR.quantize_abs_ref(torch.from_numpy(x), cfg), t[:3])


@pytest.mark.parametrize("eb", [1e-2, 1e-5])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_rel_matches_pallas(shape, eb):
    x = _mix(shape)
    k = JO.quantize_rel(jnp.asarray(x),
                        JCfg(mode="rel", error_bound=eb, bin_bits=32),
                        interpret=True)
    cfg = TCfg(mode="rel", error_bound=eb, bin_bits=32)
    t = TO.quantize_rel(torch.from_numpy(x), cfg)
    _same(k, t)
    _same(TR.quantize_rel_ref(torch.from_numpy(x), cfg), t)


@pytest.mark.parametrize("shape", [(4096,), (65537,), (128, 128)])
def test_quantize_abs_traced_eb_matches_pallas(shape):
    """A per-tensor bound given as a 0-d tensor (the reference's traced
    scalar) overrides the config bound."""
    x = _mix(shape)
    eb = np.float32(3.7e-3)
    k = JO.quantize_abs(jnp.asarray(x), JCfg(mode="abs", error_bound=1.0),
                        eb=jnp.float32(eb), interpret=True)
    t = TD.quantize_abs(torch.from_numpy(x), TCfg(mode="abs", error_bound=1.0),
                        eb=torch.tensor(eb))
    _same(k[:3], t[:3])
    t_float = TD.quantize_abs(torch.from_numpy(x),
                              TCfg(mode="abs", error_bound=1.0), eb=float(eb))
    _same(k[:3], t_float[:3])


@pytest.mark.parametrize("eb", [0.0, float("nan"), 2.0 ** -125])
def test_quantize_abs_degenerate_eb_matches_pallas(eb):
    """A bound below the denormal-safe floor (or NaN) sends every value to
    the outliers, in both packages."""
    x = _mix((2048,))
    k = JO.quantize_abs(jnp.asarray(x), JCfg(mode="abs", error_bound=1.0),
                        eb=jnp.float32(eb), interpret=True)
    t = TD.quantize_abs(torch.from_numpy(x), TCfg(mode="abs", error_bound=1.0),
                        eb=torch.tensor(eb, dtype=torch.float32))
    _same(k[:3], t[:3])
    assert bool(t.outlier.all())


@pytest.mark.parametrize("eb", [1e-2, 1e-5])
@pytest.mark.parametrize("shape", [(1,), (4096,), (65537,), (3, 5, 7)])
def test_dequantize_abs_matches_pallas(shape, eb):
    """Quantize, carry the outliers' exact bits as the payload, dequantize:
    every decoded float bit-equal, and the bound held in float64."""
    x = _mix(shape)
    cfg = TCfg(mode="abs", error_bound=eb)
    jcfg = JCfg(mode="abs", error_bound=eb)
    t = TD.quantize_abs(torch.from_numpy(x), cfg)
    payload = torch.where(t.outlier, float_to_bits(torch.from_numpy(x)),
                          torch.zeros((), dtype=torch.int32))
    y = TO.dequantize_abs(t.bins, payload, t.outlier, cfg)
    jq = JO.quantize_abs(jnp.asarray(x), jcfg, interpret=True)
    jpay = jnp.where(jq.outlier, j_float_to_bits(jnp.asarray(x)), 0)
    jy = JO.dequantize_abs(jq.bins, jpay, jq.outlier, jcfg, interpret=True)
    _same([jpay.astype(jnp.int32), jy], [payload, y])
    _same([TR.dequantize_abs_ref(t.bins, payload, t.outlier, cfg)], [y])
    xs, ys = x.reshape(-1), y.numpy().reshape(-1)
    fin = np.isfinite(xs)
    assert np.all(np.abs(xs[fin].astype(np.float64) - ys[fin]) <= eb)
    np.testing.assert_array_equal(xs[~fin].view(np.uint32),
                                  ys[~fin].view(np.uint32))


def test_dequantize_abs_traced_eb_matches_pallas():
    x = _mix((5000,))
    eb = np.float32(2.5e-3)
    cfg, jcfg = TCfg(mode="abs", error_bound=1.0), JCfg(mode="abs",
                                                        error_bound=1.0)
    t = TD.quantize_abs(torch.from_numpy(x), cfg, eb=torch.tensor(eb))
    payload = torch.where(t.outlier, float_to_bits(torch.from_numpy(x)),
                          torch.zeros((), dtype=torch.int32))
    y = TD.dequantize_abs(t.bins, payload, t.outlier, cfg, eb=torch.tensor(eb))
    jy = JO.dequantize_abs(jnp.asarray(t.bins.numpy()),
                           jnp.asarray(payload.numpy()),
                           jnp.asarray(t.outlier.numpy()), jcfg,
                           eb=jnp.float32(eb), interpret=True)
    _same([jy], [y])


def _tile(a, pad):
    """The reference ops' layout: flat, padded to whole [256, 128] blocks."""
    flat = a.reshape(-1)
    block = 256 * LANES
    return np.concatenate([flat, np.full((-flat.size) % block, pad,
                                         flat.dtype)]).reshape(-1, LANES)


@pytest.mark.parametrize("eb", [1e-2, 1e-5])
@pytest.mark.parametrize("shape", [(1,), (4096,), (65537,), (128, 128)])
def test_dequantize_rel_matches_pallas(shape, eb):
    x = _mix(shape)
    cfg = TCfg(mode="rel", error_bound=eb, bin_bits=32)
    t = TD.quantize_rel(torch.from_numpy(x), cfg)
    payload = torch.where(t.outlier, float_to_bits(torch.from_numpy(x)),
                          torch.zeros((), dtype=torch.int32))
    y = TD.dequantize_rel(t.bins, payload, t.outlier, t.sign, cfg)
    n = x.size
    jy = JDQ.dequantize_rel_pallas(
        jnp.asarray(_tile(t.bins.numpy(), 0)),
        jnp.asarray(_tile(payload.numpy(), 0)),
        jnp.asarray(_tile(t.outlier.numpy(), False)),
        jnp.asarray(_tile(t.sign.numpy(), False)),
        cfg=JCfg(mode="rel", error_bound=eb, bin_bits=32), dtype=jnp.float32,
        interpret=True)
    _same([np.asarray(jy).reshape(-1)[:n].reshape(shape)], [y])
    _same([TR.dequantize_rel_ref(t.bins, payload, t.outlier, t.sign, cfg)],
          [y])
    xs, ys = x.reshape(-1).astype(np.float64), y.numpy().reshape(-1)
    fin = np.isfinite(xs)
    assert np.all(np.abs(xs[fin] - ys[fin]) <= eb * np.abs(xs[fin]))
    np.testing.assert_array_equal(x.reshape(-1)[~fin].view(np.uint32),
                                  ys[~fin].view(np.uint32))


def test_dense_wrappers_refuse_other_types():
    cfg = TCfg(mode="abs", error_bound=1e-3)
    with pytest.raises(NotImplementedError, match="float32"):
        TD.quantize_abs(torch.zeros(8, dtype=torch.float64), cfg)
    with pytest.raises(NotImplementedError, match="float32"):
        TD.quantize_rel(torch.zeros(8, dtype=torch.float16),
                        TCfg(mode="rel", error_bound=1e-3))
    bins = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        TD.dequantize_abs(bins.to(torch.int64), bins, bins.bool(), cfg)
    with pytest.raises(ValueError, match="shape"):
        TD.dequantize_abs(bins, bins[:4], bins.bool(), cfg)
    assert TO.quantize_abs is TD.quantize_abs
    assert set(TO.__all__) == {"quantize_abs", "quantize_rel",
                               "dequantize_abs"}

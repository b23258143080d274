"""The port's mode dispatch, the paper's two baselines and the dense and
compact codecs (`repro_torch.core.quantizer` / `core.codec`) against the
JAX package's `repro.core`, bit for bit on every plane.

On the CPU the float32 codecs go through `kernels.dense`'s plain versions
(the CUDA tensors' route is B8-B11, held against the same plain versions in
tests/test_torch_cuda.py); float64 goes through the torch quantizers, held
against the reference under `jax_enable_x64`.  Planes are compared as
uint32 (uint64) views.  The float32 sweep takes the five exponent-boundary
slabs of benchmarks/exhaustive_sweep.py and two slabs chosen by its crc32
registry, 2**20 bit patterns each, and checks every value in float64 as
its `verify_slab` does.  `quantize_rel_library` calls the backend's
log2/exp2 and is held to the bound only (ROADMAP C-port-8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.datasets import _rng
from repro import core as J
from repro.core import codec as JC
from repro_torch import core as T
from repro_torch.core import codec as TC

RNG = np.random.default_rng(2101)
SLAB = 1 << 20
BOUNDARY_SLABS = (0, 0x7F000000, 0x7F800000, 0x80000000, 0xFF000000)
# the first two slabs of exhaustive_sweep.py's --smoke draw
CRC_SLABS = tuple(int(i) * SLAB for i in _rng("sweep").choice(
    (1 << 32) // SLAB, size=4, replace=False)[:2])
SPECIALS = np.array([np.inf, -np.inf, np.nan,
                     np.uint32(0x7FC00123).view(np.float32),
                     1e-42, -1e-42, 0.0, -0.0], np.float32)
# C-port-8: XLA's CPU log2 and torch's differ in the last bit here
C_PORT_8 = (0x08000B13, -113663, -113664)


def _bits(a: np.ndarray) -> np.ndarray:
    """32- and 64-bit planes as unsigned bit views; bool, int8 and int16
    planes as they are."""
    return a.view({4: np.uint32, 8: np.uint64}.get(a.dtype.itemsize, a.dtype))


def _same(t, j) -> None:
    if t is None or j is None:
        assert t is None and j is None
        return
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.dtype.itemsize == j.dtype.itemsize, (t.dtype, j.dtype)
    np.testing.assert_array_equal(_bits(t), _bits(j))


def _same_eb(t, j) -> None:
    """The traced NOA bound, bit for bit, except where it is a denormal:
    XLA's CPU build flushes eps * range to 0 there and torch keeps it
    (ROADMAP C-port-1).  Both are below the eb floor, so both send the
    whole tensor lossless and every other plane agrees."""
    if t is not None and j is not None:
        tv = np.asarray(t.numpy())
        if tv != 0 and abs(float(tv)) < np.finfo(tv.dtype).tiny:
            assert float(np.asarray(j)) == 0.0
            return
    _same(t, j)


def _mix(n: int) -> np.ndarray:
    """Normal values with the special values and denormals striped in."""
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    x[: 8 * (n // 64): 8] = np.resize(SPECIALS, n // 64)
    x[3::97] = np.float32(5e-4)
    return x


def _special_sweep(n: int = 4096) -> np.ndarray:
    """tests/test_packed_codec.py's special-value suite: random bit patterns
    with inf/NaN/payload/denormal/zero stripes."""
    x = RNG.integers(0, 1 << 32, n, dtype=np.uint32).view(np.float32).copy()
    for i, v in enumerate(SPECIALS):
        x[i::64] = v
    return x


def _denormals(n: int = 4096) -> np.ndarray:
    """Every denormal class: positive and negative, up to the smallest
    normal, and the normals around it."""
    bits = RNG.integers(0, 1 << 23, n, dtype=np.uint32)
    bits[1::2] |= np.uint32(0x80000000)
    bits[::7] = np.uint32(0x00800000) + np.arange(len(bits[::7]),
                                                  dtype=np.uint32)
    return bits.view(np.float32)


INPUTS = {"mix": lambda: _mix(3001), "specials": _special_sweep,
          "denormals": _denormals,
          "lognormal": lambda: np.exp(RNG.standard_normal(2048) * 1.4
                                      + 8.0).astype(np.float32)}
MODES = {"abs": 1e-2, "rel": 1e-2, "noa": 1e-3}


def _cfgs(**kw):
    return T.QuantizerConfig(**kw), J.QuantizerConfig(**kw)


_JIT = {}


def _jitted(name, fn, jcfg):
    """One jit of the reference per function and config (and so per shape
    of its input)."""
    key = (name, jcfg)
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda v: fn(v, jcfg))
    return _JIT[key]


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantize_dispatch_matches_reference(mode, inp):
    x = INPUTS[inp]()
    tc, jc = _cfgs(mode=mode, error_bound=MODES[mode])
    (tq, teb) = T.quantize(torch.from_numpy(x), tc)
    (jq, jeb) = J.quantize(jnp.asarray(x), jc)
    for t, j in zip(tq, jq):
        _same(t, j)
    _same_eb(teb, jeb)


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("bin_bits", [8, 16, 32])
def test_quantize_abs_unprotected_matches_reference(bin_bits, inp):
    x = INPUTS[inp]()
    tc, jc = _cfgs(mode="abs", error_bound=1e-2, bin_bits=bin_bits)
    t = T.quantize_abs_unprotected(torch.from_numpy(x), tc)
    j = J.quantize_abs_unprotected(jnp.asarray(x), jc)
    for a, b in zip(t, j):
        _same(a, b)


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("bin_bits", [8, 16, 32])
def test_dense_and_compact_codecs_match_reference(bin_bits, mode, inp):
    x = INPUTS[inp]()
    tc, jc = _cfgs(mode=mode, error_bound=MODES[mode], bin_bits=bin_bits,
                   outlier_cap_frac=0.25)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    td, jd = T.encode_dense(xt, tc), J.encode_dense(xj, jc)
    for t, j in zip(td[:4], jd[:4]):
        _same(t, j)
    _same_eb(td.eb, jd.eb)
    y = T.decode_dense(td, tc, shape=(x.size,))
    _same(y, J.decode_dense(jd, jc, shape=(x.size,)))
    _same(T.roundtrip_dense(xt, tc), J.roundtrip_dense(xj, jc))

    tk, jk = T.encode_compact(xt, tc), J.encode_compact(xj, jc)
    for t, j in zip(tk[:6], jk[:6]):
        _same(t, j)
    _same_eb(tk.eb, jk.eb)
    assert tk.wire_bits(tc) == jk.wire_bits(jc)
    yc = T.decode_compact(tk, tc)
    _same(yc, J.decode_compact(jk, jc))
    if not bool(tk.overflow):  # else the outliers past the cap decode as 0
        _same(yc, y)


def test_dense_codec_keeps_shape_and_traced_eb():
    x = _mix(3 * 5 * 64).reshape(3, 5, 64)
    tc, jc = _cfgs(mode="abs", error_bound=1e-3, bin_bits=16)
    for eb in (2.5e-3, np.float32(7e-4)):
        teb = eb if isinstance(eb, float) else torch.tensor(eb)
        t = T.encode_dense(torch.from_numpy(x), tc, eb=teb)
        j = J.encode_dense(jnp.asarray(x), jc, eb=eb)
        for a, b in zip(t, j):
            _same(a, b)
        _same(T.decode_dense(t, tc, shape=x.shape),
              J.decode_dense(j, jc, shape=x.shape))
        _same(T.decode_compact(T.encode_compact(torch.from_numpy(x), tc,
                                                eb=teb), tc, shape=x.shape),
              J.decode_compact(J.encode_compact(jnp.asarray(x), jc, eb=eb),
                               jc, shape=x.shape))
    assert T.roundtrip_dense(torch.from_numpy(x), tc).shape == x.shape


def test_compact_codec_overflow_detected():
    """tests/test_core_quantizer.py's case: 1000 NaNs at a cap of 1."""
    tc, jc = _cfgs(mode="abs", error_bound=1e-3, outlier_cap_frac=0.001)
    x = np.full(1000, np.nan, np.float32)
    t = T.encode_compact(torch.from_numpy(x), tc)
    j = J.encode_compact(jnp.asarray(x), jc)
    assert bool(t.overflow) and bool(j.overflow)
    for a, b in zip(t, j):
        _same(a, b)
    _same(T.decode_compact(t, tc), J.decode_compact(j, jc))


def _verify_slab(x: np.ndarray, y: np.ndarray, cfg) -> int:
    """benchmarks/exhaustive_sweep.py's `verify_slab`: the bound in float64
    on finite values (REL: non-zero), zeros and non-finite values
    bit-identical.  Returns the number of violations."""
    fin = np.isfinite(x)
    if cfg.mode == "abs":
        bad = int(np.sum(np.abs(x[fin].astype(np.float64)
                                - y[fin].astype(np.float64))
                         > cfg.error_bound))
    else:
        m = fin & (x != 0)
        xv = x[m].astype(np.float64)
        bad = int(np.sum(np.abs(xv - y[m].astype(np.float64)) / np.abs(xv)
                         > cfg.error_bound))
        z = fin & (x == 0)
        bad += int(np.sum(x[z].view(np.uint32) != y[z].view(np.uint32)))
    bad += int(np.sum(x[~fin].view(np.uint32) != y[~fin].view(np.uint32)))
    return bad


@pytest.mark.parametrize("start", BOUNDARY_SLABS + CRC_SLABS,
                         ids=lambda s: f"{s:#010x}")
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_float32_slab_sweep(mode, start):
    bits = np.arange(start, start + SLAB, dtype=np.int64).astype(np.uint32)
    x = bits.view(np.float32)
    tc, jc = _cfgs(mode=mode, error_bound=1e-3, bin_bits=32)
    y = T.roundtrip_dense(torch.from_numpy(x), tc).numpy()
    want = np.asarray(_jitted("roundtrip", J.roundtrip_dense, jc)(
        jnp.asarray(x)))
    np.testing.assert_array_equal(y.view(np.uint32), want.view(np.uint32))
    assert _verify_slab(x, y, tc) == 0


@pytest.mark.parametrize("mode,eb", [("abs", 1e-9), ("rel", 1e-6),
                                     ("noa", 1e-7)])
def test_float64_dense_codec_matches_reference(mode, eb):
    x = RNG.standard_normal(2048)
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1e300, -2.5]
    tc, jc = _cfgs(mode=mode, error_bound=eb, dtype="float64", bin_bits=32,
                   outlier_cap_frac=0.1)
    xt = torch.from_numpy(x)
    jax.config.update("jax_enable_x64", True)
    try:
        xj = jnp.asarray(x, jnp.float64)
        td, jd = T.encode_dense(xt, tc), J.encode_dense(xj, jc)
        for a, b in zip(td, jd):
            _same(a, b)
        y = T.roundtrip_dense(xt, tc)
        _same(y, J.roundtrip_dense(xj, jc))
        tk, jk = T.encode_compact(xt, tc), J.encode_compact(xj, jc)
        for a, b in zip(tk, jk):
            _same(a, b)
        assert tk.wire_bits(tc) == jk.wire_bits(jc)
        _same(T.decode_compact(tk, tc), J.decode_compact(jk, jc))
    finally:
        jax.config.update("jax_enable_x64", False)
    y = y.numpy()
    m = np.isfinite(x) & (x != 0)
    bound = {"abs": eb, "noa": float(td.eb) if td.eb is not None else 0.0,
             "rel": eb * np.abs(x[m])}[mode]
    assert np.all(np.abs(x[m] - y[m]) <= bound)
    exact = ~np.isfinite(x) | ((x == 0) if mode == "rel" else False)
    assert np.array_equal(x[exact].view(np.uint64), y[exact].view(np.uint64))


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("eb", [1e-3, 1e-2])
def test_quantize_rel_library_meets_the_bound(eb, inp):
    """Bound only: the bins may differ from the reference's in the last
    bit of log2 (C-port-8), but every non-outlier decodes within eb|x| and
    the outlier set is the same kind of set (non-finite, screened, or
    failed the check)."""
    x = INPUTS[inp]()
    tc = T.QuantizerConfig(mode="rel", error_bound=eb, bin_bits=32)
    t = T.quantize_rel_library(torch.from_numpy(x), tc)
    ok = ~t.outlier.numpy()
    xv = x[ok].astype(np.float64)
    r = t.recon.numpy()[ok].astype(np.float64)
    assert np.all(np.abs(xv - r) <= eb * np.abs(xv))
    assert np.all(np.isfinite(x[ok]))
    assert np.array_equal(t.sign.numpy(), x.view(np.int32) < 0)
    assert np.all(t.bins.numpy()[~ok] == 0)
    assert np.all(t.recon.numpy()[~ok] == 0)


def test_quantize_rel_library_c_port_8():
    """C-port-8 pinned: at 0x08000B13 (3.853e-34), REL 1e-3 with 32-bit
    bins, XLA's CPU log2 gives -110.99950408935547 and torch's CPU log2
    -110.99951171875 (one ulp apart), so the reference's bin is -113663
    and the port's -113664.  Both meet the bound."""
    bits, want_ref, want_port = C_PORT_8
    x = (bits + np.arange(16)).astype(np.uint32).view(np.float32)
    tc, jc = _cfgs(mode="rel", error_bound=1e-3, bin_bits=32)
    t = T.quantize_rel_library(torch.from_numpy(x), tc)
    j = J.quantize_rel_library(jnp.asarray(x), jc)
    assert int(np.asarray(j.bins)[0]) == want_ref
    assert int(t.bins[0]) == want_port
    assert not bool(t.outlier[0]) and not bool(np.asarray(j.outlier)[0])
    for r in (t.recon.numpy(), np.asarray(j.recon)):
        assert abs(float(x[0]) - float(r[0])) <= 1e-3 * abs(float(x[0]))
    # the bit-trick REL has no such difference: it is the parity-safe one
    _same(T.quantize_rel(torch.from_numpy(x), tc).bins,
          J.quantize_rel(jnp.asarray(x), jc).bins)


# the names of repro.core.__all__ the port does not have, and why
PORT_LACKS: dict = {}


def test_core_exports_match_reference():
    missing = set(J.__all__) - set(T.__all__)
    assert missing == set(PORT_LACKS), sorted(missing)
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.EncodedCompact.wire_bits.__doc__
    assert TC.EncodedDense._fields == JC.EncodedDense._fields
    assert TC.EncodedCompact._fields == JC.EncodedCompact._fields


def test_float64_packed_wire_raises():
    """C-port-2: float64 takes the dense and compact codecs, not the
    packed wire."""
    cfg = T.QuantizerConfig(mode="abs", error_bound=1e-9, dtype="float64")
    with pytest.raises(NotImplementedError, match="C-port-2"):
        T.encode_packed(torch.zeros(256, dtype=torch.float64), cfg)

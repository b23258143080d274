"""Port parity: `repro_torch.core.quantizer` against the JAX package's
`repro.core.quantizer` and the numpy oracle, bit for bit (no tolerance).

Inputs are made with numpy from fixed seeds, including the special-value
sweep of tests/test_packed_codec.py and the paper's special-value suite.
Every plane (bins, outlier, recon, sign, the NOA eb) is compared as uint32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quantizer as jq
from repro.core.config import QuantizerConfig as JCfg
from repro_torch.core import oracle_np as tor
from repro_torch.core import quantizer as tq
from repro_torch.core.config import QuantizerConfig as TCfg

RNG = np.random.default_rng(1102)


def _mix(n):
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.finfo(np.float32).max, 5e-4]
    return x


def _specials(n=4096):
    """The paper's special-value suite (benchmarks/datasets.special_values):
    random bit patterns with INF/NaN/payload/denormal/zero stripes."""
    x = RNG.integers(0, 1 << 32, n, dtype=np.uint32).view(np.float32).copy()
    for i, v in enumerate([np.inf, -np.inf, np.nan,
                           np.uint32(0x7FC00123).view(np.float32),
                           1e-42, -1e-42, 0.0, -0.0]):
        x[i::64] = v
    return x


def _lognormal(n):
    return np.exp(RNG.standard_normal(n) * 1.4 + 8.0).astype(np.float32)


INPUTS = {"mix": _mix, "specials": _specials, "lognormal": _lognormal,
          "small": lambda n: (RNG.standard_normal(n) * 1e-3).astype(np.float32)}


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _assert_planes(t_planes, j_planes):
    for t, j in zip(t_planes, j_planes):
        if t is None or j is None:
            assert t is None and j is None
            continue
        np.testing.assert_array_equal(_u32(t.numpy()), _u32(j))


def _cfgs(**kw):
    return TCfg(**kw), JCfg(**kw)


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("bin_bits", [8, 16, 32])
def test_quantize_abs_static_matches_reference(bin_bits, inp):
    x = INPUTS[inp](3001)
    tc, jc = _cfgs(mode="abs", error_bound=1e-2, bin_bits=bin_bits)
    t = tq.quantize_abs(torch.from_numpy(x), tc)
    _assert_planes(t[:3], jq.quantize_abs(jnp.asarray(x), jc)[:3])
    _assert_planes(t[:3], tor.quantize_abs(x, tc))
    y = tq.dequantize_abs(t.bins, tc).numpy()
    np.testing.assert_array_equal(
        _u32(y), _u32(jq.dequantize_abs(jnp.asarray(t.bins.numpy()), jc)))


@pytest.mark.parametrize("eb", [2.5e-3, "tensor", 2.0 ** -125, float("nan"),
                                float("inf"), 0.0, -1.0])
def test_quantize_abs_traced_matches_reference(eb):
    """Per-tensor bound (float or 0-d tensor), with the degenerate guard:
    below the floor, NaN, zero or negative sends the whole tensor lossless."""
    x = _mix(2049)
    tc, jc = _cfgs(mode="abs", error_bound=1.0, bin_bits=16)
    if eb == "tensor":
        t_eb, j_eb = torch.tensor(7.5e-4), jnp.asarray(np.float32(7.5e-4))
    else:
        t_eb, j_eb = eb, eb
    t = tq.quantize_abs(torch.from_numpy(x), tc, eb=t_eb)
    _assert_planes(t[:3], jq.quantize_abs(jnp.asarray(x), jc, eb=j_eb)[:3])
    _assert_planes(t[:3], tor.quantize_abs(x, tc, eb=np.float32(j_eb)))
    y = tq.dequantize_abs(t.bins, tc, eb=t_eb).numpy()
    np.testing.assert_array_equal(
        _u32(y), _u32(jq.dequantize_abs(jnp.asarray(t.bins.numpy()), jc, eb=j_eb)))
    if not (np.float32(j_eb) >= np.float32(2.0 ** -120)):
        assert bool(t.outlier.all())


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("bin_bits", [8, 16, 32])
def test_quantize_rel_matches_reference(bin_bits, inp):
    x = INPUTS[inp](3001)
    tc, jc = _cfgs(mode="rel", error_bound=1e-3, bin_bits=bin_bits)
    t = tq.quantize_rel(torch.from_numpy(x), tc)
    j = jq.quantize_rel(jnp.asarray(x), jc)
    _assert_planes(t, j)
    _assert_planes(t, tor.quantize_rel(x, tc))
    y = tq.dequantize_rel(t.bins, t.sign, tc).numpy()
    want = jq.dequantize_rel(jnp.asarray(t.bins.numpy()),
                             jnp.asarray(t.sign.numpy()), jc)
    np.testing.assert_array_equal(_u32(y), _u32(want))


@pytest.mark.parametrize("inp", ["mix", "lognormal", "small", "constant",
                                 "nonfinite"])
def test_quantize_noa_matches_reference(inp):
    """NOA's on-device eb (error_bound * finite range) and planes, including
    an infinite range (the mix holds float32 max), a zero range and an
    all-non-finite tensor (both degenerate: all outliers)."""
    gens = dict(INPUTS, constant=lambda n: np.full(n, 3.25, np.float32),
                nonfinite=lambda n: np.where(RNG.random(n) < 0.5, np.nan,
                                             np.inf).astype(np.float32))
    x = gens[inp](1500)
    tc, jc = _cfgs(mode="noa", error_bound=1e-3, bin_bits=16)
    t, t_eb = tq.quantize_noa(torch.from_numpy(x), tc)
    j, j_eb = jq.quantize_noa(jnp.asarray(x), jc)
    _assert_planes(t[:3], j[:3])
    assert _u32(t_eb.numpy()) == _u32(np.asarray(j_eb))
    o_bins, o_out, o_rec, o_eb = tor.quantize_noa(x, tc)
    _assert_planes(t[:3], (o_bins, o_out, o_rec))
    if np.isfinite(x).any():   # the oracle reports eb=0, not -inf, otherwise
        assert _u32(t_eb.numpy()) == _u32(np.float32(o_eb))


def _ties(n=256):
    """Values exactly half-way between two bins, where round-half-to-even
    (jnp.rint, torch.round, CUDA rintf) and round-half-away differ: ABS
    ties for eb2 = 2**-6 (eb = 1e-2) and REL ties in the log2approx domain
    for log_step = 2**-10 (eb = 1e-3)."""
    k = np.arange(-n // 2, n // 2)
    abs_ties = (k + 0.5) * 2.0 ** -6
    rel_ties = np.ldexp(1.0 + (np.abs(k) % 1000 + 0.5) * 2.0 ** -10, k % 40 - 20)
    return np.concatenate([abs_ties, rel_ties * np.sign(k + 0.5)]).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["abs", "rel", "traced"])
def test_round_half_to_even_matches_reference(mode):
    x = _ties()
    eb = 1e-3 if mode == "rel" else 1e-2
    tc, jc = _cfgs(mode="rel" if mode == "rel" else "abs", error_bound=eb,
                   bin_bits=16)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if mode == "rel":
        t, j = tq.quantize_rel(xt, tc), jq.quantize_rel(xj, jc)
    elif mode == "abs":
        t, j = tq.quantize_abs(xt, tc), jq.quantize_abs(xj, jc)
    else:
        t, j = tq.quantize_abs(xt, tc, eb=0.01), jq.quantize_abs(xj, jc, eb=0.01)
    _assert_planes(t[:3], j[:3])
    assert (t.bins.numpy()[~t.outlier.numpy()] % 2 == 0).sum() > x.size // 4


def test_quantizers_hold_the_bound():
    """Every non-outlier is within eb (REL: eb*|x|) of its original."""
    x = _lognormal(4096)
    for mode in ("abs", "rel", "noa"):
        tc = TCfg(mode=mode, error_bound=1e-3, bin_bits=32)
        xt = torch.from_numpy(x)
        if mode == "noa":
            qt, eb = tq.quantize_noa(xt, tc)
        else:
            fn = tq.quantize_abs if mode == "abs" else tq.quantize_rel
            qt, eb = fn(xt, tc), None
        keep = ~qt.outlier.numpy()
        assert keep.any()
        err = np.abs(x.astype(np.float64) - qt.recon.numpy().astype(np.float64))
        lim = (np.float64(np.float32(1e-3)) * np.abs(x.astype(np.float64))
               if mode == "rel" else
               np.float64(np.float32(1e-3) if eb is None else eb.item()))
        assert np.all(err[keep] <= np.broadcast_to(lim, x.shape)[keep])


def test_float64_quantizers_match_numpy_oracle():
    """float64 has no JAX twin with x64 off; the numpy oracle stands in."""
    x = np.concatenate([RNG.standard_normal(1000) * 10,
                        [np.nan, np.inf, -0.0, 1e-310, 5e-300]])
    for mode in ("abs", "rel"):
        tc = TCfg(mode=mode, error_bound=1e-6, bin_bits=32, dtype="float64")
        t = (tq.quantize_abs if mode == "abs" else tq.quantize_rel)(
            torch.from_numpy(x), tc)
        o = (tor.quantize_abs if mode == "abs" else tor.quantize_rel)(x, tc)
        for a, b in zip(t, o):
            np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                          np.asarray(b).view(np.uint8))


def test_denormal_step_differs_from_flushing_reference():
    """ROADMAP C-port-1: with a traced eb >= 2**126, 1/eb2 = 2**-127 is a
    denormal.  The reference's XLA backend flushes it to zero, so every value
    bins to 0 there; torch keeps it, so values near the float32 maximum get
    bin 1.  Both wires hold the bound; they differ in which values are
    outliers."""
    x = np.array([1.5e38, -1.5e38, 1.0, 3.0e38], np.float32)
    eb = np.float32(2.0 ** 126)
    tc, jc = _cfgs(mode="abs", error_bound=1.0, bin_bits=8)
    t = tq.quantize_abs(torch.from_numpy(x), tc, eb=float(eb))
    j = jq.quantize_abs(jnp.asarray(x), jc, eb=eb)
    assert t.bins.tolist() == [1, -1, 0, 0]
    assert np.asarray(j.bins).tolist() == [0, 0, 0, 0]
    assert t.outlier.tolist() == [False, False, False, True]
    assert np.asarray(j.outlier).tolist() == [True, True, False, True]
    for planes in (t, j):
        keep = ~np.asarray(planes.outlier)
        err = np.abs(x[keep].astype(np.float64)
                     - np.asarray(planes.recon)[keep].astype(np.float64))
        assert np.all(err <= np.float64(eb))


def _zero_log_step_input(spec):
    if spec.startswith("rel:1e-16"):
        x = (RNG.standard_normal(70) * 3).astype(np.float32)
        x[::9] = 1.0
        x[4::9] = -1.0
        return x
    return np.array([1.0] * 60 + [-1.0] * 3 + [2.0], np.float32)


@pytest.mark.parametrize("spec", ["rel:1e-30|pack:8", "rel:1e-30|pack:16",
                                  "rel:1e-30|pack:32",
                                  "rel:1e-30|pack:16|narrow",
                                  "rel:1e-16|pack:16"])
def test_rel_zero_log_step_matches_reference(spec):
    """ROADMAP C-port-4: at a zero log step (eb below ~1.1e-16) x = +-1
    gives rint(0 * inf) = NaN before the int32 cast, which XLA (and CUDA)
    cast to 0, a bin that decodes +-1 exactly.  The plain quantize_rel maps
    NaN to 0 the same way, so every plane of the CPU path is the
    reference's.  The numpy oracle keeps INT32_MIN (an outlier), as the
    reference's oracle does."""
    from repro.core import pipeline as JP
    from repro_torch.core import pipeline as TP
    x = _zero_log_step_input(spec)
    t = TP.parse_pipeline(spec).encode(x, device="cpu")
    j = JP.parse_pipeline(spec).encode(jnp.asarray(x), kernels=False)
    for f in ("payload", "payload_len", "out_idx", "out_payload",
              "n_outliers", "overflow", "sign_words"):
        np.testing.assert_array_equal(
            getattr(t, f).numpy().view(np.uint32) if f != "overflow"
            else getattr(t, f).numpy(),
            np.asarray(getattr(j, f)).view(np.uint32) if f != "overflow"
            else np.asarray(getattr(j, f)), err_msg=f)
    for u, v in zip(t.headers, j.headers):
        np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                      np.asarray(v))
    cfg = TCfg(mode="rel", error_bound=float(spec.split("|")[0][4:]),
               bin_bits=16)
    ones = np.abs(x) == 1.0
    assert not tq.quantize_rel(torch.from_numpy(x), cfg).outlier.numpy()[ones].any()
    assert tor.quantize_rel(x, cfg)[1][ones].all()

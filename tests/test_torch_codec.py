"""Port parity: the packed wire (`repro_torch.core.codec`) and the fused
kernel entry points (`repro_torch.kernels.pack`, which take their plain
torch versions on the CPU) against the JAX package's `repro.core.codec`
and its Pallas kernels in interpret mode.

No tolerance: words, outlier table, sign plane, header scalars and every
decoded float are compared as uint32.  Word planes in the port are int32
tensors holding the uint32 bits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codec as JC
from repro.core.config import QuantizerConfig as JCfg
from repro.kernels import pack as JK
from repro_torch.core import codec as TC
from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import pack as TK

RNG = np.random.default_rng(1103)
FIELDS = ("words", "out_idx", "out_payload", "n_outliers", "overflow",
          "sign_words", "eb")


def _mix(n):
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    x[:min(n, 8)] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
                     np.finfo(np.float32).max, 5e-4][:min(n, 8)]
    return x


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _assert_wire(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(_u32(a.numpy()), _u32(b), err_msg=f)
    assert t.wire_bits() == j.wire_bits()


@pytest.mark.parametrize("n", [1, 12, 511, 4096, 65537])
@pytest.mark.parametrize("bits", [1, 8, 16, 32])
def test_pack_unpack_words_match_reference(bits, n):
    if bits == 1:
        vals = RNG.integers(0, 2, n).astype(np.int32)
    else:
        mx = (1 << (bits - 1)) - 1
        vals = RNG.integers(-mx + 1, mx, n).astype(np.int32)
    t = TC.pack_words(torch.from_numpy(vals), bits)
    j = JC.pack_words(jnp.asarray(vals), bits)
    assert t.dtype == torch.int32
    assert t.shape[0] == TC.packed_word_count(n, bits) == JC.packed_word_count(n, bits)
    np.testing.assert_array_equal(_u32(t.numpy()), _u32(j))
    signed = bits != 1
    back = TC.unpack_words(t, n, bits, signed=signed).numpy()
    np.testing.assert_array_equal(back, vals)
    want = JC.unpack_words(j, n, bits, signed=signed)
    np.testing.assert_array_equal(_u32(back), _u32(want))
    if bits == 1:
        flags = vals.astype(bool)
        tf = TC.pack_flags(torch.from_numpy(flags))
        np.testing.assert_array_equal(_u32(tf.numpy()),
                                      _u32(JC.pack_flags(jnp.asarray(flags))))
        np.testing.assert_array_equal(TC.unpack_flags(tf, n).numpy(), flags)


@pytest.mark.parametrize("n", [12, 4097])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_codec_encode_decode_match_reference(mode, bits, n):
    tc = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    jc = JCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    x = _mix(n)
    t = TC.encode_packed(torch.from_numpy(x), tc)
    j = JC.encode_packed(jnp.asarray(x), jc)
    _assert_wire(t, j)
    y = TC.decode_packed(t, tc, n=n).numpy()
    np.testing.assert_array_equal(_u32(y), _u32(JC.decode_packed(j, jc, n=n)))
    if not bool(t.overflow):          # n=12 holds 3 non-finite values, K=2
        nonfinite = ~np.isfinite(x)
        np.testing.assert_array_equal(_u32(y)[nonfinite], _u32(x)[nonfinite])


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_kernel_entry_matches_interpret_kernels(mode, bits):
    """`kernels.pack.encode_packed/decode_packed` (plain versions on the
    CPU) against the Pallas kernels in interpret mode, on a ragged size."""
    n = 4095
    tc = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    jc = JCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    x = _mix(n)
    before = dict(TK.LAUNCHES)
    t = TK.encode_packed(torch.from_numpy(x), tc)
    j = JK.encode_packed(jnp.asarray(x), jc, interpret=True)
    _assert_wire(t, j)
    y = TK.decode_packed(t, tc, n=n).numpy()
    want = JK.decode_packed(j, jc, n=n, interpret=True)
    np.testing.assert_array_equal(_u32(y), _u32(want))
    assert TK.LAUNCHES == before          # no kernel runs for a CPU tensor


def test_traced_eb_kernel_entry_matches_reference():
    """A per-tensor bound reaches the ABS kernel as a 1-element tensor."""
    n = 3000
    tc = TCfg(mode="abs", error_bound=1.0, bin_bits=8, outlier_cap_frac=1 / 64)
    jc = JCfg(mode="abs", error_bound=1.0, bin_bits=8, outlier_cap_frac=1 / 64)
    x = (RNG.standard_normal(n) * 3e-3).astype(np.float32)
    eb = np.float32(2.0 ** -5 * np.sqrt(np.mean(x.astype(np.float64) ** 2)))
    t = TK.encode_packed(torch.from_numpy(x), tc, eb=torch.tensor(eb))
    j = JK.encode_packed(jnp.asarray(x), jc, eb=jnp.asarray(eb), interpret=True)
    _assert_wire(t, j)
    _assert_wire(TC.encode_packed(torch.from_numpy(x), tc, eb=torch.tensor(eb)), j)
    assert not bool(t.overflow)
    y = TK.decode_packed(t, tc, n=n).numpy()
    keep = np.ones(n, bool)
    keep[t.out_idx.numpy()[t.out_idx.numpy() < n]] = False
    assert keep.any()
    assert np.all(np.abs(y[keep].astype(np.float64) - x[keep]) <= eb)


def test_overflow_and_cap_match_reference():
    tc = TCfg(mode="abs", error_bound=1e-3, bin_bits=8, outlier_cap_frac=1 / 256)
    jc = JCfg(mode="abs", error_bound=1e-3, bin_bits=8, outlier_cap_frac=1 / 256)
    x = np.full(1024, np.inf, np.float32)
    x[::7] = 0.25
    t = TC.encode_packed(torch.from_numpy(x), tc)
    _assert_wire(t, JC.encode_packed(jnp.asarray(x), jc))
    assert bool(t.overflow) and int(t.n_outliers) > tc.outlier_cap(1024)


def test_scatter_drops_empty_slots_and_keeps_last_index():
    """Fill slots (== n) and out-of-range slots drop; an outlier at the
    last index is restored (the PR 1 clamped-slot regression)."""
    n = 10
    buf = torch.arange(n + 1, dtype=torch.float32)
    vals = np.array([7.5, -1.25, 99.0, 42.0], np.float32)
    idx = torch.tensor([n - 1, 3, n, n + 5], dtype=torch.int32)
    got = TC.scatter_outliers_(buf, n, idx,
                               torch.from_numpy(vals.view(np.int32)))
    want = np.asarray(jnp.arange(n, dtype=jnp.float32).at[
        jnp.asarray(idx.numpy())].set(jnp.asarray(vals), mode="drop"))
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    assert got[n - 1].item() == 7.5 and got[3].item() == -1.25


def test_float64_is_not_on_the_packed_wire():
    tc = TCfg(mode="abs", error_bound=1e-3, dtype="float64")
    with pytest.raises(NotImplementedError, match="C-port-2"):
        TC.encode_packed(torch.zeros(8, dtype=torch.float64), tc)

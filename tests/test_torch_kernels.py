"""The four CUDA kernels of `repro_torch.kernels` (csrc/pack.cu) and their
wrappers.

On the CPU a wrapper takes its plain torch version, and only because the
tensor it was given lies on the CPU; those plain versions are held here
against the JAX package's Pallas kernels (interpret mode) bit for bit.  The
kernel-vs-plain tests need the card and live in tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.config import QuantizerConfig as JCfg
from repro.kernels import pack as JK
from repro_torch.core import codec as TC
from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import _build
from repro_torch.kernels import pack as TK

RNG = np.random.default_rng(1105)
CSRC = Path(TK.__file__).resolve().parent / "csrc"


def _mix(n):
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.uint32(0x7FC00123).view(np.float32), 5e-4]
    return x


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_plain_versions_match_pallas_kernels(mode, bits):
    """Each wrapper's plain version (what a CPU tensor gets) against the
    Pallas launcher it replaces, plane by plane, on a ragged size."""
    n = 5 * 4096 + 77
    tc = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    jc = JCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    x = _mix(n)
    rows = -(-n // (32 * 128)) * 32              # whole sign words
    x2d = jnp.pad(jnp.asarray(x), (0, rows * 128 - n)).reshape(rows, 128)
    nw = TC.packed_word_count(n, bits)
    eb = torch.tensor([np.float32(1e-2)])
    if mode == "abs":
        words, out = TK.abs_pack(torch.from_numpy(x), eb, tc)
        jw, jo = JK.quantize_pack_abs_pallas(
            x2d, jnp.full((1, 1), 1e-2, jnp.float32), maxbin=jc.maxbin,
            tighten=jc.tighten, eb_floor=jc.eb_floor, bin_bits=bits, rows=32)
        y = TK.abs_unpack(words, eb, n, tc)
        jy = JK.unpack_dequant_abs_pallas(
            jw, jnp.full((1, 1), 1e-2, jnp.float32), dtype=jnp.float32,
            eb_floor=jc.eb_floor, bin_bits=bits, rows=32)
    else:
        words, out, signs = TK.rel_pack(torch.from_numpy(x), tc)
        jw, jo, js = JK.quantize_pack_rel_pallas(x2d, cfg=jc, rows=32)
        np.testing.assert_array_equal(
            _u32(signs.numpy()), _u32(js).reshape(-1)[:TC.packed_word_count(n, 1)])
        y = TK.rel_unpack(words, signs, n, tc)
        jy = JK.unpack_dequant_rel_pallas(jw, js, cfg=jc, dtype=jnp.float32,
                                          rows=32)
    np.testing.assert_array_equal(_u32(words.numpy()),
                                  _u32(jw).reshape(-1)[:nw])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo).reshape(-1)[:n])
    np.testing.assert_array_equal(_u32(y.numpy()),
                                  _u32(jy).reshape(-1)[:n])


def test_wrappers_validate_operands():
    cfg = TCfg(mode="abs", error_bound=1e-3, bin_bits=16)
    x = torch.zeros(300)
    eb = torch.tensor([1e-3])
    with pytest.raises(TypeError):
        TK.abs_pack(x.double(), eb, cfg)
    with pytest.raises(ValueError):
        TK.abs_pack(torch.zeros(300, 2)[:, 0], eb, cfg)       # strided
    with pytest.raises(ValueError, match="words"):
        TK.abs_unpack(torch.zeros(7, dtype=torch.int32), eb, 300, cfg)
    words, _ = TK.abs_pack(x, eb, cfg)
    with pytest.raises(ValueError, match="out"):
        TK.abs_unpack(words, eb, 300, cfg, out=torch.empty(10))


def test_build_keeps_the_bit_exactness_rules():
    """The flags and sources keep the paper's rules: no contraction, no
    fast-math, round half to even, truncating casts, masked eb2.  The
    sources are csrc/pack.cu, csrc/lossless.cu and csrc/dense.cu, which
    share the quantizers through csrc/quantize.cuh (lossless.cu also
    includes the chunk placement of csrc/chunk.cuh), and
    csrc/kv_attention.cu."""
    flags = " ".join(_build.NVCC_FLAGS + _build.LINK_FLAGS)
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert {f.name for f in _build.SOURCES + _build.HEADERS} == {
        "pack.cu", "lossless.cu", "dense.cu", "kv_attention.cu",
        "quantize.cuh", "chunk.cuh"}
    assert sorted(CSRC.iterdir()) == sorted(_build.SOURCES + _build.HEADERS)
    src = "".join(f.read_text() for f in _build.SOURCES + _build.HEADERS)
    code = re.sub(r"//.*", "", src)
    assert "roundf" not in code and "__fmaf" not in code and "fmaf(" not in code
    assert "rintf" in code and "__float2int_rz" in code
    assert "0xFF800000u" in code
    for c_name in ("repro_abs_pack", "repro_rel_pack", "repro_abs_unpack",
                   "repro_rel_unpack", "repro_abs_pack_lc",
                   "repro_rel_pack_lc", "repro_lc_select", "repro_lc_expand",
                   "repro_dense_quantize_abs", "repro_dense_quantize_rel",
                   "repro_dense_dequantize_abs", "repro_dense_dequantize_rel",
                   "repro_kv_decode_attention"):
        assert f'extern "C" int {c_name}(' in src
        assert c_name in _build._SIGNATURES
    for kernel in ("_abs_pack_kernel", "_rel_pack_kernel",
                   "_abs_unpack_kernel", "_rel_unpack_kernel",
                   "_abs_pack_lc_kernel", "_rel_pack_lc_kernel",
                   "_lc_select_kernel", "_lc_expand_kernel",
                   "quantize_abs.py:32 _kernel", "quantize_rel.py:41 _kernel",
                   "dequantize.py:21 _abs_kernel",
                   "dequantize.py:35 _rel_kernel",
                   "kv_attention.py:39 _kernel"):
        assert f"replaces {kernel}" in src
    for f in _build.SOURCES:
        if f.name != "kv_attention.cu":        # no quantizer: held by tolerance
            assert '#include "quantize.cuh"' in f.read_text()
    assert '#include "chunk.cuh"' in (CSRC / "lossless.cu").read_text()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")

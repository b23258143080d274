"""Parity-safe transcendental replacements (the paper's §3.2), in torch.

Counterpart of `repro.core.bitops`.  log2approx/pow2approx use only
bitcasts (`Tensor.view`), integer ops and single IEEE add/sub, so every
backend (the JAX reference, torch on the CPU, the CUDA kernels) produces
identical bits.  Every quantization step is a power of two, so `bin * step`
is an exact exponent shift and no FMA contraction can change a result.

Integer planes are signed (int32 for float32, int64 for float64): torch on
the CPU has no shifts for its unsigned types.  `>>` on a signed tensor is
arithmetic, so every right shift here is masked.
"""
from __future__ import annotations

import torch

# dtype -> (int dtype, mantissa bits, exponent mask, exponent bias)
_FP_SPEC = {
    torch.float32: (torch.int32, 23, 0xFF, 127),
    torch.float64: (torch.int64, 52, 0x7FF, 1023),
}


def fp_spec(dtype):
    try:
        return _FP_SPEC[dtype]
    except KeyError:
        raise TypeError(
            f"unsupported float dtype for bit-level quantizer: {dtype}") from None


def pow2_floor(x: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= x (x positive, finite, normal), by clearing
    the mantissa bits."""
    int_t, mb, _, _ = fp_spec(x.dtype)
    bits = x.view(int_t)
    return (bits & ~((1 << mb) - 1)).view(x.dtype)


def log2approx(x: torch.Tensor) -> torch.Tensor:
    """The paper's log2approxf: exponent + (1.mantissa), exact on powers of
    two.  Callers pass |x|; sign/zero/denormal cases are the quantizer's."""
    int_t, mb, emask, bias = fp_spec(x.dtype)
    orig_i = x.view(int_t)
    expo = (orig_i >> mb) & emask
    frac_i = (orig_i & ((1 << mb) - 1)) | (bias << mb)
    frac_f = frac_i.view(x.dtype)
    return frac_f + (expo - (bias + 1)).to(x.dtype)


def pow2approx(log_f: torch.Tensor) -> torch.Tensor:
    """The paper's pow2approxf, the inverse of log2approx on its own range.
    log_f must be an exact product (bin * pow2 step); `.to(int)` truncates
    toward zero like the reference's C-style cast."""
    int_t, mb, _, bias = fp_spec(log_f.dtype)
    biased = log_f + bias
    expo = biased.to(int_t)
    frac_f = biased - (expo - 1).to(log_f.dtype)
    frac_i = frac_f.view(int_t)
    exp_i = _shl_wrap(expo, mb, int_t) | (frac_i & ((1 << mb) - 1))
    return exp_i.view(log_f.dtype)


def _shl_wrap(v: torch.Tensor, sh: int, int_t) -> torch.Tensor:
    """v << sh with two's-complement wraparound in int_t's width (the
    reference's shift semantics), computed without signed overflow."""
    width = 32 if int_t == torch.int32 else 64
    top_bit = 1 << (width - sh - 1)             # the bit that lands on the sign
    low = (v & (top_bit - 1)) << sh             # never reaches the sign bit
    return torch.where((v & top_bit) != 0, low | -(1 << (width - 1)), low)


def float_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact payload for the lossless outlier channel (NaN payloads,
    -0.0 and infinities survive)."""
    int_t, _, _, _ = fp_spec(x.dtype)
    return x.view(int_t)


def bits_to_float(bits: torch.Tensor, dtype) -> torch.Tensor:
    return bits.view(dtype)

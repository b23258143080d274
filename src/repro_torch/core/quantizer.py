"""Guaranteed-error-bound quantizers (the paper's core contribution), in torch.

Counterpart of `repro.core.quantizer`, with every correctness mechanism of
the reference:

  * double-checking: every value is reconstructed and verified against the
    bound at once; failures are outliers, kept losslessly.
  * parity-safe REL transcendentals from `bitops`.
  * special values: NaN/INF are flagged before any int cast; denormals are
    handled by the eb floor (ABS) and the REL screen.
  * the paper's two-comparison range test `(bin >= maxbin) | (bin <= -maxbin)`,
    never `abs(bin) >= maxbin`.

The check accepts only `diff <= eb * TIGHTEN`, so every decoded value is
within eb of its original, or bit-for-bit identical to it.  Every function
runs on any device; `torch.round` rounds half to even like `jnp.rint`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bitops import float_to_bits, log2approx, pow2_floor, pow2approx
from .config import QuantizerConfig


class Quantized(NamedTuple):
    """bins: int32 (0 where outlier); outlier: bool; recon: what the decoder
    produces for non-outliers (0 at outliers); sign: REL only, True where
    the original's sign bit is set."""

    bins: torch.Tensor
    outlier: torch.Tensor
    recon: torch.Tensor
    sign: torch.Tensor | None = None


def full_scalar(v, dt, device) -> torch.Tensor:
    """A 0-d tensor of dtype dt holding v: exact for numpy scalars of dt,
    rounded once for Python floats (as the reference's jnp.asarray does).
    Filled on the device, so a CUDA scalar costs no host sync."""
    return torch.full((), float(v), dtype=dt, device=device)


def _traced_abs_step(eb, cfg: QuantizerConfig, dt, device):
    """The traced-eb transform shared by encode and decode: eb floored
    (NaN propagates, like jnp.maximum), eb2 = pow2_floor(2 * eb).  A
    tensor eb of several elements broadcasts against the data (the KV
    cache's per-page bounds); one element acts as a scalar."""
    floor = full_scalar(cfg.eb_floor, dt, device)
    if not torch.is_tensor(eb):
        eb_in = full_scalar(eb, dt, device)
    else:
        eb_in = eb.to(device=device, dtype=dt)
        if eb_in.numel() == 1:
            eb_in = eb_in.reshape(())
    degenerate = ~(eb_in >= floor)               # True also for NaN eb
    eb_ = torch.maximum(eb_in, floor)
    eb2 = pow2_floor(full_scalar(2.0, dt, device) * eb_)
    return eb_, eb2, degenerate


def quantize_abs(x: torch.Tensor, cfg: QuantizerConfig, eb=None) -> Quantized:
    """ABS quantizer: bin = rint(x / (2*eb)), recon = bin * (2*eb).

    `eb` (a float or a 0-d tensor) overrides the config bound (NOA and
    per-tensor bounds); below the floor, or NaN, the whole tensor goes
    lossless (the degenerate guard).
    """
    dt, dev = x.dtype, x.device
    degenerate = None
    if eb is None:
        eb_, eb2, inv_eb2 = (full_scalar(c, dt, dev) for c in cfg.abs_constants())
    else:
        eb_, eb2, degenerate = _traced_abs_step(eb, cfg, dt, dev)
        inv_eb2 = full_scalar(1.0, dt, dev) / eb2
    maxbin = cfg.maxbin

    finite = torch.isfinite(x)
    xs = torch.where(finite, x, torch.zeros((), dtype=dt, device=dev))
    bin_f = torch.round(xs * inv_eb2)
    # range check in the float domain first: |bin_f| can exceed int32
    range_bad = bin_f.abs() >= full_scalar(float(maxbin), dt, dev)
    bin_i = torch.where(range_bad, torch.zeros_like(bin_f), bin_f).to(torch.int32)
    range_bad_i = (bin_i >= maxbin) | (bin_i <= -maxbin)

    recon = bin_i.to(dt) * eb2                   # exact (pow2 step)
    bound = eb_ * full_scalar(cfg.tighten, dt, dev)
    fails = ~((x - recon).abs() <= bound)        # True for NaN diff too
    fails |= ~torch.isfinite(recon)              # recon-overflow guard

    outlier = (~finite) | range_bad | range_bad_i | fails
    if degenerate is not None:
        outlier = outlier | degenerate
    bins = torch.where(outlier, torch.zeros_like(bin_i), bin_i)
    recon = torch.where(outlier, torch.zeros((), dtype=dt, device=dev), recon)
    return Quantized(bins, outlier, recon)


def dequantize_abs(bins: torch.Tensor, cfg: QuantizerConfig, eb=None,
                   dtype=None) -> torch.Tensor:
    dt = dtype or getattr(torch, cfg.dtype)
    if eb is None:
        _, eb2, _ = cfg.abs_constants()
        eb2 = full_scalar(eb2, dt, bins.device)
    else:
        _, eb2, _ = _traced_abs_step(eb, cfg, dt, bins.device)
    return bins.to(dt) * eb2


def quantize_rel(x: torch.Tensor, cfg: QuantizerConfig) -> Quantized:
    """REL quantizer: bins in the log2approx domain.

    bin = rint(log2approx(|x|) / w), recon = sign(x) * pow2approx(bin * w),
    w = log2(1+eb) floored to a power of two.  The check is
    |x - r| <= eb * T * |x| with a finite, normal reconstruction.
    """
    dt, dev = x.dtype, x.device
    eb_, log_step, inv_log_step = cfg.rel_constants()
    maxbin = cfg.maxbin

    finite = torch.isfinite(x)
    ax = x.abs()
    too_small = ~(ax >= full_scalar(cfg.rel_screen_threshold(), dt, dev))
    one = torch.ones((), dtype=dt, device=dev)
    safe = torch.where(finite & ~too_small, ax, one)
    lg = log2approx(safe)
    bin_f = torch.round(lg * full_scalar(inv_log_step, dt, dev))
    # a zero log step (eb below ~1.1e-16) gives rint(0 * inf) = NaN at
    # |x| = 1; XLA and CUDA cast it to 0, torch on the CPU to INT32_MIN
    bin_f = torch.where(torch.isnan(bin_f), torch.zeros_like(bin_f), bin_f)
    range_bad = bin_f.abs() >= full_scalar(float(maxbin), dt, dev)
    bin_i = torch.where(range_bad, torch.zeros_like(bin_f), bin_f).to(torch.int32)
    range_bad_i = (bin_i >= maxbin) | (bin_i <= -maxbin)

    # sign from the BIT PATTERN, not `x < 0` (flush-proof)
    neg = float_to_bits(x) < 0
    mag = pow2approx(bin_i.to(dt) * full_scalar(log_step, dt, dev))
    recon = torch.where(neg, -mag, mag)
    ebT = full_scalar(dt_np(dt).type(eb_) * dt_np(dt).type(cfg.tighten), dt, dev)
    ok = ((x - recon).abs() <= ebT * ax) & torch.isfinite(recon)
    ok &= mag >= full_scalar(np.finfo(dt_np(dt)).tiny, dt, dev)
    outlier = (~finite) | too_small | range_bad | range_bad_i | ~ok
    bins = torch.where(outlier, torch.zeros_like(bin_i), bin_i)
    recon = torch.where(outlier, torch.zeros((), dtype=dt, device=dev), recon)
    return Quantized(bins, outlier, recon, sign=neg)


def dequantize_rel(bins: torch.Tensor, sign: torch.Tensor,
                   cfg: QuantizerConfig, dtype=None) -> torch.Tensor:
    dt = dtype or getattr(torch, cfg.dtype)
    _, log_step, _ = cfg.rel_constants()
    mag = pow2approx(bins.to(dt) * full_scalar(log_step, dt, bins.device))
    return torch.where(sign, -mag, mag)


def value_range_eb(x: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    """NOA's traced bound: error_bound * (max - min) over the finite values,
    as a 0-d tensor on x's device (no host sync)."""
    finite = torch.isfinite(x)
    big = full_scalar(np.finfo(dt_np(x.dtype)).max, x.dtype, x.device)
    hi = torch.where(finite, x, -big).max()
    lo = torch.where(finite, x, big).min()
    return full_scalar(cfg.error_bound, x.dtype, x.device) * (hi - lo)


def quantize_noa(x: torch.Tensor, cfg: QuantizerConfig):
    """NOA = ABS with eb scaled by the value range (paper §2.1.3).  Returns
    (Quantized, eb); degenerate ranges go lossless inside quantize_abs."""
    eb = value_range_eb(x, cfg)
    return quantize_abs(x, cfg, eb=eb), eb


def quantize(x: torch.Tensor, cfg: QuantizerConfig):
    """Mode dispatch.  Returns (Quantized, eb): eb the traced NOA bound, a
    0-d tensor, else None."""
    if cfg.mode == "abs":
        return quantize_abs(x, cfg), None
    if cfg.mode == "rel":
        return quantize_rel(x, cfg), None
    if cfg.mode == "noa":
        return quantize_noa(x, cfg)
    raise ValueError(cfg.mode)


# ---------------------------------------------------------------------------
# The paper's baselines (Figs 1-4, Tables 4-9), kept beside the guarded
# quantizers only to measure what the guarantee costs.
# ---------------------------------------------------------------------------

def quantize_abs_unprotected(x: torch.Tensor, cfg: QuantizerConfig) -> Quantized:
    """ABS without the double-check: only non-finite values and bins out of
    range are outliers.  recon = bins * eb2 (0 at outliers)."""
    dt, dev = x.dtype, x.device
    _, eb2, inv_eb2 = (full_scalar(c, dt, dev) for c in cfg.abs_constants())
    finite = torch.isfinite(x)
    xs = torch.where(finite, x, torch.zeros((), dtype=dt, device=dev))
    bin_f = torch.round(xs * inv_eb2)
    range_bad = bin_f.abs() >= full_scalar(float(cfg.maxbin), dt, dev)
    bin_i = torch.where(range_bad, torch.zeros_like(bin_f), bin_f).to(torch.int32)
    outlier = (~finite) | range_bad
    bins = torch.where(outlier, torch.zeros_like(bin_i), bin_i)
    return Quantized(bins, outlier, bins.to(dt) * eb2)


def quantize_rel_library(x: torch.Tensor, cfg: QuantizerConfig) -> Quantized:
    """REL through the backend's own log2/exp2 (the paper's 'original
    functions' baseline), with the double-check kept: every value still
    meets the bound, but the bins depend on the backend's last bit, so
    there is no cross-device parity (ROADMAP C-port-8)."""
    dt, dev = x.dtype, x.device
    eb_, log_step, inv_log_step = cfg.rel_constants()
    finite = torch.isfinite(x)
    ax = x.abs()
    too_small = ~(ax >= full_scalar(cfg.rel_screen_threshold(), dt, dev))
    one = torch.ones((), dtype=dt, device=dev)
    safe = torch.where(finite & ~too_small, ax, one)
    bin_f = torch.round(torch.log2(safe) * full_scalar(inv_log_step, dt, dev))
    # NaN to 0 before the int cast (rint(0 * inf) at a zero log step)
    bin_f = torch.where(torch.isnan(bin_f), torch.zeros_like(bin_f), bin_f)
    range_bad = bin_f.abs() >= full_scalar(float(cfg.maxbin), dt, dev)
    bin_i = torch.where(range_bad, torch.zeros_like(bin_f), bin_f).to(torch.int32)
    mag = torch.exp2(bin_i.to(dt) * full_scalar(log_step, dt, dev))
    neg = float_to_bits(x) < 0
    recon = torch.where(neg, -mag, mag)
    ebT = full_scalar(dt_np(dt).type(eb_) * dt_np(dt).type(cfg.tighten), dt, dev)
    ok = ((x - recon).abs() <= ebT * ax) & torch.isfinite(recon)
    ok &= mag >= full_scalar(np.finfo(dt_np(dt)).tiny, dt, dev)
    outlier = (~finite) | too_small | range_bad | ~ok
    bins = torch.where(outlier, torch.zeros_like(bin_i), bin_i)
    recon = torch.where(outlier, torch.zeros((), dtype=dt, device=dev), recon)
    return Quantized(bins, outlier, recon, sign=neg)


def dt_np(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch float dtype."""
    return {torch.float32: np.dtype(np.float32),
            torch.float64: np.dtype(np.float64)}[dt]

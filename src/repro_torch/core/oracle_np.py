"""Pure-numpy mirror of the quantizers — a second oracle for the port.

A copy of the JAX package's `repro.core.oracle_np`.  The paper's parity
requirement is that independent implementations on different hardware and
compilers produce bit-identical compressed streams: the torch quantizers
(CPU and CUDA) and this numpy implementation must agree bit-for-bit on
bins, outlier flags, and reconstructions.  That only holds because every
op used is IEEE-754 add/sub/mul/cmp, integer ops, or bitcasts (the paper's
discipline).
"""
from __future__ import annotations

import numpy as np

from .config import QuantizerConfig

_SPEC = {
    np.dtype(np.float32): (np.int32, np.uint32, 23, 0xFF, 127),
    np.dtype(np.float64): (np.int64, np.uint64, 52, 0x7FF, 1023),
}


def log2approx(x: np.ndarray) -> np.ndarray:
    int_t, _, mb, emask, bias = _SPEC[x.dtype]
    orig_i = x.view(int_t)
    expo = (orig_i >> mb) & emask
    frac_i = ((int_t(bias) << mb) | (orig_i & ((int_t(1) << mb) - int_t(1))))
    frac_f = frac_i.astype(int_t).view(x.dtype)
    return frac_f + (expo - (bias + 1)).astype(x.dtype)


def pow2approx(log_f: np.ndarray) -> np.ndarray:
    int_t, _, mb, _, bias = _SPEC[log_f.dtype]
    biased = log_f + log_f.dtype.type(bias)
    with np.errstate(invalid="ignore"):
        expo = biased.astype(int_t)            # trunc toward zero (C cast)
    frac_f = biased - (expo - 1).astype(log_f.dtype)
    frac_i = frac_f.view(int_t)
    exp_i = (expo << mb) | (frac_i & ((int_t(1) << mb) - int_t(1)))
    return exp_i.view(log_f.dtype)


def quantize_abs(x: np.ndarray, cfg: QuantizerConfig, eb=None):
    from .config import _pow2_floor_np

    dt = x.dtype
    degenerate = False
    if eb is None:
        eb, eb2, inv_eb2 = cfg.abs_constants()
    else:
        # mirror of the traced-eb guard + pow2 step in quantizer.py
        eb = dt.type(eb)
        floor = dt.type(cfg.eb_floor)
        degenerate = not (eb >= floor)
        eb = max(eb, floor)
        eb2 = _pow2_floor_np(dt.type(2) * eb)
        inv_eb2 = dt.type(1) / eb2
    maxbin = cfg.maxbin

    finite = np.isfinite(x)
    xs = np.where(finite, x, dt.type(0))
    # Mask magnitudes whose xs * inv_eb2 would overflow before multiplying.
    # eb2 is a power of two, so the scaling is EXACT: |xs| <= max * eb2 iff
    # the product fits, and anything above it is a range outlier anyway
    # (|bin| would far exceed maxbin).  The decision is bit-identical to
    # the unmasked JAX path; this only silences the spurious overflow
    # RuntimeWarning, which would otherwise bury real regressions.
    thr = dt.type(min(float(np.finfo(dt).max) * float(eb2),
                      float(np.finfo(dt).max)))
    huge = np.abs(xs) > thr
    xs = np.where(huge, dt.type(0), xs)
    bin_f = np.rint(xs * inv_eb2)
    range_bad = huge | (np.abs(bin_f) >= dt.type(maxbin))
    with np.errstate(invalid="ignore"):
        bin_i = np.where(range_bad, 0, bin_f).astype(np.int32)
    range_bad_i = (bin_i >= maxbin) | (bin_i <= -maxbin)
    recon = bin_i.astype(dt) * eb2
    with np.errstate(invalid="ignore", over="ignore"):
        fails = ~(np.abs(x - recon) <= eb * dt.type(cfg.tighten))
    fails |= ~np.isfinite(recon)       # recon-overflow guard (see quantizer.py)
    outlier = (~finite) | range_bad | range_bad_i | fails | degenerate
    bins = np.where(outlier, 0, bin_i)
    recon = np.where(outlier, dt.type(0), recon)
    return bins, outlier, recon


def dequantize_abs(bins, cfg: QuantizerConfig, eb=None):
    from .config import _pow2_floor_np

    dt = cfg.np_dtype
    if eb is None:
        _, eb2, _ = cfg.abs_constants()
    else:
        eb_ = max(dt.type(eb), dt.type(cfg.eb_floor))
        eb2 = _pow2_floor_np(dt.type(2) * eb_)
    return bins.astype(dt) * eb2


def quantize_rel(x: np.ndarray, cfg: QuantizerConfig):
    dt = x.dtype
    eb, log_step, inv_log_step = cfg.rel_constants()
    maxbin = cfg.maxbin

    finite = np.isfinite(x)
    ax = np.abs(x)
    too_small = ~(ax >= dt.type(cfg.rel_screen_threshold()))
    safe = np.where(finite & ~too_small, ax, dt.type(1))
    lg = log2approx(safe)
    bin_f = np.rint(lg * inv_log_step)
    range_bad = np.abs(bin_f) >= dt.type(maxbin)
    with np.errstate(invalid="ignore"):
        bin_i = np.where(range_bad, 0, bin_f).astype(np.int32)
    range_bad_i = (bin_i >= maxbin) | (bin_i <= -maxbin)
    int_t = _SPEC[dt][0]
    neg = x.view(int_t) < 0          # bit-pattern sign (parity with JAX)
    mag = pow2approx(bin_i.astype(dt) * log_step)
    recon = np.where(neg, -mag, mag)
    ebT = dt.type(eb) * dt.type(cfg.tighten)
    with np.errstate(invalid="ignore"):
        ok = (np.abs(x - recon) <= ebT * ax)
    ok &= np.isfinite(recon)
    ok &= mag >= np.finfo(dt).tiny
    outlier = (~finite) | too_small | range_bad | range_bad_i | ~ok
    bins = np.where(outlier, 0, bin_i)
    return bins, outlier, np.where(outlier, dt.type(0), recon), neg


def dequantize_rel(bins, sign, cfg: QuantizerConfig):
    dt = cfg.np_dtype
    _, log_step, _ = cfg.rel_constants()
    mag = pow2approx(bins.astype(dt) * log_step)
    return np.where(sign, -mag, mag)


def quantize_noa(x: np.ndarray, cfg: QuantizerConfig):
    finite = np.isfinite(x)
    if finite.any():
        r = x[finite].max().astype(x.dtype) - x[finite].min().astype(x.dtype)
    else:
        r = x.dtype.type(0)
    eb = x.dtype.type(cfg.error_bound) * r
    bins, outlier, recon = quantize_abs(x, cfg, eb=eb)
    return bins, outlier, recon, eb

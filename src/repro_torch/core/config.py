"""Quantizer configuration and host-side derived constants.

A copy of the JAX package's `repro.core.config` (numpy only), kept here so
the port imports nothing of that package.  All data-independent constants
(eb2, 1/eb2, the REL log-step) are computed ONCE on the host in double
precision and then frozen to the target dtype; devices never evaluate a
transcendental to derive them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

Mode = str  # 'abs' | 'rel' | 'noa'

# Acceptance tightening: the double-check comparison is itself floating
# point.  Accepting only diff <= eb * TIGHTEN guarantees the TRUE error is
# <= eb even after the check's own rounding (a few ulps).
TIGHTEN_F32 = 1.0 - 2.0 ** -18
TIGHTEN_F64 = 1.0 - 2.0 ** -40

# Denormal-flush hardening.  The JAX reference runs on backends that flush
# denormals (FTZ/DAZ); torch on the CPU and the CUDA kernels (no fast-math)
# keep IEEE gradual underflow.  These guards make the accept/reject decision
# identical under both semantics:
#   * ABS: eb must be >= EB_FLOOR so every denormal quantizes to bin 0.
#   * REL: magnitudes below rel_screen_threshold() are outliers, decided by
#     comparisons against a normal number only.
EB_FLOOR_F32 = 2.0 ** -120
EB_FLOOR_F64 = 2.0 ** -1000


def _pow2_floor_np(x):
    """Largest power of two <= x, by clearing mantissa bits."""
    dt = x.dtype
    if dt == np.float32:
        bits = np.float32(x).view(np.uint32)
        return (bits & np.uint32(0xFF800000)).view(np.float32)
    bits = np.float64(x).view(np.uint64)
    return (bits & np.uint64(0xFFF0000000000000)).view(np.float64)


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """User-facing knobs for one LC-style guaranteed-error-bound quantizer."""

    mode: Mode = "abs"            # 'abs' | 'rel' | 'noa'
    error_bound: float = 1e-3     # eb (for 'noa': relative to value range R)
    bin_bits: int = 16            # storage width of bin numbers (sign incl.)
    dtype: str = "float32"        # data dtype: 'float32' | 'float64'
    outlier_cap_frac: float = 0.125  # compact codec: max outliers fraction

    def __post_init__(self):
        if self.mode not in ("abs", "rel", "noa"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if not (self.error_bound > 0.0) or not math.isfinite(self.error_bound):
            raise ValueError("error_bound must be finite and positive")
        if self.bin_bits not in (8, 16, 32):
            raise ValueError("bin_bits must be 8, 16 or 32")
        if self.mode == "abs" and self.error_bound < self.eb_floor:
            raise ValueError(
                f"abs error_bound {self.error_bound} below the denormal-safe "
                f"floor {self.eb_floor} for {self.dtype} (see EB_FLOOR_* note)")

    @property
    def eb_floor(self) -> float:
        return EB_FLOOR_F64 if self.dtype == "float64" else EB_FLOOR_F32

    def rel_screen_threshold(self):
        """Smallest |x| the REL quantizer will bin; below it -> outlier.

        2 * max(tiny, tiny/eb), rounded UP, so every product in the
        double-check and every sub stays in the normal range.
        """
        dt = self.np_dtype
        tiny = float(np.finfo(dt).tiny)
        thr = 2.0 * max(tiny, tiny / self.error_bound)
        return np.nextafter(dt.type(thr), dt.type(np.inf))

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def tighten(self) -> float:
        return TIGHTEN_F64 if self.np_dtype == np.float64 else TIGHTEN_F32

    @property
    def maxbin(self) -> int:
        # Valid bins are (-maxbin, maxbin); |bin| >= maxbin is an outlier.
        return (1 << (self.bin_bits - 1)) - 1

    # --- host-side derived constants (exact target-dtype bits) -------------

    def abs_constants(self, eb: float | None = None):
        """(eb, eb2, inv_eb2) as numpy scalars of the data dtype.  eb2 is
        floored to a power of two so bin * eb2 and x * inv_eb2 are exact
        exponent shifts (immune to FMA contraction)."""
        dt = self.np_dtype
        eb_ = dt.type(self.error_bound if eb is None else eb)
        eb2 = _pow2_floor_np(dt.type(2.0) * eb_)
        inv_eb2 = dt.type(1.0) / eb2
        return eb_, eb2, inv_eb2

    def rel_constants(self):
        """(eb, log_step, inv_log_step) for the REL quantizer; log_step is
        log2(1+eb) floored to a power of two."""
        dt = self.np_dtype
        eb_ = dt.type(self.error_bound)
        step = math.log2(1.0 + self.error_bound)
        log_step = _pow2_floor_np(dt.type(step))
        inv_log_step = dt.type(1.0) / log_step
        return eb_, log_step, inv_log_step

    def outlier_cap(self, n: int) -> int:
        return max(1, int(math.ceil(n * self.outlier_cap_frac)))

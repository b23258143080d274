"""The dense-layout kernels under the names of the reference's
`repro/kernels/ops.py` (`quantize_abs`, `quantize_rel`, `dequantize_abs`),
so that each module of the reference has its counterpart here.  The
wrappers, their kernels and their plain versions live in `kernels/dense.py`
(which also holds `dequantize_rel`, the launcher that the reference keeps
in `kernels/dequantize.py` without an `ops` wrapper)."""
from .dense import dequantize_abs, quantize_abs, quantize_rel

__all__ = ["quantize_abs", "quantize_rel", "dequantize_abs"]

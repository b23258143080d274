"""Dense-layout quantize and dequantize: the four CUDA kernels of
`csrc/dense.cu`, their wrappers, and their plain torch versions.

Counterpart of the reference's `repro/kernels/quantize_abs.py`
(`_kernel`), `repro/kernels/quantize_rel.py` (`_kernel`) and
`repro/kernels/dequantize.py` (`_abs_kernel`, `_rel_kernel`), with the
layout handling of `repro/kernels/ops.py`: any shape goes in, and every
output has its shape.  The reference tiles the flat stream to [R, 128] and
pads it (`rows`, `interpret` are TPU tiling knobs); the kernels here work
on the flat n values and mask the tail, which gives the same values
elementwise.  Bins are int32, outlier and sign planes bool, the payload
int32 IEEE bits; float32 only (JAX's x64 is off, so the reference
computes float32 only).

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (built from source at first use) or raises;
nothing falls back.  On the "meta" device it returns empty outputs of the
kernel's shapes and computes nothing.  Each launch adds one to
`LAUNCHES[name]`.

`encode_packed`/`decode_packed` put B8-B11 on the pipeline's main path:
the chains with a predictor stage, and `verify=`/`return_quantized=`
encodes, which need the dense `Quantized` planes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import codec as C
from ..core import quantizer as q
from ..core.bitops import bits_to_float
from ..core.config import QuantizerConfig
from ..core.quantizer import Quantized
from .pack import DEVICES, _launch, rel_constants_f32

KERNELS = ("_quantize_abs", "_quantize_rel", "_dequantize_abs",
           "_dequantize_rel")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _flat(t: torch.Tensor, dtype, what: str) -> torch.Tensor:
    """t as a contiguous 1-d tensor; raises on a type the kernel does not
    take (float32 data only: ROADMAP C-port-2)."""
    if t.dtype != dtype:
        err = NotImplementedError if dtype == torch.float32 else TypeError
        raise err(f"{what}: expected {dtype}, got {t.dtype}")
    if t.device.type not in DEVICES:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.reshape(-1).contiguous()


def _same_shape(ref: torch.Tensor, *others) -> None:
    for t in others:
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError("bins, payload_bits, outlier (and sign) must "
                             "share one shape and device")


def _eb_tensor(eb, cfg: QuantizerConfig, like: torch.Tensor) -> torch.Tensor:
    """eb (None: the config bound; a float; or a 0-d tensor on the data's
    device) as one float32 element on the data's device, read by the
    kernel through a pointer: a traced bound costs no host sync."""
    if eb is None:
        eb = cfg.error_bound
    if not torch.is_tensor(eb):
        return q.full_scalar(eb, torch.float32, like.device).reshape(1)
    if eb.numel() != 1 or eb.device != like.device:
        raise ValueError("eb must be one value on the data's device")
    return eb.to(torch.float32).reshape(1).contiguous()


# ------------------------------------------------------- plain versions --
# The kernels' arithmetic in plain torch: the quantizers of core.quantizer
# (ABS always with the traced eb, as the reference's ops do) and the
# payload select of the dequantize kernels.

def _quantize_abs_plain(x, eb, cfg: QuantizerConfig) -> Quantized:
    return q.quantize_abs(x, cfg, eb=eb.reshape(()))


def _quantize_rel_plain(x, cfg: QuantizerConfig) -> Quantized:
    return q.quantize_rel(x, cfg)


def _dequantize_abs_plain(bins, payload_bits, outlier, eb,
                          cfg: QuantizerConfig):
    recon = q.dequantize_abs(bins, cfg, eb=eb.reshape(()), dtype=torch.float32)
    return torch.where(outlier, bits_to_float(payload_bits, torch.float32),
                       recon)


def _dequantize_rel_plain(bins, payload_bits, outlier, sign,
                          cfg: QuantizerConfig):
    recon = q.dequantize_rel(bins, sign, cfg, dtype=torch.float32)
    return torch.where(outlier, bits_to_float(payload_bits, torch.float32),
                       recon)


# -------------------------------------------------------------- wrappers --

def quantize_abs(x: torch.Tensor, cfg: QuantizerConfig, eb=None) -> Quantized:
    """ABS quantize with the bound eb (default cfg.error_bound; a float or
    a 0-d tensor on x's device).  Returns Quantized(bins int32, outlier
    bool, recon float32 with 0 at outliers), each of x's shape."""
    flat = _flat(x, torch.float32, "quantize_abs x")
    eb_t = _eb_tensor(eb, cfg, flat)
    if flat.device.type == "cpu":
        return Quantized(*(t.reshape(x.shape) for t in
                           _quantize_abs_plain(flat, eb_t, cfg)[:3]))
    n = flat.numel()
    bins = torch.empty(n, dtype=torch.int32, device=flat.device)
    outlier = torch.empty(n, dtype=torch.bool, device=flat.device)
    recon = torch.empty(n, dtype=torch.float32, device=flat.device)
    _launch(LAUNCHES, "_quantize_abs", "repro_dense_quantize_abs",
            flat.device, flat.data_ptr(), n, eb_t.data_ptr(), cfg.maxbin,
            float(np.float32(cfg.tighten)), float(np.float32(cfg.eb_floor)),
            bins.data_ptr(), outlier.data_ptr(), recon.data_ptr())
    return Quantized(bins.reshape(x.shape), outlier.reshape(x.shape),
                     recon.reshape(x.shape))


def quantize_rel(x: torch.Tensor, cfg: QuantizerConfig) -> Quantized:
    """REL quantize.  Returns Quantized(bins, outlier, recon, sign), each of
    x's shape; sign is True where x's sign bit is set."""
    flat = _flat(x, torch.float32, "quantize_rel x")
    if flat.device.type == "cpu":
        return Quantized(*(t.reshape(x.shape) for t in
                           _quantize_rel_plain(flat, cfg)))
    n = flat.numel()
    bins = torch.empty(n, dtype=torch.int32, device=flat.device)
    outlier = torch.empty(n, dtype=torch.bool, device=flat.device)
    recon = torch.empty(n, dtype=torch.float32, device=flat.device)
    sign = torch.empty(n, dtype=torch.bool, device=flat.device)
    _launch(LAUNCHES, "_quantize_rel", "repro_dense_quantize_rel",
            flat.device, flat.data_ptr(), n, cfg.maxbin,
            *rel_constants_f32(cfg), bins.data_ptr(), outlier.data_ptr(),
            recon.data_ptr(), sign.data_ptr())
    return Quantized(*(t.reshape(x.shape) for t in (bins, outlier, recon,
                                                    sign)))


def dequantize_abs(bins: torch.Tensor, payload_bits: torch.Tensor,
                   outlier: torch.Tensor, cfg: QuantizerConfig, eb=None):
    """bins * eb2, with the exact float32 of payload_bits (int32 IEEE bits)
    at outliers.  Returns float32 of bins' shape."""
    _same_shape(bins, payload_bits, outlier)
    b = _flat(bins, torch.int32, "dequantize_abs bins")
    p = _flat(payload_bits, torch.int32, "dequantize_abs payload_bits")
    o = _flat(outlier, torch.bool, "dequantize_abs outlier")
    eb_t = _eb_tensor(eb, cfg, b)
    if b.device.type == "cpu":
        return _dequantize_abs_plain(b, p, o, eb_t, cfg).reshape(bins.shape)
    y = torch.empty(b.numel(), dtype=torch.float32, device=b.device)
    _launch(LAUNCHES, "_dequantize_abs", "repro_dense_dequantize_abs",
            b.device, b.data_ptr(), p.data_ptr(), o.data_ptr(),
            eb_t.data_ptr(), float(np.float32(cfg.eb_floor)), y.data_ptr(),
            b.numel())
    return y.reshape(bins.shape)


def dequantize_rel(bins: torch.Tensor, payload_bits: torch.Tensor,
                   outlier: torch.Tensor, sign: torch.Tensor,
                   cfg: QuantizerConfig):
    """+-pow2approx(bins * log_step), with the exact float32 of payload_bits
    at outliers.  Returns float32 of bins' shape."""
    _same_shape(bins, payload_bits, outlier, sign)
    b = _flat(bins, torch.int32, "dequantize_rel bins")
    p = _flat(payload_bits, torch.int32, "dequantize_rel payload_bits")
    o = _flat(outlier, torch.bool, "dequantize_rel outlier")
    s = _flat(sign, torch.bool, "dequantize_rel sign")
    if b.device.type == "cpu":
        return _dequantize_rel_plain(b, p, o, s, cfg).reshape(bins.shape)
    y = torch.empty(b.numel(), dtype=torch.float32, device=b.device)
    _launch(LAUNCHES, "_dequantize_rel", "repro_dense_dequantize_rel",
            b.device, b.data_ptr(), p.data_ptr(), o.data_ptr(), s.data_ptr(),
            rel_constants_f32(cfg)[1], y.data_ptr(), b.numel())
    return y.reshape(bins.shape)


# ------------------------------------------------------------ public API --

def encode_packed(x: torch.Tensor, cfg: QuantizerConfig, eb=None,
                  bin_transform=None):
    """Kernel twin of `core.codec.encode_packed(x, cfg, eb,
    return_quantized=True, bin_transform=...)` (bit-exact): B8 or B9 give
    the `Quantized` planes (NOA: the finite range's bound, then B8 with
    it; a static ABS bound goes in as the traced plane, which gives the
    same step), then the outlier table, the bin transform and the pack
    are torch ops, as in the reference's jit path.  Returns
    (EncodedPacked, Quantized)."""
    flat = x.reshape(-1).contiguous()
    C.check_f32(flat)
    qt, eb = C.quantize_flat(flat, cfg, eb)
    enc = C.pack_quantized(flat, qt, cfg, eb, cfg.outlier_cap(flat.shape[0]),
                           bin_transform)
    return enc, qt


def decode_packed(enc: C.EncodedPacked, cfg: QuantizerConfig,
                  n: int | None = None, shape=None, bin_untransform=None):
    """Kernel twin of `core.codec.decode_packed(..., bin_untransform=...)`
    (bit-exact): unpack and the bin untransform as torch ops, then B10 or
    B11 with the outlier table as dense planes."""
    if n is None:
        if shape is None:
            raise ValueError("decode_packed needs n or shape")
        n = int(np.prod(shape))
    if getattr(torch, cfg.dtype) != torch.float32:
        raise NotImplementedError("the dense kernels decode float32 only "
                                  "(ROADMAP C-port-2)")
    bins = C.unpack_words(enc.words, n, cfg.bin_bits)
    if bin_untransform is not None:
        bins = bin_untransform(bins)
    outlier, payload = C.outlier_planes(n, enc.out_idx, enc.out_payload)
    sign = None if cfg.mode != "rel" else C.unpack_flags(enc.sign_words, n)
    y = C.decode_planes(bins, payload, outlier, sign, enc.eb, cfg,
                        torch.float32)
    return y.reshape(shape) if shape is not None else y

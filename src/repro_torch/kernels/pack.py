"""Fused quantize + bit-pack and unpack + dequantize: the four CUDA kernels
of `csrc/pack.cu`, their wrappers, and their plain torch versions.

Counterpart of `repro.kernels.pack` (the Pallas kernels `_abs_pack_kernel`,
`_rel_pack_kernel`, `_abs_unpack_kernel`, `_rel_unpack_kernel`).  One pass
reads x and writes bin_bits-wide bins already packed into 32-bit lane words,
the outlier mask and, for REL, the sign plane at 1 bit/value; decode reads
the words (and signs) and writes the reconstruction.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (built from source at first use) or raises;
nothing falls back.  For a tensor on the "meta" device it checks the
operands as for the card and returns empty outputs of the kernel's shapes,
computing nothing.  Each launch (a meta one too) adds one to
`LAUNCHES[name]`.

Outside the kernels, as in the reference, stay torch ops: NOA's finite
min/max, the outlier table (`nonzero_static`), and the decode scatter.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import codec as C
from ..core import quantizer as q
from ..core.config import QuantizerConfig

LANES = 128        # lane width of the packed tile (the §4 layout)
assert LANES == C.PACK_LANES, "kernel tile width must match the wire layout"

DEVICES = ("cpu", "cuda", "meta")   # the devices a wrapper takes

KERNELS = ("_abs_pack", "_rel_pack", "_abs_unpack", "_rel_unpack")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _check_input(t: torch.Tensor, dtype, what: str) -> str:
    """Validate a kernel operand; returns 'cpu', 'cuda' or 'meta'."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-d tensor")
    if t.device.type not in DEVICES:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _eb_operand(eb: torch.Tensor, device) -> torch.Tensor:
    if eb.dtype != torch.float32 or eb.numel() != 1 or eb.device != device:
        raise ValueError("eb operand must be one float32 on the data's device")
    return eb.reshape(1).contiguous()


_FNS: dict = {}     # C name -> the library's ctypes function, looked up once


def _launch(counts: dict, name: str, fn: str, device, *args) -> None:
    """Call C function `fn` of the kernel library on `device`'s current
    stream; raise if the launch failed, else add one to counts[name] (under
    a lock: ranks on threads launch concurrently).  On the "meta" device
    nothing runs: the launch is counted, and the caller's outputs stay the
    empty tensors it made (`launch.dryrun`)."""
    device = torch.device(device)
    if device.type == "meta":
        with _COUNT_LOCK:
            counts[name] += 1
        return
    func = _FNS.get(fn)
    if func is None:
        from . import _build
        func = _FNS.setdefault(fn, getattr(_build.load(), fn))
    if device.index is None or device.index == torch.cuda.current_device():
        code = func(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            code = func(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        from . import _build
        _build.check(_build.load(), code, name)
    with _COUNT_LOCK:
        counts[name] += 1


# ------------------------------------------------------- plain versions --
# The kernels' arithmetic in plain torch: the traced-eb ABS quantizer (the
# kernel always reads eb from memory), the REL quantizer, and the §4 pack.

def _abs_pack_plain(x, eb, cfg: QuantizerConfig):
    qt = q.quantize_abs(x, cfg, eb=eb.reshape(()))
    return C.pack_words(qt.bins, cfg.bin_bits), qt.outlier


def _rel_pack_plain(x, cfg: QuantizerConfig):
    qt = q.quantize_rel(x, cfg)
    return C.pack_words(qt.bins, cfg.bin_bits), qt.outlier, C.pack_flags(qt.sign)


def _abs_unpack_plain(words, eb, n: int, cfg: QuantizerConfig):
    bins = C.unpack_words(words, n, cfg.bin_bits)
    return q.dequantize_abs(bins, cfg, eb=eb.reshape(()), dtype=torch.float32)


def _rel_unpack_plain(words, sign_words, n: int, cfg: QuantizerConfig):
    bins = C.unpack_words(words, n, cfg.bin_bits)
    sign = C.unpack_flags(sign_words, n)
    return q.dequantize_rel(bins, sign, cfg, dtype=torch.float32)


# -------------------------------------------------------------- wrappers --

def abs_pack(x: torch.Tensor, eb: torch.Tensor, cfg: QuantizerConfig):
    """x: f32[n]; eb: f32[1] on x's device (a traced bound costs no host
    sync).  Returns (words int32[packed_word_count(n, bits)], outlier
    bool[n])."""
    if _check_input(x, torch.float32, "abs_pack x") == "cpu":
        return _abs_pack_plain(x, eb, cfg)
    eb = _eb_operand(eb, x.device)
    n = x.shape[0]
    n_words = C.packed_word_count(n, cfg.bin_bits)
    words = torch.empty(n_words, dtype=torch.int32, device=x.device)
    outlier = torch.empty(n, dtype=torch.bool, device=x.device)
    _launch(LAUNCHES, "_abs_pack", "repro_abs_pack", x.device, x.data_ptr(),
            n, eb.data_ptr(), cfg.bin_bits, cfg.maxbin,
            float(np.float32(cfg.tighten)), float(np.float32(cfg.eb_floor)),
            words.data_ptr(), n_words // LANES, outlier.data_ptr())
    return words, outlier


def rel_constants_f32(cfg: QuantizerConfig):
    """(ebT, log_step, inv_log_step, screen, tiny) as exact float32 values,
    from the host constants the reference freezes (`cfg.rel_constants()`)."""
    f32 = np.float32
    eb_, log_step, inv_log_step = cfg.rel_constants()
    return (float(f32(eb_) * f32(cfg.tighten)), float(log_step),
            float(inv_log_step), float(cfg.rel_screen_threshold()),
            float(np.finfo(f32).tiny))


def rel_pack(x: torch.Tensor, cfg: QuantizerConfig):
    """x: f32[n].  Returns (words, outlier bool[n], sign_words
    int32[packed_word_count(n, 1)])."""
    if _check_input(x, torch.float32, "rel_pack x") == "cpu":
        return _rel_pack_plain(x, cfg)
    n = x.shape[0]
    n_words = C.packed_word_count(n, cfg.bin_bits)
    words = torch.empty(n_words, dtype=torch.int32, device=x.device)
    outlier = torch.empty(n, dtype=torch.bool, device=x.device)
    sign_words = torch.empty(C.packed_word_count(n, 1), dtype=torch.int32,
                             device=x.device)
    _launch(LAUNCHES, "_rel_pack", "repro_rel_pack", x.device, x.data_ptr(),
            n, cfg.bin_bits, cfg.maxbin, *rel_constants_f32(cfg),
            words.data_ptr(), n_words // LANES, outlier.data_ptr(),
            sign_words.data_ptr())
    return words, outlier, sign_words


def _check_words(words: torch.Tensor, n: int, bits: int, what: str) -> str:
    dev = _check_input(words, torch.int32, what)
    if words.shape[0] != C.packed_word_count(n, bits):
        raise ValueError(f"{what}: {words.shape[0]} words, expected "
                         f"{C.packed_word_count(n, bits)} for n={n}")
    return dev


def abs_unpack(words: torch.Tensor, eb: torch.Tensor, n: int,
               cfg: QuantizerConfig, out: torch.Tensor | None = None):
    """words: int32[packed_word_count(n, bits)]; eb: f32[1].  Returns
    recon f32[n] (outliers not restored).  `out`, if given, is a float32
    buffer of at least n elements whose first n are written."""
    dev = _check_words(words, n, cfg.bin_bits, "abs_unpack words")
    y = _out_buffer(out, n, words.device)
    if dev == "cpu":
        y[:n] = _abs_unpack_plain(words, eb, n, cfg)
        return y[:n]
    eb = _eb_operand(eb, words.device)
    _launch(LAUNCHES, "_abs_unpack", "repro_abs_unpack", words.device,
            words.data_ptr(), words.shape[0] // LANES, eb.data_ptr(),
            cfg.bin_bits, float(np.float32(cfg.eb_floor)), y.data_ptr(), n)
    return y[:n]


def rel_unpack(words: torch.Tensor, sign_words: torch.Tensor, n: int,
               cfg: QuantizerConfig, out: torch.Tensor | None = None):
    """words and sign_words as rel_pack emits them.  Returns recon f32[n]."""
    dev = _check_words(words, n, cfg.bin_bits, "rel_unpack words")
    _check_words(sign_words, n, 1, "rel_unpack sign_words")
    if sign_words.device != words.device:
        raise ValueError("rel_unpack: words and sign_words on different "
                         "devices")
    y = _out_buffer(out, n, words.device)
    if dev == "cpu":
        y[:n] = _rel_unpack_plain(words, sign_words, n, cfg)
        return y[:n]
    _launch(LAUNCHES, "_rel_unpack", "repro_rel_unpack", words.device,
            words.data_ptr(), words.shape[0] // LANES, sign_words.data_ptr(),
            cfg.bin_bits, rel_constants_f32(cfg)[1], y.data_ptr(), n)
    return y[:n]


def _out_buffer(out, n: int, device) -> torch.Tensor:
    if out is None:
        return torch.empty(n, dtype=torch.float32, device=device)
    if (out.dtype != torch.float32 or out.device != device or out.dim() != 1
            or out.shape[0] < n or not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32[>= n] on the "
                         "words' device")
    return out


# ------------------------------------------------------------ public API --

def encode_packed(x: torch.Tensor, cfg: QuantizerConfig,
                  eb=None) -> C.EncodedPacked:
    """Fused-kernel twin of `core.codec.encode_packed` (bit-exact)."""
    flat = x.reshape(-1).contiguous()
    C.check_f32(flat)
    n = flat.shape[0]
    if cfg.mode == "noa":
        eb = q.value_range_eb(flat, cfg)      # needs the whole tensor
    sign_words = None
    if cfg.mode == "rel":
        words, outlier, sign_words = rel_pack(flat, cfg)
    else:
        eb_arr = C.eb_plane(cfg.error_bound if eb is None else eb, flat)
        words, outlier = abs_pack(flat, eb_arr.reshape(1), cfg)
    return C.EncodedPacked(words, *C.outlier_table(flat, outlier,
                                                   cfg.outlier_cap(n)),
                           sign_words, C.eb_plane(eb, flat))


def decode_packed(enc: C.EncodedPacked, cfg: QuantizerConfig,
                  n: int | None = None, shape=None, dtype=None):
    """Fused-kernel twin of `core.codec.decode_packed` (bit-exact)."""
    if n is None:
        if shape is None:
            raise ValueError("decode_packed needs n or shape")
        n = int(np.prod(shape))
    if (dtype or getattr(torch, cfg.dtype)) != torch.float32:
        raise NotImplementedError("the packed-wire kernels decode float32 "
                                  "only (ROADMAP C-port-2)")
    words = enc.words.contiguous()
    # one spare element past the end takes the dropped outlier slots
    buf = torch.empty(n + 1, dtype=torch.float32, device=words.device)
    if cfg.mode == "rel":
        recon = rel_unpack(words, enc.sign_words.contiguous(), n, cfg, out=buf)
    else:
        eb = C.eb_plane(cfg.error_bound if enc.eb is None else enc.eb, buf)
        recon = abs_unpack(words, eb.reshape(1), n, cfg, out=buf)
    recon = C.scatter_outliers_(buf, n, enc.out_idx, enc.out_payload)
    return recon.reshape(shape) if shape is not None else recon

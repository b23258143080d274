"""The packed wire (§4 layout) over the quantizers, in torch.

Counterpart of the packed half of `repro.core.codec`: bins bit-packed into
32-bit lane words, the REL sign plane at 1 bit/value, and the capped exact
outlier table (the first K outlier indices in ascending order, filled with
n, plus their original IEEE bits).  `overflow` is `n_outliers > K`: the
tensor then cannot be represented within the bound and callers must take a
lossless path; the guarantee is never silently dropped.

Word layout: the flat stream is zero-padded to whole tiles of
vpw * PACK_LANES elements (vpw = 32 // bin_bits), viewed row-major as
[R, PACK_LANES], and word row w packs element rows w*vpw .. w*vpw+vpw-1:
element [w*vpw + i, lane] occupies bits [i*bin_bits, (i+1)*bin_bits) of
word [w, lane], as bin_bits-wide two's complement.

Word planes are int32 tensors holding the uint32 bits (compare them as
`.numpy().view(np.uint32)`): torch on the CPU has no shifts for uint32.
Packing runs in int64 and is wrapped back to int32 (`to_i32`), so no shift
overflows a signed type.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import quantizer as q
from .bitops import bits_to_float, float_to_bits
from .config import QuantizerConfig

PACK_LANES = 128          # lane width of the packed tile
_PACK_WIDTHS = (1, 2, 4, 8, 16, 32)
_U32 = 0xFFFFFFFF


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    u = u & _U32
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def packed_word_count(n: int, bin_bits: int) -> int:
    """Number of 32-bit words `pack_words` emits for n elements."""
    vpw = 32 // bin_bits
    tile = vpw * PACK_LANES
    return -(-n // tile) * PACK_LANES


def pack_words(values: torch.Tensor, bin_bits: int) -> torch.Tensor:
    """Pack flat int (or bool) values into words (layout in the module
    note).  Each value must be representable in bin_bits two's complement.
    Returns int32[packed_word_count(n, bin_bits)]."""
    if bin_bits not in _PACK_WIDTHS:
        raise ValueError(f"bin_bits must be one of {_PACK_WIDTHS}")
    vpw = 32 // bin_bits
    n = values.shape[0]
    n_words = packed_word_count(n, bin_bits)
    u = values.to(torch.int64) & ((1 << bin_bits) - 1)
    u = torch.cat([u, u.new_zeros(n_words * vpw - n)])
    grp = u.reshape(-1, vpw, PACK_LANES)
    word = grp[:, 0, :]
    for i in range(1, vpw):
        word = word | (grp[:, i, :] << (i * bin_bits))
    return to_i32(word.reshape(-1))


def unpack_words(words: torch.Tensor, n: int, bin_bits: int,
                 signed: bool = True) -> torch.Tensor:
    """Inverse of pack_words.  Returns int32[n]: sign-extended bins, or the
    raw bin_bits-wide fields when signed=False."""
    vpw = 32 // bin_bits
    w = (words.to(torch.int64) & _U32).reshape(-1, PACK_LANES)
    if vpw == 1:
        flat = w.reshape(-1)[:n]
    else:
        mask = (1 << bin_bits) - 1
        cols = [(w >> (i * bin_bits)) & mask for i in range(vpw)]
        flat = torch.stack(cols, dim=1).reshape(-1)[:n]
    if not signed or bin_bits == 32:
        return to_i32(flat)
    half = 1 << (bin_bits - 1)
    return ((flat ^ half) - half).to(torch.int32)    # sign-extend


def pack_flags(flags: torch.Tensor) -> torch.Tensor:
    """bool[n] -> int32[packed_word_count(n, 1)] at 1 bit/value."""
    return pack_words(flags, 1)


def unpack_flags(words: torch.Tensor, n: int) -> torch.Tensor:
    return unpack_words(words, n, 1, signed=False).to(torch.bool)


class EncodedPacked(NamedTuple):
    """The packed wire: words, the capped exact-outlier table, an 8-byte
    header (n_outliers/overflow + eb), and the REL sign plane."""
    words: torch.Tensor        # int32[n_words] — bin_bits-wide packed bins
    out_idx: torch.Tensor      # int32[K], n = "empty slot"
    out_payload: torch.Tensor  # int32[K] — original IEEE bits, bit-exact
    n_outliers: torch.Tensor   # int32 0-d
    overflow: torch.Tensor     # bool 0-d: n_outliers > K (bound NOT met)
    sign_words: torch.Tensor | None  # int32[n_sign_words] (REL only)
    eb: torch.Tensor | None    # 0-d traced bound (NOA / per-tensor eb)

    def wire_bits(self, cfg: QuantizerConfig | None = None) -> int:
        """Static wire size in bits, tile padding included."""
        bits = 32 * self.words.shape[0]
        bits += self.out_idx.shape[0] * (32 + 32)
        if self.sign_words is not None:
            bits += 32 * self.sign_words.shape[0]
        return bits + 64                     # n_outliers/overflow + eb header


def check_f32(x: torch.Tensor) -> None:
    """The packed wire's outlier payload is a 32-bit plane: float32 only."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"the packed wire carries float32 data only, got {x.dtype} "
            "(ROADMAP C-port-2: float64 on the packed wire)")


def outlier_table(flat: torch.Tensor, outlier: torch.Tensor, k: int):
    """(out_idx, out_payload, n_outliers, overflow): the first k outlier
    indices in ascending order, filled with n, and their IEEE bits.
    `nonzero_static` keeps the shape static (no host sync on the card)."""
    n = flat.shape[0]
    n_out = outlier.sum(dtype=torch.int32)
    idx = torch.nonzero_static(outlier, size=k, fill_value=n).reshape(-1)
    bits = float_to_bits(flat)[idx.clamp(max=n - 1)]
    payload = torch.where(idx < n, bits, torch.zeros_like(bits))
    return idx.to(torch.int32), payload, n_out, n_out > k


def eb_plane(eb, flat: torch.Tensor):
    """The wire's eb field: None for static bounds, else a 0-d tensor."""
    if eb is None:
        return None
    if torch.is_tensor(eb):
        return eb.to(device=flat.device, dtype=flat.dtype).reshape(())
    return q.full_scalar(eb, flat.dtype, flat.device)


def encode_packed(x: torch.Tensor, cfg: QuantizerConfig,
                  eb=None) -> EncodedPacked:
    """Quantize + bit-pack with plain torch ops (the reference path; the
    fused kernels in `repro_torch.kernels.pack` are its bit-exact twin)."""
    flat = x.reshape(-1)
    check_f32(flat)
    k = cfg.outlier_cap(flat.shape[0])
    if cfg.mode == "abs":
        qt = q.quantize_abs(flat, cfg, eb=eb)
    elif cfg.mode == "rel":
        qt = q.quantize_rel(flat, cfg)
    else:
        qt, eb = q.quantize_noa(flat, cfg)
    words = pack_words(qt.bins, cfg.bin_bits)
    sign_words = None if qt.sign is None else pack_flags(qt.sign)
    return EncodedPacked(words, *outlier_table(flat, qt.outlier, k),
                         sign_words, eb_plane(eb, flat))


def scatter_outliers_(buf: torch.Tensor, n: int, out_idx: torch.Tensor,
                      out_payload: torch.Tensor) -> torch.Tensor:
    """Write the exact outlier values over the reconstructions in buf[:n],
    in place; returns buf[:n].  Slots outside [0, n) are dropped (the fill
    value n marks empties; negative slots wrap first, as the reference's
    `.at[].set(mode="drop")` does) into buf[n], a spare element, so no
    data-dependent shape (and no host sync) is needed."""
    idx = out_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    buf.index_put_((idx,), bits_to_float(out_payload.to(torch.int32),
                                         buf.dtype))
    return buf[:n]


def decode_packed(enc: EncodedPacked, cfg: QuantizerConfig, n: int | None = None,
                  shape=None, dtype=None) -> torch.Tensor:
    """Unpack + dequantize + exact outlier restore.  `n` (or `shape`) gives
    the true element count; the packed stream carries pad words."""
    if n is None:
        if shape is None:
            raise ValueError("decode_packed needs n or shape")
        n = int(np.prod(shape))
    dt = dtype or getattr(torch, cfg.dtype)
    bins = unpack_words(enc.words, n, cfg.bin_bits)
    if cfg.mode == "rel":
        sign = unpack_flags(enc.sign_words, n)
        recon = q.dequantize_rel(bins, sign, cfg, dtype=dt)
    else:
        recon = q.dequantize_abs(bins, cfg, eb=enc.eb, dtype=dt)
    buf = recon.new_empty(n + 1)     # the spare element takes dropped slots
    buf[:n] = recon
    recon = scatter_outliers_(buf, n, enc.out_idx, enc.out_payload)
    return recon.reshape(shape) if shape is not None else recon

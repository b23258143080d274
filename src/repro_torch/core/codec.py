"""The fixed-shape codec over the quantizers, in torch (counterpart of
`repro.core.codec`): the dense and compact layouts (further down), and the
packed wire (§4 layout): bins bit-packed into 32-bit lane words, the REL
sign plane at 1 bit/value, and the capped exact outlier table (the first K outlier indices in ascending order, filled with
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
    # int32 throughout: a field's bits are its value's low bits (the cast
    # wraps), and a shift into the top bits wraps as the uint32 shift does
    u = torch.zeros(n_words * vpw, dtype=torch.int32, device=values.device)
    u[:n] = values.to(torch.int32) & ((1 << bin_bits) - 1 if vpw > 1 else -1)
    grp = u.reshape(-1, vpw, PACK_LANES)
    word = grp[:, 0, :].clone()
    for i in range(1, vpw):
        word |= grp[:, i, :] << (i * bin_bits)
    return word.reshape(-1)


def unpack_words(words: torch.Tensor, n: int, bin_bits: int,
                 signed: bool = True) -> torch.Tensor:
    """Inverse of pack_words.  Returns int32[n]: sign-extended bins, or the
    raw bin_bits-wide fields when signed=False.  Runs in int32: a shift
    then a mask to bin_bits < 32 bits, the xor and the subtract give the
    bits their uint32 forms give, mod 2^32."""
    vpw = 32 // bin_bits
    w = words if words.dtype == torch.int32 else to_i32(words.to(torch.int64))
    w = w.reshape(-1, PACK_LANES)
    if vpw == 1:
        flat = w.reshape(-1)[:n].clone()
    else:
        mask = (1 << bin_bits) - 1
        out = torch.empty((w.shape[0], vpw, PACK_LANES), dtype=torch.int32,
                          device=w.device)
        for i in range(vpw):
            torch.bitwise_and(w >> (i * bin_bits), mask, out=out[:, i, :])
        flat = out.reshape(-1)[:n]
    if signed and bin_bits < 32:
        half = 1 << (bin_bits - 1)
        flat ^= half                                  # sign-extend
        flat -= half
    return flat


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


def encode_packed(x: torch.Tensor, cfg: QuantizerConfig, eb=None, *,
                  return_quantized: bool = False, bin_transform=None):
    """Quantize + bit-pack with plain torch ops (the reference path; the
    fused kernels in `repro_torch.kernels.pack` are its bit-exact twin).
    With return_quantized, also returns the local `Quantized` (its bins
    untransformed).  `bin_transform` (the predictor hook, `core.predict`)
    is an exact int32 bijection applied to the bin plane just before
    packing; `decode_packed`'s `bin_untransform` inverts it."""
    flat = x.reshape(-1)
    check_f32(flat)
    k = cfg.outlier_cap(flat.shape[0])
    if cfg.mode == "abs":
        qt = q.quantize_abs(flat, cfg, eb=eb)
    elif cfg.mode == "rel":
        qt = q.quantize_rel(flat, cfg)
    else:
        qt, eb = q.quantize_noa(flat, cfg)
    enc = pack_quantized(flat, qt, cfg, eb, k, bin_transform)
    return (enc, qt) if return_quantized else enc


def pack_quantized(flat: torch.Tensor, qt, cfg: QuantizerConfig, eb, k: int,
                   bin_transform=None) -> EncodedPacked:
    """The packed wire of quantized planes: the outlier table, the
    (transformed) bins packed at cfg.bin_bits, the sign plane at 1 bit."""
    bins = qt.bins if bin_transform is None else bin_transform(qt.bins)
    words = pack_words(bins, cfg.bin_bits)
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
                  shape=None, dtype=None, bin_untransform=None) -> torch.Tensor:
    """Unpack + dequantize + exact outlier restore.  `n` (or `shape`) gives
    the true element count; the packed stream carries pad words.
    `bin_untransform` inverts the encode-side `bin_transform` on the
    unpacked plane before dequantizing."""
    if n is None:
        if shape is None:
            raise ValueError("decode_packed needs n or shape")
        n = int(np.prod(shape))
    dt = dtype or getattr(torch, cfg.dtype)
    bins = unpack_words(enc.words, n, cfg.bin_bits)
    if bin_untransform is not None:
        bins = bin_untransform(bins)
    if cfg.mode == "rel":
        sign = unpack_flags(enc.sign_words, n)
        recon = q.dequantize_rel(bins, sign, cfg, dtype=dt)
    else:
        recon = q.dequantize_abs(bins, cfg, eb=enc.eb, dtype=dt)
    buf = recon.new_empty(n + 1)     # the spare element takes dropped slots
    buf[:n] = recon
    recon = scatter_outliers_(buf, n, enc.out_idx, enc.out_payload)
    return recon.reshape(shape) if shape is not None else recon


def outlier_planes(n: int, out_idx: torch.Tensor, out_payload: torch.Tensor):
    """The outlier table as dense planes (outlier bool[n], payload int32[n]
    IEEE bits, 0 elsewhere), for the dense dequantize kernels.  Slots are
    resolved as `scatter_outliers_` resolves them: negatives wrap, those
    outside [0, n) drop into one spare element."""
    idx = out_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    dev = out_idx.device
    outlier = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    outlier[idx] = True
    pdt = torch.int64 if out_payload.element_size() == 8 else torch.int32
    payload = torch.zeros(n + 1, dtype=pdt, device=dev)
    payload.index_put_((idx,), out_payload.to(pdt))
    return outlier[:n], payload[:n]


# ---------------------------------------------------------------------------
# The dense and compact layouts (the reference's fixed-shape codec)
# ---------------------------------------------------------------------------
#
# DENSE keeps bins, the outlier flags and the outliers' exact bits at every
# index (0 where not an outlier); COMPACT keeps the bins and the capped
# outlier table of the packed wire, unpacked.  float32 data goes through
# `kernels.dense` (B8/B9 to quantize, B10/B11 to decode: the kernels on the
# card, their plain versions on the CPU); float64 through the torch
# quantizers on any device (the dense kernels take float32 only).

_BIN_DTYPE = {8: torch.int8, 16: torch.int16, 32: torch.int32}


class EncodedDense(NamedTuple):
    bins: torch.Tensor         # int{8,16,32}[n]
    outlier: torch.Tensor      # bool[n]
    payload: torch.Tensor      # int32 (float64: int64) IEEE bits at outliers
    sign: torch.Tensor | None  # bool[n] (REL only)
    eb: torch.Tensor | None    # 0-d traced bound (NOA / per-tensor eb)


class EncodedCompact(NamedTuple):
    bins: torch.Tensor         # int{8,16,32}[n]
    out_idx: torch.Tensor      # int32[K], n = "empty slot"
    out_payload: torch.Tensor  # int32 (float64: int64) IEEE bits [K]
    n_outliers: torch.Tensor   # int32 0-d
    overflow: torch.Tensor     # bool 0-d: n_outliers > K (bound NOT met)
    sign: torch.Tensor | None
    eb: torch.Tensor | None

    def wire_bits(self, cfg: QuantizerConfig) -> int:
        """Static wire size in bits (what the collective moves)."""
        n = self.bins.shape[0]
        k = self.out_idx.shape[0]
        elem = self.out_payload.element_size() * 8
        sign_bits = n if self.sign is not None else 0
        return n * cfg.bin_bits + k * (32 + elem) + sign_bits + 64


def _narrow(bins: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    return bins.to(_BIN_DTYPE[cfg.bin_bits])


def _dense_kernels(dt: torch.dtype):
    """`kernels.dense` for float32 data, None for float64 (imported here:
    it imports this module)."""
    if dt != torch.float32:
        return None
    from ..kernels import dense
    return dense


def quantize_flat(flat: torch.Tensor, cfg: QuantizerConfig, eb):
    """(Quantized, eb) as the reference's encoders dispatch on the mode: eb
    passes through for ABS and REL, NOA replaces it with its range bound."""
    k = _dense_kernels(flat.dtype)
    if k is None:
        if cfg.mode == "noa":
            return q.quantize_noa(flat, cfg)
        if cfg.mode == "rel":
            return q.quantize_rel(flat, cfg), eb
        return q.quantize_abs(flat, cfg, eb=eb), eb
    if cfg.mode == "rel":
        return k.quantize_rel(flat, cfg), eb
    if cfg.mode == "noa":
        eb = q.value_range_eb(flat, cfg)
    return k.quantize_abs(flat, cfg, eb=eb), eb


def decode_planes(bins, payload, outlier, sign, eb, cfg: QuantizerConfig,
                  dt: torch.dtype) -> torch.Tensor:
    """bins dequantized in dt, with the exact value of payload's bits where
    outlier is set."""
    bins = bins.to(torch.int32)
    k = _dense_kernels(dt)
    if k is not None and cfg.mode == "rel":
        return k.dequantize_rel(bins, payload, outlier, sign, cfg)
    if k is not None:
        return k.dequantize_abs(bins, payload, outlier, cfg, eb=eb)
    if cfg.mode == "rel":
        recon = q.dequantize_rel(bins, sign, cfg, dtype=dt)
    else:
        recon = q.dequantize_abs(bins, cfg, eb=eb, dtype=dt)
    return torch.where(outlier, bits_to_float(payload, dt), recon)


def encode_dense(x: torch.Tensor, cfg: QuantizerConfig, eb=None) -> EncodedDense:
    flat = x.reshape(-1)
    qt, eb = quantize_flat(flat, cfg, eb)
    bits = float_to_bits(flat)
    payload = torch.where(qt.outlier, bits, torch.zeros_like(bits))
    return EncodedDense(_narrow(qt.bins, cfg), qt.outlier, payload, qt.sign,
                        eb_plane(eb, flat))


def decode_dense(enc: EncodedDense, cfg: QuantizerConfig, shape=None):
    vals = decode_planes(enc.bins, enc.payload, enc.outlier, enc.sign,
                          enc.eb, cfg, getattr(torch, cfg.dtype))
    return vals.reshape(shape) if shape is not None else vals


def encode_compact(x: torch.Tensor, cfg: QuantizerConfig,
                   eb=None) -> EncodedCompact:
    """The bins and the first K = cfg.outlier_cap(n) outliers' exact bits
    (`outlier_table`); `overflow` reports n_outliers > K."""
    flat = x.reshape(-1)
    qt, eb = quantize_flat(flat, cfg, eb)
    table = outlier_table(flat, qt.outlier, cfg.outlier_cap(flat.shape[0]))
    return EncodedCompact(_narrow(qt.bins, cfg), *table, qt.sign,
                          eb_plane(eb, flat))


def decode_compact(enc: EncodedCompact, cfg: QuantizerConfig, shape=None,
                   dtype=None):
    """Dequantize and restore the table's exact values; empty slots (index
    n) drop, as the reference's `.at[].set(mode="drop")` drops them."""
    dt = dtype or getattr(torch, cfg.dtype)
    outlier, payload = outlier_planes(enc.bins.shape[0], enc.out_idx,
                                      enc.out_payload)
    vals = decode_planes(enc.bins, payload, outlier, enc.sign, enc.eb, cfg,
                          dt)
    return vals.reshape(shape) if shape is not None else vals


def roundtrip_dense(x: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    """Encode + decode; the decoded result carries the full guarantee."""
    return decode_dense(encode_dense(x, cfg), cfg, shape=x.shape)


# ---------------------------------------------------------------------------
# The chunked zero/narrow coder (the reference's DESIGN.md §6)
# ---------------------------------------------------------------------------
#
# The packed word stream is cut into chunks of LC_CHUNK = 512 words (4 word
# rows x PACK_LANES), zero-padded at the end.  Each chunk gets a 2-bit code
# from its largest word, read as uint32:
#
#   code 0 — every word zero: dropped (0 payload words);
#   code 1 — every word < 2^8:  stored at  8 bits/word (4 words/uint32);
#   code 2 — every word < 2^16: stored at 16 bits/word (2 words/uint32);
#   code 3 — verbatim words.
#
# Stage 'zero' uses codes {0, 3} only; 'narrow' the full set.  A chunk's
# narrowed image is pack_words(chunk, width).  The codes pack at 2 bits
# into the stage's header plane.  The payload is carried padded to
# capacity (n_chunks * LC_CHUNK words) with the used word count in
# `payload_len`, which is all a transport moves.

LC_CHUNK = 512                 # words per chunk (4 x PACK_LANES)
LC_STAGES = ("zero", "narrow")
_LC_WIDTHS = (0, 8, 16, 32)    # stored word width per header code
_LC_LENS = tuple(LC_CHUNK * w // 32 for w in _LC_WIDTHS)   # payload words


def transmitted_bits(payload_len: torch.Tensor, static_bits: int):
    """The transmitted wire size in bits, as a 0-d float32 tensor on
    payload_len's device: `static_bits` (headers, tables, length fields)
    plus 32 bits per transmitted payload word.  The static part is folded
    into the word count as exact int32 and converted to float32 once, as
    the reference does: exact through 2^24 words, one rounding beyond."""
    static_words, rem = divmod(static_bits, 32)
    words = payload_len.to(torch.int32) + static_words
    return words.to(torch.float32) * 32.0 + rem


_SUM_WINDOW = 32


def f32_sum(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a 1-d plane in the order the reference's CPU
    build sums it, so that sums past 2^24 round the same way: while more
    than 32 values remain, pad with zeros (half of the padding in front,
    the larger half behind) to windows of 32 and fold each window from 0
    in index order; then fold what is left from 0.  A 0-d float32 tensor
    on v's device, no host sync.  (Under jit the reference fuses an
    elementwise producer of up to 32 values into its sum: ROADMAP
    C-port-5.)"""
    v = v.reshape(-1).to(torch.float32)
    while v.shape[0] > _SUM_WINDOW:
        pad = (-v.shape[0]) % _SUM_WINDOW
        win = torch.cat([v.new_zeros(pad // 2), v,
                         v.new_zeros(pad - pad // 2)]).reshape(-1, _SUM_WINDOW)
        v = torch.zeros(win.shape[0], dtype=torch.float32, device=v.device)
        for j in range(_SUM_WINDOW):
            v = v + win[:, j]
    total = torch.zeros((), dtype=torch.float32, device=v.device)
    for i in range(v.shape[0]):
        total = total + v[i]
    return total


def lc_chunk_count(n_words: int) -> int:
    return -(-n_words // LC_CHUNK)


def lc_header_words(n_words: int) -> int:
    """Words of the stored 2-bit header plane (tile-padded, pad zero)."""
    return packed_word_count(lc_chunk_count(n_words), 2)


def lc_header_content_words(n_chunks: int) -> int:
    """Words of real header content (16 codes per word): what a transport
    moves; the receiver re-pads the stored plane."""
    return -(-n_chunks // 16)


def lc_chunk_codes(chunks: torch.Tensor, stage: str) -> torch.Tensor:
    """Per-chunk width code, int32[n_chunks].  chunks: int32[n_chunks,
    LC_CHUNK] holding uint32 bits.  The max is the unsigned one: a word
    with bit 31 set is negative as int32, and makes its chunk code 3."""
    if stage not in LC_STAGES:
        raise ValueError(f"lossless stage must be one of {LC_STAGES}")
    high = (chunks < 0).any(dim=1)
    mx = chunks.amax(dim=1)          # the unsigned max where no word is < 0
    nonzero = high | (mx != 0)
    if stage == "zero":
        codes = torch.where(nonzero, 3, 0)
    else:
        codes = torch.where(~nonzero, 0,
                            torch.where(high | (mx >= 1 << 16), 3,
                                        torch.where(mx >= 1 << 8, 2, 1)))
    return codes.to(torch.int32)


def lc_chunk_lens(codes: torch.Tensor) -> torch.Tensor:
    """Payload words each chunk occupies, from its code (_LC_LENS),
    computed on the codes' device with no table copied from the host."""
    return torch.where(codes == 3, LC_CHUNK,
                       codes * (LC_CHUNK // 4)).to(torch.int32)


def lc_narrow_chunks(chunks: torch.Tensor, codes: torch.Tensor):
    """Narrow each chunk to its code's width, left-aligned and zero-padded
    to LC_CHUNK words (the compaction strips the padding)."""
    n_chunks = chunks.shape[0]
    flat = chunks.reshape(-1)
    cand1 = pack_words(flat, 8).reshape(n_chunks, LC_CHUNK // 4)
    cand2 = pack_words(flat, 16).reshape(n_chunks, LC_CHUNK // 2)
    pad1 = torch.cat([cand1, cand1.new_zeros(n_chunks, 3 * LC_CHUNK // 4)], 1)
    pad2 = torch.cat([cand2, cand2.new_zeros(n_chunks, LC_CHUNK // 2)], 1)
    c = codes[:, None]
    return torch.where(c == 1, pad1,
                       torch.where(c == 2, pad2,
                                   torch.where(c == 3, chunks,
                                               torch.zeros_like(chunks))))


def compact_chunks(sel: torch.Tensor, lens: torch.Tensor):
    """Concatenate per-chunk word prefixes at their true lengths.  sel:
    int32[n_chunks, LC_CHUNK] (each chunk's words left-aligned), lens:
    int32[n_chunks] words used per chunk.  Returns (payload
    int32[n_chunks * LC_CHUNK], tail zero; payload_len int32 0-d)."""
    payload, plen = compact_chunk_rows(sel[None], lens[None])
    return payload[0], plen[0]


def compact_chunk_rows(sel: torch.Tensor, lens: torch.Tensor):
    """`compact_chunks` of each row on its own: sel int32[R, n_chunks,
    LC_CHUNK], lens int32[R, n_chunks] -> (payload int32[R, n_chunks *
    LC_CHUNK], payload_len int32[R]).  A row is one stream (a KV page):
    its offsets are a cumsum along the row.

    Slots past a chunk's length, and destinations outside the row
    (negative ones wrap first, as the reference's `.at[].set(mode="drop")`
    does), go to one spare word past the row's end, so no mask and no host
    sync is needed."""
    rows, n_chunks = lens.shape
    cap = n_chunks * LC_CHUNK
    lens = lens.to(torch.int32)
    ends = torch.cumsum(lens, 1, dtype=torch.int32)
    offs = ends - lens
    slot = torch.arange(LC_CHUNK, dtype=torch.int32, device=sel.device)
    dest = (offs[..., None] + slot).to(torch.int64)
    dest = torch.where(dest < 0, dest + cap, dest)
    keep = (slot < lens[..., None]) & (dest >= 0) & (dest < cap)
    dest = torch.where(keep, dest, cap)
    base = torch.arange(rows, dtype=torch.int64,
                        device=sel.device)[:, None, None] * (cap + 1)
    payload = torch.zeros(rows * (cap + 1), dtype=torch.int32,
                          device=sel.device)
    payload.index_put_(((dest + base).reshape(-1),),
                       sel.reshape(-1).to(torch.int32))
    return payload.reshape(rows, cap + 1)[:, :cap], ends[:, -1]


def gather_chunks(payload: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Inverse of compact_chunks: re-pad each chunk's words to LC_CHUNK
    slots.  Returns int32[n_chunks, LC_CHUNK].  Over-long (corrupt)
    lengths are clamped to the plane, as in the reference; the decode
    entries check the transmitted length on the host first."""
    return gather_chunk_rows(payload[None], lens[None])[0]


def gather_chunk_rows(payload: torch.Tensor, lens: torch.Tensor):
    """`gather_chunks` of each row on its own: payload int32[R, W], lens
    int32[R, n_chunks] -> int32[R, n_chunks, LC_CHUNK]."""
    rows, n_chunks = lens.shape
    lens = lens.to(torch.int32)
    ends = torch.cumsum(lens, 1, dtype=torch.int32)
    offs = ends - lens
    slot = torch.arange(LC_CHUNK, dtype=torch.int32, device=payload.device)
    valid = slot < lens[..., None]
    src = torch.where(valid, offs[..., None] + slot, 0)
    src = src.clamp(0, payload.shape[1] - 1).to(torch.int64)
    got = torch.gather(payload, 1, src.reshape(rows, -1))
    return torch.where(valid, got.reshape(rows, n_chunks, LC_CHUNK), 0)


def pack_word_rows(values: torch.Tensor, bin_bits: int) -> torch.Tensor:
    """`pack_words` of each row of values [R, n] on its own:
    int32[R, packed_word_count(n, bin_bits)].  Each row is zero-padded to
    whole tiles, so the rows pack as one stream."""
    vpw = 32 // bin_bits
    rows, n = values.shape
    tile = vpw * PACK_LANES
    pad = -(-n // tile) * tile - n
    if pad:
        values = torch.cat([values, values.new_zeros(rows, pad)], 1)
    return pack_words(values.reshape(-1), bin_bits).reshape(rows, -1)


def unpack_word_rows(words: torch.Tensor, n: int, bin_bits: int,
                     signed: bool = True) -> torch.Tensor:
    """Inverse of pack_word_rows: words int32[R, W] (W whole tiles) ->
    int32[R, n]."""
    rows, w = words.shape
    per = w * (32 // bin_bits)
    return unpack_words(words.reshape(-1), rows * per, bin_bits,
                        signed).reshape(rows, per)[:, :n]


def lc_compact_payload(sel: torch.Tensor, codes: torch.Tensor):
    """compact_chunks with the per-code chunk lengths."""
    return compact_chunks(sel, lc_chunk_lens(codes))


def lc_gather_chunks(payload: torch.Tensor, codes: torch.Tensor):
    """Inverse of lc_compact_payload: int32[n_chunks, LC_CHUNK]."""
    return gather_chunks(payload, lc_chunk_lens(codes))


def lc_expand_chunks(padded: torch.Tensor, codes: torch.Tensor):
    """Widen narrowed chunks back to 32-bit words (the exact inverse of
    lc_narrow_chunks for the valid prefix)."""
    n_chunks = padded.shape[0]
    flat_n = n_chunks * LC_CHUNK
    exp1 = unpack_words(padded[:, :LC_CHUNK // 4].reshape(-1), flat_n, 8,
                        signed=False).reshape(n_chunks, LC_CHUNK)
    exp2 = unpack_words(padded[:, :LC_CHUNK // 2].reshape(-1), flat_n, 16,
                        signed=False).reshape(n_chunks, LC_CHUNK)
    c = codes[:, None]
    return torch.where(c == 1, exp1,
                       torch.where(c == 2, exp2,
                                   torch.where(c == 3, padded,
                                               torch.zeros_like(padded))))


def lc_chunks(words: torch.Tensor) -> torch.Tensor:
    """A word plane zero-padded to whole chunks: int32[n_chunks, LC_CHUNK]."""
    n_chunks = lc_chunk_count(words.shape[0])
    pad = words.new_zeros(n_chunks * LC_CHUNK - words.shape[0])
    return torch.cat([words, pad]).reshape(n_chunks, LC_CHUNK)


def encode_words_lc(words: torch.Tensor, stage: str = "narrow"):
    """Lossless-code a packed word plane.  Returns (header_words, payload,
    payload_len); exact."""
    chunks = lc_chunks(words)
    codes = lc_chunk_codes(chunks, stage)
    sel = lc_narrow_chunks(chunks, codes)
    payload, plen = lc_compact_payload(sel, codes)
    return pack_words(codes, 2), payload, plen


def decode_words_lc(header_words: torch.Tensor, payload: torch.Tensor,
                    n_words: int) -> torch.Tensor:
    """Exact inverse of encode_words_lc; n_words is the word count that
    went in."""
    codes = unpack_words(header_words, lc_chunk_count(n_words), 2,
                         signed=False)
    padded = lc_gather_chunks(payload, codes)
    return lc_expand_chunks(padded, codes).reshape(-1)[:n_words]


class EncodedLC(NamedTuple):
    """The packed wire after the chunk coder.  `payload` is padded to
    capacity; only `payload_len` words of it (plus the header content and
    the outlier table) are transmitted, and wire_bits counts those."""
    header_words: torch.Tensor   # int32 — 2-bit per-chunk width codes
    payload: torch.Tensor        # int32[capacity] — compacted chunk data
    payload_len: torch.Tensor    # int32 0-d — words actually used
    out_idx: torch.Tensor        # int32[K], n = "empty slot"
    out_payload: torch.Tensor    # int32[K] — original IEEE bits
    n_outliers: torch.Tensor     # int32 0-d
    overflow: torch.Tensor       # bool 0-d (bound NOT met when True)
    sign_words: torch.Tensor | None  # int32 (REL only, not chunk-coded)
    eb: torch.Tensor | None      # 0-d traced bound

    def wire_bits(self, cfg: QuantizerConfig | None = None) -> torch.Tensor:
        """Transmitted bits (0-d float32, data-dependent): header content,
        outlier table, sign plane, the 64-bit packed header and the 32-bit
        length field, plus the transmitted payload words."""
        n_chunks = self.payload.shape[0] // LC_CHUNK
        static = 32 * lc_header_content_words(n_chunks)
        static += self.out_idx.shape[0] * (32 + 32)
        if self.sign_words is not None:
            static += 32 * self.sign_words.shape[0]
        static += 64 + 32
        return transmitted_bits(self.payload_len, static)


def encode_lossless(enc: EncodedPacked, stage: str = "narrow") -> EncodedLC:
    """Run the chunk coder over an EncodedPacked (plain torch ops)."""
    header_words, payload, plen = encode_words_lc(enc.words, stage)
    return EncodedLC(header_words, payload, plen, enc.out_idx,
                     enc.out_payload, enc.n_outliers, enc.overflow,
                     enc.sign_words, enc.eb)


def decode_lossless(lc: EncodedLC, n_words: int) -> EncodedPacked:
    """Exact inverse of encode_lossless; n_words as in decode_words_lc."""
    words = decode_words_lc(lc.header_words, lc.payload, n_words)
    return EncodedPacked(words, lc.out_idx, lc.out_payload, lc.n_outliers,
                         lc.overflow, lc.sign_words, lc.eb)


# ---------------------------------------------------------------------------
# SHUFFLE: zigzag sign-fold + byte-plane shuffle (a lossless word stage)
# ---------------------------------------------------------------------------
#
# Two's-complement small negatives set the high bits of every word they
# touch, so the chunk codes never fire on mixed-sign bin streams.  The
# stage zigzag-folds each `width`-bit lane, z = (v << 1) ^ (v >> width-1),
# so small |v| of either sign has clear high bytes, then (width < 32)
# transposes byte j of every lane into a contiguous plane, so the cleared
# high bytes form whole all-zero chunks.  At width 32 a lane is a word and
# only the fold applies.  The stream is padded to whole PACK_LANES tiles;
# the work runs in int64 holding the uint32 lanes.


def _width_mask(width: int) -> int:
    return _U32 if width == 32 else (1 << width) - 1


def _zigzag(lanes: torch.Tensor, width: int) -> torch.Tensor:
    """int64 lanes holding width-bit two's complement -> zigzag codes
    (int64 in [0, 2^width))."""
    half = 1 << (width - 1)
    v = ((lanes & _width_mask(width)) ^ half) - half      # sign-extend
    z = (v << 1) ^ (v >> 63)
    return z & _width_mask(width)


def _unzigzag(z: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of _zigzag on int64 codes in [0, 2^width)."""
    v = (z >> 1) ^ -(z & 1)
    return v & _width_mask(width)


def shuffle_word_count(n_words: int) -> int:
    """Words `shuffle_words` emits for an n_words stream (tile-padded)."""
    return -(-n_words // PACK_LANES) * PACK_LANES


def shuffle_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """Fold + byte-plane-shuffle a packed word stream whose lanes are
    `width`-bit values (width in {8, 16, 32}); unshuffle_words inverts
    it."""
    return shuffle_word_rows(words[None], width)[0]


def shuffle_word_rows(words: torch.Tensor, width: int) -> torch.Tensor:
    """`shuffle_words` of each row of words int32[R, n] on its own (a row
    is one stream: its byte planes stay in the row)."""
    if width not in (8, 16, 32):
        raise ValueError(f"shuffle width must be 8, 16 or 32, got {width}")
    rows, n_words = words.shape
    npad = shuffle_word_count(n_words)
    w = torch.cat([words, words.new_zeros(rows, npad - n_words)], 1)
    if width == 32:
        return to_i32(_zigzag(w.to(torch.int64), 32))
    lanes = unpack_word_rows(w, npad * 32 // width, width, signed=False)
    z = _zigzag(lanes.to(torch.int64), width)
    planes = torch.stack([(z >> (8 * j)) & 0xFF for j in range(width // 8)],
                         1)
    return pack_word_rows(planes.reshape(rows, -1), 8)


def unshuffle_words(shuffled: torch.Tensor, n_words: int,
                    width: int) -> torch.Tensor:
    """Exact inverse of shuffle_words; n_words is the pre-shuffle count."""
    return unshuffle_word_rows(shuffled[None], n_words, width)[0]


def unshuffle_word_rows(shuffled: torch.Tensor, n_words: int,
                        width: int) -> torch.Tensor:
    """Exact inverse of shuffle_word_rows: int32[R, npad] -> [R, n_words]."""
    rows = shuffled.shape[0]
    npad = shuffle_word_count(n_words)
    if width == 32:
        z = shuffled[:, :npad].to(torch.int64) & _U32
        return to_i32(_unzigzag(z, 32))[:, :n_words]
    n_lanes = npad * 32 // width
    stream = unpack_word_rows(shuffled[:, :npad], 4 * npad, 8, signed=False)
    planes = stream.to(torch.int64).reshape(rows, width // 8, n_lanes)
    z = planes[:, 0]
    for j in range(1, width // 8):
        z = z | (planes[:, j] << (8 * j))
    return pack_word_rows(_unzigzag(z, width), width)[:, :n_words]


# ---------------------------------------------------------------------------
# ENT: static canonical entropy coder over surviving chunk payloads
# ---------------------------------------------------------------------------
#
# The input word stream is chunked as for the zero/narrow coder (LC_CHUNK
# words).  Each chunk gets a 2-bit mode: 0 all words zero (dropped), 1
# entropy-coded (its 2048 bytes, little-endian within each word, as a
# variable-length bitstream padded to whole words, with its bit length in
# the header), 2 verbatim (the coded stream would exceed 512 words).  One
# canonical prefix code serves every chunk, built from the byte histogram
# of the surviving chunks: Shannon lengths ceil(-log2 p) read off the
# float32 exponent bits, clipped to ENT_MAX_LEN, then a Kraft-budget sweep
# in descending frequency.  Only the 256 4-bit lengths travel; the codes
# and the 2^ENT_MAX_LEN-entry decode table rebuild from them.  Codes
# deposit first bit at the lowest bit (LSB-first within words), so encode
# is a cumsum and a disjoint-bit scatter-add, and decode reads a window of
# ENT_MAX_LEN bits per symbol, chunk by chunk in parallel.  The sorts are
# stable (`jnp.argsort` is); both scans stay on the device.

ENT_MAX_LEN = 12               # max code length; decode LUT = 2^12 entries
ENT_SYMS = 256                 # byte alphabet
_ENT_CHUNK_SYMS = 4 * LC_CHUNK            # 2048 coded bytes per chunk
_ENT_CHUNK_CAP_BITS = 32 * LC_CHUNK       # verbatim-escape threshold
_ENT_BUF_WORDS = _ENT_CHUNK_SYMS * ENT_MAX_LEN // 32   # worst-case coded

def _ent_rev(device) -> torch.Tensor:
    """The bit reversal of every ENT_MAX_LEN-bit value (the canonical code
    is MSB-first, the stream LSB-first), built on `device` with device ops
    (no host copy)."""
    a = torch.arange(1 << ENT_MAX_LEN, dtype=torch.int32, device=device)
    rev = torch.zeros_like(a)
    for j in range(ENT_MAX_LEN):
        rev = (rev << 1) | ((a >> j) & 1)
    return rev


def ent_header_words(n_words: int) -> int:
    """Words of the stored `ent` header plane: the 4-bit codebook lengths,
    the 2-bit chunk modes and the 16-bit chunk bit lengths, each
    tile-padded."""
    nc = lc_chunk_count(n_words)
    return (packed_word_count(ENT_SYMS, 4) + packed_word_count(nc, 2)
            + packed_word_count(nc, 16))


def ent_header_content_words(n_chunks: int) -> int:
    """Words of real header content (what a transport moves): 32 words of
    codebook lengths + 2 bits/chunk of modes + 16 bits/chunk of bit
    lengths."""
    return (ENT_SYMS * 4 // 32 + lc_header_content_words(n_chunks)
            + -(-n_chunks // 2))


def _floor_log2_f32(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) for positive normal float32: the unbiased exponent,
    integer work only."""
    return ((float_to_bits(x) >> 23) & 0xFF) - 127


def ent_code_lengths(hist: torch.Tensor) -> torch.Tensor:
    """Length-limited code lengths (1..ENT_MAX_LEN), int32[256], from a
    256-bin symbol histogram (int32[256]): the Shannon ideal clipped, then
    a budget scan in descending frequency (stable order) that keeps the
    Kraft sum <= 1.  The 256 steps run on the histogram's device."""
    lmax, dev = ENT_MAX_LEN, hist.device
    hist = hist.to(torch.int32)
    total = torch.clamp(hist.sum(dtype=torch.int32), min=1).to(torch.float32)
    p = torch.clamp(hist.to(torch.float32) / total, min=2.0 ** -126)
    ideal = torch.where(hist > 0, -_floor_log2_f32(p), lmax)
    ideal = torch.clamp(ideal, 1, lmax).to(torch.int32)
    order = torch.argsort(-hist, stable=True)
    want = ideal[order]
    budget = torch.full((), 1 << lmax, dtype=torch.int32, device=dev)
    lens_sorted = torch.empty(ENT_SYMS, dtype=torch.int32, device=dev)
    for k in range(ENT_SYMS):
        rem = ENT_SYMS - 1 - k
        lmin = lmax - _floor_log2_f32((budget - rem).to(torch.float32))
        ln = torch.clamp(torch.maximum(want[k], lmin), 1, lmax)
        lens_sorted[k] = ln
        budget = budget - (1 << (lmax - ln))
    out = torch.zeros(ENT_SYMS, dtype=torch.int32, device=dev)
    return out.scatter(0, order, lens_sorted)


def _ent_canonical(lens: torch.Tensor):
    """Canonical code assignment from lengths: symbols sorted by (length,
    symbol) take consecutive codes within their length class.  Returns
    (order = symbols in canonical order, their lengths, their codes
    MSB-first), each [256]."""
    lmax, dev = ENT_MAX_LEN, lens.device
    # a wire carries 4-bit lengths: valid ones are 1..ENT_MAX_LEN, and a
    # corrupt one must not index past the tables (on the card that is a
    # device-side assert); the clamp changes no valid codebook
    lens = lens.to(torch.int32).clamp(1, lmax)
    count = torch.zeros(lmax + 1, dtype=torch.int32, device=dev)
    count.scatter_add_(0, lens.to(torch.int64), torch.ones_like(lens))
    # first[ln] = (first[ln-1] + count[ln-1]) << 1 = sum_k<ln count[k] 2^(ln-k)
    ln = torch.arange(lmax + 1, device=dev)
    sh = ln[:, None] - ln[None, :]
    weight = torch.where(sh > 0, torch.ones_like(sh) << sh.clamp(min=0), 0)
    first = (weight * count[None, :]).sum(1).to(torch.int32)
    order = torch.argsort(lens, stable=True)
    sl = lens[order]
    rank = (torch.arange(ENT_SYMS, dtype=torch.int32, device=dev)
            - torch.searchsorted(sl, sl, right=False).to(torch.int32))
    return order, sl, first[sl.to(torch.int64)] + rank


def ent_encode_table(lens: torch.Tensor):
    """(length, LSB-first deposit value) per symbol, int32[256] each: the
    canonical code bit-reversed within its length."""
    order, sl, codes = _ent_canonical(lens)
    rev_t = _ent_rev(lens.device)
    rev = rev_t[codes.clamp(0, (1 << ENT_MAX_LEN) - 1).to(torch.int64)] \
        >> (ENT_MAX_LEN - sl)
    zeros = torch.zeros(ENT_SYMS, dtype=torch.int32, device=lens.device)
    return zeros.scatter(0, order, sl), zeros.scatter(0, order, rev)


def ent_decode_lut(lens: torch.Tensor):
    """(symbol, length) decode tables, int32[2^ENT_MAX_LEN] each, indexed by
    the next ENT_MAX_LEN stream bits (LSB-first window)."""
    order, sl, codes = _ent_canonical(lens)
    starts = (codes << (ENT_MAX_LEN - sl)).contiguous()   # increasing
    win = _ent_rev(lens.device)
    j = (torch.searchsorted(starts, win, right=True) - 1).clamp(0, ENT_SYMS - 1)
    return order[j].to(torch.int32), sl[j]


def _ent_chunk_bytes(chunks: torch.Tensor) -> torch.Tensor:
    """int32[nc, LC_CHUNK] words -> int32[nc, 4 * LC_CHUNK] byte symbols in
    stream order (little-endian within each word)."""
    b = torch.stack([(chunks >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
    return b.reshape(chunks.shape[0], _ENT_CHUNK_SYMS)


def _ent_chunk_words(modes: torch.Tensor, bitlen: torch.Tensor):
    """Payload words each chunk occupies, int32[nc], from its mode and bit
    length."""
    return torch.where(modes == 1, (bitlen + 31) >> 5,
                       torch.where(modes == 2, LC_CHUNK, 0)).to(torch.int32)


def encode_words_ent(words: torch.Tensor):
    """Entropy-code a word plane (layout in the section note).  Returns
    (header_words, payload, payload_len); decode_words_ent inverts it."""
    chunks = lc_chunks(words)
    nc, dev = chunks.shape[0], chunks.device
    alive = (chunks != 0).any(dim=1)
    byts = _ent_chunk_bytes(chunks)
    # codebook from the byte histogram of the surviving chunks: one row of
    # counts per chunk (spreads the scatter), then the live rows summed
    counts = torch.zeros(nc, ENT_SYMS, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, byts.to(torch.int64), torch.ones_like(byts))
    hist = (counts * alive[:, None]).sum(0, dtype=torch.int32)
    del counts
    lens = ent_code_lengths(hist)
    sym_len, sym_code = ent_encode_table(lens)

    # per-chunk bitstream: cumsum of the code lengths, each code's <= 2 word
    # fragments deposited by scatter-add (the bits are disjoint, so add is
    # or, and no int32 sum carries).  The planes are [nc, 2048]: each is
    # freed when done, which keeps the peak of a 128M-word encode ~35 GB.
    lns = sym_len[byts]
    ends = torch.cumsum(lns, dim=1, dtype=torch.int32)
    offs = ends - lns
    bitlen = ends[:, -1].contiguous()
    del lns, ends
    code = sym_code[byts].to(torch.int64)
    del byts
    row = torch.arange(nc, device=dev)[:, None] * (_ENT_BUF_WORDS + 1)
    w_idx = (row + (offs >> 5)).reshape(-1)
    boff = (offs & 31).to(torch.int64)
    del offs
    lo = to_i32(code << boff).reshape(-1)
    hi = to_i32(torch.where(boff > 0, code >> (32 - boff), 0)).reshape(-1)
    del code, boff
    buf = torch.zeros(nc * (_ENT_BUF_WORDS + 1), dtype=torch.int32, device=dev)
    buf.index_add_(0, w_idx, lo)
    buf.index_add_(0, w_idx + 1, hi)
    del w_idx, lo, hi
    coded = buf.reshape(nc, _ENT_BUF_WORDS + 1)[:, :LC_CHUNK]
    modes = torch.where(~alive, 0, torch.where(
        bitlen <= _ENT_CHUNK_CAP_BITS, 1, 2)).to(torch.int32)
    lens_words = _ent_chunk_words(modes, bitlen)
    m = modes[:, None]
    sel = torch.where(m == 1, coded, torch.where(m == 2, chunks, 0))
    del buf, coded
    payload, plen = compact_chunks(sel, lens_words)
    header = torch.cat([pack_words(lens, 4), pack_words(modes, 2),
                        pack_words(torch.where(modes == 1, bitlen, 0), 16)])
    return header, payload, plen


def decode_words_ent(header_words: torch.Tensor, payload: torch.Tensor,
                     n_words: int) -> torch.Tensor:
    """Exact inverse of encode_words_ent; n_words is the pre-coding word
    count.  The decode is a scan of 2048 steps over all chunks at once,
    on the payload's device."""
    nc = lc_chunk_count(n_words)
    dev = payload.device
    hw_len = packed_word_count(ENT_SYMS, 4)
    hw_mode = packed_word_count(nc, 2)
    lens = unpack_words(header_words[:hw_len], ENT_SYMS, 4, signed=False)
    modes = unpack_words(header_words[hw_len:hw_len + hw_mode], nc, 2,
                         signed=False)
    bitlen = unpack_words(header_words[hw_len + hw_mode:], nc, 16,
                          signed=False)
    padded = gather_chunks(payload, _ent_chunk_words(modes, bitlen))
    lut_sym, lut_len = ent_decode_lut(lens)
    lut = (lut_sym | (lut_len << 8)).to(torch.int64)
    # word pairs: dbl[:, i] holds words i and i+1, so a window of the next
    # ENT_MAX_LEN bits at any bit offset is one shift of one entry (the
    # reference's 32-bit window read, whose low 12 bits are these)
    w = padded.to(torch.int64) & _U32
    w = torch.cat([w, w.new_zeros(nc, 2)], dim=1)
    dbl = w[:, :-1] | (w[:, 1:] << 32)
    del w
    pos = torch.zeros(nc, 1, dtype=torch.int64, device=dev)
    syms = torch.empty(_ENT_CHUNK_SYMS, nc, dtype=torch.uint8, device=dev)
    for s in range(_ENT_CHUNK_SYMS):
        win = dbl.gather(1, pos >> 5) >> (pos & 31)
        e = lut[win & ((1 << ENT_MAX_LEN) - 1)]
        syms[s] = (e & 0xFF).reshape(-1)
        # clamped: mode-0/2 rows decode garbage that the mode mask
        # discards, but their positions stay inside the row
        pos = torch.clamp(pos + (e >> 8), max=_ENT_CHUNK_CAP_BITS)
    del dbl
    b = syms.t().to(torch.int64).reshape(nc, LC_CHUNK, 4)
    decoded = to_i32(b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
                     | (b[..., 3] << 24))
    m = modes[:, None]
    out = torch.where(m == 1, decoded, torch.where(m == 2, padded, 0))
    return out.reshape(-1)[:n_words]

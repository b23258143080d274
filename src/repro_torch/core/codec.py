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
    int32[n_chunks * LC_CHUNK], tail zero; payload_len int32 0-d).

    Slots past a chunk's length, and destinations outside the plane
    (negative ones wrap first, as the reference's `.at[].set(mode="drop")`
    does), go to one spare word past the end, so no mask and no host sync
    is needed."""
    n_chunks = sel.shape[0]
    cap = n_chunks * LC_CHUNK
    lens = lens.to(torch.int32)
    ends = torch.cumsum(lens, 0, dtype=torch.int32)
    offs = ends - lens
    slot = torch.arange(LC_CHUNK, dtype=torch.int32, device=sel.device)[None, :]
    dest = (offs[:, None] + slot).to(torch.int64)
    dest = torch.where(dest < 0, dest + cap, dest)
    keep = (slot < lens[:, None]) & (dest >= 0) & (dest < cap)
    dest = torch.where(keep, dest, cap)
    payload = torch.zeros(cap + 1, dtype=torch.int32, device=sel.device)
    payload.index_put_((dest.reshape(-1),), sel.reshape(-1).to(torch.int32))
    return payload[:cap], ends[-1]


def gather_chunks(payload: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Inverse of compact_chunks: re-pad each chunk's words to LC_CHUNK
    slots.  Returns int32[n_chunks, LC_CHUNK].  Over-long (corrupt)
    lengths are clamped to the plane, as in the reference; the decode
    entries check the transmitted length on the host first."""
    lens = lens.to(torch.int32)
    ends = torch.cumsum(lens, 0, dtype=torch.int32)
    offs = ends - lens
    slot = torch.arange(LC_CHUNK, dtype=torch.int32,
                        device=payload.device)[None, :]
    valid = slot < lens[:, None]
    src = torch.where(valid, offs[:, None] + slot, 0)
    src = src.clamp(0, payload.shape[0] - 1)
    return torch.where(valid, payload[src.to(torch.int64)], 0)


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

"""The chunked zero/narrow coder on the card: the four CUDA kernels of
`csrc/lossless.cu`, their wrappers, and their plain torch versions.

Counterpart of `repro.kernels.lossless` (the Pallas kernels
`_abs_pack_lc_kernel`, `_rel_pack_lc_kernel`, `_lc_select_kernel`,
`_lc_expand_kernel`).  The fused pack kernels (B5) quantize, pack and
chunk-code x in one pass and write the narrowed chunk image and one int32
code per chunk, never the plain word plane.  The select kernel (B6)
chunk-codes rows of words, or compacts B5's image, and writes the
compacted payload, its zero tail, the payload length and the 2-bit header
of every row in one launch; the expand kernel (B7) reads the header and
the used payload words back and writes the words in one launch.  In the
reference the compaction, the header pack, the header unpack and the
gather are XLA ops around its kernels (`codec.compact_chunk_rows`,
`pack_word_rows`, `unpack_word_rows`, `gather_chunk_rows` here): the plain
versions of B6 and B7 are those compositions.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (built from source at first use) or raises;
nothing falls back.  On the "meta" device it returns empty outputs of the
kernel's shapes and computes nothing.  Each launch adds one to
`LAUNCHES[name]`.

Outside the kernels, as in the reference, stay torch ops: NOA's finite
min/max and the outlier table.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import codec as C
from ..core import quantizer as q
from ..core.config import QuantizerConfig
from . import pack as K

KERNELS = ("_abs_pack_lc", "_rel_pack_lc", "_lc_select", "_lc_expand")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _narrow_flag(stage: str) -> int:
    if stage not in C.LC_STAGES:
        raise ValueError(f"lossless stage must be one of {C.LC_STAGES}")
    return int(stage == "narrow")


def _chunk_outputs(n_words: int, device):
    """(sel int32[n_chunks * LC_CHUNK], codes int32[n_chunks])."""
    n_chunks = C.lc_chunk_count(n_words)
    return (torch.empty(n_chunks * C.LC_CHUNK, dtype=torch.int32,
                        device=device),
            torch.empty(n_chunks, dtype=torch.int32, device=device))


# chunks per tile of select_compact_kernel / gather_expand_kernel, and the
# scratch words before the tiles' status words (csrc/lossless.cu)
_TILE, _SCRATCH_HEAD = 16, 4
_MAX_CAP = 2 ** 31 - 1          # a row's prefixes are 32-bit in the scan


def _scratch_words(chunks: int) -> int:
    """Scratch of the select or the expand: a tile counter and one 64-bit
    status word a tile (`repro_lc_scratch_words`)."""
    return _SCRATCH_HEAD + 2 * -(-chunks // _TILE)


def _check_rows(t: torch.Tensor, what: str) -> str:
    """A 2-d int32 operand whose rows are contiguous (any row stride);
    returns its device type."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected torch.int32, got {t.dtype}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1) or (
            t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        raise ValueError(f"{what}: expected a 2-d tensor with contiguous "
                         f"rows")
    if t.device.type not in K.DEVICES:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _check_cap(n_in: int) -> int:
    nc = C.lc_chunk_count(n_in)
    if nc * C.LC_CHUNK > _MAX_CAP:
        raise ValueError(f"chunk coder: a row of {n_in} words passes the "
                         f"{_MAX_CAP}-word payload a row can hold")
    return nc


# ------------------------------------------------------- plain versions --

def _lc_image_plain(words, stage: str):
    """The chunk image (each chunk narrowed, left-aligned, zero-padded to
    512 words) and the codes of one stream int32[W]: what B5 writes."""
    chunks = C.lc_chunks(words)
    codes = C.lc_chunk_codes(chunks, stage)
    return C.lc_narrow_chunks(chunks, codes).reshape(-1), codes


def _lc_compact_plain(sel, codes):
    """The reference's compaction and 2-bit header of each row: sel
    int32[R * nc * 512] (the chunk images), codes int32[R, nc] ->
    (header [R, hw], payload [R, 512 nc], payload_len int32[R])."""
    rows, nc = codes.shape
    payload, plen = C.compact_chunk_rows(sel.reshape(rows, nc, C.LC_CHUNK),
                                         C.lc_chunk_lens(codes))
    return C.pack_word_rows(codes, 2), payload, plen


def _lc_select_plain(words, stage: str):
    """B6's function: words int32[R, n_in], each row a stream, through the
    reference's composition lc_chunks -> lc_chunk_codes ->
    lc_narrow_chunks -> compact_chunk_rows -> pack_word_rows."""
    rows, n_in = words.shape
    nc = C.lc_chunk_count(n_in)
    if nc * C.LC_CHUNK != n_in:
        words = torch.cat([words, words.new_zeros(rows, nc * C.LC_CHUNK
                                                  - n_in)], 1)
    chunks = words.reshape(rows * nc, C.LC_CHUNK)
    codes = C.lc_chunk_codes(chunks, stage)
    sel = C.lc_narrow_chunks(chunks, codes)
    return _lc_compact_plain(sel, codes.reshape(rows, nc))


def _abs_pack_lc_plain(x, eb, cfg: QuantizerConfig, stage: str):
    words, outlier = K._abs_pack_plain(x, eb, cfg)
    return (outlier, *_lc_image_plain(words, stage))


def _rel_pack_lc_plain(x, cfg: QuantizerConfig, stage: str):
    words, outlier, sign_words = K._rel_pack_plain(x, cfg)
    return (outlier, sign_words, *_lc_image_plain(words, stage))


def _lc_expand_plain(header, payload, n_in: int):
    """B7's function: header [R, hw], payload [R, W] -> words int32[R,
    n_in], through the reference's inverse: unpack_word_rows ->
    gather_chunk_rows (source indices clipped to [0, W - 1]) ->
    lc_expand_chunks."""
    rows = payload.shape[0]
    nc = C.lc_chunk_count(n_in)
    codes = C.unpack_word_rows(header, nc, 2, signed=False)
    padded = C.gather_chunk_rows(payload, C.lc_chunk_lens(codes))
    words = C.lc_expand_chunks(padded.reshape(-1, C.LC_CHUNK),
                               codes.reshape(-1))
    return words.reshape(rows, nc * C.LC_CHUNK)[:, :n_in]


# -------------------------------------------------------------- wrappers --

def abs_pack_lc(x: torch.Tensor, eb: torch.Tensor, cfg: QuantizerConfig,
                stage: str):
    """x: f32[n]; eb: f32[1] on x's device.  Returns (outlier bool[n],
    sel int32[n_chunks * 512] — each chunk narrowed, left-aligned and
    zero-padded — and codes int32[n_chunks]) for the packed words of x."""
    narrow = _narrow_flag(stage)
    if K._check_input(x, torch.float32, "abs_pack_lc x") == "cpu":
        return _abs_pack_lc_plain(x, eb, cfg, stage)
    eb = K._eb_operand(eb, x.device)
    n = x.shape[0]
    sel, codes = _chunk_outputs(C.packed_word_count(n, cfg.bin_bits),
                                x.device)
    outlier = torch.empty(n, dtype=torch.bool, device=x.device)
    K._launch(LAUNCHES, "_abs_pack_lc", "repro_abs_pack_lc", x.device,
              x.data_ptr(), n, eb.data_ptr(), cfg.bin_bits, cfg.maxbin,
              float(np.float32(cfg.tighten)),
              float(np.float32(cfg.eb_floor)), narrow, codes.shape[0],
              outlier.data_ptr(), sel.data_ptr(), codes.data_ptr())
    return outlier, sel, codes


def rel_pack_lc(x: torch.Tensor, cfg: QuantizerConfig, stage: str):
    """x: f32[n].  Returns (outlier bool[n], sign_words
    int32[packed_word_count(n, 1)], sel, codes) as abs_pack_lc."""
    narrow = _narrow_flag(stage)
    if K._check_input(x, torch.float32, "rel_pack_lc x") == "cpu":
        return _rel_pack_lc_plain(x, cfg, stage)
    n = x.shape[0]
    sel, codes = _chunk_outputs(C.packed_word_count(n, cfg.bin_bits),
                                x.device)
    outlier = torch.empty(n, dtype=torch.bool, device=x.device)
    sign_words = torch.empty(C.packed_word_count(n, 1), dtype=torch.int32,
                             device=x.device)
    K._launch(LAUNCHES, "_rel_pack_lc", "repro_rel_pack_lc", x.device,
              x.data_ptr(), n, cfg.bin_bits, cfg.maxbin,
              *K.rel_constants_f32(cfg), narrow, codes.shape[0],
              outlier.data_ptr(), sign_words.data_ptr(), sel.data_ptr(),
              codes.data_ptr())
    return outlier, sign_words, sel, codes


def _select_launch(src, codes, rows: int, n_in: int, narrow: int):
    """B6's launch: outputs and scratch in one buffer, laid out as payload
    [R, cap], header [R, hw], scratch, payload_len [R] (the C entry zeroes
    the header and the scratch with one memset)."""
    nc = _check_cap(n_in)
    cap, hw = nc * C.LC_CHUNK, C.lc_header_words(n_in)
    at_hs = rows * cap
    at_len = at_hs + rows * hw + _scratch_words(rows * nc)
    buf = torch.empty(at_len + rows, dtype=torch.int32, device=src.device)
    payload = buf[:at_hs].view(rows, cap)
    header = buf[at_hs:at_hs + rows * hw].view(rows, hw)
    plen = buf[at_len:]
    if nc == 0:
        plen.zero_()
    K._launch(LAUNCHES, "_lc_select", "repro_lc_select", src.device,
              src.data_ptr(), src.stride(0) if src.dim() == 2 else 0,
              None if codes is None else codes.data_ptr(), rows, n_in,
              narrow, buf.data_ptr(), buf.data_ptr() + 4 * at_hs,
              plen.data_ptr())
    return header, payload, plen


def lc_select(words: torch.Tensor, stage: str):
    """B6: words int32[R, n_in] (rows contiguous, any n_in), each row a
    stream (a KV page).  Returns (header int32[R, lc_header_words(n_in)],
    payload int32[R, 512 * n_chunks], payload_len int32[R]): each row's
    chunks at their true lengths then zeros, and its 2-bit codes packed
    as pack_words lays them out.  The last chunk's ragged tail reads as
    zero words.  One launch."""
    narrow = _narrow_flag(stage)
    if _check_rows(words, "lc_select words") == "cpu":
        return _lc_select_plain(words, stage)
    return _select_launch(words, None, words.shape[0], words.shape[1],
                          narrow)


def lc_compact_image(sel: torch.Tensor, codes: torch.Tensor):
    """B6 on B5's output (one stream): sel int32[n_chunks * 512], the
    chunk image abs_pack_lc / rel_pack_lc write, and its codes
    int32[n_chunks].  Returns (header [1, hw], payload [1, 512 *
    n_chunks], payload_len [1]) as lc_select does; reads only each
    chunk's used words.  One launch, counted as _lc_select."""
    dev = K._check_input(sel, torch.int32, "lc_compact_image sel")
    K._check_input(codes, torch.int32, "lc_compact_image codes")
    nc = codes.shape[0]
    if sel.shape[0] != nc * C.LC_CHUNK or codes.device != sel.device:
        raise ValueError(f"lc_compact_image: expected sel int32[{nc} * "
                         f"{C.LC_CHUNK}] beside codes int32[{nc}]")
    if dev == "cpu":
        return _lc_compact_plain(sel, codes[None])
    return _select_launch(sel, codes, 1, sel.shape[0], 0)


def lc_expand(header: torch.Tensor, payload: torch.Tensor, n_in: int):
    """B7: header int32[R, lc_header_words(n_in)] and payload int32[R, W]
    (rows contiguous, any row strides) as lc_select writes them.  Returns
    words int32[R, n_in].  A source index past the plane is clipped to
    W - 1 and a slot past its chunk's length reads 0, as in the
    reference.  One launch."""
    dev = _check_rows(header, "lc_expand header")
    _check_rows(payload, "lc_expand payload")
    rows, hw = payload.shape[0], C.lc_header_words(n_in)
    if (header.shape != (rows, hw) or payload.shape[1] < 1
            or header.device != payload.device):
        raise ValueError(f"lc_expand: expected header int32[{rows}, {hw}] "
                         f"and payload int32[{rows}, >= 1] on one device "
                         f"for n_in={n_in}")
    if dev == "cpu":
        return _lc_expand_plain(header, payload, n_in)
    nc = _check_cap(n_in)
    at_scratch = -(-rows * n_in // 4) * 4
    buf = torch.empty(at_scratch + _scratch_words(rows * nc),
                      dtype=torch.int32, device=payload.device)
    words = buf[:rows * n_in].view(rows, n_in)
    K._launch(LAUNCHES, "_lc_expand", "repro_lc_expand", payload.device,
              header.data_ptr(), header.stride(0), payload.data_ptr(),
              payload.stride(0), payload.shape[1], rows, n_in,
              buf.data_ptr(), buf.data_ptr() + 4 * at_scratch)
    return words


# ------------------------------------------------------------ public API --

def _finish_encode(sel: torch.Tensor, codes: torch.Tensor):
    """B5's tail: its chunk image compacted, and the 2-bit header, by B6
    (the reference's compaction and header pack)."""
    header, payload, plen = lc_compact_image(sel, codes)
    return header[0], payload[0], plen[0]


def encode_words_lc(words: torch.Tensor, stage: str = "narrow"):
    """Kernel twin of `core.codec.encode_words_lc` (bit-exact): returns
    (header_words, payload, payload_len)."""
    header, payload, plen = lc_select(words.reshape(1, -1).contiguous(),
                                      stage)
    return header[0], payload[0], plen[0]


def decode_words_lc(header_words: torch.Tensor, payload: torch.Tensor,
                    n_words: int) -> torch.Tensor:
    """Kernel twin of `core.codec.decode_words_lc` (bit-exact)."""
    return lc_expand(header_words.reshape(1, -1).contiguous(),
                     payload.reshape(1, -1).contiguous(), n_words)[0]


def encode_lossless(enc: C.EncodedPacked, stage: str = "narrow") -> C.EncodedLC:
    """Kernel twin of `core.codec.encode_lossless`."""
    hw, payload, plen = encode_words_lc(enc.words, stage)
    return C.EncodedLC(hw, payload, plen, enc.out_idx, enc.out_payload,
                       enc.n_outliers, enc.overflow, enc.sign_words, enc.eb)


def decode_lossless(lc: C.EncodedLC, n_words: int) -> C.EncodedPacked:
    """Kernel twin of `core.codec.decode_lossless`."""
    words = decode_words_lc(lc.header_words, lc.payload, n_words)
    return C.EncodedPacked(words, lc.out_idx, lc.out_payload, lc.n_outliers,
                           lc.overflow, lc.sign_words, lc.eb)


def encode_packed_lc(x: torch.Tensor, cfg: QuantizerConfig, eb=None,
                     stage: str = "narrow") -> C.EncodedLC:
    """Fused quantize + pack + chunk coder: one pass over x (B5).  Bit-exact
    twin of `core.codec.encode_lossless(encode_packed(x))`."""
    flat = x.reshape(-1).contiguous()
    C.check_f32(flat)
    n = flat.shape[0]
    if cfg.mode == "noa":
        eb = q.value_range_eb(flat, cfg)      # needs the whole tensor
    sign_words = None
    if cfg.mode == "rel":
        outlier, sign_words, sel, codes = rel_pack_lc(flat, cfg, stage)
    else:
        eb_arr = C.eb_plane(cfg.error_bound if eb is None else eb, flat)
        outlier, sel, codes = abs_pack_lc(flat, eb_arr.reshape(1), cfg, stage)
    hw, payload, plen = _finish_encode(sel, codes)
    return C.EncodedLC(hw, payload, plen,
                       *C.outlier_table(flat, outlier, cfg.outlier_cap(n)),
                       sign_words, C.eb_plane(eb, flat))

"""The chunked zero/narrow coder on the card: the four CUDA kernels of
`csrc/lossless.cu`, their wrappers, and their plain torch versions.

Counterpart of `repro.kernels.lossless` (the Pallas kernels
`_abs_pack_lc_kernel`, `_rel_pack_lc_kernel`, `_lc_select_kernel`,
`_lc_expand_kernel`).  The fused pack kernels quantize, pack and chunk-code
x in one pass and write the narrowed chunk image and one int32 code per
chunk, never the plain word plane; the select kernel chunk-codes an
existing word plane; the expand kernel widens a gathered chunk image back
to words.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel (built from source at first use) or raises;
nothing falls back.  On the "meta" device it returns empty outputs of the
kernel's shapes and computes nothing.  Each launch adds one to
`LAUNCHES[name]`.

Outside the kernels, as in the reference, stay torch ops: NOA's finite
min/max, the outlier table, the compaction of the chunk image to its true
length (`codec.lc_compact_payload`, a scatter into a buffer with one spare
word, so it needs no mask and no host sync), the 2-bit packing of the
codes, and on decode the gather (`codec.lc_gather_chunks`).
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


# ------------------------------------------------------- plain versions --

def _lc_select_plain(words, stage: str):
    chunks = C.lc_chunks(words)
    codes = C.lc_chunk_codes(chunks, stage)
    return C.lc_narrow_chunks(chunks, codes).reshape(-1), codes


def _abs_pack_lc_plain(x, eb, cfg: QuantizerConfig, stage: str):
    words, outlier = K._abs_pack_plain(x, eb, cfg)
    return (outlier, *_lc_select_plain(words, stage))


def _rel_pack_lc_plain(x, cfg: QuantizerConfig, stage: str):
    words, outlier, sign_words = K._rel_pack_plain(x, cfg)
    return (outlier, sign_words, *_lc_select_plain(words, stage))


def _lc_expand_plain(padded, codes, n_words: int):
    return C.lc_expand_chunks(padded.reshape(-1, C.LC_CHUNK),
                              codes).reshape(-1)[:n_words]


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


def lc_select(words: torch.Tensor, stage: str):
    """words: int32[W] (any W).  Returns (sel int32[n_chunks * 512], codes
    int32[n_chunks]); the last chunk's ragged tail reads as zero words."""
    narrow = _narrow_flag(stage)
    if K._check_input(words, torch.int32, "lc_select words") == "cpu":
        return _lc_select_plain(words, stage)
    sel, codes = _chunk_outputs(words.shape[0], words.device)
    K._launch(LAUNCHES, "_lc_select", "repro_lc_select", words.device,
              words.data_ptr(), words.shape[0], narrow, codes.shape[0],
              sel.data_ptr(), codes.data_ptr())
    return sel, codes


def lc_expand(padded: torch.Tensor, codes: torch.Tensor, n_words: int):
    """padded: int32[n_chunks * 512] (each chunk's narrowed words
    left-aligned), codes: int32[n_chunks], n_chunks =
    lc_chunk_count(n_words).  Returns words int32[n_words]."""
    dev = K._check_input(padded, torch.int32, "lc_expand padded")
    K._check_input(codes, torch.int32, "lc_expand codes")
    n_chunks = C.lc_chunk_count(n_words)
    if (padded.shape[0] != n_chunks * C.LC_CHUNK
            or codes.shape[0] != n_chunks or codes.device != padded.device):
        raise ValueError(f"lc_expand: expected padded int32[{n_chunks} * "
                         f"{C.LC_CHUNK}] and codes int32[{n_chunks}] on one "
                         f"device for n_words={n_words}")
    if dev == "cpu":
        return _lc_expand_plain(padded, codes, n_words)
    words = torch.empty(n_words, dtype=torch.int32, device=padded.device)
    K._launch(LAUNCHES, "_lc_expand", "repro_lc_expand", padded.device,
              padded.data_ptr(), codes.data_ptr(), n_chunks,
              words.data_ptr(), n_words)
    return words


# ------------------------------------------------------------ public API --

def _finish_encode(sel: torch.Tensor, codes: torch.Tensor):
    """The reference's shared tail: compaction and the 2-bit header."""
    payload, plen = C.lc_compact_payload(sel.reshape(-1, C.LC_CHUNK), codes)
    return C.pack_words(codes, 2), payload, plen


def encode_words_lc(words: torch.Tensor, stage: str = "narrow"):
    """Kernel twin of `core.codec.encode_words_lc` (bit-exact): returns
    (header_words, payload, payload_len)."""
    return _finish_encode(*lc_select(words.contiguous(), stage))


def decode_words_lc(header_words: torch.Tensor, payload: torch.Tensor,
                    n_words: int) -> torch.Tensor:
    """Kernel twin of `core.codec.decode_words_lc` (bit-exact)."""
    codes = C.unpack_words(header_words, C.lc_chunk_count(n_words), 2,
                           signed=False)
    padded = C.lc_gather_chunks(payload, codes)
    return lc_expand(padded.reshape(-1), codes, n_words)


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

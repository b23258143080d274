"""LC-style pipeline API, in torch: spec strings -> one chain -> one wire.

Counterpart of `repro.core.pipeline`: a `Pipeline` parsed from a spec such
as `"delta|rel:1e-3|pack:8|zero|narrow"` is any number of value-domain
predictor stages (`core.predict`, closed-loop on the bin plane), a
quantizer stage, a bit-pack stage, and any number of lossless word stages
(`zero`, `narrow`, `shuffle[:w]`, `ent`), each an exact transform of the
packed word stream.  The grammar is the reference's:

    pipeline = { pred-stage "|" } quant:<eb> "|" pack:<bits> { "|" word-stage }

Encoding gives one `Encoded` wire; `Pipeline.wire_bits` counts exactly the
transmitted prefix, as the reference does.  `encode(verify=True)` adds the
audit plane's bound report, `integrity=True` the wire checksum, and
`return_quantized=True` the local `Quantized` planes.  Float64 data raises
NotImplementedError (ROADMAP C-port-2).

Entry points run on the card unless the caller asks for the CPU:
`encode`/`decode` take `device=` (default "cuda") and raise when there is
no CUDA device; they never carry on quietly on the CPU.  Dispatch
(`kernels=None`) takes the CUDA kernels on the card and the plain torch
reference on the CPU; both are bit-identical (`kernels.pack`,
`kernels.lossless` and `kernels.dense` are the reference's bit-exact
twins by test), so the guarantee is untouched by dispatch.  The dispatch
table is in `src/repro_torch/DESIGN.md`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import dense as D
from ..kernels import lossless as L
from ..kernels import pack as K
from . import audit as A
from . import codec as C
from . import predict as P
from .config import QuantizerConfig

_QUANT_MODES = ("abs", "rel", "noa")
_CAP_DEFAULT = 0.125          # QuantizerConfig.outlier_cap_frac default

GRAMMAR = ('pipeline = { pred-stage "|" } quant:<eb> "|" pack:<bits> '
           '{ "|" word-stage }')
_F64_ITEM = "ROADMAP C-port-2 (float64 on the packed wire)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({item})")


def kernel_device(dev) -> bool:
    """Whether work on `dev` takes the kernels: on the card, and on the
    meta device (`launch.dryrun`), which follows the card's path (the
    wrappers count a launch and return empty outputs)."""
    return torch.device(dev).type in ("cuda", "meta")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: repro_torch runs on the card "
                           "unless the caller passes device='cpu'")
    return dev


class Encoded(NamedTuple):
    """The one wire container (the reference's `Encoded`).  Word planes are
    int32 tensors holding the uint32 bits; `headers` holds one stored
    header plane per word stage, in chain order; `payload` is the final
    word plane, padded to capacity after a chunk stage, and `payload_len`
    the transmitted word count (data-dependent after a chunk stage)."""
    payload: torch.Tensor          # int32[capacity] — final word plane
    payload_len: torch.Tensor      # int32 0-d — words a transport moves
    headers: tuple                 # per-stage header planes
    out_idx: torch.Tensor          # int32[K], n = "empty slot"
    out_payload: torch.Tensor      # int32[K] — original IEEE bits
    n_outliers: torch.Tensor       # int32 0-d
    overflow: torch.Tensor         # bool 0-d (bound NOT met when True)
    sign_words: torch.Tensor | None  # int32 (REL only)
    eb: torch.Tensor | None        # 0-d traced bound
    checksum: torch.Tensor | None = None  # int32 0-d (integrity=True)


def _fmt(v: float) -> str:
    """Canonical float printing for specs (shortest roundtrip repr)."""
    return repr(float(v))


@dataclasses.dataclass(frozen=True)
class QuantStage:
    """Quantizer front end: mode + error bound (+ outlier-cap fraction)."""
    mode: str = "abs"
    eb: float = 1e-3
    cap: float = _CAP_DEFAULT
    dtype: str = "float32"

    def spec(self) -> str:
        s = f"{self.mode}:{_fmt(self.eb)}"
        if self.cap != _CAP_DEFAULT:
            s += f":cap={_fmt(self.cap)}"
        if self.dtype != "float32":
            s += f":dtype={self.dtype}"
        return s


@dataclasses.dataclass(frozen=True)
class PackStage:
    """Bit-pack stage: bins -> 32-bit lane words at `bits`/value (§4)."""
    bits: int = 16

    def spec(self) -> str:
        return f"pack:{self.bits}"


@dataclasses.dataclass(frozen=True)
class ChunkStage:
    """The chunked zero/narrow coder as a word stage.  `kernels` picks the
    wrappers of `kernels.lossless` (CUDA kernels for a CUDA tensor) over
    the plain `core.codec` functions; both give the same wire."""
    mode: str = "narrow"          # 'zero' | 'narrow'
    transmits_len = True

    def capacity_words(self, n_in: int) -> int:
        return C.lc_chunk_count(n_in) * C.LC_CHUNK

    def header_words(self, n_in: int) -> int:
        return C.lc_header_words(n_in)

    def header_content_bits(self, n_in: int) -> int:
        return 32 * C.lc_header_content_words(C.lc_chunk_count(n_in))

    def encode_words(self, words, n_in: int, kernels: bool = False):
        """One stream int32[n_in] -> (header, payload, payload_len): the
        one-row case of encode_pages."""
        h, p, n = self.encode_pages(words[None], n_in, kernels)
        return h[0], p[0], n[0]

    def decode_words(self, header, payload, n_in: int,
                     kernels: bool = False):
        return self.decode_pages(header[None], payload[None], n_in,
                                 kernels)[0]

    def encode_pages(self, words, n_in: int, kernels: bool = False):
        """Each row of words int32[R, n_in] coded as its own stream (a row
        is one KV page): (headers [R, hw], payload [R, cap], len
        int32[R]).  With kernels=True one launch of the select kernel B6
        for every row's chunks, their compaction and 2-bit headers; else
        the reference's composition."""
        select = L.lc_select if kernels else L._lc_select_plain
        return select(words, self.mode)

    def decode_pages(self, header, payload, n_in: int,
                     kernels: bool = False):
        """Exact inverse of encode_pages: int32[R, n_in] (one launch of
        the expand kernel B7 with kernels=True)."""
        expand = L.lc_expand if kernels else L._lc_expand_plain
        return expand(header, payload, n_in)

    def spec(self) -> str:
        return self.mode


@dataclasses.dataclass(frozen=True)
class EntStage:
    """Static canonical entropy coder over surviving 512-word chunks
    (`codec.encode_words_ent`): the codebook's 4-bit lengths, the 2-bit
    chunk modes and the 16-bit chunk bit lengths ride in the header
    plane; each surviving chunk is coded on its own, with a verbatim
    escape.  Length-variable.  Torch ops on either device (the reference
    has no kernel for it); `kernels` is accepted and changes nothing."""
    transmits_len = True

    def capacity_words(self, n_in: int) -> int:
        return C.lc_chunk_count(n_in) * C.LC_CHUNK

    def header_words(self, n_in: int) -> int:
        return C.ent_header_words(n_in)

    def header_content_bits(self, n_in: int) -> int:
        return 32 * C.ent_header_content_words(C.lc_chunk_count(n_in))

    def encode_words(self, words, n_in: int, kernels: bool = False):
        return C.encode_words_ent(words)

    def decode_words(self, header, payload, n_in: int,
                     kernels: bool = False):
        return C.decode_words_ent(header, payload, n_in)

    def encode_pages(self, words, n_in: int, kernels: bool = False):
        """`encode_words` row by row (each row builds its own codebook;
        no registered KV page chain holds `ent`)."""
        outs = [self.encode_words(w, n_in) for w in words]
        return tuple(torch.stack(p) for p in zip(*outs))

    def decode_pages(self, header, payload, n_in: int,
                     kernels: bool = False):
        return torch.stack([self.decode_words(h, p, n_in)
                            for h, p in zip(header, payload)])

    def spec(self) -> str:
        return "ent"


@dataclasses.dataclass(frozen=True)
class ShuffleStage:
    """Zigzag sign-fold + byte-plane shuffle (`codec.shuffle_words`):
    makes the chunk codes fire on mixed-sign bin streams.  Headerless and
    length-static; `width` is the lane width of the incoming words (the
    pack width right after `pack`).  Torch ops on either device."""
    width: int = 16
    transmits_len = False

    def capacity_words(self, n_in: int) -> int:
        return C.shuffle_word_count(n_in)

    def header_words(self, n_in: int) -> int:
        return 0

    def header_content_bits(self, n_in: int) -> int:
        return 0

    def encode_words(self, words, n_in: int, kernels: bool = False):
        h, p, n = self.encode_pages(words[None], n_in, kernels)
        return h[0], p[0], n[0]

    def decode_words(self, header, payload, n_in: int,
                     kernels: bool = False):
        return self.decode_pages(header[None], payload[None], n_in)[0]

    def encode_pages(self, words, n_in: int, kernels: bool = False):
        out = C.shuffle_word_rows(words, self.width)
        return (words.new_zeros(words.shape[0], 0), out,
                torch.full((words.shape[0],), self.capacity_words(n_in),
                           dtype=torch.int32, device=words.device))

    def decode_pages(self, header, payload, n_in: int,
                     kernels: bool = False):
        return C.unshuffle_word_rows(payload, n_in, self.width)

    def spec(self) -> str:
        return f"shuffle:{self.width}"


def _parse_params(tokens):
    """Split stage arg tokens into (positional list, {key: value})."""
    pos, kw = [], {}
    for t in tokens:
        if "=" in t:
            k, v = t.split("=", 1)
            kw[k] = v
        else:
            pos.append(t)
    return pos, kw


def _parse_chunk(name, tokens):
    if tokens:
        raise ValueError(f"stage {name!r} takes no parameters")
    return ChunkStage(name)


def _parse_shuffle(name, tokens, *, pack_bits):
    pos, kw = _parse_params(tokens)
    if kw or len(pos) > 1:
        raise ValueError("shuffle takes at most one positional width")
    width = int(pos[0]) if pos else pack_bits
    if width not in (8, 16, 32):
        raise ValueError(f"shuffle width must be 8, 16 or 32, got {width}")
    return ShuffleStage(width)


def _parse_ent(name, tokens):
    if tokens:
        raise ValueError(f"stage {name!r} takes no parameters")
    return EntStage()


# name -> parser(name, arg_tokens, pack_bits) -> word stage.
STAGES = {
    "zero": lambda name, tokens, pack_bits: _parse_chunk(name, tokens),
    "narrow": lambda name, tokens, pack_bits: _parse_chunk(name, tokens),
    "shuffle": lambda name, tokens, pack_bits: _parse_shuffle(
        name, tokens, pack_bits=pack_bits),
    "ent": lambda name, tokens, pack_bits: _parse_ent(name, tokens),
}


def register_stage(name: str, parser) -> None:
    """Register a word stage: parser(name, arg_tokens, pack_bits) -> stage."""
    STAGES[name] = parser


def _unknown_stage_error(tok: str) -> ValueError:
    """Unknown spec token: name every registered stage in both domains and
    the grammar, so a misplaced stage diagnoses itself."""
    return ValueError(
        f"unknown stage {tok!r}; registered value-domain (pred) stages: "
        f"{sorted(P.PRED_STAGES)}; quantizers: {sorted(_QUANT_MODES)}; "
        f"registered word-domain stages: {sorted(STAGES)}; "
        f"grammar: {GRAMMAR}")


def parse_word_stages(stages, pack_bits: int) -> tuple:
    """Resolve a word-stage chain: a tuple of stage objects passes
    through; a spec fragment ("narrow", "shuffle|narrow", "", "none")
    parses through the STAGES registry."""
    if isinstance(stages, tuple):
        return stages
    out = []
    for part in str(stages).split("|"):
        part = part.strip()
        if not part or part == "none":
            continue
        tok = part.split(":")
        if tok[0] not in STAGES:
            raise _unknown_stage_error(tok[0])
        out.append(STAGES[tok[0]](tok[0], tok[1:], pack_bits))
    return tuple(out)


def word_stage_sizes(stages, n_words: int) -> list:
    """[words into stage 0, into stage 1, ..., final capacity] (static)."""
    sizes = [n_words]
    for st in stages:
        sizes.append(st.capacity_words(sizes[-1]))
    return sizes


def encode_word_stages(stages, words, n_words: int, kernels: bool = False):
    """Run a word-stage chain over a packed plane.  Returns (headers tuple,
    payload, transmitted_len): the one-row case of encode_page_stages."""
    headers, payload, plen = encode_page_stages(stages, words[None],
                                                n_words, kernels)
    return tuple(h[0] for h in headers), payload[0], plen[0]


def decode_word_stages(stages, headers, payload, n_words: int,
                       kernels: bool = False):
    """Exact inverse of encode_word_stages."""
    return decode_page_stages(stages, tuple(h[None] for h in headers),
                              payload[None], n_words, kernels)[0]


def encode_page_stages(stages, words, n_words: int, kernels: bool = False):
    """Run a word-stage chain over each row of words int32[R, n_words] as
    its own stream (a row is one KV page): (headers tuple of [R, hw],
    payload [R, cap], transmitted_len int32[R]).  Each stage after the
    first takes the previous stage's padded capacity."""
    headers, cur, cur_n = [], words, n_words
    plen = torch.full((words.shape[0],), n_words, dtype=torch.int32,
                      device=words.device)
    for st in stages:
        hdr, cur, plen = st.encode_pages(cur, cur_n, kernels=kernels)
        headers.append(hdr)
        cur_n = st.capacity_words(cur_n)
    return tuple(headers), cur, plen


def decode_page_stages(stages, headers, payload, n_words: int,
                       kernels: bool = False):
    """Exact inverse of encode_page_stages: int32[R, n_words]."""
    sizes = word_stage_sizes(stages, n_words)
    cur = payload
    for st, hdr, n_in in reversed(list(zip(stages, headers, sizes[:-1]))):
        cur = st.decode_pages(hdr, cur, n_in, kernels=kernels)
    return cur


def _to_device(enc, dev: torch.device):
    """A wire (`Encoded` or another NamedTuple of planes) on `dev`."""
    def mv(f):
        if f is None:
            return None
        if isinstance(f, tuple):
            return tuple(h.to(dev) for h in f)
        return f.to(dev)
    return type(enc)(*(mv(f) for f in enc))


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """One chain: pred stages -> quantizer -> pack -> word stages.
    `parse_pipeline` / `spec()` are exact inverses.  `pred` holds the
    value-domain predictor stages: exact bijections on the quantized bin
    plane, applied after the quantizer on encode and inverted before
    dequantize on decode, so the bound is inherited unchanged."""
    quant: QuantStage
    pack: PackStage
    stages: tuple = ()
    pred: tuple = ()

    def spec(self) -> str:
        return "|".join([p.spec() for p in self.pred]
                        + [self.quant.spec(), self.pack.spec()]
                        + [s.spec() for s in self.stages])

    def qcfg(self) -> QuantizerConfig:
        return QuantizerConfig(mode=self.quant.mode,
                               error_bound=self.quant.eb,
                               bin_bits=self.pack.bits,
                               dtype=self.quant.dtype,
                               outlier_cap_frac=self.quant.cap)

    def n_words(self, n: int) -> int:
        """Packed word count entering the first word stage."""
        return C.packed_word_count(n, self.pack.bits)

    def stage_sizes(self, n: int) -> list:
        """[words into stage 0, into stage 1, ..., final capacity]."""
        return word_stage_sizes(self.stages, self.n_words(n))

    def kernel_dispatch(self) -> str:
        """Dotted name of the kernel entry this chain's encode maps onto on
        the card.  A pred chain quantizes with the dense kernels (B8/B9),
        as `verify=`/`return_quantized=` encodes of any chain do; one
        chunk stage fuses into the pack pass (`encode_packed_lc`); any
        other chain runs the pack kernel and then its word stages (chunk
        stages through the select kernel, `shuffle`/`ent` as torch ops),
        where the reference takes its jit path: the wire is the same."""
        if self.pred:
            return "repro_torch.kernels.dense.encode_packed"
        if self._fuses_chunk_stage():
            return "repro_torch.kernels.lossless.encode_packed_lc"
        return "repro_torch.kernels.pack.encode_packed"

    def _fuses_chunk_stage(self) -> bool:
        """One chunk stage alone: it fuses into the pack pass (B5)."""
        return len(self.stages) == 1 and isinstance(self.stages[0],
                                                    ChunkStage)

    def encode_words(self, words, n_words: int, kernels: bool = False):
        """Run the word stages only.  Returns (headers, payload, len)."""
        return encode_word_stages(self.stages, words, n_words, kernels)

    def decode_words(self, headers, payload, n_words: int,
                     kernels: bool = False):
        """Exact inverse of encode_words."""
        return decode_word_stages(self.stages, headers, payload, n_words,
                                  kernels)

    def _wrap_packed(self, ep: C.EncodedPacked, n: int,
                     kernels: bool = False) -> Encoded:
        headers, payload, plen = self.encode_words(ep.words, self.n_words(n),
                                                   kernels)
        return Encoded(payload, plen, headers, ep.out_idx, ep.out_payload,
                       ep.n_outliers, ep.overflow, ep.sign_words, ep.eb)

    # --- pred (value-domain) stage plumbing ---------------------------------

    def _pred_shape(self, pred_shape, n: int) -> tuple:
        shape = (n,) if pred_shape is None else tuple(pred_shape)
        if int(np.prod(shape)) != n:
            raise ValueError(f"pred_shape {shape} has {int(np.prod(shape))} "
                             f"elements, tensor has {n}")
        return shape

    def _bin_transform(self, pred_shape, n: int):
        """bins -> codes closure for encode_packed, or None."""
        if not self.pred:
            return None
        shape, bits = self._pred_shape(pred_shape, n), self.pack.bits
        return lambda bins: P.encode_pred_stages(self.pred, bins, shape, bits)

    def _bin_untransform(self, pred_shape, n: int):
        """codes -> bins closure for decode_packed, or None."""
        if not self.pred:
            return None
        shape, bits = self._pred_shape(pred_shape, n), self.pack.bits
        return lambda codes: P.decode_pred_stages(self.pred, codes, shape,
                                                  bits)

    # --- encode / decode ---------------------------------------------------

    def encode(self, x, eb=None, *, device="cuda", kernels: bool | None = None,
               return_quantized: bool = False, pred_shape=None,
               verify: bool = False, integrity: bool = False):
        """Encode x (a tensor or array) on `device`.  `eb` (a float or a 0-d
        tensor, which stays on the device) overrides the bound for ABS.
        kernels=None takes the CUDA kernels on the card and the plain torch
        reference on the CPU; kernels=False forces the reference.
        `pred_shape` is the value-domain shape the pred stages see
        (default x.shape).

        `return_quantized=True` also returns the local `Quantized`;
        `verify=True` appends an `audit.AuditReport` computed from the
        encoder's own recon plane (both take the dense kernels B8/B9 on
        the card); `integrity=True` attaches the 32-bit wire checksum on
        any path.  Returns enc | (enc, qt) | (enc, report) |
        (enc, qt, report)."""
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        if x.dtype != torch.float32:
            raise not_ported(f"{x.dtype} data", _F64_ITEM)
        n = x.numel()
        if pred_shape is None:
            pred_shape = tuple(x.shape)
        cfg = self.qcfg()
        use_k = kernel_device(dev) if kernels is None else kernels
        transform = self._bin_transform(pred_shape, n)
        enc, qt = None, None
        if use_k and (self.pred or return_quantized or verify):
            ep, qt = D.encode_packed(x, cfg, eb, bin_transform=transform)
        elif use_k and self._fuses_chunk_stage():
            lc = L.encode_packed_lc(x, cfg, eb, stage=self.stages[0].mode)
            enc = Encoded(lc.payload, lc.payload_len, (lc.header_words,),
                          lc.out_idx, lc.out_payload, lc.n_outliers,
                          lc.overflow, lc.sign_words, lc.eb)
        elif use_k:
            ep = K.encode_packed(x, cfg, eb)
        else:
            ep, qt = C.encode_packed(x, cfg, eb, return_quantized=True,
                                     bin_transform=transform)
        if enc is None:
            enc = self._wrap_packed(ep, n, use_k)
        if integrity:
            enc = A.attach_checksum(enc)
        if verify:
            report = A.audit_report(
                x, qt, cfg, eb=enc.eb if enc.eb is not None else eb,
                overflow=enc.overflow, n_outliers=enc.n_outliers)
            return (enc, qt, report) if return_quantized else (enc, report)
        return (enc, qt) if return_quantized else enc

    def decode(self, enc: Encoded, n: int | None = None, shape=None,
               dtype=None, *, device="cuda", kernels: bool | None = None,
               pred_shape=None, verify: bool = False) -> torch.Tensor:
        """Invert the chain on `device`: word stages in reverse, pred stages
        inverted on the bin plane, then unpack + dequantize + exact outlier
        restore.  Bit-identical between the kernel and reference back
        ends.  `pred_shape` must match the encode side (default `shape`,
        else the flat stream).  A transmitted `payload_len` outside [0,
        capacity] raises `audit.WireIntegrityError` (the one host read of
        a decode); `verify=True` re-checks the carried checksum first and
        raises `WireIntegrityError` on a mismatch."""
        if n is None:
            if shape is None:
                raise ValueError("decode needs n or shape")
            n = int(np.prod(shape))
        if pred_shape is None and shape is not None:
            pred_shape = tuple(shape)
        if dtype not in (None, torch.float32, "float32"):
            raise not_ported(f"{dtype} data", _F64_ITEM)
        dev = resolve_device(device)
        enc = _to_device(enc, dev)
        A.check_payload_len(enc.payload_len, enc.payload.shape[0],
                            what=f"Encoded[{self.spec()}]")
        if verify and not bool(A.verify_wire(enc)):
            raise A.WireIntegrityError(
                f"Encoded[{self.spec()}]: checksum mismatch on decode")
        use_k = kernel_device(dev) if kernels is None else kernels
        words = self.decode_words(enc.headers, enc.payload, self.n_words(n),
                                  use_k)
        ep = C.EncodedPacked(words, enc.out_idx, enc.out_payload,
                             enc.n_outliers, enc.overflow, enc.sign_words,
                             enc.eb)
        cfg, untransform = self.qcfg(), self._bin_untransform(pred_shape, n)
        if use_k and self.pred:
            return D.decode_packed(ep, cfg, n=n, shape=shape,
                                   bin_untransform=untransform)
        if use_k:
            return K.decode_packed(ep, cfg, n=n, shape=shape)
        return C.decode_packed(ep, cfg, n=n, shape=shape,
                               bin_untransform=untransform)

    def roundtrip(self, x, eb=None, **kw):
        return self.decode(self.encode(x, eb, **kw), shape=tuple(x.shape),
                           **kw)

    # --- honest wire accounting --------------------------------------------

    def _base_bits(self, enc: Encoded) -> int:
        bits = 64 + enc.out_idx.shape[0] * (32 + 32)
        if enc.sign_words is not None:
            bits += 32 * enc.sign_words.shape[0]
        if enc.checksum is not None:
            bits += 32                             # the integrity digest
        # pred stages transmit their header content here: every shipped
        # predictor has none, but the slot keeps a parameterized one exact
        return bits + sum(st.header_content_bits() for st in self.pred)

    def wire_bits(self, enc: Encoded, n: int | None = None):
        """Transmitted wire size in bits, the reference's accounting bit
        for bit: the transmitted payload prefix, every stage's header
        content (tile padding excluded), the outlier table, the sign plane
        and the 64-bit packed header (+32 for a transmitted length when
        the last stage's length is data-dependent).  A Python int for
        static chains; otherwise a 0-d float32 tensor on the wire's device
        (`codec.transmitted_bits`), so an encode needs no host sync to
        account its wire.  Pass `n` for exact per-stage input sizes;
        without it the final capacity is used, which gives the same
        header content for every registered stage."""
        if not self.stages:
            return self._base_bits(enc) + 32 * enc.payload.shape[0]
        if n is not None:
            sizes = self.stage_sizes(n)[:-1]
        else:
            sizes = [enc.payload.shape[0]] * len(self.stages)
        hdr = sum(st.header_content_bits(sz)
                  for st, sz in zip(self.stages, sizes))
        if self.stages[-1].transmits_len:
            return C.transmitted_bits(enc.payload_len,
                                      self._base_bits(enc) + hdr + 32)
        return self._base_bits(enc) + hdr + 32 * enc.payload.shape[0]

    def wire_bytes(self, enc: Encoded, n: int | None = None):
        b = self.wire_bits(enc, n)
        return b // 8 if isinstance(b, int) else b / 8.0

    def capacity_bytes(self, enc: Encoded) -> int:
        """Static upper bound: what a padded all-gather buffer holds."""
        b = (enc.payload.numel() + enc.out_idx.numel()
             + enc.out_payload.numel()
             + sum(h.numel() for h in enc.headers)) * 4 + 8
        if enc.sign_words is not None:
            b += enc.sign_words.numel() * 4
        if enc.checksum is not None:
            b += 4
        if self.stages:
            b += 4                              # transmitted length field
        return b

    # --- per-stage reporting -------------------------------------------------

    def stage_report(self, x, eb=None, pred_shape=None, *, device="cuda"):
        """[(label, transmitted_bits_after_stage), ...] through the chain,
        starting from the raw tensor, on the plain path.  Pred stages have
        no header bits, so they fold into the base row's label."""
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        n = x.numel()
        if pred_shape is None:
            pred_shape = tuple(x.shape)
        ep, _ = C.encode_packed(x, self.qcfg(), eb, return_quantized=True,
                                bin_transform=self._bin_transform(
                                    pred_shape, n))
        base = self._base_bits(
            Encoded(ep.words, None, (), ep.out_idx, ep.out_payload,
                    ep.n_outliers, ep.overflow, ep.sign_words, ep.eb))
        base_label = "|".join([p.spec() for p in self.pred]
                              + [self.quant.spec(), self.pack.spec()])
        rows = [("raw", n * np.dtype(self.quant.dtype).itemsize * 8),
                (base_label, base + 32 * ep.words.shape[0])]
        cur, cur_n = ep.words, self.n_words(n)
        hdr_bits = 0
        for st in self.stages:
            _, cur, plen = st.encode_words(cur, cur_n)
            hdr_bits += st.header_content_bits(cur_n)
            cur_n = st.capacity_words(cur_n)
            # as wire_bits: +32 for the length field only when this
            # prefix's last stage is length-variable
            if st.transmits_len:
                bits = C.transmitted_bits(plen, base + hdr_bits + 32)
            else:
                bits = base + hdr_bits + 32 * cur.shape[0]
            rows.append((st.spec(), float(bits)))
        return rows


def parse_pipeline(spec) -> Pipeline:
    """Parse a spec string into a Pipeline.  Leading tokens naming
    registered pred stages (`predict.PRED_STAGES`) form the value-domain
    chain; then a quantizer (abs|rel|noa, positional eb, optional
    cap=/dtype=), pack:<bits>, and registered word stages (STAGES).
    `Pipeline.spec()` is the exact inverse.  Unknown tokens raise
    ValueError; float64 data raises NotImplementedError."""
    if isinstance(spec, Pipeline):
        return spec
    parts = [p.strip() for p in str(spec).split("|") if p.strip()]
    pred = []
    while parts and parts[0].split(":")[0] in P.PRED_STAGES:
        tok = parts.pop(0).split(":")
        pred.append(P.PRED_STAGES[tok[0]](tok[0], tok[1:]))
    if len(parts) < 2:
        raise ValueError(
            f"pipeline spec needs at least 'quant:<eb>|pack:<bits>', "
            f"got {spec!r}; grammar: {GRAMMAR}")
    qtok = parts[0].split(":")
    if qtok[0] not in _QUANT_MODES:
        raise _unknown_stage_error(qtok[0])
    pos, kw = _parse_params(qtok[1:])
    if len(pos) != 1:
        raise ValueError(f"quantizer stage needs exactly one error bound, "
                         f"got {parts[0]!r}")
    bad = set(kw) - {"cap", "dtype"}
    if bad:
        raise ValueError(f"unknown quantizer parameters {sorted(bad)}")
    quant = QuantStage(qtok[0], float(pos[0]),
                       float(kw.get("cap", _CAP_DEFAULT)),
                       kw.get("dtype", "float32"))
    ptok = parts[1].split(":")
    if ptok[0] != "pack" or len(ptok) != 2:
        raise ValueError(f"second stage must be 'pack:<bits>', "
                         f"got {parts[1]!r}")
    pack = PackStage(int(ptok[1]))
    if pack.bits not in (8, 16, 32):
        raise ValueError(f"pack bits must be 8, 16 or 32, got {pack.bits}")
    stages = parse_word_stages("|".join(parts[2:]), pack.bits)
    pipe = Pipeline(quant, pack, stages, tuple(pred))
    pipe.qcfg()                       # validate the combination eagerly
    if quant.dtype != "float32":
        raise not_ported(f"{quant.dtype} data", _F64_ITEM)
    return pipe

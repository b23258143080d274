"""LC-style pipeline API, in torch: spec strings -> one chain -> one wire.

Counterpart of `repro.core.pipeline` for the chains ported so far: a
quantizer stage, a pack stage and any number of `zero`/`narrow` chunk
stages, `"abs|rel|noa:<eb>|pack:{8,16,32}{|zero|narrow}"` (for example
`"rel:1e-3|pack:16"`, the `grad-wire-8` preset `"abs:1.0:cap=0.015625|pack:8"`
or `smoke-chain` `"rel:0.001|pack:8|zero|narrow"`).  The grammar is the
reference's:

    pipeline = { pred-stage "|" } quant:<eb> "|" pack:<bits> { "|" word-stage }

and the parser recognises every registered token.  Pred stages, the
`shuffle` and `ent` word stages, `verify=`, `integrity=`,
`return_quantized=` and float64 data raise NotImplementedError naming the
ROADMAP item that ports them.

Entry points run on the card unless the caller asks for the CPU:
`encode`/`decode` take `device=` (default "cuda") and raise when there is
no CUDA device; they never carry on quietly on the CPU.  Dispatch
(`kernels=None`) takes the CUDA kernels on the card and the plain torch
reference on the CPU; both are bit-identical (`kernels.pack` and
`kernels.lossless` are the reference's bit-exact twins by test), so the
guarantee is untouched by dispatch.  The dispatch table is in
`src/repro_torch/DESIGN.md`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import lossless as L
from ..kernels import pack as K
from . import audit as A
from . import codec as C
from .config import QuantizerConfig

_QUANT_MODES = ("abs", "rel", "noa")
_CAP_DEFAULT = 0.125          # QuantizerConfig.outlier_cap_frac default

GRAMMAR = ('pipeline = { pred-stage "|" } quant:<eb> "|" pack:<bits> '
           '{ "|" word-stage }')

# Registered tokens of the reference grammar that the port does not run
# yet, each with the ROADMAP item that ports it.
PRED_STAGES = {
    "delta": "ROADMAP A8 (value-domain predictors)",
    "lorenzo": "ROADMAP A8 (value-domain predictors)",
    "kvdelta": "ROADMAP A8 (value-domain predictors)",
}
UNPORTED_WORD_STAGES = {
    "shuffle": "ROADMAP A7 (shuffle word stage)",
    "ent": "ROADMAP A7 (ent word stage)",
}
_F64_ITEM = "ROADMAP C-port-2 (float64 on the packed wire)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({item})")


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
    checksum: torch.Tensor | None = None  # carried from a reference wire


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
        if kernels:
            return L.encode_words_lc(words, self.mode)
        return C.encode_words_lc(words, self.mode)

    def decode_words(self, header, payload, n_in: int,
                     kernels: bool = False):
        if kernels:
            return L.decode_words_lc(header, payload, n_in)
        return C.decode_words_lc(header, payload, n_in)

    def spec(self) -> str:
        return self.mode


def _parse_chunk(name, tokens):
    if tokens:
        raise ValueError(f"stage {name!r} takes no parameters")
    return ChunkStage(name)


# name -> parser(name, arg_tokens, pack_bits) -> word stage.  The
# reference's `shuffle` and `ent` are in UNPORTED_WORD_STAGES.
STAGES = {
    "zero": lambda name, tokens, pack_bits: _parse_chunk(name, tokens),
    "narrow": lambda name, tokens, pack_bits: _parse_chunk(name, tokens),
}


def parse_word_stages(stages, pack_bits: int) -> tuple:
    """Resolve a word-stage chain: a tuple of stage objects passes
    through; a spec fragment ("narrow", "zero|narrow", "", "none") parses
    through the STAGES registry."""
    if isinstance(stages, tuple):
        return stages
    out = []
    for part in str(stages).split("|"):
        part = part.strip()
        if not part or part == "none":
            continue
        tok = part.split(":")
        if tok[0] in UNPORTED_WORD_STAGES:
            raise not_ported(f"word stage {tok[0]!r}",
                             UNPORTED_WORD_STAGES[tok[0]])
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
    payload, transmitted_len).  Each stage after the first takes the
    previous stage's padded capacity."""
    headers, cur, cur_n = [], words, n_words
    plen = torch.full((), n_words, dtype=torch.int32, device=words.device)
    for st in stages:
        hdr, cur, plen = st.encode_words(cur, cur_n, kernels=kernels)
        headers.append(hdr)
        cur_n = st.capacity_words(cur_n)
    return tuple(headers), cur, plen


def decode_word_stages(stages, headers, payload, n_words: int,
                       kernels: bool = False):
    """Exact inverse of encode_word_stages."""
    sizes = word_stage_sizes(stages, n_words)
    cur = payload
    for st, hdr, n_in in reversed(list(zip(stages, headers, sizes[:-1]))):
        cur = st.decode_words(hdr, cur, n_in, kernels=kernels)
    return cur


def _to_device(enc: Encoded, dev: torch.device) -> Encoded:
    def mv(f):
        if f is None:
            return None
        if isinstance(f, tuple):
            return tuple(h.to(dev) for h in f)
        return f.to(dev)
    return Encoded(*(mv(f) for f in enc))


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """One chain: quantizer -> pack -> word stages.  `parse_pipeline` /
    `spec()` are exact inverses."""
    quant: QuantStage
    pack: PackStage
    stages: tuple = ()

    def spec(self) -> str:
        return "|".join([self.quant.spec(), self.pack.spec()]
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
        """Dotted name of the kernel entry this chain's encode maps onto.
        One chunk stage fuses into the pack pass (`encode_packed_lc`);
        with more, the pack kernel runs and each chunk stage then runs
        the select kernel (`kernels.lossless.encode_words_lc`), where the
        reference takes its jit path: the wire is the same."""
        if len(self.stages) == 1:
            return "repro_torch.kernels.lossless.encode_packed_lc"
        return "repro_torch.kernels.pack.encode_packed"

    def encode_words(self, words, n_words: int, kernels: bool = False):
        """Run the word stages only.  Returns (headers, payload, len)."""
        return encode_word_stages(self.stages, words, n_words, kernels)

    def decode_words(self, headers, payload, n_words: int,
                     kernels: bool = False):
        """Exact inverse of encode_words."""
        return decode_word_stages(self.stages, headers, payload, n_words,
                                  kernels)

    # --- encode / decode ---------------------------------------------------

    def encode(self, x, eb=None, *, device="cuda", kernels: bool | None = None,
               return_quantized: bool = False, verify: bool = False,
               integrity: bool = False) -> Encoded:
        """Encode x (a tensor or array) on `device`.  `eb` (a float or a 0-d
        tensor, which stays on the device) overrides the bound for ABS.
        kernels=None takes the CUDA kernels on the card and the plain torch
        reference on the CPU; kernels=False forces the reference."""
        if verify or integrity:
            raise not_ported("encode(verify=/integrity=)",
                             "ROADMAP A9 (audit plane)")
        if return_quantized:
            raise not_ported("encode(return_quantized=True)",
                             "ROADMAP A10 (gradient wire bookkeeping)")
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        if x.dtype != torch.float32:
            raise not_ported(f"{x.dtype} data", _F64_ITEM)
        use_k = dev.type == "cuda" if kernels is None else kernels
        if use_k and len(self.stages) == 1:
            lc = L.encode_packed_lc(x, self.qcfg(), eb,
                                    stage=self.stages[0].mode)
            return Encoded(lc.payload, lc.payload_len, (lc.header_words,),
                           lc.out_idx, lc.out_payload, lc.n_outliers,
                           lc.overflow, lc.sign_words, lc.eb)
        if use_k:
            ep = K.encode_packed(x, self.qcfg(), eb)
        else:
            ep = C.encode_packed(x, self.qcfg(), eb)
        headers, payload, plen = self.encode_words(
            ep.words, self.n_words(x.numel()), use_k)
        return Encoded(payload, plen, headers, ep.out_idx, ep.out_payload,
                       ep.n_outliers, ep.overflow, ep.sign_words, ep.eb)

    def decode(self, enc: Encoded, n: int | None = None, shape=None,
               dtype=None, *, device="cuda", kernels: bool | None = None,
               verify: bool = False) -> torch.Tensor:
        """Invert the chain on `device`: word stages in reverse, then
        unpack + dequantize + exact outlier restore.  Bit-identical between
        the kernel and reference back ends.  A transmitted `payload_len`
        outside [0, capacity] raises `audit.WireIntegrityError` (the one
        host read of a decode)."""
        if verify:
            raise not_ported("decode(verify=True)", "ROADMAP A9 (audit plane)")
        if n is None:
            if shape is None:
                raise ValueError("decode needs n or shape")
            n = int(np.prod(shape))
        if dtype not in (None, torch.float32, "float32"):
            raise not_ported(f"{dtype} data", _F64_ITEM)
        dev = resolve_device(device)
        enc = _to_device(enc, dev)
        A.check_payload_len(enc.payload_len, enc.payload.shape[0],
                            what=f"Encoded[{self.spec()}]")
        use_k = dev.type == "cuda" if kernels is None else kernels
        words = self.decode_words(enc.headers, enc.payload, self.n_words(n),
                                  use_k)
        ep = C.EncodedPacked(words, enc.out_idx, enc.out_payload,
                             enc.n_outliers, enc.overflow, enc.sign_words,
                             enc.eb)
        if use_k:
            return K.decode_packed(ep, self.qcfg(), n=n, shape=shape)
        return C.decode_packed(ep, self.qcfg(), n=n, shape=shape)

    # --- honest wire accounting --------------------------------------------

    def _base_bits(self, enc: Encoded) -> int:
        bits = 64 + enc.out_idx.shape[0] * (32 + 32)
        if enc.sign_words is not None:
            bits += 32 * enc.sign_words.shape[0]
        if enc.checksum is not None:
            bits += 32
        return bits

    def wire_bits(self, enc: Encoded, n: int | None = None):
        """Transmitted wire size in bits, the reference's accounting bit
        for bit: the transmitted payload prefix, every stage's header
        content (tile padding excluded), the outlier table, the sign plane
        and the 64-bit packed header (+32 for a transmitted length).  A
        Python int for stage-free chains; after a chunk stage a 0-d
        float32 tensor on the wire's device (`codec.transmitted_bits`), so
        an encode needs no host sync to account its wire.  Pass `n` for
        exact per-stage input sizes; without it the final capacity is
        used, which gives the same header content for chunk stages."""
        if not self.stages:
            return self._base_bits(enc) + 32 * enc.payload.shape[0]
        if n is not None:
            sizes = self.stage_sizes(n)[:-1]
        else:
            sizes = [enc.payload.shape[0]] * len(self.stages)
        hdr = sum(st.header_content_bits(sz)
                  for st, sz in zip(self.stages, sizes))
        return C.transmitted_bits(enc.payload_len,
                                  self._base_bits(enc) + hdr + 32)

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


def _unknown_stage_error(tok: str) -> ValueError:
    return ValueError(
        f"unknown stage {tok!r}; registered value-domain (pred) stages: "
        f"{sorted(PRED_STAGES)}; quantizers: {sorted(_QUANT_MODES)}; "
        f"registered word-domain stages: "
        f"{sorted([*STAGES, *UNPORTED_WORD_STAGES])}; "
        f"grammar: {GRAMMAR}")


def parse_pipeline(spec) -> Pipeline:
    """Parse a spec string into a Pipeline.  `Pipeline.spec()` is the exact
    inverse.  Registered tokens of chains not yet ported raise
    NotImplementedError; unknown tokens raise ValueError."""
    if isinstance(spec, Pipeline):
        return spec
    parts = [p.strip() for p in str(spec).split("|") if p.strip()]
    if parts and parts[0].split(":")[0] in PRED_STAGES:
        name = parts[0].split(":")[0]
        raise not_ported(f"pred stage {name!r}", PRED_STAGES[name])
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
    pipe = Pipeline(quant, pack, stages)
    pipe.qcfg()                       # validate the combination eagerly
    if quant.dtype != "float32":
        raise not_ported(f"{quant.dtype} data", _F64_ITEM)
    return pipe

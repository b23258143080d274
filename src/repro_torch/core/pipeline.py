"""LC-style pipeline API, in torch: spec strings -> one chain -> one wire.

Counterpart of `repro.core.pipeline` for the chains ported so far: a
quantizer stage and a pack stage, `"abs|rel|noa:<eb>|pack:{8,16,32}"`
(for example `"rel:1e-3|pack:16"` or the `grad-wire-8` preset
`"abs:1.0:cap=0.015625|pack:8"`).  The grammar is the reference's:

    pipeline = { pred-stage "|" } quant:<eb> "|" pack:<bits> { "|" word-stage }

and the parser recognises every registered token.  Pred stages, word
stages, `verify=`, `integrity=`, `return_quantized=` and float64 data raise
NotImplementedError naming the ROADMAP item that ports them.

Entry points run on the card unless the caller asks for the CPU:
`encode`/`decode` take `device=` (default "cuda") and raise when there is
no CUDA device; they never carry on quietly on the CPU.  Dispatch
(`kernels=None`) takes the fused CUDA kernels on the card and the plain
torch reference on the CPU; both are bit-identical (`kernels.pack` is the
reference's bit-exact twin by test), so the guarantee is untouched by
dispatch.  The dispatch table is in `src/repro_torch/DESIGN.md`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

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
WORD_STAGES = {
    "zero": "ROADMAP slice 2: A5b and B5-B7 (LC chunk coder and kernels)",
    "narrow": "ROADMAP slice 2: A5b and B5-B7 (LC chunk coder and kernels)",
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
    int32 tensors holding the uint32 bits; `headers` holds one plane per
    word stage (none in the ported chains); `payload_len` is the
    transmitted word count."""
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
    """One chain: quantizer -> pack.  `parse_pipeline` / `spec()` are exact
    inverses."""
    quant: QuantStage
    pack: PackStage

    def spec(self) -> str:
        return f"{self.quant.spec()}|{self.pack.spec()}"

    def qcfg(self) -> QuantizerConfig:
        return QuantizerConfig(mode=self.quant.mode,
                               error_bound=self.quant.eb,
                               bin_bits=self.pack.bits,
                               dtype=self.quant.dtype,
                               outlier_cap_frac=self.quant.cap)

    def n_words(self, n: int) -> int:
        """Packed word count of an n-element tensor."""
        return C.packed_word_count(n, self.pack.bits)

    def kernel_dispatch(self) -> str:
        """Dotted name of the fused entry this chain maps onto."""
        return "repro_torch.kernels.pack.encode_packed"

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
        n = x.numel()
        use_k = dev.type == "cuda" if kernels is None else kernels
        if use_k:
            ep = K.encode_packed(x, self.qcfg(), eb)
        else:
            ep = C.encode_packed(x, self.qcfg(), eb)
        plen = torch.full((), self.n_words(n), dtype=torch.int32, device=dev)
        return Encoded(ep.words, plen, (), ep.out_idx, ep.out_payload,
                       ep.n_outliers, ep.overflow, ep.sign_words, ep.eb)

    def decode(self, enc: Encoded, n: int | None = None, shape=None,
               dtype=None, *, device="cuda", kernels: bool | None = None,
               verify: bool = False) -> torch.Tensor:
        """Invert the chain on `device`: unpack + dequantize + exact outlier
        restore.  Bit-identical between the kernel and reference back ends.
        A transmitted `payload_len` outside [0, capacity] raises
        `audit.WireIntegrityError`."""
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
        ep = C.EncodedPacked(enc.payload, enc.out_idx, enc.out_payload,
                             enc.n_outliers, enc.overflow, enc.sign_words,
                             enc.eb)
        use_k = dev.type == "cuda" if kernels is None else kernels
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

    def wire_bits(self, enc: Encoded, n: int | None = None) -> int:
        """Transmitted wire size in bits: the payload plane, the outlier
        table, the sign plane and the 64-bit packed header (the reference's
        accounting for stage-free chains, bit for bit)."""
        return self._base_bits(enc) + 32 * enc.payload.shape[0]

    def wire_bytes(self, enc: Encoded, n: int | None = None) -> int:
        return self.wire_bits(enc, n) // 8

    def capacity_bytes(self, enc: Encoded) -> int:
        """Static upper bound: what a padded all-gather buffer holds."""
        b = (enc.payload.numel() + enc.out_idx.numel()
             + enc.out_payload.numel()
             + sum(h.numel() for h in enc.headers)) * 4 + 8
        if enc.sign_words is not None:
            b += enc.sign_words.numel() * 4
        if enc.checksum is not None:
            b += 4
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
        f"registered word-domain stages: {sorted(WORD_STAGES)}; "
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
    for part in parts[2:]:
        name = part.split(":")[0]
        if name not in WORD_STAGES:
            raise _unknown_stage_error(name)
        raise not_ported(f"word stage {name!r}", WORD_STAGES[name])
    pipe = Pipeline(quant, pack)
    pipe.qcfg()                       # validate the combination eagerly
    if quant.dtype != "float32":
        raise not_ported(f"{quant.dtype} data", _F64_ITEM)
    return pipe

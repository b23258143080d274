"""Closed-loop predictor stages, the value-domain half of the pipeline
grammar, in torch.

Counterpart of `repro.core.predict`.  The encoder quantizes pointwise first
(the bound is decided there and never touched again), then transforms the
int32 bin plane with an exact integer bijection before bit-packing:

    bins --pred.encode_bins--> codes --pack_words--> word plane

Predicting from the previous bin is predicting from the decoder's view:
``bin[i-1] * eb2`` is the reconstruction the decoder holds, so the bin
delta is the closed-loop residual scaled by 1/eb2.  ``scan_reference``
writes the same computation as the literal per-element
reconstruction-feedback loop.

Exactness: all arithmetic is two's complement mod 2^32.  A residual is
zigzag-folded to the pack width ``bits``; the decoder integrates and
re-wraps to ``bits`` bits, which recovers the bins exactly because
|bin| < 2^(bits-1).  torch's int32 sums must not be trusted to wrap, so
the differences and the cumulative sums run in int64 and are folded back
to their low 32 (or ``bits``) bits, which is the same ring.

Stage contract (`PredStage`):

    spec()                          spec token ("delta", "lorenzo", ...)
    header_content_bits()           0: the predictors are static
                                    bijections with no header plane
    encode_bins(bins, shape, bits)  int32[n] -> int32[n] coded plane
    decode_bins(codes, shape, bits) exact inverse (same shape/bits)

`shape` is the value-domain shape of the original tensor (`pred_shape` of
`Pipeline.encode`/`decode`); `bits` is the pack width.  Registered
predictors (PRED_STAGES): `delta` (1-D previous value), `lorenzo` (2-D
Lorenzo over the last two dims, leading dims batch), `kvdelta` (previous
token along the second-to-last axis, token 0 unpredicted).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_U32 = 0xFFFFFFFF


# ------------------------------------------------------------- bit helpers --

def _wrap64(v: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 -> the int64 value of its low `bits` bits as two's
    complement (the canonical representative mod 2^bits)."""
    half = 1 << (bits - 1)
    return ((v & ((1 << bits) - 1)) ^ half) - half


def _sign_extend(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Canonical int32 representative of a `bits`-bit two's-complement
    value (its low `bits` bits, sign-extended)."""
    return _wrap64(v.to(torch.int64), min(bits, 32)).to(torch.int32)


def _fold(d: torch.Tensor, bits: int) -> torch.Tensor:
    """Residual (any integer tensor) -> zigzag code, as sign-extended
    `bits`-bit int32.  Small |d| of either sign gives small codes."""
    d = _wrap64(d.to(torch.int64), min(bits, 32))
    z = (d << 1) ^ (d >> 63)
    return _wrap64(z, min(bits, 32)).to(torch.int32)


def _unfold(z: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact inverse of _fold, as int64 (sign-extended `bits`-bit values)."""
    zu = z.to(torch.int64) & ((1 << min(bits, 32)) - 1)
    d = (zu >> 1) ^ -(zu & 1)
    return _wrap64(d, min(bits, 32))


def _batched_dims(shape, flat_1d) -> tuple:
    """(batch, rows, cols) view of `shape` for a last-two-dims predictor;
    1-D/0-D input maps to `flat_1d(n)` (how the stage degrades)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if len(shape) < 2:
        return flat_1d(n)
    b = 1
    for s in shape[:-2]:
        b *= s
    return (b, shape[-2], shape[-1])


def _shift(p: torch.Tensor, dim: int) -> torch.Tensor:
    """p moved one step forward along dim, zero-filled (the neighbour at
    i-1, 0 out of range)."""
    out = torch.zeros_like(p)
    src = p.narrow(dim, 0, p.shape[dim] - 1)
    out.narrow(dim, 1, p.shape[dim] - 1).copy_(src)
    return out


# ----------------------------------------------------------------- stages --

@dataclasses.dataclass(frozen=True)
class DeltaStage:
    """1-D previous-value predictor: code[i] = fold(bin[i] - bin[i-1]).
    The whole tensor is one flat stream; the first element is predicted
    from 0."""

    def spec(self) -> str:
        return "delta"

    def header_content_bits(self) -> int:
        return 0

    def encode_bins(self, bins, shape, bits: int):
        b = bins.reshape(-1).to(torch.int64)
        return _fold(b - _shift(b, 0), bits)

    def decode_bins(self, codes, shape, bits: int):
        d = _unfold(codes.reshape(-1), bits)
        return _sign_extend(torch.cumsum(d, 0), bits)


@dataclasses.dataclass(frozen=True)
class LorenzoStage:
    """2-D Lorenzo predictor over the last two dims: the residual is
    bin[i,j] - bin[i-1,j] - bin[i,j-1] + bin[i-1,j-1] (out-of-range
    neighbours read 0).  Leading dims batch; 1-D input is a single-row
    plane, where lorenzo degrades to delta."""

    @staticmethod
    def _dims(shape) -> tuple:
        return _batched_dims(shape, lambda n: (1, 1, n))

    def spec(self) -> str:
        return "lorenzo"

    def header_content_bits(self) -> int:
        return 0

    def encode_bins(self, bins, shape, bits: int):
        p = bins.reshape(self._dims(shape)).to(torch.int64)
        dr = p - _shift(p, 1)
        dc = dr - _shift(dr, 2)
        return _fold(dc, bits).reshape(-1)

    def decode_bins(self, codes, shape, bits: int):
        d = _unfold(codes.reshape(self._dims(shape)), bits)
        b = _wrap64(torch.cumsum(d, 2), 32)
        b = torch.cumsum(b, 1)
        return _sign_extend(b, bits).reshape(-1)


@dataclasses.dataclass(frozen=True)
class KVDeltaStage:
    """Previous-token delta along the second-to-last axis, the KV-page
    predictor: on a (page_tokens, head_dim) page each channel is predicted
    from the same channel of the previous token; token 0 is unpredicted,
    so every page decodes on its own.  1-D input is an (n, 1) column,
    where kvdelta degrades to delta."""

    @staticmethod
    def _dims(shape) -> tuple:
        return _batched_dims(shape, lambda n: (1, n, 1))

    def spec(self) -> str:
        return "kvdelta"

    def header_content_bits(self) -> int:
        return 0

    def encode_bins(self, bins, shape, bits: int):
        p = bins.reshape(self._dims(shape)).to(torch.int64)
        return _fold(p - _shift(p, 1), bits).reshape(-1)

    def decode_bins(self, codes, shape, bits: int):
        d = _unfold(codes.reshape(self._dims(shape)), bits)
        return _sign_extend(torch.cumsum(d, 1), bits).reshape(-1)


# --------------------------------------------------------------- registry --

def _parse_plain(name, tokens, cls):
    if tokens:
        raise ValueError(f"pred stage {name!r} takes no parameters")
    return cls()


# name -> parser(name, arg_tokens) -> PredStage instance.
PRED_STAGES = {
    "delta": lambda name, tokens: _parse_plain(name, tokens, DeltaStage),
    "lorenzo": lambda name, tokens: _parse_plain(name, tokens, LorenzoStage),
    "kvdelta": lambda name, tokens: _parse_plain(name, tokens, KVDeltaStage),
}


def register_pred_stage(name: str, parser) -> None:
    """Register a value-domain stage: parser(name, arg_tokens) -> stage."""
    PRED_STAGES[name] = parser


def parse_pred_stages(stages) -> tuple:
    """Resolve a pred-stage chain: a tuple of stage objects passes
    through; a spec fragment ("delta", "kvdelta", "", "none") parses via
    the PRED_STAGES registry."""
    if isinstance(stages, tuple):
        return stages
    out = []
    for part in str(stages).split("|"):
        part = part.strip()
        if not part or part == "none":
            continue
        tok = part.split(":")
        if tok[0] not in PRED_STAGES:
            raise ValueError(f"unknown pred stage {tok[0]!r}; registered "
                             f"value-domain stages: {sorted(PRED_STAGES)}")
        out.append(PRED_STAGES[tok[0]](tok[0], tok[1:]))
    return tuple(out)


# ------------------------------------------------------------- chain ops --

def encode_pred_stages(pred, bins, shape, bits: int):
    """Apply a pred chain to a flat int32 bin plane, in spec order."""
    for st in pred:
        bins = st.encode_bins(bins, shape, bits)
    return bins


def decode_pred_stages(pred, codes, shape, bits: int):
    """Exact inverse of encode_pred_stages (reverse order)."""
    for st in reversed(pred):
        codes = st.decode_bins(codes, shape, bits)
    return codes


# ------------------------------------------- reconstruction-feedback scan --

def _wrap_py(v: int, bits: int) -> int:
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def _fold_py(d: int, bits: int) -> int:
    return ((d << 1) ^ (d >> 63)) & ((1 << bits) - 1)


def _unfold_py(z: int, bits: int) -> int:
    return (z >> 1) ^ (-(z & 1))


def scan_reference(stage, bins, shape, bits: int):
    """The closed-loop predictor as the literal per-element
    reconstruction-feedback loop: predict from the bins reconstructed so
    far, emit the folded residual, feed the decoded residual back.  O(n)
    Python, for tests.  Returns (codes, recon) as int32 numpy arrays;
    recon == bins is the closed-loop exactness property."""
    bins = np.asarray(bins, dtype=np.int64).reshape(-1)
    if isinstance(stage, DeltaStage):
        dims, lorenzo = (1, bins.size, 1), False
    elif isinstance(stage, KVDeltaStage):
        dims, lorenzo = KVDeltaStage._dims(shape), False
    elif isinstance(stage, LorenzoStage):
        dims, lorenzo = LorenzoStage._dims(shape), True
    else:
        raise TypeError(f"no scan reference for {stage!r}")
    p = bins.reshape(dims)
    codes = np.zeros(dims, np.int64)
    recon = np.zeros(dims, np.int64)
    nb, nh, nw = dims
    for b in range(nb):
        for i in range(nh):
            for j in range(nw):
                if lorenzo:
                    pred = ((int(recon[b, i - 1, j]) if i else 0)
                            + (int(recon[b, i, j - 1]) if j else 0)
                            - (int(recon[b, i - 1, j - 1])
                               if i and j else 0))
                else:
                    pred = int(recon[b, i - 1, j]) if i else 0
                d = _wrap_py(int(p[b, i, j]) - pred, bits)
                z = _fold_py(d, bits)
                codes[b, i, j] = _wrap_py(z, bits)
                recon[b, i, j] = _wrap_py(pred + _unfold_py(z, bits), bits)
    return (codes.reshape(-1).astype(np.int32),
            recon.reshape(-1).astype(np.int32))

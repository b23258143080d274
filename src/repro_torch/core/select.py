"""Adaptive chain selection, in torch: pick the encoding chain per shard at
run time from a small static candidate set.

Counterpart of `repro.core.select`:

  * `plane_stats`: one pass over the packed word plane.  The per-chunk
    codes give the zero-chunk fraction and the exact zero/narrow payload
    sizes; the byte histogram of the narrowed surviving chunks, priced by
    the real coder's `codec.ent_code_lengths`, gives the `ent` estimate.
    A pred prefix is scored on its residual plane.
  * `chain_cost`: estimated payload bits + the chain's static header
    content + `bias` * n_words / 1024 (the autotuned calibration of
    `configs.registry.SELECTOR_SETS`), all in float32 as the reference
    computes them; the argmin wins.
  * `Selector.encode`: the stats pass (the pack kernel B1 on the card),
    the costs as torch ops, one host read of the argmin, then the chosen
    candidate's own `Pipeline.encode` with its kernels, embedded in the
    uniform `SelectedWire`.  The reference's `lax.switch` also runs only
    the chosen branch, and that branch is the candidate's own encode, so
    the wire is bit-identical to encoding with that chain directly.
  * `SelectedWire`: the chain id rides as a 1-byte header, the payload is
    padded to the largest candidate capacity and the stage headers are
    flattened into one padded plane.  `Selector.wire_bits` is the chosen
    chain's `Pipeline.wire_bits` + 8 (+ 32 with a checksum), in float32
    as the reference's switch returns it.

`Selector` has the `Pipeline` surface its consumers use (`encode`,
`decode`, `wire_bits`, `wire_bytes`, `capacity_bytes`, `qcfg`, `spec`), so
`compression.grads` ships selector wires through the same
`CompressedShard`/`Transport` path (always the gather branch: each shard
picked its own chain).  Candidates may hold only `zero`/`narrow`/`ent`
word stages: the shared statistics cannot price `shuffle`.

`KVSelector` picks a page fragment (optional pred stages + word stages)
per KV page: the same statistics per page (`page_stats`, every page of a
plane at once), the costs, an argmin per page, and each fragment's own
page encode over every page, the chosen one kept per page (the reference
vmaps a `lax.switch`, which selects the same way).  `compression.kv`
packs and unpacks with it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..configs.registry import get_selector_set
from ..kernels import pack as K
from . import audit as A
from . import codec as C
from . import predict as P
from . import quantizer as Q
from .pipeline import (ChunkStage, Encoded, EntStage, Pipeline,
                       _to_device, decode_page_stages, encode_page_stages,
                       kernel_device, parse_pipeline, parse_word_stages,
                       resolve_device, word_stage_sizes)

CHAIN_ID_BITS = 8          # the transmitted chain-id header
MAX_CHAINS = 1 << CHAIN_ID_BITS


class SelectedWire(NamedTuple):
    """The uniform wire every selector produces (the reference's
    `SelectedWire`).  Word planes are int32 tensors holding uint32 bits.

      * `chain_id`: int32 0-d, transmitted as one byte; decode and the
        accounting dispatch on it;
      * `payload`: the chosen chain's final word plane, zero-padded to the
        largest capacity in the set;
      * `header`: the chosen chain's stage header planes, raveled in chain
        order and zero-padded to the largest total in the set;
      * the rest is the outlier table, sign plane and bound, which every
        candidate shares (one quantizer and pack stage per set), and the
        opt-in checksum."""
    chain_id: torch.Tensor
    payload: torch.Tensor
    payload_len: torch.Tensor
    header: torch.Tensor
    out_idx: torch.Tensor
    out_payload: torch.Tensor
    n_outliers: torch.Tensor
    overflow: torch.Tensor
    sign_words: torch.Tensor | None
    eb: torch.Tensor | None
    checksum: torch.Tensor | None = None


# ------------------------------------------------------------ statistics --

class PlaneStats(NamedTuple):
    """Per-plane statistics, float32 0-d tensors: the fraction of all-zero
    chunks, the exact payload bits under `zero` and under `narrow`, and
    the estimated bits under `narrow|ent`."""
    zero_frac: torch.Tensor
    zero_bits: torch.Tensor
    narrow_bits: torch.Tensor
    ent_bits: torch.Tensor


def plane_stats(words: torch.Tensor, n_words: int) -> PlaneStats:
    """Statistics of one packed word plane (int32[n_words]), on its device
    with no host sync."""
    f32 = torch.float32
    chunks = C.lc_chunks(words[:n_words])
    nc = chunks.shape[0]
    codes = C.lc_chunk_codes(chunks, "narrow")
    lens_w = C.lc_chunk_lens(codes)                      # words per chunk
    alive = codes > 0
    n_alive = alive.sum(dtype=torch.int32).to(f32)
    zero_bits = 32.0 * C.LC_CHUNK * n_alive
    narrow_bits = 32.0 * lens_w.sum(dtype=torch.int32).to(f32)
    # the byte histogram of the narrowed chunks' valid words: the byte
    # multiset `ent` codes in a narrow|ent chain.  Each chunk counts into
    # its own row of bins (slot ENT_SYMS takes the invalid bytes), so the
    # atomic adds spread over nc * 257 counters; the rows sum exactly.
    byts = C._ent_chunk_bytes(C.lc_narrow_chunks(chunks, codes))
    slot = torch.arange(byts.shape[1], dtype=torch.int32,
                        device=words.device) // 4
    sym = torch.where(slot[None, :] < lens_w[:, None], byts, C.ENT_SYMS)
    row = torch.arange(nc, dtype=torch.int64, device=words.device)
    idx = (row[:, None] * (C.ENT_SYMS + 1) + sym).reshape(-1)
    counts = torch.zeros(nc * (C.ENT_SYMS + 1), dtype=torch.int32,
                         device=words.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    hist = counts.reshape(nc, C.ENT_SYMS + 1).sum(0, dtype=torch.int32)
    hist = hist[:C.ENT_SYMS]
    elens = C.ent_code_lengths(hist)
    ent_bits = C.f32_sum(hist.to(f32) * elens.to(f32))
    # the verbatim escape: `ent` never pays more than its input
    return PlaneStats(1.0 - n_alive / float(nc), zero_bits, narrow_bits,
                      torch.minimum(ent_bits, narrow_bits))


def page_stats(words: torch.Tensor, n_words: int,
               need_ent: bool = False) -> PlaneStats:
    """`plane_stats` of each row of words int32[R, n_words] (a KV page
    each), as float32[R] planes; the elementwise float32 arithmetic is the
    scalar one's, so each row's numbers are bit-equal to plane_stats of
    that row.  `ent_bits` is computed (row by row) only with need_ent,
    else None."""
    f32 = torch.float32
    rows = words.shape[0]
    nc = C.lc_chunk_count(n_words)
    if nc * C.LC_CHUNK != n_words:
        words = torch.cat([words, words.new_zeros(
            rows, nc * C.LC_CHUNK - n_words)], 1)
    codes = C.lc_chunk_codes(words.reshape(-1, C.LC_CHUNK),
                             "narrow").reshape(rows, nc)
    lens_w = C.lc_chunk_lens(codes)
    n_alive = (codes > 0).sum(1, dtype=torch.int32).to(f32)
    zero_bits = 32.0 * C.LC_CHUNK * n_alive
    narrow_bits = 32.0 * lens_w.sum(1, dtype=torch.int32).to(f32)
    ent_bits = None
    if need_ent:
        ent_bits = torch.stack([plane_stats(w, n_words).ent_bits
                                for w in words])
    return PlaneStats(1.0 - n_alive / float(nc), zero_bits, narrow_bits,
                      ent_bits)


def _static_hdr_bits(stages: tuple, n_words: int) -> int:
    """Transmitted header-content bits of a word chain: per-stage header
    content plus the 32-bit length field of a length-variable chain."""
    sizes = word_stage_sizes(stages, n_words)[:-1]
    bits = sum(st.header_content_bits(sz) for st, sz in zip(stages, sizes))
    if stages and stages[-1].transmits_len:
        bits += 32
    return bits


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _est_payload_bits(stages: tuple, st: PlaneStats, n_words: int):
    """Estimated payload bits of a word chain over a plane with statistics
    `st`: exact for plain/zero/narrow, the estimate for chains ending in
    `ent`."""
    if not stages:
        return _f32(32 * n_words, st.zero_bits)
    last = stages[-1]
    if isinstance(last, EntStage):
        if st.ent_bits is None:
            raise ValueError("ent_bits was not computed (need_ent=False)")
        return st.ent_bits
    if isinstance(last, ChunkStage) and last.mode == "narrow":
        return st.narrow_bits
    if isinstance(last, ChunkStage):
        return st.zero_bits
    raise ValueError(f"stage {last.spec()!r} is not scoreable from the "
                     f"shared statistics")


def chain_cost(stages: tuple, st: PlaneStats, n_words: int,
               bias: float = 0.0) -> torch.Tensor:
    """Estimated payload bits + static header content + the calibration
    bias (bits per 1024 words), float32 in the reference's order."""
    like = st.zero_bits
    return (_est_payload_bits(stages, st, n_words)
            + _f32(_static_hdr_bits(stages, n_words), like)
            + _f32(bias, like) * _f32(n_words / 1024.0, like))


def _ends_in_ent(stages: tuple) -> bool:
    return bool(stages) and isinstance(stages[-1], EntStage)


def _check_scoreable(stages: tuple):
    for st in stages:
        if not isinstance(st, (ChunkStage, EntStage)):
            raise ValueError(
                f"selector candidates may only contain zero/narrow/ent "
                f"word stages (the scoreable ones); got {st.spec()!r}")


def _pred_key(pred: tuple) -> tuple:
    return tuple(p.spec() for p in pred)


# -------------------------------------------------------------- Selector --

@dataclasses.dataclass(frozen=True)
class Selector:
    """A static candidate set of full pipelines sharing one quantizer and
    pack stage, with run-time per-shard selection."""
    name: str
    chains: tuple                 # tuple[Pipeline, ...] sharing quant+pack
    bias: tuple = ()              # per-chain bits/1024 words (autotuned)

    def __post_init__(self):
        if not self.chains:
            raise ValueError("a selector needs at least one candidate")
        if len(self.chains) > MAX_CHAINS:
            raise ValueError(f"at most {MAX_CHAINS} candidates fit the "
                             f"{CHAIN_ID_BITS}-bit chain-id header")
        q0, p0 = self.chains[0].quant, self.chains[0].pack
        for pipe in self.chains:
            if pipe.quant != q0 or pipe.pack != p0:
                raise ValueError(
                    f"every candidate in a selector set must share the "
                    f"quantizer and pack stages; {pipe.spec()!r} differs "
                    f"from {self.chains[0].spec()!r}")
            _check_scoreable(pipe.stages)
        if self.bias and len(self.bias) != len(self.chains):
            raise ValueError("bias must have one entry per candidate")

    # --- Pipeline-surface statics -----------------------------------------

    @property
    def quant(self):
        return self.chains[0].quant

    @property
    def pack(self):
        return self.chains[0].pack

    def spec(self) -> str:
        return f"auto:{self.name}"

    def qcfg(self):
        return self.chains[0].qcfg()

    def n_words(self, n: int) -> int:
        return self.chains[0].n_words(n)

    def capacity_words(self, n: int) -> int:
        """Payload capacity of the uniform wire: the largest final
        capacity across candidates."""
        return max(pipe.stage_sizes(n)[-1] for pipe in self.chains)

    def header_capacity_words(self, n: int) -> int:
        """Size of the flattened header plane: the largest total of stored
        header words across candidates."""
        return max(self._chain_header_words(i, n)
                   for i in range(len(self.chains)))

    def _chain_header_words(self, i: int, n: int) -> int:
        pipe = self.chains[i]
        sizes = pipe.stage_sizes(n)[:-1]
        return sum(st.header_words(sz) for st, sz in zip(pipe.stages, sizes))

    def _pred_shape(self, pred_shape, n: int) -> tuple:
        shape = (n,) if pred_shape is None else tuple(pred_shape)
        if int(np.prod(shape)) != n:
            raise ValueError(f"pred_shape {shape} has "
                             f"{int(np.prod(shape))} elements, tensor "
                             f"has {n}")
        return shape

    # --- scoring ----------------------------------------------------------

    def _stats_words(self, flat: torch.Tensor, eb, use_k: bool):
        """The stats pass: (packed word plane, bins or None).  On the
        kernel path the pack kernel gives the words, and the bins of a
        pred prefix are unpacked from them (exact: every bin fits its
        field); on the plain path the reference's `encode_packed`."""
        cfg = self.qcfg()
        if not use_k:
            ep, qt = C.encode_packed(flat, cfg, eb, return_quantized=True)
            return ep.words, qt.bins
        flat = flat.contiguous()
        if cfg.mode == "rel":
            return K.rel_pack(flat, cfg)[0], None
        if cfg.mode == "noa":
            eb = Q.value_range_eb(flat, cfg)
        eb_arr = C.eb_plane(cfg.error_bound if eb is None else eb, flat)
        return K.abs_pack(flat, eb_arr.reshape(1), cfg)[0], None

    def _costs(self, words, bins, n: int, pred_shape) -> torch.Tensor:
        """float32[n_chains] estimated transmitted bits per candidate (one
        stats pass per distinct pred prefix in the set)."""
        n_words = self.n_words(n)
        shape = self._pred_shape(pred_shape, n)
        bits = self.pack.bits
        stats, costs = {}, []
        for i, pipe in enumerate(self.chains):
            key = _pred_key(pipe.pred)
            if key not in stats:
                w = words
                if pipe.pred:
                    if bins is None:
                        bins = C.unpack_words(words, n, bits)
                    codes = P.encode_pred_stages(pipe.pred, bins, shape, bits)
                    w = C.pack_words(codes, bits)
                stats[key] = plane_stats(w, n_words)
            b = self.bias[i] if self.bias else 0.0
            costs.append(chain_cost(pipe.stages, stats[key], n_words, b))
        return torch.stack(costs)

    def score(self, x, eb=None, *, pred_shape=None, device="cuda",
              kernels: bool | None = None) -> torch.Tensor:
        """Estimated wire bits per candidate (float32[n_chains])."""
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        if pred_shape is None:
            pred_shape = tuple(x.shape)
        use_k = kernel_device(dev) if kernels is None else kernels
        flat = x.reshape(-1)
        words, bins = self._stats_words(flat, eb, use_k)
        return self._costs(words, bins, flat.shape[0], pred_shape)

    # --- encode -----------------------------------------------------------

    def _embed(self, enc: Encoded, i: int, n: int) -> SelectedWire:
        """One candidate's `Encoded` in the uniform wire."""
        dev = enc.payload.device
        cap = self.capacity_words(n)
        payload = torch.cat([enc.payload,
                             enc.payload.new_zeros(cap - enc.payload.numel())])
        hw = self.header_capacity_words(n)
        header = torch.cat([h.reshape(-1) for h in enc.headers]
                           + [torch.zeros(hw, dtype=torch.int32,
                                          device=dev)])[:hw]
        return SelectedWire(torch.full((), i, dtype=torch.int32, device=dev),
                            payload, enc.payload_len, header, enc.out_idx,
                            enc.out_payload, enc.n_outliers, enc.overflow,
                            enc.sign_words, enc.eb)

    def _view(self, wire: SelectedWire, i: int, n: int) -> Encoded:
        """The exact inverse of `_embed` for candidate i (static slicing:
        the chain id names the layout)."""
        pipe = self.chains[i]
        sizes = pipe.stage_sizes(n)
        headers, off = [], 0
        for st, sz in zip(pipe.stages, sizes[:-1]):
            hw = st.header_words(sz)
            headers.append(wire.header[off:off + hw])
            off += hw
        return Encoded(wire.payload[:sizes[-1]], wire.payload_len,
                       tuple(headers), wire.out_idx, wire.out_payload,
                       wire.n_outliers, wire.overflow, wire.sign_words,
                       wire.eb)

    def _chosen(self, wire: SelectedWire) -> int:
        """The transmitted chain id, read on the host (clamped into the
        set, as the reference's `lax.switch` clamps its index)."""
        return min(max(int(wire.chain_id), 0), len(self.chains) - 1)

    def encode(self, x, eb=None, *, device="cuda", kernels: bool | None = None,
               return_quantized: bool = False, pred_shape=None,
               verify: bool = False, integrity: bool = False):
        """Stats pass -> costs -> argmin (one host read) -> the chosen
        candidate's own `Pipeline.encode` on `device` (kernels=None: the
        card's kernels on the card, the plain path on the CPU) -> the
        uniform wire.  `return_quantized`/`verify` come from the chosen
        encode (every candidate shares the quantizer, and pred stages are
        bijections after it); `integrity=True` attaches the checksum over
        the uniform wire.  Returns wire | (wire, qt) | (wire, report) |
        (wire, qt, report), as `Pipeline.encode`."""
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev)
        flat = x.reshape(-1)
        n = flat.shape[0]
        if pred_shape is None:
            pred_shape = tuple(x.shape)
        use_k = kernel_device(dev) if kernels is None else kernels
        words, bins = self._stats_words(flat, eb, use_k)
        costs = self._costs(words, bins, n, pred_shape)
        del words, bins
        i = int(torch.argmin(costs))
        out = self.chains[i].encode(flat, eb, device=dev, kernels=kernels,
                                    return_quantized=return_quantized,
                                    pred_shape=pred_shape, verify=verify)
        out = (out,) if isinstance(out, Encoded) else out
        wire = self._embed(out[0], i, n)
        if integrity:
            wire = A.attach_checksum(wire)
        return (wire, *out[1:]) if len(out) > 1 else wire

    # --- decode -----------------------------------------------------------

    def decode(self, wire: SelectedWire, n: int | None = None, shape=None,
               dtype=None, *, device="cuda", kernels: bool | None = None,
               pred_shape=None, verify: bool = False) -> torch.Tensor:
        """Invert the chosen chain: read the transmitted chain id on the
        host once and decode its view with that candidate's own
        `Pipeline.decode` (its kernels on the card).  A transmitted
        `payload_len` outside the plane raises `WireIntegrityError`;
        `verify=True` re-checks the carried checksum first."""
        if n is None:
            if shape is None:
                raise ValueError("decode needs n or shape")
            n = int(np.prod(shape))
        if pred_shape is None and shape is not None:
            pred_shape = tuple(shape)
        dev = resolve_device(device)
        wire = _to_device(wire, dev)
        A.check_payload_len(wire.payload_len, wire.payload.shape[0],
                            what=f"SelectedWire[{self.spec()}]")
        if verify and not bool(A.verify_wire(wire)):
            raise A.WireIntegrityError(
                f"SelectedWire[{self.spec()}]: checksum mismatch on decode")
        i = self._chosen(wire)
        return self.chains[i].decode(self._view(wire, i, n), n=n,
                                     shape=shape, dtype=dtype, device=dev,
                                     kernels=kernels, pred_shape=pred_shape)

    def roundtrip(self, x, eb=None, **kw):
        return self.decode(self.encode(x, eb, **kw), shape=tuple(x.shape),
                           **kw)

    # --- wire accounting --------------------------------------------------

    def wire_bits(self, wire: SelectedWire, n: int) -> torch.Tensor:
        """Transmitted bits: the chosen chain's `Pipeline.wire_bits` plus
        the chain-id byte (and the 32-bit checksum when carried), a float32
        0-d tensor on the wire's device as the reference's switch gives
        it."""
        i = self._chosen(wire)
        bits = self.chains[i].wire_bits(self._view(wire, i, n), n)
        bits = (bits.to(torch.float32) if torch.is_tensor(bits)
                else _f32(bits, wire.payload))
        if wire.checksum is not None:
            bits = bits + _f32(32, bits)
        return bits + _f32(CHAIN_ID_BITS, bits)

    def wire_bytes(self, wire: SelectedWire, n: int) -> torch.Tensor:
        return self.wire_bits(wire, n) / 8.0

    def capacity_bytes(self, wire: SelectedWire) -> int:
        """Static upper bound: what a padded all-gather buffer holds."""
        b = (wire.payload.numel() + wire.header.numel()
             + wire.out_idx.numel() + wire.out_payload.numel()) * 4 + 8 + 4 + 1
        if wire.sign_words is not None:
            b += wire.sign_words.numel() * 4
        if wire.checksum is not None:
            b += 4
        return b


# ----------------------------------------------------------- KV selector --

@dataclasses.dataclass(frozen=True)
class KVSelector:
    """Per-page chain selection over page fragments of the two-domain
    grammar (optional pred stages + word stages; the quantizer is the
    per-page KV bound).  Every fragment must preserve the per-page word
    count so pages stay independently migratable; the chosen fragment's
    id is transmitted per page (1 byte) next to the page's length."""
    name: str
    chains: tuple                 # tuple[(pred tuple, word tuple), ...]
    bias: tuple = ()

    def __post_init__(self):
        if not self.chains:
            raise ValueError("a KV selector needs at least one fragment")
        if len(self.chains) > MAX_CHAINS:
            raise ValueError(f"at most {MAX_CHAINS} fragments fit the "
                             f"{CHAIN_ID_BITS}-bit chain-id header")
        for _, word in self.chains:
            _check_scoreable(word)
        if self.bias and len(self.bias) != len(self.chains):
            raise ValueError("bias must have one entry per fragment")

    def spec(self) -> str:
        return f"auto:{self.name}"

    def validate_page(self, wpp: int):
        for _, word in self.chains:
            sizes = word_stage_sizes(word, wpp)
            if not all(sz == wpp for sz in sizes):
                raise ValueError(
                    f"selector fragments must preserve the per-page word "
                    f"count so pages stay self-describing: {wpp}, {sizes}")

    def header_capacity_words(self, wpp: int) -> int:
        return max((sum(st.header_words(sz) for st, sz in
                        zip(word, word_stage_sizes(word, wpp)[:-1]))
                    for _, word in self.chains))

    def header_content_bits(self, i: int, wpp: int) -> int:
        """Transmitted header-content bits of fragment `i` for one page
        (the per-page accounting `transport.wire_bytes` sums)."""
        pred, word = self.chains[i]
        return (_static_hdr_bits(word, wpp) - (32 if word else 0)
                + sum(p.header_content_bits() for p in pred))

    # --- per-page select / encode / decode --------------------------------

    def page_costs(self, bins, bits: int, wpp: int,
                   pred_codes) -> torch.Tensor:
        """float32[R, n_chains] estimated transmitted bits of each page of
        bins int32[R, page * D]: the scoring rule over each page's
        word-plane statistics.  `pred_codes(pred)` gives a pred prefix's
        residual codes [R, page * D]."""
        stats, costs = {}, []
        need_ent = {_pred_key(p) for p, w in self.chains if _ends_in_ent(w)}
        for i, (pred, word) in enumerate(self.chains):
            key = _pred_key(pred)
            if key not in stats:
                codes = pred_codes(pred) if pred else bins
                stats[key] = page_stats(C.pack_word_rows(codes, bits), wpp,
                                        need_ent=key in need_ent)
            b = self.bias[i] if self.bias else 0.0
            costs.append(torch.broadcast_to(
                chain_cost(word, stats[key], wpp, b), (bins.shape[0],)))
        return torch.stack(costs, 1)

    def page_select(self, bins, bits: int, wpp: int,
                    pred_codes) -> torch.Tensor:
        """Chain id per page, int32[R]: the argmin of `page_costs` (the
        first on ties)."""
        return torch.argmin(self.page_costs(bins, bits, wpp, pred_codes),
                            1).to(torch.int32)

    def encode_pages(self, i: int, codes, bits: int, wpp: int,
                     kernels: bool = False):
        """Encode every page with fragment `i` from its pred codes int32[R,
        page * D] (the bins when the fragment has no pred stage) into the
        uniform (header [R, hw], payload [R, wpp], payload_len [R])."""
        _, word = self.chains[i]
        words = C.pack_word_rows(codes, bits)
        headers, payload, plen = encode_page_stages(word, words, wpp,
                                                    kernels)
        hw = self.header_capacity_words(wpp)
        rows = words.shape[0]
        flat_h = ([h.reshape(rows, -1) for h in headers]
                  + [words.new_zeros(rows, hw)])
        return torch.cat(flat_h, 1)[:, :hw], payload, plen

    def decode_pages(self, i: int, header, payload, bits: int, wpp: int,
                     kernels: bool = False):
        """Exact inverse of `encode_pages` up to the pred stages: the pred
        codes (or bins) int32[R, wpp * 32 / bits] of every page read as
        fragment `i`."""
        _, word = self.chains[i]
        headers, off = [], 0
        for st, sz in zip(word, word_stage_sizes(word, wpp)[:-1]):
            hw = st.header_words(sz)
            headers.append(header[:, off:off + hw])
            off += hw
        words = decode_page_stages(word, tuple(headers), payload, wpp,
                                   kernels)
        return C.unpack_word_rows(words, wpp * 32 // bits, bits)


# ---------------------------------------------------------- set registry --

def _split_fragment(frag: str, pack_bits: int):
    """'kvdelta|zero|narrow' -> (pred tuple, word tuple): leading
    registered pred names form the value chain (the page-fragment split
    `compression.kv` uses too)."""
    parts = [p.strip() for p in str(frag).split("|") if p.strip()]
    npred = 0
    while (npred < len(parts)
           and parts[npred].split(":")[0] in P.PRED_STAGES):
        npred += 1
    return (P.parse_pred_stages("|".join(parts[:npred])),
            parse_word_stages("|".join(parts[npred:]), pack_bits))


@functools.lru_cache(maxsize=None)
def get_selector(name: str):
    """The selector of a `SELECTOR_SETS` entry (cached: one instance per
    name): a `Selector` for a full-pipeline set, the per-page `KVSelector`
    for a KV page-fragment set (base None; the reference raises there and
    points to `get_kv_selector`)."""
    entry = get_selector_set(name)
    if entry["base"] is None:
        return get_kv_selector(name)
    base = parse_pipeline(entry["base"])
    chains = []
    for frag in entry["chains"]:
        pred, word = _split_fragment(frag, base.pack.bits)
        chains.append(Pipeline(base.quant, base.pack, word, pred))
    return Selector(name, tuple(chains), tuple(entry.get("bias", ())))


@functools.lru_cache(maxsize=None)
def get_kv_selector(name: str) -> KVSelector:
    """The per-page `KVSelector` of a base-less `SELECTOR_SETS` entry (KV
    pages pack at 8 bits/value)."""
    entry = get_selector_set(name)
    if entry["base"] is not None:
        raise KeyError(f"selector set {name!r} is a full-pipeline set; "
                       f"use get_selector")
    chains = tuple(_split_fragment(f, 8) for f in entry["chains"])
    return KVSelector(name, chains, tuple(entry.get("bias", ())))


def is_auto_spec(spec) -> bool:
    """True for the 'auto' / 'auto:SET' grammar extension."""
    return isinstance(spec, str) and (spec == "auto"
                                      or spec.startswith("auto:"))


def _set_name(spec: str, default: str) -> str:
    return spec.split(":", 1)[1] if ":" in spec else default


def parse_selector(spec: str, *, default: str = "grad-wire") -> Selector:
    """Resolve an 'auto' / 'auto:SET' spec to its `Selector`."""
    if not is_auto_spec(spec):
        raise ValueError(f"not an auto spec: {spec!r}")
    return get_selector(_set_name(spec, default))


def parse_kv_selector(spec: str, *,
                      default: str = "kv-page") -> KVSelector:
    """Resolve an 'auto' / 'auto:SET' spec to its `KVSelector`."""
    if not is_auto_spec(spec):
        raise ValueError(f"not an auto spec: {spec!r}")
    return get_kv_selector(_set_name(spec, default))


def parse_chain(spec):
    """The pipeline grammar extended by 'auto' / 'auto:SET' (a `Selector`);
    anything else parses as a plain `Pipeline`."""
    if isinstance(spec, (Selector, Pipeline)):
        return spec
    if is_auto_spec(spec):
        return parse_selector(spec)
    return parse_pipeline(spec)

"""Error-bounded KV-cache compression: the decode layout `QuantizedKV` that
the flash-decode attention kernel (`kernels/kv_attention.py`) streams, and
the packed wire `PackedKV` that cache transfers move.

Counterpart of `repro.compression.kv`, bit for bit.  Each (batch,
kv_head) cache is cut into pages of `page` tokens; each page is
ABS-quantized to int8 bins with its own bound eb = eb_rel * max|page|
(over the finite values).  Values the int8 grid cannot hold within eb
keep their exact float32 in a per-page side table of `cap` (flat in-page
index, value) slots, the first `cap` outliers in ascending order, -1 for
an empty slot; the encoder zeroes their bins, so adding the value back
restores it bit for bit.  A page with more than `cap` outliers is flagged
in `overflow`: the bound is surfaced, never silently dropped.

`PackedKV` is the one wire layout: each page's bins bit-packed into 32-bit
words (`codec.pack_words` at 8 bits), optionally run through a per-page
stage chain in the two-domain grammar: leading pred stages (`kvdelta`,
the previous-token delta on the page's (page, D) bin plane) and word
stages (`zero`, `narrow`, `shuffle`, `ent`), coded per page so that each
page is self-describing and migrates on its own; `stages="auto"` picks
the fragment per page (`core.select.KVSelector`) and sends its id.  The
reference vmaps its per-page coders; here every page of a plane is a row
of one batch: one pack, one chunk select (B6 on the card) over all pages'
chunks, and a cumsum along each row for the compaction (B7 expands on
decode).  `pack_kv(integrity=True)` carries the wire checksum
(`core.audit`); `unpack_kv(verify=True)` re-checks it.

Quantize, dequantize and the plain wire run on any device with torch ops
and no host sync; `unpack_kv` reads the transmitted lengths on the host
once to check them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import audit as A
from ..core import codec as C
from ..core import predict as P
from ..core import quantizer as q
from ..core import select as SEL
from ..core.bitops import pow2_floor
from ..core.config import QuantizerConfig
from ..core.pipeline import (decode_page_stages, encode_page_stages,
                             kernel_device, parse_word_stages,
                             word_stage_sizes)

PAGE = 128       # tokens per page (the reference's models/serve.py)
CAP = 8          # exact outlier slots per page


class QuantizedKV(NamedTuple):
    bins: torch.Tensor      # int8  [..., S, D]
    eb2: torch.Tensor       # f32   [..., n_pages]  pow2 bin width per page
    out_idx: torch.Tensor   # int32 [..., n_pages, cap]  flat idx in page, -1 empty
    out_val: torch.Tensor   # f32   [..., n_pages, cap]  exact values
    overflow: torch.Tensor  # bool  [..., n_pages]


def kv_quantizer_config(eb_rel: float = 2.0 ** -6) -> QuantizerConfig:
    # bin_bits=8 -> maxbin 127; eb_rel = 2^-6 keeps |bin| <= 64 by
    # construction so range outliers cannot occur for finite pages.
    return QuantizerConfig(mode="abs", error_bound=eb_rel, bin_bits=8)


def _pages(x: torch.Tensor, page: int) -> torch.Tensor:
    """x [..., S, D] as float32 [..., S/page, page*D]."""
    *lead, s, d = x.shape
    if s % page:
        raise ValueError(f"S={s} is not a multiple of page={page}")
    return x.to(torch.float32).reshape(*lead, s // page, page * d)


def _page_eb(xf: torch.Tensor, cfg: QuantizerConfig) -> torch.Tensor:
    """eb_rel * max|page| over the finite values, float32 [..., n_pages]."""
    zero = torch.zeros((), device=xf.device)
    finite = torch.where(torch.isfinite(xf), xf, zero)
    amax = finite.abs().amax(dim=-1)
    return q.full_scalar(cfg.error_bound, torch.float32, xf.device) * amax


def _first_outliers(outlier: torch.Tensor, vals: torch.Tensor, cap: int):
    """Per row of outlier [..., m]: the first `cap` True indices in
    ascending order, -1 filled, and vals at them (0.0 in empty slots) -
    `jnp.nonzero(size=cap, fill_value=-1)` row by row.  The rank of each
    outlier is a cumsum; `searchsorted` finds where the rank reaches
    1..cap.  Shapes stay static, so there is no host sync."""
    m = outlier.shape[-1]
    rank = torch.cumsum(outlier, dim=-1, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=outlier.device)
    want = want.expand(*rank.shape[:-1], cap).contiguous()
    pos = torch.searchsorted(rank, want)
    found = pos < m
    idx = torch.where(found, pos, torch.full_like(pos, -1)).to(torch.int32)
    safe = torch.where(found, pos, torch.zeros_like(pos))
    val = torch.gather(vals, -1, safe)
    return idx, torch.where(found, val, torch.zeros((), device=vals.device))


def quantize_kv(x: torch.Tensor, cfg: QuantizerConfig, *, page: int = PAGE,
                cap: int = CAP) -> QuantizedKV:
    """x: [..., S, D] float32 (or any float type, taken to float32);
    S % page == 0."""
    *lead, s, d = x.shape
    xf = _pages(x, page)
    eb = _page_eb(xf, cfg)                                 # per-page bound
    qt = q.quantize_abs(xf, cfg, eb=eb[..., None])
    out_idx, out_val = _first_outliers(qt.outlier, xf, cap)
    n_out = qt.outlier.sum(dim=-1)
    bins = qt.bins.to(torch.int8).reshape(*lead, s, d)
    _, eb2, _ = _eb2(eb, cfg)
    return QuantizedKV(bins, eb2, out_idx, out_val, n_out > cap)


def _eb2(eb: torch.Tensor, cfg: QuantizerConfig):
    """(eb floored, eb2 = pow2_floor(2 eb), 1 / eb2), float32: the step the
    quantizer takes for a traced eb."""
    floor = q.full_scalar(cfg.eb_floor, torch.float32, eb.device)
    eb_ = torch.maximum(eb.to(torch.float32), floor)       # NaN propagates
    eb2 = pow2_floor(q.full_scalar(2.0, torch.float32, eb.device) * eb_)
    return eb_, eb2, 1.0 / eb2


def dequantize_kv(qkv: QuantizedKV, *, page: int = PAGE,
                  dtype=torch.float32) -> torch.Tensor:
    """The plain decode: bins * eb2 per page, then each outlier slot's
    exact value added at its index (the attention kernel fuses this)."""
    *lead, s, d = qkv.bins.shape
    n_pages = s // page
    recon = (qkv.bins.to(dtype).reshape(*lead, n_pages, page * d)
             * qkv.eb2[..., None].to(dtype))
    # one spare column takes the empty (-1) slots, as mode="drop" does
    buf = torch.cat([recon, torch.zeros_like(recon[..., :1])], dim=-1)
    idx = qkv.out_idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < page * d), idx,
                      torch.full_like(idx, page * d))
    # outlier bins were zeroed by the encoder -> add == exact restore
    buf.scatter_add_(-1, idx, qkv.out_val.to(dtype))
    return buf[..., :page * d].reshape(*lead, s, d)


def kv_error_bound_holds(x: torch.Tensor, qkv: QuantizedKV,
                         cfg: QuantizerConfig, *,
                         page: int = PAGE) -> torch.Tensor:
    """Test helper: a 0-d bool, True iff every non-overflow page meets its
    bound."""
    xf = _pages(x, page)
    yf = _pages(dequantize_kv(qkv, page=page), page)
    eb = _page_eb(xf, cfg)
    err = (xf - yf).abs().amax(dim=-1)
    return ((err <= eb) | qkv.overflow).all()


# ------------------------------------------------------------ the wire ---

def _word_stages(stages) -> tuple:
    """Resolve a word-stage chain given as a spec fragment ("narrow",
    "shuffle|narrow", "zero") or a tuple of stage objects.  KV pages pack
    at 8 bits/value, so bare `shuffle` folds at width 8."""
    return parse_word_stages(stages, 8)


def _page_stages(stages):
    """Split a per-page stage chain into (pred, word) tuples: leading
    tokens naming registered pred stages ("kvdelta|zero|narrow") form the
    value-domain chain; the rest are word stages.  Tuples split on the
    stage contract (anything with `encode_bins` leads)."""
    if isinstance(stages, tuple):
        pred = []
        while stages and hasattr(stages[0], "encode_bins"):
            pred.append(stages[0])
            stages = stages[1:]
        return tuple(pred), _word_stages(stages)
    parts = [p.strip() for p in str(stages).split("|") if p.strip()]
    npred = 0
    while (npred < len(parts)
           and parts[npred].split(":")[0] in P.PRED_STAGES):
        npred += 1
    return (P.parse_pred_stages("|".join(parts[:npred])),
            _word_stages("|".join(parts[npred:])))


_PLANES = ("payload", "payload_len", "headers", "eb2", "out_idx",
           "out_val", "overflow", "chain_id", "checksum")


class PackedKV:
    """The wire form of QuantizedKV: per-page packed words, run through a
    (possibly empty, static) page chain.  Every plane is what a cache
    transfer moves; `payload` is padded to the per-page capacity when a
    stage is length-variable, and the transmitted prefix of each page is
    `payload_len`.  Word planes are int32 tensors holding uint32 bits.

    The planes are `_fields` (iteration yields them in that order, as a
    NamedTuple's do, and `_replace` swaps them); `stages`, `pred` and
    `select` are static and ride along unchanged through `map_planes`."""

    _fields = _PLANES

    def __init__(self, payload, payload_len, headers, eb2, out_idx,
                 out_val, overflow, chain_id=None, checksum=None, *,
                 stages=(), pred=(), select=None):
        self.payload = payload        # int32 [..., n_pages, cap_words]
        self.payload_len = payload_len  # int32 [..., n_pages]
        self.headers = tuple(headers)  # tuple of int32 [..., n_pages, hw]
        self.eb2 = eb2                # f32   [..., n_pages]
        self.out_idx = out_idx        # int32 [..., n_pages, cap]
        self.out_val = out_val        # f32   [..., n_pages, cap]
        self.overflow = overflow      # bool  [..., n_pages]
        self.chain_id = chain_id      # int32 [..., n_pages] when selected
        self.checksum = checksum      # int32 0-d (integrity=True)
        self.stages = stages          # word-domain chain (per page)
        self.pred = pred              # value-domain chain (per page)
        self.select = select          # KVSelector for the per-page choice

    def __iter__(self):
        return iter([getattr(self, f) for f in self._fields])

    def _statics(self) -> dict:
        return dict(stages=self.stages, pred=self.pred, select=self.select)

    def _replace(self, **planes) -> "PackedKV":
        bad = set(planes) - set(self._fields)
        if bad:
            raise ValueError(f"PackedKV has no plane {sorted(bad)}")
        cur = {f: getattr(self, f) for f in self._fields}
        cur.update(planes)
        return PackedKV(**cur, **self._statics())

    def map_planes(self, fn) -> "PackedKV":
        """fn over every plane (each header plane on its own; None stays
        None), the statics kept."""
        def one(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return tuple(fn(h) for h in v)
            return fn(v)
        return PackedKV(*(one(getattr(self, f)) for f in self._fields),
                        **self._statics())

    def with_checksum(self, checksum) -> "PackedKV":
        """The same wire with the integrity digest carried (the covered
        planes are untouched)."""
        return self._replace(checksum=checksum)

    # --- accounting --------------------------------------------------------
    def nbytes(self) -> int:
        """Static stored footprint: for a stage-free chain this is the
        wire; with stages it is the padded capacity a gather buffer
        holds."""
        b = (self.payload.numel() + self.eb2.numel() + self.out_idx.numel()
             + self.out_val.numel()) * 4 + self.overflow.numel()
        b += sum(h.numel() for h in self.headers) * 4
        if self.stages:
            b += self.payload_len.numel() * 4
        if self.select is not None:
            b += self.payload_len.numel() * 4 + self.chain_id.numel() * 4
        if self.checksum is not None:
            b += 4
        return b

    def wire_nbytes(self):
        """Measured transmitted footprint, through the single accounting
        accessor `core.transport.wire_bytes`."""
        from ..core.transport import wire_bytes
        return wire_bytes(self)


def _use_kernels(t: torch.Tensor) -> bool:
    """The chunk coder's kernels (B6/B7) for a CUDA (or meta) tensor, the
    plain coder for a CPU one: the same wire."""
    return kernel_device(t.device)


def _pred_rows(pred, bins, page: int, d: int, encode: bool):
    """The pred chain over every page: bins (or codes, decoding) int32[R,
    page * d], each row one page's (page, d) plane, predicted within the
    page only (the reference vmaps the chain per page).  `delta` reads a
    page as one flat stream; the plane predictors batch their leading
    axis; any other registered stage runs page by page."""
    rows = bins.shape[0]
    cur = bins
    for st in (pred if encode else tuple(reversed(pred))):
        if isinstance(st, P.DeltaStage):
            if encode:
                b = cur.to(torch.int64)
                cur = P._fold(b - P._shift(b, 1), 8)
            else:
                cur = P._sign_extend(torch.cumsum(P._unfold(cur, 8), 1), 8)
            continue
        fn = st.encode_bins if encode else st.decode_bins
        if isinstance(st, (P.LorenzoStage, P.KVDeltaStage)):
            cur = fn(cur.reshape(-1), (rows, page, d), 8).reshape(rows, -1)
        else:
            cur = torch.stack([fn(r, (page, d), 8) for r in cur])
    return cur


def pack_kv(qkv: QuantizedKV, *, page: int = PAGE, stages=(),
            integrity: bool = False) -> PackedKV:
    """Bit-pack a quantized cache for the wire, optionally through a
    per-page stage chain ("zero", "zero|narrow", "kvdelta|zero|narrow",
    ...; "auto" / "auto:SET" selects per page).  Leading pred stages
    transform each page's (page, D) bin plane before packing, token 0
    unpredicted, so a page never references another page.  Needs page * D
    % 512 == 0 (whole 32-bit tiles per page), and each word stage must
    keep the per-page word count (whole chunks per page: D % 16 == 0 at
    page 128 for zero/narrow).  The chunk select kernel (B6) runs on the
    card, the plain coder on the CPU; the wire is the same.
    `integrity=True` attaches the wire checksum."""
    if SEL.is_auto_spec(stages) or isinstance(stages, SEL.KVSelector):
        sel = (stages if isinstance(stages, SEL.KVSelector)
               else SEL.parse_kv_selector(stages))
        p = _pack_kv_select(qkv, sel, page=page)
        return A.attach_checksum(p) if integrity else p
    pred, st = _page_stages(stages)
    *lead, s, d = qkv.bins.shape
    n_pages = s // page
    per = page * d
    if per % (4 * C.PACK_LANES):
        raise ValueError(f"page * D = {per} is not a whole number of "
                         f"{4 * C.PACK_LANES}-value tiles")
    wpp = per // 4
    flat = qkv.bins.reshape(-1, per).to(torch.int32)
    if pred:
        flat = _pred_rows(pred, flat, page, d, encode=True)
    words = C.pack_word_rows(flat, 8)
    if not st:
        plen = torch.full((*lead, n_pages), wpp, dtype=torch.int32,
                          device=words.device)
        p = PackedKV(words.reshape(*lead, n_pages, wpp), plen, (),
                     qkv.eb2, qkv.out_idx, qkv.out_val, qkv.overflow,
                     pred=pred)
        return A.attach_checksum(p) if integrity else p
    sizes = word_stage_sizes(st, wpp)
    if not all(sz == wpp for sz in sizes):
        raise ValueError(f"the stage chain must keep the per-page word "
                         f"count so pages stay self-describing: page "
                         f"{page}, D {d}, sizes {sizes}")
    headers, payload, plen = encode_page_stages(st, words, wpp,
                                                _use_kernels(words))
    headers = tuple(h.reshape(*lead, n_pages, h.shape[-1]) for h in headers)
    p = PackedKV(payload.reshape(*lead, n_pages, -1),
                 plen.reshape(*lead, n_pages), headers, qkv.eb2,
                 qkv.out_idx, qkv.out_val, qkv.overflow, stages=st,
                 pred=pred)
    return A.attach_checksum(p) if integrity else p


def _pack_kv_select(qkv: QuantizedKV, sel, *, page: int = PAGE) -> PackedKV:
    """Per-page adaptive packing: score each page's bin plane, encode
    every page with every fragment, and keep the chosen fragment's
    (header, payload, length) per page with its chain id (the reference's
    vmapped `lax.switch` computes the same selection)."""
    *lead, s, d = qkv.bins.shape
    n_pages = s // page
    per = page * d
    if per % (4 * C.PACK_LANES):
        raise ValueError(f"page * D = {per} is not a whole number of "
                         f"{4 * C.PACK_LANES}-value tiles")
    wpp = per // 4
    sel.validate_page(wpp)
    flat = qkv.bins.reshape(-1, per).to(torch.int32)
    use_k = _use_kernels(flat)
    codes = {}

    def pred_codes(pred):
        key = SEL._pred_key(pred)
        if key not in codes:
            codes[key] = _pred_rows(pred, flat, page, d, encode=True)
        return codes[key]

    cid = sel.page_select(flat, 8, wpp, pred_codes)
    hdr = pay = plen = None
    for i, (pred, _) in enumerate(sel.chains):
        h, w, n = sel.encode_pages(i, pred_codes(pred) if pred else flat, 8,
                                   wpp, use_k)
        if hdr is None:
            hdr, pay, plen = h, w, n
            continue
        pick = cid == i
        hdr = torch.where(pick[:, None], h, hdr)
        pay = torch.where(pick[:, None], w, pay)
        plen = torch.where(pick, n, plen)
    return PackedKV(pay.reshape(*lead, n_pages, wpp),
                    plen.reshape(*lead, n_pages),
                    (hdr.reshape(*lead, n_pages, hdr.shape[-1]),),
                    qkv.eb2, qkv.out_idx, qkv.out_val, qkv.overflow,
                    cid.reshape(*lead, n_pages), select=sel)


def unpack_kv(p: PackedKV, *, page: int = PAGE,
              verify: bool = False) -> QuantizedKV:
    """Inverse of pack_kv (bit-exact for every chain): the int8 decode
    layout.  Selected wires decode per page on the transmitted chain id.
    Transmitted lengths outside [0, words per page] raise
    `audit.WireIntegrityError` (one host read); `verify=True` re-checks
    the carried checksum first.  The chunk expand kernel (B7) runs on the
    card."""
    *lead, n_pages, wpp = p.payload.shape
    A.check_payload_len(p.payload_len, wpp, what="PackedKV")
    if verify and not bool(A.verify_wire(p)):
        raise A.WireIntegrityError("PackedKV: checksum mismatch on unpack")
    per = wpp * 4
    d = per // page
    pay = p.payload.reshape(-1, wpp)
    use_k = _use_kernels(pay)
    if p.select is not None:
        sel = p.select
        hdr = p.headers[0].reshape(pay.shape[0], -1)
        cid = p.chain_id.reshape(-1).clamp(0, len(sel.chains) - 1)
        bins = None
        for i, (pred, _) in enumerate(sel.chains):
            b = sel.decode_pages(i, hdr, pay, 8, wpp, use_k)
            if pred:
                b = _pred_rows(pred, b, page, d, encode=False)
            bins = b if bins is None else torch.where(
                (cid == i)[:, None], b, bins)
    else:
        words = pay
        if p.stages:
            hdrs = tuple(h.reshape(pay.shape[0], h.shape[-1])
                         for h in p.headers)
            words = decode_page_stages(p.stages, hdrs, pay, wpp, use_k)
        bins = C.unpack_word_rows(words, per, 8)
        if p.pred:
            bins = _pred_rows(p.pred, bins, page, d, encode=False)
    bins = bins.to(torch.int8).reshape(*lead, n_pages * page, d)
    return QuantizedKV(bins, p.eb2, p.out_idx, p.out_val, p.overflow)


def slice_pages(qkv: QuantizedKV, start: int, count: int = 1, *,
                page: int = PAGE) -> QuantizedKV:
    """Whole-page slice [start, start + count) of a quantized cache (the
    unit of streaming migration).  Every page is self-describing, so a
    slice packs to a standalone wire and lands bit-exactly with
    `paste_pages`."""
    s0 = start * page
    return QuantizedKV(qkv.bins[..., s0:s0 + count * page, :],
                       qkv.eb2[..., start:start + count],
                       qkv.out_idx[..., start:start + count, :],
                       qkv.out_val[..., start:start + count, :],
                       qkv.overflow[..., start:start + count])


def paste_pages(dst: QuantizedKV, src: QuantizedKV, start: int, *,
                page: int = PAGE) -> QuantizedKV:
    """Inverse of `slice_pages`: a copy of dst with src's pages written at
    page index `start`."""
    s0 = start * page
    n = src.eb2.shape[-1]
    if src.bins.shape[-2] != n * page:
        raise ValueError(f"src holds {src.bins.shape[-2]} tokens, not "
                         f"{n} pages of {page}")

    def put(a, b, lo, hi, trailing: int):
        out = a.clone()
        idx = (Ellipsis, slice(lo, hi)) + (slice(None),) * trailing
        out[idx] = b
        return out

    return QuantizedKV(put(dst.bins, src.bins, s0, s0 + n * page, 1),
                       put(dst.eb2, src.eb2, start, start + n, 0),
                       put(dst.out_idx, src.out_idx, start, start + n, 1),
                       put(dst.out_val, src.out_val, start, start + n, 1),
                       put(dst.overflow, src.overflow, start, start + n, 0))


def gather_kv_packed(p: PackedKV, axis) -> PackedKV:
    """All-gather a packed cache over an axis (`core.axis`): every plane
    grows a leading axis of the axis size (`Transport.all_gather`)."""
    from ..core.transport import TRANSPORT
    return TRANSPORT.all_gather(p, axis)


def kv_wire_bytes(shape, *, page: int = PAGE, cap: int = CAP) -> int:
    """Analytic wire footprint of a stage-free pack_kv for a cache of
    `shape` [..., S, D]; equals PackedKV.nbytes() exactly."""
    *lead, s, d = shape
    n_lead = math.prod(lead) if lead else 1
    n_pages = s // page
    return n_lead * n_pages * ((page * d // 4) * 4 + 4 + cap * 8 + 1)

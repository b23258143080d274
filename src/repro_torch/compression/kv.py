"""Error-bounded KV-cache quantization, the dense half: the decode layout
`QuantizedKV` that the flash-decode attention kernel
(`kernels/kv_attention.py`) streams.

Counterpart of `repro.compression.kv` (`QuantizedKV`,
`kv_quantizer_config`, `quantize_kv`, `_eb2`, `dequantize_kv`,
`kv_error_bound_holds`), bit for bit.  Each (batch, kv_head) cache is cut
into pages of `page` tokens; each page is ABS-quantized to int8 bins with
its own bound eb = eb_rel * max|page| (over the finite values).  Values the
int8 grid cannot hold within eb keep their exact float32 in a per-page
side table of `cap` (flat in-page index, value) slots, the first `cap`
outliers in ascending order, -1 for an empty slot; the encoder zeroes
their bins, so adding the value back restores it bit for bit.  A page
with more than `cap` outliers is flagged in `overflow`: the bound is
surfaced, never silently dropped.

The packed wire (`PackedKV`, `pack_kv`/`unpack_kv`), its stage chains,
the selector and the page transport are not ported yet (ROADMAP A12).
Every function runs on any device with torch ops and no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import quantizer as q
from ..core.bitops import pow2_floor
from ..core.config import QuantizerConfig

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

"""Decode-step (serving) paths over a KV cache: raw bfloat16, or quantized
with a guaranteed error bound (counterpart of `repro.models.serve`, the
dense, vlm, MoE and hybrid families).  A MoE layer's FFN is the
reference's `moe_ffn_local` over the step's B tokens (capacity max(1,
int(K B / E)) slots per expert, so an aligned batch can drop (token, k)
pairs, as the reference's step does).

Quantized cache layout per layer (`compression.kv`):
    bins   int8 [L, B, G, S, hd]       4x smaller than bf16 K+V
    eb2    f32  [L, B, G, nP]          per-page pow2 step
    out_idx/out_val [L, B, G, nP, cap] exact outliers (bit-exact restore)
    hot    bf16 [L, B, page, G, hd]    write buffer of the open page
When the open page fills ((pos + 1) % page == 0) it is quantized within
the step.  `pos` is a host int (the reference's scalar), so the page close
is a host branch and needs no device sync.

Attention over the quantized cache has two parts, merged by their softmax
states as the reference merges them: the closed pages through the
flash-decode kernel over the int8 pages (`kernels.kv_attention`, B12, with
its (m, l) output; its plain version on the CPU), and the open hot page
through `_partial_attn` in torch ops.  The reference dequantizes the
history to bfloat16 and attends to it with XLA; every bins * eb2 product
of a normal page is exact in bfloat16 (|bin| <= 127, eb2 a power of two)
and the outliers are bfloat16 values, so B12 attends to the same values.
Where the history is empty (pos < page) the kernel is not called and the
merge takes the hot part alone, with the reference's arithmetic.

The hybrid (jamba) decodes over a raw cache of its periods' attention
layers and each Mamba block's conv tail and SSM state (`_serve_hybrid`,
the reference's `_serve_hybrid`); it has no QuantCache path, engine or
`stream_prefill`, as the reference has none.

Caches are updated in place: `serve_step` returns the cache it was given
(the reference returns a new one).

On a rank of the reference's layout, the cache is a `RankCache`: the
rank's block under `launch.mesh.cache_layouts` of a cache of a recorded
global batch and sequence (`make_quant_cache` / `make_raw_cache` with the
rank's mesh): the data axes on the batch, "model" on the sequence of
`bins` and of raw K and V, and on the largest other dim of `eb2`, the
outlier planes and the hot page (the page axis, or the KV heads where a
short cache has fewer pages than heads; the hot page's token slots).
The step over it (`_serve_tp`), with the rank's parameter blocks
(`transformer.rank_layout`) or whole weights:

  * q from the rank's `wq` columns and k, v from its `wkv` block,
    gathered over "model" in one collective (q of every head: the
    history is split by sequence, not by head; `transformer._project`);
  * the new token's K and V go to the rank that owns their slot (raw: its
    sequence block; quantized: its hot-page slots);
  * each rank attends to its own tokens: B12 over its closed pages with
    lengths local to its block, and the hot page's slots it holds (raw:
    `layers.decode_attention` over its block), each part an (o, l, m);
    the ranks' parts are merged over "model" by B12's own merge rule
    (`merge_parts`: pmax of m, then one psum of the rescaled o and l).  A
    rank with no token of a part does not compute it: it adds no weight;
  * a page that closes is gathered over "model" (the hot page's slots),
    so each (row, KV head, page) gets the eb2 and outliers one rank gives
    it, and is quantized by the ranks that hold a part of its planes
    (the page's owner; every rank where a plane is split by KV head);
  * `wo` and the FFN's `w2` row-parallel (psum over "model"), the logits
    the rank's "vocab" block.

Prefill -> decode hand-off: `pack_cache` turns a QuantCache into the
`PackedCache` wire (closed pages as per-page `PackedKV`, the open hot page
raw), `transfer_cache` moves it between ranks of a `core.axis` with
`Transport.send_pages`, and `unpack_cache` restores the decode layout bit
for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree as T
from ..compression import kv as KVC
from ..configs.base import ArchConfig
from ..core.config import QuantizerConfig
from ..core.pipeline import resolve_device
from ..core.transport import TRANSPORT, Transport
from ..kernels import kv_attention as KA
from ..launch import mesh as MESH
from . import layers as L
from . import transformer as TT
from .moe import moe_ffn_rows
from . import mamba as M
from .transformer import DTYPE, _ffn_block, _index, _project, hybrid_blocks

PAGE = KVC.PAGE
CAP = KVC.CAP


class RawCache(NamedTuple):
    k: torch.Tensor            # [L, B, S, G, hd]
    v: torch.Tensor


class QuantCache(NamedTuple):
    k: KVC.QuantizedKV         # bins [L, B, G, S, hd], ...
    v: KVC.QuantizedKV
    hot_k: torch.Tensor        # [L, B, page, G, hd]
    hot_v: torch.Tensor


class PackedCache(NamedTuple):
    """The prefill -> decode transfer wire of a QuantCache: closed pages as
    per-page `PackedKV` wires, the open hot page raw (it is not quantized
    yet).  `core.transport.wire_bytes` accounts it field by field."""
    k: KVC.PackedKV
    v: KVC.PackedKV
    hot_k: torch.Tensor
    hot_v: torch.Tensor


def _raw_tree(cfg: ArchConfig, batch: int, seq: int, l_: int, new):
    shape = (l_, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    k = new(shape, DTYPE, 0)
    return RawCache(k, new(shape, DTYPE, 0))


def _quant_tree(cfg: ArchConfig, batch: int, seq: int, l_: int, new):
    g, hd = cfg.n_kv_heads, cfg.head_dim
    np_ = seq // PAGE

    def one():
        bins = new((l_, batch, g, seq, hd), torch.int8, 0)
        eb2 = new((l_, batch, g, np_), torch.float32, 0)
        out_idx = new((l_, batch, g, np_, CAP), torch.int32, -1)
        out_val = new((l_, batch, g, np_, CAP), torch.float32, 0)
        overflow = new((l_, batch, g, np_), torch.bool, False)
        return KVC.QuantizedKV(bins, eb2, out_idx, out_val, overflow)

    k = one()
    v = one()
    hot = (l_, batch, PAGE, g, hd)
    hot_k = new(hot, DTYPE, 0)
    return QuantCache(k, v, hot_k, new(hot, DTYPE, 0))


class _Leaf:
    """A leaf's shape alone: a cache tree to lay out makes no tensor (a
    meta tensor made inside a dry-run's count would count as held)."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


def _shapes(shape, dt, fill) -> _Leaf:
    return _Leaf(shape)


class RankCache(NamedTuple):
    """A rank's block of a decode cache on the reference's layout: `block`
    (a QuantCache or RawCache) holds the rank's blocks under
    `launch.mesh.cache_layouts` of the cache of `batch` rows (the global
    batch) over `seq` tokens.  `make_quant_cache` / `make_raw_cache` with
    a mesh return one; `cache_plan` holds the block's shapes to the
    layout of (batch, seq)."""
    block: object
    batch: int
    seq: int


def _make_cache(tree_fn, cfg, batch, seq, n_layers, device, mesh):
    """tree_fn's cache on `device`: whole, or with `mesh` (a rank's) the
    rank's `RankCache` under `launch.mesh.cache_layouts` (leaves made in
    the tree's order, so the layouts are taken in that order too)."""
    dev = resolve_device(device)
    l_ = cfg.n_layers if n_layers is None else n_layers
    if mesh is None:
        return tree_fn(cfg, batch, seq, l_, lambda shape, dt, fill: torch.full(
            shape, fill, dtype=dt, device=dev))
    desc = MESH.Mesh(mesh.shape, mesh.axis_names)
    glob = tree_fn(cfg, batch, seq, l_, _shapes)
    lays = iter(T.leaves(MESH.cache_layouts(desc, glob, batch)))
    return RankCache(tree_fn(cfg, batch, seq, l_, lambda shape, dt, fill:
                             torch.full(MESH.block_shape(shape, next(lays)),
                                        fill, dtype=dt, device=dev)),
                     batch, seq)


def make_raw_cache(cfg: ArchConfig, batch: int, seq: int, n_layers=None, *,
                   device="cuda", mesh=None) -> RawCache:
    """A zero raw cache of `batch` rows over `seq` tokens, k and v [L, B,
    S, G, hd]; with `mesh` (a rank's) the rank's `RankCache` of it."""
    return _make_cache(_raw_tree, cfg, batch, seq, n_layers, device, mesh)


def make_quant_cache(cfg: ArchConfig, batch: int, seq: int, n_layers=None,
                     *, device="cuda", mesh=None) -> QuantCache:
    """An empty quantized cache (layout in the module docstring); with
    `mesh` (a rank's) the rank's `RankCache` of it under
    `cache_layouts`."""
    return _make_cache(_quant_tree, cfg, batch, seq, n_layers, device, mesh)


def pack_cache(cache: QuantCache, *, stages=(),
               integrity: bool = False) -> PackedCache:
    """QuantCache -> transfer wire.  `stages` is a per-page chain in the
    two-domain grammar ("zero", "zero|narrow", "kvdelta|zero|narrow", a
    `configs.registry.KV_PAGE_CHAINS` value), or "auto" / "auto:SET" for a
    per-page choice; `integrity=True` gives both planes their checksum."""
    return PackedCache(
        KVC.pack_kv(cache.k, page=PAGE, stages=stages, integrity=integrity),
        KVC.pack_kv(cache.v, page=PAGE, stages=stages, integrity=integrity),
        cache.hot_k, cache.hot_v)


def unpack_cache(wire: PackedCache, *, verify: bool = False) -> QuantCache:
    """Exact inverse of pack_cache: the int8 decode layout (verify=True
    re-checks each plane's checksum)."""
    return QuantCache(KVC.unpack_kv(wire.k, page=PAGE, verify=verify),
                      KVC.unpack_kv(wire.v, page=PAGE, verify=verify),
                      wire.hot_k, wire.hot_v)


def transfer_cache(cache: QuantCache, src: int, dst: int, axis, *,
                   stages=(), transport: Transport | None = None):
    """Move a serving cache from rank `src` (prefill) to rank `dst`
    (decode) of `axis` (every rank calls it with a cache of the same
    shape).  Pages cross only as PackedKV wires through
    `Transport.send_pages`; rank `dst` returns the bit-identical
    QuantCache, the other ranks zeros (ppermute semantics)."""
    tp = TRANSPORT if transport is None else transport
    return unpack_cache(tp.send_pages(pack_cache(cache, stages=stages),
                                      src, dst, axis))


def _check_family(cfg: ArchConfig) -> None:
    """The QuantCache path (`serve_step` over a QuantCache,
    `serve_step_rows`), the engine and `stream_prefill` serve the dense,
    vlm and MoE decoder stacks.  encdec and ssm decode through their own
    `serve_step` (by `ModelBundle.serve_step`), the hybrid through
    `serve_step` over `ModelBundle.make_cache`'s raw cache and states; the
    reference's engine does not run them either (it asserts the hybrid
    away, engine.py:125; its prefill reads params["layers"])."""
    if cfg.family in ("encdec", "ssm"):
        raise NotImplementedError(
            f"the {cfg.family} family has no QuantCache serve path: the "
            "reference's DecodeEngine fails on it too (its prefill reads "
            "params['layers']); decode it with ModelBundle.serve_step")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "the hybrid family has no QuantCache serve path: the "
            "reference's DecodeEngine refuses it (engine.py:125, \"engine "
            "serves the QuantCache path\"); decode it with serve_step over "
            "ModelBundle.make_cache's (RawCache, (conv tails, ssm states))")


def _project_token(cfg: ArchConfig, p: dict, x: torch.Tensor, pos):
    """x: [B, 1, D] -> q [B, 1, H, hd], k/v [B, 1, G, hd], rope at pos (a
    host int, or int32 positions [B, 1], one a row)."""
    positions = pos if torch.is_tensor(pos) else torch.full(
        (1, 1), pos, dtype=torch.int32, device=x.device)
    return _project(cfg, p, x, positions)


def _attn_decode_raw(cfg: ArchConfig, p: dict, x, kc, vc, pos: int):
    """kc/vc: [B, S, G, hd], one layer's cache, written in place."""
    b = x.shape[0]
    q, k, v = _project_token(cfg, p, x, pos)
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    o = L.decode_attention(q, kc, vc, lengths)
    return x + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]


def _quantize_page(qkv: KVC.QuantizedKV, hot: torch.Tensor, page_idx: int,
                   kv_cfg: QuantizerConfig) -> KVC.QuantizedKV:
    """Quantize the filled hot page [B, page, G, hd] into history page
    `page_idx` of qkv (written in place; qkv is returned)."""
    b, page, g, hd = hot.shape
    x = hot.permute(0, 2, 1, 3).to(torch.float32)          # [B, G, P, hd]
    q = KVC.quantize_kv(x, kv_cfg, page=page, cap=CAP)
    qkv.bins[:, :, page_idx * page:(page_idx + 1) * page] = q.bins
    qkv.eb2[:, :, page_idx] = q.eb2[..., 0]
    qkv.out_idx[:, :, page_idx] = q.out_idx[:, :, 0]
    qkv.out_val[:, :, page_idx] = q.out_val[:, :, 0]
    qkv.overflow[:, :, page_idx] = q.overflow[..., 0]
    return qkv


def _fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` in one fixed order, by elementwise adds (zeros up
    to a power of two, then halves added pairwise), so that a row's bits
    follow neither the other rows nor a library kernel's choice by the
    shapes (a batched product's does on the card)."""
    n = x.shape[dim]
    if n & (n - 1):
        pad = list(x.shape)
        pad[dim] = (1 << n.bit_length()) - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def _partial_attn(q, kc, vc, lengths):
    """Un-normalized attention piece for a two-part merge.  q [B, 1, H, hd];
    kc/vc [B, T, G, hd]; returns (acc / l [B, H, hd], l [B, H], m [B, H]).
    Every sum is a `_fold_sum`, so each row is computed as it would be
    alone."""
    b, _, h, hd = q.shape
    t, g = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, g, h // g, 1, hd).to(torch.float32)
    kg = kc.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # [B,G,1,T,hd]
    vg = vc.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    scores = _fold_sum(qg * kg, -1) / (hd ** 0.5)         # [B, G, gs, T]
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), L.NEG_BIG, device=q.device))
    m = scores.amax(-1)                                   # [B, G, gs]
    p = torch.exp(scores - m[..., None])
    l_ = _fold_sum(p, -1)
    acc = _fold_sum(p[..., None] * vg, -2)                # [B, G, gs, hd]
    o = acc / torch.clamp(l_, min=1e-30)[..., None]
    return o.reshape(b, h, hd), l_.reshape(b, h), m.reshape(b, h)


def _attn_history(cfg: ArchConfig, q, qk, qv, page_start,
                  pages_per_split=None):
    """The closed pages' part, (o [B, H, hd], l [B, H], m [B, H]), through
    B12 with lengths = page_start (a host int, or int32 [B], one a row;
    the kernel on the card, its plain version on the CPU)."""
    b, _, h, hd = q.shape
    g = cfg.n_kv_heads
    qg = q.to(torch.float32).reshape(b, g, h // g, hd)
    lengths = page_start if torch.is_tensor(page_start) else torch.full(
        (b,), page_start, dtype=torch.int32, device=q.device)
    o, m, l_ = KA.kv_decode_attention(qg, qk, qv, lengths, page=PAGE,
                                      cap=CAP, return_stats=True,
                                      pages_per_split=pages_per_split)
    return o.reshape(b, h, hd), l_.reshape(b, h), m.reshape(b, h)


def _attn_decode_quant(cfg: ArchConfig, p: dict, x, qk, qv, hot_k, hot_v,
                       pos: int, kv_cfg: QuantizerConfig):
    """One layer's attention over the quantized cache (written in place):
    the token goes into the hot page, the closed pages (B12) and the hot
    page are merged, and the page is quantized when it fills."""
    b = x.shape[0]
    q, k, v = _project_token(cfg, p, x, pos)
    in_page = pos % PAGE
    hot_k[:, in_page] = k[:, 0].to(hot_k.dtype)
    hot_v[:, in_page] = v[:, 0].to(hot_v.dtype)
    page_start = pos - in_page
    hot_len = torch.full((b,), in_page + 1, dtype=torch.int32,
                         device=x.device)
    o_hot, l_hot, m_hot = _partial_attn(q, hot_k, hot_v, hot_len)
    if page_start > 0:
        o_hist, l_hist, m_hist = _attn_history(cfg, q, qk, qv, page_start)
        m = torch.maximum(m_hist, m_hot)
        w1 = l_hist * torch.exp(m_hist - m)
    else:
        # empty history: the reference's weight l exp(NEG_BIG - m) is 0,
        # so the merge reduces to (o_hot w2) / w2
        o_hist = torch.zeros_like(o_hot)
        m, w1 = m_hot, torch.zeros_like(l_hot)
    w2 = l_hot * torch.exp(m_hot - m)
    o = (o_hist * w1[..., None] + o_hot * w2[..., None]) / (
        w1 + w2)[..., None]
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    if (pos + 1) % PAGE == 0:                          # close the page
        _quantize_page(qk, hot_k, pos // PAGE, kv_cfg)
        _quantize_page(qv, hot_v, pos // PAGE, kv_cfg)
        hot_k.zero_()
        hot_v.zero_()
    return x + o @ p["wo"]


def _qkv_layer(qkv: KVC.QuantizedKV, i: int) -> KVC.QuantizedKV:
    return KVC.QuantizedKV(*(t[i] for t in qkv))


def serve_step(cfg: ArchConfig, params: dict, cache, tokens, pos: int,
               mesh=None, kv_cfg: QuantizerConfig | None = None):
    """One decode step.  tokens: int [B, 1]; pos: a host int (aligned
    batch).  Returns (logits float32 [B, V_padded], cache), the cache
    updated in place.  `mesh`: the calling rank's (`launch.mesh`); with
    the rank's parameter blocks and cache blocks the reference's layout
    (`_serve_tp`; the logits the rank's "vocab" block), with whole
    weights the MoE layers take the expert-parallel decode path over its
    "model" axis and every other layer runs replicated."""
    pos = int(pos)
    spec = TT.rank_layout(cfg, params, mesh)
    if isinstance(cache, RankCache):
        return _serve_tp(cfg, params, cache, tokens, pos, mesh, kv_cfg,
                         spec), cache
    if spec is not None:
        raise ValueError("the rank's parameter blocks decode over its "
                         "RankCache (make_cache(..., mesh=)), not a whole "
                         "cache")
    x = TT.embed(params, tokens)
    if cfg.family == "hybrid":
        x = _serve_hybrid(cfg, params, cache, x, pos, mesh)
    elif isinstance(cache, QuantCache):
        _check_family(cfg)
        if kv_cfg is None:
            raise ValueError("a quantized cache needs kv_cfg")
        if cache.k.bins.shape[3] <= pos:
            raise ValueError(f"pos {pos} is past the cache's "
                             f"{cache.k.bins.shape[3]} tokens")
        lay = params["layers"]
        for i in range(cfg.n_layers):
            lp = _index(lay, i)
            x = _attn_decode_quant(cfg, lp, x, _qkv_layer(cache.k, i),
                                   _qkv_layer(cache.v, i), cache.hot_k[i],
                                   cache.hot_v[i], pos, kv_cfg)
            x, _ = _ffn_block(cfg, lp, x, mesh)
    else:
        _check_family(cfg)
        if cache.k.shape[2] <= pos:
            raise ValueError(f"pos {pos} is past the cache's "
                             f"{cache.k.shape[2]} tokens")
        lay = params["layers"]
        for i in range(cfg.n_layers):
            lp = _index(lay, i)
            x = _attn_decode_raw(cfg, lp, x, cache.k[i], cache.v[i], pos)
            x, _ = _ffn_block(cfg, lp, x, mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits(x, params)[:, 0].to(torch.float32), cache


def _serve_hybrid(cfg: ArchConfig, params: dict, cache, x, pos: int,
                  mesh=None) -> torch.Tensor:
    """The jamba decode step's stack over cache = (RawCache over the
    periods' attention layers [P, B, S, G, hd], (conv_tail [P, n_mamba, B,
    K-1, Di] bfloat16, ssm_h [P, n_mamba, B, Di, N] float32)), every plane
    written in place: the attention block through `_attn_decode_raw`, each
    Mamba block from its state (`mamba.mamba_block` at T = 1), the FFNs
    as the decoder stack's."""
    if not (isinstance(cache, tuple) and len(cache) == 2
            and isinstance(cache[0], RawCache)):
        raise TypeError("the hybrid decodes over ModelBundle.make_cache's "
                        "(RawCache, (conv tails, ssm states)); it has no "
                        "QuantCache path (the reference's engine refuses it, "
                        "engine.py:125)")
    attn, (tails, hs) = cache
    if attn.k.shape[2] <= pos:
        raise ValueError(f"pos {pos} is past the cache's "
                         f"{attn.k.shape[2]} tokens")
    periods = params["periods"]
    for per in range(cfg.n_layers // cfg.attn_period):
        pp = _index(periods, per)
        for _, mi, ffn, fi in hybrid_blocks(cfg):
            if mi is None:
                x = _attn_decode_raw(cfg, pp["attn"], x, attn.k[per],
                                     attn.v[per], pos)
            else:
                mp = _index(pp["mamba"], mi)
                hn = L.rms_norm(x, mp["ln1"], cfg.norm_eps)
                y, (tail, h) = M.mamba_block(
                    mp, hn, state=(tails[per, mi], hs[per, mi]))
                x = x + y
                tails[per, mi].copy_(tail)
                hs[per, mi].copy_(h)
            x, _ = _ffn_block(cfg, _index(pp[ffn], fi), x, mesh)
    return x


# ------------------------------------------------ the reference's layout --

class CachePlan(NamedTuple):
    """Where a rank's cache block lies (`cache_plan`): the global sequence
    `s`, the rank's `s_l` tokens from `s0`, its `page_l` hot-page slots
    from `t0`, and per plane of a layer (names of `QuantizedKV`, "hot";
    "kv" for a raw cache) the dim "model" splits, or None."""
    s: int
    s_l: int
    s0: int
    page_l: int
    t0: int
    model: dict


def cache_plan(cfg: ArchConfig, cache: RankCache, mesh) -> CachePlan:
    """The rank's `CachePlan` of its `RankCache`, whose block must have
    the shapes `cache_layouts` gives the rank of a cache of cache.batch
    rows over cache.seq tokens.  Raises where it has not, or where the
    layout is not one the step runs: it needs "model" on the sequence of
    bins / raw K and V (a page or token block a rank), on any dim of eb2
    and the outlier planes but the batch, on the hot page's slots or
    nowhere."""
    if not isinstance(cache, RankCache):
        raise TypeError(f"the layout's decode step takes a RankCache "
                        f"(make_cache(..., mesh=)), got "
                        f"{type(cache).__name__}")
    if "model" not in mesh.axis_names:
        raise ValueError(f"the layout's decode step needs a \"model\" axis, "
                         f"got {mesh!r}")
    blk = cache.block
    quant = isinstance(blk, QuantCache)
    lead = blk.k.bins if quant else blk.k
    desc = MESH.Mesh(mesh.shape, mesh.axis_names)
    glob = (_quant_tree if quant else _raw_tree)(
        cfg, cache.batch, cache.seq, lead.shape[0], _shapes)
    lays = T.leaves(MESH.cache_layouts(desc, glob, cache.batch))
    want = [MESH.block_shape(t.shape, ly) for t, ly in
            zip(T.leaves(glob), lays)]
    got = [tuple(t.shape) for t in T.leaves(blk)]
    if got != want:
        raise ValueError(f"a cache of blocks {got} is not a rank's block of "
                         f"{cache.batch} rows over {cache.seq} tokens under "
                         f"cache_layouts on {dict(desc.sizes)}: {want}")
    fields = (list(KVC.QuantizedKV._fields) * 2 + ["hot"] * 2 if quant
              else ["kv", "kv"])
    dims = {f: next((i - 1 for i, e in enumerate(ly.spec)
                     if "model" in MESH._names(e)), None)
            for f, ly in zip(fields, lays)}
    ax = mesh.axis("model")
    seq_dim = 2 if quant else 1
    s_l = lead.shape[1 + seq_dim]
    ok = dims["bins" if quant else "kv"] == seq_dim
    if quant:
        ok &= all(dims[f] != 0 for f in
                  ("eb2", "out_idx", "out_val", "overflow"))
        ok &= dims["hot"] in (None, 1) and s_l % PAGE == 0
    if not ok:
        raise NotImplementedError(f"a cache layout the decode step does not "
                                  f"run: \"model\" on dims {dims}")
    page_l = blk.hot_k.shape[2] if quant else 0
    t0 = ax.rank * page_l if quant and dims["hot"] == 1 else 0
    return CachePlan(cache.seq, s_l, ax.rank * s_l, page_l, t0, dims)


def merge_parts(parts: list, axis, like: torch.Tensor) -> torch.Tensor:
    """The attention output [B, H, hd] from the ranks' parts, each (o [B,
    H, hd], l [B, H], m [B, H]) over its tokens (o normalized by its l):
    B12's merge rule over `axis`, M = pmax of m, then one psum of
    sum o l exp(m - M) and of sum l exp(m - M).  A rank without parts adds
    nothing (`like`: a tensor of o's shape).  On one rank with the hot
    page and the history this is the single-rank merge, bit for bit."""
    if parts:
        m_loc = parts[0][2]
        for _, _, m_ in parts[1:]:
            m_loc = torch.maximum(m_loc, m_)
    else:
        m_loc = torch.full(like.shape[:-1], L.NEG_BIG, device=like.device)
    m_all = axis.pmax(m_loc)
    num = den = None
    for o, l_, m_ in parts:
        w = l_ * torch.exp(m_ - m_all)
        num = o * w[..., None] if num is None else num + o * w[..., None]
        den = w if den is None else den + w
    if num is None:
        num, den = torch.zeros_like(like), torch.zeros_like(like[..., 0])
    tot = axis.psum(torch.cat([num, den[..., None]], -1))
    return tot[..., :-1] / tot[..., -1:]


def _page_owner(page: int, plan: CachePlan) -> tuple:
    """(the rank that holds history page `page` of bins, its local page)."""
    per = plan.s_l // PAGE
    return page // per, page % per


def _rank_planes(qk: KVC.QuantizedKV, qv: KVC.QuantizedKV,
                 plan: CachePlan, mesh) -> tuple:
    """A layer's K and V planes over the rank's pages, whole in every other
    dim: bins as held (its sequence block); eb2 and the outlier planes as
    held where split by page, else gathered over "model" along the dim it
    splits (the KV heads, or the outlier slots; one collective for the
    six) and cut to the rank's pages.  overflow (B12 does not read it) as
    held."""
    per = plan.s_l // PAGE
    p0 = plan.s0 // PAGE
    names = ("eb2", "out_idx", "out_val")
    planes = {(i, f): getattr(qkv, f) for i, qkv in enumerate((qk, qv))
              for f in names}
    split = [key for key in planes if plan.model[key[1]] not in (None, 2)]
    if split:
        whole = mesh.axis("model").all_gather_dims(
            [planes[key] for key in split],
            [plan.model[key[1]] for key in split])
        planes.update(zip(split, whole))
    for key in planes:
        if plan.model[key[1]] != 2:
            planes[key] = planes[key][:, :, p0:p0 + per]
    return tuple(KVC.QuantizedKV(qkv.bins, *(planes[(i, f)] for f in names),
                                 qkv.overflow)
                 for i, qkv in enumerate((qk, qv)))


def _quantize_hot(hot: torch.Tensor, kv_cfg: QuantizerConfig):
    """A whole hot page [B, page, G, hd] quantized as one history page:
    QuantizedKV with bins [B, G, page, hd] and one page of each plane."""
    x = hot.permute(0, 2, 1, 3).to(torch.float32)          # [B, G, P, hd]
    return KVC.quantize_kv(x, kv_cfg, page=PAGE, cap=CAP)


def _close_page(qkv: KVC.QuantizedKV, hot: torch.Tensor, page: int,
                plan: CachePlan, mesh, kv_cfg: QuantizerConfig) -> None:
    """Quantize history page `page` from the hot page, whose slots are
    gathered over "model" first (every rank takes part in the gather);
    the ranks that hold a part of the page's planes quantize it and write
    their parts: the page's owner, and every rank where a plane is split
    in another dim than its pages (or not split)."""
    ax = mesh.axis("model")
    full = ax.all_gather_dim(hot, 1) if plan.model["hot"] == 1 else hot
    owner, lp = _page_owner(page, plan)
    others = [f for f in ("eb2", "out_idx", "out_val", "overflow")
              if plan.model[f] != 2]
    if owner != ax.rank and not others:
        return
    q = _quantize_hot(full, kv_cfg)
    vals = {"eb2": q.eb2[..., 0], "out_idx": q.out_idx[:, :, 0],
            "out_val": q.out_val[:, :, 0], "overflow": q.overflow[..., 0]}
    if owner == ax.rank:
        qkv.bins[:, :, lp * PAGE:(lp + 1) * PAGE] = q.bins
    for f, v in vals.items():
        t, md = getattr(qkv, f), plan.model[f]
        if md == 2:
            if owner == ax.rank:
                t[:, :, lp] = v
            continue
        if md is not None:           # the rank's slice of v's dim md
            n = t.shape[md]
            v = v.narrow(md if md < 2 else md - 1, ax.rank * n, n)
        t[:, :, page] = v


def _attn_decode_tp(cfg: ArchConfig, p: dict, x, kv: tuple, pos: int,
                    plan: CachePlan, lspec, mesh,
                    kv_cfg: QuantizerConfig | None):
    """One layer's attention on a rank of the layout (p after
    `fsdp_gather`; lspec None for whole weights): kv is (kc, vc) [B, S_l,
    G, hd] of a raw cache, or (qk, qv, hot_k, hot_v) of a quantized one,
    written in place."""
    b = x.shape[0]
    hd = cfg.head_dim
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    # q of every head (the history is split by sequence, not by head)
    qa, k, v = _project(cfg, p, x, positions, lspec, mesh, all_heads=True)
    h0, hl = TT._heads(cfg, p, lspec, mesh)
    ax = mesh.axis("model")
    parts = []
    if len(kv) == 2:                                       # raw
        kc, vc = kv
        if plan.s0 <= pos < plan.s0 + plan.s_l:
            kc[:, pos - plan.s0] = k[:, 0].to(kc.dtype)
            vc[:, pos - plan.s0] = v[:, 0].to(vc.dtype)
        n = min(max(pos + 1 - plan.s0, 0), plan.s_l)
        if n:
            lengths = torch.full((b,), n, dtype=torch.int32, device=x.device)
            parts.append(L.decode_attention(qa, kc, vc, lengths,
                                            return_stats=True))
    else:
        qk, qv, hot_k, hot_v = kv
        in_page = pos % PAGE
        slot = in_page - plan.t0
        if 0 <= slot < plan.page_l:
            hot_k[:, slot] = k[:, 0].to(hot_k.dtype)
            hot_v[:, slot] = v[:, 0].to(hot_v.dtype)
        # every rank takes part in the planes' gathers, with history or not
        planes = _rank_planes(qk, qv, plan, mesh)
        hist = min(max(pos - in_page - plan.s0, 0), plan.s_l)
        if hist:
            parts.append(_attn_history(cfg, qa, *planes, hist))
        # a hot page that "model" does not split is rank 0's part alone
        n = min(max(in_page + 1 - plan.t0, 0), plan.page_l)
        if n and (plan.model["hot"] == 1 or ax.rank == 0):
            hot_len = torch.full((b,), n, dtype=torch.int32, device=x.device)
            parts.append(_partial_attn(qa, hot_k, hot_v, hot_len))
        if (pos + 1) % PAGE == 0:
            for qkv, hot in ((qk, hot_k), (qv, hot_v)):
                _close_page(qkv, hot, pos // PAGE, plan, mesh, kv_cfg)
                hot.zero_()
    like = torch.empty((b, qa.shape[2], hd), device=x.device)
    o = merge_parts(parts, ax, like)[:, h0:h0 + hl]
    o = o.reshape(b, 1, hl * hd).to(x.dtype)
    return x + TT.attn_out(o, p["wo"], TT._entry(lspec, "wo", 0), mesh)


def _serve_tp(cfg: ArchConfig, params: dict, cache: RankCache, tokens,
              pos: int, mesh, kv_cfg: QuantizerConfig | None,
              spec) -> torch.Tensor:
    """`serve_step` over a rank's `RankCache`: with `spec` (the rank's
    parameter blocks) the rank's "vocab" block of the logits, float32
    [B_l, V_padded / model]; with whole weights (spec None) every
    vocab's."""
    _check_family(cfg)
    plan = cache_plan(cfg, cache, mesh)
    blk = cache.block
    quant = isinstance(blk, QuantCache)
    if quant and kv_cfg is None:
        raise ValueError("a quantized cache needs kv_cfg")
    if not 0 <= pos < plan.s:
        raise ValueError(f"pos {pos} is outside the cache's {plan.s} tokens")
    lspec = TT._layer_spec(None if spec is None else spec["layers"])
    x = TT.embed(params, tokens, spec, mesh)
    for i in range(cfg.n_layers):
        lp = TT.fsdp_gather(_index(params["layers"], i), lspec, mesh)
        if quant:
            kv = (_qkv_layer(blk.k, i), _qkv_layer(blk.v, i),
                  blk.hot_k[i], blk.hot_v[i])
        else:
            kv = (blk.k[i], blk.v[i])
        x = _attn_decode_tp(cfg, lp, x, kv, pos, plan, lspec, mesh, kv_cfg)
        x, _ = _ffn_block(cfg, lp, x, mesh, None, lspec)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits(x, params, spec, mesh)[:, 0].to(torch.float32)


# ------------------------------------------------- one position a row --

def _host_ints(vals: list, dev: torch.device) -> torch.Tensor:
    """int32 [len(vals)] on dev without a device sync (pinned, async)."""
    t = torch.tensor(vals, dtype=torch.int32)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" \
        else t


class _Rows(NamedTuple):
    """A row-wise step's per-row state, made once a step."""
    positions: torch.Tensor       # int32 [B, 1]
    hot_len: torch.Tensor         # int32 [B]
    page_start: torch.Tensor      # int32 [B]
    has_hist: torch.Tensor        # bool [B]
    any_hist: bool
    wr_rows: torch.Tensor         # int64 [W], the live rows
    wr_slot: torch.Tensor         # int64 [W], their hot-page slot
    closing: list                 # [(row, page index)] of pages that fill


def _rows_state(pos: list, live: list, dev) -> _Rows:
    b = len(pos)
    eff = [p if on else 0 for p, on in zip(pos, live)]
    in_page = [p % PAGE for p in eff]
    start = [p - i for p, i in zip(eff, in_page)]
    wr = [r for r in range(b) if live[r]]
    ints = _host_ints(eff + [i + 1 for i in in_page] + start + wr
                      + [in_page[r] for r in wr], dev)
    start_t = ints[2 * b:3 * b]
    return _Rows(ints[:b][:, None], ints[b:2 * b], start_t, start_t > 0,
                 any(s_ > 0 for s_ in start),
                 ints[3 * b:3 * b + len(wr)].long(),
                 ints[3 * b + len(wr):].long(),
                 [(r, eff[r] // PAGE) for r in wr if (eff[r] + 1) % PAGE == 0])


def _attn_decode_rows(cfg: ArchConfig, p: dict, x, qk, qv, hot_k, hot_v,
                      st: _Rows, kv_cfg: QuantizerConfig, pages_per_split):
    """`_attn_decode_quant` with a position a row: the live rows' tokens go
    into their hot pages, the closed pages (B12, lengths a row) and the
    hot page are merged row by row, and a live row's page is quantized
    when it fills."""
    rows = x.shape[0]
    q, k, v = _project_token(cfg, p, x, st.positions)
    hot_k[st.wr_rows, st.wr_slot] = k[st.wr_rows, 0].to(hot_k.dtype)
    hot_v[st.wr_rows, st.wr_slot] = v[st.wr_rows, 0].to(hot_v.dtype)
    o_hot, l_hot, m_hot = _partial_attn(q, hot_k, hot_v, st.hot_len)
    if st.any_hist:
        o_h, l_h, m_h = _attn_history(cfg, q, qk, qv, st.page_start,
                                      pages_per_split)
        has = st.has_hist[:, None]
        m = torch.where(has, torch.maximum(m_h, m_hot), m_hot)
        w1 = torch.where(has, l_h * torch.exp(m_h - m),
                         torch.zeros_like(l_hot))
        o_hist = torch.where(has[..., None], o_h, torch.zeros_like(o_hot))
    else:
        o_hist = torch.zeros_like(o_hot)
        m, w1 = m_hot, torch.zeros_like(l_hot)
    w2 = l_hot * torch.exp(m_hot - m)
    o = (o_hist * w1[..., None] + o_hot * w2[..., None]) / (
        w1 + w2)[..., None]
    o = o.reshape(rows, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    for r, page_idx in st.closing:                 # close each row's page
        for qkv, hot in ((qk, hot_k), (qv, hot_v)):
            _quantize_page(KVC.QuantizedKV(*(t[r:r + 1] for t in qkv)),
                           hot[r:r + 1], page_idx, kv_cfg)
            hot[r].zero_()
    return x + o @ p["wo"]


def _ffn_rows(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The FFN sublayer with every row its own MoE routing group."""
    if "router" not in p:
        return _ffn_block(cfg, p, x)[0]
    hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + moe_ffn_rows(hx, p["router"], p["w1"], p["w3"], p["w2"],
                            top_k=cfg.moe_top_k, act=cfg.act)


def serve_step_rows(cfg: ArchConfig, params: dict, cache: QuantCache,
                    tokens, pos: list, kv_cfg: QuantizerConfig, *,
                    live=None, pages_per_split: int | None = None):
    """One decode step over a quantized cache with a position a row (the
    reference's vmap of the batch-1 step over a slot axis, which the
    engine's batched step is).  tokens: int [B, 1]; pos: B host ints;
    the cache (B rows) is updated in place.  Returns (logits float32 [B,
    V_padded], cache).

    Each row is computed as the batch-1 step computes it: RoPE at its
    position, its token into its hot page at pos % page, B12 over its
    closed pages (lengths a row; not launched while no row has any), its
    own MoE routing group, and its page quantized when it fills.

    live: B host bools (default all): a dead row is computed at position
    0 and writes nothing; its logits are stale.  pages_per_split: B12's
    split (fix it to keep a row's sums from depending on B)."""
    _check_family(cfg)
    b = tokens.shape[0]
    pos = [int(p_) for p_ in pos]
    live = [True] * b if live is None else [bool(on) for on in live]
    if len(pos) != b or len(live) != b:
        raise ValueError(f"{b} rows with {len(pos)} positions and "
                         f"{len(live)} live flags")
    s = cache.k.bins.shape[3]
    for r in range(b):
        if live[r] and not 0 <= pos[r] < s:
            raise ValueError(f"row {r}: pos {pos[r]} is outside the cache's "
                             f"{s} tokens")
    st = _rows_state(pos, live, tokens.device)
    x = params["emb"][tokens].to(DTYPE)
    lay = params["layers"]
    for i in range(cfg.n_layers):
        lp = _index(lay, i)
        x = _attn_decode_rows(cfg, lp, x, _qkv_layer(cache.k, i),
                              _qkv_layer(cache.v, i), cache.hot_k[i],
                              cache.hot_v[i], st, kv_cfg, pages_per_split)
        x = _ffn_rows(cfg, lp, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits(x, params)[:, 0].to(torch.float32), cache

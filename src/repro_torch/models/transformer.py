"""The decoder stack: parameter specs, blocks and the forward pass for the
dense, vlm, MoE and hybrid (jamba) families (counterpart of
`repro.models.transformer`).

Per-layer parameters are stacked on a leading layer axis, as in the
reference, so its parameter tree carries across as it is
(`params.params_from_numpy`).  The reference scans the stack under
grouped remat (`jax.checkpoint`); the port loops over the layers in
Python (as `serve_step` does) and, with remat while autograd records,
wraps each layer in `torch.utils.checkpoint.checkpoint`: the backward
pass recomputes the layer from its input instead of keeping its
activations, which changes no value.  The jamba hybrid's stack walks
its periods the same way (`_period`: seven Mamba blocks and an
attention block, each followed by its dense or MoE FFN), each period
one checkpoint, inside which `mamba.mamba_block`'s scan checkpoints its
chunks (the reference's `scan_grouped_remat(..., max_group=1)` over
`chunked_scan`).  encdec and ssm have stacks of their own
(`models.encdec`, `models.xlstm_stack`).

With a `launch.mesh.Mesh` of the calling rank, `params` is one of two
things (`rank_layout` tells which, and raises on anything else):

  * the rank's blocks under `launch.mesh.param_shardings` (`param_blocks`;
    the dense, vlm and MoE families): the reference's layout, run where
    GSPMD puts its collectives, for serving and for training (the
    gradient reaches the rank's blocks through the collectives'
    backward: the FSDP gather's is a reduce-scatter over the data axes,
    the psums' a psum; `launch.train`; the cross-entropy over the
    "vocab" blocks is `layers.vocab_ce`).  Inside the layer loop each layer's
    "embed" blocks are gathered over the data axes (FSDP), then dropped.
    q comes from the rank's `wq` columns (whole heads); k and v from its
    `wkv` block, gathered over "model" (a block can split a KV head: the
    reference un-shards k and v at the same seam); `repeat_kv` then the
    rank's heads, `flash_attention` over them, and `wo` row-parallel (the
    rank's partial product in float32, a psum over "model", one rounding
    to bfloat16).  The dense FFN is `w1` / `w3` column-parallel
    and `w2` row-parallel; the MoE experts run expert parallel as below.
    The embedding is the rank's "vocab" rows (`layers.vocab_embed`), and
    the logits are the rank's "vocab" block.  A dim that its axes do not
    divide is whole on every rank and runs so (no psum over it);
  * whole weights, the experts whole or the rank's block over "model"
    alone: the MoE layers run expert parallel over "model"
    (`moe.moe_ffn`), every other layer replicated on each rank.  The
    hybrid runs only so (its Mamba layout waits), and the MoE experts'
    "embed" dim on the layout is gathered with the rest of the layer.

While autograd records, `remat` checkpoints each layer on either form;
thread ranks of the layout train without it (`launch.train`: a
recomputed layer would call a thread collective inside the backward).

One implementation serves both: the sublayers take the layer's specs
(`lspec`, None for whole weights), and a dim that no "model" axis of
more than one rank splits runs the one-rank ops in the one-rank order.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from ..configs.base import ArchConfig
from ..launch import mesh as MESH
from ..launch.mesh import data_axes
from . import layers as L
from . import mamba as M
from .moe import moe_ffn
from .params import ParamSpec, axes_tree
from .params import tree_map as ptree_map

DTYPE = torch.bfloat16


OWN_STACK = {"encdec": "models.encdec", "ssm": "models.xlstm_stack"}
# the families whose forward pass and decode step run the reference's
# layout (`rank_layout`); the others run on whole weights
LAYOUT_FAMILIES = ("dense", "vlm", "moe")


def _check_decoder(cfg: ArchConfig, what: str) -> None:
    """The decoder stack runs the dense, vlm, MoE and hybrid families;
    encdec and ssm have stacks of their own."""
    if cfg.family in OWN_STACK:
        raise ValueError(f"the {cfg.family} family's {what} lives in "
                         f"{OWN_STACK[cfg.family]} (models.build dispatches "
                         "to it)")
    if cfg.family not in ("dense", "vlm", "moe", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")


def _attn_specs(cfg: ArchConfig, lead=()):
    d, hd = cfg.d_model, cfg.head_dim
    h, g = cfg.n_heads, cfg.n_kv_heads
    ax = tuple(None for _ in lead)
    return {
        "ln1": ParamSpec(lead + (d,), torch.float32, ax + (None,), -1.0),
        "wq": ParamSpec(lead + (d, h * hd), DTYPE, ax + ("embed", "heads")),
        "wkv": ParamSpec(lead + (d, 2 * g * hd), DTYPE,
                         ax + ("embed", "heads")),
        "wo": ParamSpec(lead + (h * hd, d), DTYPE, ax + ("heads", "embed")),
    }


def _ffn_specs(cfg: ArchConfig, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    ax = tuple(None for _ in lead)
    s = {
        "ln2": ParamSpec(lead + (d,), torch.float32, ax + (None,), -1.0),
        "w1": ParamSpec(lead + (d, f), DTYPE, ax + ("embed", "mlp")),
        "w2": ParamSpec(lead + (f, d), DTYPE, ax + ("mlp", "embed")),
    }
    if cfg.act == "swiglu":
        s["w3"] = ParamSpec(lead + (d, f), DTYPE, ax + ("embed", "mlp"))
    return s


def _moe_specs(cfg: ArchConfig, lead=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    ax = tuple(None for _ in lead)
    return {
        "ln2": ParamSpec(lead + (d,), torch.float32, ax + (None,), -1.0),
        "router": ParamSpec(lead + (d, e), torch.float32,
                            ax + ("embed", None)),
        "w1": ParamSpec(lead + (e, d, f), DTYPE,
                        ax + ("experts", "embed", None)),
        "w3": ParamSpec(lead + (e, d, f), DTYPE,
                        ax + ("experts", "embed", None)),
        "w2": ParamSpec(lead + (e, f, d), DTYPE,
                        ax + ("experts", None, "embed")),
    }


_MAMBA_AXES = {
    "in_proj": ("embed", "mlp"),
    "conv_w": (None, "mlp"),
    "a_log": ("mlp", None),
    "d_skip": ("mlp",),
    "bc_proj": ("mlp", None),
    "dt_proj": ("embed", "mlp"),
    "dt_bias": ("mlp",),
    "out_proj": ("mlp", "embed"),
}


def _mamba_specs(cfg: ArchConfig, lead=()):
    """One Mamba block's parameters (`mamba.mamba_params_shape`) and its
    norm."""
    ax = tuple(None for _ in lead)
    out = {"ln1": ParamSpec(lead + (cfg.d_model,), torch.float32,
                            ax + (None,), -1.0)}
    for name, (shape, dt) in M.mamba_params_shape(
            cfg.d_model, cfg.ssm_state, DTYPE).items():
        scale = -1.0 if name in ("a_log", "d_skip", "dt_bias") else 0.02
        out[name] = ParamSpec(lead + shape, dt, ax + _MAMBA_AXES[name], scale)
    return out


def param_specs(cfg: ArchConfig) -> dict:
    d, l_ = cfg.d_model, cfg.n_layers
    specs = {
        "emb": ParamSpec((cfg.padded_vocab, d), DTYPE, ("vocab", "embed")),
        "final_norm": ParamSpec((d,), torch.float32, (None,), -1.0),
    }
    if cfg.family in ("dense", "vlm"):
        specs["layers"] = {**_attn_specs(cfg, (l_,)),
                           **_ffn_specs(cfg, (l_,))}
    elif cfg.family == "moe":
        specs["layers"] = {**_attn_specs(cfg, (l_,)),
                           **_moe_specs(cfg, (l_,))}
    elif cfg.family == "hybrid":
        n_per = cfg.attn_period                  # blocks per period
        periods = l_ // n_per
        n_moe = n_per // cfg.moe_every
        specs["periods"] = {
            "mamba": _mamba_specs(cfg, (periods, n_per - 1)),
            "attn": _attn_specs(cfg, (periods,)),
            "dense_ffn": _ffn_specs(cfg, (periods, n_per - n_moe)),
            "moe_ffn": _moe_specs(cfg, (periods, n_moe)),
        }
    else:
        _check_decoder(cfg, "parameters")
    return specs


def _project(cfg: ArchConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor, lspec=None, mesh=None,
             all_heads: bool = False):
    """The attention sublayer's projections: x [B, S, D] -> q [B, S, Hl,
    hd], k, v [B, S, G, hd] of rms_norm(x), q and k roped at `positions`
    ([1, S], or [B, S] one row each).  With whole weights (lspec None) Hl
    is every head; on a rank of the layout (p the layer after
    `fsdp_gather`) q is the rank's heads (`_heads`; with all_heads every
    head's, gathered over "model" in one collective with k and v), and k,
    v are gathered over "model" before the KV heads' seam."""
    b, s, _ = x.shape
    g, hd = cfg.n_kv_heads, cfg.head_dim
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = hx @ p["wq"]
    kv = hx @ p["wkv"]
    q_e, kv_e = _entry(lspec, "wq", 1), _entry(lspec, "wkv", 1)
    if all_heads and _split(q_e, mesh) and _split(kv_e, mesh):
        q, kv = MESH.gather_dims([q, kv], kv_e, mesh,
                                 [q.dim() - 1, kv.dim() - 1])
    else:
        kv = _gather_kv(kv, kv_e, mesh)
        if all_heads and _split(q_e, mesh):
            q = MESH.gather_dim(q, q_e, mesh, q.dim() - 1)
    q = q.reshape(b, s, -1, hd)
    kv = kv.reshape(b, s, 2, g, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    cos, sin = L.rope_tables(positions, hd if cfg.rope == "full" else hd // 2)
    return (L.apply_rope(q, cos, sin, cfg.rope),
            L.apply_rope(k, cos, sin, cfg.rope), v)


def _heads(cfg: ArchConfig, p: dict, lspec=None, mesh=None) -> tuple:
    """(h0, Hl): the heads of the rank's `wq` columns, h0 .. h0 + Hl - 1
    (with whole weights every head)."""
    hl = p["wq"].shape[-1] // cfg.head_dim
    if _split(_entry(lspec, "wq", 1), mesh):
        return mesh.axis("model").rank * hl, hl
    return 0, hl


def _attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, lspec=None, mesh=None, *,
               causal: bool = True):
    """The attention sublayer over a whole sequence, with its residual:
    x [B, S, D] -> x + wo(flash_attention(rope(q), rope(k), v)), over the
    rank's heads on a rank of the layout (`wo` row-parallel)."""
    b, s, _ = x.shape
    q, k, v = _project(cfg, p, x, positions, lspec, mesh)
    h0, hl = _heads(cfg, p, lspec, mesh)
    k = rank_heads(k, cfg.group_size, h0, hl)
    v = rank_heads(v, cfg.group_size, h0, hl)
    o = L.flash_attention(q, k, v, causal=causal)
    return x + attn_out(o.reshape(b, s, hl * cfg.head_dim), p["wo"],
                        _entry(lspec, "wo", 0), mesh)


def _ffn_block(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh=None,
               moe_data_axes=None, lspec=None):
    """The FFN sublayer with its residual: (x + ffn(rms_norm(x)), aux),
    through the experts where the layer has a router (aux is their
    load-balance loss, a 0-d tensor; else the number 0.0, which launches
    nothing in the decode step); with a mesh, expert parallel, aux
    averaged over `moe_data_axes` (default: the mesh's data axes) and the
    model axis.  On a rank of the layout (p after `fsdp_gather`) the
    dense FFN is column- then row-parallel (a psum over "model" after
    w2)."""
    hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "router" in p:
        if moe_data_axes is None:
            moe_data_axes = ("data",) if mesh is None else data_axes(mesh)
        y, aux = moe_ffn(hx, p["router"], p["w1"], p["w3"], p["w2"],
                         top_k=cfg.moe_top_k, mesh=mesh,
                         data_axes=moe_data_axes, act=cfg.act,
                         n_experts=cfg.moe_experts)
        return x + y, aux
    h = L.ffn_hidden(hx, p["w1"], p.get("w3"), cfg.act)
    if _split(_entry(lspec, "w2", 0), mesh):
        return x + L.row_parallel(h, p["w2"], mesh.axis("model")), 0.0
    return x + h @ p["w2"], 0.0


def _layer(cfg: ArchConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, mesh=None, moe_data_axes=None,
           lspec=None):
    """One decoder layer: (x after attention and FFN, its aux loss); on a
    rank of the layout its "embed" blocks gathered over the data axes
    first, then dropped."""
    lp = fsdp_gather(lp, lspec, mesh)
    x = _attention(cfg, lp, x, positions, lspec, mesh)
    return _ffn_block(cfg, lp, x, mesh, moe_data_axes, lspec)


def _index(tree: dict, i: int) -> dict:
    """Layer i of a stacked parameter tree (dicts of tensors)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hybrid_blocks(cfg: ArchConfig):
    """A period's blocks in order: (block, mamba index or None for the
    attention block, "moe_ffn" or "dense_ffn", the FFN's index)."""
    n_per, out = cfg.attn_period, []
    mamba_i = dense_i = moe_i = 0
    for blk in range(n_per):
        mi = None if blk == n_per - 1 else mamba_i
        mamba_i += mi is not None
        if blk % cfg.moe_every == cfg.moe_every - 1:
            out.append((blk, mi, "moe_ffn", moe_i))
            moe_i += 1
        else:
            out.append((blk, mi, "dense_ffn", dense_i))
            dense_i += 1
    return out


def _period(cfg: ArchConfig, pp: dict, x: torch.Tensor,
            positions: torch.Tensor, mesh=None, moe_data_axes=None):
    """One jamba period: blocks 0 .. n_per - 2 are rms_norm + Mamba with
    the residual, the last is attention; after each block its FFN (MoE
    every moe_every-th block).  Returns (x, the period's aux loss)."""
    aux = 0.0
    for _, mi, ffn, fi in hybrid_blocks(cfg):
        if mi is None:
            x = _attention(cfg, pp["attn"], x, positions)
        else:
            mp = _index(pp["mamba"], mi)
            y, _ = M.mamba_block(mp, L.rms_norm(x, mp["ln1"], cfg.norm_eps))
            x = x + y
        x, a = _ffn_block(cfg, _index(pp[ffn], fi), x, mesh, moe_data_axes)
        aux = aux + a
    return x, aux


# ------------------------------------------------ the reference's layout --

@functools.lru_cache(maxsize=None)
def param_layout(cfg: ArchConfig, shape: tuple, names: tuple):
    """`launch.mesh.param_shardings` of the parameter tree of `cfg` on a
    mesh of `shape` and axis `names` (a tree of `Sharding`s on a
    description; stacked leaves keep their layer dim, spec entry None).
    A mesh without "data" (a ("model",) mesh) or "model" has it at size
    1."""
    if not {"pod", "data"} & set(names):
        shape, names = (1,) + tuple(shape), ("data",) + tuple(names)
    if "model" not in names:
        shape, names = tuple(shape) + (1,), tuple(names) + ("model",)
    specs = param_specs(cfg)      # ParamSpecs carry the shapes: no tensor
    return MESH.param_shardings(MESH.Mesh(shape, names), axes_tree(specs),
                                specs)


@functools.lru_cache(maxsize=None)
def _shardings(cfg: ArchConfig, shape: tuple, names: tuple):
    """(global shapes, specs, logical axes, axis sizes) of `param_layout`
    ({name: tuple} trees)."""
    specs = param_specs(cfg)
    shard = param_layout(cfg, shape, names)
    return (ptree_map(lambda p: tuple(p.shape), specs),
            T.tree_map(lambda s_: s_.spec, shard), axes_tree(specs),
            T.leaves(shard)[0].mesh.sizes)


def _is_shape(x) -> bool:
    return isinstance(x, tuple)


def _block(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    return tuple(n // MESH._axis_size(e, sizes) for n, e in zip(shape, spec))


def rank_layout(cfg: ArchConfig, params: dict, mesh):
    """The specs tree {name: spec tuple} when `params` are the rank's
    blocks under `param_shardings` on `mesh` (the reference's layout, for
    the LAYOUT_FAMILIES), None when there is no mesh or the weights are
    whole but for the experts (any leaf with an "experts" axis), which
    are whole or the rank's block over "model" alone, as `moe.moe_ffn`
    takes them (the train step's layout).  On a mesh that splits no
    weight the blocks are whole, and the whole-weight path runs.
    Anything else raises: nothing gives way to whole weights."""
    if mesh is None:
        return None
    shapes, specs, axes, sizes = _shardings(cfg, mesh.shape, mesh.axis_names)
    got = {k: tuple(v.shape) for k, v in _flat(params).items()}
    glob, spec, ax = (_flat(t, _is_shape) for t in (shapes, specs, axes))
    if got.keys() != glob.keys():
        raise ValueError(f"parameters {sorted(got)} are not {cfg.name}'s")
    block = {k: _block(glob[k], spec[k], sizes) for k in glob}
    if got == block and got != glob:
        if cfg.family not in LAYOUT_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family} family runs on whole weights only: its "
                "layout (the hybrid's Mamba blocks with \"mlp\" over "
                "\"model\") waits for a later slice")
        return specs
    experts = {k: _block(glob[k], tuple(e if a == "experts" else None
                                        for a, e in zip(ax[k], spec[k])),
                         sizes)
               for k in glob if "experts" in ax[k]}
    if all(got[k] in (glob[k], experts.get(k, glob[k])) for k in glob):
        return None
    bad = sorted(k for k in glob
                 if got[k] not in (glob[k], block[k], experts.get(k)))
    raise ValueError(f"parameters neither whole nor the rank's blocks "
                     f"under param_shardings on {mesh!r}: "
                     f"{bad or sorted(got)}")


def _flat(tree, is_leaf=torch.is_tensor, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not is_leaf(v):
            out.update(_flat(v, is_leaf, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _entry(lspec, name: str, dim: int):
    """The spec entry of dim `dim` of weight `name` (None: whole
    weights, lspec None)."""
    return None if lspec is None else lspec[name][dim]


def _is_data(entry) -> bool:
    names = MESH._names(entry)
    return bool(names) and all(a in ("pod", "data") for a in names)


def _split(entry, mesh) -> bool:
    """Whether a spec entry splits a dim over a "model" axis of more than
    one rank (over one, every product and gather is the one-rank one)."""
    return (mesh is not None and "model" in MESH._names(entry)
            and mesh.sizes.get("model", 1) > 1)


def fsdp_gather(lp: dict, lspec, mesh) -> dict:
    """A layer's weights with their data-axis ("embed") blocks gathered
    over the data axes, all in one collective an axis (the rest stays the
    rank's block); whole weights (lspec None) as they are."""
    if lspec is None:
        return lp
    keys, dims, entry = [], [], None
    for k in lp:
        for dim, e in enumerate(lspec[k]):
            if _is_data(e):
                keys.append(k)
                dims.append(dim)
                entry = e
    if not keys:
        return dict(lp)
    whole = MESH.gather_dims([lp[k] for k in keys], entry, mesh, dims)
    return {**lp, **dict(zip(keys, whole))}


def _layer_spec(spec) -> dict | None:
    """A stacked tree's specs without the layer dim."""
    return None if spec is None else {k: v[1:] for k, v in spec.items()}


def _gather_kv(kv: torch.Tensor, entry, mesh) -> torch.Tensor:
    """The rank's `wkv` product columns made whole over "model": the KV
    heads' seam is taken after this gather (a rank's block can split a
    head)."""
    return MESH.gather_dim(kv, entry, mesh, kv.dim() - 1) if _split(
        entry, mesh) else kv


def rank_heads(kv: torch.Tensor, group_size: int, h0: int, n: int):
    """Heads h0 .. h0 + n - 1 of `repeat_kv(kv, group_size)` (kv [B, S, G,
    hd]): repeat_kv over the KV heads they use, then those heads."""
    g0 = h0 // group_size
    g1 = (h0 + n - 1) // group_size + 1
    r = L.repeat_kv(kv[:, :, g0:g1], group_size)
    off = h0 - g0 * group_size
    return r[:, :, off:off + n]


def attn_out(o: torch.Tensor, wo: torch.Tensor, entry, mesh) -> torch.Tensor:
    """The rank's heads' output o [..., Hl hd] through its `wo` rows: a
    row-parallel product (psum over "model") where the heads are split."""
    if _split(entry, mesh):
        return L.row_parallel(o, wo, mesh.axis("model"))
    return o @ wo


def _emb(params: dict, spec, mesh) -> torch.Tensor:
    """The embedding's rows (the rank's "vocab" block on the layout, its
    "embed" dim gathered over the data axes)."""
    return fsdp_gather({"emb": params["emb"]}, spec, mesh)["emb"]


def embed(params: dict, tokens, spec=None, mesh=None) -> torch.Tensor:
    """The embedding of `tokens`; on a rank of the layout (`spec`) its
    "vocab" rows looked up by `layers.vocab_embed`."""
    emb = _emb(params, spec, mesh)
    if _split(_entry(spec, "emb", 0), mesh):
        return L.vocab_embed(emb, tokens, mesh.axis("model")).to(DTYPE)
    return emb[tokens].to(DTYPE)


def logits(x: torch.Tensor, params: dict, spec=None, mesh=None):
    """x [..., D] against the embedding: on a rank of the layout its
    "vocab" block of the logits (the reference's seam)."""
    return x @ _emb(params, spec, mesh).T.to(DTYPE)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, mesh=None,
            remat: bool = True, moe_data_axes=None):
    """tokens: int [B, S] -> (logits bfloat16 [B, S, V_padded], aux float32
    []), the sum of the layers' load-balance losses.  `mesh`: the calling
    rank's (the tokens are the rank's; with the rank's parameter blocks
    the reference's layout, and the logits the rank's "vocab" block [B,
    S, V_padded / model]; with whole weights the MoE layers expert
    parallel); `remat` checkpoints each layer (the hybrid: each period)
    while autograd records; `moe_data_axes`: the axes the MoE aux is
    averaged over besides the model axis (default: the mesh's data
    axes)."""
    _check_decoder(cfg, "forward pass")
    spec = rank_layout(cfg, params, mesh)
    x = embed(params, tokens, spec, mesh)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    if cfg.family == "hybrid":
        stack, fn, n = params["periods"], _period, (
            cfg.n_layers // cfg.attn_period)
    else:
        stack, n = params["layers"], cfg.n_layers
        fn = functools.partial(_layer, lspec=_layer_spec(
            None if spec is None else spec["layers"]))
    for i in range(n):
        lp = _index(stack, i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(fn, cfg, lp, x, positions, mesh,
                              moe_data_axes, use_reentrant=False)
        else:
            x, a = fn(cfg, lp, x, positions, mesh, moe_data_axes)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits(x, params, spec, mesh), aux

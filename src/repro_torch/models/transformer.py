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

With a `launch.mesh.Mesh` of the calling rank the MoE layers run expert
parallel over its "model" axis (`moe.moe_ffn`); every other layer runs
replicated on each rank, as the reference computes them (its tensor
parallel and FSDP layouts are its compiler's partitioning, not code).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..launch.mesh import data_axes
from . import layers as L
from . import mamba as M
from .moe import moe_ffn
from .params import ParamSpec

DTYPE = torch.bfloat16


OWN_STACK = {"encdec": "models.encdec", "ssm": "models.xlstm_stack"}


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
             positions: torch.Tensor):
    """The attention sublayer's projections: x [B, S, D] -> q [B, S, H,
    hd], k, v [B, S, G, hd] of rms_norm(x), q and k roped at `positions`
    ([1, S], or [B, S] one row each)."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (hx @ p["wq"]).reshape(b, s, h, hd)
    kv = (hx @ p["wkv"]).reshape(b, s, 2, g, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    cos, sin = L.rope_tables(positions, hd if cfg.rope == "full" else hd // 2)
    return (L.apply_rope(q, cos, sin, cfg.rope),
            L.apply_rope(k, cos, sin, cfg.rope), v)


def _attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True):
    """The attention sublayer over a whole sequence, with its residual:
    x [B, S, D] -> x + wo(flash_attention(rope(q), rope(k), v))."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project(cfg, p, x, positions)
    k = L.repeat_kv(k, cfg.group_size)
    v = L.repeat_kv(v, cfg.group_size)
    o = L.flash_attention(q, k, v, causal=causal)
    return x + o.reshape(b, s, h * hd) @ p["wo"]


def _ffn_block(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh=None,
               moe_data_axes=None):
    """The FFN sublayer with its residual: (x + ffn(rms_norm(x)), aux),
    through the experts where the layer has a router (aux is their
    load-balance loss, a 0-d tensor; else the number 0.0, which launches
    nothing in the decode step); with a mesh, expert parallel, aux
    averaged over `moe_data_axes` (default: the mesh's data axes) and the
    model axis."""
    hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "router" in p:
        if moe_data_axes is None:
            moe_data_axes = ("data",) if mesh is None else data_axes(mesh)
        y, aux = moe_ffn(hx, p["router"], p["w1"], p["w3"], p["w2"],
                         top_k=cfg.moe_top_k, mesh=mesh,
                         data_axes=moe_data_axes, act=cfg.act,
                         n_experts=cfg.moe_experts)
        return x + y, aux
    y = L.ffn(hx, p["w1"], p.get("w3"), p["w2"], cfg.act)
    return x + y, 0.0


def _layer(cfg: ArchConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, mesh=None, moe_data_axes=None):
    """One decoder layer: (x after attention and FFN, its aux loss)."""
    x = _attention(cfg, lp, x, positions)
    return _ffn_block(cfg, lp, x, mesh, moe_data_axes)


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


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, mesh=None,
            remat: bool = True, moe_data_axes=None):
    """tokens: int [B, S] -> (logits bfloat16 [B, S, V_padded], aux float32
    []), the sum of the layers' load-balance losses.  `mesh`: the calling
    rank's (MoE layers expert parallel; the tokens are the rank's);
    `remat` checkpoints each layer (the hybrid: each period) while
    autograd records; `moe_data_axes`: the axes the MoE aux is averaged
    over besides the model axis (default: the mesh's data axes)."""
    _check_decoder(cfg, "forward pass")
    x = params["emb"][tokens].to(DTYPE)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    if cfg.family == "hybrid":
        stack, fn, n = params["periods"], _period, (
            cfg.n_layers // cfg.attn_period)
    else:
        stack, fn, n = params["layers"], _layer, cfg.n_layers
    for i in range(n):
        lp = _index(stack, i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(fn, cfg, lp, x, positions, mesh,
                              moe_data_axes, use_reentrant=False)
        else:
            x, a = fn(cfg, lp, x, positions, mesh, moe_data_axes)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["emb"].T.to(DTYPE), aux

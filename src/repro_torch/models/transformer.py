"""The decoder stack: parameter specs, blocks and the forward pass for the
dense, vlm and MoE families (counterpart of `repro.models.transformer`).

Per-layer parameters are stacked on a leading layer axis, as in the
reference, so its parameter tree carries across as it is
(`params.params_from_numpy`).  The reference scans the stack under
grouped remat (`jax.checkpoint`); the port loops over the layers in
Python (as `serve_step` does) and, with remat while autograd records,
wraps each layer in `torch.utils.checkpoint.checkpoint`: the backward
pass recomputes the layer from its input instead of keeping its
activations, which changes no value.  The jamba hybrid is not ported
(ROADMAP A13).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.pipeline import not_ported
from . import layers as L
from .moe import moe_ffn
from .params import ParamSpec

DTYPE = torch.bfloat16


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


def param_specs(cfg: ArchConfig) -> dict:
    d, l_ = cfg.d_model, cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        layers = {**_attn_specs(cfg, (l_,)), **_ffn_specs(cfg, (l_,))}
    elif cfg.family == "moe":
        layers = {**_attn_specs(cfg, (l_,)), **_moe_specs(cfg, (l_,))}
    else:
        raise not_ported(f"the {cfg.family} family's parameters",
                         "ROADMAP A13")
    return {
        "emb": ParamSpec((cfg.padded_vocab, d), DTYPE, ("vocab", "embed")),
        "final_norm": ParamSpec((d,), torch.float32, (None,), -1.0),
        "layers": layers,
    }


def _attention(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True):
    """The attention sublayer over a whole sequence, with its residual:
    x [B, S, D] -> x + wo(flash_attention(rope(q), rope(k), v))."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (hx @ p["wq"]).reshape(b, s, h, hd)
    kv = (hx @ p["wkv"]).reshape(b, s, 2, g, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    cos, sin = L.rope_tables(positions, hd if cfg.rope == "full" else hd // 2)
    q = L.apply_rope(q, cos, sin, cfg.rope)
    k = L.apply_rope(k, cos, sin, cfg.rope)
    k = L.repeat_kv(k, cfg.group_size)
    v = L.repeat_kv(v, cfg.group_size)
    o = L.flash_attention(q, k, v, causal=causal)
    return x + o.reshape(b, s, h * hd) @ p["wo"]


def _ffn_block(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh=None):
    """The FFN sublayer with its residual: (x + ffn(rms_norm(x)), aux),
    through the experts where the layer has a router (aux is their
    load-balance loss, a 0-d tensor; else the number 0.0, which launches
    nothing in the decode step)."""
    hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "router" in p:
        y, aux = moe_ffn(hx, p["router"], p["w1"], p["w3"], p["w2"],
                         top_k=cfg.moe_top_k, mesh=mesh, act=cfg.act)
        return x + y, aux
    y = L.ffn(hx, p["w1"], p.get("w3"), p["w2"], cfg.act)
    return x + y, 0.0


def _layer(cfg: ArchConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor):
    """One decoder layer: (x after attention and FFN, its aux loss)."""
    x = _attention(cfg, lp, x, positions)
    return _ffn_block(cfg, lp, x)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, mesh=None,
            remat: bool = True, moe_data_axes=None):
    """tokens: int [B, S] -> (logits bfloat16 [B, S, V_padded], aux float32
    []), the sum of the layers' load-balance losses.  `mesh` must be None
    (one card); `remat` checkpoints each layer while autograd records;
    `moe_data_axes` is the reference's and changes nothing here."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise not_ported(f"the {cfg.family} family's forward pass",
                         "ROADMAP A13")
    if mesh is not None:
        raise ValueError("the port runs on one card: mesh must be None")
    x = params["emb"][tokens].to(DTYPE)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    lay = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in lay.items()}
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(_layer, cfg, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, lp, x, positions)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["emb"].T.to(DTYPE), aux

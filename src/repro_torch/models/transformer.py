"""The decoder stack's parameter specs and its dense FFN block (counterpart
of the parts of `repro.models.transformer` that serving reads).

Per-layer parameters are stacked on a leading layer axis, as in the
reference, so its parameter tree carries across as it is
(`params.params_from_numpy`).  The dense and vlm families share their
specs; the others, and `forward`/`loss_fn`/`flash_attention`, are not
ported yet (ROADMAP A13).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.pipeline import not_ported
from . import layers as L
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


def param_specs(cfg: ArchConfig) -> dict:
    d, l_ = cfg.d_model, cfg.n_layers
    if cfg.family not in ("dense", "vlm"):
        raise not_ported(f"the {cfg.family} family's parameters",
                         "ROADMAP A13")
    return {
        "emb": ParamSpec((cfg.padded_vocab, d), DTYPE, ("vocab", "embed")),
        "final_norm": ParamSpec((d,), torch.float32, (None,), -1.0),
        "layers": {**_attn_specs(cfg, (l_,)), **_ffn_specs(cfg, (l_,))},
    }


def _ffn_block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN sublayer with its residual: x + ffn(rms_norm(x))."""
    hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.ffn(hx, p["w1"], p.get("w3"), p["w2"], cfg.act)

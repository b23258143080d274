"""The xLSTM model stack: pairs of an mLSTM and an sLSTM block, each
behind an RMSNorm with a residual (counterpart of
`repro.models.xlstm_stack`).

Per-pair parameters are stacked on a leading pair axis, as in the
reference, so its tree carries across as it is.  The reference scans the
pairs (under remat); the port loops over them in Python and, while
autograd records, wraps each pair in `torch.utils.checkpoint`.  The cache
is the recurrent state, O(1) in the context; `serve_step` writes it in
place and returns it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.pipeline import resolve_device
from . import layers as L
from .params import ParamSpec
from .transformer import DTYPE
from .xlstm import (MASK, mlstm_block, mlstm_params_shape, slstm_block,
                    slstm_params_shape)


def param_specs(cfg: ArchConfig) -> dict:
    pairs = cfg.n_layers // 2
    d = cfg.d_model

    def from_shapes(shapes, lead):
        ax = tuple(None for _ in lead)
        out = {}
        for name, (shape, dt) in shapes.items():
            # the reference's axis names: the last wide dim is "mlp"
            axes = [None] * len(shape)
            for i in range(len(shape) - 1, -1, -1):
                if shape[i] in (2 * d, 4 * 2 * d, 3 * 2 * d, 8 * d):
                    axes[i] = "mlp"
                    break
            out[name] = ParamSpec(lead + shape, dt, ax + tuple(axes))
        return out

    return {
        "emb": ParamSpec((cfg.padded_vocab, d), DTYPE, ("vocab", "embed")),
        "final_norm": ParamSpec((d,), torch.float32, (None,), -1.0),
        "m_norm": ParamSpec((pairs, d), torch.float32, (None, None), -1.0),
        "s_norm": ParamSpec((pairs, d), torch.float32, (None, None), -1.0),
        "mlstm": from_shapes(mlstm_params_shape(d, cfg.n_heads, DTYPE),
                             (pairs,)),
        "slstm": from_shapes(slstm_params_shape(d, cfg.n_heads, DTYPE),
                             (pairs,)),
    }


def _pair_params(params: dict, i: int) -> dict:
    return {"mlstm": {k: v[i] for k, v in params["mlstm"].items()},
            "slstm": {k: v[i] for k, v in params["slstm"].items()},
            "m_norm": params["m_norm"][i], "s_norm": params["s_norm"][i]}


def _pair(cfg: ArchConfig, pp: dict, h, m_state=None, s_state=None):
    hn = L.rms_norm(h, pp["m_norm"], cfg.norm_eps)
    y, m_state = mlstm_block(pp["mlstm"], hn, cfg.n_heads, state=m_state)
    h = h + y
    hn = L.rms_norm(h, pp["s_norm"], cfg.norm_eps)
    y, s_state = slstm_block(pp["slstm"], hn, cfg.n_heads, state=s_state)
    return h + y, m_state, s_state


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, mesh=None,
            remat: bool = True):
    """tokens int [B, S] -> (logits bfloat16 [B, S, V_padded], aux 0.0).
    With a mesh (the calling rank's) every layer runs replicated on the
    rank: the family has no experts."""
    x = params["emb"][tokens].to(DTYPE)
    for i in range(cfg.n_layers // 2):
        pp = _pair_params(params, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda p, h: _pair(cfg, p, h)[0], pp, x,
                           use_reentrant=False)
        else:
            x = _pair(cfg, pp, x)[0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["emb"].T.to(DTYPE)
    return logits, torch.zeros((), device=logits.device)


def make_cache(cfg: ArchConfig, batch: int, _seq: int, *, device="cuda"):
    """The recurrent state in place of a KV cache, float32, stacked over
    the pairs: {"m": (C, n, m), "s": (c, n, h, m)} (m starts at -1e30, the
    sLSTM's n at 1)."""
    dev = resolve_device(device)
    pairs, h = cfg.n_layers // 2, cfg.n_heads
    dh = 2 * cfg.d_model // h
    z = lambda *s: torch.zeros((pairs, batch, h) + s, device=dev)
    return {
        "m": (z(dh, dh), z(dh),
              torch.full((pairs, batch, h), MASK, device=dev)),
        "s": (z(dh), torch.ones((pairs, batch, h, dh), device=dev), z(dh),
              z(dh)),
    }


def serve_step(cfg: ArchConfig, params: dict, cache: dict, tokens, pos,
               mesh=None, kv_cfg=None):
    """One token: tokens int [B, 1] -> (logits float32 [B, V_padded],
    cache), the state written in place (`pos` and `kv_cfg` are the
    reference's signature; the state needs neither; a mesh changes
    nothing)."""
    x = params["emb"][tokens].to(DTYPE)
    for i in range(cfg.n_layers // 2):
        m_state = tuple(t[i] for t in cache["m"])
        s_state = tuple(t[i] for t in cache["s"])
        x, m_new, s_new = _pair(cfg, _pair_params(params, i), x, m_state,
                                s_state)
        for old, new in zip(m_state + s_state, m_new + s_new):
            old.copy_(new)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["emb"].T.to(DTYPE))[:, 0].to(torch.float32)
    return logits, cache

"""The decode path's layers, as plain functions on tensors (counterpart of
`repro.models.layers`: `rms_norm`, `rope_tables`, `apply_rope`, `ffn`,
`decode_attention`, `trunc_init`, `NEG_BIG`).

The reference writes them as global math with sharding constraints at a
few seams (`ShardCtx`); on one card those constraints are the identity,
so the port has none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import _trunc_normal_

NEG_BIG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions: int [...]; returns (cos, sin) float32 [..., dim / 2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(torch.full_like(exps, base), exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos, sin, mode: str = "full"):
    """x: [B, S, H, hd]; cos/sin: [B or 1, S, rot / 2].  'full' rotates the
    whole head dim; 'partial' (chatglm3's 2d-RoPE) only its first half;
    'none' is the identity."""
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    c = cos[..., None, :].to(x.dtype)            # [B, S, 1, rot / 2]
    s = sin[..., None, :].to(x.dtype)
    y = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([y, xp], dim=-1) if mode == "partial" else y


def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token GQA decode: q [B, 1, H, hd]; caches [B, S, G, hd];
    lengths int [B].  Grouped einsum, no KV repeat."""
    b, _, h, hd = q.shape
    s, g = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, g, h // g, hd)
    scores = torch.einsum("bgqd,bsgd->bgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) / (hd ** 0.5)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_BIG, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqs,bsgd->bgqd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def ffn(x, w1, w3, w2, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(x @ w1) * (x @ w3)
    else:                                        # gelu (whisper)
        h = F.gelu(x @ w1, approximate="tanh")
    return h @ w2


def trunc_init(generator: torch.Generator, shape, dtype, scale=0.02):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return (_trunc_normal_(t, generator) * scale).to(dtype)

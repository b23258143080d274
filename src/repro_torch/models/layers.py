"""The model layers, as plain functions on tensors (counterpart of
`repro.models.layers`: `rms_norm`, `layer_norm`, `rope_tables`,
`apply_rope`, `repeat_kv`, `flash_attention`, `decode_attention`,
`chunked_scan`, `ffn` (its "gelu" is the tanh form, as the reference's
`jax.nn.gelu(approximate=True)`), `trunc_init`, `NEG_BIG`).

The reference writes them as global math with sharding constraints at a
few seams (`ShardCtx`); on one card those constraints are the identity,
so the port has none.  The reference's remat (`jax.checkpoint`) is
`transformer.forward`'s per-layer `torch.utils.checkpoint` here, which
changes no value; autograd differentiates `flash_attention` through its
block loops (the reference's `jax.grad` through its scans).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .params import _trunc_normal_

NEG_BIG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    """LayerNorm with bias (whisper): float32 mean and variance, rsqrt(var
    + eps), then w and b in float32; cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, -1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


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


def repeat_kv(kv: torch.Tensor, group_size: int) -> torch.Tensor:
    """[B, S, G, hd] -> [B, S, G * group_size, hd] (each KV head repeated
    for its query heads, in place order)."""
    if group_size == 1:
        return kv
    b, s, g, hd = kv.shape
    return kv[:, :, :, None, :].expand(b, s, g, group_size, hd).reshape(
        b, s, g * group_size, hd)


def _pick(n: int, target: int) -> int:
    """The largest divisor of n that is <= target (the reference's block
    rule: 1500 frames give blocks of 500)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024):
    """Online-softmax blocked attention over the reference's blocks.

    q: [B, Sq, H, hd]; k, v: [B, Skv, H, hd] (GQA repeat done by the
    caller).  Blocks of `_pick(Sq, q_block)` queries and `_pick(Skv,
    kv_block)` keys; per block the scores are float32 products of the
    bfloat16 inputs, scaled by 1/sqrt(hd) and set to NEG_BIG where the key
    lies after the query (every block is masked and computed, as the
    reference computes them); m, l and acc are float32, and p is cast to
    v's dtype before p v, whose products accumulate in float32.  Returns
    [B, Sq, H, hd] in q's dtype."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    qb, kb = _pick(sq, q_block), _pick(skv, kv_block)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    neg = torch.full((), NEG_BIG, device=dev)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    rows = torch.arange(qb, device=dev)[:, None]
    cols = torch.arange(kb, device=dev)[None, :]
    for qi in range(sq // qb):
        q_blk = q[:, qi * qb:(qi + 1) * qb].to(torch.float32)
        q_blk = q_blk.permute(0, 2, 1, 3)                   # [b, h, qb, hd]
        m = torch.full((b, h, qb), NEG_BIG, device=dev)
        l_ = torch.zeros((b, h, qb), device=dev)
        acc = torch.zeros((b, h, qb, hd), device=dev)
        for ki in range(skv // kb):
            k_blk = k[:, ki * kb:(ki + 1) * kb].to(torch.float32)
            v_blk = v[:, ki * kb:(ki + 1) * kb]
            s = torch.matmul(q_blk, k_blk.permute(0, 2, 3, 1)) * scale
            if causal:
                ok = (ki * kb + cols) <= (qi * qb + rows)      # [qb, kb]
                s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l_ = l_ * alpha + p.sum(-1)
            pv = torch.matmul(p.to(v_blk.dtype).to(torch.float32),
                              v_blk.to(torch.float32).permute(0, 2, 1, 3))
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / l_[..., None]
        out[:, qi * qb:(qi + 1) * qb] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


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


def chunked_scan(step, carry: tuple, xs, chunk: int = 64,
                 remat: bool = True):
    """A scan over time in chunks: step(carry, x_t) -> (carry, y_t) for t
    in order; returns (carry, ys stacked on a leading T axis).  carry is a
    tuple of tensors; xs a tensor [T, ...], or a tuple of them (the
    reference's pytree), and x_t is then the tuple of their slices at t.
    The chunk is min(chunk, T), or 1 where it does not divide T (the
    reference's rule).  While autograd records (and remat), each chunk
    runs under `torch.utils.checkpoint`: the backward pass keeps the carry
    only at chunk boundaries and replays the steps inside, which changes
    no value."""
    one = torch.is_tensor(xs)
    xs = (xs,) if one else tuple(xs)
    n_x, t = len(xs), xs[0].shape[0]
    chunk = min(chunk, t)
    if t % chunk:
        chunk = 1

    def run(*args):
        xc, c = args[:n_x], args[n_x:]
        ys = []
        for i in range(xc[0].shape[0]):
            c, y = step(c, xc[0][i] if one else tuple(a[i] for a in xc))
            ys.append(y)
        return (*c, torch.stack(ys))

    ys = []
    for start in range(0, t, chunk):
        xc = tuple(a[start:start + chunk] for a in xs)
        if remat and torch.is_grad_enabled():
            *carry, y = checkpoint(run, *xc, *carry, use_reentrant=False)
        else:
            *carry, y = run(*xc, *carry)
        carry = tuple(carry)
        ys.append(y)
    return carry, torch.cat(ys)


class _Silu(torch.autograd.Function):
    """`jax.nn.silu` as XLA runs it, every op rounded to x's dtype: s = 1 /
    (1 + exp(-x)), y = x s; the gradient g s + (g x)(s (1 - s)), the
    transpose of `lax.logistic`'s JVP rule."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """The reference's silu bit for bit (in bfloat16 `F.silu` rounds once
    and differs in the last bit on about a third of the values)."""
    return _Silu.apply(x)


def ffn(x, w1, w3, w2, act: str = "swiglu"):
    if act == "swiglu":
        h = silu(x @ w1) * (x @ w3)
    else:                                        # gelu (whisper)
        h = F.gelu(x @ w1, approximate="tanh")
    return h @ w2


def trunc_init(generator: torch.Generator, shape, dtype, scale=0.02):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return (_trunc_normal_(t, generator) * scale).to(dtype)

"""xLSTM blocks (arXiv:2405.04517), counterpart of `repro.models.xlstm`:
the mLSTM (matrix memory, chunkwise-parallel for a sequence, the exact
sequential step for one token) and the sLSTM (scalar memory, a true
recurrence through `layers.chunked_scan`), both with exponential gating
and log-domain stabilizers.

The state tuples are the family's cache: (C [B, H, dh, dh], n [B, H, dh],
m [B, H]) for the mLSTM, (c, n, h, m) [B, H, dh] for the sLSTM, all
float32.  As in the reference, q/k/v and the sLSTM's input projections
stay bfloat16 and are cast to float32 per step or chunk; every product of
the recurrences runs in float32; m starts at -1e30 and masked decay
weights are -1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import chunked_scan, silu

MASK = -1e30


def mlstm_params_shape(d_model: int, n_heads: int, dtype) -> dict:
    di = 2 * d_model
    return {
        "up_proj": ((d_model, 2 * di), dtype),
        "qkv": ((di, 3 * di), dtype),
        "gates": ((di, 3 * n_heads), dtype),   # i, f, o per head
        "down_proj": ((di, d_model), dtype),
    }


def slstm_params_shape(d_model: int, n_heads: int, dtype) -> dict:
    di = 2 * d_model
    dh = di // n_heads
    return {
        "up_proj": ((d_model, 2 * di), dtype),
        "wx": ((di, 4 * di), dtype),           # z, i, f, o from the input
        "rh": ((n_heads, dh, 4 * dh), dtype),  # block-diagonal recurrence
        "down_proj": ((di, d_model), dtype),
    }


def _mlstm_step(carry, inp):
    """One exact step: carry (C, n, m), inp (q, k, v [B, H, dh], ig, fg
    [B, H]; fg already log-sigmoid) -> (carry, h [B, H, dh])."""
    c, n, m = carry
    q, k, v, ig, fg = inp
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    m_new = torch.maximum(fg + m, ig)            # log-domain stabilizer
    i_ = torch.exp(ig - m_new)
    f_ = torch.exp(fg + m - m_new)
    c = f_[..., None, None] * c + i_[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                          torch.exp(-m_new))
    h = torch.einsum("bhij,bhj->bhi", c, q) / denom[..., None]
    return (c, n, m_new), h


def _mlstm_chunk(qc, kc, vc, ic, fc, c_hat, n_hat, m_in):
    """One chunk of the chunkwise form: q/k/v [B, L, H, dh], gates [B, L,
    H] -> (h [B, L, H, dh], the state at the chunk's end)."""
    chunk = qc.shape[1]
    qc = qc.to(torch.float32).transpose(1, 2)              # [B, H, L, dh]
    kc = kc.to(torch.float32).transpose(1, 2)
    vc = vc.to(torch.float32).transpose(1, 2)
    ic = ic.transpose(1, 2)                                # [B, H, L]
    fc = fc.transpose(1, 2)

    cum = torch.cumsum(fc, dim=-1)                         # inclusive
    a = cum + m_in[..., None]                              # decayed state
    bmat = cum[..., :, None] - cum[..., None, :] + ic[..., None, :]
    mask = torch.ones((chunk, chunk), device=qc.device).tril() > 0
    bmat = torch.where(mask, bmat, torch.full((), MASK, device=qc.device))
    m_i = torch.maximum(a, bmat.amax(-1))                  # [B, H, L]
    d = torch.exp(bmat - m_i[..., None])                   # decay weights
    scores = torch.einsum("bhid,bhjd->bhij", qc, kc)
    intra = torch.einsum("bhij,bhjd->bhid", d * scores, vc)
    decay = torch.exp(a - m_i)[..., None]
    inter = torch.einsum("bhde,bhie->bhid", c_hat, qc) * decay
    n_i = torch.einsum("bhij,bhjd->bhid", d, kc) + n_hat[:, :, None] * decay
    denom = torch.maximum(torch.einsum("bhid,bhid->bhi", n_i, qc).abs(),
                          torch.exp(-m_i))
    h = (intra + inter) / denom[..., None]                 # [B, H, L, dh]

    a_l = cum[..., -1] + m_in                              # [B, H]
    b_l = cum[..., -1:] - cum + ic                         # [B, H, L]
    m_out = torch.maximum(a_l, b_l.amax(-1))
    w = torch.exp(b_l - m_out[..., None])
    scale = torch.exp(a_l - m_out)
    c_hat = (c_hat * scale[..., None, None]
             + torch.einsum("bhj,bhjd,bhje->bhde", w, vc, kc))
    n_hat = n_hat * scale[..., None] + torch.einsum("bhj,bhjd->bhd", w, kc)
    return h.transpose(1, 2), c_hat, n_hat, m_out


def _mlstm_chunkwise(q, k, v, ig, fg, state, chunk: int = 64):
    """The chunkwise-parallel mLSTM (the xLSTM training form): q/k/v [B,
    T, H, dh] (k pre-scaled), ig/fg [B, T, H] (fg already log-sigmoid),
    state (C_hat, n_hat, m).  The chunk is halved until it divides T.
    While autograd records, each chunk runs under `torch.utils.checkpoint`
    (the reference's `jax.checkpoint`).  Returns (h [B, T, H, dh], state)."""
    t = q.shape[1]
    while t % chunk:
        chunk //= 2
    c_hat, n_hat, m = state
    hs = []
    for s in range(0, t, chunk):
        args = tuple(a[:, s:s + chunk] for a in (q, k, v, ig, fg))
        if torch.is_grad_enabled():
            h, c_hat, n_hat, m = checkpoint(_mlstm_chunk, *args, c_hat,
                                            n_hat, m, use_reentrant=False)
        else:
            h, c_hat, n_hat, m = _mlstm_chunk(*args, c_hat, n_hat, m)
        hs.append(h)
    return torch.cat(hs, dim=1), (c_hat, n_hat, m)


def mlstm_block(p: dict, x: torch.Tensor, n_heads: int, state=None):
    """x [B, T, D] -> (y [B, T, D], state): the chunkwise form for a
    sequence, the exact sequential step at T = 1 (decode)."""
    b, t, _ = x.shape
    u, z = (x @ p["up_proj"]).chunk(2, dim=-1)             # [B, T, Di]
    di = u.shape[-1]
    dh = di // n_heads
    qkv = (u @ p["qkv"]).reshape(b, t, 3, n_heads, dh)     # bf16
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k = k / torch.tensor(dh ** 0.5, dtype=k.dtype, device=k.device)
    gates = (u @ p["gates"]).reshape(b, t, 3, n_heads).to(torch.float32)
    ig, fg = gates[:, :, 0], F.logsigmoid(gates[:, :, 1])
    og = torch.sigmoid(gates[:, :, 2])

    if state is None:
        dev = x.device
        state = (torch.zeros((b, n_heads, dh, dh), device=dev),
                 torch.zeros((b, n_heads, dh), device=dev),
                 torch.full((b, n_heads), MASK, device=dev))
    if t == 1:
        state, h = _mlstm_step(state, (q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                       fg[:, 0]))
        h = h[:, None]                                     # [B, 1, H, dh]
    else:
        h, state = _mlstm_chunkwise(q, k, v, ig, fg, state)
    h = (h * og[..., None]).reshape(b, t, di).to(x.dtype)
    y = h * silu(z)
    return y @ p["down_proj"], state


def slstm_block(p: dict, x: torch.Tensor, n_heads: int, state=None):
    """Scalar-memory LSTM with a block-diagonal recurrence: x [B, T, D] ->
    (y [B, T, D], (c, n, h, m)), a `chunked_scan` over T in chunks of
    256."""
    b, t, _ = x.shape
    u, zgate = (x @ p["up_proj"]).chunk(2, dim=-1)
    di = u.shape[-1]
    dh = di // n_heads
    wx = (u @ p["wx"]).reshape(b, t, 4, n_heads, dh)       # bf16
    rh = p["rh"].to(torch.float32)

    if state is None:
        dev = x.device
        zeros = torch.zeros((b, n_heads, dh), device=dev)
        state = (zeros, torch.ones((b, n_heads, dh), device=dev), zeros,
                 zeros)

    def step(carry, xt):
        c, n, h, m = carry
        rec = torch.einsum("bhd,hdk->bhk", h, rh).reshape(b, n_heads, 4, dh)
        g = xt.to(torch.float32) + rec.transpose(1, 2)     # [B, 4, H, dh]
        zt = torch.tanh(g[:, 0])
        it = g[:, 1]
        ft = F.logsigmoid(g[:, 2])
        ot = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * zt
        n = f_ * n + i_
        h = ot * c / torch.clamp_min(n, 1.0)
        return (c, n, h, m_new), h

    state, hs = chunked_scan(step, state, wx.transpose(0, 1), chunk=256)
    y = hs.transpose(0, 1).reshape(b, t, di).to(x.dtype)
    y = y * silu(zgate)
    return y @ p["down_proj"], state

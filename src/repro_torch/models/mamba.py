"""Mamba (selective SSM) block, the sub-quadratic half of jamba
(counterpart of `repro.models.mamba`).

The recurrence is the reference's exact sequential scan over time,
through `layers.chunked_scan` (a Python loop over the steps; each chunk
checkpointed while autograd records).  A block's decode state is the
conv tail [B, K-1, Di] (bfloat16) and the SSM state h [B, Di, N]
(float32), which replace the KV cache of its layer.

Where the values follow XLA's rather than torch's defaults:

  * softplus is `jnp.logaddexp(x, 0)` as JAX writes it: max(x, 0) +
    log1p(exp(-|x|)), NaN where x is NaN (`F.softplus` switches to x
    past its threshold of 20);
  * silu is `layers.silu`, rounded op by op as XLA runs it; where the
    reference casts silu(conv) to float32 (dt u), XLA's jit keeps the
    last product unrounded, and so does the port (ROADMAP C-port-10);
  * the step forms da = dt a and the input term from [B, Di] / [B, N]
    slices inside the step, as the reference does (materializing them
    for all T costs B T Di N float32).

XLA's float32 exp differs from torch's in the last bit on some values
(ROADMAP C-port-6), and the recurrence carries such differences
forward, so the block agrees with the reference within a tolerance, not
bit for bit (ROADMAP C-port-10).
"""
from __future__ import annotations

import torch

from .layers import chunked_scan, silu

CONV_K = 4


def mamba_params_shape(d_model: int, d_state: int, dtype) -> dict:
    """{name: (shape, dtype)} of one block (Di = 2 d_model)."""
    di = 2 * d_model
    f32 = torch.float32
    return {
        "in_proj": ((d_model, 2 * di), dtype),
        "conv_w": ((CONV_K, di), f32),
        "a_log": ((di, d_state), f32),
        "d_skip": ((di,), f32),
        "bc_proj": ((di, 2 * d_state), dtype),
        "dt_proj": ((di, di), dtype),
        "dt_bias": ((di,), f32),
        "out_proj": ((di, d_model), dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, i.e. `jnp.logaddexp(x, 0)`."""
    y = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, y)


def _dt_u(dt: torch.Tensor, conv: torch.Tensor) -> torch.Tensor:
    """dt times silu(conv) in float32, as the jitted reference computes
    `dt * u.astype(float32)`: XLA keeps silu's last product (conv times
    its bfloat16 sigmoid) unrounded where it is cast to float32."""
    s = 1 / (1 + torch.exp(-conv))
    return dt * (conv.to(torch.float32) * s.to(torch.float32))


def _ssm_step_factory(a: torch.Tensor):
    """a: [Di, N].  The step of the recurrence, carry (h [B, Di, N],),
    over ([B, Di], [B, N], [B, N], [B, Di]) slices: h = exp(dt a) h +
    (dt u) b; y = h c."""

    def step(carry, inputs):
        (h,), (dt_u, bmat, c, dt) = carry, inputs
        da = dt[..., None] * a
        h = torch.exp(da) * h + dt_u[..., None] * bmat[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, c)
        return (h,), y

    return step


def mamba_block(p: dict, x: torch.Tensor, state=None):
    """x: [B, T, D].  state: (conv_tail [B, K-1, Di], h [B, Di, N]) to go
    on from (decode), or None for zeros (training, prefill).  Returns (y
    [B, T, D], (conv_tail, h)), the state after the last step."""
    b, t, _ = x.shape
    di = p["conv_w"].shape[1]
    n = p["a_log"].shape[1]
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)           # [B, T, Di]

    # causal depthwise conv over time
    tail = (torch.zeros((b, CONV_K - 1, di), dtype=xin.dtype,
                        device=x.device) if state is None else state[0])
    xpad = torch.cat([tail, xin], dim=1)                   # [B, T+K-1, Di]
    conv = sum(xpad[:, i:i + t] * p["conv_w"][i].to(xin.dtype)
               for i in range(CONV_K))
    new_tail = xpad[:, t:]
    u = silu(conv)                                         # [B, T, Di]

    bmat, cmat = (u @ p["bc_proj"]).to(torch.float32).chunk(2, dim=-1)
    dt = softplus((u @ p["dt_proj"]).to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])                             # [Di, N]
    dt_u = _dt_u(dt, conv)

    h0 = (torch.zeros((b, di, n), device=x.device) if state is None
          else state[1])
    (h,), ys = chunked_scan(
        _ssm_step_factory(a), (h0,),
        (dt_u.transpose(0, 1), bmat.transpose(0, 1), cmat.transpose(0, 1),
         dt.transpose(0, 1)))
    y = ys.transpose(0, 1).to(x.dtype)                     # [B, T, Di]
    y = y + u * p["d_skip"].to(x.dtype)
    y = y * silu(z)
    return y @ p["out_proj"], (new_tail, h)

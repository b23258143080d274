"""Mixture-of-Experts FFN (counterpart of `repro.models.moe`): routing,
capacity dispatch, the expert products, and the gather and combine.

Dispatch is the reference's capacity scatter into static [E, C, D]
buffers: the (token, k) pairs in token-major, k-minor order take
position `pos` within their expert (an exclusive one-hot cumsum), those
with pos < C go to slot expert * C + pos, and the rest are dropped (they
land in one extra row that nothing reads).  The expert products are
batched matmuls over all E experts, and each token gathers its k outputs
(a dropped pair gathers zeros) and sums them weighted by its gates.

Two choices keep the port on the reference's values:

  * experts are picked by a stable descending sort of the router
    probabilities, so of tied probabilities the lower expert index wins,
    as in `jax.lax.top_k` (`torch.topk` on the CPU orders ties otherwise;
    the router logits are a bfloat16 product, so ties are common);
  * the k weighted outputs are summed by `torch.sum` over the bfloat16
    tensor, which accumulates in float32 and rounds once, as XLA does.

On one card there is no expert parallelism: `moe_ffn` with a mesh, and
the decode path that runs local experts over a `model` axis
(`moe_ffn_decode_local`), raise (ROADMAP A16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.pipeline import not_ported


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x_flat [N, D] -> (gate_vals float32 [N, K], gate_idx int64 [N, K],
    aux float32 []): the router logits are x_flat @ router_w in x_flat's
    dtype, the gates the top-k softmax probabilities renormalized over k,
    aux the Shazeer load-balance loss E sum_e mean_prob_e token_frac_e / K."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).to(torch.float32)
    return _route_logits(logits, top_k)


def _top_k_experts(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The experts of the k largest probabilities, int64 [N, K], largest
    first and ties to the lower index: a stable descending sort, the order
    `jax.lax.top_k` gives."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        :, :top_k]


def _route_logits(logits: torch.Tensor, top_k: int):
    """`_route` from the router logits float32 [N, E] on."""
    probs = torch.softmax(logits, dim=-1)                       # [N, E]
    gate_idx = _top_k_experts(probs, top_k)
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    e = logits.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(gate_idx, e).to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(me * ce) / top_k
    return gate_vals, gate_idx, aux


def capacity(n: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.0) -> int:
    """Slots per expert for a call over n tokens (at least 1)."""
    return max(1, int(capacity_factor * top_k * n / n_experts))


def dispatch_slots(gate_idx: torch.Tensor, n_experts: int, cap: int):
    """gate_idx [N, K] -> (pos, keep, slot), each [N K] in token-major,
    k-minor order: the pair's position within its expert, whether it fits
    the capacity, and its buffer row (expert * cap + pos, or E cap when
    dropped)."""
    flat = gate_idx.reshape(-1)
    oh = F.one_hot(flat, n_experts).to(torch.int32)            # [N K, E]
    before = torch.cumsum(oh, 0, dtype=torch.int32) - oh
    pos = before.gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos,
                       torch.full_like(flat, n_experts * cap))
    return pos, keep, slot


def moe_ffn_local(x, router_w, w1, w3, w2, *, top_k: int,
                  capacity_factor: float = 1.0, act: str = "swiglu"):
    """x [..., D]; router_w [D, E]; w1/w3 [E, D, F], w2 [E, F, D].
    Returns (out [..., D] in x's dtype, aux float32 [])."""
    orig_shape = x.shape
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    n = x_flat.shape[0]
    e = w1.shape[0]
    cap = capacity(n, e, top_k, capacity_factor)
    gate_vals, gate_idx, aux = _route(x_flat, router_w, top_k)
    _, _, slot = dispatch_slots(gate_idx, e, cap)

    # scatter the (token, k) pairs into the expert buffers; row E cap
    # takes the dropped pairs and is cut off
    xk = x_flat[:, None].expand(n, top_k, d).reshape(n * top_k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xk
    buf = buf[:e * cap].reshape(e, cap, d)
    h = torch.bmm(buf, w1.to(x.dtype))
    if act == "swiglu":
        h = F.silu(h) * torch.bmm(buf, w3.to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, w2.to(x.dtype)).reshape(e * cap, d)

    # gather each pair's output (zeros for a dropped one) and combine
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    y = out_buf[slot].reshape(n, top_k, d)
    y = (y * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(orig_shape), aux


def moe_ffn_decode_local(*args, **kwargs):
    """Expert parallelism over a `model` mesh axis: not on one card."""
    raise not_ported("moe_ffn_decode_local (experts over a model axis)",
                     "ROADMAP A16")


def moe_ffn(x, router_w, w1, w3, w2, *, top_k: int, mesh=None,
            capacity_factor: float = 1.0, act: str = "swiglu",
            data_axes=("data",), model_axis: str = "model"):
    """The global entry point: `moe_ffn_local` on one card (mesh None);
    a mesh (expert parallelism with all-to-alls) raises."""
    if mesh is not None:
        raise not_ported("moe_ffn over a mesh (expert parallelism)",
                         "ROADMAP A16")
    return moe_ffn_local(x, router_w, w1, w3, w2, top_k=top_k,
                         capacity_factor=capacity_factor, act=act)

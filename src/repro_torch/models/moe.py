"""Mixture-of-Experts FFN (counterpart of `repro.models.moe`): routing,
capacity dispatch, the expert products, and the gather and combine.

Dispatch is the reference's capacity scatter into static [E, C, D]
buffers: the (token, k) pairs in token-major, k-minor order take
position `pos` within their expert (an exclusive one-hot cumsum), those
with pos < C go to slot expert * C + pos, and the rest are dropped (they
land in one extra row that nothing reads).  The expert products are
batched matmuls over all E experts, and each token gathers its k outputs
(a dropped pair gathers zeros) and sums them weighted by its gates.

These choices keep the port on the reference's values as XLA compiles
it (a bfloat16 product that the reference casts to float32 is kept in
float32 there: XLA drops the rounding between the two):

  * experts are picked by a stable descending sort of the router
    probabilities, so of tied probabilities the lower expert index wins,
    as in `jax.lax.top_k` (`torch.topk` on the CPU orders ties otherwise);
  * the router logits and each pair's output times its gate stay
    float32, and the k products are summed in float32 and rounded once;
  * the experts' silu is `layers.silu`, rounded op by op as XLA does.

Expert parallelism (`moe_ffn` with a `launch.mesh.Mesh` of the calling
rank): the experts split over the mesh's "model" axis, each rank taking
its block of E / ep experts as a view of the global stacked weights; the
tokens are the rank's own (replicated over "model").  Two paths, as the
reference's:

  * prefill / training (`moe_ffn_local` with `model_axis`): the capacity
    from the global expert count, routing and the scatter into [E, C, D]
    as above, a tiled all-to-all to [E / ep, ep C, D] (every rank's
    tokens for this rank's experts), the three products over the local
    experts, the all-to-all back, and the load-balance loss's pmean over
    every mesh axis;
  * decode (`moe_ffn_decode_local`, a call over one token a row): the
    local experts over all tokens, each output weighted by its token's
    gate where the token chose that expert, summed over the local
    experts, and a float32 psum over "model" cast back (no capacity, so
    no pair drops).

The collectives are `core.axis`'s: `all_to_all`, `psum` and `pmean`,
differentiable (a training forward goes through them).

`moe_ffn_rows` is the vmapped form the engine's batched decode step
takes: every row (one token) its own routing group, as the reference's
`jax.vmap` of the batch-1 step gives.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import silu


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x_flat [N, D] -> (gate_vals float32 [N, K], gate_idx int64 [N, K],
    aux float32 []): the router logits are x_flat @ router_w in x_flat's
    dtype, the gates the top-k softmax probabilities renormalized over k,
    aux the Shazeer load-balance loss E sum_e mean_prob_e token_frac_e / K."""
    logits = x_flat.float() @ router_w.to(x_flat.dtype).float()
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


def _experts(buf, w1, w3, w2, act: str, dtype):
    """The expert products over buffers [E, C, D] -> [E, C, D]."""
    h = torch.bmm(buf, w1.to(dtype))
    if act == "swiglu":
        h = silu(h) * torch.bmm(buf, w3.to(dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2.to(dtype))


def _combine(out_buf, slot, gate_vals, n: int, top_k: int, dtype):
    """Each pair's output from out_buf [R, D] (row R, zeros, for a dropped
    pair), weighted by its gate and summed over k -> [n, D]."""
    d = out_buf.shape[-1]
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    y = out_buf[slot].reshape(n, top_k, d).float()
    return (y * gate_vals[..., None].to(dtype).float()).sum(dim=1).to(dtype)


def moe_ffn_local(x, router_w, w1, w3, w2, *, top_k: int,
                  capacity_factor: float = 1.0, act: str = "swiglu",
                  model_axis=None, all_axes=None):
    """x [..., D] (the rank's tokens); router_w [D, E]; w1/w3 [El, D, F],
    w2 [El, F, D], the rank's El = E / ep experts (all E without
    `model_axis`, a `core.axis` axis of ep ranks).  `all_axes`: the axes
    whose ranks' load-balance losses are averaged.  Returns (out [..., D]
    in x's dtype, aux float32 [])."""
    orig_shape = x.shape
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    n = x_flat.shape[0]
    el = w1.shape[0]
    ep = 1 if model_axis is None else model_axis.size
    e = el * ep
    cap = capacity(n, e, top_k, capacity_factor)
    gate_vals, gate_idx, aux = _route(x_flat, router_w, top_k)
    _, _, slot = dispatch_slots(gate_idx, e, cap)

    # scatter the (token, k) pairs into the expert buffers; row E cap
    # takes the dropped pairs and is cut off
    xk = x_flat[:, None].expand(n, top_k, d).reshape(n * top_k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xk
    buf = buf[:e * cap].reshape(e, cap, d)
    if model_axis is not None:         # -> [El, ep cap, D]: every rank's
        buf = model_axis.all_to_all(buf, 0, 1)    # tokens for my experts
    out_buf = _experts(buf, w1, w3, w2, act, x.dtype)
    if model_axis is not None:         # back to [E, cap, D], my tokens
        out_buf = model_axis.all_to_all(out_buf, 1, 0)
    y = _combine(out_buf.reshape(e * cap, d), slot, gate_vals, n, top_k,
                 x.dtype)
    for ax in all_axes or ():
        aux = ax.pmean(aux)
    return y.reshape(orig_shape), aux


def moe_ffn_decode_local(x, router_w, w1, w3, w2, *, top_k: int, act: str,
                         model_axis):
    """A decode step's few tokens: the rank's El local experts (w1/w3
    [El, D, F], w2 [El, F, D]) over all tokens x [..., D], each output
    weighted by the token's gate where it chose that expert, summed over
    the local experts, then a float32 psum over `model_axis` cast back to
    x's dtype (the reference's float32 psum).  Returns (out, aux)."""
    orig_shape = x.shape
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    el = w1.shape[0]
    gate_vals, gate_idx, aux = _route(x_flat, router_w, top_k)
    e0 = model_axis.axis_index() * el
    xe = x_flat[None].expand(el, *x_flat.shape)                # [El, N, D]
    y_e = _experts(xe, w1, w3, w2, act, x.dtype)              # [El, N, D]
    eids = e0 + torch.arange(el, device=x.device)
    w_ne = torch.sum(gate_vals[None] * (gate_idx[None] == eids[:, None, None]),
                     dim=-1).to(x.dtype)                       # [El, N]
    y = torch.einsum("end,en->nd", y_e, w_ne)
    y = model_axis.psum(y.to(torch.float32)).to(x.dtype)
    return y.reshape(orig_shape), model_axis.pmean(aux)


def moe_ffn_rows(x, router_w, w1, w3, w2, *, top_k: int,
                 act: str = "swiglu"):
    """`moe_ffn_local` of each row of x [R, 1, D] alone (the reference's
    vmap over a batch-1 decode call): a row's one token has K distinct
    experts and takes the one slot (capacity 1) of each, so nothing
    drops; one scatter into [E, R, D], one set of products and one gather
    for all rows.  Returns out [R, 1, D] (the rows' load-balance losses
    are not returned: the decode step discards them)."""
    r, t, d = x.shape
    if t != 1:
        raise ValueError(f"one token a row, got {t}")
    e = w1.shape[0]
    gate_vals, gate_idx, _ = _route(x.reshape(r, d), router_w, top_k)
    slot = (gate_idx * r + torch.arange(r, device=x.device)[:, None]
            ).reshape(-1)                                    # [R K]
    buf = x.new_zeros((e * r, d))
    buf[slot] = x.expand(r, top_k, d).reshape(-1, d)
    out_buf = _experts(buf.reshape(e, r, d), w1, w3, w2, act, x.dtype)
    y = _combine(out_buf.reshape(e * r, d), slot, gate_vals, r, top_k,
                 x.dtype)
    return y.reshape(r, 1, d)


def _expert_block(w: torch.Tensor, axis, n_experts=None) -> torch.Tensor:
    """The rank's block of a stacked expert weight: a view of the global
    [E, ...] (the param sharding's "experts" -> "model"), or w itself
    where it already holds E / size experts of `n_experts` (a rank that
    holds only its block, as `launch.dryrun`'s does)."""
    e = w.shape[0]
    if n_experts is not None and e != n_experts:
        if e * axis.size != n_experts:
            raise ValueError(f"an expert weight of {e} experts is neither "
                             f"the {n_experts} nor a block of them over a "
                             f"model axis of {axis.size}")
        return w
    if e % axis.size:
        raise ValueError(f"{e} experts do not split over a model axis of "
                         f"{axis.size}")
    el = e // axis.size
    return w.narrow(0, axis.rank * el, el)


def moe_ffn(x, router_w, w1, w3, w2, *, top_k: int, mesh=None,
            capacity_factor: float = 1.0, act: str = "swiglu",
            data_axes=("data",), model_axis: str = "model",
            n_experts=None):
    """The global entry point (the reference's): the global weights (w1/w3
    [E, D, F], w2 [E, F, D]) and the calling rank's tokens.  Without a
    mesh, `moe_ffn_local` over every expert; with one (a
    `launch.mesh.Mesh` of the calling rank) expert parallel over its
    `model_axis`, each rank on its block of the experts: a call over one
    token a row (x.shape[-2] == 1) takes the decode path, any other the
    all-to-all path with aux averaged over `data_axes` and the model
    axis.  With `n_experts` given, a rank may hold only its block of the
    experts (E / ep stacked) in place of the global weights."""
    if mesh is None:
        return moe_ffn_local(x, router_w, w1, w3, w2, top_k=top_k,
                             capacity_factor=capacity_factor, act=act)
    axis = mesh.axis(model_axis)
    w1, w3, w2 = (_expert_block(w, axis, n_experts) for w in (w1, w3, w2))
    if x.dim() >= 2 and x.shape[-2] == 1:                 # decode step
        return moe_ffn_decode_local(x, router_w, w1, w3, w2, top_k=top_k,
                                    act=act, model_axis=axis)
    all_axes = [mesh.axis(a) for a in data_axes] + [axis]
    return moe_ffn_local(x, router_w, w1, w3, w2, top_k=top_k,
                         capacity_factor=capacity_factor, act=act,
                         model_axis=axis, all_axes=all_axes)

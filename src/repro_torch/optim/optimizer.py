"""AdamW with float32 master copies beside (possibly bfloat16) params, a
cosine schedule with warmup, and global-norm clipping (counterpart of
`repro.optim.optimizer`).

Every leaf runs in the reference's leaf order (`repro_torch.tree`), and
every expression rounds where the reference's does: a Python float
operand is a float32 scalar, `(1 - b2) * g * g` multiplies left to
right, and the global norm adds the leaves' float32 sums of squares in
leaf order, each summed as the reference's CPU build sums a plane
(`codec.f32_sum`).  XLA's float32 `pow` and `cos` can differ from
torch's in the last bit (ROADMAP C-port-7).

On a rank of the sharded layout the state's mu, nu and master are the
rank's blocks of the params' (the reference's ZeRO layout,
`repro/optim/optimizer.py`); `apply` runs on them as it is, given the
global norm over the ranks (`global_norm(grads, split)`).

The reference's update is pure; so is `apply` unless the caller passes
donate=True (the counterpart of jit's buffer donation): then the new
params and state are written into the given tensors and the given trees
are returned, so the update holds no second copy of the state (a
full-width layer stack's float32 state is 12 bytes a parameter).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import tree as T
from ..core.codec import f32_sum


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    mu: dict               # float32, like params
    nu: dict               # float32, like params
    master: dict           # float32 master copy of params


def _device(tree) -> torch.device:
    flat = T.leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


def init(params, cfg: AdamWConfig) -> OptState:
    zeros = T.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), params)
    # a copy even for float32 leaves: the master never aliases a param
    master = T.tree_map(lambda x: x.to(torch.float32, copy=True), params)
    return OptState(torch.zeros((), dtype=torch.int32,
                                device=_device(params)),
                    zeros, T.tree_map(torch.clone, zeros), master)


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor): linear warmup, then
    a cosine from lr down to min_lr_frac * lr; float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the float32 sum, leaf by leaf in the reference's order, of
    each leaf's sum of squares.

    On a rank's blocks (ZeRO: the gradient's blocks are the params'),
    `split` lists for each leaf in that order the `core.axis` axes that
    split it: the block's sum of squares is psummed over them, so each
    element counts once and a leaf replicated over an axis counts once,
    not once per replica.  Leaves split over the same axes share one
    psum an axis."""
    sums = [f32_sum(x.to(torch.float32).square()) for x in T.leaves(tree)]
    if split is not None:
        groups: dict = {}
        for i, axes in enumerate(split):
            if axes:
                groups.setdefault(tuple(axes), []).append(i)
        for axes, idx in groups.items():
            v = torch.stack([sums[i] for i in idx])
            for ax in axes:
                v = ax.psum(v)
            for j, i in enumerate(idx):
                sums[i] = v[j]
    total = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def _update(g, mu, nu, master, scale, lr, b1c, b2c, cfg: AdamWConfig,
            donate: bool):
    """One leaf's AdamW step: (mu, nu, master) new, or written into the
    given ones with donate.  In-place ops run on temporaries only (and on
    the state with donate); each rounds as the reference's op does."""
    g = g.to(torch.float32) * scale
    mu_new = mu * cfg.b1
    mu_new.add_((1 - cfg.b1) * g)
    gg = (1 - cfg.b2) * g
    gg.mul_(g)
    nu_new = nu * cfg.b2
    nu_new.add_(gg)
    del g, gg
    den = (nu_new / b2c).sqrt_().add_(cfg.eps)
    delta = (mu_new / b1c).div_(den)
    del den
    delta.add_(cfg.weight_decay * master)
    delta.mul_(lr)
    if donate:
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        return mu, nu, master.sub_(delta)
    return mu_new, nu_new, master - delta


def apply(params, grads, state: OptState, cfg: AdamWConfig, *,
          donate: bool = False, norm=None):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).  With
    donate=True the new params and state are the given ones, updated in
    place (`state.step` too).  `norm`: the global norm to clip by (a 0-d
    float32 tensor; default `global_norm(grads)`): on a rank's blocks the
    norm over the ranks (`global_norm(grads, split)`), and the update is
    elementwise, so each block's is the whole update's block."""
    with torch.no_grad():
        step = state.step + 1
        gnorm = global_norm(grads) if norm is None else norm
        clip = torch.full((), cfg.clip_norm, dtype=torch.float32,
                          device=gnorm.device)
        scale = torch.minimum(clip / (gnorm + 1e-9),
                              torch.ones_like(gnorm))
        lr = schedule(step, cfg)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(cfg.b1, stepf)
        b2c = 1 - torch.pow(cfg.b2, stepf)

        flat_g, tdef = T.flatten(grads)
        flat_p = T.leaves(params)
        new_mu, new_nu, new_ma = [], [], []
        for g, mu, nu, ma in zip(flat_g, T.leaves(state.mu),
                                 T.leaves(state.nu),
                                 T.leaves(state.master)):
            a, b, c = _update(g, mu, nu, ma, scale, lr, b1c, b2c, cfg,
                              donate)
            new_mu.append(a)
            new_nu.append(b)
            new_ma.append(c)
        metrics = {"grad_norm": gnorm, "lr": lr}
        if donate:
            for p, m in zip(flat_p, new_ma):
                p.copy_(m)
            state.step.copy_(step)
            return params, state, metrics
        new_p = [m.to(p.dtype) for m, p in zip(new_ma, flat_p)]
        unf = lambda leaves: T.unflatten(tdef, leaves)
        return unf(new_p), OptState(step, unf(new_mu), unf(new_nu),
                                    unf(new_ma)), metrics

"""Parameter specification trees, in torch: one source of truth for shapes,
dtypes and initialization (counterpart of `repro.models.params`).

Each leaf is a `ParamSpec(shape, dtype, axes, init_scale)`; `axes` keeps
the reference's logical axis names (the port runs on one card, where they
name no mesh).  `materialize` draws the port's own weights on the card
(or on the CPU when the caller asks) from a `torch.Generator` on that
device; `params_from_numpy` carries the JAX
package's weights across instead, so both packages can run one model, and
`train_state_from_numpy` its whole training state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    axes: tuple          # logical axis name (or None) per dim
    init_scale: float = 0.02


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """fn over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def _trunc_normal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """t (float32) filled in place with N(0, 1) truncated to [-2, 2]: a
    uniform draw between the two tails' CDF values, through erfinv."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(-2.0, 2.0)


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init_scale == 0.0:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init_scale == -1.0:                  # ones (norm scales)
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = min(spec.init_scale, 1.0 / np.sqrt(max(fan_in, 1)))
    out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
    # one leading slice at a time: a float32 copy of a stacked leaf would
    # be twice the bfloat16 one
    for part in (out if len(spec.shape) >= 3 else (out,)):
        tmp = torch.empty(part.shape, dtype=torch.float32, device=dev)
        part.copy_(_trunc_normal_(tmp, gen).mul_(scale))
        del tmp
    return out


def materialize(tree, generator: torch.Generator, device="cuda"):
    """The spec tree's weights on `device`, drawn from `generator`, which
    must lie on that device: truncated normals (+-2 sigma) times
    min(init_scale, 1/sqrt(fan_in)), ones for init_scale -1, zeros for 0
    (the reference's rule, the port's own random stream)."""
    from ..core.pipeline import resolve_device
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"weights are asked for on {dev}: pass "
                         f"torch.Generator(device={dev.type!r})")
    return tree_map(lambda s: _init_one(s, generator), tree)


def count_params(tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(tree))


def _tensor_from_numpy(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(arr).view(np.int16))
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def params_from_numpy(tree, device="cuda"):
    """The JAX package's parameter tree (numpy or JAX arrays, bfloat16
    leaves included) -> the port's tensors on `device`, bit for bit."""
    from ..core.pipeline import resolve_device
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, dev), tree)


def train_state_from_numpy(state, device="cuda"):
    """The JAX package's training state (params, OptState[, residuals]),
    as numpy or JAX arrays, -> the port's (params, `optim.optimizer.
    OptState`[, residuals]) on `device`, bit for bit.  The reference's
    OptState is any object with `step`, `mu`, `nu` and `master`."""
    from ..optim.optimizer import OptState
    params, ost, *rest = state
    carry = lambda t: params_from_numpy(t, device)
    out = (carry(params),
           OptState(carry(np.asarray(ost.step, dtype=np.int32)),
                    carry(ost.mu), carry(ost.nu), carry(ost.master)))
    return out + tuple(carry(r) for r in rest)

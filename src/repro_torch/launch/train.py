"""Train-step factories and the CLI launcher (counterpart of
`repro.launch.train`).

Two step variants:
  * make_train_step            - the baseline: the whole batch's gradient,
    then AdamW (the reference's full-precision all-reduce is one card's
    sum here).
  * make_train_step_compressed - the paper's technique on the wire: the
    step runs per pod, over a collective axis (`core.axis`), as
    `compression.grads.compressed_mean_tree` does.  Each pod takes its
    rows of the batch, its gradient by `torch.autograd.grad`, and the
    guaranteed-error-bounded compressed mean with error feedback; then
    every pod applies the same AdamW update to its replica, so the
    replicas stay bit-identical.  The state carries a pod-stacked float32
    residual tree (checkpointed: restart-exact).

Under `core.axis.run_threads(p, ...)` the p pods are threads sharing one
card, each with its own replica or (shared_state=True) all holding one
state, which one of them updates; under `DistAxis` each pod is a
process.  Entry points run on the card unless the caller passes
device="cpu".

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-20b \\
      --steps 20 --batch 4 --seq 128 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import tree as T
from ..compression import grads as G
from ..configs import registry
from ..core.pipeline import resolve_device
from ..data.pipeline import DataConfig, TokenPipeline
from ..models import build
from ..optim import optimizer as opt


def _device_of(params) -> torch.device:
    return T.leaves(params)[0].device


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(dev) for k, v in batch.items()}


def value_and_grad(bundle, params, batch: dict, mesh=None,
                   moe_data_axes=None):
    """(loss, (ce, aux)) of `bundle.loss` and its gradient tree, like
    params.  The gradient is `torch.autograd.grad` with respect to
    detached aliases of the params, so no `.grad` field is written: pods
    that share a card (threads) each take their own graph."""
    flat, tdef = T.flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, (ce, aux) = bundle.loss(T.unflatten(tdef, xs), batch, mesh,
                                      moe_data_axes=moe_data_axes)
        gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                 materialize_grads=True)
    return ((loss.detach(), (ce.detach(), torch.as_tensor(aux).detach())),
            T.unflatten(tdef, list(gs)))


def make_train_step(bundle, mesh, opt_cfg: opt.AdamWConfig, *,
                    donate: bool = False):
    """step(state=(params, opt_state), batch) -> (state, metrics).  With
    donate=True the update is written into the state's tensors
    (`optimizer.apply`)."""
    def step(state, batch):
        params, ostate = state
        batch = _to_device(batch, _device_of(params))
        (loss, (ce, aux)), grads = value_and_grad(bundle, params, batch,
                                                  mesh)
        params, ostate, metrics = opt.apply(params, grads, ostate, opt_cfg,
                                            donate=donate)
        metrics.update(loss=loss, ce=ce, aux=aux)
        return (params, ostate), metrics

    return step


def make_train_step_compressed(bundle, mesh, opt_cfg: opt.AdamWConfig,
                               gc_cfg: G.GradCompressionConfig, *,
                               donate: bool = False,
                               shared_state: bool = False):
    """step(state=(params, opt_state, residuals), batch, axis) -> (state,
    metrics), run by every pod of `axis`.

    `batch` is the global batch; pod r takes its rows [r B / p, (r + 1) B
    / p), as the reference's shard_map hands each pod its block.
    `residuals` is the pod-stacked tree (`init_residuals`): pod r reads
    row r.  With donate=False the step is pure, as the reference's: the
    pods' new rows are gathered into a new stacked tree (the reference's
    shard_map assembles it from the pods' blocks).  With donate=True pod
    r writes its new residual into row r in place, leaf by leaf, and no
    second tree is held: every row is new where the pods share the
    tensors (threads), only row r where each pod holds its own copy
    (processes).  The MoE layers see the pod's own tokens
    (moe_data_axes=("data",)).  metrics["loss"] is the pods' mean; "ce"
    and "aux" are the pod's own.

    shared_state=True: the pods are threads that hold one state between
    them (p pods on one card, where p replicas of a full-width state do
    not fit): the pods' means are the same bits, rank 0 applies the
    update in place (it needs donate=True) and the others wait for it;
    every pod returns the one state, and only rank 0's metrics have
    "grad_norm" and "lr"."""
    if shared_state and not donate:
        raise ValueError("shared_state=True updates the one state in "
                         "place: pass donate=True")

    def step(state, batch, axis):
        params, ostate, resid = state
        dev = _device_of(params)
        p, r = axis.size, axis.rank
        batch = _to_device(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % p:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{p} pods")
        per = rows // p
        local = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        row = T.tree_map(lambda t: t[r], resid)
        (loss, (ce, aux)), grads = value_and_grad(
            bundle, params, local, mesh, moe_data_axes=("data",))
        grads, new_row = G.compressed_mean_tree(
            grads, row, gc_cfg, axis, device=dev,
            out=row if donate else None)
        if not donate:
            resid = T.tree_map(axis.all_gather, new_row)
        loss = axis.psum(loss) / p
        metrics = {}
        if r == 0 or not shared_state:
            params, ostate, metrics = opt.apply(params, grads, ostate,
                                                opt_cfg, donate=donate)
        if shared_state:            # the others wait for rank 0's update
            axis.psum(torch.zeros((), device=dev))
        metrics.update(loss=loss, ce=ce, aux=aux)
        return (params, ostate, resid), metrics

    return step


def init_residuals(params, n_pods: int):
    """Pod-stacked error-feedback buffers (float32, checkpointed)."""
    return T.tree_map(lambda x: torch.zeros((n_pods,) + tuple(x.shape),
                                            dtype=torch.float32,
                                            device=x.device), params)


# ---------------------------------------------------------------- CLI ----

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="/tmp/repro-ckpt")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_cfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps)
    ostate = opt.init(params, opt_cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab, args.seq, args.batch))
    step = make_train_step(bundle, None, opt_cfg)

    state = (params, ostate)
    for i in range(args.steps):
        state, metrics = step(state, pipe.batch(i))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
    print("done")


if __name__ == "__main__":
    main()

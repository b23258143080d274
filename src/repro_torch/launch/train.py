"""Train-step factories and the CLI launcher (counterpart of
`repro.launch.train`).

Two step variants:
  * make_train_step            - the baseline: the batch's gradient
    (`micro` slices accumulated in float32, the reference dry-run's
    MICROBATCHES), then AdamW.  On a rank's mesh the batch is the rank's
    rows and the gradient is averaged over the data axes (the
    reference's full-precision all-reduce, which XLA inserts): with whole
    weights each leaf in place (`data_mean`); on the reference's layout
    (the rank's blocks under `param_shardings`: FSDP over the data axes,
    heads / mlp / vocab / experts over "model") through the FSDP
    gather's backward, a reduce-scatter, and a sum over the axes a
    leaf's block is replicated over (`replica_sum`), then AdamW on the
    blocks (ZeRO) clipped by the norm over the ranks.  With one card it
    is that card's sum.
  * make_train_step_compressed - the paper's technique on the wire: the
    step runs per pod, over a collective axis (`core.axis`), as
    `compression.grads.compressed_mean_tree` does.  Each pod takes its
    rows of the batch, its gradient by `torch.autograd.grad`, and the
    guaranteed-error-bounded compressed mean with error feedback; then
    every pod applies the same AdamW update to its replica, so the
    replicas stay bit-identical.  The state carries a pod-stacked float32
    residual tree (checkpointed: restart-exact).  On the layout each pod
    runs on its ranks' blocks (FSDP over "data" inside the pod), and each
    block crosses the wire under its whole leaf's bound.

Under `core.axis.run_threads(p, ...)` the p pods are threads sharing one
card, each with its own replica or (shared_state=True) all holding one
state, which one of them updates; under `DistAxis` each pod is a
process.  Entry points run on the card unless the caller passes
device="cpu".

CLI (an encdec arch also gets a step's stubbed frames, `stub_frames`):
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
from ..core.axis import _tree_sum
from ..models.transformer import param_layout
from .mesh import (batch_shardings_for, data_axes, drop_axis,
                   gather_objects, local_views, on_threads, replicated_axes,
                   run_mesh_threads)


def _device_of(params) -> torch.device:
    return T.leaves(params)[0].device


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(dev) for k, v in batch.items()}


def value_and_grad(bundle, params, batch: dict, mesh=None,
                   moe_data_axes=None, mean_axes=None, *, remat=None,
                   reduce: bool = True):
    """(loss, (ce, aux)) of `bundle.loss` and its gradient tree, like
    params.  The gradient is `torch.autograd.grad` with respect to
    detached aliases of the params, so no `.grad` field is written: pods
    that share a card (threads) each take their own graph.

    With a mesh description (`launch.mesh.Mesh` with no rank axes) the
    forward runs on every rank of the mesh as threads on the params'
    device, the MoE layers expert parallel, each rank on its block of the
    batch's rows over the data axes (the whole batch where they have size
    1); the loss is the mean of the data blocks' losses (each block's
    rank at "model" 0: the tokens are replicated over "model"), and one
    backward over the graph the ranks share (their collectives join it)
    gives the gradient of that mean, each expert's from the rank that
    holds it.  The layers are not rematerialized there: a recomputed
    layer would call a collective inside the backward.

    With a rank's mesh (`mesh.axes` set: thread ranks, `dist_mesh`, or
    `core.axis.MetaAxis` axes in `launch.dryrun`) `batch` is the rank's
    own rows; the loss and the gradient are then averaged over
    `mean_axes` (default: the mesh's data axes), as the reference's train
    step averages the gradient over the devices that split its batch:
      * whole weights (and experts over "model"): each leaf's gradient
        averaged over those axes (`data_mean`);
      * the rank's blocks under `param_shardings` (`ModelBundle.layout`):
        the gradient of the mean loss over the gradient's axes (`mean_axes`
        and "model", whose ranks share the tokens), reaching each block
        through the collectives' backward: the FSDP gather's is the
        reduce-scatter over the data axes.  Then each leaf's gradient is
        summed over the axes of those that its block is replicated over
        (`replica_sum`).  A rank of `dist_mesh` or `MetaAxis` takes the
        backward of its own loss over the count of those ranks, each
        layer rematerialized (the recomputed collectives run again in the
        backward); thread ranks run the layers without remat and one
        backward over the graph they share (`_shared_grad`).
    `reduce=False` returns the rank's metrics and gradient before any sum
    or mean over the ranks (`accumulate` reduces after its slices)."""
    flat, tdef = T.flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]
    tree = T.unflatten(tdef, xs)
    rank_mesh = mesh is not None and mesh.axes is not None
    shard = layout_shardings(bundle, params, mesh) if rank_mesh else None
    threads = shard is not None and on_threads(mesh)
    if remat is None:
        remat = not threads
    with torch.enable_grad():
        if mesh is not None and mesh.axes is None:
            loss, (ce, aux) = _mesh_loss(bundle, tree, batch, mesh,
                                         moe_data_axes)
        else:
            loss, (ce, aux) = bundle.loss(tree, batch, mesh, remat=remat,
                                          moe_data_axes=moe_data_axes)
        if shard is None:
            gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True)
        else:
            axes = grad_axes(mesh, mean_axes)
            if threads:
                gs = _shared_grad(mesh, loss, xs, axes)
            else:
                n = int(np.prod([mesh.sizes[a] for a in axes]))
                gs = torch.autograd.grad(loss / n, xs, allow_unused=True,
                                         materialize_grads=True)
    metrics = (loss.detach(), (ce.detach(), torch.as_tensor(aux).detach()))
    out = (metrics, T.unflatten(tdef, list(gs)))
    if rank_mesh and reduce:
        out = rank_reduce(out, bundle, params, mesh, mean_axes)
    return out


def grad_axes(mesh, mean_axes=None) -> tuple:
    """The axes of more than one rank that a rank's gradient on the layout
    spans, in mesh order: `mean_axes` (default: the data axes), whose
    ranks split the batch, and "model", whose ranks share the tokens."""
    names = data_axes(mesh) if mean_axes is None else tuple(mean_axes)
    return tuple(a for a in mesh.axis_names
                 if (a in names or a == "model") and mesh.sizes[a] > 1)


def layout_shardings(bundle, params, mesh):
    """Each leaf's `Sharding` (in tree order) where `params` are the
    rank's blocks under `param_shardings` on the rank's `mesh`
    (`ModelBundle.layout`), else None (no mesh, or whole weights)."""
    if mesh is None or bundle.layout(params, mesh) is None:
        return None
    return T.leaves(param_layout(bundle.cfg, mesh.shape, mesh.axis_names))


def split_axes(shard, mesh) -> list:
    """For each leaf's `Sharding`, the rank's `core.axis` axes of more
    than one rank that split the leaf."""
    return [[mesh.axis(a) for a in mesh.axis_names
             if a not in replicated_axes(s) and mesh.sizes[a] > 1]
            for s in shard]


def _shared_grad(mesh, loss, xs: list, axes: tuple) -> list:
    """Thread ranks on the layout: the rank's gradient of the mean of the
    data blocks' losses (each block's from its rank at "model" 0, as
    `_mesh_loss` takes it) over its aliases `xs`, from one backward over
    the graph the ranks of `axes` share.  The thread collectives built
    each rank's result from the others' tensors, so that backward reaches
    every rank's blocks (the FSDP gather's reduce-scatter happens in it);
    it runs on the rank at coordinate 0 of every axis while the others
    wait, and no collective waits inside it."""
    every = gather_objects(mesh, axes, (mesh.coords(), loss, xs))
    me = [c for c, _, _ in every].index(mesh.coords())
    lead = None
    if me == 0:
        losses = [l_ for c, l_, _ in every if c.get("model", 0) == 0]
        objective = _tree_sum(losses) / len(losses)
        flat = [x for _, _, xx in every for x in xx]
        gs = torch.autograd.grad(objective, flat, allow_unused=True,
                                 materialize_grads=True)
        k = len(xs)
        lead = [gs[i * k:(i + 1) * k] for i in range(len(every))]
    del every
    return list(gather_objects(mesh, axes, lead)[0][me])


def replica_sum(grads, shard, mesh, axes) -> object:
    """Each leaf's gradient summed over those of `axes` that its block is
    replicated over (`launch.mesh.replicated_axes` of its `Sharding`):
    the norms, the router, a dim its axes do not divide, and the data
    mean of a leaf that the data axes do not split.  Every rank that
    holds the block gets the same sum (the ranks' order).  Returns a new
    tree."""
    flat, tdef = T.flatten(grads)
    out = []
    for g, s in zip(flat, shard):
        for a in replicated_axes(s):
            if a in axes:
                g = mesh.axis(a).psum(g)
        out.append(g)
    return T.unflatten(tdef, out)


def rank_reduce(out, bundle, params, mesh, mean_axes=None):
    """A rank's (metrics, grads) from `value_and_grad(..., reduce=False)`
    reduced over the ranks: on the layout the metrics' mean over
    `mean_axes` and `replica_sum`; with whole weights `data_mean`."""
    shard = layout_shardings(bundle, params, mesh)
    if shard is None:
        return data_mean(out, mesh, mean_axes)
    (loss, (ce, aux)), grads = out
    names = data_axes(mesh) if mean_axes is None else tuple(mean_axes)
    vals = torch.stack([loss, ce, aux.to(loss.dtype)])
    for a in names:
        if a in mesh.axis_names and mesh.sizes[a] > 1:
            vals = mesh.axis(a).pmean(vals)
    return ((vals[0], (vals[1], vals[2])),
            replica_sum(grads, shard, mesh, grad_axes(mesh, mean_axes)))


def sharded_norm(bundle, params, grads, mesh):
    """The global norm of `grads` over the ranks where they are the rank's
    blocks on the layout (`optimizer.global_norm` with each leaf's split
    axes), else None (`optimizer.apply` takes the tree's own)."""
    shard = layout_shardings(bundle, params, mesh)
    if shard is None:
        return None
    return opt.global_norm(grads, split_axes(shard, mesh))


def data_mean(tree, mesh, axes=None):
    """Every tensor leaf of `tree` averaged over the rank mesh's `axes`
    (default: its data axes; an axis of size 1 is skipped), written into
    the leaf in place (one leaf's copy and mean are held at a time): the
    gradient mean of data parallelism on whole weights.  The ranks read a
    copy, so a thread rank that writes its leaf early changes no other's
    mean.  Returns the tree."""
    names = data_axes(mesh) if axes is None else tuple(axes)
    axes_ = [mesh.axis(n) for n in names
             if n in mesh.axis_names and mesh.sizes[n] > 1]
    if axes_:
        for t in T.leaves(tree):
            m = t.clone()
            for ax in axes_:
                m = ax.pmean(m)
            t.copy_(m)
            del m
    return tree


def _mesh_loss(bundle, params, batch: dict, mesh, moe_data_axes):
    """The mean over the data blocks of the loss of a forward on every
    rank of `mesh` (threads), each rank on its block of the rows; ce and
    aux likewise.  The blocks' values are summed pairwise in block order,
    as `pmean` sums."""
    dp = tuple(a for a in data_axes(mesh) if a in mesh.axis_names)
    n_blocks = int(np.prod([mesh.sizes[a] for a in dp])) if dp else 1

    def rank(m):
        rows = batch
        if n_blocks > 1:
            rows = local_views(batch, batch_shardings_for(m, batch),
                               m.coords())
        with torch.enable_grad():
            return bundle.loss(params, rows, m, remat=False,
                               moe_data_axes=moe_data_axes)

    out = run_mesh_threads(mesh.shape, mesh.axis_names, rank)
    if n_blocks == 1:
        return out[0]
    # row-major ranks: the data blocks' ranks at "model" 0, in block order
    per = mesh.size // n_blocks
    firsts = out[::per]

    def mean(vals):
        return _tree_sum([torch.as_tensor(v) for v in vals]) / n_blocks

    return (mean([o[0] for o in firsts]),
            (mean([o[1][0] for o in firsts]), mean([o[1][1] for o in firsts])))


def accumulate(bundle, params, batch: dict, mesh, micro: int, *,
               remat=None):
    """`value_and_grad` over `micro` sequential slices of the batch's rows
    (gradient accumulation): the float32 sum of the slices' gradients
    divided by `micro`, the slices' mean loss (the reference dry-run's
    `MICROBATCHES` scan); then the reduction over a rank mesh's ranks
    (`rank_reduce`: the data mean, or on the layout the replicated
    axes' sums)."""
    if micro == 1:
        return value_and_grad(bundle, params, batch, mesh, remat=remat)
    rows = next(iter(batch.values())).shape[0]
    if rows % micro:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{micro} microbatches")
    per = rows // micro
    rank_mesh = mesh is not None and mesh.axes is not None
    acc, metrics = None, []
    for i in range(micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        m, g = value_and_grad(bundle, params, mb, mesh, remat=remat,
                              reduce=False)
        g = T.tree_map(lambda t: t.to(torch.float32), g)
        if acc is None:
            acc = g
        else:
            flat, tdef = T.flatten(acc)
            acc = T.unflatten(tdef, [a.add_(b) for a, b in
                                     zip(flat, T.leaves(g))])
        metrics.append(m)
        del g
    grads = T.tree_map(lambda t: t / micro, acc)
    loss, ce, aux = (torch.stack(v).mean() for v in zip(
        *[(m[0], m[1][0], m[1][1]) for m in metrics]))
    out = ((loss, (ce, aux)), grads)
    return rank_reduce(out, bundle, params, mesh) if rank_mesh else out


def make_train_step(bundle, mesh, opt_cfg: opt.AdamWConfig, *,
                    donate: bool = False, micro: int = 1, remat=None):
    """step(state=(params, opt_state), batch) -> (state, metrics).  With
    donate=True the update is written into the state's tensors
    (`optimizer.apply`).  micro > 1 accumulates the gradient over that
    many slices of the batch (`accumulate`).  On a rank's mesh `batch` is
    the rank's rows, and the gradient is averaged over the data axes.  On
    the layout (params and opt_state the rank's blocks: ZeRO's) AdamW
    runs on the blocks, clipped by the norm over the ranks
    (`sharded_norm`); thread ranks each hold their own state
    (`launch.mesh.rank_state`: no two write one tensor).  `remat`: each
    layer rematerialized (default: except on thread ranks of the
    layout)."""
    def step(state, batch):
        params, ostate = state
        batch = _to_device(batch, _device_of(params))
        (loss, (ce, aux)), grads = accumulate(bundle, params, batch, mesh,
                                              micro, remat=remat)
        norm = sharded_norm(bundle, params, grads, mesh)
        params, ostate, metrics = opt.apply(params, grads, ostate, opt_cfg,
                                            donate=donate, norm=norm)
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
    row r; or each pod's own row alone (its block under the reference's
    P("pod", ...), `init_residuals(params, 1)`, as a rank of the layout
    holds it).  With donate=False the step is pure, as the reference's:
    the pods' new rows are gathered into a new stacked tree (the
    reference's shard_map assembles it from the pods' blocks; a pod's own
    row stays its own).  With donate=True pod r writes its new residual
    into its row in place, leaf by leaf, and no
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
    "grad_norm" and "lr".

    On the reference's gradcomp layout (`mesh` a rank's ("pod", "data",
    "model") mesh, params the rank's blocks under `param_shardings` with
    "pod" dropped: FSDP over "data" inside each pod, every pod its
    replica) the pod's gradient is `value_and_grad`'s on the pod's
    ("data", "model") mesh, each block is compressed under its whole
    leaf's bound and averaged over the pods block by block
    (`compressed_mean_tree(split=)`), the residual rows are the rank's
    blocks, and AdamW runs on the blocks (the norm over the pod's
    ranks)."""
    if shared_state and not donate:
        raise ValueError("shared_state=True updates the one state in "
                         "place: pass donate=True")

    # a pod's own mesh: the layout's FSDP and the MoE's data mean run
    # over "data" inside the pod; the pods meet only in the compressed mean
    pod_mesh = None if mesh is None else drop_axis(mesh, "pod")

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
        # the pods' stacked rows, or (p > 1) the pod's own row alone: its
        # block under the reference's P("pod", ...)
        n_rows = T.leaves(resid)[0].shape[0]
        if n_rows not in (p, 1):
            raise ValueError(f"residuals of {n_rows} rows for {p} pods")
        own = n_rows < p
        row = T.tree_map(lambda t: t[0 if own else r], resid)
        (loss, (ce, aux)), grads = value_and_grad(
            bundle, params, local, pod_mesh, moe_data_axes=("data",),
            mean_axes=("data",))
        shard = layout_shardings(bundle, params, pod_mesh)
        split = None if shard is None else split_axes(shard, pod_mesh)
        grads, new_row = G.compressed_mean_tree(
            grads, row, gc_cfg, axis, device=dev,
            out=row if donate else None, split=split)
        if not donate:
            resid = T.tree_map(lambda t: t[None] if own
                               else axis.all_gather(t), new_row)
        loss = axis.psum(loss) / p
        metrics = {}
        if r == 0 or not shared_state:
            norm = None if split is None else opt.global_norm(grads, split)
            params, ostate, metrics = opt.apply(params, grads, ostate,
                                                opt_cfg, donate=donate,
                                                norm=norm)
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

def stub_frames(cfg, batch: int, step: int, dev) -> torch.Tensor:
    """The encdec family's stubbed frontend output for one step: N(0, 1)
    bfloat16 [batch, enc_context, d_model] from a `torch.Generator` seeded
    by the step.  The reference draws them with `jax.random.normal` from
    `PRNGKey(step)`, a stream torch cannot reproduce, so the two
    launchers train on other frames."""
    gen = torch.Generator(device=dev).manual_seed(step)
    return torch.randn((batch, cfg.enc_context, cfg.d_model),
                       generator=gen, device=dev).to(torch.bfloat16)


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
        batch = pipe.batch(i)
        if cfg.family == "encdec":
            batch["frames"] = stub_frames(cfg, args.batch, i, dev)
        state, metrics = step(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
    print("done")


if __name__ == "__main__":
    main()

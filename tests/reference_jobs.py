"""The JAX package's side of the port's tests, with no torch: what a test
runs in a process of its own, where importing torch and the port would
cost seconds.

  * `reference_routes`: every expert choice the reference makes;
  * the reduced jamba-1.5-large-398b's STATE weights and tokens
    (`state_weights`, `tokens`), and its reference loss and gradient
    (`hybrid_grads`), which tests/test_torch_hybrid.py runs in two
    processes while its other tests run:

    python tests/reference_jobs.py {f32,bf16} OUT.npz

  * the reference dry-run's layouts (`dryrun_layouts`: every param, batch
    and cache leaf's spec and per-device block on both production meshes,
    compiling nothing; run with XLA_FLAGS=
    --xla_force_host_platform_device_count=512) and the dot FLOPs of two
    jitted steps on one CPU device (`dryrun_flops`), for
    tests/test_torch_dryrun.py:

    python tests/reference_jobs.py {layouts,flops} OUT.json
"""
import contextlib
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import moe as JM
from repro.models import transformer as JT

NAME = "jamba-1.5-large-398b"
JC = JR.get(NAME).reduced()
B = 2
GRAD_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@contextlib.contextmanager
def reference_routes():
    """Record every expert choice the reference makes (its `_route`'s
    gate_idx, in call order, inside jit and scan too) into a list."""
    real, got = JM._route, []

    def route(x_flat, router_w, top_k):
        out = real(x_flat, router_w, top_k)
        jax.debug.callback(lambda gi: got.append(np.asarray(gi)), out[1],
                           ordered=True)
        return out

    JM._route = route
    try:
        yield got
    finally:
        JM._route = real


def state_weights(tree: dict) -> dict:
    """The reference's numpy tree with each Mamba block's a_log, dt_bias,
    conv_w and bc_proj redrawn so that its state reaches the logits
    (tests/test_torch_hybrid.py's docstring says how and why)."""
    m = dict(tree["periods"]["mamba"])
    rng = np.random.default_rng(1)
    n = m["a_log"].shape[-1]
    m["a_log"] = np.broadcast_to(np.log(np.arange(1, n + 1, dtype=np.float32)),
                                 m["a_log"].shape).copy()
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), m["dt_bias"].shape))
    m["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    m["conv_w"] = rng.uniform(-0.5, 0.5, m["conv_w"].shape).astype(np.float32)
    di = m["bc_proj"].shape[-2]
    m["bc_proj"] = (64 / np.sqrt(di) * rng.uniform(-1, 1, m["bc_proj"].shape)
                    ).astype(m["bc_proj"].dtype)
    periods = dict(tree["periods"], mamba=m)
    return dict(tree, periods=periods)


def tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, JC.vocab, shape).astype(
        np.int32)


def reference_init() -> dict:
    """The reference's parameter tree from PRNGKey(0), as numpy."""
    return jax.tree.map(np.asarray,
                        jax.jit(j_build(JC).init)(jax.random.PRNGKey(0)))


def grad_batch() -> dict:
    tok = tokens((B, 33), 13)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def hybrid_grads(name: str, out: str) -> None:
    """`jax.value_and_grad` of the reference's `loss_fn` on the STATE
    weights with the stack (and, for "f32", the weights) in GRAD_DTYPES'
    dtype `name`, jitted, its expert choices recorded: the loss, aux, every
    gradient leaf (as float32) and the choices, saved to `out` (npz)."""
    jdt = GRAD_DTYPES[name]
    jp = jax.tree.map(jnp.asarray, state_weights(reference_init()))
    if name == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    JT.DTYPE = jdt
    jb = {k: jnp.asarray(v) for k, v in grad_batch().items()}
    with reference_routes() as routes:
        (jl, (_, jaux)), jg = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(JC, p, jb["tokens"], jb["labels"],
                                 remat=False), has_aux=True))(jp)
        jax.effects_barrier()
    leaves = {f"g{i}": np.asarray(g.astype(jnp.float32))
              for i, g in enumerate(jax.tree.leaves(jg))}
    np.savez(out, loss=np.float32(jl), aux=np.float32(jaux),
             routes=np.stack(routes), **leaves)


def _spec(ns, ndim: int) -> list:
    """A NamedSharding's spec as a list of ndim entries (None, a name, or
    a list of names)."""
    spec = list(ns.spec) + [None] * (ndim - len(ns.spec))
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _leaves_layout(tree, shardings) -> list:
    return [[_spec(ns, len(a.shape)), list(ns.shard_shape(a.shape))]
            for a, ns in zip(jax.tree.leaves(tree),
                             jax.tree.leaves(shardings))]


def dryrun_layouts(out: str) -> None:
    """{mesh kind: {"params": {arch: leaves}, "cells": {"arch shape":
    {"batch": leaves, "cache": leaves, "cache_kvq": leaves}}}}, each leaf
    [spec, block shape], from the reference dry-run's own
    `_batch_shardings`, `_greedy_sharding` and `mesh.param_shardings` on
    the production meshes (`all_cells`)."""
    from repro.configs.base import SHAPES
    from repro.launch import dryrun as RD
    from repro.launch import mesh as RM

    doc = {}
    for kind in ("single", "multi"):
        mesh = RM.make_production_mesh(multi_pod=kind == "multi")
        params, cells = {}, {}
        for arch in sorted(JR.ARCHS):
            bundle = j_build(JR.get(arch))
            ab = bundle.abstract_params()
            params[arch] = _leaves_layout(
                ab, RM.param_shardings(mesh, bundle.axes(), ab))
        for arch, shape_name in RD.all_cells():
            bundle = j_build(JR.get(arch))
            shape = SHAPES[shape_name]
            rec = {}
            if shape.kind in ("train", "prefill"):
                batch = bundle.input_specs(shape)
                rec["batch"] = _leaves_layout(
                    batch, RD._batch_shardings(mesh, batch))
            else:
                for key, q in (("cache", False), ("cache_kvq", True)):
                    ins = bundle.input_specs(shape, quantized_kv=q)
                    rec[key] = _leaves_layout(ins["cache"], jax.tree.map(
                        lambda s: RD._greedy_sharding(
                            mesh, s, skip_dims=(0,),
                            batch_size=shape.global_batch), ins["cache"]))
                rec["batch"] = _leaves_layout(
                    [ins["tokens"]], [RD._greedy_sharding(mesh,
                                                          ins["tokens"])])
            cells[f"{arch} {shape_name}"] = rec
        doc[kind] = {"params": params, "cells": cells}
    doc["all_cells"] = [list(c) for c in RD.all_cells()]
    doc["microbatches"] = RD.MICROBATCHES
    with open(out, "w") as f:
        json.dump(doc, f)


FLOPS_TRAIN = ("internlm2-20b", 2, 64)      # arch (reduced), batch, seq
FLOPS_DECODE = ("olmoe-1b-7b", 2, 256)      # arch (reduced), batch, cache
FLOPS_HYBRID = (NAME, 2, 256)               # the Mamba scans: 4 chunks


def dryrun_flops(out: str) -> None:
    """`hlo_analysis.dot_flops` of the reference's jitted train step
    (loss, gradient, AdamW), its loss alone and its loss and gradient
    without remat, on the reduced FLOPS_TRAIN, its decode step on the
    reduced FLOPS_DECODE (raw cache), and the loss alone on the reduced
    FLOPS_HYBRID (its scans counted by their trip counts), one CPU
    device."""
    from repro.configs.base import ShapeConfig
    from repro.launch import hlo_analysis
    from repro.optim import optimizer as opt

    name, b, s = FLOPS_TRAIN
    bundle = j_build(JR.get(name).reduced())
    params = bundle.abstract_params()
    opt_cfg = opt.AdamWConfig(total_steps=1000)
    ostate = jax.eval_shape(lambda p: opt.init(p, opt_cfg), params)
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    batch = {"tokens": tok, "labels": tok}

    def train_step(params, ostate, batch):
        (loss, _), grads = jax.value_and_grad(bundle.loss, has_aux=True)(
            params, batch, None)
        params, ostate, _ = opt.apply(params, grads, ostate, opt_cfg)
        return params, ostate, loss

    def flops(fn, *args):
        return int(hlo_analysis.dot_flops(
            jax.jit(fn).lower(*args).compile().as_text()))

    train = flops(train_step, params, ostate, batch)
    forward = flops(lambda p, bt: bundle.loss(p, bt, None), params, batch)
    no_remat = flops(lambda p, bt: jax.value_and_grad(
        lambda q: bundle.loss(q, bt, None, remat=False), has_aux=True)(p),
        params, batch)
    name, b, s = FLOPS_DECODE
    bundle = j_build(JR.get(name).reduced())
    ins = bundle.input_specs(ShapeConfig("flops", s, b, "decode"))

    def serve_step(params, cache, tokens, pos):
        return bundle.serve_step(params, cache, tokens, pos, None)

    decode = flops(serve_step, bundle.abstract_params(), ins["cache"],
                   ins["tokens"], ins["pos"])
    name, b, s = FLOPS_HYBRID
    bundle = j_build(JR.get(name).reduced())
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    hybrid = flops(lambda p, bt: bundle.loss(p, bt, None),
                   bundle.abstract_params(), {"tokens": tok, "labels": tok})
    with open(out, "w") as f:
        json.dump({"train": train, "forward": forward,
                   "no_remat": no_remat, "decode": decode,
                   "hybrid_forward": hybrid}, f)


if __name__ == "__main__":
    job, path = sys.argv[1:]
    if job == "layouts":
        dryrun_layouts(path)
    elif job == "flops":
        dryrun_flops(path)
    else:
        hybrid_grads(job, path)

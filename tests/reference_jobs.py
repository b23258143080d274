"""The JAX package's side of the port's tests, with no torch: what a test
runs in a process of its own, where importing torch and the port would
cost seconds.

  * `reference_routes`: every expert choice the reference makes;
  * the reduced jamba-1.5-large-398b's STATE weights and tokens
    (`state_weights`, `tokens`), and its reference loss and gradient
    (`hybrid_grads`), which tests/test_torch_hybrid.py runs in two
    processes while its other tests run:

    python tests/reference_jobs.py {f32,bf16} OUT.npz
"""
import contextlib
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


if __name__ == "__main__":
    hybrid_grads(*sys.argv[1:])

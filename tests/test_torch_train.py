"""The port's training path against the JAX package's: the tree order
(`repro_torch.tree`), AdamW (`optim.optimizer`), the token pipeline
(`data.pipeline`), `ModelBundle.loss` and its gradients, the
full-precision and the compressed train steps (`launch.train`), the
nested-tree `compressed_mean_tree`, and `params.train_state_from_numpy`.

Tolerances, each from the measured margin:
  * AdamW, run eagerly on numpy trees: with the global norm under the
    clip (scale 1) every leaf of mu, nu, master and params is bit-equal;
    the norm itself is within NORM_ULPS float32 ulps (XLA's CPU build
    sums a multi-dim leaf dimension by dimension in windows of 32, the
    port sums the flattened plane so: ROADMAP C-port-7), and through the
    clip scale that moves each master leaf by at most MASTER_ULPS ulps of
    its largest value; the schedule and the bias corrections within 1 ulp
    (XLA's float32 cos and pow).
  * the loss within LOSS_TOL and each gradient leaf within GRAD_TOL of its
    max |g| (bfloat16 products summed in another order); olmoe with the
    reference's expert choices forced in (ROADMAP C-port-6).
  * the steps' losses within STEP_LOSS_TOL.
  * the compressed mean and residuals, on the gradients the reference's
    own pods computed, bit-equal; the master after the update within
    MASTER_ULPS (the reference's jitted step also fuses its optimizer's
    products into its sums).
  * the port against itself, bit for bit: the donating full-precision
    step against the pure one, and the shared-state compressed step
    (donate=True, one state that rank 0 updates) against the replica
    step.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch import train as JT
from repro.models import build as j_build
from repro.models import transformer as JTR
from repro.optim import optimizer as JO
from repro_torch import tree as T
from repro_torch.compression import grads as TG
from repro_torch.configs import registry as TR
from repro_torch.core.axis import run_threads
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as TT
from repro_torch.models import ModelBundle
from repro_torch.models import build as t_build
from repro_torch.models import moe as TM
from repro_torch.models.params import params_from_numpy, train_state_from_numpy
from repro_torch.optim import optimizer as TO

from test_torch_moe import forced_routes, reference_routes

REPO = Path(__file__).resolve().parents[1]
NORM_ULPS = 16
MASTER_ULPS = 2
LOSS_TOL = 1e-3
GRAD_TOL = 1.5e-2
STEP_LOSS_TOL = 5e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
SEQ, BATCH, STEPS = 32, 4, 3
WIRES = ("grad-wire-8", "grad-wire-16-narrow")


def ordered(a) -> np.ndarray:
    """float32 bits as integers ordered like the values (-0.0 == +0.0)."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a, b) -> int:
    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


def leaf_ulps(a, b) -> float:
    """max |a - b| in float32 ulps of the leaf's largest |a| (elementwise
    ulps blow up near 0, where a weight's update is not)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    top = np.float32(np.abs(a).max())
    return float(np.abs(a - b).max() / np.spacing(top))


def to_np(t) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def bits_equal_trees(a, b) -> bool:
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and bits_equal(to_np(x), to_np(y))
        for x, y in zip(la, lb))


# ------------------------------------------------------------- tree order --

def test_flatten_is_the_reference_order_and_unflatten_keeps_keys():
    tree = ({"w": 1, "b": {"z": 2, "a": 3}, "c": None},
            JO.OptState(4, {"y": 5, "x": 6}, [7, 8], (9,)))
    leaves, tdef = T.flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    back = T.unflatten(tdef, leaves)
    assert back == tree and list(back[0]) == ["w", "b", "c"]
    assert list(back[0]["b"]) == ["z", "a"]
    assert type(back[1]) is JO.OptState
    with pytest.raises(ValueError):
        T.unflatten(tdef, leaves[:-1])


# --------------------------------------------------------------- optimizer --

def opt_tree(rng):
    return {"w": rng.standard_normal((40, 70)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal(300).astype(np.float32),
            "layers": {"x": rng.standard_normal((3, 33, 65)).astype(
                ml_dtypes.bfloat16), "ln": np.ones(65, np.float32)}}


def test_schedule_and_bias_corrections_within_one_ulp():
    jc, tc = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    steps = np.arange(0, 2000, dtype=np.int32)
    j = np.asarray(jax.vmap(lambda s: JO.schedule(s, jc))(steps))
    t = TO.schedule(torch.from_numpy(steps), tc).numpy()
    assert ulps(j, t) <= 1, ulps(j, t)
    for b in (0.9, 0.95):
        # up to 0.9^800, past which XLA's CPU build flushes denormals
        s = steps[1:800].astype(np.float32)
        assert ulps(np.asarray(b ** jnp.asarray(s)),
                    torch.pow(b, torch.from_numpy(s)).numpy()) <= 1


def test_global_norm_within_ulps():
    rng = np.random.default_rng(3)
    for _ in range(4):
        tree = opt_tree(rng)
        j = np.asarray(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
        t = TO.global_norm(params_from_numpy(tree, device="cpu")).numpy()
        assert ulps(j, t) <= NORM_ULPS, ulps(j, t)
    flat = {"a": rng.standard_normal(4097).astype(np.float32),
            "b": rng.standard_normal(300).astype(ml_dtypes.bfloat16)}
    j = np.asarray(JO.global_norm(jax.tree.map(jnp.asarray, flat)))
    t = TO.global_norm(params_from_numpy(flat, device="cpu")).numpy()
    assert bits_equal(j, t)             # 1-d leaves: the same order


@pytest.mark.parametrize("gscale", [1e-3, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("donate", [False, True], ids=["pure", "donate"])
def test_apply_matches_reference(gscale, donate):
    """Six AdamW steps of both packages from one numpy state on the same
    gradients: unclipped every plane bit-equal, clipped within the norm's
    ulps; donate=True gives the same bits in the old tensors."""
    rng = np.random.default_rng(0)
    params = opt_tree(rng)
    jc, tc = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init(jp, jc)
    tp, ts = train_state_from_numpy((params, jax.tree.map(np.asarray, js)),
                                    device="cpu")
    master_id = id(T.leaves(ts.master)[0])
    for _ in range(6):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * gscale
                                    ).astype(p.dtype), params)
        jp, js, jm = JO.apply(jp, jax.tree.map(jnp.asarray, g), js, jc)
        tp, ts, tm = TO.apply(tp, params_from_numpy(g, "cpu"), ts, tc,
                              donate=donate)
        assert int(ts.step) == int(js.step)
        assert bits_equal(np.asarray(jm["lr"]), tm["lr"].numpy())
        assert ulps(jm["grad_norm"], tm["grad_norm"].numpy()) <= NORM_ULPS
        for name in ("mu", "nu", "master"):
            for a, b in zip(jax.tree.leaves(getattr(js, name)),
                            T.leaves(getattr(ts, name))):
                if gscale < 1:
                    assert bits_equal(np.asarray(a), b.numpy()), name
                elif name == "master":
                    assert leaf_ulps(a, b.numpy()) <= MASTER_ULPS
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            if gscale < 1:
                assert bits_equal(np.asarray(a), to_np(b))
    assert (id(T.leaves(ts.master)[0]) == master_id) == donate


# --------------------------------------------------------------- pipeline --

@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (0, 7, 0), (3, 2, 1),
                                            (11, 123, 3)])
def test_token_pipeline_bit_equal(seed, step, host):
    kw = dict(vocab=92544, seq_len=64, global_batch=8, seed=seed,
              n_hosts=4, host_id=host)
    want = JPipe(JDataConfig(**kw)).batch(step)
    got = TokenPipeline(DataConfig(**kw)).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32 and bits_equal(got[k], want[k])


def test_reference_lint_finds_nothing_new_in_the_port(capsys):
    """The reference's layer-1 rules over the port (`python -m
    repro.analysis --no-contracts src/repro_torch`): zero new findings.
    The pipeline's step-keyed seed carries the reference's reasoned GL006
    suppression."""
    from repro.analysis.__main__ import main as analysis_main
    port = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    rc = analysis_main(["--no-contracts", str(port)])
    out = capsys.readouterr().out
    assert rc == 0 and "0 new findings" in out, out


# ---------------------------------------------------------- loss and grads --

CONFIGS = {name: (JR.get(name).reduced(), TR.get(name).reduced())
           for name in ("internlm2-20b", "chatglm3-6b", "olmoe-1b-7b")}


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (name, (jc, tc)) in enumerate(CONFIGS.items()):
        jp = jax.jit(j_build(jc).init)(jax.random.PRNGKey(60 + i))
        out[name] = (jc, tc, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def batch_of(vocab, b=BATCH, s=SEQ, seed=5):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def port_grads(tc, tp, batch, remat=True):
    """(loss, (ce, aux)), grads of the port's loss on a numpy batch."""
    bundle = t_build(tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if remat:
        return TT.value_and_grad(bundle, tp, tb)
    flat, tdef = T.flatten(tp)
    xs = [p.detach().requires_grad_(True) for p in flat]
    loss, (ce, aux) = bundle.loss(T.unflatten(tdef, xs), tb, remat=False)
    return (loss.detach(), (ce.detach(), aux)), T.unflatten(
        tdef, list(torch.autograd.grad(loss, xs)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_reference(models, name, capsys):
    jc, tc, jp, tp = models[name]
    batch = batch_of(jc.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, (jce, jaux)), jg = jax.jit(jax.value_and_grad(
        j_build(jc).loss, has_aux=True))(jp, jb)
    force = None
    if jc.family == "moe":
        with reference_routes() as routes:
            jax.block_until_ready(jax.jit(
                lambda p, t: JTR.forward(jc, p, t, remat=False))(
                    jp, jb["tokens"]))
        # the port's remat replays each layer's routing in the backward
        seq = routes + routes[::-1]
        force = forced_routes(seq)
    real = TM._top_k_experts
    TM._top_k_experts = force or real
    try:
        (tl, (tce, taux)), tg = port_grads(tc, tp, batch)
    finally:
        TM._top_k_experts = real
    if force is not None:
        assert force.calls == len(seq) and force.near_ties()
    d_loss = abs(float(tl) - float(jl))
    assert d_loss <= LOSS_TOL, d_loss
    assert abs(float(taux) - float(jaux)) <= LOSS_TOL
    worst = 0.0
    for a, b in zip(jax.tree.leaves(jg), T.leaves(tg)):
        a = np.asarray(a, np.float32)
        rel = float(np.abs(a - b.float().numpy()).max() / np.abs(a).max())
        worst = max(worst, rel)
    with capsys.disabled():
        print(f"\n{name}: |loss - ref| {d_loss:.3g}, grads {worst:.3g} of "
              f"max |g|")
    assert worst <= GRAD_TOL, worst


@pytest.mark.parametrize("name", ["internlm2-20b", "olmoe-1b-7b"])
def test_remat_changes_no_value(models, name):
    _, tc, _, tp = models[name]
    batch = batch_of(tc.vocab, seed=6)
    (l1, _), g1 = port_grads(tc, tp, batch, remat=True)
    (l0, _), g0 = port_grads(tc, tp, batch, remat=False)
    assert bits_equal(l1.numpy(), l0.numpy())
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        assert torch.equal(a, b)


def test_encdec_and_ssm_loss_raise():
    """encdec and ssm have their loss (tests/test_torch_encdec.py,
    test_torch_xlstm.py); what raises is an encdec batch without its
    frames.  The hybrid's loss runs (tests/test_torch_hybrid.py holds it
    and its gradient against the reference): finite, its aux the MoE
    FFNs' load-balance loss."""
    cfg = TR.get("whisper-base").reduced()
    bundle = t_build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(KeyError, match="frames"):
        bundle.loss(params, {"tokens": tok, "labels": tok})
    hybrid = t_build(TR.get("jamba-1.5-large-398b").reduced())
    hp = hybrid.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        loss, (ce, aux) = hybrid.loss(hp, {"tokens": tok, "labels": tok})
    assert bool(torch.isfinite(loss)) and float(aux) > 0
    assert torch.equal(loss, ce + 0.01 * aux)


# ------------------------------------------------------------- the steps --

STEP_CFG = "internlm2-20b"


@functools.lru_cache(maxsize=1)
def step_inputs():
    """The reduced internlm2-20b's reference weights and the batches (one
    set for the module: JAX arrays are immutable, and the port copies
    what it takes)."""
    jc, tc = CONFIGS[STEP_CFG]
    jp = jax.jit(j_build(jc).init)(jax.random.PRNGKey(0))
    pipe = JPipe(JDataConfig(jc.vocab, SEQ, BATCH, seed=0))
    return jc, tc, jp, [pipe.batch(i) for i in range(STEPS)]


def test_full_precision_step_matches_reference():
    """Three steps of the reference's jitted `make_train_step` and the
    port's from one state: losses within STEP_LOSS_TOL."""
    jc, tc, jp, batches = step_inputs()
    jocfg, tocfg = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    jstep = jax.jit(JT.make_train_step(j_build(jc), None, jocfg))
    jstate = (jp, JO.init(jp, jocfg))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    tstep = TT.make_train_step(t_build(tc), None, tocfg)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        d = abs(float(jm["loss"]) - float(tm["loss"]))
        assert d <= STEP_LOSS_TOL, d
    assert int(tstate[1].step) == STEPS


def test_donating_step_equals_the_pure_step():
    """make_train_step(donate=True) writes the update into the state's
    tensors; three steps of it give the pure step's params and OptState
    bit for bit, and the pure step leaves its input state as it was."""
    jc, tc, jp, batches = step_inputs()
    tocfg = TO.AdamWConfig(**OPT)
    host = jax.tree.map(np.asarray, (jp, JO.init(jp, JO.AdamWConfig(**OPT))))
    pure, start = (train_state_from_numpy(host, device="cpu")
                   for _ in range(2))
    kept = T.tree_map(torch.clone, start)
    donated = T.tree_map(torch.clone, start)
    pure_step = TT.make_train_step(t_build(tc), None, tocfg)
    donating = TT.make_train_step(t_build(tc), None, tocfg, donate=True)
    for b in batches:
        pure, _ = pure_step(pure, b)
        new, _ = donating(donated, b)
        assert all(x is y for x, y in zip(T.leaves(new), T.leaves(donated))
                   if x.dim())
        donated = new
    assert bits_equal_trees(pure, donated)
    pure_step(start, batches[0])
    assert bits_equal_trees(start, kept)


REF_STEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compression.grads import (GradCompressionConfig,
                                         compressed_mean_tree)
    from repro.configs import registry
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.launch import train as RT
    from repro.models import build
    from repro.optim import optimizer as opt

    out, seq, batch, steps = sys.argv[1], *map(int, sys.argv[2:5])
    cfg = registry.get("internlm2-20b").reduced()
    bundle = build(cfg)
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    rep, pod = NamedSharding(mesh, P()), NamedSharding(mesh, P("pod"))
    params = bundle.init(jax.random.PRNGKey(0))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    pipe = TokenPipeline(DataConfig(cfg.vocab, seq, batch, seed=0))

    def specs(t, lead):
        return jax.tree.map(lambda s: P("pod", *(None,) * (s.ndim - 1))
                            if lead else P(*(None,) * s.ndim), t)

    def mapped(fn, leads, out_specs):
        # fn per pod under shard_map; leads[i]: argument i is pod-stacked
        return jax.jit(lambda *a: jax.shard_map(
            fn, mesh=mesh, in_specs=tuple(specs(x, l)
                                          for x, l in zip(a, leads)),
            out_specs=out_specs(a), axis_names={"pod"},
            check_vma=False)(*a))

    stack = lambda t: jax.tree.map(lambda x: x[None], t)
    row = lambda t: jax.tree.map(lambda x: x[0], t)

    # the reference step's two halves, apart, so the per-pod gradients,
    # means and residuals are outputs (pod-stacked): the pod-local
    # gradient (and the pods' mean loss), then the compressed mean
    def local_grads(params, b):
        (loss, _), g = jax.value_and_grad(bundle.loss, has_aux=True)(
            params, b, mesh, moe_data_axes=("data",))
        return jax.lax.pmean(loss, "pod"), stack(g)
    pod_grads = mapped(local_grads, (False, True),
                       lambda a: (P(), specs(a[0], True)))

    def pod_means(gc):
        def local(g, r):
            m, nr = compressed_mean_tree(row(g), row(r), gc, "pod")
            return stack(m), stack(nr)
        return mapped(local, (True, True),
                      lambda a: (specs(a[0], True), specs(a[0], True)))
    apply = jax.jit(lambda p, g, o: opt.apply(p, g, o, ocfg)[:2])

    flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    rec = {}
    for name in ("grad-wire-8", "grad-wire-16-narrow"):
        gc = GradCompressionConfig(eb_rel=2.0 ** -5,
                                   pipeline=registry.get_pipeline(name))
        means_fn = pod_means(gc)
        # grad-wire-8 runs the reference's own jitted step, and its halves
        # at step 1 must give the step's residuals and loss bit for bit;
        # grad-wire-16-narrow runs the halves and AdamW as its step (one
        # compile fewer)
        own = name == "grad-wire-8"
        if own:
            step = jax.jit(RT.make_train_step_compressed(bundle, mesh, ocfg,
                                                         gc))
        state = (params, opt.init(params, ocfg),
                 RT.init_residuals(params, 2))
        state = (jax.device_put(state[0], rep), jax.device_put(state[1], rep),
                 jax.device_put(state[2], pod))
        losses = []
        for i in range(steps):
            b = {k: jax.device_put(jnp.asarray(v), pod)
                 for k, v in pipe.batch(i).items()}
            before = state
            if not own or i == 1:
                loss, g = pod_grads(state[0], b)
                means, nr = means_fn(g, state[2])
            if own:
                state, m = step(state, b)
                if i == 1:
                    assert float(loss) == float(m["loss"])
                    assert all(np.array_equal(a, c) for a, c in
                               zip(flat(nr), flat(state[2])))
                loss = m["loss"]
            else:
                state = (*apply(state[0], row(means), state[1]), nr)
            losses.append(float(loss))
            if i == 1:        # a step with a residual carried in
                for k, v in (("before", before), ("grads", g),
                             ("means", means), ("resid", nr),
                             ("after", state)):
                    for j, a in enumerate(flat(v)):
                        rec[f"{name}/{k}/{j}"] = a
        rec[f"{name}/losses"] = np.array(losses)
    np.savez(out, **{k: (v.view(np.uint16) if v.dtype.name == "bfloat16"
                         else v) for k, v in rec.items()})
""")


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference's compressed step on 2 host devices (its own process:
    the test process holds JAX at 1 device), 3 steps for each wire, with
    step 1's state, per-pod gradients, means and residuals.  Started
    before the module's first test, so its ~25 s overlap the others."""
    out = tmp_path_factory.mktemp("ref") / "steps.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_STEP, str(out),
                             str(SEQ), str(BATCH), str(STEPS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_steps(reference_process):
    out, proc = reference_process
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


def recorded(rec, name, key, like_bf16):
    """A recorded tree's leaves as tensors; bfloat16 where like_bf16[i]."""
    out, j = [], 0
    while f"{name}/{key}/{j}" in rec:
        a = rec[f"{name}/{key}/{j}"]
        t = torch.from_numpy(a.astype(np.int16) if a.dtype == np.uint16
                             else a)
        out.append(t.view(torch.bfloat16) if a.dtype == np.uint16 else t)
        j += 1
    return out


def port_compressed_run(tc, jp, batches, wire, step_fn=None):
    """The port's compressed step, 2 pods as threads, from the reference's
    weights: (losses, final state of pod 0, pods' params equal)."""
    tocfg = TO.AdamWConfig(**OPT)
    gc = TG.GradCompressionConfig(eb_rel=2.0 ** -5,
                                  pipeline=TR.get_pipeline(wire))
    step = step_fn or TT.make_train_step_compressed(t_build(tc), None, tocfg,
                                                    gc)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    state = (params, TO.init(params, tocfg), TT.init_residuals(params, 2))
    losses, same = [], True
    for b in batches:
        outs = run_threads(2, lambda ax: step(state, b, ax))
        same &= all(torch.equal(a, c) for a, c in
                    zip(T.leaves(outs[0][0][0]), T.leaves(outs[1][0][0])))
        state = outs[0][0]
        losses.append(float(outs[0][1]["loss"]))
    return losses, state, same


@pytest.fixture(scope="module")
def replica_runs():
    """The port's compressed step with a replica per pod, each wire."""
    jc, tc, jp, batches = step_inputs()
    return {w: port_compressed_run(tc, jp, batches, w) for w in WIRES}


@pytest.mark.parametrize("wire", WIRES)
def test_compressed_step_losses_match_reference(reference_steps,
                                                replica_runs, wire):
    losses, _, same = replica_runs[wire]
    want = reference_steps[f"{wire}/losses"]
    assert same, "the pods' params differ after a step"
    d = float(np.abs(np.array(losses) - want).max())
    assert d <= STEP_LOSS_TOL, (losses, want)


def test_shared_state_step_equals_the_replica_step(replica_runs):
    """shared_state=True with donate=True (the pods hold one state, which
    rank 0 updates in place; the full-width run on the card takes this
    path): three steps give the replica step's losses, params, OptState
    and residuals bit for bit, and a step that misses the update does
    not; the replica step leaves its input state as it was."""
    jc, tc, jp, batches = step_inputs()
    gc = TG.GradCompressionConfig(eb_rel=2.0 ** -5,
                                  pipeline=TR.get_pipeline(WIRES[0]))
    shared = TT.make_train_step_compressed(
        t_build(tc), None, TO.AdamWConfig(**OPT), gc, donate=True,
        shared_state=True)
    want_losses, want, _ = replica_runs[WIRES[0]]
    losses, state, _ = port_compressed_run(tc, jp, batches, WIRES[0],
                                           step_fn=shared)
    assert losses == want_losses
    assert bits_equal_trees(state, want)

    def missed(state, batch, axis):
        if int(state[1].step) == 1:       # planted: this update is lost
            shared(T.tree_map(torch.clone, state), batch, axis)
            return state, {"loss": torch.zeros(())}
        return shared(state, batch, axis)
    _, state, _ = port_compressed_run(tc, jp, batches, WIRES[0],
                                      step_fn=missed)
    assert not bits_equal_trees(state, want)
    # the replica step (donate=False) leaves the state it was given
    pure = TT.make_train_step_compressed(t_build(tc), None,
                                         TO.AdamWConfig(**OPT), gc)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    start = (params, TO.init(params, TO.AdamWConfig(**OPT)),
             TT.init_residuals(params, 2))
    kept = T.tree_map(torch.clone, start)
    run_threads(2, lambda ax: pure(start, batches[0], ax))
    assert bits_equal_trees(start, kept)


def port_mean_on_reference_grads(rec, wire, drop_residual=False):
    """The port's compressed_mean_tree on the reference pods' step-1
    gradients and residuals: per pod (means, residuals) as leaf lists."""
    gc = TG.GradCompressionConfig(eb_rel=2.0 ** -5,
                                  pipeline=TR.get_pipeline(wire))
    grads = recorded(rec, wire, "grads", None)
    n = len(grads)
    before = recorded(rec, wire, "before", None)
    resid = before[-n:]                      # the state's last n leaves

    def pod(ax):
        g = [t[ax.rank] for t in grads]
        r = [torch.zeros_like(t[ax.rank]) if drop_residual else t[ax.rank]
             for t in resid]
        m, nr = TG.compressed_mean_tree(g, r, gc, ax, device="cpu")
        return m, nr
    return run_threads(2, pod)


@pytest.mark.parametrize("wire", WIRES)
def test_compressed_mean_bit_equal_on_reference_grads(reference_steps, wire):
    """Fed the gradients the reference's pods computed, the port's mean
    and residuals are the reference's bit for bit, and AdamW on that mean
    lands within MASTER_ULPS of the reference's master; a step that drops
    the residual fails the comparison."""
    rec = reference_steps
    means = recorded(rec, wire, "means", None)
    resid = recorded(rec, wire, "resid", None)
    out = port_mean_on_reference_grads(rec, wire)

    def matches(out):
        return all(torch.equal(m, want[r]) and torch.equal(nr, rw[r])
                   for r, (ms, nrs) in enumerate(out)
                   for m, nr, want, rw in zip(ms, nrs, means, resid))
    assert matches(out)
    assert not matches(port_mean_on_reference_grads(rec, wire,
                                                    drop_residual=True))
    # AdamW on the mean, from the reference's state before the step
    before = recorded(rec, wire, "before", None)
    n = len(means)
    jc, tc, jp, _ = step_inputs()
    _, tdef = T.flatten(params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu"))
    params = T.unflatten(tdef, before[:n])
    ost = TO.OptState(before[n], T.unflatten(tdef, before[n + 1:2 * n + 1]),
                      T.unflatten(tdef, before[2 * n + 1:3 * n + 1]),
                      T.unflatten(tdef, before[3 * n + 1:4 * n + 1]))
    _, new, _ = TO.apply(params, T.unflatten(tdef, out[0][0]), ost,
                         TO.AdamWConfig(**OPT))
    after = recorded(rec, wire, "after", None)
    worst = max(leaf_ulps(a.numpy(), b.numpy()) for a, b in
                zip(after[3 * n + 1:4 * n + 1], T.leaves(new.master)))
    assert worst <= MASTER_ULPS, worst


def test_pods_applying_different_means_fail_the_replica_check(
        monkeypatch):
    """A planted fault: pod 1 applies its mean scaled by (1 + 2^-7): the
    pods' replicas part, and the run's replica check catches it."""
    jc, tc, jp, batches = step_inputs()
    real = TG.compressed_mean_tree

    def skew(grads, residuals, cfg, axis, *a, **kw):
        m, r = real(grads, residuals, cfg, axis, *a, **kw)
        if axis.rank == 1:
            m = T.tree_map(lambda t: t * (1 + 2 ** -7), m)
        return m, r
    monkeypatch.setattr(TG, "compressed_mean_tree", skew)
    _, _, same = port_compressed_run(tc, jp, batches[:1], WIRES[0])
    assert not same


def test_compressed_mean_tree_nested_equals_flat():
    """A nested tree gives the flat call's leaves, in the reference's
    order (dict keys sorted), each mean in its leaf's dtype."""
    rng = np.random.default_rng(8)

    def g(*shape, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * 3e-3).astype(
            np.float32)).to(dtype)
    pods = [{"emb": g(64, 40, dtype=torch.bfloat16), "final_norm": g(40),
             "layers": {"wq": g(2, 40, 40, dtype=torch.bfloat16),
                        "ln1": g(2, 40)}} for _ in range(2)]
    res = [T.tree_map(lambda t: torch.full(t.shape, 1e-4), p) for p in pods]
    gc = TG.GradCompressionConfig(eb_rel=2.0 ** -5)

    def nested(ax):
        return TG.compressed_mean_tree(pods[ax.rank], res[ax.rank], gc, ax,
                                       device="cpu")

    def flat(ax):
        return TG.compressed_mean_tree(T.leaves(pods[ax.rank]),
                                       T.leaves(res[ax.rank]), gc, ax,
                                       device="cpu")
    a, b = run_threads(2, nested), run_threads(2, flat)
    for (mn, rn), (mf, rf) in zip(a, b):
        assert list(mn) == ["emb", "final_norm", "layers"]
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(mn), mf))
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(rn), rf))
        assert mn["emb"].dtype == torch.bfloat16
        assert mn["final_norm"].dtype == torch.float32
    # out= writes the new residuals into the given tree
    buf = [T.tree_map(torch.zeros_like, r) for r in res]
    c = run_threads(2, lambda ax: TG.compressed_mean_tree(
        pods[ax.rank], res[ax.rank], gc, ax, device="cpu", out=buf[ax.rank]))
    for r, (_, rn) in enumerate(c):
        assert all(x is y for x, y in zip(T.leaves(rn), T.leaves(buf[r])))
        assert all(torch.equal(x, y) for x, y in
                   zip(T.leaves(buf[r]), T.leaves(a[r][1])))


def test_train_state_from_numpy_bit_for_bit():
    jc, tc, jp, _ = step_inputs()
    jocfg = JO.AdamWConfig(**OPT)
    state = (jp, JO.init(jp, jocfg), JT.init_residuals(jp, 2))
    host = jax.tree.map(np.asarray, state)
    got = train_state_from_numpy(host, device="cpu")
    assert isinstance(got[1], TO.OptState) and got[1].step.dtype == torch.int32
    assert len(T.leaves(got)) == len(jax.tree.leaves(host))
    for a, b in zip(jax.tree.leaves(host), T.leaves(got)):
        assert bits_equal(a, to_np(b))


def test_entry_points_run_on_the_card_unless_asked():
    """Without a card: the CLI raises, and asked for the CPU it trains."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--arch", "internlm2-20b", "--steps", "1"])
    TT.main(["--arch", "internlm2-20b", "--steps", "2", "--batch", "2",
             "--seq", "16", "--device", "cpu"])

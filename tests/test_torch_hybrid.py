"""The port's jamba hybrid (`repro_torch.models.mamba`, the hybrid stack of
`transformer.forward`, `serve._serve_hybrid`, `ModelBundle.make_cache`)
against the JAX package's `repro.models`, on the reduced
jamba-1.5-large-398b (one period of 8 blocks: 7 Mamba + 1 attention, 4
MoE FFNs of 8 experts, top 2; d 128, Di 256, N 8).

Weights.  The reference's tree from PRNGKey(0), carried across by
`params_from_numpy`.  At the reference's init (every matrix at 0.02, A
= -e, dt near 1.3) a Mamba block's output is its skip term u D to within
1e-4, so neither its conv tail nor its SSM state reaches the logits: a
decode step that drops h moves them by less than 1e-6.  The tests
therefore also run on STATE weights: the same tree with four Mamba
leaves of every block redrawn from a numpy seed, A = -(1 .. N) and dt
log-uniform in [1e-3, 1e-1] (Mamba's own init), the conv at Conv1d's
U(-1/2, 1/2) and bc_proj at 64 / sqrt(Di), so that the state carries
across steps and moves the logits (dropping h moves them by ~0.1).

Routing.  The MoE FFNs route, so a near tie can flip between the two
packages (ROADMAP C-port-6): the reference's expert choices are forced
into the port (`test_torch_moe.forced_routes`), and every choice the
port made otherwise on its own must be a near tie.

Tolerances: `mamba_block`'s y within Y_TOL of max |y| and h within
H_TOL of max |h|, its conv tail bit for bit; logits within LOGIT_TOL of
the reference's max |logit| (the serving tests' limit); the loss and
every gradient leaf against the reference's in float32 within F32_TOL
and in bfloat16 within BF16_GRAD_TOL (see the two gradient tests).

The reference's two `jax.value_and_grad`s take ~14 s each to trace and
compile, so they run in two processes of their own
(`reference_jobs.hybrid_grads`), started when the module starts, while
the other tests run.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import serve as JS
from repro.models import transformer as JT
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.launch import train as TTR
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.models import build as t_build
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TM
from repro_torch.models import serve as TS
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_numpy

from reference_jobs import (B, GRAD_DTYPES, NAME, grad_batch, reference_init,
                            reference_routes, state_weights, tokens)
from test_torch_moe import forced_routes, one_thread  # noqa: F401

LOGIT_TOL = 2e-2
Y_TOL = 2.0 ** -7          # one bfloat16 step of the largest |y|
# the float32 state: at the reference's init within 2^-22 (XLA's exp and
# torch's); on the STATE weights 2^-13, where an in_proj value one bf16
# step apart (the product's sum order: 3 of 32,768 values) is carried by
# the slow decay
H_TOL = 2.0 ** -11
LOSS_TOL = 1e-3           # tests/test_torch_train.py
F32_TOL = 1e-5            # the float32 loss and gradients
# the bfloat16 gradients: read 0.008-0.022 of a leaf's max |g| (d_skip's
# the largest), where bfloat16 itself moves the reference's leaves
# 0.058-0.60 from its float32 ones (see test_bf16_loss_and_grads_...)
BF16_GRAD_TOL = 2.0 ** -5
T_FWD, STEPS, SEQ = 64, 32, 64
JC, TC = JR.get(NAME).reduced(), TR.get(NAME).reduced()
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def reference_grad_jobs(tmp_path_factory):
    """Starts `reference_jobs.hybrid_grads` for each of GRAD_DTYPES in a
    process of its own when the module starts: {name: (process, npz
    path)}."""
    d = tmp_path_factory.mktemp("reference_grads")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jobs = {}
    for name in GRAD_DTYPES:
        out = d / f"{name}.npz"
        jobs[name] = (subprocess.Popen(
            [sys.executable, str(HERE / "reference_jobs.py"), name,
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE), out)
    yield jobs
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_grads(reference_grad_jobs):
    """{name: (loss, aux, gradient leaves, expert choices)} of the
    reference, from `reference_grad_jobs`."""
    out = {}
    for name, (proc, path) in reference_grad_jobs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err.decode()[-3000:]
        with np.load(path) as z:
            n = sum(k.startswith("g") for k in z.files)
            out[name] = (float(z["loss"]), float(z["aux"]),
                         [z[f"g{i}"] for i in range(n)], list(z["routes"]))
    return out


@pytest.fixture(scope="module")
def weights():
    """{"init" | "state": (reference params, port params)}."""
    ref = reference_init()
    out = {}
    for key, tree in (("init", ref), ("state", state_weights(ref))):
        out[key] = (jax.tree.map(jnp.asarray, tree),
                    params_from_numpy(tree, device="cpu"))
    return out


def rel(ref, got) -> float:
    """max |ref - got| / max |ref| in float32."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.to(torch.float32).numpy() if torch.is_tensor(got) else got
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


# --------------------------------------------------------- the Mamba block --

@pytest.mark.parametrize("t,chunk", [(16, 8), (12, 8)])
def test_chunked_scan_over_a_tuple_matches_reference(t, chunk):
    """`layers.chunked_scan` with a tuple of xs (the reference's pytree):
    the carry and the ys bit-equal to the reference's on values whose
    sums are exact, for a chunk that divides T and one that does not
    (chunk 1); with autograd recording (each chunk checkpointed)
    the values and the gradient are those of the unchunked loop."""
    rng = np.random.default_rng(t)
    a = rng.integers(-3, 4, (t, 2, 3)).astype(np.float32)
    b = rng.integers(-3, 4, (t, 3)).astype(np.float32)

    def j_step(h, xs):
        x, y = xs
        h = h * 0.5 + x * y
        return h, h.sum(-1)

    def t_step(carry, xs):
        (h,), (x, y) = carry, xs
        h = h * 0.5 + x * y
        return (h,), h.sum(-1)

    jh, jy = JL.chunked_scan(j_step, jnp.zeros((2, 3)),
                             (jnp.asarray(a), jnp.asarray(b)), chunk=chunk)
    ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b)
    (th,), ty = TL.chunked_scan(t_step, (torch.zeros((2, 3)),), (ta, tb),
                                chunk=chunk)
    np.testing.assert_array_equal(np.asarray(jh), th.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jy), ty.detach().numpy())
    g = torch.autograd.grad((ty * ty).sum(), ta)[0]
    h, ys = (torch.zeros((2, 3)),), []
    a2 = torch.from_numpy(a).requires_grad_(True)
    for i in range(t):
        h, y = t_step(h, (a2[i], tb[i]))
        ys.append(y)
    ys = torch.stack(ys)
    assert torch.equal(ys, ty.detach())
    assert torch.equal(torch.autograd.grad((ys * ys).sum(), a2)[0], g)


def test_softplus_is_the_reference_form_c_port_10():
    """`mamba.softplus` is `jnp.logaddexp(x, 0)`'s form, max(x, 0) +
    log1p(exp(-|x|)): within 3 float32 ulps of `jax.nn.softplus` over
    [-40, 40] (XLA's exp and log1p differ from torch's in the last bit),
    the same bits at the specials; past 20 it is x, as F.softplus's
    threshold gives."""
    x = np.concatenate([np.linspace(-40, 40, 100_001, dtype=np.float32),
                        np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0])])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TMB.softplus(torch.from_numpy(x)).numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps[:-5].max() <= 3, ulps.max()
    np.testing.assert_array_equal(want[-5:].view(np.int32),
                                  got[-5:].view(np.int32))
    big = x[:-5] > 20
    np.testing.assert_array_equal(got[:-5][big], x[:-5][big])


def _block_inputs(weights, key, t, with_state):
    jp, tp = weights[key]
    jm = jax.tree.map(lambda a: a[0, 0], jp["periods"]["mamba"])
    tm = {k: v[0, 0] for k, v in tp["periods"]["mamba"].items()}
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (B, t, JC.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    run = jax.jit(JMB.mamba_block)
    state = None
    if with_state:                               # the state of 64 tokens
        pre = jnp.asarray(np.random.default_rng(8).standard_normal(
            (B, 64, JC.d_model)).astype(np.float32)).astype(jnp.bfloat16)
        state = run(jm, pre)[1]
    return jm, tm, x, state, run


@pytest.mark.parametrize("key,t,with_state", [
    ("init", 64, False), ("state", 64, False), ("state", 64, True),
    ("state", 1, True)])
def test_mamba_block_matches_reference(weights, key, t, with_state):
    """`mamba_block` on block 0 against the jitted reference, from zeros
    and from the state of a 64-token run: the conv tail bit for bit, y
    within Y_TOL of max |y|, h within H_TOL of max |h|."""
    jm, tm, x, state, run = _block_inputs(weights, key, t, with_state)
    jy, (jt, jh) = run(jm, x, state)
    ts = None if state is None else tuple(
        params_from_numpy({"s": np.asarray(s)}, device="cpu")["s"]
        for s in state)
    ty, (tt, th) = TMB.mamba_block(
        tm, params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"], ts)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == jy.shape
    assert tt.dtype == torch.bfloat16 and th.dtype == torch.float32
    np.testing.assert_array_equal(bits(jt), bits(tt))
    assert rel(jy, ty) <= Y_TOL
    assert rel(jh, th) <= H_TOL


def test_dt_u_keeps_the_silu_product_unrounded_c_port_10(weights,
                                                         monkeypatch):
    """The bfloat16 chains of the block under `jit`: the conv's four
    products and their sum, u D and y silu(z) round as the eager
    reference's (the tail and y above); `dt * u.astype(float32)` does not:
    XLA keeps silu's last product unrounded there.  A port that rounds u
    first (the eager reference's value) leaves the jitted reference's h
    by more than 2^-12 of max |h| at the reference's init, where the
    port's is within 2^-16."""
    jm, tm, x, _, run = _block_inputs(weights, "init", 64, False)
    jh = run(jm, x)[1][1]
    xt = params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]
    assert rel(jh, TMB.mamba_block(tm, xt)[1][1]) <= 2.0 ** -16
    monkeypatch.setattr(TMB, "_dt_u",
                        lambda dt, conv: dt * TL.silu(conv).float())
    assert rel(jh, TMB.mamba_block(tm, xt)[1][1]) > 2.0 ** -12


# ---------------------------------------------------------- the stack --

def test_forward_and_prefill_match_reference(weights, monkeypatch):
    """`forward`'s logits at every position of T_FWD tokens and
    `prefill`'s last logits within LOGIT_TOL of the reference's (routing
    forced), aux close, and `ModelBundle.loss` within LOSS_TOL of the
    reference's `loss_fn` formula on its logits; the port's own choices
    differ only at near ties (the reference's init; the STATE weights are
    held through the decode steps below)."""
    jp, tp = weights["init"]
    toks = tokens((B, T_FWD), 11)
    with reference_routes() as routes:
        jl, jaux = jax.jit(lambda p, t: JT.forward(JC, p, t, None,
                                                   remat=False))(
            jp, jnp.asarray(toks))
        jax.effects_barrier()
    forced = forced_routes(routes + routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    tl_, taux = TT.forward(TC, tp, torch.from_numpy(toks), remat=False)
    tlast = t_build(TC).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert forced.calls == 2 * len(routes) == 2 * JC.n_layers // JC.moe_every
    assert forced.near_ties(), (forced.own, forced.tokens, forced.tie)
    assert tl_.dtype == torch.bfloat16 and tuple(tl_.shape) == jl.shape
    assert rel(jl, tl_) < LOGIT_TOL
    assert tlast.dtype == torch.float32
    assert rel(jl[:, -1], tlast) < LOGIT_TOL
    assert abs(float(taux) - float(jaux)) <= 1e-2 * abs(float(jaux))
    labels = tokens((B, T_FWD), 15)
    jlog = jl.astype(jnp.float32)
    ll = jnp.take_along_axis(jlog, jnp.asarray(labels)[..., None], -1)
    want = float(jnp.mean(jax.nn.logsumexp(jlog, axis=-1) - ll[..., 0])
                 + 0.01 * jaux)
    monkeypatch.setattr(TM, "_top_k_experts", forced_routes(routes))
    got = t_build(TC).loss(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)},
                           remat=False)[0]
    assert abs(float(got) - want) <= LOSS_TOL


@pytest.fixture(scope="module")
def ref_steps(weights):
    """STEPS teacher-forced decode steps of the reference from position 0
    on its `make_cache(B, SEQ)` (the STATE weights), jitted once: (tokens,
    logits per step, the final cache, the expert choices)."""
    jp, _ = weights["state"]
    toks = tokens((B, T_FWD), 12)[:, :STEPS]
    step = jax.jit(lambda p, c, t, i: JS.serve_step(JC, p, c, t, i))
    cache = j_build(JC).make_cache(B, SEQ)
    out = []
    with reference_routes() as routes:
        for i in range(STEPS):
            lj, cache = step(jp, cache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.int32(i))
            out.append(np.asarray(lj))
        jax.effects_barrier()
    return toks, out, cache, routes


def port_steps(tp, toks, fault=None):
    """The port's teacher-forced steps from position 0 on its own
    make_cache; `fault` zeroes the conv tails or the SSM states after each
    step (the planted faults).  Returns (logits per step, cache)."""
    bundle = t_build(TC)
    cache = bundle.make_cache(B, SEQ, device="cpu")
    out = []
    for i in range(toks.shape[1]):
        lt, cache = bundle.serve_step(
            tp, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        out.append(lt.numpy())
        if fault is not None:
            cache[1][{"tail": 0, "h": 1}[fault]].zero_()
    return out, cache


def test_serve_steps_match_reference(weights, ref_steps, monkeypatch):
    """STEPS teacher-forced `serve_step`s of the port (routing forced)
    within LOGIT_TOL of the reference's at every step; the caches after
    them: the attention K/V and the conv tails bit for bit, the SSM states
    within H_TOL of max |h|; the port's own choices differ only at near
    ties."""
    toks, jout, jcache, routes = ref_steps
    forced = forced_routes(routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    tout, tcache = port_steps(weights["state"][1], toks)
    assert forced.calls == STEPS * JC.n_layers // JC.moe_every
    assert forced.near_ties(), (forced.own, forced.tokens, forced.tie)
    worst = max(rel(a, b) for a, b in zip(jout, tout))
    assert worst < LOGIT_TOL, worst
    (jkv, (jtail, jh)), (tkv, (ttail, th)) = jcache, tcache
    assert isinstance(tkv, TS.RawCache)
    for a, b in ((jkv.k, tkv.k), (jkv.v, tkv.v)):
        assert rel(a[:, :, :STEPS], b[:, :, :STEPS]) < LOGIT_TOL
    np.testing.assert_array_equal(bits(jtail).shape, bits(ttail).shape)
    assert rel(jtail, ttail) < LOGIT_TOL
    assert rel(jh, th) < LOGIT_TOL


class PositionRoutes:
    """The port's own expert choices in `forward` (one call a layer over
    B T tokens), given back to the decode steps position by position (one
    call a layer over B tokens)."""

    def __init__(self, real=TM._top_k_experts):
        self.real, self.seen, self.calls = real, [], 0

    def __call__(self, probs, top_k):
        if probs.shape[0] == B * T_FWD:
            self.seen.append(self.real(probs, top_k))
            return self.seen[-1]
        layer, pos = self.calls % len(self.seen), self.calls // len(self.seen)
        self.calls += 1
        return self.seen[layer].reshape(B, T_FWD, top_k)[:, pos]


@pytest.mark.parametrize("fault", [None, "tail", "h"])
def test_serve_steps_match_forward_and_planted_faults_fail(weights,
                                                          ref_steps, fault,
                                                          monkeypatch):
    """The port's STEPS teacher-forced steps against its own `forward` on
    the same tokens, with a capacity that keeps every (token, expert) pair
    in both and forward's expert choices given to the steps: within
    LOGIT_TOL at every position.  A step that drops the conv tail, or the
    SSM state h, fails it by more than twice."""
    tp = weights["state"][1]
    toks = tokens((B, T_FWD), 12)
    assert np.array_equal(toks[:, :STEPS], ref_steps[0])
    monkeypatch.setattr(TM, "capacity", lambda n, e, k, cf=1.0: n * k)
    monkeypatch.setattr(TM, "_top_k_experts", PositionRoutes())
    with torch.no_grad():
        fwd = TT.forward(TC, tp, torch.from_numpy(toks), remat=False)[0]
        steps, _ = port_steps(tp, toks[:, :STEPS], fault)
    fwd = fwd.float().numpy()
    gap = max(rel(fwd[:, i], steps[i]) for i in range(STEPS))
    if fault is None:
        assert gap < LOGIT_TOL, gap
    else:
        assert gap > 2 * LOGIT_TOL, gap


def test_ep_forward_bit_equal_to_one_rank(weights):
    """The hybrid's forward over a ("model",) mesh of 2 thread ranks (4
    experts a rank, the all-to-alls) is the one-rank forward bit for bit,
    logits and aux."""
    _, tp = weights["state"]
    toks = torch.from_numpy(tokens((B, 32), 14))
    with torch.no_grad():
        one, one_aux = TT.forward(TC, tp, toks, remat=False)
        got = run_mesh_threads((2,), ("model",), lambda m: TT.forward(
            TC, tp, toks, m, remat=False, moe_data_axes=()))
    for lg, aux in got:
        assert torch.equal(lg, one) and torch.equal(aux, one_aux)


# ----------------------------------------------------- caches and specs --

@pytest.mark.parametrize("quantized", [False, True])
def test_make_cache_is_the_reference_tree(quantized):
    """(RawCache over the periods' attention layers, (conv tails, SSM
    states)): the reference's shapes and dtypes, raw whatever `quantized`
    says, zeros; the parameter tree carried across leaf for leaf."""
    want = jax.eval_shape(lambda: j_build(JC).make_cache(3, 128, quantized))
    got = t_build(TC).make_cache(3, 128, quantized, device="cpu")
    assert isinstance(got[0], TS.RawCache)
    j_leaves, t_leaves = jax.tree.leaves(want), T.leaves(got)
    assert [(a.shape, str(a.dtype)) for a in j_leaves] == [
        (tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in t_leaves]
    assert all(not bool(t.any()) for t in t_leaves)
    jp = j_build(JC).abstract_params()
    tp = t_build(TC).abstract_params()
    assert [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jp)] == [
        (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        for t in T.leaves(tp)]


def test_quant_cache_engine_and_stream_prefill_refuse_the_hybrid():
    """The hybrid has no QuantCache path, engine or stream_prefill, as the
    reference's engine asserts (engine.py:125)."""
    from repro_torch.models import engine as TE
    from repro_torch.compression import kv as TKV
    params = t_build(TC).init(torch.Generator().manual_seed(0), device="cpu")
    qc = TS.make_quant_cache(TC, 1, 128, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(TypeError, match="engine.py:125"):
        TS.serve_step(TC, params, qc, tok, 0, None, TKV.kv_quantizer_config())
    with pytest.raises(NotImplementedError, match="engine.py:125"):
        TS.serve_step_rows(TC, params, qc, tok, [0],
                           TKV.kv_quantizer_config())
    with pytest.raises(NotImplementedError, match="engine.py:125"):
        TE.DecodeEngine(TC, params, n_slots=1, seq=128, device="cpu")


def test_train_cli_trains_the_reduced_hybrid(capsys):
    """`launch.train.main` on the reduced jamba on the CPU: two AdamW
    steps, a finite loss each."""
    TTR.main(["--arch", NAME, "--reduced", "--device", "cpu", "--steps",
              "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)) and "done" in out


# ------------------------------------------------- loss and gradients --

def port_grads(weights, name: str, routes, monkeypatch):
    """`ModelBundle.loss` and its gradient with remat (each period a
    checkpoint, each scan chunk within it another; the period's routing
    replays in the backward) on the STATE weights with the stack (and,
    for "f32", the weights) in GRAD_DTYPES' dtype, the expert choices
    forced to `routes`: ((loss, aux), leaves, the forced stand-in)."""
    tdt = TORCH_DTYPES[name]
    tp = weights["state"][1]
    if name == "f32":
        tp = T.tree_map(lambda t: t.float(), tp)
    monkeypatch.setattr(TT, "DTYPE", tdt)
    forced = forced_routes(routes + routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    tb = {k: torch.from_numpy(v) for k, v in grad_batch().items()}
    (tl, (_, taux)), tg = TTR.value_and_grad(t_build(TC), tp, tb)
    assert forced.calls == 2 * len(routes) and forced.near_ties()
    return (float(tl), float(taux)), T.leaves(tg), tp, tb


def test_loss_and_grads_match_reference(weights, ref_grads, monkeypatch):
    """The port's loss and gradient (`port_grads`) against
    `jax.value_and_grad` of the reference's `loss_fn` (routing forced),
    on the STATE weights and activations in float32: the loss and aux
    within F32_TOL, every gradient leaf within F32_TOL of its max |g|
    (measured: 1.6e-6).  The bfloat16 arithmetic is held in
    `test_bf16_loss_and_grads_match_reference`.  The port's gradient
    without remat is the same bit for bit."""
    jl, jaux, j_leaves, routes = ref_grads["f32"]
    (tl, taux), t_leaves, tp, tb = port_grads(weights, "f32", routes,
                                              monkeypatch)
    assert abs(tl - jl) <= F32_TOL * abs(jl)
    assert abs(taux - jaux) <= F32_TOL * abs(jaux)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        assert b.dtype == torch.float32 and rel(a, b) <= F32_TOL
    monkeypatch.setattr(TM, "_top_k_experts", forced_routes(routes))
    flat, tdef = T.flatten(tp)
    xs = [p.detach().requires_grad_(True) for p in flat]
    loss = t_build(TC).loss(T.unflatten(tdef, xs), tb, remat=False)[0]
    for a, b in zip(torch.autograd.grad(loss, xs), t_leaves):
        assert torch.equal(a, b)


def test_bf16_loss_and_grads_match_reference(weights, ref_grads,
                                             monkeypatch):
    """The same in bfloat16, as the card trains: the loss within LOSS_TOL
    and every gradient leaf within BF16_GRAD_TOL of its max |g| (read:
    0.008-0.022).  The witness that this gap is bfloat16 rounding: each
    package's bfloat16 leaves lie 0.058-0.60 from its own float32 ones
    (every leaf of the port within a fifth of the reference's distance,
    on the same expert choices: 14 of 256 (token, layer) choices differ
    in the two dtypes), and the two packages' bfloat16 leaves lie within half that
    distance of each other."""
    jl, _, j16, routes = ref_grads["bf16"]
    _, _, j32, routes32 = ref_grads["f32"]
    (tl, _), t16, _, _ = port_grads(weights, "bf16", routes, monkeypatch)
    _, t32, _, _ = port_grads(weights, "f32", routes32, monkeypatch)
    assert abs(tl - jl) <= LOSS_TOL
    assert len(j16) == len(t16)
    for a16, a32, b16, b32, w in zip(j16, j32, t16, t32,
                                     T.leaves(weights["state"][1])):
        assert b16.dtype == w.dtype
        gap, own = rel(a16, b16), rel(a32, a16)
        assert gap <= BF16_GRAD_TOL, gap
        assert gap <= own / 2, (gap, own)
        port_own = rel(b32.numpy(), b16)
        assert abs(port_own - own) <= own / 5, (port_own, own)


"""Training on the reference's sharded layout (`launch.train` with the
rank's blocks under `param_shardings`; `layers.vocab_ce`;
`optimizer.global_norm(split=)`; `compression.grads` on blocks) against
the port's one-rank step and the JAX package's jitted single-device one.

Ranks are threads (`launch.mesh.run_mesh_threads`) on the meshes (2, 2)
("data", "model") and (2, 1, 2) ("pod", "data", "model"); each data block
of the batch (one row here) is its ranks' rows.  Every rank holds its
views of the weights (`param_blocks`); the gradients come back as the
ranks' blocks and are joined (`launch.mesh.assemble`).  A MoE layer's
capacity follows the tokens a rank routes, as the reference's does over
its data shards, so the MoE config's references run block by block and
average, with the reference's expert choices forced into the port
(C-port-6), as tests/test_torch_tp.py does.

What is held, with its tolerance:
  (a) `vocab_ce` on (1, 2) and (1, 4) against the whole logits'
      `logsumexp - ll` within CE_TOL, its gradient block by block within
      CE_GRAD_TOL;
  (b) `global_norm` on blocks within NORM_ULPS of the whole tree's
      (tests/test_torch_train.py's C-port-7 limit); `apply` on blocks,
      given the whole tree's norm, bit-equal to the blocks of the whole
      update (mu, nu, master, params);
  (c) float32: the layout's step against the reference's: the loss within
      F32_LOSS_TOL, each gradient leaf within F32_GRAD_TOL of its max |g|,
      each new param within STEP_TOL_LR learning rates of the
      reference's (step 1's AdamW moves an element by lr sign(g): a
      gradient near 0 can flip) and all but F32_FLIP_FRAC of them within
      F32_PARAM_TOL;
  (d) bfloat16: against the port's one-rank step: the loss within
      BF16_LOSS_TOL of |loss|, each gradient leaf within BF16_GRAD_TOL of
      its max |g| (the EP training limit), the master as in (c);
  (e) the compressed step on (2, 2, 2) with grad-wire-8: each block's
      bound eb within `eb_ulps_bound` of the whole leaf's (two float32
      sums of the same squares in other orders), every pod's decoded
      mean within eb (float64) of the pods' mean input, and each block's
      mean bit-equal to that block of the whole leaf's compressed mean
      under the same eb;
  (f) planted faults, each failing its check: the CE's lse over the
      rank's block alone, a replicated leaf's gradient without its sum
      over "model", the FSDP leaves' gradient averaged again over "data";
  (g) rank 0's step on `MetaAxis` axes (no remat, as thread ranks run
      it): its collective bytes by kind equal a count made from the
      layout's shapes;
  (h) four gloo processes (`launch.mesh.dist_mesh`, each rank its own
      loss's backward over the ranks' count, each layer rematerialized)
      on (2, 2): the loss and the joined gradient as (c)'s against the
      port's one rank in float32.

torch runs on one thread (`test_torch_moe.one_thread`).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import transformer as JT
from repro.optim import optimizer as JO
from repro_torch import tree as T
from repro_torch.compression import grads as G
from repro_torch.configs import registry as TR
from repro_torch.core.axis import MetaAxis
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch import train as TL
from repro_torch.models import build as t_build
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import optimizer as O

from test_torch_moe import one_thread  # noqa: F401  (autouse fixture)
from test_torch_tp import Forced, reference_rows

CE_TOL = 2e-6            # of max |lse - ll|: float32 sums in another order
CE_GRAD_TOL = 1e-6       # of the largest |gradient| (1 / tokens)
NORM_ULPS = 16
F32_LOSS_TOL = 1e-5      # relative
F32_GRAD_TOL = 1e-4      # of each leaf's max |g|
F32_PARAM_TOL = 1e-6     # absolute, on weights of size ~0.02-1
F32_FLIP_FRAC = 1e-3     # elements whose step-1 update flipped its sign
STEP_TOL_LR = 2.0        # learning rates: a flipped sign moves 2 lr
BF16_LOSS_TOL = 1e-3     # of |loss|
BF16_GRAD_TOL = 2e-2     # of each leaf's max |g|
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
SEQ = 32
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = [("internlm2-20b", "2x2"), ("olmoe-1b-7b", "2x1x2")]


# ------------------------------------------------------------- helpers --

def ordered(a) -> np.ndarray:
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a, b) -> int:
    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


def bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def leaf_gaps(got, want) -> list:
    """max |got - want| / max |want| of each leaf, in tree order."""
    return [float((a.float() - b.float()).abs().max()
                  / max(b.float().abs().max(), 1e-30))
            for a, b in zip(T.leaves(got), T.leaves(want))]


def data_index(m) -> int:
    c, i = m.coords(), 0
    for a in M.data_axes(m):
        i = i * m.sizes[a] + c[a]
    return i


def n_blocks(mesh_key) -> int:
    desc = M.Mesh(*MESHES[mesh_key])
    return int(np.prod([desc.sizes[a] for a in M.data_axes(desc)]))


def rows_of(batch: dict, i: int, n: int) -> dict:
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def make_batch(vocab: int, rows: int, seed: int) -> dict:
    tok = np.random.default_rng(seed).integers(0, vocab, (rows, SEQ + 1))
    return {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}


def opt_shardings(shard):
    rep = M.replicated(next(iter(T.leaves(shard))).mesh)
    return O.OptState(rep, shard, shard, shard)


def layout_run(tc, tp, batch, mesh_key, forced=None, *, step: bool = True):
    """Every rank's (coords, loss, gradient blocks, new params blocks,
    new master blocks, grad norm) of the layout's value_and_grad and
    pure train step (one AdamW step from `O.init`), each data rank on its
    block of the batch's rows; and the shardings and coordinates."""
    shape, names = MESHES[mesh_key]
    bundle = t_build(tc)
    desc, axes = M.Mesh(shape, names), bundle.axes()
    shard = M.param_shardings(desc, axes, tp)
    ocfg = O.AdamWConfig(**OPT)
    ost = O.init(tp, ocfg)
    nb = n_blocks(mesh_key)

    def rank(m):
        di = data_index(m)
        rows = rows_of(batch, di, nb)
        blk = M.param_blocks(tp, m, axes)
        if forced is not None:
            forced.start(di)
        (loss, _), g = TL.value_and_grad(bundle, blk, rows, m)
        if not step:
            return m.coords(), loss, g, None, None, None
        if forced is not None:
            forced.start(di)
        ob = M.local_views(ost, opt_shardings(shard), m.coords())
        (p1, s1), met = TL.make_train_step(bundle, m, ocfg)((blk, ob), rows)
        return m.coords(), loss, g, p1, s1.master, met["grad_norm"]

    return M.run_mesh_threads(shape, names, rank), shard


def joined(out, shard, i: int):
    return M.assemble([o[i] for o in out], shard, [o[0] for o in out])


def one_rank(tc, tp, batch, nb: int, forced=None):
    """The port's one-rank step on the same data blocks: each block's
    loss and gradient (mesh None) averaged in float32, then AdamW."""
    bundle = t_build(tc)
    losses, grads = [], []
    for i in range(nb):
        if forced is not None:
            forced.start(i)
        (loss, _), g = TL.value_and_grad(bundle, tp, rows_of(batch, i, nb))
        losses.append(float(loss))
        grads.append(g)
    flat = [sum(x.float() for x in xs) / nb
            for xs in zip(*(T.leaves(g) for g in grads))]
    g = T.unflatten(T.flatten(grads[0])[1],
                    [f.to(x.dtype) for f, x in zip(flat, T.leaves(grads[0]))])
    ocfg = O.AdamWConfig(**OPT)
    p1, s1, _ = O.apply(tp, g, O.init(tp, ocfg), ocfg)
    return float(np.mean(losses)), g, p1, s1.master


def param_gap(got, want, lr: float) -> tuple:
    """(max |got - want| in learning rates, the share of elements off by
    more than F32_PARAM_TOL) over every leaf."""
    worst, off, n = 0.0, 0, 0
    for a, b in zip(T.leaves(got), T.leaves(want)):
        d = (a.double() - b.double()).abs()
        worst = max(worst, float(d.max()) / lr)
        off += int((d > F32_PARAM_TOL).sum())
        n += d.numel()
    return worst, off / n


def first_lr() -> float:
    return float(O.schedule(torch.ones((), dtype=torch.int32),
                            O.AdamWConfig(**OPT)))


# ----------------------------------------------------------- (a) the CE --

@pytest.mark.parametrize("n", [2, 4])
def test_vocab_ce_matches_the_whole_logits(n):
    """Every rank's lse - ll from its "vocab" block within CE_TOL of the
    whole logits' `logsumexp - ll` (labels in every block, the padded
    columns counted as the one-rank loss counts them), and the gradient
    of the mean reaches each rank's block: its softmax block less its
    one-hot block, over the tokens."""
    g = torch.Generator().manual_seed(n)
    logits = torch.randn((3, 7, 256), generator=g) * 4
    labels = torch.randint(0, 256, (3, 7), generator=g)
    labels[0, :n] = torch.arange(n) * (256 // n)     # one in every block
    leaf = logits.clone().requires_grad_(True)
    want = torch.logsumexp(leaf, -1) - leaf.gather(-1, labels[..., None])[
        ..., 0]
    (want_g,) = torch.autograd.grad(want.mean(), leaf)
    blocks = [b.clone().requires_grad_(True) for b in logits.chunk(n, -1)]

    def rank(m):
        ax = m.axis("model")
        return L.vocab_ce(blocks[ax.rank], labels, ax)

    got = M.run_mesh_threads((1, n), ("data", "model"), rank)
    want = want.detach()
    top = float(want.abs().max())
    for ce in got:
        assert float((ce.detach() - want).abs().max()) <= CE_TOL * top
    grads = torch.autograd.grad(got[0].mean(), blocks)
    g_top = float(want_g.abs().max())
    for gb, wb in zip(grads, want_g.chunk(n, -1)):
        assert float((gb - wb).abs().max()) <= CE_GRAD_TOL * g_top


# ------------------------------------------------- (b) AdamW on blocks --

def test_global_norm_and_apply_on_blocks():
    """The reduced internlm2's tree on the (2, 2) mesh with random
    gradients: each rank's `global_norm(grads, split)` within NORM_ULPS
    of the whole tree's, the same on every rank; `apply` on each rank's
    blocks of params, gradients and state, given the whole tree's norm
    (clipping: the norm is above clip_norm), bit-equal to the blocks of
    the whole update, pure and donating."""
    tc = TR.get("internlm2-20b").reduced()
    bundle = t_build(tc)
    tp = bundle.init(torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(6)
    grads = T.tree_map(lambda t: torch.randn(t.shape, generator=g).to(
        t.dtype), tp)
    ocfg = O.AdamWConfig(**OPT)
    whole_norm = O.global_norm(grads)
    assert float(whole_norm) > ocfg.clip_norm
    p1, s1, m1 = O.apply(tp, grads, O.init(tp, ocfg), ocfg)
    desc = M.Mesh((2, 2), ("data", "model"))
    shard = M.param_shardings(desc, bundle.axes(), tp)
    sshard = opt_shardings(shard)
    split_names = [[a for a in desc.axis_names
                    if a not in M.replicated_axes(s)] for s in T.leaves(shard)]

    def rank(m, params, state, donate):
        c = m.coords()
        gb = M.local_views(grads, shard, c)
        norm = O.global_norm(gb, [[m.axis(a) for a in names]
                                  for names in split_names])
        pb, sb, _ = O.apply(M.rank_state(params, shard, c), gb,
                            M.rank_state(state, sshard, c), ocfg,
                            donate=donate, norm=whole_norm)
        return c, norm, pb, sb

    for donate in (False, True):
        # one global state; each rank updates its views of the blocks that
        # are its alone and its copies of those ranks share
        params = T.tree_map(torch.clone, tp)
        state = O.init(tp, ocfg)
        out = M.run_mesh_threads((2, 2), ("data", "model"),
                                 lambda m: rank(m, params, state, donate))
        norms = {bits(o[1]) for o in out}
        assert len(norms) == 1
        assert ulps(whole_norm.numpy(), out[0][1].numpy()) <= NORM_ULPS
        for c, _, pb, sb in out:
            for want, got in ((p1, pb), (s1.mu, sb.mu), (s1.nu, sb.nu),
                              (s1.master, sb.master)):
                for w, x, s in zip(T.leaves(want), T.leaves(got),
                                   T.leaves(shard)):
                    assert bits(M.local_view(w, s, c)) == bits(x)
            assert int(sb.step) == 1
    assert bits(m1["grad_norm"]) == bits(whole_norm)


# --------------------------------------- (c) float32 against the reference --

def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy())


@pytest.fixture(scope="module")
def f32_models():
    """{name: (reference cfg, port cfg, port float32 weights, the same
    values as JAX arrays)}."""
    out = {}
    for i, (name, _) in enumerate(CASES):
        jc, tc = JR.get(name).reduced(), TR.get(name).reduced()
        tp = T.tree_map(lambda t: t.float(), t_build(tc).init(
            torch.Generator().manual_seed(80 + i), device="cpu"))
        jp = jax.tree.map(jnp.asarray, T.tree_map(lambda t: t.numpy(), tp))
        out[name] = (jc, tc, tp, jp)
    return out


def reference_step(jc, jp, batch: dict, nb: int, routes=None) -> tuple:
    """The reference's float32 step: its jitted loss gradient on each
    data block (the MoE config's capacity is a block's), averaged, then
    its jitted AdamW (`optimizer.apply`); for the dense config with one
    block this is `launch.train.make_train_step`'s body.  Returns (loss,
    gradient, new params), numpy."""
    real = JT.DTYPE
    JT.DTYPE = jnp.float32
    try:
        vg = jax.jit(jax.value_and_grad(j_build(jc).loss, has_aux=True))
        losses, grads = [], []
        for i in range(nb):
            b = {k: jnp.asarray(v.numpy()) for k, v in
                 rows_of(batch, i, nb).items()}
            (loss, _), g = vg(jp, b)
            losses.append(float(loss))
            grads.append(g)
        g = jax.tree.map(lambda *xs: sum(xs) / nb, *grads)
        jocfg = JO.AdamWConfig(**OPT)
        p1, _, _ = jax.jit(lambda p, g_: JO.apply(
            p, g_, JO.init(p, jocfg), jocfg))(jp, g)
    finally:
        JT.DTYPE = real
    return (float(np.mean(losses)), jax.tree.map(np.asarray, g),
            jax.tree.map(np.asarray, p1))


@pytest.mark.parametrize("name,mesh_key", CASES)
def test_float32_layout_step_matches_reference(f32_models, name, mesh_key,
                                               monkeypatch):
    jc, tc, tp, jp = f32_models[name]
    monkeypatch.setattr(TT, "DTYPE", torch.float32)
    nb = n_blocks(mesh_key)
    batch = make_batch(tc.vocab, nb, 21)
    forced = None
    if tc.family == "moe":
        real = JT.DTYPE
        _, routes = reference_rows(jc, jp, batch["tokens"].numpy(),
                                   jnp.float32)
        assert JT.DTYPE is real
        forced = Forced(routes)
        monkeypatch.setattr(TM, "_top_k_experts", forced)
    want_loss, want_g, want_p = reference_step(jc, jp, batch, nb)
    out, shard = layout_run(tc, tp, batch, mesh_key, forced)
    for o in out:
        assert abs(float(o[1]) - want_loss) <= F32_LOSS_TOL * abs(want_loss)
    g = joined(out, shard, 2)
    want_g = params_from_numpy(want_g, device="cpu")
    assert max(leaf_gaps(g, want_g)) <= F32_GRAD_TOL
    lr = first_lr()
    worst, flipped = param_gap(joined(out, shard, 3),
                               params_from_numpy(want_p, device="cpu"), lr)
    assert worst <= STEP_TOL_LR * (1 + 1e-3) and flipped <= F32_FLIP_FRAC
    if forced is not None:
        assert forced.tie >= 1 - 2.0 ** -4, forced.tie


# ---------------------------------------- (d) bfloat16 against one rank --

@pytest.fixture(scope="module")
def bf16_models():
    return {name: (TR.get(name).reduced(), t_build(TR.get(name).reduced(
    )).init(torch.Generator().manual_seed(90 + i), device="cpu"))
        for i, (name, _) in enumerate(CASES)}


@pytest.mark.parametrize("name,mesh_key", CASES)
def test_bfloat16_layout_step_matches_one_rank(bf16_models, name, mesh_key,
                                               monkeypatch):
    tc, tp = bf16_models[name]
    nb = n_blocks(mesh_key)
    batch = make_batch(tc.vocab, nb, 22)
    forced = None
    if tc.family == "moe":
        forced = Forced()
        monkeypatch.setattr(TM, "_top_k_experts", forced)
    want_loss, want_g, _, want_master = one_rank(tc, tp, batch, nb, forced)
    if forced is not None:
        forced.routes = {k: v[:len(v) // 2] for k, v in forced.seen.items()}
        forced.seen = {}
    out, shard = layout_run(tc, tp, batch, mesh_key, forced)
    for o in out:
        assert abs(float(o[1]) - want_loss) <= BF16_LOSS_TOL * abs(want_loss)
    assert max(leaf_gaps(joined(out, shard, 2), want_g)) <= BF16_GRAD_TOL
    worst, _ = param_gap(joined(out, shard, 4), want_master, first_lr())
    assert worst <= STEP_TOL_LR * (1 + 1e-3)
    if forced is not None:
        assert forced.tie >= 1 - 2.0 ** -4, forced.tie


# ------------------------------------------- (e) the compressed step --

GC_EB_REL = 2.0 ** -5


class SentBlocks:
    """`compression.grads.compress_shard` and `compressed_mean` wrapped:
    each rank's input (g + r), bound, overflow flag and mean of every
    leaf, keyed by (rank coords, leaf index)."""

    def __init__(self, monkeypatch):
        import threading
        self.real_cs, self.real_cm = G.compress_shard, G.compressed_mean
        self.local, self.got = threading.local(), {}
        monkeypatch.setattr(G, "compress_shard", self.cs)
        monkeypatch.setattr(G, "compressed_mean", self.cm)

    def start(self, coords):
        self.local.coords, self.local.i = tuple(coords.values()), 0

    def cs(self, *a, **kw):
        out = self.real_cs(*a, **kw)
        self.local.enc = out[0].enc
        return out

    def cm(self, g, cfg, axis, **kw):
        mean, resid = self.real_cm(g, cfg, axis, **kw)
        enc, i = self.local.enc, self.local.i
        self.got[(self.local.coords, i)] = (g.clone(), enc.eb.clone(),
                                           bool(enc.overflow), mean.clone())
        self.local.i = i + 1
        return mean, resid


def f32_sum_adds(n: int) -> int:
    """The adds one value passes through in `codec.f32_sum` over n values
    (windows of 32, 31 adds each, then the last fold): the sum of n
    non-negative values is within that many units of 2^-24 of the exact
    one, relative."""
    adds = 0
    while n > 32:
        adds += 31
        n = -(-n // 32)
    return adds + n - 1


def eb_ulps_bound(n: int, n_block: int, ranks: int) -> int:
    """The float32 ulps between eb_rel * sqrt(ss / n) of the whole leaf's
    sum of squares and of its blocks' sums psummed over `ranks`: each sum
    within its adds of the exact one, halved by the root, doubled into
    ulps, and a rounding each of the mean, the root and the product."""
    return f32_sum_adds(n) + f32_sum_adds(n_block) + ranks - 1 + 4


def test_compressed_step_on_blocks(bf16_models, monkeypatch):
    """grad-wire-8 on the (2, 2, 2) ("pod", "data", "model") mesh: each
    pod's ranks on their blocks under `param_shardings` with "pod" dropped
    (FSDP over "data" inside the pod), the pods sharing one state
    (`shared_state`), each (data, model) rank its own blocks
    (`rank_state`) and its pod-stacked residual blocks.  For every leaf
    and pod: the bound within `eb_ulps_bound` of `compress_shard`'s on
    the whole leaf (the blocks' inputs joined); every block's mean within
    the pods' mean bound of their mean input (float64); and each block's
    mean bit-equal to that block of the whole leaf's compressed mean
    under the same bound (the quantizer is elementwise)."""
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.core.axis import run_threads
    from repro_torch.core.transport import TRANSPORT
    tc, tp = bf16_models["internlm2-20b"]
    bundle = t_build(tc)
    shape, names = MESHES["2x2x2"]
    pod_desc = M.Mesh(shape[1:], names[1:])
    shard = M.param_shardings(pod_desc, bundle.axes(), tp)
    gcfg = G.GradCompressionConfig(eb_rel=GC_EB_REL,
                                   pipeline=get_pipeline("grad-wire-8"))
    ocfg = O.AdamWConfig(**OPT)
    params, ost = T.tree_map(torch.clone, tp), O.init(tp, ocfg)
    states = {}
    for c in M.mesh_coords(pod_desc):
        p = M.rank_state(params, shard, c)
        states[tuple(c.values())] = (p, M.rank_state(
            ost, opt_shardings(shard), c), TL.init_residuals(p, 2))
    batch = make_batch(tc.vocab, 4, 23)
    sent = SentBlocks(monkeypatch)

    def rank(m):
        c = m.coords()
        sent.start(c)
        step = TL.make_train_step_compressed(bundle, m, ocfg, gcfg,
                                             donate=True, shared_state=True)
        # the rank's rows over "data"; pod p takes its half of them
        rows = rows_of(batch, c["data"], 2)
        _, met = step(states[(c["data"], c["model"])], rows, m.axis("pod"))
        return met["loss"]

    losses = M.run_mesh_threads(shape, names, rank)
    assert all(np.isfinite(float(x)) for x in losses)
    pipe = gcfg.pipe()
    coords = M.mesh_coords(pod_desc)
    for i, s in enumerate(T.leaves(shard)):
        ins, ebs = [], []
        for pod in range(2):
            blocks = [sent.got[((pod, *c.values()), i)] for c in coords]
            assert not any(b[2] for b in blocks)
            ins.append(M.assemble([{"g": b[0]} for b in blocks],
                                  {"g": s}, coords)["g"])
            assert len({bits(b[1]) for b in blocks}) == 1
            ebs.append(blocks[0][1])
            whole_eb = G.compress_shard(ins[pod], gcfg, device="cpu")[0].enc.eb
            assert ulps(whole_eb.numpy(), ebs[pod].numpy()) <= eb_ulps_bound(
                ins[pod].numel(), blocks[0][0].numel(), len(coords))

        def pod_mean(ax):
            flat = ins[ax.rank].reshape(-1).to(torch.float32)
            enc = pipe.encode(flat, ebs[ax.rank], device="cpu")
            return TRANSPORT.reduce_sum(enc, pipe, flat.numel(), ax) / 2

        whole = run_threads(2, pod_mean)[0].reshape(ins[0].shape)
        want64 = (ins[0].double() + ins[1].double()) / 2
        bound = float(ebs[0] + ebs[1]) / 2
        for pod in range(2):
            for c in coords:
                mean = sent.got[((pod, *c.values()), i)][3]
                assert bits(mean) == bits(M.local_view(whole, s, c))
                gap = (mean.double() - M.local_view(want64, s, c)).abs()
                slack = np.spacing(np.float32(mean.abs().max()))
                assert float(gap.max()) <= bound + slack


# ------------------------------------------------- (f) planted faults --

def _lse_of_block(logits, labels, axis):
    """The fault: lse from the rank's "vocab" block alone."""
    n = logits.shape[-1]
    lse = torch.logsumexp(logits, -1)
    local = labels.to(torch.int64) - axis.axis_index() * n
    mine = (local >= 0) & (local < n)
    ll = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    return lse - axis.psum(torch.where(mine, ll, -0.0))


def _without_model(real):
    def replica_sum(grads, shard, mesh, axes):
        return real(grads, shard, mesh, tuple(a for a in axes
                                              if a != "model"))
    return replica_sum


def _data_mean_again(real):
    def replica_sum(grads, shard, mesh, axes):
        out = real(grads, shard, mesh, axes)
        flat, tdef = T.flatten(out)
        ax = mesh.axis("data")
        return T.unflatten(tdef, [
            ax.pmean(g) if "data" not in M.replicated_axes(s) else g
            for g, s in zip(flat, shard)])
    return replica_sum


FAULTS = {"lse_of_block": (L, "vocab_ce", lambda real: _lse_of_block),
          "no_model_sum": (TL, "replica_sum", _without_model),
          "fsdp_mean_again": (TL, "replica_sum", _data_mean_again)}


@pytest.mark.parametrize("fault", [None] + list(FAULTS))
def test_planted_faults_fail(f32_models, fault, monkeypatch):
    """The float32 reduced internlm2 on (2, 2) against the port's one rank
    on the same blocks: clean, the loss within F32_LOSS_TOL and each
    gradient leaf within F32_GRAD_TOL; each planted fault fails one of
    the two."""
    _, tc, tp, _ = f32_models["internlm2-20b"]
    monkeypatch.setattr(TT, "DTYPE", torch.float32)
    batch = make_batch(tc.vocab, 2, 24)
    want_loss, want_g, _, _ = one_rank(tc, tp, batch, 2)
    if fault is not None:
        mod, name, make = FAULTS[fault]
        monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    out, shard = layout_run(tc, tp, batch, "2x2", step=False)
    loss_ok = all(abs(float(o[1]) - want_loss) <= F32_LOSS_TOL
                  * abs(want_loss) for o in out)
    grads_ok = max(leaf_gaps(joined(out, shard, 2), want_g)) <= F32_GRAD_TOL
    assert (loss_ok and grads_ok) == (fault is None), (loss_ok, grads_ok)


# ------------------------------------------ (g) rank 0's step on meta --

def hand_count(cfg, b: int, s: int, nd: int, nm: int) -> dict:
    """Rank 0's collective bytes of the full-precision step on the layout
    of a dense config (no remat), by kind, from the layout's shapes (an
    all-reduce at its payload, any other kind at its result, as
    `MetaAxis` records): each FSDP block gathered over "data" where it is
    used and reduce-scattered in the backward (the embedding twice: its
    lookup and the logits), the KV product gathered over "model" and
    reduce-scattered back, the psums of `wo`, `w2` (float32 partials),
    the vocab lookup (bfloat16) and the CE's sum and label logit (each
    forward and backward) and its pmax (forward), the replicated
    leaves' sums over "data" and "model", the metrics' mean and the
    global norm's psums."""
    d, h, hd, g, f = (cfg.d_model, cfg.n_heads, cfg.head_dim,
                      cfg.n_kv_heads, cfg.d_ff)
    v, n_l, bf, f4 = cfg.padded_vocab, cfg.n_layers, 2, 4
    tok = b * s
    emb = v // nm * d * bf
    layer = [d * h * hd // nm, d * 2 * g * hd // nm, h * hd // nm * d,
             d * f // nm, d * f // nm, f // nm * d]
    gathered = sum(layer) * bf
    kv = tok * 2 * g * hd * bf
    ag = 2 * emb + n_l * (gathered + kv)
    rs = 2 * emb // nd + n_l * (gathered // nd + kv // nm)
    ar = (2 * tok * d * bf + n_l * 4 * tok * d * f4 + 5 * tok * f4
          + 2 * (d + 2 * n_l * d) * f4 + 3 * f4 + 2 * 7 * f4)
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs}


def test_meta_step_collectives_against_a_hand_count(bf16_models):
    tc, _ = bf16_models["internlm2-20b"]
    bundle = t_build(tc)
    desc = M.Mesh(*MESHES["2x2"])
    rec = cost.Recorder()
    rmesh = M.Mesh(desc.shape, desc.axis_names, axes={
        n: MetaAxis(desc.sizes[n], rec) for n in desc.axis_names})
    ocfg = O.AdamWConfig(**OPT)
    with torch.device("meta"):
        mp = M.param_blocks(bundle.abstract_params(), rmesh, bundle.axes())
        ms = O.init(mp, ocfg)
        batch = {k: torch.empty((1, SEQ), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = TL.make_train_step(bundle, rmesh, ocfg, donate=True,
                                  remat=False)
        with cost.counting(0, rec) as c:
            step((mp, ms), batch)
    assert c.collective_bytes == hand_count(tc, 1, SEQ, 2, 2)


# ------------------------------------------ (h) processes over gloo --

DIST_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs import registry as TR
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TL
    from repro_torch.models import build
    from repro_torch.models import transformer as TT

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=4, rank=rank)
    mesh = M.dist_mesh((2, 2), ("data", "model"))
    with open(out + ".in", "rb") as f:
        params, batch = pickle.load(f)
    TT.DTYPE = torch.float32
    bundle = build(TR.get("internlm2-20b").reduced())
    i = mesh.coords()["data"]
    rows = {k: torch.from_numpy(v[i:i + 1]) for k, v in batch.items()}
    tp = T.tree_map(torch.from_numpy, params)
    (loss, _), g = TL.value_and_grad(
        bundle, M.param_blocks(tp, mesh, bundle.axes()), rows, mesh)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump((mesh.coords(), float(loss),
                     T.tree_map(lambda t: t.numpy(), g)), f)
    dist.destroy_process_group()
""")


def test_dist_ranks_match_one_rank(f32_models, tmp_path, monkeypatch):
    _, tc, tp, _ = f32_models["internlm2-20b"]
    monkeypatch.setattr(TT, "DTYPE", torch.float32)
    batch = make_batch(tc.vocab, 2, 25)
    want_loss, want_g, _, _ = one_rank(tc, tp, batch, 2)
    out = tmp_path / "res"
    (tmp_path / "res.in").write_bytes(pickle.dumps((
        T.tree_map(lambda t: t.numpy(), tp),
        {k: v.numpy() for k, v in batch.items()})))
    script = tmp_path / "dist_ranks.py"
    script.write_text(DIST_SCRIPT)
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    procs = [subprocess.Popen([sys.executable, str(script), str(k),
                               str(tmp_path / "store"), str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(4)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    res = [pickle.loads((tmp_path / f"res.{k}").read_bytes())
           for k in range(4)]
    for _, loss, _ in res:
        assert abs(loss - want_loss) <= F32_LOSS_TOL * abs(want_loss)
    desc = M.Mesh(*MESHES["2x2"])
    shard = M.param_shardings(desc, t_build(tc).axes(), tp)
    g = M.assemble([T.tree_map(torch.from_numpy, r[2]) for r in res], shard,
                   [r[0] for r in res])
    assert max(leaf_gaps(g, want_g)) <= F32_GRAD_TOL

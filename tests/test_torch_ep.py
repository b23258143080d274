"""Expert parallelism in the port (`repro_torch.core.axis`'s all_to_all,
psum and pmean; `models.moe`'s expert-parallel paths; `transformer.
forward` and `serve.serve_step` with a mesh) against the port's own
one-rank paths and against the JAX package's `moe_ffn` on a ("model",)
mesh of 4 forced host devices, run in a subprocess (this process holds
JAX at one device).

The port's ranks are 4 threads (`launch.mesh.run_mesh_threads`), each with
its block of the experts as a view of the shared weights.

What holds bit for bit: the prefill path's output and load-balance loss
and the decode path's output against the reference's `moe_ffn` on its
mesh and against the port's one-rank `moe_ffn_local`; the gradients of a
sum of the prefill output with respect to x and the expert weights
against the one-rank path (one backward over the graph the thread ranks
share), and those with respect to the expert weights against the
reference's; the ("data", "model") mesh's paths against the ("model",)
one.  x's gradient sums several bfloat16 contributions, whose order and
rounding follow XLA's fusion of the reference's backward: it agrees
within two bfloat16 ulps of its largest |value|.  In the whole model
the reference's choices are forced into the port (`moe._top_k_experts`)
where a near tie rounds apart (C-port-6).
"""
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.compression import kv as TKV
from repro_torch.configs import registry as TR
from repro_torch.core.axis import run_threads
from repro_torch.launch.mesh import run_mesh_threads
from repro_torch.models import moe as TM
from repro_torch.models import serve as TS
from repro_torch.models import transformer as TTr
from repro_torch.models.params import params_from_numpy

REPO = Path(__file__).resolve().parents[1]
EP = 4
E, K, D, F = 8, 2, 16, 32
# two bfloat16 ulps of the largest |value|: x's gradient against the
# reference's (the order of its bfloat16 sums follows XLA's fusion), and
# the decode path (bfloat16 partials a rank) against the dispatch path
MOE_RTOL = 2.0 ** -6
LOGIT_TOL = 2e-2          # of max |reference logit|: test_torch_serve.py
NEAR_TIE = 2.0 ** -4
SEQ_KV = 256

REF_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.models import build, moe as JM
    from repro.models import transformer as JT

    out, seed = sys.argv[1], int(sys.argv[2])
    E, K, D, F = 8, 2, 16, 32
    rec = {}
    mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("model",))
    rng = np.random.default_rng(seed)
    bf = lambda a: jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    x = bf(rng.standard_normal((2, 12, D)))
    rw = jnp.asarray(rng.standard_normal((D, E)).astype(np.float32))
    w1, w3 = (bf(rng.standard_normal((E, D, F)) * 0.2) for _ in range(2))
    w2 = bf(rng.standard_normal((E, F, D)) * 0.2)
    ep = lambda xx: jax.jit(lambda *a: JM.moe_ffn(
        *a, top_k=K, mesh=mesh, data_axes=()))(xx, rw, w1, w3, w2)
    y, aux = ep(x)
    yl, auxl = jax.jit(lambda *a: JM.moe_ffn_local(*a, top_k=K))(
        x, rw, w1, w3, w2)
    rec["y"], rec["aux"] = np.asarray(y), np.asarray(aux)
    rec["local_equal"] = np.array(bool(jnp.all(y == yl))
                                  and float(aux) == float(auxl))
    rec["y_decode"] = np.asarray(ep(x[:, :1])[0])

    def grads(m):
        def f(x, w1, w3, w2):
            o = (JM.moe_ffn_local(x, rw, w1, w3, w2, top_k=K)[0] if m is None
                 else JM.moe_ffn(x, rw, w1, w3, w2, top_k=K, mesh=m,
                                 data_axes=())[0])
            return jnp.sum(o.astype(jnp.float32))
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(x, w1, w3, w2)

    for name, a, b in zip(("x", "w1", "w3", "w2"), grads(mesh),
                          grads(None)):
        rec["grad/" + name] = np.asarray(a)
        rec["grad_local_equal/" + name] = np.array(bool(jnp.all(a == b)))
    mesh2 = jax.make_mesh((1, 4), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    try:
        JM.moe_ffn(x[:, :1], rw, w1, w3, w2, top_k=K, mesh=mesh2)
        rec["c_ref_8"] = np.array("")
    except ValueError as e:
        rec["c_ref_8"] = np.array(str(e).splitlines()[0])
    cfg = registry.get("olmoe-1b-7b").reduced()
    params = build(cfg).init(jax.random.PRNGKey(40))
    toks = jnp.asarray(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (2, 16)), jnp.int32)
    with jax.set_mesh(mesh):
        lg, lax_ = jax.jit(lambda p, t: JT.forward(
            cfg, p, t, mesh, remat=False, moe_data_axes=()))(params, toks)
        rec["fwd/logits"] = np.asarray(lg.astype(jnp.float32))
    lg0, _ = jax.jit(lambda p, t: JT.forward(cfg, p, t, None,
                                             remat=False))(params, toks)
    rec["fwd/local_gap"] = np.asarray(
        jnp.abs(lg.astype(jnp.float32) - lg0.astype(jnp.float32)).max()
        / jnp.abs(lg0.astype(jnp.float32)).max())
    np.savez(out, **{k: (v.view(np.uint16) if v.dtype.name == "bfloat16"
                         else v) for k, v in rec.items()})
""")
SEED = 7


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference's expert-parallel paths on 4 host devices, started
    before the module's first test so that its ~17 s overlap them."""
    out = tmp_path_factory.mktemp("ref") / "ep.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_EP, str(out),
                             str(SEED)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(reference_process):
    out, proc = reference_process
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    rec = dict(np.load(out))
    return {k: (v.view(jnp.bfloat16) if v.dtype == np.uint16 else v)
            for k, v in rec.items()}


def _inputs():
    """The subprocess's x, router and expert weights, from the same seed."""
    rng = np.random.default_rng(SEED)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32)).astype(
        jnp.bfloat16))
    x = bf(rng.standard_normal((2, 12, D)))
    rw = rng.standard_normal((D, E)).astype(np.float32)
    w1, w3 = (bf(rng.standard_normal((E, D, F)) * 0.2) for _ in range(2))
    w2 = bf(rng.standard_normal((E, F, D)) * 0.2)
    j = dict(x=x, rw=rw, w1=w1, w3=w3, w2=w2)
    return j, params_from_numpy(j, device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32)).numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _rel(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().to(torch.float32).numpy()
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _ep(fn):
    """fn(mesh of the rank) on 4 thread ranks of a ("model",) mesh."""
    return run_mesh_threads((EP,), ("model",), fn)


class _Forced:
    """`moe._top_k_experts` returning the reference's choices of call i,
    counted per thread (every rank routes the same tokens); the port's own
    choices where they differ must be near ties."""

    def __init__(self, routes):
        self.routes, self.real = routes, TM._top_k_experts
        self.local = threading.local()
        self.tie = 1.0
        self.lock = threading.Lock()

    def __call__(self, probs, top_k):
        i = getattr(self.local, "calls", 0)
        self.local.calls = i + 1
        own = self.real(probs, top_k)
        want = torch.tensor(np.asarray(self.routes[i]), dtype=own.dtype)
        differ = (own != want).any(-1)
        if bool(differ.any()):
            ratio = (probs.gather(1, want).amin(-1)
                     / probs.gather(1, own).amin(-1))[differ]
            with self.lock:
                self.tie = min(self.tie, float(
                    torch.minimum(ratio, 1 / ratio).min()))
        return want


# ------------------------------------------------------- the collectives --

@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (0, 0), (2, 1)])
def test_thread_all_to_all_is_the_tiled_exchange(split, concat):
    """Rank r's result: chunk r of every rank's tensor along `split`,
    joined along `concat` in rank order (lax.all_to_all tiled=True)."""
    xs = [np.random.default_rng(r).standard_normal((8, 4, 8)).astype(
        np.float32) for r in range(EP)]
    got = run_threads(EP, lambda ax: ax.all_to_all(
        torch.from_numpy(xs[ax.rank]), split, concat))
    for r in range(EP):
        want = np.concatenate([np.split(x, EP, split)[r] for x in xs],
                              concat)
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_thread_pmean_of_a_replicated_value_is_that_value():
    """pmean sums pairwise, so a value every rank holds comes back bit for
    bit (a left fold of 4 equal values can round); axis_index is the
    rank; a psum still folds in rank order."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32) * 1e3)
    got = run_threads(EP, lambda ax: (ax.pmean(a), ax.axis_index(),
                                      ax.psum(a)))
    assert [g[1] for g in got] == list(range(EP))
    for mean, _, total in got:
        assert torch.equal(mean, a)
        assert torch.equal(total, ((a + a) + a) + a)


DIST_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import dist_mesh

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    mesh = dist_mesh((1, 2), ("data", "model"))
    ax = mesh.axis("model")
    with open(out + ".in", "rb") as f:
        xs, ws = pickle.load(f)
    x = torch.from_numpy(xs[rank]).to(torch.bfloat16).requires_grad_(True)
    y = ax.all_to_all(x, 0, 1)
    s = ax.psum(x.float().sum(0))
    m = ax.pmean(x.float().sum(1))
    loss = (y.float() * torch.from_numpy(ws[rank])).sum() + s.sum() + m.sum()
    loss.backward()
    res = [t.detach().float().numpy() for t in (y, s, m, x.grad)]
    res.append(mesh.coords())
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
""")


def test_dist_axis_collectives_match_the_thread_axis(tmp_path):
    """Two gloo processes (`launch.mesh.dist_mesh` over a (1, 2) mesh):
    all_to_all of a bfloat16 tensor, psum and pmean, and their gradients
    (the Functions' backward: the inverse exchange, the summed gradients,
    the own input's gradient for pmean) equal the thread axis's, where one
    backward crosses the ranks' shared graph."""
    r = np.random.default_rng(5)
    xs = [r.standard_normal((4, 6)).astype(np.float32) for _ in range(2)]
    ws = [r.standard_normal((2, 12)).astype(np.float32) for _ in range(2)]
    out = tmp_path / "res"
    (tmp_path / "res.in").write_bytes(pickle.dumps((xs, ws)))
    script = tmp_path / "dist_ranks.py"
    script.write_text(DIST_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen([sys.executable, str(script), str(k),
                               str(tmp_path / "store"), str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    theirs = [pickle.loads((tmp_path / f"res.{k}").read_bytes())
              for k in range(2)]
    x = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
         for a in xs]

    def rank(m):
        ax = m.axis("model")
        y = ax.all_to_all(x[ax.rank], 0, 1)
        s = ax.psum(x[ax.rank].float().sum(0))
        mm = ax.pmean(x[ax.rank].float().sum(1))
        loss = ((y.float() * torch.from_numpy(ws[ax.rank])).sum() + s.sum()
                + mm.sum())
        return loss, [y, s, mm], m.coords()

    mine = run_mesh_threads((1, 2), ("data", "model"), rank)
    grads = torch.autograd.grad(mine[0][0] + mine[1][0], x)
    for k in range(2):
        for a, b in zip(mine[k][1] + [grads[k]], theirs[k][:4]):
            np.testing.assert_array_equal(a.detach().float().numpy(), b)
        assert mine[k][2] == theirs[k][4] == {"data": 0, "model": k}


# ------------------------------------------------------------- the model --

@pytest.fixture(scope="module")
def olmoe():
    jc = JR.get("olmoe-1b-7b").reduced()
    tc = TR.get("olmoe-1b-7b").reduced()
    jp = j_build(jc).init(jax.random.PRNGKey(40))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(SEED + 1).integers(0, jc.vocab, (2, 16))
    return jc, tc, jp, tp, toks


def _reference_routes(jc, jp, toks) -> list:
    """The reference's expert choices of its local forward, layer by
    layer (a `jax.debug.callback` on a wrapped `_route`)."""
    routes, real = [], JM._route

    def route(x_flat, router_w, top_k):
        out = real(x_flat, router_w, top_k)
        jax.debug.callback(lambda gi: routes.append(np.asarray(gi)), out[1],
                           ordered=True)
        return out

    JM._route = route
    try:
        out = JT.forward(jc, jp, jnp.asarray(toks, jnp.int32), None,
                         remat=False)
        jax.effects_barrier()
    finally:
        JM._route = real
    return routes, out


def test_ep_forward_bit_equal_to_one_rank_and_near_the_reference(olmoe):
    """The reduced olmoe's forward with the mesh (4 thread ranks, 2
    experts each): logits and aux bit-equal to the one-rank forward, and,
    with the reference's choices forced in, within LOGIT_TOL of the
    reference's forward; the port's own choices differ only at near
    ties."""
    jc, tc, jp, tp, toks = olmoe
    routes, (jl, jaux) = _reference_routes(jc, jp, toks)
    assert len(routes) == jc.n_layers
    forced = _Forced(routes)
    real = TM._top_k_experts
    TM._top_k_experts = forced
    tt = torch.from_numpy(toks)
    try:
        one = TTr.forward(tc, tp, tt, None, remat=False)
        got = _ep(lambda m: TTr.forward(tc, tp, tt, m, remat=False,
                                        moe_data_axes=()))
    finally:
        TM._top_k_experts = real
    for lg, aux in got:
        np.testing.assert_array_equal(_bits(lg), _bits(one[0]))
        assert _bits(aux) == _bits(one[1])
    assert forced.tie >= 1 - NEAR_TIE, forced.tie
    assert _rel(np.asarray(jl).reshape(32, -1),
                got[0][0].reshape(32, -1)) < LOGIT_TOL
    assert abs(float(got[0][1]) - float(jaux)) < 1e-3


def test_ep_serve_steps_keep_every_pair(olmoe, monkeypatch):
    """Two quantized decode steps with the mesh (each rank its own cache),
    the reference's choices forced in: every rank's logits the same bits,
    within LOGIT_TOL of the port's one-rank step with every pair kept (the
    decode path drops none) and of the reference's local step with every
    pair kept; the port's own choices differ only at near ties."""
    from repro.compression import kv as JKV
    from repro.models import serve as JS
    jc, tc, jp, tp, toks = olmoe
    real_local = JM.moe_ffn_local
    monkeypatch.setattr(JM, "moe_ffn_local", lambda *a, **kw: real_local(
        *a, **{**kw, "capacity_factor": float(jc.moe_experts)}))
    routes, real_route, want = [], JM._route, []

    def route(x_flat, router_w, top_k):
        out = real_route(x_flat, router_w, top_k)
        jax.debug.callback(lambda gi: routes.append(np.asarray(gi)), out[1],
                           ordered=True)
        return out

    monkeypatch.setattr(JM, "_route", route)
    jcache = JS.make_quant_cache(jc, 2, SEQ_KV)
    for i in range(2):
        jl, jcache = JS.serve_step(jc, jp, jcache,
                                   jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                   i, None, JKV.kv_quantizer_config())
        want.append(jl)
    jax.effects_barrier()
    assert len(routes) == 2 * jc.n_layers
    kv = TKV.kv_quantizer_config()
    tt = torch.from_numpy(toks).to(torch.int32)

    def steps(mesh):
        cache = TS.make_quant_cache(tc, 2, SEQ_KV, device="cpu")
        out = []
        for i in range(2):
            lg, cache = TS.serve_step(tc, tp, cache, tt[:, i:i + 1], i, mesh,
                                      kv)
            out.append(lg)
        return out

    forced = _Forced(routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    got = _ep(steps)
    monkeypatch.setattr(TM, "capacity", lambda n, e, k, f=1.0: n * k)
    one = steps(None)
    assert forced.tie >= 1 - NEAR_TIE, forced.tie
    for i in range(2):
        for rank in got:
            np.testing.assert_array_equal(_bits(rank[i]), _bits(got[0][i]))
        ref_one = one[i].numpy()
        assert (np.abs(got[0][i].numpy() - ref_one).max()
                / np.abs(ref_one).max()) < LOGIT_TOL
        assert _rel(want[i], got[0][i]) < LOGIT_TOL


def test_ep_training_step_bit_equal_to_one_rank():
    """`launch.train.value_and_grad` and `make_train_step` on a (1, 4)
    mesh description (the forward on 4 thread ranks, the loss rank 0's,
    one backward over their graph) for a 2-layer MoE: the loss, every
    gradient leaf and the updated parameters bit-equal to the one-rank
    step's (the load-balance loss's pmean differentiates as the value
    every rank holds).  On a (2, 2) mesh the data blocks' mean."""
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build as t_build
    from repro_torch.optim import optimizer as O
    from repro_torch import tree as T
    cfg = TArch(name="tiny-ep", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=512, head_dim=16,
                moe_experts=8, moe_top_k=2)
    bundle = t_build(cfg)
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 33)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    mesh = Mesh((1, EP), ("data", "model"))
    (l1, (c1, a1)), g1 = TL.value_and_grad(bundle, params, batch, None)
    (l4, (c4, a4)), g4 = TL.value_and_grad(bundle, params, batch, mesh)
    for a, b in ((l1, l4), (c1, c4), (a1, a4)):
        assert _bits(a) == _bits(b)
    for a, b in zip(T.leaves(g4), T.leaves(g1)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    one = TL.make_train_step(bundle, None, ocfg)((params, O.init(params,
                                                                 ocfg)),
                                                 batch)
    ep = TL.make_train_step(bundle, mesh, ocfg)((params, O.init(params,
                                                                ocfg)), batch)
    for a, b in zip(T.leaves(ep[0][0]), T.leaves(one[0][0])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # a data axis: each block of rows on its ranks, the blocks' mean
    # (tests/test_torch_dryrun.py holds it against one rank per block)
    (l22, _), g22 = TL.value_and_grad(bundle, params, batch,
                                      Mesh((2, 2), ("data", "model")))
    halves = [TL.value_and_grad(bundle, params,
                                {k: v[i:i + 1] for k, v in batch.items()},
                                None) for i in range(2)]
    assert abs(float(l22) - float(halves[0][0][0] + halves[1][0][0]) / 2
               ) <= 1e-6
    for g, a, b in zip(T.leaves(g22), T.leaves(halves[0][1]),
                       T.leaves(halves[1][1])):
        want = (a.float() + b.float()) / 2
        assert torch.allclose(g.float(), want, rtol=0, atol=2.0 ** -7 * max(
            want.abs().max().item(), 1e-30))


# ---------------------------------------------------------- the MoE FFN --

def test_ep_prefill_bit_equal_to_one_rank_and_near_the_reference(ref):
    """The all-to-all path over 4 thread ranks: out and aux bit-equal to
    the port's one-rank moe_ffn_local on the same choices (pairs drop:
    cap = 6 of a mean load of 6) and to the reference's mesh output (bit-
    equal to its own local one)."""
    assert bool(ref["local_equal"])
    j, t = _inputs()
    x_flat = jnp.asarray(j["x"]).reshape(-1, D)
    want_idx = np.asarray(JM._route(x_flat, jnp.asarray(j["rw"]), K)[1])
    real = TM._top_k_experts
    TM._top_k_experts = _Forced([want_idx] * 2)
    try:
        one_y, one_aux = TM.moe_ffn_local(t["x"], t["rw"], t["w1"], t["w3"],
                                          t["w2"], top_k=K)
        got = _ep(lambda m: TM.moe_ffn(t["x"], t["rw"], t["w1"], t["w3"],
                                       t["w2"], top_k=K, mesh=m,
                                       data_axes=()))
    finally:
        TM._top_k_experts = real
    _, keep, _ = TM.dispatch_slots(torch.from_numpy(want_idx).long(), E,
                                   TM.capacity(24, E, K))
    assert not bool(keep.all())                            # pairs drop
    for y, aux in got:
        np.testing.assert_array_equal(_bits(y), _bits(one_y))
        assert _bits(aux) == _bits(one_aux)
    np.testing.assert_array_equal(_bits(got[0][0]), _ref_bits(ref["y"]))
    assert _bits(got[0][1]) == _ref_bits(ref["aux"])


def test_ep_decode_path_keeps_every_pair(ref):
    """One token a row: the decode path (local experts over all tokens, a
    float32 psum of each rank's bfloat16 partial) on every rank bit-equal
    to the reference's decode path and within MOE_RTOL of the port's
    one-rank path with every pair kept; its aux is the one-rank aux (the
    mean of 4 equal values)."""
    j, t = _inputs()
    x1 = t["x"][:, :1]
    all_kept = TM.moe_ffn_local(x1, t["rw"], t["w1"], t["w3"], t["w2"],
                                top_k=K, capacity_factor=E / K)
    got = _ep(lambda m: TM.moe_ffn(x1, t["rw"], t["w1"], t["w3"], t["w2"],
                                   top_k=K, mesh=m, data_axes=()))
    for y, aux in got:
        np.testing.assert_array_equal(_bits(y), _bits(got[0][0]))
        assert float(aux) == float(all_kept[1])
        ref_one = all_kept[0].to(torch.float32).numpy()
        assert (np.abs(y.float().numpy() - ref_one).max()
                / np.abs(ref_one).max()) < MOE_RTOL
    np.testing.assert_array_equal(_bits(got[0][0]),
                                  _ref_bits(ref["y_decode"]))


def test_ep_gradients_bit_equal_to_one_rank(ref):
    """d sum(out) / d (x, w1, w3, w2) through the all-to-alls (rank 0's
    sum, one backward over the ranks' shared graph): bit-equal to the
    one-rank path's, as the reference's mesh gradients equal its local
    ones (checked in the subprocess); the expert weights' bit-equal to the
    reference's, x's within MOE_RTOL of its largest |value|."""
    for name in ("x", "w1", "w3", "w2"):
        assert bool(ref["grad_local_equal/" + name]), name
    _, t = _inputs()

    def leaves():
        return [t[k].detach().clone().requires_grad_(True)
                for k in ("x", "w1", "w3", "w2")]

    j, _ = _inputs()
    want_idx = np.asarray(JM._route(jnp.asarray(j["x"]).reshape(-1, D),
                                    jnp.asarray(j["rw"]), K)[1])
    real = TM._top_k_experts
    TM._top_k_experts = _Forced([want_idx])
    try:
        one = leaves()
        y, _ = TM.moe_ffn_local(one[0], t["rw"], *one[1:], top_k=K)
        g_one = torch.autograd.grad(y.float().sum(), one)
        ep = leaves()
        sums = _ep(lambda m: TM.moe_ffn(ep[0], t["rw"], *ep[1:], top_k=K,
                                        mesh=m, data_axes=())[0].float().sum())
        g_ep = torch.autograd.grad(sums[0], ep)
    finally:
        TM._top_k_experts = real
    for name, a, b in zip(("x", "w1", "w3", "w2"), g_ep, g_one):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
        if name == "x":
            assert _rel(ref["grad/x"], a) < MOE_RTOL
        else:
            np.testing.assert_array_equal(
                _bits(a), _ref_bits(ref["grad/" + name]), err_msg=name)


def test_data_model_mesh_paths_where_the_reference_fails(ref):
    """On a (1, 4) ("data", "model") mesh the reference's decode path
    stops in shard_map (ROADMAP C-ref-8: its out_specs name the 'data'
    axis, which is not manual); the port's decode and prefill paths there
    equal the ("model",) mesh's bit for bit."""
    assert "must refer to an axis marked as manual" in str(ref["c_ref_8"])
    _, t = _inputs()
    for x in (t["x"][:, :1], t["x"]):
        flat = _ep(lambda m: TM.moe_ffn(x, t["rw"], t["w1"], t["w3"],
                                        t["w2"], top_k=K, mesh=m,
                                        data_axes=()))
        grid = run_mesh_threads((1, EP), ("data", "model"), lambda m:
                                TM.moe_ffn(x, t["rw"], t["w1"], t["w3"],
                                           t["w2"], top_k=K, mesh=m))
        for (a, aa), (b, bb) in zip(flat, grid):
            np.testing.assert_array_equal(_bits(a), _bits(b))
            assert _bits(aa) == _bits(bb)


def test_reference_mesh_forward_is_not_its_local_forward_c_ref_8(ref):
    """The reference's forward on its ("model",) mesh moves its logits off
    its own local forward (its partitioner's sums, and routes that flip at
    near ties: ROADMAP C-ref-8), by more than the serving limit; the
    port's mesh forward is its one-rank forward bit for bit (above)."""
    assert float(ref["fwd/local_gap"]) > LOGIT_TOL


def test_silu_differs_from_xla_in_the_last_bit_c_port_9():
    """On the same bfloat16 values torch's `F.silu` and XLA's silu differ
    on about a third, by one or two bfloat16 ulps (XLA rounds every op of
    x * (1 / (1 + exp(-x))), torch once); the port's `layers.silu`, and
    its gradient, are the jitted reference's bit for bit (ROADMAP
    C-port-9, closed); the experts' products agree bit for bit."""
    import torch.nn.functional as F
    from repro_torch.models.layers import silu
    r = np.random.default_rng(9)
    x, g = (np.asarray(jnp.asarray(r.standard_normal(1000).astype(
        np.float32) * 3).astype(jnp.bfloat16)) for _ in range(2))
    ref, ref_grad = (np.asarray(a.astype(jnp.float32)) for a in jax.jit(
        lambda x, g: (jax.nn.silu(x), jax.vjp(jax.nn.silu, x)[1](g)[0]))(
        jnp.asarray(x), jnp.asarray(g)))
    t = params_from_numpy({"x": x, "g": g}, device="cpu")
    got = F.silu(t["x"]).float().numpy()
    differ = ref != got
    assert differ.sum() > 0
    big = np.maximum(np.abs(ref), np.abs(got)).astype(np.float32)
    ulp = np.spacing(big) * 2.0 ** 16              # a bfloat16 ulp
    assert np.all(np.abs(ref - got)[differ] <= 2 * ulp[differ])
    tx = t["x"].clone().requires_grad_(True)
    y = silu(tx)
    (gx,) = torch.autograd.grad(y, tx, t["g"])
    np.testing.assert_array_equal(y.detach().float().numpy(), ref)
    np.testing.assert_array_equal(gx.float().numpy(), ref_grad)
    w = np.asarray(jnp.asarray(np.random.default_rng(10).standard_normal(
        (4, 16, 8)).astype(np.float32)).astype(jnp.bfloat16))
    b = np.asarray(jnp.asarray(np.random.default_rng(11).standard_normal(
        (4, 6, 16)).astype(np.float32)).astype(jnp.bfloat16))
    j = np.asarray(jnp.einsum("ecd,edf->ecf", b, w).astype(jnp.float32))
    t = params_from_numpy({"w": w, "b": b}, device="cpu")
    np.testing.assert_array_equal(torch.bmm(t["b"], t["w"]).float().numpy(),
                                  j)

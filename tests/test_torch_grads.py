"""Port parity of the compressed gradient all-reduce:
`repro_torch.compression.grads` against `repro.compression.grads`, bit for
bit.  `GradCompressionConfig`'s cap rules; `compress_shard` (wire,
`Quantized` planes, bound, accounting) against the reference's; at p = 1
`compressed_mean` against the reference's own `shard_map` over a
one-device mesh; at p > 1 (threads, `core.axis.run_threads`) each rank's
mean against the reference's decodes of the same wires summed in rank
order, and its residual against the reference's; the lossless overflow
branch; `integrity='drop'`; error feedback over two steps; and the
`torch.distributed` axis on two gloo processes, which must agree with the
thread axis bit for bit.
"""
import functools
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
from jax.sharding import PartitionSpec as P

from repro.compression import grads as JG
from repro.core import select as JS
from repro_torch.compression import grads as TG
from repro_torch.core import select as TS
from repro_torch.core import transport as TT
from repro_torch.core.axis import run_threads
from repro_torch.runtime.guard import FaultPlan

from conftest import shard_map_compat
from test_torch_stages import _u32
from test_torch_transport import ref_gather_sum, to_reference

REPO = Path(__file__).resolve().parents[1]
N = 5120
CFGS = {"plain-8": dict(),
        "narrow-16": dict(pipeline="abs:1.0|pack:16|narrow"),
        "auto": dict(pipeline="auto"),
        "pred": dict(pipeline="delta|abs:1.0|pack:16|narrow|ent")}


def cfgs(name, **kw):
    args = dict(eb_rel=2.0 ** -5, **CFGS[name], **kw)
    return JG.GradCompressionConfig(**args), TG.GradCompressionConfig(**args)


def grads(p, n=N, seed=0):
    """p pods' gradients: a shared N(0,1)*3e-3 part plus a per-pod one."""
    r = np.random.default_rng(seed)
    base = r.standard_normal(n)
    return [((base + 0.5 * r.standard_normal(n)) * 3e-3).astype(np.float32)
            for _ in range(p)]


def bits(a):
    return _u32(a.numpy() if torch.is_tensor(a) else np.asarray(a))


def assert_bits(a, b):
    np.testing.assert_array_equal(bits(a), bits(b))


def spec_of(pipe):
    if isinstance(pipe, (JS.Selector, TS.Selector)):
        return (pipe.spec(), tuple(c.spec() for c in pipe.chains))
    return pipe.spec()


@pytest.mark.parametrize("kw", [
    dict(), dict(bin_bits=16, outlier_cap_frac=1 / 32),
    dict(pipeline="abs:1.0|pack:8|narrow", outlier_cap_frac=1 / 16),
    dict(pipeline="abs:1.0:cap=0.25|pack:8", outlier_cap_frac=1 / 16),
    dict(pipeline="auto", outlier_cap_frac=1 / 32),
    dict(pipeline="auto:sci-plane", outlier_cap_frac=1 / 32)])
def test_config_cap_rules_match_reference(kw):
    """A spec silent about cap= inherits the config's outlier cap; an
    explicit cap= (the selector sets' bases pin 1/64) wins."""
    j = JG.GradCompressionConfig(**kw)
    t = TG.GradCompressionConfig(**kw)
    assert spec_of(t.pipe()) == spec_of(j.pipe())
    assert t.qcfg() == t.pipe().qcfg()
    assert TG.wire_bytes(4099, t) == JG.wire_bytes(4099, j)


def test_config_rejects_a_non_abs_quantizer():
    with pytest.raises(ValueError, match="abs"):
        TG.GradCompressionConfig(pipeline="rel:0.01|pack:8").pipe()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_compress_shard_matches_reference(name):
    """The wire, the local Quantized planes, the bound, the accounting and
    the legacy views equal the reference's."""
    jc, tc = cfgs(name)
    x = grads(1, seed=1)[0]
    j_shard, j_q = JG.compress_shard(jnp.asarray(x), jc, integrity=True)
    t_shard, t_q = TG.compress_shard(torch.from_numpy(x), tc, integrity=True,
                                     device="cpu")
    ref = to_reference(t_shard.enc)
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(j_shard.enc, f)
        if isinstance(a, tuple):
            for u, v in zip(a, b):
                assert_bits(u, v)
        elif a is not None:
            assert_bits(a, b)
    for f in ("bins", "outlier", "recon"):
        assert_bits(getattr(t_q, f), getattr(j_q, f))
    mine, want = t_shard.nbytes(), j_shard.nbytes()
    assert float(mine) == float(want)
    assert t_shard.capacity_nbytes() == j_shard.capacity_nbytes()
    if not isinstance(t_shard.pipe, TS.Selector):
        assert_bits(t_shard.words, j_shard.words)
        assert_bits(t_shard.payload, j_shard.payload)
        if t_shard.pipe.stages:
            assert_bits(t_shard.header_words, j_shard.header_words)


@functools.lru_cache(maxsize=None)
def ref_one_pod(name):
    """The reference's compressed_mean inside its own shard_map over a
    one-device mesh (compiled once per config)."""
    jc, _ = cfgs(name)
    mesh = jax.make_mesh((1,), ("pod",))
    return jax.jit(shard_map_compat(
        lambda g: JG.compressed_mean(g, jc, "pod"), mesh,
        in_specs=P(), out_specs=(P(), P())))


def one_pod(name, x):
    (t_mean, t_res), = run_threads(1, lambda ax: TG.compressed_mean(
        torch.from_numpy(x), cfgs(name)[1], ax, device="cpu"))
    return t_mean, t_res


def test_one_pod_matches_reference_shard_map():
    """At p = 1 the mean and residual of `compressed_mean` equal the
    reference's inside its own shard_map."""
    x = grads(1, seed=2)[0]
    j_mean, j_res = ref_one_pod("plain-8")(jnp.asarray(x))
    t_mean, t_res = one_pod("plain-8", x)
    assert_bits(t_mean, j_mean)
    assert_bits(t_res, j_res)


def _ref_mean_resid(jc, xs, t_shards):
    """Per rank, the reference's mean (its decodes of the same wires summed
    over the gathered axis, / p) and residual (its own compress_shard)."""
    jp = jc.pipe()
    want = ref_gather_sum(jp, [to_reference(s.enc) for s in t_shards])
    mean = want / np.float32(len(xs))
    resid = []
    for x in xs:
        _, q = JG.compress_shard(jnp.asarray(x), jc)
        shipped = np.where(np.asarray(q.outlier), x, np.asarray(q.recon))
        resid.append(x - shipped)
    return mean, resid


@pytest.mark.parametrize("name", ["plain-8", "narrow-16", "auto", "pred"])
def test_two_pods_match_reference(name):
    """Each pod's mean equals the reference's decode-then-sum of both
    pods' wires over 2, its residual the reference's, and every residual
    is within eb (checked in float64)."""
    jc, tc = cfgs(name)
    xs = grads(2, seed=3)
    out = run_threads(2, lambda ax: (
        TG.compress_shard(torch.from_numpy(xs[ax.rank]), tc, device="cpu")[0],
        TG.compressed_mean(torch.from_numpy(xs[ax.rank]), tc, ax,
                           device="cpu")))
    mean, resid = _ref_mean_resid(jc, xs, [o[0] for o in out])
    for r, (shard, (t_mean, t_res)) in enumerate(out):
        assert_bits(t_mean, mean)
        assert_bits(t_res, resid[r])
        eb = float(shard.enc.eb)
        assert np.all(np.abs(t_res.numpy().astype(np.float64)) <= eb)


def test_ring_fires_and_equals_gather():
    """A pair built so the ring rule holds at grad-wire-8 (one grid: x and
    -x have the same rms bit for bit; no outliers: |x| <= 3e-3): the ring
    fires, and its mean equals the gather path's and the reference's."""
    jc, tc = cfgs("plain-8")
    r = np.random.default_rng(4)
    a = (3e-3 * np.tanh(r.standard_normal(N))).astype(np.float32)
    xs = [a, -a]

    def run(ax, tp):
        g = torch.from_numpy(xs[ax.rank])
        shard, _ = TG.compress_shard(g, tc, device="cpu")
        return (tp.uses_ring(shard.enc, shard.pipe, ax), shard,
                TG.compressed_mean(g, tc, ax, transport=tp, device="cpu"))

    ring = run_threads(2, lambda ax: run(ax, TT.TRANSPORT))
    gather = run_threads(2, lambda ax: run(ax, TT.Transport(reduce="gather")))
    mean, resid = _ref_mean_resid(jc, xs, [o[1] for o in ring])
    for r_, (fired, _, (m, res)), (_, _, (mg, _)) in zip(range(2), ring,
                                                         gather):
        assert fired
        assert_bits(m, mg)
        assert_bits(m, mean)
        assert_bits(res, resid[r_])


def test_overflow_takes_the_lossless_branch():
    """An outlier table past its cap on one pod sends every pod to the
    lossless sum: the mean is (x0 + x1) / 2 exactly and the residuals are
    0; at p = 1 it equals the reference's shard_map."""
    _, tc = cfgs("plain-8")
    xs = grads(2, seed=5)
    cap = tc.qcfg().outlier_cap(N)
    xs[1][np.arange(cap + 3) * 7] = 1.0    # three outliers past the cap
    out = run_threads(2, lambda ax: TG.compressed_mean(
        torch.from_numpy(xs[ax.rank]), tc, ax, device="cpu"))
    want = (xs[0] + xs[1]) / np.float32(2)
    for m, res in out:
        assert_bits(m, want)
        assert not torch.count_nonzero(res)
    j_mean, j_res = ref_one_pod("plain-8")(jnp.asarray(xs[1]))
    t_mean, t_res = one_pod("plain-8", xs[1])
    assert_bits(t_mean, j_mean)
    assert_bits(t_res, j_res)
    assert_bits(t_mean, xs[1])


def test_integrity_drop_renormalizes_over_verified_shards():
    """`integrity='drop'` with one gathered shard corrupted
    (`payload_bitflip`): each pod's mean is the reference's arithmetic
    over the shards that verified; a clean run equals the plain mean."""
    jc, tc = cfgs("narrow-16")
    p = 3
    xs = grads(p, seed=6)
    plan = FaultPlan("grads", "payload_bitflip")
    faulty = TT.Transport(fault=plan.corrupt_wire)

    def run(ax):
        g = torch.from_numpy(xs[ax.rank])
        shard, _ = TG.compress_shard(g, tc, integrity=True, device="cpu")
        enc_all, ok = faulty.all_gather(shard.enc, ax, verify="mask")
        return (shard, ok,
                TG.compressed_mean(g, tc, ax, device="cpu")[0],
                TG.compressed_mean(g, tc, ax, integrity="drop",
                                   device="cpu")[0],
                TG.compressed_mean(g, tc, ax, transport=faulty,
                                   integrity="drop", device="cpu")[0])

    out = run_threads(p, run)
    ok = out[0][1].numpy()
    assert ok.sum() == p - 1
    jp = jc.pipe()
    dec = [np.asarray(jp.decode(to_reference(o[0].enc), n=N, kernels=False))
           for o in out]
    w = ok.astype(np.float32)
    s = np.zeros(N, np.float32)
    for i in range(p):
        s = s + dec[i] * w[i]
    want = s / np.maximum(w.sum(), np.float32(1))
    for _, _, plain, clean, bad in out:
        assert_bits(clean, plain)
        assert_bits(bad, want)
    with pytest.raises(ValueError, match="drop"):
        run_threads(1, lambda ax: TG.compressed_mean(
            torch.from_numpy(xs[0]), tc, ax, integrity="raise",
            device="cpu"))


def test_tree_with_error_feedback_over_two_steps():
    """compressed_mean_tree on a dict and on a list: each leaf is its own
    compressed_mean of g + r, and the second step's residual stays within
    its eb."""
    _, tc = cfgs("narrow-16")
    shapes = {"w": (40, 64), "b": (2560,), "emb": (16, 160)}
    r = np.random.default_rng(7)
    tree = [{k: torch.from_numpy((r.standard_normal(s) * 3e-3)
                                 .astype(np.float32)) for k, s in
             shapes.items()} for _ in range(2)]

    def run(ax):
        g = tree[ax.rank]
        res = {k: torch.zeros_like(v) for k, v in g.items()}
        means1, res1 = TG.compressed_mean_tree(g, res, tc, ax, device="cpu")
        means2, res2 = TG.compressed_mean_tree(g, res1, tc, ax, device="cpu")
        by_leaf = {k: TG.compressed_mean(g[k] + res1[k], tc, ax,
                                         device="cpu") for k in g}
        lst = TG.compressed_mean_tree([g[k] for k in g],
                                      [res1[k] for k in g], tc, ax,
                                      device="cpu")
        ebs = {k: float(TG.compress_shard(g[k] + res1[k], tc,
                                          device="cpu")[0].enc.eb)
               for k in g}
        return means2, res2, by_leaf, lst, ebs

    for means2, res2, by_leaf, lst, ebs in run_threads(2, run):
        for i, k in enumerate(shapes):
            assert means2[k].shape == shapes[k]
            assert torch.equal(means2[k], by_leaf[k][0])
            assert torch.equal(res2[k], by_leaf[k][1])
            assert torch.equal(lst[0][i], means2[k])
            assert np.all(np.abs(res2[k].numpy().astype(np.float64))
                          <= ebs[k])


GLOO_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.compression import grads as TG
    from repro_torch.core.axis import DistAxis
    from repro_torch.core.transport import TRANSPORT

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    axis = DistAxis()
    with open(out + ".in", "rb") as f:
        cases = pickle.load(f)
    results = []
    for kw, xs in cases:
        cfg = TG.GradCompressionConfig(**kw)
        g = torch.from_numpy(xs[rank])
        mean, resid = TG.compressed_mean(g, cfg, axis, device="cpu")
        shard, _ = TG.compress_shard(g, cfg, integrity=True, device="cpu")
        ring = TRANSPORT.uses_ring(shard.enc, shard.pipe, axis)
        moved = TRANSPORT.send_pages(shard.enc, 1, 0, axis, verify="mask")
        results.append((mean.numpy(), resid.numpy(), ring,
                        moved[0].payload.numpy(), bool(moved[1])))
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
""")


def test_gloo_axis_agrees_with_the_thread_axis(tmp_path):
    """Two gloo processes (file store under tmp_path) run compressed_mean,
    the ring rule and send_pages through `DistAxis`; every result equals
    the thread axis's bit for bit."""
    r = np.random.default_rng(8)
    a = (3e-3 * np.tanh(r.standard_normal(2048))).astype(np.float32)
    cases = [(dict(eb_rel=2.0 ** -5), [a, -a]),                # the ring
             (dict(eb_rel=2.0 ** -5, pipeline="abs:1.0|pack:16|narrow"),
              grads(2, n=2048, seed=9))]
    out = tmp_path / "res"
    (tmp_path / "res.in").write_bytes(pickle.dumps(cases))
    script = tmp_path / "gloo_ranks.py"
    script.write_text(GLOO_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen([sys.executable, str(script), str(rank),
                               str(tmp_path / "store"), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    dist_res = [pickle.loads((tmp_path / f"res.{k}").read_bytes())
                for k in range(2)]
    for c, (kw, xs) in enumerate(cases):
        cfg = TG.GradCompressionConfig(**kw)

        def run(ax):
            g = torch.from_numpy(xs[ax.rank])
            mean, resid = TG.compressed_mean(g, cfg, ax, device="cpu")
            shard, _ = TG.compress_shard(g, cfg, integrity=True,
                                         device="cpu")
            moved = TT.TRANSPORT.send_pages(shard.enc, 1, 0, ax,
                                            verify="mask")
            return (mean.numpy(), resid.numpy(),
                    TT.TRANSPORT.uses_ring(shard.enc, shard.pipe, ax),
                    moved[0].payload.numpy(), bool(moved[1]))

        for k, mine in enumerate(run_threads(2, run)):
            theirs = dist_res[k][c]
            for u, v in zip(mine, theirs):
                if isinstance(u, np.ndarray):
                    np.testing.assert_array_equal(_u32(u), _u32(v))
                else:
                    assert u == v
        assert dist_res[0][c][2] == (c == 0)       # the ring fired in case 0
        assert dist_res[0][c][4]                   # rank 0 verified rank 1's


def test_chip_smoke_holds_the_wires_the_pods_sent():
    """chip_smoke's `sent_wires` keeps each pod's wire as compressed_mean
    sent it (the same planes as a fresh encode, and the wires the mean
    decodes to), and `grad_bytes_moved` counts each pod's own wire on the
    gather, the word planes on the ring."""
    from test_torch_pipeline import _chip_script
    cs = _chip_script("chip_smoke")
    _, tc = cfgs("narrow-16")
    xs = [torch.from_numpy(x) for x in grads(cs.GRAD_PODS, n=4096, seed=11)]
    xs[1][:1024] = 0                 # one all-zero chunk: a shorter wire
    real = TG.compress_shard
    with cs.sent_wires() as (sent, each_pod):
        means = run_threads(cs.GRAD_PODS, each_pod(
            lambda ax: TG.compressed_mean(xs[ax.rank], tc, ax,
                                          device="cpu")[0]))
    shards = [w[0] for w in sent]
    assert [len(w) for w in sent] == [1] * cs.GRAD_PODS
    for x, s in zip(xs, shards):
        fresh = TG.compress_shard(x, tc, device="cpu")[0]
        for a, b in zip(s.enc, fresh.enc):
            if isinstance(a, torch.Tensor):
                assert_bits(a, b)
    want = sum(s.pipe.decode(s.enc, n=s.n, device="cpu", kernels=False)
               for s in shards) / cs.GRAD_PODS
    for m in means:
        assert_bits(m, want)
    sizes = [float(s.nbytes()) for s in shards]
    assert sizes[0] != sizes[1]          # narrow: each pod's own length
    p = cs.GRAD_PODS
    assert cs.grad_bytes_moved(shards, "gather") == (p - 1) * sum(sizes)
    assert cs.grad_bytes_moved(shards, "ring") == (
        p * (p - 1) * shards[0].enc.payload.numel() * 4)
    assert TG.compress_shard is real                   # the wrap is undone

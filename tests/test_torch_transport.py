"""Port parity of the transport: `repro_torch.core.transport` against
`repro.core.transport`, bit for bit, per rank.  The reference's own
multi-device paths do not run on this JAX (ROADMAP C-ref-2), so each rank
of the port (p threads, `core.axis.run_threads`) is held against
single-process reference calls: the gather sum against the reference's
`Pipeline.decode(kernels=False)` of every rank's wire summed over the
gathered axis, the ring against the exact int32 bin sum dequantized by the
reference's `dequantize_abs`, and the ring against the gather.  At p = 1
the reference runs its own `shard_map` over a one-device mesh.  Also the
§8 run-time rule, the checked reduces under the guard's faults (at the
reference's fault positions), `send_pages`, `verify_gathered`, and the
accounting (`wire_bytes`, `bytes_moved`).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core import audit as JA
from repro.core import codec as JC
from repro.core import select as JS
from repro.core import transport as JT
from repro.core.pipeline import Encoded as JEncoded
from repro.core.pipeline import parse_pipeline as j_parse
from repro.core.quantizer import dequantize_abs as j_dequantize_abs
from repro.runtime import guard as JG
from repro_torch.configs.registry import get_pipeline
from repro_torch.core import audit as TA
from repro_torch.core import interop
from repro_torch.core import select as TS
from repro_torch.core import transport as TT
from repro_torch.core.axis import run_threads
from repro_torch.core.pipeline import parse_pipeline as t_parse
from repro_torch.runtime import guard as TG

from conftest import shard_map_compat
from test_torch_stages import _u32

N = 5120                       # five chunks of words at pack:16
RNG = np.random.default_rng(1710)


def rank_data(p, n=N, seed=0, scale=3e-3):
    """p float32 gradients: a shared N(0,1) part plus a per-rank one."""
    r = np.random.default_rng(seed)
    base = r.standard_normal(n)
    return [((base + 0.5 * r.standard_normal(n)) * scale).astype(np.float32)
            for _ in range(p)]


def rms_eb(x):
    return np.float32(2.0 ** -5 * np.sqrt(np.mean(
        x.astype(np.float64) ** 2)))


def pipes(spec):
    if TS.is_auto_spec(spec):
        return JS.parse_chain(spec), TS.parse_chain(spec)
    spec = get_pipeline(spec)
    return j_parse(spec), t_parse(spec)


def to_reference(wire):
    """The port's wire as the reference's (its encoders give the same
    planes: tests/test_torch_select.py, test_torch_pipeline.py)."""
    if isinstance(wire, TS.SelectedWire):
        cls, planes = JS.SelectedWire, interop.selected_wire_to_numpy(wire)
    else:
        cls, planes = JEncoded, interop.encoded_to_numpy(wire)
    return cls(*[None if f is None else
                 (tuple(map(jnp.asarray, f)) if isinstance(f, tuple)
                  else jnp.asarray(f)) for f in planes])


def encode_both(spec, xs, ebs, integrity=False):
    """Every rank's wire from the port, the same wires as the reference's,
    and those stacked along a leading rank axis (what the reference's
    all_gather gives)."""
    jp, tp = pipes(spec)
    t = [tp.encode(torch.from_numpy(x), None if e is None else torch.tensor(e),
                   device="cpu", integrity=integrity)
         for x, e in zip(xs, ebs)]
    j = [to_reference(w) for w in t]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *j)
    return jp, tp, j, t, stacked


@functools.lru_cache(maxsize=None)
def ref_decode(jp, n):
    """The reference's `decode(kernels=False)` of one wire, jitted once per
    chain and size (its `_gather_sum` decodes under jit too)."""
    return jax.jit(lambda w: jp.decode(w, n=n, kernels=False))


def ref_decodes(jp, wires, n=N):
    """The reference's decode of every rank's wire, stacked in rank order
    (its `_gather_sum` decodes the gathered wire the same way, under
    vmap)."""
    return jnp.stack([ref_decode(jp, n)(w) for w in wires])


def ref_gather_sum(jp, wires, n=N):
    """The reference's `_gather_sum` sum over the gathered axis."""
    return np.asarray(jnp.sum(ref_decodes(jp, wires, n), axis=0))


def on_ranks(t_wires, fn):
    return run_threads(len(t_wires), lambda ax: fn(ax, t_wires[ax.rank]))


def assert_bits(a, b):
    np.testing.assert_array_equal(_u32(a), _u32(np.asarray(b)))


@pytest.mark.parametrize("spec,p", [("grad-wire-8", 2), ("grad-wire-8", 4),
                                    ("grad-wire-16-narrow", 4),
                                    ("grad-wire-pred", 2), ("auto", 2)])
def test_gather_sum_matches_reference(spec, p):
    """Every rank's gather sum (and mean) equals the reference's decode of
    each rank's wire summed over the gathered axis."""
    xs = rank_data(p, seed=p)
    jp, tp, j, t, _ = encode_both(spec, xs, [rms_eb(x) for x in xs])
    want = ref_gather_sum(jp, j)
    gather = TT.Transport(reduce="gather")
    outs = on_ranks(t, lambda ax, w: (gather.reduce_sum(w, tp, N, ax),
                                      TT.TRANSPORT.reduce_mean(w, tp, N, ax),
                                      TT.TRANSPORT.uses_ring(w, tp, ax)))
    for total, mean, ring in outs:
        assert not ring
        assert_bits(total, want)
        assert_bits(mean, np.float32(want) / np.float32(p))


def ring_wires(p, pipe_spec="grad-wire-8", eb=np.float32(1e-3), n=N):
    """Ring-compatible wires: every rank on one grid (the same eb) and no
    outliers (|x| well inside the bins' reach)."""
    xs = rank_data(p, n=n, seed=10 + p)
    return xs, encode_both(pipe_spec, xs, [eb] * p)


@pytest.mark.parametrize("p", [2, 3, 4])
def test_ring_matches_exact_bin_sum_and_gather(p):
    """The ring fires, and its sum equals the exact int32 sum of every
    rank's bins dequantized once by the reference, and the gather path's
    sum, bit for bit; so does a static-bound chain."""
    for spec, eb in (("grad-wire-8", np.float32(1e-3)),
                     ("abs:0.001|pack:16", None)):
        _, (jp, tp, j, t, _) = ring_wires(p, spec, eb)
        qc = jp.qcfg()
        bins = sum(np.asarray(JC.unpack_words(w.payload, N, qc.bin_bits),
                              np.int64) for w in j)
        want = np.asarray(j_dequantize_abs(
            jnp.asarray(bins.astype(np.int32)), qc,
            eb=None if eb is None else jnp.asarray(eb), dtype=jnp.float32))
        gather = TT.Transport(reduce="gather")
        outs = on_ranks(t, lambda ax, w: (
            TT.TRANSPORT.uses_ring(w, tp, ax),
            TT.TRANSPORT.reduce_sum(w, tp, N, ax),
            gather.reduce_sum(w, tp, N, ax)))
        for ring, total, gathered in outs:
            assert ring
            assert_bits(total, want)
            assert_bits(gathered, want)
        assert_bits(outs[0][2], ref_gather_sum(jp, j))


def _mismatched_eb():
    xs = rank_data(2, seed=20)
    return xs, [np.float32(1e-3), np.float32(1.5e-3)]


def _nan_eb():
    xs = rank_data(2, seed=21)
    return xs, [np.float32(1e-3), np.float32(np.nan)]


def _one_outlier():
    xs = rank_data(2, seed=22)
    xs[1][17] = np.inf
    return xs, [np.float32(1e-3)] * 2


@pytest.mark.parametrize("case", [_mismatched_eb, _nan_eb, _one_outlier])
def test_ring_rule_falls_back_to_gather(case):
    """Mismatched eb, a NaN eb and any outlier each send every rank down
    the gather path, whose result is the reference's."""
    xs, ebs = case()
    jp, tp, j, t, _ = encode_both("grad-wire-8", xs, ebs)
    want = ref_gather_sum(jp, j)
    outs = on_ranks(t, lambda ax, w: (TT.TRANSPORT.uses_ring(w, tp, ax),
                                      TT.TRANSPORT.reduce_sum(w, tp, N, ax)))
    for ring, total in outs:
        assert not ring
        assert_bits(total, want)


def test_checked_ring_drops_the_corrupt_hop():
    """`integrity='drop'` on the ring: a clean run counts p and equals the
    unchecked mean; under `hop_bitflip` every received hop fails its
    owner's digest, so each rank counts p - 1 = 1 and its mean is its own
    decode.  The corrupted hop planes equal the reference guard's."""
    xs, (jp, tp, j, t, _) = ring_wires(2)
    t = [tp.encode(torch.from_numpy(x), torch.tensor(np.float32(1e-3)),
                   device="cpu", integrity=True) for x in xs]
    plan = TG.FaultPlan("ring", "hop_bitflip")
    faulty = TT.Transport(fault=plan.corrupt_hop)

    def run(ax, w):
        return (TT.TRANSPORT.reduce_mean(w, tp, N, ax),
                TT.TRANSPORT.reduce_mean(w, tp, N, ax, integrity="drop",
                                         return_valid=True),
                faulty.reduce_mean(w, tp, N, ax, integrity="drop",
                                   return_valid=True))

    for r, (plain, (clean, nv), (bad, nv_bad)) in enumerate(on_ranks(t, run)):
        assert int(nv) == 2 and int(nv_bad) == 1
        assert_bits(clean, plain)
        own = jp.decode(j[r], n=N, kernels=False)
        assert_bits(bad, own)
    hop = (t[1].payload, TA.plane_checksum(t[1].payload))
    j_hop = (j[1].payload, JA.plane_checksum(j[1].payload))
    for a, b in zip(plan.corrupt_hop(hop),
                    JG.FaultPlan("ring", "hop_bitflip").corrupt_hop(j_hop)):
        assert_bits(a, b)


@pytest.mark.parametrize("spec", ["grad-wire-16-narrow", "auto"])
def test_checked_gather_drops_the_corrupt_shard(spec):
    """`payload_bitflip` on one shard of the gathered wire: every rank
    drops it (n_valid = p - 1) and its mean is the other shards' decodes
    over p - 1; the corrupted gathered wire equals the reference guard's
    corruption of its own gathered wire, and `verify_gathered` gives the
    reference's verdicts."""
    p = 3
    xs = rank_data(p, seed=30)
    jp, tp, j, t, stacked = encode_both(spec, xs, [rms_eb(x) for x in xs],
                                        integrity=True)
    plan = TG.FaultPlan("gather", "payload_bitflip")
    j_bad = JG.FaultPlan("gather", "payload_bitflip").corrupt_wire(stacked)
    j_ok = np.asarray(JA.verify_gathered(j_bad))
    assert j_ok.sum() == p - 1
    dec = np.asarray(ref_decodes(jp, j))
    want = np.zeros(N, np.float32)
    for i in range(p):
        want = want + np.where(j_ok[i], dec[i], np.float32(0))
    faulty = TT.Transport(reduce="gather", fault=plan.corrupt_wire)

    def run(ax, w):
        gathered, ok = faulty.all_gather(w, ax, verify="mask")
        return gathered, ok, faulty.reduce_mean(w, tp, N, ax,
                                                integrity="drop",
                                                return_valid=True)

    for gathered, ok, (mean, nv) in on_ranks(t, run):
        for f in gathered._fields:
            a, b = getattr(gathered, f), getattr(j_bad, f)
            if isinstance(a, tuple):
                for u, v in zip(a, b):
                    assert_bits(u, v)
            elif a is not None:
                assert_bits(a, b)
        np.testing.assert_array_equal(ok.numpy(), j_ok)
        assert int(nv) == p - 1
        assert_bits(mean, want / np.float32(p - 1))
    with pytest.raises(TA.WireIntegrityError):
        on_ranks(t, lambda ax, w: faulty.all_gather(w, ax, verify="raise"))


def test_send_pages_moves_one_wire():
    """Rank dst receives rank src's planes bit for bit and verifies them;
    the other ranks receive zeros."""
    xs = rank_data(3, seed=40)
    _, tp, _, t, _ = encode_both("grad-wire-16-narrow", xs,
                                 [rms_eb(x) for x in xs], integrity=True)
    outs = on_ranks(t, lambda ax, w: TT.TRANSPORT.send_pages(
        w, 0, 2, ax, verify="mask"))
    moved, ok = outs[2]
    assert bool(ok)
    for a, b in zip(moved, t[0]):
        if isinstance(a, tuple):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
        elif a is not None:
            assert torch.equal(a, b)
    assert not bool(torch.count_nonzero(outs[1][0].payload))


def test_wire_bytes_and_bytes_moved_match_reference():
    """The one accounting accessor on every wire form equals the
    reference's on the same wires; bytes_moved scales it by p (p - 1) and
    refuses an axis of one rank."""
    xs = rank_data(1, seed=50)
    eb = rms_eb(xs[0])
    for spec in ("grad-wire-8", "grad-wire-16-narrow", "grad-wire-16-ent",
                 "auto"):
        jp, tp, j, t, _ = encode_both(spec, xs, [eb], integrity=True)
        mine = TT.wire_bytes(t[0], pipe=tp, n=N)
        ref = JT.wire_bytes(j[0], pipe=jp, n=N)
        if isinstance(ref, int):
            assert isinstance(mine, int) and mine == ref
        else:
            assert_bits(mine, ref)
        for p in (2, 4):
            moved = TT.TRANSPORT.bytes_moved(t[0], op="reduce_mean",
                                             axis_size=p, pipe=tp, n=N)
            assert float(moved) == float(JT.TRANSPORT.bytes_moved(
                j[0], op="reduce_mean", axis_size=p, pipe=jp, n=N))
        assert TT.TRANSPORT.bytes_moved(t[0], op="send_pages", pipe=tp,
                                        n=N) == mine
        with pytest.raises(ValueError, match="axis_size"):
            TT.TRANSPORT.bytes_moved(t[0], op="all_gather", axis_size=1,
                                     pipe=tp, n=N)
    raw = torch.zeros(N)
    assert TT.wire_bytes(raw) == JT.wire_bytes(jnp.zeros(N)) == 4 * N
    assert TT.wire_bytes((raw, raw[:7])) == 4 * (N + 7)
    with pytest.raises(TypeError):
        TT.wire_bytes(t[0])
    with pytest.raises(ValueError, match="unknown op"):
        TT.TRANSPORT.bytes_moved(raw, op="scatter", axis_size=2)
    with pytest.raises(ValueError, match="reduce"):
        TT.Transport(reduce="tree")


@pytest.mark.parametrize("spec", ["grad-wire-8"])
def test_one_rank_matches_reference_shard_map(spec):
    """At p = 1 the reference runs its own reduce_mean inside shard_map
    over a one-device mesh: the port's (the ring's static rule fails at
    p = 1, so the gather path) equals it bit for bit."""
    x = rank_data(1, seed=60)[0]
    eb = rms_eb(x)
    jp, tp, j, t, _ = encode_both(spec, [x], [eb])
    mesh = jax.make_mesh((1,), ("pod",))

    def f(w):
        return JT.TRANSPORT.reduce_mean(w, jp, N, "pod")

    want = shard_map_compat(f, mesh, in_specs=P(), out_specs=P())(j[0])
    (mine,) = on_ranks(t, lambda ax, w: TT.TRANSPORT.reduce_mean(w, tp, N,
                                                                 ax))
    assert_bits(mine, want)

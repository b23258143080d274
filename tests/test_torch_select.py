"""Port parity of the adaptive chain selector: `repro_torch.core.select`
against `repro.core.select`, bit for bit (no tolerance): every candidate's
float32 cost, the chosen chain id, every `SelectedWire` plane as uint32
bits (checksum included), the decoded floats, `wire_bits` and
`capacity_bytes`, on the `grad-wire` and `sci-plane` sets over the
crc32-seeded suites of `benchmarks/datasets.py` and the special-value
sweep.  Also the `SELECTOR_SETS` mirror, the float32 summation order
`plane_stats` inherits from the reference, the audit plane on selector
wires (the `SelectedWire` checksum branch, `chainid_swap`, the detection
matrix) and `interop` in both directions.  Every input is five chunks of
words long at its pack width (ENT_CHUNKS): the reference's `ent` scans
compile once per chunk count.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.core import audit as JA
from repro.core import select as JS
from repro.runtime import guard as JG
from repro_torch.configs import registry as TR
from repro_torch.core import audit as TA
from repro_torch.core import codec as TC
from repro_torch.core import interop
from repro_torch.core import select as TS
from repro_torch.runtime import guard as TG

from test_torch_stages import ENT_CHUNKS, _u32

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import datasets  # noqa: E402

RNG = np.random.default_rng(1707)


def rms_eb(x):
    """eb = 2**-5 * rms over the finite values (float32), as chip_smoke."""
    f = np.where(np.isfinite(x), x, 0).astype(np.float64)
    return np.float32(2.0 ** -5 * np.sqrt(np.mean(f * f)))


def set_input(set_name, suite):
    """(x, eb, pred_shape): ENT_CHUNKS chunks of words at the set's pack
    width, cut from a dataset suite (or the special-value sweep)."""
    bits = TS.get_selector(set_name).pack.bits
    n = ENT_CHUNKS * 512 * 32 // bits
    if suite == "specials":
        x = datasets.special_values(n)
    elif suite == "nyxplane":
        x = datasets.nyx_plane(256).reshape(-1)[:n]
    elif suite == "iid":
        x = datasets.iid(n)
    else:
        x = datasets.GRAD_SUITES[suite]()[:n]
    x = np.ascontiguousarray(x, np.float32)
    shape = (n // 64, 64)
    # the grad set's eb is the per-tensor bound; the sci set keeps its own
    eb = rms_eb(x) if set_name == "grad-wire" else None
    return x, eb, shape


def _both(set_name):
    return JS.get_selector(set_name), TS.get_selector(set_name)


def assert_selected_equal(t, j):
    for f in JS.SelectedWire._fields:
        a, b = getattr(t, f), getattr(j, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(_u32(a), _u32(np.asarray(b)),
                                      err_msg=f)


@functools.lru_cache(maxsize=None)
def ref_fns(set_name, shape, static_eb):
    """The reference's encode (return_quantized, verify, integrity) and
    decode for one set and input shape, each jitted once: every suite of a
    set has the same shape, so they compile once per set (the eager
    `lax.switch` would compile on every call).  The costs are compared
    eagerly: under jit the reference's compiler fuses chain_cost's
    multiply-add (ROADMAP C-port-5)."""
    j = JS.get_selector(set_name)
    n = int(np.prod(shape))

    def eb_of(eb):
        return None if static_eb else eb

    encode = jax.jit(lambda x, eb: j.encode(
        x, eb_of(eb), pred_shape=shape, return_quantized=True, verify=True,
        integrity=True))
    decode = jax.jit(lambda w: j.decode(w, n=n, pred_shape=shape))
    return encode, decode


def _j_wire(wire):
    return JS.SelectedWire(*[None if f is None else jnp.asarray(f)
                             for f in interop.selected_wire_to_numpy(wire)])


CASES = ([("grad-wire", s) for s in ("gradsmooth", "gradsparse", "gradadv",
                                     "gradwalk", "iid", "specials")]
         + [("sci-plane", s) for s in ("nyxplane", "specials")])


def test_selector_sets_mirror_the_reference():
    assert TR.SELECTOR_SETS == JR.SELECTOR_SETS
    for name in TR.SELECTOR_SETS:
        assert TR.get_selector_set(name) is TR.SELECTOR_SETS[name]
    with pytest.raises(KeyError):
        TR.get_selector_set("nope")
    for name in ("grad-wire", "sci-plane"):
        j, t = _both(name)
        assert [p.spec() for p in t.chains] == [p.spec() for p in j.chains]
        assert t.bias == j.bias and t.spec() == j.spec()


@pytest.mark.parametrize("set_name,suite", CASES)
def test_selector_matches_reference(set_name, suite):
    """score's float32 bits, the chain id, every wire plane (with the
    checksum), the decode, wire_bits and capacity_bytes equal the
    reference's, on the plain path and through the kernel entries (their
    plain versions on the CPU); the wire equals the chosen chain's own
    wire; verify= and return_quantized= agree too."""
    j, t = _both(set_name)
    x, eb, shape = set_input(set_name, suite)
    n = x.size
    eb_t = None if eb is None else torch.tensor(eb)
    j_encode, j_decode = ref_fns(set_name, shape, eb is None)
    eb_j = jnp.float32(0 if eb is None else eb)
    j_costs = np.asarray(j.score(jnp.asarray(x.reshape(shape)),
                                 None if eb is None else eb_j))
    for k in (False, True):
        t_costs = t.score(torch.from_numpy(x.reshape(shape)), eb_t,
                          device="cpu", kernels=k)
        np.testing.assert_array_equal(_u32(t_costs), _u32(j_costs))
    jw, jq, jrep = j_encode(jnp.asarray(x), eb_j)
    for k in (False, True):
        tw, tq, trep = t.encode(torch.from_numpy(x), eb_t, pred_shape=shape,
                                device="cpu", kernels=k,
                                return_quantized=True, verify=True,
                                integrity=True)
        assert_selected_equal(tw, jw)
        for f in jq._fields:
            a, b = getattr(tq, f), getattr(jq, f)
            if b is not None:
                np.testing.assert_array_equal(_u32(a), _u32(np.asarray(b)))
        for f in jrep._fields:
            np.testing.assert_array_equal(
                _u32(getattr(trep, f).reshape(())),
                _u32(np.asarray(getattr(jrep, f))), err_msg=f)
    i = int(tw.chain_id)
    assert i == int(jw.chain_id) == int(np.argmin(j_costs))
    direct = t.chains[i].encode(torch.from_numpy(x), eb_t, device="cpu",
                                pred_shape=shape)
    view = t._view(tw, i, n)
    for f in ("payload", "payload_len", "out_idx", "out_payload", "eb"):
        a, b = getattr(view, f), getattr(direct, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    for a, b in zip(view.headers, direct.headers):
        assert torch.equal(a, b)
    assert bool(JA.verify_wire(jw))
    y_j = _u32(np.asarray(j_decode(jw)))
    for k in (False, True):
        np.testing.assert_array_equal(
            _u32(t.decode(tw, n=n, pred_shape=shape, device="cpu",
                          kernels=k, verify=True)), y_j)
    np.testing.assert_array_equal(_u32(t.wire_bits(tw, n)),
                                  _u32(np.asarray(j.wire_bits(jw, n))))
    np.testing.assert_array_equal(_u32(t.wire_bytes(tw, n)),
                                  _u32(np.asarray(j.wire_bytes(jw, n))))
    assert t.capacity_bytes(tw) == j.capacity_bytes(jw)


def test_selected_wire_crosses_both_ways():
    """A wire selected by either package decodes in the other,
    bit-identically, and the reference's checksum recomputes in the
    port."""
    j, t = _both("grad-wire")
    x, eb, shape = set_input("grad-wire", "gradsparse")
    jw = ref_fns("grad-wire", shape, False)[0](jnp.asarray(x),
                                               jnp.asarray(eb))[0]
    tw = t.encode(torch.from_numpy(x), torch.tensor(eb), device="cpu",
                  integrity=True)
    carried = interop.selected_wire_from_numpy(jw, device="cpu")
    assert_selected_equal(carried, jw)
    np.testing.assert_array_equal(_u32(TA.wire_checksum(carried)),
                                  _u32(np.asarray(JA.wire_checksum(jw))))
    y = _u32(np.asarray(j.decode(jw, n=x.size)))
    np.testing.assert_array_equal(
        _u32(t.decode(carried, n=x.size, device="cpu", verify=True)), y)
    np.testing.assert_array_equal(
        _u32(np.asarray(j.decode(_j_wire(tw), n=x.size, verify=True))), y)


@pytest.mark.parametrize("suite", ["gradsmooth", "gradwalk"])
def test_selector_wire_audit_plane(suite):
    """The SelectedWire branch of the checksum equals the reference's
    `wire_checksum`; every fault class applicable to a selector wire,
    `chainid_swap` included, corrupts the same planes as the reference
    guard and is detected; decode(verify=True) refuses the corrupted
    wire."""
    j, t = _both("grad-wire")
    x, eb, shape = set_input("grad-wire", suite)
    jw = ref_fns("grad-wire", shape, False)[0](jnp.asarray(x),
                                               jnp.asarray(eb))[0]
    tw = t.encode(torch.from_numpy(x), torch.tensor(eb), device="cpu",
                  integrity=True)
    np.testing.assert_array_equal(_u32(TA.wire_checksum(tw)),
                                  _u32(np.asarray(JA.wire_checksum(jw))))
    assert TG.applicable_classes(tw) == JG.applicable_classes(jw)
    assert "chainid_swap" in TG.applicable_classes(tw)
    nc = len(t.chains)
    matrix = TG.detection_matrix(tw, suite=suite, n_chains=nc)
    assert matrix == JG.detection_matrix(jw, suite=suite, n_chains=nc)
    assert all(matrix.values()), matrix
    for cls in TG.applicable_classes(tw):
        bad = TG.FaultPlan(suite, cls, n_chains=nc).corrupt_wire(tw)
        j_bad = JG.FaultPlan(suite, cls, n_chains=nc).corrupt_wire(jw)
        assert_selected_equal(bad, j_bad)
        with pytest.raises(TA.WireIntegrityError):
            t.decode(bad, n=x.size, device="cpu", verify=True)


@pytest.mark.parametrize("n", [33, 100, 256, 1000, 5120, 99_999, 1 << 20])
def test_f32_sum_takes_the_reference_order(n):
    """`codec.f32_sum` rounds as the reference's float32 sum does, on
    sums far past 2^24 where the order shows."""
    v = (RNG.standard_normal(n) * np.exp(4 * RNG.standard_normal(n))
         * 1e6).astype(np.float32)
    np.testing.assert_array_equal(_u32(TC.f32_sum(torch.from_numpy(v))),
                                  _u32(np.asarray(jnp.sum(jnp.asarray(v)))))


def test_f32_sum_of_a_fused_square_c_port_5():
    """ROADMAP C-port-5, pinned: on a plane of up to 32 values the
    reference's jit fuses x * x into its in-order float32 sum (one
    rounding per step) where `codec.f32_sum` of the rounded squares, like
    the reference's eager sum, rounds each square first.  On this
    three-value input the two differ by one ulp."""
    import jax
    v = np.array([984025753, 1047259548, 3171148137],
                 np.uint32).view(np.float32)
    mine = _u32(TC.f32_sum(torch.from_numpy(v) * torch.from_numpy(v)))
    eager = _u32(np.asarray(jnp.sum(jnp.asarray(v) * jnp.asarray(v))))
    fused = _u32(np.asarray(jax.jit(lambda a: jnp.sum(a * a))(v)))
    assert mine == eager
    assert abs(int(fused) - int(mine)) == 1          # one ulp


def test_fused_cost_under_jit_c_port_5():
    """ROADMAP C-port-5, pinned: under jit the reference fuses chain_cost's
    bias term into its add; on the sci-plane set's NYX plane the
    lorenzo|narrow|ent cost then differs by one ulp from the eager
    reference, which the port equals."""
    j, t = _both("sci-plane")
    x, _, shape = set_input("sci-plane", "nyxplane")
    eager = _u32(np.asarray(j.score(jnp.asarray(x.reshape(shape)))))
    fused = _u32(np.asarray(jax.jit(
        lambda a: j.score(a.reshape(shape)))(jnp.asarray(x))))
    mine = _u32(t.score(torch.from_numpy(x.reshape(shape)), device="cpu"))
    np.testing.assert_array_equal(mine, eager)
    assert list(np.nonzero(fused != eager)[0]) == [3]
    assert abs(int(fused[3]) - int(eager[3])) == 1


def test_plane_stats_on_a_large_plane():
    """On 2^20 words (4 Mi bytes, so the ent estimate's float32 sum is far
    past 2^24) every statistic equals the reference's bit for bit."""
    w = RNG.integers(0, 1 << 20, 1 << 20).astype(np.uint32)
    w[: 1 << 18] = 0
    w[1 << 19: (1 << 19) + 4096] = RNG.integers(0, 2 ** 32, 4096,
                                                dtype=np.uint64)
    ref = JS.plane_stats(jnp.asarray(w), w.size)
    mine = TS.plane_stats(torch.from_numpy(w.view(np.int32)), w.size)
    assert float(mine.ent_bits) > 2 ** 24
    for f in JS.PlaneStats._fields:
        np.testing.assert_array_equal(_u32(getattr(mine, f)),
                                      _u32(np.asarray(getattr(ref, f))),
                                      err_msg=f)


def test_selector_grammar_and_validation():
    assert isinstance(TS.parse_chain("auto"), TS.Selector)
    assert TS.parse_chain("auto:sci-plane").name == "sci-plane"
    assert TS.parse_chain("abs:1e-3|pack:8|zero").spec() == \
        "abs:0.001|pack:8|zero"
    assert TS.is_auto_spec("auto:grad-wire") and not TS.is_auto_spec("abs")
    assert TS.get_selector("kv-page") is TS.get_kv_selector("kv-page")
    with pytest.raises(ValueError, match="not an auto spec"):
        TS.parse_selector("abs:1|pack:8")
    base = TS.parse_pipeline("abs:1e-3|pack:16|shuffle|narrow")
    with pytest.raises(ValueError, match="scoreable"):
        TS.Selector("bad", (base,))
    a = TS.parse_pipeline("abs:1e-3|pack:16|narrow")
    b = TS.parse_pipeline("abs:1e-3|pack:8|narrow")
    with pytest.raises(ValueError, match="share"):
        TS.Selector("mixed", (a, b))
    with pytest.raises(ValueError, match="bias"):
        TS.Selector("nobias", (a,), bias=(0.0, 1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu' (this box has a card)")
        TS.get_selector("grad-wire").encode(np.ones(64, np.float32))

"""Port parity of the audit plane: `repro_torch.core.audit` and
`repro_torch.runtime.guard` against `repro.core.audit` and
`repro.runtime.guard`, bit for bit: checksums on every preset's wire (also
carried across by `interop`), `verify=` reports field for field, fault
positions, and the detection matrix (every fault class caught, no false
positive) on all 13 presets.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import audit as JA
from repro.core import pipeline as JP
from repro.runtime import guard as JG
from repro_torch.configs.registry import PIPELINES, get_pipeline
from repro_torch.core import audit as TA
from repro_torch.core import interop
from repro_torch.core import pipeline as TP
from repro_torch.runtime import guard as TG

from test_torch_stages import (ENT_CHUNKS, _chain_input, _u32,
                               assert_wire_equal)

RNG = np.random.default_rng(1609)
REPORT_FIELDS = TA.AuditReport._fields


def _n_for(spec):
    """Values whose packed words make ENT_CHUNKS chunks at the pack width
    (the reference's ent scans then compile once)."""
    return ENT_CHUNKS * 512 * 32 // TP.parse_pipeline(spec).pack.bits


def _j_wire(planes):
    """The reference's Encoded from the port's numpy planes."""
    return JP.Encoded(*[None if f is None else
                        (tuple(map(jnp.asarray, f)) if isinstance(f, tuple)
                         else jnp.asarray(f)) for f in planes])


def assert_report_equal(t, j):
    for f in REPORT_FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(_u32(a.reshape(())), _u32(b), err_msg=f)


def _encode_both(spec, x, eb, **kw):
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    t = tp.encode(x, None if eb is None else torch.tensor(eb), device="cpu",
                  **kw)
    j = jp.encode(jnp.asarray(x), None if eb is None else jnp.asarray(eb),
                  kernels=False, **kw)
    return tp, jp, t, j


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_audit_plane_matches_reference_on_every_preset(name):
    """encode(verify=True, integrity=True) on the CPU path and through the
    kernel entry (plain versions on the CPU): the wire, its checksum and
    the report equal the reference's; the checksum recomputed on the
    reference wire carried across equals it; decode(verify=True) accepts
    the wire, and each package decodes the other's bit-identically; every fault class is detected with no false positive, the
    corrupted planes are the reference guard's, and a NaN-corrupted input
    shows in the report."""
    spec = get_pipeline(name)
    n = _n_for(spec)
    x, eb = _chain_input(spec, n)
    tp, jp, (t, rep), (j, j_rep) = _encode_both(spec, x, eb, verify=True,
                                                integrity=True)
    assert_wire_equal(t, j)
    assert_report_equal(rep, j_rep)
    assert bool(rep.ok()) == bool(j_rep.ok())
    tk, rep_k = tp.encode(x, None if eb is None else torch.tensor(eb),
                          device="cpu", kernels=True, verify=True,
                          integrity=True)
    assert_wire_equal(tk, j)
    assert_report_equal(rep_k, j_rep)
    carried = interop.encoded_from_numpy(j, device="cpu")
    np.testing.assert_array_equal(_u32(TA.wire_checksum(carried)),
                                  _u32(j.checksum))
    assert bool(TA.verify_wire(carried))
    y_j = _u32(np.asarray(jp.decode(j, n=n, kernels=False, verify=True)))
    np.testing.assert_array_equal(
        _u32(tp.decode(t, n=n, device="cpu", verify=True)), y_j)
    # each package decodes the other's wire, carried by interop
    np.testing.assert_array_equal(
        _u32(tp.decode(carried, n=n, device="cpu", verify=True)), y_j)
    np.testing.assert_array_equal(_u32(np.asarray(jp.decode(
        _j_wire(interop.encoded_to_numpy(t)), n=n, kernels=False,
        verify=True))), y_j)

    plan = TG.FaultPlan(name, "nan_input")
    bad_x = plan.corrupt_input(x)
    np.testing.assert_array_equal(
        _u32(bad_x), _u32(np.asarray(JG.FaultPlan(name, "nan_input")
                                     .corrupt_input(x))))
    _, nan_rep = tp.encode(bad_x, None if eb is None else torch.tensor(eb),
                           device="cpu", verify=True)
    _, j_nan_rep = jp.encode(jnp.asarray(bad_x.numpy()),
                             None if eb is None else jnp.asarray(eb),
                             kernels=False, verify=True)
    assert_report_equal(nan_rep, j_nan_rep)
    matrix = TG.detection_matrix(t, suite=name, report=nan_rep)
    assert matrix == {"payload_bitflip": True, "header_bitflip": True,
                      "length_truncate": True, "nan_input": True}
    for cls in TG.applicable_classes(t):
        bad = TG.FaultPlan(name, cls).corrupt_wire(t)
        j_bad = JG.FaultPlan(name, cls).corrupt_wire(j)
        assert_wire_equal(bad, j_bad)
        with pytest.raises(TA.WireIntegrityError):
            tp.decode(bad, n=n, device="cpu", verify=True)


@pytest.mark.parametrize("case", ["int32_bit31", "bool", "float32_specials",
                                  "int8", "empty", "scalar", "large"])
def test_plane_checksum_matches_reference(case):
    a = {
        "int32_bit31": (RNG.integers(0, 2 ** 32, 1000, dtype=np.uint64)
                        | 0x80000000).astype(np.uint32).view(np.int32),
        "bool": RNG.random(777) < 0.3,
        "float32_specials": np.array([np.nan, -0.0, 0.0, np.inf, -np.inf,
                                      1e-42, np.uint32(0x7FC00123)
                                      .view(np.float32), 3.5], np.float32),
        "int8": RNG.integers(-128, 128, 99).astype(np.int8),
        "empty": np.zeros(0, np.int32),
        "scalar": np.int32(-5),
        "large": RNG.integers(-2 ** 31, 2 ** 31, 70001).astype(np.int32),
    }[case]
    got = TA.plane_checksum(torch.from_numpy(np.array(a)))
    np.testing.assert_array_equal(_u32(got),
                                  _u32(np.asarray(JA.plane_checksum(a))))


def test_integrity_is_aux_and_costs_one_word():
    """integrity=True moves no bit of any other plane; the checksum adds 32
    bits to the wire and 4 bytes to the capacity, as in the reference."""
    spec = "abs:0.001:cap=0.015625|pack:16|narrow"
    pipe = TP.parse_pipeline(spec)
    x, _ = _chain_input(get_pipeline("grad-wire-16-narrow"), 4096)
    e0 = pipe.encode(x, device="cpu")
    e1 = pipe.encode(x, device="cpu", integrity=True)
    assert e0.checksum is None and e1.checksum is not None
    for a, b in zip(e0[:-1], e1[:-1]):
        if isinstance(a, tuple):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
        elif a is not None:
            assert torch.equal(a, b)
    assert pipe.capacity_bytes(e1) == pipe.capacity_bytes(e0) + 4
    assert float(pipe.wire_bits(e1, 4096)) == float(pipe.wire_bits(e0, 4096)) + 32
    with pytest.raises(ValueError, match="integrity=True"):
        TA.verify_wire(e0)
    with pytest.raises(ValueError, match="integrity=True"):
        pipe.decode(e0, n=4096, device="cpu", verify=True)
    with pytest.raises(ValueError, match="integrity=True"):
        TG.detection_matrix(e0)


def test_checksum_crosses_packages_both_ways():
    """A port wire's checksum verifies in the reference after
    `interop.encoded_to_numpy`, and a corrupted one does not."""
    spec = get_pipeline("sci-rel-narrow")
    x, _ = _chain_input(spec, 3000)
    t = TP.parse_pipeline(spec).encode(x, device="cpu", integrity=True)
    assert bool(JA.verify_wire(_j_wire(interop.encoded_to_numpy(t))))
    bad = TG.FaultPlan("x", "payload_bitflip").corrupt_wire(t)
    assert not bool(JA.verify_wire(_j_wire(interop.encoded_to_numpy(bad))))


def _report_input(mode, case):
    """(x, spec): normal values with denormal and signed-zero corners; REL
    gets zeros (below its screen, so outliers); `nan` plants non-finite
    values; `overflow` shrinks the table to 2 slots and gives more
    outliers than that (ABS: values past the bin range; REL: its zeros;
    NOA: a constant field, whose zero range sends every value to the
    table)."""
    x = (RNG.standard_normal(3000) * 4).astype(np.float32)
    x[:4] = [1e-42, -0.0, 5e-4, -7.25]
    if mode == "rel":
        x[::37] = 0.0
    if case == "nan":
        x[10:13] = [np.nan, np.inf, -np.inf]
    if case == "overflow":
        if mode == "abs":
            x[20:40] = 1e6
        elif mode == "noa":
            x[:] = 3.0
    cap = 0.0005 if case == "overflow" else 0.125
    return x, f"{mode}:0.001:cap={cap}|pack:16"


@pytest.mark.parametrize("case", ["clean", "nan", "overflow"])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_audit_report_matches_reference(mode, case):
    """The report field for field on clean, NaN-injected and overflowed
    encodes (C-ref-1: the overflowed one reports overflow, not ok)."""
    x, spec = _report_input(mode, case)
    eb = np.float32(0.01) if mode == "abs" else None
    _, _, (t, qt, rep), (j, jq, j_rep) = _encode_both(
        spec, x, eb, verify=True, return_quantized=True)
    assert_wire_equal(t, j)
    assert_report_equal(rep, j_rep)
    for f in ("bins", "outlier", "recon"):
        np.testing.assert_array_equal(_u32(getattr(qt, f)),
                                      _u32(np.asarray(getattr(jq, f))))
    assert bool(rep.ok()) == (case != "overflow")
    assert int(rep.violations) == 0
    assert (int(rep.n_nonfinite) > 0) == (case == "nan")
    report = TA.audit_report(torch.from_numpy(x), qt,
                             TP.parse_pipeline(spec).qcfg(),
                             eb=None if eb is None else torch.tensor(eb))
    if mode != "noa":
        for f in ("violations", "max_err", "n_nonfinite", "n_outliers"):
            assert torch.equal(getattr(report, f), getattr(rep, f)), f


def test_degradation_policies():
    assert sorted(TA.DEGRADATION_POLICIES) == sorted(JA.DEGRADATION_POLICIES)
    with pytest.raises(TA.WireIntegrityError, match="site-a"):
        TA.get_policy("raise")({"site": "site-a"})
    assert TA.get_policy("drop")({}) == "drop"
    assert TA.get_policy("rerequest")({}) == "rerequest"
    with pytest.raises(KeyError, match="unknown degradation policy"):
        TA.get_policy("bogus")
    TA.register_policy("count", lambda ctx: "counted")
    try:
        assert TA.get_policy("count")({}) == "counted"
    finally:
        del TA.DEGRADATION_POLICIES["count"]


def test_fault_plan_contract():
    assert TG.FAULT_CLASSES == JG.FAULT_CLASSES
    with pytest.raises(ValueError, match="unknown fault class"):
        TG.FaultPlan("s", "bogus")
    spec = get_pipeline("grad-wire-8")
    x, eb = _chain_input(spec, 2048)
    t = TP.parse_pipeline(spec).encode(x, torch.tensor(eb), device="cpu",
                                       integrity=True)
    assert TG.applicable_classes(t) == JG.applicable_classes(
        _j_wire(interop.encoded_to_numpy(t)))
    for cls in ("nan_input", "hop_bitflip"):
        with pytest.raises(ValueError, match="not a stored-wire fault"):
            TG.FaultPlan("s", cls).corrupt_wire(t)
    with pytest.raises(ValueError, match="not applicable"):
        TG.FaultPlan("s", "chainid_swap").corrupt_wire(t)
    # the header-free chain falls back to the outlier count
    bad = TG.FaultPlan("s", "header_bitflip").corrupt_wire(t)
    assert not torch.equal(bad.n_outliers, t.n_outliers)
    assert not bool(TA.verify_wire(bad))


def test_corrupt_hop_flips_one_bit_of_the_largest_word_plane():
    plan = TG.FaultPlan("ring", "hop_bitflip")
    words = torch.from_numpy(RNG.integers(-2 ** 31, 2 ** 31, 640)
                             .astype(np.int32))
    hop = (torch.zeros(3, dtype=torch.int32), (words, torch.ones(2)))
    out = plan.corrupt_hop(hop)
    assert torch.equal(out[0], hop[0]) and torch.equal(out[1][1], hop[1][1])
    diff = (out[1][0] ^ words).numpy().view(np.uint32)
    assert np.count_nonzero(diff) == 1
    assert bin(int(diff[diff != 0][0])).count("1") == 1
    assert not torch.equal(TA.plane_checksum(out[1][0]),
                           TA.plane_checksum(words))
    assert plan.corrupt_hop(torch.ones(4)) is not None

"""The port's packed KV wire (`repro_torch.compression.kv`: `PackedKV`,
`pack_kv`/`unpack_kv`, `slice_pages`/`paste_pages`, `kv_wire_bytes`) and
the per-page selector (`core.select.KVSelector`) against the JAX package.

Every plane of every wire (payload, payload_len, headers, the outlier
table, chain_id, checksum) is held bit for bit, as uint32, against
`repro.compression.kv` on one quantized cache with NaN, +-inf, denormal,
all-zero and correlated pages and a page with more outliers than slots;
`wire_bytes` is held exactly equal.  The reference's wires decode in the
port and the port's in the reference.  The fault guard, the transport and
the registry mirrors are checked on the same cache.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.compression import kv as JKV
from repro.configs import base as JB
from repro.configs import registry as JR
from repro.core import select as JS
from repro.core.transport import TRANSPORT as JTP
from repro.core.transport import wire_bytes as j_wire_bytes
from repro_torch.compression import kv as TKV
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.core import audit as TA
from repro_torch.core import interop
from repro_torch.core import select as TS
from repro_torch.core.axis import run_threads
from repro_torch.core.transport import TRANSPORT as TTP
from repro_torch.core.transport import wire_bytes as t_wire_bytes
from repro_torch.runtime import guard as TG

RNG = np.random.default_rng(1812)
CHAINS = [JR.get_kv_chain(n) for n in JR.KV_PAGE_CHAINS] + ["auto"]
FRAGMENTS = ["", "narrow", "shuffle|narrow", "delta|narrow", "lorenzo|zero",
             "narrow|ent"]


def _cache_values(d=16):
    """K [2, 2, 640, d]: normal pages, NaN and +-inf values, a page past
    its outlier slots (inf rows), denormals, an all-zero page, a constant
    page (kvdelta's), a page of one spike over near-zero values (narrow's)
    and a page scaled into the subnormal range."""
    x = (RNG.standard_normal((2, 2, 640, d)) * 0.7).astype(np.float32)
    x[0, 0, 3, 2] = np.nan
    x[0, 0, 7, 5] = -np.inf
    x[0, 1, 130:133, :] = np.inf                     # > cap outliers
    x[1, 0, 260:262, :] = 1e-42
    x[1, 0, 384:512] = 0.0                           # unwritten page
    x[1, 1, 0:128] = 0.5
    x[0, 0, 256:384] = RNG.standard_normal((128, d)) * 1e-3
    x[0, 0, 300, 3] = 5.0
    x[1, 1, 512:640] *= 1e-36
    return x


@pytest.fixture(scope="module")
def caches():
    x = _cache_values()
    jq = JKV.quantize_kv(jnp.asarray(x), JKV.kv_quantizer_config())
    tq = interop.quantized_kv_from_numpy(jq, device="cpu")
    assert bool(np.asarray(jq.overflow).any())
    return jq, tq


def _as_u32(a):
    a = np.asarray(a)
    if a.dtype in (np.float32, np.int32):
        return a.view(np.uint32)
    return a


def _assert_wire_equal(jp, tp):
    got = interop.packed_kv_to_numpy(tp)
    for name in TKV.PackedKV._fields:
        a, b = getattr(jp, name), getattr(got, name)
        if name == "headers":
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(_as_u32(u), _as_u32(v))
        elif a is None or b is None:
            assert a is None and b is None, name
        else:
            a = np.asarray(a)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(_as_u32(a), _as_u32(b),
                                          err_msg=name)


def _assert_qkv_equal(a, b):
    for name, u, v in zip(TKV.QuantizedKV._fields, a, b):
        np.testing.assert_array_equal(_as_u32(np.asarray(u)),
                                      _as_u32(np.asarray(v)), err_msg=name)


@pytest.mark.parametrize("stages,integrity",
                         [(s, True) for s in CHAINS + FRAGMENTS]
                         + [(s, False) for s in ("", "zero", "auto")])
def test_pack_kv_planes_bit_equal(caches, stages, integrity):
    """Every plane of the port's wire equals the reference's as uint32,
    and wire_bytes is exactly the reference's."""
    jq, tq = caches
    jp = JKV.pack_kv(jq, stages=stages, integrity=integrity)
    tp = TKV.pack_kv(tq, stages=stages, integrity=integrity)
    _assert_wire_equal(jp, tp)
    assert float(t_wire_bytes(tp)) == float(j_wire_bytes(jp))
    assert float(tp.wire_nbytes()) == float(jp.wire_nbytes())
    assert tp.nbytes() == jp.nbytes()


@pytest.mark.parametrize("stages", CHAINS + FRAGMENTS)
def test_unpack_kv_roundtrips_both_ways(caches, stages):
    """unpack_kv restores every plane of the cache bit for bit, and each
    package decodes the other's wire."""
    jq, tq = caches
    tp = TKV.pack_kv(tq, stages=stages, integrity=True)
    _assert_qkv_equal(TKV.unpack_kv(tp, verify=True), tq)
    jp = JKV.pack_kv(jq, stages=stages, integrity=True)
    _assert_qkv_equal(TKV.unpack_kv(
        interop.packed_kv_from_numpy(jp, device="cpu"), verify=True), tq)


def test_selector_chooses_per_page_like_reference(caches):
    """The kv-page set picks more than one fragment on this cache, page by
    page as the reference does, and every selected wire's id is one a
    fragment owns."""
    jq, tq = caches
    tp = TKV.pack_kv(tq, stages="auto")
    ids = set(tp.chain_id.reshape(-1).tolist())
    assert ids == {0, 1, 2}
    jsel, tsel = JS.get_kv_selector("kv-page"), TS.get_kv_selector("kv-page")
    assert [("|".join(p.spec() for p in (*pred, *word))) for pred, word in
            jsel.chains] == [("|".join(p.spec() for p in (*pred, *word)))
                             for pred, word in tsel.chains]
    assert tsel.bias == jsel.bias
    wpp = 128 * 16 // 4
    assert [tsel.header_content_bits(i, wpp) for i in range(3)] == [
        jsel.header_content_bits(i, wpp) for i in range(3)]
    assert TS.parse_kv_selector("auto") is tsel
    assert TS.get_selector("kv-page") is tsel
    with pytest.raises(KeyError):
        TS.get_kv_selector("grad-wire")


def test_unpack_kv_rejects_bad_lengths_and_checksums(caches):
    _, tq = caches
    tp = TKV.pack_kv(tq, stages="zero|narrow", integrity=True)
    bad = tp._replace(payload_len=tp.payload_len + 10_000)
    with pytest.raises(TA.WireIntegrityError):
        TKV.unpack_kv(bad)
    flipped = tp._replace(eb2=tp.eb2 * 2.0)
    with pytest.raises(TA.WireIntegrityError):
        TKV.unpack_kv(flipped, verify=True)
    with pytest.raises(ValueError):
        TKV.pack_kv(TKV.QuantizedKV(
            torch.zeros((1, 1, 128, 2), dtype=torch.int8),
            *(t[:1, :1, :1] for t in tq[1:])))


@pytest.mark.parametrize("stages", ["", "zero", "auto"])
def test_guard_detects_every_fault_on_kv_wires(caches, stages):
    """Every stored-wire fault class flips the port's KV checksum (the
    reference's detection matrix for KV wires)."""
    jq, tq = caches
    tp = TKV.pack_kv(tq, stages=stages, integrity=True)
    got = TG.detection_matrix(tp, suite=f"kv-{stages}", n_chains=3)
    jp = JKV.pack_kv(jq, stages=stages, integrity=True)
    from repro.runtime import guard as JG
    want = JG.detection_matrix(jp, suite=f"kv-{stages}", n_chains=3)
    assert got == want and all(got.values())
    for cls in TG.applicable_classes(tp):
        bad_t = TG.FaultPlan(f"kv-{stages}", cls, 3).corrupt_wire(tp)
        bad_j = JG.FaultPlan(f"kv-{stages}", cls, 3).corrupt_wire(jp)
        _assert_wire_equal(bad_j, bad_t)


def test_slice_paste_pages_match_reference(caches):
    jq, tq = caches
    js, ts = JKV.slice_pages(jq, 2, 2), TKV.slice_pages(tq, 2, 2)
    _assert_qkv_equal(js, ts)
    dst = TKV.QuantizedKV(*(torch.zeros_like(t) for t in tq))
    jdst = JKV.QuantizedKV(*(jnp.zeros_like(t) for t in jq))
    _assert_qkv_equal(JKV.paste_pages(jdst, js, 1),
                      TKV.paste_pages(dst, ts, 1))
    assert all(bool((t == 0).all()) for t in dst)     # dst untouched
    one = TKV.unpack_kv(TKV.pack_kv(ts, stages="kvdelta|zero|narrow"))
    _assert_qkv_equal(TKV.paste_pages(tq, one, 2), tq)


def test_kv_wire_bytes_matches_nbytes(caches):
    _, tq = caches
    tp = TKV.pack_kv(tq)
    assert TKV.kv_wire_bytes(tuple(tq.bins.shape)) == tp.nbytes() == \
        JKV.kv_wire_bytes(tuple(tq.bins.shape))
    assert t_wire_bytes(tp) == tp.nbytes()


@pytest.mark.parametrize("stages", ["kvdelta|zero|narrow", "auto"])
def test_send_pages_and_gather_move_kv_wires(caches, stages):
    """Two thread ranks: send_pages delivers rank 0's wire to rank 1 bit
    for bit (zeros elsewhere), the gather stacks both ranks' wires, and
    bytes_moved is the reference's."""
    jq, tq = caches
    other = TKV.QuantizedKV(*(t.flip(0) for t in tq))

    def rank(ax):
        mine = TKV.pack_kv(tq if ax.rank == 0 else other, stages=stages,
                           integrity=True)
        got = TTP.send_pages(mine, 0, 1, ax, verify="mask")
        return mine, got, TKV.gather_kv_packed(mine, ax)

    (w0, (r0, ok0), g0), (w1, (r1, ok1), g1) = run_threads(2, rank)
    assert bool(ok1) and not bool(ok0)
    _assert_qkv_equal(TKV.unpack_kv(r1, verify=True), tq)
    for a, b in zip(g0, g1):
        for u, v in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (a, b))):
            if u is not None:
                np.testing.assert_array_equal(_as_u32(u.numpy()),
                                              _as_u32(v.numpy()))
    assert bool(TA.verify_gathered(g0).all())
    _assert_qkv_equal(TKV.unpack_kv(TA.shard_of(g0, 1)), other)
    jp = JKV.pack_kv(jq, stages=stages, integrity=True)
    assert float(TTP.bytes_moved(w0, op="send_pages")) == float(
        JTP.bytes_moved(jp, op="send_pages"))
    assert float(TTP.bytes_moved(w0, op="all_gather", axis_size=2)) == float(
        JTP.bytes_moved(jp, op="all_gather", axis_size=2))


def test_registry_mirrors_equal_reference():
    """ARCHS, SHAPES, KV_PAGE_CHAINS and get_kv_chain mirror the reference,
    reduced() included."""
    assert list(TR.ARCHS) == list(JR.ARCHS)
    for name, cfg in JR.ARCHS.items():
        mine = TR.get(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(cfg), name
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(
            cfg.reduced()), name
        assert (mine.head_dim, mine.group_size, mine.padded_vocab) == (
            cfg.head_dim, cfg.group_size, cfg.padded_vocab)
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    assert TB.FAMILIES == JB.FAMILIES
    assert TR.KV_PAGE_CHAINS == JR.KV_PAGE_CHAINS
    for name in (*JR.KV_PAGE_CHAINS, "auto", "auto:kv-page", "zero",
                 "shuffle|narrow"):
        assert TR.get_kv_chain(name) == JR.get_kv_chain(name)
    with pytest.raises(KeyError):
        TR.get_kv_chain("no-such-chain")

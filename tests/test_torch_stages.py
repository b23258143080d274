"""Port parity of the `shuffle` and `ent` word stages: `repro_torch.core.codec`
against `repro.core.codec`, and the chains that use them through
`repro_torch.core.pipeline` against `repro.core.pipeline`, bit for bit (no
tolerance): every plane, `wire_bits`, `stage_report` and the decoded floats.
Also the two dispatch repairs (a lone `ent` or `shuffle` stage; a chain
that ends in `shuffle`).  Every `ent` input is five chunks long
(ENT_CHUNKS): the reference's decode scan compiles once per chunk count.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codec as JC
from repro.core import pipeline as JP
from repro_torch.configs.registry import get_pipeline
from repro_torch.core import codec as TC
from repro_torch.core import pipeline as TP

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import datasets  # noqa: E402

RNG = np.random.default_rng(1606)
ENT_CHUNKS = 5
N16 = ENT_CHUNKS * 512 * 2          # values: five chunks of words at pack:16
N32 = ENT_CHUNKS * 512              # and at pack:32
SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42, -1e-40,
                     np.uint32(0x7FC00123).view(np.float32)], np.float32)


def _u32(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _t(a):
    """numpy uint32/int32/float32 -> a writable torch tensor (uint32 as
    int32 bits)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def assert_wire_equal(t, j):
    """Every plane of the port's Encoded equal to the reference's."""
    for f in JP.Encoded._fields:
        a, b = getattr(t, f), getattr(j, f)
        if f == "headers":
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(_u32(u), _u32(v), err_msg=f)
            continue
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(_u32(a), _u32(b), err_msg=f)


def _bits(v):
    return float(v) if torch.is_tensor(v) or hasattr(v, "dtype") else v


# --------------------------------------------------------------- shuffle --

@pytest.mark.parametrize("n_words", [1, 300, 4096 + 5])
@pytest.mark.parametrize("width", [8, 16, 32])
def test_shuffle_matches_reference(width, n_words):
    """Mixed-sign lanes at the stage's width (and words with bit 31 set at
    width 32), against `codec.shuffle_words`; unshuffle inverts it."""
    if width == 32:
        w = RNG.integers(0, 2 ** 32, n_words, dtype=np.uint64)
        w[::3] = RNG.integers(-200, 200, w[::3].size) & 0xFFFFFFFF
        w = w.astype(np.uint32)
    else:
        lanes = RNG.integers(-100, 100, n_words * 32 // width)
        w = np.asarray(JC.pack_words(jnp.asarray(lanes, jnp.int32),
                                     width))[:n_words]
    j = np.asarray(JC.shuffle_words(jnp.asarray(w), width))
    t = TC.shuffle_words(_t(w), width)
    np.testing.assert_array_equal(_u32(t), j)
    back = TC.unshuffle_words(t, n_words, width)
    np.testing.assert_array_equal(_u32(back), w)
    np.testing.assert_array_equal(
        _u32(back), np.asarray(JC.unshuffle_words(jnp.asarray(j), n_words,
                                                  width)))


# ------------------------------------------------------------------ ent ---

def _hists():
    power = (1e6 / np.arange(1, 257) ** 1.5).astype(np.int32)
    return {
        "empty": np.zeros(256, np.int32),
        "all_tied": np.full(256, 7, np.int32),
        "one_symbol": np.r_[[1 << 20], np.zeros(255)].astype(np.int32),
        "ties_and_zeros": RNG.integers(0, 3, 256).astype(np.int32),
        "power_law": RNG.permutation(power),
    }


@pytest.mark.parametrize("case", sorted(_hists()))
def test_ent_codebook_matches_reference(case):
    """Code lengths, the encode table and the decode LUT from one
    histogram; tied counts test the stable sorts."""
    hist = _hists()[case]
    jl = np.asarray(JC.ent_code_lengths(jnp.asarray(hist)))
    tl = TC.ent_code_lengths(_t(hist))
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert np.sum(2.0 ** -jl) <= 1.0
    for a, b in zip(TC.ent_encode_table(tl),
                    JC.ent_encode_table(jnp.asarray(jl))):
        np.testing.assert_array_equal(_u32(a), _u32(np.asarray(b)))
    for a, b in zip(TC.ent_decode_lut(tl), JC.ent_decode_lut(jnp.asarray(jl))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ent_words(n_words):
    """Chunks cycling through all-zero, small bytes, random words (the
    verbatim escape) and small words with bit 31 set."""
    w = np.zeros(n_words, np.uint32)
    for c in range(-(-n_words // 512)):
        s = slice(c * 512, min(n_words, (c + 1) * 512))
        m = s.stop - s.start
        kind = c % 4
        if kind == 1:
            w[s] = RNG.integers(0, 6, m)
        elif kind == 2:
            w[s] = RNG.integers(0, 2 ** 32, m, dtype=np.uint64)
        elif kind == 3:
            w[s] = (RNG.integers(0, 16, m) | 0x80000000).astype(np.uint32)
    return w


@pytest.mark.parametrize("n_words", [ENT_CHUNKS * 512,
                                     (ENT_CHUNKS - 1) * 512 + 77])
def test_ent_words_match_reference(n_words):
    """Every chunk mode (0, 1 and the verbatim 2) and high-bit words, on a
    whole number of chunks and one off a 512 multiple."""
    w = _ent_words(n_words)
    jh, jp, jl = JC.encode_words_ent(jnp.asarray(w))
    th, tp, tl = TC.encode_words_ent(_t(w))
    np.testing.assert_array_equal(_u32(th), np.asarray(jh))
    np.testing.assert_array_equal(_u32(tp), np.asarray(jp))
    assert int(tl) == int(jl)
    modes = TC.unpack_words(th[TC.packed_word_count(256, 4):],
                            -(-n_words // 512), 2, signed=False)
    assert set(modes.tolist()) == {0, 1, 2}
    back = TC.decode_words_ent(th, tp, n_words)
    np.testing.assert_array_equal(_u32(back), w)


def test_ent_decode_of_a_corrupt_codebook_stays_in_bounds():
    """Code lengths past ENT_MAX_LEN in a corrupted header (4-bit fields
    hold up to 15) decode to garbage of the right shape, not an index
    error (on the card: not a device-side assert); the checksum is what
    detects the corruption."""
    w = _ent_words(ENT_CHUNKS * 512)
    th, tp, _ = TC.encode_words_ent(_t(w))
    bad = th.clone()
    bad[:4] = -1                       # 32 code lengths of 15
    out = TC.decode_words_ent(bad, tp, w.size)
    assert out.shape == (w.size,) and out.dtype == torch.int32


# -------------------------------------------------------- chains, parity --

def _grad(n):
    return datasets.GRAD_SUITES["gradsmooth"]()[:n].astype(np.float32)


def _sci(n):
    x = datasets.rel_mixed()[:n].astype(np.float32)
    x[:SPECIALS.size] = SPECIALS
    return x


def _chain_input(spec, n):
    """(x, eb): the grad suite with a per-tensor bound for the grad wires,
    the REL suite with the special values for the others."""
    pipe = TP.parse_pipeline(spec)
    if pipe.quant.eb == 1.0:
        x = _grad(n)
        eb = np.float32(2.0 ** -5 * np.sqrt(np.mean(x.astype(np.float64) ** 2)))
        return x, eb
    return _sci(n), None


def check_chain(spec, n, pred_shape=None):
    """One chain through both pipelines: every plane, wire_bits (with and
    without n), stage_report and the decoded floats; the kernel entry (its
    plain versions on the CPU) gives the same wire."""
    x, eb = _chain_input(spec, n)
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    assert tp.spec() == jp.spec()
    kw = {} if pred_shape is None else {"pred_shape": pred_shape}
    t = tp.encode(x, None if eb is None else torch.tensor(eb), device="cpu",
                  kernels=False, **kw)
    j = jp.encode(jnp.asarray(x), None if eb is None else jnp.asarray(eb),
                  kernels=False, **kw)
    assert_wire_equal(t, j)
    for m in (n, None):
        assert _bits(tp.wire_bits(t, m)) == _bits(jp.wire_bits(j, m))
    assert tp.capacity_bytes(t) == jp.capacity_bytes(j)
    rows_t = tp.stage_report(x, eb, device="cpu", **kw)
    rows_j = jp.stage_report(jnp.asarray(x), eb, **kw)
    assert [(a, _bits(b)) for a, b in rows_t] == \
        [(a, _bits(b)) for a, b in rows_j]
    y = tp.decode(t, n=n, device="cpu", kernels=False, **kw)
    y_j = np.asarray(jp.decode(j, n=n, kernels=False, **kw))
    np.testing.assert_array_equal(_u32(y), _u32(y_j))
    tk = tp.encode(x, None if eb is None else torch.tensor(eb), device="cpu",
                   kernels=True, **kw)
    assert_wire_equal(tk, j)
    np.testing.assert_array_equal(
        _u32(tp.decode(tk, n=n, device="cpu", kernels=True, **kw)), _u32(y_j))
    if not bool(t.overflow):
        bound_holds(x, y.numpy(), tp, t)
    return tp, t


def bound_holds(x, y, pipe, enc):
    """Every value within eb of its original or bit-identical to it (only
    where the table did not overflow: ROADMAP C-ref-1)."""
    cfg = pipe.qcfg()
    eb = np.float64(np.float32(cfg.error_bound if enc.eb is None
                               else enc.eb.item()))
    same = _u32(x) == _u32(y)
    with np.errstate(invalid="ignore"):
        err = np.abs(x.astype(np.float64) - y.astype(np.float64))
    lim = eb * np.abs(x.astype(np.float64)) if cfg.mode == "rel" else eb
    assert np.all(same | (err <= lim))


@pytest.mark.parametrize("name", ["grad-wire-16-ent", "sci-rel-shuffle",
                                  "sci-rel-ent"])
def test_stage_presets_match_reference(name):
    check_chain(get_pipeline(name), N32 if name.startswith("sci") else N16)


@pytest.mark.parametrize("spec", ["abs:0.01|pack:16|ent",
                                  "rel:0.001|pack:8|shuffle"])
def test_lone_word_stage_chains(spec):
    """One stage that is not a chunk stage: the card's dispatch takes the
    pack kernel, not the fused chunk coder, and the wire is the
    reference's."""
    assert TP.parse_pipeline(spec).kernel_dispatch() == \
        "repro_torch.kernels.pack.encode_packed"
    check_chain(spec, N16)


def test_chain_ending_in_shuffle_accounts_like_reference():
    """A static last stage: no transmitted length, an int bit count."""
    spec = "abs:0.01|pack:16|narrow|shuffle:16"
    tp, t = check_chain(spec, N16)
    assert isinstance(tp.wire_bits(t, N16), int)


def test_wire_bits_past_2_24_words_match_reference():
    """`transmitted_bits` past 2^24 words: one float32 rounding, as in the
    reference, for an ent chain with a large transmitted length."""
    spec = get_pipeline("grad-wire-16-ent")
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    x, eb = _chain_input(spec, N16)
    t = tp.encode(x, torch.tensor(eb), device="cpu")
    j = jp.encode(jnp.asarray(x), jnp.asarray(eb), kernels=False)
    for plen in (2 ** 24 - 1, 2 ** 24 + 3, 3 * 2 ** 25 + 7):
        tb = tp.wire_bits(t._replace(payload_len=torch.tensor(
            plen, dtype=torch.int32)), N16)
        jb = jp.wire_bits(j._replace(payload_len=jnp.int32(plen)), N16)
        assert float(tb) == float(jb)


def test_registered_word_stage_roundtrips():
    """`register_stage` adds a word stage to the grammar."""
    TP.register_stage("shuffle8", lambda name, tokens, pack_bits:
                      TP.ShuffleStage(8))
    try:
        pipe = TP.parse_pipeline("abs:0.01|pack:8|shuffle8|narrow")
        assert pipe.stages[0] == TP.ShuffleStage(8)
        x = _grad(2000)
        y = pipe.roundtrip(x, 0.001, device="cpu")
        ref = TP.parse_pipeline("abs:0.01|pack:8|shuffle:8|narrow")
        np.testing.assert_array_equal(
            _u32(y), _u32(ref.roundtrip(x, 0.001, device="cpu")))
    finally:
        del TP.STAGES["shuffle8"]

"""Port parity for the chunked zero/narrow coder: the LC half of
`repro_torch.core.codec`, the plain versions behind the wrappers of
`repro_torch.kernels.lossless`, and `Pipeline` chains with `zero`/`narrow`
stages, against the JAX package's `repro.core.codec`,
`repro.kernels.lossless` (Pallas in interpret mode) and
`repro.core.pipeline`.

No tolerance: every word plane is compared as uint32, `wire_bits` as
float32 bits, and every decoded float as its bit pattern.  Word planes in
the port are int32 tensors holding the uint32 bits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codec as JC
from repro.core import pipeline as JP
from repro.core.config import QuantizerConfig as JCfg
from repro.kernels import lossless as JL
from repro_torch.configs.registry import PIPELINES
from repro_torch.core import audit as TA
from repro_torch.core import codec as TC
from repro_torch.core import interop
from repro_torch.core import pipeline as TP
from repro_torch.core.bitops import pow2approx
from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import lossless as TL

RNG = np.random.default_rng(1201)
CHUNK = TC.LC_CHUNK
PLANES = ("payload", "payload_len", "out_idx", "out_payload", "n_outliers",
          "overflow", "sign_words", "eb")
WORD_SIZES = [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * 4096 + 129]
PATTERNS = ["allzero", "bytes", "shorts", "full", "bit31", "mix"]
LC_PRESETS = ["grad-wire-8-narrow", "grad-wire-16-zero", "grad-wire-16-narrow",
              "sci-abs-narrow", "sci-rel-narrow", "smoke-chain"]


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _t(words):
    """uint32 numpy words -> the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _eq(t, j, what=""):
    np.testing.assert_array_equal(_u32(t.numpy()), _u32(j), err_msg=what)


def _words(n, pattern):
    """A uint32 word stream.  'bit31' words are negative as int32, which
    an int32 max would rank below zero; 'mix' gives each chunk its own
    class, one of them bytes with a single bit-31 word."""
    if pattern == "allzero":
        return np.zeros(n, np.uint32)
    if pattern == "bytes":
        return RNG.integers(0, 1 << 8, n, dtype=np.uint32)
    if pattern == "shorts":
        return RNG.integers(0, 1 << 16, n, dtype=np.uint32)
    if pattern == "full":
        return RNG.integers(1 << 16, 1 << 31, n, dtype=np.uint32)
    if pattern == "bit31":
        w = RNG.integers(0, 1 << 8, n, dtype=np.uint32)
        w[::97] |= np.uint32(1 << 31)
        return w
    w = np.zeros(n, np.uint32)
    for c in range(-(-n // CHUNK)):
        lo, hi = c * CHUNK, min(n, (c + 1) * CHUNK)
        kind = c % 5
        if kind == 1:
            w[lo:hi] = RNG.integers(0, 1 << 8, hi - lo)
        elif kind == 2:
            w[lo:hi] = RNG.integers(0, 1 << 16, hi - lo)
        elif kind == 3:
            w[lo:hi] = RNG.integers(0, 1 << 32, hi - lo, dtype=np.uint64)
        elif kind == 4:
            w[lo:hi] = RNG.integers(0, 1 << 8, hi - lo)
            w[hi - 1] = 0xFFFFFFF0
    return w


def sweep_bins(n, bits, mode):
    """Bins whose packed words give chunk codes 0, 1, 2, 3 in turn (stage
    narrow), chunk by chunk: class 1 keeps every word < 2^8, class 2 every
    word < 2^16, class 3 has words >= 2^16 or with bit 31 set."""
    vpw = 32 // bits
    row = np.arange(n) // 128                     # element row
    cls = (row // (4 * vpw)) % 4                  # the chunk's class
    field = row % vpw                             # bin field in its word
    big = 100_000 if mode == "rel" else 1 << 23
    lim = {8: (100, 100, 100), 16: (255, 30000, 30000),
           32: (255, 65535, big)}[bits]
    b = np.zeros(n, np.int64)
    for k in (1, 2, 3):
        m = cls == k
        if bits == 8:
            m &= field < (1, 2, 4)[k - 1]
            b[m] = RNG.integers(-lim[k - 1], lim[k - 1] + 1, m.sum())
        elif bits == 16:
            m &= field < (1, 1, 2)[k - 1]
            lo = 0 if k == 1 else -lim[k - 1]
            b[m] = RNG.integers(lo, lim[k - 1] + 1, m.sum())
        else:
            lo = {1: 0, 2: 256, 3: -lim[2]}[k]
            b[m] = RNG.integers(lo, lim[k - 1] + 1, m.sum())
    return b


def sweep_field(n, bits, mode, cfg):
    """Float32 values that quantize to sweep_bins exactly (ABS: bin·eb2;
    REL: ±pow2approx(bin·log_step))."""
    bins = sweep_bins(n, bits, mode)
    if mode == "rel":
        _, log_step, _ = cfg.rel_constants()
        mag = pow2approx(torch.from_numpy((bins * float(log_step))
                                          .astype(np.float32))).numpy()
        return np.where(RNG.random(n) < 0.5, -mag, mag).astype(np.float32)
    _, eb2, _ = cfg.abs_constants()
    return (bins * float(eb2)).astype(np.float32)


def _specials(x):
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.uint32(0x7FC00123).view(np.float32), 5e-4]
    return x


def _field(kind, n):
    if kind == "sparse-grad":        # 1 % of 1024-value rows touched
        x = np.zeros(n, np.float32)
        rows = RNG.choice(-(-n // 1024), max(1, n // 102400), replace=False)
        for r in rows:
            x[r * 1024:(r + 1) * 1024] = RNG.standard_normal(
                len(x[r * 1024:(r + 1) * 1024])) * 3e-3
        return _specials(x)
    if kind == "nyx":
        return _specials(np.exp(RNG.standard_normal(n) * 1.4 + 8.0)
                         .astype(np.float32))
    return _specials(np.exp(RNG.standard_normal(n) * 0.02).astype(np.float32))


# ------------------------------------------------------ codec, LC half --

@pytest.mark.parametrize("stage", TC.LC_STAGES)
@pytest.mark.parametrize("n", WORD_SIZES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_codec_lc_matches_reference(pattern, n, stage):
    w = _words(n, pattern)
    jw, tw = jnp.asarray(w), _t(w)
    chunks = np.pad(w, (0, TC.lc_chunk_count(n) * CHUNK - n)).reshape(-1, CHUNK)
    codes = TC.lc_chunk_codes(_t(chunks), stage)
    _eq(codes, JC.lc_chunk_codes(jnp.asarray(chunks), stage), "codes")
    _eq(TC.lc_narrow_chunks(_t(chunks), codes),
        JC.lc_narrow_chunks(jnp.asarray(chunks), jnp.asarray(codes.numpy())),
        "narrowed chunks")
    t, j = TC.encode_words_lc(tw, stage), JC.encode_words_lc(jw, stage)
    for a, b, what in zip(t, j, ("header", "payload", "payload_len")):
        _eq(a, b, what)
    _eq(TC.decode_words_lc(*t[:2], n), JC.decode_words_lc(*j[:2], n))
    _eq(TC.decode_words_lc(*t[:2], n), w)
    assert TC.lc_header_words(n) == JC.lc_header_words(n)
    assert t[0].shape[0] == TC.lc_header_words(n)


@pytest.mark.parametrize("lens", [[512, 700, 3, 0], [600, 600, 600, 600],
                                  [0, 0, 513, 1]])
def test_compact_and_gather_clamp_overlong_lengths(lens):
    """Corrupt lengths past LC_CHUNK: compaction drops what falls outside
    the plane and the gather clamps, as in the reference."""
    sel = RNG.integers(0, 1 << 32, (len(lens), CHUNK), dtype=np.uint64)
    sel = sel.astype(np.uint32)
    tl, jl = torch.tensor(lens, dtype=torch.int32), jnp.asarray(lens, jnp.int32)
    tp_, tlen = TC.compact_chunks(_t(sel), tl)
    jp_, jlen = JC.compact_chunks(jnp.asarray(sel), jl)
    _eq(tp_, jp_, "payload")
    _eq(tlen, jlen, "payload_len")
    _eq(TC.gather_chunks(tp_, tl), JC.gather_chunks(jp_, jl), "gather")


@pytest.mark.parametrize("static_bits", [0, 31, 96, 64 * 1000 + 17])
def test_transmitted_bits_one_rounding(static_bits):
    """int32 word sum, then one float32 conversion: bit-equal past 2^24
    words, where adding float32 bit totals would round twice."""
    for plen in (0, 1, (1 << 24) - 1, (1 << 24) + 1, (1 << 24) + 3,
                 (1 << 30) + 7):
        t = TC.transmitted_bits(torch.tensor(plen, dtype=torch.int32),
                                static_bits)
        j = JC.transmitted_bits(jnp.int32(plen), static_bits)
        assert t.dtype == torch.float32 and t.dim() == 0
        _eq(t, j, f"{plen} + {static_bits}")


def test_lc_constants_and_lengths_match_reference():
    assert TC.LC_CHUNK == JC.LC_CHUNK and TC.LC_STAGES == JC.LC_STAGES
    assert TC._LC_WIDTHS == JC._LC_WIDTHS and TC._LC_LENS == JC._LC_LENS
    codes = torch.arange(4, dtype=torch.int32)
    _eq(TC.lc_chunk_lens(codes), JC.lc_chunk_lens(jnp.arange(4)))
    for k in (1, 15, 16, 17, 1000):
        assert TC.lc_header_content_words(k) == JC.lc_header_content_words(k)
    with pytest.raises(ValueError):
        TC.lc_chunk_codes(torch.zeros(1, CHUNK, dtype=torch.int32), "ent")


# ------------------------------------- kernel plain versions vs Pallas --

@pytest.mark.parametrize("stage", TC.LC_STAGES)
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_encode_packed_lc_matches_pallas(mode, bits, stage):
    """The fused entry (plain versions on the CPU) against the Pallas
    `encode_packed_lc` in interpret mode, on the code sweep with the
    special values up front, at a ragged n."""
    n = 3 * 4096 + 129
    tc = TCfg(mode=mode, error_bound=2.0 ** -7, bin_bits=bits)
    jc = JCfg(mode=mode, error_bound=2.0 ** -7, bin_bits=bits)
    x = _specials(sweep_field(n, bits, "rel" if mode == "rel" else "abs", tc))
    t = TL.encode_packed_lc(torch.from_numpy(x), tc, stage=stage)
    j = JL.encode_packed_lc(jnp.asarray(x), jc, stage=stage, interpret=True)
    for f in t._fields:
        a, b = getattr(t, f), getattr(j, f)
        if a is None:
            assert b is None, f
            continue
        _eq(a, b, f)
    _eq(t.wire_bits(), j.wire_bits(), "wire_bits")
    ref = TC.encode_packed(torch.from_numpy(x), tc)
    for staged in (TC.encode_lossless(ref, stage),
                   TL.encode_lossless(ref, stage)):
        for a, b in zip(staged, t):
            assert (a is None and b is None) or torch.equal(a, b)
    nw = TC.packed_word_count(n, bits)
    for back in (TC.decode_lossless(t, nw), TL.decode_lossless(t, nw)):
        _eq(back.words, ref.words.numpy().view(np.uint32), "words")


@pytest.mark.parametrize("stage", TC.LC_STAGES)
@pytest.mark.parametrize("pattern", ["mix", "bit31", "allzero"])
@pytest.mark.parametrize("n", [1, CHUNK + 1, 10 * CHUNK + 13])
def test_words_lc_wrappers_match_pallas(n, pattern, stage):
    w = _words(n, pattern)
    t = TL.encode_words_lc(_t(w), stage)
    j = JL.encode_words_lc(jnp.asarray(w), stage, interpret=True)
    for a, b, what in zip(t, j, ("header", "payload", "payload_len")):
        _eq(a, b, what)
    _eq(TL.decode_words_lc(*t[:2], n),
        JL.decode_words_lc(j[0], j[1], n, interpret=True))
    header, payload, plen = TL.lc_select(_t(w)[None], stage)
    for a, b, what in zip((header[0], payload[0], plen[0]), j,
                          ("header", "payload", "payload_len")):
        _eq(a, b, what)
    _eq(TL.lc_expand(header, payload, n)[0], w)


def test_select_and_expand_wrappers_match_pallas_launchers():
    """lc_select / lc_expand (plain on the CPU) against the Pallas
    launchers they replace with the reference's compaction, header pack,
    header unpack and gather around them, on a tiled plane whose codes
    sweep 0-3; lc_compact_image on the launcher's own chunk image."""
    n = 16 * CHUNK
    w = _words(n, "mix")
    for stage in TC.LC_STAGES:
        jsel, jcodes = JL.chunk_select_pallas(
            jnp.asarray(w).reshape(-1, 128), stage, wrows=32, interpret=True)
        codes = jnp.asarray(jcodes)[:, 0].astype(jnp.int32)
        jpay, jlen = JC.compact_chunks(jsel.reshape(-1, CHUNK),
                                       JC.lc_chunk_lens(codes))
        jhdr = JC.pack_words(codes, 2)
        for got in (TL.lc_select(_t(w)[None], stage),
                    TL.lc_compact_image(_t(np.array(jsel).reshape(-1)),
                                        _t(np.array(codes)))):
            for a, b, what in zip(got, (jhdr, jpay, jlen),
                                  ("header", "payload", "payload_len")):
                _eq(a[0], b, what)
        padded = JC.gather_chunks(jpay, JC.lc_chunk_lens(codes))
        jback = JL.chunk_expand_pallas(
            padded.reshape(-1, 128),
            jnp.broadcast_to(codes.astype(jnp.uint32)[:, None],
                             (codes.shape[0], 128)),
            wrows=32, interpret=True)
        _eq(TL.lc_expand(_t(np.array(jhdr))[None],
                         _t(np.array(jpay))[None], n)[0],
            np.asarray(jback).reshape(-1))


def test_wrappers_validate_operands():
    with pytest.raises(ValueError, match="stage"):
        TL.lc_select(torch.zeros(1, 8, dtype=torch.int32), "ent")
    with pytest.raises(TypeError):
        TL.lc_select(torch.zeros(1, 8), "zero")
    with pytest.raises(ValueError, match="2-d"):
        TL.lc_select(torch.zeros(8, dtype=torch.int32), "zero")
    with pytest.raises(ValueError, match="lc_expand"):
        TL.lc_expand(torch.zeros(1, 100, dtype=torch.int32),
                     torch.zeros(1, CHUNK, dtype=torch.int32), 100)
    with pytest.raises(ValueError, match="lc_compact_image"):
        TL.lc_compact_image(torch.zeros(100, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))
    header, payload, plen = TL.lc_select(torch.zeros(1, 600,
                                                     dtype=torch.int32),
                                         "zero")
    assert payload.shape == (1, 2 * CHUNK) and plen.tolist() == [0]
    assert header.shape == (1, 128) and not header.any()


# ------------------------------------------- B6 and B7 on rows of streams --

ROW_SIZES = [1, CHUNK - 1, CHUNK, CHUNK + 1, 4 * CHUNK + 129]
ROW_PATTERNS = ("mix", "bit31", "allzero", "bytes", "shorts", "full")


def _rows(rows, n):
    """rows streams of n words, the patterns in turn: every code, bit-31
    words, an all-zero row."""
    return np.stack([_words(n, ROW_PATTERNS[r % len(ROW_PATTERNS)])
                     for r in range(rows)])


@pytest.mark.parametrize("stage", TC.LC_STAGES)
@pytest.mark.parametrize("n", ROW_SIZES)
@pytest.mark.parametrize("rows", [1, 3, 64])
def test_lc_rows_match_pallas_row_by_row(rows, n, stage):
    """B6's and B7's plain versions on R rows (KV pages) against the
    reference one row at a time: chunk_select_pallas -> compact_chunks ->
    pack_words(codes, 2) (`JL.encode_words_lc`) and `JL.decode_words_lc`,
    header, payload with its zero tail, payload_len and words bit for
    bit."""
    w = _rows(rows, n)
    header, payload, plen = TL.lc_select(_t(w), stage)
    nc = TC.lc_chunk_count(n)
    assert header.shape == (rows, TC.lc_header_words(n))
    assert payload.shape == (rows, nc * CHUNK) and plen.shape == (rows,)
    back = TL.lc_expand(header, payload, n)
    _eq(back, w)
    for r in range(rows):
        j = JL.encode_words_lc(jnp.asarray(w[r]), stage, interpret=True)
        for a, b, what in zip((header[r], payload[r], plen[r]), j,
                              ("header", "payload", "payload_len")):
            _eq(a, b, f"row {r} {what}")
        _eq(back[r], JL.decode_words_lc(j[0], j[1], n, interpret=True))


@pytest.mark.parametrize("stage", TC.LC_STAGES)
@pytest.mark.parametrize("n", ROW_SIZES)
def test_lc_compact_image_matches_pallas(n, stage):
    """B5's route: its chunk image and codes compacted by B6's image
    entry give the reference's header, payload and length."""
    w = _words(n, "mix" if n > CHUNK else "bit31")
    sel, codes = TL._lc_image_plain(_t(w), stage)
    got = TL.lc_compact_image(sel, codes)
    j = JL.encode_words_lc(jnp.asarray(w), stage, interpret=True)
    for a, b, what in zip(got, j, ("header", "payload", "payload_len")):
        _eq(a[0], b, what)


@pytest.mark.parametrize("width", [129, 700, 4 * CHUNK + 1])
def test_lc_expand_clips_a_short_payload(width):
    """A payload cut to W words, fewer than the chunks need (and a header
    with every chunk verbatim): source indices clip to W - 1 and slots
    past a chunk's length read 0, as the reference's gather does."""
    n = 4 * CHUNK + 129
    w = _rows(3, n)
    header, payload, _ = TL.lc_select(_t(w), "narrow")
    cut = payload[:, :width]
    got = TL.lc_expand(header, cut, n)
    for r in range(3):
        _eq(got[r], JL.decode_words_lc(jnp.asarray(header[r].numpy()),
                                       jnp.asarray(cut[r].numpy()), n,
                                       interpret=True))
    verbatim = torch.full_like(header, -1)
    got = TL.lc_expand(verbatim, cut, n)
    _eq(got[0], JL.decode_words_lc(jnp.asarray(verbatim[0].numpy()),
                                   jnp.asarray(cut[0].numpy()), n,
                                   interpret=True))


# ----------------------------------------------------------- pipelines --

def _chain_case(name):
    """(spec, x, eb) for a preset or a novel chain."""
    spec = NOVEL.get(name) or PIPELINES.get(name, name)
    n = 5 * 4096 + 77
    if name.startswith("grad"):
        x = _field("sparse-grad", n)
        fin = np.where(np.isfinite(x), x, 0).astype(np.float64)
        return spec, x, np.float32(2.0 ** -5 * np.sqrt(np.mean(fin ** 2)))
    if name == "smoke-chain":
        return spec, _field("near-one", n), None
    if name.startswith("sweep"):
        bits = int(spec.split("pack:")[1].split("|")[0])
        mode = spec.split(":")[0]
        cfg = TP.parse_pipeline(spec).qcfg()
        return spec, _specials(sweep_field(n, bits, mode, cfg)), None
    return spec, _field("nyx", n), None


NOVEL = {"sweep-abs16": "abs:0.0078125|pack:16|narrow",
         "sweep-rel32": "rel:0.001|pack:32|zero|narrow",
         "sweep-abs8": "abs:0.0078125|pack:8|narrow|narrow"}
NOVEL_PLAIN = ["noa:0.001|pack:16|zero", "rel:0.01|pack:16|narrow|zero"]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", LC_PRESETS + list(NOVEL) + NOVEL_PLAIN)
def test_pipeline_lc_matches_reference(name, kernels):
    """Pipeline encode -> Encoded -> decode against the JAX Pipeline: the
    reference path (kernels=False) and the Pallas path in interpret mode
    (kernels=True), every plane, wire_bits, capacity and decoded float."""
    spec, x, eb = _chain_case(name)
    n = x.size
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    assert tp.spec() == jp.spec()
    assert tp.stage_sizes(n) == jp.stage_sizes(n)
    teb = None if eb is None else torch.tensor(eb)
    jeb = None if eb is None else jnp.float32(eb)
    t = tp.encode(x, teb, device="cpu", kernels=kernels)
    j = jp.encode(jnp.asarray(x), jeb, kernels=kernels, interpret=True)
    for f in PLANES:
        a, b = getattr(t, f), getattr(j, f)
        if a is None:
            assert b is None, f
            continue
        _eq(a, b, f)
    assert len(t.headers) == len(j.headers) == len(tp.stages)
    for a, b in zip(t.headers, j.headers):
        _eq(a, b, "header")
    for nn in (n, None):
        wb = tp.wire_bits(t, nn)
        assert torch.is_tensor(wb) and wb.dtype == torch.float32
        _eq(wb, jp.wire_bits(j, nn), "wire_bits")
        _eq(tp.wire_bytes(t, nn), jp.wire_bytes(j, nn), "wire_bytes")
    assert tp.capacity_bytes(t) == jp.capacity_bytes(j)
    y = tp.decode(t, n=n, device="cpu", kernels=kernels).numpy()
    _eq(torch.from_numpy(y), jp.decode(j, n=n, kernels=kernels,
                                       interpret=True), "decoded")
    if name.startswith("sweep"):        # the first narrow stage sees 0-3
        i = [st.spec() for st in tp.stages].index("narrow")
        codes = TC.unpack_words(t.headers[i], TC.lc_chunk_count(
            tp.stage_sizes(n)[i]), 2, signed=False)
        hist = torch.bincount(codes, minlength=4)
        assert (hist >= 0.1 * codes.numel()).all(), hist
    if not bool(t.overflow) and int(t.n_outliers) < n:
        same = _u32(x) == _u32(y)
        with np.errstate(invalid="ignore"):
            err = np.abs(x.astype(np.float64) - y.astype(np.float64))
        cfg = tp.qcfg()
        ebv = np.float64(np.float32(cfg.error_bound if t.eb is None
                                    else t.eb.item()))
        lim = ebv * np.abs(x.astype(np.float64)) if cfg.mode == "rel" else ebv
        assert np.all(same | (err <= lim))


def test_kernel_dispatch_rows():
    one = TP.parse_pipeline("rel:0.001|pack:32|narrow")
    two = TP.parse_pipeline(PIPELINES["smoke-chain"])
    assert one.kernel_dispatch() == "repro_torch.kernels.lossless.encode_packed_lc"
    assert two.kernel_dispatch() == "repro_torch.kernels.pack.encode_packed"
    assert [s.spec() for s in two.stages] == ["zero", "narrow"]
    n = 70_000
    sizes = two.stage_sizes(n)
    assert sizes == JP.parse_pipeline(two.spec()).stage_sizes(n)
    assert sizes[1] == sizes[2] == TC.lc_chunk_count(sizes[0]) * CHUNK


@pytest.mark.parametrize("name", ["sci-rel-narrow", "smoke-chain",
                                  "grad-wire-16-zero"])
def test_interop_carries_lc_wires(name):
    """An LC wire encoded by either package decodes bit-identically in the
    other."""
    spec, x, eb = _chain_case(name)
    n = x.size
    tp, jp = TP.parse_pipeline(spec), JP.parse_pipeline(spec)
    teb = None if eb is None else torch.tensor(eb)
    jeb = None if eb is None else jnp.float32(eb)
    j = jp.encode(jnp.asarray(x), jeb, kernels=False)
    y_j = np.asarray(jp.decode(j, n=n, kernels=False))
    from_j = interop.encoded_from_numpy(j, device="cpu")
    for a, b in zip(from_j.headers, j.headers):
        _eq(a, b, "header")
    _eq(tp.decode(from_j, n=n, device="cpu"), y_j, "JAX wire in the port")
    planes = interop.encoded_to_numpy(tp.encode(x, teb, device="cpu"))
    assert all(h.dtype == np.uint32 for h in planes.headers)
    j_wire = JP.Encoded(*[None if f is None else
                          (tuple(map(jnp.asarray, f)) if isinstance(f, tuple)
                           else jnp.asarray(f)) for f in planes])
    y_t = np.array(jp.decode(j_wire, n=n, kernels=False))
    _eq(torch.from_numpy(y_t), y_j, "port wire in JAX")


def test_lc_payload_len_guard_and_clamp():
    pipe = TP.parse_pipeline("abs:0.001|pack:16|narrow")
    x = _field("nyx", 5000) * np.float32(1e-6)
    enc = pipe.encode(x, device="cpu")
    cap = enc.payload.shape[0]
    for bad in (-1, cap + 1):
        corrupt = enc._replace(payload_len=torch.tensor(bad, dtype=torch.int32))
        with pytest.raises(TA.WireIntegrityError, match="payload_len"):
            pipe.decode(corrupt, n=x.size, device="cpu")
    # a corrupt header (every chunk verbatim) still decodes deterministically
    hdr = torch.full_like(enc.headers[0], -1)
    y = pipe.decode(enc._replace(headers=(hdr,)), n=x.size, device="cpu")
    assert y.shape == (x.size,)


@pytest.mark.parametrize("n", [1, 4 * CHUNK + 129])
def test_chunk_stage_kernel_path_is_one_launch_each_way(n, monkeypatch):
    """With kernels=True a chunk stage is one B6 launch to encode and one
    B7 launch to decode, whatever the row count: on the meta device (the
    card's shapes, nothing computed) it calls none of the reference's
    compaction, gather or 2-bit header pack and unpack."""
    calls = []
    for name in ("compact_chunk_rows", "gather_chunk_rows",
                 "pack_word_rows", "unpack_word_rows", "compact_chunks",
                 "gather_chunks", "pack_words", "unpack_words"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    st = TP.ChunkStage("narrow")
    words = torch.empty(7, n, dtype=torch.int32, device="meta")
    before = dict(TL.LAUNCHES)
    header, payload, plen = st.encode_pages(words, n, kernels=True)
    back = st.decode_pages(header, payload, n, kernels=True)
    assert calls == []
    assert TL.LAUNCHES["_lc_select"] == before["_lc_select"] + 1
    assert TL.LAUNCHES["_lc_expand"] == before["_lc_expand"] + 1
    assert header.shape == (7, TC.lc_header_words(n))
    assert payload.shape == (7, st.capacity_words(n))
    assert plen.shape == (7,) and back.shape == (7, n)

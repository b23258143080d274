"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here carries the `cuda` marker and skips without an NVIDIA card
(CUDA kernels have no CPU mode).  The file imports nothing of JAX, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports JAX).  `chip_smoke.py`
runs the same checks at the main path's full size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.config import QuantizerConfig as TCfg
from repro_torch.kernels import pack as TK

RNG = np.random.default_rng(1106)


def _mix(n):
    """Normal values, the special-value sweep, and exact half-way ties
    (ABS at eb2 = 2**-6, REL at log_step = 2**-10), where rintf's
    round-half-to-even must agree with torch.round."""
    x = (RNG.standard_normal(n) * 10).astype(np.float32)
    k = np.arange(min(n, 4096) // 2)
    ties = np.concatenate([(k - k.size / 2 + 0.5) * 2.0 ** -6,
                           np.ldexp(1.0 + (k % 1000 + 0.5) * 2.0 ** -10,
                                    k % 40 - 20)])
    x[8:8 + ties.size] = ties[:max(0, n - 8)]
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42,
             np.uint32(0x7FC00123).view(np.float32), 5e-4][:n]
    return x


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


def _shifted(t, offset):
    """A copy of t that starts `offset` elements into its storage."""
    return torch.cat([t[:offset], t])[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 4095, 4096 * 3 + 129, 4096 * 8])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_kernels_match_plain_versions_on_card(mode, bits, n, offset):
    """B1-B4 bit for bit against their plain versions: n = 4096 * 8 is
    whole groups of 32 rows (the pack kernel's vector path), 4095 and
    4096 * 3 + 129 end inside a row (the last group takes the guarded
    path), and offset 1 gives an unaligned view (every group guarded)."""
    _need_card()
    cfg = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits)
    x = _shifted(torch.from_numpy(_mix(max(n, 8))[:n]).cuda(), offset)
    before = dict(TK.LAUNCHES)
    if mode == "rel":
        k_out = TK.rel_pack(x, cfg)
        p_out = TK._rel_pack_plain(x, cfg)
    else:
        eb = torch.tensor([7.5e-3], device="cuda")
        k_out = TK.abs_pack(x, eb, cfg)
        p_out = TK._abs_pack_plain(x, eb, cfg)
    for a, b in zip(k_out, p_out):
        assert torch.equal(a, b)
    if mode == "rel":
        y = TK.rel_unpack(k_out[0], k_out[2], n, cfg)
        want = TK._rel_unpack_plain(k_out[0], k_out[2], n, cfg)
    else:
        y = TK.abs_unpack(k_out[0], eb, n, cfg)
        want = TK._abs_unpack_plain(k_out[0], eb, n, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    name = "_rel" if mode == "rel" else "_abs"
    assert TK.LAUNCHES[name + "_pack"] == before[name + "_pack"] + 1
    assert TK.LAUNCHES[name + "_unpack"] == before[name + "_unpack"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["abs:0.01|pack:8", "rel:0.001|pack:16",
                                  "noa:0.001|pack:32"])
def test_pipeline_on_card_matches_cpu(spec):
    """The card's kernel path against the CPU reference, plane by plane."""
    _need_card()
    from repro_torch.core.pipeline import parse_pipeline
    pipe = parse_pipeline(spec)
    x = _mix(9000)
    on_card = pipe.encode(x)
    on_cpu = pipe.encode(x, device="cpu")
    for a, b in zip(on_card, on_cpu):
        if torch.is_tensor(a):
            assert torch.equal(a.cpu(), b)
    y = pipe.decode(on_card, n=x.size).cpu()
    assert torch.equal(y.view(torch.int32),
                       pipe.decode(on_cpu, n=x.size, device="cpu").view(torch.int32))


# ----------------------------------------- the chunk coder (lossless.cu) --

def _sweep_x(n, bits, mode, cfg):
    """Values whose packed words give chunk codes 0, 1, 2, 3 in turn (stage
    narrow): class 1 keeps words < 2^8, class 2 < 2^16, class 3 has words
    >= 2^16 or with bit 31 set; ABS values bin*eb2, REL +-pow2approx."""
    from repro_torch.core.bitops import pow2approx
    vpw = 32 // bits
    row = np.arange(n) // 128
    cls, field = (row // (4 * vpw)) % 4, row % vpw
    big = 100_000 if mode == "rel" else 1 << 23
    spans = {8: ((-100, 100, 1), (-100, 100, 2), (-100, 100, 4)),
             16: ((0, 255, 1), (-30000, 30000, 1), (-30000, 30000, 2)),
             32: ((0, 255, 1), (256, 65535, 1), (-big, big, 1))}[bits]
    bins = np.zeros(n, np.int64)
    for k, (lo, hi, nf) in enumerate(spans, start=1):
        m = (cls == k) & (field < nf)
        bins[m] = RNG.integers(lo, hi + 1, m.sum())
    if mode == "rel":
        _, log_step, _ = cfg.rel_constants()
        mag = pow2approx(torch.from_numpy(
            (bins * float(log_step)).astype(np.float32))).numpy()
        x = np.where(RNG.random(n) < 0.5, -mag, mag).astype(np.float32)
    else:
        x = (bins * float(cfg.abs_constants()[1])).astype(np.float32)
    x[:8] = _mix(8)
    return x


def _equal(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple)
                                                    else (b,))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["zero", "narrow"])
@pytest.mark.parametrize("n", [1, 4095, 4096 * 7 + 129])
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_lc_kernels_match_plain_versions_on_card(mode, bits, n, stage):
    """B5 (fused pack + select), B6 (select) and B7 (expand) against their
    plain versions on the code sweep, with each launch counted."""
    _need_card()
    from repro_torch.kernels import lossless as TL
    cfg = TCfg(mode=mode, error_bound=2.0 ** -7 if mode == "abs" else 1e-3,
               bin_bits=bits)
    x = torch.from_numpy(_sweep_x(max(n, 8), bits, mode, cfg)[:n]).cuda()
    eb = torch.tensor([2.0 ** -7], device="cuda")
    before = dict(TL.LAUNCHES)
    if mode == "rel":
        out = TL.rel_pack_lc(x, cfg, stage)
        _equal(out, TL._rel_pack_lc_plain(x, cfg, stage))
        words = TK.rel_pack(x, cfg)[0]
    else:
        out = TL.abs_pack_lc(x, eb, cfg, stage)
        _equal(out, TL._abs_pack_lc_plain(x, eb, cfg, stage))
        words = TK.abs_pack(x, eb, cfg)[0]
    sel, codes = out[-2], out[-1]
    _equal(TL.lc_compact_image(sel, codes),
           TL._lc_compact_plain(sel, codes[None]))
    rows = words[None]
    header, payload, plen = TL.lc_select(rows, stage)
    _equal((header, payload, plen), TL._lc_select_plain(rows, stage))
    back = TL.lc_expand(header, payload, words.shape[0])
    _equal(back, TL._lc_expand_plain(header, payload, words.shape[0]))
    _equal(back[0], words)
    torch.cuda.synchronize()
    if n > 4096 and stage == "narrow":
        hist = torch.bincount(codes.long(), minlength=4)
        assert (hist >= 0.1 * codes.numel()).all(), hist
    name = "_rel_pack_lc" if mode == "rel" else "_abs_pack_lc"
    assert TL.LAUNCHES[name] == before[name] + 1
    assert TL.LAUNCHES["_lc_select"] == before["_lc_select"] + 2
    assert TL.LAUNCHES["_lc_expand"] == before["_lc_expand"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["zero", "narrow"])
@pytest.mark.parametrize("n_words", [1, 511, 512, 513, 3 * 4096 + 129])
def test_lc_select_expand_on_card_with_bit31_words(n_words, stage):
    """Words with bit 31 set are negative as int32; the select must rank
    them as the largest, in the kernel and in its plain version."""
    _need_card()
    from repro_torch.kernels import lossless as TL
    w = RNG.integers(0, 1 << 8, n_words).astype(np.uint32)
    w[::97] |= np.uint32(1 << 31)
    w[1024:2048] = RNG.integers(0, 1 << 16, len(w[1024:2048]))
    words = torch.from_numpy(w.view(np.int32)).cuda()[None]
    out = TL.lc_select(words, stage)
    _equal(out, TL._lc_select_plain(words, stage))
    assert int(out[0][0, 0]) & 3 == 3
    _equal(TL.lc_expand(out[0], out[1], n_words), words)


def _lc_rows(rows, n, gen):
    """rows streams of n words on the card whose chunks take every code
    (narrow), with bit-31 words and an all-zero row."""
    kind = torch.randint(0, 5, (rows, -(-n // 512)), generator=gen,
                         device="cuda").repeat_interleave(512, 1)[:, :n]
    r = torch.randint(-2 ** 31, 2 ** 31, (rows, n), generator=gen,
                      device="cuda", dtype=torch.int64)
    w = torch.where(kind == 1, r & 0xFF, torch.where(
        kind == 2, r & 0xFFFF, torch.where(kind == 3, r, torch.where(
            kind == 4, (r & 0xFF) | (r & (1 << 31)), 0))))
    w = w.to(torch.int32)
    if rows > 1:
        w[1] = 0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided", "offset"])
@pytest.mark.parametrize("stage", ["zero", "narrow"])
@pytest.mark.parametrize("n", [1, 511, 512, 513, 4 * 512 + 129])
@pytest.mark.parametrize("rows", [1, 3, 64, 1000])
def test_b6_b7_rows_match_plain_versions_on_card(rows, n, stage, layout):
    """B6 and B7 on R rows (KV pages) against their plain versions: rows
    contiguous, rows at a stride past their width, and rows one word off
    16-byte alignment (the kernels' scalar paths); the header read from
    a row-strided view and the payload cut to fewer words than the
    chunks need (clipped reads)."""
    _need_card()
    from repro_torch.kernels import lossless as TL
    gen = torch.Generator(device="cuda").manual_seed(rows * 7919 + n)
    w = _lc_rows(rows, n, gen)
    if layout == "strided":
        w = torch.cat([w, torch.full((rows, 5), -7, dtype=torch.int32,
                                     device="cuda")], 1)[:, :n]
    elif layout == "offset":
        w = torch.cat([w.new_zeros(1), w.reshape(-1)])[1:].view(rows, n)
    before = dict(TL.LAUNCHES)
    got = TL.lc_select(w, stage)
    want = TL._lc_select_plain(w, stage)
    _equal(got, want)
    header, payload, _ = got
    back = TL.lc_expand(header, payload, n)
    _equal(back, w.contiguous())
    wide = torch.cat([header, header], 1)[:, :header.shape[1]]
    cut = payload[:, :max(1, payload.shape[1] // 3)]
    _equal(TL.lc_expand(wide, cut, n), TL._lc_expand_plain(wide, cut, n))
    torch.cuda.synchronize()
    assert TL.LAUNCHES["_lc_select"] == before["_lc_select"] + 1
    assert TL.LAUNCHES["_lc_expand"] == before["_lc_expand"] + 2


@pytest.mark.cuda
def test_b6_b7_long_row_look_back_on_card():
    """One row of 262,144 chunks (16,384 tiles of the look-back scan) and
    the same words as 2 rows of 131,072: every plane equal to the plain
    versions; and the scratch size the wrapper allocates is the C
    entry's."""
    _need_card()
    from repro_torch.kernels import _build
    from repro_torch.kernels import lossless as TL
    gen = torch.Generator(device="cuda").manual_seed(26)
    n = 262_144 * 512
    w = _lc_rows(1, n, gen)
    for rows in (w, w.view(2, n // 2)):
        got = TL.lc_select(rows, "narrow")
        _equal(got, TL._lc_select_plain(rows, "narrow"))
        back = TL.lc_expand(got[0], got[1], rows.shape[1])
        _equal(back, rows)
        del got, back
    lib = _build.load()
    for chunks in (0, 1, 15, 16, 17, 262_144):
        assert lib.repro_lc_scratch_words(chunks) == TL._scratch_words(chunks)


@pytest.mark.cuda
def test_b6_b7_two_thread_ranks_on_two_streams():
    """Two ranks as threads, each on its own stream, calling B6 and B7 at
    once: every call's scratch is its own, so each rank's planes equal
    the plain versions."""
    _need_card()
    from repro_torch.core.axis import run_threads
    from repro_torch.kernels import lossless as TL
    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = [_lc_rows(48, 4 * 512 + 129, gen) for _ in range(2)]
    TL.lc_select(inputs[0], "narrow")                # build first
    torch.cuda.synchronize()

    def rank(ax):
        w = inputs[ax.rank]
        stream = torch.cuda.Stream()
        outs = []
        with torch.cuda.stream(stream):
            for _ in range(20):
                h, p, ln = TL.lc_select(w, "narrow")
                outs.append((h, p, ln, TL.lc_expand(h, p, w.shape[1])))
        stream.synchronize()
        return outs

    for w, outs in zip(inputs, run_threads(2, rank)):
        want = TL._lc_select_plain(w, "narrow")
        for h, p, ln, back in outs:
            _equal((h, p, ln), want)
            _equal(back, w)


@pytest.mark.cuda
def test_b6_b7_one_launch_each_and_a_cuda_graph():
    """Each wrapper call is one kernel (and the memset of its scratch) in
    the profiler's trace, makes no host sync, and captures in a CUDA
    graph whose replay on new words gives the plain versions' planes."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import lossless as TL
    gen = torch.Generator(device="cuda").manual_seed(9)
    n = 4 * 512 + 129
    w = _lc_rows(64, n, gen)
    h, p, _ = TL.lc_select(w, "narrow")             # build and load first
    TL.lc_expand(h, p, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            h, p, _ = TL.lc_select(w, "narrow")
            TL.lc_expand(h, p, n)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"
             and "memset" not in e.name.lower()]
    assert len(names) == 2, names
    assert sum("select_compact_kernel" in x for x in names) == 1, names
    assert sum("gather_expand_kernel" in x for x in names) == 1, names
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            gh, gp, gl = TL.lc_select(w, "narrow")
            gback = TL.lc_expand(gh, gp, n)
    torch.cuda.current_stream().wait_stream(side)
    w.copy_(_lc_rows(64, n, gen))
    graph.replay()
    torch.cuda.synchronize()
    _equal((gh, gp, gl), TL._lc_select_plain(w, "narrow"))
    _equal(gback, w)


@pytest.mark.cuda
def test_chunk_stages_on_card_run_no_torch_compaction(monkeypatch):
    """On the card a chunk stage is B6 and B7 alone: a chain's encode and
    decode and pack_kv / unpack_kv call none of the reference's
    compaction, gather or 2-bit header pack and unpack with a CUDA
    tensor."""
    _need_card()
    from repro_torch.compression import kv as TKV
    from repro_torch.configs.registry import PIPELINES, get_kv_chain
    from repro_torch.core import codec as C
    from repro_torch.core.pipeline import parse_pipeline
    calls = []

    def counted(name, real, bits_at):
        def fn(*a, **k):
            two_bit = bits_at is None or a[bits_at] == 2
            if two_bit and any(torch.is_tensor(t) and t.is_cuda for t in a):
                calls.append(name)
            return real(*a, **k)
        return fn

    for name, bits_at in (("compact_chunk_rows", None),
                          ("gather_chunk_rows", None),
                          ("pack_word_rows", 1), ("unpack_word_rows", 2)):
        monkeypatch.setattr(C, name, counted(name, getattr(C, name),
                                             bits_at))
    x = _mix(20000)
    for name in ("grad-wire-16-narrow", "sci-rel-narrow", "smoke-chain"):
        pipe = parse_pipeline(PIPELINES[name])
        pipe.decode(pipe.encode(x), n=x.size)
    qkv = _kv_wire_case()
    for stages in ("kv-page", "kv-page-narrow", "auto"):
        TKV.unpack_kv(TKV.pack_kv(qkv, stages=get_kv_chain(stages)))
    torch.cuda.synchronize()
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grad-wire-8-narrow", "grad-wire-16-zero",
                                  "grad-wire-16-narrow", "sci-abs-narrow",
                                  "sci-rel-narrow", "smoke-chain",
                                  "noa:0.001|pack:16|zero"])
def test_lc_pipeline_on_card_matches_cpu(name):
    """The chunk-stage chains on the card (B5 or the pack kernel and B6,
    then B7) against the CPU reference, plane by plane."""
    _need_card()
    from repro_torch.configs.registry import PIPELINES
    from repro_torch.core.pipeline import parse_pipeline
    pipe = parse_pipeline(PIPELINES.get(name, name))
    x = _mix(20000)
    x[RNG.random(x.size) < 0.5] = 0.0            # zero chunks and narrow ones
    if name == "smoke-chain":
        x = np.exp(RNG.standard_normal(20000) * 0.02).astype(np.float32)
    eb = torch.tensor(1e-2) if name.startswith("grad") else None
    on_card = pipe.encode(x, None if eb is None else eb.cuda())
    on_cpu = pipe.encode(x, eb, device="cpu")
    for a, b in zip(on_card, on_cpu):
        if isinstance(a, tuple):
            for u, v in zip(a, b):
                assert torch.equal(u.cpu(), v)
        elif torch.is_tensor(a):
            assert torch.equal(a.cpu(), b)
    assert torch.equal(pipe.wire_bits(on_card, x.size).cpu(),
                       pipe.wire_bits(on_cpu, x.size))
    y = pipe.decode(on_card, n=x.size).cpu()
    assert torch.equal(y.view(torch.int32),
                       pipe.decode(on_cpu, n=x.size, device="cpu")
                       .view(torch.int32))


def _up(v):
    return np.nextafter(np.float32(v), np.float32(np.inf))


def _down(v):
    return np.nextafter(np.float32(v), np.float32(-np.inf))


def _pack_edges(cfg, eb):
    """The quantizers' edges: values whose bins are +-(maxbin - 1) and
    +-maxbin and the ties and floats beside them (ABS: (bin + d) * eb2; REL:
    +-pow2approx(bin * log_step)), the REL FTZ screen and float32's tiny
    with their neighbours, denormals, +-0.0, +-inf and NaN payloads."""
    from repro_torch.core.bitops import pow2approx
    f32 = np.float32
    mb = cfg.maxbin
    bins = np.array([mb - 1, mb, 1 - mb, -mb, mb // 2, 0], np.int64)
    vals = [np.inf, -np.inf, np.nan,
            *np.array([0x7FC00123, 0x7F800001, 0xFFC00001, 0x00000001,
                       0x007FFFFF, 0x80000001, 0x807FFFFF, 0x00000000,
                       0x80000000], np.uint32).view(np.float32)]
    tiny = np.finfo(f32).tiny
    edges = [tiny, -tiny]
    if cfg.mode == "rel":
        _, log_step, _ = cfg.rel_constants()
        mag = pow2approx(torch.from_numpy((bins * float(log_step))
                                          .astype(np.float32))).numpy()
        edges += [*mag, *-mag, cfg.rel_screen_threshold(),
                  -cfg.rel_screen_threshold()]
    else:
        eb2 = float(cfg.abs_constants(eb)[1])
        edges += [f32((b + d) * eb2) for b in bins for d in (-0.5, 0.0, 0.5)]
    for e in edges:
        vals += [f32(e), _up(e), _down(e)]
    return np.array(vals, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_pack_kernels_hold_the_quantizer_edges_on_card(mode, bits):
    """B1 and B3 bit for bit against their plain versions on the
    quantizers' edges (`_pack_edges`), placed in a whole group (the vector
    path) and in the ragged last group (the guarded path).  The bounds put
    the bins +-(maxbin - 1) and +-maxbin inside float32's range (REL) and
    inside the field's value range (NOA) where the width allows (REL
    pack:32 bins stop near 2^17 at 1e-3)."""
    _need_card()
    from repro_torch.core import quantizer as TQ
    eb = {"abs": {8: 1e-2, 16: 1e-2, 32: 1e-2},
          "noa": {8: 1e-3, 16: 3e-6, 32: 1e-10},
          "rel": {8: 1.5, 16: 4e-3, 32: 1e-3}}[mode][bits]
    cfg = TCfg(mode=mode, error_bound=eb, bin_bits=bits)
    x = torch.from_numpy(_mix(4096 * 2 + 300))
    x[90:92] = torch.tensor([-1.1e6, 1.1e6])   # the value range's ends
    eb_t = (TQ.value_range_eb(x, cfg) if mode == "noa"
            else torch.tensor(np.float32(7.5e-3))).reshape(1)
    edges = torch.from_numpy(_pack_edges(cfg, eb_t.item()))
    x[100:100 + edges.numel()] = edges
    x[-edges.numel():] = edges
    x, eb_t = x.cuda(), eb_t.cuda()
    if mode == "rel":
        _equal(TK.rel_pack(x, cfg), TK._rel_pack_plain(x, cfg))
    else:
        if mode == "noa":           # the edges stay inside the value range
            assert torch.equal(TQ.value_range_eb(x, cfg).reshape(1), eb_t)
        _equal(TK.abs_pack(x, eb_t, cfg), TK._abs_pack_plain(x, eb_t, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("eb", [float("nan"), 0.0, 2.0 ** -121, -1.0,
                                float("inf"), 3e38])
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_abs_pack_degenerate_and_huge_bounds_on_card(bits, eb):
    """B1 with a traced eb that is NaN, zero, below the floor or negative
    (degenerate: every value an outlier) or whose step overflows, bit for
    bit against its plain version, on whole groups and a ragged one."""
    _need_card()
    cfg = TCfg(mode="abs", error_bound=1e-2, bin_bits=bits)
    eb_t = torch.tensor([eb], dtype=torch.float32, device="cuda")
    for n in (4096 * 2, 4096 * 2 + 300):
        x = torch.from_numpy(_mix(n)).cuda()
        _equal(TK.abs_pack(x, eb_t, cfg), TK._abs_pack_plain(x, eb_t, cfg))


# ------------------- the dense quantize/dequantize kernels (dense.cu) --


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 4095, 4096 * 3 + 129])
@pytest.mark.parametrize("eb", [1e-2, 1e-5])
def test_dense_kernels_match_plain_versions_on_card(eb, n, offset):
    """B8-B11 bit for bit against their plain versions, on the special
    values and the ties; offset 1 gives unaligned views (the scalar
    path)."""
    _need_card()
    from repro_torch.core.bitops import float_to_bits
    from repro_torch.kernels import dense as TD
    x = torch.from_numpy(_mix(max(n + offset, 8))[:n + offset]).cuda()[offset:]
    acfg = TCfg(mode="abs", error_bound=eb)
    rcfg = TCfg(mode="rel", error_bound=eb, bin_bits=32)
    eb_t = torch.tensor(np.float32(eb * 0.75), device="cuda")
    before = dict(TD.LAUNCHES)
    qa = TD.quantize_abs(x, acfg, eb=eb_t)
    _equal(tuple(qa[:3]), tuple(TD._quantize_abs_plain(x, eb_t.reshape(1),
                                                       acfg)[:3]))
    qr = TD.quantize_rel(x, rcfg)
    _equal(tuple(qr), tuple(TD._quantize_rel_plain(x, rcfg)))
    bits = float_to_bits(x)
    pa = torch.where(qa.outlier, bits, torch.zeros_like(bits))
    b, p, o = (_shifted(t, offset) for t in (qa.bins, pa, qa.outlier))
    ya = TD.dequantize_abs(b, p, o, acfg, eb=eb_t)
    _equal(ya.view(torch.int32), TD._dequantize_abs_plain(
        b, p, o, eb_t.reshape(1), acfg).view(torch.int32))
    pr = torch.where(qr.outlier, bits, torch.zeros_like(bits))
    yr = TD.dequantize_rel(qr.bins, pr, qr.outlier, qr.sign, rcfg)
    _equal(yr.view(torch.int32), TD._dequantize_rel_plain(
        qr.bins, pr, qr.outlier, qr.sign, rcfg).view(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(ya.view(torch.int32)[~qa.outlier],
                       qa.recon.view(torch.int32)[~qa.outlier])
    assert torch.equal(ya.view(torch.int32)[qa.outlier],
                       bits[qa.outlier])
    assert torch.equal(yr.view(torch.int32)[qr.outlier], bits[qr.outlier])
    for k in TD.KERNELS:
        assert TD.LAUNCHES[k] == before[k] + 1, k


# ------------------------- the flash-decode attention (kv_attention.cu) --

def _kv_case(b, g, s, hg, d=128):
    from repro_torch.compression import kv as TKV
    k = (RNG.standard_normal((b, g, s, d)) * 0.7).astype(np.float32)
    v = (RNG.standard_normal((b, g, s, d)) * 0.7).astype(np.float32)
    k[:, :, 0, :32] *= 80.0
    v[:, :, 0, :32] *= 80.0
    cfg = TKV.kv_quantizer_config()
    kq = TKV.quantize_kv(torch.from_numpy(k).cuda(), cfg)
    vq = TKV.quantize_kv(torch.from_numpy(v).cuda(), cfg)
    q = torch.from_numpy(RNG.standard_normal((b, g, hg, d))
                         .astype(np.float32)).cuda()
    return q, kq, vq


def _fill_page_outliers(qkv, page=1, b=0, g=0):
    """qkv with cap exact outlier values on page `page` of (b, g): their
    bins zeroed and the slots filled in ascending order, as the encoder
    would leave them (the default bound makes no finite outliers)."""
    cap = qkv.out_idx.shape[-1]
    d = qkv.bins.shape[-1]
    idx = np.sort(RNG.choice(128 * d, cap, replace=False))
    val = RNG.uniform(-300.0, 300.0, cap).astype(np.float32)
    bins = qkv.bins.clone()
    bins[b, g, page * 128 + idx // d, idx % d] = 0
    out_idx, out_val = qkv.out_idx.clone(), qkv.out_val.clone()
    out_idx[b, g, page] = torch.from_numpy(idx.astype(np.int32))
    out_val[b, g, page] = torch.from_numpy(val)
    return qkv._replace(bins=bins, out_idx=out_idx, out_val=out_val)


@pytest.mark.cuda
@pytest.mark.parametrize("hg", [1, 6, 16])
def test_kv_attention_kernel_matches_plain_version_on_card(hg):
    """B12 within rtol = atol = 2e-5 of its plain version (another order
    of sums), at lengths 1, 127, 128 and S."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    s = 512
    q, kq, vq = _kv_case(4, 2, s, hg)
    assert not bool(kq.overflow.any() | vq.overflow.any())
    lengths = torch.tensor([1, 127, 128, s], dtype=torch.int32, device="cuda")
    before = TA.LAUNCHES["_kv_decode_attention"]
    out = TA.kv_decode_attention(q, kq, vq, lengths)
    want = TA._kv_decode_attention_plain(q, kq, vq, lengths)
    torch.cuda.synchronize()
    assert TA.LAUNCHES["_kv_decode_attention"] == before + 1
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_kv_attention_kernel_full_page_of_outliers_on_card():
    """A page holding cap exact outlier values in K and in V: the kernel's
    adds restore them as the plain version's scatter does."""
    _need_card()
    from repro_torch.compression import kv as TKV
    from repro_torch.kernels import kv_attention as TA
    q, kq, vq = _kv_case(2, 2, 384, 6)
    kq, vq = _fill_page_outliers(kq), _fill_page_outliers(vq)
    assert int((kq.out_idx[0, 0, 1] >= 0).sum()) == kq.out_idx.shape[-1]
    deq = TKV.dequantize_kv(vq)[0, 0, 128:256].reshape(-1)
    assert torch.equal(deq[vq.out_idx[0, 0, 1].long()], vq.out_val[0, 0, 1])
    for lengths in ([100, 384], [200, 129], [384, 1]):
        lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = TA.kv_decode_attention(q, kq, vq, lengths)
        want = TA._kv_decode_attention_plain(q, kq, vq, lengths)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [4, 16])
def test_kv_attention_split_matches_plain_version_on_card(pps):
    """The split over pages at S = 8192 (64 pages): lengths one before, on
    and one after a split boundary, 1 and S, against the plain version
    split the same way."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    s, edge = 8192, pps * 128
    q, kq, vq = _kv_case(2, 2, s, 6)
    for pair in ([edge - 1, edge], [edge + 1, 1], [s, 2 * edge + 1],
                 [2 * edge, s - 1]):
        lengths = torch.tensor(pair, dtype=torch.int32, device="cuda")
        out = TA.kv_decode_attention(q, kq, vq, lengths, pages_per_split=pps)
        want = TA._kv_decode_attention_plain(q, kq, vq, lengths,
                                             pages_per_split=pps)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_kv_attention_masked_inf_in_last_page_on_card():
    """An inf in V at a masked token inside the last page read: p = 0
    there, so 0 * inf puts NaN in that channel of every head, in the
    kernel as in the plain version; a length 0 row is all NaN."""
    _need_card()
    from repro_torch.compression import kv as TKV
    from repro_torch.kernels import kv_attention as TA
    b, g, s = 2, 2, 1024
    v = (RNG.standard_normal((b, g, s, 128)) * 0.7).astype(np.float32)
    v[0, 1, 300, 5] = np.inf
    vq = TKV.quantize_kv(torch.from_numpy(v).cuda(),
                         TKV.kv_quantizer_config())
    q, kq, _ = _kv_case(b, g, s, 6)
    lengths = torch.tensor([290, 0], dtype=torch.int32, device="cuda")
    for pps in (1, 2, 8):
        out = TA.kv_decode_attention(q, kq, vq, lengths, pages_per_split=pps)
        want = TA._kv_decode_attention_plain(q, kq, vq, lengths,
                                             pages_per_split=pps)
        torch.cuda.synchronize()
        nan = torch.isnan(out)
        assert torch.equal(nan, torch.isnan(want))
        assert bool(nan[1].all())
        assert nan[0].nonzero().tolist() == [[1, h, 5] for h in range(6)]
        torch.testing.assert_close(out[~nan], want[~nan], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [2, 3])
def test_kv_attention_outliers_in_last_page_of_a_split_on_card(pps):
    """A page holding cap exact outlier values in K and in V, the last page
    of the first split: its corrections reach that split's partials."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    q, kq, vq = _kv_case(2, 2, 1024, 6)
    kq = _fill_page_outliers(kq, page=pps - 1)
    vq = _fill_page_outliers(vq, page=pps - 1)
    for pair in ([pps * 128, 1024], [pps * 128 - 5, pps * 128 + 1]):
        lengths = torch.tensor(pair, dtype=torch.int32, device="cuda")
        out = TA.kv_decode_attention(q, kq, vq, lengths, pages_per_split=pps)
        want = TA._kv_decode_attention_plain(q, kq, vq, lengths,
                                             pages_per_split=pps)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_kv_attention_makes_no_host_sync_on_card():
    """The wrapper launches with lengths on the card and no host sync."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    q, kq, vq = _kv_case(2, 2, 1024, 6)
    lengths = torch.tensor([700, 1024], dtype=torch.int32, device="cuda")
    TA.kv_decode_attention(q, kq, vq, lengths)     # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TA.kv_decode_attention(q, kq, vq, lengths)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = TA._kv_decode_attention_plain(q, kq, vq, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


# ------------------- the rest of the grammar and the audit plane (A7-A9) --

def _planes_equal(a, b):
    """Every plane of two Encoded wires (or Quantized / AuditReport
    tuples) bit for bit, the first on the card."""
    for u, v in zip(a, b):
        if isinstance(u, tuple):
            _planes_equal(u, v)
        elif u is None or v is None:
            assert u is None and v is None
        else:
            assert u.dtype == v.dtype and torch.equal(u.cpu(), v.cpu())


_PRED_SHAPES = {"sci-lorenzo-ent": (8, 64, 40), "kv-delta": (80, 32, 8)}


def _preset_case(name, n=20480):
    from repro_torch.configs.registry import PIPELINES
    from repro_torch.core.pipeline import parse_pipeline
    pipe = parse_pipeline(PIPELINES.get(name, name))
    x = _mix(n)
    x[RNG.random(n) < 0.5] = 0.0                # zero and narrow chunks
    eb = torch.tensor(1e-2) if pipe.quant.eb == 1.0 else None
    return pipe, x, eb, _PRED_SHAPES.get(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grad-wire-16-ent", "grad-wire-pred",
                                  "sci-rel-shuffle", "sci-rel-ent",
                                  "sci-lorenzo-ent", "kv-delta",
                                  "abs:0.01|pack:16|ent",
                                  "noa:0.001|pack:8|shuffle|zero"])
def test_stage_and_pred_chains_on_card_match_cpu(name):
    """The shuffle/ent stages and the pred chains on the card (B8/B9 and
    B10/B11 for the pred chains) against the CPU reference: every plane,
    wire_bits, and the decoded floats."""
    _need_card()
    pipe, x, eb, shape = _preset_case(name)
    on_card = pipe.encode(x, None if eb is None else eb.cuda(),
                          pred_shape=shape)
    on_cpu = pipe.encode(x, eb, device="cpu", pred_shape=shape)
    _planes_equal(on_card, on_cpu)
    wb = pipe.wire_bits(on_card, x.size)
    assert float(wb) == float(pipe.wire_bits(on_cpu, x.size))
    y = pipe.decode(on_card, n=x.size, pred_shape=shape)
    y_cpu = pipe.decode(on_cpu, n=x.size, device="cpu", pred_shape=shape)
    assert torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grad-wire-pred", "sci-lorenzo-ent",
                                  "kv-delta", "rel:0.001|pack:16",
                                  "noa:0.001|pack:16|narrow",
                                  "lorenzo|rel:0.001|pack:32|narrow"])
def test_pred_and_verify_paths_launch_dense_kernels_only(name, monkeypatch):
    """On the card the pred chains and verify=/return_quantized= encodes
    quantize with B8/B9 and the pred chains decode with B10/B11; the
    plain quantizers and the plain packed codec run on none of these
    paths.  The report, the Quantized planes and the checksum equal the
    CPU path's."""
    _need_card()
    from repro_torch.core import codec as C
    from repro_torch.core import quantizer as Q
    from repro_torch.kernels import dense as D
    pipe, x, eb, shape = _preset_case(name)
    eb_card = None if eb is None else eb.cuda()
    pipe.encode(x, eb_card, pred_shape=shape, verify=True)   # build first
    want = pipe.encode(x, eb, device="cpu", pred_shape=shape, verify=True,
                       return_quantized=True, integrity=True)

    def forbidden(*args, **kw):
        raise AssertionError("a plain quantizer ran on the card's path")

    for mod, fn in ((Q, "quantize_abs"), (Q, "quantize_rel"),
                    (Q, "quantize_noa"), (Q, "dequantize_abs"),
                    (Q, "dequantize_rel"), (C, "encode_packed"),
                    (C, "decode_packed")):
        monkeypatch.setattr(mod, fn, forbidden)
    D.reset_launches()
    got = pipe.encode(x, eb_card, pred_shape=shape, verify=True,
                      return_quantized=True, integrity=True)
    rel = pipe.quant.mode == "rel"
    assert D.LAUNCHES["_quantize_rel" if rel else "_quantize_abs"] == 1
    assert D.LAUNCHES["_quantize_abs" if rel else "_quantize_rel"] == 0
    enc, qt, rep = got
    _planes_equal(enc, want[0])
    _planes_equal(qt, want[1])
    _planes_equal(rep, want[2])
    assert bool(rep.ok()) or bool(enc.overflow)
    y = pipe.decode(enc, n=x.size, pred_shape=shape, verify=True)
    deq = "_dequantize_rel" if rel else "_dequantize_abs"
    assert D.LAUNCHES[deq] == (1 if pipe.pred else 0)
    monkeypatch.undo()
    y_cpu = pipe.decode(want[0], n=x.size, device="cpu", pred_shape=shape)
    assert torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32))


@pytest.mark.cuda
def test_ent_and_checksum_encode_make_no_host_sync_on_card():
    """The ent coder's two scans and the checksum fold stay on the card."""
    _need_card()
    pipe, x, eb, _ = _preset_case("grad-wire-16-ent")
    xc, ebc = torch.from_numpy(x).cuda(), eb.cuda()
    pipe.encode(xc, ebc, integrity=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc = pipe.encode(xc, ebc, integrity=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _planes_equal(enc, pipe.encode(x, eb, device="cpu", integrity=True))


@pytest.mark.cuda
def test_ent_decode_of_a_corrupt_codebook_on_card():
    """Corrupted 4-bit code lengths (15 > ENT_MAX_LEN) decode on the card
    without a device-side assert, and the card keeps working."""
    _need_card()
    from repro_torch.core import codec as C
    pipe, x, eb, _ = _preset_case("grad-wire-16-ent")
    enc = pipe.encode(x, eb.cuda())
    hdr = enc.headers[-1].clone()
    hdr[:4] = -1
    out = C.decode_words_ent(hdr, enc.payload, pipe.stage_sizes(x.size)[-2])
    torch.cuda.synchronize()
    assert out.is_cuda and int((out * 0).sum()) == 0


@pytest.mark.cuda
def test_guard_on_card_detects_every_fault():
    """detection_matrix on a card wire: every class caught, the corrupted
    planes back on the card, decode(verify=True) raises."""
    _need_card()
    from repro_torch.core import audit as A
    from repro_torch.runtime import guard as G
    pipe, x, eb, _ = _preset_case("sci-rel-ent")
    enc, rep = pipe.encode(x, verify=True, integrity=True)
    bad_x = G.FaultPlan("card", "nan_input").corrupt_input(
        torch.from_numpy(x).cuda())
    assert bad_x.is_cuda
    _, nan_rep = pipe.encode(bad_x, verify=True)
    m = G.detection_matrix(enc, suite="card", report=nan_rep)
    assert all(m.values()) and len(m) == 4
    for cls in G.applicable_classes(enc):
        bad = G.FaultPlan("card", cls).corrupt_wire(enc)
        assert bad.payload.is_cuda
        with pytest.raises(A.WireIntegrityError):
            pipe.decode(bad, n=x.size, verify=True)


def _pods(p, n, seed):
    r = np.random.default_rng(seed)
    base = r.standard_normal(n)
    return [torch.from_numpy(((base + 0.5 * r.standard_normal(n)) * 3e-3)
                             .astype(np.float32)).cuda() for _ in range(p)]


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("spec", ["", "abs:1.0|pack:16|narrow", "auto"])
def test_thread_axis_on_card_matches_the_plain_path(spec, p):
    """p ranks as threads on one card: every rank's mean equals the plain
    result (each rank's wire decoded with kernels=False, summed from 0 in
    rank order, over p) and the CPU's; a ring pair (x, -x) at p = 2 takes
    the ring, bit-equal to the gather."""
    _need_card()
    from repro_torch.compression import grads as G
    from repro_torch.core.axis import run_threads
    from repro_torch.core.transport import TRANSPORT, Transport
    cfg = G.GradCompressionConfig(eb_rel=2.0 ** -5, pipeline=spec)
    n = 3 * 4096 + 77
    xs = _pods(p, n, seed=p)

    def run(ax, dev, tp=None):
        g = xs[ax.rank].to(dev)
        shard, _ = G.compress_shard(g, cfg, device=dev)
        return shard, G.compressed_mean(g, cfg, ax, transport=tp,
                                        device=dev)[0]

    card = run_threads(p, lambda ax: run(ax, "cuda"))
    cpu = run_threads(p, lambda ax: run(ax, "cpu"))
    total = torch.zeros(n, device="cuda")
    for shard, _ in card:
        total = total + shard.pipe.decode(shard.enc, n=n, kernels=False)
    for (_, m), (_, mc) in zip(card, cpu):
        assert m.is_cuda
        assert torch.equal(m.view(torch.int32), (total / p).view(torch.int32))
        assert torch.equal(m.cpu().view(torch.int32), mc.view(torch.int32))
    if spec == "" and p == 2:
        a = torch.tanh(xs[0]) * 3e-3
        xs[:] = [a, -a]

        def ring(ax):
            shard, m = run(ax, "cuda")
            return (TRANSPORT.uses_ring(shard.enc, shard.pipe, ax), m,
                    run(ax, "cuda", Transport(reduce="gather"))[1])

        for fired, m, mg in run_threads(2, ring):
            assert fired and torch.equal(m.view(torch.int32),
                                         mg.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("chain", range(5))
def test_selector_candidates_on_card(chain):
    """Each grad-wire candidate through the Selector on the card: forced
    to win by its bias, the wire equals that chain's own wire and the CPU
    selector's, and the decode equals the CPU's, with no plain fallback."""
    _need_card()
    import dataclasses
    from repro_torch.core import select as S
    sel = S.get_selector("grad-wire")
    sel = dataclasses.replace(sel, bias=tuple(
        0.0 if i == chain else 1e9 for i in range(5)))
    n = 5 * 1024
    x = torch.from_numpy(((np.random.default_rng(chain).standard_normal(n))
                          * 3e-3).astype(np.float32))
    eb = torch.tensor(np.float32(1e-4))
    w = sel.encode(x, eb.cuda(), integrity=True)
    wc = sel.encode(x, eb, device="cpu", integrity=True)
    assert int(w.chain_id) == int(wc.chain_id) == chain
    for a, b in zip(w, wc):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    direct = sel.chains[chain].encode(x, eb.cuda())
    view = sel._view(w, chain, n)
    assert torch.equal(view.payload, direct.payload)
    y = sel.decode(w, n=n, verify=True)
    assert y.is_cuda
    assert torch.equal(y.cpu().view(torch.int32),
                       sel.decode(wc, n=n, device="cpu").view(torch.int32))
    assert float(sel.wire_bits(w, n)) == float(sel.wire_bits(wc, n))


# ---------------------------- serving: B12's (m, l), the KV wire, engine --

@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[0, 128, 256, 511], [0, 0, 1, 384],
                                     [127, 129, 255, 512]])
def test_kv_attention_stats_match_plain_version_on_card(lengths):
    """B12's merged softmax state (m, l) beside its output, against the
    plain version's, within rtol = atol = 2e-5: at length 0 (no page read:
    m = -1e30, l = 0, the output NaN), at a page that has just closed (128,
    256, 384) and inside a page."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    q, kq, vq = _kv_case(4, 2, 512, 6)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, m, l_ = TA.kv_decode_attention(q, kq, vq, lens, return_stats=True)
    w_out, w_m, w_l = TA._kv_decode_attention_plain(q, kq, vq, lens,
                                                    return_stats=True)
    torch.cuda.synchronize()
    assert m.shape == l_.shape == (4, 2, 6)
    torch.testing.assert_close(m, w_m, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l_, w_l, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out, w_out, rtol=2e-5, atol=2e-5,
                               equal_nan=True)
    empty = lens == 0
    assert bool((m[empty] == -1e30).all()) and bool((l_[empty] == 0).all())
    assert bool(torch.isnan(out[empty]).all())
    assert bool(torch.isfinite(out[~empty]).all())
    plain = TA.kv_decode_attention(q, kq, vq, lens)
    assert torch.equal(torch.nan_to_num(plain), torch.nan_to_num(out))


def _kv_wire_case():
    """A small quantized cache [2, 2, 512, 128] on the card: normal pages,
    a correlated page (kvdelta wins it), an all-zero (unwritten) page and
    a page with more outliers than slots."""
    from repro_torch.compression import kv as TKV
    x = (RNG.standard_normal((2, 2, 512, 128)) * 0.7).astype(np.float32)
    x[0, 0, 128:256] = np.cumsum(
        RNG.standard_normal((128, 128)) * 0.01, 0) + 1.0
    x[1, :, 384:] = 0.0
    x[0, 1, 256:266, :] = np.inf
    return TKV.quantize_kv(torch.from_numpy(x).cuda(),
                           TKV.kv_quantizer_config())


@pytest.mark.cuda
@pytest.mark.parametrize("stages", ["kv-page", "kv-page-narrow",
                                    "kv-page-pred", "auto"])
def test_pack_kv_pages_on_card_match_cpu(stages):
    """pack_kv / unpack_kv on the card (B6 over every page's chunks, one
    launch a chunk stage; B7 on unpack, one launch a chunk stage)
    bit-equal to the CPU path, and the round trip exact."""
    _need_card()
    from repro_torch.compression import kv as TKV
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.core.pipeline import ChunkStage
    from repro_torch.kernels import lossless as TL
    qkv = _kv_wire_case()
    spec = get_kv_chain(stages)
    before = dict(TL.LAUNCHES)
    p = TKV.pack_kv(qkv, stages=spec, integrity=True)
    back = TKV.unpack_kv(p, verify=True)
    torch.cuda.synchronize()
    if stages == "auto":
        assert TL.LAUNCHES["_lc_select"] > before["_lc_select"]
        assert TL.LAUNCHES["_lc_expand"] > before["_lc_expand"]
    else:
        chunk_stages = sum(isinstance(st, ChunkStage)
                           for st in TKV._page_stages(spec)[1])
        for name in ("_lc_select", "_lc_expand"):
            assert TL.LAUNCHES[name] == before[name] + chunk_stages, name
    cpu = TKV.pack_kv(TKV.QuantizedKV(*(t.cpu() for t in qkv)), stages=spec,
                      integrity=True)
    for name, a, b in zip(p._fields, p, cpu):
        if a is None:
            assert b is None, name
        elif isinstance(a, tuple):
            assert all(torch.equal(u.cpu(), w) for u, w in zip(a, b)), name
        else:
            assert torch.equal(a.cpu(), b), name
    for a, b in zip(back, qkv):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


def _engine_cfg():
    """internlm2-20b's attention heads (48 query heads over 8 KV heads of
    128) at a narrower residual width and two layers."""
    from repro_torch.configs.base import ArchConfig as TArch
    return TArch(name="internlm2-20b-heads", family="dense", n_layers=2,
                 d_model=1024, n_heads=48, n_kv_heads=8, d_ff=2048,
                 vocab=4096, head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [2, 4])
def test_engine_slots_bit_identical_to_batch1_on_card(n_slots):
    """Each slot's logits through prefill, insert, a page close and
    evict -> insert equal, bit for bit, those of the batch-1 serve_step
    path run alone."""
    _need_card()
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.models import build as tbuild
    from repro_torch.models import engine as TE
    from repro_torch.models import serve as TS
    cfg = _engine_cfg()
    params = tbuild(cfg).init(torch.Generator(device="cuda").manual_seed(7))
    eng = TE.DecodeEngine(cfg, params, n_slots=n_slots, seq=256,
                          stages=get_kv_chain("kv-page"))
    prompts = [RNG.integers(0, cfg.vocab, 120 + 3 * i) for i in
               range(n_slots)]
    for i, pr in enumerate(prompts):
        assert eng.insert(eng.allocate(), eng.prefill(pr), request=i)
    rows = [[] for _ in range(n_slots)]
    for step in range(12):
        logits, _ = eng.generate_step()
        for s in range(n_slots):
            rows[s].append(logits[s].clone())
        if step == 5:
            eng.insert(0, eng.evict(0), request=0)
    for s, pr in enumerate(prompts):
        cache = TS.make_quant_cache(cfg, 1, 256)
        tok = None
        for i, t in enumerate(pr):
            logits, cache = eng.step_one(
                cache, torch.tensor([[int(t)]], device="cuda"), i)
        tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
        for step in range(12):
            logits, cache = eng.step_one(cache, tok, len(pr) + step)
            assert torch.equal(logits[0].view(torch.int32),
                               rows[s][step].view(torch.int32)), (s, step)
            tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hg", [1, 2, 16])
def test_kv_attention_head_dim_80_matches_plain_version_on_card(hg):
    """B12's D = 80 instance (stablelm-3b's head dim) within rtol = atol =
    2e-5 of its plain version, with its (m, l): ragged lengths (0, inside
    a page, on a page edge, past a split edge, S), a full page of exact
    outliers in K and V on two rows, and splits of 1 and 3 pages."""
    _need_card()
    from repro_torch.kernels import kv_attention as TA
    s = 1024
    q, kq, vq = _kv_case(4, 3, s, hg, d=80)
    for b, g, page in ((0, 0, 1), (2, 1, 6)):
        kq = _fill_page_outliers(kq, page=page, b=b, g=g)
        vq = _fill_page_outliers(vq, page=page, b=b, g=g)
    lengths = torch.tensor([300, 0, 768 + 1, s], dtype=torch.int32,
                           device="cuda")
    for pps in (None, 1, 3):
        before = TA.LAUNCHES["_kv_decode_attention"]
        got = TA.kv_decode_attention(q, kq, vq, lengths, pages_per_split=pps,
                                     return_stats=True)
        want = TA._kv_decode_attention_plain(q, kq, vq, lengths,
                                             pages_per_split=pps,
                                             return_stats=True)
        torch.cuda.synchronize()
        assert TA.LAUNCHES["_kv_decode_attention"] == before + 1
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-5,
                                       equal_nan=True)
        assert bool(torch.isnan(got[0][1]).all())
        assert bool(torch.isfinite(got[0][[0, 2, 3]]).all())


# --------------------------------------------- the MoE family (moe.py) --

@pytest.mark.cuda
def test_route_on_card_matches_cpu():
    """`moe._route_logits` on the card against the CPU on the same
    bfloat16-valued logits (olmoe's 64 experts, top 8): the expert
    choices, capacity positions, drops and slots equal, the gates within
    4 float32 ulps; ties go to the lower index on the card too."""
    _need_card()
    from repro_torch.models import moe as TM
    x = torch.from_numpy(RNG.standard_normal((512, 64)).astype(np.float32))
    logits = x.to(torch.bfloat16).to(torch.float32)
    logits[0, :] = torch.arange(64, dtype=torch.float32) % 5   # ties
    cpu = TM._route_logits(logits, 8)
    card = TM._route_logits(logits.cuda(), 8)
    assert torch.equal(card[1].cpu(), cpu[1])
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=2.0 ** -21,
                               atol=0)
    torch.testing.assert_close(card[2].cpu(), cpu[2], rtol=1e-6, atol=0)
    cap = TM.capacity(512, 64, 8)
    for a, b in zip(TM.dispatch_slots(card[1], 64, cap),
                    TM.dispatch_slots(cpu[1], 64, cap)):
        assert torch.equal(a.cpu(), b)
    tie = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]], device="cuda")
    assert TM._route_logits(tie, 3)[1].tolist() == [[1, 2, 4]]


@pytest.mark.cuda
def test_two_layer_olmoe_steps_on_card_match_cpu():
    """Two olmoe-1b-7b layers at full width (64 experts of 2048 x 1024):
    130 quantized decode steps of 2 requests (a page closes in step 127,
    B12 on the card from step 128) within 2e-2 of the CPU's max |logit|
    at every step, with the card's expert choices forced into the CPU run
    (their router products round differently); where the CPU's own choice
    differs it is a near tie: the weakest forced expert's probability and
    the weakest own one's are within a factor 1 - 2^-4."""
    _need_card()
    import dataclasses
    from repro_torch.compression import kv as TKV
    from repro_torch.configs.registry import get
    from repro_torch.models import build as tbuild
    from repro_torch.models import moe as TM
    from repro_torch.models import serve as TS
    cfg = dataclasses.replace(get("olmoe-1b-7b"), n_layers=2)
    params = tbuild(cfg).init(torch.Generator(device="cuda").manual_seed(9))
    cpu = {"emb": params["emb"].cpu(), "final_norm":
           params["final_norm"].cpu(),
           "layers": {k: v.cpu() for k, v in params["layers"].items()}}
    kv_cfg = TKV.kv_quantizer_config()
    cc = TS.make_quant_cache(cfg, 2, 256)
    hc = TS.make_quant_cache(cfg, 2, 256, device="cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (130, 2, 1)))
    real, card_choices = TM._top_k_experts, []
    own = {"tokens": 0, "differ": 0, "tie": 1.0}

    def record(probs, k):
        idx = real(probs, k)
        card_choices.append(idx.cpu())
        return idx

    def forced(probs, k):
        idx, want = real(probs, k), card_choices.pop(0)
        differ = (idx != want).any(-1)
        own["tokens"] += idx.shape[0]
        own["differ"] += int(differ.sum())
        if bool(differ.any()):
            ratio = (probs.gather(1, want).amin(-1)
                     / probs.gather(1, idx).amin(-1))[differ]
            own["tie"] = min(own["tie"],
                             float(torch.minimum(ratio, 1 / ratio).min()))
        return want

    rel = []
    try:
        for i in range(130):
            TM._top_k_experts = record
            lc, cc = TS.serve_step(cfg, params, cc, toks[i].cuda(), i, None,
                                   kv_cfg)
            TM._top_k_experts = forced
            lh, hc = TS.serve_step(cfg, cpu, hc, toks[i], i, None, kv_cfg)
            rel.append(float((lc.cpu() - lh).abs().max() / lh.abs().max()))
    finally:
        TM._top_k_experts = real
    assert max(rel) < 2e-2, (max(rel), int(np.argmax(rel)))
    assert own["tie"] >= 1.0 - 2.0 ** -4, own


@pytest.mark.cuda
def test_moe_decode_step_makes_no_host_sync_on_card():
    """A quantized MoE decode step with a closed page (routing, the
    capacity dispatch, B12) on the card makes no host sync."""
    _need_card()
    from repro_torch.compression import kv as TKV
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.models import build as tbuild
    from repro_torch.models import serve as TS
    cfg = TArch(name="moe-sync", family="moe", n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=128,
                moe_experts=16, moe_top_k=4)
    params = tbuild(cfg).init(torch.Generator(device="cuda").manual_seed(3))
    cache = TS.make_quant_cache(cfg, 4, 256)
    kv_cfg = TKV.kv_quantizer_config()
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    for pos in range(130):
        TS.serve_step(cfg, params, cache, tok, pos, None, kv_cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = TS.serve_step(cfg, params, cache, tok, 130, None, kv_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_dense_codec_through_b8_b11_on_card_matches_cpu(mode, bits):
    """`core.encode_dense`/`decode_dense`/`encode_compact`/`decode_compact`
    of float32 on the card launch B8 or B9 per encode and B10 or B11 per
    decode, and every plane and decoded float is bit-equal to the CPU's
    (the kernels' plain versions); float64 takes the torch quantizers on
    either device and agrees too."""
    _need_card()
    from repro_torch import core as C
    from repro_torch.kernels import dense as D
    cfg = TCfg(mode=mode, error_bound=1e-2, bin_bits=bits,
               outlier_cap_frac=0.25)
    x = torch.from_numpy(_mix(4096 * 3 + 129))
    q, dq = ("_quantize_rel", "_dequantize_rel") if mode == "rel" else (
        "_quantize_abs", "_dequantize_abs")
    before = dict(D.LAUNCHES)
    enc = C.encode_dense(x.cuda(), cfg)
    y = C.decode_dense(enc, cfg, shape=x.shape)
    kc = C.encode_compact(x.cuda(), cfg)
    yc = C.decode_compact(kc, cfg)
    torch.cuda.synchronize()
    assert D.LAUNCHES[q] == before[q] + 2
    assert D.LAUNCHES[dq] == before[dq] + 2
    want = C.encode_dense(x, cfg)
    for a, b in zip(enc, want):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    assert torch.equal(y.cpu().view(torch.int32),
                       C.decode_dense(want, cfg).view(torch.int32))
    wk = C.encode_compact(x, cfg)
    for a, b in zip(kc, wk):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)
    assert torch.equal(yc.cpu().view(torch.int32),
                       C.decode_compact(wk, cfg).view(torch.int32))
    c64 = TCfg(mode=mode, error_bound=1e-9 if mode != "rel" else 1e-6,
               dtype="float64", bin_bits=32)
    x64 = x.double()
    assert torch.equal(C.roundtrip_dense(x64.cuda(), c64).cpu().view(
        torch.int64), C.roundtrip_dense(x64, c64).view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-base", "xlstm-350m"])
def test_two_layer_encdec_and_ssm_on_card_match_cpu(name):
    """A 2-layer cut of whisper-base (2 encoder and 2 decoder layers) and
    of xlstm-350m (one pair) at full width: the loss, the prefill logits
    and 16 decode steps on the card within 2e-2 of the CPU's max |logit|."""
    _need_card()
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs.registry import get
    from repro_torch.models import build as tbuild
    from repro_torch.models import encdec as TE
    cfg = dataclasses.replace(get(name), n_layers=2,
                              enc_layers=min(get(name).enc_layers, 2))
    bundle = tbuild(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(21))
    cpu = T.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(22)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_context, cfg.d_model)).astype(np.float32)).to(
                torch.bfloat16)
    on_card = {k: v.cuda() for k, v in batch.items()}

    def rel(a, b):
        return float((a.cpu().float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        lc, _ = bundle.loss(params, on_card)
        lh, _ = bundle.loss(cpu, batch)
        assert abs(float(lc) - float(lh)) <= 1e-3 * abs(float(lh)) + 1e-3
        assert rel(bundle.prefill(params, on_card),
                   bundle.prefill(cpu, batch)) <= 2e-2
        caches = []
        for p, dev in ((params, "cuda"), (cpu, "cpu")):
            c = bundle.make_cache(2, 16, device=dev)
            if cfg.family == "encdec":
                enc = TE.encode(cfg, p, batch["frames"].to(dev))
                c = (c[0], TE.cross_kv(cfg, p, enc))
            caches.append(c)
        for pos in range(16):
            t = tok[:, pos:pos + 1]
            oc, _ = bundle.serve_step(params, caches[0], t.cuda(), pos)
            oh, _ = bundle.serve_step(cpu, caches[1], t, pos)
            assert rel(oc, oh) <= 2e-2, pos


@pytest.mark.cuda
def test_expert_parallel_moe_on_card_matches_one_rank():
    """`moe_ffn` on 4 thread ranks of a ("model",) mesh on the card, 16
    experts of d 256: every rank the same bits; the all-to-all path within
    2^-6 of the one-rank output's largest |value| (cuBLAS may pick other
    algorithms for 4 experts x 4 copies than for 16 experts), aux equal;
    the decode path within 2^-6 of the one-rank path with every pair
    kept; a 2-layer MoE's gradient over a (1, 4) mesh description within
    2e-2 of the one-rank gradient, leaf by leaf."""
    _need_card()
    from repro_torch import tree as T
    from repro_torch.configs.base import ArchConfig as TArch
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import Mesh, run_mesh_threads
    from repro_torch.models import build as tbuild
    from repro_torch.models import moe as TM
    gen = torch.Generator(device="cuda").manual_seed(11)
    e, d, f = 16, 256, 512
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(2, 64, d).to(torch.bfloat16)
    rw = rnd(d, e) * 0.1
    w1, w3 = (rnd(e, d, f).mul(0.05).to(torch.bfloat16) for _ in range(2))
    w2 = rnd(e, f, d).mul(0.05).to(torch.bfloat16)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    for xx, cf in ((x, 1.0), (x[:, :1], float(e))):
        one, aux = TM.moe_ffn_local(xx, rw, w1, w3, w2, top_k=4,
                                    capacity_factor=cf)
        got = run_mesh_threads((4,), ("model",), lambda m: TM.moe_ffn(
            xx, rw, w1, w3, w2, top_k=4, mesh=m, data_axes=()))
        for y, a in got:
            assert torch.equal(y.view(torch.int16),
                               got[0][0].view(torch.int16))
            assert rel(y, one) <= 2.0 ** -6
            assert float(a) == float(aux)
    cfg = TArch(name="tiny-ep-card", family="moe", n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024, head_dim=64,
                moe_experts=8, moe_top_k=2)
    bundle = tbuild(cfg)
    params = bundle.init(gen)
    tok = torch.randint(0, cfg.vocab, (2, 65), generator=gen, device="cuda")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (l1, _), g1 = TL.value_and_grad(bundle, params, batch, None)
    (l4, _), g4 = TL.value_and_grad(bundle, params, batch,
                                    Mesh((1, 4), ("data", "model")))
    assert abs(float(l1) - float(l4)) <= 1e-3 * abs(float(l1))
    for a, b in zip(T.leaves(g4), T.leaves(g1)):
        assert rel(a, b) <= 2e-2

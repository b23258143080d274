"""The port's serving path (`repro_torch.models`: params, layers,
transformer specs, `serve.serve_step` over raw and quantized caches,
`engine.DecodeEngine`) against the JAX package's `repro.models`.

The weights are the reference's own, carried across by
`params_from_numpy`; both packages get the same tokens.  Logits are held
within LOGIT_TOL = 2e-2 of the reference's largest |logit| at every step,
for 200 teacher-forced steps that cross a page close: the bfloat16
products are rounded in another order, which moves a logit by a few
bfloat16 steps, and the history pages that the port reads through B12's
plain version hold the values the reference dequantizes (within B12's
2e-5).  Sound runs read at most 1.14e-2 (two bfloat16 steps of the
largest logit; at most 2^-6 = 1.56e-2 for two steps); a port that drops
the closed pages reads 0.38-1.24 from step 128 on, and one that weighs
the history by e too much in the merge 2.2e-2 (tiny), 6.9e-2 (chatglm3)
and 1.03e-1 (internlm2), so the limit lies between the two;
`test_logit_tolerance_catches_a_broken_history` keeps two of those
faults failing it.  A raw cache served in place of the quantized one
reads as a sound run here (eb_rel 2^-6 moves no logit by a bfloat16
step at these widths): the cache's own checks catch it.  Given the same
hot page, the closed page is bit-equal.  The engine's per-slot logits are
bit-identical to the port's own batch-1 `serve_step`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compression import kv as JKV
from repro.configs import registry as JR
from repro.configs.base import ArchConfig as JArch
from repro.models import build as j_build
from repro.models import serve as JS
from repro.models.params import count_params as j_count
from repro_torch.compression import kv as TKV
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.kernels import kv_attention as TA
from repro_torch.models import build as t_build
from repro_torch.models import engine as TE
from repro_torch.models import layers as TL
from repro_torch.models import serve as TS
from repro_torch.models.params import params_from_numpy

from test_torch_moe import one_thread  # noqa: F401

RNG = np.random.default_rng(2026)
LOGIT_TOL = 2e-2            # of max |reference logit|, per step
TINY = dict(name="tiny-engine", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16)
CONFIGS = {"tiny": (JArch(**TINY), TArch(**TINY)),
           "internlm2-20b": (JR.get("internlm2-20b").reduced(),
                             TR.get("internlm2-20b").reduced()),
           "chatglm3-6b": (JR.get("chatglm3-6b").reduced(),
                           TR.get("chatglm3-6b").reduced())}


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, port cfg, reference params, port params)}."""
    out = {}
    for i, (name, (jc, tc)) in enumerate(CONFIGS.items()):
        jp = j_build(jc).init(jax.random.PRNGKey(i))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[name] = (jc, tc, jp, tp)
    return out


def test_params_carry_across_bit_for_bit(models):
    jc, tc, jp, tp = models["internlm2-20b"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for k in path:
            node = node[k.key]
        a = np.asarray(leaf)
        t = node.view(torch.int16) if node.dtype == torch.bfloat16 else node
        np.testing.assert_array_equal(a.view(np.int16) if a.dtype.name ==
                                      "bfloat16" else a, t.numpy())
    assert t_build(tc).n_params() == j_build(jc).n_params() == j_count(
        j_build(jc).specs)
    shapes = jax.tree.map(lambda s: tuple(s.shape), j_build(jc).specs,
                          is_leaf=lambda s: hasattr(s, "axes"))
    tshapes = {k: (v.shape if hasattr(v, "axes") else
                   {kk: vv.shape for kk, vv in v.items()})
               for k, v in t_build(tc).specs.items()}
    assert tshapes == shapes


def test_port_init_draws_its_own_weights():
    tc = CONFIGS["tiny"][1]
    b = t_build(tc)
    p1 = b.init(torch.Generator().manual_seed(3), device="cpu")
    p2 = b.init(torch.Generator().manual_seed(3), device="cpu")
    w = p1["layers"]["wq"].float()
    assert torch.equal(w, p2["layers"]["wq"].float())
    scale = min(0.02, 1 / np.sqrt(tc.d_model))
    assert float(w.abs().max()) <= 2 * scale * 1.01
    assert abs(float(w.std()) / scale - 0.88) < 0.05   # truncated at 2 sigma
    assert bool((p1["final_norm"] == 1).all())


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_other_families_raise(family):
    """The hybrid, ssm and encdec decode through their own caches and
    steps (tests/test_torch_hybrid.py, test_torch_xlstm.py,
    test_torch_encdec.py), not through the decoder stack's QuantCache path
    (this step, the engine, stream_prefill): the reference's engine
    refuses the hybrid (engine.py:125) and fails on the other two.  The
    hybrid's `make_cache` gives the reference's tree, quantized or not."""
    name = {"hybrid": "jamba-1.5-large-398b", "ssm": "xlstm-350m",
            "encdec": "whisper-base"}[family]
    if family == "hybrid":
        with pytest.raises(NotImplementedError, match="engine.py:125"):
            TS._check_family(TR.get(name))
        for quantized in (False, True):
            want = jax.eval_shape(lambda: j_build(
                JR.get(name).reduced()).make_cache(1, 128, quantized))
            got = t_build(TR.get(name).reduced()).make_cache(
                1, 128, quantized, device="cpu")
            assert isinstance(got[0], TS.RawCache)
            assert [(a.shape, str(a.dtype)) for a in jax.tree.leaves(want)] \
                == [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for t in (*got[0], *got[1])]
        return
    assert t_build(TR.get(name).reduced()).n_params() > 0
    with pytest.raises(NotImplementedError, match="DecodeEngine"):
        TS._check_family(TR.get(name))


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_family_serves_and_prefills_on_the_cpu(name):
    """The MoE family through the bundle on the CPU (the port's own
    weights): 130 quantized decode steps past a page close and the raw
    cache's, and prefill, all finite and of the reference's shapes; the
    quantized logits within 0.15 of the raw ones' max."""
    tc = TR.get(name).reduced()
    bundle = t_build(tc)
    params = bundle.init(torch.Generator().manual_seed(5), device="cpu")
    toks = torch.from_numpy(RNG.integers(0, tc.vocab, (130, 2, 1)))
    qc = bundle.make_cache(2, 256, quantized=True, device="cpu")
    rc = bundle.make_cache(2, 256, device="cpu")
    kv_cfg = TKV.kv_quantizer_config()
    for i in range(130):
        lq, qc = bundle.serve_step(params, qc, toks[i], i, None, kv_cfg)
        lr, rc = bundle.serve_step(params, rc, toks[i], i)
    assert lq.shape == (2, tc.padded_vocab) and lq.dtype == torch.float32
    assert bool(torch.isfinite(lq).all() & torch.isfinite(lr).all())
    assert float((lq - lr).abs().max() / lr.abs().max()) < 0.15
    assert bool(qc.k.eb2[:, :, :, 0].gt(0).all())
    last = bundle.prefill(params, {"tokens": toks[:40, :, 0].T.contiguous()})
    assert last.shape == (2, tc.padded_vocab) and last.dtype == torch.float32
    assert bool(torch.isfinite(last).all())


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    tc = CONFIGS["tiny"][1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.make_quant_cache(tc, 1, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(tc).make_cache(1, 128, quantized=True)


def test_weights_and_engine_run_on_the_card_unless_asked(models):
    """init and DecodeEngine default to the card: without one they raise,
    even given a CPU generator or CPU weights; asked for the CPU, a
    generator or weights on another device are refused."""
    tc, tp = models["tiny"][1], models["tiny"][3]
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_build(tc).init(gen)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.DecodeEngine(tc, tp, n_slots=1, seq=256)
    else:
        with pytest.raises(ValueError, match="generator lies on cpu"):
            t_build(tc).init(gen)
        with pytest.raises(ValueError, match="parameters lie on cpu"):
            TE.DecodeEngine(tc, tp, n_slots=1, seq=256)
    p = t_build(tc).init(gen, device="cpu")
    assert p["emb"].device.type == "cpu"
    eng = TE.DecodeEngine(tc, tp, n_slots=1, seq=256, device="cpu")
    assert eng.device.type == "cpu"


def test_layers_match_reference():
    from repro.models import layers as JL
    x = RNG.standard_normal((2, 1, 6, 32)).astype(np.float32)
    pos = np.array([[5], [300]], dtype=np.int32)
    for mode, rot in (("full", 32), ("partial", 16)):
        jc, js = JL.rope_tables(jnp.asarray(pos), rot)
        tcos, tsin = TL.rope_tables(torch.from_numpy(pos), rot)
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jc), atol=2e-6)
        np.testing.assert_allclose(tsin.numpy(), np.asarray(js), atol=2e-6)
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(x), tcos, tsin, mode).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jc, js, mode)),
            atol=1e-5)
    w = RNG.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-6)
    kc = RNG.standard_normal((2, 64, 2, 32)).astype(np.float32)
    vc = RNG.standard_normal((2, 64, 2, 32)).astype(np.float32)
    q = RNG.standard_normal((2, 1, 6, 32)).astype(np.float32)
    lens = np.array([1, 40], dtype=np.int32)
    np.testing.assert_allclose(
        TL.decode_attention(*map(torch.from_numpy, (q, kc, vc, lens))).numpy(),
        np.asarray(JL.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)))),
        rtol=1e-5, atol=1e-6)
    a = RNG.standard_normal((3, 32)).astype(np.float32)
    w1, w3 = (RNG.standard_normal((32, 16)).astype(np.float32)
              for _ in range(2))
    w2 = RNG.standard_normal((16, 32)).astype(np.float32)
    for act in ("swiglu", "gelu"):
        np.testing.assert_allclose(
            TL.ffn(*map(torch.from_numpy, (a, w1, w3, w2)), act).numpy(),
            np.asarray(JL.ffn(*map(jnp.asarray, (a, w1, w3, w2)), act)),
            rtol=1e-4, atol=1e-4)


def test_quantize_page_bit_equal_on_the_same_hot_page():
    """Both packages close the same bfloat16 hot page (with an outlier
    spike, a NaN and a subnormal-scale head) into page 1 of a cache: every
    plane bit-equal."""
    b, g, hd, seq = 2, 2, 16, 384
    hot = (RNG.standard_normal((b, TS.PAGE, g, hd)) * 0.7).astype(np.float32)
    hot[0, 5, 1, 3] = 300.0
    hot[1, 9, 0, 2] = np.nan
    hot[1, :, 1] *= 1e-38
    jhot = jnp.asarray(hot).astype(jnp.bfloat16)
    thot = params_from_numpy({"hot": np.asarray(jhot)}, device="cpu")["hot"]
    jc = JS.make_quant_cache(JArch(**TINY), b, seq)
    tc = TS.make_quant_cache(TArch(**TINY), b, seq, device="cpu")
    cfg = JKV.kv_quantizer_config()
    jq = JS._quantize_page(jax.tree.map(lambda a: a[0], jc.k), jhot, 1, cfg)
    tq = TS._quantize_page(TKV.QuantizedKV(*(t[0] for t in tc.k)), thot, 1,
                           TKV.kv_quantizer_config())
    for name, u, v in zip(TKV.QuantizedKV._fields, jq, tq):
        a = np.asarray(u)
        if a.dtype == np.float32:
            a, v = a.view(np.uint32), v.view(torch.int32).numpy().view(
                np.uint32)
        np.testing.assert_array_equal(a, np.asarray(v), err_msg=name)
    assert bool(tc.k.bins[0, :, :, 128:256].ne(0).any())  # written in place


def _run_both(jc, tc, jp, tp, quantized: bool, steps: int, b: int = 2,
              seq: int = 256):
    """Teacher-force both packages' serve_step over `steps` tokens; returns
    the per-step max|diff| / max|ref| and the two caches."""
    toks = RNG.integers(0, jc.vocab, size=(steps, b)).astype(np.int32)
    kv_j = JKV.kv_quantizer_config() if quantized else None
    kv_t = TKV.kv_quantizer_config() if quantized else None
    step = jax.jit(lambda p, c, t, i: JS.serve_step(jc, p, c, t, i, None,
                                                    kv_j))
    if quantized:
        jcache = JS.make_quant_cache(jc, b, seq)
        tcache = TS.make_quant_cache(tc, b, seq, device="cpu")
    else:
        jcache = JS.make_raw_cache(jc, b, seq)
        tcache = TS.make_raw_cache(tc, b, seq, device="cpu")
    rel = []
    for i in range(steps):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[i]).reshape(b, 1),
                          jnp.int32(i))
        lt, tcache = TS.serve_step(tc, tp, tcache,
                                   torch.from_numpy(toks[i]).reshape(b, 1), i,
                                   None, kv_t)
        lj = np.asarray(lj)
        assert lt.shape == lj.shape and lt.dtype == torch.float32
        rel.append(float(np.abs(lj - lt.numpy()).max() / np.abs(lj).max()))
    return np.array(rel), jcache, tcache


@pytest.mark.parametrize("name,quantized", [("tiny", True), ("tiny", False),
                                            ("internlm2-20b", True),
                                            ("chatglm3-6b", True)])
def test_serve_step_logits_match_reference(models, name, quantized):
    """200 teacher-forced steps (a page closes inside step 127): logits
    within LOGIT_TOL of the reference's at every step, and the closed page
    within the bound of the port's own hot values."""
    jc, tc, jp, tp = models[name]
    rel, jcache, tcache = _run_both(jc, tc, jp, tp, quantized, steps=200)
    assert rel.max() < LOGIT_TOL, (rel.max(), int(rel.argmax()))
    if quantized:
        assert not bool(tcache.k.overflow[:, :, :, 0].any())
        assert bool(tcache.k.eb2[:, :, :, 0].gt(0).all())
        assert bool(tcache.k.eb2[:, :, :, 1].eq(0).all())
        # the port's closed page reads back within a page bound of the
        # reference's (their hot values differ by bfloat16 rounding only)
        hist_j = np.asarray(JKV.dequantize_kv(jcache.k))[..., :128, :]
        hist_t = TKV.dequantize_kv(tcache.k)[..., :128, :].numpy()
        eb = 2.0 * np.asarray(jcache.k.eb2)[..., :1, None]
        assert np.all(np.abs(hist_j - hist_t) <= 4 * eb + 0.02)


def _history_dropped(real):
    def attn(cfg, q, qk, qv, page_start):
        o, l_, m = real(cfg, q, qk, qv, page_start)
        return (torch.zeros_like(o), torch.zeros_like(l_),
                torch.full_like(m, TA.NEG_BIG))
    return attn


def _history_weight_e(real):
    def attn(cfg, q, qk, qv, page_start):
        o, l_, m = real(cfg, q, qk, qv, page_start)
        return o, l_, m + 1.0
    return attn


@pytest.mark.parametrize("name,fault", [("tiny", _history_dropped),
                                        ("internlm2-20b", _history_weight_e)])
def test_logit_tolerance_catches_a_broken_history(models, monkeypatch, name,
                                                  fault):
    """LOGIT_TOL fails a port whose history path is wrong: the closed
    pages dropped from the merge, or weighed by e too much.  Before the
    first page closes the faulty port is sound and within the limit."""
    jc, tc, jp, tp = models[name]
    monkeypatch.setattr(TS, "_attn_history", fault(TS._attn_history))
    rel, _, _ = _run_both(jc, tc, jp, tp, True, steps=200)
    assert rel[:TS.PAGE].max() < LOGIT_TOL
    assert rel[TS.PAGE:].max() > 2 * LOGIT_TOL, rel[TS.PAGE:].max()


def test_history_merge_uses_b12_stats(models):
    """The closed pages' part through B12's plain version (m, l) merges
    with the hot page's exactly as the reference's two _partial_attn
    parts do (within B12's 2e-5), and with an empty history the hot part
    alone comes out."""
    jc, tc, _, _ = models["tiny"]
    b, g, hd, h = 2, tc.n_kv_heads, tc.head_dim, tc.n_heads
    x = (RNG.standard_normal((b, g, 256, hd)) * 0.7).astype(np.float32)
    kq = TKV.quantize_kv(torch.from_numpy(x), TKV.kv_quantizer_config())
    vq = TKV.quantize_kv(torch.from_numpy(x[::-1].copy()),
                         TKV.kv_quantizer_config())
    q = torch.from_numpy(RNG.standard_normal((b, 1, h, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    o, l_, m = TS._attn_history(tc, q, kq, vq, 128)
    hk = TKV.dequantize_kv(kq, dtype=torch.bfloat16).permute(0, 2, 1, 3)
    hv = TKV.dequantize_kv(vq, dtype=torch.bfloat16).permute(0, 2, 1, 3)
    wo, wl, wm = TS._partial_attn(q, hk, hv, torch.full((b,), 128))
    torch.testing.assert_close(o, wo, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l_, wl, rtol=2e-5, atol=2e-5)
    lens = torch.zeros(b, dtype=torch.int32)
    out, m0, l0 = TA.kv_decode_attention(
        q.float().reshape(b, g, h // g, hd), kq, vq, lens, return_stats=True)
    assert bool(torch.isnan(out).all()) and bool((l0 == 0).all())
    assert bool((m0 == -1e30).all())


def _engine(tc, tp, n_slots=2, stages="kv-page", integrity=None):
    return TE.DecodeEngine(tc, tp, n_slots=n_slots, seq=256,
                           stages=TR.get_kv_chain(stages),
                           integrity=integrity, device="cpu")


def _batch1(eng, prompt, n_new):
    cache = TS.make_quant_cache(eng.cfg, 1, eng.seq, device="cpu")
    for i, t in enumerate(prompt):
        logits, cache = eng.step_one(cache, torch.tensor([[int(t)]]), i)
    out = [logits[0]]
    tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
    for k in range(n_new - 1):
        logits, cache = eng.step_one(cache, tok, len(prompt) + k)
        out.append(logits[0])
        tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
    return out


@pytest.mark.parametrize("stages", ["kv-page", "auto"])
def test_engine_slots_bit_identical_to_batch1(models, stages):
    """Prefill, insert, a page close (prompts of 126 and 17 tokens run to
    step 130) and evict -> insert: each slot's logits equal the batch-1
    serve_step path's bit for bit, and the wire accounting is the
    reference's rule (one send per hand-off)."""
    _, tc, _, tp = models["tiny"]
    eng = _engine(tc, tp, stages=stages, integrity="raise")
    prompts = [RNG.integers(0, tc.vocab, 126), RNG.integers(0, tc.vocab, 17)]
    pres = [eng.prefill(p) for p in prompts]
    for i, pre in enumerate(pres):
        assert eng.insert(eng.allocate(), pre, request=i)
    rows = [[pres[0].logits[0]], [pres[1].logits[0]]]
    for step in range(6):
        logits, toks = eng.generate_step()
        for s in range(2):
            rows[s].append(logits[s].clone())
        if step == 2:
            pre = eng.evict(1)
            assert eng.allocate() == 1
            assert eng.insert(1, pre, request=1)
    for s, p in enumerate(prompts):
        want = _batch1(eng, p, 7)
        for a, b in zip(rows[s], want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    st = eng.stats()
    assert st["sends"] == 4 and st["inserts"] == 3 and st["evictions"] == 1
    assert st["audit_checks"] == 6 and st["audit_failures"] == 0
    assert st["wire_bytes"] > 0 and st["generated_tokens"] == 12


def test_engine_run_matches_sequential_and_refuses_bad_wires(models):
    """run() over 3 requests on 2 slots (churn) gives each request the
    batch-1 path's greedy tokens; a corrupted wire is refused under
    'rerequest' and raises under 'raise'."""
    from repro_torch.core import audit as TAu
    from repro_torch.runtime import guard as TG
    _, tc, _, tp = models["tiny"]
    eng = _engine(tc, tp)
    prompts = [RNG.integers(0, tc.vocab, n) for n in (130, 17, 140)]
    out = eng.run(prompts, 4)
    for rid, p in enumerate(prompts):
        want = [int(torch.argmax(l_)) for l_ in _batch1(eng, p, 4)]
        assert out[rid] == want
    eng2 = _engine(tc, tp, integrity="rerequest")
    pre = eng2.prefill(prompts[1])
    bad = pre._replace(pages=pre.pages._replace(
        k=TG.FaultPlan("engine", "payload_bitflip").corrupt_wire(
            pre.pages.k)))
    assert eng2.insert(0, bad) is False
    assert eng2.stats()["audit_failures"] == 1 and eng2.requests[0] is None
    eng3 = _engine(tc, tp, integrity="raise")
    with pytest.raises(TAu.WireIntegrityError):
        eng3.insert(0, bad)
    with pytest.raises(TypeError):
        eng3.insert(0, pre._replace(pages=pre.pages._replace(
            k=TKV.unpack_kv(pre.pages.k))))
    report = TAu.AuditReport(*(torch.tensor(v) for v in (
        10, 0, 0.5, 0, 3, False)))
    eng3.record_audit([report, None])
    assert eng3.stats()["audit_reports"] == 1


def test_pack_transfer_unpack_cache_is_bit_exact(models):
    """A cache after 140 steps (one closed page): pack_cache for every KV
    chain and 'auto', transfer_cache rank 0 -> 1 over two thread ranks,
    unpack_cache bit-equal, and the next steps' logits bit-equal."""
    from repro_torch.core.axis import run_threads
    _, tc, _, tp = models["tiny"]
    cache = TS.make_quant_cache(tc, 2, 256, device="cpu")
    kv_cfg = TKV.kv_quantizer_config()
    toks = torch.from_numpy(RNG.integers(0, tc.vocab, (144, 2, 1)))
    for i in range(140):
        _, cache = TS.serve_step(tc, tp, cache, toks[i], i, None, kv_cfg)
    for stages in [*TR.KV_PAGE_CHAINS.values(), "auto"]:
        wire = TS.pack_cache(cache, stages=stages, integrity=True)
        back = TS.unpack_cache(wire, verify=True)
        for a, b in zip((*back.k, *back.v), (*cache.k, *cache.v)):
            assert torch.equal(a, b)
        got = run_threads(2, lambda ax: TS.transfer_cache(
            cache if ax.rank == 0 else TS.make_quant_cache(
                tc, 2, 256, device="cpu"), 0, 1, ax, stages=stages))[1]
        for a, b in zip((*got.k, *got.v, got.hot_k, got.hot_v),
                        (*cache.k, *cache.v, cache.hot_k, cache.hot_v)):
            assert torch.equal(a, b)
    moved = TS.unpack_cache(TS.pack_cache(cache, stages="auto"))
    moved = moved._replace(hot_k=moved.hot_k.clone(),
                           hot_v=moved.hot_v.clone())
    for i in range(140, 144):
        la, cache = TS.serve_step(tc, tp, cache, toks[i], i, None, kv_cfg)
        lb, moved = TS.serve_step(tc, tp, moved, toks[i], i, None, kv_cfg)
        assert torch.equal(la.view(torch.int32), lb.view(torch.int32))

"""The port's MoE family (`repro_torch.models`: `moe`, `layers.repeat_kv`
and `flash_attention`, `transformer.forward`, `ModelBundle.prefill`, the
MoE decode step, the engine and `engine.stream_prefill`) against the JAX
package's `repro.models`, on the reduced olmoe-1b-7b and
qwen3-moe-235b-a22b configurations and a tiny MoE, with the reference's
weights carried across by `params_from_numpy`.

Routing.  On the same router logits both packages choose the same
experts (ties to the lower index) and the same capacity positions, drops
and slots, bit for bit; the gates agree within GATE_RTOL and the
load-balance loss within AUX_RTOL, not bit for bit, because XLA:CPU's
float32 exp differs from torch's in the last bit on about 9 % of values
(1,427 of 16,384 probed).  Whole-model runs feed each package its own
router logits, a bfloat16 product whose sums run in another order, so a
token whose top-k boundary lies within a rounding of a tie can pick
another expert, and with capacity drops that moves the positions of the
pairs after it.  Those runs therefore force the reference's expert
choices into the port, call by call (`forced_routes`), hold the logits
within LOGIT_TOL of the reference's largest |logit| (the serving tests'
limit), and require every choice the port made otherwise on its own to
be a near tie: the probabilities of the weakest of the reference's
experts and of the port's are within a factor 1 - NEAR_TIE (ROADMAP
C-port-6 records such a difference); a planted fault in the gates fails
the limit, and one in the choice fails the near-tie check.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compression import kv as JKV
from repro.configs import registry as JR
from repro.configs.base import ArchConfig as JArch
from repro.core.transport import TRANSPORT as JTP
from repro.models import build as j_build
from repro.models import engine as JE
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import serve as JS
from repro.models import transformer as JT
from repro_torch.compression import kv as TKV
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import interop
from repro_torch.core.axis import run_threads
from repro_torch.core.transport import Transport
from repro_torch.models import build as t_build
from repro_torch.models import engine as TE
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import serve as TS
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_numpy

from reference_jobs import reference_routes

RNG = np.random.default_rng(2027)
LOGIT_TOL = 2e-2          # of max |reference logit| (tests/test_torch_serve.py)
GATE_RTOL = 2.0 ** -21    # four float32 ulps
AUX_RTOL = 1e-6
NEAR_TIE = 2.0 ** -4      # a port's own choice may differ where p is this close
TINY_MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=512, head_dim=16,
                moe_experts=4, moe_top_k=2)
CONFIGS = {"tiny-moe": (JArch(**TINY_MOE), TArch(**TINY_MOE)),
           "olmoe-1b-7b": (JR.get("olmoe-1b-7b").reduced(),
                           TR.get("olmoe-1b-7b").reduced()),
           "qwen3-moe-235b-a22b": (JR.get("qwen3-moe-235b-a22b").reduced(),
                                   TR.get("qwen3-moe-235b-a22b").reduced())}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in a module that uses it (this one, and those
    that import it): their tensors are small, and with test workers
    sharing the cores, threads of small ops only wait on one another
    (each worker's torch takes every core by default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, port cfg, reference params, port params)}."""
    out = {}
    for i, (name, (jc, tc)) in enumerate(CONFIGS.items()):
        jp = j_build(jc).init(jax.random.PRNGKey(40 + i))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[name] = (jc, tc, jp, tp)
    return out


class forced_routes:
    """In place of the port's expert choice (`moe._top_k_experts`): the
    reference's choices of call i (routes[i]); the gates, the load-balance
    loss and the dispatch stay the port's own code.  Counts the tokens
    where the port's own choice (`real`) differs, keeps the first (call,
    token), and over those tokens the least of r and 1 / r, r the ratio of
    the weakest forced expert's probability to the weakest own one's
    (`tie`, 1 when none differs)."""

    def __init__(self, routes, real=TM._top_k_experts):
        self.routes, self.real, self.calls = routes, real, 0
        self.tokens = self.own = 0
        self.first_own, self.tie = None, 1.0

    def __call__(self, probs, top_k):
        idx = self.real(probs, top_k)
        want = torch.from_numpy(self.routes[self.calls]).to(idx.dtype)
        differ = (idx != want).any(-1)
        if bool(differ.any()):
            if self.first_own is None:
                self.first_own = (self.calls, int(differ.nonzero()[0, 0]))
            ratio = (probs.gather(1, want).amin(-1)
                     / probs.gather(1, idx).amin(-1))[differ]
            self.tie = min(self.tie,
                           float(torch.minimum(ratio, 1 / ratio).min()))
        self.calls += 1
        self.tokens += int(idx.shape[0])
        self.own += int(differ.sum())
        return want

    def near_ties(self) -> bool:
        return self.tie >= 1.0 - NEAR_TIE


def _rel(ref, got):
    """Per leading row: max |ref - got| / max |ref| (float32)."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    return (np.abs(ref - got).reshape(ref.shape[0], -1).max(-1)
            / np.abs(ref).max())


def _reference_dispatch(gate_idx, e, cap):
    """The reference's pos / keep / slot lines (moe.py:60-64)."""
    oh = jax.nn.one_hot(gate_idx.reshape(-1), e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, 0) - oh,
                              gate_idx.reshape(-1, 1), axis=1)[:, 0]
    keep = pos < cap
    slot = jnp.where(keep, gate_idx.reshape(-1) * cap + pos, e * cap)
    return pos, keep, slot


# ------------------------------------------------------------- routing --

@pytest.mark.parametrize("n,d,e,k", [(256, 64, 64, 8), (96, 32, 8, 2)])
def test_route_matches_reference_on_identical_logits(n, d, e, k):
    """Both `_route`s (the reference's jitted, as it runs: XLA keeps the
    router product in float32, as the port does) on tokens whose router
    product is exact (two bfloat16 terms a row), so the logits are
    identical: the
    expert choices (ties to the lower index: a built tie at the top-k
    boundary on token 0, a three-way one on token 1), the capacity
    positions, drops and slots bit-equal; gates within 4 ulps (the exp's
    last bit, then a division); aux within 1e-6."""
    x = np.zeros((n, d), np.float32)
    x[np.arange(n), np.arange(n) % d] = 1.0
    x[np.arange(n), (7 * np.arange(n) + 3) % d] += 1.0
    w = (RNG.standard_normal((d, e)) * 0.5).astype(np.float32)
    w = np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    # token 0 reads rows 0 and 3: its k-th and (k+1)-th largest tie
    row = np.sort(RNG.permutation(e).astype(np.float32) / e)[::-1].copy()
    row[k] = row[k - 1]
    perm = RNG.permutation(e)
    w[0], w[3] = 0.0, row[perm]
    # token 1 reads rows 1 and 10: three equal values across the boundary
    row = np.sort(RNG.permutation(e).astype(np.float32) / e)[::-1].copy()
    row[k - 2:k + 1] = row[k - 2]
    w[1], w[10] = 0.0, row[RNG.permutation(e)]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jv, ji, jaux = jax.jit(JM._route, static_argnums=2)(xb, jnp.asarray(w),
                                                        k)
    tx = params_from_numpy({"x": np.asarray(xb)}, device="cpu")["x"]
    tv, ti, taux = TM._route(tx, torch.from_numpy(w), k)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    tied = [int(np.argmax(perm == k - 1)), int(np.argmax(perm == k))]
    assert int(ti[0, k - 1]) == min(tied) and max(tied) not in ti[0]
    torch.testing.assert_close(tv, torch.from_numpy(np.array(jv)),
                               rtol=GATE_RTOL, atol=0)
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))
    cap = TM.capacity(n, e, k)
    assert cap == max(1, int(1.0 * k * n / e))
    for a, b in zip(_reference_dispatch(ji, e, cap),
                    TM.dispatch_slots(ti, e, cap)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_route_prefers_the_lower_index_of_a_tie():
    """[1, 3, 3, 2, 3, 0] at k = 3: experts 1, 2, 4, as jax.lax.top_k
    gives them."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]])
    _, idx, _ = TM._route_logits(logits, 3)
    j = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits.numpy()), -1), 3)[1]
    assert idx.tolist() == [[1, 2, 4]] == np.asarray(j).tolist()


def test_moe_ffn_local_matches_reference_with_drops(models, monkeypatch):
    """The reduced olmoe's layer-0 experts over 128 tokens (cap = 32 of a
    mean load of 32, so pairs drop): with the reference's choices forced
    in, the output within 2^-7 of its largest |value| (bfloat16 products
    summed in another order), the drops the same; the port's own choices
    differ only at near ties."""
    jc, tc, jp, tp = models["olmoe-1b-7b"]
    n, k, e = 128, jc.moe_top_k, jc.moe_experts
    x = (RNG.standard_normal((2, n // 2, jc.d_model))).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tx = params_from_numpy({"x": np.asarray(xb)}, device="cpu")["x"]
    lp = jax.tree.map(lambda t: t[0], jp["layers"])
    tlp = {kk: v[0] for kk, v in tp["layers"].items()}
    with reference_routes() as routes:
        jy, jaux = JM.moe_ffn_local(xb, lp["router"], lp["w1"], lp["w3"],
                                    lp["w2"], top_k=k)
        jax.effects_barrier()
    cap = TM.capacity(n, e, k)
    assert cap == 32
    _, keep, _ = _reference_dispatch(jnp.asarray(routes[0]), e, cap)
    assert not bool(np.asarray(keep).all())                  # pairs drop
    forced = forced_routes(routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    ty, taux = TM.moe_ffn_local(tx, tlp["router"], tlp["w1"], tlp["w3"],
                                tlp["w2"], top_k=k)
    assert ty.shape == tx.shape and ty.dtype == torch.bfloat16
    assert forced.calls == 1 and forced.near_ties(), vars(forced)
    assert _rel(jy.reshape(n, -1), ty.reshape(n, -1)).max() < 2.0 ** -7
    assert abs(float(taux) - float(jaux)) < 1e-3


def test_moe_mesh_paths_raise(models):
    """The expert-parallel paths (tests/test_torch_ep.py holds them against
    the reference): a mesh description, which has no rank, raises; on 2
    thread ranks of a ("model",) mesh the reduced olmoe's layer-0 experts
    give the one-rank output (prefill) and every pair (decode)."""
    from repro_torch.launch.mesh import make_production_mesh, run_mesh_threads
    _, _, _, tp = models["olmoe-1b-7b"]
    lp = {k: v[0] for k, v in tp["layers"].items()}
    w = (lp["router"], lp["w1"], lp["w3"], lp["w2"])
    x = torch.from_numpy(RNG.standard_normal((2, 8, 128)).astype(
        np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="description"):
        TM.moe_ffn(x, *w, top_k=2, mesh=make_production_mesh())
    for xx, cf in ((x, 1.0), (x[:, :1], 4.0)):
        one = TM.moe_ffn_local(xx, *w, top_k=2, capacity_factor=cf)[0]
        got = run_mesh_threads((2,), ("model",), lambda m: TM.moe_ffn(
            xx, *w, top_k=2, mesh=m, data_axes=())[0])
        for y in got:
            assert y.shape == xx.shape
            assert float((y.float() - one.float()).abs().max()) <= 2.0 ** -6 \
                * float(one.float().abs().max())


# ------------------------------------------------ layers, forward, prefill --

@pytest.mark.parametrize("sq,causal", [(1200, True), (96, False)])
def test_flash_attention_matches_reference(sq, causal):
    """The blocked attention over bfloat16 q, k, v: at 1200 tokens the
    reference's blocks are 400 queries by 600 keys (1200 divides neither
    512 nor 1024), all masked and computed; the output within one
    bfloat16 step (2^-7 relative) plus 2^-8 of the largest |output| of
    the reference's: an exp one ulp off can round a p to bfloat16 the
    other way, which moves a whole row by 2^-9 p v, and values near 0 are
    sums that cancel."""
    b, h, hd = 1, 2, 32
    q, k, v = (jnp.asarray(RNG.standard_normal((b, sq, h, hd)) * s)
               .astype(jnp.bfloat16) for s in (2.0, 2.0, 1.0))
    want = JL.flash_attention(q, k, v, causal=causal)
    tq, tk, tv = (params_from_numpy({"t": np.asarray(t)}, device="cpu")["t"]
                  for t in (q, k, v))
    got = TL.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, hd)
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    assert np.all(np.abs(w - g) <= 2.0 ** -7 * np.abs(w)
                  + 2.0 ** -8 * np.abs(w).max())
    assert TL._pick(1200, 512) == 400 and TL._pick(1200, 1024) == 600


def test_repeat_kv_matches_reference():
    kv = RNG.standard_normal((2, 5, 3, 4)).astype(np.float32)
    for gs in (1, 4):
        np.testing.assert_array_equal(
            TL.repeat_kv(torch.from_numpy(kv), gs).numpy(),
            np.asarray(JL.repeat_kv(jnp.asarray(kv), gs)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_prefill_match_reference(models, name, monkeypatch):
    """forward's logits at every position and prefill's last logits within
    LOGIT_TOL of the reference's (routing forced), aux close; the port's
    own choices differ only at near ties."""
    jc, tc, jp, tp = models[name]
    toks = RNG.integers(0, jc.vocab, (2, 48)).astype(np.int32)
    with reference_routes() as routes:
        jl, jaux = JT.forward(jc, jp, jnp.asarray(toks), None, remat=False)
        jlast = j_build(jc).prefill(jp, {"tokens": jnp.asarray(toks)})
        jax.effects_barrier()
    forced = forced_routes(routes)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    tl_, taux = TT.forward(tc, tp, torch.from_numpy(toks))
    tlast = t_build(tc).prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert forced.calls == 2 * jc.n_layers
    assert forced.near_ties(), (forced.own, forced.tokens, forced.tie)
    assert tl_.dtype == torch.bfloat16 and tl_.shape == jl.shape
    assert _rel(jl.reshape(-1, jl.shape[-1]),
                tl_.reshape(-1, tl_.shape[-1])).max() < LOGIT_TOL
    assert tlast.dtype == torch.float32 and tlast.shape == jlast.shape
    assert _rel(jlast, tlast).max() < LOGIT_TOL
    assert abs(float(taux) - float(jaux)) <= 1e-2 * abs(float(jaux))


def _unnormalized_gates(logits, top_k):
    """`moe._route_logits` with a fault: the gates not renormalized over
    the k chosen experts."""
    probs = torch.softmax(logits, dim=-1)
    idx = TM._top_k_experts(probs, top_k)
    return probs.gather(1, idx), idx, torch.zeros(())


def _lowest_experts(probs, top_k):
    """`moe._top_k_experts` with a fault: the k least likely experts."""
    return torch.sort(probs, dim=-1, stable=True)[1][:, :top_k]


@pytest.mark.parametrize("fault", ["unnormalized", "lowest"])
def test_planted_routing_fault_fails(models, monkeypatch, fault):
    """A port whose gates skip the renormalization over k fails LOGIT_TOL
    (the reference's choices forced in); one that picks the k least likely
    experts makes its own choice otherwise on most tokens, none of them a
    near tie."""
    jc, tc, jp, tp = models["olmoe-1b-7b"]
    toks = RNG.integers(0, jc.vocab, (2, 48)).astype(np.int32)
    with reference_routes() as routes:
        jl, _ = JT.forward(jc, jp, jnp.asarray(toks), None, remat=False)
        jax.effects_barrier()
    if fault == "unnormalized":
        monkeypatch.setattr(TM, "_route_logits", _unnormalized_gates)
        forced = forced_routes(routes)
    else:
        forced = forced_routes(routes, real=_lowest_experts)
    monkeypatch.setattr(TM, "_top_k_experts", forced)
    tl_, _ = TT.forward(tc, tp, torch.from_numpy(toks))
    rel = _rel(jl.reshape(-1, jl.shape[-1]), tl_.reshape(-1, tl_.shape[-1]))
    if fault == "unnormalized":
        assert rel.max() > 2 * LOGIT_TOL, rel.max()
    else:
        assert forced.own > 0.9 * forced.tokens and not forced.near_ties()


# --------------------------------------------------------------- serving --

@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_serve_steps_match_reference(models, name, monkeypatch):
    """200 teacher-forced quantized decode steps of 2 requests (a page
    closes inside step 127; cap = 1 slot an expert, so a pair drops when
    both tokens pick one expert): logits within LOGIT_TOL of the
    reference's at every step (routing forced), the first page closed
    within its bound, and the port's own choices differ only at near
    ties."""
    jc, tc, jp, tp = models[name]
    b, seq, steps = 2, 256, 200
    toks = RNG.integers(0, jc.vocab, size=(steps, b)).astype(np.int32)
    kv_j, kv_t = JKV.kv_quantizer_config(), TKV.kv_quantizer_config()
    with reference_routes() as routes:
        step = jax.jit(lambda p, c, t, i: JS.serve_step(jc, p, c, t, i, None,
                                                        kv_j))
        jcache = JS.make_quant_cache(jc, b, seq)
        tcache = TS.make_quant_cache(tc, b, seq, device="cpu")
        forced = forced_routes(routes)
        monkeypatch.setattr(TM, "_top_k_experts", forced)
        rel = []
        for i in range(steps):
            lj, jcache = step(jp, jcache, jnp.asarray(toks[i]).reshape(b, 1),
                              jnp.int32(i))
            lj = np.asarray(lj)
            jax.effects_barrier()
            lt, tcache = TS.serve_step(
                tc, tp, tcache, torch.from_numpy(toks[i]).reshape(b, 1), i,
                None, kv_t)
            rel.append(float(np.abs(lj - lt.numpy()).max()
                             / np.abs(lj).max()))
    assert forced.calls == steps * jc.n_layers
    assert forced.near_ties(), (forced.own, forced.tokens, forced.tie)
    assert max(rel) < LOGIT_TOL, (max(rel), int(np.argmax(rel)))
    assert not bool(tcache.k.overflow[:, :, :, 0].any())
    hist_j = np.asarray(JKV.dequantize_kv(jcache.k))[..., :128, :]
    hist_t = TKV.dequantize_kv(tcache.k)[..., :128, :].numpy()
    eb = 2.0 * np.asarray(jcache.k.eb2)[..., :1, None]
    assert np.all(np.abs(hist_j - hist_t) <= 4 * eb + 0.02)


def _batch1(cfg, params, prompt, n_new, seq=256, kv_cfg=None):
    kv_cfg = TKV.kv_quantizer_config() if kv_cfg is None else kv_cfg
    cache = TS.make_quant_cache(cfg, 1, seq, device="cpu")
    for i, t in enumerate(prompt):
        logits, cache = TS.serve_step(cfg, params, cache,
                                      torch.tensor([[int(t)]]), i, None,
                                      kv_cfg)
    out, pos = [logits[0]], len(prompt)
    for _ in range(n_new - 1):
        tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
        logits, cache = TS.serve_step(cfg, params, cache, tok, pos, None,
                                      kv_cfg)
        out.append(logits[0])
        pos += 1
    return out, cache


def test_moe_engine_slots_bit_identical_to_batch1(models):
    """The DecodeEngine over the tiny MoE, 2 slots, 3 requests, one
    evict -> insert: every slot's logits bit-equal to its request's
    batch-1 serve_step path (a batch-1 step drops no pair)."""
    _, tc, _, tp = models["tiny-moe"]
    eng = TE.DecodeEngine(tc, tp, n_slots=2, seq=256,
                          stages=TR.get_kv_chain("kv-page"), device="cpu")
    prompts = [RNG.integers(0, tc.vocab, n) for n in (130, 17, 140)]
    out = eng.run(prompts, 5)
    for rid, p in enumerate(prompts):
        want, _ = _batch1(tc, tp, p, 5)
        assert out[rid] == [int(torch.argmax(l_)) for l_ in want]
    eng = TE.DecodeEngine(tc, tp, n_slots=2, seq=256, device="cpu")
    pres = [eng.prefill(p) for p in prompts[:2]]
    for s, pre in enumerate(pres):
        assert eng.insert(eng.allocate(), pre, request=s)
    rows = [[pres[0].logits[0]], [pres[1].logits[0]]]
    for step in range(5):
        logits, _ = eng.generate_step()
        for s in range(2):
            rows[s].append(logits[s].clone())
        if step == 1:
            eng.insert(1, eng.evict(1), request=1)
    for s in range(2):
        want, _ = _batch1(tc, tp, prompts[s], 6)
        for a, w in zip(rows[s], want):
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))


def _assert_wire_equal(jw, tw):
    """Every plane of a reference PackedKV and a port one bit-equal."""
    got = interop.packed_kv_to_numpy(tw)
    for name in TKV.PackedKV._fields:
        a, b = getattr(jw, name), getattr(got, name)
        if name == "headers":
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(np.asarray(u).view(np.uint8),
                                              np.asarray(v).view(np.uint8))
        elif a is None or b is None:
            assert a is None and b is None, name
        else:
            a = np.asarray(a)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=name)


class _Recording(Transport):
    """A Transport that keeps every wire rank `src` sends."""

    def __init__(self):
        super().__init__()
        self.sent = []

    def send_pages(self, wire, src, dst, axis, **kw):
        if axis.rank == src:
            self.sent.append(wire)
        return super().send_pages(wire, src, dst, axis, **kw)


@pytest.mark.parametrize("stages", ["kv-page"])
def test_stream_prefill_is_bit_identical(models, stages):
    """stream_prefill of a 260-token prompt from rank 0 to rank 1 of a
    2-thread axis: two PageWires and a TailWire; every page wire bit-equal
    to the reference's pack_kv of the same source page, the ledger the
    reference's accounting of those wires; the assembled cache and the
    first token bit-identical to the source's; 4 steps on it bit-equal to
    4 on the source; rank 0 gets zeros; the engine runs on it."""
    _, tc, _, tp = models["tiny-moe"]
    spec = TR.get_kv_chain(stages)
    prompt = RNG.integers(0, tc.vocab, 260)
    tps = [_Recording(), _Recording()]
    res = run_threads(2, lambda ax: TE.stream_prefill(
        tc, tp, prompt, seq=512, axis=ax, stages=spec,
        transport=tps[ax.rank]))
    got, zero = res[1], res[0]
    want_logits, src = _batch1(tc, tp, prompt, 1, seq=512)
    for a, b in zip((*got.cache.k, *got.cache.v, got.cache.hot_k,
                     got.cache.hot_v),
                    (*src.k, *src.v, src.hot_k, src.hot_v)):
        assert torch.equal(a, b)
    assert torch.equal(got.logits.view(torch.int32),
                       want_logits[0][None].view(torch.int32))
    assert int(got.next_token) == int(torch.argmax(want_logits[0]))
    assert got.pos == 260 and not bool(zero.cache.k.bins.any())
    sent = tps[0].sent
    assert [type(w).__name__ for w in sent] == ["PageWire"] * 2 + ["TailWire"]
    ledger = []
    for p, w in enumerate(sent[:2]):
        want = JE.PageWire(*(JKV.pack_kv(JKV.QuantizedKV(*map(
            jnp.asarray, interop.quantized_kv_to_numpy(
                TKV.slice_pages(q, p)))), stages=spec)
            for q in (src.k, src.v)))
        for jw, tw in zip(want, w):
            _assert_wire_equal(jw, tw)
        ledger.append(("PageWire", p,
                       float(JTP.bytes_moved(want, op="send_pages"))))
    tail = JE.TailWire(*(jnp.asarray(np.asarray(t.float() if t.dtype ==
                                                torch.bfloat16 else t))
                         .astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                 else jnp.float32) for t in sent[2]))
    ledger.append(("TailWire", 2,
                   float(JTP.bytes_moved(tail, op="send_pages"))))
    assert got.stats["ledger"] == ledger == zero.stats["ledger"]
    assert got.stats["sends"] == 3 and got.stats["pages_streamed"] == 2
    kv_cfg = TKV.kv_quantizer_config()
    a, b = TE._clone_cache(got.cache), src
    tok = got.next_token
    for i in range(260, 264):
        la, a = TS.serve_step(tc, tp, a, tok, i, None, kv_cfg)
        lb, b = TS.serve_step(tc, tp, b, tok, i, None, kv_cfg)
        assert torch.equal(la.view(torch.int32), lb.view(torch.int32))
        tok = torch.argmax(la, -1).to(torch.int32).reshape(1, 1)
    eng = TE.DecodeEngine(tc, tp, n_slots=1, seq=512, device="cpu")
    out = eng.run([prompt], 3, prefill_fn=lambda p: got)
    assert out[0][0] == int(got.next_token)
    assert eng.stats()["sends"] == 3


# ------------------------------------------------------------ the builds --

def test_full_moe_configs_build_like_reference():
    """build() of the full olmoe-1b-7b and qwen3-moe-235b-a22b: the
    reference's parameter count (olmoe 6,816,335,872) and shapes; the
    router float32, the experts [L, E, D, F] / [L, E, F, D]."""
    for name in ("olmoe-1b-7b", "qwen3-moe-235b-a22b"):
        tb, jb = t_build(TR.get(name)), j_build(JR.get(name))
        assert tb.n_params() == jb.n_params()
        lay = tb.specs["layers"]
        cfg = TR.get(name)
        assert lay["router"].dtype == torch.float32
        assert lay["w1"].shape == lay["w3"].shape == (
            cfg.n_layers, cfg.moe_experts, cfg.d_model, cfg.d_ff)
        assert lay["w2"].shape == (cfg.n_layers, cfg.moe_experts, cfg.d_ff,
                                   cfg.d_model)
        jshapes = {k: tuple(v.shape) for k, v in jb.specs["layers"].items()}
        assert {k: tuple(v.shape) for k, v in lay.items()} == jshapes
    assert t_build(TR.get("olmoe-1b-7b")).n_params() == 6_816_335_872


def test_params_carry_moe_tree_across(models):
    jc, tc, jp, tp = models["qwen3-moe-235b-a22b"]
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w2"].dtype == torch.bfloat16
    for k in ("router", "w1", "w3", "w2"):
        a = np.asarray(jp["layers"][k])
        t = tp["layers"][k]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(np.int16),
                                          t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(a, t.numpy())


def test_hybrid_forward_and_prefill_raise():
    """The hybrid's forward and prefill run (tests/test_torch_hybrid.py
    holds them against the reference): on the port's own weights, finite
    bfloat16 logits of the reference's shape, and prefill the last of
    them bit for bit.  What raises is the decoder stack called for a
    family with a stack of its own (ssm)."""
    cfg = TR.get("jamba-1.5-large-398b").reduced()
    bundle = t_build(cfg)
    assert "periods" in bundle.specs
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 16)))
    logits, aux = TT.forward(cfg, params, toks, remat=False)
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == (2, 16, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    last = bundle.prefill(params, {"tokens": toks})
    assert torch.equal(last, logits[:, -1].float())
    # the ssm family has a stack of its own: the decoder stack names it
    dense = dataclasses.replace(TR.get("internlm2-20b").reduced(),
                                family="ssm")
    with pytest.raises(ValueError, match="models.xlstm_stack"):
        TT.forward(dense, {}, torch.zeros((1, 4), dtype=torch.int32))

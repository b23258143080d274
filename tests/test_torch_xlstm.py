"""The port's ssm family (`repro_torch.models.xlstm` and `xlstm_stack`)
against the JAX package's `repro.models` on the reduced xlstm-350m, and
the configs' analytic parameter counts over every architecture.

The weights are the reference's own (the 3-d sLSTM `rh` leaf and the
float32 norms included), carried across by `params_from_numpy`.  Logits
are held within LOGIT_TOL = 2e-2 of the reference's largest |logit|
(sound runs read 0.2-0.7e-2; an mLSTM forget gate through `sigmoid` in
place of `log_sigmoid` reads 0.69), the loss within LOSS_TOL and each
gradient leaf within GRAD_TOL of its largest value.  The chunkwise mLSTM
is held against the exact sequential step at the reference's own
tolerances (tests/test_xlstm_chunkwise.py).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import xlstm as JX
from repro.models import xlstm_stack as JXS
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.launch.train import value_and_grad
from repro_torch.models import build as t_build
from repro_torch.models import xlstm as TX
from repro_torch.models import xlstm_stack as TXS
from repro_torch.models.params import params_from_numpy

B, S = 2, 128
SERVE_STEPS = 32
LOGIT_TOL = 2e-2
LOSS_TOL = 1e-3
GRAD_TOL = 1.5e-2


@pytest.fixture(scope="module")
def model():
    jc = JR.get("xlstm-350m").reduced()
    tc = TR.get("xlstm-350m").reduced()
    jp = jax.jit(j_build(jc).init)(jax.random.PRNGKey(80))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(81).integers(0, jc.vocab, (B, S + 1)).astype(
        np.int32)
    jlog, _ = jax.jit(lambda p, t: JXS.forward(jc, p, t))(
        jp, jnp.asarray(tok[:, :-1]))
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, tok=tok,
                jlog=np.asarray(jlog, np.float32))


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ref - np.asarray(got, np.float32)).max()
                 / np.abs(ref).max())


def _gates(b, t, h, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    k /= 4
    ig = rng.standard_normal((b, t, h)).astype(np.float32)
    fg = np.array(jax.nn.log_sigmoid(
        rng.standard_normal((b, t, h)).astype(np.float32) + 2.0))
    return q, k, v, ig, fg


def test_mlstm_chunkwise_matches_sequential_step():
    """tests/test_xlstm_chunkwise.py in the port: h within rtol = atol =
    2e-4, the boundary state within rtol 2e-3, atol 1e-4; and the port's
    chunkwise against the reference's."""
    b, t, h, dh = 2, 128, 2, 16
    arrs = _gates(b, t, h, dh, 82)
    q, k, v, ig, fg = map(torch.from_numpy, arrs)
    state = (torch.zeros(b, h, dh, dh), torch.zeros(b, h, dh),
             torch.full((b, h), -1e30))
    c, hs = state, []
    for i in range(t):
        c, y = TX._mlstm_step(c, (q[:, i], k[:, i], v[:, i], ig[:, i],
                                  fg[:, i]))
        hs.append(y)
    h_seq = torch.stack(hs, dim=1).numpy()
    cs, ms = c[0].numpy(), c[2].numpy()
    j0 = tuple(jnp.asarray(s.numpy()) for s in state)
    for chunk in (16, 32, 128):
        h_ch, (cc, _, mc) = TX._mlstm_chunkwise(q, k, v, ig, fg, state,
                                                chunk=chunk)
        np.testing.assert_allclose(h_ch.numpy(), h_seq, rtol=2e-4,
                                   atol=2e-4, err_msg=f"chunk={chunk}")
        c_seq = cs * np.exp(ms)[..., None, None]
        c_chk = cc.numpy() * np.exp(mc.numpy())[..., None, None]
        np.testing.assert_allclose(c_chk, c_seq, rtol=2e-3, atol=1e-4)
        hj, _ = JX._mlstm_chunkwise(*map(jnp.asarray, arrs), j0, chunk=chunk)
        np.testing.assert_allclose(h_ch.numpy(), np.asarray(hj), rtol=2e-4,
                                   atol=2e-4)


def test_mlstm_chunkwise_grad_finite():
    b, t, h, dh = 1, 64, 2, 8
    q, k, v, ig, fg = map(torch.from_numpy, _gates(b, t, h, dh, 83))
    q.requires_grad_(True)
    state = (torch.zeros(b, h, dh, dh), torch.zeros(b, h, dh),
             torch.full((b, h), -1e30))
    hh, _ = TX._mlstm_chunkwise(q, k, v, ig, fg, state, chunk=16)
    (g,) = torch.autograd.grad(hh.square().sum(), q)
    assert bool(torch.isfinite(g).all())


def test_blocks_match_reference_with_and_without_state(model):
    """One mLSTM and one sLSTM block of layer 0's weights over a sequence,
    then one token on the state they leave (the decode form)."""
    jp, tp = model["jp"], model["tp"]
    x = np.random.default_rng(84).standard_normal((B, 64, 128)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for name, jf, tf in (("mlstm", JX.mlstm_block, TX.mlstm_block),
                         ("slstm", JX.slstm_block, TX.slstm_block)):
        jpp = jax.tree.map(lambda a: a[0], jp[name])
        tpp = {k: v[0] for k, v in tp[name].items()}
        jy, js = jf(jpp, jx, 4)
        with torch.no_grad():
            ty, ts = tf(tpp, tx, 4)
            ty1, _ = tf(tpp, tx[:, :1], 4, state=ts)
        jy1, _ = jf(jpp, jx[:, :1], 4, state=js)
        assert _rel(jy, ty.float()) <= LOGIT_TOL, name
        assert _rel(jy1, ty1.float()) <= LOGIT_TOL, name
        for a, b in zip(js, ts):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-2,
                                       atol=2e-2)


def test_forward_loss_and_grads_match_reference(model):
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    with torch.no_grad():
        tlog, aux = TXS.forward(tc, tp, torch.from_numpy(tok[:, :-1]))
    assert float(aux) == 0.0
    assert _rel(model["jlog"], tlog.float()) <= LOGIT_TOL
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(j_build(jc).loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (tl, _), tg = value_and_grad(t_build(tc), tp,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    worst = max(_rel(a, b.float()) for a, b in
                zip(jax.tree.leaves(jg), T.leaves(tg)))
    assert worst <= GRAD_TOL, worst


def test_prefill_matches_reference(model):
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    t = tok[:, :-1]
    want = jax.jit(j_build(jc).prefill)(jp, {"tokens": jnp.asarray(t)})
    got = t_build(tc).prefill(tp, {"tokens": torch.from_numpy(t)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(want, got) <= LOGIT_TOL


def test_serve_steps_match_reference_and_forward(model):
    """32 teacher-forced steps on the recurrent state, against the
    reference's steps and the port's own forward at each position."""
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    jcache = j_build(jc).make_cache(B, SERVE_STEPS)
    tcache = t_build(tc).make_cache(B, SERVE_STEPS, device="cpu")
    for j, t in zip(jax.tree.leaves(jcache),
                    [x for k in ("m", "s") for x in tcache[k]]):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    step = jax.jit(lambda p, c, t, pos: j_build(jc).serve_step(p, c, t, pos))
    with torch.no_grad():
        tfwd, _ = TXS.forward(tc, tp, torch.from_numpy(tok[:, :SERVE_STEPS]))
    for pos in range(SERVE_STEPS):
        t = tok[:, pos:pos + 1]
        jl, jcache = step(jp, jcache, jnp.asarray(t), jnp.int32(pos))
        with torch.no_grad():
            tl, out = t_build(tc).serve_step(tp, tcache, torch.from_numpy(t),
                                             pos)
        assert out is tcache and tl.dtype == torch.float32
        assert _rel(jl, tl) <= LOGIT_TOL, pos
        assert _rel(tl, tfwd[:, pos].float()) <= LOGIT_TOL, pos


def test_log_sigmoid_forget_gate_fault_fails_the_tolerance(model,
                                                           monkeypatch):
    """Planted fault: the forget gates through sigmoid, not log_sigmoid."""
    monkeypatch.setattr(F, "logsigmoid", torch.sigmoid)
    with torch.no_grad():
        tlog, _ = TXS.forward(model["tc"], model["tp"],
                              torch.from_numpy(model["tok"][:, :-1]))
    assert _rel(model["jlog"], tlog.float()) > LOGIT_TOL


def test_param_counts_and_archs_match_reference():
    assert TR.all_archs().keys() == JR.all_archs().keys()
    for name, jc in JR.all_archs().items():
        tc = TR.all_archs()[name]
        for cfg_j, cfg_t in ((jc, tc), (jc.reduced(), tc.reduced())):
            assert cfg_t.param_count() == cfg_j.param_count(), name
            assert cfg_t.active_param_count() == cfg_j.active_param_count()
            assert cfg_t._mamba_params() == cfg_j._mamba_params()
            assert cfg_t._xlstm_params() == cfg_j._xlstm_params()
    for name in ("whisper-base", "xlstm-350m"):
        assert (t_build(TR.get(name)).n_params()
                == j_build(JR.get(name)).n_params())


def test_hybrid_still_raises():
    """The hybrid's loss, cache and decode step run (tests/test_torch_hybrid.py
    holds them against the reference); what still raises is its QuantCache
    path, which the reference's engine refuses (engine.py:125)."""
    from repro_torch.compression import kv as TKV
    from repro_torch.models import serve as TS
    cfg = TR.get("jamba-1.5-large-398b").reduced()
    bundle = t_build(cfg)
    params = bundle.init(torch.Generator().manual_seed(1), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        loss = bundle.loss(params, {"tokens": tok, "labels": tok})[0]
        cache = bundle.make_cache(1, 128, device="cpu")
        logits, cache = bundle.serve_step(params, cache, tok[:, :1], 0)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
    assert bool(cache[1][1].abs().sum() > 0)           # the SSM state moved
    with pytest.raises(NotImplementedError, match="engine.py:125"):
        TS.serve_step_rows(cfg, params, TS.make_quant_cache(
            cfg, 1, 128, device="cpu"), tok[:, :1], [0],
            TKV.kv_quantizer_config())

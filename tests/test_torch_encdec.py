"""The port's encoder-decoder family (`repro_torch.models.encdec`, with
`layers.layer_norm`, the tanh `ffn` GELU and `layers.chunked_scan`) against
the JAX package's `repro.models` on the reduced whisper-base.

The weights are the reference's own, carried across by
`params_from_numpy` (float32 LayerNorm w/b included); both packages get
the same tokens and the same bfloat16 frames.  Logits are held within
LOGIT_TOL = 2e-2 of the reference's largest |logit| (the bfloat16
products round in another order: sound runs read 0.8-1.4e-2, a decoder
that drops its cross-attention 0.32), the loss within LOSS_TOL and each
gradient leaf within GRAD_TOL of its largest value, as
tests/test_torch_train.py holds the decoder stack.  The serve step's
cross-attention K/V are the encoder's output times each layer's cross
`wkv`, computed by the reference and carried across.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import registry as JR
from repro.models import build as j_build
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.serve import RawCache as JRaw
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.launch.train import stub_frames, value_and_grad
from repro_torch.models import build as t_build
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.params import params_from_numpy
from repro_torch.models.serve import RawCache as TRaw

B, S = 2, 128
SERVE_STEPS = 32
LOGIT_TOL = 2e-2
LOSS_TOL = 1e-3
GRAD_TOL = 1.5e-2


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


@pytest.fixture(scope="module")
def model():
    jc = JR.get("whisper-base").reduced()
    tc = TR.get("whisper-base").reduced()
    jp = jax.jit(j_build(jc).init)(jax.random.PRNGKey(70))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(71)
    tok = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, jc.enc_context, jc.d_model)).astype(
        np.float32)
    jf, tf = _bf16(frames)
    jlog, _ = jax.jit(lambda p, t, f: JE.forward(jc, p, t, f))(
        jp, jnp.asarray(tok[:, :-1]), jf)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, tok=tok, jf=jf, tf=tf,
                jlog=np.asarray(jlog, np.float32))


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ref - np.asarray(got, np.float32)).max()
                 / np.abs(ref).max())


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(72)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JL.layer_norm(jnp.asarray(x, dt), jnp.asarray(w),
                                        jnp.asarray(b), 1e-5), np.float32)
        got = TL.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            torch.from_numpy(b), 1e-5).float().numpy()
        tol = 1e-5 if tdt == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ffn_gelu_is_the_tanh_form():
    """The reference's `jax.nn.gelu(approximate=True)` is torch's
    `approximate="tanh"`; torch's default exact GELU misses the float32
    tolerance (planted fault)."""
    rng = np.random.default_rng(73)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32) for s in
                 ((8, 64), (64, 96), (96, 64)))
    want = np.asarray(JL.ffn(*map(jnp.asarray, (x, w1)), None,
                             jnp.asarray(w2), "gelu"))
    tx, tw1, tw2 = map(torch.from_numpy, (x, w1, w2))
    got = TL.ffn(tx, tw1, None, tw2, "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = (F.gelu(tx @ tw1) @ tw2).numpy()
    assert np.abs(exact - want).max() > 1e-3


@pytest.mark.parametrize("t,chunk", [(128, 64), (100, 64), (8, 64)])
def test_chunked_scan_matches_reference(t, chunk):
    """A gated recurrence through both scans; T = 100 takes the chunk = 1
    rule; the port's remat changes neither values nor gradients."""
    rng = np.random.default_rng(74)
    xs = rng.standard_normal((t, 3, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.5

    def j_step(c, x):
        (h,) = c
        h = jnp.tanh(h @ jnp.asarray(w) + x)
        return (h,), h * 2.0

    def t_step(c, x, w=torch.from_numpy(w)):
        (h,) = c
        h = torch.tanh(h @ w + x)
        return (h,), h * 2.0

    (jh,), jys = JL.chunked_scan(j_step, (jnp.zeros((3, 4)),),
                                 jnp.asarray(xs), chunk=chunk)
    (th,), tys = TL.chunked_scan(t_step, (torch.zeros(3, 4),),
                                 torch.from_numpy(xs), chunk=chunk)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    grads = []
    for remat in (True, False):
        x = torch.from_numpy(xs).requires_grad_(True)
        _, ys = TL.chunked_scan(t_step, (torch.zeros(3, 4),), x,
                                chunk=chunk, remat=remat)
        grads.append(torch.autograd.grad(ys.square().sum(), x)[0])
    assert torch.equal(grads[0], grads[1])


def test_params_carry_across(model):
    jc, tc, jp, tp = (model[k] for k in ("jc", "tc", "jp", "tp"))
    assert t_build(tc).n_params() == j_build(jc).n_params()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for k in path:
            node = node[k.key]
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(a.view(np.int16),
                                          node.view(torch.int16).numpy())
        else:
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(a, node.numpy())
    own = t_build(tc).init(torch.Generator().manual_seed(0), device="cpu")
    assert bool((own["dec"]["self"]["ln"]["w"] == 1).all())
    assert bool((own["dec"]["self"]["ln"]["b"] == 0).all())


def test_forward_loss_and_grads_match_reference(model):
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    with torch.no_grad():
        tlog, aux = TE.forward(tc, tp, torch.from_numpy(tok[:, :-1]),
                               model["tf"])
    assert float(aux) == 0.0
    assert _rel(model["jlog"], tlog.float()) <= LOGIT_TOL

    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()},
          "frames": model["jf"]}
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()},
          "frames": model["tf"]}
    (jl, _), jg = jax.jit(jax.value_and_grad(j_build(jc).loss,
                                             has_aux=True))(jp, jb)
    (tl, _), tg = value_and_grad(t_build(tc), tp, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    worst = max(_rel(a, b.float()) for a, b in
                zip(jax.tree.leaves(jg), T.leaves(tg)))
    assert worst <= GRAD_TOL, worst


def test_prefill_matches_reference(model):
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    t = tok[:, :-1]
    want = jax.jit(j_build(jc).prefill)(
        jp, {"tokens": jnp.asarray(t), "frames": model["jf"]})
    got = t_build(tc).prefill(tp, {"tokens": torch.from_numpy(t),
                                   "frames": model["tf"]})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(want, got) <= LOGIT_TOL


def _caches(model):
    """Both packages' caches with the cross K/V of the reference's encoder
    output (each decoder layer's `enc_out @ wkv`)."""
    jc, tc, jp = model["jc"], model["tc"], model["jp"]
    enc = jax.jit(lambda p, f: JE.encode(jc, p, f))(jp, model["jf"])
    kv = jnp.stack([(enc @ jp["dec"]["cross"]["wkv"][i]).reshape(
        B, jc.enc_context, 2, jc.n_heads, jc.head_dim)
        for i in range(jc.n_layers)])
    jcross = JRaw(kv[:, :, :, 0], kv[:, :, :, 1])
    tcross = TRaw(*(params_from_numpy(np.asarray(a), device="cpu")
                    for a in jcross))
    want = TE.cross_kv(model["tc"], model["tp"], params_from_numpy(
        np.asarray(enc), device="cpu"))
    for a, b in zip(want, tcross):      # bf16 products, another order
        assert _rel(b.float(), a.float()) <= 2 ** -7
    jself = j_build(jc).make_cache(B, SERVE_STEPS)[0]
    tself = t_build(tc).make_cache(B, SERVE_STEPS, device="cpu")[0]
    return (jself, jcross), (tself, tcross)


def _serve_errors(model):
    """Per teacher-forced step: the port's logits against the reference's
    and against the port's own forward at that position."""
    jc, tc, jp, tp, tok = (model[k] for k in ("jc", "tc", "jp", "tp", "tok"))
    jcache, tcache = _caches(model)
    step = jax.jit(lambda p, c, t, pos: j_build(jc).serve_step(p, c, t, pos))
    with torch.no_grad():
        tfwd, _ = TE.forward(tc, tp, torch.from_numpy(tok[:, :SERVE_STEPS]),
                             model["tf"])
    out = []
    for pos in range(SERVE_STEPS):
        t = tok[:, pos:pos + 1]
        jl, jcache = step(jp, jcache, jnp.asarray(t), jnp.int32(pos))
        with torch.no_grad():
            tl, tcache = t_build(tc).serve_step(tp, tcache,
                                                torch.from_numpy(t), pos)
        assert tl.dtype == torch.float32
        out.append((_rel(jl, tl), _rel(tl, tfwd[:, pos].float())))
    return out


def test_serve_steps_match_reference_and_forward(model):
    errs = _serve_errors(model)
    assert max(e for e, _ in errs) <= LOGIT_TOL, errs
    assert max(e for _, e in errs) <= LOGIT_TOL, errs


def test_dropped_cross_attention_fails_the_tolerance(model, monkeypatch):
    """Planted fault: a decoder whose cross-attention adds nothing."""
    real = TE._mha
    monkeypatch.setattr(TE, "_mha", lambda cfg, p, xq, xkv, causal: (
        real(cfg, p, xq, xkv, causal) if xq is xkv else torch.zeros_like(xq)))
    with torch.no_grad():
        tlog, _ = TE.forward(model["tc"], model["tp"],
                             torch.from_numpy(model["tok"][:, :-1]),
                             model["tf"])
    assert _rel(model["jlog"], tlog.float()) > LOGIT_TOL


def test_cache_shapes_and_train_frames(model):
    jc, tc = model["jc"], model["tc"]
    jself, jcross = j_build(jc).make_cache(3, 40)
    tself, tcross = t_build(tc).make_cache(3, 40, device="cpu")
    for j, t in ((jself, tself), (jcross, tcross)):
        assert all(tuple(a.shape) == tuple(b.shape) and b.dtype ==
                   torch.bfloat16 for a, b in zip(j, t))
    assert TE.MAX_DEC_LEN == JE.MAX_DEC_LEN
    f = stub_frames(tc, 2, 5, torch.device("cpu"))
    assert f.shape == (2, tc.enc_context, tc.d_model)
    assert f.dtype == torch.bfloat16
    assert torch.equal(f, stub_frames(tc, 2, 5, torch.device("cpu")))
    assert not torch.equal(f, stub_frames(tc, 2, 6, torch.device("cpu")))

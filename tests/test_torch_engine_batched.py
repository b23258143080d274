"""The engine's batched step (`repro_torch.models.engine.DecodeEngine.
generate_step` over `serve.serve_step_rows`, a position a row) against its
batch-1 path (`step_one`), the aligned batch-1 `serve_step`, and the JAX
package's `DecodeEngine` (its vmapped step).

Four slots hold prompts of different lengths, so their pages close at
different steps; one slot is evicted and re-inserted, one is released and
left free for three steps before a new request takes it.  Every live
slot's logits and tokens must be the `step_one` chain's bit for bit, a
free slot's cache, position and token must not move, and the logits must
lie within 2e-2 of the reference engine's largest |logit|
(tests/test_torch_serve.py's limit).  On the CPU no op of the step depends
on the batch: every row of `serve_step_rows` is also the aligned batch-1
step's bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.models import build as j_build
from repro.models import engine as JE
from repro_torch import tree as T
from repro_torch.compression import kv as TKV
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.configs import registry as TR
from repro_torch.models import engine as TE
from repro_torch.models import serve as TS
from repro_torch.models.params import params_from_numpy

RNG = np.random.default_rng(2028)
LOGIT_TOL = 2e-2
SEQ, SLOTS, STEPS = 256, 4, 12
PROMPTS = (126, 120, 9, 30)        # pages close at steps 2 and 8
LATE = 12                          # the prompt that takes the freed slot
TINY = dict(name="tiny-batched", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, head_dim=16)
TINY_MOE = dict(name="tiny-batched-moe", family="moe", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
                head_dim=16, moe_experts=4, moe_top_k=2)
CONFIGS = {"dense": TINY, "moe": TINY_MOE}


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        jc, tc = JArch(**kw), TArch(**kw)
        jp = j_build(jc).init(jax.random.PRNGKey(60 + i))
        out[name] = (jc, tc, jp,
                     params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu"))
    return out


@pytest.fixture(scope="module")
def prompts():
    return [RNG.integers(0, 512, n).astype(np.int32)
            for n in PROMPTS + (LATE,)]


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _run(eng, prompts, ref: bool = False) -> dict:
    """The schedule on an engine: 4 requests, slot 1 evicted and
    re-inserted after step 3, slot 2 released after step 5 and refilled
    with the late prompt after step 8.  Returns {request: [(logits row,
    token)] per step it was live, first its prefill's}, and the free
    slot's state before and after its 3 free steps."""
    rows = {r: [] for r in range(len(prompts))}
    slot_of = {}

    def admit(r, slot):
        pre = eng.prefill(prompts[r])
        eng.insert(slot, pre, request=r)
        slot_of[r] = slot
        rows[r].append((np.asarray(pre.logits[0], np.float32),
                        int(np.asarray(pre.next_token).reshape(()))))

    for r in range(SLOTS):
        admit(r, r)
    frozen = {}
    for step in range(STEPS):
        logits, toks = eng.generate_step()
        logits, toks = np.asarray(logits, np.float32), np.asarray(toks)
        for r, slot in slot_of.items():
            if eng.requests[slot] == r:
                rows[r].append((logits[slot], int(toks[slot])))
        if step == 3:
            eng.insert(1, eng.evict(1), request=1)
        if step == 5:
            eng.release(2)
            del slot_of[2]
            if not ref:
                frozen["before"] = _slot_state(eng, 2)
        if step == 8:
            if not ref:
                frozen["after"] = _slot_state(eng, 2)
            admit(len(PROMPTS), 2)
    return rows, frozen


def _slot_state(eng, slot):
    return ([t.clone() for t in T.leaves(eng._slot_cache(slot))],
            eng._pos[slot], int(eng._tok[slot, 0]))


def _replay(eng, prompt, n: int) -> list:
    """The request alone through `step_one`: (logits, token) of its prefill
    and n steps."""
    cache = TS.make_quant_cache(eng.cfg, 1, eng.seq, device="cpu")
    for i, t in enumerate(prompt):
        logits, cache = eng.step_one(cache, torch.tensor([[int(t)]]), i)
    out = []
    for k in range(n + 1):
        tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
        out.append((logits[0], int(tok)))
        if k < n:
            logits, cache = eng.step_one(cache, tok, len(prompt) + k)
    return out


@pytest.fixture(scope="module")
def port_runs(models, prompts):
    """The schedule on the port's engine, once a config: {name: (engine,
    rows, frozen, the batch of each `_attn_history` call)}."""
    out = {}
    for name in CONFIGS:
        _, tc, _, tp = models[name]
        eng = TE.DecodeEngine(tc, tp, n_slots=SLOTS, seq=SEQ,
                              stages=TR.get_kv_chain("kv-page"),
                              device="cpu")
        calls = []
        real = TS._attn_history
        TS._attn_history = lambda cfg, q, *a, **kw: (
            calls.append(q.shape[0]), real(cfg, q, *a, **kw))[1]
        try:
            rows, frozen = _run(eng, prompts)
        finally:
            TS._attn_history = real
        out[name] = (eng, rows, frozen, calls)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_engine_bit_identical_to_step_one(models, prompts, name,
                                                  port_runs):
    """Every live slot's logits and tokens equal the step_one chain's bit
    for bit through page closes at different steps, an evict -> insert
    and a slot left free; the free slot's cache, position and token do
    not move; one generate_step attends the history of every slot in one
    B12 call a layer."""
    _, tc, _, _ = models[name]
    eng, rows, frozen, calls = port_runs[name]
    # one call over every slot a layer from the step where the first page
    # has closed (step 2) on; no prompt reaches a closed page in prefill
    assert set(calls) == {SLOTS}
    assert calls.count(SLOTS) == tc.n_layers * (STEPS - 2)
    for r, got in rows.items():
        want = _replay(eng, prompts[r], len(got) - 1)
        for (a, ta), (b, tb) in zip(got, want):
            assert torch.equal(_i32(torch.from_numpy(a)), _i32(b)), r
            assert ta == tb, r
    (c0, p0, t0), (c1, p1, t1) = frozen["before"], frozen["after"]
    assert p0 == p1 and t0 == t1
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))
    st = eng.stats()
    assert st["steps"] == STEPS and st["evictions"] == 1
    assert st["generated_tokens"] == STEPS * SLOTS - 3


def test_rows_step_equals_batch1_steps(models):
    """serve_step_rows over 4 rows at positions 0, 126, 127 and 200 (no
    history, a page about to close, the closing step, two closed pages)
    for 3 steps, row 3 dead on step 2: every live row's logits equal the
    aligned serve_step at batch 1 on its own cache, bit for bit; the dead
    row's cache does not move."""
    _, tc, _, tp = models["dense"]
    kv = TKV.kv_quantizer_config()
    pos0 = [0, 126, 127, 200]
    toks = torch.from_numpy(RNG.integers(0, 512, (3, 4, 1)).astype(np.int32))
    caches = []
    for p in pos0:                         # each row's history, batch 1
        c = TS.make_quant_cache(tc, 1, SEQ, device="cpu")
        for i, t in enumerate(RNG.integers(0, 512, p)):
            _, c = TS.serve_step(tc, tp, c, torch.tensor([[int(t)]]), i,
                                 None, kv)
        caches.append(c)
    rows = TS.QuantCache(*(
        TS.KVC.QuantizedKV(*(torch.cat([getattr(c, f)[j] for c in caches], 1)
                             for j in range(5))) if f in ("k", "v")
        else torch.cat([getattr(c, f) for c in caches], 1)
        for f in ("k", "v", "hot_k", "hot_v")))
    pos = list(pos0)
    for step in range(3):
        live = [True, True, True, step != 1]
        before = [t[:, 3].clone() for t in T.leaves(rows)]
        got, _ = TS.serve_step_rows(tc, tp, rows, toks[step], pos, kv,
                                    live=live)
        for r in range(4):
            if not live[r]:
                assert all(torch.equal(a, t[:, 3]) for a, t in
                           zip(before, T.leaves(rows)))
                continue
            want, _ = TS.serve_step(tc, tp, caches[r], toks[step, r:r + 1],
                                    pos[r], None, kv)
            assert torch.equal(_i32(got[r]), _i32(want[0])), (step, r)
            pos[r] += 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_engine_near_the_reference_engine(models, prompts, name,
                                                  port_runs):
    """The same schedule on the reference's DecodeEngine (its vmapped
    step): every live slot's greedy tokens the same, its logits within
    LOGIT_TOL of the reference's largest |logit| at every step."""
    jc, tc, jp, tp = models[name]
    got = port_runs[name][1]
    want, _ = _run(JE.DecodeEngine(jc, jp, n_slots=SLOTS, seq=SEQ,
                                   stages=TR.get_kv_chain("kv-page")),
                   [jnp.asarray(p) for p in prompts], ref=True)
    for r in got:
        assert len(got[r]) == len(want[r])
        for (a, ta), (b, tb) in zip(got[r], want[r]):
            assert ta == tb, r
            assert np.abs(a - b).max() / np.abs(b).max() < LOGIT_TOL, r


def test_raw_slot_bytes_equals_the_reference(models):
    for name in CONFIGS:
        jc, tc, jp, tp = models[name]
        a = TE.DecodeEngine(tc, tp, n_slots=2, seq=SEQ, device="cpu")
        b = JE.DecodeEngine(jc, jp, n_slots=2, seq=SEQ)
        assert a.raw_slot_bytes() == b.raw_slot_bytes() == (
            2 * tc.n_layers * SEQ * tc.n_kv_heads * tc.head_dim * 2)

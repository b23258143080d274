"""The port's storage and runtime path against the JAX package's: the
host serializer (`core.serializer`: streams byte for byte, decodes bit
for bit, `compression_ratio` on both wires), the checkpoint manager
(`checkpoint.manager`: the reference's leaf files byte for byte,
retention, partial directories, the lossy bound, a save on the worker
thread that holds the state as of `save`), and the training loop
(`runtime.train_loop`: restart-exact resume of the compressed step on
the reduced internlm2-20b, stopped by SIGTERM at step 3, with a raw and
a lossy checkpoint, the donating shared-state step held against the
pure replica step; `StragglerMonitor`, `AuditCounters`,
`PreemptionGuard`).  Every comparison is exact except the lossy
checkpoint's, which holds each restored value within its eb (float64).
"""
import os
import signal
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import QuantizerConfig as JQ
from repro.core import serializer as JS
from repro.configs import registry as JR
from repro.models import build as j_build
from repro_torch import tree as T
from repro_torch.checkpoint import manager as TMgr
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compression import grads as TG
from repro_torch.configs import registry as TR
from repro_torch.core import serializer as TS
from repro_torch.core.audit import AuditReport
from repro_torch.core.axis import run_threads
from repro_torch.core.config import QuantizerConfig as TQ
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as TT
from repro_torch.models import build as t_build
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import optimizer as TO
from repro_torch.runtime.train_loop import (AuditCounters, PreemptionGuard,
                                            StragglerMonitor,
                                            TrainLoopConfig, resume_or_init,
                                            run)

RNG = np.random.default_rng(29)
# NOA over the whole float32 range overflows its range to inf, as the
# reference's oracle does
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")
LOSSY_EB = 1e-6


def special_sweep(n=1 << 14):
    """Uniform over the float32 bit space (every exponent class, denormals,
    NaN payloads, infinities) and the paper's special values up front."""
    x = RNG.integers(0, 1 << 32, n, dtype=np.uint32).view(np.float32).copy()
    x[:10] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-42, -1e-42,
              np.uint32(0x7FC00123).view(np.float32),
              np.finfo(np.float32).max, 5e-4]
    return x


def smooth(n=1 << 14):
    t = np.linspace(0, 8 * np.pi, n)
    x = (np.sin(t) * np.cos(3 * t) + 0.1 * RNG.standard_normal(n)).astype(
        np.float32)
    x[::911] = np.nan
    x[::713] = -np.inf
    x[5] = -0.0
    x[7] = 1e-41
    return x


def all_outliers(n=300):
    x = np.where(RNG.integers(0, 2, n).astype(bool), np.float32(np.nan),
                 np.float32(np.inf)).astype(np.float32)
    x[::3] = np.uint32(0x7FC00001).view(np.float32)
    return x


FIELDS = {"sweep": special_sweep, "smooth": smooth,
          "all-outliers": all_outliers}


# ------------------------------------------------------------- serializer --

@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-3),
                                     ("noa", 1e-4)])
def test_serializer_streams_byte_identical(field, bits, mode, eb):
    x = FIELDS[field]()
    kw = dict(mode=mode, error_bound=eb, bin_bits=bits)
    want = JS.serialize(x, JQ(**kw))
    got = TS.serialize(x, TQ(**kw))
    assert got == want
    try:
        yr, cfg_r = JS.deserialize(want)
    except ValueError:
        # NOA over the whole float32 range: the range overflows to inf,
        # and both packages refuse the header's eb (ROADMAP C)
        with pytest.raises(ValueError, match="error_bound"):
            TS.deserialize(got)
        return
    y, cfg = TS.deserialize(got)
    assert y.dtype == yr.dtype and y.tobytes() == yr.tobytes()
    assert (cfg.mode, cfg.error_bound, cfg.bin_bits) == (
        cfg_r.mode, cfg_r.error_bound, cfg_r.bin_bits)


@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-3)])
def test_compression_ratio_host_and_device_equal_reference(mode, eb):
    x = smooth()
    kw = dict(mode=mode, error_bound=eb, bin_bits=16)
    assert TS.compression_ratio(x, TQ(**kw)) == JS.compression_ratio(
        x, JQ(**kw))
    got = TS.compression_ratio(x, TQ(**kw), wire="both", device="cpu")
    assert got == JS.compression_ratio(x, JQ(**kw), wire="both")
    stages = TS.compression_ratio(x, TQ(**kw), wire="device", device="cpu",
                                  pipeline="abs:1e-3|pack:16|zero|narrow",
                                  per_stage=True)
    assert stages == JS.compression_ratio(
        x, JQ(**kw), wire="device", pipeline="abs:1e-3|pack:16|zero|narrow",
        per_stage=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.compression_ratio(x, TQ(**kw), wire="device")


# ------------------------------------------------------------- checkpoint --

def state_tree(seed=0):
    """A small training-like tree: nested dicts, a NamedTuple, bfloat16,
    float32 (one leaf past 1024 values) and a 0-d int32."""
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((64, 40)).astype(ml_dtypes.bfloat16),
              "layers": {"b": r.standard_normal(40).astype(np.float32),
                         "a": r.standard_normal((4, 300)).astype(
                             np.float32)}}
    ost = TO.OptState(np.int32(7), {"x": r.standard_normal(
        2048).astype(np.float32)}, {"x": np.zeros(2048, np.float32)}, None)
    return (params, ost)


def as_port(tree):
    return T.tree_map(lambda a: params_from_numpy(a, device="cpu"), tree)


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("lossy", [None, LOSSY_EB], ids=["raw", "lossy"])
def test_leaf_files_byte_identical_to_reference(tmp_path, lossy):
    tree = state_tree()
    jq = None if lossy is None else JQ(mode="abs", error_bound=lossy)
    tq = None if lossy is None else TQ(mode="abs", error_bound=lossy)
    JManager(str(tmp_path / "ref"), lossy=jq).save(3, as_jax(tree),
                                                   blocking=True)
    CheckpointManager(str(tmp_path / "port"), lossy=tq).save(
        3, as_port(tree), blocking=True)
    ref = tmp_path / "ref" / "step-000000000003"
    port = tmp_path / "port" / "step-000000000003"
    names = sorted(p.name for p in ref.iterdir() if p.name.startswith("leaf"))
    assert names == sorted(p.name for p in port.iterdir()
                           if p.name.startswith("leaf"))
    assert len(names) == len(jax.tree.leaves(tree))
    for name in names:
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    # the port restores the reference's checkpoint (bfloat16 leaves too);
    # the reference restores no bfloat16 leaf, its own or the port's
    # (ROADMAP C-ref-4)
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(
        as_port(tree), device="cpu")
    assert step == 3
    for a, b in zip(jax.tree.leaves(tree), T.leaves(got)):
        b = b.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if b.dtype == torch.bfloat16 else b.numpy()
        if lossy is None or a.dtype != np.float32 or a.size <= 1024:
            assert np.asarray(a).tobytes() == b.tobytes()
        else:
            assert np.abs(a.astype(np.float64) - b).max() <= lossy
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="cast"):
            JManager(str(tmp_path / d)).restore(as_jax(tree))


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = as_port(state_tree())
    for step in (10, 20, 30):
        mgr.save(step, T.tree_map(lambda x: x + step, state))
    mgr.wait()
    assert mgr.all_steps() == [20, 30]
    restored, step = mgr.restore(state)
    assert step == 30
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert torch.equal(a + 30, b) and b.dtype == a.dtype


@pytest.mark.parametrize("lossy", [None, LOSSY_EB], ids=["raw", "lossy"])
def test_async_save_is_the_state_at_save(tmp_path, monkeypatch, lossy):
    """A save on the worker thread writes the state as it was when `save`
    returned, though the caller updates the tensors in place (a CPU leaf
    too: the donating train step does so while the files are written).
    The worker is held before its first file until the update is done."""
    gate = threading.Event()
    for name in ("_save_leaf", "serialize"):
        real = getattr(TMgr, name)
        monkeypatch.setattr(TMgr, name, lambda *a, _f=real, **k: (
            gate.wait(), _f(*a, **k))[1])
    q = None if lossy is None else TQ(mode="abs", error_bound=lossy)
    mgr = CheckpointManager(str(tmp_path), lossy=q)
    state = as_port(state_tree())
    saved = T.tree_map(torch.clone, state)
    mgr.save(1, state)
    for t in T.leaves(state):
        t.add_(1)
    gate.set()
    mgr.wait()
    got, _ = mgr.restore(saved)
    for a, b in zip(T.leaves(saved), T.leaves(got)):
        if lossy is not None and a.dtype == torch.float32 and a.numel() > 1024:
            assert float((a.double() - b.double()).abs().max()) <= lossy
        else:
            assert torch.equal(a, b)


def test_checkpoint_partial_dir_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, as_port(state_tree()), blocking=True)
    os.makedirs(tmp_path / "step-000000000099")      # torn: no manifest
    _, step = mgr.restore(as_port(state_tree()))
    assert step == 5


def test_lossy_checkpoint_bounded(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2,
                            lossy=TQ(mode="abs", error_bound=1e-5))
    w = torch.from_numpy(RNG.standard_normal(4096).astype(np.float32))
    mgr.save(1, {"w": w}, blocking=True)
    restored, _ = mgr.restore({"w": torch.empty(4096, device="meta")},
                              device="cpu")
    err = (w.double() - restored["w"].double()).abs().max()
    assert float(err) <= 1e-5
    files = list((tmp_path / "step-000000000001").glob("*.lc"))
    assert files and files[0].stat().st_size < 4096 * 4
    with pytest.raises(ValueError, match="meta"):
        mgr.restore({"w": torch.empty(4096, device="meta")})


# ------------------------------------------------------------------- loop --

LOOP_STEPS, LOOP_SEQ, LOOP_BATCH = 6, 8, 4


@pytest.fixture(scope="module")
def loop_parts():
    """The reduced internlm2-20b's compressed step over 2 thread pods:
    its init_fn (weights carried from the reference), the step with one
    state that the pods update in place (shared_state, donate), the
    batches, and the states of the pure replica step after 2 and after
    LOOP_STEPS uninterrupted steps."""
    jc, tc = JR.get("internlm2-20b").reduced(), TR.get("internlm2-20b"
                                                       ).reduced()
    host = jax.tree.map(np.asarray, j_build(jc).init(jax.random.PRNGKey(1)))
    ocfg = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=LOOP_STEPS)
    gc = TG.GradCompressionConfig(eb_rel=2.0 ** -5,
                                  pipeline=TR.get_pipeline("grad-wire-8"))
    step = TT.make_train_step_compressed(t_build(tc), None, ocfg, gc)
    shared = TT.make_train_step_compressed(t_build(tc), None, ocfg, gc,
                                           donate=True, shared_state=True)
    pipe = TokenPipeline(DataConfig(tc.vocab, LOOP_SEQ, LOOP_BATCH, seed=2))

    def init_fn(device):
        if device == "meta":
            params = t_build(tc).abstract_params()
        else:
            params = params_from_numpy(host, device=device)
        return (params, TO.init(params, ocfg), TT.init_residuals(params, 2))

    def step_fn(state, batch):
        return run_threads(2, lambda ax: shared(state, batch, ax))[0]
    states = [init_fn("cpu")]
    for i in range(LOOP_STEPS):
        states.append(run_threads(2, lambda ax: step(states[-1], pipe.batch(
            i), ax))[0][0])
    return init_fn, step_fn, pipe.batch, states[2], states[-1]


def states_equal(a, b) -> bool:
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("lossy", [None, LOSSY_EB], ids=["raw", "lossy"])
def test_restart_exact_resume(tmp_path, loop_parts, lossy):
    """Six uninterrupted steps of the pure step against three of the
    donating one in `run`, a SIGTERM, a restore by `resume_or_init` and
    three more: bit-identical params, OptState and residuals with a raw
    checkpoint; with a lossy one every restored value within eb of the
    saved state.  The step-2 checkpoint, written on the worker thread
    while step 3 updated the state in place, is the state after two
    steps."""
    init_fn, step_fn, batch_fn, at2, full = loop_parts
    cfg = TrainLoopConfig(total_steps=LOOP_STEPS, checkpoint_every=2,
                          log_every=1)

    def preempt(step, metrics, dt, straggle):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    q = None if lossy is None else TQ(mode="abs", error_bound=lossy)
    mgr = CheckpointManager(str(tmp_path / "b"), lossy=q)
    part, last, stopped = run(step_fn, init_fn("cpu"), batch_fn, mgr, cfg,
                              on_metrics=preempt)
    assert (last, stopped) == (3, True)
    assert mgr.all_steps() == [2, 3]
    state, start = resume_or_init(mgr, init_fn, device="cpu")
    assert start == 3
    two, _ = mgr.restore(init_fn("meta"), step=2, device="cpu")
    if lossy is None:
        assert states_equal(two, at2)
        assert states_equal(state, part)
        resumed, last, _ = run(step_fn, state, batch_fn, mgr, cfg,
                               start_step=start)
        assert last == LOOP_STEPS and states_equal(resumed, full)
    else:
        for want, got in ((part, state), (at2, two)):
            for a, b in zip(T.leaves(want), T.leaves(got)):
                if a.dtype == torch.float32 and a.numel() > 1024:
                    assert float((a.double() - b.double()).abs().max()
                                 ) <= lossy
                else:
                    assert torch.equal(a, b)
        assert not states_equal(state, part)


def test_resume_or_init_without_a_checkpoint(tmp_path, loop_parts):
    init_fn = loop_parts[0]
    state, step = resume_or_init(CheckpointManager(str(tmp_path)), init_fn,
                                 device="cpu")
    assert step == 0 and states_equal(state, init_fn("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resume_or_init(CheckpointManager(str(tmp_path)), init_fn)


def report(violations=0, nonfinite=0, overflow=0, max_err=0.0):
    t = lambda v, d=torch.int32: torch.tensor(v, dtype=d)
    return AuditReport(n=t(128), violations=t(violations),
                       max_err=t(max_err, torch.float32),
                       n_nonfinite=t(nonfinite), n_outliers=t(0),
                       overflow=t(bool(overflow), torch.bool))


def test_audit_counters_fold_reports_and_lists():
    c = AuditCounters()
    c.fold({"loss": 1.0})
    c.fold({"audit": report(max_err=1e-4)})
    c.fold({"audit": [report(violations=2, max_err=3e-4), None,
                      report(nonfinite=1, overflow=1)]})
    d = c.as_dict()
    assert d["audit_reports"] == 3
    assert d["audit_violations"] == 2
    assert d["audit_nonfinite"] == 1
    assert d["audit_overflow"] == 1
    assert d["audit_max_err"] == pytest.approx(3e-4)


def test_train_loop_surfaces_cumulative_audit_metrics(tmp_path):
    def step_fn(state, batch):
        s = {"acc": state["acc"] + 1, "step": state["step"] + 1}
        return s, {"loss": 0.0, "audit": report(violations=1)}

    seen = []
    cfg = TrainLoopConfig(total_steps=6, checkpoint_every=100, log_every=2)
    run(step_fn, {"acc": torch.zeros(()), "step": torch.zeros((), dtype=
                                                              torch.int32)},
        lambda i: {"tokens": torch.zeros(1, dtype=torch.int32)},
        CheckpointManager(str(tmp_path), keep=2), cfg,
        on_metrics=lambda step, m, dt, s: seen.append((step, m)))
    assert [s for s, _ in seen] == [2, 4, 6]
    cum = [m["audit_cumulative"] for _, m in seen]
    assert [c["audit_reports"] for c in cum] == [2, 4, 6]
    assert [c["audit_violations"] for c in cum] == [2, 4, 6]
    assert "audit" in seen[0][1]


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=3.0, warmup=2)
    for i in range(10):
        assert not mon.record(i, 0.1)
    assert mon.record(10, 1.0)
    assert mon.events and mon.events[0][0] == 10
    assert not mon.record(11, 0.1)


def test_preemption_guard_sets_the_flag_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is before

"""Fault-tolerant training runtime (counterpart of
`repro.runtime.train_loop`).

  * restart-exact resume: checkpoint (params, optimizer state,
    error-feedback residuals) + a data pipeline that is a pure function of
    the step -> a run stopped at any step resumes bit for bit.
  * preemption: SIGTERM/SIGINT set a flag; the loop checkpoints and exits
    cleanly at the next step boundary.
  * stragglers: a per-step wall-time EWMA; steps slower than
    `straggler_factor` x EWMA are recorded (the scheduler's drain hook).

A checkpoint restores onto a mesh rebuilt from the devices at hand
through `runtime.elastic.resize`.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from .. import tree as T
from ..checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    log_every: int = 10
    straggler_factor: float = 3.0


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful stop at the next step boundary."""

    def __init__(self):
        self.requested = False
        self._orig = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:          # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        return False


class StragglerMonitor:
    def __init__(self, factor: float, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.ewma = None
        self.events: list[tuple[int, float]] = []
        self._n = 0

    def record(self, step: int, dt: float) -> bool:
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self._n > self.warmup
                        and dt > self.factor * self.ewma)
        if is_straggler:
            self.events.append((step, dt))   # -> scheduler drain hook
        else:
            self.ewma = 0.9 * self.ewma + 0.1 * dt
        return is_straggler


class AuditCounters:
    """Cumulative audit counters for the loop: step functions that encode
    with verify=True surface their `AuditReport`(s) under
    metrics["audit"] (one report or a list), and the loop folds them here,
    so a run-level count of bound violations exists without the caller
    wiring its own accumulator."""

    def __init__(self):
        self.reports = 0
        self.violations = 0
        self.n_nonfinite = 0
        self.overflow = 0
        self.max_err = 0.0

    def fold(self, metrics) -> None:
        if not isinstance(metrics, dict) or "audit" not in metrics:
            return
        reps = metrics["audit"]
        # AuditReport IS a (Named)tuple — a single report is one with
        # the counter fields, anything else iterable is a list of them
        if hasattr(reps, "violations"):
            reps = (reps,)
        for rep in reps:
            if rep is None:
                continue
            self.reports += 1
            self.violations += int(rep.violations)
            self.n_nonfinite += int(rep.n_nonfinite)
            self.overflow += int(rep.overflow)
            self.max_err = max(self.max_err, float(rep.max_err))

    def as_dict(self) -> dict:
        return dict(audit_reports=self.reports,
                    audit_violations=self.violations,
                    audit_nonfinite=self.n_nonfinite,
                    audit_overflow=self.overflow,
                    audit_max_err=self.max_err)


def _sync(state) -> None:
    """Wait for the card to finish the step (the reference's
    block_until_ready on the state's first leaf)."""
    flat = T.leaves(state)
    if flat and torch.is_tensor(flat[0]) and flat[0].is_cuda:
        torch.cuda.synchronize(flat[0].device)


def run(step_fn: Callable, state, batch_fn: Callable,
        ckpt: CheckpointManager, cfg: TrainLoopConfig,
        start_step: int = 0, on_metrics: Optional[Callable] = None):
    """Generic loop: state, metrics = step_fn(state, batch_fn(step)).
    Returns (state, last_step, interrupted).

    When step_fn's metrics dict carries an "audit" entry (an
    `AuditReport` or list of them, from encode(verify=True)), the loop
    accumulates run-level counters and hands `on_metrics` the dict with
    an extra "audit_cumulative" key (see `AuditCounters`)."""
    monitor = StragglerMonitor(cfg.straggler_factor)
    audit = AuditCounters()
    step = start_step
    with PreemptionGuard() as guard:
        while step < cfg.total_steps:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            _sync(state)
            dt = time.perf_counter() - t0
            straggle = monitor.record(step, dt)
            audit.fold(metrics)
            step += 1
            if on_metrics and (step % cfg.log_every == 0 or straggle):
                if isinstance(metrics, dict) and audit.reports:
                    metrics = dict(metrics,
                                   audit_cumulative=audit.as_dict())
                on_metrics(step, metrics, dt, straggle)
            if step % cfg.checkpoint_every == 0 or guard.requested:
                ckpt.save(step, state)
            if guard.requested:
                ckpt.wait()
                return state, step, True
    ckpt.wait()
    return state, step, False


def resume_or_init(ckpt: CheckpointManager, init_fn: Callable,
                   device="cuda"):
    """Restore the latest checkpoint or build fresh state.  init_fn(device)
    builds the state on `device`; called with "meta" it gives the template,
    which allocates nothing (the reference's eval_shape).  The state lands
    on `device`, the card unless the caller passes "cpu".  Returns
    (state, step)."""
    template = init_fn("meta")
    restored, step = ckpt.restore(template, device=device)
    if restored is None:
        return init_fn(device), 0
    return restored, step

"""The dry-run's count of a scan on meta (`models.layers.chunked_scan`:
chunk 0 and chunk 1 run, every later chunk a stand-in that credits chunk
1's measured cost) against the same program run in full on the CPU under
`launch.cost.counting`: FLOPs, kernel launches and collective bytes equal,
and the peak of live bytes equal (the stand-ins make the storages the
chunks they replace leave alive, one each, so the allocator's granules
round alike).

  (a) a toy recurrence: without autograd, with it and remat, with it and
      no remat (the chunk's saved tensors kept), with a tuple of xs, and
      under an enclosing checkpoint;
  (b) `mamba_block` and `slstm_block` at narrow widths, the chunk forced
      small through the module's `chunked_scan`;
  (c) the reduced jamba-1.5-large-398b: its prefill at T = 256 and its
      loss and gradient at T = 64 in chunks of 16;
  (d) a planted fault: a stand-in that credits one chunk too few fails
      the equality.

tests/test_torch_dryrun.py holds the reduced jamba's scaled forward
against the reference's HLO count.  torch runs on one thread here
(`test_torch_moe.one_thread`).
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.core.axis import MetaAxis
from repro_torch.launch import cost
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import xlstm as XL

from test_torch_moe import one_thread  # noqa: F401  (autouse fixture)


def _leaf(shape, dtype, device, rng):
    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.from_numpy(0.1 * rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _count(fn, held, recorder=None) -> dict:
    """fn() under `cost.counting` with the held tensors' bytes as the
    base, as `launch.dryrun.measure` counts a cell."""
    base = cost.tree_bytes(held, lambda t: cost.granule_bytes(
        t.numel() * t.element_size()))
    before = cost.launch_counts()
    with cost.counting(base, recorder) as c:
        fn()
    after = cost.launch_counts()
    return {"flops": c.flops, "peak": c.peak_bytes, "live": c.live_bytes,
            "collectives": c.collective_bytes,
            "launches": {k: n - before[k] for k, n in after.items()
                         if n != before[k]}}


@pytest.fixture
def stand_ins(monkeypatch):
    """Counts the chunks the meta scans stood in for."""
    seen = []
    real = L._stand_in

    def counted(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(L, "_stand_in", counted)
    return seen


# ----------------------------------------------------------- (a) a toy --

def _toy(device, mode, tuple_xs=False, outer=False, t=64, chunk=8,
         recorder=None):
    """A tanh recurrence h = tanh(x W + h U), y = h U, over T steps, the
    loss sum(y) + sum(h); with autograd the gradient of W and x.  With a
    recorder, each chunk's carry also goes through a MetaAxis psum."""
    rng = np.random.default_rng(0)
    b, d = 3, 16
    w, u = _leaf((d, d), torch.float32, device, rng), \
        _leaf((d, d), torch.float32, device, rng)
    x = _leaf((t, b, d), torch.float32, device, rng)
    grad = mode != "nograd"
    if grad:
        w.requires_grad_(True)
        x.requires_grad_(True)
    axis = None if recorder is None else MetaAxis(2, recorder)

    def step(carry, xt):
        (h,) = carry
        if tuple_xs:
            xt = xt[0] + xt[1]
        h = torch.tanh(xt @ w + h @ u)
        if axis is not None:
            h = axis.pmean(h)
        return (h,), h @ u

    def scan(xin):
        xs = (xin, xin * 3) if tuple_xs else xin
        h0 = torch.zeros((b, d), device=xin.device)
        (h,), ys = L.chunked_scan(step, (h0,), xs, chunk=chunk,
                                  remat=mode != "noremat")
        return ys.sum() + h.sum()

    def fn():
        with torch.set_grad_enabled(grad):
            xin = x * 2
            loss = (checkpoint(scan, xin, use_reentrant=False) if outer
                    else scan(xin))
            if grad:
                torch.autograd.grad(loss, [w, x])

    return _count(fn, [w, u, x], recorder)


TOY = [("nograd", False, False), ("remat", False, False),
       ("noremat", False, False), ("remat", True, False),
       ("nograd", True, False), ("noremat", True, False),
       ("remat", False, True)]


@pytest.mark.parametrize("mode,tuple_xs,outer", TOY,
                         ids=[f"{m}{'-tuple' if t else ''}"
                              f"{'-outer' if o else ''}" for m, t, o in TOY])
def test_toy_scan_scaled_on_meta_equals_the_cpu_run(mode, tuple_xs, outer,
                                                    stand_ins):
    cpu = _toy("cpu", mode, tuple_xs, outer)
    assert not stand_ins                       # the CPU runs every chunk
    meta = _toy("meta", mode, tuple_xs, outer)
    assert len(stand_ins) >= 6                 # 8 chunks: 0 and 1 run
    assert meta == cpu


def test_toy_scan_credits_collective_bytes(stand_ins):
    """A psum inside the step: the stand-ins credit chunk 1's recorded
    bytes, so the meta count records every chunk's."""
    for mode in ("nograd", "remat"):
        # two chunks, never scaled, against eight: 16 steps against 64
        ref = _toy("meta", mode, t=16, chunk=8, recorder=cost.Recorder())
        scaled = _toy("meta", mode, t=64, chunk=8, recorder=cost.Recorder())
        assert ref["collectives"] and scaled["collectives"] == {
            k: 4 * n for k, n in ref["collectives"].items()}, mode
    assert stand_ins


# --------------------------------------------------- (b) the two blocks --

def _block(kind, device, grad, outer):
    rng = np.random.default_rng(2)
    d, b, t = 32, 2, 48
    if kind == "mamba":
        shapes = MB.mamba_params_shape(d, 4, torch.bfloat16)
        fn = lambda p, x: MB.mamba_block(p, x)[0]          # noqa: E731
    else:
        shapes = XL.slstm_params_shape(d, 2, torch.bfloat16)
        fn = lambda p, x: XL.slstm_block(p, x, 2)[0]       # noqa: E731
    p = {k: _leaf(s, dt, device, rng) for k, (s, dt) in shapes.items()}
    x = _leaf((b, t, d), torch.bfloat16, device, rng)
    if grad:
        for v in list(p.values()) + [x]:
            v.requires_grad_(True)

    def run():
        with torch.set_grad_enabled(grad):
            y = (checkpoint(fn, p, x, use_reentrant=False) if outer
                 else fn(p, x))
            if grad:
                torch.autograd.grad(y.float().sum(), [x, *p.values()])

    return _count(run, [p, x])


BLOCKS = [(k, g, o) for k in ("mamba", "slstm")
          for g, o in ((False, False), (True, False), (True, True))]


@pytest.mark.parametrize("kind,grad,outer", BLOCKS,
                         ids=[f"{k}-{'grad' if g else 'nograd'}"
                              f"{'-outer' if o else ''}"
                              for k, g, o in BLOCKS])
def test_blocks_scaled_on_meta_equal_the_cpu_run(kind, grad, outer,
                                                 monkeypatch, stand_ins):
    mod = MB if kind == "mamba" else XL
    monkeypatch.setattr(mod, "chunked_scan", lambda *a, **k: L.chunked_scan(
        *a, **{**k, "chunk": 6}))                          # 8 chunks
    cpu = _block(kind, "cpu", grad, outer)
    meta = _block(kind, "meta", grad, outer)
    assert len(stand_ins) >= 6
    assert meta == cpu


# ----------------------------------------------- (c) the reduced jamba --

JAMBA = TR.get("jamba-1.5-large-398b").reduced()


def _jamba(device, what):
    bundle = build(JAMBA)
    params = (bundle.abstract_params() if device == "meta" else
              bundle.init(torch.Generator().manual_seed(0), device="cpu"))
    if what == "prefill":
        tok = torch.zeros((1, 256), dtype=torch.int32, device=device)
        with torch.no_grad():
            return _count(lambda: bundle.prefill(params, {"tokens": tok}),
                          [params, tok])
    tok = torch.zeros((2, 64), dtype=torch.int32, device=device)
    batch = {"tokens": tok, "labels": tok}
    flat, tdef = T.flatten(params)
    xs = [p.detach().requires_grad_(True) for p in flat]

    def fn():
        with torch.enable_grad():
            loss, _ = bundle.loss(T.unflatten(tdef, xs), batch)
            torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)

    return _count(fn, [xs, batch])


@pytest.mark.parametrize("what,chunk", [("prefill", 64), ("loss_grad", 16)])
def test_reduced_jamba_scaled_on_meta_equals_the_cpu_run(what, chunk,
                                                         monkeypatch,
                                                         stand_ins):
    """Prefill at T = 256 (4 chunks a Mamba block); loss and gradient at T
    = 64 in chunks of 16 (4 chunks; the period's checkpoint replays its
    blocks, stand-ins and all)."""
    monkeypatch.setattr(MB, "chunked_scan", lambda *a, **k: L.chunked_scan(
        *a, **{**k, "chunk": chunk}))
    cpu = _jamba("cpu", what)
    meta = _jamba("meta", what)
    assert len(stand_ins) >= 7 * 2
    assert meta == cpu


# -------------------------------------------------- (d) a planted fault --

def test_a_stand_in_short_of_one_chunk_fails_the_equality(monkeypatch):
    """A stand-in that credits nothing once (one chunk too few) gives a
    count below the CPU's: the equality above catches it."""
    cpu = _toy("cpu", "remat")
    real = cost.Meter.credit
    skipped = []

    def short(self, spend, times=1, live=None):
        if not skipped:
            skipped.append(spend)
            return None
        return real(self, spend, times, live)

    monkeypatch.setattr(cost.Meter, "credit", short)
    meta = _toy("meta", "remat")
    assert skipped and meta["flops"] == cpu["flops"] - skipped[0].flops
    assert meta != cpu


def test_unscaled_scans_run_every_chunk_on_meta(stand_ins):
    """Two chunks (too few to measure one and stand in for another), and
    meta outside a count, run as the CPU does."""
    assert _toy("meta", "remat", t=16, chunk=8) == _toy("cpu", "remat",
                                                        t=16, chunk=8)
    h0 = torch.zeros((2, 3), device="meta")
    xs = torch.empty((64, 2, 3), device="meta")
    _, ys = L.chunked_scan(lambda c, x: ((c[0] + x,), c[0] * x), (h0,), xs,
                           chunk=8)
    assert ys.shape == (64, 2, 3) and not stand_ins

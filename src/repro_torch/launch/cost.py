"""What a rank's program costs, counted while it runs (the port's
counterpart of `repro.launch.hlo_analysis`, which reads the same three
things from XLA's HLO text).

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the
    matmul-class ops (mm, addmm, bmm, baddbmm, convolutions, attention),
    the counterpart of `hlo_analysis.dot_flops`, plus what the program
    credits (`Meter.credit`).  The port's loops are Python loops and
    run in full, but for one: on meta, `models.layers.chunked_scan` runs
    the chunks that measure one chunk (`Meter.open` / `close`) and
    credits that chunk's cost for each chunk it does not run, as
    `hlo_analysis.computation_multipliers` scales a scan's body by its
    trip count.
  * The peak of live tensor bytes (`PeakTracker`): every new storage an op
    makes is added when it appears and taken off when it is freed; views
    and in-place results add nothing, and storages made before the count
    (the program's inputs) are the caller's `base`.  A credited chunk
    notes the live bytes then plus the measured chunk's transient.  The
    counterpart of the compiled program's `temp_bytes` (+ its arguments).
  * Collective bytes by kind (`Recorder`, filled by `core.axis.MetaAxis`
    and by credits), the counterpart of `hlo_analysis.collective_bytes`.

Kernel launches are the kernel modules' own counters (`launch_counts`);
credits add to them.  All of it runs on any device: on "meta"
(`launch.dryrun`, nothing allocated) and on the card (`chip_smoke.py`
holds the dry-run's numbers against the card's own run of the same
step).
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

ALLOC_GRANULE = 512   # the CUDA caching allocator rounds every block to it


def granule_bytes(n: int) -> int:
    """n bytes as the CUDA caching allocator counts them: at least one
    512-byte granule, rounded up to a whole number of granules."""
    return max(1, -(-int(n) // ALLOC_GRANULE)) * ALLOC_GRANULE


def tree_bytes(tree, leaf_bytes=None) -> int:
    """Bytes of every tensor leaf of a tree (dicts, lists, tuples and
    NamedTuples), each leaf through `leaf_bytes` (default: numel times
    element size)."""
    leaves = [t for t in tree_flatten(tree)[0] if torch.is_tensor(t)]
    if leaf_bytes is None:
        return sum(t.numel() * t.element_size() for t in leaves)
    return sum(leaf_bytes(t) for t in leaves)


class Recorder:
    """Collective bytes by kind ("all-reduce", "all-gather",
    "reduce-scatter", "all-to-all", "collective-permute"); a
    `core.axis.MetaAxis` (or a `core.axis.RecordingAxis` on thread and
    process ranks) calls it per collective: the sharded layout's FSDP and
    "model" gathers as all-gathers, their gradients as reduce-scatters.
    Thread-safe."""

    def __init__(self):
        self.bytes: dict = {}
        self._lock = threading.Lock()

    def __call__(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)


class TraceBudgetExceeded(RuntimeError):
    """A counted program ran past its time budget (`counting(budget_s=)`)."""


class PeakTracker(TorchDispatchMode):
    """The live bytes of the storages made inside it, and their peak.

    Each op's outputs are looked at: a storage not seen before (not an
    input's, not a view of one made inside) adds its bytes, rounded up to
    the caching allocator's 512-byte granule; a weak reference to the
    storage takes them off when it is freed.  `peak` is the largest live
    total, `live` the total at exit; `base` (set by the caller: the bytes
    of the inputs the program holds) is added to both by `peak_bytes`.
    Each storage of ours carries a serial number, in the order they were
    made (`made_since`).  With a `deadline` (time.perf_counter()), an op
    past it raises TraceBudgetExceeded."""

    def __init__(self, base: int = 0, deadline=None):
        super().__init__()
        self.base, self.live, self.peak = int(base), 0, 0
        self.deadline, self.ops, self.serial = deadline, 0, 0
        self._ours: dict = {}        # storage key -> (finalizer, n, serial)
        self._theirs: dict = {}      # storages made before the count
        self._lock = threading.RLock()   # a finalizer may run inside it

    @property
    def peak_bytes(self) -> int:
        return self.base + self.peak

    def note(self, extra: int, live=None) -> None:
        """A peak of `live` (default: the live bytes now) plus `extra` (a
        credited chunk's transient)."""
        with self._lock:
            live = self.live if live is None else int(live)
            self.peak = max(self.peak, live + int(extra))

    def made_since(self, serial: int) -> dict:
        """{storage key: bytes} of our storages alive now that were made
        after `serial`."""
        with self._lock:
            return {k: v[1] for k, v in self._ours.items() if v[2] > serial}

    def _drop(self, table: dict, key: int, n: int) -> None:
        with self._lock:
            if table.pop(key, None) is not None and table is self._ours:
                self.live -= n

    def _storage(self, t):
        try:
            return t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return None          # tensors with no storage (sparse, ...)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if (self.deadline is not None and self.ops % 256 == 0
                and time.perf_counter() > self.deadline):
            raise TraceBudgetExceeded(f"the program ran past its budget "
                                      f"after {self.ops} ops (at {func})")
        for t in tree_flatten((args, kwargs))[0]:
            if torch.is_tensor(t):
                st = self._storage(t)
                if st is None:
                    continue
                key = st._cdata
                with self._lock:
                    known = key in self._ours or key in self._theirs
                if not known:
                    fin = weakref.finalize(st, self._drop, self._theirs,
                                           key, 0)
                    with self._lock:
                        self._theirs[key] = fin
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if torch.is_tensor(t):
                st = self._storage(t)
                if st is None:
                    continue
                key = st._cdata
                with self._lock:
                    if key in self._ours or key in self._theirs:
                        continue
                n = granule_bytes(st.nbytes())
                fin = weakref.finalize(st, self._drop, self._ours, key, n)
                with self._lock:
                    self.serial += 1
                    self._ours[key] = (fin, n, self.serial)
                    self.live += n
                    self.peak = max(self.peak, self.live)
        return out


class Spend:
    """What a stretch of a counted program spent: FLOPs, kernel launches
    {wrapper counter: n}, collective bytes {kind: n}, and `transient`,
    the most bytes it held at once above what was live when it began."""

    __slots__ = ("flops", "launches", "collectives", "transient")

    def __init__(self, flops: int, launches: dict, collectives: dict,
                 transient: int):
        self.flops, self.launches = int(flops), launches
        self.collectives, self.transient = collectives, int(transient)


def kernel_modules():
    """The kernel modules, each with its wrappers' `LAUNCHES` counters."""
    from ..kernels import dense, kv_attention, lossless, pack
    return pack, lossless, dense, kv_attention


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter {counter: n}."""
    return {k: n for m in kernel_modules() for k, n in m.LAUNCHES.items()}


def _minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}


class Meter:
    """The `counting` in progress (`meter()`), for code that counts a
    stretch of itself and credits what it does not run
    (`models.layers.chunked_scan` on meta).

    `open()` / `close(token)` measure the stretch between them as a
    `Spend`, with the storages it made that are still alive; windows
    nest.  `credit(spend, times, live)` adds `times` x its FLOPs,
    launches and collective bytes, and notes the peak `live` (default:
    the live bytes now) + its transient.  `memo` keeps measurements for
    the count's length; `deferred` counts credits owed until a
    measurement comes (a window that closes with more owed than it
    opened with, or a count that ends with any, raises)."""

    def __init__(self, flops: FlopCounterMode, tracker: PeakTracker,
                 recorder: Recorder):
        self.flops_mode, self.tracker, self.recorder = flops, tracker, recorder
        self.credited = 0
        self.memo: dict = {}
        self.deferred = self.windows = 0

    def flops(self) -> int:
        return int(self.flops_mode.get_total_flops()) + self.credited

    def open(self) -> tuple:
        t = self.tracker
        with t._lock:
            tok = (self.flops(), launch_counts(), dict(self.recorder.bytes),
                   t.peak, t.live, t.serial, self.deferred)
            t.peak = t.live
        self.windows += 1
        return tok

    def close(self, tok: tuple) -> tuple:
        """(the Spend since `open`, {storage key: bytes} made since and
        alive now)."""
        flops, launches, coll, peak0, live0, serial, deferred = tok
        if self.deferred > deferred:
            raise RuntimeError("a measured stretch left credits owed "
                               f"({self.deferred - deferred}) inside it")
        self.windows -= 1
        t = self.tracker
        made = t.made_since(serial)
        with t._lock:
            transient = t.peak - live0
            t.peak = max(peak0, t.peak)
        return Spend(self.flops() - flops, _minus(launch_counts(), launches),
                     _minus(dict(self.recorder.bytes), coll),
                     transient), made

    def credit(self, spend: Spend, times: int = 1, live=None) -> None:
        self.tracker.note(spend.transient, live)
        self.credited += times * spend.flops
        for m in kernel_modules():
            for k, n in spend.launches.items():
                if k in m.LAUNCHES:
                    m.LAUNCHES[k] += times * n
        for kind, n in spend.collectives.items():
            self.recorder(kind, times * n)


_METERS: list = []


def meter():
    """The innermost `counting` in progress, or None."""
    return _METERS[-1] if _METERS else None


class Count:
    """What `counting` measured: flops, peak_bytes (base + the transient
    peak), live_bytes at the end (base + what the program left alive),
    seconds, and the collective bytes by kind."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder
        self.flops = self.peak_bytes = self.live_bytes = 0
        self.seconds = 0.0

    @property
    def collective_bytes(self) -> dict:
        return dict(self.recorder.bytes)


@contextlib.contextmanager
def counting(base: int = 0, recorder: Recorder | None = None,
             budget_s=None):
    """Count FLOPs, the peak of live bytes over `base`, and (through the
    recorder a program's `MetaAxis` axes were given) collective bytes of
    the code run inside; yields a `Count`, filled at exit.  With
    `budget_s`, the code is stopped (TraceBudgetExceeded) once it has run
    that many seconds."""
    rec = recorder if recorder is not None else Recorder()
    c = Count(rec)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    peak = PeakTracker(base, None if budget_s is None else t0 + budget_s)
    meter = Meter(flops, peak, rec)
    _METERS.append(meter)
    try:
        with flops, peak:
            yield c
    finally:
        _METERS.remove(meter)
    if meter.deferred or meter.windows:
        raise RuntimeError(f"{meter.deferred} credited chunks' backward "
                           f"never measured, {meter.windows} windows open")
    c.seconds = time.perf_counter() - t0
    c.flops = meter.flops()
    c.peak_bytes, c.live_bytes = peak.peak_bytes, peak.base + peak.live

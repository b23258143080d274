"""Collective axes: the ranks a compressed wire crosses.

The reference runs its collectives inside `shard_map` over a named mesh
axis (`lax.all_gather`, `ppermute`, `pmax`, `psum`).  Here an axis is an
object that each rank's code holds, with the same four collectives:

    axis.size, axis.rank, axis.axis_index() (= rank)
    axis.all_gather(t)        -> [size, *t.shape], rank order
    axis.all_gather_dim(t, dim)
                              -> the ranks' t joined along dim in rank
                                 order (`lax.all_gather(..., axis=dim,
                                 tiled=True)`: the FSDP gather of a
                                 sharded weight)
    axis.all_gather_dims(ts, dims)
                              -> [all_gather_dim(t, d) for t, d], one
                                 exchange for them all on thread ranks
    axis.ppermute(t, perm)    -> what (src, rank) in perm sends here, else 0
    axis.pmax(t), axis.psum(t), axis.pmean(t)
    axis.all_gather_object(obj)
                              -> every rank's object, rank order (thread
                                 ranks only)
    axis.all_to_all(t, split_axis, concat_axis)
                              -> `lax.all_to_all(..., tiled=True)`: t cut
                                 into `size` chunks along split_axis, chunk
                                 j sent to rank j, the chunks received
                                 joined along concat_axis in rank order

Two implementations run the same per-rank code:

  * `DistAxis`: over `torch.distributed` (gloo on the CPU, NCCL across
    cards), one process per rank;
  * `ThreadGroup.axis(r)`: p ranks as p threads of one process that
    exchange tensors through a barrier, all on one device and its current
    stream.  It is the counterpart of the reference's multi-device CPU
    mesh, and what lets p ranks share one card (NCCL refuses two ranks on
    one device).  `run_threads(p, fn)` runs fn(axis) once per rank.

A third, `MetaAxis`, is one rank of an axis whose tensors live on the
"meta" device: its collectives return empty tensors of these shapes and
record the bytes they would move (`launch.dryrun`, `launch.cost`).

Both reduce in rank order (`psum` folds ranks 0, 1, ... left to right;
`pmax` takes the maximum with NaN propagating; `pmean` sums pairwise,
((r0 + r1) + (r2 + r3)), and divides by the size, so the mean of a value
every rank holds is that value), so the two agree bit for bit.

Autograd.  `all_to_all`, `psum` and `pmean` carry gradients, so a training
forward can differentiate through the expert-parallel MoE.  A thread
rank's all_to_all and psum are built from the other ranks' tensors
themselves (a chunk, a cat, an add), so the ranks of one process share one
autograd graph, and one backward call differentiates every rank; its
backward needs no exchange (the autograd engine runs a card's backward
nodes on one worker thread, where a barrier would wait for ever).  On
`DistAxis` they are autograd functions whose backward is the transposed
exchange: the inverse all-to-all, and a psum of the gradients.
`all_gather_dim`'s gradient is the reduce-scatter of the gradients (each
rank the rank-order sum of every rank's gradient slice of its own block):
on a thread rank through the shared graph of the join, on `DistAxis` an
exchange in its backward.  `pmean`'s
gradient goes to the rank's own input alone, on both: the mean of a value
every rank holds (the MoE load-balance loss over the "model" axis, whose
ranks see the same tokens) differentiates as that value, and over ranks
that hold different values the mean of the ranks' gradients (data
parallelism's) completes it.
"""
from __future__ import annotations

import threading

import torch


def _fold(vals: list, op) -> torch.Tensor:
    out = vals[0]
    for v in vals[1:]:
        out = op(out, v)
    return out


def _tree_sum(vals: list) -> torch.Tensor:
    """Pairwise sum in rank order: ((v0 + v1) + (v2 + v3)), ...; exact
    for equal values at power-of-two sizes (a replicated value's pmean is
    that value)."""
    while len(vals) > 1:
        vals = [vals[i] + vals[i + 1] if i + 1 < len(vals) else vals[i]
                for i in range(0, len(vals), 2)]
    return vals[0]


def _join_chunks(vals: list, rank: int, split_axis: int,
                 concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all's result on `rank` from every rank's tensor."""
    size = len(vals)
    return torch.cat([v.chunk(size, split_axis)[rank] for v in vals],
                     concat_axis)


def _check_split(t: torch.Tensor, split_axis: int, size: int) -> None:
    if t.shape[split_axis] % size:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(t.shape)} "
                         f"does not split over {size} ranks")


class _OwnMean(torch.autograd.Function):
    """The ranks' mean (computed by the caller) as the value; the gradient
    to the rank's own input only."""

    @staticmethod
    def forward(ctx, own, mean):
        return mean.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RankOrder:
    """pmax/psum/pmean from `_exchange` (every rank's tensor, in rank
    order)."""

    def axis_index(self) -> int:
        return self.rank

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self._exchange(t, lambda vals: torch.cat(vals, dim))

    def all_gather_dims(self, ts, dims) -> list:
        return self._exchange(tuple(ts), lambda vals: [
            torch.cat([v[i] for v in vals], d) for i, d in enumerate(dims)])

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, lambda vals: _fold(vals, torch.maximum))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, lambda vals: _fold(vals, torch.add))

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        mean = self._exchange(t, lambda vals: _tree_sum(
            [v.detach() for v in vals]) / self.size)
        return _OwnMean.apply(t, mean)


# ----------------------------------------------------------- thread axis --

class ThreadGroup:
    """p ranks as p threads of one process.  Each collective is one
    exchange: every rank leaves its tensor in its slot, all wait, all
    compute their result from the slots, all wait again before the slots
    are reused.  The result is made before the second wait, so a rank may
    write its input in place as soon as the collective returns."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"axis size must be >= 1, got {size}")
        self.size = size
        self._slots = [None] * size
        self._barrier = threading.Barrier(size)

    def axis(self, rank: int) -> "ThreadAxis":
        return ThreadAxis(self, rank)

    def abort(self) -> None:
        """Break the barrier, so a failure in one rank ends the others."""
        self._barrier.abort()


class ThreadAxis(_RankOrder):
    """Rank `rank` of a `ThreadGroup`."""

    def __init__(self, group: ThreadGroup, rank: int):
        self.group, self.rank, self.size = group, rank, group.size

    def _exchange(self, t: torch.Tensor, combine=list):
        """combine(every rank's tensor, in rank order), computed while
        every rank waits (the tensors are the ranks' own, not copies)."""
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        try:
            out = combine(list(g._slots))
        finally:
            g._barrier.wait()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._exchange(t, torch.stack)

    def all_gather_object(self, obj) -> list:
        """Every rank's Python object, in rank order (the objects
        themselves: thread ranks share one process)."""
        return self._exchange(obj, list)

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        src = [s for s, d in perm if d == self.rank]
        return self._exchange(t, lambda vals: vals[src[0]].clone() if src
                              else torch.zeros_like(t))

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        _check_split(t, split_axis, self.size)
        return self._exchange(t, lambda vals: _join_chunks(
            vals, self.rank, split_axis, concat_axis))


def run_threads(size: int, fn) -> list:
    """[fn(axis of rank r) for r in range(size)], each rank in a thread of
    its own, with the caller's number of intra-op threads (a new thread
    would otherwise start a team of every core for each CPU op: p ranks
    oversubscribe the cores p times).  If a rank raises, the others are
    released and its exception is raised here."""
    group = ThreadGroup(size)
    results, errors = [None] * size, [None] * size
    n_threads = torch.get_num_threads()

    def work(r):
        torch.set_num_threads(n_threads)
        try:
            results[r] = fn(group.axis(r))
        except BaseException as e:          # noqa: BLE001 - re-raised below
            errors[r] = e
            group.abort()

    threads = [threading.Thread(target=work, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errs = [e for e in errors if e is not None]
    if errs:      # the first rank that failed, not one it released
        raise next((e for e in errs
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errs[0])
    return results


# ------------------------------------------------------ distributed axis --

class _DistAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, t, split_axis, concat_axis):
        ctx.axis, ctx.split, ctx.concat = axis, split_axis, concat_axis
        return axis._all_to_all(t, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (None, ctx.axis._all_to_all(g.contiguous(), ctx.concat,
                                           ctx.split), None, None)


class _DistPsum(torch.autograd.Function):
    """psum; its gradient is the psum of the gradients."""

    @staticmethod
    def forward(ctx, axis, t):
        ctx.axis = axis
        return _fold(axis._exchange(t), torch.add)

    @staticmethod
    def backward(ctx, g):
        return None, _fold(ctx.axis._exchange(g.contiguous()), torch.add)


class _DistGatherDim(torch.autograd.Function):
    """all_gather_dim; its gradient is the reduce-scatter of the gradients:
    every rank's slice of this rank's block, summed in rank order."""

    @staticmethod
    def forward(ctx, axis, t, dim):
        ctx.axis, ctx.dim = axis, dim
        return torch.cat(axis._exchange(t), dim)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.axis
        parts = [v.chunk(ax.size, ctx.dim)[ax.rank]
                 for v in ax._exchange(g.contiguous())]
        return None, _fold(parts, torch.add), None


class DistAxis(_RankOrder):
    """The ranks of a `torch.distributed` process group (the default group
    unless one is given); the caller has run `init_process_group`."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist, self.group = dist, group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    @staticmethod
    def _wire_dtype(t: torch.Tensor) -> torch.Tensor:
        # bool planes travel as bytes (gloo has no bool), 16-bit floats as
        # their bytes (a contiguous t: the last dim doubles)
        if t.dtype == torch.bool:
            return t.to(torch.uint8)
        if t.dtype in (torch.bfloat16, torch.float16):
            return t.view(torch.uint8)
        return t

    @staticmethod
    def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dtype in (torch.bfloat16, torch.float16):
            return w.view(like.dtype)
        return w.to(like.dtype)

    def _exchange(self, t: torch.Tensor, combine=list):
        flat = self._wire_dtype(t.reshape(-1).contiguous())
        outs = [torch.empty_like(flat) for _ in range(self.size)]
        self._dist.all_gather(outs, flat, group=self.group)
        return combine([self._from_wire(o, t).reshape(t.shape) for o in outs])

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _DistPsum.apply(self, t)

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _DistGatherDim.apply(self, t, dim)

    def all_gather_dims(self, ts, dims) -> list:
        return [self.all_gather_dim(t, d) for t, d in zip(ts, dims)]

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        vals = self._exchange(t.detach())
        return _OwnMean.apply(t, _tree_sum(vals) / self.size)

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        _check_split(t, split_axis, self.size)
        return _DistAllToAll.apply(self, t, split_axis, concat_axis)

    def _all_to_all(self, t, split_axis: int, concat_axis: int):
        """One all_to_all_single (gloo and NCCL have it) over t with
        split_axis moved to the front."""
        wire = self._wire_dtype(t.movedim(split_axis, 0).contiguous())
        out = torch.empty_like(wire)
        self._dist.all_to_all_single(out, wire, group=self.group)
        return torch.cat([self._from_wire(b, t).movedim(0, split_axis)
                          for b in out.chunk(self.size, 0)], concat_axis)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(t))

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        dist = self._dist
        flat = self._wire_dtype(t.reshape(-1).contiguous())
        buf = torch.zeros_like(flat)
        ops = []
        for s, d in perm:
            if s == self.rank and d == self.rank:
                buf = flat.clone()
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, flat, d, self.group))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, buf, s, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._from_wire(buf, t).reshape(t.shape)


# ------------------------------------------------------------- meta axis --

class _MetaCollective(torch.autograd.Function):
    """A collective's result as an empty tensor of its shape; its backward
    is the transposed collective (recorded too): the inverse all-to-all, a
    psum of the gradients, the own-input gradient of pmean."""

    @staticmethod
    def forward(ctx, axis, kind, t, shape, back):
        ctx.axis, ctx.back = axis, back
        axis._record(kind, t, shape)
        return t.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        back = ctx.back
        if back is None:
            return None, None, None, None, None
        kind, shape = back
        if kind is not None:
            ctx.axis._record(kind, g, shape)
        return None, None, g.new_empty(shape), None, None


def _record_bytes(recorder, size: int, kind: str, t: torch.Tensor,
                  shape) -> None:
    """XLA's count of a collective: an all-reduce at its payload (t), any
    other kind at its result (`shape`)."""
    if recorder is not None and size > 1:
        n = 1
        for d in (t.shape if kind == "all-reduce" else shape):
            n *= int(d)
        recorder(kind, n * t.element_size())


class MetaAxis:
    """Rank `rank` (default 0) of an axis of `size` ranks whose tensors
    live on the "meta" device: each collective returns an empty tensor of
    the shape `ThreadAxis` returns and adds the bytes it moves to
    `recorder(kind, nbytes)` under XLA's collective names: an all-reduce
    (psum, pmean, pmax) at its payload, an all-gather (all_gather,
    all_gather_dim), all-to-all, collective-permute (ppermute) or
    reduce-scatter (all_gather_dim's backward) at its result, as
    `benchmarks/roofline.py` reads the reference's HLO.  It lets a rank's
    program run with nothing allocated (`launch.dryrun`)."""

    def __init__(self, size: int, recorder=None, rank: int = 0):
        if size < 1:
            raise ValueError(f"axis size must be >= 1, got {size}")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of an axis of {size}")
        self.size, self.recorder, self.rank = size, recorder, rank

    def axis_index(self) -> int:
        return self.rank

    def _record(self, kind: str, t: torch.Tensor, shape) -> None:
        _record_bytes(self.recorder, self.size, kind, t, shape)

    def _apply(self, kind, t, shape, back=None):
        return _MetaCollective.apply(self, kind, t, tuple(shape), back)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._apply("all-reduce", t, t.shape,
                           ("all-reduce", tuple(t.shape)))

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self._apply("all-reduce", t, t.shape, (None, tuple(t.shape)))

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._apply("all-reduce", t.detach(), t.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._apply("all-gather", t.detach(),
                           (self.size, *t.shape))

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim] *= self.size
        return self._apply("all-gather", t, shape,
                           ("reduce-scatter", tuple(t.shape)))

    def all_gather_dims(self, ts, dims) -> list:
        return [self.all_gather_dim(t, d) for t, d in zip(ts, dims)]

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        return self._apply("collective-permute", t.detach(), t.shape)

    def all_to_all(self, t: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        _check_split(t, split_axis, self.size)
        shape = list(t.shape)
        shape[split_axis] //= self.size
        shape[concat_axis] *= self.size
        return self._apply("all-to-all", t, shape,
                           ("all-to-all", tuple(t.shape)))


# -------------------------------------------------------- recorded axis --

class RecordingAxis:
    """An axis whose collectives also add the bytes they move to
    `recorder(kind, nbytes)`, by `MetaAxis`'s rule: what a thread or
    process rank sends, to hold against the dry-run's count of the same
    program on meta.  Forward collectives only (a backward's are not
    seen)."""

    def __init__(self, axis, recorder):
        self.axis, self.recorder = axis, recorder
        self.size, self.rank = axis.size, axis.rank

    def axis_index(self) -> int:
        return self.rank

    def _rec(self, kind, t, shape):
        _record_bytes(self.recorder, self.size, kind, t, shape)

    def psum(self, t):
        self._rec("all-reduce", t, t.shape)
        return self.axis.psum(t)

    def pmean(self, t):
        self._rec("all-reduce", t, t.shape)
        return self.axis.pmean(t)

    def pmax(self, t):
        self._rec("all-reduce", t, t.shape)
        return self.axis.pmax(t)

    def all_gather(self, t):
        self._rec("all-gather", t, (self.size, *t.shape))
        return self.axis.all_gather(t)

    def all_gather_dim(self, t, dim: int):
        shape = list(t.shape)
        shape[dim] *= self.size
        self._rec("all-gather", t, shape)
        return self.axis.all_gather_dim(t, dim)

    def all_gather_dims(self, ts, dims):
        for t, d in zip(ts, dims):
            shape = list(t.shape)
            shape[d] *= self.size
            self._rec("all-gather", t, shape)
        return self.axis.all_gather_dims(ts, dims)

    def ppermute(self, t, perm):
        self._rec("collective-permute", t, t.shape)
        return self.axis.ppermute(t, perm)

    def all_to_all(self, t, split_axis: int, concat_axis: int):
        self._rec("all-to-all", t, t.shape)
        return self.axis.all_to_all(t, split_axis, concat_axis)

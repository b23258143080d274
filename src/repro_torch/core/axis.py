"""Collective axes: the ranks a compressed wire crosses.

The reference runs its collectives inside `shard_map` over a named mesh
axis (`lax.all_gather`, `ppermute`, `pmax`, `psum`).  Here an axis is an
object that each rank's code holds, with the same four collectives:

    axis.size, axis.rank
    axis.all_gather(t)        -> [size, *t.shape], rank order
    axis.ppermute(t, perm)    -> what (src, rank) in perm sends here, else 0
    axis.pmax(t), axis.psum(t)

Two implementations run the same per-rank code:

  * `DistAxis`: over `torch.distributed` (gloo on the CPU, NCCL across
    cards), one process per rank;
  * `ThreadGroup.axis(r)`: p ranks as p threads of one process that
    exchange tensors through a barrier, all on one device and its current
    stream.  It is the counterpart of the reference's multi-device CPU
    mesh, and what lets p ranks share one card (NCCL refuses two ranks on
    one device).  `run_threads(p, fn)` runs fn(axis) once per rank.

Both reduce in rank order (`psum` folds ranks 0, 1, ... left to right;
`pmax` takes the maximum with NaN propagating), so the two agree bit for
bit.
"""
from __future__ import annotations

import threading

import torch


def _fold(vals: list, op) -> torch.Tensor:
    out = vals[0]
    for v in vals[1:]:
        out = op(out, v)
    return out


class _RankOrder:
    """pmax/psum from `_exchange` (every rank's tensor, in rank order)."""

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return _fold(self._exchange(t), torch.maximum)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _fold(self._exchange(t), torch.add)


# ----------------------------------------------------------- thread axis --

class ThreadGroup:
    """p ranks as p threads of one process.  Each collective is one
    exchange: every rank leaves its tensor in its slot, all wait, all read
    the slots, all wait again before the slots are reused."""

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

    def _exchange(self, t: torch.Tensor) -> list:
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        vals = list(g._slots)
        g._barrier.wait()
        return vals

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(t))

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        vals = self._exchange(t)
        src = [s for s, d in perm if d == self.rank]
        return vals[src[0]].clone() if src else torch.zeros_like(t)


def run_threads(size: int, fn) -> list:
    """[fn(axis of rank r) for r in range(size)], each rank in a thread of
    its own.  If a rank raises, the others are released and its exception
    is raised here."""
    group = ThreadGroup(size)
    results, errors = [None] * size, [None] * size

    def work(r):
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
        # bool planes travel as bytes (gloo has no bool)
        return t.to(torch.uint8) if t.dtype == torch.bool else t

    def _exchange(self, t: torch.Tensor) -> list:
        flat = self._wire_dtype(t).reshape(-1).contiguous()
        outs = [torch.empty_like(flat) for _ in range(self.size)]
        self._dist.all_gather(outs, flat, group=self.group)
        return [o.reshape(t.shape).to(t.dtype) for o in outs]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(t))

    def ppermute(self, t: torch.Tensor, perm) -> torch.Tensor:
        dist = self._dist
        flat = self._wire_dtype(t).reshape(-1).contiguous()
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
        return buf.reshape(t.shape).to(t.dtype)

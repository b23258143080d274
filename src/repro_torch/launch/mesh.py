"""The mesh and its logical-axis sharding rules (counterpart of
`repro.launch.mesh`).

Mesh axes of the production meshes:
  single-pod  (16, 16)      ("data", "model")            = 256 chips
  multi-pod   (2, 16, 16)   ("pod", "data", "model")     = 512 chips

Logical axis -> mesh axis (`LOGICAL_RULES`):
  embed -> every data axis (FSDP)   heads/mlp/vocab/experts -> model (TP/EP)
  layers/None -> replicated
A dimension whose size the named axes do not divide stays replicated
(whisper's vocab 51865; head counts below the model axis).

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names, or None; it equals the reference's `PartitionSpec` element for
element.  A `Sharding` pairs a spec with its mesh.

A `Mesh` has axis names and a shape.  `make_production_mesh` gives one as
a description (no devices); `runtime.elastic.make_mesh_for` one over the
devices at hand.  A rank's mesh also carries, for that rank, one
`core.axis` axis per mesh axis (`axes[name]`: its rank along that axis and
the collectives over the ranks that share its other coordinates).  Ranks
as threads of one process (`run_mesh_threads`, over `core.axis.
ThreadGroup`s: NCCL refuses two ranks on one card) and as processes
(`dist_mesh`, over `torch.distributed` subgroups) hold the same code.

`local_view` gives a rank its block of a tensor under a sharding, and
`local_views` of a tree: views, not copies (tensors are mutable: the
views of ranks that share a tensor must be read only; `rank_state`
copies what ranks share, for a state a rank updates in place, and
`assemble` joins the ranks' blocks into the global tree).
`replicated_axes` names the axes a leaf's block is replicated over: the
axes a training rank sums that leaf's gradient over.  `param_blocks`
is a rank's views of a parameter tree under `param_shardings`;
`gather_dim` makes a sharded dimension whole again on a rank's mesh (the
FSDP all-gather over the data axes, or a gather over "model").

Decode caches and batch-like inputs are laid out by the reference
dry-run's greedy rule (`greedy_sharding`, `cache_layouts`): the data axes
on the global batch's dim, "model" on the largest other dim it divides
(a cache's sequence).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import tree as T
from ..core.axis import DistAxis, ThreadAxis, ThreadGroup, run_threads

LOGICAL_RULES = {
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    None: None,
}


class Mesh:
    """`axis_names` with a `shape` (the reference's `mesh.devices.shape`);
    `devices` an object array of that shape (None for a description);
    `axes` {name: core.axis axis} on a rank's own mesh (None otherwise)."""

    def __init__(self, shape, axis_names, *, devices=None, axes=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        if devices is not None:
            devices = np.asarray(devices, dtype=object).reshape(self.shape)
        self.devices = devices
        self.axes = axes

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def axis(self, name: str):
        """This rank's `core.axis` axis along mesh axis `name`."""
        if self.axes is None:
            raise ValueError(f"{self!r} is a description, with no rank's "
                             "axes: run the rank's code on a rank's mesh "
                             "(run_mesh_threads, dist_mesh)")
        return self.axes[name]

    def coords(self) -> dict:
        """This rank's coordinate along each axis (a rank's mesh only)."""
        return {n: self.axis(n).rank for n in self.axis_names}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's NamedSharding); a leaf of a tree
    (not a tuple, which `tree.flatten` would enter)."""
    mesh: Mesh
    spec: tuple


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def data_axes(mesh: Mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _entry(names: tuple):
    """A spec entry over `names`: one name stands alone (as a
    PartitionSpec holds it)."""
    return names[0] if len(names) == 1 else names


def _axis_size(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return sizes[entry]
    return int(np.prod([sizes[a] for a in entry]))


def logical_to_spec(axes: tuple, mesh: Mesh, shape=None) -> tuple:
    """The spec of a leaf with logical `axes`; with its `shape`, an axis
    whose size does not divide the dimension is dropped (replicated)."""
    rules = dict(LOGICAL_RULES)
    rules["embed"] = _entry(data_axes(mesh))
    sizes = mesh.sizes
    spec = []
    for i, a in enumerate(axes):
        r = rules.get(a, None)
        ok = (r is None or shape is None
              or shape[i] % _axis_size(r, sizes) == 0)
        spec.append(r if ok else None)
    return tuple(spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _map_axes(fn, axes_tree, *rest):
    """fn over the axes tuples of a dict tree (and the matching leaves of
    `rest`, trees of the same dicts)."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, axes_tree[k], *(r[k] for r in rest))
                for k in axes_tree}
    if not _is_axes(axes_tree):
        raise TypeError(f"an axes leaf must be a tuple, got {axes_tree!r}")
    return fn(axes_tree, *rest)


def param_shardings(mesh: Mesh, axes_tree, abstract_tree=None):
    """A tree of `Sharding`s from a tree of logical axes tuples (and of the
    leaves' shapes: tensors, e.g. on the meta device)."""
    if abstract_tree is None:
        return _map_axes(lambda ax: Sharding(mesh, logical_to_spec(ax, mesh)),
                         axes_tree)
    return _map_axes(lambda ax, ab: Sharding(
        mesh, logical_to_spec(ax, mesh, tuple(ab.shape))), axes_tree,
        abstract_tree)


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Sharding:
    return Sharding(mesh, (_entry(data_axes(mesh)),) + (None,) * (ndim - 1))


def batch_shardings_for(mesh: Mesh, tree):
    """The batch sharding of every leaf (a tensor) of a tree."""
    leaves, treedef = T.flatten(tree)
    return T.unflatten(treedef, [batch_sharding(mesh, t.ndim)
                                 for t in leaves])


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def cache_shardings(mesh: Mesh, cache_tree):
    """KV caches and recurrent states: dim 1 (the batch of a layer-stacked
    leaf) over the data axes for leaves of 2 or more dims, else
    replicated (the reference's rule)."""
    dp = _entry(data_axes(mesh))

    def spec_for(leaf):
        if leaf.ndim >= 2:
            return Sharding(mesh, (None, dp) + (None,) * (leaf.ndim - 2))
        return Sharding(mesh, ())

    leaves, treedef = T.flatten(cache_tree)
    return T.unflatten(treedef, [spec_for(t) for t in leaves])


# ---------------------------------------------------------- local views --

def _block(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """(index, count) of a rank's block along a dim sharded over `entry`:
    the axes in order, the first the most significant."""
    if entry is None:
        return 0, 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    index = 0
    for n in names:
        index = index * sizes[n] + coords[n]
    return index, _axis_size(entry, sizes)


def local_view(t: torch.Tensor, sharding: Sharding, coords: dict):
    """The block of `t` that the rank at `coords` ({axis name: index})
    holds under `sharding`: a view of t (narrow per sharded dim)."""
    sizes = sharding.mesh.sizes
    for dim, entry in enumerate(sharding.spec):
        index, count = _block(entry, sizes, coords)
        if count == 1:
            continue
        if t.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {entry} ({count})")
        n = t.shape[dim] // count
        t = t.narrow(dim, index * n, n)
    return t


def local_views(tree, shardings, coords: dict):
    """`local_view` over a tree of tensors and a tree of `Sharding`s of the
    same structure."""
    leaves, treedef = T.flatten(tree)
    shards, _ = T.flatten(shardings)
    if len(shards) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves and {len(shards)} shardings")
    return T.unflatten(treedef, [local_view(t, s, coords)
                                 for t, s in zip(leaves, shards)])


def mesh_coords(mesh: Mesh) -> list:
    """Every rank's coordinates, in row-major order over the mesh."""
    return [dict(zip(mesh.axis_names, c))
            for c in itertools.product(*(range(n) for n in mesh.shape))]


def param_blocks(params, mesh: Mesh, axes_tree, coords=None):
    """The rank's views of `params` (global tensors, e.g. on the meta
    device) under `param_shardings(mesh, axes_tree, params)`: FSDP's
    "embed" blocks over the data axes, heads / mlp / vocab / experts over
    "model".  A dim its axes do not divide stays whole
    (`logical_to_spec`'s rule, held here: every block is that of the
    spec).  `coords` default to those of the rank's mesh."""
    shard = param_shardings(mesh, axes_tree, params)
    coords = mesh.coords() if coords is None else coords
    views = local_views(params, shard, coords)
    for t, v, s in zip(T.leaves(params), T.leaves(views), T.leaves(shard)):
        if tuple(v.shape) != block_shape(t.shape, s):
            raise AssertionError(f"a block {tuple(v.shape)} of "
                                 f"{tuple(t.shape)} under {s.spec}")
    return views


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def gather_dim(t: torch.Tensor, entry, mesh: Mesh, dim: int) -> torch.Tensor:
    """`t`, the rank's block of a dim sharded over `entry` (a spec entry),
    made whole again on the rank's mesh: an all-gather along `dim` over
    each of the entry's axes, the last (least significant in `_block`'s
    order) first, so the blocks join in the global order.  An axis the
    mesh lacks has size 1."""
    return gather_dims([t], entry, mesh, [dim])[0]


def gather_dims(ts: list, entry, mesh: Mesh, dims: list) -> list:
    """`gather_dim` of several tensors sharded over the same `entry`, one
    collective per axis for them all (`all_gather_dims`)."""
    ts = list(ts)
    for name in reversed(_names(entry)):
        if name not in mesh.axis_names:
            continue
        ax = mesh.axis(name)
        if ax.size > 1:
            ts = ax.all_gather_dims(ts, dims)
    return ts


def block_shape(shape, s: Sharding) -> tuple:
    """A rank's block of a leaf of `shape` under `s` (the reference's
    `NamedSharding.shard_shape`)."""
    sizes = s.mesh.sizes
    out = list(shape)
    for i, e in enumerate(s.spec):
        n = _axis_size(e, sizes)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {e}")
        out[i] //= n
    return tuple(out)


def replicated_axes(s: Sharding) -> tuple:
    """The mesh axes that `s`'s spec does not split, in mesh order: every
    rank along them holds the same block of the leaf.  An axis that
    `logical_to_spec` dropped because it does not divide its dim is one
    of them."""
    used = {a for e in s.spec for a in _names(e)}
    return tuple(a for a in s.mesh.axis_names if a not in used)


def assemble(blocks: list, shardings, coords: list):
    """The global tree from the ranks' trees of blocks (`blocks[i]` the
    rank at `coords[i]`'s, under the tree of `Sharding`s `shardings`):
    the inverse of `local_views`.  A block that ranks share is taken from
    the last of them that holds it."""
    shards, tdef = T.flatten(shardings)
    firsts = T.leaves(blocks[0])
    outs = []
    for t, s in zip(firsts, shards):
        shape = [n * _axis_size(e, s.mesh.sizes) for n, e in
                 zip(t.shape, tuple(s.spec) + (None,) * t.dim())]
        outs.append(t.new_empty(shape))
    for tree, c in zip(blocks, coords):
        for out, t, s in zip(outs, T.leaves(tree), shards):
            local_view(out, s, c).copy_(t)
    return T.unflatten(tdef, outs)


def rank_state(tree, shardings, coords: dict):
    """A thread rank's own blocks of `tree` (params, optimizer state)
    under `shardings`, to update in place: a view of the global tensor
    where the block is the rank's alone, a copy where other ranks of the
    mesh hold the same block (a leaf replicated over an axis of more than
    one rank), so that no two ranks write one tensor."""
    leaves, tdef = T.flatten(tree)
    out = []
    for t, s in zip(leaves, T.leaves(shardings)):
        v = local_view(t, s, coords)
        shared = any(s.mesh.sizes[a] > 1 for a in replicated_axes(s))
        out.append(v.clone() if shared else v)
    return T.unflatten(tdef, out)


def drop_axis(mesh: Mesh, name: str) -> Mesh:
    """`mesh` without the axis `name` (a rank's mesh keeps its other
    axes): e.g. a pod's ("data", "model") mesh inside ("pod", "data",
    "model").  A mesh without it is returned as it is."""
    if name not in mesh.axis_names:
        return mesh
    keep = [i for i, n in enumerate(mesh.axis_names) if n != name]
    axes = None if mesh.axes is None else {
        n: a for n, a in mesh.axes.items() if n != name}
    return Mesh([mesh.shape[i] for i in keep],
                [mesh.axis_names[i] for i in keep], axes=axes)


def on_threads(mesh) -> bool:
    """Whether a rank's mesh holds thread ranks (`run_mesh_threads`)."""
    return mesh is not None and mesh.axes is not None and any(
        isinstance(a, ThreadAxis) for a in mesh.axes.values())


def gather_objects(mesh: Mesh, names, obj) -> list:
    """Every thread rank's `obj` over the mesh axes `names`, the same list
    on each, in row-major order of those axes (the ranks' coordinates
    along the others are the caller's)."""
    out = [obj]
    for name in reversed(tuple(names)):
        ax = mesh.axis(name)
        if ax.size > 1:
            out = [o for part in ax.all_gather_object(out) for o in part]
    return out


def greedy_sharding(mesh: Mesh, shape, skip_dims=(), batch_size=None):
    """The reference dry-run's `_greedy_sharding` of a leaf of `shape`:
    the data axes go only to a dim that equals the global batch (with
    `batch_size`; else the first dim they divide), "model" to the largest
    remaining divisible dim (the first of equals), never a dim in
    skip_dims."""
    dims = list(shape)
    spec = [None] * len(dims)
    axes = mesh.sizes
    dp = [a for a in ("pod", "data") if a in axes]
    dp_size = int(np.prod([axes[a] for a in dp])) if dp else 1
    for i, d in enumerate(dims):
        if i in skip_dims:
            continue
        if batch_size is not None and d != batch_size:
            continue
        if dp and d % dp_size == 0 and d >= dp_size:
            spec[i] = tuple(dp) if len(dp) > 1 else dp[0]
            break
    if "model" in axes:
        msize = axes["model"]
        best = None
        for i, d in enumerate(dims):
            if (spec[i] is None and i not in skip_dims and d % msize == 0
                    and d >= msize):
                if best is None or d > dims[best]:
                    best = i
        if best is not None:
            spec[best] = "model"
    return Sharding(mesh, tuple(spec))


def cache_layouts(mesh: Mesh, tree, global_batch: int):
    """The reference's decode cache shardings: greedy over every dim but
    the layer stack's, the data axes on the global batch's dim."""
    leaves, treedef = T.flatten(tree)
    return T.unflatten(treedef, [greedy_sharding(
        mesh, t.shape, skip_dims=(0,), batch_size=global_batch)
        for t in leaves])


# ---------------------------------------------------------- rank meshes --

def run_mesh_threads(shape, axis_names, fn) -> list:
    """fn(mesh of rank r) for every rank of a mesh of `shape`, each rank a
    thread of this process (row-major rank order): each mesh axis of a
    rank is a `ThreadGroup` axis over the ranks that share its other
    coordinates.  Returns the results in rank order; a rank that raises
    breaks every axis's barrier, so the others stop too."""
    desc = Mesh(shape, axis_names)
    coords = mesh_coords(desc)
    groups = {}
    for c in coords:
        for name in desc.axis_names:
            key = (name,) + tuple(c[n] for n in desc.axis_names if n != name)
            groups.setdefault(key, ThreadGroup(desc.sizes[name]))

    def rank_mesh(r):
        c = coords[r]
        axes = {name: groups[(name,) + tuple(
            c[n] for n in desc.axis_names if n != name)].axis(c[name])
            for name in desc.axis_names}
        return Mesh(shape, axis_names, axes=axes)

    def rank(ax):
        try:
            return fn(rank_mesh(ax.rank))
        except BaseException:
            for g in groups.values():     # release the ranks that wait
                g.abort()
            raise

    return run_threads(desc.size, rank)


def dist_mesh(shape, axis_names) -> Mesh:
    """This process's mesh over the default `torch.distributed` group (its
    size the mesh's, ranks in row-major order): one subgroup per line of
    each axis.  Every process calls it with the same arguments."""
    import torch.distributed as dist
    desc = Mesh(shape, axis_names)
    if dist.get_world_size() != desc.size:
        raise ValueError(f"a mesh of {desc.size} ranks over a world of "
                         f"{dist.get_world_size()}")
    coords = mesh_coords(desc)
    axes = {}
    for name in desc.axis_names:
        lines = {}
        for r, c in enumerate(coords):
            key = tuple(c[n] for n in desc.axis_names if n != name)
            lines.setdefault(key, []).append(r)
        for key, ranks in sorted(lines.items()):
            group = dist.new_group(ranks)     # every process, every group
            if dist.get_rank() in ranks:
                axes[name] = DistAxis(group)
    return Mesh(shape, axis_names, axes=axes)

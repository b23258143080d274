"""Elastic scaling: rebuild the mesh at a new size and re-shard the state
(counterpart of `repro.runtime.elastic`).

Shardings are pure functions of (logical axes, mesh) (`launch.mesh`'s
rules) and checkpoints store plain host arrays, so any checkpoint restores
onto any mesh whose axes divide the dimensions: after losing a card or
gaining one, checkpoint -> `resize` -> continue.  The data pipeline is a
pure function of the step, so no iterator needs repair.

A re-sharded state is one tree per device of the mesh, in the mesh's
row-major order: each device's block of every leaf (`launch.mesh.
local_view`), on that device.
"""
from __future__ import annotations

import torch

from .. import tree as T
from ..launch import mesh as M


def make_mesh_for(devices=None, model_parallel: int | None = None) -> M.Mesh:
    """The largest (data, model) mesh over `devices` (default: every card
    of this process): model = `model_parallel` (default min(16, n)),
    lowered until it divides the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (e.g. "
                               "[torch.device('cpu')])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    mp = model_parallel or min(16, n)
    while n % mp:
        mp -= 1
    return M.Mesh((n // mp, mp), ("data", "model"), devices=devices)


def reshard_state(state, axes_tree_fn, mesh: M.Mesh) -> list:
    """Place a restored state on `mesh` under rule-derived shardings:
    `axes_tree_fn(mesh)` gives a tree of `launch.mesh.Sharding`s like the
    state's; returns [each device's tree of blocks, on its device], in
    the mesh's row-major order (a block already on its device is a
    view)."""
    shardings = axes_tree_fn(mesh)
    out = []
    for coords, dev in zip(M.mesh_coords(mesh), mesh.devices.flat):
        local = M.local_views(state, shardings, coords)
        out.append(T.tree_map(lambda t, d=dev: t.to(d), local))
    return out


def resize(ckpt_manager, template, axes_tree_fn, model_parallel=None,
           devices=None):
    """checkpoint -> a mesh from the devices at hand -> restore and
    re-shard.  Returns (per-device states, step, mesh)."""
    mesh = make_mesh_for(devices, model_parallel)
    state, step = ckpt_manager.restore(template, device=mesh.devices.flat[0])
    if state is None:
        raise RuntimeError("no checkpoint to resize from")
    return reshard_state(state, axes_tree_fn, mesh), step, mesh

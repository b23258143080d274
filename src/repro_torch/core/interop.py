"""Carry a wire, or a quantized KV cache, across the two packages.

The system has no weights: its state is the wire and the cache.  A
reference `Encoded` (any object with its fields, as numpy or JAX arrays)
converts to the port's `Encoded` on a device, and back to numpy planes with
the reference's dtypes, so a wire encoded by either package decodes in the
other; a selector's `SelectedWire` crosses the same way.  Word planes
travel as uint32 in numpy and as int32 tensors (the same bits) in the
port.  A `QuantizedKV` crosses the same way, so that a cache quantized by
either package feeds both attentions, and so does the packed KV wire
`PackedKV`, whose page chain is rebuilt from its stages' specs (or its
selector's set name).
"""
from __future__ import annotations

import numpy as np
import torch

from ..compression.kv import PackedKV, QuantizedKV, _page_stages
from .pipeline import Encoded, resolve_device
from .select import SelectedWire, get_kv_selector

# fields that hold uint32 bit planes on the reference side
_U32_FIELDS = ("payload", "out_payload", "sign_words", "checksum", "header",
               "headers")


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr)).to(dev)      # a writable copy


def _wire_from_numpy(cls, wire, device):
    dev = resolve_device(device)
    fields = {}
    for name in cls._fields:
        v = getattr(wire, name, None)
        if v is None:
            fields[name] = None
        elif name == "headers":
            fields[name] = tuple(_to_tensor(h, dev) for h in v)
        else:
            fields[name] = _to_tensor(v, dev)
    return cls(**fields)


def encoded_from_numpy(wire, device="cuda") -> Encoded:
    """Reference wire (numpy or JAX planes) -> the port's Encoded on
    `device`."""
    return _wire_from_numpy(Encoded, wire, device)


def selected_wire_from_numpy(wire, device="cuda") -> SelectedWire:
    """Reference `SelectedWire` (numpy or JAX planes) -> the port's on
    `device`."""
    return _wire_from_numpy(SelectedWire, wire, device)


def _to_numpy(t: torch.Tensor, u32: bool) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    return arr.view(np.uint32) if u32 else arr


def _wire_to_numpy(enc):
    fields = {}
    for name in enc._fields:
        v = getattr(enc, name)
        if v is None:
            fields[name] = None
        elif name == "headers":
            fields[name] = tuple(_to_numpy(h, True) for h in v)
        else:
            fields[name] = _to_numpy(v, name in _U32_FIELDS)
    return type(enc)(**fields)


def encoded_to_numpy(enc: Encoded) -> Encoded:
    """The port's Encoded -> an Encoded of numpy planes with the
    reference's dtypes (uint32 word planes), ready for
    `repro.core.pipeline.Encoded(*map(jnp.asarray, ...))`."""
    return _wire_to_numpy(enc)


def selected_wire_to_numpy(wire: SelectedWire) -> SelectedWire:
    """The port's SelectedWire -> one of numpy planes with the reference's
    dtypes, ready for `repro.core.select.SelectedWire(*map(jnp.asarray,
    ...))`."""
    return _wire_to_numpy(wire)


def quantized_kv_from_numpy(qkv, device="cuda") -> QuantizedKV:
    """Reference QuantizedKV (numpy or JAX planes) -> the port's on
    `device`; the planes keep their dtypes (int8, float32, int32, bool)."""
    dev = resolve_device(device)
    return QuantizedKV(*(_to_tensor(getattr(qkv, f), dev)
                         for f in QuantizedKV._fields))


def quantized_kv_to_numpy(qkv: QuantizedKV) -> QuantizedKV:
    """The port's QuantizedKV -> a QuantizedKV of numpy planes, ready for
    `repro.compression.kv.QuantizedKV(*map(jnp.asarray, ...))`."""
    return QuantizedKV(*(_to_numpy(t, False) for t in qkv))


def packed_kv_from_numpy(wire, device="cuda") -> PackedKV:
    """Reference `PackedKV` (numpy or JAX planes) -> the port's on
    `device`.  The page chain is rebuilt from the reference's stage
    objects' specs, or from its selector's set name."""
    dev = resolve_device(device)
    planes = {}
    for name in PackedKV._fields:
        v = getattr(wire, name, None)
        if v is None:
            planes[name] = None
        elif name == "headers":
            planes[name] = tuple(_to_tensor(h, dev) for h in v)
        else:
            planes[name] = _to_tensor(v, dev)
    if getattr(wire, "select", None) is not None:
        return PackedKV(**planes, select=get_kv_selector(wire.select.name))
    spec = "|".join(st.spec() for st in (*wire.pred, *wire.stages))
    pred, stages = _page_stages(spec)
    return PackedKV(**planes, stages=stages, pred=pred)


def packed_kv_to_numpy(p: PackedKV) -> PackedKV:
    """The port's PackedKV -> one of numpy planes with the reference's
    dtypes (uint32 word planes and checksum), the statics kept."""
    planes = {}
    for name, v in zip(p._fields, p):
        if v is None:
            planes[name] = None
        elif name == "headers":
            planes[name] = tuple(_to_numpy(h, True) for h in v)
        else:
            planes[name] = _to_numpy(v, name in _U32_FIELDS)
    return PackedKV(**planes, stages=p.stages, pred=p.pred, select=p.select)

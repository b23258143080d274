"""Carry a wire, or a quantized KV cache, across the two packages.

The system has no weights: its state is the wire and the cache.  A
reference `Encoded` (any object with its fields, as numpy or JAX arrays)
converts to the port's `Encoded` on a device, and back to numpy planes with
the reference's dtypes, so a wire encoded by either package decodes in the
other.  Word planes travel as uint32 in numpy and as int32 tensors (the
same bits) in the port.  A `QuantizedKV` crosses the same way, so that a
cache quantized by either package feeds both attentions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compression.kv import QuantizedKV
from .pipeline import Encoded, resolve_device

# fields that hold uint32 bit planes on the reference side
_U32_FIELDS = ("payload", "out_payload", "sign_words", "checksum")


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr)).to(dev)      # a writable copy


def encoded_from_numpy(wire, device="cuda") -> Encoded:
    """Reference wire (numpy or JAX planes) -> the port's Encoded on
    `device`."""
    dev = resolve_device(device)
    fields = {}
    for name in Encoded._fields:
        v = getattr(wire, name, None)
        if v is None:
            fields[name] = None
        elif name == "headers":
            fields[name] = tuple(_to_tensor(h, dev) for h in v)
        else:
            fields[name] = _to_tensor(v, dev)
    return Encoded(**fields)


def _to_numpy(t: torch.Tensor, u32: bool) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    return arr.view(np.uint32) if u32 else arr


def encoded_to_numpy(enc: Encoded) -> Encoded:
    """The port's Encoded -> an Encoded of numpy planes with the
    reference's dtypes (uint32 word planes), ready for
    `repro.core.pipeline.Encoded(*map(jnp.asarray, ...))`."""
    fields = {}
    for name in Encoded._fields:
        v = getattr(enc, name)
        if v is None:
            fields[name] = None
        elif name == "headers":
            fields[name] = tuple(_to_numpy(h, True) for h in v)
        else:
            fields[name] = _to_numpy(v, name in _U32_FIELDS)
    return Encoded(**fields)


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

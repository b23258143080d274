"""Fault-injection harness for the guarantee-audit plane, in torch.

Counterpart of `repro.runtime.guard`.  The audit plane (`core.audit`)
makes two promises: the carried checksum catches silent wire corruption,
and `verify=` catches bound and non-finite violations.  This module is the
deterministic corruption side of that contract:

    plan = FaultPlan("gradsmooth", "payload_bitflip")
    bad  = plan.corrupt_wire(wire)          # wire from encode(integrity=True)
    assert not bool(audit.verify_wire(bad))

Fault classes (`FAULT_CLASSES`):

  payload_bitflip  flip one bit of one transmitted payload word
  header_bitflip   flip one bit of a header plane (the outlier count on
                   header-free chains)
  length_truncate  halve the transmitted `payload_len` and zero the tail
  chainid_swap     rotate the chain id to another valid id (selector
                   wires, `core.select.SelectedWire`, only)
  nan_input        plant NaN/+-Inf in the input before encode, caught by
                   the `verify=` report (`n_nonfinite > 0`)
  hop_bitflip      flip one bit of an in-flight wire (`corrupt_hop`, the
                   `core.transport.Transport(fault=...)` hook: a ring hop,
                   or the largest plane of a gathered wire)

Every plan seeds `np.random.default_rng` from `zlib.crc32` of its suite
and class, as the reference does, so fault positions equal the
reference's.  Corruption runs on host copies of the planes; the original
wire is never mutated, and the corrupted planes go back to the wire's
device.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..core import audit

FAULT_CLASSES = ("payload_bitflip", "header_bitflip", "length_truncate",
                 "chainid_swap", "nan_input", "hop_bitflip")


def _host(t) -> np.ndarray:
    """A writable host copy of a plane."""
    if torch.is_tensor(t):
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def _swap_leaf(wire, old_leaf, new_arr):
    """`wire` (a NamedTuple) with the plane `old_leaf` (matched by
    identity, at top level or inside a tuple field) replaced by new_arr on
    old_leaf's device and dtype."""
    new = torch.from_numpy(np.ascontiguousarray(new_arr)).to(
        device=old_leaf.device, dtype=old_leaf.dtype)
    hits, fields = 0, {}
    for name, v in zip(wire._fields, wire):
        if v is old_leaf:
            fields[name], hits = new, hits + 1
        elif isinstance(v, tuple) and any(h is old_leaf for h in v):
            fields[name] = tuple(new if h is old_leaf else h for h in v)
            hits += sum(h is old_leaf for h in v)
    if hits != 1:
        raise ValueError(f"leaf identity match found {hits} leaves")
    return wire._replace(**fields)


def applicable_classes(wire) -> tuple:
    """The wire-corruption classes that apply to this wire.  `chainid_swap`
    needs a transmitted chain id; `nan_input` and `hop_bitflip` are not
    stored-wire faults (`corrupt_input`, `corrupt_hop`)."""
    out = ["payload_bitflip", "header_bitflip", "length_truncate"]
    if getattr(wire, "chain_id", None) is not None:
        out.append("chainid_swap")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic corruption: (suite, fault class) -> positions.
    `n_chains` bounds `chainid_swap` so the swapped id stays a valid
    dispatch target."""
    suite: str
    cls: str
    n_chains: int = 2

    def __post_init__(self):
        if self.cls not in FAULT_CLASSES:
            raise ValueError(f"unknown fault class {self.cls!r}; have "
                             f"{FAULT_CLASSES}")

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(
            zlib.crc32(f"fault:{self.suite}:{self.cls}".encode()))

    def _require(self, *classes):
        if self.cls not in classes:
            raise ValueError(f"{self.cls} is not one of {classes}")

    # --- input faults -----------------------------------------------------

    def corrupt_input(self, x) -> torch.Tensor:
        """`nan_input`: plant NaN/+-Inf in the pre-encode input (a float32
        copy on x's device; the CPU for a numpy x)."""
        self._require("nan_input")
        dev = x.device if torch.is_tensor(x) else torch.device("cpu")
        a = _host(x).astype(np.float32)
        r = self.rng()
        idx = r.choice(a.size, size=min(3, a.size), replace=False)
        vals = [np.nan, np.inf, -np.inf]
        for i, j in enumerate(idx):
            a.flat[j] = vals[i % 3]
        return torch.from_numpy(a).to(dev)

    # --- in-flight faults -------------------------------------------------

    def corrupt_hop(self, hop):
        """`hop_bitflip`: flip one deterministic bit in the largest int32
        plane (uint32 bits) of more than one element of `hop` (a tensor, or
        a tuple/NamedTuple of them, nested tuples included), so a per-hop
        digest must catch it."""
        self._require("hop_bitflip")
        leaves = []

        def walk(node, path):
            if torch.is_tensor(node):
                leaves.append((path, node))
            elif isinstance(node, tuple) or hasattr(node, "map_planes"):
                for i, v in enumerate(node):
                    walk(v, path + (i,))

        walk(hop, ())
        targets = [(int(t.numel()), i) for i, (_, t) in enumerate(leaves)
                   if t.dtype == torch.int32 and t.numel() > 1]
        if not targets:
            return hop
        _, k = max(targets)
        path, leaf = leaves[k]
        r = self.rng()
        flat = _host(leaf).reshape(-1).view(np.uint32)
        word = int(r.integers(0, flat.size))
        flat[word] ^= np.uint32(1) << np.uint32(int(r.integers(0, 32)))
        new = torch.from_numpy(flat.view(np.int32).reshape(
            tuple(leaf.shape))).to(leaf.device)

        def rebuild(node, path):
            if not path:
                return new
            items = list(node)
            items[path[0]] = rebuild(items[path[0]], path[1:])
            if hasattr(node, "_fields"):      # NamedTuples and PackedKV
                return node._replace(
                    **{node._fields[path[0]]: items[path[0]]})
            return tuple(items)

        return rebuild(hop, path)

    # --- wire faults ------------------------------------------------------

    def corrupt_wire(self, wire):
        """Apply this plan's wire fault to a copy of `wire`."""
        if self.cls in ("nan_input", "hop_bitflip"):
            raise ValueError(f"{self.cls} is not a stored-wire fault "
                             "(corrupt_input / corrupt_hop)")
        if self.cls not in applicable_classes(wire):
            raise ValueError(f"{self.cls} not applicable to "
                             f"{type(wire).__name__}")
        return getattr(self, f"_{self.cls}")(wire)

    def _payload_bitflip(self, wire):
        r = self.rng()
        pay = _host(wire.payload)
        plen = _host(wire.payload_len).reshape(-1)
        rows = pay.reshape(-1, pay.shape[-1]).view(np.uint32)
        row = int(r.integers(0, rows.shape[0]))
        limit = int(plen[row]) if plen.size == rows.shape[0] else int(plen[0])
        col = int(r.integers(0, max(limit, 1)))
        rows[row, col] ^= np.uint32(1) << np.uint32(r.integers(0, 32))
        return _swap_leaf(wire, wire.payload, pay)

    def _header_plane(self, wire):
        """First non-empty header plane (a selector wire's flat `header`),
        else the outlier count (`eb2` on a `PackedKV`)."""
        planes = getattr(wire, "headers", None)
        if planes is None:
            h = getattr(wire, "header", None)
            planes = () if h is None else (h,)
        for p in planes:
            if p is not None and p.numel():
                return p
        fallback = getattr(wire, "n_outliers", None)
        return wire.eb2 if fallback is None else fallback

    def _header_bitflip(self, wire):
        r = self.rng()
        leaf = self._header_plane(wire)
        a = _host(leaf)
        view = a.reshape(a.size).view(np.uint8)   # reshape: 0-d planes too
        byte = int(r.integers(0, view.size))
        view[byte] ^= np.uint8(1) << np.uint8(r.integers(0, 8))
        return _swap_leaf(wire, leaf, a)

    def _length_truncate(self, wire):
        pay = _host(wire.payload)
        plen = _host(wire.payload_len)
        new = plen // 2
        rows = pay.reshape(-1, pay.shape[-1])
        lens = (new.reshape(-1) if new.size == rows.shape[0]
                else np.full(rows.shape[0], int(new.reshape(-1)[0])))
        mask = np.arange(rows.shape[-1])[None, :] < lens[:, None]
        rows *= mask.astype(rows.dtype)
        out = _swap_leaf(wire, wire.payload, pay)
        return _swap_leaf(out, out.payload_len, new)

    def _chainid_swap(self, wire):
        cid = _host(wire.chain_id)
        n = max(int(self.n_chains), 2)
        cid = ((cid.astype(np.int64) + 1) % n).astype(cid.dtype)
        return _swap_leaf(wire, wire.chain_id, cid)


def detection_matrix(wire, *, suite: str = "smoke", n_chains: int = 2,
                     report=None) -> dict:
    """Run every applicable wire fault against `wire` (which must carry a
    checksum) and return {fault class: detected?}: detected when
    `verify_wire` of the corrupted wire is False.  With an `AuditReport` of
    a nan-corrupted encode, the `nan_input` row is judged from it
    (`n_nonfinite > 0`)."""
    if not audit.has_checksum(wire):
        raise ValueError("detection_matrix needs encode(integrity=True) "
                         "wires — no checksum carried")
    if not bool(audit.verify_wire(wire)):
        raise audit.WireIntegrityError("clean wire failed its checksum")
    out = {}
    for cls in applicable_classes(wire):
        bad = FaultPlan(suite, cls, n_chains=n_chains).corrupt_wire(wire)
        out[cls] = not bool(audit.verify_wire(bad))
    if report is not None:
        out["nan_input"] = int(report.n_nonfinite) > 0
    return out

"""The guarantee-audit plane, in torch: bound reports, wire-integrity
checksums and degradation policies.

Counterpart of `repro.core.audit`:

  * `audit_report` checks `|x - x̂| <= eb` over the planes the encoder
    already computed (no second decode); `Pipeline.encode(verify=True)`
    returns it.
  * `wire_checksum` / `attach_checksum` / `verify_wire` cover the
    transmitted planes of a wire with a position-mixed 32-bit fold.  The
    checksum rides as an extra field (`integrity=True` at encode), so
    checksum-free wires stay bit-identical.
  * `DEGRADATION_POLICIES` names what a failed check routes to: `raise`,
    `drop`, `rerequest`.

The fold mixes each word with its position ((i+1) * 0x9E3779B9), avalanches
the pair (murmur3 fmix32) and xor-reduces; planes combine by
rotate-and-xor.  Word planes are int32 holding uint32 bits; the fold runs
in int64 holding uint32 values, each 32x32-bit multiply split in two
halves so that no product leaves int64's range, and the xor reduction is
a halving tree (torch has no xor reduction).  Every digest is an int32 0-d
tensor holding the uint32 bits, computed on the wire's device.

Dispatch over wire types is duck-typed, so this module imports none of the
container modules: `Encoded` (`core.pipeline`), `SelectedWire`
(`core.select`) and `PackedKV` (`compression.kv`) are covered.
`verify_gathered` gives per-shard verdicts over a wire gathered by
`core.transport.Transport.all_gather`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .codec import to_i32

_MIX = 0x9E3779B9  # golden-ratio odd constant: position-dependent mixing
_U32 = 0xFFFFFFFF


class WireIntegrityError(ValueError):
    """A transmitted wire failed a structural or checksum audit."""


# ------------------------------------------------------------ checksum ----

def _as_u32_words(a) -> torch.Tensor:
    """Any wire plane as a flat int64 stream of uint32 values: 32-bit
    planes bit for bit, floats bit-cast from float32, bool and narrow ints
    widened to int32 first."""
    a = torch.as_tensor(a)
    if a.dtype == torch.bool:
        a = a.to(torch.int32)
    elif a.dtype.is_floating_point:
        a = a.to(torch.float32).view(torch.int32)
    elif a.dtype != torch.int32:
        a = a.to(torch.int32)
    return a.reshape(-1).to(torch.int64) & _U32


def _mul32(m: torch.Tensor, c: int) -> torch.Tensor:
    """(m * c) mod 2^32 for m in [0, 2^32): two 16-bit halves of c."""
    lo = m * (c & 0xFFFF)
    hi = ((m * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _xor_reduce(m: torch.Tensor) -> torch.Tensor:
    """xor of all elements of a 1-d tensor (0 for none), as a 0-d tensor:
    a halving tree on the device."""
    if m.numel() == 0:
        return torch.zeros((), dtype=m.dtype, device=m.device)
    while m.numel() > 1:
        if m.numel() % 2:
            m = torch.cat([m, m.new_zeros(1)])
        half = m.numel() // 2
        m = m[:half] ^ m[half:]
    return m.reshape(())


def _fold(a) -> torch.Tensor:
    """The fold of one plane: a 0-d int64 holding the uint32 digest."""
    u = _as_u32_words(a)
    pos = _mul32(torch.arange(1, u.numel() + 1, dtype=torch.int64,
                              device=u.device), _MIX)
    # avalanche each (word, position) pair before the xor reduction, so the
    # same change at an even number of positions does not cancel
    m = u ^ pos
    m = _mul32(m, 0x85EBCA6B)
    m = m ^ (m >> 13)
    m = _mul32(m, 0xC2B2AE35)
    m = m ^ (m >> 16)
    return _xor_reduce(m)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _U32


def plane_checksum(plane) -> torch.Tensor:
    """The fold over one plane (an int32 0-d digest holding uint32 bits):
    the building block `wire_checksum` combines per container, and the
    per-hop digest of `core.transport`'s packed-domain ring."""
    return to_i32(_fold(plane))


def _planes(wire) -> list:
    """The covered planes of a wire container, in a fixed order (the
    reference's).  Duck-typed: `eb2` -> PackedKV, `chain_id` ->
    `core.select.SelectedWire`, `headers` -> `core.pipeline.Encoded`."""
    if hasattr(wire, "eb2"):                              # compression.kv.PackedKV
        planes = [wire.payload, wire.payload_len, *wire.headers, wire.eb2,
                  wire.out_idx, wire.out_val, wire.overflow]
        if wire.chain_id is not None:
            planes.append(wire.chain_id)
        return planes
    if hasattr(wire, "chain_id"):                         # core.select.SelectedWire
        planes = [wire.chain_id, wire.payload, wire.payload_len,
                  wire.header, wire.out_idx, wire.out_payload,
                  wire.n_outliers, wire.overflow]
    elif hasattr(wire, "headers"):                        # core.pipeline.Encoded
        planes = [wire.payload, wire.payload_len, *wire.headers,
                  wire.out_idx, wire.out_payload, wire.n_outliers,
                  wire.overflow]
    else:
        raise TypeError(f"not an audited wire container: {type(wire)!r}")
    if wire.sign_words is not None:
        planes.append(wire.sign_words)
    if wire.eb is not None:
        planes.append(wire.eb)
    return planes


def wire_checksum(wire) -> torch.Tensor:
    """Position-mixed 32-bit fold over a wire's transmitted planes
    (excluding any carried checksum), an int32 0-d tensor on the wire's
    device."""
    planes = _planes(wire)
    cs = torch.zeros((), dtype=torch.int64, device=planes[0].device)
    for p in planes:
        cs = _rotl(cs, 5) ^ _fold(p)
    return to_i32(cs)


def has_checksum(wire) -> bool:
    return getattr(wire, "checksum", None) is not None


def attach_checksum(wire):
    """The same wire with its checksum computed and carried.  The covered
    planes are untouched."""
    return wire._replace(checksum=wire_checksum(wire))


def verify_wire(wire) -> torch.Tensor:
    """Recompute the checksum and compare it to the carried one: a 0-d bool
    tensor.  Raises if the wire carries none."""
    if not has_checksum(wire):
        raise ValueError("wire carries no checksum — encode it with "
                         "integrity=True")
    return wire_checksum(wire) == wire.checksum.to(torch.int32)


def shard_of(wire, i: int):
    """Shard i of a wire with a gathered leading axis: every plane indexed
    at i (header tuples plane by plane, None kept)."""
    if hasattr(wire, "map_planes"):                       # PackedKV
        return wire.map_planes(lambda t: t[i])

    def take(f):
        if f is None:
            return None
        if isinstance(f, tuple):
            return tuple(h[i] for h in f)
        return f[i]
    return type(wire)(*(take(f) for f in wire))


def verify_gathered(wire) -> torch.Tensor:
    """Per-shard verdicts for a wire with a gathered leading axis (the
    result of `Transport.all_gather`): bool[axis size] on the wire's
    device."""
    p = wire.payload.shape[0]
    return torch.stack([verify_wire(shard_of(wire, i)) for i in range(p)])


# ----------------------------------------------------- length validation --

def check_payload_len(payload_len, capacity: int, *, what: str = "wire"):
    """A transmitted `payload_len` past the padded plane's capacity raises a
    structured error instead of indexing garbage.  Reading a device tensor
    here costs one small host copy; a tensor on the meta device
    (`launch.dryrun`) holds no length to read, and passes."""
    if torch.is_tensor(payload_len) and payload_len.device.type == "meta":
        return
    lens = (payload_len.detach().cpu().numpy() if torch.is_tensor(payload_len)
            else np.asarray(payload_len))
    if lens.size and ((lens < 0).any() or (lens > capacity).any()):
        bad = lens.reshape(-1)
        raise WireIntegrityError(
            f"{what}: transmitted payload_len {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''} outside [0, {capacity}] — "
            f"corrupt or truncated wire")


# ------------------------------------------------------- bound auditing ---

class AuditReport(NamedTuple):
    """The bound audit of one encode; every field is a 0-d tensor on the
    data's device (no host sync).

    n:           elements audited
    violations:  non-outlier finite values with |x - x̂| > eb (must be 0)
    max_err:     max |x - x̂| over audited values (float32; REL: relative)
    n_nonfinite: NaN/INF inputs (stored losslessly, never binned)
    n_outliers:  values stored losslessly (includes the non-finite ones)
    overflow:    the outlier table overflowed its cap
    """

    n: torch.Tensor
    violations: torch.Tensor
    max_err: torch.Tensor
    n_nonfinite: torch.Tensor
    n_outliers: torch.Tensor
    overflow: torch.Tensor

    def ok(self):
        """True iff the bound held everywhere and nothing was dropped."""
        return (self.violations == 0) & ~self.overflow


def audit_report(x, q, cfg, eb=None, overflow=None,
                 n_outliers=None) -> AuditReport:
    """An `AuditReport` from the planes the encoder already computed
    (`Quantized` of the same pass): three reductions, no re-decode.

    The violation test uses the plain requested bound (not eb * TIGHTEN):
    the encoder accepted only `diff <= eb * TIGHTEN < eb`, so a clean
    encode audits to zero violations with margin.  For ABS/NOA the bound
    takes the encoder's traced-eb floor."""
    x = torch.as_tensor(x).reshape(-1)
    dt, dev = x.dtype, x.device
    recon, outlier = q.recon.reshape(-1), q.outlier.reshape(-1)
    finite = torch.isfinite(x)
    checked = finite & ~outlier
    zero = torch.zeros((), dtype=dt, device=dev)
    if cfg.mode == "rel":
        # relative metric: |x - x̂| <= eb * |x|; report err / |x|
        bound = torch.full((), float(cfg.error_bound), dtype=dt, device=dev)
        ax = torch.where(checked, x.abs(), torch.ones((), dtype=dt,
                                                      device=dev))
        err = torch.where(checked, (x - recon).abs() / ax, zero)
    else:
        # abs / noa: mirror the encoder's traced-eb floor transform
        e = cfg.error_bound if eb is None else eb
        e = (e.to(device=dev, dtype=dt).reshape(()) if torch.is_tensor(e)
             else torch.full((), float(e), dtype=dt, device=dev))
        bound = torch.maximum(e, torch.full((), float(cfg.eb_floor),
                                            dtype=dt, device=dev))
        err = torch.where(checked, (x - recon).abs(), zero)
    bad = checked & ~(err <= bound)
    if overflow is None:
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
    err32 = err.to(torch.float32)
    max_err = (torch.clamp(err32.max(), min=0.0) if err32.numel()
               else torch.zeros((), dtype=torch.float32, device=dev))
    if n_outliers is None:
        n_outliers = outlier.sum(dtype=torch.int32)
    return AuditReport(
        n=torch.full((), x.numel(), dtype=torch.int32, device=dev),
        violations=bad.sum(dtype=torch.int32),
        max_err=max_err,
        n_nonfinite=(~finite).sum(dtype=torch.int32),
        n_outliers=torch.as_tensor(n_outliers).to(torch.int32).reshape(()),
        overflow=torch.as_tensor(overflow).to(torch.bool).reshape(()),
    )


# -------------------------------------------------- degradation policies --

def _raise_policy(ctx: dict):
    raise WireIntegrityError(
        f"wire integrity check failed at {ctx.get('site', '?')}: {ctx}")


def _drop_policy(ctx: dict):
    return "drop"


def _rerequest_policy(ctx: dict):
    return "rerequest"


# name -> handler(ctx) -> action token ("drop" | "rerequest") or raises.
DEGRADATION_POLICIES = {
    "raise": _raise_policy,
    "drop": _drop_policy,
    "rerequest": _rerequest_policy,
}


def register_policy(name: str, handler):
    """Register a degradation policy: handler(ctx_dict) -> action token,
    or raise."""
    DEGRADATION_POLICIES[name] = handler


def get_policy(name: str):
    if name not in DEGRADATION_POLICIES:
        raise KeyError(f"unknown degradation policy {name!r}; have "
                       f"{sorted(DEGRADATION_POLICIES)}")
    return DEGRADATION_POLICIES[name]

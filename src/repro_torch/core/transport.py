"""The Transport API, in torch: the one choke point for every compressed
wire that crosses an axis of ranks.

Counterpart of `repro.core.transport`:

    all_gather(wire, axis)           gather any wire (Encoded, SelectedWire,
                                     tuples of them)
    reduce_sum / reduce_mean(...)    the compressed-gradient collective: a
                                     packed-domain ring when the shards are
                                     grid-compatible, else gather + decode +
                                     sum; bit-identical either way
    send_pages(wire, src, dst, axis) point-to-point wire movement
    bytes_moved(wire, op=...)        transmitted bytes of a collective, from
                                     `wire_bytes`

`axis` is a `core.axis` object (`DistAxis` over torch.distributed, or a
`ThreadGroup` rank: p ranks on one card); each rank runs the same code, as
under the reference's `shard_map`.

The packed-domain ring fires exactly when its result is bit-identical to
the gather path (the reference's rule): statically, an ABS chain with no
word or pred stages, p > 1 and p * maxbin < 2^24 (every partial sum of
bins is an exact float32 multiple of the pow2 step eb2); at run time,
every rank on the same grid (bit-equal eb) and no rank with outliers.  The
run-time rule is agreed by `pmax` on every rank and read on the host once
per reduce (the reference's `lax.cond`); a NaN eb compares unequal and
takes the gather path.  The ring accumulates int32 bins over p - 1 hops
of the word plane and dequantizes once with the dense dequantize kernel
(B10) and an empty outlier plane; the gather path decodes every shard
with the card's kernels (`kernels=None`) and sums in rank order.

`integrity='drop'` verifies every received contribution (a per-hop
`audit.plane_checksum` that travels with the hop on the ring, the wire
checksum per gathered shard) and drops the failed ones from the sum and
from the per-rank valid count.

`send_pages` moves any wire point to point, the KV cache's `PackedKV`
(`compression.kv`) and `PackedCache` (`models.serve`) included, and
`wire_bytes` accounts a `PackedKV` page by page.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels import dense as D
from . import audit as A
from . import codec as C
from .pipeline import Encoded, Pipeline
from .select import SelectedWire


def tree_map(fn, node):
    """fn over every tensor of a wire: NamedTuples, tuples and lists keep
    their structure, None stays None, a `PackedKV` keeps its statics."""
    if torch.is_tensor(node):
        return fn(node)
    if node is None:
        return None
    if hasattr(node, "map_planes"):
        return node.map_planes(fn)
    if hasattr(node, "_fields"):
        return type(node)(*(tree_map(fn, v) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(tree_map(fn, v) for v in node)
    raise TypeError(f"cannot move a {type(node).__name__} across an axis")


# ------------------------------------------------------ byte accounting ---

def _kv_wire_bytes(wire):
    """Per-page accounting of a `PackedKV`: the eb2 / outlier / overflow
    planes, each page's header content bits (not the tile-padded stored
    plane), and the transmitted payload prefix with its 32-bit length per
    page when a stage is length-variable.  Bits accumulate across stages
    and pages and are divided by 8 once.  A Python number for static
    chains, else a 0-d float32 tensor (the word count summed as exact
    int32, converted once: `codec.transmitted_bits`)."""
    cap = wire.payload.shape[-1]
    n_pages = wire.payload_len.numel()
    checksum_bits = 32 if wire.checksum is not None else 0
    table_bits = (wire.eb2.numel() * 32 + wire.out_idx.numel() * 32
                  + wire.out_val.numel() * 32 + wire.overflow.numel() * 8)
    sel = wire.select
    if sel is not None:
        # each page sends a 1-byte chain id and its own length, and pays
        # the chosen fragment's header content
        hcb = torch.tensor([sel.header_content_bits(i, cap)
                            for i in range(len(sel.chains))],
                           dtype=torch.int32, device=wire.payload.device)
        cid = wire.chain_id.reshape(-1).to(torch.int64)
        cid = cid.clamp(0, len(sel.chains) - 1)
        hdr_bits = hcb[cid].sum(dtype=torch.int32).to(torch.float32)
        static_bits = n_pages * (8 + 32) + checksum_bits + table_bits
        words = wire.payload_len.sum(dtype=torch.int32)
        return (C.transmitted_bits(words, static_bits) + hdr_bits) / 8.0
    static_bits = checksum_bits + n_pages * sum(
        st.header_content_bits(cap) for st in wire.stages)
    static_bits += n_pages * sum(st.header_content_bits()
                                 for st in wire.pred)
    static_bits += table_bits
    if wire.stages and wire.stages[-1].transmits_len:
        static_bits += n_pages * 32            # the transmitted lengths
        words = wire.payload_len.sum(dtype=torch.int32)
        return C.transmitted_bits(words, static_bits) / 8.0
    bits = static_bits + 32 * wire.payload.numel()
    return bits // 8 if bits % 8 == 0 else bits / 8.0


def wire_bytes(wire, *, pipe=None, n: int | None = None):
    """Transmitted bytes of one wire object, the single accounting accessor:

      * `Encoded` with its `pipe` (and element count `n`), or a
        `SelectedWire` with its `Selector` and `n`: the chain's own
        accounting (`wire_bytes`);
      * a shard carrying its own pipe and n (`CompressedShard`): the same;
      * a `PackedKV`: the per-page accounting (`_kv_wire_bytes`);
      * a NamedTuple (`models.serve.PackedCache`), list or tuple of wires:
        the sum of its items;
      * a tensor: its full width (numel * element size).

    A Python int for static chains; a 0-d float32 tensor when a
    length-variable stage makes the payload data-dependent (and for every
    selector wire, as in the reference)."""
    if isinstance(wire, Encoded):
        if pipe is None:
            raise TypeError("wire_bytes(Encoded) needs pipe= (and n=)")
        return pipe.wire_bytes(wire, n)
    if isinstance(wire, SelectedWire):
        if pipe is None or n is None:
            raise TypeError("wire_bytes(SelectedWire) needs pipe= and n=")
        return pipe.wire_bytes(wire, n)
    if isinstance(getattr(wire, "enc", None), (Encoded, SelectedWire)):
        return wire.pipe.wire_bytes(wire.enc, wire.n if n is None else n)
    if hasattr(wire, "eb2") and hasattr(wire, "payload"):
        return _kv_wire_bytes(wire)
    if hasattr(wire, "_fields") or isinstance(wire, (list, tuple)):
        total = 0
        for field in wire:
            total = total + wire_bytes(field)
        return total
    if torch.is_tensor(wire):
        return wire.numel() * wire.element_size()
    raise TypeError(f"wire_bytes cannot account a {type(wire).__name__}")


# ------------------------------------------------------------ transport ---

@dataclasses.dataclass(frozen=True)
class Transport:
    """Moves compressed wires across axes.  Stateless and hashable;
    `TRANSPORT` below is the default instance.

    reduce: 'auto' takes the packed-domain ring whenever the rule above
    allows; 'gather' pins the gather + decode + sum path.

    fault: a test-only corruption hook, (wire) -> wire, applied to every
    received wire right after the collective and before any check (the
    fault-injection harness, `runtime.guard`, passes
    `FaultPlan(...).corrupt_hop`); None in production."""
    reduce: str = "auto"
    fault: Callable | None = None

    def __post_init__(self):
        if self.reduce not in ("auto", "gather"):
            raise ValueError(f"reduce must be 'auto' or 'gather', "
                             f"got {self.reduce!r}")

    # --- collectives ------------------------------------------------------

    def _verify_received(self, wire, verify, what: str):
        """None passes the wire through unchecked; 'mask' appends the
        per-shard verdicts, (wire, bool[axis size]); 'raise' raises
        `WireIntegrityError` on any mismatch (one host read)."""
        if verify is None:
            return wire
        ok = A.verify_gathered(wire)
        if verify == "mask":
            return wire, ok
        if verify == "raise":
            if not bool(ok.all()):
                raise A.WireIntegrityError(
                    f"{what}: received wire failed its integrity checksum "
                    f"(shard mask {ok.tolist()})")
            return wire
        raise ValueError(f"verify must be None, 'mask' or 'raise', "
                         f"got {verify!r}")

    def all_gather(self, wire, axis, *, verify=None):
        """Gather a wire over `axis`: every plane grows a leading axis of
        the axis size, in rank order.  `verify` checks each received
        shard's carried checksum ('mask' or 'raise'; the wires must be
        encoded with integrity=True)."""
        gathered = tree_map(axis.all_gather, wire)
        if self.fault is not None:
            gathered = self.fault(gathered)
        return self._verify_received(gathered, verify, "all_gather")

    def _ring_ok(self, pipe, qc, p: int) -> bool:
        # pred chains and selector wires never ring-reduce: each shard's
        # word plane holds residual codes or its own chain's words, so
        # decode-then-sum is the only exact path
        return (self.reduce == "auto" and isinstance(pipe, Pipeline)
                and qc.mode == "abs"
                and not pipe.stages and not pipe.pred
                and p > 1 and p * qc.maxbin < (1 << 24))

    def _ring_compat(self, enc, axis) -> bool:
        # run-time agreement: the same pow2 grid everywhere and no
        # outliers anywhere; one host read of the agreed flag (on the meta
        # device, `launch.dryrun`, no value is known: the gather, which
        # pods with their own bounds take)
        compat = axis.pmax(enc.n_outliers) == 0
        if enc.eb is not None:
            eb_hi = axis.pmax(enc.eb)
            eb_lo = -axis.pmax(-enc.eb)
            compat = compat & (eb_hi == eb_lo)
        return compat.device.type != "meta" and bool(compat)

    def uses_ring(self, enc, pipe, axis) -> bool:
        """Whether a reduce of `enc` over `axis` takes the packed-domain
        ring (the static rule, then the agreed run-time one)."""
        return (self._ring_ok(pipe, pipe.qcfg(), axis.size)
                and self._ring_compat(enc, axis))

    def _check_integrity_arg(self, enc, integrity: str):
        """The checked reduce takes the 'drop' policy only, and needs
        wires that carry a checksum."""
        A.get_policy(integrity)            # fail fast on unknown names
        if integrity != "drop":
            raise ValueError(
                f"reduce integrity={integrity!r}: the reduce supports only "
                f"the 'drop' policy (mask + renormalize); route 'raise' or "
                f"'rerequest' through all_gather(verify='mask')")
        if not A.has_checksum(enc):
            raise ValueError("reduce with integrity= needs "
                             "encode(integrity=True) wires — no checksum "
                             "carried")

    def reduce_sum(self, enc, pipe, n: int, axis, *,
                   integrity: str | None = None) -> torch.Tensor:
        """Sum of every rank's decoded tensor over `axis` (float32[n]):
        the packed-domain ring when the rule holds, else gather + decode +
        sum; bit-identical either way.  `integrity='drop'` drops the
        contributions that fail their check (a partial sum; `reduce_mean`
        renormalizes)."""
        if integrity is None:
            if self.uses_ring(enc, pipe, axis):
                return self._ring_sum(enc, pipe.qcfg(), n, axis)
            return self._gather_sum(enc, pipe, n, axis)
        total, _ = self._reduce_checked(enc, pipe, n, axis, integrity)
        return total

    def reduce_mean(self, enc, pipe, n: int, axis, *,
                    integrity: str | None = None, return_valid: bool = False):
        """reduce_sum / axis size.  With `integrity='drop'` each rank
        divides by the count of contributions it verified; `return_valid`
        appends that count (int32 0-d; the axis size on a clean run)."""
        if integrity is None:
            mean = self.reduce_sum(enc, pipe, n, axis) / axis.size
            if not return_valid:
                return mean
            return mean, torch.full((), axis.size, dtype=torch.int32,
                                    device=mean.device)
        total, n_valid = self._reduce_checked(enc, pipe, n, axis, integrity)
        mean = total / torch.clamp(n_valid, min=1).to(total.dtype)
        return (mean, n_valid) if return_valid else mean

    def send_pages(self, wire, src: int, dst: int, axis, *, verify=None):
        """Move a wire from rank `src` to rank `dst`: `dst` receives src's
        planes bit for bit, every other rank zeros (ppermute semantics).
        `verify='mask'` appends the received wire's checksum verdict (only
        dst's is meaningful); 'raise' raises on a mismatch."""
        moved = tree_map(lambda a: axis.ppermute(a, [(src, dst)]), wire)
        if self.fault is not None:
            moved = self.fault(moved)
        if verify is None:
            return moved
        ok = A.verify_wire(moved)
        if verify == "mask":
            return moved, ok
        if verify == "raise":
            if not bool(ok):
                raise A.WireIntegrityError(
                    "send_pages: received wire failed its integrity "
                    "checksum")
            return moved
        raise ValueError(f"verify must be None, 'mask' or 'raise', "
                         f"got {verify!r}")

    # --- reduce internals -------------------------------------------------

    @staticmethod
    def _decode_sum(enc_all, pipe, n: int, keep=None) -> torch.Tensor:
        """Sum of the gathered shards' decodes, from 0 in rank order (the
        reference's sum over the gathered axis); each decode takes the
        card's kernels on the card.  `keep` (host bools) leaves failed
        shards out: they add 0, as the reference's mask does."""
        dev = enc_all.payload.device
        total = torch.zeros(n, dtype=torch.float32, device=dev)
        for i in range(enc_all.payload.shape[0]):
            if keep is None or keep[i]:
                total = total + pipe.decode(A.shard_of(enc_all, i), n=n,
                                            device=dev)
            else:
                total = total + 0.0
        return total

    def _gather_sum(self, enc, pipe, n: int, axis) -> torch.Tensor:
        return self._decode_sum(self.all_gather(enc, axis), pipe, n)

    @staticmethod
    def _dequantize(total: torch.Tensor, qc, eb) -> torch.Tensor:
        """bins * eb2 once, with the dense dequantize kernel (B10) and an
        empty outlier plane: exact for |bins| < 2^24."""
        return D.dequantize_abs(total, torch.zeros_like(total),
                                torch.zeros_like(total, dtype=torch.bool),
                                qc, eb=eb)

    def _ring_sum(self, enc, qc, n: int, axis) -> torch.Tensor:
        # each hop moves the word plane to the next rank; bins accumulate
        # as exact int32 and dequantize once.  Valid only under the rule
        # reduce_sum checks.
        p = axis.size
        perm = [(i, (i + 1) % p) for i in range(p)]
        total = C.unpack_words(enc.payload, n, qc.bin_bits)
        cur = enc.payload
        for _ in range(p - 1):
            cur = axis.ppermute(cur, perm)
            total = total + C.unpack_words(cur, n, qc.bin_bits)
        return self._dequantize(total, qc, enc.eb)

    def _reduce_checked(self, enc, pipe, n: int, axis, integrity: str):
        # the verified reduce: (masked sum, per-rank valid count)
        self._check_integrity_arg(enc, integrity)
        if self.uses_ring(enc, pipe, axis):
            return self._ring_sum_checked(enc, pipe.qcfg(), n, axis)
        return self._gather_sum_checked(enc, pipe, n, axis)

    def _gather_sum_checked(self, enc, pipe, n: int, axis):
        # per-shard checksum verdicts (one host read) leave failed shards
        # out of the sum, undecoded
        enc_all, ok = self.all_gather(enc, axis, verify="mask")
        total = self._decode_sum(enc_all, pipe, n, keep=ok.tolist())
        return total, ok.sum(dtype=torch.int32)

    def _ring_sum_checked(self, enc, qc, n: int, axis):
        # each hop is (payload, owner digest): the digest is computed once
        # by the plane's owner and travels with it, so a flip at any link
        # fails at every later rank.  Failed hops are masked out of the
        # bins and the valid count; own bins always count.
        p = axis.size
        perm = [(i, (i + 1) % p) for i in range(p)]
        total = C.unpack_words(enc.payload, n, qc.bin_bits)
        cur, cs = enc.payload, A.plane_checksum(enc.payload)
        n_valid = torch.ones((), dtype=torch.int32, device=total.device)
        for _ in range(p - 1):
            cur = axis.ppermute(cur, perm)
            cs = axis.ppermute(cs, perm)
            if self.fault is not None:
                cur, cs = self.fault((cur, cs))
            ok = A.plane_checksum(cur) == cs
            bins = C.unpack_words(cur, n, qc.bin_bits)
            total = total + torch.where(ok, bins, torch.zeros_like(bins))
            n_valid = n_valid + ok.to(torch.int32)
        return self._dequantize(total, qc, enc.eb), n_valid

    # --- accounting -------------------------------------------------------

    def bytes_moved(self, wire, *, op: str = "all_gather",
                    axis_size: int = 1, pipe=None, n: int | None = None):
        """Total bytes a collective moves across the axis, from
        `wire_bytes`: one copy for 'send_pages'; p (p - 1) copies for
        'all_gather' and for 'reduce_sum'/'reduce_mean' (the gather path's
        bound: the ring, when it fires, moves only the word plane per
        hop)."""
        w = wire_bytes(wire, pipe=pipe, n=n)
        if op == "send_pages":
            return w
        if op in ("all_gather", "reduce_sum", "reduce_mean"):
            if axis_size < 2:
                raise ValueError(
                    f"bytes_moved(op={op!r}) needs axis_size >= 2, "
                    f"got {axis_size}")
            return axis_size * (axis_size - 1) * w
        raise ValueError(f"unknown op {op!r}")


TRANSPORT = Transport()

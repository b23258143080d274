"""Guaranteed-error-bounded gradient compression for the cross-pod
all-reduce, in torch: the paper's quantizer on the slowest wire.

Counterpart of `repro.compression.grads`.  Each pod quantizes its
pod-local gradient through a compression pipeline (an ABS quantizer with
the per-tensor bound eb = eb_rel * rms(g), the bit-pack, any chain of
lossless word stages, or 'auto': a `core.select.Selector`) into one wire;
`core.transport.Transport.reduce_sum` moves it (the packed-domain ring
when every pod sits on one grid with no outliers, else gather + decode +
sum, bit-identical either way).

  * Error feedback: the residual g - shipped is carried to the next step;
    the bound makes it elementwise |e| <= eb (outliers ship exactly, so
    their residual is 0).
  * Overflow: if any pod's outlier table overflows its cap, the wire
    cannot honour the bound; the pmax-agreed flag, read on the host once
    per tensor (the reference's `lax.cond`), sends that tensor to the
    lossless `psum` for the step and its residual is 0.

The functions run per rank with an axis object (`core.axis`): under
`core.axis.run_threads` p ranks share one card; under `DistAxis` each
rank is a process.  Entry points run on the card unless the caller passes
device='cpu'.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import tree as T
from ..configs.registry import get_selector_set
from ..core import codec as C
from ..core import select as SEL
from ..core.pipeline import (PackStage, Pipeline, QuantStage,
                             parse_pipeline, resolve_device)
from ..core.transport import TRANSPORT, Transport, wire_bytes as _wire_bytes


class GradCompressionConfig(NamedTuple):
    eb_rel: float = 2.0 ** -8       # bound relative to the gradient's rms
    bin_bits: int = 8               # used when `pipeline` is empty
    outlier_cap_frac: float = 1 / 64
    pipeline: str = ""              # a spec ("abs:1.0|pack:8|narrow"); its
    #                                 eb is a placeholder (the per-tensor
    #                                 bound overrides it) and a spec without
    #                                 cap= inherits outlier_cap_frac.
    #                                 'auto' / 'auto:SET' resolves to a
    #                                 Selector: the chain is chosen per
    #                                 shard at encode time.

    def pipe(self):
        """The pipeline this config describes (a `Pipeline`, or a
        `Selector` for 'auto' specs).  `pipeline` wins; otherwise a
        stage-free chain from eb_rel/bin_bits.  The quantizer must be ABS:
        eb_rel * rms(g) is an ABS bound."""
        if SEL.is_auto_spec(self.pipeline):
            sel = SEL.parse_selector(self.pipeline)
            if sel.quant.mode != "abs":
                raise ValueError(
                    f"the gradient wire needs an 'abs' quantizer stage; "
                    f"selector set {sel.name!r} has {sel.quant.mode!r}")
            if "cap=" not in get_selector_set(sel.name)["base"]:
                # a base silent about the outlier cap inherits this
                # config's; an explicit cap= wins
                sel = dataclasses.replace(sel, chains=tuple(
                    dataclasses.replace(p, quant=dataclasses.replace(
                        p.quant, cap=self.outlier_cap_frac))
                    for p in sel.chains))
            return sel
        if self.pipeline:
            pipe = parse_pipeline(self.pipeline)
            if pipe.quant.mode != "abs":
                raise ValueError(
                    f"the gradient wire needs an 'abs' quantizer stage "
                    f"(the per-tensor eb = eb_rel * rms overrides the "
                    f"spec's bound); got {pipe.quant.mode!r} in "
                    f"{self.pipeline!r}")
            if "cap=" not in self.pipeline:
                pipe = dataclasses.replace(
                    pipe, quant=dataclasses.replace(
                        pipe.quant, cap=self.outlier_cap_frac))
            return pipe
        return Pipeline(QuantStage("abs", 1.0, self.outlier_cap_frac),
                        PackStage(self.bin_bits))

    def qcfg(self):
        return self.pipe().qcfg()


class CompressedShard:
    """One pod's wire: an `Encoded` (or `SelectedWire`) with its pipeline
    and element count.  The planes of `enc` are what the transport moves;
    the legacy field names (`words`, `header_words`, `payload`, ...) are
    read-only views."""

    def __init__(self, enc, pipe, n: int):
        self.enc = enc
        self.pipe = pipe
        self.n = n

    # --- legacy field views ------------------------------------------------
    @property
    def words(self):
        """The packed bin plane (word stages decoded; under a pred chain
        the folded residual codes)."""
        if self.pipe.stages:
            return self.pipe.decode_words(self.enc.headers, self.enc.payload,
                                          self.pipe.n_words(self.n))
        return self.enc.payload

    @property
    def header_words(self):
        """The first non-empty stage header plane."""
        for h in self.enc.headers:
            if h.numel():
                return h
        raise AttributeError(
            f"pipeline {self.pipe.spec()!r} has no header planes")

    @property
    def payload(self):
        return self.enc.payload

    @property
    def payload_len(self):
        return self.enc.payload_len

    @property
    def out_idx(self):
        return self.enc.out_idx

    @property
    def out_payload(self):
        return self.enc.out_payload

    @property
    def eb(self):
        return self.enc.eb

    @property
    def n_outliers(self):
        return self.enc.n_outliers

    # --- accounting --------------------------------------------------------
    def nbytes(self):
        """Transmitted bytes of one pod's wire (`transport.wire_bytes`): an
        int for static chains, a 0-d tensor after a length-variable
        stage."""
        return _wire_bytes(self)

    def capacity_nbytes(self) -> int:
        """Static upper bound: what the padded all-gather buffer holds."""
        return self.pipe.capacity_bytes(self.enc)


def compress_shard(g, cfg: GradCompressionConfig, *, integrity: bool = False,
                   device="cuda"):
    """One pod-local gradient through the pipeline on `device`.  Returns
    (CompressedShard, Quantized): the second holds the local outlier and
    recon planes for the residual; only the shard goes on the wire.  The
    bound eb_rel * rms(g) stays on the device (rms sums in the
    reference's order, `codec.f32_sum`).  `integrity=True` attaches the
    wire checksum."""
    pipe = cfg.pipe()
    dev = resolve_device(device)
    flat = torch.as_tensor(g).to(dev).reshape(-1).to(torch.float32)
    n = flat.shape[0]
    # the reference's mean: its compiler turns / n into * (1/n) in float32
    inv_n = float(np.float32(1) / np.float32(n))
    ms = C.f32_sum(flat * flat) * torch.full((), inv_n, dtype=torch.float32,
                                             device=dev)
    eb = torch.full((), cfg.eb_rel, dtype=torch.float32,
                    device=dev) * torch.sqrt(ms)
    enc, q = pipe.encode(flat, eb, device=dev, return_quantized=True,
                         integrity=integrity)
    return CompressedShard(enc, pipe, n), q


def compressed_mean(g, cfg: GradCompressionConfig, axis, *,
                    transport: Transport | None = None,
                    integrity: str | None = None, device="cuda"):
    """Compressed mean of g over `axis` (this rank's part of the
    collective).  Returns (mean, residual): the residual is this shard's
    error-feedback term, elementwise within eb (0 on the lossless
    branch).  `transport=` overrides the default (e.g.
    Transport(reduce='gather') pins the gather path).

    `integrity='drop'`: every shard ships with its checksum, the reduce
    gathers, and a shard whose received wire fails the check is dropped;
    the mean renormalizes by the count of shards that verified."""
    if integrity not in (None, "drop"):
        raise ValueError(f"integrity must be None or 'drop', "
                         f"got {integrity!r}")
    tp = TRANSPORT if transport is None else transport
    shard, q = compress_shard(g, cfg, integrity=integrity is not None,
                              device=device)
    dev = q.recon.device
    flat = torch.as_tensor(g).to(dev).reshape(-1).to(torch.float32)
    n, p = flat.shape[0], axis.size
    # every pod must take the same branch: agreed by pmax, read once
    any_overflow = bool(axis.pmax(shard.enc.overflow.to(torch.int32)) > 0)
    if any_overflow:
        # the lossless branch ships everything: no residual
        mean = axis.psum(flat) / p
        resid = torch.zeros_like(flat)
    else:
        # the residual, what this pod did not ship (outliers went exact),
        # before the reduce, so that the quantized planes are freed before
        # it decodes every pod's wire
        resid = flat - torch.where(q.outlier.reshape(-1), flat,
                                   q.recon.reshape(-1))
        del q, flat
        if integrity == "drop":
            # the transport's checked gather (never the ring, as the
            # reference's drop branch): failed shards add 0, the sum
            # renormalizes by the count that verified
            total, n_valid = tp._gather_sum_checked(shard.enc, shard.pipe,
                                                    n, axis)
            mean = total / torch.clamp(n_valid, min=1).to(total.dtype)
        else:
            mean = tp.reduce_sum(shard.enc, shard.pipe, n, axis) / p
    shape = tuple(torch.as_tensor(g).shape)
    return mean.reshape(shape), resid.reshape(shape)


def compressed_mean_tree(grads, residuals, cfg: GradCompressionConfig,
                         axis, transport: Transport | None = None, *,
                         device="cuda", out=None):
    """Tree version with error feedback: each leaf g + r (a sum in g's
    dtype, as the reference's) is compressed-averaged over `axis`, leaf by
    leaf in the reference's order (`repro_torch.tree`), and its mean cast
    back to g's dtype.  `grads` and `residuals` are trees of tensors of
    one structure (nested dicts, lists, tuples).  Returns (mean tree, new
    residual tree).

    `out=`: a tree of that structure (float32, e.g. this pod's row of a
    pod-stacked buffer) that each leaf's new residual is written into as
    soon as it is computed, so no second residual tree is held; it is the
    residual tree returned.  It may be `residuals` itself: each leaf is
    read before it is written."""
    leaves_g, tdef = T.flatten(grads)
    leaves_r = T.leaves(residuals)
    leaves_o = None if out is None else T.leaves(out)
    out_g, out_r = [], []
    for i, (g, r) in enumerate(zip(leaves_g, leaves_r)):
        m, nr = compressed_mean(g + r.to(g.dtype), cfg, axis,
                                transport=transport, device=device)
        out_g.append(m.to(g.dtype))
        if leaves_o is not None:
            nr = leaves_o[i].copy_(nr)
        out_r.append(nr)
    return T.unflatten(tdef, out_g), T.unflatten(tdef, out_r)


def wire_bytes(n_elems: int, cfg: GradCompressionConfig) -> int:
    """Analytic packed wire footprint per pod per tensor: the packed words,
    the capped (idx, payload) table and the 8-byte header.  Equal to
    `CompressedShard.nbytes()` for a stage-free pipeline, an upper bound
    (less the small header planes) with lossless stages."""
    pipe = cfg.pipe()
    qc = pipe.qcfg()
    return pipe.n_words(n_elems) * 4 + qc.outlier_cap(n_elems) * 8 + 8



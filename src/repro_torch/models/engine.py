"""Continuous-batching decode engine over the quantized KV cache
(counterpart of `repro.models.engine.DecodeEngine`).

    engine = DecodeEngine(cfg, params, n_slots=8, seq=2048)  # on the card
    pre    = engine.prefill(prompt)        # -> PrefillResult (PackedCache)
    slot   = engine.allocate()
    engine.insert(slot, pre)               # decode through the exact inverses
    logits, tokens = engine.generate_step()

Slot lifecycle: allocate -> fill (each step writes the slot's open hot
page) -> close (a filled page quantizes within the step) -> evict (pack
the slot back to a `PackedCache` wire and free it).  Closed pages cross
any boundary only as `PackedKV` wires; `stats()["wire_bytes"]` accounts
every transfer through `Transport.bytes_moved`.

The slots are the rows of one `QuantCache` of n_slots rows, their
positions kept on the host, and `generate_step` is one step over all of
them (`serve.serve_step_rows`, the counterpart of the reference's vmap of
the batch-1 step over the slot axis): RoPE, the hot-page write, the page
close and B12's lengths follow each slot's own position, every slot is
its own MoE routing group (one token has K distinct experts and one slot
in each, so nothing drops), and a free slot's cache, position and token
stay as they are.

Each slot's logits are bit-identical to the single-request path
(`step_one`, batch 1) at the same position.  Two things could tie a
row's bits to the batch, and the engine fixes both: B12's split, which
its default takes from the batch (the engine passes one
`pages_per_split` on both paths), and a library kernel picked by the row
count (on an H100 a batched float32 product over the hot page gave a row
other bits at 1 row than at 4, so the hot-page attention sums by
elementwise adds in one fixed order: `serve._fold_sum`).

Streaming migration (`stream_prefill`): the prefill rank packs each KV
page the moment it closes and hands it to `Transport.send_pages` as a
single-page `PageWire`; the open hot page and the last logits follow in
one raw `TailWire`; the decode rank assembles the slot cache from the
received wires, bit-identical to the source.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tree as T
from ..compression import kv as KVC
from ..configs.base import ArchConfig
from ..core import audit as A
from ..core.config import QuantizerConfig
from ..core.pipeline import resolve_device
from ..core.transport import TRANSPORT, Transport
from ..kernels import kv_attention as KA
from . import serve as S


class PageWire(NamedTuple):
    """One closed page on the wire: the K and V `PackedKV` of a single
    page, the unit of streaming migration."""
    k: KVC.PackedKV
    v: KVC.PackedKV


class TailWire(NamedTuple):
    """The end of a prefill: the open hot page (raw: it is not quantized
    yet) and the last prompt position's logits, from which the decode rank
    picks the first generated token."""
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    logits: torch.Tensor


class StreamedPrefill(NamedTuple):
    """`stream_prefill`'s result: the batch-1 cache assembled from the
    per-page wires (`DecodeEngine.insert_cache` takes it), the first
    token, the last logits, the insert position and the transfer ledger."""
    cache: S.QuantCache
    next_token: torch.Tensor          # int32 [1, 1]
    logits: torch.Tensor              # f32 [1, V]
    pos: int
    stats: dict


class PrefillResult(NamedTuple):
    """What `prefill`/`evict` hand to `insert`: closed pages as `PackedKV`
    wires inside a `PackedCache`, the next token to feed, the last
    computed position's logits (None on evict), and the insert position."""
    pages: S.PackedCache
    next_token: torch.Tensor          # int32 [1, 1]
    logits: Optional[torch.Tensor]    # f32 [1, V]
    pos: int                          # next write position


def _clone_cache(cache: S.QuantCache) -> S.QuantCache:
    return S.QuantCache(KVC.QuantizedKV(*(t.clone() for t in cache.k)),
                        KVC.QuantizedKV(*(t.clone() for t in cache.v)),
                        cache.hot_k.clone(), cache.hot_v.clone())


class DecodeEngine:
    """Continuous-batching decode over `n_slots` independent requests at
    per-slot positions, each slot a batch-1 quantized cache on `device`
    (the card unless the caller passes device="cpu"), where the
    parameters must lie.

    `stages` is the per-page chain every boundary wire uses (a
    `KV_PAGE_CHAINS` value or a raw fragment), or "auto"/"auto:SET".
    `integrity` names a degradation policy (`core.audit`: "raise",
    "rerequest", or a registered one): every wire the engine emits then
    carries its checksum and `insert` re-verifies it; a failed check
    counts in `stats()`, routes through the policy and, unless the policy
    raised, refuses the insert (returns False)."""

    def __init__(self, cfg: ArchConfig, params: dict, *, n_slots: int,
                 seq: int, kv_cfg: QuantizerConfig | None = None,
                 stages="zero", transport: Transport | None = None,
                 integrity: str | None = None, device="cuda"):
        if seq % S.PAGE:
            raise ValueError(f"seq={seq} is not a multiple of {S.PAGE}")
        S._check_family(cfg)
        self.cfg, self.params = cfg, params
        dev = resolve_device(device)
        if params["emb"].device.type != dev.type:
            raise ValueError(f"the parameters lie on {params['emb'].device},"
                             f" the engine is asked to run on {dev}")
        self.device = params["emb"].device
        self.n_slots, self.seq = int(n_slots), int(seq)
        self.kv_cfg = (KVC.kv_quantizer_config() if kv_cfg is None
                       else kv_cfg)
        self.stages = stages
        self.integrity = integrity
        if integrity is not None:
            A.get_policy(integrity)          # fail fast on unknown names
        self.transport = TRANSPORT if transport is None else transport
        self._cache = S.make_quant_cache(cfg, self.n_slots, self.seq,
                                         device=self.device)
        self._pos = [0] * self.n_slots       # host-side positions
        self._tok = torch.zeros((self.n_slots, 1), dtype=torch.int32,
                                device=self.device)
        # one split for the batched step and the batch-1 path alike
        self._pps = KA.default_pages_per_split(self.n_slots, cfg.n_kv_heads,
                                               self.seq // S.PAGE)
        self.requests: list = [None] * self.n_slots   # host slot table
        self._stats = dict(prefill_tokens=0, generated_tokens=0, steps=0,
                           wire_bytes=0.0, sends=0, inserts=0, evictions=0,
                           audit_checks=0, audit_failures=0,
                           audit_reports=0, audit_violations=0,
                           audit_nonfinite=0, audit_overflow=0,
                           audit_max_err=0.0)
        self._slot_audit = [dict(checks=0, failures=0)
                            for _ in range(self.n_slots)]

    def _new_cache(self) -> S.QuantCache:
        return S.make_quant_cache(self.cfg, 1, self.seq, device=self.device)

    def step_one(self, cache: S.QuantCache, token, pos: int):
        """The single-request serve path, the bit-identity reference: one
        request (a batch-1 cache, token [1, 1]) with the batched step's
        B12 split."""
        return S.serve_step_rows(self.cfg, self.params, cache, token, [pos],
                                 self.kv_cfg, pages_per_split=self._pps)

    def _slot_cache(self, slot: int) -> S.QuantCache:
        """Slot `slot` as a batch-1 cache (views of its row)."""
        row = lambda t: t[:, slot:slot + 1]
        return S.QuantCache(KVC.QuantizedKV(*map(row, self._cache.k)),
                            KVC.QuantizedKV(*map(row, self._cache.v)),
                            row(self._cache.hot_k), row(self._cache.hot_v))

    # --- slot lifecycle ---------------------------------------------------

    def allocate(self) -> Optional[int]:
        """Claim a free slot, or None when every slot is live."""
        for slot in range(self.n_slots):
            if self.requests[slot] is None:
                return slot
        return None

    def prefill(self, prompt) -> PrefillResult:
        """Run one request's prompt through the batch-1 `step_one` chain
        and emit the slot-insert wire: closed pages leave as `PackedKV`
        (per-page chain `self.stages`), the open hot page rides raw."""
        if not torch.is_tensor(prompt):
            prompt = torch.from_numpy(np.asarray(prompt, dtype=np.int32))
        prompt = prompt.to(device=self.device, dtype=torch.int32).reshape(-1)
        m = int(prompt.shape[0])
        if not 0 < m < self.seq:
            raise ValueError(f"prompt of {m} tokens for seq={self.seq}")
        cache = self._new_cache()
        logits = None
        for i in range(m):
            logits, cache = self.step_one(cache, prompt[i].reshape(1, 1), i)
        nxt = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
        wire = S.pack_cache(cache, stages=self.stages,
                            integrity=self.integrity is not None)
        self._stats["prefill_tokens"] += m
        return PrefillResult(wire, nxt, logits, m)

    def _verify_pages(self, slot: int, pages: S.PackedCache) -> bool:
        """Receive-side check of any carried checksum on the K/V planes.
        Clean -> True.  A mismatch is counted (engine-wide and per slot)
        and routed through the degradation policy; returns False unless
        the policy raised."""
        ok = True
        for name, plane in (("k", pages.k), ("v", pages.v)):
            if not A.has_checksum(plane):
                continue
            self._stats["audit_checks"] += 1
            self._slot_audit[slot]["checks"] += 1
            if bool(A.verify_wire(plane)):
                continue
            ok = False
            self._stats["audit_failures"] += 1
            self._slot_audit[slot]["failures"] += 1
            A.get_policy(self.integrity or "raise")(dict(
                site="engine.insert", slot=slot, plane=name,
                what="PackedCache"))
        return ok

    def insert(self, slot: int, pre: PrefillResult, *, request=True) -> bool:
        """Insert a prefilled or evicted request into `slot`: the wire
        decodes through the exact page-chain inverses (`unpack_cache`), so
        the slot's history is bit-identical to the source cache.  Accounts
        the wire via `Transport.bytes_moved(op='send_pages')`.  Returns
        False when a checksum failed and the policy did not raise."""
        if self.requests[slot] is not None:
            raise ValueError(f"slot {slot} is live")
        for plane in (pre.pages.k, pre.pages.v):
            if not isinstance(plane, KVC.PackedKV):
                raise TypeError(f"insert takes PackedKV pages, got "
                                f"{type(plane).__name__}")
        self._account(pre.pages)
        if not self._verify_pages(slot, pre.pages):
            return False
        self.insert_cache(slot, S.unpack_cache(pre.pages),
                          next_token=pre.next_token, pos=pre.pos,
                          request=request)
        return True

    def insert_cache(self, slot: int, cache1: S.QuantCache, *, next_token,
                     pos: int, request=True):
        """Insert an already-decoded batch-1 cache (a copy of it: the slot
        then advances in place)."""
        if self.requests[slot] is not None:
            raise ValueError(f"slot {slot} is live")
        for d, t in zip(T.leaves(self._slot_cache(slot)), T.leaves(cache1)):
            d.copy_(t)
        self._pos[slot] = int(pos)
        self._tok[slot] = torch.as_tensor(next_token).to(
            device=self.device, dtype=torch.int32).reshape(1)
        self.requests[slot] = request
        self._stats["inserts"] += 1

    def generate_step(self):
        """One decode step of every live slot (fill, and on a page boundary
        close).  Returns (logits float32 [n_slots, V], tokens int32
        [n_slots]); dead slots' rows are stale and must be ignored."""
        live = [r is not None for r in self.requests]
        if not any(live):
            raise RuntimeError("generate_step with no live slot")
        for slot, on in enumerate(live):
            if on and self._pos[slot] >= self.seq:
                raise RuntimeError(f"slot {slot} ran past seq={self.seq}; "
                                   f"release it first")
        logits, _ = S.serve_step_rows(self.cfg, self.params, self._cache,
                                      self._tok, self._pos, self.kv_cfg,
                                      live=live, pages_per_split=self._pps)
        rows = [s_ for s_, on in enumerate(live) if on]
        idx = torch.tensor(rows, device=self.device) if len(rows) < len(
            live) else slice(None)
        self._tok[idx] = torch.argmax(logits[idx], -1, keepdim=True).to(
            torch.int32)
        for slot in rows:
            self._pos[slot] += 1
        self._stats["steps"] += 1
        self._stats["generated_tokens"] += len(rows)
        return logits, self._tok[:, 0].clone()

    def evict(self, slot: int) -> PrefillResult:
        """Pack `slot` back to the `PackedCache` wire and free it; the
        result re-`insert`s into any engine bit-exactly."""
        if self.requests[slot] is None:
            raise ValueError(f"slot {slot} is free")
        wire = S.pack_cache(_clone_cache(self._slot_cache(slot)),
                            stages=self.stages,
                            integrity=self.integrity is not None)
        out = PrefillResult(wire, self._tok[slot].reshape(1, 1).clone(),
                            None, self._pos[slot])
        self._account(wire)
        self._stats["evictions"] += 1
        self.release(slot)
        return out

    def release(self, slot: int):
        """Free a slot without packing (request finished)."""
        self.requests[slot] = None

    # --- accounting -------------------------------------------------------

    def _account(self, wire) -> float:
        moved = float(self.transport.bytes_moved(wire, op="send_pages"))
        self._stats["wire_bytes"] += moved
        self._stats["sends"] += 1
        return moved

    def raw_slot_bytes(self) -> int:
        """bfloat16 K + V of one slot's history at full `seq`: the
        denominator of the wire-bytes-against-raw ratio."""
        g, hd = self.cfg.n_kv_heads, self.cfg.head_dim
        return 2 * self.cfg.n_layers * self.seq * g * hd * 2

    def record_audit(self, report) -> None:
        """Fold an `AuditReport` (or a list of them) into the engine's
        cumulative audit_* counters, surfaced by `stats()`."""
        for rep in (report,) if hasattr(report, "violations") else report:
            if rep is None:
                continue
            self._stats["audit_reports"] += 1
            self._stats["audit_violations"] += int(rep.violations)
            self._stats["audit_nonfinite"] += int(rep.n_nonfinite)
            self._stats["audit_overflow"] += int(rep.overflow)
            self._stats["audit_max_err"] = max(
                self._stats["audit_max_err"], float(rep.max_err))

    def stats(self) -> dict:
        out = dict(self._stats)
        out["slot_audit"] = [dict(d) for d in self._slot_audit]
        return out

    # --- reference scheduler ----------------------------------------------

    def run(self, prompts, max_new_tokens: int, *, prefill_fn=None):
        """Reference continuous-batching loop: admit pending requests as
        slots free, step every live slot, release finished ones.
        `prefill_fn(prompt)` returns a `PrefillResult` (the default,
        `self.prefill`) or a `StreamedPrefill` (pages already migrated).
        Returns {request index: [generated token ids]}, `max_new_tokens`
        each, greedy."""
        prefill_fn = self.prefill if prefill_fn is None else prefill_fn
        pending = collections.deque(enumerate(list(prompts)))
        out = {rid: [] for rid, _ in pending}
        budget = {}
        while pending or any(r is not None for r in self.requests):
            while pending:
                slot = self.allocate()
                if slot is None:
                    break
                rid, prompt = pending.popleft()
                pre = prefill_fn(prompt)
                if isinstance(pre, StreamedPrefill):
                    self.insert_cache(slot, pre.cache,
                                      next_token=pre.next_token,
                                      pos=pre.pos, request=rid)
                    self._stats["wire_bytes"] += pre.stats["wire_bytes"]
                    self._stats["sends"] += pre.stats["sends"]
                else:
                    self.insert(slot, pre, request=rid)
                out[rid].append(int(pre.next_token.reshape(())))
                budget[rid] = max_new_tokens - 1
                if budget[rid] <= 0:
                    self.release(slot)
            if not any(r is not None for r in self.requests):
                continue
            _, toks = self.generate_step()
            toks = toks.tolist()
            for slot, rid in enumerate(list(self.requests)):
                if rid is None:
                    continue
                out[rid].append(int(toks[slot]))
                budget[rid] -= 1
                if budget[rid] <= 0 or self._pos[slot] >= self.seq:
                    self.release(slot)
        return out


# --------------------------------------------------- streaming migration ---

def stream_prefill(cfg: ArchConfig, params: dict, prompt, *, seq: int, axis,
                   src: int = 0, dst: int = 1,
                   kv_cfg: QuantizerConfig | None = None, stages="zero",
                   transport: Transport | None = None) -> StreamedPrefill:
    """Prefill on rank `src` of `axis` (a `core.axis` axis: threads on one
    card, or `DistAxis`), shipping each KV page to rank `dst` the moment it
    closes.  Every rank calls it with the same prompt (only `src` computes
    on it; the others pass wires of the same shapes, as `transfer_cache`
    takes a cache of the same shape on every rank).

    Every closed page crosses as a single-page `PageWire` (two `PackedKV`s
    in the per-page chain `stages`) through `Transport.send_pages`; the
    open hot page and the last position's logits follow in one raw
    `TailWire`.  Rank `dst` returns the cache assembled from the received
    wires, bit-identical to the source cache; the other ranks return zeros
    in its place (ppermute semantics).  `stats["ledger"]` lists
    (kind, page index, bytes) per wire, accounted by
    `Transport.bytes_moved` on the wire the rank sent or received."""
    tp = TRANSPORT if transport is None else transport
    kv_cfg = KVC.kv_quantizer_config() if kv_cfg is None else kv_cfg
    dev = params["emb"].device
    if not torch.is_tensor(prompt):
        prompt = torch.from_numpy(np.asarray(prompt, dtype=np.int32))
    prompt = prompt.to(device=dev, dtype=torch.int32).reshape(-1)
    m = int(prompt.shape[0])
    if not 0 < m < seq:
        raise ValueError(f"prompt of {m} tokens for seq={seq}")
    if seq % S.PAGE:
        raise ValueError(f"seq={seq} is not a multiple of {S.PAGE}")
    S._check_family(cfg)
    me = axis.rank

    def page_wire(cache, p):
        return PageWire(*(KVC.pack_kv(KVC.slice_pages(q, p, page=S.PAGE),
                                      page=S.PAGE, stages=stages)
                          for q in (cache.k, cache.v)))

    def send(wire):
        got = tp.send_pages(wire, src, dst, axis)
        return got, float(tp.bytes_moved(wire if me == src else got,
                                         op="send_pages"))

    cache = S.make_quant_cache(cfg, 1, seq, device=dev)
    recv = S.make_quant_cache(cfg, 1, seq, device=dev)
    k, v = recv.k, recv.v
    ledger = []
    logits = torch.zeros((1, cfg.padded_vocab), device=dev)
    for i in range(m):
        if me == src:
            logits, cache = S.serve_step(cfg, params, cache,
                                         prompt[i].reshape(1, 1), i, None,
                                         kv_cfg)
        if (i + 1) % S.PAGE == 0:
            p = i // S.PAGE
            # the other ranks send the same shapes from an empty page
            got, moved = send(page_wire(cache, p))
            ledger.append(("PageWire", p, moved))
            if me == dst:
                k = KVC.paste_pages(k, KVC.unpack_kv(got.k, page=S.PAGE), p,
                                    page=S.PAGE)
                v = KVC.paste_pages(v, KVC.unpack_kv(got.v, page=S.PAGE), p,
                                    page=S.PAGE)
    tail, moved = send(TailWire(cache.hot_k, cache.hot_v, logits))
    ledger.append(("TailWire", m // S.PAGE, moved))
    assembled = S.QuantCache(k, v, tail.hot_k, tail.hot_v)
    nxt = torch.argmax(tail.logits, -1).to(torch.int32).reshape(1, 1)
    stats = dict(wire_bytes=sum(b for *_, b in ledger), sends=len(ledger),
                 pages_streamed=len(ledger) - 1, ledger=ledger,
                 prefill_tokens=m)
    return StreamedPrefill(assembled, nxt, tail.logits, m, stats)

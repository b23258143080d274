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

Every slot is a batch-1 `QuantCache` with its position kept on the host,
and `generate_step` runs the live slots' batch-1 `serve_step`s in turn, so
each slot's logits are bit-identical to the single-request path at the
same position (the reference vmaps the batch-1 step over a slot axis).  One aligned
step over 4 slots is not bit-identical to their 4 batch-1 steps on the
card, so the batched step waits (ROADMAP A14), as does `stream_prefill`.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..compression import kv as KVC
from ..configs.base import ArchConfig
from ..core import audit as A
from ..core.config import QuantizerConfig
from ..core.pipeline import resolve_device
from ..core.transport import TRANSPORT, Transport
from . import serve as S


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
        self._cache = [self._new_cache() for _ in range(self.n_slots)]
        self._pos = [0] * self.n_slots       # host-side positions
        self._tok = [torch.zeros((1, 1), dtype=torch.int32,
                                 device=self.device)
                     for _ in range(self.n_slots)]
        self._logits = torch.zeros((self.n_slots, cfg.padded_vocab),
                                   device=self.device)
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
        """The single-request serve path, the bit-identity reference."""
        return S.serve_step(self.cfg, self.params, cache, token, pos, None,
                            self.kv_cfg)

    # --- slot lifecycle ---------------------------------------------------

    def allocate(self) -> Optional[int]:
        """Claim a free slot, or None when every slot is live."""
        for slot in range(self.n_slots):
            if self.requests[slot] is None:
                return slot
        return None

    def prefill(self, prompt) -> PrefillResult:
        """Run one request's prompt through the batch-1 `serve_step` chain
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
        self._cache[slot] = _clone_cache(cache1)
        self._pos[slot] = int(pos)
        self._tok[slot] = torch.as_tensor(next_token).to(
            device=self.device, dtype=torch.int32).reshape(1, 1).clone()
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
        for slot, on in enumerate(live):
            if not on:
                continue
            logits, _ = self.step_one(self._cache[slot], self._tok[slot],
                                      self._pos[slot])
            self._logits[slot] = logits[0]
            self._tok[slot] = torch.argmax(logits, -1).to(
                torch.int32).reshape(1, 1)
            self._pos[slot] += 1
        self._stats["steps"] += 1
        self._stats["generated_tokens"] += sum(live)
        return self._logits.clone(), torch.cat(self._tok).reshape(-1)

    def evict(self, slot: int) -> PrefillResult:
        """Pack `slot` back to the `PackedCache` wire and free it; the
        result re-`insert`s into any engine bit-exactly."""
        if self.requests[slot] is None:
            raise ValueError(f"slot {slot} is free")
        wire = S.pack_cache(self._cache[slot], stages=self.stages,
                            integrity=self.integrity is not None)
        out = PrefillResult(wire, self._tok[slot].clone(), None,
                            self._pos[slot])
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
        slots free, step every live slot, release finished ones.  Returns
        {request index: [generated token ids]}, `max_new_tokens` each,
        greedy."""
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

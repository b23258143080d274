#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--n N] [--seed S]

Builds the CUDA kernels of `src/repro_torch/kernels/csrc/` (pack.cu,
lossless.cu, dense.cu and kv_attention.cu, one nvcc each, in parallel) from
source, then runs twelve chains through `repro_torch.core.pipeline`
(`Pipeline.encode` -> `Encoded` -> `Pipeline.decode`) at n = 512**3
float32 values (the size of one SDRBench NYX field), with data made on the
card from `--seed`:

  * `rel:0.001|pack:16` on a NYX-like lognormal field, exp(1.4*N(0,1) + 8);
  * `noa:0.001|pack:16` on the same field;
  * `grad-wire-8` (`abs:1.0:cap=0.015625|pack:8`) on a gradient-like field,
    iid N(0,1)*3e-3, with a per-tensor bound eb = 2**-5 * rms(g) computed on
    the card and passed as a 0-d CUDA tensor;
  * `sci-rel-narrow` (`rel:0.001|pack:32|narrow`) on the NYX-like field;
  * `grad-wire-16-narrow` (`abs:1.0:cap=0.015625|pack:16|narrow`) on an
    embedding-table gradient, 8192 rows of n/8192 values, 1 % of the rows
    touched with N(0,1)*3e-3 and the rest exactly zero, eb = 2**-5 * rms;
  * `smoke-chain` (`rel:0.001|pack:8|zero|narrow`) on exp(0.02*N(0,1)), a
    field within a few % of 1 whose REL bins fit 8 bits;
  * `grad-wire-16-ent` and `grad-wire-pred` (`delta|...|pack:16|narrow|ent`)
    on the embedding gradient with eb = 2**-5 * rms;
  * `sci-rel-shuffle`, `sci-rel-ent` and `sci-lorenzo-ent` on the NYX-like
    field with pred_shape (512, 512, 512);
  * after the kv phase, `kv-delta` (`kvdelta|abs:1.0|pack:8|zero|narrow`)
    on batch row 0 of its K (one user's cache at 32K, 8 x 32768 x 128) as
    pages of 128 tokens, pred_shape (2048, 128, 128), eb = 2**-5 * rms(K).

The pred chains quantize with B8/B9 and decode with B10/B11; `shuffle`,
`ent`, the predictors and the checksum are torch ops, timed in each
line's `parts_ms`.  Every counted run also counts the calls, with a CUDA
tensor, of the plain quantizers and packed codec (`plain_calls`, 0).

An `audit` phase runs `encode(verify=True, integrity=True)` and
`decode(verify=True)` at full width on `rel:0.001|pack:16`, `grad-wire-8`,
`sci-rel-narrow`, `sci-lorenzo-ent` and `lorenzo|rel:0.001|pack:32|narrow`
(the one chain that takes B11 through the pipeline), holds the wire, the
checksum, the `Quantized` planes and the report against the plain path on
the card and requires `report.ok()`, and times verify=/integrity=, the
checksum and the audit reduction beside the plain encode and decode (the
dense kernels of these paths, B8/B9 and on pred decodes B10/B11, join the
kernel rows with their launches); then
`runtime.guard.detection_matrix` over all 13 presets at n = 2**20 (every
fault class detected, `nan_input` from the report of a NaN-corrupted
encode, the clean wire passing).

A `dense` phase drives the dense-layout entry points
(`kernels.ops.quantize_abs`, `quantize_rel`, `dequantize_abs` and
`kernels.dense.dequantize_rel`) at the same n: ABS on the gradient field
with the traced bound rms_eb(g), REL on the NYX-like field at 1e-3, each
decoded with the outliers' exact bits as payload.  A `kv` phase quantizes
a KV cache (`compression.kv.quantize_kv`) and runs the flash-decode
attention (`kernels.kv_attention.kv_decode_attention`) at internlm2-20b's
attention widths (8 KV heads, 6 query heads each, head dim 128) over a
decode_32k history (S = 32,768, page 128, cap 8), batch 32 (decode_32k's
128 cut so that K and V in float32, 4.3 GB each, fit one card beside the
check's copies); K and V are N(0,1)*0.7 with attention sinks, lengths are
drawn in [1, S] with one equal to S and one not a multiple of the page;
then one user at the full history (B = 1, batch row 0 of the same cache,
with one page of exact outlier values in K and V).

The first 64 values of each field are the paper's eight special values
(+inf, -inf, NaN, the NaN payload 0x7FC00123, +-1e-42, +-0.0), repeated.

For each chain it checks that the kernels of its path were launched on the
main path (every launch count is set to 0 just before the chain's encode
and decode and read just after), that every wire plane and every decoded
float is bit-equal to the plain torch reference run on the card, that
each kernel is bit-equal to its plain version on the main path's inputs,
that a small ragged input agrees with the numpy oracle, and that every
decoded value is within eb of its original or bit-identical to it
(checked in float64).  The dense phase holds the same: launches, every
plane bit-equal, 0 violations.  The kv phase checks that no page
overflows its outlier table, that every page meets its bound, that the
attention kernel is within rtol = atol = 2e-5 of its plain version (the
reference's own tolerance) at B = 32 and at B = 1, both split the same
way, and prints both outputs' errors against a float64 attention over the
same dequantized cache, the split (pages per split block, blocks launched,
blocks per SM) and the peak device memory.  A code-sweep phase
holds the four chunk-coder kernels bit for bit against their plain
versions on inputs where each chunk code covers at least 10 % of the
chunks, at pack 8, 16 and 32, a ragged n and both stages.  Each kernel is
timed as one call by CUDA events (median of 25 after warm-up, the
wrapper's host time included) beside its device time from a
`torch.profiler` trace (`device_ms`; their difference is the host's
share), its bound and its plain version (which repeats the kernel's
arithmetic and is no yardstick of speed); B1 and B3 also on a copy of x
one float past a 16-byte boundary (`offset1_ms`, `offset1_device_ms`,
the kernel's path for unaligned views, held against the plain version
too); the attention also beside one
`scaled_dot_product_attention` call over the dequantized float32 cache,
at B = 32 and at B = 1.  The kv line adds, under names of their own, both
timed over 10 calls in a row (a decode loop's view: the host's per-call
time hides under the device's), and the attention kernels' launches per
call from the trace.

A `serve` phase drives serving at internlm2-20b's full width and depth
(48 layers, 20.3G parameters in bf16 made on the card from the seed by
`models.model.ModelBundle.init`): (a) 8 requests of seeded tokens for
256 steps through `models.serve.serve_step` with the quantized cache
(B12 over the closed pages, 2 launches a layer once a page has closed)
and with the raw bf16 cache; every page a step closes held against the
bf16 hot page it came from (0 values outside the page bound, a wrapper
of `serve._quantize_page`), the quantized logits within 0.15 of the
raw ones' max, the `PackedCache` wire for `kv-page`, `kv-page-narrow`,
`kv-page-pred` and `auto` with checksums (B6 on pack, B7 on unpack),
each round trip bit-exact and its `wire_bytes` within 2^-23 of the bytes
counted from its planes, `transfer_cache` from rank 0 to rank 1 of a
2-thread axis bit-exact, 16 more steps on the received cache bit-equal
to 16 on the original, B12 with its (m, l) output within 2e-5 of its
plain version on layer 0's real q and cache, no plain version run on the
card (`plain_calls`); (b) `models.engine.DecodeEngine` with 2 slots over
3 requests (prompts of 130, 17 and 140 tokens, 8 new tokens each, one
evict -> insert), each slot's logits bit-identical to the batch-1
`serve_step` path, and whether an aligned step of 2 or 4 rows keeps the
batch-1 bits; (c) 4 requests at decode_32k's 32,768 tokens (its batch
128 cut to 4), every layer's closed pages from `quantize_kv` of seeded
K, V = N(0,1)*0.7, 5 steps from position 32,700: step time (CUDA events,
median of 5), B12's and the GEMMs' device time a step (`torch.profiler`),
the step's bytes bound, launches a step (96 of B12), peak memory.  The
weights are freed before the `grads` phase.

A `moe` phase drives the MoE family and head dim 80:
olmoe-1b-7b at full width and depth (16 layers, 64 experts, top-8,
6.82G parameters made on the card from the seed): (a) 8 requests for
256 steps at seq 512 through `serve_step`, quantized and raw, with the
checks of serve (a) (every closed page within its bound, quantized
logits within 0.15 of the raw ones' max, B12 with (m, l) within 2e-5 of
its plain version on layer 0's real queries, no plain call), the step
time, a profiled step by kernel kind (B12, GEMMs, the dispatch's
indexing), the bound with every expert read once and with the experts
the steps routed to, and the (token, k) pairs dropped past the capacity;
(b) the engine as in serve (b) (no aligned rows), then `stream_prefill`
of a 300-token prompt from rank 0 to rank 1 of a 2-thread axis, its
cache and 8 steps on it bit-identical to the source's, its wire ledger;
(c) serve (c)'s long context on olmoe; (d) `ModelBundle.prefill` over
32,768 tokens (time, peak memory, pairs dropped), a 256-token prefill's
last logits against 256 raw-cache decode steps within 0.15 with every
pair kept (the reference's capacity drops pairs that a batch-1 decode
step keeps; that gap is printed beside it), and `flash_attention` on
layer 0's real q, k, v at 4,096 tokens within 2^-8 |o| + 2^-8 max|v|
of a float32 softmax attention; (e) qwen3-moe-235b-a22b at full width,
4 of its 94 layers (128 experts, B12 at Hg = 16), 136 steps with the
checks of (a); (f) stablelm-3b at full width and depth (B12 at D = 80),
136 steps with the same checks.  Each model's weights are freed before
the next.

A `grads` phase drives the compressed gradient all-reduce
(`compression.grads.compressed_mean_tree` -> `compress_shard` ->
`core.transport.Transport.reduce_sum`) over the gradients of one
internlm2-20b decoder layer at full width (ln1, wq, wkv, wo, ln2, w1,
w3, w2: 390.1M float32 values a pod, made on the card from the seed as a
shared N(0,1)*3e-3 part plus a per-pod N(0,1)*1e-3 one), two pods as a
2-rank thread axis on the card (`core.axis.run_threads`), 2 steps with
error feedback at eb = 2**-5 * rms for `grad-wire-8`,
`grad-wire-16-narrow` and `pipeline="auto"` (the `grad-wire` selector
set).  Every pod's mean must be bit-equal to the plain result (each
pod's wire decoded with kernels=False, summed in rank order, over p),
every residual within eb in float64, each selector wire bit-equal to its
chosen chain's own wire, `wire_bytes` equal to the bytes counted from
the wire's planes, `plain_calls` 0.  Then a pair of wq leaves built for
the ring (3e-3 tanh(N(0,1)) and its negation: one grid, no outliers)
reduces through the ring and the gather, bit-equal, and the checked
reduces count p under no fault and p - 1 under `hop_bitflip` on the ring
and `payload_bitflip` on one gathered shard.  Each configuration's line
has its step times (one call by CUDA events, both pods' work on one
card), bytes moved against a float32 all-reduce, each leaf's branch,
the chain ids `auto` chose, max |residual|/eb, peak memory, launches per
step, and on w1 the times of one compress_shard and one decode (and for
`auto` its stats pass and every candidate's own wire bytes).

A `train` phase trains internlm2-20b at full width (d_model 6144, 48
heads over 8 KV heads of 128, d_ff 16384, vocab 92,544) on 2 of its 48
layers: 1.35G parameters made on the card from the seed, batch 8 x 512
from `data.pipeline.TokenPipeline`, AdamW at lr 1e-3 with a warmup of 2
for 6 steps.  (a) 6 steps of `launch.train.make_train_step`, then 6 each
of `make_train_step_compressed` with 2 pods as threads holding one state
(`shared_state=True`), eb = 2**-5 * rms, `grad-wire-8` and
`grad-wire-16-narrow`, every run from the same weights and batches.
Steps 1 and 6 are held leaf by leaf as the pods finish each: every pod's
mean bit-equal to the plain decode-and-sum of the wires the pods sent,
every residual within eb; every step has `plain_calls` 0 and a finite
loss.  Each line has the losses, the step time split into forward +
backward, compressed mean and optimizer (CUDA events, medians over the
steps not held), the step's bound (6 N tokens over the dense bf16 rate,
or the state read and written once over the HBM rate), bytes a step
against a float32 all-reduce, each leaf's branch, max |residual|/eb,
launches a step, a profiled step's kernels, busy time and B8/B6/B7/B2
device ms, and the peak memory; the full-precision line also the lossy
coder (`core.serializer`, ABS 1e-6) on layer 0's wq master.  (b) The
loop (`runtime.train_loop.run`, checkpoint_every=2) on the reduced
configuration: the shared-state step stopped by SIGTERM at step 3,
resumed by `resume_or_init` and run to 6, bit-identical to 6 straight
steps of the replica step with a raw checkpoint (its step-2 checkpoint
too) and within eb on every restored value with a lossy one;
each step also encodes a residual with verify=True and `AuditCounters`
must fold 6 reports with 0 violations.

Output: the card's name and power limit, one JSON line per chain, one
JSON line per phase (dense, audit, code sweep, kv, serve a/b/c, moe
a-f, grads, train),
one JSON line
{"kernels": [...]}, and last
{"ok": true, "device": {...}}.  On stderr: the build log and a summary of
its `-Xptxas -v` lines for the pack kernel (registers, stack, spills of
each instance).  Any failed check exits non-zero; with no CUDA device, or
outside a checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
N_DEFAULT = 512 ** 3
N_SWEEP = 3 * 2 ** 20 + 4099   # ragged: not a whole number of chunks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SPECIALS = np.array([np.inf, -np.inf, np.nan,
                     np.uint32(0x7FC00123).view(np.float32),
                     1e-42, -1e-42, 0.0, -0.0], dtype=np.float32)
CSRC = "src/repro_torch/kernels/csrc/"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "_abs_pack": ("pack.cu", "src/repro/kernels/pack.py:141"),
    "_rel_pack": ("pack.cu", "src/repro/kernels/pack.py:152"),
    "_abs_unpack": ("pack.cu", "src/repro/kernels/pack.py:168"),
    "_rel_unpack": ("pack.cu", "src/repro/kernels/pack.py:180"),
    "_abs_pack_lc": ("lossless.cu", "src/repro/kernels/lossless.py:110"),
    "_rel_pack_lc": ("lossless.cu", "src/repro/kernels/lossless.py:128"),
    "_lc_select": ("lossless.cu", "src/repro/kernels/lossless.py:100"),
    "_lc_expand": ("lossless.cu", "src/repro/kernels/lossless.py:106"),
    "_quantize_abs": ("dense.cu", "src/repro/kernels/quantize_abs.py:32"),
    "_quantize_rel": ("dense.cu", "src/repro/kernels/quantize_rel.py:41"),
    "_dequantize_abs": ("dense.cu", "src/repro/kernels/dequantize.py:21"),
    "_dequantize_rel": ("dense.cu", "src/repro/kernels/dequantize.py:35"),
    "_kv_decode_attention": ("kv_attention.cu",
                             "src/repro/kernels/kv_attention.py:39"),
}
# Operations per element (per word for _lc_select and _lc_expand), counted
# in csrc/: abs_quantize 2 mul, rint, sub, 2 conversions, 2 abs, 2
# compares; rel_quantize the same plus log2approx (add, conversion) and
# pow2approx (add, sub, 2 conversions) and the screen/tiny compares; the
# ABS unpack a conversion and a mul; the REL unpack a conversion, a mul and
# pow2approx.  The chunk select adds integer work the fused kernels hide
# under their float32 count; alone it is a max, 3 compares and 4
# shift/masks per word, the expand 4 shift/masks per word.  The dense
# kernels count as the pack ones, plus the recon (a conversion and a mul,
# REL also pow2approx) and the payload select.  Integer operations are
# counted against the float32 rate.  The bound is set by bytes whenever
# these are far under the card's rate over its HBM rate.
OPS_PER_ELEM = {"_abs_pack": 10, "_rel_pack": 16, "_abs_unpack": 2,
                "_rel_unpack": 6, "_abs_pack_lc": 10, "_rel_pack_lc": 16,
                "_lc_select": 8, "_lc_expand": 4, "_quantize_abs": 12,
                "_quantize_rel": 22, "_dequantize_abs": 3,
                "_dequantize_rel": 7}
# the kv phase: internlm2-20b's attention (src/repro/configs/registry.py:22,
# 48 query heads over 8 KV heads of 128) over the decode_32k history
# (src/repro/configs/base.py:159) at page 128, cap 8 (models/serve.py)
KV_G, KV_HG, KV_D, KV_S, KV_PAGE, KV_CAP = 8, 6, 128, 32_768, 128, 8
KV_BATCH = 32                  # decode_32k's 128 cut to fit one card
KV_TOL = 2e-5                  # rtol = atol: the reference's own tolerance
KV_BATCH_CALLS = 10            # attention calls in a row per timed sample


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def time_ms(fn, reps: int = 25, warm: int = 3, batch: int = 1) -> float:
    """Median time of one call of fn on the card, by CUDA events around
    `batch` calls in a row (with batch > 1 the host's time per call hides
    under the device's, as in a loop of decode steps)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def with_specials(f):
    spec = torch.from_numpy(np.tile(SPECIALS, 8).view(np.int32)).to(f.device)
    m = min(f.numel(), spec.numel())
    f.view(torch.int32)[:m] = spec[:m]
    return f


def make_fields(n: int, seed: int):
    """{name: float32 field on the card}, specials in the first 64."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nyx = torch.exp(torch.randn(n, generator=gen, device=DEV) * 1.4 + 8.0)
    grad = torch.randn(n, generator=gen, device=DEV) * 3e-3
    rows = 8192                     # benchmarks/datasets.py grad_sparse
    touched = torch.randperm(rows, generator=gen, device=DEV)[:rows // 100]
    emb = torch.zeros(rows, -(-n // rows), device=DEV)
    emb[touched] = torch.randn(touched.numel(), emb.shape[1], generator=gen,
                               device=DEV) * 3e-3
    near_one = torch.exp(torch.randn(n, generator=gen, device=DEV) * 0.02)
    return {k: with_specials(f.reshape(-1)[:n].contiguous())
            for k, f in (("nyx", nyx), ("grad", grad), ("emb", emb),
                         ("near_one", near_one))}


def rms_eb(g):
    """eb = 2**-5 * rms over the finite values, a 0-d tensor on the card."""
    finite = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    return 2.0 ** -5 * torch.sqrt(torch.mean(finite * finite))


def planes_equal(a, b) -> bool:
    """Bit equality of two wire planes (None matches None)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(planes_equal(u, v) for u, v in zip(a, b)))
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def violations(x, y, eb64: float, rel: bool) -> int:
    """Values neither bit-identical to their original nor within eb (REL:
    eb*|x|), counted in float64 on the card."""
    same = x.view(torch.int32) == y.view(torch.int32)
    x64, y64 = x.double(), y.double()
    bound = eb64 * x64.abs() if rel else torch.full_like(x64, eb64)
    within = torch.isfinite(x64) & ((x64 - y64).abs() <= bound)
    return int((~(same | within)).sum())


def kernel_bytes(name: str, n: int, bits: int = 32, hist=None) -> int:
    """Least bytes: each input read once, each output written once.  n is
    the element count for the pack and unpack kernels and the word count
    entering the stage for _lc_select and _lc_expand; `hist` (the chunk
    code counts of this run) gives the rows _lc_expand must read."""
    from repro_torch.core import codec as C
    words = 4 * C.packed_word_count(n, bits)
    signs = 4 * C.packed_word_count(n, 1)
    chunks = C.lc_chunk_count(C.packed_word_count(n, bits))
    image = 4 * chunks * C.LC_CHUNK + 4 * chunks      # sel + int32 codes
    stage_chunks = C.lc_chunk_count(n)
    if name == "_lc_select":
        return 4 * n + 4 * stage_chunks * C.LC_CHUNK + 4 * stage_chunks
    if name == "_lc_expand":
        rows = hist[1] + 2 * hist[2] + 4 * hist[3]
        return 4 * stage_chunks + 4 * C.PACK_LANES * rows + 4 * n
    return {"_abs_pack": 4 * n + 4 + words + n,
            "_rel_pack": 4 * n + words + n + signs,
            "_abs_unpack": words + 4 + 4 * n,
            "_rel_unpack": words + signs + 4 * n,
            "_abs_pack_lc": 4 * n + 4 + n + image,
            "_rel_pack_lc": 4 * n + n + signs + image,
            "_quantize_abs": 4 * n + 4 + 4 * n + n + 4 * n,
            "_quantize_rel": 4 * n + 4 * n + n + 4 * n + n,
            "_dequantize_abs": 4 * n + 4 * n + n + 4 + 4 * n,
            "_dequantize_rel": 4 * n + 4 * n + n + n + 4 * n}[name]


def bound_from(n_bytes: float, ops: float):
    """(least ms, what sets it): bytes over the HBM rate or operations over
    the float32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_of(name: str, n: int, bits: int, hist=None):
    return bound_from(kernel_bytes(name, n, bits, hist),
                      OPS_PER_ELEM[name] * n)


def kv_work(lengths, b: int, hg: int, s: int = KV_S, g: int = KV_G,
            d: int = KV_D):
    """(bytes, operations) of B12 on this run's lengths: the pages it reads
    (those holding a token < lengths[b]) with their int8 K and V tiles, eb2
    and cap (idx, val) slots, q and the output once, the lengths; per token
    read, 4*Hg*D for the scores and p v, 2*D dequantize muls, Hg exps."""
    pages = int((torch.div(lengths.long().clamp(min=0) + KV_PAGE - 1,
                           KV_PAGE, rounding_mode="floor")
                 .clamp(max=s // KV_PAGE)).sum()) * g
    per_page = 2 * (KV_PAGE * d + 4 + KV_CAP * 8)
    n_bytes = pages * per_page + 2 * 4 * b * g * hg * d + 4 * b
    tokens = pages * KV_PAGE
    return n_bytes, tokens * (4 * hg * d + 2 * d + hg)


def max_abs_err(a, b) -> float:
    """Largest difference between a kernel's output and its plain
    version's: float planes as values (NaN matching NaN, an infinity
    itself), int planes as uint32, bool planes as 0/1."""
    if a.dtype.is_floating_point:
        a64, b64 = a.double(), b.double()
        same = (a64 == b64) | (torch.isnan(a64) & torch.isnan(b64))
        d = torch.where(same, torch.zeros_like(a64), (a64 - b64).abs())
        d = torch.nan_to_num(d, nan=float("inf"))
    else:
        d = ((a.to(torch.int64) & 0xFFFFFFFF)
             - (b.to(torch.int64) & 0xFFFFFFFF)).abs()
    return float(d.max()) if d.numel() else 0.0


def ptxas_summary(log: str) -> dict:
    """{"<bits>,<rel>": {registers, stack, spill_stores, spill_loads}} of
    every instance of pack_kernel in the build log's `-Xptxas -v` lines."""
    entry = re.compile(r"Compiling entry function "
                       r"'\w*?11pack_kernelILi(\d+)ELb([01])E")
    out, key = {}, None
    for line in log.splitlines():
        m = entry.search(line)
        if m:
            key = f"{m.group(1)},{'rel' if m.group(2) == '1' else 'abs'}"
            continue
        if key is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            out[key] = dict(zip(("stack", "spill_stores", "spill_loads"),
                                map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[key]["registers"] = int(regs.group(1))
            key = None
    return out


def _kernel_modules():
    from repro_torch.kernels import dense, kv_attention, lossless, pack
    return pack, lossless, dense, kv_attention


def launches():
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


def reset_launches():
    for m in _kernel_modules():
        m.reset_launches()


def stage_codes(pipe, enc, n: int):
    """Per word stage, from its header plane: the int32 chunk codes of a
    zero/narrow stage, the chunk modes of an ent stage, None for shuffle."""
    from repro_torch.core import codec as C
    from repro_torch.core.pipeline import ChunkStage, EntStage
    out = []
    for st, h, sz in zip(pipe.stages, enc.headers, pipe.stage_sizes(n)):
        nc = C.lc_chunk_count(sz)
        if isinstance(st, ChunkStage):
            out.append(C.unpack_words(h, nc, 2, signed=False))
        elif isinstance(st, EntStage):
            lo = C.packed_word_count(C.ENT_SYMS, 4)
            out.append(C.unpack_words(h[lo:lo + C.packed_word_count(nc, 2)],
                                      nc, 2, signed=False))
        else:
            out.append(None)
    return out


def hist_of(codes):
    if codes is None:
        return None
    return [int(v) for v in torch.bincount(codes.to(torch.int64),
                                           minlength=4).cpu()]


def fused_lc(pipe) -> bool:
    return pipe.kernel_dispatch().endswith("encode_packed_lc")


def first_words(pipe, x, eb, eb_arr, shape):
    """The word plane entering the chain's first word stage, made on the
    kernel path (B8/B9 and the pred transform for a pred chain, else B1 or
    B3), and the outlier plane."""
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import pack as K
    cfg, n = pipe.qcfg(), x.numel()
    if pipe.pred:
        ep, qt = D.encode_packed(x, cfg, eb, bin_transform=pipe._bin_transform(
            shape, n))
        return ep.words, qt.outlier
    if pipe.quant.mode == "rel":
        words, outlier, _ = K.rel_pack(x, cfg)
    else:
        words, outlier = K.abs_pack(x, eb_arr, cfg)
    return words, outlier


def path_calls(pipe, enc, x, eb, eb_arr, n: int, shape):
    """[(kernel, label, n or words, hist, kernel call, plain call)] on the
    main path's inputs of every kernel the chain's encode and decode
    launch, in path order."""
    from repro_torch.core import codec as C
    from repro_torch.core.pipeline import ChunkStage
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import lossless as L
    from repro_torch.kernels import pack as K
    cfg, bits, rel = pipe.qcfg(), pipe.pack.bits, pipe.quant.mode == "rel"
    calls = []
    if pipe.pred:                       # B8/B9, the dense quantizers
        if rel:
            calls.append(("_quantize_rel", "", n, None,
                          lambda: tuple(D.quantize_rel(x, cfg)),
                          lambda: tuple(D._quantize_rel_plain(x, cfg))))
        else:
            calls.append(("_quantize_abs", "", n, None,
                          lambda: tuple(D.quantize_abs(x, cfg, eb=eb_arr)[:3]),
                          lambda: tuple(D._quantize_abs_plain(x, eb_arr,
                                                              cfg)[:3])))
    elif fused_lc(pipe):
        stage = pipe.stages[0].mode
        if rel:
            calls.append(("_rel_pack_lc", stage, n, None,
                          lambda: L.rel_pack_lc(x, cfg, stage),
                          lambda: L._rel_pack_lc_plain(x, cfg, stage)))
        else:
            calls.append(("_abs_pack_lc", stage, n, None,
                          lambda: L.abs_pack_lc(x, eb_arr, cfg, stage),
                          lambda: L._abs_pack_lc_plain(x, eb_arr, cfg, stage)))
    elif rel:
        calls.append(("_rel_pack", "", n, None, lambda: K.rel_pack(x, cfg),
                      lambda: K._rel_pack_plain(x, cfg)))
    else:
        calls.append(("_abs_pack", "", n, None,
                      lambda: K.abs_pack(x, eb_arr, cfg),
                      lambda: K._abs_pack_plain(x, eb_arr, cfg)))
    sizes = pipe.stage_sizes(n)
    codes = stage_codes(pipe, enc, n)
    if not fused_lc(pipe):              # the select kernel per chunk stage
        cur = first_words(pipe, x, eb, eb_arr, shape)[0]
        for i, st in enumerate(pipe.stages):
            if isinstance(st, ChunkStage):
                calls.append(("_lc_select", f"{i}:{st.mode}", sizes[i], None,
                              lambda w=cur, s=st.mode: L.lc_select(w, s),
                              lambda w=cur, s=st.mode:
                              L._lc_select_plain(w, s)))
            cur = st.encode_words(cur, sizes[i], kernels=True)[1]
    cur = enc.payload                   # decode: the stages in reverse
    for i in reversed(range(len(pipe.stages))):
        st, m = pipe.stages[i], sizes[i]
        if isinstance(st, ChunkStage):
            padded = C.lc_gather_chunks(cur, codes[i]).reshape(-1)
            calls.append(("_lc_expand", f"{i}:{st.mode}", m, hist_of(codes[i]),
                          lambda p=padded, c=codes[i], m=m: L.lc_expand(p, c, m),
                          lambda p=padded, c=codes[i], m=m:
                          L._lc_expand_plain(p, c, m)))
        cur = st.decode_words(enc.headers[i], cur, m, kernels=True)
    words = cur
    if pipe.pred:                       # B10/B11 on the dense planes
        bins = pipe._bin_untransform(shape, n)(C.unpack_words(words, n, bits))
        outlier, payload = C.outlier_planes(n, enc.out_idx, enc.out_payload)
        if rel:
            sign = C.unpack_flags(enc.sign_words, n)
            calls.append(("_dequantize_rel", "", n, None,
                          lambda: D.dequantize_rel(bins, payload, outlier,
                                                   sign, cfg),
                          lambda: D._dequantize_rel_plain(bins, payload,
                                                          outlier, sign, cfg)))
        else:
            calls.append(("_dequantize_abs", "", n, None,
                          lambda: D.dequantize_abs(bins, payload, outlier,
                                                   cfg, eb=eb_arr),
                          lambda: D._dequantize_abs_plain(bins, payload,
                                                          outlier, eb_arr,
                                                          cfg)))
    elif rel:
        calls.append(("_rel_unpack", "", n, None,
                      lambda: K.rel_unpack(words, enc.sign_words, n, cfg),
                      lambda: K._rel_unpack_plain(words, enc.sign_words, n,
                                                  cfg)))
    else:
        calls.append(("_abs_unpack", "", n, None,
                      lambda: K.abs_unpack(words, eb_arr, n, cfg),
                      lambda: K._abs_unpack_plain(words, eb_arr, n, cfg)))
    return calls


def oracle_check(pipe, x, eb) -> None:
    """A small ragged slice through the kernels against the numpy oracle
    (a pred chain's codes inverted first, with the slice's flat shape)."""
    from repro_torch.core import codec as C
    from repro_torch.core import oracle_np
    from repro_torch.core import predict as P
    cfg = pipe.qcfg()
    xs = x[:4099].contiguous()
    m = xs.numel()
    enc = pipe.encode(xs, eb, device=DEV, pred_shape=(m,))
    words = pipe.decode_words(enc.headers, enc.payload, pipe.n_words(m),
                              kernels=True)
    bins = C.unpack_words(words.cpu(), m, cfg.bin_bits)
    bins = P.decode_pred_stages(pipe.pred, bins, (m,), cfg.bin_bits).numpy()
    xn = xs.cpu().numpy()
    if cfg.mode == "rel":
        ob, oo, _, osign = oracle_np.quantize_rel(xn, cfg)
        sign = C.unpack_flags(enc.sign_words.cpu(), m).numpy()
        check(np.array_equal(sign, osign), "oracle: REL sign plane")
    elif cfg.mode == "noa":
        ob, oo, _, oeb = oracle_np.quantize_noa(xn, cfg)
        check(np.float32(oeb).view(np.uint32)
              == enc.eb.cpu().numpy().view(np.uint32), "oracle: NOA eb")
    else:
        eb_o = None if eb is None else np.float32(eb.item())
        ob, oo, _ = oracle_np.quantize_abs(xn, cfg, eb=eb_o)
    check(np.array_equal(bins, ob), f"oracle: bins of {pipe.spec()}")
    k = cfg.outlier_cap(m)
    want = np.full(k, m, np.int32)
    first = np.nonzero(oo)[0][:k]
    want[:first.size] = first
    check(np.array_equal(enc.out_idx.cpu().numpy(), want),
          f"oracle: outlier table of {pipe.spec()}")


# the plain versions that a card path must not call: the packed codec with
# its chunk coder, and the quantizers (the packed phases) or B12 (the serve
# path, where quantize_kv is torch ops by design: B8 is not on it)
CODEC_PLAIN_FNS = tuple(("core.codec", f) for f in (
    "encode_packed", "decode_packed", "encode_words_lc",
    "decode_words_lc")) + (("kernels.lossless", "_lc_select_plain"),
                           ("kernels.lossless", "_lc_expand_plain"))
PLAIN_FNS = tuple(("core.quantizer", f) for f in (
    "quantize_abs", "quantize_rel", "quantize_noa", "dequantize_abs",
    "dequantize_rel")) + CODEC_PLAIN_FNS
SERVE_PLAIN_FNS = (("kernels.kv_attention", "_kv_decode_attention_plain"),
                   *CODEC_PLAIN_FNS)


@contextlib.contextmanager
def plain_calls(names=PLAIN_FNS):
    """Count the calls, with a CUDA tensor, of the plain functions `names`
    ((module under repro_torch, name) pairs) while the block runs (the
    card's paths take none)."""
    import importlib
    count = {"calls": 0}
    saved = []
    for path, name in names:
        mod = importlib.import_module(f"repro_torch.{path}")
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, **kw):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                count["calls"] += 1
            return _fn(*args, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        yield count
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def kernel_row(name, label, chain, bits, size, hist, kern, plain, count):
    """Hold one kernel against its plain version and time both."""
    outs_k, outs_p = as_tuple(kern()), as_tuple(plain())
    match = len(outs_k) == len(outs_p) and all(
        planes_equal(a, b) for a, b in zip(outs_k, outs_p))
    err = max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p))
    check(match, f"{chain}: {name} ({label}) differs from its plain version")
    bound_ms, bound_by = bound_of(name, size, bits, hist)
    ms = time_ms(kern)
    _, dev_ms = device_kernels(kern, reps=10)
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "chain": chain, "stage": label,
            "bits": bits, "launches": count, "max_abs_err": err,
            "tolerance": 0.0, "match": match, "ms": ms,
            "device_ms": sum(dev_ms.values()) or None,
            "device_ms_by_kernel": dev_ms,
            "plain_ms": time_ms(plain, reps=10, warm=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms, "library_ms": None,
            "bytes": kernel_bytes(name, size, bits, hist)}


def offset1_row(pipe, x, eb_arr, label: str) -> dict:
    """B1 or B3 on the chain's x copied to a view one float past a 16-byte
    boundary (the pack kernel's strided path), held against its plain
    version and timed as the aligned row is."""
    from repro_torch.kernels import pack as K
    cfg = pipe.qcfg()
    xo = torch.empty(x.numel() + 1, device=DEV)[1:]
    xo.copy_(x)
    if pipe.quant.mode == "rel":
        kern, plain = (lambda: K.rel_pack(xo, cfg),
                       lambda: K._rel_pack_plain(xo, cfg))
    else:
        kern, plain = (lambda: K.abs_pack(xo, eb_arr, cfg),
                       lambda: K._abs_pack_plain(xo, eb_arr, cfg))
    check(all(planes_equal(a, b) for a, b in zip(kern(), plain())),
          f"{label}: the pack kernel on an unaligned view differs from its "
          "plain version")
    _, dev_ms = device_kernels(kern, reps=10)
    return {"offset1_ms": time_ms(kern),
            "offset1_device_ms": sum(dev_ms.values()) or None}


def chain_parts(pipe, enc, x, eb, eb_arr, shape, t: dict) -> dict:
    """Where the end-to-end time goes: the kernels (t: kernel -> one-call
    ms) and the torch ops around them, each timed as one call on the
    chain's own planes: NOA's range, the outlier table, the pred transform
    and the pack of a pred chain, each word stage (the chunk compaction,
    shuffle, ent encode; on decode the gather, unshuffle, ent decode), and
    the decode's unpack, pred inverse and outlier planes or scatter."""
    from repro_torch.core import codec as C
    from repro_torch.core import predict as P
    from repro_torch.core import quantizer as Q
    from repro_torch.core.pipeline import ChunkStage, EntStage, ShuffleStage
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import lossless as L
    cfg, n, bits = pipe.qcfg(), x.numel(), pipe.pack.bits
    rel = pipe.quant.mode == "rel"
    sizes, codes = pipe.stage_sizes(n), stage_codes(pipe, enc, n)
    parts = {k: 0.0 for k in (
        "encode_kernel", "value_range", "outlier_table", "select_kernel",
        "compaction", "gather", "expand_kernel", "decode_kernel", "scatter")}

    def add(key, ms):
        parts[key] = parts.get(key, 0.0) + ms

    add("encode_kernel", sum(t.get(k, 0.0) for k in (
        "_abs_pack", "_rel_pack", "_abs_pack_lc", "_rel_pack_lc",
        "_quantize_abs", "_quantize_rel")))
    add("select_kernel", t.get("_lc_select", 0.0))
    add("expand_kernel", t.get("_lc_expand", 0.0))
    add("decode_kernel", sum(t.get(k, 0.0) for k in (
        "_abs_unpack", "_rel_unpack", "_dequantize_abs", "_dequantize_rel")))
    if cfg.mode == "noa":
        add("value_range", time_ms(lambda: Q.value_range_eb(x, cfg)))
    if fused_lc(pipe):
        st = pipe.stages[0].mode
        out = (L.rel_pack_lc(x, cfg, st) if rel
               else L.abs_pack_lc(x, eb_arr, cfg, st))
        outlier, sel, codes0 = out[0], out[-2], out[-1]
        add("compaction", time_ms(lambda: (
            C.lc_compact_payload(sel.reshape(-1, C.LC_CHUNK), codes0),
            C.pack_words(codes0, 2))))
        del out, sel, codes0
    else:
        cur, outlier = first_words(pipe, x, eb, eb_arr, shape)
        for i, st in enumerate(pipe.stages):
            if isinstance(st, ChunkStage):
                sel, codes0 = L.lc_select(cur, st.mode)
                add("compaction", time_ms(lambda s=sel, c=codes0: (
                    C.lc_compact_payload(s.reshape(-1, C.LC_CHUNK), c),
                    C.pack_words(c, 2))))
                del sel, codes0
            elif isinstance(st, ShuffleStage):
                add("shuffle", time_ms(lambda w=cur, s=st:
                                       C.shuffle_words(w, s.width)))
            elif isinstance(st, EntStage):
                add("ent_encode", time_ms(lambda w=cur: C.encode_words_ent(w),
                                          reps=5, warm=1))
            cur = st.encode_words(cur, sizes[i], kernels=True)[1]
        del cur
    add("outlier_table", time_ms(lambda: C.outlier_table(
        x, outlier, cfg.outlier_cap(n))))
    del outlier
    if pipe.pred:
        qt = (D.quantize_rel(x, cfg) if rel
              else D.quantize_abs(x, cfg, eb=eb_arr))
        transform = pipe._bin_transform(shape, n)
        add("pred_encode", time_ms(lambda: transform(qt.bins), reps=10))
        pred_bins = transform(qt.bins)
        add("pack_words", time_ms(lambda: (
            C.pack_words(pred_bins, bits),
            None if qt.sign is None else C.pack_flags(qt.sign)), reps=10))
        del qt, pred_bins
    cur = enc.payload
    for i in reversed(range(len(pipe.stages))):
        st, m, hdr = pipe.stages[i], sizes[i], enc.headers[i]
        if isinstance(st, ChunkStage):
            add("gather", time_ms(lambda p=cur, c=codes[i]:
                                  C.lc_gather_chunks(p, c)))
        elif isinstance(st, ShuffleStage):
            add("unshuffle", time_ms(lambda p=cur, s=st, m=m:
                                     C.unshuffle_words(p, m, s.width)))
        elif isinstance(st, EntStage):
            add("ent_decode", time_ms(lambda p=cur, h=hdr, m=m:
                                      C.decode_words_ent(h, p, m),
                                      reps=5, warm=1))
        cur = st.decode_words(hdr, cur, m, kernels=True)
    if pipe.pred:
        add("unpack_words", time_ms(lambda: C.unpack_words(cur, n, bits)))
        codes_plane = C.unpack_words(cur, n, bits)
        untransform = pipe._bin_untransform(shape, n)
        add("pred_decode", time_ms(lambda: untransform(codes_plane), reps=10))
        add("outlier_planes", time_ms(lambda: C.outlier_planes(
            n, enc.out_idx, enc.out_payload)))
        del codes_plane
    else:
        buf = torch.empty(n + 1, device=DEV)
        add("scatter", time_ms(lambda: C.scatter_outliers_(
            buf, n, enc.out_idx, enc.out_payload)))
        del buf
    return parts


def run_chain(label: str, spec: str, x, eb, shape=None):
    """One chain through `Pipeline.encode`/`decode` on the card (pred_shape
    `shape`), held against the plain path on the card, the numpy oracle
    and the bound; prints its line and returns its kernel rows."""
    from repro_torch.core.pipeline import parse_pipeline
    pipe = parse_pipeline(spec)
    cfg, n, rel = pipe.qcfg(), x.numel(), pipe.quant.mode == "rel"
    torch.cuda.reset_peak_memory_stats()
    # warm-up (builds the library on first use), then the counted run
    pipe.decode(pipe.encode(x, eb, device=DEV, pred_shape=shape), n=n,
                device=DEV, pred_shape=shape)
    torch.cuda.synchronize()
    reset_launches()
    with plain_calls() as plain:
        enc = pipe.encode(x, eb, device=DEV, pred_shape=shape)
        y = pipe.decode(enc, n=n, device=DEV, pred_shape=shape)
        torch.cuda.synchronize()
    counts = launches()
    check(plain["calls"] == 0,
          f"{label}: the card's path called a plain quantizer or codec")

    ref = pipe.encode(x, eb, device=DEV, kernels=False, pred_shape=shape)
    y_ref = pipe.decode(ref, n=n, device=DEV, kernels=False, pred_shape=shape)
    for f in enc._fields:
        check(planes_equal(getattr(enc, f), getattr(ref, f)),
              f"{label}: wire plane {f} differs from the plain reference")
    check(planes_equal(y, y_ref), f"{label}: decoded floats differ")
    wire_bits = pipe.wire_bits(enc, n)
    ref_bits = pipe.wire_bits(ref, n)
    wire_bits = float(wire_bits) if torch.is_tensor(wire_bits) else wire_bits
    ref_bits = float(ref_bits) if torch.is_tensor(ref_bits) else ref_bits
    check(wire_bits == ref_bits, f"{label}: wire_bits differ")
    del ref, y_ref
    check(not bool(enc.overflow), f"{label}: outlier table overflowed")
    eb_used = enc.eb if enc.eb is not None else torch.tensor(cfg.error_bound)
    eb64 = float(eb_used.float().item())
    bad = violations(x, y, eb64, rel)
    check(bad == 0, f"{label}: {bad} values violate the bound")
    del y
    oracle_check(pipe, x, eb)

    eb_arr = eb_used.to(device=DEV, dtype=torch.float32).reshape(1)
    calls = path_calls(pipe, enc, x, eb, eb_arr, n, shape)
    for name in {c[0] for c in calls}:
        check(counts[name] > 0,
              f"{label}: {name} not launched on the main path")
    rows = [kernel_row(name, lab, label, pipe.pack.bits, size, hist, kern,
                       plain, counts[name])
            for name, lab, size, hist, kern, plain in calls]
    del calls
    for r in rows:
        if r["name"] in ("_abs_pack", "_rel_pack"):
            r.update(offset1_row(pipe, x, eb_arr, label))
    t = {}
    for r in rows:
        t[r["name"]] = t.get(r["name"], 0.0) + r["ms"]
    parts = chain_parts(pipe, enc, x, eb, eb_arr, shape, t)
    heavy = any(s.spec() == "ent" for s in pipe.stages)
    reps = 5 if heavy else 10
    enc_ms = time_ms(lambda: pipe.encode(x, eb, device=DEV, pred_shape=shape),
                     reps=reps, warm=1)
    dec_ms = time_ms(lambda: pipe.decode(enc, n=n, device=DEV,
                                         pred_shape=shape), reps=reps, warm=1)
    codes = stage_codes(pipe, enc, n)
    print(json.dumps({
        "chain": label, "spec": pipe.spec(), "n": n,
        "pred_shape": None if shape is None else list(shape),
        "ratio": 32 * n / wire_bits, "wire_bits": wire_bits,
        "wire_bytes": wire_bits / 8, "payload_len": int(enc.payload_len),
        "capacity_words": enc.payload.numel(),
        "codes_hist": [hist_of(c) for c in codes],
        "codes_of": [s.spec() for s in pipe.stages],
        "n_outliers": int(enc.n_outliers), "overflow": bool(enc.overflow),
        "eb": eb64, "violations": bad,
        "encode_ms": enc_ms, "decode_ms": dec_ms,
        "encode_GBps": 4 * n / enc_ms / 1e6, "decode_GBps": 4 * n / dec_ms / 1e6,
        "parts_ms": parts,
        "plain_calls": plain["calls"],
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {k: counts[k] for k in sorted({r["name"] for r in rows})}}),
        flush=True)
    return rows


def sweep_field(n: int, bits: int, rel: bool, cfg, gen):
    """Float32 values on the card whose packed words give chunk codes 0, 1,
    2, 3 in turn, chunk by chunk (stage narrow): class 1 keeps every word
    < 2^8, class 2 every word < 2^16, class 3 has words >= 2^16 or with
    bit 31 set.  ABS values are bin*eb2, REL values
    +-pow2approx(bin*log_step): both quantize back to the bin exactly."""
    from repro_torch.core.bitops import pow2approx
    vpw = 32 // bits
    row = torch.arange(n, device=DEV) // 128
    cls = (row // (4 * vpw)) % 4
    field = row % vpw
    big = 100_000 if rel else 1 << 23
    # (lowest bin, highest bin, fields of the word that may be nonzero)
    spans = {8: ((-100, 100, 1), (-100, 100, 2), (-100, 100, 4)),
             16: ((0, 255, 1), (-30000, 30000, 1), (-30000, 30000, 2)),
             32: ((0, 255, 1), (256, 65535, 1), (-big, big, 1))}[bits]
    bins = torch.zeros(n, dtype=torch.int64, device=DEV)
    for k, (lo, hi, nf) in enumerate(spans, start=1):
        r = torch.randint(lo, hi + 1, (n,), generator=gen, device=DEV)
        bins = torch.where((cls == k) & (field < nf), r, bins)
    if rel:
        _, log_step, _ = cfg.rel_constants()
        mag = pow2approx((bins * float(log_step)).to(torch.float32))
        neg = torch.randint(0, 2, (n,), generator=gen, device=DEV) == 1
        x = torch.where(neg, -mag, mag)
    else:
        _, eb2, _ = cfg.abs_constants()
        x = (bins * float(eb2)).to(torch.float32)
    return with_specials(x.contiguous())


def sweep_words(n_words: int, gen):
    """A word plane whose chunks cycle through all-zero, bytes, shorts,
    full words and bytes with one word that has bit 31 set."""
    from repro_torch.core import codec as C
    chunk = torch.arange(n_words, device=DEV) // C.LC_CHUNK
    kind = chunk % 5
    r = torch.randint(-2 ** 31, 2 ** 31, (n_words,), generator=gen,
                      device=DEV, dtype=torch.int64)
    w = torch.where(kind == 1, r & 0xFF,
                    torch.where(kind == 2, r & 0xFFFF,
                                torch.where(kind == 3, r,
                                            torch.where(kind == 4, r & 0xFF,
                                                        0))))
    last = (torch.arange(n_words, device=DEV) % C.LC_CHUNK) == C.LC_CHUNK - 1
    w = torch.where((kind == 4) & last, -16, w)
    return w.to(torch.int32)


def code_sweep(seed: int):
    """The four chunk-coder kernels against their plain versions on the
    code-sweep inputs, at pack 8/16/32, a ragged n and both stages."""
    from repro_torch.core import codec as C
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.kernels import lossless as L
    from repro_torch.kernels import pack as K
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    eb_arr = torch.full((1,), 2.0 ** -7, device=DEV)
    held, hists = 0, {}

    def hold(name, what, kern_out, plain_out):
        nonlocal held
        ok = all(planes_equal(a, b) for a, b in zip(as_tuple(kern_out),
                                                    as_tuple(plain_out)))
        check(ok, f"code sweep: {name} ({what}) differs from its plain version")
        held += 1

    for bits in (8, 16, 32):
        for mode in ("abs", "rel"):
            cfg = QuantizerConfig(mode=mode, error_bound=2.0 ** -7
                                  if mode == "abs" else 1e-3, bin_bits=bits)
            x = sweep_field(N_SWEEP, bits, mode == "rel", cfg, gen)
            n_words = C.packed_word_count(N_SWEEP, bits)
            words = (K.rel_pack(x, cfg) if mode == "rel"
                     else K.abs_pack(x, eb_arr, cfg))[0]
            for stage in ("zero", "narrow"):
                what = f"{mode} pack:{bits} {stage}"
                if mode == "rel":
                    out = L.rel_pack_lc(x, cfg, stage)
                    hold("_rel_pack_lc", what, out,
                         L._rel_pack_lc_plain(x, cfg, stage))
                else:
                    out = L.abs_pack_lc(x, eb_arr, cfg, stage)
                    hold("_abs_pack_lc", what, out,
                         L._abs_pack_lc_plain(x, eb_arr, cfg, stage))
                sel, codes = out[-2], out[-1]
                hist = hist_of(codes)
                hists[what] = hist
                want = (1, 2, 3) if stage == "narrow" else (3,)
                check(all(hist[c] >= 0.1 * codes.numel() for c in (0, *want)),
                      f"code sweep: {what} codes {hist} miss a code")
                hold("_lc_select", what, L.lc_select(words, stage),
                     L._lc_select_plain(words, stage))
                back = L.lc_expand(sel, codes, n_words)
                hold("_lc_expand", what, back,
                     L._lc_expand_plain(sel, codes, n_words))
                check(planes_equal(back, words),
                      f"code sweep: {what} expand does not invert select")
    n_words = 3 * 4096 * C.LC_CHUNK // 128 + 129       # ragged word plane
    words = sweep_words(n_words, gen)
    for stage in ("zero", "narrow"):
        sel, codes = L.lc_select(words, stage)
        hold("_lc_select", f"words {stage}", (sel, codes),
             L._lc_select_plain(words, stage))
        hists[f"words {stage}"] = hist_of(codes)
        back = L.lc_expand(sel, codes, n_words)
        hold("_lc_expand", f"words {stage}", back,
             L._lc_expand_plain(sel, codes, n_words))
        check(planes_equal(back, words), f"code sweep: words {stage} roundtrip")
    print(json.dumps({"phase": "code-sweep", "n": N_SWEEP, "held": held,
                      "codes_hist": hists}), flush=True)

def dense_phase(f) -> list:
    """B8-B11 on their main path, the dense entry points
    (`kernels.ops.quantize_abs/quantize_rel/dequantize_abs` and
    `kernels.dense.dequantize_rel`) at n = 512**3: ABS on the gradient
    field with the traced bound rms_eb(g) as a 0-d CUDA tensor, REL on the
    NYX-like field at 1e-3, each decoded with x's bits as the outlier
    payload.  Every plane bit-equal to the plain version on the card, and
    0 bound violations in float64."""
    from repro_torch.core.bitops import float_to_bits
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import ops
    xa, xr = f["grad"], f["nyx"]
    n = xa.numel()
    eb = rms_eb(xa)
    eb_arr = eb.reshape(1)
    acfg = QuantizerConfig(mode="abs", error_bound=1e-3, bin_bits=16)
    rcfg = QuantizerConfig(mode="rel", error_bound=1e-3, bin_bits=16)
    zero = torch.zeros((), dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    reset_launches()
    qa = ops.quantize_abs(xa, acfg, eb=eb)
    qr = ops.quantize_rel(xr, rcfg)
    pa = torch.where(qa.outlier, float_to_bits(xa), zero)
    pr = torch.where(qr.outlier, float_to_bits(xr), zero)
    ya = ops.dequantize_abs(qa.bins, pa, qa.outlier, acfg, eb=eb)
    yr = D.dequantize_rel(qr.bins, pr, qr.outlier, qr.sign, rcfg)
    torch.cuda.synchronize()
    counts = launches()

    eb64 = float(eb.item())
    bad_a = violations(xa, ya, eb64, False)
    bad_r = violations(xr, yr, rcfg.error_bound, True)
    check(bad_a == 0 and bad_r == 0,
          f"dense: {bad_a} ABS and {bad_r} REL values violate the bound")
    for qt, y, what in ((qa, ya, "ABS"), (qr, yr, "REL")):
        check(planes_equal(torch.where(qt.outlier, qt.recon, y), qt.recon),
              f"dense: {what} decode differs from the encoder's recon")
    calls = [
        ("_quantize_abs", lambda: tuple(ops.quantize_abs(xa, acfg, eb=eb)[:3]),
         lambda: tuple(D._quantize_abs_plain(xa, eb_arr, acfg)[:3])),
        ("_quantize_rel", lambda: tuple(ops.quantize_rel(xr, rcfg)),
         lambda: tuple(D._quantize_rel_plain(xr, rcfg))),
        ("_dequantize_abs",
         lambda: ops.dequantize_abs(qa.bins, pa, qa.outlier, acfg, eb=eb),
         lambda: D._dequantize_abs_plain(qa.bins, pa, qa.outlier, eb_arr,
                                         acfg)),
        ("_dequantize_rel",
         lambda: D.dequantize_rel(qr.bins, pr, qr.outlier, qr.sign, rcfg),
         lambda: D._dequantize_rel_plain(qr.bins, pr, qr.outlier, qr.sign,
                                         rcfg)),
    ]
    for name, _, _ in calls:
        check(counts[name] > 0, f"dense: {name} not launched on the main path")
    rows = [kernel_row(name, "abs" if "abs" in name else "rel", "dense", 16,
                       n, None, kern, plain, counts[name])
            for name, kern, plain in calls]
    print(json.dumps({
        "phase": "dense", "n": n, "eb_abs": eb64, "eb_rel": rcfg.error_bound,
        "n_outliers_abs": int(qa.outlier.sum()),
        "n_outliers_rel": int(qr.outlier.sum()),
        "violations": bad_a + bad_r,
        "launches": {name: counts[name] for name, _, _ in calls}}),
        flush=True)
    return rows


AUDIT_N = 2 ** 20               # values per preset in the detection matrix


def cube(n: int) -> tuple:
    """pred_shape of a field of n values: a cube where n is one (512**3, a
    NYX field), else the flat stream."""
    c = round(n ** (1 / 3))
    return (c, c, c) if c ** 3 == n else (n,)


def _report_equal(a, b) -> bool:
    return all(planes_equal(u, v) for u, v in zip(a, b))


def audit_chain(label: str, spec: str, x, eb, shape):
    """encode(verify=True, integrity=True) and decode(verify=True) of one
    chain at full width, held against the plain path on the card: every
    plane, the checksum, the report field for field, report.ok(); then
    verify=True, integrity=True, the checksum and the audit reduction
    timed beside the plain encode and decode of the same chain.  Returns
    (the chain's entry of the audit line, the kernel rows of its dense
    kernels: B8/B9 on the verify path, B10/B11 on a pred chain's
    decode)."""
    from repro_torch.core import audit as A
    from repro_torch.core.pipeline import parse_pipeline
    from repro_torch.kernels import dense as D
    pipe = parse_pipeline(spec)
    n, kw = x.numel(), {"device": DEV, "pred_shape": shape}
    pipe.encode(x, eb, verify=True, integrity=True, **kw)        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with plain_calls() as plain:
        enc, qt, rep = pipe.encode(x, eb, verify=True, integrity=True,
                                   return_quantized=True, **kw)
        y = pipe.decode(enc, n=n, verify=True, **kw)
        torch.cuda.synchronize()
    counts = launches()
    check(plain["calls"] == 0,
          f"audit {label}: the card's path called a plain quantizer")
    quant = "_quantize_rel" if pipe.quant.mode == "rel" else "_quantize_abs"
    check(counts[quant] > 0, f"audit {label}: {quant} not launched")
    ref, ref_qt, ref_rep = pipe.encode(x, eb, verify=True, integrity=True,
                                       return_quantized=True, kernels=False,
                                       **kw)
    for f in enc._fields:
        check(planes_equal(getattr(enc, f), getattr(ref, f)),
              f"audit {label}: wire plane {f} differs from the plain path")
    check(_report_equal(qt, ref_qt), f"audit {label}: Quantized differs")
    check(_report_equal(rep, ref_rep), f"audit {label}: report differs")
    check(bool(rep.ok()), f"audit {label}: report not ok")
    y_ref = pipe.decode(ref, n=n, verify=True, kernels=False, **kw)
    check(planes_equal(y, y_ref), f"audit {label}: decoded floats differ")
    del ref, ref_qt, y_ref, y
    eb_a = enc.eb if enc.eb is not None else eb
    cfg, n_bits = pipe.qcfg(), pipe.pack.bits
    eb_arr = (eb_a if eb_a is not None else torch.tensor(cfg.error_bound)
              ).to(device=DEV, dtype=torch.float32).reshape(1)
    if pipe.quant.mode == "rel":
        calls = [(quant, "verify", n, None,
                  lambda: tuple(D.quantize_rel(x, cfg)),
                  lambda: tuple(D._quantize_rel_plain(x, cfg)))]
    else:
        calls = [(quant, "verify", n, None,
                  lambda: tuple(D.quantize_abs(x, cfg, eb=eb_arr)[:3]),
                  lambda: tuple(D._quantize_abs_plain(x, eb_arr, cfg)[:3]))]
    if pipe.pred:
        calls += [c for c in path_calls(pipe, enc, x, eb, eb_arr, n, shape)
                  if c[0].startswith("_dequantize")]
    for name, *_ in calls:
        check(counts[name] > 0, f"audit {label}: {name} not launched")
    rows = [kernel_row(name, lab, f"audit {label}", n_bits, size, hist, kern,
                       plain, counts[name])
            for name, lab, size, hist, kern, plain in calls]
    del calls
    out = {
        "chain": label, "spec": pipe.spec(), "n": n,
        "report": {f: (float(v) if v.dtype.is_floating_point else int(v))
                   for f, v in zip(rep._fields, rep)},
        "ok": bool(rep.ok()),
        "checksum": int(enc.checksum) & 0xFFFFFFFF,
        "plain_calls": plain["calls"],
        "launches": {k: v for k, v in counts.items() if v},
        "encode_ms": time_ms(lambda: pipe.encode(x, eb, **kw), reps=5,
                             warm=1),
        "encode_verify_integrity_ms": time_ms(lambda: pipe.encode(
            x, eb, verify=True, integrity=True, **kw), reps=5, warm=1),
        "encode_integrity_ms": time_ms(lambda: pipe.encode(
            x, eb, integrity=True, **kw), reps=5, warm=1),
        "checksum_ms": time_ms(lambda: A.wire_checksum(enc), reps=10),
        "audit_report_ms": time_ms(lambda: A.audit_report(
            x, qt, pipe.qcfg(), eb=eb_a, overflow=enc.overflow,
            n_outliers=enc.n_outliers), reps=10),
        "decode_ms": time_ms(lambda: pipe.decode(enc, n=n, **kw), reps=5,
                             warm=1),
        "decode_verify_ms": time_ms(lambda: pipe.decode(
            enc, n=n, verify=True, **kw), reps=5, warm=1),
    }
    return out, rows


def audit_phase(f) -> list:
    """The audit plane on the card: five chains at full width
    (`audit_chain`), then `runtime.guard.detection_matrix` on all 13
    presets at n = AUDIT_N: every applicable fault class detected, the
    `nan_input` row judged from the report of a NaN-corrupted encode, and
    the clean wire passing its checksum (no false positive)."""
    from repro_torch.configs.registry import PIPELINES, get_pipeline
    from repro_torch.core import audit as A
    from repro_torch.core.pipeline import parse_pipeline
    from repro_torch.runtime import guard as G
    nyx, grad = f["nyx"], f["grad"]
    results = [
        audit_chain("rel", "rel:0.001|pack:16", nyx, None, None),
        audit_chain("grad-wire-8", get_pipeline("grad-wire-8"), grad,
                    rms_eb(grad), None),
        audit_chain("sci-rel-narrow", get_pipeline("sci-rel-narrow"), nyx,
                    None, None),
        audit_chain("sci-lorenzo-ent", get_pipeline("sci-lorenzo-ent"), nyx,
                    None, cube(nyx.numel())),
        # no preset puts a predictor before REL: this chain takes B9 and
        # B11 (the REL dequantize) through the pipeline
        audit_chain("lorenzo-rel", "lorenzo|rel:0.001|pack:32|narrow", nyx,
                    None, cube(nyx.numel())),
    ]
    chains = [c for c, _ in results]
    rows = [r for _, rs in results for r in rs]
    m = min(AUDIT_N, nyx.numel())
    detection, clean = {}, {}
    for name in sorted(PIPELINES):
        pipe = parse_pipeline(get_pipeline(name))
        grad_wire = pipe.quant.eb == 1.0
        # each preset's field of the chain lines (the iid gradient for the
        # grad wires: a prefix of the embedding gradient is mostly zero)
        field = ("grad" if grad_wire else
                 "near_one" if name == "smoke-chain" else "nyx")
        x = f[field][:m].contiguous()
        eb = rms_eb(x) if grad_wire else None
        shape = None
        if pipe.pred and pipe.pred[0].spec() == "lorenzo":
            shape = (m // 1024, 1024) if m % 1024 == 0 else (m,)
        elif pipe.pred and pipe.pred[0].spec() == "kvdelta":
            shape = (m // (128 * 128), 128, 128) if m % 2 ** 14 == 0 else (m,)
        enc = pipe.encode(x, eb, device=DEV, integrity=True, pred_shape=shape)
        clean[name] = bool(A.verify_wire(enc))
        bad_x = G.FaultPlan(name, "nan_input").corrupt_input(x)
        _, nan_rep = pipe.encode(bad_x, eb, device=DEV, verify=True,
                                 pred_shape=shape)
        detection[name] = G.detection_matrix(enc, suite=name, report=nan_rep)
        check(clean[name], f"audit: clean {name} wire fails its checksum")
        check(len(detection[name]) == 4 and all(detection[name].values()),
              f"audit: {name} misses a fault class: {detection[name]}")
    print(json.dumps({"phase": "audit", "chains": chains, "detection_n": m,
                      "detection": detection, "clean_wire_passes": clean,
                      "presets": len(detection)}), flush=True)
    return rows


def kv_rows(qkv, i: int):
    """Batch row i of a QuantizedKV, keeping the batch axis."""
    return type(qkv)(*(t[i:i + 1] for t in qkv))


def kv_inputs(seed: int, batch: int = KV_BATCH, s: int = KV_S):
    """The kv phase's float32 K and V [B, G, S, D], q [B, G, Hg, D] and int32
    lengths [B], made on the card from the seed."""
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    shape = (batch, KV_G, s, KV_D)
    k = torch.randn(shape, generator=gen, device=DEV) * 0.7
    v = torch.randn(shape, generator=gen, device=DEV) * 0.7
    k[:, :, 0, :KV_D // 4] *= 80.0         # attention sinks, as in
    v[:, :, 0, :KV_D // 4] *= 80.0         # tests/test_kernel_attention.py
    q = torch.randn((batch, KV_G, KV_HG, KV_D), generator=gen, device=DEV)
    lengths = torch.randint(1, s + 1, (batch,), generator=gen, device=DEV,
                            dtype=torch.int32)
    lengths[0] = s
    lengths[1] = s // 2 + 57               # not a multiple of the page
    return k, v, q, lengths


def kv_quantize(x):
    """`compression.kv.quantize_kv` of x one batch row at a time: pages are
    independent, so this is the result of one call, with 1/B of its
    temporaries."""
    from repro_torch.compression import kv as KV
    cfg = KV.kv_quantizer_config()
    parts = [KV.quantize_kv(x[i:i + 1], cfg, page=KV_PAGE, cap=KV_CAP)
             for i in range(x.shape[0])]
    return KV.QuantizedKV(*(torch.cat(p) for p in zip(*parts)))


def with_page_outliers(qkv, page: int, seed: int):
    """A copy of the one-row cache qkv with all `cap` slots of page `page`
    of every KV head holding exact values 2-4 times past the int8 grid's
    reach (127 eb2, either sign), laid out as the encoder lays out
    outliers: their bins zeroed, the slots in ascending in-page order.  The
    kv phase's bound leaves finite pages no outliers, so this is how the
    main path's shapes reach the kernel's outlier corrections."""
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    bins, idx = qkv.bins.clone(), qkv.out_idx.clone()
    val = qkv.out_val.clone()
    cap = idx.shape[-1]
    for g in range(bins.shape[1]):
        flat = torch.randperm(KV_PAGE * KV_D, generator=gen,
                              device=DEV)[:cap].sort().values
        mag = 2.0 + 2.0 * torch.rand(cap, generator=gen, device=DEV)
        sign = torch.rand(cap, generator=gen, device=DEV) < 0.5
        bins[0, g, page * KV_PAGE + flat // KV_D, flat % KV_D] = 0
        idx[0, g, page] = flat.to(torch.int32)
        val[0, g, page] = (torch.where(sign, -mag, mag) * 127.0
                           * qkv.eb2[0, g, page])
    return qkv._replace(bins=bins, out_idx=idx, out_val=val)


def device_kernels(fn, reps: int = 20, per_kernel: dict | None = None):
    """(kernels launched per call, {kernel: device ms per call}) of fn, from
    torch.profiler's trace of the card over `reps` calls after one warm-up
    call; (None, {}) when the trace holds no kernel (no card, or no
    device tracing).  `per_kernel`, if given, gets {kernel: launches per
    call}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n, ms = 0, {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith(("Memcpy", "Memset"))):
            continue
        short = re.search(r"(\w+)(<[^>]*>)?\(", e.name)
        key = short.group(1) if short else e.name
        n += 1
        ms[key] = ms.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if per_kernel is not None:
            per_kernel[key] = per_kernel.get(key, 0.0) + 1 / reps
    return (n / reps if n else None), ms


def kv_phase(seed: int, batch: int = KV_BATCH, s: int = KV_S):
    """B12 on its main path: `compression.kv.quantize_kv` of K and V, then
    `kernels.kv_attention.kv_decode_attention`, at internlm2-20b's
    attention widths over a decode_32k history.  Returns the kernel rows
    and batch row 0 of K, float32 [G, S, D]."""
    import torch.nn.functional as F
    from repro_torch.compression import kv as KV
    from repro_torch.kernels import kv_attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    k, v, q, lengths = kv_inputs(seed, batch, s)
    cfg = KV.kv_quantizer_config()

    def attend():
        return A.kv_decode_attention(q, kq, vq, lengths, page=KV_PAGE,
                                     cap=KV_CAP)

    torch.cuda.synchronize()
    reset_launches()
    kq, vq = kv_quantize(k), kv_quantize(v)
    out = attend()
    torch.cuda.synchronize()
    counts = launches()
    name = "_kv_decode_attention"
    check(counts[name] > 0, f"kv: {name} not launched on the main path")
    overflow = int(kq.overflow.sum() + vq.overflow.sum())
    check(overflow == 0, f"kv: {overflow} pages overflow their outlier table")
    holds = all(bool(KV.kv_error_bound_holds(x[i:i + 1], kv_rows(qkv, i), cfg))
                for x, qkv in ((k, kq), (v, vq)) for i in range(batch))
    check(holds, "kv: a page misses its bound")
    quantize_ms = time_ms(lambda: kv_quantize(k), reps=3, warm=1)
    k_row0 = k[0].clone()              # one user's cache: the kv-delta chain
    del k, v

    def plain():
        return A._kv_decode_attention_plain(q, kq, vq, lengths, page=KV_PAGE)

    want = plain()
    close = bool(torch.allclose(out, want, rtol=KV_TOL, atol=KV_TOL))
    err = max_abs_err(out, want)
    check(close, f"kv: {name} differs from its plain version by {err}")

    def attention64(i):
        kd = KV.dequantize_kv(kv_rows(kq, i), page=KV_PAGE).double()
        vd = KV.dequantize_kv(kv_rows(vq, i), page=KV_PAGE).double()
        sc = torch.einsum("bghd,bgsd->bghs", q[i:i + 1].double(), kd)
        sc = sc / KV_D ** 0.5
        mask = torch.arange(s, device=DEV) < lengths[i]
        sc = sc.masked_fill(~mask, float("-inf"))
        return torch.einsum("bghs,bgsd->bghd", torch.softmax(sc, -1), vd)

    ref64 = torch.cat([attention64(i) for i in range(batch)])
    kd, vd = (KV.dequantize_kv(t, page=KV_PAGE) for t in (kq, vq))
    mask = (torch.arange(s, device=DEV)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]

    def library():
        # Hg query heads of one KV head as Hg query rows against it: the
        # same function as enable_gqa=True, without expanding K and V
        return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)

    lib_out = library()
    errs64 = {w: max_abs_err(t.double(), ref64)
              for w, t in (("kernel", out), ("plain", want),
                           ("library", lib_out))}
    n_bytes, ops = kv_work(lengths, batch, KV_HG, s)
    bound_ms, bound_by = bound_from(n_bytes, ops)
    terms_ms = {"bytes": bound_from(n_bytes, 0)[0], "operations":
                bound_from(0, ops)[0]}
    # one call by CUDA events, as every kernel row is timed (the wrapper's
    # host time included); beside it KV_BATCH_CALLS calls in a row (a
    # decode loop, where the host's time hides under the card's) and the
    # kernels' own device time from the profiler's trace
    ms = time_ms(attend)
    lib_ms = time_ms(library)
    ms_batched = time_ms(attend, batch=KV_BATCH_CALLS)
    lib_batched_ms = time_ms(library, batch=KV_BATCH_CALLS)
    per_call, dev_ms = device_kernels(attend)
    del kd, vd, lib_out
    plain_ms = time_ms(plain, reps=5, warm=1)
    n_used = torch.div(lengths.long() + KV_PAGE - 1, KV_PAGE,
                       rounding_mode="floor")
    n_pages = int(n_used.sum())

    # one user at the full history: batch row 0 (length S) of the same
    # cache, with a page of exact outliers in K and V (the last page of a
    # split for every power-of-two split)
    n_all = s // KV_PAGE
    out_page = n_all // 2 - 1
    q1, len1 = q[:1], lengths[:1]
    k1 = with_page_outliers(kv_rows(kq, 0), out_page, seed)
    v1 = with_page_outliers(kv_rows(vq, 0), out_page, seed + 1)

    def attend_b1():
        return A.kv_decode_attention(q1, k1, v1, len1, page=KV_PAGE,
                                     cap=KV_CAP)

    out1 = attend_b1()
    want1 = A._kv_decode_attention_plain(q1, k1, v1, len1, page=KV_PAGE)
    close1 = bool(torch.allclose(out1, want1, rtol=KV_TOL, atol=KV_TOL))
    err1 = max_abs_err(out1, want1)
    check(close1, f"kv: {name} at B=1 differs from its plain version by "
                  f"{err1}")
    ms1 = time_ms(attend_b1)
    ms1_batched = time_ms(attend_b1, batch=KV_BATCH_CALLS)
    per_call1, dev_ms1 = device_kernels(attend_b1)
    kd1, vd1 = (KV.dequantize_kv(t, page=KV_PAGE) for t in (k1, v1))

    def library_b1():
        return F.scaled_dot_product_attention(q1, kd1, vd1,
                                              attn_mask=mask[:1])

    lib1_ms = time_ms(library_b1)
    plain1_ms = time_ms(lambda: A._kv_decode_attention_plain(
        q1, k1, v1, len1, page=KV_PAGE), reps=5, warm=1)
    del kd1, vd1
    bytes1, ops1 = kv_work(len1, 1, KV_HG, s)
    bound1_ms, bound1_by = bound_from(bytes1, ops1)
    device = sum(dev_ms.values()) or None
    device1 = sum(dev_ms1.values()) or None

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = A.default_pages_per_split(batch, KV_G, n_all, sms)
    pps1 = A.default_pages_per_split(1, KV_G, n_all, sms)
    splits = -(-n_all // pps)
    smem, per_sm = A.kv_occupancy(KV_HG, KV_CAP)
    split = {"pages_per_split": pps, "splits_per_head": splits,
             "blocks_launched": batch * KV_G * splits,
             "blocks_with_pages": KV_G * int(
                 torch.div(n_used + pps - 1, pps, rounding_mode="floor")
                 .sum()),
             "merge_blocks": batch * KV_G * KV_HG,
             "b1_pages_per_split": pps1,
             "b1_blocks_launched": KV_G * -(-n_all // pps1),
             "smem_bytes_per_block": smem, "blocks_per_sm": per_sm,
             "sms": sms}
    print(json.dumps({
        "phase": "kv", "batch": batch, "kv_heads": KV_G, "q_per_kv": KV_HG,
        "head_dim": KV_D, "seq": s, "page": KV_PAGE, "cap": KV_CAP,
        "lengths_min": int(lengths.min()), "lengths_max": int(lengths.max()),
        "pages_read_per_head": n_pages,
        "outliers": int((kq.out_idx >= 0).sum() + (vq.out_idx >= 0).sum()),
        "outliers_b1": int((k1.out_idx >= 0).sum() + (v1.out_idx >= 0).sum()),
        "overflow_pages": overflow, "bound_holds": holds,
        "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32],
        "max_abs_err_vs_float64": errs64,
        "max_abs_err_kernel_vs_plain": err, "tolerance": KV_TOL,
        "quantize_kv_ms": quantize_ms, "attention_ms": ms,
        "bound_ms": bound_ms, "share": bound_ms / ms,
        "library_ms": lib_ms, "plain_ms": plain_ms,
        "calls_in_a_row": KV_BATCH_CALLS,
        "attention_batched_ms": ms_batched,
        "library_batched_ms": lib_batched_ms,
        "attention_device_ms": device, "device_ms_by_kernel": dev_ms,
        "launches_per_call": per_call,
        "attention_b1_ms": ms1, "library_b1_ms": lib1_ms,
        "plain_b1_ms": plain1_ms, "bound_b1_ms": bound1_ms,
        "bound_b1_by": bound1_by, "share_b1": bound1_ms / ms1,
        "attention_b1_batched_ms": ms1_batched,
        "attention_b1_device_ms": device1, "b1_device_ms_by_kernel": dev_ms1,
        "b1_launches_per_call": per_call1,
        "max_abs_err_b1_kernel_vs_plain": err1, **split,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {name: counts[name]}}), flush=True)
    return [{"name": name, "route": "cuda", "source": CSRC + KERNELS[name][0],
             "replaces": KERNELS[name][1], "chain": "kv",
             "stage": f"B={batch} G={KV_G} Hg={KV_HG} D={KV_D} S={s}",
             "bits": 8, "launches": counts[name],
             "launches_per_call": per_call,
             "max_abs_err": max(err, err1),
             "tolerance": KV_TOL, "match": close and close1, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "bound_terms_ms": terms_ms,
             "share": bound_ms / ms, "library_ms": lib_ms,
             "library": "scaled_dot_product_attention over the dequantized "
                        "float32 cache (reads 4x the cache bytes; "
                        "dequantization not included)",
             "batched_ms": ms_batched, "library_batched_ms": lib_batched_ms,
             "device_ms": device,
             "bytes": n_bytes, "operations": ops, "b1_ms": ms1,
             "b1_batched_ms": ms1_batched, "b1_device_ms": device1,
             "b1_bound_ms": bound1_ms, "b1_share": bound1_ms / ms1,
             "b1_library_ms": lib1_ms, "b1_plain_ms": plain1_ms}], k_row0


# the grads phase: the gradients of one internlm2-20b decoder layer at full
# width (src/repro/configs/registry.py:22-25, the leaves of
# src/repro/models/transformer.py:37-60 with swiglu), all-reduced across
# the two pods of the multi-pod mesh (src/repro/launch/mesh.py:42) as a
# 2-rank thread axis on the card
GRAD_LEAVES = (("ln1", (6144,)), ("wq", (6144, 6144)), ("wkv", (6144, 2048)),
               ("wo", (6144, 6144)), ("ln2", (6144,)),
               ("w1", (6144, 16384)), ("w3", (6144, 16384)),
               ("w2", (16384, 6144)))
GRAD_PODS, GRAD_STEPS = 2, 2
GRAD_EB_REL = 2.0 ** -5                # as rms_eb
GRAD_RING_LEAF = "wq"                  # the leaf pair built for the ring


def grad_inputs(seed: int):
    """Each pod's gradients {leaf: float32 on the card}: a shared
    N(0,1)*3e-3 component plus a per-pod N(0,1)*1e-3 one, from the seed."""
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    pods = [{} for _ in range(GRAD_PODS)]
    for name, shape in GRAD_LEAVES:
        shared = torch.randn(shape, generator=gen, device=DEV) * 3e-3
        for pod in pods:
            pod[name] = shared + torch.randn(shape, generator=gen,
                                             device=DEV) * 1e-3
        del shared
    return pods


def grad_branch(shards, tp) -> str:
    """The branch a reduce of these wires takes, from the wires alone: the
    lossless sum on any overflow; the ring under its rule (static, then
    one grid and no outliers); else the gather."""
    if any(bool(s.enc.overflow) for s in shards):
        return "lossless"
    pipe = shards[0].pipe
    if not tp._ring_ok(pipe, pipe.qcfg(), len(shards)):
        return "gather"
    same = all(bool(s.enc.eb == shards[0].enc.eb) for s in shards)
    clean = all(int(s.enc.n_outliers) == 0 for s in shards)
    return "ring" if same and clean else "gather"


def plain_mean(shards, g_in, branch: str):
    """What every pod's mean must be: each pod's wire decoded on the plain
    path (kernels=False) and summed from 0 in rank order, over p; on the
    lossless branch the inputs summed in rank order, over p."""
    p, n = len(shards), shards[0].n
    if branch == "lossless":
        total = g_in[0].reshape(-1).float()
        for g in g_in[1:]:
            total = total + g.reshape(-1).float()
        return total / p
    total = torch.zeros(n, device=DEV)
    for s in shards:
        total = total + s.pipe.decode(s.enc, n=n, device=DEV, kernels=False)
    return total / p


def measured_bytes(pipe, enc, n: int) -> float:
    """The wire's transmitted bytes counted from its planes: the payload
    prefix (payload_len words, read here) after a length-variable stage,
    else the whole payload; each stage's header content; the outlier
    table; the sign plane; the 8-byte packed header; the length field; the
    checksum; and a selector's chain-id byte."""
    from repro_torch.core.select import Selector
    extra, checksum = 0, enc.checksum is not None
    if isinstance(pipe, Selector):
        i = int(enc.chain_id)
        enc, pipe, extra = pipe._view(enc, i, n), pipe.chains[i], 1
    sizes = pipe.stage_sizes(n)
    bits = 64 + 64 * enc.out_idx.numel()
    bits += 32 * (0 if enc.sign_words is None else enc.sign_words.numel())
    bits += 32 * checksum
    bits += sum(st.header_content_bits(sz)
                for st, sz in zip(pipe.stages, sizes))
    if pipe.stages and pipe.stages[-1].transmits_len:
        bits += 32 + 32 * int(enc.payload_len)
    else:
        bits += 32 * enc.payload.numel()
    return bits / 8 + extra


def wire_bytes_error(acct, measured: float) -> float:
    """|accounted - measured| / measured; the accounting is a Python int
    (exact) for static chains and float32 past a length-variable stage, as
    the reference's (one float32 rounding of the word count, relative
    error <= 2^-24, and of the chain-id byte's add)."""
    return abs(float(acct) - measured) / measured


GRAD_WIRE_TOL = 2.0 ** -23


@contextlib.contextmanager
def sent_wires():
    """Wrap `compress_shard` for the block so that the wires the pods send
    are kept as sent.  Yields (wires, each_pod): `wires[r]` lists pod r's
    CompressedShards in the order it encoded them, and `each_pod(fn)` is
    fn with its rank noted, to hand to `run_threads`."""
    from repro_torch.compression import grads as G
    real, rank = G.compress_shard, threading.local()
    wires = [[] for _ in range(GRAD_PODS)]

    def kept(*args, **kw):
        out = real(*args, **kw)
        wires[rank.r].append(out[0])
        return out

    def each_pod(fn):
        def run(ax):
            rank.r = ax.rank
            return fn(ax)
        return run

    G.compress_shard = kept
    try:
        yield wires, each_pod
    finally:
        G.compress_shard = real


def grad_step(cfg, g, r, tp=None):
    """One step of `compressed_mean_tree` on every pod (p threads on the
    card), timed as one call by CUDA events.  Returns (means, residuals,
    each pod's {leaf: the CompressedShard it sent}, ms)."""
    from repro_torch.compression import grads as G
    from repro_torch.core.axis import run_threads
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with sent_wires() as (sent, each_pod):
        torch.cuda.synchronize()
        a.record()
        out = run_threads(GRAD_PODS, each_pod(
            lambda ax: G.compressed_mean_tree(g[ax.rank], r[ax.rank], cfg,
                                              ax, tp, device=DEV)))
        b.record()
        b.synchronize()
    # compressed_mean_tree encodes the leaves in sorted key order
    wires = [dict(zip(sorted(g[k]), w)) for k, w in enumerate(sent)]
    return ([o[0] for o in out], [o[1] for o in out], wires,
            a.elapsed_time(b))


def grad_bytes_moved(shards, branch: str) -> float:
    """The bytes one reduce of these pods' wires moves between pods: on
    the ring each pod's word plane at each of the p - 1 hops; on the
    gather each pod's own wire (`wire_bytes`) to each of the p - 1
    others; on the lossless branch the float32 psum, counted as a
    gather of every pod's values."""
    p = len(shards)
    if branch == "ring":
        return float(p * (p - 1) * shards[0].enc.payload.numel() * 4)
    if branch == "lossless":
        return float(p * (p - 1) * shards[0].n * 4)
    return float((p - 1) * sum(float(s.nbytes()) for s in shards))


def grad_facts() -> dict:
    return {"branch": {}, "chain_ids": {}, "bytes_moved": 0.0,
            "f32_bytes": 0, "max_resid_over_eb": 0.0,
            "wire_bytes_max_rel_err": 0.0}


def grad_check_leaf(label, name, ins, shards, means, resids, facts) -> None:
    """Hold one leaf of one step on the wires the pods sent: every pod's
    mean (float32, flat) bit-equal to the plain result, every residual
    within eb in float64 (0 on the lossless branch), each selector wire
    bit-equal to its chosen chain's own wire, and `wire_bytes` equal to
    the measured transmitted bytes.  Adds the leaf's facts (branch, chain
    ids, bytes moved, max |residual|/eb, the largest wire_bytes error) to
    `facts`."""
    from repro_torch.core.select import Selector
    from repro_torch.core.transport import TRANSPORT
    n = shards[0].n
    branch = grad_branch(shards, TRANSPORT)
    facts["branch"][name] = branch
    want = plain_mean(shards, ins, branch)
    for r, m in enumerate(means):
        check(planes_equal(m.reshape(-1), want),
              f"{label}: pod {r}'s mean of {name} differs from the plain "
              "decode-and-sum")
    for r, (s, res) in enumerate(zip(shards, resids)):
        worst = float(res.abs().max())      # exact in float32; compared
        if branch == "lossless":            # in float64
            check(worst == 0.0, f"{label}: {name} residual not 0 on the "
                                "lossless branch")
            continue
        eb = float(s.enc.eb)
        check(worst <= eb, f"{label}: pod {r}'s residual of {name} exceeds "
                           f"eb ({worst} > {eb})")
        facts["max_resid_over_eb"] = max(facts["max_resid_over_eb"],
                                         worst / eb)
        acct = s.nbytes()
        err = wire_bytes_error(acct, measured_bytes(s.pipe, s.enc, n))
        tol = 0.0 if isinstance(acct, int) else GRAD_WIRE_TOL
        check(err <= tol, f"{label}: wire_bytes of {name} is off the "
                          f"measured bytes by {err}")
        facts["wire_bytes_max_rel_err"] = max(
            facts["wire_bytes_max_rel_err"], err)
    if isinstance(shards[0].pipe, Selector):
        sel = shards[0].pipe
        ids = [int(s.enc.chain_id) for s in shards]
        facts["chain_ids"][name] = ids
        for x, s, i in zip(ins, shards, ids):
            direct = sel.chains[i].encode(x.reshape(-1).float(), s.enc.eb,
                                          device=DEV,
                                          return_quantized=True)[0]
            check(planes_equal(tuple(sel._view(s.enc, i, n)),
                               tuple(direct)),
                  f"{label}: the selector wire of {name} differs from its "
                  f"chosen chain's ({i}) own wire")
    facts["bytes_moved"] += grad_bytes_moved(shards, branch)
    p = len(shards)               # a float32 all-reduce, as
    facts["f32_bytes"] += p * (p - 1) * 4 * n   # TRANSPORT.bytes_moved counts


def grad_check_step(label, g_in, means, resids, wires) -> dict:
    """Hold one step's results, leaf by leaf (`grad_check_leaf`).  Returns
    the leaf facts."""
    facts = grad_facts()
    for name, _ in GRAD_LEAVES:
        grad_check_leaf(f"grads {label}", name, [g[name] for g in g_in],
                        [w[name] for w in wires], [m[name] for m in means],
                        [r[name] for r in resids], facts)
    return facts


def grad_run(label: str, spec: str, pods) -> tuple:
    """GRAD_STEPS steps with error feedback of one configuration on every
    pod, each step held by `grad_check_step`; prints the configuration's
    line.  Returns (the launch counts of its steps, each leaf's
    branch)."""
    from repro_torch.compression import grads as G
    cfg = G.GradCompressionConfig(eb_rel=GRAD_EB_REL, pipeline=spec)
    torch.cuda.reset_peak_memory_stats()
    r = [{k: torch.zeros_like(v) for k, v in g.items()} for g in pods]
    step_ms, steps, total = [], [], {}
    for _ in range(GRAD_STEPS):
        g_in = [{k: g[k] + res[k] for k in g} for g, res in zip(pods, r)]
        torch.cuda.synchronize()
        reset_launches()
        with plain_calls() as plain:
            means, r, wires, ms = grad_step(cfg, pods, r)
        for k, v in launches().items():
            total[k] = total.get(k, 0) + v
        check(plain["calls"] == 0, f"grads {label}: the card's path called "
                                   "a plain quantizer or codec")
        step_ms.append(ms)
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps.append(grad_check_step(label, g_in, means, r, wires))
        del g_in, means, wires
    info = steps[-1]
    n_total = sum(int(np.prod(s)) for _, s in GRAD_LEAVES)
    parts = grad_parts(cfg, pods[0]["w1"])
    if spec != "auto":      # auto's ent loops would flood the trace
        parts.update(grad_busy(cfg, pods, r))
    print(json.dumps({
        "phase": "grads", "config": label, "spec": spec,
        "model": "internlm2-20b", "layer": "one decoder layer, 8 leaves",
        "pods": GRAD_PODS, "values_per_pod": n_total, "steps": GRAD_STEPS,
        "eb_rel": GRAD_EB_REL, "step_ms": step_ms,
        "bytes_moved_per_step": [s["bytes_moved"] for s in steps],
        "f32_allreduce_bytes_per_step": info["f32_bytes"],
        "ratio_vs_f32": [info["f32_bytes"] / s["bytes_moved"]
                         for s in steps],
        "branch": info["branch"],
        "chain_ids": [s["chain_ids"] for s in steps],
        "max_resid_over_eb": max(s["max_resid_over_eb"] for s in steps),
        "wire_bytes_max_rel_err": max(s["wire_bytes_max_rel_err"]
                                      for s in steps),
        "plain_calls": 0, "peak_device_GB": peak, **parts,
        "launches_per_step": {k: v / GRAD_STEPS for k, v in total.items()
                              if v}}), flush=True)
    return total, info["branch"]


def grad_busy(cfg, pods, r) -> dict:
    """One more step under `torch.profiler`: its length by CUDA events and
    the card's busy time in it (the sum of its kernels' device times; one
    stream, so they do not overlap), hence the idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = grad_step(cfg, pods, r)[3]
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"profiled_step_ms": ms, "device_busy_ms": busy or None,
            "device_idle_share": 1 - busy / ms if busy else None}


def grad_parts(cfg, x) -> dict:
    """Where a step's time goes, on pod 0's w1 (100.7M values, the largest
    leaf), each one call by CUDA events: `compress_shard` and one decode
    of its wire; for a selector also the stats pass and each candidate's
    own wire bytes beside the selector's estimates, so the choice can be
    held against the bytes each candidate really moves."""
    from repro_torch.compression import grads as G
    from repro_torch.core.select import Selector
    shard, _ = G.compress_shard(x, cfg, device=DEV)
    heavy = isinstance(shard.pipe, Selector)
    reps = 3 if heavy else 10
    out = {"w1_compress_shard_ms": time_ms(
        lambda: G.compress_shard(x, cfg, device=DEV), reps=reps, warm=1),
        "w1_decode_ms": time_ms(lambda: shard.pipe.decode(
            shard.enc, n=shard.n, device=DEV), reps=reps, warm=1)}
    if heavy:
        sel, eb, flat = shard.pipe, shard.enc.eb, x.reshape(-1)
        out["w1_score_ms"] = time_ms(lambda: sel.score(flat, eb, device=DEV),
                                     reps=reps, warm=1)
        out["w1_estimated_bytes"] = [float(c) / 8 for c in
                                     sel.score(flat, eb, device=DEV)]
        out["w1_candidate_bytes"] = [
            float(c.wire_bytes(c.encode(flat, eb, device=DEV), shard.n))
            for c in sel.chains]
        out["w1_chosen"] = int(shard.enc.chain_id)
    return out


def grad_pair_phase(seed: int) -> tuple:
    """The ring on a full-width leaf: a pair built so its rule holds at
    grad-wire-8 (3e-3 tanh(N(0,1)) and its negation: the same rms bit for
    bit, so one grid, and no outliers), reduced with reduce='auto' (the
    ring) and 'gather', bit-equal to each other and to the plain result;
    then the checked reduces: clean (p contributions), `hop_bitflip`
    on the ring hops and `payload_bitflip` on one gathered shard (p - 1),
    and `compressed_mean(integrity='drop')` under the gathered flip.
    Returns (launch counts, the ring's bins and eb for the B10 row)."""
    from repro_torch.compression import grads as G
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.core import codec as C
    from repro_torch.core.axis import run_threads
    from repro_torch.core.transport import TRANSPORT, Transport
    from repro_torch.runtime.guard import FaultPlan
    shape = dict(GRAD_LEAVES)[GRAD_RING_LEAF]
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    a = 3e-3 * torch.tanh(torch.randn(shape, generator=gen, device=DEV))
    pair = [a, -a]
    cfg = G.GradCompressionConfig(eb_rel=GRAD_EB_REL,
                                  pipeline=get_pipeline("grad-wire-8"))
    gather = Transport(reduce="gather")
    flip = FaultPlan("grads-gather", "payload_bitflip").corrupt_wire
    hop = Transport(fault=FaultPlan("grads-ring", "hop_bitflip").corrupt_hop)

    def timed(tp):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with sent_wires() as (sent, each_pod):
            torch.cuda.synchronize()
            ev[0].record()
            out = run_threads(GRAD_PODS, each_pod(
                lambda ax: G.compressed_mean(pair[ax.rank], cfg, ax,
                                             transport=tp, device=DEV)))
            ev[1].record()
            ev[1].synchronize()
        return out, [w[0] for w in sent], ev[0].elapsed_time(ev[1])

    def checked(ax):
        s, _ = G.compress_shard(pair[ax.rank], cfg, integrity=True,
                                device=DEV)
        e, pp, n = s.enc, s.pipe, s.n
        return (TRANSPORT.uses_ring(e, pp, ax),
                TRANSPORT.reduce_mean(e, pp, n, ax, integrity="drop",
                                      return_valid=True),
                hop.reduce_mean(e, pp, n, ax, integrity="drop",
                                return_valid=True),
                gather.reduce_mean(e, pp, n, ax, integrity="drop",
                                   return_valid=True),
                Transport(reduce="gather", fault=flip).reduce_mean(
                    e, pp, n, ax, integrity="drop", return_valid=True),
                G.compressed_mean(pair[ax.rank], cfg, ax,
                                  transport=Transport(fault=flip),
                                  integrity="drop", device=DEV)[0])

    torch.cuda.synchronize()
    reset_launches()
    with plain_calls() as plain:
        ring, shards, ring_ms = timed(TRANSPORT)
        gathered, _, gather_ms = timed(gather)
        chk = run_threads(GRAD_PODS, checked)
    counts = launches()
    check(plain["calls"] == 0, "grads ring: the card's path called a plain "
                               "quantizer or codec")
    for name in ("_quantize_abs", "_dequantize_abs", "_abs_unpack"):
        check(counts[name] > 0, f"grads ring: {name} not launched")
    branch = grad_branch(shards, TRANSPORT)
    check(branch == "ring", f"grads ring: the pair took the {branch} path")
    want = plain_mean(shards, pair, branch)
    decodes = [s.pipe.decode(s.enc, n=s.n, device=DEV, kernels=False)
               for s in shards]
    worst = 0.0
    for r in range(GRAD_PODS):
        (m, res), (mg, _) = ring[r], gathered[r]
        check(planes_equal(m.reshape(-1), mg.reshape(-1)),
              f"grads ring: pod {r}'s ring mean differs from the gather's")
        check(planes_equal(m.reshape(-1), want),
              f"grads ring: pod {r}'s mean differs from the plain result")
        eb = float(shards[r].enc.eb)
        e = float(res.double().abs().max())
        check(e <= eb, f"grads ring: pod {r}'s residual exceeds eb")
        worst = max(worst, e / eb)
        fired, (mc, nc), (_, nh), (_, ng), (mb, nb), cm = chk[r]
        check(fired, f"grads ring: pod {r} did not take the ring")
        check(int(nc) == GRAD_PODS and int(ng) == GRAD_PODS,
              f"grads ring: a clean checked reduce counted {int(nc)}, "
              f"{int(ng)} of {GRAD_PODS}")
        check(planes_equal(mc.reshape(-1), m.reshape(-1)),
              f"grads ring: pod {r}'s clean checked ring moved a bit")
        check(int(nh) == GRAD_PODS - 1 and int(nb) == GRAD_PODS - 1,
              f"grads ring: pod {r} counted {int(nh)} (hop flip) and "
              f"{int(nb)} (shard flip), not {GRAD_PODS - 1}")
        check(any(planes_equal(mb, d) for d in decodes)
              and planes_equal(cm.reshape(-1), mb),
              f"grads ring: pod {r}'s mean under the shard flip is not the "
              "clean shard's decode")
    n = shards[0].n
    bins = sum(C.unpack_words(s.enc.payload, n, 8) for s in shards)
    print(json.dumps({
        "phase": "grads", "config": "ring-pair", "spec": cfg.pipe().spec(),
        "leaf": GRAD_RING_LEAF, "values_per_pod": n, "pods": GRAD_PODS,
        "branch": branch, "ring_ms": ring_ms, "gather_ms": gather_ms,
        "bytes_moved_gather": grad_bytes_moved(shards, "gather"),
        "bytes_moved_ring": grad_bytes_moved(shards, "ring"),
        "max_resid_over_eb": worst,
        "n_valid": {what: [int(c[k][1]) for c in chk] for what, k in
                    (("clean_ring", 1), ("hop_bitflip", 2),
                     ("clean_gather", 3), ("payload_bitflip", 4))},
        "plain_calls": 0,
        "launches": {k: v for k, v in counts.items() if v}}), flush=True)
    return counts, (bins.to(torch.int32), shards[0].enc.eb, cfg.qcfg())


GRAD_ROWS = ("_abs_pack", "_quantize_abs", "_lc_select", "_lc_expand",
             "_abs_unpack", "_dequantize_abs")


def grad_kernel_rows(x, counts: dict, per_step: dict, ring_in=None,
                     names=GRAD_ROWS, chain: str = "grads") -> list:
    """The rows `names` of B1, B8, B6, B7, B2 and B10 on the gradient
    path's own inputs (x: a leaf's float32 gradient, for the grads phase
    pod 0's w1, 100.7M values; the ring pair's bin sum for B10), each held
    against its plain version and timed.  `launches` counts the phase's
    counted runs; `launches_per_step` the tree steps' mean."""
    from repro_torch.compression import grads as G
    from repro_torch.core import codec as C
    from repro_torch.core.select import get_selector
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import lossless as L
    from repro_torch.kernels import pack as K
    x = x.reshape(-1)
    n = x.numel()
    cfg = G.GradCompressionConfig(eb_rel=GRAD_EB_REL,
                                  pipeline="abs:1.0|pack:16|narrow")
    shard, q = G.compress_shard(x, cfg, device=DEV)
    qc, eb = shard.pipe.qcfg(), shard.enc.eb.reshape(1)
    sel_cfg = get_selector("grad-wire").qcfg()
    words = C.pack_words(q.bins, 16)
    n_words = words.numel()
    codes = C.unpack_words(shard.enc.headers[0], C.lc_chunk_count(n_words), 2,
                           signed=False)
    padded = C.lc_gather_chunks(shard.enc.payload, codes).reshape(-1)
    calls = [
        ("_abs_pack", "selector stats", 16, n, None,
         lambda: K.abs_pack(x, eb, sel_cfg),
         lambda: K._abs_pack_plain(x, eb, sel_cfg)),
        ("_quantize_abs", "compress_shard", 16, n, None,
         lambda: tuple(D.quantize_abs(x, qc, eb=eb)[:3]),
         lambda: tuple(D._quantize_abs_plain(x, eb, qc)[:3])),
        ("_lc_select", "0:narrow", 16, n_words, None,
         lambda: L.lc_select(words, "narrow"),
         lambda: L._lc_select_plain(words, "narrow")),
        ("_lc_expand", "0:narrow", 16, n_words, hist_of(codes),
         lambda: L.lc_expand(padded, codes, n_words),
         lambda: L._lc_expand_plain(padded, codes, n_words)),
        ("_abs_unpack", "gather decode", 16, n, None,
         lambda: K.abs_unpack(words, eb, n, qc),
         lambda: K._abs_unpack_plain(words, eb, n, qc)),
    ]
    if ring_in is not None:
        bins, ring_eb, ring_qc = ring_in
        zeros_i = torch.zeros_like(bins)
        zeros_b = torch.zeros_like(bins, dtype=torch.bool)
        ring_eb = ring_eb.reshape(1)
        calls.append(("_dequantize_abs", "ring", 8, bins.numel(), None,
                      lambda: D.dequantize_abs(bins, zeros_i, zeros_b,
                                               ring_qc, eb=ring_eb),
                      lambda: D._dequantize_abs_plain(bins, zeros_i, zeros_b,
                                                      ring_eb, ring_qc)))
    rows = []
    for name, label, bits, size, hist, kern, plain in calls:
        if name not in names:
            continue
        check(counts.get(name, 0) > 0,
              f"{chain}: {name} not launched on the {chain} path")
        row = kernel_row(name, label, chain, bits, size, hist, kern, plain,
                         counts[name])
        row["launches_per_step"] = per_step.get(name, 0)
        rows.append(row)
    return rows


def grads_phase(seed: int) -> list:
    """The compressed gradient all-reduce at full width: each configuration
    for GRAD_STEPS steps, the ring pair with the checked reduces, then the
    kernel rows of the path.  Returns the rows."""
    from repro_torch.configs.registry import get_pipeline
    pods = grad_inputs(seed)
    configs = (("grad-wire-8", get_pipeline("grad-wire-8")),
               ("grad-wire-16-narrow", get_pipeline("grad-wire-16-narrow")),
               ("auto", "auto"))
    counts, branches = {}, set()
    for label, spec in configs:
        run_counts, branch = grad_run(label, spec, pods)
        branches |= set(branch.values())
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v
    check("gather" in branches, "grads: no full-width leaf took the gather")
    per_step = {k: v / (len(configs) * GRAD_STEPS) for k, v in counts.items()}
    pair_counts, ring_in = grad_pair_phase(seed)
    for k, v in pair_counts.items():
        counts[k] = counts.get(k, 0) + v
    rows = grad_kernel_rows(pods[0]["w1"], counts, per_step, ring_in)
    del pods, ring_in
    return rows


# the serve phase: internlm2-20b at full width and depth
# (src/repro/configs/registry.py:22-25), random weights from the seed, the
# decode step of src/repro/models/serve.py:240 over the quantized and the
# raw cache, the PackedCache wire (serve.py:93-125) and the DecodeEngine
# (src/repro/models/engine.py:99); (c) at decode_32k's context
# (src/repro/configs/base.py:159) with its batch cut from 128 to 4
SERVE_ARCH = "internlm2-20b"
SERVE_B, SERVE_SEQ, SERVE_STEPS, SERVE_MORE = 8, 512, 256, 16
SERVE_CHAINS = ("kv-page", "kv-page-narrow", "kv-page-pred", "auto")
SERVE_QUANT_TOL = 0.15         # tests/test_models_smoke.py:115
SERVE_PROMPTS = (130, 17, 140)
SERVE_NEW = 8
SERVE_BATCHED_ROWS, SERVE_BATCHED_STEPS = (2, 4), 3
LONG_B, LONG_SEQ, LONG_POS, LONG_STEPS = 4, 32_768, 32_700, 5
B12_QUERIES = 4               # layer 0's queries B12 is held on, per part
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense


@contextlib.contextmanager
def closed_pages():
    """Wrap `models.serve._quantize_page` for the block: keep every page a
    step closes (the layer's planes, written in place, and a copy of the
    bfloat16 hot page it was made from; the copy is the wrapper's only
    work on the card).  Yields the list that `page_bound_tally` reads
    after the block."""
    from repro_torch.models import serve as S
    real, kept = S._quantize_page, []

    def wrapped(qkv, hot, page_idx, kv_cfg):
        out = real(qkv, hot, page_idx, kv_cfg)
        kept.append((out, hot.clone(), page_idx, kv_cfg))
        return out

    S._quantize_page = wrapped
    try:
        yield kept
    finally:
        S._quantize_page = real


def page_bound_tally(kept) -> dict:
    """Each kept page held against the hot page it was made from:
    {"pages", "violations", "overflow"}, where violations count the values
    of non-overflowed pages outside eb_rel * max|page| (finite values
    only)."""
    from repro_torch.compression import kv as KV
    tally = {"pages": 0, "violations": 0, "overflow": 0}
    for out, hot, page_idx, kv_cfg in kept:
        b, page, g, hd = hot.shape
        x = hot.permute(0, 2, 1, 3).to(torch.float32)       # [B, G, P, hd]
        sl = slice(page_idx * page, (page_idx + 1) * page)
        one = slice(page_idx, page_idx + 1)
        got = KV.QuantizedKV(out.bins[:, :, sl], out.eb2[:, :, one],
                             out.out_idx[:, :, one], out.out_val[:, :, one],
                             out.overflow[:, :, one])
        y = KV.dequantize_kv(got, page=page)
        xf = x.reshape(b, g, -1)
        finite = torch.isfinite(xf)
        amax = torch.where(finite, xf, torch.zeros_like(xf)).abs().amax(-1)
        eb = kv_cfg.error_bound * amax
        bad = finite & ((xf - y.reshape(b, g, -1)).abs() > eb[..., None])
        bad &= ~got.overflow.reshape(b, g, 1)
        tally["pages"] += b * g
        tally["violations"] += int(bad.sum())
        tally["overflow"] += int(got.overflow.sum())
    return tally


@contextlib.contextmanager
def first_call_args(mod, name: str):
    """Keep the arguments of the first call of mod.name with a tensor on
    DEV while the block runs (the main path's inputs of a kernel
    wrapper)."""
    real, kept = getattr(mod, name), []

    def wrapped(*args, **kw):
        if not kept and any(torch.is_tensor(a) and a.device.type == DEV
                            for a in args):
            kept.append(args)
        return real(*args, **kw)

    setattr(mod, name, wrapped)
    try:
        yield kept
    finally:
        setattr(mod, name, real)


def kv_wire_measured_bytes(p) -> float:
    """The bytes a PackedKV transmits, counted from its planes on the host:
    per page its transmitted payload words (all of them for a stage-free
    chain), each stage's header content words (the chosen fragment's for a
    selected wire), the 4-byte length of a length-variable chain (and the
    1-byte chain id of a selected one), eb2, the cap outlier (idx, val)
    slots and the 1-byte overflow flag; plus the 4-byte checksum."""
    from repro_torch.core import codec as C
    n_pages = p.payload_len.numel()
    wpp = p.payload.shape[-1]
    cap = p.out_idx.shape[-1]
    per_page = 4 + 8 * cap + 1
    words = int(p.payload_len.to(torch.int64).sum())

    def hdr_words(stages) -> int:
        return sum(C.lc_header_content_words(C.lc_chunk_count(wpp))
                   for _ in stages)

    if p.select is not None:
        per_id = torch.tensor([hdr_words(w) for _, w in p.select.chains])
        ids = p.chain_id.reshape(-1).cpu().to(torch.int64)
        hdr = int(per_id[ids].sum())
        total = n_pages * (per_page + 4 + 1) + 4 * (words + hdr)
    elif p.stages:
        total = n_pages * (per_page + 4 + 4 * hdr_words(p.stages)) + 4 * words
    else:
        total = n_pages * per_page + 4 * p.payload.numel()
    return float(total + (4 if p.checksum is not None else 0))


def cache_planes(c):
    return (*c.k, *c.v, c.hot_k, c.hot_v)


def caches_equal(a, b) -> bool:
    return all(planes_equal(x, y) for x, y in zip(cache_planes(a),
                                                  cache_planes(b)))


def serve_steps(step, cache, toks, pos0: int):
    """Run len(toks) decode steps from pos0, each timed by CUDA events (the
    host's enqueue included).  Returns (logits per step, ms per step)."""
    out, evs = [], []
    for i, t in enumerate(toks):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = step(cache, t, pos0 + i)
        b.record()
        out.append(logits)
        evs.append((a, b))
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in evs]


def step_bytes(params, lengths, b: int, hg: int, s: int, n_layers: int,
               g: int = KV_G, d: int = KV_D):
    """Least bytes of one decode step: every weight read once (every expert
    of a MoE layer too, as its step reads them), every layer's closed pages
    that hold a token < lengths (`kv_work`)."""
    w = sum(t.numel() * t.element_size() for t in
            (params["emb"], params["final_norm"],
             *params["layers"].values()))
    kv = n_layers * kv_work(lengths, b, hg, s, g, d)[0]
    return w + kv


def b12_outputs_agree(got, want) -> dict:
    """B12's (out, m, l) against its plain version's, output by output:
    the largest |difference|, the |plain value| where it falls, and the
    share of the allclose limit (KV_TOL + KV_TOL * |plain|) it uses, the
    largest over the elements."""
    res = {}
    for name, a, w in zip(("out", "m", "l"), got, want):
        d = (a.double() - w.double()).abs()
        used = d / (KV_TOL + KV_TOL * w.double().abs())
        i = int(torch.argmax(torch.nan_to_num(d, nan=float("inf"))))
        res[name] = {"max_abs_err": float(d.reshape(-1)[i]),
                     "at_abs_value": float(w.reshape(-1)[i].abs()),
                     "tolerance_used": float(torch.nan_to_num(
                         used, nan=float("inf")).max())}
    return res


def b12_row(label, qs, kq, vq, lengths, s: int, launches_: int) -> dict:
    """B12 at a serve call's shapes: the kernel with its (m, l) against its
    plain version for each query in qs (the first one is timed), timed
    beside the plain version and one scaled_dot_product_attention call
    over the dequantized cache."""
    import torch.nn.functional as F
    from repro_torch.compression import kv as KV
    from repro_torch.kernels import kv_attention as A
    name = "_kv_decode_attention"
    q = qs[0]
    b = q.shape[0]

    def kern(q=q):
        return A.kv_decode_attention(q, kq, vq, lengths, page=KV_PAGE,
                                     cap=KV_CAP, return_stats=True)

    def plain(q=q):
        return A._kv_decode_attention_plain(q, kq, vq, lengths, page=KV_PAGE,
                                            return_stats=True)

    close, err, per_q = True, 0.0, []
    for qi in qs:
        got, want = kern(qi), plain(qi)
        close &= all(bool(torch.allclose(a, w, rtol=KV_TOL, atol=KV_TOL))
                     for a, w in zip(got, want))
        err = max(err, *(max_abs_err(a, w) for a, w in zip(got, want)))
        per_q.append(b12_outputs_agree(got, want))
    check(close, f"serve: {name} ({label}) differs from its plain version "
                 f"by {err}")
    used = max(o["tolerance_used"] for r in per_q for o in r.values())
    kd, vd = (KV.dequantize_kv(t, page=KV_PAGE) for t in (kq, vq))
    mask = (torch.arange(s, device=DEV)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)

    ms, lib_ms = time_ms(kern), time_ms(library)
    per_call, dev_ms = device_kernels(kern)
    del kd, vd
    plain_ms = time_ms(plain, reps=3, warm=1)
    n_bytes, ops = kv_work(lengths, b, q.shape[2], s, q.shape[1], q.shape[3])
    bound_ms, bound_by = bound_from(n_bytes, ops)
    return {"name": name, "route": "cuda", "source": CSRC + KERNELS[name][0],
            "replaces": KERNELS[name][1], "chain": f"serve-{label}",
            "caller": "models.serve._attn_history",
            "stage": f"B={b} G={q.shape[1]} Hg={q.shape[2]} D={q.shape[3]} "
                     f"S={s} lengths={int(lengths[0])}",
            "bits": 8, "launches": launches_, "launches_per_call": per_call,
            "max_abs_err": err, "tolerance": KV_TOL, "match": close,
            "queries": len(qs), "tolerance_used": used,
            "outputs_by_query": per_q,
            "ms": ms, "device_ms": sum(dev_ms.values()) or None,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention over the dequantized "
                       "float32 cache (dequantization not included)"}


def layer0_queries(cfg, params, toks, pos: int, gen) -> list:
    """Layer 0's real queries at `pos`: for the tokens toks [B, 1] and for
    B12_QUERIES - 1 more seeded draws of tokens, each float32
    [B, G, Hg, D]."""
    from repro_torch.models import serve as S
    lp0 = {k: v[0] for k, v in params["layers"].items()}
    b = toks.shape[0]
    draws = [toks] + [torch.randint(0, cfg.vocab, toks.shape, generator=gen,
                                    device=DEV, dtype=toks.dtype)
                      for _ in range(B12_QUERIES - 1)]
    out = []
    for t in draws:
        x = params["emb"][t].to(torch.bfloat16)
        q, _, _ = S._project_token(cfg, lp0, x, pos)
        out.append(q.to(torch.float32).reshape(
            b, cfg.n_kv_heads, cfg.group_size, cfg.head_dim).contiguous())
    return out


def lc_rows(select_args, expand_args, counts) -> list:
    """B6 and B7 on the inputs pack_kv and unpack_kv gave them in the serve
    phase, held bit for bit against their plain versions."""
    from repro_torch.core import codec as C
    from repro_torch.kernels import lossless as L
    rows = []
    words, mode = select_args
    n = words.shape[0]
    sel, codes = L.lc_select(words, mode)
    hist = [int(v) for v in torch.bincount(codes.long(), minlength=4).cpu()]
    rows.append(kernel_row("_lc_select", "serve", "pack_kv", 8, n, hist,
                           lambda: L.lc_select(words, mode),
                           lambda: L._lc_select_plain(words, mode),
                           counts["_lc_select"]))
    padded, codes, n_words = expand_args
    hist = [int(v) for v in torch.bincount(codes.long(), minlength=4).cpu()]
    rows.append(kernel_row("_lc_expand", "serve", "unpack_kv", 8, n_words,
                           hist, lambda: L.lc_expand(padded, codes, n_words),
                           lambda: L._lc_expand_plain(padded, codes, n_words),
                           counts["_lc_expand"]))
    for r in rows:
        r["caller"] = ("compression.kv.pack_kv" if r["name"] == "_lc_select"
                       else "compression.kv.unpack_kv")
    return rows


def serve_aligned(cfg, params, seed: int) -> tuple:
    """(a): SERVE_B requests of seeded tokens for SERVE_STEPS steps through
    serve_step with the quantized and the raw cache; the wire for every
    chain in SERVE_CHAINS; the transfer between two thread ranks; 16 more
    steps on the received cache.  Returns (line, kernel rows, counts)."""
    from repro_torch.compression import kv as KV
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.core.axis import run_threads
    from repro_torch.core.transport import wire_bytes
    from repro_torch.kernels import lossless as L
    from repro_torch.models import serve as S
    kv_cfg = KV.kv_quantizer_config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 20)
    n_all = SERVE_STEPS + SERVE_MORE
    toks = torch.randint(0, cfg.vocab, (n_all, SERVE_B, 1), generator=gen,
                         device=DEV, dtype=torch.int32)
    qcache = S.make_quant_cache(cfg, SERVE_B, SERVE_SEQ, device=DEV)
    rcache = S.make_raw_cache(cfg, SERVE_B, SERVE_SEQ, device=DEV)

    def qstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, kv_cfg)

    def rstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, None)

    torch.cuda.synchronize()
    reset_launches()
    with closed_pages() as kept, plain_calls(SERVE_PLAIN_FNS) as plain:
        q_logits, q_ms = serve_steps(qstep, qcache, toks[:SERVE_STEPS], 0)
        counts = launches()
        r_logits, r_ms = serve_steps(rstep, rcache, toks[:SERVE_STEPS], 0)
        reset_launches()
        with first_call_args(L, "lc_select") as sel_args:
            wires = {c: S.pack_cache(qcache, stages=get_kv_chain(c),
                                     integrity=True) for c in SERVE_CHAINS}
        with first_call_args(L, "lc_expand") as exp_args:
            backs = {c: S.unpack_cache(w, verify=True)
                     for c, w in wires.items()}
        lc_counts = launches()
    pages = page_bound_tally(kept)
    del kept
    b12 = "_kv_decode_attention"
    # a B12 call is two kernel launches (split + merge), counted once
    check(counts[b12] == cfg.n_layers * (SERVE_STEPS - KV_PAGE),
          f"serve: {counts[b12]} B12 calls in (a), want "
          f"{cfg.n_layers * (SERVE_STEPS - KV_PAGE)}")
    check(pages["pages"] == 2 * 2 * cfg.n_layers * SERVE_B * cfg.n_kv_heads,
          f"serve: {pages['pages']} pages closed")
    check(pages["violations"] == 0,
          f"serve: {pages['violations']} values outside their page bound")
    check(plain["calls"] == 0, f"serve: {plain['calls']} plain calls")
    for c in SERVE_CHAINS:
        check(caches_equal(backs[c], qcache), f"serve: {c} round trip")
    rel = [float((lq - lr).abs().max() / lr.abs().max())
           for lq, lr in zip(q_logits, r_logits)]
    finite = all(bool(torch.isfinite(t).all()) for t in q_logits + r_logits)
    check(finite, "serve: a logit is not finite")
    check(max(rel) < SERVE_QUANT_TOL,
          f"serve: quantized logits {max(rel)} of max|raw| from the raw ones")
    acct = {c: float(wire_bytes(w)) for c, w in wires.items()}
    measured = {c: sum(kv_wire_measured_bytes(p) for p in (w.k, w.v))
                + 2 * w.hot_k.numel() * w.hot_k.element_size()
                for c, w in wires.items()}
    acct_err = {c: wire_bytes_error(acct[c], measured[c])
                for c in SERVE_CHAINS}
    for c in SERVE_CHAINS:
        check(acct_err[c] <= GRAD_WIRE_TOL,
              f"serve: {c} wire_bytes {acct[c]} against {measured[c]} "
              f"counted from its planes")
    raw_bytes = 2 * rcache.k.numel() * rcache.k.element_size()
    del r_logits, backs, rcache

    def rank(ax):
        mine = qcache if ax.rank == 0 else S.make_quant_cache(
            cfg, SERVE_B, SERVE_SEQ, device=DEV)
        return S.transfer_cache(mine, 0, 1, ax, stages=get_kv_chain("auto"))

    torch.cuda.synchronize()
    t0 = time.time()
    moved = run_threads(2, rank)[1]
    torch.cuda.synchronize()
    transfer_s = time.time() - t0
    check(caches_equal(moved, qcache), "serve: transfer_cache is not exact")
    more = toks[SERVE_STEPS:]
    la, _ = serve_steps(qstep, qcache, more, SERVE_STEPS)
    lb, _ = serve_steps(qstep, moved, more, SERVE_STEPS)
    after = all(planes_equal(a, b) for a, b in zip(la, lb))
    check(after, "serve: steps on the received cache differ")
    pos = [n_all]

    def one():
        qstep(qcache, toks[-1], pos[0])
        pos[0] += 1

    traced_a = {}
    kernels_a, dev_a = device_kernels(one, reps=2, per_kernel=traced_a)

    # B12 on layer 0's real q and cache (the next token's projection)
    b, hg = SERVE_B, cfg.group_size
    qs = layer0_queries(cfg, params, toks[-1], pos[0], gen)
    kq0 = KV.QuantizedKV(*(t[0] for t in qcache.k))
    vq0 = KV.QuantizedKV(*(t[0] for t in qcache.v))
    lens = torch.full((b,), pos[0] - pos[0] % KV_PAGE, dtype=torch.int32,
                      device=DEV)
    row_b12 = b12_row("a", qs, kq0, vq0, lens, SERVE_SEQ, counts[b12])
    rows = [row_b12] + lc_rows(sel_args[0][:2], exp_args[0][:3], lc_counts)
    hist_ms = statistics.median(q_ms[KV_PAGE:])
    line = {
        "phase": "serve", "part": "a", "arch": SERVE_ARCH,
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": SERVE_B, "seq": SERVE_SEQ, "steps": SERVE_STEPS,
        "step_ms_no_history": statistics.median(q_ms[:KV_PAGE]),
        "step_ms_with_history": hist_ms,
        "step_ms_page_close": [q_ms[KV_PAGE - 1], q_ms[SERVE_STEPS - 1]],
        "raw_step_ms": statistics.median(r_ms[KV_PAGE:]),
        "device_ms_per_step": sum(dev_a.values()) or None,
        "b12_device_ms_per_step": sum(
            v for k, v in dev_a.items() if k.startswith("kv_")) or None,
        "kernels_per_step": kernels_a,
        "step_bound_ms": bound_from(step_bytes(
            params, lens, b, hg, SERVE_SEQ, cfg.n_layers, cfg.n_kv_heads,
            cfg.head_dim),
            2 * sum(t.numel() for t in params["layers"].values()) * b)[0],
        "pages_closed": pages["pages"], "bound_violations":
            pages["violations"], "overflow_pages": pages["overflow"],
        "quant_vs_raw_max": max(rel), "quant_vs_raw_last": rel[-1],
        "tolerance": SERVE_QUANT_TOL,
        "b12_calls": counts[b12],
        # the wrapper's count of calls; each call launches the split and
        # the merge kernel (csrc/kv_attention.cu's C API)
        "b12_calls_per_step_with_history":
            counts[b12] / (SERVE_STEPS - KV_PAGE),
        "b12_kernel_launches_per_step_traced": sum(
            v for k, v in traced_a.items() if k.startswith("kv_")) or None,
        "wire_bytes": acct, "wire_bytes_counted": measured,
        "wire_bytes_rel_err": acct_err, "raw_cache_bytes": raw_bytes,
        "round_trips_exact": True, "transfer_s": transfer_s,
        "steps_after_transfer_bit_equal": after,
        "b12_max_abs_err": row_b12["max_abs_err"],
        "plain_calls": plain["calls"], "launches": counts}
    del wires, moved, qcache
    return line, rows


def serve_engine(cfg, params, seed: int, batched_rows=SERVE_BATCHED_ROWS,
                 phase: str = "serve") -> dict:
    """(b): DecodeEngine with 2 slots over 3 requests (one evict -> insert);
    each request's tokens and logits against the sequential batch-1
    serve_step path; then whether one aligned batched step of n rows, for
    n in `batched_rows`, keeps the batch-1 bits (the evidence for the
    engine's design)."""
    from repro_torch.compression import kv as KV
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.models import engine as E
    from repro_torch.models import serve as S
    gen = torch.Generator(device=DEV).manual_seed(seed + 21)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=DEV,
                             dtype=torch.int32) for n in SERVE_PROMPTS]
    eng = E.DecodeEngine(cfg, params, n_slots=2, seq=SERVE_SEQ,
                         stages=get_kv_chain("kv-page"), integrity="raise",
                         device=DEV)
    got = {r: [] for r in range(len(prompts))}
    t0 = time.time()
    pres = {r: eng.prefill(p) for r, p in enumerate(prompts)}
    for r in (0, 1):
        eng.insert(eng.allocate(), pres[r], request=r)
        got[r].append(pres[r].logits[0])
    evicted = False
    pending = [2]
    steps = 0
    while any(r is not None for r in eng.requests):
        logits, _ = eng.generate_step()
        steps += 1
        for slot, r in enumerate(list(eng.requests)):
            if r is None:
                continue
            got[r].append(logits[slot].clone())
            if len(got[r]) == SERVE_NEW:
                eng.release(slot)
                if pending:
                    r2 = pending.pop()
                    eng.insert(slot, pres[r2], request=r2)
                    got[r2].append(pres[r2].logits[0])
        if steps == 3 and not evicted:
            slot = eng.requests.index(1)
            pre = eng.evict(slot)
            check(eng.insert(slot, pre, request=1), "serve: re-insert")
            evicted = True
    torch.cuda.synchronize()
    engine_s = time.time() - t0
    same = True
    for r, p in enumerate(prompts):
        cache = S.make_quant_cache(cfg, 1, SERVE_SEQ, device=DEV)
        for i in range(p.shape[0]):
            logits, cache = eng.step_one(cache, p[i].reshape(1, 1), i)
        want = [logits[0]]
        for k in range(SERVE_NEW - 1):
            tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
            logits, cache = eng.step_one(cache, tok, p.shape[0] + k)
            want.append(logits[0])
        same &= all(planes_equal(a, b) for a, b in zip(got[r], want))
    check(same, f"{phase}: an engine slot's logits differ from batch-1")
    # aligned steps of n rows against n batch-1 steps: does one batched
    # step keep the batch-1 bits?
    kv_cfg = KV.kv_quantizer_config()
    batched = {}
    for n in batched_rows:
        toks = torch.randint(0, cfg.vocab, (SERVE_BATCHED_STEPS, n, 1),
                             generator=gen, device=DEV, dtype=torch.int32)
        cb = S.make_quant_cache(cfg, n, SERVE_SEQ, device=DEV)
        c1 = [S.make_quant_cache(cfg, 1, SERVE_SEQ, device=DEV)
              for _ in range(n)]
        first = None
        for pos in range(SERVE_BATCHED_STEPS):
            lb, _ = S.serve_step(cfg, params, cb, toks[pos], pos, None,
                                 kv_cfg)
            for s in range(n):
                l1, _ = S.serve_step(cfg, params, c1[s], toks[pos, s:s + 1],
                                     pos, None, kv_cfg)
                diff = l1[0].view(torch.int32) != lb[s].view(torch.int32)
                if first is None and bool(diff.any()):
                    i = int(diff.nonzero()[0])
                    first = {"pos": pos, "slot": s, "index": i,
                             "batch1": float(l1[0, i]),
                             "batched": float(lb[s, i]),
                             "n_differ": int(diff.sum())}
        batched[n] = {"bit_identical": first is None,
                      "first_differing_logit": first}
        del cb, c1
    st = eng.stats()
    return {"phase": phase, "part": "b", "arch": cfg.name, "slots": 2,
            "prompts": list(SERVE_PROMPTS), "new_tokens": SERVE_NEW,
            "engine_s": engine_s, "generate_steps": steps,
            "slots_bit_identical_to_batch1": same,
            "aligned_steps_vs_batch1": batched,
            "wire_bytes": st["wire_bytes"], "sends": st["sends"],
            "evictions": st["evictions"],
            "audit_checks": st["audit_checks"]}


def serve_long(cfg, params, seed: int, phase: str = "serve",
               label: str = "c") -> tuple:
    """(c): LONG_B requests at LONG_SEQ with every layer's closed pages from
    quantize_kv of seeded K, V = N(0,1)*0.7 and a hot page of LONG_POS %
    page tokens; LONG_STEPS steps from LONG_POS.  Returns (line, row)."""
    from repro_torch.compression import kv as KV
    from repro_torch.models import serve as S
    kv_cfg = KV.kv_quantizer_config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 22)
    cache = S.make_quant_cache(cfg, LONG_B, LONG_SEQ, device=DEV)
    g, d = cfg.n_kv_heads, cfg.head_dim
    t0 = time.time()
    for layer in range(cfg.n_layers):
        for qkv in (cache.k, cache.v):
            x = torch.randn((LONG_B, g, LONG_SEQ, d), generator=gen,
                            device=DEV) * 0.7
            qq = KV.quantize_kv(x, kv_cfg, page=KV_PAGE, cap=KV_CAP)
            for dst, src in zip(qkv, qq):
                dst[layer].copy_(src)
            del x, qq
    in_page = LONG_POS % KV_PAGE
    for hot in (cache.hot_k, cache.hot_v):
        hot[:, :, :in_page] = (torch.randn(hot[:, :, :in_page].shape,
                                           generator=gen, device=DEV)
                               * 0.7).to(hot.dtype)
    torch.cuda.synchronize()
    fill_s = time.time() - t0
    toks = torch.randint(0, cfg.vocab, (LONG_STEPS + 3, LONG_B, 1),
                         generator=gen, device=DEV, dtype=torch.int32)

    def qstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, kv_cfg)

    b12 = "_kv_decode_attention"
    reset_launches()
    logits, ms = serve_steps(qstep, cache, toks[:LONG_STEPS], LONG_POS)
    counts = launches()
    finite = all(bool(torch.isfinite(t).all()) for t in logits)
    check(finite, f"{phase} (c): a logit is not finite")
    per_step = counts[b12] / LONG_STEPS      # calls: split + merge each
    check(per_step == cfg.n_layers,
          f"{phase} (c): {per_step} B12 calls per step")
    pos = [LONG_POS + LONG_STEPS]

    def one():
        i = pos[0] - LONG_POS - LONG_STEPS
        qstep(cache, toks[LONG_STEPS + i], pos[0])
        pos[0] += 1

    traced = {}
    n_launch, dev_ms = device_kernels(one, reps=2, per_kernel=traced)
    b12_dev = sum(v for k, v in dev_ms.items() if k.startswith("kv_"))
    gemm_dev = sum(v for k, v in dev_ms.items()
                   if re.search(r"gemm|gemv|nvjet|sm90|cutlass|splitK", k, re.I))
    lens = torch.full((LONG_B,), LONG_POS - in_page, dtype=torch.int32,
                      device=DEV)
    n_bytes = step_bytes(params, lens, LONG_B, cfg.group_size, LONG_SEQ,
                         cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    ops = 2 * sum(t.numel() for t in params["layers"].values()) * LONG_B
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    # B12 alone on layer 0's cache at these lengths
    qs = layer0_queries(cfg, params, toks[-1], pos[0], gen)
    row = b12_row(label, qs, KV.QuantizedKV(*(t[0] for t in cache.k)),
                  KV.QuantizedKV(*(t[0] for t in cache.v)), lens, LONG_SEQ,
                  counts[b12])
    step_ms = statistics.median(ms)
    line = {"phase": phase, "part": "c", "arch": cfg.name, "batch": LONG_B,
            "seq": LONG_SEQ, "pos": LONG_POS, "steps": LONG_STEPS,
            "fill_s": fill_s, "step_ms": step_ms, "step_ms_all": ms,
            "step_bound_ms": bound_ms, "step_bytes": n_bytes,
            "share": bound_ms / step_ms,
            "device_ms_per_step": sum(dev_ms.values()) or None,
            "b12_device_ms_per_step": b12_dev or None,
            "gemm_device_ms_per_step": gemm_dev or None,
            "b12_share_of_step": (b12_dev / step_ms) if b12_dev else None,
            "kernels_per_step": n_launch,
            "b12_calls_per_step": per_step,
            "b12_kernel_launches_per_step_traced": sum(
                v for k, v in traced.items() if k.startswith("kv_")) or None,
            "device_ms_by_kernel": dev_ms,
            "logits_finite": finite,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    del cache
    return line, row


def serve_phase(seed: int) -> list:
    """internlm2-20b at full width and depth, made on the card from the
    seed: (a) the aligned batch, (b) the engine, (c) the long context.
    Frees the weights before it returns the kernel rows."""
    from repro_torch.configs.registry import get
    from repro_torch.models import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = get(SERVE_ARCH)
    bundle = build(cfg)
    t0 = time.time()
    params = bundle.init(torch.Generator(device=DEV).manual_seed(seed + 19),
                         device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = bundle.n_params()
    check(n_params == sum(t.numel() for t in
                          (params["emb"], params["final_norm"],
                           *params["layers"].values())),
          "serve: parameter count")
    line_a, rows = serve_aligned(cfg, params, seed)
    line_a.update(n_params=n_params, init_s=init_s)
    print(json.dumps(line_a), flush=True)
    print(json.dumps(serve_engine(cfg, params, seed)), flush=True)
    line_c, row_c = serve_long(cfg, params, seed)
    print(json.dumps(line_c), flush=True)
    del params
    torch.cuda.empty_cache()
    return rows + [row_c]


MOE_ARCH = "olmoe-1b-7b"
MOE_WIDE_ARCH, MOE_WIDE_LAYERS = "qwen3-moe-235b-a22b", 4
D80_ARCH = "stablelm-3b"
MOE_STEPS, MOE_SHORT_STEPS = 256, 136   # past two page closes; past one
STREAM_PROMPT, STREAM_MORE = 300, 8
PREFILL_LONG, PREFILL_CHECK, FLASH_S = 32_768, 256, 4096
# flash_attention against a float32 softmax: p rounded to bfloat16 moves
# the output by at most 2^-9 max|v| of its row, the bfloat16 output
# rounding by 2^-9 |o|; the limit is twice each
FLASH_RTOL, FLASH_VTOL = 2.0 ** -8, 2.0 ** -8


@contextlib.contextmanager
def moe_dispatch_counts():
    """Wrap `models.moe.dispatch_slots` for the block: per call, the
    (token, k) pairs dropped past the capacity and the distinct experts
    chosen, summed on the card (a few small kernels a call, no sync).
    Yields a dict read after the block: calls, pairs, and the 0-d tensors
    dropped and experts (None without a call)."""
    from repro_torch.models import moe as M
    real = M.dispatch_slots
    acc = {"calls": 0, "pairs": 0, "dropped": None, "experts": None}

    def wrapped(gate_idx, n_experts, cap):
        pos, keep, slot = real(gate_idx, n_experts, cap)
        dropped = (~keep).sum()
        used = torch.nn.functional.one_hot(
            gate_idx.reshape(-1), n_experts).amax(0).sum()
        for key, v in (("dropped", dropped), ("experts", used)):
            acc[key] = v if acc[key] is None else acc[key] + v
        acc["calls"] += 1
        acc["pairs"] += keep.numel()
        return pos, keep, slot

    M.dispatch_slots = wrapped
    try:
        yield acc
    finally:
        M.dispatch_slots = real


def dispatch_summary(acc: dict, per: int, unit: str = "step") -> dict:
    """The dropped pairs and the distinct experts of `moe_dispatch_counts`,
    in total and per `unit` (`per` of them: steps, or a prefill's
    layers)."""
    if not acc["calls"]:
        return {"dispatch_calls": 0}
    dropped = int(acc["dropped"])
    return {"dispatch_calls": acc["calls"], "pairs": acc["pairs"],
            "pairs_dropped": dropped, f"pairs_dropped_per_{unit}": dropped / per,
            "dropped_share": dropped / acc["pairs"],
            "experts_used_per_call": int(acc["experts"]) / acc["calls"]}


def expert_bytes(params) -> int:
    """Bytes of the expert weights (w1, w3, w2 of the MoE layers)."""
    lay = params["layers"]
    if "router" not in lay:
        return 0
    return sum(lay[k].numel() * lay[k].element_size()
               for k in ("w1", "w3", "w2"))


def device_groups(dev_ms: dict) -> dict:
    """A step's device ms by kind: B12, the GEMMs, the MoE dispatch's
    scatter and gather (indexing kernels), the rest."""
    out = {"b12": 0.0, "gemm": 0.0, "dispatch_index": 0.0, "other": 0.0}
    for k, v in dev_ms.items():
        if k.startswith("kv_"):
            out["b12"] += v
        elif re.search(r"gemm|gemv|nvjet|sm90|cutlass|splitK", k, re.I):
            out["gemm"] += v
        elif re.search(r"index|scatter|gather", k, re.I):
            out["dispatch_index"] += v
        else:
            out["other"] += v
    return out


def aligned_run(cfg, params, seed: int, steps: int, label: str) -> tuple:
    """SERVE_B requests of seeded tokens for `steps` steps at SERVE_SEQ
    through serve_step with the quantized cache and with the raw one: the
    checks of serve (a) (every closed page within its bound, quantized
    logits within SERVE_QUANT_TOL of the raw ones' max, B12 with (m, l)
    within KV_TOL of its plain version on layer 0's real queries, no plain
    call), the step times, a profiled step by kernel kind, the bound with
    every expert read once and with the experts the steps routed to, and
    the pairs dropped.  Returns (line, B12 row)."""
    from repro_torch.compression import kv as KV
    from repro_torch.models import serve as S
    kv_cfg = KV.kv_quantizer_config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 30)
    toks = torch.randint(0, cfg.vocab, (steps + 1, SERVE_B, 1),
                         generator=gen, device=DEV, dtype=torch.int32)
    qcache = S.make_quant_cache(cfg, SERVE_B, SERVE_SEQ, device=DEV)
    rcache = S.make_raw_cache(cfg, SERVE_B, SERVE_SEQ, device=DEV)

    def qstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, kv_cfg)

    def rstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with closed_pages() as kept, plain_calls(SERVE_PLAIN_FNS) as plain, \
            moe_dispatch_counts() as moe:
        q_logits, q_ms = serve_steps(qstep, qcache, toks[:steps], 0)
        counts = launches()
    r_logits, r_ms = serve_steps(rstep, rcache, toks[:steps], 0)
    pages = page_bound_tally(kept)
    del kept
    b12 = "_kv_decode_attention"
    closes = steps // KV_PAGE
    check(counts[b12] == cfg.n_layers * (steps - KV_PAGE),
          f"moe ({label}): {counts[b12]} B12 calls, want "
          f"{cfg.n_layers * (steps - KV_PAGE)}")
    check(pages["pages"] == 2 * closes * cfg.n_layers * SERVE_B
          * cfg.n_kv_heads, f"moe ({label}): {pages['pages']} pages closed")
    check(pages["violations"] == 0,
          f"moe ({label}): {pages['violations']} values outside their "
          f"page bound")
    check(plain["calls"] == 0, f"moe ({label}): {plain['calls']} plain calls")
    rel = [float((lq - lr).abs().max() / lr.abs().max())
           for lq, lr in zip(q_logits, r_logits)]
    finite = all(bool(torch.isfinite(t).all()) for t in q_logits + r_logits)
    check(finite, f"moe ({label}): a logit is not finite")
    check(max(rel) < SERVE_QUANT_TOL,
          f"moe ({label}): quantized logits {max(rel)} of max|raw| from the "
          f"raw ones")
    del r_logits, rcache
    pos = [steps]

    def one():
        qstep(qcache, toks[-1], pos[0])
        pos[0] += 1

    traced = {}
    kernels, dev = device_kernels(one, reps=2, per_kernel=traced)
    qs = layer0_queries(cfg, params, toks[-1], pos[0], gen)
    kq0 = KV.QuantizedKV(*(t[0] for t in qcache.k))
    vq0 = KV.QuantizedKV(*(t[0] for t in qcache.v))
    lens = torch.full((SERVE_B,), pos[0] - pos[0] % KV_PAGE,
                      dtype=torch.int32, device=DEV)
    row = b12_row(label, qs, kq0, vq0, lens, SERVE_SEQ, counts[b12])
    n_bytes = step_bytes(params, lens, SERVE_B, cfg.group_size, SERVE_SEQ,
                         cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    ops = 2 * sum(t.numel() for t in params["layers"].values()) * SERVE_B
    disp = dispatch_summary(moe, steps)
    eb = expert_bytes(params)
    routed = n_bytes - eb + (eb * disp["experts_used_per_call"]
                             / cfg.moe_experts if eb else 0)
    hist_ms = statistics.median(q_ms[KV_PAGE:])
    line = {"phase": "moe", "part": label[-1], "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "kv_heads": cfg.n_kv_heads, "hg": cfg.group_size,
            "head_dim": cfg.head_dim, "experts": cfg.moe_experts,
            "top_k": cfg.moe_top_k, "batch": SERVE_B, "seq": SERVE_SEQ,
            "steps": steps,
            "step_ms_no_history": statistics.median(q_ms[:KV_PAGE]),
            "step_ms_with_history": hist_ms,
            "step_ms_page_close": [q_ms[KV_PAGE * (i + 1) - 1]
                                   for i in range(closes)],
            "raw_step_ms": statistics.median(r_ms[KV_PAGE:]),
            "step_bytes": n_bytes,
            "step_bound_ms": bound_from(n_bytes, ops)[0],
            "step_bound_routed_ms": routed / HBM_BYTES_PER_S * 1e3,
            "share": bound_from(n_bytes, ops)[0] / hist_ms,
            "device_ms_per_step": sum(dev.values()) or None,
            "device_ms_by_kind": device_groups(dev),
            "device_ms_top_kernels": dict(sorted(
                dev.items(), key=lambda kv: -kv[1])[:8]),
            "kernels_per_step": kernels,
            "b12_kernel_launches_per_step_traced": sum(
                v for k, v in traced.items() if k.startswith("kv_")) or None,
            "pages_closed": pages["pages"],
            "bound_violations": pages["violations"],
            "overflow_pages": pages["overflow"],
            "quant_vs_raw_max": max(rel), "quant_vs_raw_last": rel[-1],
            "tolerance": SERVE_QUANT_TOL, "b12_calls": counts[b12],
            "b12_max_abs_err": row["max_abs_err"],
            "b12_tolerance_used": row["tolerance_used"],
            "plain_calls": plain["calls"], **disp,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    del qcache
    return line, row


def moe_stream(cfg, params, seed: int) -> dict:
    """(b), second half: stream_prefill of a STREAM_PROMPT-token prompt from
    rank 0 to rank 1 of a 2-thread axis on the card; the assembled cache
    bit-identical to the source cache (the batch-1 serve_step chain) and
    STREAM_MORE steps on it bit-equal to as many on the source."""
    from repro_torch.compression import kv as KV
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.core.axis import run_threads
    from repro_torch.models import engine as E
    from repro_torch.models import serve as S
    kv_cfg = KV.kv_quantizer_config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 31)
    prompt = torch.randint(0, cfg.vocab, (STREAM_PROMPT,), generator=gen,
                           device=DEV, dtype=torch.int32)
    stages = get_kv_chain("kv-page")
    torch.cuda.synchronize()
    t0 = time.time()
    got = run_threads(2, lambda ax: E.stream_prefill(
        cfg, params, prompt, seq=SERVE_SEQ, axis=ax, stages=stages))[1]
    torch.cuda.synchronize()
    stream_s = time.time() - t0
    src = S.make_quant_cache(cfg, 1, SERVE_SEQ, device=DEV)
    for i in range(STREAM_PROMPT):
        logits, src = S.serve_step(cfg, params, src, prompt[i].reshape(1, 1),
                                   i, None, kv_cfg)
    check(caches_equal(got.cache, src),
          "moe (b): the streamed cache differs from the source")
    check(planes_equal(got.logits, logits),
          "moe (b): the streamed logits differ from the source's")
    a, b, tok, same = E._clone_cache(got.cache), src, got.next_token, True
    for i in range(STREAM_MORE):
        la, a = S.serve_step(cfg, params, a, tok, STREAM_PROMPT + i, None,
                             kv_cfg)
        lb, b = S.serve_step(cfg, params, b, tok, STREAM_PROMPT + i, None,
                             kv_cfg)
        same &= planes_equal(la, lb)
        tok = torch.argmax(la, -1).to(torch.int32).reshape(1, 1)
    check(same, "moe (b): steps on the streamed cache differ")
    st = got.stats
    raw = 2 * cfg.n_layers * SERVE_SEQ * cfg.n_kv_heads * cfg.head_dim * 2
    return {"prompt": STREAM_PROMPT, "stream_s": stream_s,
            "pages_streamed": st["pages_streamed"], "sends": st["sends"],
            "wire_bytes": st["wire_bytes"], "ledger": st["ledger"],
            "raw_slot_bytes": raw, "cache_bit_identical": True,
            "steps_after_bit_equal": same}


def moe_prefill(cfg, params, seed: int) -> dict:
    """(d): ModelBundle.prefill at B = 1 over PREFILL_LONG tokens (time,
    peak memory, pairs dropped); a PREFILL_CHECK-token prefill against as
    many raw-cache serve_steps, with the reference's capacity and with a
    capacity that drops nothing; flash_attention on layer 0's real q, k, v
    at FLASH_S tokens against a float32 softmax attention."""
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import serve as S
    bundle = build(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed + 32)
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_LONG), generator=gen,
                         device=DEV, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with moe_dispatch_counts() as moe:
        a.record()
        last = bundle.prefill(params, {"tokens": toks})
        b.record()
        b.synchronize()
    ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(last.shape == (1, cfg.padded_vocab) and last.dtype == torch.float32
          and bool(torch.isfinite(last).all()),
          "moe (d): the 32K prefill's logits")
    disp = dispatch_summary(moe, cfg.n_layers, "layer")
    # 256-token prefill against 256 raw-cache decode steps
    short = toks[:, :PREFILL_CHECK]
    with moe_dispatch_counts() as moe_short:
        last_ref_cap = bundle.prefill(params, {"tokens": short})
    real_cap = M.capacity
    M.capacity = lambda n, e, k, f=1.0: n * k     # every pair kept
    try:
        with moe_dispatch_counts() as moe_all:
            last_all = bundle.prefill(params, {"tokens": short})
    finally:
        M.capacity = real_cap
    rc = S.make_raw_cache(cfg, 1, PREFILL_CHECK, device=DEV)
    for i in range(PREFILL_CHECK):
        lr, rc = S.serve_step(cfg, params, rc, short[:, i:i + 1], i)
    del rc
    gap_cap = float((last_ref_cap - lr).abs().max() / lr.abs().max())
    gap_all = float((last_all - lr).abs().max() / lr.abs().max())
    check(int(moe_all["dropped"]) == 0, "moe (d): a pair dropped")
    check(gap_all < SERVE_QUANT_TOL,
          f"moe (d): prefill's last logits {gap_all} of max|decode| from "
          f"the decode steps'")
    # flash_attention on layer 0's real q, k, v
    with first_call_args(L, "flash_attention") as qkv:
        bundle.prefill(params, {"tokens": toks[:, :FLASH_S]})
    q, k, v = qkv[0][:3]
    got = L.flash_attention(q, k, v).float()
    hd = q.shape[-1]
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    sc = torch.matmul(qf, kf.transpose(-1, -2)) / hd ** 0.5
    causal = torch.ones((FLASH_S, FLASH_S), dtype=torch.bool,
                        device=DEV).tril()
    sc = torch.where(causal, sc, torch.full((), -float("inf"), device=DEV))
    want = torch.matmul(torch.softmax(sc, -1), vf).permute(0, 2, 1, 3)
    del sc, causal
    vmax = vf.abs().amax(dim=(0, 2, 3))[None, None, :, None]  # per head
    limit = FLASH_RTOL * want.abs() + FLASH_VTOL * vmax
    used = float(((got - want).abs() / limit).max())
    flash_err = float((got - want).abs().max())
    check(used <= 1.0, f"moe (d): flash_attention {flash_err} from float32 "
                       f"attention ({used} of its limit)")
    return {"phase": "moe", "part": "d", "arch": cfg.name, "batch": 1,
            "tokens": PREFILL_LONG, "prefill_ms": ms,
            "tokens_per_s": PREFILL_LONG / ms * 1e3,
            "peak_device_GB": peak, "weights_GB": base_gb, **disp,
            "check_tokens": PREFILL_CHECK,
            "prefill_vs_decode_all_kept": gap_all,
            "prefill_vs_decode_reference_capacity": gap_cap,
            "check_pairs_dropped_reference_capacity":
                int(moe_short["dropped"]),
            "check_pairs": moe_short["pairs"],
            "tolerance": SERVE_QUANT_TOL,
            "flash_tokens": FLASH_S, "flash_max_abs_err": flash_err,
            "flash_tolerance": f"{FLASH_RTOL}*|o| + {FLASH_VTOL}*max|v|",
            "flash_tolerance_used": used}


def moe_phase(seed: int) -> list:
    """The MoE family and head dim 80 on the card: olmoe-1b-7b at full width
    and depth, (a) the aligned batch, (b) the engine and stream_prefill,
    (c) the long context, (d) prefill; (e) qwen3-moe-235b-a22b at full
    width, MOE_WIDE_LAYERS of its layers; (f) stablelm-3b at full width and
    depth (B12 at D = 80).  Frees each model's weights before the next.
    Returns the kernel rows."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.kernels import lossless as LC
    from repro_torch.models import build
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def load(cfg, offset):
        bundle = build(cfg)
        t0 = time.time()
        params = bundle.init(
            torch.Generator(device=DEV).manual_seed(seed + offset),
            device=DEV)
        torch.cuda.synchronize()
        check(bundle.n_params() == sum(
            t.numel() for t in (params["emb"], params["final_norm"],
                                *params["layers"].values())),
            f"moe: {cfg.name} parameter count")
        return params, {"n_params": bundle.n_params(),
                        "weights_GB": torch.cuda.memory_allocated() / 1e9,
                        "init_s": time.time() - t0}

    cfg = get(MOE_ARCH)
    params, info = load(cfg, 33)
    line, row = aligned_run(cfg, params, seed, MOE_STEPS, "moe-a")
    print(json.dumps({**line, **info}), flush=True)
    rows.append(row)
    reset_launches()
    with first_call_args(LC, "lc_select") as sel_args, \
            first_call_args(LC, "lc_expand") as exp_args:
        line_b = serve_engine(cfg, params, seed, batched_rows=(),
                              phase="moe")
        lc_counts = launches()
    line_b["stream"] = moe_stream(cfg, params, seed)
    print(json.dumps(line_b), flush=True)
    rows += lc_rows(sel_args[0][:2], exp_args[0][:3], lc_counts)
    line_c, row_c = serve_long(cfg, params, seed, phase="moe",
                               label="moe-c")
    eb = expert_bytes(params)
    line_c["expert_bytes"] = eb
    line_c["step_bound_active_ms"] = (
        line_c["step_bytes"] - eb + eb * min(
            1.0, LONG_B * cfg.moe_top_k / cfg.moe_experts)) \
        / HBM_BYTES_PER_S * 1e3
    print(json.dumps(line_c), flush=True)
    rows.append(row_c)
    print(json.dumps(moe_prefill(cfg, params, seed)), flush=True)
    del params
    torch.cuda.empty_cache()

    for name, layers, label, offset in (
            (MOE_WIDE_ARCH, MOE_WIDE_LAYERS, "moe-e", 34),
            (D80_ARCH, None, "moe-f", 35)):
        cfg = get(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params, info = load(cfg, offset)
        line, row = aligned_run(cfg, params, seed, MOE_SHORT_STEPS, label)
        line.update(info, full_layers=get(name).n_layers)
        print(json.dumps(line), flush=True)
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    return rows


# the train phase: internlm2-20b at full width (src/repro/configs/registry.py
# :22-25) on 2 of its 48 layers (two replicas' AdamW state and the pods'
# residuals hold ~54 GB at 2 layers; 4 do not fit one card), AdamW as in
# examples/train_grad_compression.py:40 with a warmup of 2 for 6 steps, the
# token pipeline of src/repro/data/pipeline.py:40, the full-precision step
# and the compressed step of src/repro/launch/train.py:37,49 over 2 pods as
# threads; then the loop and the checkpoint (runtime/train_loop.py:126,
# checkpoint/manager.py:37) on the reduced configuration
TRAIN_ARCH = "internlm2-20b"
TRAIN_LAYERS = 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_PODS = 512, 8, 6, 2
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_WIRES = ("grad-wire-8", "grad-wire-16-narrow")
TRAIN_HELD = (1, TRAIN_STEPS)          # steps held leaf by leaf
TRAIN_ROWS = ("_quantize_abs", "_lc_select", "_lc_expand", "_abs_unpack")
TRAIN_TRACE = {"quantize_abs_kernel": "B8", "select_kernel": "B6",
               "expand_kernel": "B7", "unpack_kernel": "B2"}
BF16_OPS_PER_S = 989e12                # H100 SXM dense bf16, tensor cores
LOOP_STEPS, LOOP_SEQ, LOOP_BATCH = 6, 64, 8
LOSSY_EB = 1e-6


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def cuda_mark():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def step_phases():
    """Wrap the step's compressed mean and its optimizer for the block: the
    pods enter and leave the mean together (a collective over their axis),
    and rank 0 records a CUDA event at each border (the optimizer runs on
    rank 0 alone when the pods share their state), so `marks` holds the
    stream's positions at the phase borders, in order: (name, event)."""
    from repro_torch.compression import grads as G
    from repro_torch.optim import optimizer as O
    real_cm, real_apply = G.compressed_mean_tree, O.apply
    local, marks = threading.local(), []

    def border(name, ax=None):
        if ax is not None:
            ax.psum(torch.zeros((), device=DEV))
        if getattr(local, "rank", 0) == 0:
            marks.append((name, cuda_mark()))
        if ax is not None:
            ax.psum(torch.zeros((), device=DEV))

    def cm(grads, residuals, cfg, axis, *a, **kw):
        local.rank = axis.rank
        border("mean", axis)
        out = real_cm(grads, residuals, cfg, axis, *a, **kw)
        border("mean_end", axis)
        return out

    def apply(*a, **kw):
        border("optimizer")
        out = real_apply(*a, **kw)
        border("optimizer_end")
        return out

    G.compressed_mean_tree, O.apply = cm, apply
    try:
        yield marks
    finally:
        G.compressed_mean_tree, O.apply = real_cm, real_apply


def phase_ms(start, end, marks) -> dict:
    """{phase: ms} of one step from its border events."""
    ev = dict(marks)
    first = ev.get("mean", ev["optimizer"])
    out = {"forward_backward": start.elapsed_time(first),
           "optimizer": ev["optimizer"].elapsed_time(ev["optimizer_end"]),
           "step": start.elapsed_time(end)}
    if "mean" in ev:
        out["compressed_mean"] = ev["mean"].elapsed_time(ev["mean_end"])
    return out


@contextlib.contextmanager
def held_leaves(label: str, names: list, facts: dict, keep: dict,
                plain: dict):
    """Wrap compress_shard and compressed_mean for the block: as the pods
    finish each leaf, rank 0 holds it by `grad_check_leaf` on the wires
    the pods sent, their inputs, means and residuals, while the others
    wait; nothing is kept after, except pod 0's float32 input of each
    leaf named in `keep`.  The check's own plain decodes are taken out of
    the `plain_calls` count `plain` (the other pods wait meanwhile)."""
    from repro_torch.compression import grads as G
    real_cs, real_cm = G.compress_shard, G.compressed_mean
    local, slots = threading.local(), [None] * TRAIN_PODS

    def cs(*a, **kw):
        out = real_cs(*a, **kw)
        local.shard = out[0]
        return out

    def cm(g, cfg, axis, **kw):
        mean, resid = real_cm(g, cfg, axis, **kw)
        i = getattr(local, "i", 0)
        local.i = i + 1
        slots[axis.rank] = (g, local.shard, mean, resid)
        axis.psum(torch.zeros((), device=DEV))
        if axis.rank == 0:
            ins, shards, means, resids = zip(*slots)
            counted = plain["calls"]
            grad_check_leaf(label, names[i], ins, shards, means, resids,
                            facts)
            plain["calls"] = counted
            if names[i] in keep:
                keep[names[i]] = ins[0].float()
        axis.psum(torch.zeros((), device=DEV))
        slots[axis.rank] = local.shard = None
        return mean, resid

    G.compress_shard, G.compressed_mean = cs, cm
    try:
        yield
    finally:
        G.compress_shard, G.compressed_mean = real_cs, real_cm


def train_bound(n_params: int, pods: int) -> dict:
    """The least time of a step: 6 N tokens bf16 operations over the
    card's dense bf16 rate, or the state read and written once over the
    HBM rate (params bf16 and AdamW's float32 mu, nu and master, 28 N
    bytes; with pods, each pod's float32 residual, 8 N), the larger."""
    ops = 6 * n_params * TRAIN_BATCH * TRAIN_SEQ
    n_bytes = n_params * (28 + (8 * pods if pods > 1 else 0))
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "ops": ops,
            "bytes": n_bytes, "rate": "989 TFLOP/s bf16 dense, 3.35 TB/s"}


def train_run(bundle, label: str, spec, fresh, batches, keep: dict):
    """TRAIN_STEPS steps of one configuration from fresh weights: spec None
    is `make_train_step` on the whole batch; else the compressed step
    over TRAIN_PODS pods as threads holding one state (two replicas of
    the full-width state and the emb leaf's encode on both pods at once
    do not fit the card: shared_state=True), the residuals pod-stacked;
    then two more, the second under torch.profiler.  Steps TRAIN_HELD
    are held leaf by leaf; after every step `plain_calls` is 0 and the
    loss finite.  Returns (line, launch counts, the final master)."""
    from repro_torch.compression import grads as G
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.core.axis import run_threads
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    ocfg = O.AdamWConfig(**TRAIN_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pods = 1 if spec is None else TRAIN_PODS
    params = fresh()
    state = (params, O.init(params, ocfg))
    if spec is None:
        step = TL.make_train_step(bundle, None, ocfg, donate=True)

        def run_step(b):
            return step(state, b)[1]
    else:
        gc = G.GradCompressionConfig(eb_rel=GRAD_EB_REL,
                                     pipeline=get_pipeline(spec))
        step = TL.make_train_step_compressed(bundle, None, ocfg, gc,
                                             donate=True, shared_state=True)
        state = (*state, TL.init_residuals(params, TRAIN_PODS))

        def run_step(b):
            outs = run_threads(TRAIN_PODS, lambda ax: step(state, b, ax))
            check(all(o[0][0] is params for o in outs),
                  f"train {label}: a pod returned another state")
            return outs[0][1]
    names = leaf_names(params)
    losses, times, counts, held = [], [], {}, []
    for i in range(TRAIN_STEPS):
        hold = spec is not None and i + 1 in TRAIN_HELD
        facts = grad_facts()
        torch.cuda.synchronize()
        reset_launches()
        with plain_calls() as plain, step_phases() as marks, (
                held_leaves(f"train {label} step {i + 1}", names, facts,
                            keep if i + 1 == TRAIN_STEPS else {}, plain)
                if hold else contextlib.nullcontext()):
            a = cuda_mark()
            metrics = run_step(batches[i])
            b = cuda_mark()
            b.synchronize()
        for k, v in launches().items():
            counts[k] = counts.get(k, 0) + v
        check(plain["calls"] == 0, f"train {label}: the card's path called "
                                   "a plain quantizer or codec")
        loss = float(metrics["loss"])
        check(np.isfinite(loss), f"train {label}: loss {loss} at step {i + 1}")
        losses.append(loss)
        times.append(dict(phase_ms(a, b, marks), held=hold))
        if hold:
            held.append(facts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # two more steps: a warm-up and the traced one
    n_kernels, dev_ms = device_kernels(
        lambda: run_step(batches[TRAIN_STEPS]), reps=1)
    traced = {"kernels": n_kernels,
              "device_busy_ms": sum(dev_ms.values()) or None,
              "device_ms": {b: dev_ms.get(k, 0.0)
                            for k, b in TRAIN_TRACE.items()}}
    free = [t for t in times if not t["held"]]
    med = {k: statistics.median(t[k] for t in free)
           for k in free[0] if k != "held"}
    line = {"phase": "train", "config": label, "spec": None if spec is None
            else get_pipeline(spec), "model": TRAIN_ARCH,
            "layers": f"{TRAIN_LAYERS} of 48", "n_params": bundle.n_params(),
            "pods": pods, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "loss": losses, "step_ms": times,
            "median_ms": med, **train_bound(bundle.n_params(), pods),
            "peak_device_GB": peak, "profiled_step": traced,
            "launches_per_step": {k: counts.get(k, 0) / TRAIN_STEPS for k in (
                "_quantize_abs", "_lc_select", "_lc_expand", "_abs_unpack",
                "_dequantize_abs")}}
    if held:
        line.update(
            eb_rel=GRAD_EB_REL, branch=held[-1]["branch"],
            bytes_moved_per_step=[f["bytes_moved"] for f in held],
            f32_allreduce_bytes_per_step=held[-1]["f32_bytes"],
            ratio_vs_f32=[f["f32_bytes"] / f["bytes_moved"] for f in held],
            max_resid_over_eb=max(f["max_resid_over_eb"] for f in held),
            held_steps=list(TRAIN_HELD), plain_calls=0)
    master = state[1].master
    del state, params, step
    return line, counts, master


def train_serializer(master) -> dict:
    """The lossy checkpoint's coder (`core.serializer`, ABS at LOSSY_EB) on
    layer 0's wq float32 master at full width: its ratio on the host's
    zlib stream and on the device wire, seconds to serialize and to
    deserialize, and every value within eb."""
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.core.serializer import (compression_ratio, deserialize,
                                             serialize)
    x = master["layers"]["wq"][0].cpu().numpy().reshape(-1)
    qc = QuantizerConfig("abs", LOSSY_EB)
    t0 = time.perf_counter()
    stream = serialize(x, qc)
    t1 = time.perf_counter()
    y, _ = deserialize(stream)
    t2 = time.perf_counter()
    err = float(np.abs(x.astype(np.float64) - y).max())
    check(err <= LOSSY_EB, f"train: the lossy coder's error {err} > eb")
    return {"values": int(x.size), "eb": LOSSY_EB,
            "host_ratio": x.nbytes / len(stream),
            "device_ratio": compression_ratio(x, qc, wire="device",
                                              device=DEV),
            "serialize_s": t1 - t0, "deserialize_s": t2 - t1,
            "max_err": err}


def train_loop_check(seed: int) -> dict:
    """The loop and the checkpoint on the card, on the reduced
    configuration, with the compressed step over 2 thread pods: LOOP_STEPS
    steps of the pure replica step in `run` (checkpoint_every=2) against
    3 steps of the shared-state donating one (the full-width run's), a
    SIGTERM at step 3 and a resume by `resume_or_init` to LOOP_STEPS:
    params, OptState and residuals bit-identical with a raw checkpoint,
    whose step-2 checkpoint is the state after two steps; with a lossy
    one (ABS at LOSSY_EB) every restored value within eb.  Each step
    also encodes pod 0's new w1 residual with verify=True, and
    `AuditCounters` must fold one report a step with 0 violations."""
    import os
    import signal
    import tempfile
    from repro_torch import tree as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression import grads as G
    from repro_torch.configs.registry import get, get_pipeline
    from repro_torch.core.axis import run_threads
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.core.pipeline import parse_pipeline
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as TL
    from repro_torch.models import build
    from repro_torch.optim import optimizer as O
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                resume_or_init, run)
    cfg = get(TRAIN_ARCH).reduced()
    bundle = build(cfg)
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=LOOP_STEPS)
    gc = G.GradCompressionConfig(eb_rel=GRAD_EB_REL,
                                 pipeline=get_pipeline("grad-wire-8"))
    step = TL.make_train_step_compressed(bundle, None, ocfg, gc)
    batch_fn = TokenPipeline(DataConfig(cfg.vocab, LOOP_SEQ, LOOP_BATCH,
                                        seed)).batch
    audited = parse_pipeline(get_pipeline("grad-wire-8"))

    def init_fn(device):
        if device == "meta":
            params = bundle.abstract_params()
        else:
            params = bundle.init(torch.Generator(device=device).manual_seed(
                seed + 50), device=device)
        return (params, O.init(params, ocfg),
                TL.init_residuals(params, TRAIN_PODS))

    shared = TL.make_train_step_compressed(bundle, None, ocfg, gc,
                                           donate=True, shared_state=True)

    def step_fn(state, batch, stp=step):
        outs = run_threads(TRAIN_PODS, lambda ax: stp(state, batch, ax))
        (new, m), (other, _) = outs[0], outs[1]
        check(same(new[:2], other[:2]), "train loop: the pods' replicas "
                                        "differ after a step")
        w1 = new[2]["layers"]["w1"][0].reshape(-1)
        _, rep = audited.encode(w1, rms_eb(w1), device=DEV, verify=True)
        return new, dict(m, audit=rep)

    def shared_fn(state, batch):
        return step_fn(state, batch, shared)

    def preempt(step_, metrics, dt, straggle):
        if step_ == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    def same(a, b):
        return all(planes_equal(x, y) for x, y in zip(T.leaves(a),
                                                      T.leaves(b)))
    loop = TrainLoopConfig(total_steps=LOOP_STEPS, checkpoint_every=2,
                           log_every=1)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        seen, states = [], []

        def recorded(state, batch):     # the pure step's states are kept
            new, m = step_fn(state, batch)
            states.append(new)
            return new, m
        t0 = time.perf_counter()
        full, last, stopped = run(
            recorded, init_fn(DEV), batch_fn,
            CheckpointManager(os.path.join(d, "full")), loop,
            on_metrics=lambda s, m, dt, st: seen.append(m))
        out["uninterrupted_s"] = time.perf_counter() - t0
        out["loss"] = [float(m["loss"]) for m in seen]
        check(last == LOOP_STEPS and not stopped, "train loop: cut short")
        audit = seen[-1]["audit_cumulative"]
        check(audit["audit_reports"] == LOOP_STEPS
              and audit["audit_violations"] == 0,
              f"train loop: AuditCounters folded {audit}")
        out["audit_cumulative"] = audit
        for tag, lossy in (("raw", None),
                           ("lossy", QuantizerConfig("abs", LOSSY_EB))):
            mgr = CheckpointManager(os.path.join(d, tag), lossy=lossy)
            part, last, stopped = run(shared_fn, init_fn(DEV), batch_fn, mgr,
                                      loop, on_metrics=preempt)
            check(stopped and last == 3 and mgr.all_steps() == [2, 3],
                  f"train loop ({tag}): SIGTERM at step 3 gave step {last}, "
                  f"checkpoints {mgr.all_steps()}")
            state, start = resume_or_init(mgr, init_fn, device=DEV)
            check(start == 3, f"train loop ({tag}): resumed at {start}")
            if lossy is None:
                check(same(state, part), "train loop: the restored state "
                                         "differs from the saved one")
                # written on the worker thread while step 3 ran
                two, _ = mgr.restore(init_fn("meta"), step=2, device=DEV)
                check(same(two, states[1]), "train loop: the step-2 "
                      "checkpoint is not the state after two steps")
                out["raw_step2_restore_bit_identical"] = True
                resumed, last, _ = run(shared_fn, state, batch_fn, mgr, loop,
                                       start_step=start)
                check(last == LOOP_STEPS and same(resumed, full),
                      "train loop: the resumed run is not bit-identical to "
                      "the uninterrupted one")
                out["raw_resume_bit_identical"] = True
                continue
            worst = 0.0
            for a, b in zip(T.leaves(part), T.leaves(state)):
                if a.dtype == torch.float32 and a.numel() > 1024:
                    worst = max(worst, float((a.double() - b.double()
                                              ).abs().max()))
                else:
                    check(planes_equal(a, b), "train loop: a raw leaf of "
                                              "the lossy checkpoint moved")
            check(worst <= LOSSY_EB, f"train loop: a lossy leaf moved {worst}")
            after = []
            resumed, _, _ = run(shared_fn, state, batch_fn, mgr, loop,
                                start_step=start,
                                on_metrics=lambda s, m, dt, st: after.append(
                                    float(m["loss"])))
            out["lossy"] = {"eb": LOSSY_EB, "max_restored_err": worst,
                            "loss_after_resume": after,
                            "params_max_abs_diff_at_end": max(
                                float((a.float() - b.float()).abs().max())
                                for a, b in zip(T.leaves(full[0]),
                                                T.leaves(resumed[0])))}
    return out


def train_phase(seed: int) -> list:
    """(a) internlm2-20b at full width on TRAIN_LAYERS layers: the
    full-precision step, then the compressed step for each of
    TRAIN_WIRES, every run from the same weights and batches; the lossy
    coder on layer 0's wq master; (b) the loop and the checkpoint on the
    reduced configuration.  Returns the kernel rows of B8, B6, B7 and B2
    on the train path's w1 gradient."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import build
    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    bundle = build(cfg)
    pipe = TokenPipeline(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed))
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in
                pipe.batch(i).items()} for i in range(TRAIN_STEPS + 1)]

    def fresh():
        return bundle.init(torch.Generator(device=DEV).manual_seed(seed + 40),
                           device=DEV)

    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    line, _, master = train_run(bundle, "full-precision", None, fresh,
                                batches, {})
    fp_loss = line["loss"]
    line["serializer"] = train_serializer(master)
    del master
    print(json.dumps(line), flush=True)
    keep, counts, per_step = {"layers/w1": None}, {}, {}
    for spec in TRAIN_WIRES:
        line, run_counts, master = train_run(bundle, spec, spec, fresh,
                                             batches, keep)
        del master
        line["loss_gap_at_last_step"] = line["loss"][-1] - fp_loss[-1]
        print(json.dumps(line), flush=True)
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v
            per_step[k] = max(per_step.get(k, 0), v / TRAIN_STEPS)
    torch.cuda.empty_cache()
    rows = grad_kernel_rows(keep["layers/w1"], counts, per_step,
                            names=TRAIN_ROWS, chain="train")
    del keep
    loop = train_loop_check(seed)
    print(json.dumps({"phase": "train", "config": "loop",
                      "model": f"{TRAIN_ARCH} (reduced)", **loop,
                      "phase_s": time.time() - t0}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_DEFAULT,
                    help="values per field (default 512**3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.time()
    lib = _build.build()
    print(f"chip_smoke: built {lib.name} in {time.time() - t0:.1f} s",
          file=sys.stderr)
    log = lib.with_suffix(".log").read_text()
    print(log, file=sys.stderr)
    print("chip_smoke: ptxas pack_kernel "
          + json.dumps(ptxas_summary(log)), file=sys.stderr)

    f = make_fields(args.n, args.seed)
    nyx_shape = cube(args.n)
    rows = []
    rows += run_chain("rel", "rel:0.001|pack:16", f["nyx"], None)
    rows += run_chain("noa", "noa:0.001|pack:16", f["nyx"], None)
    rows += run_chain("grad-wire-8", get_pipeline("grad-wire-8"), f["grad"],
                      rms_eb(f["grad"]))
    rows += run_chain("sci-rel-narrow", get_pipeline("sci-rel-narrow"),
                      f["nyx"], None)
    rows += run_chain("grad-wire-16-narrow",
                      get_pipeline("grad-wire-16-narrow"), f["emb"],
                      rms_eb(f["emb"]))
    rows += run_chain("smoke-chain", get_pipeline("smoke-chain"),
                      f["near_one"], None)
    for name in ("grad-wire-16-ent", "grad-wire-pred"):
        rows += run_chain(name, get_pipeline(name), f["emb"], rms_eb(f["emb"]))
    for name in ("sci-rel-shuffle", "sci-rel-ent", "sci-lorenzo-ent"):
        rows += run_chain(name, get_pipeline(name), f["nyx"], None,
                          shape=nyx_shape)
    rows += dense_phase(f)
    rows += audit_phase(f)
    del f
    code_sweep(args.seed)
    kv_rows_, k_row0 = kv_phase(args.seed)
    rows += kv_rows_
    # one user's K at 32K as pages of 128 tokens: (G S / 128, 128, D)
    g, s, d = k_row0.shape
    rows += run_chain("kv-delta", get_pipeline("kv-delta"),
                      k_row0.reshape(-1), rms_eb(k_row0),
                      shape=(g * s // KV_PAGE, KV_PAGE, d))
    del k_row0
    rows += serve_phase(args.seed)
    rows += moe_phase(args.seed)
    rows += grads_phase(args.seed)
    rows += train_phase(args.seed)
    check(set(KERNELS) <= {r["name"] for r in rows},
          "a kernel has no main-path row")
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"chip_smoke: {time.time() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

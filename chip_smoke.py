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
16 steps from position 120, every layer's cache seeded before it with
the same K, V = N(0,1)*0.7 in the quantized cache's bf16 hot page and
in the raw cache, through `models.serve.serve_step` with the quantized
cache
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
card (`plain_calls`); (b) `models.engine.DecodeEngine` with 4 slots over
5 requests (prompts of 130, 17, 140, 9 and 12 tokens, 8 new tokens each,
the last waiting for a free slot, one evict -> insert), one batched
`generate_step` a step (a position a row; B12 one call a layer over the
4 rows), each slot's logits bit-identical to the engine's batch-1 path
(`step_one`, batch 1) and to the aligned batch-1 `serve_step`, the
batched step's ms against the sequential path's, and which ops of layer
0 give a row other bits at 1 row than at 4 (`batch_dependence`); (c) 4 requests at decode_32k's
32,768 tokens (its batch 128 cut to 4), every layer's closed pages from
`quantize_kv` of seeded
K, V = N(0,1)*0.7, 5 steps from position 32,700: step time (CUDA events,
median of 5), B12's and the GEMMs' device time a step (`torch.profiler`),
the step's bytes bound, launches a step (96 of B12), peak memory.  Then
a `tp` phase on the same weights serves them on the reference's sharded
layout: 4 thread ranks of a (2, 2) ("data", "model") mesh, each on its
views of the weights under `launch.mesh.param_shardings` and its block
of the cache under `launch.mesh.cache_layouts`: (i) a prefill of 4 x 512
seeded tokens, each rank's "vocab" block of the logits within 2e-2 of
max |logit| of one rank's prefill of its rows; (ii) 16 quantized steps
from position 120 in a cache of 512 tokens (the page closes on model
rank 0; model rank 1 stays at local length 0), the logits within 2^-4
of one rank's steps, the closed pages within their bound, layer 0's B12
merge across the ranks within 2e-5 of one rank's history attention;
(iii) one step over (c)'s 32K cache at 32,700, every layer given one
rank's input to it within 2^-6 of one rank's output and the B12 merge
over both model ranks' pages within 2e-5; (iv) that step counted on
meta for each rank against the card: launches, rank 0's FLOPs and
collective bytes (`core.axis.RecordingAxis`) equal, the peak within
15 %; B12 on rank 0's block in the kernel rows.  The weights are freed
before the `grads` phase.

A `moe` phase drives the MoE family and head dim 80:
olmoe-1b-7b at full width and depth (16 layers, 64 experts, top-8,
6.82G parameters made on the card from the seed): (a) 8 requests for
16 steps at seq 512 from a seeded history at position 120, as serve
(a), through `serve_step`, quantized and raw, with the
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
of a float32 softmax attention; (g) expert parallelism: olmoe's 64
experts over a ("model",) mesh of 4 thread ranks on the card
(`launch.mesh.run_mesh_threads`, each rank a view of 16 experts), a
forward over 8 x 512 tokens through the all-to-alls against the one-rank
forward (bit-equal, or within 2e-2 of max |logit|), 32 quantized decode
steps at B = 8 through the decode path (local experts, float32 psum),
each layer's output within 2^-6 of its largest |value| from one rank's
on the same input and the logits within 2^-4 of max |logit| from the
one-rank steps, two controls with a fault in the psum (summed in bf16;
one rank's partial dropped: it must fail both limits), and one AdamW
step of a 2-layer cut at full
width on a (1, 4) mesh description (`launch.train.value_and_grad`: the
ranks' forward as threads, one backward) with its gradients against the
one-rank step's leaf by leaf; (e) qwen3-moe-235b-a22b at full width,
4 of its 94 layers (128 experts, B12 at Hg = 16), 16 steps from 120 with
the checks of (a); (f) stablelm-3b at full width and depth (B12 at D =
80), 16 steps from 120 with the same checks.  Each model's weights are freed before
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
set; `auto` for one step).  Every pod's mean must be bit-equal to the
plain result (each pod's wire decoded with kernels=False, summed in rank order,
over p),
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
must fold 6 reports with 0 violations; the raw checkpoint then goes
through `runtime.elastic.resize` onto the card's (1, 1) mesh, every leaf
and the step as saved.

Between (a) and (b) the train phase runs tp (v), training on the
reference's sharded layout (`tp_train`): the same model, batches and
AdamW on a (2, 2) ("data", "model") mesh of 4 thread ranks, each on its
views of the weights under `launch.mesh.param_shardings` and its blocks
of AdamW's state (`launch.mesh.rank_state`), 3 steps of
`launch.train.make_train_step` against one rank's: the loss every step
within 1e-3 of |loss| of one rank's on the same weights (its own run's
at step 1, its forward on the mesh's weights after), step 1's gradient
joined from the blocks within 2e-2 of each leaf's max |g| of one rank's
float32 gradient of the same weights, or no further from it than one
rank's own bfloat16 gradient where that is further (emb: token 0 is 563
of the 4,096 tokens), the global norm over the blocks within 1e-5 of
the joined gradient's, step 1's new master joined from the blocks bit-equal to the
whole update given the mesh's gradient and norm; the last step counted
against rank 0's on meta (FLOPs of the 4 ranks, the peak within 15 %,
and rank 0's collective bytes equal to a count from the layout's
shapes).  Then the compressed step on a (2, 2, 2) ("pod", "data",
"model") mesh of 8 thread ranks (FSDP over "data" inside each pod, the
pods sharing one state), `grad-wire-8` for 2 steps and
`grad-wire-16-narrow` for 1, grad-wire-8's second step and
grad-wire-16-narrow's held block by block as in (a) with each pod's
bound against its whole leaf's, `plain_calls` 0 every step; B8, B6, B7
and B2 on a block's input in the kernel rows ("train on the layout").

A `sweep` phase (after `dense`) checks the paper's §6 claim on the
card: all 2^32 float32 bit patterns, 2^28 at a time made on the card
(arange in int64, cast to int32, viewed as float32), through
`core.roundtrip_dense` at ABS and REL 1e-3 with 32-bit bins (B8/B9 to
encode, B10/B11 to decode), every value checked in float64 as
benchmarks/exhaustive_sweep.py's `verify_slab` checks it (a NaN fails
every test): 0 violations, zeros (REL) and non-finite values
bit-identical, no plain quantizer called, one launch of each of B8-B11 a
slab.  Over the same values it runs the paper's baselines: the
unprotected ABS decoded by `decode_dense` (its violations reported,
whatever they are) and the library REL decoded with its own exp2 (0
violations required; its bins against the bit-trick REL's, and on slab
0x30000000 its card bins against the CPU's).  Then Table 7 (protected
against unprotected ABS) and Tables 5-6 (bit-trick against library REL)
on the 512^3 fields, plain torch ops on both sides, B8/B9 beside them.

A `families` phase (last) drives whisper-base (encdec, frames N(0,1)
bf16 from the seed) and xlstm-350m (ssm) at full width and depth with
weights from the seed (xlstm's training on 2 of its 24 layers: the
sLSTM's recurrence makes a step's time follow the depth): 6 AdamW steps
at 8 x 448 and 8 x 512 tokens (the
loss each step, finite and falling; forward + backward and optimizer
ms; peak GB), a prefill of 8 x 448 and 8 x 2,048 tokens (tokens/s; the
sLSTM's share), 128 greedy decode steps of 8 requests (step ms beside
the bytes bound, kernels a step and the busy share from a profiled
step), 64 teacher-forced decode steps within 2e-2 of `forward`'s max
|logit| at every position on the trained weights (xlstm's too at all 24
layers on its untrained ones: within 2^-2 in bf16, and within 1e-4 in
float32, the witness of bf16 rounding), and a 2-layer cut whose loss,
prefill logits and 16 decode steps agree with the CPU path.

A `hybrid` phase (last) drives jamba-1.5-large-398b at full width (d
8,192, 64 heads over 8 KV heads, d_ff 24,576, 16 experts top 2, Di
16,384, N 16) on one period of its 9 (8 of 72 layers: 7 Mamba blocks
and an attention block, 4 dense and 4 MoE FFNs), weights from the seed
with the 4 MoE FFNs' experts one seeded set (stride-0 views: 92.9 GB
untied, 34.9 GB resident): (a) a prefill of 1 x 4,096 tokens
(prefill_32k cut x8: ms, tokens/s, the Mamba scans' share, peak GB);
(b) 8 requests, 64 teacher-forced `serve_step`s from position 0 on
`make_cache(8, 128)` (step ms beside the bytes bound with every weight
read once as if untied and with the experts routed to, kernels a step
and the busy share from a profiled step), then `forward` over the same
tokens and the steps again with every pair kept and forward's expert
choices given to the steps: within 2e-2 of max |logit| at every
position, a step's own choice different only at a near tie; (c)
long_500k: B = 1 at S = 524,288, K and V N(0,1)*0.7 below position
524,224, the Mamba states of (b)'s row 0, 8 steps (ms against the
weights' and the 2.15 GB of K and V's bound, finite logits); (d) the
reduced jamba on the same weights on the card and on the CPU (loss,
prefill logits, 16 steps, the card's expert choices given to the CPU),
then 6 AdamW steps on the card, the loss finite and falling.

The dry-run against the card (`launch.dryrun`, `launch.cost`): before
one more step of serve (c) and of the train phase's full-precision and
grad-wire-8 runs, the same step (the same factory, flags and shapes) runs
on the meta device; the card's step is then counted: its kernel
launches (a pod's) and FLOPs (`FlopCounterMode`, pod 0's) must equal
the meta count, and its max_memory_allocated after
reset_peak_memory_stats lie within 15 % of the meta peak (with 2 pods
as threads sharing one state: the held bytes plus both pods'
transients); each line's `meta_vs_card` holds both.  The hybrid holds
two more, with the Mamba scans counted on meta as the dry-run counts
them (chunks 0 and 1 run, the rest stand in and credit chunk 1's
cost): (a)'s prefill of 4,096 tokens (64 chunks a block; the held bytes
by storage, the tied experts once) and (f), one loss + gradient +
AdamW step of the reduced jamba at T = 256 (4 chunks a block).  The
audit phase's
detection matrix also takes a `grad-wire` selector wire, the one that
carries a chain id (`chainid_swap`).  Every kernel row has, beside its
one-call `ms`, `batched_ms`: 10 calls in a row by CUDA events.

Output: the card's name and power limit, one JSON line per chain, one
JSON line per phase (dense, sweep, audit, code sweep, kv, serve a/b/c,
moe a-g, grads, train, families, hybrid a-f),
one JSON line
{"kernels": [...]}, and last
{"ok": true, "device": {...}}.  On stderr: the build log, a summary of
its `-Xptxas -v` lines for the pack kernel (registers, stack, spills of
each instance), and each phase's wall time.  Any failed check exits
non-zero; with no CUDA device, or outside a checkout, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

# The train phase peaks near 74 GB of the card's 80; with fixed-size
# segments, blocks split across the pods' threads can strand 12 GiB that no
# large tensor fits in.  Expandable segments map and unmap pages instead.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

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
# shift/masks per word (its chunk placement, the scan and the header are
# a few operations a chunk of 512 words), the expand 4 shift/masks per
# word.  The dense
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


def lc_used_words(hist) -> int:
    """Payload words the chunks of a code histogram occupy."""
    from repro_torch.core import codec as C
    return sum(h * ln for h, ln in zip(hist, C._LC_LENS))


def kernel_bytes(name: str, n: int, bits: int = 32, hist=None,
                 rows: int = 1, image: bool = False) -> int:
    """Least bytes: each input read once, each output written once.  n is
    the element count for the pack and unpack kernels and the word count
    entering the stage (all `rows` streams) for _lc_select and _lc_expand;
    `hist` (the chunk code counts of this run) gives the payload words
    _lc_expand reads and, with `image` (B5's image compacted), those
    _lc_select reads.  _lc_select writes each row's payload (512 words a
    chunk), 2-bit header plane and length; _lc_expand reads the header
    plane and the used payload words and writes the words."""
    from repro_torch.core import codec as C
    words = 4 * C.packed_word_count(n, bits)
    signs = 4 * C.packed_word_count(n, 1)
    chunks = C.lc_chunk_count(C.packed_word_count(n, bits))
    image_bytes = 4 * chunks * C.LC_CHUNK + 4 * chunks   # sel + int32 codes
    n_in = n // rows
    stage_chunks = rows * C.lc_chunk_count(n_in)
    header = 4 * rows * C.lc_header_words(n_in)
    if name == "_lc_select":
        read = (4 * lc_used_words(hist) + 4 * stage_chunks if image
                else 4 * n)
        return read + 4 * stage_chunks * C.LC_CHUNK + header + 4 * rows
    if name == "_lc_expand":
        return header + 4 * lc_used_words(hist) + 4 * n
    return {"_abs_pack": 4 * n + 4 + words + n,
            "_rel_pack": 4 * n + words + n + signs,
            "_abs_unpack": words + 4 + 4 * n,
            "_rel_unpack": words + signs + 4 * n,
            "_abs_pack_lc": 4 * n + 4 + n + image_bytes,
            "_rel_pack_lc": 4 * n + n + signs + image_bytes,
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


def bound_of(name: str, n: int, bits: int, hist=None, rows: int = 1,
             image: bool = False):
    return bound_from(kernel_bytes(name, n, bits, hist, rows, image),
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


# ----------------------------------------- the dry-run against the card --

META_PEAK_TOL = 0.15       # the meta peak against max_memory_allocated


def meta_count(fn, held: dict, recorder=None) -> dict:
    """fn() on the meta device as `launch.dryrun.measure` counts it, with
    the trees in `held` (meta tensors) as the bytes the step holds and
    `recorder` the one its MetaAxis axes record into."""
    from repro_torch.launch import cost
    from repro_torch.launch import dryrun as DR
    rec = cost.Recorder() if recorder is None else recorder
    with torch.device("meta"):
        _, c, by_b = DR.measure(fn, held, rec)
    return {"launches": by_b, "flops": c.flops,
            "held_bytes": cost.tree_bytes(held), "peak_bytes": c.peak_bytes,
            "collective_bytes": c.collective_bytes, "seconds": c.seconds}


def meta_vs_card(label: str, meta: dict, launches_: dict, flops: int,
                 peak: int, pods: int = 1, ranks: int = 1) -> dict:
    """Hold the card's count of one step against the meta count: launches
    (a pod's) and FLOPs (pod 0's) equal; the peak within META_PEAK_TOL.
    With pods (threads on one card sharing the state) the prediction is
    the held bytes plus every pod's transient (the meta peak's excess);
    with `ranks` (thread ranks of a mesh, each holding its own blocks of
    the same shapes as rank 0's) that many times rank 0's peak."""
    want_peak = ranks * (meta["held_bytes"] + pods * (
        meta["peak_bytes"] - meta["held_bytes"]))
    gap = (peak - want_peak) / peak
    out = {"meta": meta, "card": {
        "launches": launches_, "flops": flops, "max_memory_allocated": peak,
        "total_memory": torch.cuda.get_device_properties(0).total_memory},
           "predicted_peak_bytes": want_peak, "peak_gap": gap,
           "pods": pods}
    print(f"chip_smoke: meta_vs_card {label} {json.dumps(out)}",
          file=sys.stderr, flush=True)
    check(launches_ == meta["launches"],
          f"{label}: launches {launches_} on the card, {meta['launches']} "
          f"on meta")
    check(flops == meta["flops"],
          f"{label}: {flops} FLOPs on the card, {meta['flops']} on meta")
    check(abs(gap) <= META_PEAK_TOL,
          f"{label}: peak {peak} on the card, {want_peak} predicted "
          f"({gap:+.3f})")
    return out


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
    return [int(v) for v in torch.bincount(codes.reshape(-1).to(torch.int64),
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
    """[(kernel, label, n or words, hist, kernel call, plain call[,
    kernel_row's keywords])] on the main path's inputs of every kernel the
    chain's encode and decode launch, in path order."""
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
            sel, codes0 = L.rel_pack_lc(x, cfg, stage)[-2:]
        else:
            calls.append(("_abs_pack_lc", stage, n, None,
                          lambda: L.abs_pack_lc(x, eb_arr, cfg, stage),
                          lambda: L._abs_pack_lc_plain(x, eb_arr, cfg, stage)))
            sel, codes0 = L.abs_pack_lc(x, eb_arr, cfg, stage)[-2:]
        calls.append(("_lc_select", f"0:{stage} image", sel.numel(),
                      hist_of(codes0), lambda: L.lc_compact_image(sel, codes0),
                      lambda: L._lc_compact_plain(sel, codes0[None]),
                      {"image": True}))
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
                              lambda w=cur[None], s=st.mode:
                              L.lc_select(w, s),
                              lambda w=cur[None], s=st.mode:
                              L._lc_select_plain(w, s)))
            cur = st.encode_words(cur, sizes[i], kernels=True)[1]
    cur = enc.payload                   # decode: the stages in reverse
    for i in reversed(range(len(pipe.stages))):
        st, m, hdr = pipe.stages[i], sizes[i], enc.headers[i]
        if isinstance(st, ChunkStage):
            calls.append(("_lc_expand", f"{i}:{st.mode}", m, hist_of(codes[i]),
                          lambda h=hdr[None], p=cur[None], m=m:
                          L.lc_expand(h, p, m),
                          lambda h=hdr[None], p=cur[None], m=m:
                          L._lc_expand_plain(h, p, m)))
        cur = st.decode_words(hdr, cur, m, kernels=True)
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
    "decode_words_lc")) + tuple(("kernels.lossless", f) for f in (
        "_lc_select_plain", "_lc_compact_plain", "_lc_expand_plain"))
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


def kernel_row(name, label, chain, bits, size, hist, kern, plain, count,
               rows: int = 1, image: bool = False):
    """Hold one kernel against its plain version and time both (`rows`
    and `image` as kernel_bytes takes them)."""
    outs_k, outs_p = as_tuple(kern()), as_tuple(plain())
    match = len(outs_k) == len(outs_p) and all(
        planes_equal(a, b) for a, b in zip(outs_k, outs_p))
    err = max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p))
    check(match, f"{chain}: {name} ({label}) differs from its plain version")
    bound_ms, bound_by = bound_of(name, size, bits, hist, rows, image)
    ms = time_ms(kern)
    batched_ms = time_ms(kern, reps=10, batch=KV_BATCH_CALLS)
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
            "share": bound_ms / ms, "batched_ms": batched_ms,
            "batched_share": bound_ms / batched_ms, "library_ms": None,
            "bytes": kernel_bytes(name, size, bits, hist, rows, image),
            "rows": rows}


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
    ms; a chunk stage is its select kernel B6, which compacts and writes
    the header, and its expand kernel B7, which reads them back) and the
    torch ops around them, each timed as one call on the chain's own
    planes: NOA's range, the outlier table, the pred transform and the
    pack of a pred chain, the other word stages (shuffle, ent encode; on
    decode unshuffle, ent decode), and the decode's unpack, pred inverse
    and outlier planes or scatter."""
    from repro_torch.core import codec as C
    from repro_torch.core import predict as P
    from repro_torch.core import quantizer as Q
    from repro_torch.core.pipeline import EntStage, ShuffleStage
    from repro_torch.kernels import dense as D
    from repro_torch.kernels import lossless as L
    cfg, n, bits = pipe.qcfg(), x.numel(), pipe.pack.bits
    rel = pipe.quant.mode == "rel"
    sizes = pipe.stage_sizes(n)
    parts = {k: 0.0 for k in (
        "encode_kernel", "value_range", "outlier_table", "select_kernel",
        "expand_kernel", "decode_kernel", "scatter")}

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
        outlier = (L.rel_pack_lc(x, cfg, st) if rel
                   else L.abs_pack_lc(x, eb_arr, cfg, st))[0]
    else:
        cur, outlier = first_words(pipe, x, eb, eb_arr, shape)
        for i, st in enumerate(pipe.stages):
            if isinstance(st, ShuffleStage):
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
        if isinstance(st, ShuffleStage):
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
                       plain, counts[name], **(extra[0] if extra else {}))
            for name, lab, size, hist, kern, plain, *extra in calls]
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
                image = L.lc_compact_image(sel, codes)
                hold("_lc_select", what + " image", image,
                     L._lc_compact_plain(sel, codes[None]))
                coded = L.lc_select(words[None], stage)
                hold("_lc_select", what, coded,
                     L._lc_select_plain(words[None], stage))
                check(all(planes_equal(a, b) for a, b in zip(image, coded)),
                      f"code sweep: {what} B5's route and B6's differ")
                back = L.lc_expand(coded[0], coded[1], n_words)
                hold("_lc_expand", what, back,
                     L._lc_expand_plain(coded[0], coded[1], n_words))
                check(planes_equal(back[0], words),
                      f"code sweep: {what} expand does not invert select")
    n_words = 3 * 4096 * C.LC_CHUNK // 128 + 129       # ragged word plane
    words = sweep_words(n_words, gen)
    pages = C.LC_CHUNK * 8                              # rows of 8 chunks
    for stage in ("zero", "narrow"):
        for what, rows in ((f"words {stage}", words[None]),
                           (f"pages {stage}", words[:n_words // pages * pages]
                            .view(-1, pages))):
            coded = L.lc_select(rows, stage)
            hold("_lc_select", what, coded, L._lc_select_plain(rows, stage))
            hists[what] = hist_of(C.unpack_word_rows(
                coded[0], C.lc_chunk_count(rows.shape[1]), 2, signed=False))
            back = L.lc_expand(coded[0], coded[1], rows.shape[1])
            hold("_lc_expand", what, back,
                 L._lc_expand_plain(coded[0], coded[1], rows.shape[1]))
            cut = coded[1][:, :coded[1].shape[1] // 3]
            hold("_lc_expand", what + " short payload",
                 L.lc_expand(coded[0], cut, rows.shape[1]),
                 L._lc_expand_plain(coded[0], cut, rows.shape[1]))
            check(planes_equal(back, rows), f"code sweep: {what} roundtrip")
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
    # a selector wire carries a chain id: the row that holds chainid_swap
    from repro_torch.core.select import get_selector
    sel = get_selector("grad-wire")
    x = f["grad"][:m].contiguous()
    enc = sel.encode(x, rms_eb(x), device=DEV, integrity=True)
    name = "auto:grad-wire"
    clean[name] = bool(A.verify_wire(enc))
    detection[name] = G.detection_matrix(enc, suite=name,
                                         n_chains=len(sel.chains))
    check(clean[name], f"audit: clean {name} wire fails its checksum")
    check("chainid_swap" in detection[name]
          and all(detection[name].values()),
          f"audit: {name} misses a fault class: {detection[name]}")
    print(json.dumps({"phase": "audit", "chains": chains, "detection_n": m,
                      "detection": detection, "clean_wire_passes": clean,
                      "presets": len(PIPELINES)}), flush=True)
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
# `auto` runs one step (its ent coder takes ~21 s a step; the first step
# already holds every check)
GRAD_STEPS_OF = {"auto": 1}
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
        total += s.pipe.decode(s.enc, n=n, device=DEV, kernels=False)
    return total.div_(p)


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
    """GRAD_STEPS steps (GRAD_STEPS_OF's for some) with error feedback of
    one configuration on every pod, each step held by `grad_check_step`;
    prints the configuration's line.  Returns (the launch counts of its
    steps, each leaf's branch)."""
    from repro_torch.compression import grads as G
    cfg = G.GradCompressionConfig(eb_rel=GRAD_EB_REL, pipeline=spec)
    torch.cuda.reset_peak_memory_stats()
    r = [{k: torch.zeros_like(v) for k, v in g.items()} for g in pods]
    step_ms, steps, total = [], [], {}
    n_steps = GRAD_STEPS_OF.get(label, GRAD_STEPS)
    for _ in range(n_steps):
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
        "pods": GRAD_PODS, "values_per_pod": n_total, "steps": n_steps,
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
        "launches_per_step": {k: v / n_steps for k, v in total.items()
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
    header, payload = shard.enc.headers[0][None], shard.enc.payload[None]
    codes = C.unpack_words(shard.enc.headers[0], C.lc_chunk_count(n_words), 2,
                           signed=False)
    calls = [
        ("_abs_pack", "selector stats", 16, n, None,
         lambda: K.abs_pack(x, eb, sel_cfg),
         lambda: K._abs_pack_plain(x, eb, sel_cfg)),
        ("_quantize_abs", "compress_shard", 16, n, None,
         lambda: tuple(D.quantize_abs(x, qc, eb=eb)[:3]),
         lambda: tuple(D._quantize_abs_plain(x, eb, qc)[:3])),
        ("_lc_select", "0:narrow", 16, n_words, None,
         lambda: L.lc_select(words[None], "narrow"),
         lambda: L._lc_select_plain(words[None], "narrow")),
        ("_lc_expand", "0:narrow", 16, n_words, hist_of(codes),
         lambda: L.lc_expand(header, payload, n_words),
         lambda: L._lc_expand_plain(header, payload, n_words)),
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
    n_steps = sum(GRAD_STEPS_OF.get(lab, GRAD_STEPS) for lab, _ in configs)
    per_step = {k: v / n_steps for k, v in counts.items()}
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
# 16 steps from a seeded history 8 positions before the first page close
# (past it, and 8 steps of B12 after it), where 136 steps from position 0
# stepped to it
SERVE_B, SERVE_SEQ, SERVE_STEPS, SERVE_MORE = 8, 512, 16, 16
SERVE_POS0 = 120               # KV_PAGE - 8
SERVE_CHAINS = ("kv-page", "kv-page-narrow", "kv-page-pred", "auto")
SERVE_QUANT_TOL = 0.15         # tests/test_models_smoke.py:115
SERVE_PROMPTS = (130, 17, 140, 9, 12)   # 4 slots, the last request waits
SERVE_NEW = 8
ENGINE_SLOTS = 4
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


def seed_history(cfg, params, qcache, rcache, tokens) -> None:
    """The model's own K and V of the seeded tokens [B, P] (P within the
    first page) at positions 0 .. P - 1 of every layer, the same bf16
    values in the quantized cache's hot page and in the raw cache: one
    batched pass through the layers (`forward`'s blocks), where P decode
    steps would take P passes.  The steps from P go on from that
    history.  (An N(0,1) history fails the quantized-vs-raw limit: over
    uncorrelated V the attention output is small beside the page's
    quantization error.)"""
    from repro_torch.models import transformer as TT
    p = tokens.shape[1]
    positions = torch.arange(p, device=tokens.device)[None, :]
    with torch.no_grad():
        x = params["emb"][tokens].to(TT.DTYPE)
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in params["layers"].items()}
            _, k, v = TT._project(cfg, lp, x, positions)
            for dst in (qcache.hot_k[i], rcache.k[i]):
                dst[:, :p] = k.to(dst.dtype)
            for dst in (qcache.hot_v[i], rcache.v[i]):
                dst[:, :p] = v.to(dst.dtype)
            x = TT._attention(cfg, lp, x, positions)
            x, _ = TT._ffn_block(cfg, lp, x)


def step_split(ms: list, pos0: int) -> dict:
    """The step times of a run from pos0 over one page close: before the
    close (no history), the closing step, after it (B12)."""
    close = KV_PAGE - 1 - pos0
    return {"step_ms_no_history": statistics.median(ms[:close]),
            "step_ms_page_close": [ms[close]],
            "step_ms_with_history": statistics.median(ms[close + 1:])}


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


def b12_row(label, qs, kq, vq, lengths, s: int, launches_: int,
            pps=None, caller: str = "models.serve._attn_history") -> dict:
    """B12 at a serve call's shapes (and split `pps`, the default when
    None): the kernel with its (m, l) against its plain version for each
    query in qs (the first one is timed), timed beside the plain version
    and one scaled_dot_product_attention call over the dequantized
    cache."""
    import torch.nn.functional as F
    from repro_torch.compression import kv as KV
    from repro_torch.kernels import kv_attention as A
    name = "_kv_decode_attention"
    q = qs[0]
    b = q.shape[0]

    def kern(q=q):
        return A.kv_decode_attention(q, kq, vq, lengths, page=KV_PAGE,
                                     cap=KV_CAP, return_stats=True,
                                     pages_per_split=pps)

    def plain(q=q):
        return A._kv_decode_attention_plain(q, kq, vq, lengths, page=KV_PAGE,
                                            pages_per_split=pps,
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
            "caller": caller,
            "stage": f"B={b} G={q.shape[1]} Hg={q.shape[2]} D={q.shape[3]} "
                     f"S={s} lengths={lengths.tolist()}",
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


def lc_rows(select_args, expand_args, counts, phase: str) -> list:
    """B6 and B7 on the inputs pack_kv and unpack_kv gave them in `phase`
    (every page a row), held bit for bit against their plain versions,
    with the host's time a call: 100 calls enqueued with no sync, by the
    host's clock.  With CHIP_SMOKE_KEEP_LC=DIR the pages B6 coded are
    kept as DIR/<phase>.pt for `chip_lc_ab.py --pages DIR`."""
    from repro_torch.core import codec as C
    from repro_torch.kernels import lossless as L
    rows = []
    words, mode = select_args
    n_rows, n_in = words.shape
    if os.environ.get("CHIP_SMOKE_KEEP_LC"):
        keep = Path(os.environ["CHIP_SMOKE_KEEP_LC"])
        keep.mkdir(parents=True, exist_ok=True)
        torch.save({"words": words.cpu(), "mode": mode}, keep / f"{phase}.pt")
    header = L.lc_select(words, mode)[0]
    codes = C.unpack_word_rows(header, C.lc_chunk_count(n_in), 2,
                               signed=False)
    rows.append(kernel_row("_lc_select", phase, "pack_kv", 8, words.numel(),
                           hist_of(codes), lambda: L.lc_select(words, mode),
                           lambda: L._lc_select_plain(words, mode),
                           counts["_lc_select"], rows=n_rows))
    header, payload, n_in = expand_args
    codes = C.unpack_word_rows(header, C.lc_chunk_count(n_in), 2,
                               signed=False)
    rows.append(kernel_row("_lc_expand", phase, "unpack_kv", 8,
                           header.shape[0] * n_in, hist_of(codes),
                           lambda: L.lc_expand(header, payload, n_in),
                           lambda: L._lc_expand_plain(header, payload, n_in),
                           counts["_lc_expand"], rows=header.shape[0]))
    for r, kern in zip(rows, (lambda: L.lc_select(words, mode),
                              lambda: L.lc_expand(header, payload, n_in))):
        r["caller"] = ("compression.kv.pack_kv" if r["name"] == "_lc_select"
                       else "compression.kv.unpack_kv")
        r["row_words"] = n_in
        r["host_us"] = host_us(kern)
    return rows


def host_us(fn, calls: int = 100) -> float:
    """The host's time a call, in µs, of `calls` calls of fn enqueued in a
    row with no sync in between (the card's queue absorbs them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def serve_aligned(cfg, params, seed: int) -> tuple:
    """(a): SERVE_B requests of seeded tokens for SERVE_STEPS steps from
    SERVE_POS0 (a seeded history before it, `seed_history`) through
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
    pos0 = SERVE_POS0
    seed_history(cfg, params, qcache, rcache, torch.randint(
        0, cfg.vocab, (SERVE_B, pos0), generator=gen, device=DEV))

    def qstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, kv_cfg)

    def rstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, None)

    torch.cuda.synchronize()
    t_steps = time.time()
    reset_launches()
    with closed_pages() as kept, plain_calls(SERVE_PLAIN_FNS) as plain:
        q_logits, q_ms = serve_steps(qstep, qcache, toks[:SERVE_STEPS], pos0)
        counts = launches()
        r_logits, r_ms = serve_steps(rstep, rcache, toks[:SERVE_STEPS], pos0)
        steps_s = time.time() - t_steps
        reset_launches()
        with first_call_args(L, "lc_select") as sel_args:
            wires = {c: S.pack_cache(qcache, stages=get_kv_chain(c),
                                     integrity=True) for c in SERVE_CHAINS}
        with first_call_args(L, "lc_expand") as exp_args:
            backs = {c: S.unpack_cache(w, verify=True)
                     for c, w in wires.items()}
        lc_counts = launches()
    print(f"chip_smoke: serve (a) {SERVE_STEPS} steps from {pos0}, "
          f"quantized and raw: {steps_s:.1f} s", file=sys.stderr, flush=True)
    pages = page_bound_tally(kept)
    del kept
    b12 = "_kv_decode_attention"
    # a B12 call is two kernel launches (split + merge), counted once
    hist_steps = pos0 + SERVE_STEPS - KV_PAGE
    check(counts[b12] == cfg.n_layers * hist_steps,
          f"serve: {counts[b12]} B12 calls in (a), want "
          f"{cfg.n_layers * hist_steps}")
    closes = (pos0 + SERVE_STEPS) // KV_PAGE
    check(pages["pages"] == 2 * closes * cfg.n_layers * SERVE_B
          * cfg.n_kv_heads, f"serve: {pages['pages']} pages closed")
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
    la, _ = serve_steps(qstep, qcache, more, pos0 + SERVE_STEPS)
    lb, _ = serve_steps(qstep, moved, more, pos0 + SERVE_STEPS)
    after = all(planes_equal(a, b) for a, b in zip(la, lb))
    check(after, "serve: steps on the received cache differ")
    pos = [pos0 + n_all]

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
    rows = [row_b12] + lc_rows(sel_args[0][:2], exp_args[0][:3], lc_counts,
                               "serve")
    line = {
        "phase": "serve", "part": "a", "arch": SERVE_ARCH,
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "batch": SERVE_B, "seq": SERVE_SEQ, "steps": SERVE_STEPS,
        "steps_from": pos0, "steps_s": steps_s, **step_split(q_ms, pos0),
        "raw_step_ms": statistics.median(r_ms[KV_PAGE - pos0:]),
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
        "b12_calls_per_step_with_history": counts[b12] / hist_steps,
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


def serve_engine(cfg, params, seed: int, phase: str = "serve") -> tuple:
    """(b): DecodeEngine with ENGINE_SLOTS slots over len(SERVE_PROMPTS)
    requests (the last waits for a free slot; one evict -> insert), each
    request's tokens and logits bit-identical to the engine's batch-1 path
    (`step_one`) and to the aligned batch-1 `serve_step`, each continued
    from the request's prefill (the step_one chain over the prompt); the
    batched generate_step's ms against the sequential path's (a step_one
    per live slot), B12's calls a step (one over every slot's rows a
    layer), and which ops of the step make a row's bits depend on the
    batch (`batch_dependence`).
    Returns (line, B12's row at the engine's call: its slots' layer-0
    cache, the engine's split)."""
    from repro_torch.compression import kv as KV
    from repro_torch.configs.registry import get_kv_chain
    from repro_torch.models import engine as E
    from repro_torch.models import serve as S
    gen = torch.Generator(device=DEV).manual_seed(seed + 21)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen, device=DEV,
                             dtype=torch.int32) for n in SERVE_PROMPTS]
    eng = E.DecodeEngine(cfg, params, n_slots=ENGINE_SLOTS, seq=SERVE_SEQ,
                         stages=get_kv_chain("kv-page"), integrity="raise",
                         device=DEV)
    got = {r: [] for r in range(len(prompts))}
    t0 = time.time()
    pres = {r: eng.prefill(p) for r, p in enumerate(prompts)}
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    for r in range(ENGINE_SLOTS):
        eng.insert(eng.allocate(), pres[r], request=r)
        got[r].append(pres[r].logits[0])
    evicted = False
    pending = list(range(len(prompts) - 1, ENGINE_SLOTS - 1, -1))
    steps, step_ms, b12_steps = 0, [], 0
    b12 = "_kv_decode_attention"
    before = launches().get(b12, 0)
    while any(r is not None for r in eng.requests):
        b12_steps += any(r is not None and eng._pos[s_] >= KV_PAGE
                         for s_, r in enumerate(eng.requests))
        a = cuda_mark()
        logits, _ = eng.generate_step()
        step_ms.append((a, cuda_mark()))
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
            check(eng.insert(slot, pre, request=1), f"{phase}: re-insert")
            evicted = True
    torch.cuda.synchronize()
    n_b12 = launches().get(b12, 0) - before
    step_ms = [a.elapsed_time(e) for a, e in step_ms]
    engine_s = time.time() - t0
    check(n_b12 == cfg.n_layers * b12_steps,
          f"{phase} (b): {n_b12} B12 calls in {b12_steps} steps with "
          f"history, want one a layer")
    same, aligned, one_ms = True, True, []
    for r, p in enumerate(prompts):
        # the prefill is the step_one chain over the prompt: go on from
        # its cache (the wire's exact inverse) and its last logits, by
        # step_one and by the aligned batch-1 serve_step
        for chain in ("step_one", "serve_step"):
            cache, logits = S.unpack_cache(pres[r].pages), pres[r].logits
            want = [logits[0]]
            for k in range(SERVE_NEW - 1):
                tok = torch.argmax(logits, -1).to(torch.int32).reshape(1, 1)
                a = cuda_mark()
                if chain == "step_one":
                    logits, cache = eng.step_one(cache, tok, p.shape[0] + k)
                    one_ms.append((a, cuda_mark()))
                else:
                    logits, cache = S.serve_step(cfg, params, cache, tok,
                                                 p.shape[0] + k, None,
                                                 eng.kv_cfg)
                want.append(logits[0])
            eq = all(planes_equal(a, b) for a, b in zip(got[r], want))
            if chain == "step_one":
                same &= eq
            else:
                aligned &= eq
    torch.cuda.synchronize()
    one_ms = [a.elapsed_time(e) for a, e in one_ms]
    check(same, f"{phase}: an engine slot's logits differ from batch-1")
    check(aligned, f"{phase}: an engine slot's logits differ from the "
                   f"aligned batch-1 serve_step")
    st = eng.stats()
    # B12 as the engine calls it: every slot's row of layer 0, lengths a
    # row (a slot whose first page never closed reads its zero page)
    lens = torch.tensor([max(KV_PAGE, p_ - p_ % KV_PAGE) for p_ in eng._pos],
                        dtype=torch.int32, device=DEV)
    toks = torch.randint(0, cfg.vocab, (ENGINE_SLOTS, 1), generator=gen,
                         device=DEV, dtype=torch.int32)
    row = b12_row(f"{phase}-b", layer0_queries(cfg, params, toks, 200, gen),
                  KV.QuantizedKV(*(t[0] for t in eng._cache.k)),
                  KV.QuantizedKV(*(t[0] for t in eng._cache.v)), lens,
                  SERVE_SEQ, n_b12, pps=eng._pps,
                  caller="models.engine.DecodeEngine.generate_step")
    line = {"phase": phase, "part": "b", "arch": cfg.name,
            "slots": ENGINE_SLOTS, "prompts": list(SERVE_PROMPTS),
            "new_tokens": SERVE_NEW, "prefill_s": prefill_s,
            "engine_s": engine_s, "generate_steps": steps,
            "generate_step_ms": statistics.median(step_ms),
            "generate_step_ms_all": step_ms,
            "sequential_step_ms": ENGINE_SLOTS * statistics.median(one_ms),
            "step_one_ms": statistics.median(one_ms),
            "b12_calls_per_step_with_history": n_b12 / max(b12_steps, 1),
            "b12_rows_per_call": ENGINE_SLOTS,
            "slots_bit_identical_to_batch1": same,
            "slots_bit_identical_to_aligned_serve_step": aligned,
            "raw_slot_bytes": eng.raw_slot_bytes(),
            "wire_bytes": st["wire_bytes"], "sends": st["sends"],
            "evictions": st["evictions"],
            "audit_checks": st["audit_checks"],
            "b12_max_abs_err": row["max_abs_err"],
            "batch_dependence": batch_dependence(cfg, params, seed)}
    return line, row


def batch_dependence(cfg, params, seed: int) -> dict:
    """Which ops of a decode step give a row other bits in a batch of
    ENGINE_SLOTS rows than alone: each op of layer 0 over ENGINE_SLOTS
    seeded rows against the same op on each row alone (batch 1).  {op:
    {"rows_differ": [...], "first": the first differing value, alone and
    in the batch}}."""
    from repro_torch.compression import kv as KV
    from repro_torch.kernels import kv_attention as KA
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import serve as S
    gen = torch.Generator(device=DEV).manual_seed(seed + 23)
    n, d = ENGINE_SLOTS, cfg.d_model
    lp = {k: v[0] for k, v in params["layers"].items()}
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    x = rnd(n, 1, d).to(torch.bfloat16)
    xo = rnd(n, 1, h * hd).to(torch.bfloat16)
    qr = rnd(n, 1, h, hd).to(torch.bfloat16)
    hk = (rnd(n, KV_PAGE, g, hd) * 0.7).to(torch.bfloat16)
    hv = (rnd(n, KV_PAGE, g, hd) * 0.7).to(torch.bfloat16)
    hl = torch.full((n,), 77, dtype=torch.int32, device=DEV)
    kq, vq = (KV.quantize_kv(rnd(n, g, SERVE_SEQ, hd) * 0.7,
                             KV.kv_quantizer_config(), page=KV_PAGE,
                             cap=KV_CAP) for _ in range(2))
    qf = rnd(n, g, h // g, hd)
    lens = torch.full((n,), 384, dtype=torch.int32, device=DEV)
    pos = torch.full((n, 1), 300, dtype=torch.int32, device=DEV)
    cos, sin = L.rope_tables(pos, hd if cfg.rope == "full" else hd // 2)
    fixed = KA.default_pages_per_split(n, g, SERVE_SEQ // KV_PAGE)
    # each op takes `sel`, which picks its rows of every per-row input
    ops = {"rms_norm": lambda sel: L.rms_norm(sel(x), lp["ln1"],
                                              cfg.norm_eps),
           "wq GEMM": lambda sel: sel(x) @ lp["wq"],
           "wkv GEMM": lambda sel: sel(x) @ lp["wkv"],
           "wo GEMM": lambda sel: sel(xo) @ lp["wo"],
           "logits GEMM": lambda sel: sel(x) @ params["emb"].T,
           "rope": lambda sel: L.apply_rope(sel(qr), sel(cos), sel(sin),
                                            cfg.rope),
           "hot-page attention": lambda sel: S._partial_attn(
               sel(qr), sel(hk), sel(hv), sel(hl))[0]}
    if "router" in lp:
        ops["moe_ffn_rows"] = lambda sel: M.moe_ffn_rows(
            sel(x), lp["router"], lp["w1"], lp["w3"], lp["w2"],
            top_k=cfg.moe_top_k, act=cfg.act)
    else:
        ops["ffn"] = lambda sel: L.ffn(sel(x), lp["w1"], lp.get("w3"),
                                       lp["w2"], cfg.act)
    for label, pps in (("B12, default split", None), ("B12, one split",
                                                      fixed)):
        ops[label] = lambda sel, pps=pps: KA.kv_decode_attention(
            sel(qf), KV.QuantizedKV(*map(sel, kq)),
            KV.QuantizedKV(*map(sel, vq)), sel(lens), pages_per_split=pps)

    def bits(t):
        t = t.reshape(-1)
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    out = {}
    for name, fn in ops.items():
        full = fn(lambda t: t)
        bad, first = [], None
        for r in range(n):
            got = fn(lambda t, r=r: t[r:r + 1])
            diff = bits(got) != bits(full[r:r + 1])
            if bool(diff.any()):
                bad.append(r)
                if first is None:
                    i = int(diff.nonzero()[0])
                    first = {"row": r, "index": i,
                             "alone": float(got.reshape(-1)[i]),
                             "in_batch": float(full[r].reshape(-1)[i])}
        out[name] = {"rows_differ": bad, "first": first}
    return out


def serve_long(cfg, params, seed: int, phase: str = "serve",
               label: str = "c", keep: bool = False) -> tuple:
    """(c): LONG_B requests at LONG_SEQ with every layer's closed pages from
    quantize_kv of seeded K, V = N(0,1)*0.7 and a hot page of LONG_POS %
    page tokens; LONG_STEPS steps from LONG_POS.  Returns (line, row), and
    with keep a list that holds the cache (the tp phase's (iii))."""
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
    toks = torch.randint(0, cfg.vocab, (LONG_STEPS + 4, LONG_B, 1),
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
    # the next step: the dry-run's count on meta, then counted on the card
    from repro_torch.models import build
    mp = build(cfg).abstract_params()
    mcache = S.make_quant_cache(cfg, LONG_B, LONG_SEQ, device="meta")
    mtok = torch.empty((LONG_B, 1), dtype=torch.int32, device="meta")
    nxt = pos[0]
    meta = meta_count(lambda: S.serve_step(cfg, mp, mcache, mtok, nxt, None,
                                           kv_cfg),
                      {"params": mp, "cache": mcache, "batch": mtok})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with FlopCounterMode(display=False) as fc:
        one()
    torch.cuda.synchronize()
    from repro_torch.launch.dryrun import launches_by_b
    vs_meta = meta_vs_card(f"{phase} (c)", meta, launches_by_b(launches()),
                           fc.get_total_flops(),
                           torch.cuda.max_memory_allocated())
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
            "logits_finite": finite, "meta_vs_card": vs_meta,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    if keep:
        return line, row, [cache]
    del cache
    return line, row


# ------------------------------------------ the reference's sharded layout --

TP_SHAPE, TP_NAMES = (2, 2), ("data", "model")
TP_B, TP_PREFILL = 4, 512
# 16 steps from a seeded history of 120 tokens in a cache of 512: the page
# closes at 127 on model rank 0, then 8 steps with history; model rank 1
# (tokens 256-511) stays at local length 0 throughout.  (32 steps from
# 112 took the phase to 121-148 s: a mesh step is ~3 s of 4 threads'
# launches on one host)
TP_SEQ, TP_POS0, TP_STEPS = 512, 120, 16
TP_PREFILL_TOL = 2e-2          # of max |logit|: the EP tests' limit
TP_DECODE_TOL = 2.0 ** -4      # of max |logit|: moe (g)'s decode limit
TP_LONG_POS = LONG_POS         # (iii): serve (c)'s first position
# (iii)'s logits, of max |logit|: above what one rank's own 32K step moves
# when only the order of its history's float32 sum changes (the
# witnesses of `tp_long_witness`), which the stack carries through 48
# bfloat16 layers at this input
TP_LONG_TOL = 2.0 ** -3


def tp_rows(m, b: int) -> slice:
    """The rows of a batch of b that the rank at its data coordinate
    holds."""
    n = b // m.sizes["data"]
    return slice(m.coords()["data"] * n, (m.coords()["data"] + 1) * n)


def tp_gap(got, full, m) -> float:
    """max |got - full's "vocab" block of the rank| / max |full|."""
    n = got.shape[-1]
    lo = m.coords()["model"] * n
    return float((got.float() - full[..., lo:lo + n].float()).abs().max()
                 / full.float().abs().max())


@contextlib.contextmanager
def tp_closed_pages():
    """Wrap `models.serve._quantize_hot` (the layout's page close): keep
    each gathered hot page (a copy) and the QuantizedKV made of it."""
    from repro_torch.models import serve as S
    real, kept = S._quantize_hot, []
    lock = threading.Lock()

    def wrapped(hot, kv_cfg):
        q = real(hot, kv_cfg)
        with lock:
            kept.append((hot.clone(), q, kv_cfg))
        return q

    S._quantize_hot = wrapped
    try:
        yield kept
    finally:
        S._quantize_hot = real


def tp_page_tally(kept) -> dict:
    """Each kept page against the gathered hot page it was made from:
    values of non-overflowed pages outside eb_rel * max|page|."""
    from repro_torch.compression import kv as KV
    tally = {"pages": 0, "violations": 0, "overflow": 0}
    for hot, q, kv_cfg in kept:
        x = hot.permute(0, 2, 1, 3).to(torch.float32)
        b, g = x.shape[:2]
        y = KV.dequantize_kv(q, page=KV_PAGE).reshape(b, g, -1)
        xf = x.reshape(b, g, -1)
        finite = torch.isfinite(xf)
        eb = kv_cfg.error_bound * torch.where(
            finite, xf, torch.zeros_like(xf)).abs().amax(-1)
        bad = finite & ((xf - y).abs() > eb[..., None])
        bad &= ~q.overflow.reshape(b, g, 1)
        tally["pages"] += b * g
        tally["violations"] += int(bad.sum())
        tally["overflow"] += int(q.overflow.sum())
    return tally


def tp_merge_check(cfg, params, one, blocks, q, pos: int) -> float:
    """Layer 0's history attention at `pos` for the queries q [B, 1, H,
    hd]: each rank's B12 part over its pages merged over "model"
    (`serve.merge_parts`) against one rank's `_attn_history` on the whole
    cache `one`; the largest share of the allclose limit (KV_TOL) any
    rank's output uses (fails above 1)."""
    from repro_torch.compression import kv as KV
    from repro_torch.launch import mesh as M
    from repro_torch.models import serve as S
    start = pos - pos % KV_PAGE
    layer0 = [KV.QuantizedKV(*(t[0] for t in qkv)) for qkv in (one.k, one.v)]
    want, _, _ = S._attn_history(cfg, q, *layer0, start)

    def rank(m):
        cache = blocks[tuple(m.coords().values())]
        plan = S.cache_plan(cfg, cache, m)
        planes = S._rank_planes(*(KV.QuantizedKV(*(t[0] for t in qkv))
                                  for qkv in (cache.block.k, cache.block.v)),
                                plan, m)
        rows = tp_rows(m, q.shape[0])
        hist = min(max(start - plan.s0, 0), plan.s_l)
        parts = [S._attn_history(cfg, q[rows], *planes, hist)] if hist else []
        like = torch.empty_like(want[rows])
        o = S.merge_parts(parts, m.axis("model"), like)
        used = (o - want[rows]).abs() / (KV_TOL + KV_TOL * want[rows].abs())
        return float(used.max())

    with torch.no_grad():
        return max(M.run_mesh_threads(TP_SHAPE, TP_NAMES, rank))


@contextlib.contextmanager
def tp_history_order(seam_page=None, pages_per_split=None):
    """One rank's `serve._attn_history` summing the closed pages in
    another order, no code of the layout: cut at page `seam_page` into
    two B12 calls (each side's pages, lengths local to it) merged by B12's
    rule as `serve.merge_parts` merges the ranks' parts (M the max of m,
    weights l e^(m - M)); or B12 with `pages_per_split` pages a split."""
    from repro_torch.compression import kv as KV
    from repro_torch.models import serve as S
    real = S._attn_history

    def cut(qkv, p0, p1):
        return KV.QuantizedKV(
            qkv.bins[:, :, p0 * KV_PAGE:p1 * KV_PAGE].contiguous(),
            *(t[:, :, p0:p1].contiguous() for t in qkv[1:]))

    def split(cfg, q, qk, qv, page_start, pages_per_split=None):
        n = qk.bins.shape[2] // KV_PAGE
        parts = []
        for p0, p1 in ((0, seam_page), (seam_page, n)):
            length = min(max(page_start - p0 * KV_PAGE, 0),
                         (p1 - p0) * KV_PAGE)
            if length:
                parts.append(real(cfg, q, cut(qk, p0, p1), cut(qv, p0, p1),
                                  length))
        m = parts[0][2]
        for _, _, m_ in parts[1:]:
            m = torch.maximum(m, m_)
        num = den = None
        for o, l_, m_ in parts:
            w = l_ * torch.exp(m_ - m)
            num = o * w[..., None] if num is None else num + o * w[..., None]
            den = w if den is None else den + w
        return num / den[..., None], den, m

    S._attn_history = (split if seam_page is not None else functools.partial(
        real, pages_per_split=pages_per_split))
    try:
        yield
    finally:
        S._attn_history = real


@contextlib.contextmanager
def tp_layer_outputs():
    """Each decoder layer's output (after its FFN, `serve._ffn_block`, on
    one rank's path and the layout's) of the decode steps run inside,
    kept in call order by thread: {thread id: [float32 copies]}."""
    from repro_torch.models import serve as S
    real, kept = S._ffn_block, {}
    lock = threading.Lock()

    def keep(out):
        with lock:
            kept.setdefault(threading.get_ident(), []).append(
                out[0].detach().float().clone())
        return out

    S._ffn_block = lambda *a, **kw: keep(real(*a, **kw))
    try:
        yield kept
    finally:
        S._ffn_block = real


@contextlib.contextmanager
def tp_layer_inputs(one_layers: list):
    """Each layer of the layout's decode step given one rank's input to it
    (one rank's previous layer's output, at the thread's `rows`; layer 0
    keeps its own: the embedding, the same bits on every path).  Yields
    the thread-local the ranks set `rows` and `layer` = 0 on."""
    from repro_torch.models import serve as S
    real, local = S._attn_decode_tp, threading.local()

    def forced(cfg, p, x, *a, **kw):
        i = local.layer
        local.layer = i + 1
        if i:
            x = one_layers[i - 1][local.rows].to(x.dtype)
        return real(cfg, p, x, *a, **kw)

    S._attn_decode_tp = forced
    try:
        yield local
    finally:
        S._attn_decode_tp = real


def tp_layer0_witness(cfg, params, hot0, toks, one, kv_cfg) -> tuple:
    """Layer 0's K and V of (ii)'s steps as the layout's ranks compute
    them, in plain torch ops and no code of the layout: each data rank's
    rows normed alone, times each model rank's `wkv` columns (a
    contiguous block, as the gather over the data axes leaves it), the
    blocks joined, k roped; written into the seeded hot pages `hot0`
    ([B, page, G, hd] each), the page that closes quantized as one rank
    quantizes it (`serve._quantize_page`) and the hot page zeroed.
    Returns (a copy of one rank's cache `one` with layer 0's planes so
    rebuilt, {values of one rank's K and V that differ from the same GEMM
    over a data rank's rows alone ("rows"), over a model rank's columns
    alone ("columns"), over both ("both")}).  Layer 0's input is the
    embedding, the same bits on every path, so these values are the
    layout's own wherever the card's GEMM rounds the same over the same
    shapes."""
    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.models import serve as S
    lp0 = {k: v[0] for k, v in params["layers"].items()}
    g, hd = cfg.n_kv_heads, cfg.head_dim
    n_d, n_m = TP_SHAPE
    b_l = TP_B // n_d
    wkv = lp0["wkv"]
    c = wkv.shape[1] // n_m
    cols = [wkv[:, r * c:(r + 1) * c].contiguous() for r in range(n_m)]
    wit = T.tree_map(lambda t: t.clone(), one)
    hot = [h.clone() for h in hot0]
    diff = dict.fromkeys(("rows", "columns", "both"), 0)

    def kv_of(kv, cos, sin):
        kv = kv.reshape(kv.shape[0], 1, 2, g, hd)
        return torch.cat([L.apply_rope(kv[:, :, 0], cos, sin, cfg.rope),
                          kv[:, :, 1]], 0)          # [2 rows, 1, G, hd]

    def n_diff(a, b) -> int:
        return int((a != b).sum())

    with torch.no_grad():
        for i in range(TP_STEPS):
            pos = TP_POS0 + i
            positions = torch.full((1, 1), pos, dtype=torch.int32,
                                   device=DEV)
            cos, sin = L.rope_tables(
                positions, hd if cfg.rope == "full" else hd // 2)
            x = params["emb"][toks[i]].to(torch.bfloat16)       # [B, 1, D]
            hx_all = L.rms_norm(x, lp0["ln1"], cfg.norm_eps)
            one_kv = kv_of(hx_all @ wkv, cos, sin)
            diff["columns"] += n_diff(kv_of(torch.cat(
                [hx_all @ w for w in cols], -1), cos, sin), one_kv)
            ks, vs = [], []
            for d in range(n_d):
                hx = L.rms_norm(x[d * b_l:(d + 1) * b_l], lp0["ln1"],
                                cfg.norm_eps)
                kv = kv_of(torch.cat([hx @ w for w in cols], -1), cos, sin)
                ks.append(kv[:b_l])
                vs.append(kv[b_l:])
                one_rows = torch.cat([one_kv[d * b_l:(d + 1) * b_l],
                                      one_kv[TP_B + d * b_l:][:b_l]])
                diff["rows"] += n_diff(kv_of(hx @ wkv, cos, sin), one_rows)
            k, v = torch.cat(ks), torch.cat(vs)
            diff["both"] += n_diff(torch.cat([k, v]), one_kv)
            slot = pos % KV_PAGE
            hot[0][:, slot] = k[:, 0]
            hot[1][:, slot] = v[:, 0]
            if (pos + 1) % KV_PAGE == 0:
                for qkv, h in zip((wit.k, wit.v), hot):
                    S._quantize_page(S._qkv_layer(qkv, 0), h, pos // KV_PAGE,
                                     kv_cfg)
                    h.zero_()
        wit.hot_k[0].copy_(hot[0])
        wit.hot_v[0].copy_(hot[1])
    return wit, diff


def tp_prefill(cfg, params, seed: int) -> dict:
    """(i): a prefill of TP_B x TP_PREFILL seeded tokens on the (2, 2)
    mesh, every rank's "vocab" block of the last logits against one
    rank's prefill of its rows (one run each: the mesh's includes what a
    rank builds at its first call)."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import build
    bundle = build(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed + 41)
    toks = torch.randint(0, cfg.vocab, (TP_B, TP_PREFILL), generator=gen,
                         device=DEV, dtype=torch.int32)
    half = TP_B // 2
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = [bundle.prefill(params, {"tokens": toks[i * half:][:half]})
               for i in range(2)]
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3

    def rank(m):
        blk = M.param_blocks(params, m, bundle.axes())
        with torch.no_grad():
            out = bundle.prefill(blk, {"tokens": toks[tp_rows(m, TP_B)]}, m)
        torch.cuda.synchronize()
        return tp_gap(out, one[m.coords()["data"]], m), out.shape

    t0 = time.perf_counter()
    res = M.run_mesh_threads(TP_SHAPE, TP_NAMES, rank)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    gap = max(g for g, _ in res)
    print(f"chip_smoke: tp (i) gap {gap}", file=sys.stderr, flush=True)
    check(gap <= TP_PREFILL_TOL,
          f"tp (i): a rank's prefill logits {gap} of max |logit| from one "
          f"rank's")
    check(all(tuple(shp) == (half, cfg.padded_vocab // 2) for _, shp in res),
          f"tp (i): logits blocks {[tuple(s) for _, s in res]}")
    return {"prefill_tokens": [TP_B, TP_PREFILL], "prefill_gap": gap,
            "prefill_tol": TP_PREFILL_TOL, "prefill_ms_mesh": mesh_ms,
            "prefill_ms_one_rank": one_ms}


def tp_steps(cfg, params, seed: int) -> tuple:
    """(ii): TP_STEPS quantized steps from TP_POS0 in a cache of TP_SEQ
    tokens at B = TP_B, each rank on its block, against one rank's steps
    on the whole cache: logits within TP_DECODE_TOL, the closed pages
    within their bound, layer 0's B12 merge within KV_TOL of one rank's
    history attention; layer 0's planes bit-equal to one rank's rebuilt
    from the K and V of the layout's GEMM shapes (`tp_layer0_witness`),
    and the values that differ from one rank's own, a plane.  Returns
    (line, B12 launches of the mesh's steps)."""
    from repro_torch import tree as T
    from repro_torch.compression import kv as KV
    from repro_torch.launch import mesh as M
    from repro_torch.models import build
    from repro_torch.models import serve as S
    bundle = build(cfg)
    kv_cfg = KV.kv_quantizer_config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 42)
    hist = torch.randint(0, cfg.vocab, (TP_B, TP_POS0), generator=gen,
                         device=DEV, dtype=torch.int32)
    glob = S.make_quant_cache(cfg, TP_B, TP_SEQ, device=DEV)
    raw = S.make_raw_cache(cfg, TP_B, TP_POS0 + 16, device=DEV)
    seed_history(cfg, params, glob, raw, hist)
    del raw
    toks = torch.randint(0, cfg.vocab, (TP_STEPS + 1, TP_B, 1),
                         generator=gen, device=DEV, dtype=torch.int32)
    one = T.tree_map(lambda t: t.clone(), glob)
    with torch.no_grad():
        want, one_ms = serve_steps(
            lambda c, t, p: S.serve_step(cfg, params, c, t, p, None, kv_cfg),
            one, toks[:TP_STEPS], TP_POS0)
    wit, wit_diff = tp_layer0_witness(
        cfg, params, (glob.hot_k[0], glob.hot_v[0]), toks, one, kv_cfg)
    desc = M.Mesh(TP_SHAPE, TP_NAMES)
    lays = M.cache_layouts(desc, glob, TP_B)
    blocks = {tuple(c.values()): S.RankCache(T.tree_map(
        lambda t: t.clone(), M.local_views(glob, lays, c)), TP_B, TP_SEQ)
        for c in M.mesh_coords(desc)}
    del glob
    b12 = "_kv_decode_attention"

    def rank(m):
        blk = M.param_blocks(params, m, bundle.axes())
        cache = blocks[tuple(m.coords().values())]
        made = bundle.make_cache(TP_B, TP_SEQ, True, device=DEV, mesh=m)
        same = (made.batch, made.seq) == (TP_B, TP_SEQ) and [
            t.shape for t in T.leaves(made.block)] == [
            t.shape for t in T.leaves(cache.block)]
        del made
        rows = tp_rows(m, TP_B)
        out, ms = [], []
        with torch.no_grad():
            for i in range(TP_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                lg, _ = S.serve_step(cfg, blk, cache, toks[i, rows],
                                     TP_POS0 + i, m, kv_cfg)
                b.record()
                out.append(lg)
                ms.append((a, b))
        torch.cuda.synchronize()
        gaps = [tp_gap(lg, w[rows], m) for lg, w in zip(out, want)]
        def n_differ(tree):
            return [int((a[0] != w[0]).sum()) for a, w in zip(
                T.leaves(cache.block),
                T.leaves(M.local_views(tree, lays, m.coords())))]

        return (max(gaps), n_differ(one), same,
                [a.elapsed_time(b) for a, b in ms],
                S.cache_plan(cfg, cache, m).model, n_differ(wit))

    reset_launches()
    with tp_closed_pages() as kept:
        res = M.run_mesh_threads(TP_SHAPE, TP_NAMES, rank)
    launches_ = launches()[b12]
    gap = max(r[0] for r in res)
    tally = tp_page_tally(kept)
    print(f"chip_smoke: tp (ii) gap {gap} closed pages {tally}",
          file=sys.stderr, flush=True)
    check(gap <= TP_DECODE_TOL,
          f"tp (ii): a rank's logits {gap} of max |logit| from one rank's")
    # layer 0's planes: bit-equal to one rank's rebuilt from the K and V
    # of the layout's GEMM shapes; those that differ from one rank's own
    # are the values where the card's GEMM rounds otherwise over a data
    # rank's rows or a model rank's columns (the witness counts them)
    planes = (["k." + f for f in KV.QuantizedKV._fields]
              + ["v." + f for f in KV.QuantizedKV._fields]
              + ["hot_k", "hot_v"])
    differ = dict(zip(planes, [sum(x) for x in zip(*(r[1] for r in res))]))
    differ_wit = dict(zip(planes, [sum(x) for x in zip(*(r[5] for r in res))]))
    print(f"chip_smoke: tp (ii) layer 0's values differing from one rank's "
          f"{differ}, from the witness's {differ_wit}; the witness's K, V "
          f"values differing from one rank's {wit_diff}", file=sys.stderr,
          flush=True)
    check(not any(differ_wit.values()),
          f"tp (ii): layer 0's planes differ from one rank's rebuilt from "
          f"the layout's GEMM shapes: {differ_wit}")
    check(all(r[2] for r in res),
          "tp (ii): a rank's block is not make_cache(mesh=)'s shape")
    check(tally["violations"] == 0 and tally["pages"] > 0,
          f"tp (ii): closed pages {tally}")
    pos = TP_POS0 + TP_STEPS
    lp0 = {k: v[0] for k, v in params["layers"].items()}
    with torch.no_grad():
        x = params["emb"][toks[TP_STEPS]].to(torch.bfloat16)
        q, _, _ = S._project_token(cfg, lp0, x, pos)
    # the merge on one rank's cache cut into the ranks' blocks: the same
    # pages both ways
    views = {tuple(c.values()): S.RankCache(M.local_views(one, lays, c),
                                            TP_B, TP_SEQ)
             for c in M.mesh_coords(desc)}
    used = tp_merge_check(cfg, params, one, views, q, pos)
    check(used <= 1.0, f"tp (ii): layer 0's B12 merge uses {used} of the "
                       f"allclose limit {KV_TOL}")
    mesh_ms = res[0][3]
    return {"decode_steps": TP_STEPS, "decode_pos0": TP_POS0,
            "decode_seq": TP_SEQ, "decode_gap": gap,
            "decode_tol": TP_DECODE_TOL,
            "layer0_values_differing_by_plane": differ,
            "layer0_values_differing_from_witness": differ_wit,
            "witness_kv_values_differing": wit_diff,
            "closed_pages": tally, "b12_merge_tolerance_used": used,
            "cache_model_dims": res[0][4],
            "step_ms_mesh": statistics.median(mesh_ms),
            "step_ms_mesh_all": mesh_ms,
            "step_ms_one_rank": statistics.median(one_ms),
            "b12_calls_mesh": launches_}, launches_


def tp_meta_counts(cfg, pos: int) -> list:
    """Each rank's decode step at (iii)'s shapes counted on meta: its
    program alone, over MetaAxis axes at its coordinates."""
    from repro_torch.compression import kv as KV
    from repro_torch.launch import cost
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.models import build
    from repro_torch.models import serve as S
    bundle = build(cfg)
    desc = M.Mesh(TP_SHAPE, TP_NAMES)
    out = []
    with torch.device("meta"):
        glob = S.make_quant_cache(cfg, LONG_B, LONG_SEQ, device="meta")
        lays = M.cache_layouts(desc, glob, LONG_B)
        mp = bundle.abstract_params()
        for c in M.mesh_coords(desc):
            rec = cost.Recorder()
            blk = M.param_blocks(mp, desc, bundle.axes(), c)
            cache = M.local_views(glob, lays, c)
            tok = torch.empty((LONG_B // 2, 1), dtype=torch.int32)
            rmesh = DR.rank_mesh(desc, rec, c)
            out.append(meta_count(lambda: S.serve_step(
                cfg, blk, S.RankCache(cache, LONG_B, LONG_SEQ), tok, pos,
                rmesh, KV.kv_quantizer_config()),
                {"params": blk, "cache": cache, "batch": tok}, rec))
    return out


def tp_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def tp_long_witness(cfg, one_step, want, one_layers) -> dict:
    """(iii)'s witnesses: one rank's 32K step with the history's sum in
    another order (`tp_history_order`; no code of the layout), against
    the same step as one rank runs it: cut at the model ranks' seam and
    merged by B12's rule, and B12 with half its default pages a split.
    {witness: {"logits_gap", "layer_gaps"}}, each of max |one rank's|."""
    from repro_torch.kernels import kv_attention as KA
    n_pages = LONG_SEQ // KV_PAGE
    pps = KA.default_pages_per_split(
        LONG_B, cfg.n_kv_heads, n_pages,
        torch.cuda.get_device_properties(0).multi_processor_count)
    out = {}
    for name, kw in (("seam", {"seam_page": n_pages // TP_SHAPE[1]}),
                     ("pages_per_split", {"pages_per_split":
                                          max(1, pps // 2)})):
        with torch.no_grad(), tp_history_order(**kw), \
                tp_layer_outputs() as kept:
            got = one_step()
        layers = next(iter(kept.values()))
        out[name] = {"logits_gap": tp_rel(got, want), "layer_gaps": [
            tp_rel(a, b) for a, b in zip(layers, one_layers)], **kw}
    return out


def tp_long(cfg, params, holder: list, seed: int, b12_launches: int) -> tuple:
    """(iii): one serve (c) step at B = LONG_B over LONG_SEQ tokens at
    TP_LONG_POS on the (2, 2) mesh, each rank on its block of serve (c)'s
    cache, against one rank's step on the whole cache: the logits within
    TP_LONG_TOL (above the witnesses' readings, `tp_long_witness`: one
    rank's step with its history summed in another order), every layer
    given one rank's input to it within EP_LAYER_TOL of one rank's
    output, the free-running layers reported; layer 0's B12 merge over
    both model ranks' pages; (iv) the same step counted on
    meta for each rank against the card (launches of all ranks, rank 0's
    FLOPs and collective bytes equal, the peak within META_PEAK_TOL).
    `holder` holds serve (c)'s cache, freed once the ranks have their
    blocks.  Returns (line, B12's row under the mesh caller)."""
    from repro_torch import tree as T
    from repro_torch.compression import kv as KV
    from repro_torch.core.axis import MetaAxis, RecordingAxis
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import launches_by_b
    from repro_torch.models import build
    from repro_torch.models import serve as S
    bundle = build(cfg)
    kv_cfg = KV.kv_quantizer_config()
    cache = holder.pop()
    gen = torch.Generator(device=DEV).manual_seed(seed + 43)
    tok = torch.randint(0, cfg.vocab, (LONG_B, 1), generator=gen,
                        device=DEV, dtype=torch.int32)
    pos = TP_LONG_POS

    def one_step():
        return S.serve_step(cfg, params, cache, tok, pos, None, kv_cfg)[0]

    with torch.no_grad(), tp_layer_outputs() as one_layers:
        want = one_step()
    one_layers = next(iter(one_layers.values()))
    witness = tp_long_witness(cfg, one_step, want, one_layers)
    with torch.no_grad():
        one_ms = time_ms(one_step, reps=3, warm=1)
        lp0 = {k: v[0] for k, v in params["layers"].items()}
        x = params["emb"][tok].to(torch.bfloat16)
        q, _, _ = S._project_token(cfg, lp0, x, pos)
    desc = M.Mesh(TP_SHAPE, TP_NAMES)
    lays = M.cache_layouts(desc, cache, LONG_B)
    blocks = {tuple(c.values()): S.RankCache(T.tree_map(
        lambda t: t.clone(), M.local_views(cache, lays, c)), LONG_B,
        LONG_SEQ) for c in M.mesh_coords(desc)}
    one_hist = cache          # held for the merge check, then freed
    used = tp_merge_check(cfg, params, one_hist, blocks, q, pos)
    check(used <= 1.0, f"tp (iii): layer 0's B12 merge uses {used} of the "
                       f"allclose limit {KV_TOL}")
    del cache, one_hist
    torch.cuda.empty_cache()
    b12 = "_kv_decode_attention"
    card = {}

    def rank(m, count=False, timed=False, forced=None):
        blk = M.param_blocks(params, m, bundle.axes())
        c = blocks[tuple(m.coords().values())]
        rows = tp_rows(m, LONG_B)
        first = m.coords() == {"data": 0, "model": 0}
        if forced is not None:
            forced.rows, forced.layer = rows, 0
        if count and first:
            rec = cost.Recorder()
            m = M.Mesh(m.shape, m.axis_names, axes={
                n: RecordingAxis(m.axis(n), rec) for n in m.axis_names})
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            if count and first:
                with FlopCounterMode(display=False) as fc:
                    lg, _ = S.serve_step(cfg, blk, c, tok[rows], pos, m,
                                         kv_cfg)
                card.update(flops=fc.get_total_flops(),
                            collective_bytes=dict(rec.bytes))
            else:
                a.record()
                lg, _ = S.serve_step(cfg, blk, c, tok[rows], pos, m, kv_cfg)
                b.record()
        torch.cuda.synchronize()
        gap = tp_gap(lg, want[rows], m)
        return (gap, (a.elapsed_time(b) if timed and first else None),
                threading.get_ident(), rows)

    reset_launches()
    with tp_layer_outputs() as mesh_layers:
        res = M.run_mesh_threads(TP_SHAPE, TP_NAMES, rank)    # warm
    launches_ = launches()[b12]
    gap = max(r[0] for r in res)
    # rank (0, 0)'s rows layer by layer against one rank's: the first
    # layer's output (one rank's input exactly: the embedding) shows the
    # layout's rounding, the later ones how the stack carries it

    def layer_gaps(kept, res) -> list:
        """Each layer's largest gap over the ranks, of one rank's max."""
        per = [[float((mv - ov[rows]).abs().max() / ov[rows].abs().max())
                for mv, ov in zip(kept[tid], one_layers)]
               for _, _, tid, rows in res]
        return [max(col) for col in zip(*per)]

    free_gaps = layer_gaps(mesh_layers, res)
    # each layer on one rank's input to it (EP_LAYER_TOL, moe (g)'s
    # per-layer limit): the layout's own rounding a layer, apart from
    # what the stack carries from the layers before
    with tp_layer_outputs() as forced_layers, tp_layer_inputs(
            one_layers) as forced:
        res_f = M.run_mesh_threads(TP_SHAPE, TP_NAMES, lambda m: rank(
            m, forced=forced))
    forced_gaps = layer_gaps(forced_layers, res_f)
    print(f"chip_smoke: tp (iii) gap {gap} layers on one rank's inputs "
          f"{forced_gaps} free {free_gaps}; witnesses "
          f"{json.dumps(witness)}", file=sys.stderr, flush=True)
    mesh_ms = M.run_mesh_threads(TP_SHAPE, TP_NAMES, lambda m: rank(
        m, timed=True))[0][1]
    # (iv): the same step counted on meta, each rank, against the card
    metas = tp_meta_counts(cfg, pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    M.run_mesh_threads(TP_SHAPE, TP_NAMES, lambda m: rank(m, count=True))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    card_launches = launches_by_b(launches())
    meta_launches = {}
    for mt in metas:
        for k, n in mt["launches"].items():
            meta_launches[k] = meta_launches.get(k, 0) + n
    want_peak = base + sum(mt["peak_bytes"] - mt["held_bytes"] for mt in metas)
    peak_gap = (peak - want_peak) / peak
    vs_meta = {"meta_rank0": metas[0], "meta_launches_all_ranks":
               meta_launches, "card": {"launches_all_ranks": card_launches,
                                       "rank0_flops": card["flops"],
                                       "rank0_collective_bytes":
                                           card["collective_bytes"],
                                       "max_memory_allocated": peak,
                                       "base": base},
               "predicted_peak_bytes": want_peak, "peak_gap": peak_gap}
    print(f"chip_smoke: meta_vs_card tp (iv) {json.dumps(vs_meta)}",
          file=sys.stderr, flush=True)
    check(card_launches == meta_launches,
          f"tp (iv): launches {card_launches} on the card, {meta_launches} "
          f"on meta")
    check(card["flops"] == metas[0]["flops"],
          f"tp (iv): rank 0's {card['flops']} FLOPs on the card, "
          f"{metas[0]['flops']} on meta")
    check(card["collective_bytes"] == metas[0]["collective_bytes"],
          f"tp (iv): rank 0's collective bytes {card['collective_bytes']} "
          f"on the card, {metas[0]['collective_bytes']} on meta")
    check(abs(peak_gap) <= META_PEAK_TOL,
          f"tp (iv): peak {peak} on the card, {want_peak} predicted "
          f"({peak_gap:+.3f})")
    # B12 on rank 0's block at these shapes (its pages are its own)
    c0 = blocks[(0, 0)]
    plan = S.cache_plan(cfg, c0, M.Mesh(TP_SHAPE, TP_NAMES, axes={
        n: MetaAxis(k) for n, k in zip(TP_NAMES, TP_SHAPE)}))
    check(all(plan.model[f] == 2 for f in ("eb2", "out_idx", "out_val")),
          f"tp (iii): rank 0's planes are not split by page: {plan.model}")
    b_l = LONG_B // 2
    start = pos - pos % KV_PAGE
    lens = torch.full((b_l,), min(start, plan.s_l), dtype=torch.int32,
                      device=DEV)
    qs = layer0_queries(cfg, params, tok[:b_l], pos, gen)
    row = b12_row("tp-c", qs, KV.QuantizedKV(*(t[0] for t in c0.block.k)),
                  KV.QuantizedKV(*(t[0] for t in c0.block.v)), lens,
                  plan.s_l,
                  b12_launches + launches_,
                  caller="models.serve._serve_tp (rank 0's block of the "
                         "(2, 2) mesh: its batch rows, its half of the "
                         "sequence)")
    del blocks
    check(max(forced_gaps) <= EP_LAYER_TOL,
          f"tp (iii): a layer on one rank's input {max(forced_gaps)} of its "
          f"max from one rank's output")
    check(bool(torch.isfinite(want).all()) and gap < float("inf"),
          "tp (iii): a logit is not finite")
    check(gap <= TP_LONG_TOL,
          f"tp (iii): a rank's logits {gap} of max |logit| from one rank's "
          f"(the witnesses: {[w['logits_gap'] for w in witness.values()]})")
    line = {"long_batch": LONG_B, "long_seq": LONG_SEQ, "long_pos": pos,
            "long_gap": gap, "long_tol": TP_LONG_TOL,
            "long_witness": witness,
            "long_layer_gaps_on_one_rank_inputs": forced_gaps,
            "long_layer_tol": EP_LAYER_TOL,
            "long_layer_gaps_free": free_gaps,
            "long_b12_merge_tolerance_used": used,
            "long_step_ms_mesh": mesh_ms,
            "long_step_ms_one_rank": one_ms,
            "long_b12_calls_mesh": launches_, "meta_vs_card": vs_meta}
    return line, row


def tp_phase(cfg, params, holder: list, seed: int) -> list:
    """The serve phase's internlm2-20b on the reference's sharded layout:
    4 thread ranks of a (2, 2) ("data", "model") mesh, each holding its
    views of the weights under `param_shardings` (FSDP over "data",
    heads / mlp / vocab over "model") and its block of the cache under
    `cache_layouts`: (i) a prefill, (ii) the quantized steps across a
    page close, (iii) one step over serve (c)'s 32K cache, (iv) that step
    on meta against the card.  Returns [B12's row under the mesh
    caller]."""
    t0 = time.time()
    line = {"phase": "tp", "arch": cfg.name, "mesh": dict(zip(TP_NAMES,
                                                             TP_SHAPE)),
            "ranks": "threads on one card"}
    line.update(tp_prefill(cfg, params, seed))
    dec, b12_launches = tp_steps(cfg, params, seed)
    line.update(dec)
    long_line, row = tp_long(cfg, params, holder, seed, b12_launches)
    line.update(long_line)
    line.update(seconds=time.time() - t0,
                peak_device_GB=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(line), flush=True)
    print(f"chip_smoke: phase tp {time.time() - t0:.1f} s", file=sys.stderr,
          flush=True)
    return [row]


def serve_phase(seed: int) -> list:
    """internlm2-20b at full width and depth, made on the card from the
    seed: (a) the aligned batch, (b) the engine, (c) the long context,
    then the tp phase on the same weights (`tp_phase`).  Frees the
    weights before it returns the kernel rows."""
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
    line_b, row_b = serve_engine(cfg, params, seed)
    print(json.dumps(line_b), flush=True)
    line_c, row_c, holder = serve_long(cfg, params, seed, keep=True)
    print(json.dumps(line_c), flush=True)
    row_tp = tp_phase(cfg, params, holder, seed)
    del params
    torch.cuda.empty_cache()
    return rows + [row_b, row_c] + row_tp


MOE_ARCH = "olmoe-1b-7b"
MOE_WIDE_ARCH, MOE_WIDE_LAYERS = "qwen3-moe-235b-a22b", 4
D80_ARCH = "stablelm-3b"
# from SERVE_POS0, past one page close, as serve (a)
MOE_STEPS = 16
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
    from SERVE_POS0 (a seeded history before it, `seed_history`) through
    serve_step with the quantized cache and with the raw one: the
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
    pos0 = SERVE_POS0
    seed_history(cfg, params, qcache, rcache, torch.randint(
        0, cfg.vocab, (SERVE_B, pos0), generator=gen, device=DEV))

    def qstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, kv_cfg)

    def rstep(c, t, pos):
        return S.serve_step(cfg, params, c, t, pos, None, None)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_steps = time.time()
    reset_launches()
    with closed_pages() as kept, plain_calls(SERVE_PLAIN_FNS) as plain, \
            moe_dispatch_counts() as moe:
        q_logits, q_ms = serve_steps(qstep, qcache, toks[:steps], pos0)
        counts = launches()
    r_logits, r_ms = serve_steps(rstep, rcache, toks[:steps], pos0)
    steps_s = time.time() - t_steps
    print(f"chip_smoke: moe ({label}) {steps} steps from {pos0}, quantized "
          f"and raw: {steps_s:.1f} s", file=sys.stderr, flush=True)
    pages = page_bound_tally(kept)
    del kept
    b12 = "_kv_decode_attention"
    closes = (pos0 + steps) // KV_PAGE
    hist_steps = pos0 + steps - KV_PAGE
    check(counts[b12] == cfg.n_layers * hist_steps,
          f"moe ({label}): {counts[b12]} B12 calls, want "
          f"{cfg.n_layers * hist_steps}")
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
    pos = [pos0 + steps]

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
    split = step_split(q_ms, pos0)
    hist_ms = split["step_ms_with_history"]
    line = {"phase": "moe", "part": label[-1], "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "kv_heads": cfg.n_kv_heads, "hg": cfg.group_size,
            "head_dim": cfg.head_dim, "experts": cfg.moe_experts,
            "top_k": cfg.moe_top_k, "batch": SERVE_B, "seq": SERVE_SEQ,
            "steps": steps, "steps_from": pos0, "steps_s": steps_s,
            **split, "raw_step_ms": statistics.median(r_ms[KV_PAGE - pos0:]),
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


# (g): expert parallelism on the one card: olmoe-1b-7b's 64 experts over a
# "model" axis of EP_RANKS thread ranks (src/repro/models/moe.py:42-168,
# src/repro/launch/mesh.py:36), each rank a view of 16 experts
EP_RANKS, EP_BATCH, EP_TOKENS, EP_STEPS = 4, 8, 512, 32
EP_POS0 = 112                  # decode from here: a page closes mid-run
EP_TOL = 2e-2                  # of max |logit| (the serving limit)
# a decode layer's output: two bfloat16 ulps of its largest |value| (each
# rank rounds its partial sum to bfloat16 before the float32 psum, as the
# reference's decode path does; one rank rounds once)
EP_LAYER_TOL = 2.0 ** -6
# the decode steps' logits against one rank's, of max |logit|: above the
# sound runs (0.025-0.028 on an H100 80GB HBM3, 700 W), below a dropped
# rank's control (1.03; its layers 0.44-0.94, the sound ones 0.0055-0.0068)
EP_DECODE_TOL = 2.0 ** -4
EP_CONTROL_STEPS = 8
EP_TRAIN_LAYERS = 2


class RecordedRoutes:
    """A stand-in for `models.moe._top_k_experts`: records each thread's
    choices in call order (`take`), or gives the recorded choices of call
    i in place of its own (`give`), keeping the least of r and 1 / r, r
    the ratio of the weakest given expert's probability to the weakest
    own one's, over the tokens where they differ (`tie`, 1 when none)."""

    def __init__(self, real, routes=None):
        self.real, self.routes = real, routes
        self.local, self.seen, self.tie = threading.local(), {}, 1.0
        self.lock = threading.Lock()

    def __call__(self, probs, top_k):
        own = self.real(probs, top_k)
        i = getattr(self.local, "calls", 0)
        self.local.calls = i + 1
        if self.routes is None:
            with self.lock:
                self.seen.setdefault(threading.get_ident(), []).append(own)
            return own
        want = self.routes[i]
        differ = (own != want).any(-1)
        if bool(differ.any()):
            r = (probs.gather(1, want).amin(-1)
                 / probs.gather(1, own).amin(-1))[differ]
            with self.lock:
                self.tie = min(self.tie, float(torch.minimum(r, 1 / r).min()))
        return want


NEAR_TIE = 2.0 ** -4      # tests/test_torch_moe.py: a near tie's ratio


class PlantedAxis:
    """A control: the "model" axis of a rank with a fault in its psum,
    "bf16 psum" (the partials summed in bfloat16) or "rank dropped" (the
    last rank's partial left out)."""

    def __init__(self, axis, kind: str):
        self.axis, self.kind = axis, kind

    def __getattr__(self, name):
        return getattr(self.axis, name)

    def psum(self, t):
        if self.kind == "bf16 psum":
            return self.axis.psum(t.to(torch.bfloat16)).to(t.dtype)
        if self.axis.rank == self.axis.size - 1:
            t = torch.zeros_like(t)
        return self.axis.psum(t)


@contextlib.contextmanager
def planted(kind):
    """`moe.moe_ffn_decode_local` over a PlantedAxis of `kind` (None: as
    it is)."""
    from repro_torch.models import moe as M
    real = M.moe_ffn_decode_local
    if kind is not None:
        M.moe_ffn_decode_local = lambda *a, model_axis, **kw: real(
            *a, model_axis=PlantedAxis(model_axis, kind), **kw)
    try:
        yield
    finally:
        M.moe_ffn_decode_local = real


def ep_decode_layers(cfg, params, toks, plant=None) -> list:
    """Each layer's expert-parallel decode output against one rank's on
    the same input: the MoE inputs of a one-rank decode step (the decode
    path, at position 0) are kept and run again through `moe_ffn` on
    EP_RANKS ranks (with the control `plant`) and on one.  [max
    |difference| / max |one rank's|] a layer."""
    from repro_torch.compression import kv as KV
    from repro_torch.launch.mesh import run_mesh_threads
    from repro_torch.models import serve as S
    from repro_torch.models import transformer as TT
    real, calls = TT.moe_ffn, []

    def kept(*a, **kw):
        calls.append((a, {k: v for k, v in kw.items() if k != "mesh"}))
        return real(*a, **kw)

    def one_rank_step(m):
        cache = S.make_quant_cache(cfg, EP_BATCH, KV_PAGE, device=DEV)
        return S.serve_step(cfg, params, cache, toks, 0, m,
                            KV.kv_quantizer_config())[0]

    TT.moe_ffn = kept
    try:
        with torch.no_grad():
            run_mesh_threads((1,), ("model",), one_rank_step)
    finally:
        TT.moe_ffn = real
    out = []
    with torch.no_grad():
        for a, kw in calls:
            with planted(plant):
                ep = run_mesh_threads((EP_RANKS,), ("model",), lambda m: real(
                    *a, **kw, mesh=m))[0][0]
            one = run_mesh_threads((1,), ("model",), lambda m: real(
                *a, **kw, mesh=m))[0][0]
            out.append(float((ep.float() - one.float()).abs().max()
                             / one.float().abs().max()))
    return out


def moe_ep(cfg, params, seed: int) -> tuple:
    """(g): (i) a forward over EP_BATCH x EP_TOKENS seeded tokens on a
    ("model",) mesh of EP_RANKS thread ranks (the all-to-alls), every
    rank's logits against the one-rank forward: bit-equal, or within
    EP_TOL of max |logit|;
    (ii) EP_STEPS quantized decode steps at B = EP_BATCH from EP_POS0 (a
    seeded hot page before it; B12 from the step after the page closes)
    through `moe_ffn_decode_local`, each rank its own cache: each layer
    within EP_LAYER_TOL of one rank's on the same input
    (`ep_decode_layers`), the ranks' logits the same bits and within
    EP_DECODE_TOL of the one-rank steps' (the decode path on one rank, with
    the ranks' expert choices; the dispatch path keeping every pair is
    reported), and two controls with a fault planted in the psum
    (`PlantedAxis`) over EP_CONTROL_STEPS steps and the layers: a dropped
    rank must fail both limits; (iii) one AdamW step of an
    EP_TRAIN_LAYERS-layer cut at full width through the expert-parallel
    forward (`make_train_step` on a (1, EP_RANKS) mesh description), its
    gradients against the one-rank step's leaf by leaf.  Step ms, the
    bytes each all-to-all and psum moves, peak GB.  Returns (line, B12's
    row at rank 0's decode call)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.compression import kv as KV
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import Mesh, run_mesh_threads
    from repro_torch.models import build
    from repro_torch.models import moe as M
    from repro_torch.models import serve as S
    from repro_torch.models import transformer as TT
    from repro_torch.optim import optimizer as O
    gen = torch.Generator(device=DEV).manual_seed(seed + 40)
    toks = torch.randint(0, cfg.vocab, (EP_BATCH, EP_TOKENS), generator=gen,
                         device=DEV)
    on_mesh = lambda fn: run_mesh_threads((EP_RANKS,), ("model",), fn)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"phase": "moe", "part": "g", "arch": cfg.name,
           "ranks": EP_RANKS, "experts_per_rank":
               cfg.moe_experts // EP_RANKS, "layers": cfg.n_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        a = cuda_mark()
        one, one_aux = TT.forward(cfg, params, toks, None, remat=False)
        b = cuda_mark()
        got = on_mesh(lambda m: TT.forward(cfg, params, toks, m,
                                           remat=False, moe_data_axes=()))
        e = cuda_mark()
        e.synchronize()
    n = EP_BATCH * EP_TOKENS
    cap = M.capacity(n, cfg.moe_experts, cfg.moe_top_k)
    bit_equal = all(planes_equal(lg, one) and planes_equal(ax, one_aux)
                    for lg, ax in got)
    fwd_rel = max(rel(lg, one) for lg, _ in got)
    ranks_agree = all(planes_equal(lg, got[0][0]) for lg, _ in got)
    check(all(bool(torch.isfinite(lg).all()) for lg, _ in got),
          "moe (g): a non-finite logit")
    check(ranks_agree, "moe (g): the ranks' logits differ")
    check(bit_equal or fwd_rel <= EP_TOL,
          f"moe (g): the expert-parallel forward is {fwd_rel} of max|logit| "
          f"from the one-rank forward")
    out["forward"] = {
        "tokens": n, "one_rank_ms": a.elapsed_time(b),
        "ep_ms": b.elapsed_time(e), "bit_equal_to_one_rank": bit_equal,
        "rel_to_one_rank": fwd_rel, "tolerance": EP_TOL,
        "capacity": cap,
        # per layer, per rank: the [E, cap, D] bf16 buffer out and back
        "all_to_all_bytes_per_call": cfg.moe_experts * cap * cfg.d_model * 2,
        "all_to_all_bytes_crossing_per_call": cfg.moe_experts * cap
        * cfg.d_model * 2 * (EP_RANKS - 1) // EP_RANKS,
        "all_to_alls_per_rank": 2 * cfg.n_layers}
    del got, one
    # (ii) decode steps, each rank its own cache
    kv_cfg = KV.kv_quantizer_config()
    dtoks = torch.randint(0, cfg.vocab, (EP_STEPS, EP_BATCH, 1),
                          generator=gen, device=DEV, dtype=torch.int32)

    def steps(m, n=EP_STEPS):
        cache = S.make_quant_cache(cfg, EP_BATCH, SERVE_SEQ, device=DEV)
        fill = torch.Generator(device=DEV).manual_seed(seed + 43)
        for hot in (cache.hot_k, cache.hot_v):
            hot[:, :, :EP_POS0] = (torch.randn(
                hot[:, :, :EP_POS0].shape, generator=fill, device=DEV)
                * 0.7).to(hot.dtype)
        outs = []
        for i in range(n):
            lg, cache = S.serve_step(cfg, params, cache, dtoks[i],
                                     EP_POS0 + i, m, kv_cfg)
            outs.append(lg)
        return outs, cache

    b12 = "_kv_decode_attention"
    # the one-rank steps take the ranks' expert choices (a near tie can
    # flip where two paths' sums round apart; the own choices that differ
    # must be near ties): the decode path on one rank (all 64 experts
    # local: every pair kept), and the dispatch path with a capacity
    # that keeps every pair
    real_top_k, real_cap = M._top_k_experts, M.capacity
    rec = RecordedRoutes(real_top_k)
    forced = []
    with torch.no_grad():
        before = launches().get(b12, 0)
        M._top_k_experts = rec
        try:
            a = cuda_mark()
            got = on_mesh(steps)
            b = cuda_mark()
        finally:
            M._top_k_experts = real_top_k
        n_b12 = launches().get(b12, 0) - before
        routes = next(iter(rec.seen.values()))
        try:
            forced.append(RecordedRoutes(real_top_k, routes))
            M._top_k_experts = forced[-1]
            one = run_mesh_threads((1,), ("model",), steps)[0][0]
            e = cuda_mark()
            forced.append(RecordedRoutes(real_top_k, routes))
            M._top_k_experts = forced[-1]
            M.capacity = lambda n_, e_, k, f=1.0: n_ * k    # every pair kept
            kept, _ = steps(None)
        finally:
            M.capacity, M._top_k_experts = real_cap, real_top_k
        e.synchronize()
    tie = min(f.tie for f in forced)
    check(tie >= 1 - NEAR_TIE, f"moe (g): a one-rank choice off the ranks' "
          f"is no near tie ({tie})")
    want_b12 = EP_RANKS * cfg.n_layers * (EP_POS0 + EP_STEPS - KV_PAGE)
    check(n_b12 == want_b12, f"moe (g): {n_b12} B12 calls, want {want_b12}")
    dec_rel = [rel(g, w) for g, w in zip(got[0][0], one)]
    kept_rel = [rel(g, w) for g, w in zip(got[0][0], kept)]
    one_kept_rel = [rel(g, w) for g, w in zip(one, kept)]
    check(all(planes_equal(x, y) for r in got for x, y in zip(r[0],
                                                             got[0][0])),
          "moe (g): the ranks' decode logits differ")
    cache0 = got[0][1]
    row = b12_row("moe-g", layer0_queries(cfg, params, dtoks[-1],
                                          EP_POS0 + EP_STEPS, gen),
                  KV.QuantizedKV(*(t[0] for t in cache0.k)),
                  KV.QuantizedKV(*(t[0] for t in cache0.v)),
                  torch.full((EP_BATCH,), KV_PAGE, dtype=torch.int32,
                             device=DEV), SERVE_SEQ, n_b12,
                  caller="models.serve._attn_history in each rank's "
                         "expert-parallel decode step")
    layer_rel = ep_decode_layers(cfg, params, dtoks[-1])
    check(max(layer_rel) <= EP_LAYER_TOL, f"moe (g): an expert-parallel "
          f"decode layer is {max(layer_rel)} of its max |value| from one "
          f"rank's on the same input")
    check(max(dec_rel) <= EP_DECODE_TOL, f"moe (g): the expert-parallel "
          f"decode logits are {max(dec_rel)} of max |logit| from one "
          f"rank's")
    # the controls: the first EP_CONTROL_STEPS steps with a fault planted
    # in the psum, against one rank's steps on the control's own expert
    # choices (as the sound run is held), and the layers on one input; a
    # dropped rank must fail both limits
    controls = {}
    with torch.no_grad():
        for kind in ("bf16 psum", "rank dropped"):
            rec_c = RecordedRoutes(real_top_k)
            try:
                M._top_k_experts = rec_c
                with planted(kind):
                    bad = on_mesh(lambda m: steps(m, EP_CONTROL_STEPS))[0][0]
                M._top_k_experts = RecordedRoutes(
                    real_top_k, next(iter(rec_c.seen.values())))
                base = run_mesh_threads((1,), ("model",), lambda m: steps(
                    m, EP_CONTROL_STEPS))[0][0]
            finally:
                M._top_k_experts = real_top_k
            controls[kind] = {
                "logits_rel_to_one_rank_max": max(
                    rel(g, w) for g, w in zip(bad, base)),
                "layer_rel_to_one_rank": ep_decode_layers(
                    cfg, params, dtoks[-1], plant=kind)}
            del bad, base
    drop = controls["rank dropped"]
    check(drop["logits_rel_to_one_rank_max"] > EP_DECODE_TOL
          and min(drop["layer_rel_to_one_rank"]) > EP_LAYER_TOL,
          f"moe (g): a dropped rank passes the decode limits: {drop}")
    out["decode"] = {
        "batch": EP_BATCH, "steps": EP_STEPS, "from_pos": EP_POS0,
        "b12_calls": n_b12, "b12_max_abs_err": row["max_abs_err"],
        "ep_step_ms": a.elapsed_time(b) / EP_STEPS,
        "one_rank_step_ms": b.elapsed_time(e) / EP_STEPS,
        "layer_rel_to_one_rank": layer_rel,
        "layer_tolerance": EP_LAYER_TOL,
        "logits_tolerance": EP_DECODE_TOL,
        "controls": controls, "control_steps": EP_CONTROL_STEPS,
        "logits_rel_to_one_rank_max": max(dec_rel),
        "logits_rel_to_one_rank": dec_rel,
        "rel_to_dispatch_path_all_kept_max": max(kept_rel),
        "one_rank_rel_to_dispatch_path_all_kept_max": max(one_kept_rel),
        "max_abs_logit": max(float(t.abs().max()) for t in kept),
        "routes": "the ranks' choices in the one-rank steps",
        "own_choice_tie_ratio": tie,
        # per layer, per rank: the float32 [B, D] partial sums of the psum
        "psum_bytes_per_call": EP_BATCH * cfg.d_model * 4,
        "psum_bytes_crossing_per_call": EP_BATCH * cfg.d_model * 4
        * (EP_RANKS - 1), "psums_per_step": cfg.n_layers}
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del got, one, kept, cache0
    torch.cuda.empty_cache()
    # (iii) one training step of a 2-layer cut through the EP forward
    cut = dataclasses.replace(cfg, n_layers=EP_TRAIN_LAYERS)
    bundle = build(cut)
    p2 = bundle.init(torch.Generator(device=DEV).manual_seed(seed + 42),
                     device=DEV)
    tt = torch.randint(0, cfg.vocab, (EP_BATCH, EP_TOKENS + 1),
                       generator=gen, device=DEV)
    batch = {"tokens": tt[:, :-1], "labels": tt[:, 1:]}
    mesh = Mesh((1, EP_RANKS), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    a = cuda_mark()
    (l1, _), g1 = TL.value_and_grad(bundle, p2, batch, None)
    b = cuda_mark()
    (l4, _), g4 = TL.value_and_grad(bundle, p2, batch, mesh)
    e = cuda_mark()
    e.synchronize()
    names = leaf_names(g1)
    leaves = {}
    for name, x, y in zip(names, T.leaves(g4), T.leaves(g1)):
        leaves[name] = {"bit_equal": planes_equal(x, y),
                        "rel": rel(x, y) if bool(y.abs().max() > 0) else 0.}
    worst = max(v["rel"] for v in leaves.values())
    check(worst <= EP_TOL, f"moe (g): an expert-parallel gradient is "
          f"{worst} of its max |value| from the one-rank step's")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    step = TL.make_train_step(bundle, mesh, ocfg)
    c = cuda_mark()
    (p3, _), metrics = step((p2, O.init(p2, ocfg)), batch)
    f = cuda_mark()
    f.synchronize()
    check(np.isfinite(float(metrics["loss"])), "moe (g): a non-finite loss")
    out["train"] = {
        "layers": EP_TRAIN_LAYERS, "tokens": EP_BATCH * EP_TOKENS,
        "loss_one_rank": float(l1), "loss_ep": float(l4),
        "loss_bit_equal": planes_equal(l1, l4),
        "grad_one_rank_ms": a.elapsed_time(b), "grad_ep_ms": b.elapsed_time(e),
        "step_ep_ms": c.elapsed_time(f),
        "leaves_bit_equal": sum(v["bit_equal"] for v in leaves.values()),
        "leaves": len(leaves),
        "leaves_not_bit_equal": {k: v["rel"] for k, v in leaves.items()
                                 if not v["bit_equal"]},
        "rel_max": worst, "tolerance": EP_TOL,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    del p2, p3, g1, g4
    torch.cuda.empty_cache()
    return out, row


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
        line_b, row_b = serve_engine(cfg, params, seed, phase="moe")
        lc_counts = launches()
    rows.append(row_b)
    line_b["stream"] = moe_stream(cfg, params, seed)
    print(json.dumps(line_b), flush=True)
    rows += lc_rows(sel_args[0][:2], exp_args[0][:3], lc_counts, "moe")
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
    line_g, row_g = moe_ep(cfg, params, seed)
    print(json.dumps(line_g), flush=True)
    rows.append(row_g)
    del params
    torch.cuda.empty_cache()

    for name, layers, label, offset in (
            (MOE_WIDE_ARCH, MOE_WIDE_LAYERS, "moe-e", 34),
            (D80_ARCH, None, "moe-f", 35)):
        cfg = get(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params, info = load(cfg, offset)
        line, row = aligned_run(cfg, params, seed, MOE_STEPS, label)
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


TRAIN_META = (None, "grad-wire-8")     # the steps held against meta


def train_meta(bundle, spec, ocfg, gcfg, batch) -> dict:
    """The dry-run's count of `train_run`'s step on meta: the same step
    factory and flags, its state and batch as meta tensors, the pods'
    axis a MetaAxis (rank 0's program)."""
    from repro_torch.core.axis import MetaAxis
    from repro_torch.launch import cost
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    mp = bundle.abstract_params()
    mo = O.init(mp, ocfg)
    mb = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
          for k, v in batch.items()}
    if spec is None:
        step = TL.make_train_step(bundle, None, ocfg, donate=True)
        return meta_count(lambda: step((mp, mo), mb),
                          {"params": mp, "opt": mo, "batch": mb})
    step = TL.make_train_step_compressed(bundle, None, ocfg, gcfg,
                                         donate=True, shared_state=True)
    mr = TL.init_residuals(mp, TRAIN_PODS)
    rec = cost.Recorder()
    ax = MetaAxis(TRAIN_PODS, rec)
    return meta_count(lambda: step((mp, mo, mr), mb, ax),
                      {"params": mp, "opt": mo, "resid": mr, "batch": mb},
                      rec)


def train_vs_meta(label: str, meta: dict, step, state, batch,
                  pods: int, resident: int = 0) -> dict:
    """One more step on the card, counted (FLOPs per pod thread, launches
    a pod, max_memory_allocated less `resident`, the bytes the card held
    before the step's state was made), held against `meta`."""
    from repro_torch.core.axis import run_threads
    from repro_torch.launch.dryrun import launches_by_b
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if pods == 1:
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        flops = fc.get_total_flops()
    else:
        per = [0] * pods

        def pod(ax):
            with FlopCounterMode(display=False) as fc:
                step(state, batch, ax)
            per[ax.rank] = fc.get_total_flops()

        run_threads(pods, pod)
        flops = per[0]
    torch.cuda.synchronize()
    return meta_vs_card(f"train {label}", meta,
                        launches_by_b(launches(), pods), flops,
                        torch.cuda.max_memory_allocated() - resident, pods)


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
    gcfg = None if spec is None else G.GradCompressionConfig(
        eb_rel=GRAD_EB_REL, pipeline=get_pipeline(spec))
    meta = (train_meta(bundle, spec, ocfg, gcfg, batches[TRAIN_STEPS])
            if spec in TRAIN_META else None)
    params = fresh()
    state = (params, O.init(params, ocfg))
    if spec is None:
        step = TL.make_train_step(bundle, None, ocfg, donate=True)

        def run_step(b):
            return step(state, b)[1]
    else:
        step = TL.make_train_step_compressed(bundle, None, ocfg, gcfg,
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
    vs_meta = None if meta is None else train_vs_meta(
        label, meta, step, state, batches[TRAIN_STEPS], pods)
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
            "meta_vs_card": vs_meta,
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


def elastic_resize(mgr, template, bundle, want) -> dict:
    """The loop's latest raw checkpoint through `runtime.elastic.resize`
    onto a mesh of the cards at hand ((1, 1) on one card), under the
    param shardings (the optimizer's trees like the params, the step and
    the residuals replicated): every leaf and the step as saved."""
    from repro_torch import tree as T
    from repro_torch.launch import mesh as MS
    from repro_torch.optim.optimizer import OptState
    from repro_torch.runtime import elastic

    def rules(m):
        ps = MS.param_shardings(m, bundle.axes(), bundle.abstract_params())
        rep = MS.replicated(m)
        return (ps, OptState(rep, ps, ps, ps),
                T.tree_map(lambda _: rep, template[2]))

    t0 = time.perf_counter()
    states, step, mesh = elastic.resize(mgr, template, rules)
    dt = time.perf_counter() - t0
    check(mesh.shape == (1, 1) and len(states) == 1 and step == LOOP_STEPS,
          f"elastic: mesh {mesh.shape}, {len(states)} states, step {step}")
    check(all(planes_equal(a, b) for a, b in zip(T.leaves(states[0]),
                                                 T.leaves(want))),
          "elastic: a resized leaf differs from the saved state")
    return {"mesh": list(mesh.shape), "step": step, "bit_identical": True,
            "leaves": len(T.leaves(want)), "resize_s": dt}


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
                out["elastic"] = elastic_resize(mgr, init_fn("meta"), bundle,
                                                resumed)
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


# -------------------------------- tp (v): training on the sharded layout --
#
# The train phase's internlm2-20b cut (2 of its 48 layers at full width, 8
# x 512 tokens a step from its TokenPipeline, TRAIN_OPT) on the
# reference's train and gradcomp layouts (src/repro/launch/dryrun.py:
# 95-181): FSDP over the data axes, heads / mlp / vocab over "model",
# AdamW's mu, nu and master the params' blocks; the gradcomp cell with
# "pod" dropped (FSDP over "data" inside each pod, the pods' replicas).
TP_TRAIN_STEPS = 3
TP_TRAIN_WIRES = (("grad-wire-8", 2), ("grad-wire-16-narrow", 1))
# the steps held block by block: grad-wire-8's second (error feedback
# carried) and grad-wire-16-narrow's
TP_TRAIN_HELD = (("grad-wire-8", 2), ("grad-wire-16-narrow", 1))
TP_TRAIN_MESH = ((2, 2), ("data", "model"))
TP_GRADCOMP_MESH = ((2, 2, 2), ("pod", "data", "model"))
TP_TRAIN_LOSS_TOL = 1e-3       # of |loss|
TP_TRAIN_GRAD_TOL = 2e-2       # of each leaf's max |g|: moe (g)'s EP limit
TP_TRAIN_NORM_TOL = 1e-5       # relative
TP_LOCAL = threading.local()   # the thread rank's coordinates and mesh


def f32_ulps(a: float, b: float) -> int:
    """|a - b| in float32 ulps (both finite, one sign)."""
    ia, ib = (int(np.array(x, np.float32).view(np.int32)) for x in (a, b))
    return abs(ia - ib)


def f32_sum_adds(n: int) -> int:
    """The adds that one value passes through in `codec.f32_sum` over n
    values (each window of 32 folds in 31 adds, then the last fold): a
    float32 sum of n non-negative values is within that many units of
    2^-24 of the exact sum, relative."""
    adds = 0
    while n > 32:
        adds += 31
        n = -(-n // 32)
    return adds + n - 1


def eb_ulps_bound(n: int, n_block: int, ranks: int) -> int:
    """How far in float32 ulps a block's bound eb_rel * sqrt(ss / n) may
    lie from the whole leaf's: ss the whole leaf's sum of squares in one
    order (`f32_sum` over n) or the blocks' sums (over n_block each)
    psummed over `ranks` ranks; each within its adds of the exact sum,
    halved by the square root, doubled into ulps, plus a rounding each
    of the mean, the root and the product."""
    return f32_sum_adds(n) + f32_sum_adds(n_block) + ranks - 1 + 4


def tp_train_rows(m, batch: dict) -> dict:
    """The rows of the rank's "data" block of a batch (a gradcomp pod then
    takes its half of them, as the dry-run's cell gives them)."""
    n, i = m.sizes["data"], m.coords()["data"]
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


@contextlib.contextmanager
def tp_applied(keep: dict):
    """Wrap `optimizer.apply` for the block: each thread rank's gradient
    blocks and the norm it clips by, as given, kept in `keep` under the
    rank's coordinates (`TP_LOCAL.key`)."""
    from repro_torch.optim import optimizer as O
    real = O.apply

    def apply(params, grads, state, cfg, **kw):
        keep[TP_LOCAL.key] = (grads, kw.get("norm"))
        return real(params, grads, state, cfg, **kw)

    O.apply = apply
    try:
        yield keep
    finally:
        O.apply = real


def tp_train_hand_count(cfg, b: int, s: int, nd: int, nm: int) -> dict:
    """Rank 0's collective bytes of the full-precision step on the (nd,
    nm) layout of a dense config (no remat; b rows of s tokens a rank), by
    kind, from the layout's shapes as `MetaAxis` records them (an
    all-reduce at its payload, any other kind at its result): each FSDP
    block gathered over "data" where it is used and reduce-scattered in
    the backward (the embedding twice: its lookup and the logits), the KV
    product gathered over "model" and reduce-scattered back, the psums of
    `wo` and `w2` (float32), the vocab lookup (bfloat16) and the CE's sum
    and label logit, each forward and backward, the CE's pmax, the
    replicated leaves' sums over "data" and "model" (the norms), the
    metrics' mean and the global norm's psums."""
    d, h, hd, g, f = (cfg.d_model, cfg.n_heads, cfg.head_dim,
                      cfg.n_kv_heads, cfg.d_ff)
    v, n_l, bf, f4 = cfg.padded_vocab, cfg.n_layers, 2, 4
    tok = b * s
    emb = v // nm * d * bf
    layer = [d * h * hd // nm, d * 2 * g * hd // nm, h * hd // nm * d,
             d * f // nm, d * f // nm, f // nm * d]
    gathered = sum(layer) * bf
    kv = tok * 2 * g * hd * bf
    ag = 2 * emb + n_l * (gathered + kv)
    rs = 2 * emb // nd + n_l * (gathered // nd + kv // nm)
    ar = (2 * tok * d * bf + n_l * 4 * tok * d * f4 + 5 * tok * f4
          + 2 * (d + 2 * n_l * d) * f4 + 3 * f4 + 2 * 7 * f4)
    return {"all-gather": ag, "all-reduce": ar, "reduce-scatter": rs}


def tp_train_meta(bundle, ocfg) -> dict:
    """Rank 0's full-precision step of the (2, 2) layout counted on meta
    (`launch.dryrun`'s path: its blocks, MetaAxis axes), without remat as
    the thread ranks run it."""
    from repro_torch.launch import cost
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    rec = cost.Recorder()
    rmesh = DR.rank_mesh(M.Mesh(*TP_TRAIN_MESH), rec)
    with torch.device("meta"):
        mp = M.param_blocks(bundle.abstract_params(), rmesh, bundle.axes())
        mo = O.init(mp, ocfg)
        rows = TRAIN_BATCH // rmesh.sizes["data"]
        mb = {k: torch.empty((rows, TRAIN_SEQ), dtype=torch.int32)
              for k in ("tokens", "labels")}
    step = TL.make_train_step(bundle, rmesh, ocfg, donate=True, remat=False)
    return meta_count(lambda: step((mp, mo), mb),
                      {"params": mp, "opt": mo, "batch": mb}, rec)


def tp_train_one(bundle, fresh, batches, ocfg) -> dict:
    """The one-rank full-precision steps (`make_train_step`, donating)
    from fresh weights: each step's loss, grad norm and ms, and step 1's
    gradient on the host, in bfloat16 and of the same weights in float32
    (the model's activations too: `float32_stack`)."""
    from repro_torch import tree as T
    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as TT
    from repro_torch.optim import optimizer as O
    params = T.tree_map(lambda t: t.float(), fresh())
    with float32_stack(TT):
        _, g = TL.value_and_grad(bundle, params, batches[0])
    g32 = T.tree_map(lambda t: t.cpu(), g)
    del g, params
    params = fresh()
    state = (params, O.init(params, ocfg))
    _, g = TL.value_and_grad(bundle, params, batches[0])
    g1 = T.tree_map(lambda t: t.cpu(), g)
    del g
    step = TL.make_train_step(bundle, None, ocfg, donate=True)
    out = {"loss": [], "grad_norm": [], "ms": [], "grad1": g1,
           "grad1_f32": g32}
    for i in range(TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step(state, batches[i])
        out["loss"].append(float(met["loss"]))
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norm"].append(float(met["grad_norm"]))
    del state, params, step
    torch.cuda.empty_cache()
    return out


def tp_train_mesh(bundle, fresh, batches, ocfg, one: dict) -> dict:
    """TP_TRAIN_STEPS full-precision steps on the (2, 2) mesh of thread
    ranks, each rank on its views of the weights and its blocks of
    AdamW's state (`launch.mesh.rank_state`: views of the blocks that are
    its alone, copies of the norms): each step's loss and one rank's on
    the same weights, step 1's gradient joined from the blocks against
    one rank's (float32 and bfloat16), the global norm against the
    joined gradient's, and step 1's new master joined from the blocks
    bit-equal to the whole update run with the mesh's gradient and norm;
    the last step counted (FLOPs per thread, the peak) against rank 0's
    on meta."""
    from repro_torch import tree as T
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    meta = tp_train_meta(bundle, ocfg)
    params = fresh()
    ost = O.init(params, ocfg)
    desc = M.Mesh(*TP_TRAIN_MESH)
    shard = M.param_shardings(desc, bundle.axes(), params)
    oshard = O.OptState(M.replicated(desc), shard, shard, shard)
    coords = M.mesh_coords(desc)
    states = {tuple(c.values()): (M.rank_state(params, shard, c),
                                  M.rank_state(ost, oshard, c))
              for c in coords}
    flops = {}

    def run(i, count=False):
        def rank(m):
            TP_LOCAL.key = tuple(m.coords().values())
            step = TL.make_train_step(bundle, m, ocfg, donate=True)
            rows = tp_train_rows(m, batches[i])
            if not count:
                return step(states[TP_LOCAL.key], rows)[1]
            with FlopCounterMode(display=False) as fc:
                met = step(states[TP_LOCAL.key], rows)[1]
            flops[TP_LOCAL.key] = fc.get_total_flops()
            return met

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = M.run_mesh_threads(*TP_TRAIN_MESH, rank)
        torch.cuda.synchronize()
        return mets, (time.perf_counter() - t0) * 1e3

    keep = {}
    with tp_applied(keep):
        mets, ms1 = run(0)
    losses, norms, ms = [[float(m["loss"]) for m in mets]], [
        [float(m["grad_norm"]) for m in mets]], [ms1]
    # step 1's gradient joined on the host, and the master check leaf by
    # leaf: the whole update of one leaf from the fresh weights, given
    # the mesh's gradient and norm
    keys = [tuple(c.values()) for c in coords]
    grad = M.assemble([T.tree_map(lambda t: t.cpu(), keep[k][0])
                       for k in keys], shard, coords)
    norm = keep[keys[0]][1]
    del keep
    whole_norm = float(O.global_norm(T.tree_map(lambda t: t.to(DEV), grad)))
    master = M.assemble([T.tree_map(lambda t: t.cpu(), states[k][1].master)
                         for k in keys], shard, coords)
    p0 = fresh()
    master_equal = True
    for p, g, w in zip(T.leaves(p0), T.leaves(grad), T.leaves(master)):
        one_leaf = {"x": p}
        _, s1, _ = O.apply(one_leaf, {"x": g.to(DEV)},
                           O.init(one_leaf, ocfg), ocfg, norm=norm)
        master_equal &= planes_equal(s1.master["x"].cpu(), w)
        del s1
    del p0, master

    def leaf_gaps(got, want):
        return [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max())
                for a, b in zip(T.leaves(got), T.leaves(want))]

    gaps = {"mesh_vs_one_f32": leaf_gaps(grad, one["grad1_f32"]),
            "mesh_vs_one_bf16": leaf_gaps(grad, one["grad1"]),
            "one_bf16_vs_one_f32": leaf_gaps(one["grad1"], one["grad1_f32"])}
    del grad

    def same_weights_loss(i):
        # one rank's loss of batch i on the mesh's weights (joined)
        cur = M.assemble([states[k][0] for k in keys], shard, coords)
        with torch.no_grad():
            out = float(bundle.loss(cur, batches[i], remat=False)[0])
        del cur
        return out

    same = [one["loss"][0]]
    for i in range(1, TP_TRAIN_STEPS):
        same.append(same_weights_loss(i))
        count = i == TP_TRAIN_STEPS - 1
        if count:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            DR._reset_launches()
        mets, t = run(i, count=count)
        losses.append([float(m["loss"]) for m in mets])
        norms.append([float(m["grad_norm"]) for m in mets])
        ms.append(t)
    peak = torch.cuda.max_memory_allocated()
    n = len(coords)
    vs_meta = meta_vs_card(
        "tp (v) train", dict(meta, flops=n * meta["flops"]),
        DR.launches_by_b(launches()), sum(flops.values()), peak, ranks=n)
    want = tp_train_hand_count(bundle.cfg, TRAIN_BATCH // 2, TRAIN_SEQ, 2, 2)
    check(meta["collective_bytes"] == want,
          f"tp (v): rank 0's collective bytes on meta "
          f"{meta['collective_bytes']}, the layout's count {want}")
    del states, params, ost
    torch.cuda.empty_cache()
    return {"loss": losses, "one_rank_loss_same_weights": same,
            "grad_norm": norms, "ms": ms, "grad_gaps": gaps,
            "whole_norm_of_mesh_grad": whole_norm,
            "master_bit_equal": master_equal, "meta_vs_card": vs_meta,
            "collective_bytes_meta": meta["collective_bytes"],
            "collective_bytes_hand_count": want, "peak_device_GB": peak / 1e9}


@contextlib.contextmanager
def tp_held_blocks(label: str, names: list, shard, facts: dict,
               plain: dict, keep: dict):
    """Wrap compress_shard and compressed_mean for the block on the (2, 2,
    2) mesh's 8 thread ranks: as the ranks finish each leaf, the rank at
    (0, 0, 0) holds every block's pair of pods by `grad_check_leaf` (each
    pod's mean bit-equal to the plain decode-and-sum of the wires the
    pods sent, each residual within eb), and each pod's bound within
    `eb_ulps_bound` of the bound `compress_shard` gives its whole leaf
    (the blocks' inputs joined: the sum of squares in one order), while
    the others wait.  The checks' own plain decodes are taken out of the
    `plain_calls` count.  Pod 0's input of rank (0, 0)'s block of each leaf named in
    `keep` is kept (float32)."""
    from repro_torch.compression import grads as G
    from repro_torch.core import codec as C
    from repro_torch.launch import mesh as M
    real_cs, real_cm = G.compress_shard, G.compressed_mean
    slots = {}
    pod_coords = M.mesh_coords(M.Mesh(*TP_TRAIN_MESH))

    def barrier():
        # a psum over each axis in turn waits for every rank of the mesh,
        # and a rank that fails releases the others (`run_mesh_threads`)
        for a in TP_GRADCOMP_MESH[1]:
            TP_LOCAL.mesh.axis(a).psum(torch.zeros((), device=DEV))

    def cs(*a, **kw):
        out = real_cs(*a, **kw)
        TP_LOCAL.shard = out[0]
        return out

    def cm(g, cfg, axis, **kw):
        mean, resid = real_cm(g, cfg, axis, **kw)
        i = getattr(TP_LOCAL, "i", 0)
        TP_LOCAL.i = i + 1
        slots[TP_LOCAL.key] = (g, TP_LOCAL.shard, mean, resid)
        barrier()
        if TP_LOCAL.key == (0, 0, 0):
            counted = plain["calls"]
            name, s = names[i], shard[i]
            for c in pod_coords:
                d, m = c["data"], c["model"]
                ins, shards, means, resids = zip(
                    *(slots[(p, d, m)] for p in range(2)))
                grad_check_leaf(label, f"{name} block {d}, {m}", ins,
                                shards, means, resids, facts)
            for p in range(2):
                whole = M.assemble(
                    [{"g": slots[(p, c["data"], c["model"])][0]}
                     for c in pod_coords], {"g": s}, pod_coords)["g"]
                # compress_shard's bound on the whole leaf
                flat = whole.reshape(-1).float()
                inv_n = float(np.float32(1) / np.float32(flat.numel()))
                f32 = dict(dtype=torch.float32, device=flat.device)
                eb = float(torch.full((), cfg.eb_rel, **f32) * torch.sqrt(
                    C.f32_sum(flat * flat) * torch.full((), inv_n, **f32)))
                got = float(slots[(p, 0, 0)][1].enc.eb)
                u = f32_ulps(got, eb)
                lim = eb_ulps_bound(flat.numel(), slots[(p, 0, 0)][0]
                                    .numel(), len(pod_coords))
                facts["eb_ulps"] = max(facts.get("eb_ulps", 0), u)
                facts["eb_ulps_bound"] = max(
                    facts.get("eb_ulps_bound", 0), lim)
                check(u <= lim, f"{label}: pod {p}'s bound of {name} is "
                                f"{u} ulps from its whole leaf's "
                                f"(bound {lim})")
                del whole, flat
            if name in keep:
                keep[name] = slots[(0, 0, 0)][0].float()
            plain["calls"] = counted
        barrier()
        return mean, resid

    G.compress_shard, G.compressed_mean = cs, cm
    try:
        yield
    finally:
        G.compress_shard, G.compressed_mean = real_cs, real_cm


def tp_train_gradcomp(bundle, fresh, batches, ocfg) -> tuple:
    """The compressed step on the (2, 2, 2) ("pod", "data", "model") mesh
    of 8 thread ranks: each pod's ranks on their blocks under
    `param_shardings` of the pod's (2, 2) mesh ("pod" dropped), the two
    pods sharing one state (`shared_state`: pod 0's ranks update it,
    pod 1's wait), each (data, model) rank its own blocks and its blocks'
    pod-stacked residuals; TP_TRAIN_WIRES' steps with error feedback,
    TP_TRAIN_HELD's held (`tp_held_blocks`), every step with `plain_calls`
    0 and a finite loss.
    Returns (the lines, the launch counts, launches a step, w1's block
    input)."""
    from repro_torch import tree as T
    from repro_torch.compression import grads as G
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    pod_desc = M.Mesh(*TP_TRAIN_MESH)
    counts, steps, lines, keep = {}, 0, {}, {"layers/w1": None}
    for spec, n_steps in TP_TRAIN_WIRES:
        gcfg = G.GradCompressionConfig(eb_rel=GRAD_EB_REL,
                                       pipeline=get_pipeline(spec))
        params = fresh()
        ost = O.init(params, ocfg)
        shard = M.param_shardings(pod_desc, bundle.axes(), params)
        oshard = O.OptState(M.replicated(pod_desc), shard, shard, shard)
        states = {}
        for c in M.mesh_coords(pod_desc):
            p = M.rank_state(params, shard, c)
            states[tuple(c.values())] = (p, M.rank_state(ost, oshard, c),
                                         TL.init_residuals(p, 2))
        names, flat_shard = leaf_names(params), T.leaves(shard)
        losses, ms, facts_all = [], [], []
        for i in range(n_steps):
            facts = grad_facts()

            def rank(m):
                c = m.coords()
                TP_LOCAL.key, TP_LOCAL.i = tuple(c.values()), 0
                TP_LOCAL.mesh = m
                step = TL.make_train_step_compressed(
                    bundle, m, ocfg, gcfg, donate=True, shared_state=True)
                st = states[(c["data"], c["model"])]
                return step(st, tp_train_rows(m, batches[i]),
                            m.axis("pod"))[1]

            torch.cuda.synchronize()
            reset_launches()
            hold = (spec, i + 1) in TP_TRAIN_HELD
            with plain_calls() as plain, (tp_held_blocks(
                    f"tp (v) {spec} step {i + 1}", names, flat_shard, facts,
                    plain, keep) if hold else contextlib.nullcontext()):
                t0 = time.perf_counter()
                mets = M.run_mesh_threads(*TP_GRADCOMP_MESH, rank)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in launches().items():
                counts[k] = counts.get(k, 0) + v
            check(plain["calls"] == 0, f"tp (v) {spec}: the card's path "
                                       "called a plain quantizer or codec")
            loss = float(mets[0]["loss"])
            check(np.isfinite(loss), f"tp (v) {spec}: loss {loss} at step "
                                     f"{i + 1}")
            losses.append(loss)
            if hold:
                facts_all.append(facts)
            steps += 1
        lines[spec] = {
            "steps": n_steps, "loss": losses, "step_ms": ms,
            "held_steps": [i for w, i in TP_TRAIN_HELD if w == spec],
            "branches": sorted({b for f in facts_all
                                for b in f["branch"].values()}),
            "bytes_moved_per_step": [f["bytes_moved"] for f in facts_all],
            "f32_allreduce_bytes_per_step": facts_all[-1]["f32_bytes"],
            "max_resid_over_eb": max(f["max_resid_over_eb"]
                                     for f in facts_all),
            "eb_ulps_max": max(f.get("eb_ulps", 0) for f in facts_all),
            "eb_ulps_bound": max(f.get("eb_ulps_bound", 0)
                                 for f in facts_all),
            "plain_calls": 0}
        del states, params, ost
        torch.cuda.empty_cache()
    per_step = {k: v / steps for k, v in counts.items()}
    return lines, counts, per_step, keep["layers/w1"]


def tp_train(bundle, fresh, batches) -> list:
    """tp (v): training on the reference's sharded layout, the train
    phase's model and batches.  Prints its line; returns the kernel rows
    of B8, B6, B7 and B2 under the caller "train on the layout"."""
    from repro_torch.optim import optimizer as O
    t0 = time.time()
    ocfg = O.AdamWConfig(**TRAIN_OPT)
    one = tp_train_one(bundle, fresh, batches, ocfg)
    mesh = tp_train_mesh(bundle, fresh, batches, ocfg, one)
    # each step's loss against one rank's on the same weights: step 1's
    # one rank's own run, the later ones one rank's forward on the mesh's
    # weights (the two runs' bfloat16 gradients part their trajectories;
    # their gap is reported)
    for i, (want, got) in enumerate(zip(mesh["one_rank_loss_same_weights"],
                                        mesh["loss"])):
        check(all(np.isfinite(x) for x in got),
              f"tp (v): a loss {got} at step {i + 1}")
        check(all(abs(x - want) <= TP_TRAIN_LOSS_TOL * abs(want)
                  for x in got),
              f"tp (v): the mesh's loss {got} at step {i + 1}, one rank's "
              f"on the same weights {want}")
    trajectory_gap = [abs(m[0] - o) / abs(o)
                      for m, o in zip(mesh["loss"], one["loss"])]
    # the norm over the ranks' blocks against the whole tree's norm of
    # the same gradient (joined); one rank's own gradient differs from it
    # by the bfloat16 products' order, which the gradient check bounds
    whole = mesh["whole_norm_of_mesh_grad"]
    norm_gap = max(abs(x - whole) for x in mesh["grad_norm"][0]) / whole
    check(norm_gap <= TP_TRAIN_NORM_TOL,
          f"tp (v): the global norm {mesh['grad_norm'][0]} over the blocks "
          f"against {whole}, the whole tree's of the same gradient")
    one_gap = abs(mesh["grad_norm"][0][0] - one["grad_norm"][0]) / abs(
        one["grad_norm"][0])
    # against one rank's gradient of the same weights in float32, each
    # leaf within TP_TRAIN_GRAD_TOL or, where one rank's own bfloat16
    # gradient lies further from it, no further than that (the witness:
    # a token repeated hundreds of times sums its embedding row's
    # bfloat16 gradient in the lookup's scatter)
    gaps = mesh["grad_gaps"]
    lims = [max(TP_TRAIN_GRAD_TOL, w) for w in gaps["one_bf16_vs_one_f32"]]
    bad = [(n, x, lim) for n, x, lim in zip(
        leaf_names(bundle.abstract_params()), gaps["mesh_vs_one_f32"], lims)
        if x > lim]
    check(not bad, f"tp (v): step 1's gradient of one rank's (float32): "
                   f"(leaf, gap of max |g|, limit) {bad}")
    check(mesh["master_bit_equal"], "tp (v): step 1's master joined from "
          "the blocks differs from the whole update on the mesh's gradient")
    wires, counts, per_step, w1 = tp_train_gradcomp(bundle, fresh, batches,
                                                     ocfg)
    rows = grad_kernel_rows(w1, counts, per_step, names=TRAIN_ROWS,
                            chain="train on the layout")
    del w1
    counts_tok = torch.bincount(batches[0]["tokens"].reshape(-1).long())
    top = counts_tok.argmax()
    line = {"phase": "tp", "part": "(v) training on the layout",
            "model": TRAIN_ARCH, "layers": f"{TRAIN_LAYERS} of 48",
            "n_params": bundle.n_params(), "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "mesh": dict(zip(*TP_TRAIN_MESH[::-1])),
            "gradcomp_mesh": dict(zip(*TP_GRADCOMP_MESH[::-1])),
            "ranks": "threads on one card",
            "one_rank": {k: v for k, v in one.items()
                         if k not in ("grad1", "grad1_f32")},
            "leaves": leaf_names(bundle.abstract_params()),
            "full_precision": {k: v for k, v in mesh.items()},
            "loss_tol": TP_TRAIN_LOSS_TOL, "grad_tol": TP_TRAIN_GRAD_TOL,
            "norm_gap": norm_gap, "norm_tol": TP_TRAIN_NORM_TOL,
            "norm_gap_to_one_rank": one_gap,
            "loss_gap_to_one_rank_run": trajectory_gap,
            "compressed": wires, "eb_rel": GRAD_EB_REL,
            # (token, count) of step 1's most frequent token: its emb row
            # sums that many bfloat16 gradients in the lookup's scatter
            "top_token_step1": [int(top), int(counts_tok[top])],
            "launches": counts, "seconds": time.time() - t0}
    print(json.dumps(line), flush=True)
    print(f"chip_smoke: phase tp (v) {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return rows


def train_phase(seed: int) -> list:
    """(a) internlm2-20b at full width on TRAIN_LAYERS layers: the
    full-precision step, then the compressed step for each of
    TRAIN_WIRES, every run from the same weights and batches; the lossy
    coder on layer 0's wq master; then tp (v), the same model and batches
    on the reference's sharded layout (`tp_train`); (b) the loop and the
    checkpoint on the reduced configuration.  Returns the kernel rows of
    B8, B6, B7 and B2 on the train path's w1 gradient and on the
    layout's w1 block."""
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
    rows += tp_train(bundle, fresh, batches)
    loop = train_loop_check(seed)
    print(json.dumps({"phase": "train", "config": "loop",
                      "model": f"{TRAIN_ARCH} (reduced)", **loop,
                      "phase_s": time.time() - t0}), flush=True)
    return rows


# ------------------------------------------------------------ the sweep --
#
# The paper's §6 claim on the card: every float32 bit pattern through
# `core.roundtrip_dense` (B8/B9 encode, B10/B11 decode) at ABS and REL
# 1e-3 with 32-bit bins (benchmarks/exhaustive_sweep.py's defaults), then
# the paper's two baselines over the same 2**32 values.

SWEEP_SLAB = 1 << 28            # bit patterns per slab (1 GiB of float32)
SWEEP_EB = 1e-3
SWEEP_PARITY_SLAB = 3           # 0x30000000..0x3FFFFFFF: |x| in [2^-31, 2)
SWEEP_EXAMPLES = 8              # violating bit patterns kept per check


def int_cast_wraps() -> bool:
    """Whether the card's int64 -> int32 cast wraps modulo 2**32."""
    probe = torch.tensor([2 ** 31, 2 ** 32 - 1, 2 ** 31 + 5],
                         dtype=torch.int64, device=DEV).to(torch.int32)
    return probe.tolist() == [-2 ** 31, -1, -2 ** 31 + 5]


def sweep_patterns(start: int, n: int, wraps: bool) -> torch.Tensor:
    """The float32 values whose bits are start .. start + n - 1, made on
    the card: arange in int64, to int32 (2**32 subtracted above 2**31 - 1
    first where the cast does not wrap), viewed as float32."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=DEV)
    if not wraps:
        i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


def sweep_bad(x, y, cfg) -> torch.Tensor:
    """benchmarks/exhaustive_sweep.py's `verify_slab` on the card, in
    float64, each test written so that a NaN fails it: ABS |x - y| <= eb
    for every finite x; REL |x - y| / |x| <= eb for every finite non-zero
    x, and zeros bit-identical; every non-finite value bit-identical (NaN
    payloads included).  Returns the mask of violations."""
    xb, yb = x.view(torch.int32), y.view(torch.int32)
    x64, y64 = x.double(), y.double()
    err = (x64 - y64).abs()
    if cfg.mode == "abs":
        ok = err <= cfg.error_bound
    else:
        ok = torch.where(x == 0, xb == yb, err / x64.abs() <= cfg.error_bound)
    return ~torch.where(torch.isfinite(x), ok, xb == yb)


def sweep_tally(tally: dict, key: str, x, y, cfg) -> None:
    bad = sweep_bad(x, y, cfg)
    n = int(bad.sum())
    tally[key] = tally.get(key, 0) + n
    if n:
        ex = tally.setdefault(key + "_examples", [])
        idx = torch.nonzero(bad).reshape(-1)[:SWEEP_EXAMPLES - len(ex)]
        ex += [f"{b & 0xFFFFFFFF:#010x}" for b in
               x.view(torch.int32)[idx].tolist()]


def sweep_tables(f) -> dict:
    """The paper's Table 7 (protected vs unprotected ABS) and Tables 5-6
    (bit-trick vs library REL) on the port, on the dense phase's 512**3
    fields: plain torch ops on both sides of a pair, CUDA events, median
    of 25, each side timed twice in the order a, b, b, a; B8/B9's
    kernel time beside them."""
    from repro_torch.core import quantizer as q
    from repro_torch.core.config import QuantizerConfig
    from repro_torch.kernels import dense as D
    xa, xr = f["grad"], f["nyx"]
    acfg = QuantizerConfig(mode="abs", error_bound=float(rms_eb(xa)),
                           bin_bits=16)
    rcfg = QuantizerConfig(mode="rel", error_bound=SWEEP_EB, bin_bits=16)

    def pair(a, b):
        ta1, tb1, tb2, ta2 = time_ms(a), time_ms(b), time_ms(b), time_ms(a)
        return [ta1, ta2], [tb1, tb2]

    prot, unprot = pair(lambda: q.quantize_abs(xa, acfg),
                        lambda: q.quantize_abs_unprotected(xa, acfg))
    trick, lib = pair(lambda: q.quantize_rel(xr, rcfg),
                      lambda: q.quantize_rel_library(xr, rcfg))
    qa, qu = q.quantize_abs(xa, acfg), q.quantize_abs_unprotected(xa, acfg)
    qr, ql = q.quantize_rel(xr, rcfg), q.quantize_rel_library(xr, rcfg)
    return {
        "n": xa.numel(),
        "table7_abs": {"field": "grad", "eb": acfg.error_bound,
                       "bin_bits": 16, "protected_ms": prot,
                       "unprotected_ms": unprot,
                       "b8_kernel_ms": time_ms(lambda: D.quantize_abs(
                           xa, acfg)),
                       "outliers_protected": int(qa.outlier.sum()),
                       "outliers_unprotected": int(qu.outlier.sum())},
        "table5_6_rel": {"field": "nyx", "eb": SWEEP_EB, "bin_bits": 16,
                         "bit_trick_ms": trick, "library_ms": lib,
                         "b9_kernel_ms": time_ms(lambda: D.quantize_rel(
                             xr, rcfg)),
                         "outliers_bit_trick": int(qr.outlier.sum()),
                         "outliers_library": int(ql.outlier.sum()),
                         "bins_differ": int((qr.bins != ql.bins).sum())}}


def sweep_rows(x, acfg, rcfg, counts: dict) -> list:
    """B8-B11 on one slab of the sweep, held against their plain versions
    and timed; `launches` is the sweep's count."""
    from repro_torch.core import quantizer as q
    from repro_torch.core.bitops import float_to_bits
    from repro_torch.kernels import dense as D
    eb = q.full_scalar(acfg.error_bound, torch.float32, DEV).reshape(1)
    qa, qr = D.quantize_abs(x, acfg), D.quantize_rel(x, rcfg)
    zero = torch.zeros((), dtype=torch.int32, device=DEV)
    pa = torch.where(qa.outlier, float_to_bits(x), zero)
    pr = torch.where(qr.outlier, float_to_bits(x), zero)
    calls = [
        ("_quantize_abs", "abs", lambda: tuple(D.quantize_abs(x, acfg)[:3]),
         lambda: tuple(D._quantize_abs_plain(x, eb, acfg)[:3])),
        ("_quantize_rel", "rel", lambda: tuple(D.quantize_rel(x, rcfg)),
         lambda: tuple(D._quantize_rel_plain(x, rcfg))),
        ("_dequantize_abs", "abs",
         lambda: D.dequantize_abs(qa.bins, pa, qa.outlier, acfg),
         lambda: D._dequantize_abs_plain(qa.bins, pa, qa.outlier, eb, acfg)),
        ("_dequantize_rel", "rel",
         lambda: D.dequantize_rel(qr.bins, pr, qr.outlier, qr.sign, rcfg),
         lambda: D._dequantize_rel_plain(qr.bins, pr, qr.outlier, qr.sign,
                                         rcfg)),
    ]
    return [kernel_row(name, label, "sweep", 32, x.numel(), None, kern,
                       plain, counts[name])
            for name, label, kern, plain in calls]


def sweep_phase(f) -> list:
    """All 2**32 float32 bit patterns, SWEEP_SLAB at a time, through
    `core.roundtrip_dense` at ABS and REL 1e-3 (32-bit bins): 0 violations,
    no plain quantizer called, one B8 (B9) and one B10 (B11) launch a
    slab.  Over the same values: the unprotected ABS decoded with
    `decode_dense` (its violations reported, whatever they are) and the
    library REL decoded with its own exp2 (0 violations required; its bins
    against the bit-trick REL's, and on one slab its card bins against the
    CPU's).  Then `sweep_tables`.  Returns B8-B11's kernel rows."""
    from repro_torch import core as C
    from repro_torch.core import quantizer as q
    from repro_torch.kernels import dense as D
    acfg = C.QuantizerConfig(mode="abs", error_bound=SWEEP_EB, bin_bits=32)
    rcfg = C.QuantizerConfig(mode="rel", error_bound=SWEEP_EB, bin_bits=32)
    wraps = int_cast_wraps()
    n_slabs = (1 << 32) // SWEEP_SLAB
    tally, secs = {}, {}
    counts = dict.fromkeys(D.KERNELS, 0)
    lib = {"bins_differ": 0, "outliers_library": 0, "outliers_bit_trick": 0}
    zero = torch.zeros((), dtype=torch.int32, device=DEV)

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        secs[key] = secs.get(key, 0.0) + time.time() - t

    def guarded(x, mode, cfg):
        reset_launches()
        y = C.roundtrip_dense(x, cfg)
        for k, v in launches().items():
            if k in counts:
                counts[k] += v
        sweep_tally(tally, mode, x, y, cfg)

    def unprotected(x):
        qu = q.quantize_abs_unprotected(x, acfg)
        payload = torch.where(qu.outlier, C.float_to_bits(x), zero)
        y = C.decode_dense(C.EncodedDense(qu.bins, qu.outlier, payload,
                                          None, None), acfg)
        sweep_tally(tally, "abs_unprotected", x, y, acfg)

    def library(x):
        ql = q.quantize_rel_library(x, rcfg)
        sweep_tally(tally, "rel_library", x,
                    torch.where(ql.outlier, x, ql.recon), rcfg)
        qr = D.quantize_rel(x, rcfg)
        lib["bins_differ"] += int((ql.bins != qr.bins).sum())
        lib["outliers_library"] += int(ql.outlier.sum())
        lib["outliers_bit_trick"] += int(qr.outlier.sum())

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls() as plain:
        for s in range(n_slabs):
            x = sweep_patterns(s * SWEEP_SLAB, SWEEP_SLAB, wraps)
            timed("abs", lambda: guarded(x, "abs", acfg))
            timed("rel", lambda: guarded(x, "rel", rcfg))
            timed("abs_unprotected", lambda: unprotected(x))
            timed("rel_library", lambda: library(x))
            del x
    n_values = n_slabs * SWEEP_SLAB
    check(n_values == 1 << 32, "sweep: the slabs do not cover 2**32 values")
    check(plain["calls"] == 0, "sweep: the card's path called a plain "
                               "quantizer or codec")
    for k in D.KERNELS:
        check(counts[k] == n_slabs, f"sweep: {k} launched {counts[k]} "
                                    f"times for {n_slabs} slabs")
    for mode in ("abs", "rel", "rel_library"):
        check(tally.get(mode, 0) == 0, f"sweep: {tally.get(mode)} {mode} "
              f"violations, e.g. {tally.get(mode + '_examples')}")

    x = sweep_patterns(SWEEP_PARITY_SLAB * SWEEP_SLAB, SWEEP_SLAB, wraps)
    t = time.time()
    card = q.quantize_rel_library(x, rcfg)
    host = q.quantize_rel_library(x.cpu(), rcfg)
    differ = card.bins.cpu() != host.bins
    parity = {"slab_start": f"{SWEEP_PARITY_SLAB * SWEEP_SLAB:#010x}",
              "values": SWEEP_SLAB, "bins_differ": int(differ.sum()),
              "outliers_differ": int((card.outlier.cpu()
                                      != host.outlier).sum()),
              "first": None, "s": time.time() - t}
    if parity["bins_differ"]:
        i = int(torch.nonzero(differ)[0])
        parity["first"] = {
            "bits": f"{int(x.view(torch.int32)[i]) & 0xFFFFFFFF:#010x}",
            "card_bin": int(card.bins[i]), "cpu_bin": int(host.bins[i])}
    rows = sweep_rows(x, acfg, rcfg, counts)
    del x, card, host, differ
    line = {"phase": "sweep", "values_per_mode": n_values, "slabs": n_slabs,
            "slab": SWEEP_SLAB, "eb": SWEEP_EB, "bin_bits": 32,
            "int64_to_int32_wraps": wraps,
            "violations": {k: v for k, v in tally.items()
                           if not k.endswith("_examples")},
            "violation_examples": {k: v for k, v in tally.items()
                                   if k.endswith("_examples")},
            "seconds": secs, "plain_calls": plain["calls"],
            "launches": counts, "library_rel": lib,
            "library_rel_card_vs_cpu": parity,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    line["violations"].update({k: 0 for k in ("abs", "rel", "abs_unprotected",
                                              "rel_library")
                               if k not in line["violations"]})
    line.update(sweep_tables(f))
    line["phase_s"] = time.time() - t0
    print(json.dumps(line), flush=True)
    return rows


# --------------------------------------------------------- the families --
#
# whisper-base (encdec) and xlstm-350m (ssm) at full width and depth, with
# weights and frames from the seed: training, prefill and serving.

FAM_RUNS = {"whisper-base": dict(seq=448, prefill=448),
            "xlstm-350m": dict(seq=512, prefill=2048)}
# xlstm-350m trains on 2 of its 24 layers (its sLSTM is a true recurrence,
# so a step's time follows the depth); prefill and decode keep all 24
FAM_TRAIN_LAYERS = {"xlstm-350m": 2}
FAM_BATCH, FAM_STEPS, FAM_SERVE = 8, 6, 128
FAM_PROMPT, FAM_CUT_STEPS, FAM_TOL = 64, 16, 2e-2
# xlstm-350m's teacher-forced steps at full depth on its untrained weights,
# of max |logit| (0.73): in bfloat16 about twice the sound reading (0.130
# on an H100 80GB HBM3, 700 W, where bfloat16 alone moves forward 0.116 and
# the steps 0.126 from themselves in float32), and in float32 (2.9e-5)
FAM_DEEP_TOL, FAM_F32_TOL = 2.0 ** -2, 1e-4
FAM_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=FAM_STEPS)


def fam_batch(cfg, tokens, seed: int, dev=None) -> dict:
    """{"tokens"} on dev (the card by default), and for encdec "frames":
    N(0, 1) bfloat16 [B, enc_context, D] from the seed (the stubbed
    frontend's output, `launch.train.stub_frames`)."""
    from repro_torch.launch.train import stub_frames
    dev = torch.device(dev or DEV)
    batch = {"tokens": tokens.to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = stub_frames(cfg, tokens.shape[0], seed, dev)
    return batch


def tree_bytes(tree) -> int:
    from repro_torch import tree as T
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def fam_train(bundle, seed: int, seq: int) -> dict:
    """FAM_STEPS full-precision steps (loss, autograd, AdamW) at FAM_BATCH
    x seq tokens from `TokenPipeline` (whisper: and its frames): the loss
    of each step finite and the last below the first; step ms split into
    forward + backward and optimizer; the bound 6 N tokens over the bf16
    rate (whisper's encoder weights over its frames) or the state read and
    written once (28 N bytes)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as TL
    from repro_torch.optim import optimizer as O
    cfg = bundle.cfg
    ocfg = O.AdamWConfig(**FAM_OPT)
    pipe = TokenPipeline(DataConfig(cfg.vocab, seq, FAM_BATCH, seed))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(torch.Generator(device=DEV).manual_seed(seed + 60),
                         device=DEV)
    state = (params, O.init(params, ocfg))
    step = TL.make_train_step(bundle, None, ocfg, donate=True)
    losses, times = [], []
    for i in range(FAM_STEPS):
        p = pipe.batch(i)
        b = fam_batch(cfg, torch.from_numpy(p["tokens"]), seed + 100 + i)
        b["labels"] = torch.from_numpy(p["labels"]).to(DEV)
        torch.cuda.synchronize()
        with step_phases() as marks:
            a = cuda_mark()
            state, metrics = step(state, b)
            e = cuda_mark()
            e.synchronize()
        loss = float(metrics["loss"])
        check(np.isfinite(loss), f"families {cfg.name}: loss {loss} at step "
                                 f"{i + 1}")
        losses.append(loss)
        times.append(phase_ms(a, e, marks))
    check(losses[-1] < losses[0], f"families {cfg.name}: the loss did not "
                                  f"fall: {losses}")
    from repro_torch import tree as T
    n = bundle.n_params()
    n_enc = sum(t.numel() for t in T.leaves(params.get("enc", {})))
    pos = sum(params[k].numel() for k in ("enc_pos", "dec_pos")
              if k in params)
    ops = 6 * ((n - n_enc - pos) * FAM_BATCH * seq
               + n_enc * FAM_BATCH * cfg.enc_context)
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = 28 * n / HBM_BYTES_PER_S * 1e3
    med = {k: statistics.median(t[k] for t in times[1:]) for k in times[0]}
    out = {"batch": FAM_BATCH, "seq": seq, "steps": FAM_STEPS,
           "loss": losses, "step_ms": times, "median_ms": med,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share": max(t_ops, t_bytes) / med["step"],
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    del state, step
    return out, params


@contextlib.contextmanager
def slstm_timer():
    """CUDA events around every sLSTM block while the block runs:
    yields the list of (start, end) pairs."""
    from repro_torch.models import xlstm_stack as XS
    real, marks = XS.slstm_block, []

    def timed(*a, **kw):
        s = cuda_mark()
        out = real(*a, **kw)
        marks.append((s, cuda_mark()))
        return out

    XS.slstm_block = timed
    try:
        yield marks
    finally:
        XS.slstm_block = real


def fam_prefill(bundle, params, seed: int, n_tok: int) -> dict:
    """`ModelBundle.prefill` of FAM_BATCH x n_tok tokens (whisper: over its
    frames): tokens/s, and for the ssm family the sLSTM blocks' share of
    the time (a true recurrence: n_tok sequential steps a block)."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 70)
    tokens = torch.randint(0, cfg.vocab, (FAM_BATCH, n_tok), generator=gen,
                           device=DEV)
    batch = fam_batch(cfg, tokens, seed + 71)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), slstm_timer() as marks:
        torch.cuda.synchronize()
        a = cuda_mark()
        logits = bundle.prefill(params, batch)
        e = cuda_mark()
        e.synchronize()
    ms = a.elapsed_time(e)
    check(bool(torch.isfinite(logits).all()), f"families {cfg.name}: "
                                              "non-finite prefill logits")
    out = {"batch": FAM_BATCH, "tokens": n_tok, "ms": ms,
           "tokens_per_s": FAM_BATCH * n_tok / ms * 1e3,
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    if marks:
        s_ms = sum(s.elapsed_time(t) for s, t in marks)
        out.update(slstm_ms=s_ms, slstm_share=s_ms / ms,
                   slstm_blocks=len(marks))
    return out


def fam_cache(bundle, params, batch: dict, seq: int):
    """A fresh cache for `batch`'s rows on their device; whisper's cross
    K/V from the encoder over its frames (`encdec.cross_kv`)."""
    from repro_torch.models import encdec as E
    cfg = bundle.cfg
    cache = bundle.make_cache(batch["tokens"].shape[0], seq,
                              device=batch["tokens"].device)
    if cfg.family == "encdec":
        enc = E.encode(cfg, params, batch["frames"])
        cache = (cache[0], E.cross_kv(cfg, params, enc))
    return cache


def fam_serve(bundle, params, seed: int) -> dict:
    """FAM_BATCH requests, FAM_SERVE greedy decode steps from position 0:
    step ms (CUDA events, median) beside the bound (every weight the step
    reads once, and the cache or state, at the HBM rate), then one
    profiled step: kernels a step and the card's busy share."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 80)
    tok = torch.randint(0, cfg.vocab, (FAM_BATCH, 1), generator=gen,
                        device=DEV)
    batch = fam_batch(cfg, tok, seed + 81)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        cache = fam_cache(bundle, params, batch, FAM_SERVE)
        marks = []
        for pos in range(FAM_SERVE):
            a = cuda_mark()
            logits, cache = bundle.serve_step(params, cache, tok, pos)
            tok = logits.argmax(-1, keepdim=True)
            marks.append((a, cuda_mark()))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(logits).all()),
              f"families {cfg.name}: non-finite decode logits")
        steps = [a.elapsed_time(e) for a, e in marks]
        n_k, dev_ms = device_kernels(
            lambda: bundle.serve_step(params, cache, tok, FAM_SERVE - 1),
            reps=3)
    if cfg.family == "encdec":
        weights = tree_bytes(params["dec"]) + tree_bytes(
            {k: params[k] for k in ("emb", "final_norm")})
        state = tree_bytes(cache[1]) + tree_bytes(cache[0]) // 2
    else:
        weights = tree_bytes(params)
        state = 2 * tree_bytes(cache)                # read and written
    med = statistics.median(steps[1:])
    bound = (weights + state) / HBM_BYTES_PER_S * 1e3
    return {"batch": FAM_BATCH, "steps": FAM_SERVE, "step_ms_median": med,
            "step_ms_first": steps[0], "bound_ms": bound, "bound_by": "bytes",
            "share": bound / med, "weight_bytes": weights,
            "cache_bytes": state,
            "kernels_per_step": n_k,
            "device_busy_ms": sum(dev_ms.values()) or None,
            "busy_share": (sum(dev_ms.values()) / med) if dev_ms else None,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}


def fam_forced_run(bundle, params, seed: int) -> tuple:
    """FAM_PROMPT teacher-forced decode steps and `forward` over the same
    seeded tokens: (forward's logits, the steps' [B, FAM_PROMPT, V], both
    float32)."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 90)
    tokens = torch.randint(0, cfg.vocab, (FAM_BATCH, FAM_PROMPT),
                           generator=gen, device=DEV)
    batch = fam_batch(cfg, tokens, seed + 91)
    with torch.no_grad():
        fwd, _ = bundle._forward(params, batch, None, remat=False)
        cache = fam_cache(bundle, params, batch, FAM_PROMPT)
        steps = []
        for pos in range(FAM_PROMPT):
            got, cache = bundle.serve_step(params, cache,
                                           tokens[:, pos:pos + 1], pos)
            steps.append(got)
    return fwd.float(), torch.stack(steps, 1)


def position_gaps(fwd, steps) -> list:
    """At each position, the largest |difference| over the largest |logit|
    of `fwd` there."""
    return [float((steps[:, p] - fwd[:, p]).abs().max()
                  / fwd[:, p].abs().max()) for p in range(fwd.shape[1])]


def forced_gap(fwd, steps) -> float:
    """The worst position's `position_gaps`."""
    return max(position_gaps(fwd, steps))


def fam_teacher_forced(bundle, params, seed: int) -> float:
    """FAM_PROMPT teacher-forced decode steps against `forward`'s logits at
    every position: the worst `forced_gap` (must be within FAM_TOL)."""
    worst = forced_gap(*fam_forced_run(bundle, params, seed))
    check(worst <= FAM_TOL, f"families {bundle.cfg.name}: teacher-forced "
                            f"steps {worst} of max |logit| from forward")
    return worst


@contextlib.contextmanager
def float32_stack(*mods):
    """Each module's DTYPE (the activations, and the caches it makes) set
    to float32 while the block runs."""
    real = [m.DTYPE for m in mods]
    for m in mods:
        m.DTYPE = torch.float32
    try:
        yield
    finally:
        for m, d in zip(mods, real):
            m.DTYPE = d


def fam_teacher_forced_deep(bundle, params, seed: int) -> dict:
    """The teacher-forced steps at full depth on the untrained weights, in
    bfloat16 and, as the witness of what bfloat16 rounding does there,
    again in float32 (the weights cast, `xlstm_stack.DTYPE` float32 by
    `float32_stack`): the bfloat16 gap within FAM_DEEP_TOL, the float32
    one within FAM_F32_TOL; beside them the largest |logit|, the largest
    |difference|, and how far each path in bfloat16 lies from itself in
    float32."""
    from repro_torch import tree as T
    from repro_torch.models import xlstm_stack as XS
    name = bundle.cfg.name
    fwd, steps = fam_forced_run(bundle, params, seed)
    p32 = T.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                     params)
    with float32_stack(XS):
        fwd32, steps32 = fam_forced_run(bundle, p32, seed)
    del p32
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    out = {"layers": bundle.cfg.n_layers, "bf16_rel_max":
           forced_gap(fwd, steps), "f32_rel_max": forced_gap(fwd32, steps32),
           "max_abs_logit": float(fwd.abs().max()),
           "abs_gap_max": float((steps - fwd).abs().max()),
           "forward_bf16_vs_f32": rel(fwd, fwd32),
           "steps_bf16_vs_f32": rel(steps, steps32),
           "tolerance": FAM_DEEP_TOL, "f32_tolerance": FAM_F32_TOL}
    check(out["f32_rel_max"] <= FAM_F32_TOL, f"families {name}: float32 "
          f"teacher-forced steps at full depth {out['f32_rel_max']}")
    check(out["bf16_rel_max"] <= FAM_DEEP_TOL, f"families {name}: "
          f"teacher-forced steps at full depth {out['bf16_rel_max']}")
    return out


def fam_cut_vs_cpu(name: str, seed: int) -> dict:
    """A 2-layer cut at full width on the card against the port's CPU path
    on the same weights: the loss, the prefill logits and FAM_CUT_STEPS
    decode steps (each within FAM_TOL of the CPU's max |logit|; the loss
    within 1e-3 of itself + 1e-3)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs.registry import get
    from repro_torch.models import build
    full = get(name)
    cfg = dataclasses.replace(full, n_layers=2,
                              enc_layers=min(full.enc_layers, 2))
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=DEV).manual_seed(seed + 95),
                         device=DEV)
    cpu = T.tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator().manual_seed(seed + 96)
    tok = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    host = fam_batch(cfg, tok[:, :-1], seed + 97, "cpu")
    host["labels"] = tok[:, 1:]
    card = {k: v.to(DEV) for k, v in host.items()}

    def rel(a, b):
        return float((a.cpu().float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        lc, lh = bundle.loss(params, card)[0], bundle.loss(cpu, host)[0]
        d_loss = abs(float(lc) - float(lh))
        pre = rel(bundle.prefill(params, card), bundle.prefill(cpu, host))
        cc = fam_cache(bundle, params, card, FAM_CUT_STEPS)
        hc = fam_cache(bundle, cpu, host, FAM_CUT_STEPS)
        steps = []
        for pos in range(FAM_CUT_STEPS):
            t = tok[:, pos:pos + 1]
            oc, cc = bundle.serve_step(params, cc, t.to(DEV), pos)
            oh, hc = bundle.serve_step(cpu, hc, t, pos)
            steps.append(rel(oc, oh))
    check(d_loss <= 1e-3 * abs(float(lh)) + 1e-3,
          f"families {name}: 2-layer loss {float(lc)} on the card, "
          f"{float(lh)} on the CPU")
    check(pre <= FAM_TOL and max(steps) <= FAM_TOL,
          f"families {name}: 2-layer card vs CPU prefill {pre}, steps "
          f"{max(steps)}")
    return {"layers": 2, "loss_card": float(lc), "loss_cpu": float(lh),
            "prefill_rel": pre, "steps_rel_max": max(steps)}


def families_phase(seed: int) -> None:
    """A13's encdec and ssm families at full width and depth (xlstm's
    training at FAM_TRAIN_LAYERS of its layers): per model a line with (a)
    training, (b) prefill, (c) serving, and the checks (teacher-forced
    steps against forward on the trained weights, and for xlstm also at
    full depth with its float32 witness; a 2-layer cut against the CPU
    path)."""
    from repro_torch.configs.registry import get
    from repro_torch.models import build
    import dataclasses
    for name, run in FAM_RUNS.items():
        t0 = time.time()
        gc.collect()
        torch.cuda.empty_cache()
        bundle = build(get(name))
        cut = FAM_TRAIN_LAYERS.get(name)
        if cut is None:
            train, params = fam_train(bundle, seed, run["seq"])
            trained = (bundle, params)
        else:
            cut_bundle = build(dataclasses.replace(get(name), n_layers=cut))
            train, cut_params = fam_train(cut_bundle, seed, run["seq"])
            train["layers"] = cut
            trained = (cut_bundle, cut_params)
            params = bundle.init(torch.Generator(device=DEV).manual_seed(
                seed + 60), device=DEV)
        line = {"phase": "families", "model": name,
                "n_params": bundle.n_params(), "train": train}
        line["prefill"] = fam_prefill(bundle, params, seed, run["prefill"])
        line["serve"] = fam_serve(bundle, params, seed)
        line["teacher_forced_rel_max"] = fam_teacher_forced(*trained, seed)
        line["teacher_forced_layers"] = trained[0].cfg.n_layers
        if cut is not None:
            line["teacher_forced_full_depth"] = fam_teacher_forced_deep(
                bundle, params, seed)
        del params, trained
        torch.cuda.empty_cache()
        line["cut_vs_cpu"] = fam_cut_vs_cpu(name, seed)
        line["tolerance"] = FAM_TOL
        line["phase_s"] = time.time() - t0
        print(json.dumps(line), flush=True)


# ------------------------------------------------------------ the hybrid --
#
# jamba-1.5-large-398b (src/repro/configs/registry.py:67-71) at full width:
# d 8,192, 64 heads over 8 KV heads of 128, d_ff 24,576, 16 experts top 2,
# Di 16,384, N 16; one period of its 9 (8 of 72 layers: 7 Mamba blocks and
# an attention block, 4 dense and 4 MoE FFNs).  Its 4 MoE FFNs hold 77.3 GB
# of experts, so the period (92.9 GB) does not fit one card: the four share
# one seeded set of expert tensors (stride-0 views, `hybrid_params`), 34.9
# GB resident; every width and every product stays, and each bound counts
# the experts as if untied.
HYB_ARCH = "jamba-1.5-large-398b"
HYB_PREFILL = 4_096            # prefill_32k's 32,768 tokens cut x8
HYB_B, HYB_STEPS, HYB_SEQ = 8, 64, 128
HYB_LONG_S, HYB_LONG_STEPS = 524_288, 8       # long_500k: B = 1
HYB_LONG_POS = HYB_LONG_S - HYB_STEPS         # K, V seeded below it
HYB_TOL = 2e-2                 # of max |logit| (the serving limit)
# (b)'s limit, with the state reaching the logits: sound runs read
# 0.024-0.026 (bfloat16 rounding, (e) is the witness), a step that drops
# h 0.48-0.58 and one that drops the conv tail 1.56-1.60 (PERF.md §6)
HYB_DECODE_TOL = 2.0 ** -4
HYB_F32_TOL = 1e-4             # (e)'s float32 witness, as FAM_F32_TOL
HYB_FAULTS = ("tail", "h")     # (b)'s planted faults: the state zeroed
HYB_BC_SCALE = 6.0             # bc_proj at U(-1, 1) HYB_BC_SCALE / sqrt(Di)
HYB_CUT_STEPS, HYB_TRAIN_STEPS = 16, 6
HYB_TRAIN_B, HYB_TRAIN_SEQ = 8, 64
HYB_META_SEQ = 256             # (f): 4 chunks a Mamba scan
HYB_TIED = ("w1", "w3", "w2")


def spec_bytes(specs) -> int:
    """The bytes of a spec tree's weights (each leaf as if untied)."""
    from repro_torch.models.params import tree_leaves
    return sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
               .element_size() for s in tree_leaves(specs))


def hybrid_params(bundle, seed: int) -> dict:
    """The bundle's weights on the card from the seed, but for the MoE
    FFNs' experts: one seeded [E, D, F] (and [E, F, D]) set, given to
    every MoE FFN of every period as a stride-0 view."""
    from repro_torch.models.params import ParamSpec, materialize
    specs = bundle.specs
    moe = specs["periods"]["moe_ffn"]
    rest = {**specs, "periods": {**specs["periods"], "moe_ffn": {
        k: v for k, v in moe.items() if k not in HYB_TIED}}}
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = materialize(rest, gen, DEV)
    lead = len(moe["router"].shape) - 2
    one = materialize({k: ParamSpec(moe[k].shape[lead:], moe[k].dtype,
                                    moe[k].axes[lead:], moe[k].init_scale)
                       for k in HYB_TIED}, gen, DEV)
    got = params["periods"]["moe_ffn"]
    params["periods"]["moe_ffn"] = {
        k: one[k][(None,) * lead].expand(moe[k].shape) if k in HYB_TIED
        else got[k] for k in moe}
    state_mamba(params, gen)
    return params


def state_mamba(params: dict, gen: torch.Generator) -> None:
    """Redraw every Mamba block's a_log, dt_bias, conv_w and bc_proj in
    place as tests/test_torch_hybrid.py's STATE weights are drawn: A =
    -(1 .. N) and dt log-uniform in [1e-3, 1e-1] (Mamba's own init), the
    conv at Conv1d's U(-1/2, 1/2), bc_proj at U(-1, 1) HYB_BC_SCALE /
    sqrt(Di).  At the port's init (A = -e, dt near 1.3) the state decays
    by ~e^-3.6 a step and a block's output is its skip term u D, so no
    check of the decode could see a step that drops the conv tail or h.
    The tests' bc_proj scale, 64, gives B and C ~2.6 at d 128; at d 8,192
    silu(conv) is ~5x larger (in_proj at 1 / sqrt(d) against 0.02), and
    6 gives B and C ~1, the state's term of the size of the skip term
    (64 makes it ~100x and (b) reads 0.124; PERF.md §6)."""
    m = params["periods"]["mamba"]
    n, di = m["a_log"].shape[-1], m["conv_w"].shape[-1]
    m["a_log"].copy_(torch.log(torch.arange(1, n + 1, device=DEV,
                                            dtype=torch.float32)))
    dt = torch.empty(m["dt_bias"].shape, device=DEV).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    m["conv_w"].uniform_(-0.5, 0.5, generator=gen)
    bc = torch.empty(m["bc_proj"].shape, device=DEV).uniform_(
        -1.0, 1.0, generator=gen)
    m["bc_proj"].copy_(bc.mul_(HYB_BC_SCALE / math.sqrt(di)))


@contextlib.contextmanager
def scan_timer():
    """CUDA events around every Mamba scan (`mamba.chunked_scan`) while
    the block runs: yields the list of (start, end) pairs."""
    from repro_torch.models import mamba as MB
    real, marks = MB.chunked_scan, []

    def timed(*a, **kw):
        s = cuda_mark()
        out = real(*a, **kw)
        marks.append((s, cuda_mark()))
        return out

    MB.chunked_scan = timed
    try:
        yield marks
    finally:
        MB.chunked_scan = real


@contextlib.contextmanager
def every_pair_kept():
    """`models.moe.capacity` at N K slots an expert while the block runs:
    no (token, expert) pair drops, in a forward over B T tokens as in a
    step over B."""
    from repro_torch.models import moe as M
    real = M.capacity
    M.capacity = lambda n, e, k, cf=1.0: n * k
    try:
        yield
    finally:
        M.capacity = real


class GivenRoutes:
    """A stand-in for `models.moe._top_k_experts`: keeps the expert
    choices of the calls it sees while recording, then (`give`) gives
    them back.  With `b` and `t` set, a call over b tokens (a decode
    step) takes position `pos` of the recorded calls over b t tokens (a
    forward), one layer after another; any other call takes the recorded
    call at its place in the order.  Keeps how often a call's own choice
    differs (`differ`) and the least of r and 1 / r at those tokens
    (`tie`, 1 when none), r the ratio of the weakest given expert's
    probability to the weakest own one's."""

    def __init__(self, real, b: int = 0, t: int = 0):
        self.real, self.b, self.t, self.seen = real, b, t, []
        self.recording = True

    def give(self):
        """From now on give the recorded choices, from the first."""
        self.recording, self.order, self.steps = False, 0, 0
        self.differ, self.tie = 0, 1.0
        return self

    def __call__(self, probs, top_k):
        own = self.real(probs, top_k)
        if self.recording:
            self.seen.append(own)
            return own
        if self.b and probs.shape[0] == self.b:
            n = len(self.seen)
            layer, pos = self.steps % n, self.steps // n
            self.steps += 1
            want = self.seen[layer].reshape(self.b, self.t, top_k)[:, pos]
        else:
            want = self.seen[self.order]
            self.order += 1
        want = want.to(own.device)
        differ = (own != want).any(-1)
        if bool(differ.any()):
            r = (probs.gather(1, want).amin(-1)
                 / probs.gather(1, own).amin(-1))[differ]
            self.differ += int(differ.sum())
            self.tie = min(self.tie, float(torch.minimum(r, 1 / r).min()))
        return want


@contextlib.contextmanager
def routes_given(b: int = 0, t: int = 0):
    """A `GivenRoutes` in place of `models.moe._top_k_experts` while the
    block runs; yields it."""
    from repro_torch.models import moe as M
    real = M._top_k_experts
    M._top_k_experts = GivenRoutes(real, b, t)
    try:
        yield M._top_k_experts
    finally:
        M._top_k_experts = real


def hyb_steps(bundle, params, toks, fault=None) -> torch.Tensor:
    """Teacher-forced `serve_step`s over toks [B, T] from position 0 on a
    fresh `make_cache(B, HYB_SEQ)`: the logits [B, T, V] float32.  A
    planted `fault` ("tail" or "h") zeroes every Mamba block's conv tail
    or SSM state after each step."""
    cache = bundle.make_cache(toks.shape[0], HYB_SEQ, device=DEV)
    out = []
    for pos in range(toks.shape[1]):
        got, cache = bundle.serve_step(params, cache, toks[:, pos:pos + 1],
                                       pos)
        out.append(got)
        if fault is not None:
            cache[1][HYB_FAULTS.index(fault)].zero_()
    return torch.stack(out, 1)


def hyb_forced(bundle, params, toks, routes) -> tuple:
    """`forward` over toks and the teacher-forced steps, every pair kept in
    both, the steps given the forward's expert choices (`routes`, a
    recording `GivenRoutes`): (forward's logits float32, the steps')."""
    with every_pair_kept():
        fwd, _ = bundle._forward(params, {"tokens": toks}, None, remat=False)
        routes.give()
        return fwd.float(), hyb_steps(bundle, params, toks)


def hyb_bytes(bundle, params) -> dict:
    """The weights' bytes: untied (every MoE FFN its own experts), those of
    the experts alone untied, and resident on the card."""
    from repro_torch import tree as T
    moe = bundle.specs["periods"]["moe_ffn"]
    return {"weights_untied": spec_bytes(bundle.specs),
            "experts_untied": spec_bytes({k: moe[k] for k in HYB_TIED}),
            "resident": sum(t.untyped_storage().nbytes() for t in {
                t.untyped_storage().data_ptr(): t
                for t in T.leaves(params)}.values())}


def hyb_prefill(bundle, params, seed: int) -> dict:
    """(a) `ModelBundle.prefill` of 1 x HYB_PREFILL seeded tokens: ms,
    tokens/s, the Mamba scans' share (CUDA events around each), peak GB,
    and the operations bound (2 N_active a token, every block of the
    attention's scores and p v as the reference computes them)."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 110)
    tokens = torch.randint(0, cfg.vocab, (1, HYB_PREFILL), generator=gen,
                           device=DEV)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), scan_timer() as marks:
        torch.cuda.synchronize()
        a = cuda_mark()
        logits = bundle.prefill(params, {"tokens": tokens})
        e = cuda_mark()
        e.synchronize()
    ms = a.elapsed_time(e)
    check(bool(torch.isfinite(logits).all()), "hybrid (a): non-finite "
                                              "prefill logits")
    del logits
    peak = torch.cuda.max_memory_allocated()
    vs_meta = hyb_prefill_vs_meta(bundle, params, tokens)
    scan_ms = sum(s.elapsed_time(t) for s, t in marks)
    # the lookup is free; the logits read the padded table
    active = cfg.active_param_count() + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    attn = 4 * HYB_PREFILL ** 2 * cfg.n_heads * cfg.head_dim \
        * (cfg.n_layers // cfg.attn_period)
    ops = 2 * active * HYB_PREFILL + attn
    return {"tokens": HYB_PREFILL, "ms": ms,
            "tokens_per_s": HYB_PREFILL / ms * 1e3, "scan_ms": scan_ms,
            "scan_share": scan_ms / ms, "scans": len(marks),
            "ops_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "peak_device_GB": peak / 1e9, "meta_vs_card": vs_meta}


def storage_bytes(tree) -> int:
    """The bytes of a tree's distinct storages, each rounded to the
    allocator's granule: the hybrid's tied experts (stride-0 views of one
    set) count once, where `cost.tree_bytes` counts every view whole."""
    from repro_torch import tree as T
    from repro_torch.launch import cost
    seen = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in T.leaves(tree) if torch.is_tensor(t)}
    return sum(cost.granule_bytes(n) for n in seen.values())


def meta_params_tied(bundle) -> dict:
    """The bundle's params on meta with the MoE FFNs' experts one set, as
    `hybrid_params` gives them to the card."""
    mp = bundle.abstract_params()
    moe = mp["periods"]["moe_ffn"]
    lead = moe["router"].dim() - 2
    for k in HYB_TIED:
        one = torch.empty(moe[k].shape[lead:], dtype=moe[k].dtype,
                          device="meta")
        moe[k] = one[(None,) * lead].expand(moe[k].shape)
    return mp


def hyb_prefill_vs_meta(bundle, params, tokens) -> dict:
    """(a)'s prefill counted on meta (the Mamba scans scaled: 64 chunks a
    block) and once more on the card: launches and FLOPs equal, the peak
    within META_PEAK_TOL (`meta_vs_card`)."""
    from repro_torch.launch import cost
    from repro_torch.launch.dryrun import launches_by_b
    mp = meta_params_tied(bundle)
    mt = torch.empty(tokens.shape, dtype=tokens.dtype, device="meta")
    base = storage_bytes({"params": mp, "tokens": mt})
    reset_launches()
    with torch.no_grad(), cost.counting(base) as c:
        bundle.prefill(mp, {"tokens": mt})
    meta = {"launches": launches_by_b(launches()), "flops": c.flops,
            "held_bytes": base, "peak_bytes": c.peak_bytes,
            "collective_bytes": c.collective_bytes, "seconds": c.seconds}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        bundle.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    return meta_vs_card("hybrid (a) prefill", meta, launches_by_b(
        launches()), fc.get_total_flops(), torch.cuda.max_memory_allocated())


def hyb_step_vs_meta(seed: int) -> dict:
    """(f) One loss + gradient + AdamW step of the reduced jamba at B =
    HYB_TRAIN_B, T = HYB_META_SEQ (HYB_META_SEQ / 64 chunks a Mamba
    block; (d) trains at 64, one chunk), `make_train_step` as the
    dry-run's train cells take it: counted on meta (`train_meta`), then
    after a first step one more on the card (`train_vs_meta`)."""
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as TL
    from repro_torch.models import build
    from repro_torch.optim import optimizer as O
    cfg = get(HYB_ARCH).reduced()
    bundle = build(cfg)
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    pipe = TokenPipeline(DataConfig(cfg.vocab, HYB_META_SEQ, HYB_TRAIN_B,
                                    seed))
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in pipe.batch(i).items()} for i in range(2)]
    meta = train_meta(bundle, None, ocfg, None, batches[1])
    gc.collect()
    resident = torch.cuda.memory_allocated() - sum(
        t.untyped_storage().nbytes() for b in batches for t in b.values())
    params = bundle.init(torch.Generator(device=DEV).manual_seed(seed + 115),
                         device=DEV)
    state = (params, O.init(params, ocfg))
    step = TL.make_train_step(bundle, None, ocfg, donate=True)
    loss = float(step(state, batches[0])[1]["loss"])
    check(np.isfinite(loss), f"hybrid (f): loss {loss}")
    out = train_vs_meta("hybrid (f)", meta, step, state, batches[1], 1,
                        resident)
    return {"config": "reduced", "batch": HYB_TRAIN_B, "seq": HYB_META_SEQ,
            "chunks_per_scan": HYB_META_SEQ // 64, "loss": loss,
            "resident_before_GB": resident / 1e9, "meta_vs_card": out}


def hyb_decode(bundle, params, seed: int, sizes: dict) -> tuple:
    """(b) HYB_B requests, HYB_STEPS teacher-forced `serve_step`s from
    position 0 on `make_cache(HYB_B, HYB_SEQ)`: step ms (CUDA events,
    median) beside the bound (every weight read once as if untied, and
    the state read and written), and beside it with the experts the steps
    routed to; a profiled step's kernels and busy share.  Then the check:
    `forward` over the same tokens and the steps again on a fresh cache,
    every pair kept in both and forward's expert choices given to the
    steps (`hyb_forced`): within HYB_DECODE_TOL of forward's max |logit|
    at every position, and a step's own choice differs only at a near tie.
    Then the planted faults: the steps again, each dropping the conv
    tails or the SSM states (HYB_FAULTS), must each leave HYB_DECODE_TOL.
    Returns (line, batch row 0 of the timed run's cache)."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 111)
    toks = torch.randint(0, cfg.vocab, (HYB_B, HYB_STEPS), generator=gen,
                         device=DEV)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        cache = bundle.make_cache(HYB_B, HYB_SEQ, device=DEV)
        marks = []
        with moe_dispatch_counts() as moe:
            for pos in range(HYB_STEPS):
                a = cuda_mark()
                logits, cache = bundle.serve_step(params, cache,
                                                  toks[:, pos:pos + 1], pos)
                marks.append((a, cuda_mark()))
            torch.cuda.synchronize()
        check(bool(torch.isfinite(logits).all()),
              "hybrid (b): non-finite decode logits")
        steps = [a.elapsed_time(e) for a, e in marks]
        state_bytes = 2 * sum(t.numel() * t.element_size() for t in cache[1])
        row0 = (tuple(t[:, 0:1].clone() for t in cache[0]),
                tuple(t[:, :, 0:1].clone() for t in cache[1]))
        n_k, dev_ms = device_kernels(
            lambda: bundle.serve_step(params, cache, toks[:, -1:],
                                      HYB_STEPS), reps=2)
        del cache
        with routes_given(HYB_B, HYB_STEPS) as routes:
            fwd, forced = hyb_forced(bundle, params, toks, routes)
            gaps = position_gaps(fwd, forced)
            differ, tie = routes.differ, routes.tie
            faults = {}
            for fault in HYB_FAULTS:
                routes.give()
                with every_pair_kept():
                    faults[fault] = forced_gap(fwd, hyb_steps(
                        bundle, params, toks, fault))
        del fwd, forced
    check(max(gaps) <= HYB_DECODE_TOL, f"hybrid (b): teacher-forced "
          f"steps {max(gaps)} of max |logit| from forward")
    check(tie >= 1.0 - NEAR_TIE, f"hybrid (b): a step's own expert "
          f"choice differs from forward's at ratio {tie}")
    for fault, gap in faults.items():
        check(gap > HYB_DECODE_TOL, f"hybrid (b): a step that drops the "
              f"{fault} reads {gap}, within {HYB_DECODE_TOL} of forward")
    disp = dispatch_summary(moe, HYB_STEPS)
    kv = 2 * 2 * HYB_B * HYB_STEPS * cfg.n_kv_heads * cfg.head_dim \
        * (cfg.n_layers // cfg.attn_period)        # K, V read at the end
    w, ex = sizes["weights_untied"], sizes["experts_untied"]
    med = statistics.median(steps[1:])
    bound = (w + state_bytes + kv) / HBM_BYTES_PER_S * 1e3
    routed = (w - ex + ex * disp["experts_used_per_call"] / cfg.moe_experts
              + state_bytes + kv) / HBM_BYTES_PER_S * 1e3
    return {"batch": HYB_B, "steps": HYB_STEPS, "cache_seq": HYB_SEQ,
            "step_ms_median": med, "step_ms_first": steps[0],
            "bound_ms": bound, "bound_by": "bytes", "share": bound / med,
            "bound_routed_ms": routed, "state_bytes": state_bytes,
            "kernels_per_step": n_k,
            "device_busy_ms": sum(dev_ms.values()) or None,
            "busy_share": (sum(dev_ms.values()) / med) if dev_ms else None,
            "device_ms_by_kind": device_groups(dev_ms),
            "teacher_forced_rel_max": max(gaps),
            "tolerance": HYB_DECODE_TOL,
            "teacher_forced_rel_at": {p: gaps[p] for p in (
                0, 1, 7, 15, 31, HYB_STEPS - 1)},
            "teacher_forced_worst_pos": int(np.argmax(gaps)),
            "own_choices_differ": differ, "near_tie_ratio": tie,
            "planted_rel_max": faults,
            **disp, "peak_device_GB": torch.cuda.max_memory_allocated()
            / 1e9}, row0


def hyb_long(bundle, params, seed: int, row0, sizes: dict) -> dict:
    """(c) long_500k: B = 1 at S = HYB_LONG_S, the attention cache's K and
    V N(0,1)*0.7 below HYB_LONG_POS, the Mamba states those of batch row
    0 after (b)'s 64 steps; HYB_LONG_STEPS steps from HYB_LONG_POS: step
    ms (CUDA events, median) against the bound (the weights as if untied
    plus the K and V the length needs) and against it with only the
    experts the steps routed to (the port reads all 16, ROADMAP B' 10),
    finite logits."""
    cfg = bundle.cfg
    gen = torch.Generator(device=DEV).manual_seed(seed + 112)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.no_grad():
        cache = bundle.make_cache(1, HYB_LONG_S, device=DEV)
        for plane in cache[0]:
            for p in range(plane.shape[0]):
                plane[p, :, :HYB_LONG_POS] = (torch.randn(
                    plane[p, :, :HYB_LONG_POS].shape, generator=gen,
                    device=DEV) * 0.7).to(plane.dtype)
        for dst, src in zip(cache[1], row0[1]):
            dst.copy_(src)
        torch.cuda.synchronize()
        fill_s = time.time() - t0
        toks = torch.randint(0, cfg.vocab, (HYB_LONG_STEPS, 1, 1),
                             generator=gen, device=DEV)
        marks, outs = [], []
        with moe_dispatch_counts() as moe:
            for i in range(HYB_LONG_STEPS):
                a = cuda_mark()
                logits, cache = bundle.serve_step(params, cache, toks[i],
                                                  HYB_LONG_POS + i)
                marks.append((a, cuda_mark()))
                outs.append(logits)
            torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    check(finite, "hybrid (c): a logit is not finite")
    ms = [a.elapsed_time(e) for a, e in marks]
    kv = sum(t.numel() * t.element_size() for t in cache[0])
    need = kv * (HYB_LONG_POS + HYB_LONG_STEPS) // HYB_LONG_S
    med = statistics.median(ms[1:])
    w, ex = sizes["weights_untied"], sizes["experts_untied"]
    disp = dispatch_summary(moe, HYB_LONG_STEPS)
    bound = (w + need) / HBM_BYTES_PER_S * 1e3
    routed = (w - ex + ex * disp["experts_used_per_call"]
              / bundle.cfg.moe_experts + need) / HBM_BYTES_PER_S * 1e3
    del cache
    return {"batch": 1, "seq": HYB_LONG_S, "pos": HYB_LONG_POS,
            "steps": HYB_LONG_STEPS, "fill_s": fill_s, "step_ms": med,
            "step_ms_all": ms, "kv_bytes": kv, "bound_ms": bound,
            "bound_by": "bytes", "share": bound / med,
            "bound_routed_ms": routed, "share_routed": routed / med, **disp,
            "logits_finite": finite,
            "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}


def hyb_cut_vs_cpu(seed: int) -> dict:
    """(d) The reduced jamba (models' `.reduced()`: one period, d 128) on
    the same weights on the card and on the CPU: the loss (within 1e-3 of
    itself + 1e-3), the prefill logits and HYB_CUT_STEPS decode steps
    (within HYB_TOL of the CPU's max |logit|), the card's expert choices
    given to the CPU run (a near tie may round apart; where the CPU's own
    choice differs it must be one); then HYB_TRAIN_STEPS AdamW steps on
    the card, the loss finite and falling."""
    from repro_torch import tree as T
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as TL
    from repro_torch.models import build
    from repro_torch.optim import optimizer as O
    cfg = get(HYB_ARCH).reduced()
    bundle = build(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed + 113)
    params = bundle.init(gen, device=DEV)
    state_mamba(params, gen)
    cpu = T.tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator().manual_seed(seed + 114)
    tok = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    host = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    card = {k: v.to(DEV) for k, v in host.items()}
    tie = {"differ": 0, "ratio": 1.0}

    def rel(a, b):
        return float((a.cpu().float() - b.float()).abs().max()
                     / b.float().abs().max())

    def both(fn):
        with routes_given() as routes:
            on_card = fn(params, card)
            routes.give()
            on_cpu = fn(cpu, host)
        tie["differ"] += routes.differ
        tie["ratio"] = min(tie["ratio"], routes.tie)
        return on_card, on_cpu

    with torch.no_grad():
        lc, lh = both(lambda p, b: bundle.loss(p, b)[0])
        pre = rel(*both(lambda p, b: bundle.prefill(p, b)))

        def steps(p, b):
            c = bundle.make_cache(2, HYB_CUT_STEPS, device=b["tokens"].device)
            out = []
            for pos in range(HYB_CUT_STEPS):
                o, c = bundle.serve_step(p, c, b["tokens"][:, pos:pos + 1],
                                         pos)
                out.append(o)
            return out

        oc, oh = both(steps)
        step_rel = [rel(a, b) for a, b in zip(oc, oh)]
    d_loss = abs(float(lc) - float(lh))
    check(d_loss <= 1e-3 * abs(float(lh)) + 1e-3,
          f"hybrid (d): loss {float(lc)} on the card, {float(lh)} on the CPU")
    check(pre <= HYB_TOL and max(step_rel) <= HYB_TOL,
          f"hybrid (d): card vs CPU prefill {pre}, steps {max(step_rel)}")
    check(tie["ratio"] >= 1.0 - NEAR_TIE, f"hybrid (d): the CPU's own "
          f"expert choice differs from the card's at ratio {tie['ratio']}")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=2,
                         total_steps=HYB_TRAIN_STEPS)
    pipe = TokenPipeline(DataConfig(cfg.vocab, HYB_TRAIN_SEQ, HYB_TRAIN_B,
                                    seed))
    state = (params, O.init(params, ocfg))
    step = TL.make_train_step(bundle, None, ocfg)
    losses = []
    for i in range(HYB_TRAIN_STEPS):
        b = {k: torch.from_numpy(v).to(DEV) for k, v in pipe.batch(i).items()}
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"hybrid (d): AdamW losses {losses}")
    return {"config": "reduced", "loss_card": float(lc),
            "loss_cpu": float(lh), "prefill_rel": pre,
            "steps": HYB_CUT_STEPS, "steps_rel_max": max(step_rel),
            "cpu_own_choices_differ": tie["differ"],
            "near_tie_ratio": tie["ratio"], "tolerance": HYB_TOL,
            "train_losses": losses}


def hyb_witness(seed: int) -> dict:
    """(e) The witness of what bfloat16 rounding does to (b)'s check: a cut
    of the period at full width, one Mamba block (its dense FFN after it)
    and the attention block (a MoE FFN after it), with (b)'s tokens and
    state weights: the teacher-forced steps against `forward` as in (b),
    in bfloat16 and again in float32 (the weights cast, and the DTYPE of
    `models.transformer`, `models.serve` and `models.model`),
    all on the bfloat16 forward's expert choices.  The float32 gap within
    HYB_F32_TOL; beside the two gaps, how far each path in bfloat16 lies
    from itself in float32."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.models import build
    from repro_torch.models import model as MD
    from repro_torch.models import serve as S
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get(HYB_ARCH), n_layers=2, attn_period=2)
    bundle = build(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed + 115)
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(gen, device=DEV)
    state_mamba(params, gen)
    gen = torch.Generator(device=DEV).manual_seed(seed + 111)
    toks = torch.randint(0, cfg.vocab, (HYB_B, HYB_STEPS), generator=gen,
                         device=DEV)
    with torch.no_grad(), routes_given(HYB_B, HYB_STEPS) as routes:
        fwd, steps = hyb_forced(bundle, params, toks, routes)
        differ, tie = routes.differ, routes.tie
        to_float32(params)
        with float32_stack(TT, S, MD), every_pair_kept():
            routes.give()
            fwd32 = bundle._forward(params, {"tokens": toks}, None,
                                    remat=False)[0]
            steps32 = hyb_steps(bundle, params, toks)
    del params
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    out = {"layers": cfg.n_layers, "blocks": "mamba+dense, attention+moe",
           "bf16_rel_max": forced_gap(fwd, steps),
           "f32_rel_max": forced_gap(fwd32, steps32),
           "max_abs_logit": float(fwd.abs().max()),
           "forward_bf16_vs_f32": rel(fwd, fwd32),
           "steps_bf16_vs_f32": rel(steps, steps32),
           "own_choices_differ": differ, "near_tie_ratio": tie,
           "f32_tolerance": HYB_F32_TOL,
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    check(out["f32_rel_max"] <= HYB_F32_TOL, f"hybrid (e): float32 "
          f"teacher-forced steps {out['f32_rel_max']} of max |logit|")
    return out


def to_float32(tree: dict) -> None:
    """Every floating leaf of a nested dict cast to float32 in place, one
    leaf at a time (each bfloat16 leaf freed as its copy is made)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_float32(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def hybrid_phase(seed: int) -> None:
    """A13's hybrid: jamba-1.5-large-398b at full width on one period
    (the experts tied and the Mamba blocks' state weights redrawn,
    `hybrid_params`): (a) prefill, (b) teacher-forced decode against
    forward, with two planted faults, (c) long_500k, then (d) the reduced
    config on the card against the CPU, and its training, and (e) the
    float32 witness of (b) on a cut of the period, and (f) the reduced
    config's train step counted on meta and on the card (as (a)'s
    prefill is, in its line).  One JSON line a part;
    no kernel of the port runs here (the reference's hybrid reaches no
    Pallas kernel)."""
    import dataclasses
    from repro_torch.configs.registry import get
    from repro_torch.models import build
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    full = get(HYB_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.attn_period)
    bundle = build(cfg)
    t0 = time.time()
    params = hybrid_params(bundle, seed + 109)
    torch.cuda.synchronize()
    sizes = hyb_bytes(bundle, params)
    head = {"phase": "hybrid", "arch": HYB_ARCH, "layers": cfg.n_layers,
            "full_layers": full.n_layers, "d_model": cfg.d_model,
            "d_inner": 2 * cfg.d_model, "ssm_state": cfg.ssm_state,
            "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
            "init_s": time.time() - t0, **sizes,
            "resident_GB": torch.cuda.memory_allocated() / 1e9}
    for part, fn in (("a", lambda: hyb_prefill(bundle, params, seed)),
                     ("b", lambda: hyb_decode(bundle, params, seed, sizes))):
        t1 = time.time()
        out = fn()
        if part == "b":
            out, row0 = out
        print(json.dumps({**head, "part": part, **out,
                          "part_s": time.time() - t1}), flush=True)
    t1 = time.time()
    line = hyb_long(bundle, params, seed, row0, sizes)
    print(json.dumps({**head, "part": "c", **line,
                      "part_s": time.time() - t1}), flush=True)
    del params, row0
    for part, fn in (("d", hyb_cut_vs_cpu), ("e", hyb_witness),
                     ("f", hyb_step_vs_meta)):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.time()
        line = fn(seed)
        print(json.dumps({"phase": "hybrid", "part": part, "arch": HYB_ARCH,
                          **line, "part_s": time.time() - t1}), flush=True)


def phase_timed(name: str, fn, *args):
    """fn(*args), its wall time on stderr."""
    t0 = time.time()
    out = fn(*args)
    print(f"chip_smoke: phase {name} {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return out


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
    rows += phase_timed("dense", dense_phase, f)
    rows += phase_timed("sweep", sweep_phase, f)
    rows += phase_timed("audit", audit_phase, f)
    del f
    phase_timed("code sweep", code_sweep, args.seed)
    kv_rows_, k_row0 = phase_timed("kv", kv_phase, args.seed)
    rows += kv_rows_
    # one user's K at 32K as pages of 128 tokens: (G S / 128, 128, D)
    g, s, d = k_row0.shape
    rows += run_chain("kv-delta", get_pipeline("kv-delta"),
                      k_row0.reshape(-1), rms_eb(k_row0),
                      shape=(g * s // KV_PAGE, KV_PAGE, d))
    del k_row0
    rows += phase_timed("serve", serve_phase, args.seed)
    rows += phase_timed("moe", moe_phase, args.seed)
    rows += phase_timed("grads", grads_phase, args.seed)
    rows += phase_timed("train", train_phase, args.seed)
    phase_timed("families", families_phase, args.seed)
    phase_timed("hybrid", hybrid_phase, args.seed)
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

#!/usr/bin/env python3
"""Time a chunk stage's encode and decode, as one caller sees them, in
two checkouts on one card, a process a run, in the given order.

    python3 chip_lc_ab.py --other DIR [--pages DIR]
                          [--order other,this,this,other]

A chunk stage's encode is what `ChunkStage.encode_words` (a chain's
stage) or `kernels.lossless._finish_encode` (B5's route) does: here one
launch of B6, which compacts the chunks and writes the 2-bit header; in
a checkout from before that redesign, the select kernel's padded image
(or B5's) then the compaction and the header pack as torch ops.  Its
decode is `ChunkStage.decode_words` / `kernels.lossless.decode_words_lc`:
here B7 alone, before it the header unpack and the gather first.  Both
take the same arguments in either checkout.  Cases: the chunk
stages of `chip_smoke.py`'s sci-rel-narrow, grad-wire-16-narrow and
smoke-chain on its 512^3 fields of seed 0, and, with --pages, the page
wires `chip_smoke.py` kept when run with CHIP_SMOKE_KEEP_LC=DIR (each
row a KV page, through `ChunkStage.encode_pages` / `decode_pages`).

Each run of `--order` is `this` (the checkout that holds this script) or
`other` (DIR: say the parent unpacked with `git archive` into a
directory that .gitignore lists); it builds its checkout's kernels and
uses its own `chip_smoke.py` to make the fields.  Prints the card's name
and power limit, then one JSON line a run: {"run", "root", "cases":
{case: {"encode_ms", "decode_ms" (one call by CUDA events, median of
25), "encode_batched_ms", "decode_batched_ms" (10 calls in a row),
"encode_host_us", "decode_host_us" (100 calls enqueued, no sync)}}}.
Every run's planes must be bit-equal to the first run's.  Exits 2
without a card, 1 if a run fails or the planes differ.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHAINS = ("sci-rel-narrow", "grad-wire-16-narrow", "smoke-chain")

RUN = r"""
import hashlib, json, sys
from pathlib import Path
sys.path.insert(0, 'src')
sys.path.insert(0, '.')
import torch
import chip_smoke as CS
from repro_torch.configs.registry import PIPELINES
from repro_torch.core import codec as C
from repro_torch.core.pipeline import ChunkStage, parse_pipeline
from repro_torch.kernels import _build
from repro_torch.kernels import lossless as L
from repro_torch.kernels import pack as K
_build.build()
chains, pages = sys.argv[1].split(','), sys.argv[2]
cases, digest = {}, hashlib.sha256()


def timed(name, enc, dec):
    planes = [t for t in (*enc(), dec()) if torch.is_tensor(t)]
    for t in planes:
        digest.update(t.reshape(-1).contiguous().view(torch.uint8).cpu()
                      .numpy())
    cases[name] = {
        "encode_ms": CS.time_ms(enc), "decode_ms": CS.time_ms(dec),
        "encode_batched_ms": CS.time_ms(enc, reps=10, batch=10),
        "decode_batched_ms": CS.time_ms(dec, reps=10, batch=10),
        "encode_host_us": host_us(enc), "decode_host_us": host_us(dec)}


def host_us(fn, calls=100):
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


f = CS.make_fields(CS.N_DEFAULT, 0)
for chain in chains:
    pipe = parse_pipeline(PIPELINES[chain])
    x = (f["emb"] if chain.startswith("grad") else
         f["near_one"] if chain == "smoke-chain" else f["nyx"])
    eb = CS.rms_eb(x) if chain.startswith("grad") else None
    cfg = pipe.qcfg()
    if CS.fused_lc(pipe):
        stage = pipe.stages[0].mode
        out = (L.rel_pack_lc(x, cfg, stage) if pipe.quant.mode == "rel"
               else L.abs_pack_lc(x, eb.reshape(1), cfg, stage))
        sel, codes = out[-2], out[-1]
        del out
        hdr, pay, _ = L._finish_encode(sel, codes)
        m = C.packed_word_count(x.numel(), cfg.bin_bits)
        timed(f"{chain} 0:{stage} image",
              lambda: L._finish_encode(sel, codes),
              lambda: L.decode_words_lc(hdr, pay, m))
        del sel, codes, hdr, pay
        continue
    cur = K.encode_packed(x, cfg, eb).words
    for i, (st, m) in enumerate(zip(pipe.stages, pipe.stage_sizes(
            x.numel()))):
        hdr, pay, _ = st.encode_words(cur, m, kernels=True)
        if isinstance(st, ChunkStage):
            timed(f"{chain} {i}:{st.mode}",
                  lambda w=cur, s=st, m=m: s.encode_words(w, m, kernels=True),
                  lambda s=st, h=hdr, p=pay, m=m:
                  s.decode_words(h, p, m, kernels=True))
        cur = pay
    del cur, hdr, pay
del f
for path in sorted(Path(pages).glob('*.pt')) if pages else ():
    kept = torch.load(path, map_location='cuda')
    words, st = kept['words'], ChunkStage(kept['mode'])
    n_in = words.shape[1]
    hdr, pay, _ = st.encode_pages(words, n_in, kernels=True)
    timed(f"{path.stem} pages {tuple(words.shape)}",
          lambda: st.encode_pages(words, n_in, kernels=True),
          lambda: st.decode_pages(hdr, pay, n_in, kernels=True))
print(json.dumps({"cases": cases, "digest": digest.hexdigest()}),
      flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's directory")
    ap.add_argument("--pages", default="",
                    help="page wires chip_smoke.py kept (CHIP_SMOKE_KEEP_LC)")
    ap.add_argument("--chains", default=",".join(CHAINS))
    ap.add_argument("--order", default="other,this,this,other")
    args = ap.parse_args(argv)
    runs = args.order.split(",")
    if any(r not in ("this", "other") for r in runs):
        ap.error("a run is this or other")
    import torch
    if not torch.cuda.is_available():
        print("chip_lc_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"this": ROOT, "other": Path(args.other).resolve()}
    pages = str(Path(args.pages).resolve()) if args.pages else ""
    first = None
    for run in runs:
        r = subprocess.run([sys.executable, "-c", RUN, args.chains, pages],
                           cwd=roots[run], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        out = json.loads(r.stdout.strip().splitlines()[-1])
        first = first or out["digest"]
        print(json.dumps({"run": run, "root": str(roots[run]),
                          "cases": out["cases"],
                          "same_planes": out["digest"] == first}),
              flush=True)
        if out["digest"] != first:
            print("chip_lc_ab: the planes differ between runs",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

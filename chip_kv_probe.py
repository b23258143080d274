#!/usr/bin/env python3
"""Sweep the flash-decode attention (B12, csrc/kv_attention.cu) over its
split and its head count on one NVIDIA card.

    python3 chip_kv_probe.py [--seed S] [--out FILE]

Builds the kv phase's cache of `chip_smoke.py` (`kv_inputs` and
`kv_quantize`: internlm2-20b's attention widths over a decode_32k history,
B = 32, the same seed and lengths) and calls
`kernels.kv_attention.kv_decode_attention`, the one launch path:

  * at Hg = 1, 6 and 16 query heads per KV head (B = 32): the bytes stay,
    the arithmetic scales with Hg, so the slope says how much of the time
    the arithmetic sets;
  * at pages_per_split 1 to 64 (Hg = 6), at B = 32 and at B = 1 (batch
    row 0, length S): the grid's and the merge's share, and the split the
    default should pick.

Each point is timed three ways: one call by CUDA events (median of 25, as
`chip_smoke.py` times `attention_ms`), 10 calls in a row by CUDA events,
and the device time of the split and merge kernels from `torch.profiler`
(`chip_smoke.device_kernels`).  Prints the card's name and power limit,
then one JSON line per point; with --out, also writes them to FILE.  Needs
a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_kv_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import kv_attention as A

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    lines = []
    s = cs.KV_S
    k, v, q6, lengths = cs.kv_inputs(args.seed)
    kq, vq = cs.kv_quantize(k), cs.kv_quantize(v)
    del k, v
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 4)

    def point(row, q, kc, vc, lens, pps=None):
        def fn():
            return A.kv_decode_attention(q, kc, vc, lens, page=cs.KV_PAGE,
                                         cap=cs.KV_CAP, pages_per_split=pps)

        per_call, dev = cs.device_kernels(fn)
        bound, by = cs.bound_from(*cs.kv_work(lens, q.shape[0], q.shape[2],
                                              s))
        row = {"card": smi[0], **row, "ms": cs.time_ms(fn),
               "batched_ms": cs.time_ms(fn, batch=cs.KV_BATCH_CALLS),
               "device_ms": sum(dev.values()) or None,
               "device_ms_by_kernel": dev, "launches_per_call": per_call,
               "bound_ms": bound, "bound_by": by}
        lines.append(row)
        print(json.dumps(row), flush=True)

    b = q6.shape[0]
    for hg in (1, 6, 16):
        q = q6 if hg == cs.KV_HG else torch.randn(
            (b, cs.KV_G, hg, cs.KV_D), generator=gen, device="cuda")
        smem, per_sm = A.kv_occupancy(hg, cs.KV_CAP)
        point({"probe": "heads", "batch": b, "hg": hg,
               "smem_bytes_per_block": smem, "blocks_per_sm": per_sm},
              q, kq, vq, lengths)
    rows = {32: (q6, kq, vq, lengths),
            1: (q6[:1], cs.kv_rows(kq, 0), cs.kv_rows(vq, 0), lengths[:1])}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, case in rows.items():
        default = A.default_pages_per_split(batch, cs.KV_G, s // cs.KV_PAGE,
                                            sms)
        for pps in (1, 2, 4, 8, 16, 32, 64):
            point({"probe": "split", "batch": batch, "hg": cs.KV_HG,
                   "pages_per_split": pps, "default": pps == default},
                  *case, pps)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

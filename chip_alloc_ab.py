#!/usr/bin/env python3
"""Time `chip_smoke.py`'s serve phase with the CUDA caching allocator's
expandable segments off and on, in alternating processes, on one card.

    python3 chip_alloc_ab.py [--order off,on,on,off]

Run from a checkout of the repository.  CUDA reads the allocator setting
when it starts, so every run is a process of its own with
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:<True|False>.  Prints the
card's name and power limit, then one JSON line a run:
{"expandable_segments": bool, "serve_s": s, "generate_step_ms": ms (the
4-slot engine's step), "long_step_ms": ms (serve (c)'s step at 32K)}.
Exits 2 without a card, 1 if a run fails.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def one_run() -> int:
    """serve_phase(0) in this process, its kernel library built first."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    _build.build()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        CS.serve_phase(0)
    serve_s = time.time() - t0
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    engine = next(x for x in lines if "generate_step_ms" in x)
    long_ = next(x for x in lines if "fill_s" in x)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    print(json.dumps({"expandable_segments": conf.endswith(":True"),
                      "serve_s": serve_s,
                      "generate_step_ms": engine["generate_step_ms"],
                      "long_step_ms": long_["step_ms"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="off,on,on,off",
                    help="the runs' settings in order (default off,on,on,off)")
    ap.add_argument("--one", action="store_true",
                    help="one run in this process, with the caller's setting")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_alloc_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        return one_run()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    for setting in args.order.split(","):
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=(
            f"expandable_segments:{setting == 'on'}"))
        rc = subprocess.run([sys.executable, __file__, "--one"],
                            env=env).returncode
        if rc != 0:
            print(f"chip_alloc_ab: the {setting} run exited {rc}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

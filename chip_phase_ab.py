#!/usr/bin/env python3
"""Time `chip_smoke.py`'s phases on one card, a process a run, in the
given order: in two checkouts, or with the CUDA caching allocator's
expandable segments off and on.

    python3 chip_phase_ab.py [--other DIR] [--phases serve,moe]
                             [--order other,this,this,other]

Each run of `--order` is `this` (the checkout that holds this script)
or `other` (DIR: a checkout of another commit, say the parent unpacked
with `git archive` into a directory that .gitignore lists), optionally
with `:alloc-on` or `:alloc-off`, which sets
PYTORCH_CUDA_ALLOC_CONF=expandable_segments:<True|False> for that
process (CUDA reads it when it starts; without it chip_smoke turns
expandable segments on).  Each run builds its checkout's kernels, then
runs the named phases of its own `chip_smoke.py` with seed 0, their
lines discarded.  Prints the card's name and power limit, then one JSON
line a run: {"run": item, "root": path, "phase_s": {phase: seconds}}.
Exits 2 without a card, 1 if a run fails.

    python3 chip_phase_ab.py --phases serve \\
        --order this:alloc-off,this:alloc-on,this:alloc-on,this:alloc-off
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ALLOC = {"alloc-on": "expandable_segments:True",
         "alloc-off": "expandable_segments:False"}

RUN = """
import contextlib, io, json, sys, time
sys.path.insert(0, 'src')
sys.path.insert(0, '.')
import chip_smoke as CS
from repro_torch.kernels import _build
_build.build()
out = {}
for name in sys.argv[1].split(','):
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        getattr(CS, name + '_phase')(0)
    out[name] = time.time() - t0
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's directory")
    ap.add_argument("--phases", default="serve,moe")
    ap.add_argument("--order", default="other,this,this,other")
    args = ap.parse_args(argv)
    runs = [item.partition(":") for item in args.order.split(",")]
    for root, _, setting in runs:
        if root not in ("this", "other") or (setting and setting not in ALLOC):
            ap.error(f"a run is this or other[:alloc-on|:alloc-off], "
                     f"not {root}:{setting}")
        if root == "other" and not args.other:
            ap.error("an `other` run needs --other")
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"this": ROOT, "other": Path(args.other or ROOT).resolve()}
    for root, sep, setting in runs:
        env = dict(os.environ)
        if setting:
            env["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC[setting]
        r = subprocess.run([sys.executable, "-c", RUN, args.phases],
                           cwd=roots[root], env=env, capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": root + sep + setting, "root":
                          str(roots[root]), "phase_s":
                          json.loads(r.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

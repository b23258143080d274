#!/usr/bin/env python3
"""Count the SASS instructions of the port's pack kernel, by class, with
`cuobjdump -sass`.

    python3 chip_sass.py [--lib PATH] [--values N]

Builds the library from `src/repro_torch/kernels/csrc/` (or reads the one
given with --lib) and disassembles it.  For every instance of
`pack_kernel` (the fused quantize + pack of B1 and B3), it counts the
static instructions of the path an aligned whole group takes:

  * where the kernel has 16-byte global accesses (`LDG.E.128`,
    `STG.E.128`), the vector path: from the start of the basic block that
    holds the first such access to the first unpredicated EXIT after the
    last one;
  * else the whole function.

The classes: conversions (F2I, I2F, FRND, F2F, I2I), float32 (FADD,
FMUL, FFMA, FSETP, FSEL, FMNMX, MUFU), integer (IADD3, IMAD, ISETP, LOP3,
SHF, SEL, LEA, PRMT, ...), loads (LDG, LDS, LDL, LD, LDC), stores (STG,
STS, STL, ST), uniform-datapath instructions (U*), and other (moves,
branches, predicate logic); NOPs are not counted.  Per value is the count
over --values, the values one thread quantizes on that path (128 for the
16-byte design's four lanes of 32 rows, 32 for one lane of 32 rows).  The
unrolled paths have no loops, so the static count is the count each thread
executes.  Prints one JSON line per instance.  Needs the CUDA toolkit's
`cuobjdump` (on PATH or beside nvcc).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = "pack_kernel"
CLASSES = {
    "conversions": {"F2I", "I2F", "FRND", "F2F", "I2I", "F2IP", "I2FP",
                    "F2FP"},
    "float32": {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET",
                "FCHK", "MUFU", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"},
    "integer": {"IADD3", "IADD", "IADD32I", "VIADD", "IMAD", "IMUL",
                "ISETP", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR", "SEL",
                "IABS", "IMNMX", "VIMNMX", "LEA", "PRMT", "BMSK", "POPC",
                "FLO", "BREV", "ISCADD", "IDP", "IMAD32I"},
    "loads": {"LDG", "LDS", "LDL", "LD", "LDC"},
    "stores": {"STG", "STS", "STL", "ST"},
}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                  r"([.\w]*)\s*([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNC = re.compile(r"Function : (\S+)")


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    return str(Path(_build.nvcc_path()).parent / "cuobjdump")


def functions(sass: str) -> dict:
    """{mangled name: [(address, predicate, opcode, modifiers, operands)
    or ("label", name)]} of a `cuobjdump -sass` listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        lab = LABEL.match(line)
        if lab:
            cur.append(("label", lab.group(1)))
            continue
        m = INSN.search(line)
        if m:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4), m.group(5)))
    return out


def is_wide(ins) -> bool:
    return ins[2] in ("LDG", "STG") and ".128" in ins[3]


def counted_path(body):
    """The instructions of the vector path (see the module note), or of
    the whole function when it has no 16-byte global access."""
    insns = [i for i in body if i[0] != "label"]
    wide = [k for k, i in enumerate(insns) if is_wide(i)]
    if not wide:
        return insns, "whole"
    targets = {int(t, 16) for i in insns if i[2] == "BRA"
               for t in re.findall(r"0x([0-9a-f]+)", i[4])}
    labelled = set()
    for k, item in enumerate(body):
        if item[0] == "label" and k + 1 < len(body):
            labelled.add(body[k + 1][0])
    start = wide[0]
    while start > 0:
        prev, here = insns[start - 1], insns[start]
        if (here[0] in targets or here[0] in labelled
                or prev[2] in ("BRA", "EXIT", "RET")):
            break
        start -= 1
    end = next((k for k in range(wide[-1], len(insns))
                if insns[k][2] == "EXIT" and not insns[k][1]), len(insns) - 1)
    return insns[start:end + 1], "vector"


def classify(insns) -> dict:
    by_class = Counter()
    ops = Counter()
    for i in insns:
        op = i[2]
        if op == "NOP":
            continue
        ops[op] += 1
        cls = next((c for c, names in CLASSES.items() if op in names),
                   "uniform" if op.startswith("U") else "other")
        by_class[cls] += 1
    return {"total": sum(by_class.values()), **dict(by_class),
            "opcodes": dict(sorted(ops.items()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", type=Path, help="a built library (default: "
                    "build it from src/repro_torch/kernels/csrc)")
    ap.add_argument("--values", type=int, default=128,
                    help="values one thread quantizes on the counted path")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        lib = _build.build()
    sass = subprocess.run([cuobjdump_path(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    name = re.compile(rf"{len(KERNEL)}{KERNEL}I(.*?)EEv")
    found = 0
    for fn, body in functions(sass).items():
        m = name.search(fn)
        if not m:
            continue
        found += 1
        path, region = counted_path(body)
        counts = classify(path)
        per_value = {k: v / args.values for k, v in counts.items()
                     if k != "opcodes"}
        instance = ",".join(re.findall(r"L\w(\d+)E", m.group(1)))
        print(json.dumps({"kernel": KERNEL, "instance": instance,
                          "region": region, "values": args.values,
                          "function_total": len([i for i in body
                                                 if i[0] != "label"]),
                          "counts": counts, "per_value": per_value}),
              flush=True)
    if not found:
        print(f"chip_sass: no instance of {KERNEL} in {lib}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

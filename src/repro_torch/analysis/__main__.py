"""The gate: `python -m repro_torch.analysis [paths] [--format json]
[--no-contracts] [--no-lint] [--rules ID,...]` exits nonzero on any
finding not in the committed `analysis-baseline-torch.json`.

Layer 1 (the lint) needs only the standard library; Layer 2 (the
contracts) imports the port on the CPU.  The default lint scope is
src/repro_torch and chip_smoke.py under the repository root (found from
this file, so the gate works from any directory).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import lint_paths
from . import report as R

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def main(argv=None, repo_root=None) -> int:
    root = Path(repo_root) if repo_root is not None else REPO_ROOT
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS} "
                         f"under the repository root)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"accepted findings (default: {R.BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings and exit 0")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip Layer 2 (no import of the port)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip Layer 1 (contracts only)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (Layer 1)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    baseline = args.baseline or str(root / R.BASELINE_NAME)

    paths = args.paths or [root / p for p in DEFAULT_PATHS]
    findings = []
    if not args.no_lint:
        rules = args.rules.split(",") if args.rules else None
        findings += lint_paths(paths, rules=rules)
    if not args.no_contracts:
        from . import contracts
        findings += contracts.run_contracts(root)

    rel = []
    for f in findings:
        try:
            p = str(Path(f.path).resolve().relative_to(root.resolve()))
        except ValueError:
            p = f.path
        rel.append(type(f)(f.rule, p, f.line, f.message, f.hint))
    findings = rel

    if args.write_baseline:
        R.write_baseline(baseline, findings)
        print(f"baseline written: {len(findings)} accepted finding(s) "
              f"-> {baseline}")
        return 0
    new, old = R.split_new(findings, R.load_baseline(baseline))
    out = (R.render_json if args.format == "json" else R.render_text)(
        new, old)
    print(out)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())

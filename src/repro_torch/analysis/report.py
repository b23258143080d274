"""Reporting and the baseline of the port's guarantee linter.

The committed `analysis-baseline-torch.json` holds the keys of accepted
findings; the gate fails only on findings not in it.  It is empty: every
finding is fixed or carries a reasoned noqa.  Keys omit line numbers
(`Finding.key`)."""
from __future__ import annotations

import json
from pathlib import Path

BASELINE_NAME = "analysis-baseline-torch.json"


def load_baseline(path) -> set:
    p = Path(path)
    if not p.exists():
        return set()
    return set(json.loads(p.read_text()).get("findings", []))


def write_baseline(path, findings) -> None:
    doc = {"findings": sorted({f.key() for f in findings})}
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def split_new(findings, baseline: set):
    """-> (new findings, baselined findings)."""
    new = [f for f in findings if f.key() not in baseline]
    old = [f for f in findings if f.key() in baseline]
    return new, old


def render_text(new, old) -> str:
    lines = [f.render() for f in new]
    if old:
        lines.append(f"({len(old)} baselined finding"
                     f"{'s' if len(old) != 1 else ''} suppressed)")
    lines.append(f"{len(new)} new finding{'s' if len(new) != 1 else ''}")
    return "\n".join(lines)


def render_json(new, old) -> str:
    return json.dumps({"new": [f.as_dict() for f in new],
                       "baselined": [f.as_dict() for f in old],
                       "count": len(new)}, indent=1)

"""RC005: the port's dispatch table (`src/repro_torch/DESIGN.md`,
"Dispatch table") against `Pipeline.kernel_dispatch`'s routing.

The table's rows name, per chain pattern, the encode entry the card takes
(`kernels.<module>.<fn>`, or "same" for the row above's).  The checker
maps each row to probe chains and holds the row's claim against
`parse_pipeline(probe).kernel_dispatch()`.  `parse_dispatch_table` and
`check_dispatch` are separate so that a test can feed a planted stale
row.
"""
from __future__ import annotations

import dataclasses
import re

from .walker import Finding

DESIGN_PATH = "src/repro_torch/DESIGN.md"
_TABLE_ANCHOR = "## Dispatch table"
_ENTRY = re.compile(r"kernels\.(\w+)\.(\w+)")


@dataclasses.dataclass(frozen=True)
class Row:
    """One table row: the chain cell and the encode cell, unescaped."""
    chain: str
    encode: str


def _clean(cell: str) -> str:
    return cell.replace("\\|", "|").replace("`", "").strip()


def parse_dispatch_table(text: str) -> list:
    """The rows of the first table after the anchor heading."""
    if _TABLE_ANCHOR not in text:
        return []
    body = text.split(_TABLE_ANCHOR, 1)[1]
    rows = []
    for line in body.splitlines():
        line = line.strip()
        if rows and not line.startswith("|"):
            break
        if not line.startswith("|"):
            continue
        cells = [_clean(c) for c in re.split(r"(?<!\\)\|", line)[1:-1]]
        if len(cells) < 2 or not cells[0] or \
                set(cells[0]) <= {"-", " "} or cells[0].lower() == "chain":
            continue
        rows.append(Row(cells[0], cells[1]))
    return rows


# row pattern -> (routing class, representative probe chains); a row the
# classifier cannot place is itself a finding
def _probes_for(chain: str):
    c = chain.lower().replace(" ", "")
    if "pred" in c:
        return "dense", ("delta|abs:0.001|pack:16",
                         "lorenzo|rel:0.001|pack:32|narrow")
    if "shuffle" in c or "several" in c or re.search(r"\bent\b",
                                                      chain.lower()):
        return "stages", ("abs:0.001|pack:32|shuffle|narrow",
                          "abs:0.001|pack:16|narrow|ent",
                          "abs:0.001|pack:8|zero|narrow")
    if "zero" in c or "narrow" in c:
        return "fused", ("abs:0.001|pack:16|zero",
                         "rel:0.001|pack:32|narrow")
    for mode in ("abs", "noa", "rel"):
        if c.startswith(f"{mode}:") and "pack" in c:
            return "pack", tuple(f"{mode}:0.001|pack:{b}"
                                 for b in (8, 16, 32))
    return None


CLASSES = ("pack", "fused", "stages", "dense")


def check_dispatch(rows, *, path: str = DESIGN_PATH) -> list:
    """Probe every row against the real `kernel_dispatch` (no device)."""
    from ..core.pipeline import parse_pipeline

    if not rows:
        return [Finding("RC005", path, 1,
                        "the dispatch table is missing (or lost its "
                        "heading)", "restore the '## Dispatch table' table")]
    findings, seen, last = [], set(), None
    for row in rows:
        probes = _probes_for(row.chain)
        if probes is None:
            findings.append(Finding(
                "RC005", path, 1,
                f"dispatch-table row {row.chain!r} has no probe mapping",
                "extend analysis/dispatch.py's classifier with the row's "
                "representative chains"))
            continue
        cls, specs = probes
        m = _ENTRY.search(row.encode)
        if m:
            last = f"repro_torch.kernels.{m.group(1)}.{m.group(2)}"
        elif not row.encode.lower().startswith("same") or last is None:
            findings.append(Finding(
                "RC005", path, 1,
                f"dispatch-table row {row.chain!r} names no encode entry "
                f"({row.encode!r})", "write kernels.<module>.<fn>, or "
                "'same' for the row above's"))
            continue
        seen.add(cls)
        for spec in specs:
            actual = parse_pipeline(spec).kernel_dispatch()
            if actual != last:
                findings.append(Finding(
                    "RC005", path, 1,
                    f"dispatch table desync: row {row.chain!r} claims "
                    f"{last} but kernel_dispatch({spec!r}) routes to "
                    f"{actual}", "update the row (or kernel_dispatch) so "
                    "the notes and the code agree"))
    missing = [c for c in CLASSES if c not in seen]
    if missing:
        findings.append(Finding(
            "RC005", path, 1,
            f"the dispatch table covers {len(seen)} of the {len(CLASSES)} "
            f"routing classes (missing: {', '.join(missing)})",
            "restore the missing rows"))
    return findings

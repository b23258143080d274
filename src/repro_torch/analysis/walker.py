"""Layer-1 lint engine of the port's guarantee linter (`src/repro_torch/
DESIGN.md`, "The guarantee linter"): parse every file once, hand the tree
to each registered rule, honor per-file suppressions.  Pure stdlib `ast`,
a copy of the JAX package's `repro.analysis.walker` (the port imports
nothing of that package).

A rule is one class with `id`, `title`, `hint` and `check(tree, text,
path)`, registered by `register_rule`; the Layer-2 documentation contract
(RC008) demands a row per id in the design notes' rule table.

Suppressions are per FILE, not per line: a comment anywhere in the file

    # repro: noqa PT00x -- <why this exception is sound>

turns the named rule(s) off for that file.  The reason after `--` is
mandatory: a bare `# repro: noqa PT00x` emits a GL000 finding instead
of suppressing anything, so every accepted exception documents itself
where it is made.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

# "repro: noqa GL001" / "repro: noqa GL001,PT002 -- reason"
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\s+([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"(?:\s*--\s*(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint or contract finding: rule id, location, message, hint."""
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def key(self) -> str:
        """Baseline identity, without the line: edits above a finding do
        not make it new."""
        return f"{self.rule}::{self.path}::{self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tail}"


# id -> rule object (.id, .title, .hint, .check(tree, text, path))
RULES: dict = {}


def register_rule(rule) -> None:
    """Register a lint rule (one entry per id, the `STAGES` pattern)."""
    RULES[rule.id] = rule


def parse_suppressions(text: str, path: str):
    """-> (suppressed rule-id set, [Finding for reasonless noqas])."""
    suppressed, bad = set(), []
    for ln, line in enumerate(text.splitlines(), 1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        ids = {t.strip() for t in m.group(1).split(",")}
        if m.group(2) is None:
            bad.append(Finding(
                "GL000", path, ln,
                f"suppression of {sorted(ids)} carries no reason",
                "append ` -- <why this exception is sound>` to the noqa"))
            continue
        suppressed |= ids
    return suppressed, bad


def lint_file(path, *, rules=None) -> list:
    """The registered rules (or the ids in `rules`) over one file, with its
    suppressions applied (GL000 findings are never suppressible)."""
    path = Path(path)
    rel = str(path)
    text = path.read_text()
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError as e:
        return [Finding("GL000", rel, e.lineno or 1,
                        f"file does not parse: {e.msg}",
                        "fix the syntax error")]
    suppressed, findings = parse_suppressions(text, rel)
    for rule in (RULES.values() if rules is None
                 else [RULES[r] for r in rules]):
        if rule.id in suppressed:
            continue
        findings.extend(rule.check(tree, text, rel))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths, *, rules=None) -> list:
    """Walk `paths` (files or directories) and lint every `*.py`."""
    out = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f, rules=rules))
    return out

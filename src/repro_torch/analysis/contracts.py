"""Layer 2 of the port's guarantee linter: import the port and check what
no single unit test pins as a set (RC001-RC008, the reference's
contracts over the port's own registries).

  RC001  every `core.pipeline.STAGES` entry parses bare, has the whole
         word-stage contract (encode/decode pair, capacity and header
         accounting, transmits_len) and roundtrips a word plane exactly
  RC002  every `PIPELINES` preset parses and spec-roundtrips
  RC003  every `KV_PAGE_CHAINS` chain splits into pred | word stages
  RC004  every `SELECTOR_SETS` member constructs, or the design notes
         document its rejection
  RC005  the dispatch table of `src/repro_torch/DESIGN.md` matches
         `Pipeline.kernel_dispatch` (`analysis/dispatch.py`)
  RC006  every `core.audit.DEGRADATION_POLICIES` name has a consumer
         outside core/audit.py (a string constant in the port, its tests
         or `chip_smoke.py`)
  RC007  every `runtime.guard.FAULT_CLASSES` class is in `chip_smoke.py`'s
         audit detection matrix (the classes `detection_matrix` returns,
         which the script runs, and those it names itself)
  RC008  every registered rule id has a row in the design notes'
         "The guarantee linter" section

Everything runs on the CPU; no card is touched.
"""
from __future__ import annotations

import ast
import zlib
from pathlib import Path

from .walker import Finding, RULES
from . import dispatch as D

_REG = "src/repro_torch/configs/registry.py"
DESIGN = "src/repro_torch/DESIGN.md"
LINTER_HEADING = "## The guarantee linter"


def check_stages() -> list:
    """RC001: the word-stage registry contract."""
    import numpy as np
    import torch
    from ..core import pipeline as PL

    findings, path = [], "src/repro_torch/core/pipeline.py"
    contract = ("encode_words", "decode_words", "capacity_words",
                "header_words", "header_content_bits", "spec")
    n = 1024
    for name, parser in sorted(PL.STAGES.items()):
        try:
            st = parser(name, [], 16)
        except Exception as e:   # noqa: BLE001 - reported as a finding
            findings.append(Finding(
                "RC001", path, 1, f"stage {name!r} does not parse bare: {e}",
                "every registered stage must build from its plain name"))
            continue
        missing = [a for a in contract if not callable(getattr(st, a, None))]
        if not hasattr(st, "transmits_len"):
            missing.append("transmits_len")
        if missing:
            findings.append(Finding(
                "RC001", path, 1,
                f"stage {name!r} is missing contract members {missing}",
                "implement the whole word-stage contract"))
            continue
        try:
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            words = torch.from_numpy(
                rng.integers(0, 256, size=n).astype(np.int32))
            hdr, payload, plen = st.encode_words(words, n)
            cap = st.capacity_words(n)
            if int(payload.numel()) != cap:
                findings.append(Finding(
                    "RC001", path, 1,
                    f"stage {name!r}: stored payload plane "
                    f"({int(payload.numel())} words) != capacity_words "
                    f"({cap})", "capacity_words must describe the plane"))
            if int(hdr.numel()) != st.header_words(n):
                findings.append(Finding(
                    "RC001", path, 1,
                    f"stage {name!r}: stored header plane "
                    f"({int(hdr.numel())} words) != header_words "
                    f"({st.header_words(n)})",
                    "header_words must describe the plane"))
            if st.header_words(n) and \
                    st.header_content_bits(n) > 32 * st.header_words(n):
                findings.append(Finding(
                    "RC001", path, 1,
                    f"stage {name!r}: header_content_bits exceeds the "
                    f"stored header plane", "content bits cannot exceed "
                    "storage"))
            back = st.decode_words(hdr, payload, n)
            if not torch.equal(back, words):
                findings.append(Finding(
                    "RC001", path, 1,
                    f"stage {name!r}: decode_words is not the exact "
                    f"inverse of encode_words on a {n}-word plane",
                    "the stage contract is a bit-exact roundtrip"))
            if not st.transmits_len and int(plen) != cap:
                findings.append(Finding(
                    "RC001", path, 1,
                    f"stage {name!r}: transmits_len=False but encode "
                    f"returned len {int(plen)} != capacity {cap}",
                    "length-static stages transmit the whole plane"))
        except Exception as e:   # noqa: BLE001 - reported as a finding
            findings.append(Finding(
                "RC001", path, 1,
                f"stage {name!r} roundtrip raised: {type(e).__name__}: {e}",
                "the bare stage must encode/decode a word plane"))
    return findings


def check_pipelines() -> list:
    """RC002: every preset parses and spec-roundtrips."""
    from ..configs.registry import PIPELINES, get_pipeline
    from ..core.pipeline import parse_pipeline

    findings = []
    for name in sorted(PIPELINES):
        try:
            pipe = parse_pipeline(get_pipeline(name))
            if parse_pipeline(pipe.spec()) != pipe:
                findings.append(Finding(
                    "RC002", _REG, 1,
                    f"preset {name!r} does not spec-roundtrip",
                    "spec() and parse_pipeline must be inverses"))
        except Exception as e:   # noqa: BLE001 - reported as a finding
            findings.append(Finding(
                "RC002", _REG, 1, f"preset {name!r} does not parse: {e}",
                "every PIPELINES entry must parse_pipeline"))
    return findings


def check_kv_chains() -> list:
    """RC003: every KV page chain resolves through the fragment grammar."""
    from ..compression import kv
    from ..configs.registry import KV_PAGE_CHAINS, get_kv_chain

    findings = []
    for name in sorted(KV_PAGE_CHAINS):
        try:
            kv._page_stages(get_kv_chain(name))
        except Exception as e:   # noqa: BLE001 - reported as a finding
            findings.append(Finding(
                "RC003", _REG, 1,
                f"KV page chain {name!r} does not resolve: {e}",
                "every KV_PAGE_CHAINS fragment must split into pred|word "
                "stages (compression/kv.py)"))
    return findings


def check_selector_sets(design_text: str) -> list:
    """RC004: every selector-set member constructs, or the design notes
    name the token its rejection names."""
    from ..configs.registry import SELECTOR_SETS
    from ..core import select as SEL

    findings = []
    for name, entry in sorted(SELECTOR_SETS.items()):
        if len(entry["bias"]) != len(entry["chains"]):
            findings.append(Finding(
                "RC004", _REG, 1,
                f"selector set {name!r}: bias has {len(entry['bias'])} "
                f"entries for {len(entry['chains'])} chains",
                "one calibration bias per candidate chain"))
        try:
            sel = (SEL.get_kv_selector(name) if entry["base"] is None
                   else SEL.get_selector(name))
            if len(sel.chains) != len(entry["chains"]):
                findings.append(Finding(
                    "RC004", _REG, 1,
                    f"selector set {name!r}: built {len(sel.chains)} "
                    f"candidates from {len(entry['chains'])} chains",
                    "construction must keep every member"))
        except Exception as e:   # noqa: BLE001 - reported as a finding
            tokens = {t.split(":")[0] for c in entry["chains"]
                      for t in c.split("|") if t}
            if not any(tok and tok in str(e) and tok in design_text
                       for tok in tokens):
                findings.append(Finding(
                    "RC004", _REG, 1,
                    f"selector set {name!r} does not construct and the "
                    f"rejection is undocumented: {e}",
                    "make the member scoreable or document the rejection "
                    "in src/repro_torch/DESIGN.md"))
    return findings


def _string_constants(paths) -> set:
    used = set()
    for py in paths:
        try:
            tree = ast.parse(Path(py).read_text())
        except (SyntaxError, OSError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                used.add(node.value)
    return used


def check_policies(repo_root: Path) -> list:
    """RC006: every degradation policy's name is a string constant at
    some consumer outside core/audit.py (the port, its tests, the chip
    script)."""
    from ..core.audit import DEGRADATION_POLICIES

    files = [p for p in sorted((repo_root / "src/repro_torch").rglob("*.py"))
             if p.name != "audit.py" and "analysis" not in p.parts]
    files += sorted((repo_root / "tests").glob("test_torch_*.py"))
    files.append(repo_root / "chip_smoke.py")
    used = _string_constants(files)
    return [Finding(
        "RC006", "src/repro_torch/core/audit.py", 1,
        f"degradation policy {name!r} has no consumer outside "
        f"core/audit.py", "wire the policy into a receive site (or drop "
        "it from DEGRADATION_POLICIES)")
        for name in sorted(DEGRADATION_POLICIES) if name not in used]


def matrix_classes() -> set:
    """The fault classes `runtime.guard.detection_matrix` runs, on a small
    CPU wire with a checksum and a NaN-corrupted encode's report, as
    `chip_smoke.py`'s audit phase calls it."""
    import torch
    from ..core.pipeline import parse_pipeline
    from ..runtime import guard as G

    pipe = parse_pipeline("abs:0.001|pack:8")
    x = torch.linspace(-1, 1, 4096)
    enc = pipe.encode(x, device="cpu", integrity=True)
    bad = G.FaultPlan("rc007", "nan_input").corrupt_input(x)
    _, rep = pipe.encode(bad, device="cpu", verify=True)
    return set(G.detection_matrix(enc, suite="rc007", report=rep))


def check_fault_classes(chip_smoke: Path) -> list:
    """RC007: every fault class is in the chip script's audit matrix."""
    from ..runtime.guard import FAULT_CLASSES

    if not chip_smoke.exists():
        return [Finding("RC007", chip_smoke.name, 1,
                        "chip_smoke.py is missing: its audit phase is the "
                        "committed proof of fault coverage on the card",
                        "restore chip_smoke.py")]
    text = chip_smoke.read_text()
    pinned = _string_constants([chip_smoke])
    if "detection_matrix" in text:
        pinned |= matrix_classes()
    return [Finding(
        "RC007", chip_smoke.name, 1,
        f"fault class {cls!r} is not in chip_smoke.py's detection matrix",
        "exercise the class in chip_smoke.py's audit (or grads) phase")
        for cls in FAULT_CLASSES if cls not in pinned]


def linter_section(design_text: str) -> str:
    if LINTER_HEADING not in design_text:
        return ""
    return design_text.split(LINTER_HEADING, 1)[1].split("\n## ", 1)[0]


def check_rule_docs(design_text: str) -> list:
    """RC008: every registered rule id has a row in the linter section."""
    sec = linter_section(design_text)
    if not sec:
        return [Finding("RC008", DESIGN, 1,
                        f"{DESIGN} has no '{LINTER_HEADING}' section",
                        "add the section with one row per rule id")]
    return [Finding("RC008", DESIGN, 1,
                    f"lint rule {rid} is registered but undocumented in "
                    f"'{LINTER_HEADING}'", "add the rule's row (its lesson)")
            for rid in sorted(RULES) if rid not in sec]


def run_contracts(repo_root) -> list:
    """Every Layer-2 contract; returns the combined findings."""
    root = Path(repo_root)
    design_path = root / DESIGN
    design = design_path.read_text() if design_path.exists() else ""
    findings = []
    findings += check_stages()
    findings += check_pipelines()
    findings += check_kv_chains()
    findings += check_selector_sets(design)
    findings += D.check_dispatch(D.parse_dispatch_table(design))
    findings += check_policies(root)
    findings += check_fault_classes(root / "chip_smoke.py")
    findings += check_rule_docs(design)
    return findings

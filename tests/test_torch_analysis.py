"""The port's guarantee linter (`repro_torch.analysis`): the JAX package's
fixtures (`tests/test_analysis.py`) ported to the port's rules, Layer 1
against the reference's `repro.analysis` finding for finding, the PT
rules positive and negative, the contracts RC005 and RC008 on planted
faults in a copy of the tree, and the gate on the real tree.
"""
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint_paths as ref_lint_paths
from repro_torch.analysis import RULES, lint_file, lint_paths
from repro_torch.analysis import contracts as RC
from repro_torch.analysis import dispatch as D
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.walker import parse_suppressions

REPO = Path(__file__).resolve().parents[1]
PORT_DESIGN = REPO / "src" / "repro_torch" / "DESIGN.md"


def _lint(tmp_path, src, rules=None, name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return lint_file(p, rules=rules)


# --------------------------------------------- golden snippets per rule ---

GOLDEN = {
    "GL001": """
        import torch

        def wire_bits(stages, lens):
            return torch.sum(lens.to(torch.float32)) * 32.0
        """,
    "GL002": """
        import torch

        def apply_feedback(x, bins, eb2, eb):
            recon = bins * eb2
            ok = torch.abs(x - recon) <= eb
            return ok
        """,
    "GL003": """
        import torch

        def audit_violations(diff, eb, TIGHTEN):
            return torch.sum(diff > eb * TIGHTEN)
        """,
    "GL004": """
        def encode_bins(bins, x):
            return bins - x
        """,
    "GL005": """
        def read_payload(payload, payload_len):
            return payload[:payload_len]
        """,
    "GL006": """
        import numpy as np

        rng = np.random.default_rng(42)
        """,
    "GL007": """
        def encode_packed(x):
            print("encoding", x.shape)
            return x
        """,
    "PT001": """
        import torch

        def quantize_abs(x, eb):
            q = torch.round(x / (2 * eb))
            return q.to(torch.int32)
        """,
    "PT002": """
        import torch

        def codebook(hist):
            return torch.argsort(-hist)
        """,
    "PT003": """
        import torch

        def shift_words(words):
            u = words.view(torch.uint32)
            return u >> 3
        """,
}

CLEAN = {
    # convert once: the float is on the sum, not inside it
    "GL001": """
        import torch

        def wire_bits(stages, lens):
            return 32.0 * torch.sum(lens).to(torch.float32)
        """,
    "GL002": """
        import torch

        def apply_feedback(x, bins, eb2, eb):
            recon = bins * eb2
            ok = torch.isfinite(recon) & (torch.abs(x - recon) <= eb)
            return ok
        """,
    "GL003": """
        import torch

        def audit_violations(diff, eb):
            return torch.sum(diff > eb)
        """,
    "GL004": """
        def encode_bins(bins, prev_bins):
            return bins - prev_bins
        """,
    "GL005": """
        import torch

        def read_payload(payload, payload_len):
            k = torch.clamp(payload_len, max=payload.shape[-1])
            return payload[:k]
        """,
    "GL006": """
        import numpy as np
        import zlib

        rng = np.random.default_rng(zlib.crc32(b"suite-name"))
        """,
    "GL007": """
        def encode_packed(x):
            return x

        def report(x):
            print("host-side caller", x.shape)
        """,
    "PT001": """
        import torch

        def quantize_abs(x, eb):
            q = torch.round(x / (2 * eb))
            q = torch.where(torch.isnan(q), 0, q)
            return q.to(torch.int32)
        """,
    "PT002": """
        import torch

        def codebook(hist, names):
            names.sort()
            return torch.argsort(-hist, stable=True)
        """,
    "PT003": """
        import torch

        def shift_words(words):
            hi = words.view(torch.uint32) > 7
            return (words >> 3) & 0x1FFFFFFF, hi
        """,
}


@pytest.mark.parametrize("rule", sorted(GOLDEN))
def test_golden_snippet_fires(tmp_path, rule):
    findings = _lint(tmp_path, GOLDEN[rule], rules=[rule])
    assert findings, f"{rule} missed its golden snippet"
    assert all(f.rule == rule for f in findings)
    assert all(f.hint for f in findings), "findings must carry a fix hint"


@pytest.mark.parametrize("rule", sorted(GOLDEN))
def test_clean_twin_does_not_fire(tmp_path, rule):
    assert _lint(tmp_path, CLEAN[rule], rules=[rule]) == []


@pytest.mark.parametrize("src,rule,n", [
    # a float-to-int cast in a bins function, .int() and .long() forms
    ("def to_bins(x):\n    return x.int(), x.long()\n", "PT001", 2),
    # an int plane's cast is int-to-int and passes
    ("import torch\ndef encode_bins(bins):\n"
     "    return bins.reshape(-1).to(torch.int64)\n", "PT001", 0),
    # outside quantize/bins functions the cast is not the rule's
    ("import torch\ndef loss(x):\n    return x.to(torch.int32)\n",
     "PT001", 0),
    # Tensor.sort with a dim, torch.sort, Tensor.argsort
    ("import torch\ndef f(x):\n    return (x.sort(-1), torch.sort(x),\n"
     "            x.argsort(dim=0))\n", "PT002", 3),
    # stable=False is still unstable; jnp/np sorts are not torch's
    ("import torch, numpy as np\ndef f(x, jnp):\n"
     "    return torch.argsort(x, stable=False), np.argsort(x),\n"
     "           jnp.argsort(x)\n", "PT002", 1),
    # uint32 arithmetic through a name, an aug-assign and a reduction
    ("import torch\ndef f(w):\n    u = w.to(torch.uint32)\n    u += 1\n"
     "    return torch.max(u), u * 2\n", "PT003", 3),
    # a uint32 view compared is the sanctioned use
    ("import torch\ndef f(w, v):\n"
     "    return w.view(torch.uint32) == v.view(torch.uint32)\n", "PT003",
     0),
])
def test_port_rules_positive_and_negative(tmp_path, src, rule, n):
    assert len(_lint(tmp_path, src, rules=[rule])) == n


def test_gl006_flags_unseeded_and_hash(tmp_path):
    src = """
        import numpy as np

        a = np.random.default_rng()
        b = np.random.default_rng(hash("suite"))
        """
    msgs = [f.message for f in _lint(tmp_path, src, rules=["GL006"])]
    assert any("unseeded" in m for m in msgs)
    assert any("hash()" in m for m in msgs)


# ------------------------------------------------------- suppressions ---

def test_suppression_with_reason_suppresses(tmp_path):
    src = """\
        import torch

        # repro: noqa PT002 -- a fixture: ties cannot occur in this input
        order = torch.argsort(torch.arange(4))
        """
    assert _lint(tmp_path, src) == []


def test_suppression_without_reason_is_gl000(tmp_path):
    src = """\
        import torch

        # repro: noqa PT002
        order = torch.argsort(torch.arange(4))
        """
    rules = {f.rule for f in _lint(tmp_path, src)}
    assert "GL000" in rules, "a reasonless noqa must be flagged"
    assert "PT002" in rules, "a reasonless noqa suppresses nothing"


def test_parse_suppressions_multi_rule():
    sup, bad = parse_suppressions(
        "# repro: noqa GL001, PT003 -- fixture file\n", "f.py")
    assert sup == {"GL001", "PT003"} and bad == []


def test_every_registered_rule_has_a_golden_snippet():
    assert set(GOLDEN) == set(RULES)


def test_lint_paths_walks_directories(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "m.py").write_text(
        "def encode_packed(x):\n    print(x)\n    return x\n")
    assert [f.rule for f in lint_paths([tmp_path])] == ["GL007"]


# ------------------------------------------- parity with the reference ---

def test_layer1_matches_the_reference_finding_for_finding():
    """The port's rules over the JAX package, its tests, benchmarks and
    examples give the reference's `lint_paths` findings: the same (rule,
    file, line) for every one (suppressions applied on both sides)."""
    paths = [REPO / p for p in ("src/repro", "benchmarks", "examples",
                                "tests/test_analysis.py",
                                "tests/test_parity.py",
                                "tests/test_property_quantizer.py")]
    ours = [(f.rule, f.path, f.line) for f in lint_paths(paths)]
    theirs = [(f.rule, f.path, f.line) for f in ref_lint_paths(paths)]
    assert ours == theirs
    assert any(r == "GL006" for r, _, _ in theirs), (
        "the parity set must hold findings, not only silence")


def test_reference_golden_snippets_match(tmp_path):
    """The reference's golden snippets (its own test file's) fire the same
    GL rules under the port's engine."""
    import test_analysis as TA
    for rule, src in TA.GOLDEN.items():
        p = tmp_path / f"{rule}.py"
        p.write_text(textwrap.dedent(src))
    ours = [(f.rule, f.line) for f in lint_paths([tmp_path])]
    theirs = [(f.rule, f.line) for f in ref_lint_paths([tmp_path])]
    assert ours == theirs and len(ours) >= len(TA.GOLDEN)


# -------------------------------------------------- contracts (layer 2) ---

def _tree_copy(tmp_path) -> Path:
    """The files the contracts read, copied under tmp_path."""
    root = tmp_path / "tree"
    (root / "src" / "repro_torch").mkdir(parents=True)
    shutil.copy(PORT_DESIGN, root / "src" / "repro_torch" / "DESIGN.md")
    shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
    (root / "tests").mkdir()
    return root


def test_dispatch_checker_accepts_the_real_table():
    rows = D.parse_dispatch_table(PORT_DESIGN.read_text())
    assert len(rows) >= 6
    assert D.check_dispatch(rows) == []


def test_rc005_catches_a_planted_stale_row(tmp_path):
    root = _tree_copy(tmp_path)
    design = root / "src" / "repro_torch" / "DESIGN.md"
    text = design.read_text()
    old = "| `kernels.lossless.encode_packed_lc` (quantize"
    assert old in text
    design.write_text(text.replace(
        old, "| `kernels.pack.encode_packed` (quantize", 1))
    findings = [f for f in RC.run_contracts(root) if f.rule == "RC005"]
    assert any("desync" in f.message and "zero" in f.message
               for f in findings), findings


def test_dispatch_checker_flags_a_missing_table():
    findings = D.check_dispatch(D.parse_dispatch_table("no table here"))
    assert findings and findings[0].rule == "RC005"


def test_rc008_catches_an_undocumented_rule(tmp_path, monkeypatch):
    root = _tree_copy(tmp_path)
    design = root / "src" / "repro_torch" / "DESIGN.md"
    text = design.read_text()
    row = next(ln for ln in text.splitlines() if ln.startswith("| PT003 "))
    design.write_text(text.replace(row + "\n", ""))
    findings = [f for f in RC.run_contracts(root) if f.rule == "RC008"]
    assert [f.message for f in findings] == [
        "lint rule PT003 is registered but undocumented in "
        "'## The guarantee linter'"]


def test_rc007_holds_every_fault_class_in_the_chip_script(tmp_path):
    from repro_torch.runtime.guard import FAULT_CLASSES
    root = _tree_copy(tmp_path)
    assert RC.check_fault_classes(root / "chip_smoke.py") == []
    smoke = root / "chip_smoke.py"
    smoke.write_text(smoke.read_text().replace('"hop_bitflip"', '"x"'))
    missing = RC.check_fault_classes(smoke)
    assert [f.message.split("'")[1] for f in missing] == ["hop_bitflip"]
    assert "hop_bitflip" in FAULT_CLASSES


def test_clean_tree_gate_exits_zero(capsys):
    """The gate on the real tree, Layer 1 and Layer 2: no new finding."""
    rc = analysis_main([])
    out = capsys.readouterr().out
    assert rc == 0 and "0 new findings" in out, out

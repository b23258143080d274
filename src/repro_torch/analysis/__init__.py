"""The port's guarantee linter (`src/repro_torch/DESIGN.md`, "The
guarantee linter"), counterpart of `repro.analysis`: static checks that
the guarantee's known pitfalls are not in the port, before any kernel
runs.

  Layer 1 (`walker` + `rules`): a stdlib-`ast` lint with a rule registry
      (`RULES`): GL001-GL007 with the reference's logic, and PT001-PT003,
      the port's own lessons (a NaN reaching an int cast, an unstable
      sort, uint32 arithmetic).  Imports nothing but the standard library.
  Layer 2 (`contracts` + `dispatch`): imports the port and checks what no
      single unit test pins as a set (RC001-RC008): the stage contract,
      the presets, the KV chains, the selector sets, the design notes'
      dispatch table against `Pipeline.kernel_dispatch`, the degradation
      policies' consumers, the fault classes in `chip_smoke.py`'s audit
      matrix, and a documented row for every rule id.

Findings carry a rule id, file:line and a hint; a per-file
`# repro: noqa <id> -- reason` suppresses with a mandatory reason.  The
gate, `python -m repro_torch.analysis`, fails on any finding outside the
committed `analysis-baseline-torch.json` (empty).
"""
from .walker import (Finding, RULES, lint_file, lint_paths,  # noqa: F401
                     register_rule)
from . import rules as _rules  # noqa: F401  (registers the rules)

"""Named compression-pipeline presets, mirrored from the JAX package's
`repro.configs.registry.PIPELINES` (a test pins the two equal).

The gradient-wire presets use eb=1 as a placeholder: the caller passes the
per-tensor bound (eb_rel * rms(g)) at encode time.  Every preset parses
and runs in the port.
"""
from __future__ import annotations

PIPELINES = {
    # gradient all-reduce wires (cap = 1/64)
    "grad-wire-8": "abs:1.0:cap=0.015625|pack:8",
    "grad-wire-8-narrow": "abs:1.0:cap=0.015625|pack:8|narrow",
    "grad-wire-16-zero": "abs:1.0:cap=0.015625|pack:16|zero",
    "grad-wire-16-narrow": "abs:1.0:cap=0.015625|pack:16|narrow",
    "grad-wire-16-ent": "abs:1.0:cap=0.015625|pack:16|narrow|ent",
    "grad-wire-pred": "delta|abs:1.0:cap=0.015625|pack:16|narrow|ent",
    # scientific-data archival-grade device chains (paper eval bound 1e-3)
    "sci-abs-narrow": "abs:0.001|pack:32|narrow",
    "sci-rel-narrow": "rel:0.001|pack:32|narrow",
    "sci-rel-shuffle": "rel:0.001|pack:32|shuffle|narrow",
    "sci-rel-ent": "rel:0.001|pack:32|shuffle|narrow|ent",
    "sci-lorenzo-ent": "lorenzo|abs:0.001|pack:32|narrow|ent",
    # KV-page migration chain
    "kv-delta": "kvdelta|abs:1.0|pack:8|zero|narrow",
    # the full chain exercised by CI's smoke step
    "smoke-chain": "rel:0.001|pack:8|zero|narrow",
}


def get_pipeline(name: str) -> str:
    """Resolve a preset name OR pass through a raw spec ('|' present)."""
    if name in PIPELINES:
        return PIPELINES[name]
    if "|" in name:
        return name
    raise KeyError(f"unknown pipeline preset {name!r}; have "
                   f"{sorted(PIPELINES)} (or pass a '|'-spec)")

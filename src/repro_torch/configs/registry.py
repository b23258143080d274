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


# Selector candidate sets (the adaptive chain choice), mirrored from the
# JAX package's `SELECTOR_SETS` with its autotuned biases (a test pins the
# two equal).  `base` is the shared quantizer + pack spec; `chains` are
# the word-stage (and pred-stage) fragments appended to it; `bias` is the
# per-candidate calibration in bits per 1024 words.  `base: None` marks a
# KV page-fragment set, mirrored as data: its per-page selector comes with
# the packed KV wire (ROADMAP A12).
SELECTOR_SETS = {
    "grad-wire": {
        "base": "abs:0.001:cap=0.015625|pack:16",
        "chains": ("", "zero", "narrow", "narrow|ent",
                   "delta|narrow|ent"),
        "bias": (0, 0, 0, 24.119, 30.48),
    },
    "sci-plane": {
        "base": "abs:64.0:cap=0.015625|pack:32",
        "chains": ("", "narrow", "narrow|ent", "lorenzo|narrow|ent"),
        "bias": (0, 0, 4.297, 8.176),
    },
    "kv-page": {
        "base": None,
        "chains": ("zero", "zero|narrow", "kvdelta|zero|narrow"),
        "bias": (0, 0, 0),
    },
}


def get_selector_set(name: str) -> dict:
    """The `SELECTOR_SETS` entry of a set name."""
    if name not in SELECTOR_SETS:
        raise KeyError(f"unknown selector set {name!r}; have "
                       f"{sorted(SELECTOR_SETS)}")
    return SELECTOR_SETS[name]

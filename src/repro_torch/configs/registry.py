"""The assigned architectures and the named compression presets, mirrored
from the JAX package's `repro.configs.registry` (`ARCHS`, `PIPELINES`,
`KV_PAGE_CHAINS`, `SELECTOR_SETS`; a test pins each equal).

The gradient-wire presets use eb=1 as a placeholder: the caller passes the
per-tensor bound (eb_rel * rms(g)) at encode time.  Every preset parses
and runs in the port.
"""
from __future__ import annotations

from .base import ArchConfig

ARCHS = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


internlm2_20b = _reg(ArchConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544,
    source="arXiv:2403.17297; hf"))

stablelm_3b = _reg(ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b; unverified"))

chatglm3_6b = _reg(ArchConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024, rope="partial",
    source="arXiv:2406.12793; hf (2d-RoPE -> rotary on half the head dim)"))

deepseek_67b = _reg(ArchConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=102400,
    source="arXiv:2401.02954; hf (llama-arch)"))

chameleon_34b = _reg(ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536,
    source="arXiv:2405.09818; unverified (early fusion: VQ image tokens "
           "share the text vocab; frontend stub = token ids)"))

whisper_base = _reg(ArchConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865, enc_layers=6,
    enc_context=1500, act="gelu", rope="none",
    source="arXiv:2212.04356; unverified (conv frontend stubbed: "
           "input_specs() provides precomputed frame embeddings)"))

olmoe_1b_7b = _reg(ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    moe_experts=64, moe_top_k=8,
    source="arXiv:2409.02060; hf"))

qwen3_moe_235b = _reg(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936,
    moe_experts=128, moe_top_k=8, head_dim=128,
    source="hf:Qwen/Qwen3-30B-A3B; hf"))

jamba_1_5_large = _reg(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    moe_experts=16, moe_top_k=2, moe_every=2, attn_period=8,
    source="arXiv:2403.19887; hf (Mamba+attn 1:7, MoE every 2nd layer)"))

xlstm_350m = _reg(ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    source="arXiv:2405.04517; unverified (alternating mLSTM/sLSTM blocks)"))


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def all_archs() -> dict:
    return dict(ARCHS)


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


# Per-page KV wire chains for the decode engine and cache migration:
# fragments of the two-domain grammar applied per page (optional pred
# stages, then word stages), not full pipeline specs (the quantizer is
# `compression.kv.kv_quantizer_config`, per page).
KV_PAGE_CHAINS = {
    # default engine hand-off: zero chunks drop the unwritten tail
    "kv-page": "zero",
    # narrow the surviving chunks too
    "kv-page-narrow": "zero|narrow",
    # kvdelta residuals ahead of the per-page coder
    "kv-page-pred": "kvdelta|zero|narrow",
}


def get_kv_chain(name: str) -> str:
    """Resolve a KV page-chain preset OR pass through a raw fragment;
    'auto' / 'auto:SET' pass through verbatim (`compression.kv` resolves
    them to a per-page `KVSelector`)."""
    if name in KV_PAGE_CHAINS:
        return KV_PAGE_CHAINS[name]
    if name == "auto" or name.startswith("auto:"):
        return name
    if "|" in name or name in ("", "zero", "narrow"):
        return name
    raise KeyError(f"unknown KV page chain {name!r}; have "
                   f"{sorted(KV_PAGE_CHAINS)} (or pass a stage fragment)")


# Selector candidate sets (the adaptive chain choice), mirrored from the
# JAX package's `SELECTOR_SETS` with its autotuned biases (a test pins the
# two equal).  `base` is the shared quantizer + pack spec; `chains` are
# the word-stage (and pred-stage) fragments appended to it; `bias` is the
# per-candidate calibration in bits per 1024 words.  `base: None` marks a
# KV page-fragment set (`core.select.get_kv_selector`).
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

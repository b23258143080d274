"""Architecture and run-shape configuration, mirrored from the JAX
package's `repro.configs.base` (a test pins the two equal).

One `ArchConfig` per assigned architecture (exact public numbers, in
`configs.registry.ARCHS`) plus `reduced()` for small CPU tests.
`ShapeConfig` carries the four assigned input shapes.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # see FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1            # MoE FFN every k-th layer (jamba: 2)
    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0
    ssm_state: int = 16           # mamba d_state
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_context: int = 1500       # stubbed frame-embedding length
    # rotary style: 'full' | 'partial' (chatglm 2d-rope: half the head dim)
    rope: str = "full"
    norm_eps: float = 1e-5
    act: str = "swiglu"           # 'swiglu' | 'gelu' (whisper)
    source: str = ""              # provenance note [paper/hf; tier]

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256."""
        return (self.vocab + 255) // 256 * 256

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.attn_period == 0
                         else self.attn_period),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads,
                                  4 // max(1, self.group_size))),
            head_dim=32,
            d_ff=256,
            vocab=512,
            moe_experts=min(self.moe_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            enc_layers=min(self.enc_layers, 2),
            enc_context=64,
            ssm_state=8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

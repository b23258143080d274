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

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once; the roofline's
        MODEL_FLOPS = 6 N D term)."""
        d, hd, f = self.d_model, self.head_dim, self.d_ff
        attn = d * (self.n_heads * hd) * 2 + d * (2 * self.n_kv_heads * hd)
        dense_ffn = (3 if self.act == "swiglu" else 2) * d * f
        if self.family == "moe":
            moe_ffn = 3 * d * f * self.moe_experts
            per_layer = attn + moe_ffn + d * self.moe_experts + 2 * d
            n = self.n_layers * per_layer
        elif self.family == "hybrid":
            n = 0
            for i in range(self.n_layers):
                is_attn = (i % self.attn_period) == self.attn_period - 1
                block = attn if is_attn else self._mamba_params()
                ffn = (3 * d * f * self.moe_experts + d * self.moe_experts
                       if (i % self.moe_every) == self.moe_every - 1
                       else dense_ffn)
                n += block + ffn + 2 * d
        elif self.family == "ssm":
            n = self.n_layers * self._xlstm_params()
        elif self.family == "encdec":
            dec = self.n_layers * (2 * attn + dense_ffn + 3 * d)
            enc = self.enc_layers * (attn + dense_ffn + 2 * d)
            n = dec + enc + (self.enc_context + 32_768) * d  # positions
        else:                                                 # dense / vlm
            n = self.n_layers * (attn + dense_ffn + 2 * d)
        return n + self.vocab * d

    def active_param_count(self) -> int:
        """MoE: only the top-k experts count toward a step's FLOPs."""
        if self.moe_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        if self.family == "moe":
            inactive = (self.n_layers * 3 * d * f
                        * (self.moe_experts - self.moe_top_k))
        else:                                                 # hybrid
            n_moe = sum(1 for i in range(self.n_layers)
                        if (i % self.moe_every) == self.moe_every - 1)
            inactive = n_moe * 3 * d * f * (self.moe_experts - self.moe_top_k)
        return full - inactive

    def _mamba_params(self) -> int:
        """One Mamba block (the reference's models/mamba.py shapes)."""
        d = self.d_model
        n = self.ssm_state
        di = 2 * d
        return (d * 2 * di            # in_proj
                + 4 * di              # conv
                + di * n + di         # a_log, d_skip
                + di * 2 * n          # bc_proj
                + di * di + di        # dt_proj, dt_bias
                + di * d)             # out_proj

    def _xlstm_params(self) -> int:
        """Per layer: one mLSTM + sLSTM pair (models/xlstm.py's shapes) and
        its two norms, halved."""
        d, h = self.d_model, self.n_heads
        di = 2 * d
        dh = di // h
        mlstm = d * 2 * di + di * 3 * di + di * 3 * h + di * d
        slstm = d * 2 * di + di * 4 * di + h * dh * 4 * dh + di * d
        return (mlstm + slstm + 2 * d) // 2


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


def runnable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """Assignment skip rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False
    return True

"""Family dispatcher: ArchConfig -> parameter specs, weights, caches, the
forward pass's prefill and the decode step (counterpart of
`repro.models.model`, for the dense, vlm and MoE families).  The other
families raise, naming their ROADMAP item; `loss` and `input_specs` wait
for the training and dry-run slices (ROADMAP A15/A16)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from . import serve, transformer
from .params import count_params, materialize


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    specs: dict

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """The port's own weights on `device`, drawn from `generator` (a
        generator on that device)."""
        return materialize(self.specs, generator, device)

    def n_params(self) -> int:
        return count_params(self.specs)

    def make_cache(self, batch: int, seq: int, quantized: bool = False, *,
                   device="cuda"):
        if quantized:
            return serve.make_quant_cache(self.cfg, batch, seq,
                                          device=device)
        return serve.make_raw_cache(self.cfg, batch, seq, device=device)

    def serve_step(self, params, cache, tokens, pos, mesh=None, kv_cfg=None):
        return serve.serve_step(self.cfg, params, cache, tokens, pos, mesh,
                                kv_cfg)

    def prefill(self, params, batch: dict, mesh=None) -> torch.Tensor:
        """The forward pass without a loss (the prefill_32k program):
        batch["tokens"] int [B, S] -> the last position's logits, float32
        [B, V_padded]."""
        logits, _ = transformer.forward(self.cfg, params, batch["tokens"],
                                        mesh, remat=False)
        return logits[:, -1].to(torch.float32)


def build(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(cfg, transformer.param_specs(cfg))

"""Family dispatcher: ArchConfig -> parameter specs, weights, the training
loss, caches, the forward pass's prefill and the decode step (counterpart
of `repro.models.model`, for the dense, vlm, MoE, encdec and ssm
families).  The hybrid raises, naming its ROADMAP item; `input_specs`
waits for the dry-run slice (ROADMAP A16)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..core.pipeline import not_ported
from . import encdec, serve, transformer, xlstm_stack
from .params import count_params, materialize, tree_map


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    specs: dict

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """The port's own weights on `device`, drawn from `generator` (a
        generator on that device)."""
        return materialize(self.specs, generator, device)

    def abstract_params(self) -> dict:
        """The weights' shapes and dtypes as tensors on the "meta" device:
        a template that allocates nothing (the reference's
        ShapeDtypeStructs)."""
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"), self.specs)

    def n_params(self) -> int:
        return count_params(self.specs)

    def _forward(self, params, batch: dict, mesh, remat: bool,
                 moe_data_axes=None):
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.forward(cfg, params, batch["tokens"],
                                  batch["frames"], mesh, remat)
        if cfg.family == "ssm":
            return xlstm_stack.forward(cfg, params, batch["tokens"], mesh,
                                       remat)
        return transformer.forward(cfg, params, batch["tokens"], mesh, remat,
                                   moe_data_axes)

    def loss(self, params, batch: dict, mesh=None, remat: bool = True,
             moe_data_axes=None):
        """The training loss ce + 0.01 aux: ce the mean over tokens of the
        float32 logsumexp of the logits less the label's logit, aux the
        layers' load-balance loss.  batch: {"tokens", "labels"} int [B,
        S], and for encdec "frames" [B, enc_context, D].  Returns (loss,
        (ce, aux)), 0-d float32 tensors."""
        logits, aux = self._forward(params, batch, mesh, remat,
                                    moe_data_axes)
        logits = logits.to(torch.float32)
        labels = batch["labels"].to(torch.int64)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None])[..., 0]
        ce = torch.mean(lse - ll)
        return ce + 0.01 * aux, (ce, aux)

    def make_cache(self, batch: int, seq: int, quantized: bool = False, *,
                   device="cuda"):
        cfg = self.cfg
        if cfg.family == "ssm":
            return xlstm_stack.make_cache(cfg, batch, seq, device=device)
        if cfg.family == "encdec":
            return encdec.make_cache(cfg, batch, seq, device=device)
        if cfg.family == "hybrid":
            raise not_ported("the hybrid family's cache", "ROADMAP A13")
        if quantized:
            return serve.make_quant_cache(cfg, batch, seq, device=device)
        return serve.make_raw_cache(cfg, batch, seq, device=device)

    def serve_step(self, params, cache, tokens, pos, mesh=None, kv_cfg=None):
        cfg = self.cfg
        if cfg.family == "ssm":
            return xlstm_stack.serve_step(cfg, params, cache, tokens, pos,
                                          mesh, kv_cfg)
        if cfg.family == "encdec":
            return encdec.serve_step(cfg, params, cache, tokens, pos, mesh,
                                     kv_cfg)
        return serve.serve_step(cfg, params, cache, tokens, pos, mesh,
                                kv_cfg)

    def prefill(self, params, batch: dict, mesh=None) -> torch.Tensor:
        """The forward pass without a loss (the prefill_32k program):
        batch["tokens"] int [B, S] (and for encdec batch["frames"]) -> the
        last position's logits, float32 [B, V_padded]."""
        logits, _ = self._forward(params, batch, mesh, remat=False)
        return logits[:, -1].to(torch.float32)


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "ssm":
        return ModelBundle(cfg, xlstm_stack.param_specs(cfg))
    if cfg.family == "encdec":
        return ModelBundle(cfg, encdec.param_specs(cfg))
    return ModelBundle(cfg, transformer.param_specs(cfg))

"""Family dispatcher: ArchConfig -> parameter specs, weights, the training
loss, caches, the forward pass's prefill, the decode step and the input
specs (counterpart of `repro.models.model`, for every family: dense,
vlm, MoE, hybrid, encdec and ssm).

`mesh` is a `launch.mesh.Mesh` of the calling rank.  With `params` the
rank's blocks (`launch.mesh.param_blocks`; the dense, vlm and MoE
families) the forward pass and the decode step run the reference's
layout (`models.transformer`, `models.serve`): the rank's cache block
(a `serve.RankCache` from `make_cache(..., mesh=)`), and the rank's
"vocab" block of the logits, and `loss` takes its cross-entropy across
the ranks' blocks (`layers.vocab_ce`).  With whole weights the MoE
layers run expert parallel over its "model" axis (`models.moe`) and
every other layer replicated on each rank."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import encdec, mamba, serve, transformer, xlstm_stack
from . import layers as L
from .params import abstract, axes_tree, count_params, materialize
from .transformer import DTYPE


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
        return abstract(self.specs)

    def axes(self) -> dict:
        """Every weight's logical axes (`launch.mesh.param_shardings`)."""
        return axes_tree(self.specs)

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
        float32 logsumexp of the logits less the label's logit (on a rank
        of the layout over the ranks' "vocab" blocks, `layers.vocab_ce`;
        the mean over the rank's tokens), aux the layers' load-balance
        loss.  batch: {"tokens", "labels"} int [B, S], and for encdec
        "frames" [B, enc_context, D].  Returns (loss, (ce, aux)), 0-d
        float32 tensors."""
        logits, aux = self._forward(params, batch, mesh, remat,
                                    moe_data_axes)
        logits = logits.to(torch.float32)
        labels = batch["labels"].to(torch.int64)
        spec = self.layout(params, mesh)
        if transformer._split(transformer._entry(spec, "emb", 0), mesh):
            # the rank's "vocab" block of the logits
            ce = torch.mean(L.vocab_ce(logits, labels, mesh.axis("model")))
        else:
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, labels[..., None])[..., 0]
            ce = torch.mean(lse - ll)
        return ce + 0.01 * aux, (ce, aux)

    def layout(self, params, mesh):
        """The specs tree of the reference's layout where `params` are the
        rank's blocks under `param_shardings` on the rank's `mesh`
        (`transformer.rank_layout`, the LAYOUT_FAMILIES), else None."""
        if mesh is None or self.cfg.family not in transformer.LAYOUT_FAMILIES:
            return None
        return transformer.rank_layout(self.cfg, params, mesh)

    def make_cache(self, batch: int, seq: int, quantized: bool = False, *,
                   device="cuda", mesh=None):
        """A zero decode cache of `batch` rows over `seq` tokens: raw or
        (quantized=True) a QuantCache for the decoder stacks; the ssm
        family's recurrent state, encdec's self-attention cache (its
        cross K/V comes from `encdec.cross_kv`), and for the hybrid
        (RawCache over its periods' attention layers, (conv tails [P,
        n_mamba, B, K-1, Di] bfloat16, ssm states [P, n_mamba, B, Di, N]
        float32)) whatever `quantized` says, as the reference gives.
        With `mesh` (a rank's; the dense, vlm and MoE families): the
        rank's `serve.RankCache`, its block of the cache of `batch` rows
        (the global batch) under `launch.mesh.cache_layouts`."""
        cfg = self.cfg
        if mesh is not None:
            if cfg.family not in transformer.LAYOUT_FAMILIES:
                raise NotImplementedError(
                    f"the {cfg.family} family's cache has no rank layout "
                    "yet: it runs on whole weights and caches")
            make = (serve.make_quant_cache if quantized
                    else serve.make_raw_cache)
            return make(cfg, batch, seq, device=device, mesh=mesh)
        if cfg.family == "ssm":
            return xlstm_stack.make_cache(cfg, batch, seq, device=device)
        if cfg.family == "encdec":
            return encdec.make_cache(cfg, batch, seq, device=device)
        if cfg.family == "hybrid":
            # the reference's: a raw cache whatever `quantized` says
            periods = cfg.n_layers // cfg.attn_period
            n_mamba, di = cfg.attn_period - 1, 2 * cfg.d_model
            attn = serve.make_raw_cache(cfg, batch, seq, n_layers=periods,
                                        device=device)
            dev = attn.k.device
            tails = torch.zeros((periods, n_mamba, batch, mamba.CONV_K - 1,
                                 di), dtype=DTYPE, device=dev)
            hs = torch.zeros((periods, n_mamba, batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=dev)
            return (attn, (tails, hs))
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

    def input_specs(self, shape: ShapeConfig, quantized_kv: bool = False):
        """Every model input of this (arch, shape) cell as tensors on the
        "meta" device (no allocation): train {"tokens", "labels"},
        prefill {"tokens"} (encdec: and "frames" [B, enc_context, D]),
        decode {"tokens" [B, 1], "pos" [], "cache"} against a seq_len
        cache."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
        tok = meta((b, s), torch.int32)
        if shape.kind in ("train", "prefill"):
            d = {"tokens": tok}
            if shape.kind == "train":
                d["labels"] = meta((b, s), torch.int32)
            if cfg.family == "encdec":
                d["frames"] = meta((b, cfg.enc_context, cfg.d_model), DTYPE)
            return d
        return {"tokens": meta((b, 1), torch.int32),
                "pos": meta((), torch.int32),
                "cache": self.make_cache(b, s, quantized=quantized_kv,
                                         device="meta")}

    def prefill(self, params, batch: dict, mesh=None) -> torch.Tensor:
        """The forward pass without a loss (the prefill_32k program):
        batch["tokens"] int [B, S] (and for encdec batch["frames"]) -> the
        last position's logits, float32 [B, V_padded] (on a rank of the
        layout its "vocab" block [B, V_padded / model])."""
        logits, _ = self._forward(params, batch, mesh, remat=False)
        return logits[:, -1].to(torch.float32)


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "ssm":
        return ModelBundle(cfg, xlstm_stack.param_specs(cfg))
    if cfg.family == "encdec":
        return ModelBundle(cfg, encdec.param_specs(cfg))
    return ModelBundle(cfg, transformer.param_specs(cfg))

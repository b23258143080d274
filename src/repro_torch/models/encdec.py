"""The whisper-style encoder-decoder (counterpart of `repro.models.encdec`).

The conv/audio frontend is a stub, as in the reference: `frames`, the
precomputed frame embeddings [B, enc_context, D] in bfloat16, are an
input.  Encoder: bidirectional self-attention and a GELU FFN; decoder:
causal self-attention, cross-attention over the encoder's output and a
GELU FFN; learned positional embeddings; pre-LayerNorm with bias.

Per-layer parameters are stacked on a leading layer axis, so the
reference's tree carries across as it is (`params.params_from_numpy`).
The reference scans the layers (the encoder always under remat, the
decoder under `remat`); the port loops over them in Python and, while
autograd records, wraps each layer in `torch.utils.checkpoint`, which
changes no value.  `serve_step` reads a raw bfloat16 cache and ignores
`kv_cfg`, as the reference's does; the cross-attention K/V in the cache
are the caller's (`cross_kv`: each layer's cross `wkv` over the encoder's
output).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.pipeline import resolve_device
from . import layers as L
from .params import ParamSpec
from .serve import RawCache
from .transformer import DTYPE, _index

MAX_DEC_LEN = 32_768          # covers the decode_32k / prefill_32k shapes


def _ln(lead, d):
    ax = tuple(None for _ in lead)
    return {"w": ParamSpec(lead + (d,), torch.float32, ax + (None,), -1.0),
            "b": ParamSpec(lead + (d,), torch.float32, ax + (None,), 0.0)}


def _attn(cfg: ArchConfig, lead):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    ax = tuple(None for _ in lead)
    return {
        "ln": _ln(lead, d),
        "wq": ParamSpec(lead + (d, h * hd), DTYPE, ax + ("embed", "heads")),
        "wkv": ParamSpec(lead + (d, 2 * h * hd), DTYPE,
                         ax + ("embed", "heads")),
        "wo": ParamSpec(lead + (h * hd, d), DTYPE, ax + ("heads", "embed")),
    }


def _ffn(cfg: ArchConfig, lead):
    d, f = cfg.d_model, cfg.d_ff
    ax = tuple(None for _ in lead)
    return {
        "ln": _ln(lead, d),
        "w1": ParamSpec(lead + (d, f), DTYPE, ax + ("embed", "mlp")),
        "w2": ParamSpec(lead + (f, d), DTYPE, ax + ("mlp", "embed")),
    }


def param_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    el, dl = cfg.enc_layers, cfg.n_layers
    return {
        "emb": ParamSpec((cfg.padded_vocab, d), DTYPE, ("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.enc_context, d), DTYPE, (None, "embed")),
        "dec_pos": ParamSpec((MAX_DEC_LEN, d), DTYPE, (None, "embed")),
        "enc": {"self": _attn(cfg, (el,)), "ffn": _ffn(cfg, (el,))},
        "dec": {"self": _attn(cfg, (dl,)), "cross": _attn(cfg, (dl,)),
                "ffn": _ffn(cfg, (dl,))},
        "enc_norm": _ln((), d),
        "final_norm": _ln((), d),
    }


def _mha(cfg: ArchConfig, p: dict, xq, xkv, causal: bool):
    b, sq, _ = xq.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (xq @ p["wq"]).reshape(b, sq, h, hd)
    kv = (xkv @ p["wkv"]).reshape(b, xkv.shape[1], 2, h, hd)
    o = L.flash_attention(q, kv[:, :, 0], kv[:, :, 1], causal=causal)
    return o.reshape(b, sq, h * hd) @ p["wo"]


def _block_ln(p: dict, x, eps: float):
    return L.layer_norm(x, p["w"], p["b"], eps)


def _enc_layer(cfg: ArchConfig, lp: dict, h):
    hn = _block_ln(lp["self"]["ln"], h, cfg.norm_eps)
    h = h + _mha(cfg, lp["self"], hn, hn, causal=False)
    hn = _block_ln(lp["ffn"]["ln"], h, cfg.norm_eps)
    return h + L.ffn(hn, lp["ffn"]["w1"], None, lp["ffn"]["w2"], "gelu")


def _dec_layer(cfg: ArchConfig, lp: dict, h, enc_out):
    hn = _block_ln(lp["self"]["ln"], h, cfg.norm_eps)
    h = h + _mha(cfg, lp["self"], hn, hn, causal=True)
    hn = _block_ln(lp["cross"]["ln"], h, cfg.norm_eps)
    h = h + _mha(cfg, lp["cross"], hn, enc_out, causal=False)
    hn = _block_ln(lp["ffn"]["ln"], h, cfg.norm_eps)
    return h + L.ffn(hn, lp["ffn"]["w1"], None, lp["ffn"]["w2"], "gelu")


def _run_layer(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor):
    """frames: [B, enc_context, D] (the stubbed frontend's output) -> the
    encoder's output, bfloat16 [B, enc_context, D]."""
    x = frames.to(DTYPE) + params["enc_pos"][None].to(DTYPE)
    for i in range(cfg.enc_layers):
        x = _run_layer(lambda lp, h: _enc_layer(cfg, lp, h), True,
                       _index(params["enc"], i), x)
    return _block_ln(params["enc_norm"], x, cfg.norm_eps)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor, mesh=None, remat: bool = True):
    """The teacher-forced decoder over stubbed audio frames: tokens int
    [B, S], frames [B, enc_context, D] -> (logits bfloat16 [B, S,
    V_padded], aux 0.0 float32).  With a mesh (the calling rank's) every
    layer runs replicated on the rank: the family has no experts."""
    enc_out = encode(cfg, params, frames)
    s = tokens.shape[1]
    x = (params["emb"][tokens] + params["dec_pos"][:s][None]).to(DTYPE)
    for i in range(cfg.n_layers):
        x = _run_layer(lambda lp, h, e: _dec_layer(cfg, lp, h, e), remat,
                       _index(params["dec"], i), x, enc_out)
    x = _block_ln(params["final_norm"], x, cfg.norm_eps)
    logits = x @ params["emb"].T.to(DTYPE)
    return logits, torch.zeros((), device=logits.device)


def make_cache(cfg: ArchConfig, batch: int, seq: int, *, device="cuda"):
    """(the decoder's self-attention KV cache [L, B, seq, H, hd], the
    cross-attention KV [L, B, enc_context, H, hd]), bfloat16 zeros."""
    dev = resolve_device(device)
    dl, h, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim

    def zeros(s):
        return torch.zeros((dl, batch, s, h, hd), dtype=DTYPE, device=dev)

    return (RawCache(zeros(seq), zeros(seq)),
            RawCache(zeros(cfg.enc_context), zeros(cfg.enc_context)))


def cross_kv(cfg: ArchConfig, params: dict, enc_out: torch.Tensor):
    """The cross-attention K/V that `serve_step` reads, as the decoder's
    cross-attention in `forward` computes them: each layer's `wkv` over
    the encoder's output [B, enc_context, D].  Returns a RawCache of [L,
    B, enc_context, H, hd] bfloat16 (the reference's make_cache leaves
    this to the caller's prefill)."""
    b, s, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.head_dim
    kv = torch.stack([(enc_out @ w).reshape(b, s, 2, h, hd)
                      for w in params["dec"]["cross"]["wkv"]])
    return RawCache(kv[:, :, :, 0].contiguous(), kv[:, :, :, 1].contiguous())


def serve_step(cfg: ArchConfig, params: dict, cache, tokens, pos: int,
               mesh=None, kv_cfg=None):
    """One decoder token at the host int `pos`; tokens int [B, 1].  The
    self-attention K/V are written into the cache in place; the
    cross-attention K/V are read from it.  Returns (logits float32 [B,
    V_padded], cache); a mesh changes nothing (see `forward`)."""
    self_kv, cross = cache
    pos = int(pos)
    if self_kv.k.shape[2] <= pos:
        raise ValueError(f"pos {pos} is past the cache's "
                         f"{self_kv.k.shape[2]} tokens")
    b = tokens.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    x = (params["emb"][tokens]
         + params["dec_pos"][pos:pos + 1][None]).to(DTYPE)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    full = torch.full((b,), cfg.enc_context, dtype=torch.int32, device=dev)
    for i in range(cfg.n_layers):
        lp = _index(params["dec"], i)
        kc, vc = self_kv.k[i], self_kv.v[i]
        hn = _block_ln(lp["self"]["ln"], x, cfg.norm_eps)
        q = (hn @ lp["self"]["wq"]).reshape(b, 1, h, hd)
        kv = (hn @ lp["self"]["wkv"]).reshape(b, 1, 2, h, hd)
        kc[:, pos] = kv[:, 0, 0].to(kc.dtype)
        vc[:, pos] = kv[:, 0, 1].to(vc.dtype)
        o = L.decode_attention(q, kc, vc, lengths)
        x = x + o.reshape(b, 1, h * hd) @ lp["self"]["wo"]

        hn = _block_ln(lp["cross"]["ln"], x, cfg.norm_eps)
        q = (hn @ lp["cross"]["wq"]).reshape(b, 1, h, hd)
        o = L.decode_attention(q, cross.k[i], cross.v[i], full)
        x = x + o.reshape(b, 1, h * hd) @ lp["cross"]["wo"]

        hn = _block_ln(lp["ffn"]["ln"], x, cfg.norm_eps)
        x = x + L.ffn(hn, lp["ffn"]["w1"], None, lp["ffn"]["w2"], "gelu")
    x = _block_ln(params["final_norm"], x, cfg.norm_eps)
    logits = (x @ params["emb"].T.to(DTYPE))[:, 0].to(torch.float32)
    return logits, cache

"""Plain torch oracles for the port's dense and attention kernels
(counterpart of `repro.kernels.ref`).

The quantizer oracles are the core library functions (`core.quantizer`,
the one source of the guarantee), with a static eb when none is given; the
attention oracle is a direct softmax over the dequantized,
outlier-corrected cache.  The tests hold the kernels' plain versions (and,
on the card, the kernels) against these: bit for bit for the quantizers,
within a tolerance for the attention, whose sums run in another order.
"""
from __future__ import annotations

import torch

from ..compression.kv import PAGE, QuantizedKV, dequantize_kv
from ..core import quantizer as q
from ..core.bitops import bits_to_float
from ..core.config import QuantizerConfig


def quantize_abs_ref(x, cfg: QuantizerConfig, eb=None):
    qt = q.quantize_abs(x, cfg, eb=eb)
    return qt.bins, qt.outlier, qt.recon


def quantize_rel_ref(x, cfg: QuantizerConfig):
    qt = q.quantize_rel(x, cfg)
    return qt.bins, qt.outlier, qt.recon, qt.sign


def dequantize_abs_ref(bins, payload_bits, outlier, cfg: QuantizerConfig,
                       eb=None, dtype=torch.float32):
    recon = q.dequantize_abs(bins, cfg, eb=eb, dtype=dtype)
    return torch.where(outlier, bits_to_float(payload_bits, dtype), recon)


def dequantize_rel_ref(bins, payload_bits, outlier, sign,
                       cfg: QuantizerConfig, dtype=torch.float32):
    recon = q.dequantize_rel(bins, sign, cfg, dtype=dtype)
    return torch.where(outlier, bits_to_float(payload_bits, dtype), recon)


def kv_decode_attention_ref(q_: torch.Tensor, kq: QuantizedKV,
                            vq: QuantizedKV, lengths: torch.Tensor, *,
                            page: int = PAGE) -> torch.Tensor:
    """Decode attention as a plain softmax over the fully dequantized cache
    (`compression.kv.dequantize_kv`), tokens >= lengths[b] masked to -inf.
    q_: [B, G, Hg, D]; lengths: [B].  With length 0 the output is NaN."""
    d = q_.shape[-1]
    s = kq.bins.shape[2]
    k = dequantize_kv(kq, page=page)                    # [B, G, S, D]
    v = dequantize_kv(vq, page=page)
    scores = torch.einsum("bghd,bgsd->bghs", q_.float(), k) / (d ** 0.5)
    mask = torch.arange(s, device=q_.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    return torch.einsum("bghs,bgsd->bghd", torch.softmax(scores, dim=-1), v)

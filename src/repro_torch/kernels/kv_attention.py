"""Flash-decode attention over the int8 quantized KV cache: the CUDA kernel
of `csrc/kv_attention.cu`, its wrapper, and its plain torch version.

Counterpart of `repro.kernels.kv_attention` (the Pallas kernel `_kernel`
and its launcher `kv_decode_attention`).  For one query token per
sequence, q [B, G, Hg, D] attends to tokens < lengths[b] of a cache whose
K and V are `compression.kv.QuantizedKV` planes with bins [B, G, S, D].
The kernel dequantizes each page in shared memory, adds the page's exact
outlier values, and runs the online softmax in float32, page by page; it
stops after the last page that holds a token < lengths[b].

Semantics beside the reference's (ROADMAP C-port-3): pages wholly past the
length are not read, so a non-finite V value there does not reach the
output (the reference's 0 * inf gives NaN); with length 0 no page is read
and the output is NaN (0/0), as the reference's oracle gives, where the
reference's kernel gives the mean of V.  The output agrees with the
reference's kernel and oracle within rtol = atol = 2e-5 (the reference's
own tolerance: the sums are taken in another order).

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel (built from source at first use) or raises;
nothing falls back.  Each launch adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compression.kv import CAP, PAGE, QuantizedKV, dequantize_kv
from .pack import _launch

KERNELS = ("_kv_decode_attention",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
NEG_BIG = -1e30
MAX_HG = 16          # query heads per KV head the kernel takes
HEAD_DIM = 128       # the kernel's D (and its page, PAGE)


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def softmax_scale(d: int) -> float:
    """1/sqrt(d) rounded once to float32, as the reference's kernel
    multiplies by it."""
    return float(np.float32(1.0 / d ** 0.5))


def _check(q, kq: QuantizedKV, vq: QuantizedKV, lengths, page: int,
           cap: int) -> None:
    b, g, hg, d = q.shape
    if q.dtype != torch.float32:
        raise NotImplementedError(f"q: expected float32, got {q.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("lengths must be int32 [B]")
    for name, qkv in (("kq", kq), ("vq", vq)):
        s = qkv.bins.shape[2]
        if qkv.bins.dtype != torch.int8 or qkv.bins.shape != (b, g, s, d):
            raise ValueError(f"{name}.bins must be int8 [B, G, S, D]")
        if s % page:
            raise ValueError(f"{name}: S={s} is not a multiple of page={page}")
        pages = (b, g, s // page)
        if (qkv.eb2.dtype != torch.float32 or qkv.eb2.shape != pages
                or qkv.out_idx.dtype != torch.int32
                or qkv.out_idx.shape != (*pages, cap)
                or qkv.out_val.dtype != torch.float32
                or qkv.out_val.shape != (*pages, cap)):
            raise ValueError(f"{name}: eb2 f32 [B, G, S/page], out_idx int32 "
                             f"and out_val f32 [B, G, S/page, cap={cap}]")
    if kq.bins.shape != vq.bins.shape:
        raise ValueError("kq and vq must have one shape")
    devs = {t.device for t in (q, lengths, *kq[:4], *vq[:4])}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"all operands on one cpu or cuda device, got {devs}")


# --------------------------------------------------------- plain version --

def _kv_decode_attention_plain(q, kq: QuantizedKV, vq: QuantizedKV, lengths,
                               page: int = PAGE):
    """The kernel's arithmetic in torch ops: page by page over the
    dequantized cache, the online softmax in float32, pages past
    ceil(lengths / page) skipped (their update is discarded)."""
    b, g, hg, d = q.shape
    s = kq.bins.shape[2]
    k = dequantize_kv(kq, page=page)
    v = dequantize_kv(vq, page=page)
    scale = torch.full((), softmax_scale(d), device=q.device)
    lengths = lengths.to(torch.int64)
    n_pages = torch.div(lengths.clamp(min=0) + page - 1, page,
                        rounding_mode="floor")
    m = torch.full((b, g, hg, 1), NEG_BIG, device=q.device)
    l_ = torch.zeros((b, g, hg, 1), device=q.device)
    acc = torch.zeros((b, g, hg, d), device=q.device)
    tok = torch.arange(page, device=q.device)
    for p in range(s // page):
        kp = k[:, :, p * page:(p + 1) * page]
        vp = v[:, :, p * page:(p + 1) * page]
        scores = torch.matmul(q, kp.transpose(-1, -2)) * scale   # [b,g,hg,P]
        valid = (p * page + tok)[None, :] < lengths[:, None]      # [b, P]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full((), NEG_BIG, device=q.device))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(scores - m_new)
        live = (p < n_pages)[:, None, None, None]
        l_ = torch.where(live, l_ * alpha + pexp.sum(-1, keepdim=True), l_)
        acc = torch.where(live, acc * alpha + torch.matmul(pexp, vp), acc)
        m = torch.where(live, m_new, m)
    return acc / l_


# --------------------------------------------------------------- wrapper --

def kv_decode_attention(q: torch.Tensor, kq: QuantizedKV, vq: QuantizedKV,
                        lengths: torch.Tensor, *, page: int = PAGE,
                        cap: int = CAP) -> torch.Tensor:
    """q: float32 [B, G, Hg, D]; kq, vq: QuantizedKV with bins [B, G, S, D];
    lengths: int32 [B].  Returns float32 [B, G, Hg, D].  The CUDA kernel
    takes D = page = 128 and Hg <= 16, and raises otherwise."""
    _check(q, kq, vq, lengths, page, cap)
    if q.device.type == "cpu":
        return _kv_decode_attention_plain(q, kq, vq, lengths, page=page)
    b, g, hg, d = q.shape
    if d != HEAD_DIM or page != HEAD_DIM or not 1 <= hg <= MAX_HG:
        raise NotImplementedError(
            f"the CUDA kernel takes D = page = {HEAD_DIM} and 1 <= Hg <= "
            f"{MAX_HG}, got D={d}, page={page}, Hg={hg}")
    ops = [t.contiguous() for t in (q, lengths, *kq[:4], *vq[:4])]
    if any(t.data_ptr() % 16 for t in (ops[2], ops[6])):
        raise ValueError("the bins planes must be 16-byte aligned")
    out = torch.empty((b, g, hg, d), dtype=torch.float32, device=q.device)
    _launch(LAUNCHES, "_kv_decode_attention", "repro_kv_decode_attention",
            q.device, *(t.data_ptr() for t in ops), out.data_ptr(), b, g, hg,
            kq.bins.shape[2], d, page, cap, softmax_scale(d))
    return out

"""Flash-decode attention over the int8 quantized KV cache: the CUDA kernel
of `csrc/kv_attention.cu`, its wrapper, and its plain torch version.

Counterpart of `repro.kernels.kv_attention` (the Pallas kernel `_kernel`
and its launcher `kv_decode_attention`).  For one query token per
sequence, q [B, G, Hg, D] attends to tokens < lengths[b] of a cache whose
K and V are `compression.kv.QuantizedKV` planes with bins [B, G, S, D].
The kernel splits the pages of each (b, g) over blocks (flash-decoding):
each block streams its run of int8 pages into shared memory, runs the
online softmax in float32 page by page with the pages' exact outlier
values as corrections, and writes a partial (m, l, acc); a merge kernel
combines the partials.  Only pages that hold a token < lengths[b] are
read.  The plain version splits and merges the same way.  With
`return_stats=True` the merge also gives the merged softmax state, m (the
largest scaled score) and l (the sum of exp(score - m)) per (b, g, head),
so that a caller can merge this part of the history with another
(`models.serve` merges it with the open page's); with length 0 they are
-1e30 and 0.

Semantics beside the reference's (ROADMAP C-port-3): pages wholly past the
length are not read, so a non-finite V value there does not reach the
output (the reference's 0 * inf gives NaN); with length 0 no page is read
and the output is NaN (0/0), as the reference's oracle gives, where the
reference's kernel gives the mean of V.  The output agrees with the
reference's kernel and oracle within rtol = atol = 2e-5 (the reference's
own tolerance: the sums are taken in another order).

On a rank of the sharded layout (`models.serve._serve_tp`) the kernel
runs on the rank's block: its pages of the sequence (bins, and eb2 and
the outlier slots cut to the same pages; an outlier index is in-page, so
no offset), every KV head and the full Hg, lengths local to the block.
The caller does not launch it for a rank whose local length is 0 and
merges the ranks' (m, l) outputs itself.

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel (built from source at first use) or raises;
nothing falls back.  On the "meta" device it returns empty outputs of the
kernel's shapes and computes nothing.  Each launch adds one to
`LAUNCHES[name]`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..compression.kv import CAP, PAGE, QuantizedKV, dequantize_kv
from .pack import DEVICES, _launch

KERNELS = ("_kv_decode_attention",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
NEG_BIG = -1e30
MAX_HG = 16          # query heads per KV head the kernel takes
MAX_CAP = 64         # outlier slots per page the kernel takes
HEAD_DIMS = (80, 128)  # the kernel's instances of D (stablelm-3b; the rest)
KERNEL_PAGE = 128    # the kernel's page (tokens)
H100_SMS = 132       # the split's SM count where no card is asked
MAX_PAGES_PER_SPLIT = 16


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
    if len(devs) != 1 or next(iter(devs)).type not in DEVICES:
        raise ValueError(f"all operands on one cpu, cuda or meta device, "
                         f"got {devs}")


# ----------------------------------------------------------- the split --

def default_pages_per_split(b: int, g: int, n_pages: int,
                            sms: int = H100_SMS) -> int:
    """Pages per split block, from the shapes and the SM count only (never
    from the lengths, which stay on the card): the fewest pages that give
    every SM its two blocks over all B G n_pages pages, at most
    MAX_PAGES_PER_SPLIT (8 for one sequence at 32K, 16 at B = 32: the
    fastest of 1-64 in `chip_kv_probe.py`'s sweeps on an H100)."""
    want = -(-b * g * n_pages // (2 * sms))
    return max(1, min(MAX_PAGES_PER_SPLIT, want, n_pages))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _resolve_pages_per_split(q, n_pages: int, pages_per_split) -> int:
    if pages_per_split is None:
        return default_pages_per_split(q.shape[0], q.shape[1], n_pages,
                                       _sm_count(q.device))
    if int(pages_per_split) < 1:
        raise ValueError(f"pages_per_split must be >= 1, got {pages_per_split}")
    return int(pages_per_split)


def kv_occupancy(hg: int, cap: int = CAP) -> tuple[int, int]:
    """(dynamic shared memory bytes, blocks per SM) of the D = 128 split
    kernel at (hg, cap), as the CUDA runtime reports them on the current
    card."""
    import ctypes
    from . import _build
    lib = _build.load()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.repro_kv_decode_occupancy(
        hg, cap, ctypes.addressof(smem), ctypes.addressof(blocks)),
        "repro_kv_decode_occupancy")
    return smem.value, blocks.value


# --------------------------------------------------------- plain version --

def _kv_decode_attention_plain(q, kq: QuantizedKV, vq: QuantizedKV, lengths,
                               page: int = PAGE, pages_per_split=None,
                               return_stats: bool = False):
    """The kernel's arithmetic in torch ops over the dequantized cache.  The
    pages of each (b, g) are cut into splits of `pages_per_split` (the
    kernel's default when None); each split runs the online softmax in
    float32 page by page from (m, l, acc) = (-1e30, 0, 0), pages past
    ceil(lengths / page) skipped (their update is discarded); the splits
    are merged as the kernel merges them: m = max m_i, w_i = exp(m_i - m),
    out = sum w_i acc_i / sum w_i l_i; return_stats adds (m, sum w_i l_i),
    float32 [B, G, Hg] each."""
    b, g, hg, d = q.shape
    n_all = kq.bins.shape[2] // page
    pps = _resolve_pages_per_split(q, n_all, pages_per_split)
    nsplit = max(1, -(-n_all // pps))
    dev = q.device
    k = dequantize_kv(kq, page=page).reshape(b, g, n_all, page, d)
    v = dequantize_kv(vq, page=page).reshape(b, g, n_all, page, d)
    scale = torch.full((), softmax_scale(d), device=dev)
    neg = torch.full((), NEG_BIG, device=dev)
    lengths = lengths.to(torch.int64)
    n_used = torch.div(lengths.clamp(min=0) + page - 1, page,
                       rounding_mode="floor")
    m = torch.full((b, g, nsplit, hg, 1), NEG_BIG, device=dev)
    l_ = torch.zeros((b, g, nsplit, hg, 1), device=dev)
    acc = torch.zeros((b, g, nsplit, hg, d), device=dev)
    tok = torch.arange(page, device=dev)
    qs = q[:, :, None]                                    # [b, g, 1, hg, d]
    for j in range(pps if n_all else 0):
        pidx = torch.arange(nsplit, device=dev) * pps + j       # [nsplit]
        pc = pidx.clamp(max=n_all - 1)
        kp, vp = k[:, :, pc], v[:, :, pc]             # [b, g, nsplit, P, d]
        scores = torch.matmul(qs, kp.transpose(-1, -2)) * scale
        valid = (pidx[:, None] * page + tok)[None] < lengths[:, None, None]
        scores = torch.where(valid[:, None, :, None, :], scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(scores - m_new)
        live = ((pidx[None] < n_all) & (pidx[None] < n_used[:, None]))
        live = live[:, None, :, None, None]               # [b, 1, nsplit, 1, 1]
        l_ = torch.where(live, l_ * alpha + pexp.sum(-1, keepdim=True), l_)
        acc = torch.where(live, acc * alpha + torch.matmul(pexp, vp), acc)
        m = torch.where(live, m_new, m)
    m_all = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - m_all)
    l_all = (l_ * w).sum(2)
    out = (acc * w).sum(2) / l_all
    if return_stats:
        return out, m_all[:, :, 0, :, 0], l_all[..., 0]
    return out


# --------------------------------------------------------------- wrapper --

def kv_decode_attention(q: torch.Tensor, kq: QuantizedKV, vq: QuantizedKV,
                        lengths: torch.Tensor, *, page: int = PAGE,
                        cap: int = CAP,
                        pages_per_split: int | None = None,
                        return_stats: bool = False):
    """q: float32 [B, G, Hg, D]; kq, vq: QuantizedKV with bins [B, G, S, D];
    lengths: int32 [B].  Returns float32 [B, G, Hg, D], and with
    return_stats also the merged (m, l), float32 [B, G, Hg] each.  The CUDA
    kernel takes D in {80, 128}, page = 128, Hg <= 16 and cap <= 64, and
    raises otherwise.
    `pages_per_split` (default: `default_pages_per_split` of the shapes and
    the SM count) sets the pages each split block takes; the result does
    not depend on it beyond the order of the sums.  Makes no host sync."""
    _check(q, kq, vq, lengths, page, cap)
    n_all = kq.bins.shape[2] // page
    pps = _resolve_pages_per_split(q, n_all, pages_per_split)
    if q.device.type == "cpu":
        return _kv_decode_attention_plain(q, kq, vq, lengths, page=page,
                                          pages_per_split=pps,
                                          return_stats=return_stats)
    b, g, hg, d = q.shape
    if (d not in HEAD_DIMS or page != KERNEL_PAGE or not 1 <= hg <= MAX_HG
            or cap > MAX_CAP):
        raise NotImplementedError(
            f"the CUDA kernel takes D in {HEAD_DIMS}, page = {KERNEL_PAGE}, "
            f"1 <= Hg <= {MAX_HG} and cap <= {MAX_CAP}, got D={d}, "
            f"page={page}, Hg={hg}, cap={cap}")
    ops = [t.contiguous() for t in (q, lengths, *kq[:4], *vq[:4])]
    if any(t.data_ptr() % 16 for t in (ops[2], ops[6])):
        raise ValueError("the bins planes must be 16-byte aligned")
    out = torch.empty((b, g, hg, d), dtype=torch.float32, device=q.device)
    nsplit = -(-n_all // pps)
    parts = b * g * nsplit * hg
    ws = torch.empty(parts * (2 + d), dtype=torch.float32, device=q.device)
    stats = (torch.empty((2, b, g, hg), dtype=torch.float32, device=q.device)
             if return_stats else None)
    _launch(LAUNCHES, "_kv_decode_attention", "repro_kv_decode_attention",
            q.device, *(t.data_ptr() for t in ops), out.data_ptr(),
            ws.data_ptr(), ws[parts:].data_ptr(), ws[2 * parts:].data_ptr(),
            stats[0].data_ptr() if return_stats else None,
            stats[1].data_ptr() if return_stats else None,
            b, g, hg, kq.bins.shape[2], d, page, cap, pps, softmax_scale(d))
    return (out, stats[0], stats[1]) if return_stats else out

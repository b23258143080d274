"""Host-side byte-stream serializer, the LC-style on-disk and archival
format (counterpart of `repro.core.serializer`; numpy and zlib over the
port's copy of the oracle, `core.oracle_np`, so its streams are the
reference's byte for byte).

Unlike the device codec (static shapes), this is true variable-length
encoding: outliers are stored INLINE with the bin numbers via an escape
code (+maxbin, which the quantizer's range check keeps out of the valid
bin range), the paper's §3.1 design point vs SZ3's separate outlier
list.  A final lossless stage (zlib, standing in for LC's lossless
components) compresses the packed stream.

zlib here is the host/archival coder (highest ratio, byte-stream output)
used for checkpoints and offline storage; the device/wire coder is the
chunked zero/narrow scheme of the pipeline's word stages.
`compression_ratio` reports either side (wire=).

Layout (little-endian):
  u32 magic | u8 mode | u8 dtype | u8 bin_bits | u8 flags
  u64 n | u64 eb_bits (exact target-dtype bits of eb, zero-extended)
  zlib( bins[n] as i{bin_bits} with +maxbin escapes
        | payload bits for each escape, in index order
        | sign plane (REL only, packbits) )

Decode recomputes recon with the same expressions as the device decoder
(numpy, IEEE ops only).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from . import oracle_np as onp
from .config import QuantizerConfig
from .pipeline import (ChunkStage, PackStage, Pipeline, QuantStage,
                       parse_pipeline, resolve_device)

_MAGIC = 0x4C43_4542  # 'LCEB'
_MODES = {"abs": 0, "rel": 1, "noa": 2}
_MODES_INV = {v: k for k, v in _MODES.items()}
_DTYPES = {"float32": 0, "float64": 1}
_DTYPES_INV = {0: "float32", 1: "float64"}
_BIN_NP = {8: np.int8, 16: np.int16, 32: np.int32}


def _eb_bits(eb: float, dtype: np.dtype) -> int:
    if dtype == np.float32:
        return int(np.float32(eb).view(np.uint32))
    return int(np.float64(eb).view(np.uint64))


def _eb_from_bits(bits: int, dtype: np.dtype) -> np.floating:
    if dtype == np.float32:
        return np.uint32(bits).view(np.float32)
    return np.uint64(bits).view(np.float64)


def serialize(x: np.ndarray, cfg: QuantizerConfig, level: int = 6) -> bytes:
    """Full LC-style pipeline on the host: quantize (numpy oracle, bit-
    identical to the device quantizer) -> pack with inline outliers ->
    lossless stage."""
    flat = np.ascontiguousarray(x).reshape(-1)
    dt = flat.dtype
    if cfg.mode == "abs":
        bins, outlier, _ = onp.quantize_abs(flat, cfg)
        sign = None
        eb = cfg.np_dtype.type(cfg.error_bound)
    elif cfg.mode == "rel":
        bins, outlier, _, sign = onp.quantize_rel(flat, cfg)
        eb = cfg.np_dtype.type(cfg.error_bound)
    else:  # noa
        bins, outlier, _, eb = onp.quantize_noa(flat, cfg)
        sign = None

    maxbin = cfg.maxbin
    stored = bins.astype(np.int64)
    stored[outlier] = maxbin                       # inline escape code
    packed = stored.astype(_BIN_NP[cfg.bin_bits]).tobytes()

    bits_t = np.uint32 if dt == np.float32 else np.uint64
    payload = flat[outlier].view(bits_t).tobytes()  # bit-exact, index order
    body = packed + payload
    flags = 0
    if sign is not None:
        body += np.packbits(sign.astype(np.uint8)).tobytes()
        flags |= 1

    header = struct.pack(
        "<IBBBBQQ", _MAGIC, _MODES[cfg.mode], _DTYPES[str(dt)], cfg.bin_bits,
        flags, flat.size, _eb_bits(float(eb), dt))
    return header + zlib.compress(body, level)


def deserialize(stream: bytes) -> tuple[np.ndarray, QuantizerConfig]:
    magic, mode_i, dt_i, bin_bits, flags, n, ebb = struct.unpack(
        "<IBBBBQQ", stream[:24])
    if magic != _MAGIC:
        raise ValueError("bad magic")
    mode = _MODES_INV[mode_i]
    dtype = np.dtype(_DTYPES_INV[dt_i])
    eb = _eb_from_bits(ebb, dtype)
    # NOA's effective eb can be degenerate (all-outlier stream, eb == 0);
    # the config object still needs a valid bound, the decode below uses
    # the header eb directly.
    cfg_eb = float(eb) if float(eb) > 0 else 1.0
    cfg = QuantizerConfig(mode=mode, error_bound=cfg_eb, bin_bits=bin_bits,
                          dtype=str(dtype))
    body = zlib.decompress(stream[24:])

    bin_np = _BIN_NP[bin_bits]
    bins = np.frombuffer(body[: n * bin_np().itemsize], bin_np).astype(np.int64)
    off = n * bin_np().itemsize
    outlier = bins == cfg.maxbin
    n_out = int(outlier.sum())
    bits_t = np.uint32 if dtype == np.float32 else np.uint64
    payload = np.frombuffer(body[off: off + n_out * bits_t().itemsize], bits_t)
    off += n_out * bits_t().itemsize
    sign = None
    if flags & 1:
        nbytes = (n + 7) // 8
        sign = np.unpackbits(
            np.frombuffer(body[off: off + nbytes], np.uint8))[:n].astype(bool)

    bins_clean = np.where(outlier, 0, bins).astype(np.int32)
    if mode == "rel":
        out = onp.dequantize_rel(bins_clean, sign, cfg)
    else:
        # NOA stored its effective eb in the header, so decode is plain ABS.
        out = onp.dequantize_abs(bins_clean, cfg, eb=eb)
    out = out.copy()
    out[outlier] = payload.view(dtype)             # bit-exact restore
    return out, cfg


def _device_pipeline(cfg: QuantizerConfig, pipeline):
    """Resolve the device-wire pipeline: an explicit spec/Pipeline wins;
    otherwise cfg maps onto its default chain, quantize|pack|narrow."""
    if pipeline is not None:
        return parse_pipeline(pipeline)
    return Pipeline(QuantStage(cfg.mode, cfg.error_bound,
                               cfg.outlier_cap_frac, cfg.dtype),
                    PackStage(cfg.bin_bits), (ChunkStage("narrow"),))


def compression_ratio(x: np.ndarray, cfg: QuantizerConfig, level: int = 6,
                      stream: bytes | None = None, wire: str = "host",
                      pipeline=None, per_stage: bool = False,
                      pred_shape=None, *, device="cuda"):
    """Compression ratio of x under cfg.

    wire='host'   — this module's zlib byte stream (archival coder).
    wire='device' — the device wire format: the compression pipeline's
                    `Encoded` container, run on `device` (the card unless
                    the caller passes device="cpu"), counting the
                    transmitted bits via `Pipeline.wire_bits`, the
                    accessor the gathered wire is measured with.
                    `pipeline` (spec string or Pipeline) selects the
                    chain; default is cfg's quantizer + pack + 'narrow'.
    wire='both'   — (host, device) tuple, for comparable benchmark rows.
    per_stage     — with a device wire, report [(stage_spec, ratio)] per
                    chain prefix instead of one number (Pipeline
                    .stage_report), so any chain's ratio decomposes.
    pred_shape    — value-domain shape for pred-bearing chains; defaults
                    to x.shape, so a 2-D array reaches `lorenzo` as its
                    plane even though the wire is flat.
    """
    if wire not in ("host", "device", "both"):
        raise ValueError(f"wire must be host|device|both, got {wire!r}")
    host = dev_ratio = None
    if wire in ("host", "both"):
        if stream is None:
            stream = serialize(x, cfg, level)
        host = x.nbytes / len(stream)
    if wire in ("device", "both"):
        dev = resolve_device(device)
        pipe = _device_pipeline(cfg, pipeline)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if pred_shape is None:
            pred_shape = tuple(x.shape)
        if per_stage:
            rows = pipe.stage_report(xt, pred_shape=pred_shape, device=dev)
            dev_ratio = [(label, x.nbytes * 8 / float(bits))
                         for label, bits in rows[1:]]
        else:
            enc = pipe.encode(xt, pred_shape=pred_shape, device=dev)
            dev_ratio = x.nbytes / (float(pipe.wire_bits(enc, x.size)) / 8)
    if wire == "host":
        return host
    if wire == "device":
        return dev_ratio
    return host, dev_ratio

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--n N] [--seed S]

Builds the four CUDA kernels of `src/repro_torch/kernels/csrc/pack.cu` from
source, then runs three chains through `repro_torch.core.pipeline`
(`Pipeline.encode` -> `Encoded` -> `Pipeline.decode`) at n = 512**3 float32
values (the size of one SDRBench NYX field), with data made on the card from
`--seed`:

  * `rel:0.001|pack:16` on a NYX-like lognormal field, exp(1.4*N(0,1) + 8);
  * `noa:0.001|pack:16` on the same field;
  * `grad-wire-8` (`abs:1.0:cap=0.015625|pack:8`) on a gradient-like field,
    iid N(0,1)*3e-3, with a per-tensor bound eb = 2**-5 * rms(g) computed on
    the card and passed as a 0-d CUDA tensor.

The first 64 values of each field are the paper's eight special values
(+inf, -inf, NaN, the NaN payload 0x7FC00123, +-1e-42, +-0.0), repeated.

For each chain it checks that the kernels were launched on the main path,
that every wire plane and every decoded float is bit-equal to the plain
torch reference run on the card, that each kernel is bit-equal to its plain
version, that a small ragged input agrees with the numpy oracle, and that
every decoded value is within eb of its original or bit-identical to it
(checked in float64).  It times each kernel with CUDA events (median of 25
after warm-up) beside its bound and its plain version (which repeats the
kernel's arithmetic and is no yardstick of speed).

Output: the card's name and power limit, one JSON line per chain, one JSON
line {"kernels": [...]}, and last {"ok": true, "device": {...}}.  Any failed
check exits non-zero; with no CUDA device, or outside a checkout, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
N_DEFAULT = 512 ** 3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SPECIALS = np.array([np.inf, -np.inf, np.nan,
                     np.uint32(0x7FC00123).view(np.float32),
                     1e-42, -1e-42, 0.0, -0.0], dtype=np.float32)
SOURCE = "src/repro_torch/kernels/csrc/pack.cu"
REPLACES = {"_abs_pack": "src/repro/kernels/pack.py:141",
            "_rel_pack": "src/repro/kernels/pack.py:152",
            "_abs_unpack": "src/repro/kernels/pack.py:168",
            "_rel_unpack": "src/repro/kernels/pack.py:180"}
# float32 operations per element, counted in csrc/pack.cu (arithmetic,
# rounding, conversions, abs and compares): abs_quantize 2 mul, rint, sub,
# 2 conversions, 2 abs, 2 compares; rel_quantize the same plus log2approx
# (add, conversion) and pow2approx (add, sub, 2 conversions) and the
# screen/tiny compares; the ABS unpack a conversion and a mul; the REL
# unpack a conversion, a mul and pow2approx.  The bound is set by bytes
# whenever these are far under the card's float32 rate over its HBM rate.
OPS_PER_ELEM = {"_abs_pack": 10, "_rel_pack": 16, "_abs_unpack": 2,
                "_rel_unpack": 6}


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median time of one call of fn on the card, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_fields(n: int, seed: int):
    """(nyx, grad) float32 fields on the card, specials in the first 64."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nyx = torch.exp(torch.randn(n, generator=gen, device=DEV) * 1.4 + 8.0)
    grad = torch.randn(n, generator=gen, device=DEV) * 3e-3
    spec = torch.from_numpy(np.tile(SPECIALS, 8).view(np.int32)).to(DEV)
    m = min(n, spec.numel())
    for f in (nyx, grad):
        f.view(torch.int32)[:m] = spec[:m]
    return nyx, grad


def planes_equal(a, b) -> bool:
    """Bit equality of two wire planes (None matches None)."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def violations(x, y, eb64: float, rel: bool) -> int:
    """Values neither bit-identical to their original nor within eb (REL:
    eb*|x|), counted in float64 on the card."""
    same = x.view(torch.int32) == y.view(torch.int32)
    x64, y64 = x.double(), y.double()
    bound = eb64 * x64.abs() if rel else torch.full_like(x64, eb64)
    within = torch.isfinite(x64) & ((x64 - y64).abs() <= bound)
    return int((~(same | within)).sum())


def kernel_bytes(name: str, n: int, bits: int) -> int:
    """Least bytes: each input read once, each output written once."""
    from repro_torch.core.codec import packed_word_count
    words = 4 * packed_word_count(n, bits)
    signs = 4 * packed_word_count(n, 1)
    return {"_abs_pack": 4 * n + 4 + words + n,
            "_rel_pack": 4 * n + words + n + signs,
            "_abs_unpack": words + 4 + 4 * n,
            "_rel_unpack": words + signs + 4 * n}[name]


def bound_of(name: str, n: int, bits: int):
    t_bytes = kernel_bytes(name, n, bits) / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM[name] * n / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a, b) -> float:
    """Largest difference between a kernel's output and its plain
    version's: float planes as values (NaN matching NaN), int planes as
    uint32, bool planes as 0/1."""
    if a.dtype.is_floating_point:
        a64, b64 = a.double(), b.double()
        both_nan = torch.isnan(a64) & torch.isnan(b64)
        d = torch.where(both_nan, torch.zeros_like(a64), (a64 - b64).abs())
        d = torch.nan_to_num(d, nan=float("inf"))
    else:
        d = ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs()
    return float(d.max()) if d.numel() else 0.0


def kernel_calls(name: str, pipe, enc, x, eb_arr, n: int):
    """(kernel call, plain call) on the main path's inputs of one kernel."""
    from repro_torch.kernels import pack as K
    cfg = pipe.qcfg()
    return {
        "_abs_pack": (lambda: K.abs_pack(x, eb_arr, cfg),
                      lambda: K._abs_pack_plain(x, eb_arr, cfg)),
        "_rel_pack": (lambda: K.rel_pack(x, cfg),
                      lambda: K._rel_pack_plain(x, cfg)),
        "_abs_unpack": (lambda: K.abs_unpack(enc.payload, eb_arr, n, cfg),
                        lambda: K._abs_unpack_plain(enc.payload, eb_arr, n, cfg)),
        "_rel_unpack": (lambda: K.rel_unpack(enc.payload, enc.sign_words, n, cfg),
                        lambda: K._rel_unpack_plain(enc.payload, enc.sign_words,
                                                    n, cfg)),
    }[name]


def oracle_check(pipe, x, eb) -> None:
    """A small ragged slice through the kernels against the numpy oracle."""
    from repro_torch.core import codec as C
    from repro_torch.core import oracle_np
    cfg = pipe.qcfg()
    xs = x[:4099].contiguous()
    enc = pipe.encode(xs, eb, device=DEV)
    bins = C.unpack_words(enc.payload.cpu(), xs.numel(), cfg.bin_bits).numpy()
    xn = xs.cpu().numpy()
    if cfg.mode == "rel":
        ob, oo, _, osign = oracle_np.quantize_rel(xn, cfg)
        sign = C.unpack_flags(enc.sign_words.cpu(), xs.numel()).numpy()
        check(np.array_equal(sign, osign), "oracle: REL sign plane")
    elif cfg.mode == "noa":
        ob, oo, _, oeb = oracle_np.quantize_noa(xn, cfg)
        check(np.float32(oeb).view(np.uint32)
              == enc.eb.cpu().numpy().view(np.uint32), "oracle: NOA eb")
    else:
        ob, oo, _ = oracle_np.quantize_abs(xn, cfg, eb=np.float32(eb.item()))
    check(np.array_equal(bins, ob), f"oracle: bins of {pipe.spec()}")
    m, k = xs.numel(), cfg.outlier_cap(xs.numel())
    want = np.full(k, m, np.int32)
    first = np.nonzero(oo)[0][:k]
    want[:first.size] = first
    check(np.array_equal(enc.out_idx.cpu().numpy(), want),
          f"oracle: outlier table of {pipe.spec()}")


def run_chain(label: str, spec: str, x, eb, rel: bool, kernels: tuple):
    from repro_torch.core.pipeline import parse_pipeline
    from repro_torch.kernels import pack as K
    pipe = parse_pipeline(spec)
    n = x.numel()
    # warm-up (builds the library on first use), then the counted run
    pipe.decode(pipe.encode(x, eb, device=DEV), n=n, device=DEV)
    torch.cuda.synchronize()
    K.reset_launches()
    enc = pipe.encode(x, eb, device=DEV)
    y = pipe.decode(enc, n=n, device=DEV)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for name in kernels:
        check(launches[name] > 0, f"{label}: {name} not launched on the main path")

    ref = pipe.encode(x, eb, device=DEV, kernels=False)
    y_ref = pipe.decode(ref, n=n, device=DEV, kernels=False)
    for f in enc._fields:
        if f != "headers":
            check(planes_equal(getattr(enc, f), getattr(ref, f)),
                  f"{label}: wire plane {f} differs from the plain reference")
    check(planes_equal(y, y_ref), f"{label}: decoded floats differ")
    check(not bool(enc.overflow), f"{label}: outlier table overflowed")
    cfg = pipe.qcfg()
    eb_used = enc.eb if enc.eb is not None else torch.tensor(cfg.error_bound)
    eb64 = float(eb_used.float().item())
    bad = violations(x, y, eb64, rel)
    check(bad == 0, f"{label}: {bad} values violate the bound")
    oracle_check(pipe, x, eb)

    eb_arr = eb_used.to(device=DEV, dtype=torch.float32).reshape(1)
    rows = []
    for name in kernels:
        kern, plain = kernel_calls(name, pipe, enc, x, eb_arr, n)
        outs_k, outs_p = kern(), plain()
        outs_k = outs_k if isinstance(outs_k, tuple) else (outs_k,)
        outs_p = outs_p if isinstance(outs_p, tuple) else (outs_p,)
        match = all(planes_equal(a, b) for a, b in zip(outs_k, outs_p))
        err = max(max_abs_err(a, b) for a, b in zip(outs_k, outs_p))
        check(match, f"{label}: {name} differs from its plain version")
        bound_ms, bound_by = bound_of(name, n, cfg.bin_bits)
        ms = time_ms(kern)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "chain": label,
            "bits": cfg.bin_bits, "launches": launches[name],
            "max_abs_err": err, "tolerance": 0.0, "match": match,
            "ms": ms, "plain_ms": time_ms(plain, reps=20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": None,
            "bytes": kernel_bytes(name, n, cfg.bin_bits)})

    # where the end-to-end time goes: the kernels and the torch ops around
    # them (NOA's range reduction, the outlier table, the decode scatter)
    from repro_torch.core import codec as C
    from repro_torch.core import quantizer as Q
    outlier = K.abs_pack(x, eb_arr, cfg)[1] if not rel else K.rel_pack(x, cfg)[1]
    buf = torch.empty(n + 1, device=DEV)
    parts = {
        "encode_kernel": rows[0]["ms"],
        "value_range": (time_ms(lambda: Q.value_range_eb(x, cfg))
                        if cfg.mode == "noa" else 0.0),
        "outlier_table": time_ms(lambda: C.outlier_table(
            x, outlier, cfg.outlier_cap(n))),
        "decode_kernel": rows[1]["ms"],
        "scatter": time_ms(lambda: C.scatter_outliers_(
            buf, n, enc.out_idx, enc.out_payload)),
    }
    enc_ms = time_ms(lambda: pipe.encode(x, eb, device=DEV), reps=10, warm=2)
    dec_ms = time_ms(lambda: pipe.decode(enc, n=n, device=DEV), reps=10, warm=2)
    print(json.dumps({
        "chain": label, "spec": pipe.spec(), "n": n,
        "ratio": 32 * n / pipe.wire_bits(enc, n),
        "wire_bytes": pipe.wire_bytes(enc, n),
        "n_outliers": int(enc.n_outliers), "overflow": bool(enc.overflow),
        "eb": eb64, "violations": bad,
        "encode_ms": enc_ms, "decode_ms": dec_ms,
        "encode_GBps": 4 * n / enc_ms / 1e6, "decode_GBps": 4 * n / dec_ms / 1e6,
        "parts_ms": parts,
        "launches": {k: launches[k] for k in kernels}}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N_DEFAULT,
                    help="values per field (default 512**3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_pipeline
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.time()
    lib = _build.build()
    print(f"chip_smoke: built {lib.name} in {time.time() - t0:.1f} s",
          file=sys.stderr)
    print(lib.with_suffix(".log").read_text(), file=sys.stderr)

    nyx, grad = make_fields(args.n, args.seed)
    finite = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
    eb_grad = 2.0 ** -5 * torch.sqrt(torch.mean(finite * finite))   # 0-d, on card
    rows = []
    rows += run_chain("rel", "rel:0.001|pack:16", nyx, None, True,
                      ("_rel_pack", "_rel_unpack"))
    rows += run_chain("noa", "noa:0.001|pack:16", nyx, None, False,
                      ("_abs_pack", "_abs_unpack"))
    rows += run_chain("grad-wire-8", get_pipeline("grad-wire-8"), grad,
                      eb_grad, False, ("_abs_pack", "_abs_unpack"))
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"chip_smoke: {time.time() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the port's CUDA kernels: `nvcc` into a shared library with
a plain C interface, loaded with ctypes.

The sources (`csrc/pack.cu`, `csrc/lossless.cu` and `csrc/dense.cu`, which
include `csrc/quantize.cuh`, `lossless.cu` also `csrc/chunk.cuh`, and
`csrc/kv_attention.cu`) are compiled in
parallel, one `nvcc` each, and linked into one library at first use, in
`build/repro_torch/` at the root of the checkout (listed in `.gitignore`).  The library is named by a hash of the
sources, the header and the flags, so an edited source rebuilds and an
unchanged one loads at once.  The flags keep the paper's bit-exactness
rules: `-fmad=false` (no multiply-add contraction) and no
`--use_fast_math` (which would flush denormals, approximate divisions and
may fold away `isfinite`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "pack.cu", CSRC / "lossless.cu", CSRC / "dense.cu",
           CSRC / "kv_attention.cu")
HEADERS = (CSRC / "quantize.cuh", CSRC / "chunk.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-fmad=false", "-std=c++17", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of csrc/*.cu (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "repro_abs_pack": [_P, _LL, _P, _I, _I, _F, _F, _P, _LL, _P, _P],
    "repro_rel_pack": [_P, _LL, _I, _I, _F, _F, _F, _F, _F, _P, _LL, _P, _P,
                       _P],
    "repro_abs_unpack": [_P, _LL, _P, _I, _F, _P, _LL, _P],
    "repro_rel_unpack": [_P, _LL, _P, _I, _F, _P, _LL, _P],
    "repro_abs_pack_lc": [_P, _LL, _P, _I, _I, _F, _F, _I, _LL, _P, _P, _P,
                          _P],
    "repro_rel_pack_lc": [_P, _LL, _I, _I, _F, _F, _F, _F, _F, _I, _LL, _P,
                          _P, _P, _P, _P],
    "repro_lc_select": [_P, _LL, _P, _LL, _LL, _I, _P, _P, _P, _P],
    "repro_lc_expand": [_P, _LL, _P, _LL, _LL, _LL, _LL, _P, _P, _P],
    "repro_dense_quantize_abs": [_P, _LL, _P, _I, _F, _F, _P, _P, _P, _P],
    "repro_dense_quantize_rel": [_P, _LL, _I, _F, _F, _F, _F, _F, _P, _P,
                                 _P, _P, _P],
    "repro_dense_dequantize_abs": [_P, _P, _P, _P, _F, _P, _LL, _P],
    "repro_dense_dequantize_rel": [_P, _P, _P, _P, _F, _P, _LL, _P],
    "repro_kv_decode_attention": [_P] * 16 + [_I] * 8 + [_F, _P],
    "repro_kv_decode_occupancy": [_I, _I, _P, _P],
}

_LIB: ctypes.CDLL | None = None
_LOAD_LOCK = threading.Lock()   # ranks on threads must not race the build


def nvcc_path() -> str:
    """`nvcc` from PATH, else from the CUDA toolkit torch finds (CUDA_HOME)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME as home
    if not home or not (Path(home) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return str(Path(home) / "bin" / "nvcc")


def build() -> Path:
    """Compile and link csrc/*.cu (once per source and flag set); returns
    the library's path.  The compiler's output, register counts included,
    is kept beside it as <lib>.log."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in SOURCES + HEADERS:
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"repro_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        out = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(out),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log = "".join(f"== {src.name}\n{text}"
                      for src, text in zip(SOURCES, logs))
        lib.with_suffix(".log").write_text(f"{log}== link\n{link.stdout}")
        failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode]
        if failed or link.returncode:
            raise RuntimeError(f"nvcc failed on {failed or 'the link'}:\n"
                               f"{log}{link.stdout}")
        os.replace(out, lib)          # atomic: concurrent builders agree
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_lc_scratch_words.argtypes = [_LL]
            lib.repro_lc_scratch_words.restype = _LL
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")

"""Build and load the port's CUDA kernels: `nvcc` into a shared library with
a plain C interface, loaded with ctypes.

The library is built at first use into `build/repro_torch/` at the root of
the checkout (listed in `.gitignore`), named by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads at once.
The flags keep the paper's bit-exactness rules: `-fmad=false` (no
multiply-add contraction) and no `--use_fast_math` (which would flush
denormals, approximate divisions and may fold away `isfinite`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of csrc/pack.cu (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "repro_abs_pack": [_P, _LL, _P, _I, _I, _F, _F, _P, _LL, _P, _P],
    "repro_rel_pack": [_P, _LL, _I, _I, _F, _F, _F, _F, _F, _P, _LL, _P, _P,
                       _P],
    "repro_abs_unpack": [_P, _LL, _P, _I, _F, _P, _LL, _P],
    "repro_rel_unpack": [_P, _LL, _P, _I, _F, _P, _LL, _P],
}

_LIB: ctypes.CDLL | None = None


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
    """Compile csrc/pack.cu (once per source and flag set); returns the
    library's path.  The compiler's output, register counts included, is
    kept beside it as <lib>.log."""
    src = SOURCE
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)          # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")

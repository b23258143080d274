"""The exact forms that the pack kernel (csrc/pack.cu, B1 and B3) uses at
pack:8 and pack:16 in place of conversion instructions, held against the
instructions they replace over each form's whole domain.

Both instruction sequences are emulated in numpy float32, which rounds
every operation to nearest even, as the kernel's `_rn` intrinsics and its
`-fmad=false` build do; CUDA's conversions are emulated with their
semantics (`__float2int_rz` truncates, saturates and gives 0 for NaN).
The forms:

  (a) log2approx's `__int2float_rn(expo - 128)`, expo in [0, 255], as
      float((bits >> 23) + 0x4B000000) - (2^23 + 128), for the values the
      quantizer passes it (sign bit clear);
  (c) `rintf(y)` and `__float2int_rz` of it as r = (y + 1.5*2^23) -
      1.5*2^23 and i = bits(y + 1.5*2^23) - bits(1.5*2^23), for |y| < 2^22;
      beyond, |r| >= 2^22, so every bin the range test passes is exact;
  (b) the float of the bin, `__int2float_rn(range_bad ? 0 : bin)`, as
      range_bad ? 0.0f : r;
  (e) REL's check |x - recon|, recon = x's sign on mag, as |(|x|) - mag|;
  and the two preconditions that keep y finite: REL's 1/log_step clamped
  to FLT_MAX, ABS's eb at or above float32's floor.

Last, the kernel's whole ABS and REL sequences against the plain
quantizers of `repro_torch.core.quantizer` for the bounds of
`configs/registry.py`'s presets and 1e-2, 1e-3 and 1e-5.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quantizer as JQ
from repro.core.config import QuantizerConfig as JCfg
from repro_torch.configs.registry import PIPELINES
from repro_torch.core import codec as TC
from repro_torch.core import quantizer as TQ
from repro_torch.core.config import QuantizerConfig
from repro_torch.kernels import _build
from repro_torch.kernels import pack as TK
from test_torch_cuda import _pack_edges

F32, I32, U32 = np.float32, np.int32, np.uint32
MAGIC = F32(12582912.0)            # 1.5 * 2^23
MAGIC_BITS = 0x4B400000
FLT_MAX = np.finfo(F32).max
HOST = Path(__file__).resolve().parent / "cuda_host"
CSRC = Path(TK.__file__).resolve().parent / "csrc"
EBS = sorted({float(m) for spec in PIPELINES.values()
              for m in re.findall(r"(?:abs|rel|noa):([0-9.e+-]+)", spec)}
             | {1e-2, 1e-3, 1e-5})


def bits(a):
    return np.asarray(a, F32).view(U32)


def f2i_rz(a):
    """`__float2int_rz`: toward zero, saturating, 0 for NaN."""
    a = np.asarray(a, F32)
    out = np.zeros(a.shape, I32)
    inside = np.isfinite(a) & (np.abs(a) < F32(2.0 ** 31))
    out[inside] = np.trunc(a[inside]).astype(I32)
    out[a >= F32(2.0 ** 31)] = np.iinfo(I32).max
    out[a <= F32(-2.0 ** 31)] = np.iinfo(I32).min
    return out


def rint_old(y):
    """rintf and the bin's int: FRND then F2I.TRUNC."""
    r = np.rint(y).astype(F32)
    return r, f2i_rz(r)


def rint_magic(y):
    s = (np.asarray(y, F32) + MAGIC).astype(F32)
    i = (s.view(I32).astype(np.int64) - MAGIC_BITS).astype(I32)
    return (s - MAGIC).astype(F32), i


def neighbours(v, k=3):
    """v and the k floats on each side of it, by bit pattern."""
    v = np.asarray(v, F32)
    out = [v]
    up = down = v
    for _ in range(k):
        up = np.nextafter(up, F32(np.inf))
        down = np.nextafter(down, F32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


def bin_edges():
    """Every integer bin in +-2^15, the ties k +- 0.5 beside it, and three
    floats on each side of each, by bit pattern."""
    k = np.arange(-2 ** 15, 2 ** 15 + 1).astype(F32)
    return np.concatenate([neighbours(k), neighbours(k - F32(0.5)),
                           neighbours(k + F32(0.5))])


def binade(e, sign):
    """Every float32 y with 2^e <= |y| < 2^(e+1), of one sign."""
    lo = int(bits(F32(2.0 ** e)))
    y = np.arange(lo, lo + 2 ** 23, dtype=np.int64).astype(U32).view(F32)
    return y if sign > 0 else -y


# ------------------------------------------------------------------ (a) --

def log2approx_old(x):
    b = np.asarray(x, F32).view(I32)
    expo = (b >> 23) & 0xFF
    frac = ((127 << 23) | (b & 0x7FFFFF)).astype(I32).view(F32)
    return (frac + (expo - 128).astype(F32)).astype(F32)


def log2approx_new(x):
    """For x with its sign bit clear (|x| or 1 in the quantizer)."""
    b = np.asarray(x, F32).view(U32)
    expo_f = ((b >> U32(23)) + U32(0x4B000000)).astype(U32).view(F32)
    frac = ((b & U32(0x7FFFFF)) | U32(127 << 23)).astype(U32).view(F32)
    return (frac + (expo_f - F32(8388736.0)).astype(F32)).astype(F32)


def every_exponent(step):
    """All 256 exponents with the sign bit clear, each with every step-th
    mantissa and the mantissa's ends."""
    mant = np.unique(np.r_[np.arange(0, 2 ** 23, step), 1, 2 ** 23 - 1])
    expo = np.arange(256, dtype=np.int64)
    return ((expo[:, None] << 23) | mant[None, :]).astype(U32).view(F32).ravel()


def test_exponent_form_every_exponent():
    """(a): float(expo + 0x4B000000) - (2^23 + 128) is expo - 128 as
    `__int2float_rn` gives it, bit for bit (+0.0 at 128), for all 256."""
    expo = np.arange(256, dtype=U32)
    new = ((expo + U32(0x4B000000)).view(F32) - F32(8388736.0)).astype(F32)
    assert np.array_equal(bits(new), bits((expo.astype(I32) - 128)
                                          .astype(F32)))


def test_log2approx_form_every_exponent_and_mantissa_sample():
    """(a) inside log2approx, for every exponent (every 131st mantissa)."""
    x = every_exponent(131)
    assert np.array_equal(bits(log2approx_new(x)), bits(log2approx_old(x)))


# ------------------------------------------------------------------ (c) --

def _check_rint(y):
    r_old, i_old = rint_old(y)
    r, i = rint_magic(y)
    assert np.array_equal(r, r_old)                 # values: -0.0 == +0.0
    assert not np.any(bits(r) == U32(0x80000000))   # r is never -0.0
    assert np.array_equal(i, i_old)


def test_rint_form_every_bin_and_its_edges():
    """(c) on every integer bin in +-2^15, the ties beside it and three
    floats on each side of each tie and bin."""
    _check_rint(bin_edges())


@pytest.mark.parametrize("e", [-24, -1, 0, 14, 21])
@pytest.mark.parametrize("sign", [1, -1])
def test_rint_form_every_float_of_a_binade(e, sign):
    """(c) on every float32 of the binades [2^e, 2^(e+1)): where the ties
    are densest (0.5-2), where pack:16 bins end (2^14-2^15), the last
    binade of the form's domain (2^21-2^22), and values that round to
    0."""
    _check_rint(binade(e, sign))


def test_rint_form_out_of_its_domain_is_out_of_range():
    """For |y| >= 2^22 (and +-inf) |r| >= 2^22, above every pack:8 and
    pack:16 maxbin, as |rint(y)| is: such a y is range_bad either way."""
    edges = [2.0 ** 22, 2.0 ** 22 + 0.5, 2.0 ** 23, 1.5 * 2.0 ** 23,
             2.0 ** 24, 2.0 ** 24 + 2, 2.0 ** 31, 2.0 ** 40, 3e38]
    y = neighbours(np.array(edges, F32), k=8)
    y = np.concatenate([y[np.abs(y) >= F32(2.0 ** 22)],
                        binade(22, 1)[::97], binade(23, -1)[::89]])
    y = np.concatenate([y, -y, [np.inf, -np.inf]]).astype(F32)
    with np.errstate(invalid="ignore"):
        r, _ = rint_magic(y)
    assert np.all(np.abs(r) >= F32(2.0 ** 22))
    assert np.all(np.abs(np.rint(y)) >= F32(2.0 ** 22))


# ------------------------------------------------------------------ (b) --

def front_old(y, maxbin):
    """range_bad, the bin and the float of the bin, as quantize.cuh."""
    r, i = rint_old(y)
    range_bad = np.abs(r) >= F32(maxbin)
    b = np.where(range_bad, 0, i).astype(I32)
    return range_bad, b, b.astype(F32)


def front_new(y, maxbin):
    r, i = rint_magic(y)
    range_bad = np.abs(r) >= F32(maxbin)
    return (range_bad, np.where(range_bad, 0, i).astype(I32),
            np.where(range_bad, F32(0.0), r).astype(F32))


@pytest.mark.parametrize("maxbin", [127, 32767])
def test_bin_float_form_every_bin(maxbin):
    """(b): range_bad ? 0.0f : r has the bits of `__int2float_rn` of the
    bin, and the range test and the bin agree, on every bin in +-2^15 and
    its edges, on a binade, and out of (c)'s domain.  No bin that passes
    the range test reaches +-maxbin, so the kernel drops the integer
    range test."""
    y = np.concatenate([bin_edges(), binade(14, -1)[::7],
                        np.array([2.0 ** 22, -2.0 ** 30, np.inf, -np.inf],
                                 F32)])
    with np.errstate(invalid="ignore"):
        old, new = front_old(y, maxbin), front_new(y, maxbin)
    assert np.array_equal(old[0], new[0])
    assert np.array_equal(old[1], new[1])
    assert np.array_equal(bits(old[2]), bits(new[2]))
    assert np.all(np.abs(new[1][~new[0]]) < maxbin)


# ------------------------------------------------------------------ (e) --

def test_rel_check_form_reads_the_same_difference():
    """(e): |x - (neg ? -mag : mag)| and |(|x|) - mag| have the same bits
    for every finite x (both signs, every exponent, sampled mantissas)
    against mags of the same and of neighbouring values, and the specials
    pow2approx can give (+-inf, NaN, -0.0, denormals)."""
    ax = every_exponent(4099)
    ax = ax[np.isfinite(ax)]
    specials = np.array([np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-42, -3e38],
                        F32)
    with np.errstate(over="ignore"):
        mags = [ax, np.nextafter(ax, F32(np.inf)), ax * F32(1.001),
                np.roll(ax, 7), *specials[:, None]]
    for x in (ax, -ax):
        for mag in mags:
            mag = np.broadcast_to(np.asarray(mag, F32), ax.shape)
            recon = np.where(x.view(I32) < 0, -mag, mag)
            with np.errstate(invalid="ignore", over="ignore"):
                old = np.abs((x - recon).astype(F32))
                new = np.abs((np.abs(x) - mag).astype(F32))
            same = (bits(old) == bits(new)) | (np.isnan(old) & np.isnan(new))
            assert same.all()


# --------------------------------------------- the two preconditions --

def test_rel_inverse_step_clamp_gives_the_same_bins():
    """REL with log_step = 0 (eb below ~1e-38): 1/log_step = +inf makes
    y = log2approx * inf NaN at x = 1 and +-inf elsewhere.  The kernel
    clamps it to FLT_MAX: the same range_bad, bin and bin float for every
    log2approx value (all exponents, sampled mantissas)."""
    lg = log2approx_new(every_exponent(257))
    for maxbin in (127, 32767):
        with np.errstate(invalid="ignore", over="ignore"):
            old = front_old((lg * F32(np.inf)).astype(F32), maxbin)
            new = front_new((lg * FLT_MAX).astype(F32), maxbin)
        for a, b in zip(old, new):
            assert np.array_equal(np.asarray(a).view(np.uint8),
                                  np.asarray(b).view(np.uint8))


def test_abs_inverse_step_is_finite_above_the_floor():
    """ABS: eb = max(eb_in, floor) with floor >= 2^-126 (the launcher
    refuses less; float32's floor is 2^-120) gives 1/eb2 <= 2^125, or 0
    for eb2 = inf, so y = x * (1/eb2) is never NaN for finite x."""
    assert QuantizerConfig().eb_floor >= 2.0 ** -126
    eb = np.concatenate([neighbours(np.ldexp(F32(1.0), np.arange(-126, 128))
                                    .astype(F32)), [np.inf]]).astype(F32)
    eb = eb[eb >= F32(2.0 ** -126)]
    with np.errstate(over="ignore"):
        eb2 = ((F32(2.0) * eb).astype(F32).view(U32)
               & U32(0xFF800000)).view(F32)
        inv = (F32(1.0) / eb2).astype(F32)
    assert np.all(np.isfinite(inv)) and np.all(inv <= F32(2.0 ** 125))


# ---------------------- the kernel's source, built for the host --
#
# csrc/pack.cu (with quantize.cuh), exactly as nvcc reads it, built by g++
# against cuda_host/cuda_runtime.h, a stand-in that keeps the intrinsics'
# CUDA semantics and runs each launch as a loop over blocks and threads.
# Its planes are held against the plain versions and against the JAX
# package's quantizer (`repro.core.quantizer`) on the same inputs.

LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<([^,<>]+),\s*([^,<>]+),\s*0,\s*s>>>\(")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/pack.cu for the host")
    src = (CSRC / "pack.cu").read_text()
    host, n_launches = LAUNCH.subn(r"emu_launch(\2, \3, \1, ", src)
    assert n_launches == src.count("<<<") > 0       # every launch rewritten
    tmp = tmp_path_factory.mktemp("pack_host")
    (tmp / "pack.cpp").write_text(host)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-w", "-I", str(HOST), "-I", str(CSRC), "-o",
                    str(tmp / "pack.so"), str(tmp / "pack.cpp")], check=True)
    lib = ctypes.CDLL(str(tmp / "pack.so"))
    for fn in ("repro_abs_pack", "repro_rel_pack", "repro_abs_unpack",
               "repro_rel_unpack"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def host_pack(lib, x, cfg, eb=None):
    """(words, outlier, sign words for REL) of the host-built
    repro_abs_pack / repro_rel_pack on the CPU tensor x.  The planes start
    filled with other bytes, so that one the kernel leaves unwritten shows,
    and run on into a margin that it must not write."""
    n, bits_ = x.numel(), cfg.bin_bits
    n_words = TC.packed_word_count(n, bits_)
    words = torch.full((n_words + 64,), 0x5A5A5A5A, dtype=torch.int32)
    outlier = torch.full((n + 64,), 2, dtype=torch.uint8)
    signs = torch.full((TC.packed_word_count(n, 1) + 64,), 0x33,
                       dtype=torch.int32)
    if cfg.mode == "rel":
        rc = lib.repro_rel_pack(x.data_ptr(), n, bits_, cfg.maxbin,
                                *TK.rel_constants_f32(cfg), words.data_ptr(),
                                n_words // 128, outlier.data_ptr(),
                                signs.data_ptr(), None)
    else:
        rc = lib.repro_abs_pack(x.data_ptr(), n, eb.data_ptr(), bits_,
                                cfg.maxbin, float(F32(cfg.tighten)),
                                float(F32(cfg.eb_floor)), words.data_ptr(),
                                n_words // 128, outlier.data_ptr(), None)
    assert rc == 0
    assert (words[-64:] == 0x5A5A5A5A).all() and (outlier[n:] == 2).all()
    assert (signs[-64:] == 0x33).all()
    planes = (words[:-64], outlier[:n], signs[:-64])
    return planes if cfg.mode == "rel" else planes[:2]


def host_unpack(lib, words, cfg, n, eb=None, signs=None):
    y = torch.full((n,), np.nan)
    if cfg.mode == "rel":
        rc = lib.repro_rel_unpack(words.data_ptr(), words.numel() // 128,
                                  signs.data_ptr(), cfg.bin_bits,
                                  TK.rel_constants_f32(cfg)[1], y.data_ptr(),
                                  n, None)
    else:
        rc = lib.repro_abs_unpack(words.data_ptr(), words.numel() // 128,
                                  eb.data_ptr(), cfg.bin_bits,
                                  float(F32(cfg.eb_floor)), y.data_ptr(), n,
                                  None)
    assert rc == 0
    return y


def jax_planes(x, cfg, eb=None):
    """The planes that the JAX package's quantizer gives for x, packed by
    the §4 layout."""
    jcfg = JCfg(mode=cfg.mode, error_bound=cfg.error_bound,
                bin_bits=cfg.bin_bits)
    xj = jnp.asarray(np.asarray(x))
    if cfg.mode == "rel":
        q = JQ.quantize_rel(xj, jcfg)
    else:
        q = JQ.quantize_abs(xj, jcfg, eb=jnp.float32(eb.item()))
    bins = torch.from_numpy(np.asarray(q.bins).astype(np.int32))
    planes = (TC.pack_words(bins, cfg.bin_bits),
              torch.from_numpy(np.asarray(q.outlier)))
    if cfg.mode == "rel":
        planes += (TC.pack_flags(torch.from_numpy(np.asarray(q.sign))),)
    return planes


def check_host_pack(lib, x, cfg, eb=None):
    """The host-built pack of x, plane by plane, against the plain version
    and the JAX quantizer; returns its planes."""
    got = host_pack(lib, x, cfg, eb)
    plain = (TK._rel_pack_plain(x.contiguous(), cfg) if cfg.mode == "rel"
             else TK._abs_pack_plain(x.contiguous(), eb, cfg))
    for ref in (plain, jax_planes(x, cfg, eb)):
        assert torch.equal(got[0], ref[0])                          # words
        assert torch.equal(got[1], ref[1].to(torch.uint8))          # outlier
        if cfg.mode == "rel":
            assert torch.equal(got[2], ref[2])                      # signs
    return got


def shifted(a, offset):
    """x as a CPU tensor that starts `offset` floats past a 16-byte
    boundary, followed by values that a read past its end would turn into
    bins."""
    buf = torch.full((a.size + 8,), 0.375)        # a read past n shows
    skip = (-(buf.data_ptr() // 4) % 4) + offset
    t = buf[skip:skip + a.size]
    t.copy_(torch.from_numpy(a))
    assert t.data_ptr() % 16 == 4 * offset
    return t


def field(seed, scale):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(20000) * scale,
        np.exp(rng.standard_normal(20000) * 8.0),
        -np.exp(rng.standard_normal(20000) * 0.02),
        rng.uniform(-1, 1, 2000) * 2.0 ** -126,           # denormals
        [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-42, 3e38, -3e38, 1.0, -1.0]
    ]).astype(F32)
    x[:4] = np.array([0x7FC00123, 0xFFC00001, 0x7F800001, 1],
                     U32).view(F32)
    return x


@pytest.mark.parametrize("bits_", [8, 16])
@pytest.mark.parametrize("eb", EBS)
def test_rel_kernel_sequence_matches_plain_quantizer(host_lib, eb, bits_):
    """csrc/pack.cu's REL pack, built for the host, against the plain and
    the JAX quantizer for the presets' bounds and 1e-2, 1e-3 and 1e-5, on a
    field with the specials and values on the bins' grid."""
    cfg = QuantizerConfig(mode="rel", error_bound=eb, bin_bits=bits_)
    x = field(1, 1.0)
    lg = (np.log2(np.abs(x[np.isfinite(x)]) + 1e-30)).astype(F32)
    x = np.concatenate([x, np.exp2(np.round(lg * 64) / 64).astype(F32)])
    check_host_pack(host_lib, torch.from_numpy(x), cfg)


@pytest.mark.parametrize("bits_", [8, 16])
@pytest.mark.parametrize("eb", EBS)
def test_abs_kernel_sequence_matches_plain_quantizer(host_lib, eb, bits_):
    cfg = QuantizerConfig(mode="abs", error_bound=eb, bin_bits=bits_)
    _check_abs_kernel(host_lib, cfg, F32(eb * 0.75))


@pytest.mark.parametrize("eb_in", [np.nan, 0.0, 2.0 ** -121, -1.0, np.inf,
                                   3e38])
def test_abs_kernel_sequence_degenerate_and_huge_bounds(host_lib, eb_in):
    """A degenerate eb (NaN, zero, negative, below the floor) or one whose
    step overflows: every value an outlier, as in the plain quantizer."""
    cfg = QuantizerConfig(mode="abs", error_bound=1e-3, bin_bits=16)
    _check_abs_kernel(host_lib, cfg, F32(eb_in))


def _check_abs_kernel(lib, cfg, eb_in):
    """ABS on a field and on every tie (k + 0.5) * eb2 for k in +-2^15."""
    with np.errstate(over="ignore"):
        _, eb2, _ = cfg.abs_constants(max(eb_in, F32(cfg.eb_floor)))
    if not np.isfinite(eb2):
        eb2 = F32(2.0 ** -7)
    ties = ((np.arange(-2 ** 15, 2 ** 15) + 0.5) * float(eb2)).astype(F32)
    x = np.concatenate([field(2, cfg.error_bound * 300), ties,
                        neighbours(ties[::101])])
    check_host_pack(lib, torch.from_numpy(x), cfg, torch.tensor([eb_in]))


def test_rel_kernel_with_a_zero_log_step(host_lib):
    """REL at eb = 1e-30, where log_step is 0 and 1/log_step +inf: the
    launcher's FLT_MAX in its place gives the same planes.  At x = +-1 the
    reference computes rint(0 * inf) = NaN and casts it to int32: XLA (on
    the CPU too) and CUDA's conversion give 0 (bin 0, exact), torch on the
    CPU INT32_MIN, which the plain quantize_rel therefore maps to 0 first
    (ROADMAP C-port-4).  The kernel gives bin 0 at every width."""
    x = field(3, 1.0)
    assert np.array_equal(x[-2:], [1.0, -1.0])
    for bits_ in (8, 16, 32):
        cfg = QuantizerConfig(mode="rel", error_bound=1e-30, bin_bits=bits_)
        check_host_pack(host_lib, torch.from_numpy(x[:-2]), cfg)
        words, outlier, signs = host_pack(host_lib, torch.from_numpy(x[-2:]),
                                          cfg)
        assert outlier.tolist() == [0, 0]
        assert not words.any() and signs.tolist()[:2] == [0, 1]   # -1: lane 1


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 4095, 4096 * 3 + 129, 4096 * 8])
@pytest.mark.parametrize("bits_", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_host_pack_paths_match_plain_and_jax(host_lib, mode, bits_, n,
                                             offset):
    """Each of the pack kernel's paths: n = 4096 * 8 is whole groups (the
    16-byte path, or at offset 1 the strided one), 4095 and 4096 * 3 + 129
    end inside a row (the last group guarded), n = 1 a lone value.  The
    unpack kernels decode the words as their plain versions do."""
    cfg = QuantizerConfig(mode=mode, error_bound=1e-2, bin_bits=bits_)
    rng = np.random.default_rng(n + bits_)
    a = (rng.standard_normal(n) * (1.0 if mode == "rel" else 10.0)
         ).astype(F32)
    a[:8] = np.array([0x7F800000, 0xFF800000, 0x7FC00123, 1, 0x80000001, 0,
                      0x80000000, 0x3F800000], U32).view(F32)[:n]
    x = shifted(a, offset)
    eb = torch.tensor([F32(7.5e-3)])
    got = check_host_pack(host_lib, x, cfg, eb)
    if mode == "rel":
        y = host_unpack(host_lib, got[0], cfg, n, signs=got[2])
        want = TK._rel_unpack_plain(got[0], got[2], n, cfg)
    else:
        y = host_unpack(host_lib, got[0], cfg, n, eb=eb)
        want = TK._abs_unpack_plain(got[0], eb, n, cfg)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bits_", [8, 16, 32])
@pytest.mark.parametrize("mode", ["abs", "rel", "noa"])
def test_host_pack_holds_the_quantizer_edges(host_lib, mode, bits_):
    """The card test's edges (bins +-(maxbin - 1) and +-maxbin and the
    floats beside them, the FTZ screen, tiny, denormals, +-0.0, +-inf, NaN
    payloads) in a whole group and in the ragged last group, aligned and
    not."""
    eb = {"abs": 1e-2, "noa": {8: 1e-3, 16: 3e-6, 32: 1e-10}[bits_],
          "rel": {8: 1.5, 16: 4e-3, 32: 1e-3}[bits_]}[mode]
    cfg = QuantizerConfig(mode=mode, error_bound=eb, bin_bits=bits_)
    a = field(4, 10.0)[:4096 * 2 + 300].copy()
    a[90:92] = [-1.1e6, 1.1e6]
    eb_t = (TQ.value_range_eb(torch.from_numpy(a), cfg) if mode == "noa"
            else torch.tensor(F32(7.5e-3))).reshape(1)
    edges = _pack_edges(cfg, eb_t.item())
    a[100:100 + edges.size] = edges
    a[-edges.size:] = edges
    if mode == "noa":
        cfg = QuantizerConfig(mode="abs", error_bound=eb, bin_bits=bits_)
    for offset in (0, 1):
        check_host_pack(host_lib, shifted(a, offset), cfg, eb_t)

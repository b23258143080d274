// Device helpers shared by the port's CUDA sources (pack.cu, lossless.cu,
// dense.cu): the quantizers of repro_torch.core.quantizer, one value at a
// time, and the constants of the packed wire's thread layout.
//
// Bit-exactness: the arithmetic uses the _rn intrinsics (and the library
// is built with -fmad=false, without fast-math), so no multiply-add is
// ever contracted.  rintf rounds half to even (like jnp.rint); float->int
// casts truncate; eb2 is computed by masking the bits of 2*eb; the sign
// comes from the bit pattern; the range test is the two-comparison form.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;       // lane width of the packed tile
constexpr int GROUP = 32;        // element rows per thread (one sign word)

// jnp.maximum(eb_in, floor): NaN propagates (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float eb_in, float floor) {
  return (eb_in >= floor || eb_in != eb_in) ? eb_in : floor;
}

// Largest power of two <= 2*eb, by clearing the mantissa bits.
__device__ __forceinline__ float pow2_step(float eb) {
  return __uint_as_float(__float_as_uint(__fmul_rn(2.0f, eb)) & 0xFF800000u);
}

__device__ __forceinline__ float log2approx(float x) {
  int orig_i = __float_as_int(x);
  int expo = (orig_i >> 23) & 0xFF;
  int frac_i = (127 << 23) | (orig_i & 0x7FFFFF);
  return __fadd_rn(__int_as_float(frac_i), __int2float_rn(expo - 128));
}

__device__ __forceinline__ float pow2approx(float l) {
  float biased = __fadd_rn(l, 127.0f);
  int expo = __float2int_rz(biased);                 // C cast: toward zero
  float frac_f = __fsub_rn(biased, __int2float_rn(expo - 1));
  uint32_t exp_i = ((uint32_t)expo << 23) |
                   ((uint32_t)__float_as_int(frac_f) & 0x7FFFFFu);
  return __uint_as_float(exp_i);
}

struct AbsParams {
  float eb, eb2, inv_eb2, bound, maxbin_f;
  int maxbin;
  bool degenerate;
};

struct RelParams {
  float ebT, log_step, inv_log_step, screen, tiny, maxbin_f;
  int maxbin;
};

__device__ __forceinline__ AbsParams abs_params(const float* eb_ptr,
                                                float eb_floor, float tighten,
                                                int maxbin) {
  AbsParams p;
  float eb_in = *eb_ptr;
  p.degenerate = !(eb_in >= eb_floor);               // True for NaN eb too
  p.eb = max_nan(eb_in, eb_floor);
  p.eb2 = pow2_step(p.eb);
  p.inv_eb2 = __fdiv_rn(1.0f, p.eb2);
  p.bound = __fmul_rn(p.eb, tighten);
  p.maxbin = maxbin;
  p.maxbin_f = __int2float_rn(maxbin);
  return p;
}

// ABS quantize + double-check of one value (core.quantizer.quantize_abs).
__device__ __forceinline__ int abs_quantize(float x, const AbsParams& p,
                                            bool& outlier) {
  bool finite = isfinite(x);
  float xs = finite ? x : 0.0f;
  float bin_f = rintf(__fmul_rn(xs, p.inv_eb2));
  bool range_bad = fabsf(bin_f) >= p.maxbin_f;
  int bin_i = range_bad ? 0 : __float2int_rz(bin_f);
  bool range_bad_i = (bin_i >= p.maxbin) || (bin_i <= -p.maxbin);
  float recon = __fmul_rn(__int2float_rn(bin_i), p.eb2);   // exact
  bool fails = !(fabsf(__fsub_rn(x, recon)) <= p.bound);   // NaN fails
  fails = fails || !isfinite(recon);
  outlier = !finite || range_bad || range_bad_i || fails || p.degenerate;
  return outlier ? 0 : bin_i;
}

// REL quantize + double-check of one value (core.quantizer.quantize_rel).
__device__ __forceinline__ int rel_quantize(float x, const RelParams& p,
                                            bool& outlier) {
  bool finite = isfinite(x);
  float ax = fabsf(x);
  bool too_small = !(ax >= p.screen);                // FTZ screen
  float safe = (finite && !too_small) ? ax : 1.0f;
  float bin_f = rintf(__fmul_rn(log2approx(safe), p.inv_log_step));
  bool range_bad = fabsf(bin_f) >= p.maxbin_f;
  int bin_i = range_bad ? 0 : __float2int_rz(bin_f);
  bool range_bad_i = (bin_i >= p.maxbin) || (bin_i <= -p.maxbin);
  bool neg = __float_as_int(x) < 0;                  // bit-pattern sign
  float mag = pow2approx(__fmul_rn(__int2float_rn(bin_i), p.log_step));
  float recon = neg ? -mag : mag;
  bool ok = (fabsf(__fsub_rn(x, recon)) <= __fmul_rn(p.ebT, ax)) &&
            isfinite(recon);
  ok = ok && (mag >= p.tiny);
  outlier = !finite || too_small || range_bad || range_bad_i || !ok;
  return outlier ? 0 : bin_i;
}

// ---------------------------- the quantizers by width: exact forms --
//
// abs_quantize_packed<BITS> and rel_quantize_packed<BITS> give the bits of
// abs_quantize and rel_quantize.  At BITS = 32 they are those; at 8 and
// 16, where every bin that passes the range test lies below 2^15, they
// trade conversions and compares for the exact forms below.  pack.cu's
// kernel uses them; lossless.cu and dense.cu still call the helpers above.
// Each form is held against the instructions it replaces over its whole
// domain by tests/test_torch_pack_identities.py.
//
// (c) rintf(y) and __float2int_rz of it, for |y| < 2^22: y + 1.5*2^23 lies
// in (2^23, 2^24), where the float32 grid is the integers, so the add
// rounds y to an integer, half to even (the constant is even); the
// subtraction is exact; and the sum's bits less the constant's are that
// integer.  For |y| >= 2^22 (+-inf included) |r| >= 2^22.  r is +0.0
// where rintf gives -0.0: only |r| and the int are read.
constexpr float RINT_MAGIC = 12582912.0f;        // 1.5 * 2^23
constexpr int RINT_MAGIC_BITS = 0x4B400000;

struct Rounded {
  float r;    // rint(y) for |y| < 2^22, else |r| >= 2^22
  int i;      // rint(y) as an int for |y| < 2^22
};

__device__ __forceinline__ Rounded rint_magic(float y) {
  float s = __fadd_rn(y, RINT_MAGIC);
  return {__fsub_rn(s, RINT_MAGIC), __float_as_int(s) - RINT_MAGIC_BITS};
}

// (a) log2approx with __int2float_rn(expo - 128), expo in [0, 255], as
// (2^23 + expo) - (2^23 + 128): the add puts expo in the mantissa of 2^23
// exactly, and the difference of two integers below 2^24 is exact, +0.0
// at expo = 128 as the conversion gives.  For x with its sign bit clear
// (the quantizer passes |x| or 1), so that b >> 23 is expo.
__device__ __forceinline__ float log2approx_noconv(float x) {
  uint32_t b = __float_as_uint(x);
  float expo_f = __uint_as_float((b >> 23) + 0x4B000000u);
  float frac_f = __uint_as_float((b & 0x7FFFFFu) | (127u << 23));
  return __fadd_rn(frac_f, __fsub_rn(expo_f, 8388736.0f));
}

// abs_quantize and rel_quantize with (c), and (b): the float of the bin,
// __int2float_rn(range_bad ? 0 : bin), is range_bad ? 0.0f : r, the same
// bits (r is integral and +0.0 at zero).  The range test reads |r| >=
// maxbin_f; since maxbin (127 or 32767) is exact in float32 and below
// 2^22, that is the reference's test, and a bin that passes it lies in
// (-maxbin, maxbin), so the second, integer range test can never fire and
// is left out.  y is never NaN, given two preconditions that the caller
// keeps: ABS an eb_floor >= 2^-126, so that 1/eb2 <= 2^125; REL an
// inv_log_step <= FLT_MAX (pack.cu's launcher refuses the one and clamps
// the other).  BITS = 32 keeps the instructions above: there bins reach
// 2^31.
template <int BITS>
__device__ __forceinline__ int abs_quantize_packed(float x,
                                                   const AbsParams& p,
                                                   bool& outlier) {
  if constexpr (BITS == 32) {
    return abs_quantize(x, p, outlier);
  } else {
    bool finite = isfinite(x);
    float xs = finite ? x : 0.0f;
    Rounded b = rint_magic(__fmul_rn(xs, p.inv_eb2));
    bool range_bad = fabsf(b.r) >= p.maxbin_f;
    float recon = __fmul_rn(range_bad ? 0.0f : b.r, p.eb2);   // exact
    bool fails = !(fabsf(__fsub_rn(x, recon)) <= p.bound);   // NaN fails
    fails = fails || !isfinite(recon);
    outlier = !finite || range_bad || fails || p.degenerate;
    return outlier ? 0 : b.i;
  }
}

template <int BITS>
__device__ __forceinline__ int rel_quantize_packed(float x,
                                                   const RelParams& p,
                                                   bool& outlier) {
  if constexpr (BITS == 32) {
    return rel_quantize(x, p, outlier);
  } else {
    bool finite = isfinite(x);
    float ax = fabsf(x);
    bool too_small = !(ax >= p.screen);              // FTZ screen
    float safe = (finite && !too_small) ? ax : 1.0f;
    Rounded b = rint_magic(__fmul_rn(log2approx_noconv(safe),
                                     p.inv_log_step));
    bool range_bad = fabsf(b.r) >= p.maxbin_f;
    float mag = pow2approx(__fmul_rn(range_bad ? 0.0f : b.r, p.log_step));
    // (e) recon = x's sign on mag, so |x - recon| = |ax - mag|: negation
    // is exact and rounding symmetric (x non-finite or 0 is an outlier
    // anyway), and recon is finite where mag is.
    bool ok = (fabsf(__fsub_rn(ax, mag)) <= __fmul_rn(p.ebT, ax)) &&
              isfinite(mag);
    ok = ok && (mag >= p.tiny);
    outlier = !finite || too_small || range_bad || !ok;
    return outlier ? 0 : b.i;
  }
}

}  // namespace

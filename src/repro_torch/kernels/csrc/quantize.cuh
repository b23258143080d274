// Device helpers shared by the port's CUDA sources (pack.cu, lossless.cu):
// the quantizers of repro_torch.core.quantizer, one value at a time, and
// the constants of the packed wire's thread layout.
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

}  // namespace

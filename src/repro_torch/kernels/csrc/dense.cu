// Dense-layout quantize and dequantize kernels for Hopper (sm_90a), the
// CUDA counterparts of the four elementwise Pallas kernels:
//
//   quantize_abs_kernel    replaces quantize_abs.py:32 _kernel
//   quantize_rel_kernel    replaces quantize_rel.py:41 _kernel
//   dequantize_abs_kernel  replaces dequantize.py:21 _abs_kernel
//   dequantize_rel_kernel  replaces dequantize.py:35 _rel_kernel
//
// (files under src/repro/kernels/).  Each computes what its TPU kernel
// computes, bit for bit (the plain torch versions in kernels/dense.py are
// the oracle), on the flat stream of n values: the reference's [R, 128]
// tiles and their padding have no counterpart here, since every output is
// elementwise.  One thread owns 4 consecutive values: when every pointer
// is 16-byte aligned (the bool planes 4-byte aligned) and the quad is
// whole, it reads and writes them with one vector access per plane; the
// ragged tail and unaligned views take the scalar path.
//
// Bound: all four are memory-bound (2-13 operations per value against 13-14
// bytes moved, far below the card's ~20 flop/byte float32 ridge), so the
// design only has to read each input once and write each output once, with
// wide coalesced accesses.
//
// Bit-exactness: the per-value quantizers and the pow2/log2 helpers are
// those of the packed kernels (quantize.cuh), which says how they keep it.
#include "quantize.cuh"

namespace {

constexpr int DBLOCK = 256;
constexpr int QUAD = 4;

__device__ __forceinline__ uint32_t pack4(const bool f[QUAD]) {
  return (uint32_t)f[0] | ((uint32_t)f[1] << 8) | ((uint32_t)f[2] << 16) |
         ((uint32_t)f[3] << 24);
}

// The quad's helpers take m, the values of the quad that lie below n, and
// index their arrays only in fully unrolled loops, so that the arrays stay
// in registers (a runtime index would put them in local memory).
__device__ __forceinline__ int quad_len(long long e, long long n) {
  return (int)min((long long)QUAD, n - e);
}

// Loads 4 values (one vector access when VEC and the quad is whole).
template <bool VEC, typename T, typename V>
__device__ __forceinline__ void load4(const T* p, long long e, int m,
                                      T out[QUAD]) {
  if (VEC && m == QUAD) {
    V v = *reinterpret_cast<const V*>(p + e);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
      if (i < m) out[i] = p[e + i];
  }
}

template <bool VEC>
__device__ __forceinline__ void load_flags(const uint8_t* p, long long e,
                                           int m, bool out[QUAD]) {
  if (VEC && m == QUAD) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(p + e);
#pragma unroll
    for (int i = 0; i < QUAD; ++i) out[i] = ((w >> (8 * i)) & 0xFFu) != 0u;
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
      if (i < m) out[i] = p[e + i] != 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_flags(uint8_t* p, long long e, int m,
                                            const bool f[QUAD]) {
  if (VEC && m == QUAD) {
    *reinterpret_cast<uint32_t*>(p + e) = pack4(f);
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
      if (i < m) p[e + i] = f[i] ? 1 : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_ints(int* p, long long e, int m,
                                           const int v[QUAD]) {
  if (VEC && m == QUAD) {
    *reinterpret_cast<int4*>(p + e) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
      if (i < m) p[e + i] = v[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void store_floats(float* p, long long e, int m,
                                             const float v[QUAD]) {
  if (VEC && m == QUAD) {
    *reinterpret_cast<float4*>(p + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < QUAD; ++i)
      if (i < m) p[e + i] = v[i];
  }
}

// bins, outlier, recon (0 at outliers): core.quantizer.quantize_abs with a
// traced eb read from device memory (degenerate guard included).
template <bool VEC>
__global__ void __launch_bounds__(DBLOCK)
quantize_abs_kernel(const float* __restrict__ x, long long n,
                    const float* __restrict__ eb_ptr, float eb_floor,
                    float tighten, int maxbin, int* __restrict__ bins,
                    uint8_t* __restrict__ outlier,
                    float* __restrict__ recon) {
  long long e = ((long long)blockIdx.x * DBLOCK + threadIdx.x) * QUAD;
  if (e >= n) return;
  AbsParams p = abs_params(eb_ptr, eb_floor, tighten, maxbin);
  float v[QUAD] = {0.0f, 0.0f, 0.0f, 0.0f}, r[QUAD];
  int b[QUAD];
  bool o[QUAD];
  int m = quad_len(e, n);
  load4<VEC, float, float4>(x, e, m, v);
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    b[i] = abs_quantize(v[i], p, o[i]);
    r[i] = __fmul_rn(__int2float_rn(b[i]), p.eb2);    // 0 at outliers
  }
  store_ints<VEC>(bins, e, m, b);
  store_flags<VEC>(outlier, e, m, o);
  store_floats<VEC>(recon, e, m, r);
}

// bins, outlier, recon (0 at outliers), sign (from the bit pattern):
// core.quantizer.quantize_rel.
template <bool VEC>
__global__ void __launch_bounds__(DBLOCK)
quantize_rel_kernel(const float* __restrict__ x, long long n, RelParams rp,
                    int* __restrict__ bins, uint8_t* __restrict__ outlier,
                    float* __restrict__ recon, uint8_t* __restrict__ sign) {
  long long e = ((long long)blockIdx.x * DBLOCK + threadIdx.x) * QUAD;
  if (e >= n) return;
  float v[QUAD] = {0.0f, 0.0f, 0.0f, 0.0f}, r[QUAD];
  int b[QUAD];
  bool o[QUAD], s[QUAD];
  int m = quad_len(e, n);
  load4<VEC, float, float4>(x, e, m, v);
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    b[i] = rel_quantize(v[i], rp, o[i]);
    s[i] = __float_as_int(v[i]) < 0;
    float mag = pow2approx(__fmul_rn(__int2float_rn(b[i]), rp.log_step));
    r[i] = o[i] ? 0.0f : (s[i] ? -mag : mag);
  }
  store_ints<VEC>(bins, e, m, b);
  store_flags<VEC>(outlier, e, m, o);
  store_floats<VEC>(recon, e, m, r);
  store_flags<VEC>(sign, e, m, s);
}

// y = outlier ? bits of payload : bins * eb2 (eb2 = pow2_step(max(eb,
// floor)), the encoder's step) for ABS, or +-pow2approx(bins * log_step)
// for REL.
template <bool VEC, bool REL>
__global__ void __launch_bounds__(DBLOCK)
dequantize_kernel(const int* __restrict__ bins,
                  const int* __restrict__ payload,
                  const uint8_t* __restrict__ outlier,
                  const uint8_t* __restrict__ sign,
                  const float* __restrict__ eb_ptr, float eb_floor,
                  float log_step, float* __restrict__ y, long long n) {
  long long e = ((long long)blockIdx.x * DBLOCK + threadIdx.x) * QUAD;
  if (e >= n) return;
  float eb2 = 0.0f;
  if constexpr (!REL) eb2 = pow2_step(max_nan(*eb_ptr, eb_floor));
  int b[QUAD] = {0, 0, 0, 0}, pl[QUAD] = {0, 0, 0, 0};
  bool o[QUAD] = {false, false, false, false};
  bool s[QUAD] = {false, false, false, false};
  float out[QUAD] = {0.0f, 0.0f, 0.0f, 0.0f};
  int m = quad_len(e, n);
  load4<VEC, int, int4>(bins, e, m, b);
  load4<VEC, int, int4>(payload, e, m, pl);
  load_flags<VEC>(outlier, e, m, o);
  if constexpr (REL) load_flags<VEC>(sign, e, m, s);
#pragma unroll
  for (int i = 0; i < QUAD; ++i) {
    float v;
    if constexpr (REL) {
      float mag = pow2approx(__fmul_rn(__int2float_rn(b[i]), log_step));
      v = s[i] ? -mag : mag;
    } else {
      v = __fmul_rn(__int2float_rn(b[i]), eb2);       // exact (pow2 step)
    }
    out[i] = o[i] ? __int_as_float(pl[i]) : v;
  }
  store_floats<VEC>(y, e, m, out);
}

unsigned grid_of(long long n) {
  const long long per_block = (long long)DBLOCK * QUAD;
  return (unsigned)((n + per_block - 1) / per_block);
}

bool aligned(const void* p, unsigned a) { return ((uintptr_t)p % a) == 0; }

}  // namespace

// ---------------------------------------------------------------- C API --
// Every entry launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch (0 = ok).
// Bool planes are one byte per value (torch.bool).

extern "C" int repro_dense_quantize_abs(const float* x, long long n,
                                        const float* eb, int maxbin,
                                        float tighten, float eb_floor,
                                        int* bins, uint8_t* outlier,
                                        float* recon, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  bool vec = aligned(x, 16) && aligned(bins, 16) && aligned(recon, 16) &&
             aligned(outlier, 4);
  if (vec)
    quantize_abs_kernel<true><<<grid_of(n), DBLOCK, 0, s>>>(
        x, n, eb, eb_floor, tighten, maxbin, bins, outlier, recon);
  else
    quantize_abs_kernel<false><<<grid_of(n), DBLOCK, 0, s>>>(
        x, n, eb, eb_floor, tighten, maxbin, bins, outlier, recon);
  return (int)cudaGetLastError();
}

extern "C" int repro_dense_quantize_rel(const float* x, long long n,
                                        int maxbin, float ebT, float log_step,
                                        float inv_log_step, float screen,
                                        float tiny, int* bins,
                                        uint8_t* outlier, float* recon,
                                        uint8_t* sign, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RelParams rp;
  rp.ebT = ebT;
  rp.log_step = log_step;
  rp.inv_log_step = inv_log_step;
  rp.screen = screen;
  rp.tiny = tiny;
  rp.maxbin = maxbin;
  rp.maxbin_f = (float)maxbin;      // host round-to-nearest, as numpy does
  bool vec = aligned(x, 16) && aligned(bins, 16) && aligned(recon, 16) &&
             aligned(outlier, 4) && aligned(sign, 4);
  if (vec)
    quantize_rel_kernel<true><<<grid_of(n), DBLOCK, 0, s>>>(
        x, n, rp, bins, outlier, recon, sign);
  else
    quantize_rel_kernel<false><<<grid_of(n), DBLOCK, 0, s>>>(
        x, n, rp, bins, outlier, recon, sign);
  return (int)cudaGetLastError();
}

template <bool REL>
static int launch_dequantize(const int* bins, const int* payload,
                             const uint8_t* outlier, const uint8_t* sign,
                             const float* eb, float eb_floor, float log_step,
                             float* y, long long n, cudaStream_t s) {
  if (n <= 0) return 0;
  bool vec = aligned(bins, 16) && aligned(payload, 16) && aligned(y, 16) &&
             aligned(outlier, 4) && (!REL || aligned(sign, 4));
  if (vec)
    dequantize_kernel<true, REL><<<grid_of(n), DBLOCK, 0, s>>>(
        bins, payload, outlier, sign, eb, eb_floor, log_step, y, n);
  else
    dequantize_kernel<false, REL><<<grid_of(n), DBLOCK, 0, s>>>(
        bins, payload, outlier, sign, eb, eb_floor, log_step, y, n);
  return (int)cudaGetLastError();
}

extern "C" int repro_dense_dequantize_abs(const int* bins, const int* payload,
                                          const uint8_t* outlier,
                                          const float* eb, float eb_floor,
                                          float* y, long long n,
                                          void* stream) {
  return launch_dequantize<false>(bins, payload, outlier, nullptr, eb,
                                  eb_floor, 0.0f, y, n, (cudaStream_t)stream);
}

extern "C" int repro_dense_dequantize_rel(const int* bins, const int* payload,
                                          const uint8_t* outlier,
                                          const uint8_t* sign, float log_step,
                                          float* y, long long n,
                                          void* stream) {
  return launch_dequantize<true>(bins, payload, outlier, sign, nullptr, 0.0f,
                                 log_step, y, n, (cudaStream_t)stream);
}

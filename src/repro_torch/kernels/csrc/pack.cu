// Fused quantize + bit-pack and unpack + dequantize kernels for Hopper
// (sm_90a), the CUDA counterparts of the four Pallas kernels in
// src/repro/kernels/pack.py:
//
//   abs_pack_kernel    replaces _abs_pack_kernel    (pack.py:141)
//   rel_pack_kernel    replaces _rel_pack_kernel    (pack.py:152)
//   abs_unpack_kernel  replaces _abs_unpack_kernel  (pack.py:168)
//   rel_unpack_kernel  replaces _rel_unpack_kernel  (pack.py:180)
//
// Each computes what its TPU kernel computes, bit for bit (the plain torch
// versions in kernels/pack.py are the oracle).  Layout (the §4 wire): the
// flat stream is viewed as [rows, 128]; word row w packs element rows
// w*vpw .. w*vpw+vpw-1 at the same lane; the REL sign plane packs 32 rows
// per word.  One thread owns one (group of 32 element rows, lane): it reads
// its 32 values (neighbouring threads read neighbouring lanes, so every
// warp load is one 128-byte line), and writes its 32/vpw words, its 32
// outlier bytes and, for REL, its one sign word.  Elements past n behave as
// the zero the reference pads with: bin 0, sign 0, and no outlier byte is
// written for them.
//
// Bound: all four are memory-bound.  They do ~10-20 flops per element
// against 6-7 bytes moved, ~2 flop/byte, far below the card's
// ~20 flop/byte float32 ridge, so the design only has to keep each input
// byte read once and each output byte written once.
//
// Bit-exactness: the per-value quantizers and the pow2/log2 helpers are in
// quantize.cuh (shared with lossless.cu), which says how they keep it.
#include "quantize.cuh"

namespace {

constexpr int BLOCK = 256;

template <int BITS, bool REL>
__global__ void __launch_bounds__(BLOCK)
pack_kernel(const float* __restrict__ x, long long n, long long n_groups,
            const float* __restrict__ eb_ptr, float eb_floor, float tighten,
            RelParams rp, int maxbin, uint32_t* __restrict__ words,
            long long n_word_rows, uint8_t* __restrict__ outlier,
            uint32_t* __restrict__ sign_words) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = BITS == 32 ? 0xFFFFFFFFu : ((1u << BITS) - 1u);
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long g = t / LANES;
  int lane = (int)(t % LANES);
  if (g >= n_groups) return;
  AbsParams ap = {};
  if constexpr (!REL) ap = abs_params(eb_ptr, eb_floor, tighten, maxbin);
  uint32_t sign = 0;
#pragma unroll
  for (int k = 0; k < GROUP / VPW; ++k) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < VPW; ++i) {
      int j = k * VPW + i;
      long long e = (g * GROUP + j) * LANES + lane;
      bool in = e < n;
      float v = in ? x[e] : 0.0f;
      bool out;
      int bin;
      if constexpr (REL) {
        bin = rel_quantize(v, rp, out);
        sign |= (uint32_t)(__float_as_int(v) < 0) << j;
      } else {
        bin = abs_quantize(v, ap, out);
      }
      if (in) outlier[e] = out ? 1 : 0;
      w |= ((uint32_t)bin & MASK) << (i * BITS);
    }
    long long wr = g * (GROUP / VPW) + k;
    if (wr < n_word_rows) words[wr * LANES + lane] = w;
  }
  if constexpr (REL) sign_words[g * LANES + lane] = sign;
}

template <int BITS, bool REL>
__global__ void __launch_bounds__(BLOCK)
unpack_kernel(const uint32_t* __restrict__ words, long long n_word_rows,
              const uint32_t* __restrict__ sign_words,
              const float* __restrict__ eb_ptr, float eb_floor,
              float log_step, float* __restrict__ y, long long n,
              long long n_groups) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = BITS == 32 ? 0xFFFFFFFFu : ((1u << BITS) - 1u);
  long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  long long g = t / LANES;
  int lane = (int)(t % LANES);
  if (g >= n_groups) return;
  float eb2 = 0.0f;
  uint32_t sign = 0u;
  if constexpr (REL) {
    sign = sign_words[g * LANES + lane];
  } else {
    eb2 = pow2_step(max_nan(*eb_ptr, eb_floor));   // the encoder's eb2
  }
#pragma unroll
  for (int k = 0; k < GROUP / VPW; ++k) {
    long long wr = g * (GROUP / VPW) + k;
    uint32_t w = wr < n_word_rows ? words[wr * LANES + lane] : 0u;
#pragma unroll
    for (int i = 0; i < VPW; ++i) {
      int j = k * VPW + i;
      long long e = (g * GROUP + j) * LANES + lane;
      if (e >= n) continue;
      uint32_t u = (w >> (i * BITS)) & MASK;
      int bin = BITS == 32 ? (int)u
                           : ((int)(u << (32 - BITS))) >> (32 - BITS);
      float v;
      if constexpr (REL) {
        float mag = pow2approx(__fmul_rn(__int2float_rn(bin), log_step));
        v = ((sign >> j) & 1u) ? -mag : mag;
      } else {
        v = __fmul_rn(__int2float_rn(bin), eb2);     // exact (pow2 step)
      }
      y[e] = v;
    }
  }
}

long long n_groups_of(long long n) { return (n + GROUP * LANES - 1) / (GROUP * LANES); }

unsigned grid_of(long long n_groups) {
  return (unsigned)((n_groups * LANES + BLOCK - 1) / BLOCK);
}

template <bool REL>
int launch_pack(int bits, const float* x, long long n, const float* eb,
                float eb_floor, float tighten, RelParams rp, int maxbin,
                uint32_t* words, long long n_word_rows, uint8_t* outlier,
                uint32_t* sign_words, cudaStream_t s) {
  long long g = n_groups_of(n);
  unsigned grid = grid_of(g);
  switch (bits) {
    case 8: pack_kernel<8, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words); break;
    case 16: pack_kernel<16, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words); break;
    case 32: pack_kernel<32, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool REL>
int launch_unpack(int bits, const uint32_t* words, long long n_word_rows,
                  const uint32_t* sign_words, const float* eb, float eb_floor,
                  float log_step, float* y, long long n, cudaStream_t s) {
  long long g = n_groups_of(n);
  unsigned grid = grid_of(g);
  switch (bits) {
    case 8: unpack_kernel<8, REL><<<grid, BLOCK, 0, s>>>(words, n_word_rows, sign_words, eb, eb_floor, log_step, y, n, g); break;
    case 16: unpack_kernel<16, REL><<<grid, BLOCK, 0, s>>>(words, n_word_rows, sign_words, eb, eb_floor, log_step, y, n, g); break;
    case 32: unpack_kernel<32, REL><<<grid, BLOCK, 0, s>>>(words, n_word_rows, sign_words, eb, eb_floor, log_step, y, n, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C API --
// Every entry launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch (0 = ok).

extern "C" int repro_abs_pack(const float* x, long long n, const float* eb,
                              int bits, int maxbin, float tighten,
                              float eb_floor, uint32_t* words,
                              long long n_word_rows, uint8_t* outlier,
                              void* stream) {
  RelParams unused = {};
  return launch_pack<false>(bits, x, n, eb, eb_floor, tighten, unused, maxbin,
                            words, n_word_rows, outlier, nullptr,
                            (cudaStream_t)stream);
}

extern "C" int repro_rel_pack(const float* x, long long n, int bits,
                              int maxbin, float ebT, float log_step,
                              float inv_log_step, float screen, float tiny,
                              uint32_t* words, long long n_word_rows,
                              uint8_t* outlier, uint32_t* sign_words,
                              void* stream) {
  RelParams rp;
  rp.ebT = ebT;
  rp.log_step = log_step;
  rp.inv_log_step = inv_log_step;
  rp.screen = screen;
  rp.tiny = tiny;
  rp.maxbin = maxbin;
  rp.maxbin_f = (float)maxbin;      // host round-to-nearest, as numpy does
  return launch_pack<true>(bits, x, n, nullptr, 0.0f, 0.0f, rp, maxbin, words,
                           n_word_rows, outlier, sign_words,
                           (cudaStream_t)stream);
}

extern "C" int repro_abs_unpack(const uint32_t* words, long long n_word_rows,
                                const float* eb, int bits, float eb_floor,
                                float* y, long long n, void* stream) {
  return launch_unpack<false>(bits, words, n_word_rows, nullptr, eb, eb_floor,
                              0.0f, y, n, (cudaStream_t)stream);
}

extern "C" int repro_rel_unpack(const uint32_t* words, long long n_word_rows,
                                const uint32_t* sign_words, int bits,
                                float log_step, float* y, long long n,
                                void* stream) {
  return launch_unpack<true>(bits, words, n_word_rows, sign_words, nullptr,
                             0.0f, log_step, y, n, (cudaStream_t)stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

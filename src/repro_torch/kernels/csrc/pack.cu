// Fused quantize + bit-pack and unpack + dequantize kernels for Hopper
// (sm_90a), the CUDA counterparts of the four Pallas kernels in
// src/repro/kernels/pack.py:
//
//   pack_kernel<BITS, false>    replaces _abs_pack_kernel    (pack.py:141)
//   pack_kernel<BITS, true>     replaces _rel_pack_kernel    (pack.py:152)
//   unpack_kernel<BITS, false>  replaces _abs_unpack_kernel  (pack.py:168)
//   unpack_kernel<BITS, true>   replaces _rel_unpack_kernel  (pack.py:180)
//
// Each computes what its TPU kernel computes, bit for bit (the plain torch
// versions in kernels/pack.py are the oracle).  Layout (the §4 wire): the
// flat stream is viewed as [rows, 128]; word row w packs element rows
// w*vpw .. w*vpw+vpw-1 at the same lane; the REL sign plane packs 32 rows
// per word.  Elements past n behave as the zero the reference pads with:
// bin 0, sign 0, and no outlier byte is written for them.
//
// Bound: all four are bound by their bytes (5-8 bytes moved a value).
// The pack kernel once gave a thread one lane of a group of 32 element
// rows, with scalar accesses: ~50-60 instructions a value, half of them
// 64-bit index arithmetic and tail tests, and for REL 6 conversions, which
// run at 1/8 of the float32 rate (`chip_sass.py` counts them).  Its
// integer and conversion pipes, not its bytes, set its time.  So
// pack_kernel gives each warp one group (32 rows of 128 lanes, 4096
// values) and each thread four lanes of it, as dense.cu does for its
// planes.  Inside a group every offset is a constant of the unrolled code,
// so a whole group (all its values below n) runs with no index arithmetic
// and no tail test per value.  Where x and the word and sign planes are
// 16-byte aligned and the outlier plane 4-byte aligned, the four lanes are
// neighbours: per element row one 16-byte load of x and one 4-byte store
// of the 4 outlier bytes, per word row one 16-byte store of the 4 lanes'
// words, and for REL one 16-byte store of the 4 sign words; a warp moves
// 512 contiguous bytes per load and per word store.  An unaligned view
// (x[1:]) takes lanes t, t+32, t+64, t+96 instead, with scalar accesses
// that a warp still makes on 128 contiguous bytes, in a loop over word
// rows with no tail test.  The last, ragged group takes the same loop with
// a test for each element.  All three are paths of the same kernel.  The quantizers are quantize.cuh's by width
// (abs/rel_quantize_packed<BITS>), which at pack:8 and pack:16 trade
// conversions and compares for exact forms.  The unpack kernels keep one
// thread per lane.
//
// Bit-exactness: the per-value quantizers and the pow2/log2 helpers are in
// quantize.cuh (shared with lossless.cu and dense.cu), which says how they
// keep it.
#include "quantize.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int WARP = 32;
constexpr int QUAD = 4;          // lanes per thread in pack_kernel

// ------------------------------------------------------------ the pack --

// Word row k of a group for a thread's four lanes.  QUADS: lanes 4t..4t+3,
// so that a row is one 16-byte load, its outlier bytes one 4-byte store
// and the word row one 16-byte store (needs x and words 16-byte aligned,
// outlier 4-byte).  Else lanes t, t+32, t+64, t+96: scalar accesses, each
// warp instruction on 128 contiguous bytes of x, whatever its alignment.
// GUARD (the ragged last group): every element is tested against rem (the
// elements below n, counted from xg) and the word row against has_word.
// xg, og point at row 0 of the thread's first lane in x and the outlier
// plane, wg at word row 0 of it.  Arrays are indexed only in unrolled
// loops, so they stay in registers.
template <int BITS, bool REL, bool QUADS, bool GUARD>
__device__ __forceinline__ void pack_word_row(
    int k, const float* __restrict__ xg, int rem, const AbsParams& ap,
    const RelParams& rp, uint8_t* __restrict__ og, uint32_t* __restrict__ wg,
    bool has_word, uint32_t sign[QUAD]) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = BITS == 32 ? 0xFFFFFFFFu : ((1u << BITS) - 1u);
  constexpr int STEP = QUADS ? 1 : WARP;      // lanes between its values
  constexpr bool VEC = QUADS && !GUARD;
  uint32_t w[QUAD] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < VPW; ++i) {
    const int off = (k * VPW + i) * LANES;
    float v[QUAD];
    if constexpr (VEC) {
      float4 q = *reinterpret_cast<const float4*>(xg + off);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int l = 0; l < QUAD; ++l)
        v[l] = (!GUARD || off + l * STEP < rem) ? xg[off + l * STEP] : 0.0f;
    }
    uint32_t flags = 0u;
#pragma unroll
    for (int l = 0; l < QUAD; ++l) {
      bool out;
      int bin;
      if constexpr (REL) {
        bin = rel_quantize_packed<BITS>(v[l], rp, out);
        // x's sign bit enters at the bottom, row 0 first: one funnel
        // shift a value, and one bit reversal a group puts row j at bit j
        sign[l] = __funnelshift_l(__float_as_uint(v[l]), sign[l], 1);
      } else {
        bin = abs_quantize_packed<BITS>(v[l], ap, out);
      }
      w[l] |= ((uint32_t)bin & MASK) << (i * BITS);
      if constexpr (VEC) {
        flags |= (uint32_t)out << (8 * l);
      } else if (!GUARD || off + l * STEP < rem) {
        og[off + l * STEP] = out ? 1 : 0;
      }
    }
    if constexpr (VEC) *reinterpret_cast<uint32_t*>(og + off) = flags;
  }
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(wg + k * LANES) = make_uint4(w[0], w[1], w[2],
                                                           w[3]);
  } else if (!GUARD || has_word) {
#pragma unroll
    for (int l = 0; l < QUAD; ++l) wg[k * LANES + l * STEP] = w[l];
  }
}

// Group g (element rows 32g .. 32g+31, sign word row g) for thread t of
// its warp.
template <int BITS, bool REL, bool QUADS, bool GUARD>
__device__ __forceinline__ void pack_group(
    long long g, int t, const float* __restrict__ x, long long n,
    const AbsParams& ap, const RelParams& rp, uint32_t* __restrict__ words,
    long long n_word_rows, uint8_t* __restrict__ outlier,
    uint32_t* __restrict__ sign_words) {
  constexpr int WORD_ROWS = GROUP * BITS / 32;
  constexpr int STEP = QUADS ? 1 : WARP;
  const int lane0 = QUADS ? QUAD * t : t;
  const long long first = g * GROUP * LANES + lane0;
  const float* xg = x + first;
  uint8_t* og = outlier + first;
  uint32_t* wg = words + g * WORD_ROWS * LANES + lane0;
  uint32_t sign[QUAD] = {0u, 0u, 0u, 0u};
  if constexpr (QUADS && !GUARD) {
#pragma unroll
    for (int k = 0; k < WORD_ROWS; ++k)
      pack_word_row<BITS, REL, true, false>(k, xg, 0, ap, rp, og, wg, true,
                                            sign);
  } else {
    // a loop over word rows: unrolled as well, these paths made ptxas
    // spill at pack:8 and pack:32
    const int rem = GUARD ? (int)min(n - first, (long long)(GROUP * LANES))
                          : 0;
    const long long word_rows_left = n_word_rows - g * WORD_ROWS;
#pragma unroll 1
    for (int k = 0; k < WORD_ROWS; ++k)
      pack_word_row<BITS, REL, QUADS, GUARD>(k, xg, rem, ap, rp, og, wg,
                                             k < word_rows_left, sign);
  }
  if constexpr (REL) {
    uint32_t* sg = sign_words + g * LANES + lane0;
    if constexpr (QUADS && !GUARD) {
      *reinterpret_cast<uint4*>(sg) = make_uint4(
          __brev(sign[0]), __brev(sign[1]), __brev(sign[2]), __brev(sign[3]));
    } else {
#pragma unroll
      for (int l = 0; l < QUAD; ++l) sg[l * STEP] = __brev(sign[l]);
    }
  }
}

// One warp per group of 32 element rows (4096 values), one thread per four
// lanes of it.  A whole group takes the 16-byte path where vec (x, words
// and sign_words 16-byte aligned, outlier 4-byte aligned), else the strided
// scalar one; the ragged last group takes the guarded one.
template <int BITS, bool REL>
__global__ void __launch_bounds__(BLOCK)
pack_kernel(const float* __restrict__ x, long long n, long long n_groups,
            const float* __restrict__ eb_ptr, float eb_floor, float tighten,
            RelParams rp, int maxbin, uint32_t* __restrict__ words,
            long long n_word_rows, uint8_t* __restrict__ outlier,
            uint32_t* __restrict__ sign_words, bool vec) {
  const long long g = (long long)blockIdx.x * (BLOCK / WARP) +
                      threadIdx.x / WARP;
  const int t = threadIdx.x % WARP;
  if (g >= n_groups) return;
  AbsParams ap = {};
  if constexpr (!REL) ap = abs_params(eb_ptr, eb_floor, tighten, maxbin);
  if ((g + 1) * GROUP * LANES > n)
    pack_group<BITS, REL, false, true>(g, t, x, n, ap, rp, words, n_word_rows,
                                       outlier, sign_words);
  else if (vec)
    pack_group<BITS, REL, true, false>(g, t, x, n, ap, rp, words, n_word_rows,
                                       outlier, sign_words);
  else
    pack_group<BITS, REL, false, false>(g, t, x, n, ap, rp, words,
                                        n_word_rows, outlier, sign_words);
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

bool aligned(const void* p, unsigned a) { return ((uintptr_t)p % a) == 0; }

template <bool REL>
int launch_pack(int bits, const float* x, long long n, const float* eb,
                float eb_floor, float tighten, RelParams rp, int maxbin,
                uint32_t* words, long long n_word_rows, uint8_t* outlier,
                uint32_t* sign_words, cudaStream_t s) {
  // the preconditions of quantize.cuh's exact forms, which keep y finite
  // for (c): ABS needs a normal floor; REL's 1/log_step is +inf only for
  // log_step = 0 (eb below ~1.1e-16), where FLT_MAX gives the same bins and
  // outliers (0 stays 0, every other log2approx, at least 2^-23 in size,
  // goes far out of range as +-inf does)
  if (!REL && !(eb_floor >= 1.17549435e-38f))
    return (int)cudaErrorInvalidValue;
  if (REL && bits != 32)
    rp.inv_log_step = fminf(rp.inv_log_step, 3.40282347e38f);   // FLT_MAX
  long long g = n_groups_of(n);
  unsigned grid = (unsigned)((g + BLOCK / WARP - 1) / (BLOCK / WARP));
  bool vec = aligned(x, 16) && aligned(words, 16) && aligned(outlier, 4) &&
             (!REL || aligned(sign_words, 16));
  switch (bits) {
    case 8: pack_kernel<8, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words, vec); break;
    case 16: pack_kernel<16, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words, vec); break;
    case 32: pack_kernel<32, REL><<<grid, BLOCK, 0, s>>>(x, n, g, eb, eb_floor, tighten, rp, maxbin, words, n_word_rows, outlier, sign_words, vec); break;
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
// repro_abs_pack refuses an eb_floor below 2^-126 (cudaErrorInvalidValue):
// the wrappers pass float32's 2^-120.

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

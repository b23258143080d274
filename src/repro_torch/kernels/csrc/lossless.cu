// The chunked zero/narrow coder (DESIGN.md §6) for Hopper (sm_90a): the
// CUDA counterparts of the four Pallas kernels in
// src/repro/kernels/lossless.py:
//
//   pack_lc_kernel<BITS, false>  replaces _abs_pack_lc_kernel  (lossless.py:110)
//   pack_lc_kernel<BITS, true>   replaces _rel_pack_lc_kernel  (lossless.py:128)
//   select_kernel       replaces _lc_select_kernel    (lossless.py:100)
//   expand_kernel       replaces _lc_expand_kernel    (lossless.py:106)
//
// Each computes what its TPU kernel computes, bit for bit (the plain torch
// versions in kernels/lossless.py are the oracle).  A chunk is 512 words =
// 4 word rows x 128 lanes of the §4 word plane.  Per chunk: the unsigned
// max word gives a 2-bit code (stage zero: 0 or 3; stage narrow: 0, < 2^8,
// < 2^16, else 3), and the chunk is narrowed to 8 or 16 bits per word,
// left-aligned and zero-padded to its 4 rows (width 8 packs rows 0-3 into
// row 0; width 16 packs rows 0-1 into row 0 and rows 2-3 into row 1 — the
// reference's pack_words at chunk granularity).  The compaction of the
// narrowed chunks to their true lengths (cumsum + scatter) and its inverse
// gather stay torch ops, as they stay XLA ops in the reference.
//
// Thread layout (pack.cu's): one thread owns one (group of 32 element
// rows, lane), so 32/vpw word rows at its lane; a chunk's 4 word rows x 128
// lanes then lie inside the 128 threads (4 warps) of one row group, which
// is one block here.  pack:8 gives 2 chunks per group, pack:16 4, pack:32
// 8.  The chunk max is __reduce_max_sync on unsigned words in each warp,
// then the 4 warps through shared memory (one slot per chunk, so one
// barrier per chunk); each thread then narrows its own 4 words.
//
// Bound: all four are memory-bound (a few integer operations per word
// beside the quantizers' ~2 flop/byte).  The fused pack kernels do not
// write the plain word plane — encode_packed_lc never reads it — so they
// move x + outlier + chunk image + codes (+ sign), the same bytes as
// pack.cu's kernels.  select reads its words once and writes the image
// and codes; expand reads only the rows its chunk's code needs.
#include "quantize.cuh"

namespace {

constexpr int CHUNK_ROWS = 4;                  // word rows per chunk
constexpr int CHUNK = CHUNK_ROWS * LANES;      // 512 words
constexpr int WARPS = LANES / 32;              // warps across one chunk
constexpr int SEL_CHUNKS = 4;                  // chunks per select block
constexpr int EXP_BLOCK = 256;

__device__ __forceinline__ uint32_t max_u32(uint32_t a, uint32_t b) {
  return a > b ? a : b;
}

// The chunk's width code from its unsigned max word.
__device__ __forceinline__ uint32_t chunk_code(uint32_t mx, bool narrow) {
  if (mx == 0u) return 0u;
  if (!narrow) return 3u;
  return mx < (1u << 8) ? 1u : (mx < (1u << 16) ? 2u : 3u);
}

// Unsigned max of v over the block's 128 threads (one chunk's lanes).
// `red` is a slot of WARPS words used by this call only.
__device__ __forceinline__ uint32_t chunk_max(uint32_t v, uint32_t* red) {
  uint32_t m = __reduce_max_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  uint32_t r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = max_u32(r, red[i]);
  return r;
}

// Narrow one lane's 4 words of a chunk to the code's width and store the
// left-aligned, zero-padded chunk image at that lane.
__device__ __forceinline__ void store_narrowed(const uint32_t w[CHUNK_ROWS],
                                               uint32_t code,
                                               uint32_t* __restrict__ img) {
  uint32_t o[CHUNK_ROWS] = {0u, 0u, 0u, 0u};
  if (code == 1u) {
    o[0] = (w[0] & 0xFFu) | ((w[1] & 0xFFu) << 8) | ((w[2] & 0xFFu) << 16) |
           ((w[3] & 0xFFu) << 24);
  } else if (code == 2u) {
    o[0] = (w[0] & 0xFFFFu) | ((w[1] & 0xFFFFu) << 16);
    o[1] = (w[2] & 0xFFFFu) | ((w[3] & 0xFFFFu) << 16);
  } else if (code == 3u) {
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) o[r] = w[r];
  }
#pragma unroll
  for (int r = 0; r < CHUNK_ROWS; ++r) img[r * LANES] = o[r];
}

// Quantize + pack + chunk select over one row group per block (pack.cu's
// pack_kernel, then the select on the fresh words, which never reach
// device memory).
template <int BITS, bool REL>
__global__ void __launch_bounds__(LANES)
pack_lc_kernel(const float* __restrict__ x, long long n,
               const float* __restrict__ eb_ptr, float eb_floor,
               float tighten, RelParams rp, int maxbin, bool narrow,
               long long n_chunks, uint8_t* __restrict__ outlier,
               uint32_t* __restrict__ sign_words, uint32_t* __restrict__ sel,
               int32_t* __restrict__ codes) {
  constexpr int VPW = 32 / BITS;
  constexpr int CPG = GROUP / VPW / CHUNK_ROWS;  // chunks per row group
  constexpr uint32_t MASK = BITS == 32 ? 0xFFFFFFFFu : ((1u << BITS) - 1u);
  __shared__ uint32_t red[CPG][WARPS];
  const long long g = blockIdx.x;
  const int lane = threadIdx.x;
  AbsParams ap = {};
  if constexpr (!REL) ap = abs_params(eb_ptr, eb_floor, tighten, maxbin);
  uint32_t sign = 0;
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    uint32_t w[CHUNK_ROWS];
    uint32_t mx = 0u;
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        const int j = (c * CHUNK_ROWS + r) * VPW + i;   // row in the group
        const long long e = (g * GROUP + j) * LANES + lane;
        const bool in = e < n;
        const float v = in ? x[e] : 0.0f;
        bool out;
        int bin;
        if constexpr (REL) {
          bin = rel_quantize(v, rp, out);
          sign |= (uint32_t)(__float_as_int(v) < 0) << j;
        } else {
          bin = abs_quantize(v, ap, out);
        }
        if (in) outlier[e] = out ? 1 : 0;
        word |= ((uint32_t)bin & MASK) << (i * BITS);
      }
      w[r] = word;
      mx = max_u32(mx, word);
    }
    const uint32_t code = chunk_code(chunk_max(mx, red[c]), narrow);
    const long long chunk = g * CPG + c;       // the same for the block
    if (chunk < n_chunks) {
      store_narrowed(w, code, sel + chunk * CHUNK + lane);
      if (lane == 0) codes[chunk] = (int32_t)code;
    }
  }
  if constexpr (REL) sign_words[g * LANES + lane] = sign;
}

// Chunk select on an existing word plane of n_words words; the ragged tail
// of the last chunk reads as the zero words the reference pads with.
__global__ void __launch_bounds__(LANES)
select_kernel(const uint32_t* __restrict__ words, long long n_words,
              bool narrow, long long n_chunks, uint32_t* __restrict__ sel,
              int32_t* __restrict__ codes) {
  __shared__ uint32_t red[SEL_CHUNKS][WARPS];
  const int lane = threadIdx.x;
  for (int c = 0; c < SEL_CHUNKS; ++c) {
    const long long chunk = (long long)blockIdx.x * SEL_CHUNKS + c;
    if (chunk >= n_chunks) break;              // the same for the block
    uint32_t w[CHUNK_ROWS];
    uint32_t mx = 0u;
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      const long long i = chunk * CHUNK + r * LANES + lane;
      w[r] = i < n_words ? words[i] : 0u;
      mx = max_u32(mx, w[r]);
    }
    const uint32_t code = chunk_code(chunk_max(mx, red[c]), narrow);
    store_narrowed(w, code, sel + chunk * CHUNK + lane);
    if (lane == 0) codes[chunk] = (int32_t)code;
  }
}

// Inverse of the select for the valid prefix: one thread per (chunk, lane)
// widens its lane of the chunk image back to 4 words, reading only the
// rows the code needs, and writes those of the first n_words words.
__global__ void __launch_bounds__(EXP_BLOCK)
expand_kernel(const uint32_t* __restrict__ padded,
              const int32_t* __restrict__ codes, long long n_chunks,
              uint32_t* __restrict__ words, long long n_words) {
  const long long t = (long long)blockIdx.x * EXP_BLOCK + threadIdx.x;
  const long long chunk = t / LANES;
  const int lane = (int)(t % LANES);
  if (chunk >= n_chunks) return;
  const uint32_t code = (uint32_t)codes[chunk];
  const uint32_t* p = padded + chunk * CHUNK + lane;
  uint32_t o[CHUNK_ROWS] = {0u, 0u, 0u, 0u};
  if (code == 1u) {
    const uint32_t b = p[0];
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) o[r] = (b >> (8 * r)) & 0xFFu;
  } else if (code == 2u) {
    const uint32_t a = p[0], b = p[LANES];
    o[0] = a & 0xFFFFu;
    o[1] = a >> 16;
    o[2] = b & 0xFFFFu;
    o[3] = b >> 16;
  } else if (code == 3u) {
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) o[r] = p[r * LANES];
  }
#pragma unroll
  for (int r = 0; r < CHUNK_ROWS; ++r) {
    const long long i = chunk * CHUNK + r * LANES + lane;
    if (i < n_words) words[i] = o[r];
  }
}

template <bool REL>
int launch_pack_lc(int bits, const float* x, long long n, const float* eb,
                   float eb_floor, float tighten, RelParams rp, int maxbin,
                   int narrow, long long n_chunks, uint8_t* outlier,
                   uint32_t* sign_words, uint32_t* sel, int32_t* codes,
                   cudaStream_t s) {
  const long long groups = (n + GROUP * LANES - 1) / (GROUP * LANES);
  if (groups == 0) return 0;
  const unsigned grid = (unsigned)groups;
  const bool nar = narrow != 0;
  switch (bits) {
    case 8: pack_lc_kernel<8, REL><<<grid, LANES, 0, s>>>(x, n, eb, eb_floor, tighten, rp, maxbin, nar, n_chunks, outlier, sign_words, sel, codes); break;
    case 16: pack_lc_kernel<16, REL><<<grid, LANES, 0, s>>>(x, n, eb, eb_floor, tighten, rp, maxbin, nar, n_chunks, outlier, sign_words, sel, codes); break;
    case 32: pack_lc_kernel<32, REL><<<grid, LANES, 0, s>>>(x, n, eb, eb_floor, tighten, rp, maxbin, nar, n_chunks, outlier, sign_words, sel, codes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C API --
// Every entry launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch (0 = ok).
// `narrow` is 1 for stage narrow, 0 for stage zero; sel holds n_chunks*512
// words and codes n_chunks int32.

extern "C" int repro_abs_pack_lc(const float* x, long long n, const float* eb,
                                 int bits, int maxbin, float tighten,
                                 float eb_floor, int narrow,
                                 long long n_chunks, uint8_t* outlier,
                                 uint32_t* sel, int32_t* codes,
                                 void* stream) {
  RelParams unused = {};
  return launch_pack_lc<false>(bits, x, n, eb, eb_floor, tighten, unused,
                               maxbin, narrow, n_chunks, outlier, nullptr,
                               sel, codes, (cudaStream_t)stream);
}

extern "C" int repro_rel_pack_lc(const float* x, long long n, int bits,
                                 int maxbin, float ebT, float log_step,
                                 float inv_log_step, float screen, float tiny,
                                 int narrow, long long n_chunks,
                                 uint8_t* outlier, uint32_t* sign_words,
                                 uint32_t* sel, int32_t* codes,
                                 void* stream) {
  RelParams rp;
  rp.ebT = ebT;
  rp.log_step = log_step;
  rp.inv_log_step = inv_log_step;
  rp.screen = screen;
  rp.tiny = tiny;
  rp.maxbin = maxbin;
  rp.maxbin_f = (float)maxbin;      // host round-to-nearest, as numpy does
  return launch_pack_lc<true>(bits, x, n, nullptr, 0.0f, 0.0f, rp, maxbin,
                              narrow, n_chunks, outlier, sign_words, sel,
                              codes, (cudaStream_t)stream);
}

extern "C" int repro_lc_select(const uint32_t* words, long long n_words,
                               int narrow, long long n_chunks, uint32_t* sel,
                               int32_t* codes, void* stream) {
  if (n_chunks == 0) return 0;
  const unsigned grid = (unsigned)((n_chunks + SEL_CHUNKS - 1) / SEL_CHUNKS);
  select_kernel<<<grid, LANES, 0, (cudaStream_t)stream>>>(
      words, n_words, narrow != 0, n_chunks, sel, codes);
  return (int)cudaGetLastError();
}

extern "C" int repro_lc_expand(const uint32_t* padded, const int32_t* codes,
                               long long n_chunks, uint32_t* words,
                               long long n_words, void* stream) {
  if (n_chunks == 0) return 0;
  const unsigned grid =
      (unsigned)((n_chunks * LANES + EXP_BLOCK - 1) / EXP_BLOCK);
  expand_kernel<<<grid, EXP_BLOCK, 0, (cudaStream_t)stream>>>(
      padded, codes, n_chunks, words, n_words);
  return (int)cudaGetLastError();
}

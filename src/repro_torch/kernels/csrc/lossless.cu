// The chunked zero/narrow coder (DESIGN.md §6) for Hopper (sm_90a): the
// CUDA counterparts of the four Pallas kernels in
// src/repro/kernels/lossless.py:
//
//   pack_lc_kernel<BITS, false>      replaces _abs_pack_lc_kernel  (lossless.py:110)
//   pack_lc_kernel<BITS, true>       replaces _rel_pack_lc_kernel  (lossless.py:128)
//   select_compact_kernel<false>     replaces _lc_select_kernel    (lossless.py:100)
//   gather_expand_kernel             replaces _lc_expand_kernel    (lossless.py:106)
//
// Each computes what its TPU kernel computes, bit for bit (the plain torch
// versions in kernels/lossless.py are the oracle).  A chunk is 512 words =
// 4 word rows x 128 lanes of the §4 word plane.  Per chunk: the unsigned
// max word gives a 2-bit code (stage zero: 0 or 3; stage narrow: 0, < 2^8,
// < 2^16, else 3), and the chunk is narrowed to 8 or 16 bits per word,
// left-aligned (width 8 packs rows 0-3 into row 0; width 16 packs rows 0-1
// into row 0 and rows 2-3 into row 1 — the reference's pack_words at chunk
// granularity).
//
// The TPU kernels write and read a chunk image padded to 512 words a chunk,
// and the compaction to true lengths (a cumsum and a scatter), the 2-bit
// header pack and, on decode, the header unpack and the gather stay XLA
// ops there (src/repro/core/codec.py:495-525).  On this card they are
// folded into the two kernels: select_compact_kernel writes the compacted
// payload, its zero tail, the payload length and the 2-bit header of each
// row (stream) in one launch, and gather_expand_kernel reads the header and
// the used payload words back and writes the words.  A chunk's payload
// offset is the sum of the lengths of the chunks before it in its row: a
// segmented exclusive scan over all rows' chunks, by single-pass decoupled
// look-back (tile_offset).  Placement (chunk.cuh): a chunk writes its len
// data words at [off, off + len) and its 512 - len empty slots as zeros at
// the end of the row, so the payload is written once, with no memset, in
// 16-byte stores (every offset is a multiple of 128 words).  The header's
// 2-bit codes go in with atomicOr into a plane zeroed, with the look-back
// scratch, by one memset.
//
// Thread layouts.  pack_lc_kernel (pack.cu's): one thread owns one (group
// of 32 element rows, lane), so a chunk's 4 word rows x 128 lanes lie
// inside the 128 threads (4 warps) of one row group, which is one block.
// The chunk max is __reduce_max_sync in each warp, then the 4 warps through
// shared memory.  select_compact_kernel and gather_expand_kernel: one warp
// per chunk, TILE_WARPS warps x CPW chunks a block (a tile); lane l holds
// words 4l..4l+3 of each of the chunk's 4 rows as one uint4 per row, which
// is everything the narrowing of output words 4l..4l+3 reads, so a chunk
// needs no shared memory and one warp reduction.
//
// Bound: all four are memory-bound (a few integer operations per word
// beside the quantizers' ~2 flop/byte).  The fused pack kernels write the
// chunk image and codes, never the plain word plane.  The select reads its
// words (or the image's used words) once and writes the payload, the
// header and the lengths; the expand reads the header and the used
// payload words and writes the words.
#include "quantize.cuh"
#include "chunk.cuh"

namespace {

constexpr int CHUNK_ROWS = 4;                  // word rows per chunk
constexpr int CHUNK = CHUNK_ROWS * LANES;      // 512 words
constexpr int WARPS = LANES / 32;              // warps across one chunk
constexpr int TILE_WARPS = 8;                  // warps of a select/expand block
constexpr int CPW = 2;                         // chunks per warp
constexpr int TILE = TILE_WARPS * CPW;         // chunks per tile (block)
constexpr int TILE_THREADS = TILE_WARPS * 32;
constexpr int SCRATCH_HEAD = 4;                // words before the status words
constexpr unsigned FULL = 0xFFFFFFFFu;
// A tile's status word: flag in bits 63-62, the value in bits 31-0.
constexpr unsigned long long ST_AGG = 1ull << 62;  // value: the tile's sum
constexpr unsigned long long ST_INC = 2ull << 62;  // value: the row's prefix
static_assert(TILE <= 32, "the tile scan runs in one warp");
static_assert(CHUNK == lc::kChunk && LANES == lc::kLanes, "chunk layout");

__device__ __forceinline__ uint32_t max_u32(uint32_t a, uint32_t b) {
  return a > b ? a : b;
}

// Unsigned max of v over the block's 128 threads (one chunk's lanes).
// `red` is a slot of WARPS words used by this call only.
__device__ __forceinline__ uint32_t chunk_max(uint32_t v, uint32_t* red) {
  uint32_t m = __reduce_max_sync(FULL, v);
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
// device memory).  Writes the padded chunk image and the codes;
// select_compact_kernel<true> compacts them.
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
    const uint32_t code = lc::chunk_code(chunk_max(mx, red[c]), narrow);
    const long long chunk = g * CPG + c;       // the same for the block
    if (chunk < n_chunks) {
      store_narrowed(w, code, sel + chunk * CHUNK + lane);
      if (lane == 0) codes[chunk] = (int32_t)code;
    }
  }
  if constexpr (REL) sign_words[g * LANES + lane] = sign;
}

// ------------------------------------------------ the chunk offsets scan --

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The row offset of one chunk of the tile, run by all of warp 0: lane i
// holds chunk tile * TILE + i, its length `len` and whether it starts a
// row (`start`); lanes past the tile or the last chunk hold 0 and false.
// A segmented inclusive scan in the warp gives each chunk the sum since
// its row's start inside the tile.  The tile then publishes its status: a
// tile holding a row start knows its last row's prefix at once (ST_INC);
// one inside a row publishes its sum (ST_AGG) and, if its first chunk does
// not start a row, looks back over the tiles before it, 32 at a time,
// adding sums until a prefix, then publishes its own prefix.  Tiles take
// their ids from an atomic counter in launch order, so every tile waited
// on is already running and forward progress holds.  Row prefixes fit 32
// bits: the wrapper caps a row at 2^31 - 1 payload words.
__device__ __forceinline__ uint32_t tile_offset(long long tile, uint32_t len,
                                                bool start,
                                                unsigned long long* status) {
  const int lane = threadIdx.x & 31;
  uint32_t v = len;
  bool seen = start;             // a row starts at or before this lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t v_up = __shfl_up_sync(FULL, v, d);
    const int seen_up = __shfl_up_sync(FULL, (int)seen, d);
    if (lane >= d) {
      if (!seen) v += v_up;
      seen = seen || seen_up != 0;
    }
  }
  const uint32_t last = __shfl_sync(FULL, v, 31);
  const bool any_start = __shfl_sync(FULL, (int)seen, 31) != 0;
  const bool start0 = __shfl_sync(FULL, (int)start, 0) != 0;
  if (lane == 0) st_release(status + tile, (any_start ? ST_INC : ST_AGG) | last);
  uint32_t excl = 0u;
  if (!start0) {                 // the same for the warp
    long long pred = tile - 1;
    for (;;) {
      const long long t = pred - lane;
      unsigned long long s = ST_INC;   // before tile 0: a prefix of 0
      if (t >= 0) {
        do {
          s = ld_acquire(status + t);
        } while ((s >> 62) == 0ull);
      }
      const unsigned inc = __ballot_sync(FULL, (s >> 62) == 2ull);
      const uint32_t val = (uint32_t)s;
      if (inc != 0u) {
        const int k = __ffs(inc) - 1;  // the nearest tile with a prefix
        excl += __reduce_add_sync(FULL, lane <= k ? val : 0u);
        break;
      }
      excl += __reduce_add_sync(FULL, val);
      pred -= 32;
    }
    if (lane == 0 && !any_start) st_release(status + tile, ST_INC | (excl + last));
  }
  return v - len + (seen ? 0u : excl);
}

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint32_t umax4(uint4 v) {
  return max_u32(max_u32(v.x, v.y), max_u32(v.z, v.w));
}

__device__ __forceinline__ uint32_t pack8(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return (a & 0xFFu) | ((b & 0xFFu) << 8) | ((c & 0xFFu) << 16) |
         ((d & 0xFFu) << 24);
}

__device__ __forceinline__ uint32_t pack16(uint32_t a, uint32_t b) {
  return (a & 0xFFFFu) | ((b & 0xFFFFu) << 16);
}

// Narrow a chunk held as w[r] = words r*128 + 4l .. +3 in lane l: output
// word r*128 + 4l + j of the narrowed chunk ends up in w[r] component j.
__device__ __forceinline__ void narrow_chunk(uint4 w[CHUNK_ROWS],
                                             uint32_t code) {
  if (code == 1u) {
    w[0] = make_uint4(pack8(w[0].x, w[1].x, w[2].x, w[3].x),
                      pack8(w[0].y, w[1].y, w[2].y, w[3].y),
                      pack8(w[0].z, w[1].z, w[2].z, w[3].z),
                      pack8(w[0].w, w[1].w, w[2].w, w[3].w));
  } else if (code == 2u) {
    w[0] = make_uint4(pack16(w[0].x, w[1].x), pack16(w[0].y, w[1].y),
                      pack16(w[0].z, w[1].z), pack16(w[0].w, w[1].w));
    w[1] = make_uint4(pack16(w[2].x, w[3].x), pack16(w[2].y, w[3].y),
                      pack16(w[2].z, w[3].z), pack16(w[2].w, w[3].w));
  }
}

// The inverse for the valid prefix: p[r] holds narrowed words
// r*128 + 4l .. +3; returns output row r's words 4l .. +3.
__device__ __forceinline__ uint4 widen_row(const uint4 p[CHUNK_ROWS],
                                           uint32_t code, int r) {
  if (code == 1u) {
    const int s = 8 * r;
    return make_uint4((p[0].x >> s) & 0xFFu, (p[0].y >> s) & 0xFFu,
                      (p[0].z >> s) & 0xFFu, (p[0].w >> s) & 0xFFu);
  }
  if (code == 2u) {
    const uint4 q = p[r >> 1];
    const int s = 16 * (r & 1);
    return make_uint4((q.x >> s) & 0xFFFFu, (q.y >> s) & 0xFFFFu,
                      (q.z >> s) & 0xFFFFu, (q.w >> s) & 0xFFFFu);
  }
  if (code == 3u) return p[r];
  return make_uint4(0u, 0u, 0u, 0u);
}

// B6: chunk select and compaction of `rows` streams in one pass.
// IMAGE false: `in` holds rows of n_in words at row stride in_stride; the
// ragged tail of a row's last chunk reads as zero words.  IMAGE true: `in`
// is pack_lc_kernel's chunk image [rows * nc * 512] with its codes, and
// only each chunk's used words are read.  Writes payload [rows, 512 nc]
// (the chunks at their true lengths, then zeros), plen [rows] and the
// 2-bit codes into header [rows, hw] (zeroed by the caller).  `vec`: rows
// and n_in allow 16-byte loads.
template <bool IMAGE>
__global__ void __launch_bounds__(TILE_THREADS)
select_compact_kernel(const uint32_t* __restrict__ in, long long in_stride,
                      const int32_t* __restrict__ in_codes, long long n_in,
                      bool vec, bool narrow, long long rows, long long nc,
                      long long hw, uint32_t* __restrict__ header,
                      unsigned int* counter, unsigned long long* status,
                      uint32_t* __restrict__ payload,
                      int32_t* __restrict__ plen) {
  __shared__ unsigned int s_tile;
  __shared__ uint32_t s_len[TILE];
  __shared__ uint32_t s_off[TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long total = rows * nc, cap = nc * CHUNK;
  uint4 w[CPW][CHUNK_ROWS];
  uint32_t code[CPW];
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int i = warp * CPW + k;
    const long long g = tile * TILE + i;
    code[k] = 0u;
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) w[k][r] = make_uint4(0u, 0u, 0u, 0u);
    if (g >= total) {            // the same for the warp
      if (lane == 0) s_len[i] = 0u;
      continue;
    }
    const long long row = g / nc, c = g - row * nc;
    if constexpr (IMAGE) {
      code[k] = (uint32_t)in_codes[g] & 3u;
      const uint32_t len = lc::chunk_len(code[k]);
#pragma unroll
      for (int r = 0; r < CHUNK_ROWS; ++r)
        if ((uint32_t)(r * LANES) < len)
          w[k][r] = load4(in + g * CHUNK + r * LANES + 4 * lane);
    } else {
      const uint32_t* src = in + row * in_stride;
      uint32_t mx = 0u;
#pragma unroll
      for (int r = 0; r < CHUNK_ROWS; ++r) {
        const long long e = c * CHUNK + r * LANES + 4 * lane;
        if (vec) {
          if (e < n_in) w[k][r] = load4(src + e);
        } else {
          w[k][r] = make_uint4(e < n_in ? src[e] : 0u,
                               e + 1 < n_in ? src[e + 1] : 0u,
                               e + 2 < n_in ? src[e + 2] : 0u,
                               e + 3 < n_in ? src[e + 3] : 0u);
        }
        mx = max_u32(mx, umax4(w[k][r]));
      }
      code[k] = lc::chunk_code(__reduce_max_sync(FULL, mx), narrow);
      narrow_chunk(w[k], code[k]);
    }
    if (lane == 0) {
      s_len[i] = lc::chunk_len(code[k]);
      if (code[k] != 0u)
        atomicOr(header + row * hw + lc::header_word(c),
                 code[k] << lc::header_shift(c));
    }
  }
  __syncthreads();
  if (warp == 0) {
    const long long g = tile * TILE + lane;
    const bool valid = lane < TILE && g < total;
    const long long row = valid ? g / nc : 0, c = valid ? g - row * nc : 0;
    const uint32_t len = valid ? s_len[lane] : 0u;
    const uint32_t off = tile_offset(tile, len, valid && c == 0, status);
    if (lane < TILE) s_off[lane] = off;
    if (valid && c == nc - 1) plen[row] = (int32_t)(off + len);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int i = warp * CPW + k;
    const long long g = tile * TILE + i;
    if (g >= total) continue;
    const long long row = g / nc, c = g - row * nc;
    const uint32_t len = lc::chunk_len(code[k]);
    const long long off = s_off[i];
    const long long zs = lc::zero_start(cap, c, off, len);
    uint32_t* dst = payload + row * cap + 4 * lane;
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      const uint32_t slot = r * LANES;
      if (slot < len)
        store4(dst + off + slot, w[k][r]);
      else
        store4(dst + zs + (slot - len), make_uint4(0u, 0u, 0u, 0u));
    }
  }
}

// B7: header unpack, gather and expand of `rows` streams in one pass.
// header [rows, row stride h_stride] holds each row's 2-bit codes, payload
// [rows, width] (row stride p_stride) the compacted chunks.  A chunk reads
// only its used words; a source index is clipped to [0, width - 1], as
// the reference's gather clips it (a short or corrupt plane decodes
// deterministically).  Writes words [rows, n_out] (contiguous).
// `pay_vec` / `out_vec`: 16-byte loads / stores are aligned.
__global__ void __launch_bounds__(TILE_THREADS)
gather_expand_kernel(const uint32_t* __restrict__ header, long long h_stride,
                     const uint32_t* __restrict__ payload, long long p_stride,
                     long long width, bool pay_vec, long long rows,
                     long long nc, long long n_out, bool out_vec,
                     unsigned int* counter, unsigned long long* status,
                     uint32_t* __restrict__ words) {
  __shared__ unsigned int s_tile;
  __shared__ uint32_t s_code[TILE];
  __shared__ uint32_t s_off[TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long total = rows * nc;
  if (warp == 0) {
    const long long g = tile * TILE + lane;
    const bool valid = lane < TILE && g < total;
    const long long row = valid ? g / nc : 0, c = valid ? g - row * nc : 0;
    const uint32_t code =
        valid ? (header[row * h_stride + lc::header_word(c)] >>
                 lc::header_shift(c)) & 3u
              : 0u;
    const uint32_t off =
        tile_offset(tile, lc::chunk_len(code), valid && c == 0, status);
    if (lane < TILE) {
      s_code[lane] = code;
      s_off[lane] = off;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int i = warp * CPW + k;
    const long long g = tile * TILE + i;
    if (g >= total) continue;    // the same for the warp
    const long long row = g / nc, c = g - row * nc;
    const uint32_t code = s_code[i], len = lc::chunk_len(code);
    const long long off = s_off[i];
    const uint32_t* src = payload + row * p_stride;
    const bool fast = pay_vec && off + len <= width;
    uint4 p[CHUNK_ROWS];
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      p[r] = make_uint4(0u, 0u, 0u, 0u);
      if ((uint32_t)(r * LANES) >= len) continue;
      const long long s = off + r * LANES + 4 * lane;
      if (fast) {
        p[r] = load4(src + s);
      } else {
        const long long top = width - 1;
        p[r] = make_uint4(src[s < top ? s : top], src[s + 1 < top ? s + 1 : top],
                          src[s + 2 < top ? s + 2 : top],
                          src[s + 3 < top ? s + 3 : top]);
      }
    }
    uint32_t* dst = words + row * n_out;
#pragma unroll
    for (int r = 0; r < CHUNK_ROWS; ++r) {
      const uint4 o = widen_row(p, code, r);
      const long long e = c * CHUNK + r * LANES + 4 * lane;
      if (out_vec) {
        if (e < n_out) store4(dst + e, o);
      } else {
        if (e < n_out) dst[e] = o.x;
        if (e + 1 < n_out) dst[e + 1] = o.y;
        if (e + 2 < n_out) dst[e + 2] = o.z;
        if (e + 3 < n_out) dst[e + 3] = o.w;
      }
    }
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

long long tiles_of(long long chunks) { return (chunks + TILE - 1) / TILE; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// ---------------------------------------------------------------- C API --
// Every entry launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch (0 = ok).
// `narrow` is 1 for stage narrow, 0 for stage zero.

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

// Scratch words the select and the expand need after their header (select)
// or output (expand): a tile counter and one 64-bit status word a tile.
extern "C" long long repro_lc_scratch_words(long long chunks) {
  return SCRATCH_HEAD + 2 * tiles_of(chunks);
}

// B6.  codes == NULL: `in` is rows of n_in words at row stride in_stride.
// Else `in` is pack_lc_kernel's image of one row, n_in = 512 * its chunks,
// with its codes.  `hs` is the header [rows, header_words(nc)] followed by
// repro_lc_scratch_words(rows * nc) words; one memset zeroes both.
extern "C" int repro_lc_select(const uint32_t* in, long long in_stride,
                               const int32_t* codes, long long rows,
                               long long n_in, int narrow, uint32_t* payload,
                               uint32_t* hs, int32_t* plen, void* stream) {
  const long long nc = (n_in + CHUNK - 1) / CHUNK, total = rows * nc;
  if (total == 0) return 0;
  if (nc * CHUNK > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long hw = lc::header_words(nc);
  uint32_t* scratch = hs + rows * hw;
  const long long zero_words = rows * hw + repro_lc_scratch_words(total);
  cudaError_t err = cudaMemsetAsync(hs, 0, (size_t)zero_words * 4, s);
  if (err != cudaSuccess) return (int)err;
  unsigned int* counter = scratch;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + SCRATCH_HEAD);
  const unsigned grid = (unsigned)tiles_of(total);
  const bool vec = in_stride % 4 == 0 && n_in % 4 == 0 && aligned16(in);
  if (codes == nullptr) {
    select_compact_kernel<false><<<grid, TILE_THREADS, 0, s>>>(
        in, in_stride, nullptr, n_in, vec, narrow != 0, rows, nc, hw, hs,
        counter, status, payload, plen);
  } else {
    if (n_in % CHUNK != 0 || !aligned16(in)) return (int)cudaErrorInvalidValue;
    select_compact_kernel<true><<<grid, TILE_THREADS, 0, s>>>(
        in, n_in, codes, n_in, true, narrow != 0, rows, nc, hw, hs, counter,
        status, payload, plen);
  }
  return (int)cudaGetLastError();
}

// B7.  `scratch` holds repro_lc_scratch_words(rows * nc) words; zeroed
// here by one memset.
extern "C" int repro_lc_expand(const uint32_t* header, long long h_stride,
                               const uint32_t* payload, long long p_stride,
                               long long width, long long rows,
                               long long n_in, uint32_t* words,
                               uint32_t* scratch, void* stream) {
  const long long nc = (n_in + CHUNK - 1) / CHUNK, total = rows * nc;
  if (total == 0) return 0;
  if (nc * CHUNK > 0x7FFFFFFFLL || width < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)repro_lc_scratch_words(total) * 4, s);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + SCRATCH_HEAD);
  const bool pay_vec = p_stride % 4 == 0 && aligned16(payload);
  const bool out_vec = n_in % 4 == 0 && aligned16(words);
  gather_expand_kernel<<<(unsigned)tiles_of(total), TILE_THREADS, 0, s>>>(
      header, h_stride, payload, p_stride, width, pay_vec, rows, nc, n_in,
      out_vec, scratch, status, words);
  return (int)cudaGetLastError();
}

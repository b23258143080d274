// Flash-decode attention over the int8 paged KV cache for Hopper (sm_90a),
// the CUDA counterpart of the Pallas kernel in src/repro/kernels/:
//
//   kv_split_kernel, with kv_merge_kernel,  replaces kv_attention.py:39 _kernel
//
// For one query token per sequence: q [B, G, Hg, D] against a cache whose K
// and V are QuantizedKV planes (compression/kv.py): int8 bins [B, G, S, D],
// a pow2 step eb2 per page of P tokens, and per page up to `cap` exact
// outlier values at flat in-page indices (-1 = empty slot).  The output is
// softmax(q k^T / sqrt(D), masked to tokens < lengths[b]) v, in float32.
// The kernels are templates over D (and Hg); D = 128 (internlm2, olmoe,
// qwen3-moe) and D = 80 (stablelm-3b) are instantiated, the page is 128
// tokens for both.  At D = 80 a tile row is 80 bytes (five 16-byte
// chunks, stored unswizzled), QK^T takes 5 k-steps of 16 channels, p v
// 5 m-tiles of 16 channels (warps of channel group 3 sit it out, those of
// group 2 half), and the merge has 80 threads a group.
//
// Bound.  Per page the work reads 2 P D bytes of bins (32 KB at D = 128)
// and does ~4 Hg P D operations: ~12 flop/byte at Hg = 6, near the card's
// float32 ridge, so on
// CUDA cores the arithmetic (with its int8 conversions, shared-memory
// operands and softmax) costs more than the bytes.  The dots go to the
// tensor cores instead, and the bytes set the bound.
//
// Design (flash-decoding; its measured steps are in PERF.md).
//  * Split.  The grid is (B G, splits): block (bg, j) takes pages
//    [j pps, (j + 1) pps) of (b, g), cut at the last page that holds a
//    token < lengths[b].  The wrapper picks pps from the shapes and the SM
//    count only, so lengths stay on the card (no host sync); a block whose
//    first page lies past the length exits at once and writes nothing.  At
//    B = 32, G = 8, S = 32K, pps = 16 gives 4,096 blocks of at most 16
//    pages: many short waves, which even out ragged lengths.  Each block
//    writes its partial softmax state (m, l, acc[Hg, D]) to a float32
//    workspace; kv_merge_kernel reads the splits that hold pages
//    (ceil(ceil(len / P) / pps), recomputed from lengths) and combines them:
//    m = max m_i (NaN propagating, as jnp.maximum), w_i = exp(m_i - m),
//    out = sum w_i acc_i / sum w_i l_i.  With length 0 no split is read and
//    the output is 0/0 = NaN.
//  * Int8 tiles, loaded asynchronously.  A ring of STAGES = 3 stages, each
//    the K and V tiles of one page (16 KB each, int8) and the page's eb2 and
//    outlier slots, is filled with cp.async (16-byte copies for the tiles,
//    4-byte ones for the side data), so the loads of pages i+1 and i+2 are
//    in flight while page i is computed.  With the scores and p the block
//    needs 110 KB at Hg <= 8, so two blocks (16 warps) fit an SM.  The
//    16-byte chunks of each row are XOR swizzled on the copy (k_chunk,
//    v_chunk) so that the fragment reads below are free of bank conflicts.
//  * Tensor cores, exactly enough.  Both products run as mma.m16n8k16 in
//    bf16 with float32 accumulators: S^T = K q^T and O^T = V^T p^T.  A bin
//    is exact in bf16; q and p are each split into three bf16 parts
//    (hi + mid + lo, each cut from the rest, |rest| < 2^-23 |x|), one
//    accumulator per part, so the products keep float32 precision.  A byte
//    b becomes a float with no I2F: (b ^ 0x80) placed as the low mantissa
//    byte of 2^23 (__byte_perm) minus 2^23 + 128 is b exactly; two such
//    floats pack into a bf16x2 with one more __byte_perm.  eb2 is a power
//    of two, so q (bin eb2) = (q bin) eb2 exactly (barring under/overflow):
//    the scale moves out of the products, once per score and once per page
//    of p v.  Channels and tokens are permuted inside each product (the sum
//    does not care) so that every thread's operands are whole words.
//  * Outliers as corrections.  The encoder zeroed the bins of the exact
//    values, so each K slot (t, d, val) adds q[h, d] val / sqrt(D) to
//    score[h, t] (for t < length) and each V slot adds p[h, t] val to
//    acc[h, d]: the plain version's scatter up to the order of the sums,
//    with the reference's inf and NaN positions for non-finite values.  A
//    warp finds the live slots of a page with one ballot.
//  * Per page: (1) wait for the stage, sync, issue the load of page i + 2;
//    (2) scores, warp w = tokens 16 w .. 16 w + 15, scaled, masked to -1e30
//    past the length; (3) online softmax, a warp per head, m and l in that
//    warp's registers, p written as float32 and as its three bf16 parts;
//    (4) p v, warp w = channels 32 (w % 4) .. + 31 over tokens 64 (w / 4)
//    .. + 63, acc in the mma's registers (the two token halves are added
//    once, at the end of the split).  Three __syncthreads per page.
//    Masked tokens inside the last page read still enter p v with p = 0,
//    so a non-finite V value there gives NaN where the reference does;
//    pages wholly past the length are not read (ROADMAP C-port-3).
//  * The sums run in another order than the reference's, so the output
//    agrees within rtol = atol = 2e-5, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KP = 128;                 // page P (tokens)
constexpr int MAX_HG = 16;
constexpr int MAX_CAP = 64;
constexpr int NT = 256;                 // threads of a split block
constexpr int NWARP = NT / 32;
constexpr int STAGES = 3;               // pages in the cp.async ring
constexpr int PS_STRIDE = KP + 4;       // floats per head row of scores / p
constexpr int P3_STRIDE = KP + 16;      // bf16 per head row of a p part
constexpr float NEG_BIG = -1e30f;
constexpr float MAGIC = 8388736.0f;     // 2^23 + 128

// jnp.maximum: NaN in either operand propagates (fmaxf would drop it).
__device__ __forceinline__ float max_nan2(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Byte j of w (already XOR 0x80808080) as a float: exact, no I2F.
__device__ __forceinline__ float byte_to_float(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) - MAGIC;
}

// Two floats whose low 16 bits are zero as one bf16x2 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// x with its mantissa cut to bf16's 8 bits (exact as a bf16).
__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// x = hi + mid + lo + r, |r| < 2^-23 |x|: three bf16 parts of a float.
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  p[0] = trunc_bf16(x);
  float r = x - p[0];
  p[1] = trunc_bf16(r);
  p[2] = trunc_bf16(r - p[1]);
}

// D += A B, m16n8k16, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of one int8 tile (a page of K or of V) at head dim D.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return KP * D;
}

// Where 16-byte chunk c of row r of a tile lands.  At D = 128: K rows XOR
// by (r & 7) (a thread reads 32 bytes of one row; 8 rows in a phase), V
// rows by 2 ((r >> 2) & 3) (a thread reads one word of 4 consecutive
// rows).  At D = 80 (five chunks a row) in place: the score reads, one
// word at channel 20 c4 + 4 s of rows g, are conflict-free as they lie.
template <int D>
__device__ __forceinline__ int k_chunk(int r, int c) {
  return D == 128 ? c ^ (r & 7) : c;
}
template <int D>
__device__ __forceinline__ int v_chunk(int r, int c) {
  return D == 128 ? c ^ (2 * ((r >> 2) & 3)) : c;
}

// Bytes of one stage's side data: eb2 of K and V, then K idx, K val,
// V idx, V val (cap each), rounded up to 16.
__host__ __device__ __forceinline__ int side_bytes(int cap) {
  return (8 + 16 * cap + 15) / 16 * 16;
}

__host__ __device__ constexpr int padded_heads(int hg) {
  return (hg + 7) / 8 * 8;
}

__host__ __device__ inline int split_smem(int d, int hg, int cap) {
  const int hgp = padded_heads(hg);
  return STAGES * (2 * KP * d + side_bytes(cap)) +
         hgp * PS_STRIDE * 4 + 3 * hgp * P3_STRIDE * 2 + hgp * 4;
}

struct Cache {
  const int8_t* bins;
  const float* eb2;
  const int* idx;
  const float* val;
};

// Bit i of the result: slot 32 k + i (< cap) of idx holds an in-page
// index (one ballot of the warp).
template <int D>
__device__ __forceinline__ unsigned live_slots(const int* idx, int cap,
                                               int k) {
  const int e = 32 * k + threadIdx.x % 32;
  const int v = e < cap ? idx[e] : -1;
  return __ballot_sync(0xFFFFFFFFu, v >= 0 && v < tile_bytes<D>());
}

// Issue the copies of global page `page` into stage buffer `tile`/`side`.
template <int D>
__device__ __forceinline__ void load_page(const Cache& k, const Cache& v,
                                          size_t page, int cap, int8_t* tile,
                                          char* side) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int CHUNKS = TILE / 16, CPR = D / 16;  // chunks a tile, a row
  const int tid = threadIdx.x;
  const int8_t* ksrc = k.bins + page * TILE;
  const int8_t* vsrc = v.bins + page * TILE;
#pragma unroll
  for (int r = 0; r < (CHUNKS + NT - 1) / NT; ++r) {
    int j = r * NT + tid;                   // 16-byte chunk of the tile
    if (CHUNKS % NT != 0 && j >= CHUNKS) break;
    int row = j / CPR, c = j % CPR;
    cp_async16(tile + row * D + 16 * k_chunk<D>(row, c), ksrc + 16 * j);
    cp_async16(tile + TILE + row * D + 16 * v_chunk<D>(row, c),
               vsrc + 16 * j);
  }
  for (int e = tid; e < 2 + 4 * cap; e += NT) {
    const void* src;
    if (e < 2) {
      src = (e == 0 ? k.eb2 : v.eb2) + page;
    } else {
      int f = (e - 2) / cap, s = (e - 2) % cap;
      size_t o = page * cap + s;
      src = f == 0 ? (const void*)(k.idx + o)
          : f == 1 ? (const void*)(k.val + o)
          : f == 2 ? (const void*)(v.idx + o) : (const void*)(v.val + o);
    }
    cp_async4(side + 4 * e, src);
  }
}

// One block of 8 warps per run of pages of one (b, g).  Fragment layouts
// are those of mma.m16n8k16 (g = lane / 4, c = lane % 4).  Scores: S^T =
// K q^T, M = tokens (warp w: m-tile w), N = heads, K = channels in D / 16
// steps, with the channel of k-index 2c + {0, 1} + 8 {0, 1} at step s
// being (D / 4) c + 4 s + 2 {0, 1} + {0, 1}: a thread reads 4 consecutive
// bytes of a row per step.  p v: O^T = V^T p^T, M = channels (warp w:
// channels 32 (w % 4) .. + 31, those below D; row g of m-tile j is channel
// 32 (w % 4) + 4g + 2j, row g + 8 the next), N = heads, K = tokens (warp
// w: tokens 64 (w / 4) .. + 63; the token of k-index 2c + {0,1} +
// 8 {0,1} at step s is 16 s + 4 c + 2 {0,1} + {0,1}).  The two token
// halves are added at the end of the split.  Each bf16 part of q and p
// has its own accumulator, so the mma chains are a third as deep.
template <int D, int HG>
__global__ void __launch_bounds__(NT, padded_heads(HG) <= 8 ? 2 : 1)
kv_split_kernel(const float* __restrict__ q, const int* __restrict__ lengths,
                Cache kc, Cache vc, float* __restrict__ ws_m,
                float* __restrict__ ws_l, float* __restrict__ ws_acc, int G,
                int S, int cap, int pps, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  constexpr int TILE = tile_bytes<D>();
  constexpr int KS = D / 16;                       // k-steps of QK^T
  constexpr int CPT = D / 4;                       // channels of a c4 lane
  constexpr int HGP = padded_heads(HG);
  constexpr int NTL = HGP / 8;                     // n-tiles of heads
  constexpr int HPW = (HG + NWARP - 1) / NWARP;    // softmax heads per warp
  extern __shared__ __align__(16) char smem[];
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);  // [STAGES][2][TILE]
  char* sides = smem + STAGES * 2 * TILE;             // [STAGES][side]
  const int sb = side_bytes(cap);
  // [HGP][PS_STRIDE] scores, then p; [3][HGP][P3_STRIDE] p's bf16 parts
  float* ps = reinterpret_cast<float*>(sides + STAGES * sb);
  uint16_t* p3 = reinterpret_cast<uint16_t*>(ps + HGP * PS_STRIDE);
  float* a_s = reinterpret_cast<float*>(p3 + 3 * HGP * P3_STRIDE);  // [HGP]

  const int bg = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bg / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int cw = warp % 4, tw = warp / 4;          // p v: channels, tokens
  const int n_pages_all = S / KP;
  const int len = lengths[b];
  const int n_used = len <= 0 ? 0 : min(n_pages_all, (len + KP - 1) / KP);
  const int p0 = split * pps;
  if (p0 >= n_used) return;                 // the merge reads no such split
  const int np = min(p0 + pps, n_used) - p0;
  const size_t page0 = (size_t)bg * n_pages_all + p0;
  const float* qg = q + (size_t)bg * HG * D;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < np)
      load_page<D>(kc, vc, page0 + s, cap, tiles + s * 2 * TILE,
                   sides + s * sb);
    cp_async_commit();
  }
  // padded heads: p = 0 and alpha = 1 throughout
  for (int i = tid; i < 3 * HGP * P3_STRIDE; i += NT) p3[i] = 0;
  for (int i = tid; i < HGP; i += NT) a_s[i] = 1.0f;

  // q^T as B fragments, three bf16 parts: head 8 n + g, channels
  // CPT c4 + 4 s + {0, 1} (b0) and + {2, 3} (b1)
  uint32_t qf[NTL][KS][3][2];
#pragma unroll
  for (int n = 0; n < NTL; ++n) {
    const int h = 8 * n + g;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      float4 v = h < HG ? *reinterpret_cast<const float4*>(
                              qg + h * D + CPT * c4 + 4 * s)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      float x0[3], x1[3], x2[3], x3[3];
      split3(v.x, x0);
      split3(v.y, x1);
      split3(v.z, x2);
      split3(v.w, x3);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        qf[n][s][part][0] = pack_bf16(x0[part], x1[part]);
        qf[n][s][part][1] = pack_bf16(x2[part], x3[part]);
      }
    }
  }

  float m_r[HPW], l_r[HPW];                 // softmax state, this warp's heads
#pragma unroll
  for (int k = 0; k < HPW; ++k) {
    m_r[k] = NEG_BIG;
    l_r[k] = 0.0f;
  }
  float acc[2][NTL][4];                     // O^T fragments, this token half
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;

  for (int i = 0; i < np; ++i) {
    cp_async_wait<STAGES - 2>();            // this thread's copies of page i
    __syncthreads();                        // everyone's; page i-1 is done
    {
      int nxt = i + STAGES - 1;
      if (nxt < np)
        load_page<D>(kc, vc, page0 + nxt, cap,
                  tiles + (nxt % STAGES) * 2 * TILE,
                  sides + (nxt % STAGES) * sb);
      cp_async_commit();
    }
    const int8_t* kt = tiles + (i % STAGES) * 2 * TILE;
    const int8_t* vt = kt + TILE;
    const char* side = sides + (i % STAGES) * sb;
    const float keb = reinterpret_cast<const float*>(side)[0];
    const float veb = reinterpret_cast<const float*>(side)[1];
    const int* kidx = reinterpret_cast<const int*>(side + 8);
    const float* kval = reinterpret_cast<const float*>(kidx + cap);
    const int* vidx = reinterpret_cast<const int*>(kval + cap);
    const float* vval = reinterpret_cast<const float*>(vidx + cap);
    const int tok0 = (p0 + i) * KP;

    // scores (times eb2 of K and 1/sqrt(D); -1e30 past the length) of
    // tokens 16 warp .. 16 warp + 15 -> ps
    {
      const int r0 = 16 * warp + g, r1 = r0 + 8;
      uint32_t kw[2][KS];                   // rows r0, r1: a word a step
      if constexpr (D == 128) {             // 32 bytes a row, two chunks
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 w0 = *reinterpret_cast<const uint4*>(
              kt + r0 * D + 16 * k_chunk<D>(r0, 2 * c4 + h));
          const uint4 w1 = *reinterpret_cast<const uint4*>(
              kt + r1 * D + 16 * k_chunk<D>(r1, 2 * c4 + h));
          kw[0][4 * h] = w0.x, kw[0][4 * h + 1] = w0.y;
          kw[0][4 * h + 2] = w0.z, kw[0][4 * h + 3] = w0.w;
          kw[1][4 * h] = w1.x, kw[1][4 * h + 1] = w1.y;
          kw[1][4 * h + 2] = w1.z, kw[1][4 * h + 3] = w1.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          kw[0][s] = *reinterpret_cast<const uint32_t*>(
              kt + r0 * D + CPT * c4 + 4 * s);
          kw[1][s] = *reinterpret_cast<const uint32_t*>(
              kt + r1 * D + CPT * c4 + 4 * s);
        }
      }
      float sc[3][NTL][4];
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[part][n][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t word = kw[r][s] ^ 0x80808080u;
          a[r] = pack_bf16(byte_to_float(word, 0), byte_to_float(word, 1));
          a[r + 2] = pack_bf16(byte_to_float(word, 2), byte_to_float(word, 3));
        }
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mma_bf16(sc[part][n], a, qf[n][s][part][0], qf[n][s][part][1]);
      }
      const bool ok0 = tok0 + r0 < len, ok1 = tok0 + r1 < len;
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const int h = 8 * n + 2 * c4;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (e < 2 ? ok0 : ok1)
                     ? (sc[0][n][e] + (sc[1][n][e] + sc[2][n][e])) * keb *
                           scale
                     : NEG_BIG;
        ps[h * PS_STRIDE + r0] = v[0];
        ps[(h + 1) * PS_STRIDE + r0] = v[1];
        ps[h * PS_STRIDE + r1] = v[2];
        ps[(h + 1) * PS_STRIDE + r1] = v[3];
      }
    }
    __syncthreads();

    // online softmax, warp = head: K outliers of tokens < length, max, exp;
    // p to ps (float32) and to p3 (three bf16 parts)
#pragma unroll
    for (int k = 0; k < HPW; ++k) {
      const int h = warp + NWARP * k;
      if (h < HG) {
        float sc[KP / 32];
#pragma unroll
        for (int j = 0; j < KP / 32; ++j)
          sc[j] = ps[h * PS_STRIDE + j * 32 + lane];
        for (int w = 0; 32 * w < cap; ++w)  // K outliers of this lane's tokens
          for (unsigned live = live_slots<D>(kidx, cap, w); live;
               live &= live - 1) {
            const int e = 32 * w + __ffs(live) - 1;
            const int idx = kidx[e], t = idx / D;
            if (t % 32 == lane && tok0 + t < len) {
              const float add = qg[h * D + idx % D] * kval[e] * scale;
#pragma unroll
              for (int j = 0; j < KP / 32; ++j)
                if (j == t / 32) sc[j] += add;
            }
          }
        float mx = NEG_BIG;
#pragma unroll
        for (int j = 0; j < KP / 32; ++j) mx = max_nan2(sc[j], mx);
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          mx = max_nan2(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
        const float m_new = max_nan2(m_r[k], mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < KP / 32; ++j) {
          const int t = j * 32 + lane;
          const float e = expf(sc[j] - m_new);
          float part[3];
          split3(e, part);
          ps[h * PS_STRIDE + t] = e;
#pragma unroll
          for (int pp = 0; pp < 3; ++pp)
            p3[(pp * HGP + h) * P3_STRIDE + t] =
                (uint16_t)(__float_as_uint(part[pp]) >> 16);
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
        const float alpha = expf(m_r[k] - m_new);
        if (lane == 0) a_s[h] = alpha;
        l_r[k] = l_r[k] * alpha + sum;
        m_r[k] = m_new;
      }
    }
    __syncthreads();

    // acc = acc alpha + eb2 (p bins) + p val: channels 32 cw .. + 31 (those
    // below D), tokens 64 tw .. + 63
    if (32 * cw < D) {
      float pv[3][2][NTL][4];
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int n = 0; n < NTL; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[part][j][n][e] = 0.0f;
      // this lane's word in rows 16 s + 4 c4 + u: the same column for all;
      // a lane past D reads bins of 0
      const bool vok = D % 32 == 0 || 32 * cw + 4 * g < D;
      const int8_t* vcol = vt + 16 * v_chunk<D>(4 * c4, 2 * cw + g / 4) +
                           4 * (g % 4);
#pragma unroll
      for (int s = 4 * tw; s < 4 * tw + 4; ++s) {
        const int t = 16 * s + 4 * c4;
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = vok ? *reinterpret_cast<const uint32_t*>(vcol + (t + u) * D) ^
                           0x80808080u
                     : 0x80808080u;
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {       // m-tile j: bytes 2j (row g), 2j+1
          a[j][0] = pack_bf16(byte_to_float(w[0], 2 * j),
                              byte_to_float(w[1], 2 * j));
          a[j][1] = pack_bf16(byte_to_float(w[0], 2 * j + 1),
                              byte_to_float(w[1], 2 * j + 1));
          a[j][2] = pack_bf16(byte_to_float(w[2], 2 * j),
                              byte_to_float(w[3], 2 * j));
          a[j][3] = pack_bf16(byte_to_float(w[2], 2 * j + 1),
                              byte_to_float(w[3], 2 * j + 1));
        }
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            const uint2 bb = *reinterpret_cast<const uint2*>(
                p3 + (part * HGP + 8 * n + g) * P3_STRIDE + t);
            mma_bf16(pv[part][0][n], a[0], bb.x, bb.y);
            mma_bf16(pv[part][1][n], a[1], bb.x, bb.y);
          }
      }
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        const float al0 = a_s[8 * n + 2 * c4], al1 = a_s[8 * n + 2 * c4 + 1];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sum =
                pv[0][j][n][e] + (pv[1][j][n][e] + pv[2][j][n][e]);
            acc[j][n][e] = acc[j][n][e] * (e % 2 ? al1 : al0) + veb * sum;
          }
      }
      for (int w = 0; 32 * w < cap; ++w)     // V outliers in this lane's slice
        for (unsigned live = live_slots<D>(vidx, cap, w); live;
             live &= live - 1) {
        const int e = 32 * w + __ffs(live) - 1;
        const int idx = vidx[e];
        const int d = idx % D, t = idx / D;
        if (d / 32 == cw && t / 64 == tw && (d / 4) % 8 == g) {
          const float val = vval[e];
          const int j = (d / 2) % 2, hi = d % 2;
#pragma unroll
          for (int n = 0; n < NTL; ++n)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int ee = 0; ee < 4; ++ee) {
                const int h = 8 * n + 2 * c4 + ee % 2;
                if (jj == j && ee / 2 == hi && h < HG)
                  acc[jj][n][ee] += ps[h * PS_STRIDE + t] * val;
              }
        }
      }
    }
  }

  // the split's partial state: m, l from the softmax warps; acc, the two
  // token halves added through stage 0's tiles (channel
  // 32 cw + 4 g + 2 j + e / 2, head 8 n + 2 c4 + e % 2)
  cp_async_wait<0>();
  __syncthreads();
  const size_t slot = (size_t)bg * nsplit + split;
#pragma unroll
  for (int k = 0; k < HPW; ++k) {
    const int h = warp + NWARP * k;
    if (h < HG && lane == 0) {
      ws_m[slot * HG + h] = m_r[k];
      ws_l[slot * HG + h] = l_r[k];
    }
  }
  float* red = reinterpret_cast<float*>(tiles);    // [4][32][2][NTL][4]
  float* mine = red + ((cw * 32 + lane) * 2 * NTL) * 4;
  if (tw == 1)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * NTL + n) * 4 + e] = acc[j][n][e];
  __syncthreads();
  if (tw == 0)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 8 * n + 2 * c4 + e % 2;
          const int d = 32 * cw + 4 * g + 2 * j + e / 2;
          if (h < HG && d < D)
            ws_acc[(slot * HG + h) * D + d] =
                acc[j][n][e] + mine[(j * NTL + n) * 4 + e];
        }
}

// Block (bg, h) of MERGE_GROUPS x D threads, thread = (group, channel):
// combine the splits of (b, g) that hold pages into out[b, g, h, :].  The
// max over the splits is a block reduction; each group sums every
// MERGE_GROUPS-th split with independent loads, and the groups' sums are
// added at the end.  When m_out is not null, the merged softmax state
// goes there too: m_out[b, g, h] the largest scaled score and l_out[b, g,
// h] the sum of exp(score - m) (NEG_BIG and 0 where no page is read), so
// a caller can merge this part with another.
constexpr int MERGE_GROUPS = 4;

template <int D>
__global__ void __launch_bounds__(MERGE_GROUPS * D)
kv_merge_kernel(const int* __restrict__ lengths,
                const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                const float* __restrict__ ws_acc, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out,
                int G, int hg, int S, int pps, int nsplit) {
  __shared__ float red_m[MERGE_GROUPS * D / 32];
  __shared__ float red_a[MERGE_GROUPS][D], red_l[MERGE_GROUPS][D];
  const int bg = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, d = tid % D, grp = tid / D;
  const int len = lengths[bg / G];
  const int n_used = len <= 0 ? 0 : min(S / KP, (len + KP - 1) / KP);
  const int n_split = (n_used + pps - 1) / pps;
  const size_t base = (size_t)bg * nsplit;
  float m = NEG_BIG;
  for (int i = tid; i < n_split; i += MERGE_GROUPS * D)
    m = max_nan2(ws_m[(base + i) * hg + h], m);
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    m = max_nan2(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  if (tid % 32 == 0) red_m[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MERGE_GROUPS * D / 32; ++w) m = max_nan2(red_m[w], m);
  float l = 0.0f, a = 0.0f;
#pragma unroll 4
  for (int i = grp; i < n_split; i += MERGE_GROUPS) {
    const size_t s = (base + i) * hg + h;
    const float w = expf(ws_m[s] - m);
    l += ws_l[s] * w;
    a += ws_acc[s * D + d] * w;
  }
  red_a[grp][d] = a;
  red_l[grp][d] = l;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int k = 1; k < MERGE_GROUPS; ++k) {
      a += red_a[k][d];
      l += red_l[k][d];
    }
    out[((size_t)bg * hg + h) * D + d] = a / l;
    if (m_out != nullptr && d == 0) {
      m_out[(size_t)bg * hg + h] = m;
      l_out[(size_t)bg * hg + h] = l;
    }
  }
}

// Raise the split kernel's dynamic shared memory limit to smem bytes on
// the current device, once per (device, size).
template <int D, int HG>
cudaError_t allow_smem(int smem) {
  constexpr int MAX_DEV = 64;
  static int set[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEV && set[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kv_split_kernel<D, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess && dev < MAX_DEV) set[dev] = smem;
  return err;
}

template <int D, int HG>
cudaError_t launch_split(dim3 grid, int smem, cudaStream_t stream,
                         const float* q, const int* lengths, Cache k, Cache v,
                         float* ws_m, float* ws_l, float* ws_acc, int G, int S,
                         int cap, int pps, float scale) {
  cudaError_t err = allow_smem<D, HG>(smem);
  if (err != cudaSuccess) return err;
  kv_split_kernel<D, HG><<<grid, NT, smem, stream>>>(
      q, lengths, k, v, ws_m, ws_l, ws_acc, G, S, cap, pps, scale);
  return cudaGetLastError();
}

#define KV_HG_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)

template <int D, int HG>
cudaError_t occupancy(int smem, int* blocks) {
  cudaError_t err = allow_smem<D, HG>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kv_split_kernel<D, HG>, NT, smem);
}

// Launch the split kernel at (d, hg), both checked by the caller.
template <int D>
cudaError_t split_for(int hg, dim3 grid, int smem, cudaStream_t st,
                      const float* q, const int* lengths, Cache k, Cache v,
                      float* ws_m, float* ws_l, float* ws_acc, int G, int S,
                      int cap, int pps, float scale) {
  switch (hg) {
#define KV_CASE(H)                                                   \
  case H:                                                            \
    return launch_split<D, H>(grid, smem, st, q, lengths, k, v, ws_m, \
                              ws_l, ws_acc, G, S, cap, pps, scale);
    KV_HG_CASES(KV_CASE)
#undef KV_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------- C API --
// Launches the split kernel and then the merge on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launches (0 = ok).  ws_m and ws_l hold B G nsplit hg floats and ws_acc
// B G nsplit hg D, with nsplit = ceil(S / page / pps); m_out and l_out are
// null or hold B G hg floats each (the merged softmax state); the wrapper
// (kernels/kv_attention.py) allocates them and checks shapes, types and
// contiguity; here D in {80, 128}, page = 128, 1 <= hg <= 16,
// 0 <= cap <= 64 and pps >= 1 are checked again.

extern "C" int repro_kv_decode_attention(
    const float* q, const int* lengths, const int8_t* kbins,
    const float* keb2, const int* kidx, const float* kval,
    const int8_t* vbins, const float* veb2, const int* vidx,
    const float* vval, float* out, float* ws_m, float* ws_l, float* ws_acc,
    float* m_out, float* l_out, int B, int G, int hg, int S, int D,
    int page, int cap, int pps, float scale, void* stream) {
  if ((D != 80 && D != 128) || page != KP || hg < 1 || hg > MAX_HG ||
      S % KP != 0 || cap < 0 || cap > MAX_CAP || pps < 1 ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || G <= 0) return 0;
  const int nsplit = (S / KP + pps - 1) / pps;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (nsplit > 0) {
    const dim3 grid(B * G, nsplit);
    const int smem = split_smem(D, hg, cap);
    const Cache k{kbins, keb2, kidx, kval}, v{vbins, veb2, vidx, vval};
    err = D == 128 ? split_for<128>(hg, grid, smem, st, q, lengths, k, v,
                                    ws_m, ws_l, ws_acc, G, S, cap, pps, scale)
                   : split_for<80>(hg, grid, smem, st, q, lengths, k, v,
                                   ws_m, ws_l, ws_acc, G, S, cap, pps, scale);
    if (err != cudaSuccess) return (int)err;
  }
  if (D == 128)
    kv_merge_kernel<128><<<dim3(B * G, hg), MERGE_GROUPS * 128, 0, st>>>(
        lengths, ws_m, ws_l, ws_acc, out, m_out, l_out, G, hg, S, pps,
        nsplit);
  else
    kv_merge_kernel<80><<<dim3(B * G, hg), MERGE_GROUPS * 80, 0, st>>>(
        lengths, ws_m, ws_l, ws_acc, out, m_out, l_out, G, hg, S, pps,
        nsplit);
  return (int)cudaGetLastError();
}

// The D = 128 split kernel's dynamic shared memory and how many of its
// blocks one SM holds at (hg, cap); 0 = ok, else a CUDA error code.
extern "C" int repro_kv_decode_occupancy(int hg, int cap, int* smem_bytes,
                                         int* blocks_per_sm) {
  if (hg < 1 || hg > MAX_HG || cap < 0 || cap > MAX_CAP)
    return (int)cudaErrorInvalidValue;
  *smem_bytes = split_smem(128, hg, cap);
  cudaError_t err = cudaSuccess;
  switch (hg) {
#define KV_CASE(H)                                      \
  case H:                                               \
    err = occupancy<128, H>(*smem_bytes, blocks_per_sm); \
    break;
    KV_HG_CASES(KV_CASE)
#undef KV_CASE
  }
  return (int)err;
}

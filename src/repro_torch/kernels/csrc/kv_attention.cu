// Flash-decode attention over the int8 paged KV cache for Hopper (sm_90a),
// the CUDA counterpart of the Pallas kernel in src/repro/kernels/:
//
//   kv_decode_kernel  replaces kv_attention.py:39 _kernel
//
// For one query token per sequence: q [B, G, Hg, D] against a cache whose K
// and V are QuantizedKV planes (compression/kv.py): int8 bins [B, G, S, D],
// a pow2 step eb2 per page of P tokens, and per page up to `cap` exact
// outlier values at flat in-page indices (-1 = empty slot).  The output is
// softmax(q k^T / sqrt(D), masked to tokens < lengths[b]) v, in float32.
//
// Design.  One block of 256 threads per (b, g) walks the pages in order, a
// loop that takes the place of the TPU's sequential page axis, and stops
// at the last page that holds a token < lengths[b].  Per page it
//   1. loads the int8 K and V tiles (P x D = 16 KB each) with 16-byte loads
//      and dequantizes them (bin * eb2, exact) into float32 shared memory,
//      the K rows padded to D + 1 floats so that a thread per token reads
//      its row without bank conflicts;
//   2. adds each outlier's exact value at (idx / D, idx % D).  The encoder
//      zeroed those bins, so the add restores the value bit for bit, as the
//      reference's one-hot matmul does (the TPU has no scatter; here one
//      thread per slot writes shared memory);
//   3. computes the Hg x P scores (thread = token, heads split over the two
//      halves of the block), scaled by 1/sqrt(D) in float32 and masked to
//      -1e30 past the length, as the reference does;
//   4. runs the online softmax in float32 (one warp per head: the page max,
//      NaN-propagating like jnp.maximum, alpha = exp(m_prev - m_new), p =
//      exp(s - m_new), l = l * alpha + sum p);
//   5. updates acc = acc * alpha + p v (thread = channel, heads split over
//      the halves, acc in registers),
// and writes acc / l at the end.  Pages past the length are skipped: there
// exp(-1e30 - m) = 0 and alpha = 1, so they change no finite result (a
// non-finite V value in such a page does not reach the output; ROADMAP
// C-port-3).  With length 0 no page is read and the output is 0/0 = NaN.
//
// Bound: per page it reads 2 P D bytes of bins, 2 steps and 2 cap
// (idx, val) pairs, and does about 4 Hg P D operations: 12 flop/byte at
// Hg = 6, near the card's ~20 flop/byte float32 ridge, so the bytes and
// the operations terms are close.  This first version has no split over
// pages (a (b, g) with a long history runs on one SM), no cp.async/TMA
// overlap of the next page's load with this page's work, and no tensor
// cores; those are later work.  Sums are taken in another order than the
// reference's, so the output agrees within a tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KD = 128;                 // head dim D
constexpr int KP = 128;                 // page P (tokens)
constexpr int KPAD = KD + 1;            // padded K row
constexpr int MAX_HG = 16;
constexpr int ABLOCK = 256;
constexpr int HALF_HEADS = MAX_HG / 2;  // heads per thread, at most
constexpr float NEG_BIG = -1e30f;
constexpr size_t SMEM_FLOATS =
    KP * KPAD + KP * KD + 2 * MAX_HG * KD + 3 * MAX_HG;

// jnp.maximum: NaN in either operand propagates (fmaxf would drop it).
__device__ __forceinline__ float max_nan2(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// int8 tile of one page -> float32 shared memory, bin * eb2 (exact).
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ src,
                                          float eb2, float* dst, int stride) {
#pragma unroll
  for (int r = 0; r < KP * KD / (16 * ABLOCK); ++r) {
    int off = (r * ABLOCK + threadIdx.x) * 16;
    int4 w = *reinterpret_cast<const int4*>(src + off);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    float* row = dst + (off / KD) * stride + off % KD;
#pragma unroll
    for (int j = 0; j < 16; ++j) row[j] = __fmul_rn((float)b[j], eb2);
  }
}

__global__ void __launch_bounds__(ABLOCK, 1)
kv_decode_kernel(const float* __restrict__ q, const int* __restrict__ lengths,
                 const int8_t* __restrict__ kbins,
                 const float* __restrict__ keb2,
                 const int* __restrict__ kidx, const float* __restrict__ kval,
                 const int8_t* __restrict__ vbins,
                 const float* __restrict__ veb2,
                 const int* __restrict__ vidx, const float* __restrict__ vval,
                 float* __restrict__ out, int G, int hg, int S, int cap,
                 float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                         // [KP][KPAD]
  float* vs = ks + KP * KPAD;               // [KP][KD]
  float* qs = vs + KP * KD;                 // [hg][KD]
  float* ps = qs + MAX_HG * KD;             // [hg][KP] scores, then p
  float* m_s = ps + MAX_HG * KP;            // [hg]
  float* l_s = m_s + MAX_HG;
  float* a_s = l_s + MAX_HG;

  const int bg = blockIdx.x;                // b * G + g
  const int b = bg / G;
  const int tid = threadIdx.x;
  const int half = tid / KP;                // 0 or 1
  const int lane_t = tid % KP;              // token (scores) or channel (PV)
  const int warp = tid / 32, lane = tid % 32;
  const int n_pages_all = S / KP;
  const int len = lengths[b];
  const int n_pages = len <= 0 ? 0 : min(n_pages_all, (len + KP - 1) / KP);

  for (int i = tid; i < hg * KD; i += ABLOCK)
    qs[i] = q[(size_t)bg * hg * KD + i];
  if (tid < hg) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.0f;
  }
  float acc[HALF_HEADS];
#pragma unroll
  for (int k = 0; k < HALF_HEADS; ++k) acc[k] = 0.0f;

  for (int p = 0; p < n_pages; ++p) {
    const size_t page = (size_t)bg * n_pages_all + p;
    __syncthreads();                        // the last page's readers are done
    load_tile(kbins + page * KP * KD, keb2[page], ks, KPAD);
    load_tile(vbins + page * KP * KD, veb2[page], vs, KD);
    __syncthreads();
    for (int i = tid; i < 2 * cap; i += ABLOCK) {   // exact outlier adds
      bool is_k = i < cap;
      int slot = is_k ? i : i - cap;
      int idx = (is_k ? kidx : vidx)[page * cap + slot];
      if (idx >= 0 && idx < KP * KD) {
        float val = (is_k ? kval : vval)[page * cap + slot];
        float* cell = is_k ? &ks[(idx / KD) * KPAD + idx % KD]
                           : &vs[(idx / KD) * KD + idx % KD];
        *cell = __fadd_rn(*cell, val);
      }
    }
    __syncthreads();

    // scores: thread = token lane_t, heads half, half + 2, ...
    {
      float s[HALF_HEADS];
#pragma unroll
      for (int k = 0; k < HALF_HEADS; ++k) s[k] = 0.0f;
      const float* krow = ks + lane_t * KPAD;
#pragma unroll 4
      for (int c = 0; c < KD; ++c) {
        float kv = krow[c];
#pragma unroll
        for (int k = 0; k < HALF_HEADS; ++k)
          if (half + 2 * k < hg)
            s[k] = __fadd_rn(s[k], __fmul_rn(qs[(half + 2 * k) * KD + c], kv));
      }
      bool valid = p * KP + lane_t < len;
#pragma unroll
      for (int k = 0; k < HALF_HEADS; ++k)
        if (half + 2 * k < hg)
          ps[(half + 2 * k) * KP + lane_t] =
              valid ? __fmul_rn(s[k], scale) : NEG_BIG;
    }
    __syncthreads();

    // online softmax: warp = head
    for (int h = warp; h < hg; h += ABLOCK / 32) {
      float sc[KP / 32];
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < KP / 32; ++j) {
        sc[j] = ps[h * KP + j * 32 + lane];
        mx = max_nan2(sc[j], mx);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = max_nan2(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      float m_prev = m_s[h];
      float m_new = max_nan2(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KP / 32; ++j) {
        float e = expf(__fsub_rn(sc[j], m_new));
        ps[h * KP + j * 32 + lane] = e;
        sum = __fadd_rn(sum, e);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, o));
      __syncwarp();
      if (lane == 0) {
        float alpha = expf(__fsub_rn(m_prev, m_new));
        a_s[h] = alpha;
        l_s[h] = __fadd_rn(__fmul_rn(l_s[h], alpha), sum);
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v: thread = channel lane_t
#pragma unroll
    for (int k = 0; k < HALF_HEADS; ++k) {
      int h = half + 2 * k;
      if (h < hg) {
        float dot = 0.0f;
        const float* prow = ps + h * KP;
#pragma unroll 4
        for (int t = 0; t < KP; ++t)
          dot = __fadd_rn(dot, __fmul_rn(prow[t], vs[t * KD + lane_t]));
        acc[k] = __fadd_rn(__fmul_rn(acc[k], a_s[h]), dot);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < HALF_HEADS; ++k) {
    int h = half + 2 * k;
    if (h < hg)
      out[((size_t)bg * hg + h) * KD + lane_t] = __fdiv_rn(acc[k], l_s[h]);
  }
}

}  // namespace

// ---------------------------------------------------------------- C API --
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() right after the launch (0 = ok).  The wrapper
// (kernels/kv_attention.py) checks shapes, types and contiguity; here
// D = P = 128 and 1 <= hg <= 16 are checked again.

extern "C" int repro_kv_decode_attention(
    const float* q, const int* lengths, const int8_t* kbins,
    const float* keb2, const int* kidx, const float* kval,
    const int8_t* vbins, const float* veb2, const int* vidx,
    const float* vval, float* out, int B, int G, int hg, int S, int D,
    int page, int cap, float scale, void* stream) {
  if (D != KD || page != KP || hg < 1 || hg > MAX_HG || S % KP != 0 ||
      cap < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || G <= 0) return 0;
  const int smem = (int)(SMEM_FLOATS * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kv_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kv_decode_kernel<<<B * G, ABLOCK, smem, (cudaStream_t)stream>>>(
      q, lengths, kbins, keb2, kidx, kval, vbins, veb2, vidx, vval, out, G,
      hg, S, cap, scale);
  return (int)cudaGetLastError();
}

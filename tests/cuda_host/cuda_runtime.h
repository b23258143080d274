// A host stand-in for the CUDA runtime, so that g++ can compile the
// logic of a kernel source of src/repro_torch/kernels/csrc/ that uses no
// shared memory, no barriers and no warp shuffles (pack.cu) and run it on
// the CPU.  tests/test_torch_pack_identities.py rewrites each
// `kernel<...><<<grid, block, 0, s>>>(args)` launch into
// `emu_launch(grid, block, kernel<...>, args)`, which runs every thread of
// every block in turn.
//
// The device intrinsics keep CUDA's semantics: the _rn operations round
// to nearest even in float32 (volatile, so g++ neither contracts nor
// widens them; build with -ffp-contract=off), denormals are kept (the
// library is built without -ftz), `__float2int_rz` truncates, saturates
// and gives 0 for NaN, `__int2float_rn` rounds to nearest.  What this
// cannot show: nvcc's code generation, alignment faults, races.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host stand-in"; }

struct dim3_ { unsigned x, y, z; };
inline thread_local dim3_ threadIdx, blockIdx;

struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline uint32_t __float_as_uint(float f) { uint32_t i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(uint32_t i) { float f; memcpy(&f, &i, 4); return f; }
inline float __int2float_rn(int i) { volatile float r = (float)i; return r; }
inline int __float2int_rz(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT32_MAX;
  if (f <= -2147483648.0f) return INT32_MIN;
  return (int)f;
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned sh) {
  sh &= 31;
  return (uint32_t)((((uint64_t)hi << 32 | lo) << sh) >> 32);
}
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
using std::isfinite;
using std::min;

template <class K, class... A>
void emu_launch(unsigned grid, unsigned block, K kernel, A... args) {
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < block; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {t, 0, 0};
      kernel(args...);
    }
}

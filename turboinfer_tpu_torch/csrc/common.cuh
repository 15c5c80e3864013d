// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes a plain C interface (extern "C", raw
// pointers, ints, the caller's cudaStream_t) and returns the value of
// cudaGetLastError() right after its launches, so the Python wrapper
// can raise on a refused launch. Kernels allocate nothing: the wrapper
// passes outputs and scratch it allocated with torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ti {

constexpr float kNegInf = -1e30f;   // mask value of the JAX package (ops.NEG_INF)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Eight bf16 values held in one 16-byte vector, unpacked to float.
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace ti

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

// Merges the split-T partial results s0..ns-1 of one output row with
// log-sum-exp rescaling: split s wrote its unnormalised output
// po[s * D + d] and its running max and sum pml[2 s], pml[2 s + 1].
// (m0, l0) is one more partial with a zero output: an attention sink
// enters as (sink, 1), exactly once; the default (kNegInf, 0) adds
// nothing (0 * expf(m0 - mx) is exactly 0), so callers without a sink
// get the plain merge bit for bit.
__device__ __forceinline__ float merge_splits(const float* po,
                                              const float* pml, int ns,
                                              int D, int d, int s0 = 0,
                                              float m0 = kNegInf,
                                              float l0 = 0.f) {
  float mx = m0;
  for (int s = s0; s < ns; ++s) mx = fmaxf(mx, pml[2 * s]);
  float l = l0 * __expf(m0 - mx), o = 0.f;
  for (int s = s0; s < ns; ++s) {
    const float w = __expf(pml[2 * s] - mx);
    l += w * pml[2 * s + 1];
    o += w * po[(long long)s * D + d];
  }
  return o / fmaxf(l, 1e-30f);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace ti

// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes a plain C interface (extern "C", raw
// pointers, ints, the caller's cudaStream_t) and returns the value of
// cudaGetLastError() right after its launches, so the Python wrapper
// can raise on a refused launch. Kernels allocate nothing: the wrapper
// passes outputs and scratch it allocated with torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ti {

constexpr float kNegInf = -1e30f;   // mask value of the JAX package (ops.NEG_INF)

// n (<= 32) rounded up to a power of two: the lanes that hold a row of n
// 16-byte chunks, so an XOR butterfly over them never reaches another
// row's (head dim 96: 12 bf16 chunks take 16 lanes, 6 of 8-bit codes 8).
__host__ __device__ constexpr int lane_group(int n) {
  return n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : n > 2 ? 4 : n;
}

// Logit soft-capping, cap * tanh(x / cap), as 1 - 2 / (e^{2y} + 1) with
// y = x / cap: one ex2.approx and one approximate division, within a few
// f32 ulps of cap over the whole range (e^{2y} = inf gives cap exactly,
// 0 gives -cap), where tanh.approx.f32's 2^-11 relative error would put
// up to 0.025 on a score at cap 50. `two_log2e_cap` is 2 log2(e) / cap.
__device__ __forceinline__ float softcap(float x, float cap,
                                         float two_log2e_cap) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * two_log2e_cap));
  return cap - __fdividef(2.f * cap, e + 1.f);
}

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

// Four float8_e4m3fn bit patterns (one 32-bit word, element 0 in the
// low byte) -> float, as the JAX package's e4m3_to_bf16 decodes them.
// Each byte moves to the high byte of a 16-bit lane with its magnitude
// shifted right by one, so sign, 4 exponent and 3 mantissa bits sit
// where fp16 keeps them: the fp16 value is the e4m3 value times 2^-8
// (fp16's exponent bias is 8 above e4m3's), subnormals included, and
// the NaN codes 0x7F/0xFF are the finite fp16 1.875 and read as +-480
// (K/V caches hold no NaN). Exact: every e4m3 value is an fp16 value.
__device__ __forceinline__ void e4m3x4_to_float(uint32_t w, float* f) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t v = __byte_perm(w, 0u, j ? 0x3424u : 0x1404u);
    const uint32_t h = (v & 0x80008000u) | ((v & 0x7F007F00u) >> 1);
    const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&h));
    f[2 * j] = p.x * 256.f;
    f[2 * j + 1] = p.y * 256.f;
  }
}

// KV element types of the attention kernels: bf16, int8 codes (exact in
// float; the caller applies the per-row scale), uint8 e4m3 bits. A
// 16-byte vector holds KvVec<KV>::kE of them; kv16_to_float unpacks one.
template <typename KV>
struct KvVec {
  static constexpr int kE = 16 / static_cast<int>(sizeof(KV));
};

template <typename KV>
__device__ __forceinline__ void kv16_to_float(const uint4& u, float* f);

template <>
__device__ __forceinline__ void kv16_to_float<__nv_bfloat16>(const uint4& u,
                                                             float* f) {
  bf16x8_to_float(u, f);
}

template <>
__device__ __forceinline__ void kv16_to_float<int8_t>(const uint4& u,
                                                      float* f) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
}

template <>
__device__ __forceinline__ void kv16_to_float<uint8_t>(const uint4& u,
                                                       float* f) {
  e4m3x4_to_float(u.x, f);
  e4m3x4_to_float(u.y, f + 4);
  e4m3x4_to_float(u.z, f + 8);
  e4m3x4_to_float(u.w, f + 12);
}

// kE consecutive bf16 values (8 or 16) of a query row, as float.
template <int kE>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p,
                                              float* f) {
#pragma unroll
  for (int i = 0; i < kE; i += 8)
    bf16x8_to_float(*reinterpret_cast<const uint4*>(p + i), f + i);
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

// cp.async copies of one thread, global -> shared: kBytes (4, 8 or 16)
// at dst, of which the first src_bytes come from src and the rest are
// zeros (src_bytes 0 reads nothing). 16-byte copies bypass L1 (K/V rows
// stream once); smaller ones go through it.
template <int kBytes>
__device__ __forceinline__ void async_copy(void* dst, const void* src,
                                           int src_bytes = kBytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Arrival counters for a merge done by the last block of a group to
// finish: every block of the group calls it after writing its partial
// result; it returns true in exactly one block, the last, which then
// reads the partials (with __ldcg: other SMs wrote them) and must set
// *counter back to 0, so the zeroed buffer is zeroed again for the next
// launch (and for CUDA-graph replays). Called by all threads of the
// block; `flag` is a shared int. The barrier orders the block's writes
// before thread 0's release, and its acquire before the block's reads.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected,
                                               int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    *flag = old == expected - 1;
  }
  __syncthreads();
  return *flag;
}

// Lets `kernel` take up to `bytes` of dynamic shared memory (above 48 KB
// only after this).
template <typename F>
inline int allow_smem(F kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// d (+)= a b: mma.sync m16n8k16, bf16 operands (a: 4 registers of the
// 16 x 16 A fragment, b0 b1: the 16 x 8 B fragment), f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> bf16x2 (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace ti

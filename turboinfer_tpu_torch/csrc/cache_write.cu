// cache_write_fresh: write a fresh prefill's K and V into layer li of the
// stacked head-major cache, at T offset 0, in place.
//
// Replaces the TPU kernel turboinfer_tpu/kernels/pallas/cache_write.py
// cache_write_fresh (_write, body _kernel), fused with the
// [B, S, Hkv, D] -> [B, Hkv, S, D] transpose that
// turboinfer_tpu/models/llama.py does before it. One launch writes both
// K (blockIdx.y == 0) and V (blockIdx.y == 1); cache rows at t >= S are
// not touched.
//
// What bounds it on the H100: bytes, 2 * B * S * Hkv * D * itemsize read
// and the same written, over 3.35 TB/s. Each thread moves one 16-byte
// vector; consecutive threads read consecutive bytes of the source
// (ordered b, s, h, d) and write whole D-rows of the destination, so
// both sides stay coalesced in row-sized runs.
#include "common.cuh"

namespace {

__global__ void cache_write_fresh_kernel(
    const unsigned char* __restrict__ k_new,
    const unsigned char* __restrict__ v_new, unsigned char* __restrict__ k_cache,
    unsigned char* __restrict__ v_cache, int B, int S, int Hkv, int T,
    int row_bytes, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh) {
  const int nvec = row_bytes / 16;
  const long long total = (long long)B * S * Hkv * nvec;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int vec = static_cast<int>(idx % nvec);
  long long rest = idx / nvec;
  const int h = static_cast<int>(rest % Hkv);
  rest /= Hkv;
  const int s = static_cast<int>(rest % S);
  const int b = static_cast<int>(rest / S);
  const bool is_v = blockIdx.y == 1;
  const unsigned char* src = is_v
      ? v_new + b * vsb + s * vss + h * vsh
      : k_new + b * ksb + s * kss + h * ksh;
  unsigned char* dst = (is_v ? v_cache : k_cache) +
                       (((long long)b * Hkv + h) * T + s) * row_bytes;
  reinterpret_cast<uint4*>(dst)[vec] =
      reinterpret_cast<const uint4*>(src)[vec];
}

}  // namespace

extern "C" {

// k_new, v_new: [B, S, Hkv, D] with byte strides {sb, ss, sh} each and a
// contiguous D row of `row_bytes` (a multiple of 16); k_cache, v_cache:
// the contiguous [B, Hkv, T, D] plane of layer li (the caller offsets
// the pointers). S <= T.
int ti_cache_write_fresh(const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, int B, int S, int Hkv, int T,
                         int row_bytes, const long long* strides,
                         void* stream) {
  const long long total = (long long)B * S * Hkv * (row_bytes / 16);
  if (total == 0) return 0;
  dim3 grid(static_cast<unsigned>((total + 255) / 256), 2);
  cache_write_fresh_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(k_new),
      static_cast<const unsigned char*>(v_new),
      static_cast<unsigned char*>(k_cache), static_cast<unsigned char*>(v_cache),
      B, S, Hkv, T, row_bytes, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5]);
  return ti::launch_status();
}

}  // extern "C"

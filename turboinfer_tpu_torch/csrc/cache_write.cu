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
//
// kv_encode_write: the same write for an int8 or fp8 cache, fused with
// the encode of turboinfer_tpu/models/common.py encode_kv_scaled that
// the JAX model runs before every cache write (decode step, fresh and
// chunked prefill, paged pages). K and V [N tokens, Hkv, D] bf16; token
// n, head h goes to cache row rows[n] + layer_off + h * head_stride of
// the cache viewed as [rows, D] (and of its [rows] scale plane), so one
// addressing serves the contiguous cache (head stride T) and the page
// pool (head stride page); rows[n] < 0 writes nothing. One warp encodes
// one (token, head, K or V) row in registers: the f32 absmax by shuffle,
// scale = max(absmax, 1e-12) times f32(1 / 127) (the JAX package's
// compiled `/ 127.0` is that multiply), codes __float2int_rn(x / scale)
// by IEEE division (the build has no fast-math) clamped to +-127: the
// JAX package's bytes. fp8 converts with __nv_cvt_float_to_fp8 without
// saturation and writes 0x7F | sign where |x| > 464 or x is not finite,
// as the JAX package's float8_e4m3fn cast does. Bound: bytes, the bf16
// rows read, the codes (and f32 scales) written.
#include <cuda_fp8.h>

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

// D / 32 elements per lane (D in {32, 64, 128}).
template <int D, bool kFp8>
__global__ void __launch_bounds__(256)
kv_encode_write_kernel(const __nv_bfloat16* __restrict__ k_new,
                       const __nv_bfloat16* __restrict__ v_new,
                       uint8_t* __restrict__ k_cache,
                       uint8_t* __restrict__ v_cache,
                       float* __restrict__ k_scale,
                       float* __restrict__ v_scale,
                       const long long* __restrict__ rows, int N, int Hkv,
                       long long layer_off, long long head_stride,
                       long long ksn, long long ksh, long long vsn,
                       long long vsh) {
  constexpr int kPer = D / 32;
  const long long job = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (job >= (long long)N * Hkv) return;
  const int lane = threadIdx.x & 31;
  const int n = static_cast<int>(job / Hkv), h = static_cast<int>(job % Hkv);
  const long long row0 = rows[n];
  if (row0 < 0) return;
  const bool is_v = blockIdx.y == 1;
  const __nv_bfloat16* src = is_v ? v_new + n * vsn + h * vsh
                                  : k_new + n * ksn + h * ksh;
  const long long row = row0 + layer_off + h * head_stride;
  uint8_t* dst = (is_v ? v_cache : k_cache) + row * D + lane * kPer;
  float x[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    x[e] = __bfloat162float(src[lane * kPer + e]);
  uint8_t c[kPer];
  if (kFp8) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float a = fabsf(x[e]);
      c[e] = (a > 464.f || !isfinite(x[e]))
                 ? static_cast<uint8_t>(signbit(x[e]) ? 0xFF : 0x7F)
                 : static_cast<uint8_t>(
                       __nv_cvt_float_to_fp8(x[e], __NV_NOSAT, __NV_E4M3));
    }
  } else {
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) amax = fmaxf(amax, fabsf(x[e]));
    amax = ti::warp_max(amax);
    const float s = fmaxf(amax, 1e-12f) * (1.f / 127.f);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int q = __float2int_rn(x[e] / s);
      c[e] = static_cast<uint8_t>(static_cast<int8_t>(max(-127, min(127, q))));
    }
    if (lane == 0) (is_v ? v_scale : k_scale)[row] = s;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) dst[e] = c[e];
}

template <int D>
void launch_encode(const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, void* k_scale, void* v_scale,
                   const long long* rows, int N, int Hkv, bool fp8,
                   long long layer_off, long long head_stride,
                   const long long* st, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(((long long)N * Hkv + 7) / 8), 2);
  auto kern = fp8 ? kv_encode_write_kernel<D, true>
                  : kv_encode_write_kernel<D, false>;
  kern<<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<uint8_t*>(k_cache), static_cast<uint8_t*>(v_cache),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), rows, N,
      Hkv, layer_off, head_stride, st[0], st[1], st[2], st[3]);
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

// k_new, v_new: bf16 [N, Hkv, D] with element strides {ksn, ksh, vsn,
// vsh} and contiguous D rows; k_cache, v_cache: an int8 or fp8 (uint8
// e4m3 bits) cache or page pool, contiguous, viewed as [rows, D];
// k_scale, v_scale: f32 [rows] planes for int8 (fp8 = 0), null for fp8;
// rows: int64 [N] on the device, the head-0 row of token n at layer 0,
// < 0 to skip it. D in {32, 64, 128}.
int ti_kv_encode_write(const void* k_new, const void* v_new, void* k_cache,
                       void* v_cache, void* k_scale, void* v_scale,
                       const void* rows, int N, int Hkv, int D, int fp8,
                       long long layer_off, long long head_stride,
                       const long long* strides, void* stream) {
  if (N == 0) return 0;
  if (!fp8 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* r = static_cast<const long long*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      launch_encode<32>(k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, fp8, layer_off, head_stride, strides, st);
      break;
    case 64:
      launch_encode<64>(k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, fp8, layer_off, head_stride, strides, st);
      break;
    case 128:
      launch_encode<128>(k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, fp8, layer_off, head_stride, strides, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return ti::launch_status();
}

}  // extern "C"

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
// pool (head stride page); rows[n] < 0 writes nothing.
//
// What bounds it on the H100: bytes, the bf16 rows read once, the codes
// (and f32 scales) written once. The design:
//  * a row of D bf16 is D / 8 lanes, one 16-byte load each (a warp at
//    D = 256, a half-warp at 128 and at 96, whose last 4 lanes idle, a
//    quarter at 64, an eighth at 32); its
//    absmax is a shuffle reduction inside that lane group (on the bf16
//    bits: the magnitudes order as the low 15 bits), and each lane stores
//    its 8 codes as one 8-byte vector, so a warp stores whole rows;
//  * a warp takes a chunk of kU * 32 / (D / 8) consecutive tokens of one
//    (K or V, head) and issues all kU loads of each lane before any
//    reduction; consecutive tokens of a sequence are consecutive rows of
//    the [.., T] plane (or of a page), so lane l writes the scale of the
//    chunk's token l and a warp's scales leave in one store of
//    consecutive floats. kU is 4 for long writes (prefill slabs), 1 for
//    short ones (decode steps, verifies), where more warps finish
//    sooner;
//  * one chunk a warp, 8 warps a block on 8 neighbouring heads of the
//    same tokens, and as many blocks as chunks: on the H100 this beat a
//    grid sized to the resident blocks with warps looping over chunks
//    (with or without a cp.async ring a thread in shared memory).
//
// int8, bit for bit with the plain form: scale = max(absmax, 1e-12)
// times f32(1 / 127) (the JAX package's compiled `/ 127.0` is that
// multiply), codes round-half-even(x / scale) of the IEEE quotient,
// clamped to +-127. Without a division: y = 1 / scale correctly rounded
// once a row, then q = x * y and twice q += (x - scale * q) * y, each
// step an FMA. x * y lies within 2 ulps of x / scale; the first step
// leaves q within one ulp (faithful), and from a faithful q and a
// correctly rounded y one more step gives the correctly rounded
// quotient (Markstein's theorem: the remainder x - scale * q is then
// exact). Where the code can be nonzero (|x / scale| >= 0.5, so x >=
// 3.9e-15) x, the scale and the remainder are normal, so no step
// underflows; below that any q rounds to 0. Adding 1.5 * 2^23 rounds the
// quotient half to even and leaves the code in the low byte; |x /
// scale| <= 127 + 2^-16 rounds to at most 127, so no clamp is needed.
// A division per value would call the IEEE division routine (the build
// has no fast math); a product that only divided near a .5 tie (within
// 2^-13) branched too often: bf16 rows put ~0.3% of their quotients
// there (~0.1% exact ties), so most warps took the branch. A row with
// inf or NaN (scale inf or NaN, as the plain form's) divides.
//
// fp8: cvt.rn.satfinite.e4m3x2.f32 converts two values an instruction;
// then 0x7F | sign where |x| > 464 or x is not finite (compared on the
// bf16 bits), as the JAX package's float8_e4m3fn cast writes. For |x|
// <= 464 the saturating conversion gives the non-saturating one's byte:
// values in (448, 464] round to 448 either way (464 is a tie that goes
// to 448, the even code). (cuda_fp8.hpp has the hardware conversion for
// satfinite only: __nv_cvt_float_to_fp8 without saturation runs a
// software routine.)

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

constexpr int kEncThreads = 256;

// 1.5 * 2^23: q + it rounds q to an integer, half to even (|q| < 2^22),
// left in the low mantissa bits.
constexpr float kRound = 12582912.0f;

// Four codes (low bytes of a..d) packed into one word, a in byte 0.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The largest |x| of the 8 bf16 values of v, as bf16 bits: magnitudes
// order as the low 15 bits (a NaN above every number, as torch's amax
// keeps it).
__device__ __forceinline__ uint32_t abs_max_bits(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = max(m, max(w[i] & 0x7FFFu, (w[i] >> 16) & 0x7FFFu));
  return m;
}

// The int8 codes of the 8 bf16 values of v at scale s (y: 1 / s
// rounded), packed (value 0 in byte 0): round-half-even of the IEEE
// quotient x / s, clamped to +-127. Two FMA corrections of x * y give
// that quotient (see the header); a row with inf or NaN divides.
__device__ __forceinline__ uint2 int8_codes(const uint4& v, float s,
                                            float y) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
  uint32_t c[8];
  if (s <= 3.40282347e38f) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float q = __fmul_rn(f[e], y);
      q = __fmaf_rn(__fmaf_rn(-s, q, f[e]), y, q);
      q = __fmaf_rn(__fmaf_rn(-s, q, f[e]), y, q);
      c[e] = __float_as_uint(__fadd_rn(q, kRound));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[e] = static_cast<uint32_t>(
          max(-127, min(127, __float2int_rn(__fdiv_rn(f[e], s)))));
  }
  return make_uint2(pack4(c[0], c[1], c[2], c[3]),
                    pack4(c[4], c[5], c[6], c[7]));
}

// The e4m3 bytes of the two bf16 values of w (element 0 in the low half
// and the low byte), as float8_e4m3fn's cast writes them: the hardware
// conversion, then 0x7F | sign past |x| > 464 and for inf and NaN.
__device__ __forceinline__ uint32_t e4m3x2(uint32_t w) {
  unsigned short r;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
      : "=h"(r)
      : "f"(__uint_as_float(w & 0xFFFF0000u)), "f"(__uint_as_float(w << 16)));
  uint32_t out = r;
  constexpr uint32_t k464 = 0x43E8u;      // bf16 bits of 464
  if ((w & 0x7FFFu) > k464) out = (out & 0xFF00u) | 0x7Fu | ((w >> 8) & 0x80u);
  if (((w >> 16) & 0x7FFFu) > k464)
    out = (out & 0x00FFu) | 0x7F00u | ((w >> 16) & 0x8000u);
  return out;
}

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The int8 (at scale s, y = 1 / s) or fp8 codes of the 8 bf16 values of
// v.
template <bool kFp8>
__device__ __forceinline__ uint2 codes8(const uint4& v, float s, float y) {
  if constexpr (kFp8)
    return make_uint2(e4m3x2(v.x) | (e4m3x2(v.y) << 16),
                      e4m3x2(v.z) | (e4m3x2(v.w) << 16));
  else
    return int8_codes(v, s, y);
}

// A row of D bf16 is kG = D / 8 16-byte pieces, one a lane, in a group of
// kGP = lane_group(kG) lanes (at D = 96 the 12 pieces take lanes 0-11 of
// a 16-lane group, and lanes 12-15 load nothing, hold a zero absmax and
// store nothing, so the butterfly stays in the group and no lane writes a
// row of another token). kSlots = 32 / kGP rows a warp instruction, kRows
// = kSlots * kU tokens a warp (its chunk): token n0 + u * kSlots + slot is
// the lane's u-th row. Chunk c is token chunk c / (2 Hkv) of (K or V,
// head) c % (2 Hkv), so the 8 warps of a block read 8 neighbouring heads
// of the same tokens. A warp issues all its loads before any reduction.
template <int D, bool kFp8, int kU>
__global__ void __launch_bounds__(kEncThreads)
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
  constexpr int kG = D / 8, kGP = ti::lane_group(kG);
  constexpr int kSlots = 32 / kGP, kRows = kSlots * kU;
  const int lane = threadIdx.x & 31, slot = lane / kGP, part = lane % kGP;
  const bool live = kGP == kG || part < kG;   // the lane holds a piece
  const int c = blockIdx.x * (kEncThreads / 32) + (threadIdx.x >> 5);
  if (c >= 2 * Hkv * ((N + kRows - 1) / kRows)) return;
  const int n0 = c / (2 * Hkv) * kRows, hv = c % (2 * Hkv);
  const bool is_v = hv >= Hkv;
  const int h = is_v ? hv - Hkv : hv;
  const __nv_bfloat16* src =
      (is_v ? v_new + h * vsh : k_new + h * ksh) + (live ? part * 8 : 0);
  const long long sn = is_v ? vsn : ksn;
  uint8_t* dst = (is_v ? v_cache : k_cache) + part * 8;
  const long long base = layer_off + h * head_stride;
  uint4 x[kU];
  long long row[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int n = n0 + u * kSlots + slot;
    row[u] = n < N ? __ldg(rows + n) : -1;
    x[u] = n < N && live ? load_stream(src + n * sn)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  float s[kU] = {}, y[kU] = {};
  if constexpr (!kFp8) {
    // the kU rows side by side, so their reductions overlap
    uint32_t m[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) m[u] = abs_max_bits(x[u]);
#pragma unroll
    for (int o = kGP / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
        m[u] = max(m[u], __shfl_xor_sync(0xffffffffu, m[u], o));
    // max(absmax, 1e-12) * f32(1 / 127), a NaN absmax kept
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float a = __uint_as_float(m[u] << 16);
      s[u] = __fmul_rn(a < 1e-12f ? 1e-12f : a, 1.f / 127.f);
      y[u] = __frcp_rn(s[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u)
    if (row[u] >= 0 && live)
      *reinterpret_cast<uint2*>(dst + (row[u] + base) * D) =
          codes8<kFp8>(x[u], s[u], y[u]);
  if constexpr (!kFp8) {
    // lane l < kRows writes the scale of the chunk's token l
    float my_s = 0.f;
    long long my_row = -1;
    const int from = (lane % kSlots) * kGP;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float su = __shfl_sync(0xffffffffu, s[u], from);
      const long long ru = __shfl_sync(0xffffffffu, row[u], from);
      if (lane / kSlots == u) my_s = su, my_row = ru;
    }
    if (my_row >= 0) (is_v ? v_scale : k_scale)[my_row + base] = my_s;
  }
}

template <int D, bool kFp8, int kU>
int launch_encode(const void* k_new, const void* v_new, void* k_cache,
                  void* v_cache, void* k_scale, void* v_scale,
                  const long long* rows, int N, int Hkv, long long layer_off,
                  long long head_stride, const long long* st,
                  cudaStream_t stream) {
  constexpr int kRows = 32 / ti::lane_group(D / 8) * kU;
  constexpr int kWarps = kEncThreads / 32;
  const long long warps = 2LL * Hkv * ((N + kRows - 1) / kRows);
  kv_encode_write_kernel<D, kFp8, kU>
      <<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kEncThreads,
         0, stream>>>(
          static_cast<const __nv_bfloat16*>(k_new),
          static_cast<const __nv_bfloat16*>(v_new),
          static_cast<uint8_t*>(k_cache), static_cast<uint8_t*>(v_cache),
          static_cast<float*>(k_scale), static_cast<float*>(v_scale), rows,
          N, Hkv, layer_off, head_stride, st[0], st[1], st[2], st[3]);
  return ti::launch_status();
}

// The plan: one row a lane (kU = 1) keeps a short write short (a decode
// step, a verify, a 1024-token GPT-OSS prefill: more warps, each done
// sooner); from kLongRows (K and V) rows up, four rows a lane in flight
// fill the memory pipe (faster on the H100 from 65536 rows; 16384 rows
// took longer).
constexpr long long kLongRows = 32768;

template <int D>
int launch_encode(bool fp8, const void* k_new, const void* v_new,
                  void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                  const long long* rows, int N, int Hkv, long long layer_off,
                  long long head_stride, const long long* st,
                  cudaStream_t stream) {
  auto launch = 2LL * Hkv * N >= kLongRows
                    ? (fp8 ? launch_encode<D, true, 4>
                           : launch_encode<D, false, 4>)
                    : (fp8 ? launch_encode<D, true, 1>
                           : launch_encode<D, false, 1>);
  return launch(k_new, v_new, k_cache, v_cache, k_scale, v_scale, rows, N,
                Hkv, layer_off, head_stride, st, stream);
}

}  // namespace

extern "C" {

// ti_kv_encode_write's refusal of a misaligned K/V view or cache.
constexpr int kMisaligned = -1;

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
// vsh}, contiguous D rows and 16-byte aligned (pointers and the strides
// in bytes); k_cache, v_cache: an int8 or fp8 (uint8 e4m3 bits) cache or
// page pool, contiguous and 16-byte aligned, viewed as [rows, D];
// k_scale, v_scale: f32 [rows] planes for int8 (fp8 = 0), null for fp8;
// rows: int64 [N] on the device, the head-0 row of token n at layer 0,
// < 0 to skip it. D in {32, 64, 96, 128, 256}. Returns kMisaligned, launching
// nothing, when a pointer or stride breaks the 16-byte alignment (the
// check costs the caller nothing on the host).
int ti_kv_encode_write(const void* k_new, const void* v_new, void* k_cache,
                       void* v_cache, void* k_scale, void* v_scale,
                       const void* rows, int N, int Hkv, int D, int fp8,
                       long long layer_off, long long head_stride,
                       const long long* strides, void* stream) {
  if (N == 0) return 0;
  if (!fp8 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(k_new) | reinterpret_cast<uintptr_t>(v_new) |
        reinterpret_cast<uintptr_t>(k_cache) |
        reinterpret_cast<uintptr_t>(v_cache)) & 15) ||
      ((strides[0] | strides[1] | strides[2] | strides[3]) & 7))
    return kMisaligned;
  const long long* r = static_cast<const long long*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_encode<32>(fp8, k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, layer_off, head_stride, strides, st);
    case 64:
      return launch_encode<64>(fp8, k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, layer_off, head_stride, strides, st);
    case 96:
      return launch_encode<96>(fp8, k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, layer_off, head_stride, strides, st);
    case 128:
      return launch_encode<128>(fp8, k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, layer_off, head_stride, strides, st);
    case 256:
      return launch_encode<256>(fp8, k_new, v_new, k_cache, v_cache, k_scale, v_scale, r, N, Hkv, layer_off, head_stride, strides, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

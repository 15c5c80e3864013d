// qmm_a8: the W4A8 product y[M, N] of int8 activations and int4
// weights, and the row quantizer that makes its activations.
//
// Replaces turboinfer_tpu/kernels/pallas/qmm.py _kernel_int4_a8 (:466)
// and _kernel_int4_a8_idx (:484), whose body is _int4_a8_body (:425),
// with the jnp around them in _qmm_2d and _qmm_stacked: the row
// quantizer _a8_quantize_rows (:502) before, the row scaling after
// (TURBOINFER_QMM_A8=1; the Python side, qmm.a8_applies, decides which
// products take it, as the JAX package does). A stacked weight's layer
// is chosen by the caller's pointer offset; the kernel sees one plane.
//
// Semantics, bit for bit with the plain version (qmm.qmatmul_a8_plain):
//  * ti_a8_quantize_rows, one block per row: sx = max(absmax, 1e-8) *
//    f32(1/127) (XLA compiles the JAX package's `/ 127.0` into that
//    multiply), codes = round-half-even(x / sx) with an IEEE division,
//    clipped to +-127. The absmax is exact in any order.
//  * ti_qmm_a8: per scale group j, the integer partial sum_k xq[m, k] *
//    (u[k, n] - 8) (the JAX body computes it as p - 8 * rowsum because
//    Mosaic has no int8 subtract; the two are equal in int32, so the
//    nibbles are unpacked straight to signed u - 8), then acc[m, n] =
//    acc + f32(partial) * f32(s[j, n]), rounded as a multiply and an
//    add (no FMA), in group order; y = bf16(f32(bf16(acc)) * sx[m]),
//    the two roundings of the JAX code for bf16 activations.
//
// Weight format: [K/2, N] uint8, byte row r of scale group j = r / (g/2)
// holds logical row j*g + r % (g/2) in its low nibble and j*g + g/2 +
// r % (g/2) in its high nibble, each stored +8; scales bf16 [K/g, N].
//
// What bounds it on the H100: 2*M*K*N integer operations over the int8
// tensor-core rate (1979 TOPS dense) at prefill M; the bytes (xq, the
// int4 plane, y) below M of a few hundred. The product runs on
// mma.sync.m16n8k32 s8 x s8 -> s32, whose fragment layout is documented,
// so each column's group scale is applied in registers after the
// group's k32 steps. A block computes a 128 x 128 tile with 8 warps
// (32 x 64 each); a K step is 32 byte rows of one group (64 logical k:
// the step's low-nibble rows, then its high-nibble rows), staged in
// shared memory K-major for both operands: x codes as 16-byte vectors,
// the weight bytes unpacked to signed int8 and transposed 4 x 4 in
// registers. The next step is prefetched into registers during the
// MMAs. No cp.async/TMA pipeline and no wgmma: that is future work.
#include "common.cuh"

namespace {

constexpr int kQThreads = 256;
constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBR = 32;            // byte rows a K step (64 logical k)
constexpr int kLdA = 80;           // bytes a row of the x tile (64 + pad)
constexpr int kLdB = 68;           // bytes a column of the W tile (17 words)

__device__ __forceinline__ float inv127() {
  return __int_as_float(0x3C010204);   // f32(1/127)
}

__global__ void __launch_bounds__(kQThreads)
a8_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                        int8_t* __restrict__ xq, float* __restrict__ sx,
                        int K) {
  __shared__ float red[kQThreads / 32];
  __shared__ float srow;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * K;
  float m = 0.f;
  for (int i = tid * 8; i < K; i += kQThreads * 8) {
    float f[8];
    ti::bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + i)), f);
#pragma unroll
    for (int b = 0; b < 8; ++b) m = fmaxf(m, fabsf(f[b]));
  }
  m = ti::warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float a = red[0];
#pragma unroll
    for (int w = 1; w < kQThreads / 32; ++w) a = fmaxf(a, red[w]);
    const float s = __fmul_rn(fmaxf(a, 1e-8f), inv127());
    srow = s;
    sx[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = srow;
  for (int i = tid * 8; i < K; i += kQThreads * 8) {
    float f[8];
    ti::bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(xr + i)), f);
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float c = fminf(fmaxf(rintf(__fdiv_rn(f[b], s)), -127.f), 127.f);
      word[b >> 2] |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xFFu)
                      << (8 * (b & 3));
    }
    *reinterpret_cast<uint2*>(qr + i) = make_uint2(word[0], word[1]);
  }
}

// Four int4 bytes (four columns of one byte row, column c in byte c) ->
// their low and high nibbles as signed int8 u - 8, byte for byte: u ^ 8
// is u - 8 in 4-bit two's complement; bit 3 set adds the sign bits 0xF0
// (8 * 0x1E; no carry crosses a byte).
__device__ __forceinline__ uint32_t nibbles_to_s8(uint32_t n4) {
  const uint32_t y = n4 ^ 0x08080808u;
  return y | ((y & 0x08080808u) * 0x1Eu);
}

// 4 x 4 byte transpose: r[i] holds row i's columns 0..3 (column c in
// byte c); out[c] holds column c's rows 0..3 (row i in byte i).
__device__ __forceinline__ void transpose4x4(const uint32_t* r,
                                             uint32_t* out) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// D = A (16 x 32 s8, row) * B (32 x 8 s8, col) + D, s32.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// g is a multiple of 64, so a K step (32 byte rows) lies in one group.
__global__ void __launch_bounds__(kThreads, 1)
qmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const uint8_t* __restrict__ w,
              const __nv_bfloat16* __restrict__ s,
              __nv_bfloat16* __restrict__ y, int M, int K, int N, int g) {
  __shared__ __align__(16) int8_t as[kBM * kLdA];
  __shared__ __align__(16) int8_t bs[kBN * kLdB];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1;     // warp rows wm*32 .. +31
  const int wn = warp & 1;      // warp cols wn*64 .. +63
  const int bm0 = blockIdx.y * kBM, bn0 = blockIdx.x * kBN;
  const int half = g >> 1;
  const int spg = half / kBR;   // K steps a group
  const int steps = (K / g) * spg;
  // the thread's 4 x 4 block of the weight step: byte rows rq*4 .. +3,
  // columns cq*4 .. +3 (a warp reads 4 rows x 32 contiguous bytes)
  const int rq = (lane & 3) + 4 * (warp & 1);
  const int cq = (lane >> 2) + 8 * (warp >> 1);
  const int wcol = bn0 + cq * 4;

  uint4 xr[2];
  uint32_t wr[4];
  auto fetch = [&](int st) {
    const int j = st / spg, q = st - j * spg;
    const int klo = j * g + q * kBR;
    const int r0 = j * half + q * kBR;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, m = idx >> 2, c = idx & 3;
      const int k = c < 2 ? klo + c * 16 : klo + half + (c - 2) * 16;
      xr[i] = bm0 + m < M ? __ldg(reinterpret_cast<const uint4*>(
                                xq + (size_t)(bm0 + m) * K + k))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wr[i] = wcol < N ? __ldg(reinterpret_cast<const uint32_t*>(
                             w + (size_t)(r0 + rq * 4 + i) * N + wcol))
                       : 0u;
  };

  int acc[2][8][4];
  float accf[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0;
        accf[mt][nt][e] = 0.f;
      }

  if (steps > 0) fetch(0);
  for (int st = 0; st < steps; ++st) {
    __syncthreads();   // the previous step's tiles are consumed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, m = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(as + m * kLdA + c * 16) = xr[i];
    }
    {
      uint32_t lo[4], hi[4], lot[4], hit[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = nibbles_to_s8(wr[i] & 0x0F0F0F0Fu);
        hi[i] = nibbles_to_s8((wr[i] >> 4) & 0x0F0F0F0Fu);
      }
      transpose4x4(lo, lot);
      transpose4x4(hi, hit);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int8_t* col = bs + (cq * 4 + c) * kLdB + rq * 4;
        *reinterpret_cast<uint32_t*>(col) = lot[c];
        *reinterpret_cast<uint32_t*>(col + kBR) = hit[c];
      }
    }
    __syncthreads();
    if (st + 1 < steps) fetch(st + 1);   // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < 2 * kBR; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r = as + (wm * 32 + mt * 16 + gid) * kLdA + kk + tig * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8 * kLdA);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r + 8 * kLdA + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* c = bs + (wn * 64 + nt * 8 + gid) * kLdB + kk + tig * 4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(c);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(c + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    if ((st + 1) % spg == 0) {
      // the group's scales: columns n, n + 1 of each n tile
      const int j = st / spg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = bn0 + wn * 64 + nt * 8 + tig * 2;
        float2 sc = make_float2(0.f, 0.f);
        if (n < N)
          sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              s + (size_t)j * N + n));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __int2float_rn(acc[mt][nt][e]);
            accf[mt][nt][e] = __fadd_rn(
                accf[mt][nt][e], __fmul_rn(p, (e & 1) ? sc.y : sc.x));
            acc[mt][nt][e] = 0;
          }
      }
    }
  }

  // y = bf16(f32(bf16(acc)) * sx[m]); fragment rows gid and gid + 8,
  // columns tig*2 and tig*2 + 1 of each 16 x 8 tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = bm0 + wm * 32 + mt * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float rs = sx[m];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = bn0 + wn * 64 + nt * 8 + tig * 2;
        if (n >= N) continue;
        const float o0 = __bfloat162float(
            __float2bfloat16_rn(accf[mt][nt][2 * h]));
        const float o1 = __bfloat162float(
            __float2bfloat16_rn(accf[mt][nt][2 * h + 1]));
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
            __floats2bfloat162_rn(__fmul_rn(o0, rs), __fmul_rn(o1, rs));
      }
    }
}

}  // namespace

extern "C" {

// x: bf16 [M, K] contiguous, 16-byte aligned, K % 8 == 0; xq: int8
// [M, K]; sx: f32 [M].
int ti_a8_quantize_rows(const void* x, void* xq, void* sx, int M, int K,
                        void* stream) {
  if (M <= 0 || K <= 0 || K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  a8_quantize_rows_kernel<<<M, kQThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), K);
  return ti::launch_status();
}

// xq: int8 [M, K] and sx: f32 [M] from ti_a8_quantize_rows; w: one
// layer's plane, uint8 [K/2, N] contiguous; s: bf16 [K/g, N]
// contiguous; y: bf16 [M, N]. Needs g a multiple of 64 dividing K,
// N % 8 == 0, and w, s 16-byte aligned (x codes are read as 16-byte
// vectors: K % 16 == 0 follows from g).
int ti_qmm_a8(const void* xq, const void* sx, const void* w, const void* s,
              void* y, int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || g % 64 || K % g || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_a8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<__nv_bfloat16*>(y), M, K, N, g);
  return ti::launch_status();
}

}  // extern "C"

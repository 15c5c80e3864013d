// qmm_int4: y[M, N] = x[M, K] @ dequant(W), W group-wise int4, and its
// grouped form qmm_int4_grouped: y[g] = x[g] @ dequant(W[slots[g]]).
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/qmm.py
// qmatmul_pallas_stacked (_qmm_stacked, _kernel_int4_idx) and
// qmatmul_pallas (_qmm_2d, _kernel_int4). The layer of a stacked
// [L, K/2, N] weight is chosen by the caller's pointer offset; the kernel
// sees one [K/2, N] plane.
//
// The grouped entry replaces qmatmul_pallas_grouped (_qmm_grouped,
// _kernel_int4_grp): MoE decode's k routed experts, G data-dependent
// planes of the flat [L*E, K/2, N] expert stack, in ONE launch. It is
// the GEMV body below with a group axis folded into blockIdx.z: each
// block reads its group's slot id from device memory (no host sync),
// clamps it into [0, L*E - 1] so a bad id never reads outside the
// stack, and offsets the weight and scale pointers by that plane and x,
// y and the split-K partials by the group's rows. Bound: bytes again,
// G planes of (K/2 + 2K/g) * N bytes per call (M <= 16 only).
//
// Weight format (the JAX package's, byte for byte): packed byte row r
// belongs to scale group j = r / (g/2) at offset o = r % (g/2); its low
// nibble is logical row k = j*g + o, its high nibble k = j*g + g/2 + o,
// each stored +8. Scales are bf16 [K/g, N]; sums are f32; y is bf16.
// Both paths index by packed byte row and stage x in that order, so
// nothing of the dequantized weight ever reaches device memory.
//
// What bounds it on the H100, and the two paths:
//  * M <= 16 (decode): the packed weight must be streamed once per call,
//    so the bound is bytes: (K/2 + 2K/g) * N bytes over 3.35 TB/s. The
//    GEMV path gives each block a 64-column strip and one 512-byte-row
//    slice of K (split-K), reads every packed byte once with 8-byte
//    loads (a warp covers 4 runs of 64 contiguous bytes; a thread walks
//    16 consecutive rows, 8 in flight, loading their scales once), stages
//    the block's slice of x in shared memory and accumulates in f32 on
//    the CUDA cores. Split-K partials go through an f32 scratch and a
//    second, tiny reduce kernel. At M = 8 that is 8 f32 FMAs per weight
//    value: ALU work that, not the bytes, limits this path on this card.
//  * M > 16 (prefill): 2*M*K*N operations over the bf16 tensor-core
//    rate bound it. The tensor-core path stages a 128 x 64 tile of x
//    (16-byte loads) and a 64 x 128 tile of W dequantized to bf16 (the
//    rounding the JAX reference applies, ops._dequant_ref) in shared
//    memory, prefetches the next K step into registers while 8 warps
//    run WMMA bf16 16x16x16 on the current one (32 x 64 outputs each).
//    No cp.async/TMA pipeline and no wgmma yet: that is future work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kGemvThreads = 256;
constexpr int kGemvBN = 64;      // columns per block: 8 column groups of 8
constexpr int kGemvRows = 512;   // packed byte rows per K split
constexpr int kGemvUnroll = 8;   // weight rows in flight per thread
constexpr int kRowsPerThread = kGemvRows / 32;   // 16 consecutive rows

constexpr int kTcThreads = 256;
constexpr int kTcBM = 128;
constexpr int kTcBN = 128;
constexpr int kTcBR = 32;        // packed byte rows per K step
constexpr int kTcBK = 2 * kTcBR; // logical K per step (low + high nibbles)
constexpr int kXsLd = kTcBK + 8;
constexpr int kWsLd = kTcBN + 8;

// Nibble v in [0, 15] -> float(v - 8), exact: 2^23 + v minus 2^23 + 8.
__device__ __forceinline__ float nib_to_float(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388616.0f;
}

__device__ __forceinline__ float scale_at(const uint4& sv, int b) {
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sv);
  return (b & 1) ? __high2float(sp[b >> 1]) : __low2float(sp[b >> 1]);
}

// kGrouped: blockIdx.z runs over (group, M tile) pairs; group grp uses
// plane slots[grp] of the [nslots, K/2, N] stack and rows grp*M ..
// grp*M + M - 1 of x, y and the partials ([splits, G*M, N]).
template <int MT, bool kGrouped>
__global__ void __launch_bounds__(kGemvThreads, 2)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s,
                const int* __restrict__ slots, int nslots,
                __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                int M, int K, int N, int g) {
  __shared__ __nv_bfloat162 xs[MT][kGemvRows];
  __shared__ float red[kGemvThreads / 32][MT][kGemvBN];

  int mt = blockIdx.z, row0 = 0, rows = M;
  if (kGrouped) {
    const int mtiles = (M + MT - 1) / MT;
    const int grp = blockIdx.z / mtiles;
    mt = blockIdx.z - grp * mtiles;
    row0 = grp * M;
    rows = (gridDim.z / mtiles) * M;
    const int slot = min(max(slots[grp], 0), nslots - 1);
    w += (size_t)slot * (size_t)(K >> 1) * N;
    s += (size_t)slot * (size_t)(K / g) * N;
  }
  x += (size_t)row0 * K;
  y += (size_t)row0 * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                 // column group in the strip
  const int rl = warp * 4 + (lane >> 3);   // row lane in the block, 0..31
  const int n0 = blockIdx.x * kGemvBN + cg * 8;
  const int m0 = mt * MT;
  const int half = g >> 1;
  const int r0 = blockIdx.y * kGemvRows;
  const int nrows = min(kGemvRows, (K >> 1) - r0);

  // x pairs (low-nibble row, high-nibble row) for this block's byte rows.
  for (int rr = tid; rr < nrows; rr += kGemvThreads) {
    const int r = r0 + rr, j = r / half;
    const int k = j * g + (r - j * half);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      __nv_bfloat162 v;
      if (m0 + m < M) {
        const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
        v.x = xr[k];
        v.y = xr[k + half];
      } else {
        v.x = __float2bfloat16(0.f);
        v.y = v.x;
      }
      xs[m][rr] = v;
    }
  }
  __syncthreads();

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[m][b] = 0.f;

  // Each thread walks kRowsPerThread consecutive byte rows (a run that
  // stays inside one scale group whenever g/2 is a multiple of it, so
  // the scales load once), kGemvUnroll rows in flight at a time.
  const int rbeg = rl * kRowsPerThread;
  if (n0 < N && rbeg < nrows) {
    int jcur = -1;
    float sc[8];
    for (int i0 = 0; i0 < kRowsPerThread; i0 += kGemvUnroll) {
      uint2 wv[kGemvUnroll];
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int rr = rbeg + i0 + u;
        if (rr < nrows)
          wv[u] = __ldg(reinterpret_cast<const uint2*>(
              w + (size_t)(r0 + rr) * N + n0));
      }
#pragma unroll
      for (int u = 0; u < kGemvUnroll; ++u) {
        const int rr = rbeg + i0 + u;
        if (rr >= nrows) break;
        const int j = (r0 + rr) / half;
        if (j != jcur) {
          const uint4 sv = __ldg(reinterpret_cast<const uint4*>(
              s + (size_t)j * N + n0));
#pragma unroll
          for (int b = 0; b < 8; ++b) sc[b] = scale_at(sv, b);
          jcur = j;
        }
        float2 xf[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xf[m] = __bfloat1622float2(xs[m][rr]);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t word = (b < 4) ? wv[u].x : wv[u].y;
          const uint32_t byte = (word >> (8 * (b & 3))) & 0xFFu;
          const float wlo = nib_to_float(byte & 0xFu) * sc[b];
          const float whi = nib_to_float(byte >> 4) * sc[b];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m][b] = fmaf(xf[m].x, wlo, fmaf(xf[m].y, whi, acc[m][b]));
        }
      }
    }
  }

  // Sum the 4 row lanes of each warp, then the 8 warps through smem.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      float v = acc[m][b];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][b] = v;
    }
  if ((lane >> 3) == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int b = 0; b < 8; ++b) red[warp][m][cg * 8 + b] = acc[m][b];
  }
  __syncthreads();
  for (int i = tid; i < MT * kGemvBN; i += kGemvThreads) {
    const int m = i / kGemvBN, c = i - m * kGemvBN;
    const int n = blockIdx.x * kGemvBN + c, mm = m0 + m;
    if (n >= N || mm >= M) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kGemvThreads / 32; ++wi) v += red[wi][m][c];
    if (gridDim.y == 1)
      y[(size_t)mm * N + n] = __float2bfloat16(v);
    else
      partial[((size_t)blockIdx.y * rows + row0 + mm) * N + n] = v;
  }
}

__global__ void qmm_splitk_reduce(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ y, int MN,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += partial[(size_t)z * MN + i];
  y[i] = __float2bfloat16(v);
}

// Dequantize 8 packed bytes (8 columns) into the low- and high-nibble
// rows of the W tile, as bf16, with one 16-byte store each.
__device__ __forceinline__ void store_dequant(__nv_bfloat16* lo_row,
                                              __nv_bfloat16* hi_row,
                                              const uint2& wv,
                                              const uint4& sv) {
  __nv_bfloat162 lo[4], hi[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t word = (p < 2) ? wv.x : wv.y;
    const uint32_t b0 = (word >> (16 * (p & 1))) & 0xFFu;
    const uint32_t b1 = (word >> (16 * (p & 1) + 8)) & 0xFFu;
    const float s0 = scale_at(sv, 2 * p), s1 = scale_at(sv, 2 * p + 1);
    lo[p] = __floats2bfloat162_rn(nib_to_float(b0 & 0xFu) * s0,
                                  nib_to_float(b1 & 0xFu) * s1);
    hi[p] = __floats2bfloat162_rn(nib_to_float(b0 >> 4) * s0,
                                  nib_to_float(b1 >> 4) * s1);
  }
  *reinterpret_cast<uint4*>(lo_row) = *reinterpret_cast<const uint4*>(lo);
  *reinterpret_cast<uint4*>(hi_row) = *reinterpret_cast<const uint4*>(hi);
}

// g is a multiple of 64, so the 32 byte rows of a K step lie in one
// scale group and the step's 64 x columns are two contiguous runs of 32;
// x moves in 16-byte vectors, prefetched into registers one step ahead.
__global__ void __launch_bounds__(kTcThreads, 2)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ w,
              const __nv_bfloat16* __restrict__ s,
              __nv_bfloat16* __restrict__ y, int M, int K, int N, int g) {
  __shared__ __align__(128) __nv_bfloat16 xs[kTcBM * kXsLd];
  __shared__ __align__(128) __nv_bfloat16 ws[kTcBK * kWsLd];
  __shared__ __align__(128) float cs[kTcThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1;   // warp row: output rows wm*32 .. +31
  const int wn = warp & 1;    // warp col: output cols wn*64 .. +63
  const int bm0 = blockIdx.y * kTcBM, bn0 = blockIdx.x * kTcBN;
  const int half = g >> 1;
  const int KB = K >> 1;

  constexpr int kXVec = kTcBM * kTcBK / 8 / kTcThreads;        // 4
  constexpr int kWVec = kTcBR * kTcBN / 8 / kTcThreads;        // 2
  uint4 xr[kXVec];
  uint2 wr[kWVec];
  uint4 sr[kWVec];

  auto fetch = [&](int r0) {
    const int j = r0 / half, kb = j * g + (r0 - j * half);
#pragma unroll
    for (int i = 0; i < kXVec; ++i) {
      const int idx = tid + i * kTcThreads, m = idx >> 3, v = idx & 7;
      const int k = kb + (v < 4 ? v * 8 : half + (v - 4) * 8);
      xr[i] = (bm0 + m < M) ? __ldg(reinterpret_cast<const uint4*>(
                                  x + (size_t)(bm0 + m) * K + k))
                            : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int idx = tid + i * kTcThreads, rr = idx >> 4, cgp = idx & 15;
      const int r = r0 + rr, n = bn0 + cgp * 8;
      wr[i] = make_uint2(0x88888888u, 0x88888888u);
      sr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) {
        wr[i] = __ldg(reinterpret_cast<const uint2*>(w + (size_t)r * N + n));
        sr[i] = __ldg(reinterpret_cast<const uint4*>(
            s + (size_t)(r / half) * N + n));
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int r0 = 0; r0 < KB; r0 += kTcBR) {
    __syncthreads();   // the previous step's tiles are consumed
    // column c < 32: low-nibble row of byte row r0 + c; c >= 32: high.
#pragma unroll
    for (int i = 0; i < kXVec; ++i) {
      const int idx = tid + i * kTcThreads, m = idx >> 3, v = idx & 7;
      *reinterpret_cast<uint4*>(xs + m * kXsLd + v * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int idx = tid + i * kTcThreads, rr = idx >> 4, cgp = idx & 15;
      store_dequant(ws + rr * kWsLd + cgp * 8,
                    ws + (rr + kTcBR) * kWsLd + cgp * 8, wr[i], sr[i]);
    }
    __syncthreads();
    if (r0 + kTcBR < KB) fetch(r0 + kTcBR);   // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * kXsLd + kk,
                               kXsLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], ws + kk * kWsLd + wn * 64 + j * 16,
                               kWsLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = bm0 + wm * 32 + i * 16 + (e >> 4);
        const int n = bn0 + wn * 64 + j * 16 + (e & 15);
        if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(cs[warp][e]);
      }
      __syncwarp();
    }
}

int gemv_splits(int K) { return ((K >> 1) + kGemvRows - 1) / kGemvRows; }

template <int MT, bool kGrouped>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* w,
                 const __nv_bfloat16* s, const int* slots, int nslots,
                 __nv_bfloat16* y, float* partial, int groups, int M, int K,
                 int N, int g, cudaStream_t stream) {
  const int splits = gemv_splits(K);
  dim3 grid((N + kGemvBN - 1) / kGemvBN, splits,
            groups * ((M + MT - 1) / MT));
  qmm_gemv_kernel<MT, kGrouped><<<grid, kGemvThreads, 0, stream>>>(
      x, w, s, slots, nslots, y, partial, M, K, N, g);
  if (splits > 1) {
    const int MN = groups * M * N;
    qmm_splitk_reduce<<<(MN + 255) / 256, 256, 0, stream>>>(partial, y, MN,
                                                            splits);
  }
}

// The GEMV (M <= 16) for `groups` row blocks of M rows each.
template <bool kGrouped>
void gemv(const __nv_bfloat16* x, const uint8_t* w, const __nv_bfloat16* s,
          const int* slots, int nslots, __nv_bfloat16* y, float* partial,
          int groups, int M, int K, int N, int g, cudaStream_t st) {
  if (M <= 1)
    launch_gemv<1, kGrouped>(x, w, s, slots, nslots, y, partial, groups, M,
                             K, N, g, st);
  else if (M <= 2)
    launch_gemv<2, kGrouped>(x, w, s, slots, nslots, y, partial, groups, M,
                             K, N, g, st);
  else if (M <= 4)
    launch_gemv<4, kGrouped>(x, w, s, slots, nslots, y, partial, groups, M,
                             K, N, g, st);
  else
    launch_gemv<8, kGrouped>(x, w, s, slots, nslots, y, partial, groups, M,
                             K, N, g, st);
}

}  // namespace

extern "C" {

// Largest M served by the GEMV (decode) path.
int ti_qmm_gemv_max_m() { return 16; }

// f32 scratch elements the call needs (split-K partials); 0 if none.
long long ti_qmm_workspace(int M, int K, int N) {
  if (M > ti_qmm_gemv_max_m() || gemv_splits(K) <= 1) return 0;
  return (long long)gemv_splits(K) * M * N;
}

// x: bf16 [M, K] contiguous; w: uint8 [K/2, N] contiguous (one layer);
// s: bf16 [K/g, N] contiguous; y: bf16 [M, N]; partial: f32 scratch of
// ti_qmm_workspace(M, K, N) elements. Needs g a multiple of 64 dividing
// K, N % 8 == 0 and 16-byte aligned w and s.
int ti_qmm_int4(const void* x, const void* w, const void* s, void* y,
                void* partial, int M, int K, int N, int g, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const __nv_bfloat16* sb = static_cast<const __nv_bfloat16*>(s);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  float* pb = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= ti_qmm_gemv_max_m()) {
    gemv<false>(xb, wb, sb, nullptr, 0, yb, pb, 1, M, K, N, g, st);
  } else {
    dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
    qmm_tc_kernel<<<grid, kTcThreads, 0, st>>>(xb, wb, sb, yb, M, K, N, g);
  }
  return ti::launch_status();
}

// x: bf16 [G, M, K] contiguous, M <= ti_qmm_gemv_max_m(); w: uint8
// [nslots, K/2, N] and s: bf16 [nslots, K/g, N], the flat expert stack;
// slots: int32 [G] on the device; y: bf16 [G, M, N]; partial: f32
// scratch of G * ti_qmm_workspace(M, K, N) elements. Same layout needs
// as ti_qmm_int4.
int ti_qmm_int4_grouped(const void* x, const void* w, const void* s,
                        const void* slots, void* y, void* partial, int G,
                        int M, int K, int N, int g, int nslots,
                        void* stream) {
  if (M > ti_qmm_gemv_max_m() || nslots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gemv<true>(static_cast<const __nv_bfloat16*>(x),
             static_cast<const uint8_t*>(w),
             static_cast<const __nv_bfloat16*>(s),
             static_cast<const int*>(slots), nslots,
             static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), G,
             M, K, N, g, static_cast<cudaStream_t>(stream));
  return ti::launch_status();
}

}  // extern "C"

// qmm: y[M, N] = x[M, K] @ dequant(W), W group-wise int4 or int8 with
// optional zero points, and its grouped form: y[g] = x[g] @
// dequant(W[slots[g]]).
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/qmm.py
// qmatmul_pallas_stacked (_qmm_stacked: _kernel_int4_idx,
// _kernel_int8_idx) and qmatmul_pallas (_qmm_2d: _kernel_int4,
// _kernel_int8), each with its asym (zero-point) branch. The layer of a
// stacked [L, K(/2), N] weight is chosen by the caller's pointer offset;
// the kernel sees one plane.
//
// The grouped entry replaces qmatmul_pallas_grouped (_qmm_grouped:
// _kernel_int4_grp, _kernel_int8_grp): MoE decode's k routed experts, G
// data-dependent planes of the flat [L*E, K(/2), N] expert stack, in ONE
// launch. It is the GEMV body below with a group axis folded into
// blockIdx.z: each block reads its group's slot id from device memory
// (no host sync), clamps it into [0, L*E - 1] so a bad id never reads
// outside the stack, and offsets the weight, scale and zero-point
// pointers by that plane (size_t offsets: an int8 plane stack passes
// 2^31 bytes within 64 planes) and x, y and the split-K partials by the
// group's rows. Bound: bytes again, G planes per call (M <= 16 only).
//
// Weight formats (the JAX package's, byte for byte). A "byte row" is
// one row of the stored plane:
//  * int4: [K/2, N] uint8; byte row r belongs to scale group j = r /
//    (g/2) at offset o = r % (g/2); its low nibble is logical row
//    k = j*g + o, its high nibble k = j*g + g/2 + o, each stored +8.
//  * int8: [K, N] int8 codes in [-128, 127]; byte row r is logical row
//    k = r, in scale group r / g.
// Scales (and zero points, when given) are bf16 [K/g, N]; the weight is
// (q - zp) * s, computed in f32; sums are f32; y is bf16. Both paths
// index by byte row and stage x in that order, so nothing of the
// dequantized weight ever reaches device memory.
//
// What bounds it on the H100, and the two paths:
//  * M <= 16 (decode): the weight must be streamed once per call, so the
//    bound is bytes: (K/2 or K + 2K/g, 4K/g with zero points) * N bytes
//    over 3.35 TB/s. The GEMV path gives each block a 64-column strip and
//    one 512-byte-row slice of K (split-K), reads every weight byte once
//    with 8-byte loads (8 columns; a warp covers 4 runs of 64 contiguous
//    bytes; a thread walks 16 consecutive byte rows, 8 in flight, loading
//    their scales once), stages the block's slice of x in shared memory
//    and accumulates in f32 on the CUDA cores. Split-K partials go
//    through an f32 scratch and a second, tiny reduce kernel. At M = 8
//    that is 8 f32 FMAs per weight value: ALU work that, not the bytes,
//    limits this path on this card.
//  * M > 16 (prefill, verify): 2*M*K*N operations over the bf16
//    tensor-core rate bound it from M of a few hundred up, the plane's
//    bytes below. qmm_tc.cu serves it: wgmma (A, the weight, dequantized
//    in registers; B, x, from shared memory) fed by a TMA ring of 3-6
//    stages on mbarriers, 256 weight columns x 64 or 128 tokens a block,
//    split-K with fixed-order partial sums when the tiles leave SMs
//    idle. Its header has the design.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kGemvThreads = 256;
constexpr int kGemvBN = 64;      // columns per block: 8 column groups of 8
constexpr int kGemvRows = 512;   // byte rows per K split
constexpr int kGemvUnroll = 8;   // weight rows in flight per thread
constexpr int kRowsPerThread = kGemvRows / 32;   // 16 consecutive rows

// Byte rows of a [K, N] plane, and byte rows per scale group.
__host__ __device__ constexpr int byte_rows(int K, int bits) {
  return bits == 4 ? K >> 1 : K;
}

// Nibble v in [0, 15] -> float(v - 8), exact: 2^23 + v minus 2^23 + 8.
__device__ __forceinline__ float nib_to_float(uint32_t v) {
  return __int_as_float(0x4B000000u | v) - 8388616.0f;
}

// Byte b of an int8 code -> its value in [-128, 127], exact: the sign
// bit flipped gives b + 128 in [0, 255]; 2^23 + that minus 2^23 + 128.
__device__ __forceinline__ float i8_to_float(uint32_t b) {
  return __int_as_float(0x4B000000u | (b ^ 0x80u)) - 8388736.0f;
}

__device__ __forceinline__ float bf16_at(const uint4& v, int b) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  return (b & 1) ? __high2float(p[b >> 1]) : __low2float(p[b >> 1]);
}

// (q - zp) * s with zero points, q * s without; q - zp is exact in f32.
template <bool kAsym>
__device__ __forceinline__ float deq(float q, float s, float z) {
  if constexpr (kAsym)
    return (q - z) * s;
  else
    return q * s;
}

// kGrouped: blockIdx.z runs over (group, M tile) pairs; group grp uses
// plane slots[grp] of the [nslots, K(/2), N] stack and rows grp*M ..
// grp*M + M - 1 of x, y and the partials ([splits, G*M, N]).
template <int MT, bool kGrouped, int kBits, bool kAsym>
__global__ void __launch_bounds__(kGemvThreads, 2)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s,
                const __nv_bfloat16* __restrict__ zp,
                const int* __restrict__ slots, int nslots,
                __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                int M, int K, int N, int g) {
  // int4: x pairs (low-nibble row, high-nibble row) per byte row;
  // int8: one x value per byte row.
  using XT = std::conditional_t<kBits == 4, __nv_bfloat162, __nv_bfloat16>;
  __shared__ XT xs[MT][kGemvRows];
  __shared__ float red[kGemvThreads / 32][MT][kGemvBN];

  const int KB = byte_rows(K, kBits);
  const int gr = byte_rows(g, kBits);      // byte rows per scale group
  int mt = blockIdx.z, row0 = 0, rows = M;
  if (kGrouped) {
    const int mtiles = (M + MT - 1) / MT;
    const int grp = blockIdx.z / mtiles;
    mt = blockIdx.z - grp * mtiles;
    row0 = grp * M;
    rows = (gridDim.z / mtiles) * M;
    const size_t slot = (size_t)min(max(slots[grp], 0), nslots - 1);
    w += slot * (size_t)KB * N;
    s += slot * (size_t)(K / g) * N;
    if (kAsym) zp += slot * (size_t)(K / g) * N;
  }
  x += (size_t)row0 * K;
  y += (size_t)row0 * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                 // column group in the strip
  const int rl = warp * 4 + (lane >> 3);   // row lane in the block, 0..31
  const int n0 = blockIdx.x * kGemvBN + cg * 8;
  const int m0 = mt * MT;
  const int r0 = blockIdx.y * kGemvRows;
  const int nrows = min(kGemvRows, KB - r0);

  // x for this block's byte rows, in byte-row order.
  for (int rr = tid; rr < nrows; rr += kGemvThreads) {
    const int r = r0 + rr;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bool live = m0 + m < M;
      const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
      if constexpr (kBits == 4) {
        const int j = r / gr;
        const int k = j * g + (r - j * gr);
        __nv_bfloat162 v;
        v.x = live ? xr[k] : __float2bfloat16(0.f);
        v.y = live ? xr[k + gr] : __float2bfloat16(0.f);
        xs[m][rr] = v;
      } else {
        xs[m][rr] = live ? xr[r] : __float2bfloat16(0.f);
      }
    }
  }
  __syncthreads();

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[m][b] = 0.f;

  // Each thread walks kRowsPerThread consecutive byte rows (a run that
  // stays inside one scale group whenever the group's byte rows are a
  // multiple of it, so the scales load once), kGemvUnroll in flight.
  const int rbeg = rl * kRowsPerThread;
  if (n0 < N && rbeg < nrows) {
    int jcur = -1;
    float sc[8], zf[8] = {};
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
        const int j = (r0 + rr) / gr;
        if (j != jcur) {
          const uint4 sv = __ldg(reinterpret_cast<const uint4*>(
              s + (size_t)j * N + n0));
#pragma unroll
          for (int b = 0; b < 8; ++b) sc[b] = bf16_at(sv, b);
          if constexpr (kAsym) {
            const uint4 zv = __ldg(reinterpret_cast<const uint4*>(
                zp + (size_t)j * N + n0));
#pragma unroll
            for (int b = 0; b < 8; ++b) zf[b] = bf16_at(zv, b);
          }
          jcur = j;
        }
        if constexpr (kBits == 4) {
          float2 xf[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) xf[m] = __bfloat1622float2(xs[m][rr]);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t word = (b < 4) ? wv[u].x : wv[u].y;
            const uint32_t byte = (word >> (8 * (b & 3))) & 0xFFu;
            const float wlo = deq<kAsym>(nib_to_float(byte & 0xFu), sc[b],
                                         zf[b]);
            const float whi = deq<kAsym>(nib_to_float(byte >> 4), sc[b],
                                         zf[b]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][b] = fmaf(xf[m].x, wlo, fmaf(xf[m].y, whi, acc[m][b]));
          }
        } else {
          float xf[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m) xf[m] = __bfloat162float(xs[m][rr]);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t word = (b < 4) ? wv[u].x : wv[u].y;
            const float wq = deq<kAsym>(
                i8_to_float((word >> (8 * (b & 3))) & 0xFFu), sc[b], zf[b]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][b] = fmaf(xf[m], wq, acc[m][b]);
          }
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

int gemv_splits(int K, int bits) {
  return (byte_rows(K, bits) + kGemvRows - 1) / kGemvRows;
}

// Operands of one call: zp is null for symmetric weights.
struct Args {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zp;
  const int* slots;
  int nslots;
  __nv_bfloat16* y;
  float* partial;
  int groups, M, K, N, g, bits;
  cudaStream_t stream;
};

template <int MT, bool kGrouped, int kBits, bool kAsym>
void launch_gemv(const Args& a) {
  const int splits = gemv_splits(a.K, kBits);
  dim3 grid((a.N + kGemvBN - 1) / kGemvBN, splits,
            a.groups * ((a.M + MT - 1) / MT));
  qmm_gemv_kernel<MT, kGrouped, kBits, kAsym>
      <<<grid, kGemvThreads, 0, a.stream>>>(a.x, a.w, a.s, a.zp, a.slots,
                                            a.nslots, a.y, a.partial, a.M,
                                            a.K, a.N, a.g);
  if (splits > 1) {
    const int MN = a.groups * a.M * a.N;
    qmm_splitk_reduce<<<(MN + 255) / 256, 256, 0, a.stream>>>(a.partial, a.y,
                                                              MN, splits);
  }
}

// The GEMV (M <= 16) for `groups` row blocks of M rows each.
template <bool kGrouped, int kBits, bool kAsym>
void gemv(const Args& a) {
  if (a.M <= 1)
    launch_gemv<1, kGrouped, kBits, kAsym>(a);
  else if (a.M <= 2)
    launch_gemv<2, kGrouped, kBits, kAsym>(a);
  else if (a.M <= 4)
    launch_gemv<4, kGrouped, kBits, kAsym>(a);
  else
    launch_gemv<8, kGrouped, kBits, kAsym>(a);
}

template <bool kGrouped>
void gemv_any(const Args& a) {
  if (a.bits == 4)
    a.zp ? gemv<kGrouped, 4, true>(a) : gemv<kGrouped, 4, false>(a);
  else
    a.zp ? gemv<kGrouped, 8, true>(a) : gemv<kGrouped, 8, false>(a);
}

}  // namespace

namespace ti {   // qmm_tc.cu: the tensor-core path (M > 16)
long long qmm_tc_workspace(int M, int K, int N, int bits);
int qmm_tc(const void* x, const void* w, const void* s, const void* zp,
           void* y, void* partial, int M, int K, int N, int g, int bits,
           cudaStream_t stream);
}  // namespace ti

extern "C" {

// Largest M served by the GEMV (decode) path.
int ti_qmm_gemv_max_m() { return 16; }

// f32 scratch elements the call needs (split-K partials); 0 if none.
long long ti_qmm_workspace(int M, int K, int N, int bits) {
  if (M > ti_qmm_gemv_max_m()) return ti::qmm_tc_workspace(M, K, N, bits);
  if (gemv_splits(K, bits) <= 1) return 0;
  return (long long)gemv_splits(K, bits) * M * N;
}

// x: bf16 [M, K] contiguous; w: one layer's plane, uint8 [K/2, N]
// (bits 4) or int8 [K, N] (bits 8), contiguous; s: bf16 [K/g, N]
// contiguous; zp: bf16 [K/g, N] zero points, or null for symmetric
// weights; y: bf16 [M, N]; partial: f32 scratch of
// ti_qmm_workspace(M, K, N, bits) elements. Needs g a multiple of 64
// dividing K, N % 8 == 0 and 16-byte aligned w, s and zp.
int ti_qmm(const void* x, const void* w, const void* s, const void* zp,
           void* y, void* partial, int M, int K, int N, int g, int bits,
           void* stream) {
  if (bits != 4 && bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const uint8_t*>(w),
               static_cast<const __nv_bfloat16*>(s),
               static_cast<const __nv_bfloat16*>(zp), nullptr, 0,
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial),
               1, M, K, N, g, bits, static_cast<cudaStream_t>(stream)};
  if (M > ti_qmm_gemv_max_m())
    return ti::qmm_tc(x, w, s, zp, y, partial, M, K, N, g, bits,
                      a.stream);
  gemv_any<false>(a);
  return ti::launch_status();
}

// x: bf16 [G, M, K] contiguous, M <= ti_qmm_gemv_max_m(); w: the flat
// expert stack [nslots, K/2, N] uint8 (bits 4) or [nslots, K, N] int8
// (bits 8); s (and zp, or null): bf16 [nslots, K/g, N]; slots: int32
// [G] on the device; y: bf16 [G, M, N]; partial: f32 scratch of
// G * ti_qmm_workspace(M, K, N, bits) elements. Same layout needs as
// ti_qmm.
int ti_qmm_grouped(const void* x, const void* w, const void* s,
                   const void* zp, const void* slots, void* y, void* partial,
                   int G, int M, int K, int N, int g, int bits, int nslots,
                   void* stream) {
  if (M > ti_qmm_gemv_max_m() || nslots <= 0 || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  gemv_any<true>(Args{static_cast<const __nv_bfloat16*>(x),
                      static_cast<const uint8_t*>(w),
                      static_cast<const __nv_bfloat16*>(s),
                      static_cast<const __nv_bfloat16*>(zp),
                      static_cast<const int*>(slots), nslots,
                      static_cast<__nv_bfloat16*>(y),
                      static_cast<float*>(partial), G, M, K, N, g, bits,
                      static_cast<cudaStream_t>(stream)});
  return ti::launch_status();
}

}  // extern "C"

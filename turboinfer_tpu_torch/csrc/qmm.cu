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
// (q - zp) * s, rounded to bf16 as the JAX bodies round it; sums are
// f32; y is bf16. Nothing of the dequantized weight reaches device
// memory.
//
// What bounds it on the H100, and the two paths:
//  * M <= 16 (decode): the weight must be streamed once per call, so the
//    bound is bytes: (K/2 or K + 2K/g, 4K/g with zero points) * N bytes
//    over 3.35 TB/s. The GEMV below keeps the arithmetic under that and
//    the loads in flight:
//    - The products run on the tensor cores: mma.sync m16n8k16 bf16
//      with f32 sums, the weight as A (16 weight columns x 16 k), x as B
//      (16 k x 8 tokens; M > 8 takes a second token tile), so the CUDA
//      cores only dequantize, ~2 operations an int4 weight and ~3 an
//      int8 one. Each weight value is rounded to bf16 as the JAX bodies
//      round it: int4 symmetric by the magic-number trick (0x4300 | v is
//      128 + v; minus 136 is v - 8, exact) and one bf16x2 multiply by
//      the column's scale (the f32 product of two 8-bit significands is
//      exact, so its one rounding is JAX's); int8 codes exactly to bf16
//      through an f32 magic add and byte permutes, then the same
//      multiply; zero points as JAX computes them, (q - zp) * s in f32,
//      then cvt.rn.bf16x2.
//    - The k order within a scale group is free (the sum over it is
//      order-free): a thread loads 8 consecutive byte rows of 16
//      consecutive columns, and each k16 step's fragments come straight
//      from those 16-byte vectors. int4: a byte row pair (r, r + 1)
//      gives the k pair (k, k + 1) of its low nibbles and (k + g/2,
//      k + g/2 + 1) of its high ones; int8: rows (r, r + 1) and (r + 2,
//      r + 3). x is read in the same order, so a thread's activations
//      for a step are 16 contiguous bytes per token (two for int4).
//    - Loads: 16-byte ld.global.nc that skip L1, into registers, two
//      steps deep (the next step's 8 vectors are in flight while this
//      one is dequantized), 4 KB of weight per warp per step; the next
//      step's scale, zero-point and x lines are prefetched into L1.
//      (A per-thread cp.async ring through shared memory, tried first,
//      streamed this access pattern markedly slower on the H100.)
//    - Enough blocks: a block of 4 warps owns a 128-column strip and a
//      share of K (split-K), its warps splitting that share again
//      (gemv_splits plans the count). The warps' sums meet in shared
//      memory; with split-K each block writes its f32 partial, counts
//      itself in the strip's arrival counter, and the last block to
//      arrive sums the partials in split order (repeat calls give the
//      same bits) into y and zeroes the counter again, so one launch
//      does it all.
//    Weight rows whose N bytes are not a multiple of 16 are read as
//    8-byte halves; columns past N read zeros and are not written.
//  * M > 16 (prefill, verify): 2*M*K*N operations over the bf16
//    tensor-core rate bound it from M of a few hundred up, the plane's
//    bytes below. qmm_tc.cu serves it: wgmma (A, the weight, dequantized
//    in registers; B, x, from shared memory) fed by a TMA ring of 3-6
//    stages on mbarriers, 256 weight columns x 64 or 128 tokens a block,
//    split-K with fixed-order partial sums when the tiles leave SMs
//    idle. Its header has the design.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsB = kThreads / 32;   // a block's warps split its K share
constexpr int kStrip = 128;        // weight columns a block (16 a lane group)
constexpr int kStepRows = 32;      // byte rows a warp step (4 KB)
constexpr int kFillBlocks = 264;   // ~2 blocks on each of 132 SMs

__host__ __device__ constexpr int byte_rows(int K, int bits) {
  return bits == 4 ? K >> 1 : K;
}

// 16-byte vectors of x a thread reads a step for a token tile: int4 the
// low- and high-nibble k (g/2 apart), int8 one.
template <int kBits>
constexpr int kXPer = kBits == 4 ? 2 : 1;

// 16 bytes of global memory read once: not kept in L1.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 r;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr uint32_t kBf136 = 0x43084308u;     // bf16x2 (136, 136)
constexpr uint32_t kMagic4 = 0x43004300u;    // bf16x2 (128, 128)

// Byte p of two 32-bit words a, b (column c of byte rows r, r + 1) ->
// bf16x2 pairs: int4 low nibbles (lo) and high nibbles (hi), each
// (value - 8), unscaled.
__device__ __forceinline__ void nib_pairs(uint32_t a, uint32_t b, int p,
                                          uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(a, b, p | ((4 + p) << 8));
  lo = bf2_sub((t & 0x000F000Fu) | kMagic4, kBf136);
  hi = bf2_sub(((t >> 4) & 0x000F000Fu) | kMagic4, kBf136);
}

// Byte p of an int8 word whose bytes were XORed with 0x80 -> 2^23 +
// code + 128 as f32 (exact); minus 2^23 + 128 (+ z) is the code (- z).
__device__ __forceinline__ float i8m(uint32_t wx, int p) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, p | 0x7440));
}

// The nibble at bit `shift` of a, v -> f32 v - 8, exact: 2^23 + v minus
// 2^23 + 8.
__device__ __forceinline__ float nibf(uint32_t a, int shift) {
  return __uint_as_float(((a >> shift) & 0xFu) | 0x4B000000u) - 8388616.0f;
}

template <int kBits, bool kAsym, int MT, bool kVec16, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s,
                const __nv_bfloat16* __restrict__ zp,
                const int* __restrict__ slots, int nslots,
                __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                int* __restrict__ counters, int M, int K, int N, int g,
                int splits) {
  constexpr int kE = MT * 32;                 // accumulators a thread
  extern __shared__ __align__(16) float red[];  // [warps][kE][32]
  __shared__ int flag;
  const int KB = byte_rows(K, kBits);
  const int bcol = blockIdx.x, split = blockIdx.y, grp = blockIdx.z;
  const int bcols = gridDim.x;
  if (kGrouped) {
    const size_t slot = (size_t)min(max(slots[grp], 0), nslots - 1);
    w += slot * (size_t)KB * N;
    s += slot * (size_t)(K / g) * N;
    if (kAsym) zp += slot * (size_t)(K / g) * N;
    x += (size_t)grp * M * K;
    y += (size_t)grp * M * N;
    partial += (size_t)grp * splits * M * N;
    counters += (size_t)grp * bcols;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, q = lane & 3;
  const int col0 = bcol * kStrip + gi * 16;      // this lane's 16 columns
  const int cbytes = min(max(N - col0, 0), 16);  // 0, 8 or 16
  const int gr = byte_rows(g, kBits);            // byte rows a group

  // This warp's steps: an even share of the block's split of K.
  const int nsteps = KB / kStepRows;
  const int wt = split * kWarpsB + warp, nw = splits * kWarpsB;
  const int st0 = (int)((long long)wt * nsteps / nw);
  const int st1 = (int)((long long)(wt + 1) * nsteps / nw);

  // Step st: byte rows r0 = 32 st .. + 32 in scale group j; x at k0
  // (int4: j*g + (r0 - j*gr) + 8q, + g/2 for the high nibbles; int8:
  // r0 + 8q).
  auto group = [&](int st) { return st * kStepRows / gr; };
  auto xk = [&](int st) {
    const int r0 = st * kStepRows, j = r0 / gr;
    return kBits == 4 ? j * g + (r0 - j * gr) + 8 * q : r0 + 8 * q;
  };
  // The step's 8 weight rows of this lane's 16 columns, zeros past N.
  auto load_w = [&](int st, uint4 (&wv)[8]) {
    const uint8_t* wr = w + ((size_t)st * kStepRows + 8 * q) * N + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (kVec16) {
        wv[i] = cbytes ? ld_stream16(wr + (size_t)i * N)
                       : make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint2 lo = cbytes ? ld_stream8(wr + (size_t)i * N)
                                : make_uint2(0u, 0u);
        const uint2 hi = cbytes == 16 ? ld_stream8(wr + (size_t)i * N + 8)
                                      : make_uint2(0u, 0u);
        wv[i] = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  };
  // The next step's scales, zero points and x lines, into L1.
  auto prefetch = [&](int st) {
    if (cbytes) {
      prefetch_l1(s + (size_t)group(st) * N + col0);
      if constexpr (kAsym) prefetch_l1(zp + (size_t)group(st) * N + col0);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int m = t * 8 + gi;
      if (m < M) {
        const __nv_bfloat16* xr = x + (size_t)m * K + xk(st);
        prefetch_l1(xr);
        if constexpr (kBits == 4) prefetch_l1(xr + g / 2);
      }
    }
  };

  float acc[MT][8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][i][c] = 0.f;

  // Dequantizes step st's weights wv and runs its mmas, 8 columns (4
  // mmas a k16 block) at a time to keep fewer values live.
  auto compute = [&](int st, const uint4 (&wv)[8]) {
    const int j = group(st);
    uint4 xv[MT][kXPer<kBits>];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int m = t * 8 + gi;
      const __nv_bfloat16* xr = x + (size_t)min(m, M - 1) * K + xk(st);
#pragma unroll
      for (int h = 0; h < kXPer<kBits>; ++h)
        xv[t][h] = m < M ? __ldg(reinterpret_cast<const uint4*>(xr + h * g / 2))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // columns 8 half .. + 8: their bf16 scales (zeros past N; N % 8 ==
      // 0, so a vector is wholly inside or past it)
      auto cols8 = [&](const __nv_bfloat16* base) {
        return cbytes > 8 * half
                   ? __ldg(reinterpret_cast<const uint4*>(
                         base + (size_t)j * N + col0 + 8 * half))
                   : make_uint4(0u, 0u, 0u, 0u);
      };
      const uint4 sv = cols8(s);
      // per column: bf16x2 (s, s), or f32 s and z
      uint32_t s2[8];
      float sf[kAsym ? 8 : 1], zf[kAsym ? 8 : 1];
      if constexpr (kAsym) {
        const uint4 zv = cols8(zp);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t sw = word(sv, c >> 1), zw = word(zv, c >> 1);
          sf[c] = __uint_as_float((c & 1) ? (sw & 0xFFFF0000u) : (sw << 16));
          zf[c] = __uint_as_float((c & 1) ? (zw & 0xFFFF0000u) : (zw << 16));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t sw = word(sv, c >> 1);
          s2[c] = __byte_perm(sw, sw, (c & 1) ? 0x3232u : 0x1010u);
        }
      }
      constexpr int kBlocks = kBits == 4 ? 4 : 2;   // k16 blocks a step
#pragma unroll
      for (int kb = 0; kb < kBlocks; ++kb) {
        // A fragments of mma i (columns 2i, 2i + 1 of the half): {col 2i
        // slots 0-7 (k pairs), col 2i+1 slots 0-7, col 2i slots 8-15,
        // col 2i+1 slots 8-15}.
        uint32_t a[4][4];
        if constexpr (kBits == 4) {
          const uint4 ra = wv[2 * kb], rb = wv[2 * kb + 1];
#pragma unroll
          for (int wd = 0; wd < 2; ++wd) {
            const uint32_t wa = word(ra, 2 * half + wd);
            const uint32_t wb = word(rb, 2 * half + wd);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int c = 4 * wd + p, i = c >> 1, r = c & 1;
              if constexpr (kAsym) {
                const uint32_t sh = 8 * p;
                a[i][r] = ti::pack_bf16((nibf(wa, sh) - zf[c]) * sf[c],
                                 (nibf(wb, sh) - zf[c]) * sf[c]);
                a[i][2 + r] = ti::pack_bf16((nibf(wa, sh + 4) - zf[c]) * sf[c],
                                     (nibf(wb, sh + 4) - zf[c]) * sf[c]);
              } else {
                uint32_t lo, hi;
                nib_pairs(wa, wb, p, lo, hi);
                a[i][r] = bf2_mul(lo, s2[c]);
                a[i][2 + r] = bf2_mul(hi, s2[c]);
              }
            }
          }
        } else {
#pragma unroll
          for (int wd = 0; wd < 2; ++wd) {
            uint32_t wx[4];
#pragma unroll
            for (int h = 0; h < 4; ++h)
              wx[h] = word(wv[4 * kb + h], 2 * half + wd) ^ 0x80808080u;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int c = 4 * wd + p, i = c >> 1, r = c & 1;
#pragma unroll
              for (int hp = 0; hp < 2; ++hp) {    // rows (0, 1), (2, 3)
                const float q0 = i8m(wx[2 * hp], p) - 8388736.0f;
                const float q1 = i8m(wx[2 * hp + 1], p) - 8388736.0f;
                if constexpr (kAsym) {
                  a[i][2 * hp + r] =
                      ti::pack_bf16((q0 - zf[c]) * sf[c], (q1 - zf[c]) * sf[c]);
                } else {   // the exact code's top 16 bits are its bf16
                  a[i][2 * hp + r] = bf2_mul(
                      __byte_perm(__float_as_uint(q0), __float_as_uint(q1), 0x7632u),
                      s2[c]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const uint32_t b0 = word(xv[t][0], kBits == 4 ? kb : 2 * kb);
          const uint32_t b1 =
              kBits == 4 ? word(xv[t][1], kb) : word(xv[t][0], 2 * kb + 1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ti::mma_bf16(acc[t][4 * half + i], a[i], b0, b1);
        }
      }
    }
  };

  // Two steps' weights in registers: the next step's loads are in flight
  // while this one's are dequantized.
  uint4 wa[8], wb[8];
  if (st0 < st1) {
    load_w(st0, wa);
    prefetch(st0);
  }
  for (int st = st0; st < st1; st += 2) {
    if (st + 1 < st1) {
      load_w(st + 1, wb);
      prefetch(st + 1);
    }
    compute(st, wa);
    if (st + 1 < st1) {
      if (st + 2 < st1) {
        load_w(st + 2, wa);
        prefetch(st + 2);
      }
      compute(st + 1, wb);
    }
  }

  // The warps' sums meet in shared memory: red[warp][e][lane], e =
  // (t * 8 + i) * 4 + c holding column col0 + 2i + (c >> 1), token
  // t * 8 + 2q + (c & 1) of this lane.
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * kE + (t * 8 + i) * 4 + c) * 32 + lane] = acc[t][i][c];
  __syncthreads();
  // Warp w finishes e in [w * kE / kWarpsB, (w + 1) * kE / kWarpsB) over
  // the block's warps, taken as column pairs: (c = 0, 2) for token 2q,
  // (1, 3) for 2q + 1.
  for (int e0 = warp * kE / kWarpsB; e0 < (warp + 1) * kE / kWarpsB;
       e0 += 4) {
    const int t = e0 / 32, i = (e0 / 4) % 8;
    const int col = col0 + 2 * i;
#pragma unroll
    for (int tk = 0; tk < 2; ++tk) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kWarpsB; ++k)
          sum += red[(k * kE + e0 + 2 * h + tk) * 32 + lane];
        v[h] = sum;
      }
      const int m = t * 8 + 2 * q + tk;
      if (m >= M || col >= N) continue;
      if (splits == 1)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      else
        *reinterpret_cast<float2*>(partial + ((size_t)split * M + m) * N +
                                   col) = make_float2(v[0], v[1]);
    }
  }
  if (splits == 1 ||
      !ti::last_to_arrive(counters + bcol, splits, &flag))
    return;

  // The last block of the column block sums the splits in order, 4
  // columns of a token row a unit, a thread's units (at most 4) 4 splits
  // at a time: 16 loads in flight.
  constexpr int kU = (16 * kStrip / 4 + kThreads - 1) / kThreads;
  const int n0 = bcol * kStrip, units = M * (kStrip / 4);
  const size_t stride = (size_t)M * N / 4;     // float4s a split
  const float4* pu[kU];
  float4 sum[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = tid + u * kThreads;
    const int m = i / (kStrip / 4), col = n0 + 4 * (i % (kStrip / 4));
    pu[u] = i < units && col < N
                ? reinterpret_cast<const float4*>(partial + (size_t)m * N + col)
                : nullptr;
    sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int sp = 0; sp < splits; sp += 4) {
    float4 v[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[u][k] = pu[u] && sp + k < splits ? __ldcg(pu[u] + (sp + k) * stride)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sum[u].x += v[u][k].x;
        sum[u].y += v[u][k].y;
        sum[u].z += v[u][k].z;
        sum[u].w += v[u][k].w;
      }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (!pu[u]) continue;
    const int i = tid + u * kThreads;
    const int m = i / (kStrip / 4), col = n0 + 4 * (i % (kStrip / 4));
    __nv_bfloat162* yp =
        reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + col);
    yp[0] = __floats2bfloat162_rn(sum[u].x, sum[u].y);
    yp[1] = __floats2bfloat162_rn(sum[u].z, sum[u].w);
  }
  if (tid == 0) counters[bcol] = 0;
}

// K splits of the GEMV for `cols` column blocks (all groups'), as
// measured on the H100 over the 7B, Mixtral and GPT-OSS projection
// shapes: a narrow plane (at most 66 column blocks, so 4 splits or
// more) fills one wave of 2 blocks an SM, Mixtral's two 32-block expert
// planes too; a wider one takes the count whose blocks come nearest
// above ~2.3 an SM unless that passes a wave of 3, more for zero points
// and two token tiles, whose heavier dequantization and mmas want more
// warps. Each warp keeps at least one step.
int gemv_splits(int K, int cols, int bits, bool heavy) {
  const int steps = byte_rows(K, bits) / kStepRows;
  int s;
  if (cols * 4 <= kFillBlocks) {
    s = kFillBlocks / cols;
  } else {
    const int target = (heavy ? 1800 : 1200) / kWarpsB, most = target * 4 / 3;
    s = (target + cols - 1) / cols;
    if (s > 1 && (long long)s * cols > most) --s;
  }
  return max(1, min(s, steps / kWarpsB));
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
  int* counters;
  int groups, M, K, N, g, bits;
  cudaStream_t stream;
};

// K splits of a GEMV call over `groups` planes of N columns; heavy: zero
// points or two token tiles (M > 8). The launch and the scratch size
// both read it.
int call_splits(int K, int N, int groups, int bits, bool heavy) {
  return gemv_splits(K, (N + kStrip - 1) / kStrip * groups, bits, heavy);
}

template <int kBits, bool kAsym, int MT, bool kVec16, bool kGrouped>
int launch_gemv(const Args& a) {
  auto kernel = qmm_gemv_kernel<kBits, kAsym, MT, kVec16, kGrouped>;
  const int bcols = (a.N + kStrip - 1) / kStrip;
  const int splits = call_splits(a.K, a.N, a.groups, kBits, kAsym || MT > 1);
  dim3 grid(bcols, splits, a.groups);
  constexpr int kSmem = kWarpsB * MT * 32 * 32 * 4;   // the warps' sums
  static const int allowed = ti::allow_smem(kernel, kSmem);
  if (allowed) return allowed;
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      a.x, a.w, a.s, a.zp, a.slots, a.nslots, a.y, a.partial, a.counters,
      a.M, a.K, a.N, a.g, splits);
  return 0;
}

template <int kBits, bool kAsym, bool kGrouped>
int gemv_mt(const Args& a) {
  const bool v16 = a.N % 16 == 0;
  if (a.M <= 8)
    return v16 ? launch_gemv<kBits, kAsym, 1, true, kGrouped>(a)
               : launch_gemv<kBits, kAsym, 1, false, kGrouped>(a);
  return v16 ? launch_gemv<kBits, kAsym, 2, true, kGrouped>(a)
             : launch_gemv<kBits, kAsym, 2, false, kGrouped>(a);
}

template <bool kGrouped>
int gemv_any(const Args& a) {
  if (a.bits == 4)
    return a.zp ? gemv_mt<4, true, kGrouped>(a) : gemv_mt<4, false, kGrouped>(a);
  return a.zp ? gemv_mt<8, true, kGrouped>(a) : gemv_mt<8, false, kGrouped>(a);
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

// Arrival counters one group of a GEMV call uses: its column blocks.
int ti_qmm_counters(int N) { return (N + kStrip - 1) / kStrip; }

// f32 scratch elements a grouped call of G planes needs (split-K
// partials, G groups of the launch's splits x M x N); 0 if none. The
// split count follows all G planes' column blocks (gemv_splits is not
// monotone in them), so it is planned for G, not for one group.
long long ti_qmm_grouped_workspace(int G, int M, int K, int N, int bits) {
  const int splits = max(call_splits(K, N, G, bits, false),
                         call_splits(K, N, G, bits, true));
  return splits <= 1 ? 0 : (long long)G * splits * M * N;
}

// f32 scratch elements the call needs (split-K partials); 0 if none.
long long ti_qmm_workspace(int M, int K, int N, int bits) {
  if (M > ti_qmm_gemv_max_m()) return ti::qmm_tc_workspace(M, K, N, bits);
  return ti_qmm_grouped_workspace(1, M, K, N, bits);
}

// x: bf16 [M, K] contiguous; w: one layer's plane, uint8 [K/2, N]
// (bits 4) or int8 [K, N] (bits 8), contiguous; s: bf16 [K/g, N]
// contiguous; zp: bf16 [K/g, N] zero points, or null for symmetric
// weights; y: bf16 [M, N]; partial: f32 scratch of
// ti_qmm_workspace(M, K, N, bits) elements; counters: at least
// ti_qmm_counters(N) int32 zeros, left zeros (M <= 16 only). Needs g a
// multiple of 64 dividing K, N % 8 == 0 and 16-byte aligned x, w, s and
// zp.
int ti_qmm(const void* x, const void* w, const void* s, const void* zp,
           void* y, void* partial, void* counters, int M, int K, int N,
           int g, int bits, void* stream) {
  if (bits != 4 && bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const uint8_t*>(w),
               static_cast<const __nv_bfloat16*>(s),
               static_cast<const __nv_bfloat16*>(zp), nullptr, 0,
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial),
               static_cast<int*>(counters), 1, M, K, N, g, bits,
               static_cast<cudaStream_t>(stream)};
  if (M > ti_qmm_gemv_max_m())
    return ti::qmm_tc(x, w, s, zp, y, partial, M, K, N, g, bits,
                      a.stream);
  const int bad = gemv_any<false>(a);
  return bad ? bad : ti::launch_status();
}

// x: bf16 [G, M, K] contiguous, M <= ti_qmm_gemv_max_m(); w: the flat
// expert stack [nslots, K/2, N] uint8 (bits 4) or [nslots, K, N] int8
// (bits 8); s (and zp, or null): bf16 [nslots, K/g, N]; slots: int32
// [G] on the device; y: bf16 [G, M, N]; partial: f32 scratch of
// ti_qmm_grouped_workspace(G, M, K, N, bits) elements; counters: G *
// ti_qmm_counters(N) int32 zeros, left zeros. Same layout needs as
// ti_qmm.
int ti_qmm_grouped(const void* x, const void* w, const void* s,
                   const void* zp, const void* slots, void* y, void* partial,
                   void* counters, int G, int M, int K, int N, int g,
                   int bits, int nslots, void* stream) {
  if (M > ti_qmm_gemv_max_m() || nslots <= 0 || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bad = gemv_any<true>(
      Args{static_cast<const __nv_bfloat16*>(x),
           static_cast<const uint8_t*>(w),
           static_cast<const __nv_bfloat16*>(s),
           static_cast<const __nv_bfloat16*>(zp),
           static_cast<const int*>(slots), nslots,
           static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial),
           static_cast<int*>(counters), G, M, K, N, g, bits,
           static_cast<cudaStream_t>(stream)});
  return bad ? bad : ti::launch_status();
}

}  // extern "C"

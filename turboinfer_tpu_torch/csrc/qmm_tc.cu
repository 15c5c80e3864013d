// qmm_tc: the tensor-core path of qmm (M > 16): y[M, N] = x[M, K] @
// dequant(W) for one int4 or int8 weight plane, with or without zero
// points, on Hopper's wgmma fed by TMA. ti_qmm (qmm.cu) calls it for
// every M above ti_qmm_gemv_max_m().
//
// Replaces, at prefill and verify row counts, the TPU kernels
// turboinfer_tpu/kernels/pallas/qmm.py qmatmul_pallas_stacked
// (_qmm_stacked: _kernel_int4_idx, _kernel_int8_idx) and qmatmul_pallas
// (_qmm_2d: _kernel_int4, _kernel_int8), with their asym branches. The
// caller's pointer offset picks a stack's plane.
//
// Semantics (qmm.cu's header has the byte formats): the weight is
// (q - zp) * s in f32, rounded once to bf16; sums are f32; y is rounded
// once to bf16. Symmetric weights take the product q * s in bf16
// (mul.rn.bf16x2): q has at most 8 significant bits and s 8, so the f32
// product is exact and its one rounding to bf16 gives the same bits.
//
// What bounds it on the H100: 2*M*K*N operations over the bf16
// tensor-core rate (989 TFLOP/s dense) from M of a few hundred up; below
// that the weight plane, read once (K/2 or K bytes a column plus its
// scales) over 3.35 TB/s.
//
// Design. The operands are swapped: y^T = W^T x^T, so the weight's
// columns are wgmma's 64-row M and the tokens its N (a 64- or 128-token
// tile: M = 17..64 is not padded to 128). A block is two warpgroups,
// each owning 128 weight columns (two m64 tiles) of a 256-column strip.
// A stage holds 128 logical k: four TMA boxes of x (tokens x 32 columns,
// 64-byte swizzle, read by wgmma as its K-major B straight from shared
// memory), the raw weight bytes (64 int4 or 128 int8 byte rows x 128
// columns for each warpgroup, 128-byte swizzle) and two rows of scales
// (and zero points). A ring of 3-6 stages (as many as 227 KB hold) is
// kept full through mbarriers: the last warp to finish with a stage (a
// shared counter) refills it, so no warp waits for another and no
// producer warp is needed: a third warpgroup would cap every thread at
// 168 registers, and the 128 f32 accumulators plus two chunks of A
// fragments need more (ptxas then serializes the wgmmas).
//
// A thread reads the weight bytes it needs with conflict-free 4-byte
// loads and dequantizes them in registers into wgmma's A fragment (the
// RS form); the dequantized weight never goes back to shared memory:
//  * int4: a 16-byte-row chunk's low nibbles are a k16 of x columns
//    j*g + o.., its high nibbles the k16 g/2 columns on; the x box of a
//    32-byte-row unit is placed by that unit's group, so any g that is a
//    multiple of 64 works (a stage may straddle a group's end). One byte
//    fills the same fragment slot of two wgmmas (low and high k16): a
//    nibble becomes bf16 128+u with one LOP3, minus 136 is u-8 exactly,
//    then times the scale.
//  * int8: a code becomes f32 by the 2^23 trick, then bf16 (exact), then
//    times the scale.
//  * zero points: (q - zp) * s in f32, then cvt.rn.bf16x2.
// Each thread owns four adjacent weight columns (its two fragment rows in
// each m64 tile), so one 4-byte load feeds 8 (int4) or 4 (int8) values
// and the epilogue writes a token's 8 adjacent bf16 outputs with one
// 16-byte store after one shuffle. A chunk is dequantized while the
// previous chunk's wgmmas run (A fragments double-buffered, wait_group 1),
// the next stage's first chunk during the last chunk of this one.
//
// Tiles fill the 132 SMs by split-K: the tiles that fill whole waves of
// SMs run over all of K, and the rest (all of them at small M) may each
// be cut into S parts over K, S from a model of SM-waves and the parts'
// round trip (plan, below); the parts go through the caller's f32
// workspace and a second kernel sums them in a fixed order (no atomics:
// a call's bits repeat). Tokens are the fastest tile axis, so the
// blocks in flight share a weight strip and x stays in L2 at prefill.
//
// Rows TMA cannot describe: a weight plane whose row (N bytes) is not a
// multiple of 16 bytes gets its bytes by 8-byte cp.async copies of the
// refilling warp into the same swizzled layout, completing on the same
// mbarrier (cp.async.mbarrier.arrive.noinc). x, scales and zero points
// always go through TMA (their rows are 2K and 2N bytes). TMA fills rows
// and columns past the ends with zeros (x past M or K, the weight past N
// or the plane), so tails add nothing, and the epilogue masks them.
#include "hopper.cuh"

namespace {

using namespace ti::hw;

constexpr int kGroups = 2;                        // warpgroups a block
constexpr int kThreads = kGroups * 128;
constexpr int kWCols = 128;                       // weight columns a warpgroup
constexpr int kTileN = kGroups * kWCols;       // weight columns a block
constexpr int kSmemMax = 227 * 1024;

constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory of one block: kStages stages, then their mbarriers and
// counters.
template <int kBits, bool kAsym, int BT>
struct Layout {
  static constexpr int kRows = kBits == 4 ? 64 : 128;   // byte rows a stage
  static constexpr int kXBox = BT * 64;     // tokens x 32 bf16 columns
  static constexpr int kX = 4 * kXBox;      // 128 logical k
  static constexpr int kWBox = kRows * kWCols;
  static constexpr int kW = kGroups * kWBox;
  static constexpr int kS = 2 * kTileN * 2; // two bf16 rows of 256 columns
  static constexpr int kTx = kX + kW + kS * (kAsym ? 2 : 1);
  static constexpr int kStage = align1k(kTx);
  static constexpr int kStages = cmin(6, (kSmemMax - 1024 - 72) / kStage);
  static constexpr int kSmem = kStages * kStage + 1024 + 12 * kStages;
  static_assert(kStages >= 3, "the ring needs three stages");
};

// wgmma B descriptor of a K-major tile with the 64-byte swizzle: 8-row
// core groups 512 bytes apart (SBO 32 x 16 B), layout type 2.
constexpr uint64_t kDescB64 = (1ull << 16) | (32ull << 32) | (2ull << 62);

// 8 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BT>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc) {
  if constexpr (BT == 64)
    wgmma_n64(d, a, desc);
  else
    wgmma_n128(d, a, desc);
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// (m & mask) | bits, one LOP3.
__device__ __forceinline__ uint32_t lop_and_or(uint32_t m, uint32_t mask,
                                               uint32_t bits) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(m), "r"(mask),
      "r"(bits));
  return r;
}

constexpr uint32_t kBf128 = 0x43004300u;   // bf16x2 (128, 128)
constexpr uint32_t kBf136 = 0x43084308u;   // bf16x2 (136, 136)

// Scales (and zero points) of a thread's 4 columns in one group: bf16x2
// pairs (s, s) for the bf16 products, or f32 for the zero-point form.
template <bool kAsym>
struct Scales {
  uint32_t s2[4];
  float s[4], z[4];
};

template <bool kAsym>
__device__ __forceinline__ Scales<kAsym> load_scales(const uint8_t* sp,
                                                     const uint8_t* zp) {
  Scales<kAsym> r;
  const uint2 sv = *reinterpret_cast<const uint2*>(sp);
  if constexpr (kAsym) {
    const uint2 zv = *reinterpret_cast<const uint2*>(zp);
    const uint32_t sw[2] = {sv.x, sv.y}, zw[2] = {zv.x, zv.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t a = sw[i >> 1], b = zw[i >> 1];
      r.s[i] = __uint_as_float((i & 1) ? (a & 0xFFFF0000u) : (a << 16));
      r.z[i] = __uint_as_float((i & 1) ? (b & 0xFFFF0000u) : (b << 16));
    }
  } else {
    r.s2[0] = __byte_perm(sv.x, 0u, 0x1010);
    r.s2[1] = __byte_perm(sv.x, 0u, 0x3232);
    r.s2[2] = __byte_perm(sv.y, 0u, 0x1010);
    r.s2[3] = __byte_perm(sv.y, 0u, 0x3232);
  }
  return r;
}

// One bf16x2 fragment register from two raw values of column i: bf16x2
// (128 + u) pairs for int4, f32 codes for int8.
template <bool kAsym>
__device__ __forceinline__ uint32_t deq4(uint32_t raw, const Scales<kAsym>& sc,
                                         int i) {
  const uint32_t q = bf2_sub(raw, kBf136);          // u - 8, exact
  if constexpr (kAsym) {
    const float lo = __uint_as_float(q << 16);
    const float hi = __uint_as_float(q & 0xFFFF0000u);
    return f2_bf2((lo - sc.z[i]) * sc.s[i], (hi - sc.z[i]) * sc.s[i]);
  } else {
    return bf2_mul(q, sc.s2[i]);
  }
}

template <bool kAsym>
__device__ __forceinline__ uint32_t deq8(float lo, float hi,
                                         const Scales<kAsym>& sc, int i) {
  if constexpr (kAsym)
    return f2_bf2((lo - sc.z[i]) * sc.s[i], (hi - sc.z[i]) * sc.s[i]);
  else
    return bf2_mul(f2_bf2(lo, hi), sc.s2[i]);   // codes are exact in bf16
}

// Byte b of an int8 code word already XORed with 0x80808080 -> its value.
__device__ __forceinline__ float code8(uint32_t wx, int b) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | b)) -
         8388736.0f;
}

// The A fragments of one chunk: af[kk][t][r]. t is the m64 tile (columns
// c0 + 2t and c0 + 2t + 1), r = 2 * pr + h: h picks the column, pr the
// k pair (2 tig, 2 tig + 1) or (2 tig + 8, 2 tig + 9). int4: kk 0 is the
// chunk's low nibbles, kk 1 its high; int8: kk is the k16 half.
// wsm: this warpgroup's weight box in the stage; rbase: the chunk's
// first byte row; cchunk/cin: the thread's 16-byte chunk and offset.
template <int kBits, bool kAsym>
__device__ __forceinline__ void dequant_chunk(uint32_t (&af)[2][2][4],
                                              const uint8_t* wsm, int rbase,
                                              int tig, uint32_t cchunk,
                                              uint32_t cin,
                                              const Scales<kAsym>& sc) {
  auto word = [&](int r) {
    return *reinterpret_cast<const uint32_t*>(
        wsm + r * kWCols + (((cchunk ^ (uint32_t)(r & 7)) << 4) | cin));
  };
  if constexpr (kBits == 4) {
    uint32_t wd[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) wd[d] = word(rbase + 2 * tig + (d & 1) + 8 * (d >> 1));
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // bytes [A.b(2t), A.b(2t+1), B.b(2t), B.b(2t+1)] of rows A, B
        const uint32_t p = __byte_perm(wd[2 * pr], wd[2 * pr + 1],
                                       t ? 0x7632 : 0x5410);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lo = lop_and_or(p >> (8 * h), 0x000F000Fu, kBf128);
          const uint32_t hi = lop_and_or(p >> (8 * h + 4), 0x000F000Fu, kBf128);
          af[0][t][2 * pr + h] = deq4<kAsym>(lo, sc, 2 * t + h);
          af[1][t][2 * pr + h] = deq4<kAsym>(hi, sc, 2 * t + h);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t wd[4];
#pragma unroll
      for (int d = 0; d < 4; ++d)
        wd[d] = word(rbase + 16 * kk + 2 * tig + (d & 1) + 8 * (d >> 1)) ^
                0x80808080u;
#pragma unroll
      for (int pr = 0; pr < 2; ++pr)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[kk][i >> 1][2 * pr + (i & 1)] = deq8<kAsym>(
              code8(wd[2 * pr], i), code8(wd[2 * pr + 1], i), sc, i);
    }
  }
}

template <int kBits, bool kAsym, int BT>
__global__ void __launch_bounds__(kThreads, 1)
qmm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
              const __grid_constant__ CUtensorMap tmw,
              const __grid_constant__ CUtensorMap tms,
              const __grid_constant__ CUtensorMap tmz,
              const uint8_t* __restrict__ wcp, __nv_bfloat16* __restrict__ y,
              float* __restrict__ partial, int M, int K, int N, int g,
              int steps, int mtiles, int whole, int splits) {
  using L = Layout<kBits, kAsym, BT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kStages * L::kStage;
  auto full = [&](int s) { return bars + 8u * s; };
  // done[s]: warps that have finished with stage s, counted modulo the
  // block's 8 warps
  uint32_t* const done = reinterpret_cast<uint32_t*>(
      sbase + L::kStages * L::kStage + 8 * L::kStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KB = kBits == 4 ? K / 2 : K;
  const int gr = kBits == 4 ? g / 2 : g;        // byte rows a scale group
  // Block b < whole computes tile b over all of K; the rest split each
  // remaining tile's K steps `splits` ways (tail tile t, part z).
  // Tiles are numbered token tile fastest.
  const int blk = blockIdx.x;
  const bool split = blk >= whole;
  const int tile = split ? whole + (blk - whole) / splits : blk;
  const int z = split ? (blk - whole) % splits : 0, parts = split ? splits : 1;
  const int st0 = (int)((long long)z * steps / parts);
  const int nst = (int)((long long)(z + 1) * steps / parts) - st0;
  const int m0 = (tile % mtiles) * BT, n0 = (tile / mtiles) * kTileN;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), wcp ? 1 + 32 : 1);   // + a warp's cp.async
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Fills the stage of K step `it`, run by one whole warp: lane 0 issues
  // the TMA copies; with wcp, lane l copies columns 8 l .. 8 l + 7 of
  // every weight byte row with cp.async.
  auto fill = [&](int it) {
    const int stage = it % L::kStages;
    const uint32_t sb = base + stage * L::kStage;
    const int r0 = (st0 + it) * L::kRows;
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(full(stage), L::kTx - (wcp ? L::kW : 0));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int col;
        if constexpr (kBits == 4) {
          // unit b / 2: 32 byte rows of one group; b & 1: low / high
          const int ru = r0 + 32 * (b >> 1), j = ru / gr;
          col = j * g + (ru - j * gr) + (b & 1) * gr;
        } else {
          col = r0 + 32 * b;
        }
        tma_2d(sb + b * L::kXBox, &tmx, full(stage), col, m0);
      }
      if (!wcp)
        for (int c = 0; c < kGroups; ++c)
          tma_2d(sb + L::kX + c * L::kWBox, &tmw, full(stage),
                 n0 + c * kWCols, r0);
      tma_2d(sb + L::kX + L::kW, &tms, full(stage), n0, r0 / gr);
      if (kAsym)
        tma_2d(sb + L::kX + L::kW + L::kS, &tmz, full(stage), n0, r0 / gr);
    }
    if (wcp) {
      const int c = 8 * lane, wgc = c / kWCols, cc = c % kWCols;
      const bool col_ok = n0 + c < N;
      for (int i = 0; i < L::kRows; ++i) {
        const bool ok = col_ok && r0 + i < KB;
        const uint8_t* src = ok ? wcp + (size_t)(r0 + i) * N + n0 + c : wcp;
        const uint32_t dst = sb + L::kX + wgc * L::kWBox + i * kWCols +
                             ((((cc >> 4) ^ (i & 7)) << 4) | (cc & 15));
        cp_async8(dst, src, ok ? 8 : 0);
      }
      cp_async_arrive(full(stage));
    }
  };
  if (warp == 0)
    for (int it = 0; it < nst && it < L::kStages; ++it) fill(it);

  // Warpgroup wg: weight columns n0 + 128 wg .. + 127.
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, tig = lane & 3;
  const int c0 = 32 * wl + 4 * g8;     // the thread's 4 columns, c0 .. c0 + 3
  const uint32_t cchunk = (uint32_t)c0 >> 4, cin = (uint32_t)c0 & 15u;
  float acc[2][BT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[t][i] = 0.f;
  // A fragments, double-buffered: [buffer][kk][t][register]. A chunk
  // is dequantized while the previous chunk's wgmmas run (the next
  // stage's first chunk during this stage's last); a buffer is rewritten
  // only after wait_group has retired the wgmmas that read it, and every
  // stage ends with all wgmmas retired, so ptxas never sees the
  // registers of a wgmma in flight written and keeps them asynchronous.
  uint32_t af[2][2][2][4];
  struct Stage {
    uint32_t sx;            // shared address of the stage (x boxes first)
    const uint8_t* ws;      // this warpgroup's weight box
    const uint8_t* ss;      // its scales, at the thread's 4 columns
    int r0, rnext;          // first byte row; first byte row of group 2
  };
  auto at = [&](int it) {
    const int stage = it % L::kStages;
    Stage st;
    st.sx = base + stage * L::kStage;
    st.ws = sbase + stage * L::kStage + L::kX + wg * L::kWBox;
    st.ss = sbase + stage * L::kStage + L::kX + L::kW + (wg * kWCols + c0) * 2;
    st.r0 = (st0 + it) * L::kRows;
    st.rnext = (st.r0 / gr + 1) * gr;
    return st;
  };
  auto dequant = [&](const Stage& st, int q, uint32_t (&a)[2][2][4]) {
    const int rq = q * (kBits == 4 ? 16 : 32);
    const int gs = st.r0 + rq >= st.rnext ? 1 : 0;
    const Scales<kAsym> sc = load_scales<kAsym>(
        st.ss + gs * kTileN * 2, st.ss + L::kS + gs * kTileN * 2);
    dequant_chunk<kBits, kAsym>(a, st.ws, rq, tig, cchunk, cin, sc);
  };
  auto mma = [&](const Stage& st, int q, const uint32_t (&a)[2][2][4]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // int4: x box 2 (q / 2) + kk (unit q / 2, low / high), k16 q & 1;
      // int8: box q, k16 kk
      const int box = kBits == 4 ? 2 * (q >> 1) + kk : q;
      const int k16 = kBits == 4 ? (q & 1) : kk;
      const uint64_t desc =
          kDescB64 | (((st.sx + box * L::kXBox + k16 * 32) >> 4) & 0x3FFFu);
#pragma unroll
      for (int t = 0; t < 2; ++t) wgmma_rs<BT>(acc[t], a[kk][t], desc);
    }
    wgmma_commit();
  };

  if (nst > 0) {
    mbar_wait(full(0), 0);
    dequant(at(0), 0, af[0]);
  }
  for (int it = 0; it < nst; ++it) {
    const int stage = it % L::kStages;
    const Stage cur = at(it);
    mma(cur, 0, af[0]);
    dequant(cur, 1, af[1]);
    mma(cur, 1, af[1]);
    wgmma_wait<1>();
    dequant(cur, 2, af[0]);
    mma(cur, 2, af[0]);
    wgmma_wait<1>();
    dequant(cur, 3, af[1]);
    mma(cur, 3, af[1]);
    wgmma_wait<1>();
    if (it + 1 < nst) {
      mbar_wait(full((it + 1) % L::kStages), ((it + 1) / L::kStages) & 1);
      dequant(at(it + 1), 0, af[0]);
    }
    wgmma_wait<0>();
    // The last of the 8 warps to finish with the stage refills it, so no
    // warp ever waits for another.
    __syncwarp();
    uint32_t last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&done[stage], 1u) % (kGroups * 4) ==
             kGroups * 4 - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && it + L::kStages < nst)
      fill(it + L::kStages);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) asm volatile("" : "+f"(acc[t][i])::"memory");

  // acc[t][4j + 2h + e]: column c0 + 2t + h, token 8j + 2 tig + e.
  const int n = n0 + wg * kWCols + c0;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    float f[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      f[e][0] = acc[0][4 * j + e];
      f[e][1] = acc[0][4 * j + 2 + e];
      f[e][2] = acc[1][4 * j + e];
      f[e][3] = acc[1][4 * j + 2 + e];
    }
    const int mt = m0 + 8 * j + 2 * tig;
    if (split) {
      // the tile's part z: [BT][kTileN] f32 at (tail tile, z)
      float* pt = partial + ((size_t)(tile - whole) * splits + z) * BT *
                                kTileN;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (mt + e < M && n < N)
          *reinterpret_cast<float4*>(pt + (mt + e - m0) * kTileN + n - n0) =
              make_float4(f[e][0], f[e][1], f[e][2], f[e][3]);
    } else {
      // lanes g8 and g8 ^ 1 hold columns c0 .. c0 + 3 and the next 4:
      // the even one writes token e = 0, the odd one token e = 1
      const uint2 v0 = make_uint2(f2_bf2(f[0][0], f[0][1]),
                                  f2_bf2(f[0][2], f[0][3]));
      const uint2 v1 = make_uint2(f2_bf2(f[1][0], f[1][1]),
                                  f2_bf2(f[1][2], f[1][3]));
      const bool odd = g8 & 1;
      const uint2 send = odd ? v0 : v1;
      const uint2 recv = make_uint2(__shfl_xor_sync(0xffffffffu, send.x, 4),
                                    __shfl_xor_sync(0xffffffffu, send.y, 4));
      const int m = mt + (odd ? 1 : 0), nn = odd ? n - 4 : n;
      const uint4 out = odd ? make_uint4(recv.x, recv.y, v1.x, v1.y)
                            : make_uint4(v0.x, v0.y, recv.x, recv.y);
      if (m < M && nn < N)
        *reinterpret_cast<uint4*>(y + (size_t)m * N + nn) = out;
    }
  }
}

// y = bf16(sum of the parts) for the tail tiles, in part order; 4
// outputs a thread.
template <int BT>
__global__ void qmm_tc_reduce(const float* __restrict__ partial,
                              __nv_bfloat16* __restrict__ y, int M, int N,
                              int mtiles, int whole, int splits) {
  constexpr int kQuads = BT * kTileN / 4;
  const int tt = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kQuads) return;
  const int tile = whole + tt, r = 4 * i / kTileN, c = 4 * i % kTileN;
  const int m = (tile % mtiles) * BT + r, n = (tile / mtiles) * kTileN + c;
  if (m >= M || n >= N) return;
  const float* p = partial + (size_t)tt * splits * BT * kTileN + 4 * i;
  float4 v = *reinterpret_cast<const float4*>(p);
  for (int z = 1; z < splits; ++z) {
    const float4 q =
        *reinterpret_cast<const float4*>(p + (size_t)z * BT * kTileN);
    v.x += q.x;
    v.y += q.y;
    v.z += q.z;
    v.w += q.w;
  }
  *reinterpret_cast<uint2*>(y + (size_t)m * N + n) =
      make_uint2(f2_bf2(v.x, v.y), f2_bf2(v.z, v.w));
}

struct Plan {
  int bt, mtiles, tiles, steps, whole, splits;
  long long workspace() const {   // f32 elements of the parts
    return (long long)(tiles - whole) * splits * bt * kTileN;
  }
};

// Token tile and split-K of a call. The tiles that fill whole waves of
// the SMs run over all of K; when tiles remain (or there are fewer tiles
// than SMs) those are split into `splits` parts over K, so the last wave
// is as full as it can be. The split minimizes the waves times a tile's
// time (at the 55% of the bf16 rate a block sustains) plus the f32
// parts' round trip through device memory; every part keeps at least 2
// steps.
Plan plan(int M, int K, int N, int bits) {
  Plan p;
  p.bt = M <= 64 ? 64 : 128;
  p.mtiles = (M + p.bt - 1) / p.bt;
  p.tiles = p.mtiles * ((N + kTileN - 1) / kTileN);
  const int rows = bits == 4 ? 64 : 128, KB = bits == 4 ? K / 2 : K;
  p.steps = (KB + rows - 1) / rows;
  const long long sms = num_sms(), T = p.tiles;
  const double tile_s = 2.0 * p.bt * kTileN * K / (989e12 / 132 * 0.55);
  p.whole = p.tiles;
  p.splits = 1;
  double best = (double)((T + sms - 1) / sms) * tile_s;
  const long long whole = T / sms * sms;
  for (int s = 2; s <= 16 && 2 * s <= p.steps; ++s) {
    const long long rest = T - whole;
    const double t = (double)(whole / sms) * tile_s +
                     (double)((rest * s + sms - 1) / sms) * tile_s / s +
                     8.0 * rest * s * kTileN * M / p.mtiles / 3e12;
    if (rest > 0 && t < best) {
      best = t;
      p.whole = (int)whole;
      p.splits = s;
    }
  }
  return p;
}

struct Call {
  const __nv_bfloat16* x;
  const uint8_t* w;
  const __nv_bfloat16* s;
  const __nv_bfloat16* zp;
  __nv_bfloat16* y;
  float* partial;
  int M, K, N, g, bits;
  cudaStream_t stream;
};

template <int kBits, bool kAsym, int BT>
int launch(const Call& c, const Plan& p) {
  using L = Layout<kBits, kAsym, BT>;
  auto kernel = qmm_tc_kernel<kBits, kAsym, BT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int KB = kBits == 4 ? c.K / 2 : c.K;
  CUtensorMap tmx, tmw, tms, tmz;
  // a weight row TMA cannot describe (not a multiple of 16 bytes) goes
  // through the refilling warp's cp.async copies instead
  const bool w_tma = c.N % 16 == 0;
  bool ok = tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.x, c.K, c.M,
                       2LL * c.K, 32, BT, CU_TENSOR_MAP_SWIZZLE_64B) &&
            tensor_map(&tms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.s, c.N,
                       c.K / c.g, 2LL * c.N, kTileN, 2,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && w_tma)
    ok = tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.w, c.N, KB, c.N,
                    kWCols, L::kRows, CU_TENSOR_MAP_SWIZZLE_128B);
  else
    tmw = tms;   // unused
  if (ok && kAsym)
    ok = tensor_map(&tmz, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.zp, c.N,
                    c.K / c.g, 2LL * c.N, kTileN, 2,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    tmz = tms;   // unused
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = p.whole + (p.tiles - p.whole) * p.splits;
  kernel<<<blocks, kThreads, L::kSmem, c.stream>>>(
      tmx, tmw, tms, tmz, w_tma ? nullptr : c.w, c.y, c.partial, c.M, c.K,
      c.N, c.g, p.steps, p.mtiles, p.whole, p.splits);
  if (p.whole < p.tiles) {
    constexpr int kQuads = BT * kTileN / 4;
    const dim3 grid((kQuads + 255) / 256, p.tiles - p.whole);
    qmm_tc_reduce<BT><<<grid, 256, 0, c.stream>>>(
        c.partial, c.y, c.M, c.N, p.mtiles, p.whole, p.splits);
  }
  return ti::launch_status();
}

template <int kBits, bool kAsym>
int launch_bt(const Call& c, const Plan& p) {
  return p.bt == 64 ? launch<kBits, kAsym, 64>(c, p)
                    : launch<kBits, kAsym, 128>(c, p);
}

}  // namespace

namespace ti {

long long qmm_tc_workspace(int M, int K, int N, int bits) {
  return plan(M, K, N, bits).workspace();
}

int qmm_tc(const void* x, const void* w, const void* s, const void* zp,
           void* y, void* partial, int M, int K, int N, int g, int bits,
           cudaStream_t stream) {
  const Call c{static_cast<const __nv_bfloat16*>(x),
               static_cast<const uint8_t*>(w),
               static_cast<const __nv_bfloat16*>(s),
               static_cast<const __nv_bfloat16*>(zp),
               static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(partial),
               M, K, N, g, bits, stream};
  const Plan p = plan(M, K, N, bits);
  if (bits == 4)
    return zp ? launch_bt<4, true>(c, p) : launch_bt<4, false>(c, p);
  return zp ? launch_bt<8, true>(c, p) : launch_bt<8, false>(c, p);
}

}  // namespace ti

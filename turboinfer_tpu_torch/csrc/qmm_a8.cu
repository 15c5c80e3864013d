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
//  * ti_a8_quantize_rows: sx = max(absmax, 1e-8) *
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
// tensor-core rate (1979 TOP/s dense) from M of a few hundred up; below
// that the bytes, chiefly the int4 plane (K/2 * N) read once, over
// 3.35 TB/s. The quantizer is bytes alone: x read once, codes written.
//
// Design of the product (qmm_a8_kernel). The operands are swapped, y^T =
// W^T x^T: the weight's columns are the 16-row (mma.sync) or 64-row
// (wgmma) M side, each thread owning two adjacent columns, and the
// tokens the N side. A block owns 64 columns (128 at prefill: two
// warpgroups) and a token tile that fits M: 16, 32, 48 or 64 tokens up
// to kSmallM rows (a decode batch, a verify), 128 above. Its operands
// arrive through a ring of up to 8 stages (16 with split warpgroups) on
// mbarriers, filled by TMA: a stage is 4 "units" of 32 byte rows (128
// byte rows, one g=256 group), with an x box of the units' low-nibble k
// and one of their high-nibble k (tokens x 128 codes, 128-byte swizzle:
// unit u's k32 at byte 32 u of each row), a box of raw weight bytes per
// column warpgroup (128 rows x 64 columns, 64-byte swizzle) and the
// group's row of scales. Each warp arrives on a stage's empty barrier
// when done with it; the first warp of the warpgroup that reads a slot
// refills it one stage later, so it rarely waits (no producer warp).
//  * Unpacking: one ldmatrix.x4.trans of a warp's 16-byte column chunk
//    of a unit's 32 rows hands each thread byte pairs of its two columns
//    at rows 4 tig .. + 3 and 16 + 4 tig .. + 3 (the rows given to the
//    lanes are permuted so a phase's 8 rows hit 8 distinct bank groups
//    under the swizzle); two byte permutes make the A fragment registers
//    (four k of one column each), and one or two LOP3s each a low- and
//    a high-nibble s8 fragment: a unit is two k32 products on its bytes.
//  * Up to 64 tokens the products run on mma.sync m16n8k32, x's B
//    fragments by ldmatrix from the same swizzled boxes: on the H100 an
//    RS wgmma took ~80 cycles to issue at 16 tokens, and a stage's eight
//    of them held the block. When such tiles number fewer than the SMs (N = 4096
//    at a decode), 2 or 4 warpgroups split a tile's groups: warpgroup w
//    takes groups w, w + kSplit, ..., and hands each group's terms to
//    warpgroup 0 through shared memory (ready and free mbarriers), which
//    adds every group's terms into the f32 sum in group order.
//  * At 128 tokens, wgmma m64n128k32 (the RS form), A fragments
//    double-buffered: a stage's fragments are unpacked while the
//    previous stage's wgmmas run; a runtime branch never skips a wgmma.
// Group scales in registers: the s32 accumulator holds one group's
// partial, zeroed at the group's start (scale-d 0 for wgmma); at the
// group's end each partial enters the f32 sum as a multiply and an add,
// in group order. Where g <= 256 a nibble enters as 16 * (u - 8), its
// sign bit where int8 keeps it, so the accumulator holds 16p with |16p|
// < 2^22, and f32(p) = the bits of 1.5 * 2^19 plus the accumulator (an
// integer add) minus 1.5 * 2^19: fma(that, s, -1.5 * 2^19 * s) is f32(p)
// * s rounded once, since 1.5 * 2^19 * s is exact for a bf16 s. Larger
// groups take sign-extended u - 8 and an exact int-to-float conversion.
// No split over K across blocks: their f32 sums would meet out of group
// order, and this kernel is held to the plain form bit for bit. Tiles
// fill the SMs over (N, M); tokens are the fastest tile axis, so blocks
// in flight share a weight strip and x stays in L2 at prefill.
//
// Rows TMA cannot describe: a plane whose row (N bytes) is not a
// multiple of 16 bytes gets its bytes by 8-byte cp.async copies of the
// refilling warp into the same swizzled layout, completing on the same
// mbarrier. TMA fills rows and columns past the ends with zeros (x past
// M, the weight past N); the epilogue masks them. Groups that are not a
// multiple of 256 (g = 64, 128, ...) take one unit a stage on wgmma at 64
// tokens; an odd stage count there gets a padding stage with an all-zero
// A fragment.
//
// Design of the quantizer (a8_quantize_rows_kernel): x is read from
// device memory once: one block a row, one bulk copy (TMA) brings the
// row into shared memory, and the absmax and the codes are computed from
// there: x * (1/sx) rounded by adding 1.5 * 2^23, with the IEEE division
// only where that product lies near a half-integer. Codes leave as
// 16-byte vectors.
#include "hopper.cuh"

namespace {

using namespace ti::hw;

constexpr int kWCols = 64;        // weight columns a warpgroup (one m64 tile)
constexpr int kUnitRows = 32;     // byte rows a unit (a k32 over each nibble)
constexpr int kMaxStages = 8;     // 16 with split warpgroups (few blocks)
constexpr int kSmemMax = 227 * 1024;
// The regime boundary: up to kSmallM rows the token tile fits M (16, 32,
// 48 or 64), above it is 128 tokens.
constexpr int kSmallM = 64;

constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory of one block: kStages stages of [x box of the units' low
// nibbles][x box of their high nibbles][kWG weight boxes][a row of
// scales], then the stages' full and empty mbarriers, then the split
// warpgroups' term slots and their mbarriers.
template <int BT, int kWG, int kU, int kSplit>
struct Layout {
  static constexpr int kRows = kU * kUnitRows;     // byte rows a stage
  static constexpr int kXBox = BT * kRows;         // tokens x 32 kU codes
  static constexpr int kX = 2 * kXBox;
  static constexpr int kWBox = kRows * kWCols;
  static constexpr int kW = kWG * kWBox;
  static constexpr int kS = kWG * kWCols * 2;      // the group's bf16 scales
  static constexpr int kTx = kX + kW + kS;
  static constexpr int kStage = align1k(kTx);
  // the split warpgroups' group terms on their way to warpgroup 0: two
  // slots each of BT/2 floats a thread, and a ready and a free mbarrier
  // a slot
  static constexpr int kTerms = (kSplit - 1) * 2 * 128 * (BT / 2) * 4;
  static constexpr int kExtra = kTerms + (kSplit - 1) * 2 * 16;
  static constexpr int kMax = kSplit > 1 ? 2 * kMaxStages : kMaxStages;
  static constexpr int kStages =
      cmin(kMax, (kSmemMax - 1024 - 16 * kMax - kExtra) / kStage) / kSplit *
      kSplit;
  static constexpr int kSmem = kStages * kStage + 1024 + 16 * kStages + kExtra;
  static_assert(kStages >= 4 && kStages % kSplit == 0,
                "the ring needs four stages, a whole number a warpgroup");
  // x boxes: rows of 32 kU bytes, swizzled over their width (128 or 32
  // bytes); wgmma reads unit u's k32 at byte 32 u of each row, 8-row core
  // groups 8 * 32 kU bytes apart (descriptor layout 1: 128-byte swizzle,
  // 3: 32-byte)
  static_assert(kU == 4 || kU == 1, "4 units a stage, or 1");
  static constexpr CUtensorMapSwizzle kXSwizzle =
      kU == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint64_t kDesc = (1ull << 16) |
                                    ((uint64_t)(8 * kRows / 16) << 32) |
                                    ((uint64_t)(kU == 4 ? 1 : 3) << 62);
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Four 8 x 8 b16 matrices from shared memory: lane l gives the address
// of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldmatrix_4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D = A (16 x 32 s8, row) * B (32 x 8 s8, col) + D, s32.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory, transposed: lane l gives
// the address of row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldmatrix_t4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

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

__device__ __forceinline__ float inv127() {
  return __int_as_float(0x3C010204);   // f32(1/127)
}

// 1.5 * 2^23: x + it rounds x to an integer, half to even (|x| < 2^22)
constexpr float kRound = 12582912.0f;

// Four int4 bytes -> their low or high nibbles as the s8 values the
// product takes, byte for byte:
//  * kX16: 16 * (u - 8). u ^ 8 is u - 8 in 4-bit two's complement; in a
//    byte's high nibble it is 16 * (u - 8) as int8.
//  * otherwise u - 8 sign-extended: bit 3 of u ^ 8 set adds the sign bits
//    0xF0 (8 * 0x1E; no carry crosses a byte).
template <bool kX16>
__device__ __forceinline__ uint32_t nib_lo(uint32_t b) {
  if constexpr (kX16) {
    return ((b << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
  } else {
    const uint32_t y = (b & 0x0F0F0F0Fu) ^ 0x08080808u;
    return y | ((y & 0x08080808u) * 0x1Eu);
  }
}

template <bool kX16>
__device__ __forceinline__ uint32_t nib_hi(uint32_t b) {
  if constexpr (kX16) {
    return (b & 0xF0F0F0F0u) ^ 0x80808080u;
  } else {
    const uint32_t y = ((b >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    return y | ((y & 0x08080808u) * 0x1Eu);
  }
}

// 1.5 * 2^19: in [2^19, 2^20) an f32's last bit is 1/16, so the bits of
// this value plus an integer a (|a| < 2^22) are the f32 1.5 * 2^19 + a/16.
constexpr int kMagic16 = 0x49400000;
constexpr float kMagic16f = 786432.0f;

// BT tokens x 64 kWG weight columns a block; kU units (32 byte rows each)
// a stage, a whole number of stages a scale group (plan guarantees it).
// Token tiles of 64 or fewer (kU = 4) run the products on mma.sync
// m16n8k32, the rest on wgmma. kSplit > 1 (mma.sync, kWG = 1, one group
// a stage): kSplit warpgroups share the block's 64 columns, warpgroup w
// taking groups w, w + kSplit, ...; warpgroup 0 adds every group's term
// into the f32 sum in group order, the others' through shared memory.
template <int BT, int kWG, int kU, int kSplit, bool kX16>
__global__ void __launch_bounds__(kWG * kSplit * 128, 1)
qmm_a8_kernel(const __grid_constant__ CUtensorMap tmx,
              const __grid_constant__ CUtensorMap tmw,
              const __grid_constant__ CUtensorMap tms,
              const uint8_t* __restrict__ wcp, const float* __restrict__ sx,
              __nv_bfloat16* __restrict__ y, int M, int K, int N, int g,
              int mtiles) {
  using L = Layout<BT, kWG, kU, kSplit>;
  constexpr bool kSync = BT <= 64 && kU == 4;
  static_assert(kSplit == 1 || (kSync && kWG == 1), "split: mma.sync only");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kStages * L::kStage;
  // full[slot]: the stage's bytes have landed; empty[slot]: every warp
  // is done with it
  auto full = [&](int st) { return bars + 8u * (st % L::kStages); };
  auto empty = [&](int st) {
    return bars + 8u * (L::kStages + st % L::kStages);
  };
  // warpgroup w's (w >= 1) term slot b and its ready and free barriers
  const uint32_t xbars = bars + 16u * L::kStages;
  auto ready = [&](int w, int b) { return xbars + 16u * (2 * (w - 1) + b); };
  auto freed = [&](int w, int b) { return ready(w, b) + 8u; };
  float* const terms = reinterpret_cast<float*>(
      sbase + L::kStages * L::kStage + 16 * L::kStages +
      (kSplit - 1) * 2 * 16);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KB = K / 2, gr = g / 2;               // byte rows; a group's
  const int groups = K / g;
  const int stages = KB / L::kRows;               // exact: kU | g / 64
  const int spg = gr / L::kRows;                  // stages a group
  const int m0 = (blockIdx.x % mtiles) * BT;
  const int n0 = (blockIdx.x / mtiles) * (kWG * kWCols);

  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(full(i), wcp ? 1 + 32 : 1);       // + a warp's cp.async
      mbar_init(empty(i), kWG * 4);               // the warps that read it
    }
    for (int w = 1; w < kSplit; ++w)
      for (int b = 0; b < 2; ++b) {
        mbar_init(ready(w, b), 128);
        mbar_init(freed(w, b), 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Fills stage st, run by warp 0: lane 0 issues the TMA copies (the x
  // boxes of the units' low and high nibbles, the weight boxes, the
  // group's scales); with wcp, the lanes copy the weight bytes with
  // cp.async. A padding stage past the end reloads the last.
  auto fill = [&](int st) {
    const uint32_t sb = base + (st % L::kStages) * L::kStage;
    const int r0 = min(st, stages - 1) * L::kRows;
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect_tx(full(st), L::kTx - (wcp ? L::kW : 0));
      const int j = r0 / gr, col = j * g + (r0 - j * gr);
      tma_2d(sb, &tmx, full(st), col, m0);
      tma_2d(sb + L::kXBox, &tmx, full(st), col + gr, m0);
      if (!wcp)
#pragma unroll
        for (int c = 0; c < kWG; ++c)
          tma_2d(sb + L::kX + c * L::kWBox, &tmw, full(st),
                 n0 + c * kWCols, r0);
      tma_2d(sb + L::kX + L::kW, &tms, full(st), n0, j);
    }
    if (wcp) {
      // lane l: 8-byte piece l & 7 of rows 4 i + (l >> 3)
      const int piece = lane & 7, col = 8 * piece;
#pragma unroll 4
      for (int i = 0; i < kWG * L::kRows / 4; ++i) {
        const int c = i / (L::kRows / 4);
        const int row = 4 * (i % (L::kRows / 4)) + (lane >> 3);
        const int n = n0 + c * kWCols + col;
        const bool ok = n < N;
        const uint8_t* src = ok ? wcp + (size_t)(r0 + row) * N + n : wcp;
        const uint32_t dst =
            sb + L::kX + c * L::kWBox + row * kWCols +
            ((((uint32_t)(piece >> 1) ^ ((row >> 1) & 3u)) << 4) |
             (uint32_t)(piece & 1) * 8u);
        cp_async8(dst, src, ok ? 8 : 0);
      }
      cp_async_arrive(full(st));
    }
  };
  // the wgmma loop runs stages in pairs (its A buffers are named, not
  // indexed): an odd count gets a padding stage
  const int padded = kSync ? stages : (stages + 1) & ~1;
  if (warp == 0)
    for (int st = 0; st < padded && st < L::kStages; ++st) fill(st);

  // Warpgroup wg: weight columns n0 + 64 wg .. + 63; the thread's two,
  // ca and ca + 1, are its fragment rows g8 and g8 + 8 of warp wl, and
  // it needs their bytes at rows 4 tig .. + 3 and 16 + 4 tig .. + 3 of
  // each unit. One ldmatrix.x4.trans of the warp's 16-byte chunk of 32
  // rows gives them as byte pairs: matrix m's row 2p + e (lane 8 m + 2p
  // + e) is row 16 (m >> 1) + 4p + e + 2 (p >> 1) (m even) or 4p + 2 + e
  // - 2 (p >> 1) (m odd) of the unit, so lane (g8, tig) receives rows 4
  // tig .. + 3 in registers 2 rs and 2 rs + 1 (halves swapped for tig >=
  // 2), and a phase's 8 rows fall in 8 distinct 16-byte bank groups
  // under the 64-byte swizzle.
  // wk: the split warpgroup (kSplit > 1), else wg: the column warpgroup
  const int wk = kSplit > 1 ? warp >> 2 : 0;
  const int wg = kSplit > 1 ? 0 : warp >> 2;
  const int wl = warp & 3, g8 = lane >> 2, tig = lane & 3;
  const int ca = 16 * wl + 2 * g8;
  const int n = n0 + wg * kWCols + ca;
  uint32_t lm_off;             // this lane's ldmatrix row, from a unit's base
  {
    const int mi = lane >> 3, p = (lane >> 1) & 3, e = lane & 1;
    const int r = 16 * (mi >> 1) +
                  ((mi & 1) ? 4 * p + 2 + e - 2 * (p >> 1)
                            : 4 * p + e + 2 * (p >> 1));
    lm_off = r * kWCols + (((uint32_t)wl ^ ((r >> 1) & 3u)) << 4);
  }
  const uint32_t sel_a = (tig & 2) ? 0x2064u : 0x6420u;
  const uint32_t sel_b = (tig & 2) ? 0x3175u : 0x7531u;

  int acc[BT / 2];
  float accf[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    acc[i] = 0;
    accf[i] = 0.f;
  }
  // A fragments of a stage, double-buffered: [buffer][unit][low/high]
  // [register]. Register 0: column ca, k 4 tig .. + 3; 1: column ca + 1,
  // the same k; 2 and 3: k 16 + 4 tig .. + 3.
  uint32_t af[2][kU][2][4];

  auto dequant = [&](int st, uint32_t (&a)[kU][2][4]) {
    const uint32_t wsm = base + (st % L::kStages) * L::kStage + L::kX +
                         wg * L::kWBox + lm_off;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      uint32_t r[4];
      ldmatrix_t4(wsm + u * kUnitRows * kWCols, r);
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        const uint32_t ra = __byte_perm(r[2 * rs], r[2 * rs + 1], sel_a);
        const uint32_t rb = __byte_perm(r[2 * rs], r[2 * rs + 1], sel_b);
        a[u][0][2 * rs] = nib_lo<kX16>(ra);
        a[u][0][2 * rs + 1] = nib_lo<kX16>(rb);
        a[u][1][2 * rs] = nib_hi<kX16>(ra);
        a[u][1][2 * rs + 1] = nib_hi<kX16>(rb);
      }
    }
    if (st >= stages) {      // the padding stage adds nothing
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[u][h][q] = 0u;
    }
  };
  auto mma = [&](int st, const uint32_t (&a)[kU][2][4], int scale_d) {
    if constexpr (!kSync) {
      const uint32_t xb = base + (st % L::kStages) * L::kStage;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const uint32_t lo = xb + 32 * u, hi = lo + L::kXBox;
        wgmma_s8<BT>(acc, a[u][0], L::kDesc | ((lo >> 4) & 0x3FFFu),
                     u == 0 ? scale_d : 1);
        wgmma_s8<BT>(acc, a[u][1], L::kDesc | ((hi >> 4) & 0x3FFFu), 1);
      }
      wgmma_commit();
    }
  };

  int q = 0, j = 0;                  // stage within its group; the group

  // The group's terms f32(p) * s, rounded once, from stage st's scales.
  auto group_terms = [&](int st, float (&t)[BT / 2]) {
    // the scales of the thread's two columns, from the stage's scale row
    const uint32_t sv = *reinterpret_cast<const uint32_t*>(
        sbase + (st % L::kStages) * L::kStage + L::kX + L::kW +
        (wg * kWCols + ca) * 2);
    const float s0 = __uint_as_float(sv << 16);
    const float s1 = __uint_as_float(sv & 0xFFFF0000u);
    const float c0 = -__fmul_rn(kMagic16f, s0), c1 = -__fmul_rn(kMagic16f, s1);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const bool hi = (i >> 1) & 1;     // fragment row g8 + 8: column ca + 1
      if constexpr (kX16)
        t[i] = __fmaf_rn(__int_as_float(acc[i] + kMagic16), hi ? s1 : s0,
                         hi ? c1 : c0);
      else
        t[i] = __fmul_rn(__int2float_rn(acc[i]), hi ? s1 : s0);
    }
  };
  // Adds the group's terms into accf: groups in order.
  auto epilogue = [&](int st) {
    float t[BT / 2];
    group_terms(st, t);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) accf[i] = __fadd_rn(accf[i], t[i]);
  };

  // One stage: its wgmmas (a group's first overwrites the s32 partial);
  // this warp counts stage st - 1 done (its wgmmas retired), and warp 0
  // refills the slot of stage st - 2, which every warp has left by now;
  // then, while the wgmmas run, the next stage's A fragments; at a
  // group's end its partials are scaled into accf.
  auto step = [&](int st, const uint32_t (&cur)[kU][2][4],
                  uint32_t (&next)[kU][2][4]) {
    mma(st, cur, q == 0 ? 0 : 1);
    wgmma_wait<1>();              // stage st - 1's wgmmas retired
    if (st >= 1 && lane == 0) mbar_arrive(empty(st - 1));
    if (warp == 0 && st >= 2 && st - 2 + L::kStages < padded) {
      mbar_wait(empty(st - 2), ((st - 2) / L::kStages) & 1);
      fill(st - 2 + L::kStages);
    }
    if (st + 1 < padded) {
      mbar_wait(full(st + 1), ((st + 1) / L::kStages) & 1);
      dequant(st + 1, next);
    }
    if (++q == spg) {
      wgmma_wait<0>();
      if (j++ < groups) epilogue(st);
      q = 0;
    }
  };

  if constexpr (kSync) {
    // Stage by stage (this warpgroup's stages: wk, wk + kSplit, ...): the
    // A fragments of its units, x's B fragments by ldmatrix from the same
    // swizzled boxes wgmma reads (a thread's four codes of a token, k 4
    // tig .. + 3 and 16 + 4 tig .. + 3), the products on mma.sync; the
    // warp counts the stage done once its group's terms are out, and the
    // warpgroup's first warp refills the slot of its stage before, which
    // its warps have left by then.
    const int tk = tid & 127;
    for (int st = wk; st < stages; st += kSplit) {
      mbar_wait(full(st), (st / L::kStages) & 1);
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) acc[i] = 0;
      }
      dequant(st, af[0]);
      const uint32_t xb = base + (st % L::kStages) * L::kStage;
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int jj = 0; jj < BT / 8; ++jj) {
          // matrices: low k 0-15, low k 16-31, high k 0-15, high k 16-31
          const int mi = lane >> 3, tok = 8 * jj + (lane & 7);
          uint32_t b[4];
          ldmatrix_4(xb + (mi >> 1) * L::kXBox + tok * L::kRows +
                         ((uint32_t)((2 * u + (mi & 1)) ^ (tok & 7)) << 4),
                     b);
          mma_s8(acc + 4 * jj, af[0][u][0], b[0], b[1]);
          mma_s8(acc + 4 * jj, af[0][u][1], b[2], b[3]);
        }
      if constexpr (kSplit == 1) {
        if (++q == spg) {
          if (j++ < groups) epilogue(st);
          q = 0;
        }
      } else {
        // one group a stage: stage st is group st
        float t[BT / 2];
        group_terms(st, t);
        // round r of this warpgroup's terms: slot b, its use u of it
        const int r = st / kSplit, b = r & 1, u = r >> 1;
        if (wk == 0) {
#pragma unroll
          for (int i = 0; i < BT / 2; ++i) accf[i] = __fadd_rn(accf[i], t[i]);
          for (int w = 1; w < kSplit && st + w < stages; ++w) {
            mbar_wait(ready(w, b), u & 1);
            const float* tw =
                terms + ((w - 1) * 2 + b) * (BT / 2) * 128 + tk;
#pragma unroll
            for (int i = 0; i < BT / 2; ++i)
              accf[i] = __fadd_rn(accf[i], tw[i * 128]);
            mbar_arrive(freed(w, b));
          }
        } else {
          if (u >= 1) mbar_wait(freed(wk, b), (u - 1) & 1);
          float* tw = terms + ((wk - 1) * 2 + b) * (BT / 2) * 128 + tk;
#pragma unroll
          for (int i = 0; i < BT / 2; ++i) tw[i * 128] = t[i];
          mbar_arrive(ready(wk, b));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      if (wl == 0 && st >= kSplit && st - kSplit + L::kStages < stages) {
        mbar_wait(empty(st - kSplit), ((st - kSplit) / L::kStages) & 1);
        fill(st - kSplit + L::kStages);
      }
    }
    if (wk != 0) return;
  } else {
    mbar_wait(full(0), 0);
    dequant(0, af[0]);
    for (int st = 0; st < padded; st += 2) {
      step(st, af[0], af[1]);
      step(st + 1, af[1], af[0]);
    }
    wgmma_wait<0>();
  }

  // y = bf16(f32(bf16(accf)) * sx[m]): accf[4 jj + 2 h + e] is column
  // ca + h, token 8 jj + 2 tig + e.
  if (n >= N) return;
#pragma unroll
  for (int jj = 0; jj < BT / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * jj + 2 * tig + e;
      if (m >= M) continue;
      const float rs = __ldg(sx + m);
      const float o0 = __bfloat162float(__float2bfloat16_rn(accf[4 * jj + e]));
      const float o1 =
          __bfloat162float(__float2bfloat16_rn(accf[4 * jj + 2 + e]));
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
          __floats2bfloat162_rn(__fmul_rn(o0, rs), __fmul_rn(o1, rs));
    }
}

struct Plan {
  int bt, wg, ku, split, mtiles, tiles;
};

// Token tile, warpgroups and units a stage of a call. The token tile
// fits M up to kSmallM; above it, 128 tokens, and two warpgroups (128
// columns) a block when that still gives a full wave of tiles; with
// fewer tiles than SMs at a small tile and g = 256, 2 or 4 warpgroups
// split a tile's groups. A stage holds 4 units (128 byte rows) when a
// group has a multiple of that, as every g that is a multiple of 256
// does; other groups (g = 64, 128, 192, ...) take one unit a stage at 64
// tokens, and g > 256 (the u - 8 form) takes 64 tokens at M <= kSmallM
// too: rare forms, kept to few kernel instances.
Plan plan(int M, int N, int g) {
  Plan p;
  p.bt = M > kSmallM ? 128 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 48 ? 48 : 64;
  p.ku = 4;
  if ((g / 64) % p.ku) {
    p.ku = 1;
    p.bt = 64;
  } else if (g > 256 && p.bt < 128) {
    p.bt = 64;
  }
  p.mtiles = (M + p.bt - 1) / p.bt;
  p.wg = p.bt == 128 &&
                 (long long)p.mtiles * ((N + 2 * kWCols - 1) / (2 * kWCols)) >=
                     num_sms()
             ? 2
             : 1;
  p.tiles = p.mtiles * ((N + p.wg * kWCols - 1) / (p.wg * kWCols));
  // fewer tiles than SMs at a small token tile and g = 256 (one group a
  // stage): split warpgroups share each tile's groups
  p.split = p.bt <= 64 && p.ku == 4 && g == 256 && p.tiles < num_sms()
                ? (p.bt <= 32 ? 4 : 2)
                : 1;
  return p;
}

struct Call {
  const int8_t* xq;
  const float* sx;
  const uint8_t* w;
  const __nv_bfloat16* s;
  __nv_bfloat16* y;
  int M, K, N, g;
  cudaStream_t stream;
};

template <int BT, int kWG, int kU, bool kX16, int kSplit = 1>
int launch(const Call& c, const Plan& p) {
  using L = Layout<BT, kWG, kU, kSplit>;
  auto kernel = qmm_a8_kernel<BT, kWG, kU, kSplit, kX16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmx, tmw;
  // a weight row TMA cannot describe (not a multiple of 16 bytes) goes
  // through the refilling warp's cp.async copies instead
  const bool w_tma = c.N % 16 == 0;
  bool ok = tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.xq, c.K, c.M,
                       c.K, L::kRows, BT, L::kXSwizzle);
  CUtensorMap tms;
  ok = ok && tensor_map(&tms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.s, c.N,
                        c.K / c.g, 2LL * c.N, kWG * kWCols, 1,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && w_tma)
    ok = tensor_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.w, c.N, c.K / 2,
                    c.N, kWCols, L::kRows, CU_TENSOR_MAP_SWIZZLE_64B);
  else
    tmw = tmx;   // unused
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<p.tiles, kWG * kSplit * 128, L::kSmem, c.stream>>>(
      tmx, tmw, tms, w_tma ? nullptr : c.w, c.sx, c.y, c.M, c.K, c.N, c.g,
      p.mtiles);
  return ti::launch_status();
}

// 16 * |partial| < 2^22 up to g = 256 (127 * 8 * 16 * 256 = 4161536):
// the 16 (u - 8) form there, u - 8 above.
int launch_plan(const Call& c, const Plan& p) {
  const bool x16 = c.g <= 256;
  if (p.ku == 1)
    return x16 ? launch<64, 1, 1, true>(c, p) : launch<64, 1, 1, false>(c, p);
  if (p.bt == 128) {
    if (p.wg == 2)
      return x16 ? launch<128, 2, 4, true>(c, p)
                 : launch<128, 2, 4, false>(c, p);
    return x16 ? launch<128, 1, 4, true>(c, p) : launch<128, 1, 4, false>(c, p);
  }
  if (!x16) return launch<64, 1, 4, false>(c, p);
  if (p.split > 1) {
    switch (p.bt) {
      case 16: return launch<16, 1, 4, true, 4>(c, p);
      case 32: return launch<32, 1, 4, true, 4>(c, p);
      case 48: return launch<48, 1, 4, true, 2>(c, p);
      default: return launch<64, 1, 4, true, 2>(c, p);
    }
  }
  switch (p.bt) {
    case 16: return launch<16, 1, 4, true>(c, p);
    case 32: return launch<32, 1, 4, true>(c, p);
    case 48: return launch<48, 1, 4, true>(c, p);
    default: return launch<64, 1, 4, true>(c, p);
  }
}

// ---- the row quantizer ----------------------------------------------------

// Longest row the quantizer takes: a row of bf16 lives in shared memory.
constexpr int kQMaxK = 112 * 1024;

// One block a row of K bf16 (K % 8 == 0): one bulk copy brings the row
// into shared memory on an mbarrier, the absmax and then the codes are
// computed from there, kC values (16, or 8 where K % 16 == 8) a thread at
// a time, the codes stored as kC-byte vectors.
template <int kT, int kC>
__global__ void __launch_bounds__(kT)
a8_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                        int8_t* __restrict__ xq, float* __restrict__ sx,
                        int K) {
  extern __shared__ __align__(128) uint8_t qsmem[];
  __shared__ __align__(8) uint64_t qbar;
  __shared__ float red[kT / 32];
  const int tid = threadIdx.x, m = blockIdx.x;
  const uint32_t bar = smem_u32(&qbar);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2u * K);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(qsmem)),
        "l"(x + (size_t)m * K), "r"(2u * K), "r"(bar)
        : "memory");
  }
  mbar_wait(bar, 0);
  const uint4* row = reinterpret_cast<const uint4*>(qsmem);
  float mx = 0.f;
  for (int v = tid; v < K / 8; v += kT) {
    float f[8];
    ti::bf16x8_to_float(row[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(f[i]));
  }
  mx = ti::warp_max(mx);
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) mx = fmaxf(mx, red[w]);
  const float s = __fmul_rn(fmaxf(mx, 1e-8f), inv127());
  if (tid == 0) sx[m] = s;
  // code(v): the bits of 1.5 * 2^23 + rint(v / s), the int8 code in the
  // low byte (|v / s| <= 127 + 2^-16, so no clip is ever needed), with v
  // / s rounded as an IEEE division. Adding 1.5 * 2^23 rounds to an
  // integer, half to even. v * (1/s) lies within 2^-15 of v / s, so
  // where it is further than 2^-13 from a half-integer both round alike;
  // the few others divide.
  const float r = __frcp_rn(s);
  auto code = [&](float v) {
    const float q = __fmul_rn(v, r);
    const float t = __fadd_rn(q, kRound);
    const float d = __fsub_rn(q, __fsub_rn(t, kRound));
    return __float_as_uint(fabsf(d) < 0.5f - 1.220703125e-4f
                               ? t
                               : __fadd_rn(__fdiv_rn(v, s), kRound));
  };
  int8_t* qr = xq + (size_t)m * K;
  for (int c = tid; c < K / kC; c += kT) {
    uint32_t word[kC / 4];
#pragma unroll
    for (int h = 0; h < kC / 8; ++h) {
      float f[8];
      ti::bf16x8_to_float(row[c * (kC / 8) + h], f);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t lo = __byte_perm(code(f[4 * w]), code(f[4 * w + 1]),
                                        0x0040);
        const uint32_t hi = __byte_perm(code(f[4 * w + 2]),
                                        code(f[4 * w + 3]), 0x0040);
        word[2 * h + w] = __byte_perm(lo, hi, 0x5410);
      }
    }
    if constexpr (kC == 16)
      *reinterpret_cast<uint4*>(qr + c * kC) =
          make_uint4(word[0], word[1], word[2], word[3]);
    else
      *reinterpret_cast<uint2*>(qr + c * kC) = make_uint2(word[0], word[1]);
  }
}

template <int kT, int kC>
int launch_quantize(const void* x, void* xq, void* sx, int M, int K,
                    cudaStream_t stream) {
  auto kernel = a8_quantize_rows_kernel<kT, kC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * kQMaxK);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<M, kT, 2 * K, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                   static_cast<int8_t*>(xq),
                                   static_cast<float*>(sx), K);
  return ti::launch_status();
}

}  // namespace

extern "C" {

// x: bf16 [M, K] contiguous, 16-byte aligned, K % 8 == 0 and K <=
// kQMaxK (a row lives in shared memory); xq: int8 [M, K]; sx: f32 [M].
// Rows of 8192 values or more take 512 threads a row (measured faster on
// the H100 at K=11008, slower at K=4096), shorter ones 256.
int ti_a8_quantize_rows(const void* x, void* xq, void* sx, int M, int K,
                        void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || K > kQMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (K % 16) return launch_quantize<256, 8>(x, xq, sx, M, K, st);
  return K >= 8192 ? launch_quantize<512, 16>(x, xq, sx, M, K, st)
                   : launch_quantize<256, 16>(x, xq, sx, M, K, st);
}

// xq: int8 [M, K] and sx: f32 [M] from ti_a8_quantize_rows; w: one
// layer's plane, uint8 [K/2, N] contiguous; s: bf16 [K/g, N]
// contiguous; y: bf16 [M, N]. Needs g a multiple of 64 dividing K,
// N % 8 == 0, and xq, w, s 16-byte aligned.
int ti_qmm_a8(const void* xq, const void* sx, const void* w, const void* s,
              void* y, int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || g % 64 || K % g || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
               static_cast<const uint8_t*>(w),
               static_cast<const __nv_bfloat16*>(s),
               static_cast<__nv_bfloat16*>(y), M, K, N, g,
               static_cast<cudaStream_t>(stream)};
  return launch_plan(c, plan(M, N, g));
}

}  // extern "C"

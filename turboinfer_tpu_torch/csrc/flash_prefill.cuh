// flash_prefill: causal GQA attention for prefill with online softmax,
// on Hopper's wgmma fed by TMA. The kernel template lives here; one
// source per K/V storage type instantiates it (flash_prefill.cu: bf16
// and the C interface, flash_prefill_int8.cu, flash_prefill_fp8.cu), so
// the three compile side by side.
//
// Replaces the TPU kernel turboinfer_tpu/kernels/pallas/flash_attention.py
// prefill_pallas (_prefill, body _kernel) and _prefill_stacked with its
// compressed reads (`scaled`, _load_kv). The K/V operand is any [B, Hkv,
// T, D] view given by base pointer and strides, so the same kernel reads
// the just-computed [B, S, Hkv, D] block of a fresh prefill (transposed
// by strides, no copy) or layer li of the stacked [L, B, Hkv, T, D]
// cache (a pointer offset). Query s of sequence b sits at position
// q_start[b] + s; keys at t >= kv_len[b] or t > position are masked with
// -1e30 and the final denominator is clamped to 1e-30, as in the JAX
// kernel, so padded query rows come out finite. With a window (Mistral,
// Gemma-2's local layers) keys t <= position - window are masked too, and
// with a softcap (Gemma-2) the scaled scores become cap * tanh(s / cap)
// before the mask, in the JAX kernel's order: the int8 key scale, the
// softcap, the mask.
//
// int8 and fp8 caches: both decodes are exact in bf16: fp8 bits become
// their e4m3 values (0x7F/0xFF as +-480, as e4m3_to_bf16 reads them),
// int8 codes stay codes, and, as in the Pallas body, the int8 scales
// ride the score and probability columns: score columns times the key
// rows' scales, probability columns times the value rows' scales before
// P V, the denominator summing the unscaled probabilities.
//
// What bounds it on the H100: 4*D*Hq*(visible query-key pairs)
// operations over the bf16 tensor-core rate (989 TFLOP/s dense); the
// bytes (Q and O once, K/V once per kv head) are far below at every
// prefill shape.
//
// Design.
//  * GQA heads packed into the tile's rows. A block owns one (b, kv head)
//    and 2 x 64 query rows, one 64-row wgmma tile per consumer
//    warpgroup; a row is a (position, query head) pair, the G heads of
//    the group (G = Hq/Hkv, or its largest divisor <= 64) side by side at
//    P = 64 / G positions. So each K/V tile is loaded once for all the
//    heads that read it. q's [B, S, Hq, D] layout keeps a group's heads
//    adjacent at each position: one TMA box of (D, G heads, P positions)
//    is the warpgroup's Q tile, rows 64 - G*P.. zeroed once. The masks
//    use the row's position.
//  * TMA and mbarriers. Q is copied once; K and V (128-key tiles, 64 at
//    D = 256) go through a ring of up to 3 stages (2 at D = 256, 1 for
//    its 8-bit codes). A box row is 128 bytes with the 128-byte swizzle
//    (D = 64, 128, 256: a row takes D / 64 boxes) or 64 bytes with the
//    64-byte swizzle (D = 32, and D = 96 as three 32-column boxes: 96
//    columns are not a whole number of 128-byte boxes, and one box
//    width keeps a single swizzle in every descriptor and in the
//    decoded 8-bit tiles). TMA fills rows past T (and query
//    positions past S) with zeros; the kv_len mask covers the rest.
//    The fresh view's T stride (Hkv*D) exceeds its head stride, so its map
//    lists the head dimension first (kv_swap).
//  * wgmma, accumulators in registers. S = Q K^T is the SS form (Q and K
//    K-major in shared memory, m64 n128 k16; n64 at D = 256). The online
//    softmax runs on S's registers (a row lives in one quad: two shuffles
//    for its max; the row sum stays per thread until the epilogue), in
//    base 2 (the softmax scale folded with log2 e). P is packed to bf16
//    in registers and is P V's A (the RS form); V is B in its natural
//    [keys, D] layout through wgmma's transpose bit (MN-major: 8-key core
//    groups one box row apart, boxes one box apart; D = 96 as one n96,
//    D = 256 as two n128 halves). O never leaves registers until the
//    epilogue.
//  * 8-bit K/V. TMA brings the raw codes (a ring of stages); all 256
//    threads decode a tile into one of two bf16 tiles in the swizzled
//    layout wgmma reads, with the int8 scale rows beside it (0 past
//    kv_len), then refill the raw stage. Two decoded buffers let one
//    warpgroup decode tile j + 1 while the other still multiplies tile j.
//  * Stages of bf16 K/V are refilled by the last of the 8 warps done with
//    them (a shared counter), so no warp waits for another and no
//    producer warp is needed: a third warpgroup would cap every thread at
//    168 registers, and S (64), O (up to 64) and P (32) need more (at
//    D = 256, O's 128 beside S's 32 and P's 16: the 64-key tile).
//  * Masks and scheduling: only tiles that cross a row's diagonal, its
//    window's start or kv_len pay for the mask; tiles past the block's
//    last visible key, and with a window the tiles before the one that
//    holds its earliest position's first visible key, are never loaded.
//    A row whose first tile is wholly before its window (a block spans
//    2 x P positions) sees only -1e30 there: its running max stays
//    -1e30, finite, so the next tile's rescale exp2(-1e30 - m) is 0 and
//    the masked tile leaves nothing behind (no -inf - -inf). Blocks run
//    in supergroups of (b, kv head) units whose K/V fit in 16 MB of L2
//    together, so the query tiles of a head read its K/V from L2 after
//    the first; inside a supergroup, late (long) query tiles first, so
//    the short ones fill the last wave. Every wgmma group is retired
//    before any register it touches is written (no serialized wgmmas).
//  * Softcap: a template flag (kCap), so the capped instances carry the
//    pass over the S registers and the others nothing, and no runtime
//    branch sits around a wgmma. cap * tanh(y) is computed as cap -
//    2 cap / (e^{2y} + 1) (ex2.approx and an approximate division, a few
//    ulps), already in base 2: the scale folds 2 log2(e) / cap, the
//    constants cap log2(e).
//  * Epilogue: O / max(l, 1e-30) as bf16 into the warpgroup's Q tile
//    (swizzled), then a TMA store of the same (D, G, P) box, which writes
//    no position past S.
#pragma once

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace ti {
namespace flash {

using namespace ti::hw;

constexpr int kRows = 64;              // query rows a warpgroup (wgmma's M)
constexpr int kWG = 2;                 // consumer warpgroups a block
constexpr int kThreads = kWG * 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory of one block (offsets from a 1024-aligned base): the
// warpgroups' Q tiles, for 8-bit K/V the two decoded K/V pairs and their
// scales, the ring of TMA stages, then the mbarriers and counters.
template <int D, typename KV>
struct Layout {
  // keys a tile: 128, or 64 at D = 256 (a 128-key tile would leave one
  // bf16 stage beside the Q tiles, no room for the 8-bit K/V pairs, and
  // S's 64 registers a thread beside O's 128)
  static constexpr int kBN = D > 128 ? 64 : 128;
  static constexpr bool k8 = sizeof(KV) == 1;
  static constexpr int kSw = D % 64 ? 64 : 128;      // bytes a box row
  static constexpr int kSwizzle = kSw == 128 ? 1 : 2; // wgmma layout type
  static constexpr int kBoxCols = kSw / 2;            // bf16 columns a box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQ = kRows * D * 2;      // one warpgroup's Q (then O)
  static constexpr int kTile = kBN * D * 2;     // one bf16 K or V tile
  static constexpr int kFill = k8 ? 2 * kBN * D : 2 * kTile;  // a stage
  static constexpr int kConvOff = kWG * kQ;
  static constexpr int kSclOff = kConvOff + (k8 ? 2 * 2 * kTile : 0);
  static constexpr int kStageOff = kSclOff + (k8 ? 2 * 2 * kBN * 4 : 0);
  static constexpr int kStages =
      cmin(3, (kSmemMax - 1024 - 128 - kStageOff) / kFill);
  static constexpr int kBarOff = kStageOff + kStages * kFill;
  static constexpr int kSmem = 1024 + kBarOff + 128;
  static_assert(kStages >= 1, "no room for a K/V stage");
  static_assert(kStageOff % 1024 == 0 && kFill % 1024 == 0, "alignment");
};

struct Params {
  const float* k_scale;   // int8: f32 [B, Hkv, T] (strides ssb, ssh, 1)
  const float* v_scale;
  const int* kv_len;
  const int* q_start;
  long long ssb, ssh;
  int B, S, T, Hkv, gh, G, chunks, P, qtiles, hgroup, kv_swap;
  int window;             // keys t <= position - window masked; 0: none
  float scale_log2;       // softmax scale times log2(e); with a softcap
                          // scale * 2 log2(e) / cap
  float cap_log2;         // softcap: cap * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of the 16-byte chunk `ch` of row r in a swizzled box.
template <int kSw>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * kSw + ((ch ^ (kSw == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// S[64 rows][kBN keys] (+)= Q K^T over 16 of D, both K-major.
template <int kBN>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t dq, uint64_t dk,
                                         int acc) {
  if constexpr (kBN == 64)
    wgmma_ss_n64(s, dq, dk, acc);
  else
    wgmma_ss_n128(s, dq, dk, acc);
}

// O[64 rows][D] += P V over 16 keys, V MN-major at shared address v
// (8-key core groups one box row apart, boxes of kBoxCols columns kBN rows
// apart). D = 96 is one n96 over three 32-column boxes (96 is a legal
// wgmma N, so one instruction, not three n32s each feeding P again); D =
// 256 is two n128 halves, the second two boxes on.
template <int D, typename L>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint32_t v) {
  auto desc = [](uint32_t addr) {
    return wgmma_desc(addr, L::kBN * L::kSw, 8 * L::kSw, L::kSwizzle);
  };
  if constexpr (D == 32) {
    wgmma_rs_n32_t(o, a, desc(v));
  } else if constexpr (D == 64) {
    wgmma_rs_n64_t(o, a, desc(v));
  } else if constexpr (D == 96) {
    wgmma_rs_n96_t(o, a, desc(v));
  } else if constexpr (D == 128) {
    wgmma_rs_n128_t(o, a, desc(v));
  } else {
    static_assert(D == 256, "head dims 32, 64, 96, 128, 256");
    wgmma_rs_n128_t(o, a, desc(v));
    wgmma_rs_n128_t(o + 64, a, desc(v + 2 * L::kBN * L::kSw));
  }
}

// Four 8-bit codes (one word, code 0 in the low byte) -> two bf16x2
// words, exactly. int8: each code c becomes the f32 2^23 + (c + 128) by a
// byte permute, minus 2^23 + 128 is c, whose 8 significant bits fit the
// upper half-word: that half is c in bf16. fp8: sign and the 7
// exponent-mantissa bits move into bf16's fields 4 bits right of bf16's
// exponent bias, so the bf16 value is the e4m3 value times 2^-120
// (subnormals included; 0x7F/0xFF read as 1.875 * 2^8 = 480), and one
// exact bf16 multiply by 2^120 finishes.
template <typename KV>
__device__ __forceinline__ void decode4(uint32_t w, uint32_t* out) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) -
             8388736.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[j] = __byte_perm(__float_as_uint(f[2 * j]),
                           __float_as_uint(f[2 * j + 1]), 0x7632);
  } else {
    const uint32_t k2p120 = 0x7B807B80u;   // bf16x2 (2^120, 2^120)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t v = __byte_perm(w, 0u, j ? 0x3424u : 0x1404u);
      const uint32_t h = (v & 0x80008000u) | ((v & 0x7F007F00u) >> 4);
      const __nv_bfloat162 r =
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&h),
                  *reinterpret_cast<const __nv_bfloat162*>(&k2p120));
      out[j] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
}

// Decodes a raw 8-bit stage (kBN K rows, then kBN V rows, D codes each)
// into bf16 K and V tiles in the swizzled box layout; all threads.
template <int D, typename KV>
__device__ __forceinline__ void decode_stage(const uint8_t* raw,
                                             uint8_t* dst) {
  using L = Layout<D, KV>;
  constexpr int kBN = L::kBN;
  constexpr int kC = D / 16;   // 16-code chunks a row
  for (int i = threadIdx.x; i < 2 * kBN * kC; i += kThreads) {
    const int row = i / kC, c16 = i - row * kC;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + row * D + c16 * 16);
    uint32_t w[8];
    decode4<KV>(v.x, w);
    decode4<KV>(v.y, w + 2);
    decode4<KV>(v.z, w + 4);
    decode4<KV>(v.w, w + 6);
    const int tile = row / kBN, r = row - tile * kBN;
    const int col = 16 * c16, bx = col / L::kBoxCols;
    const int ch = (col - bx * L::kBoxCols) / 8;
    uint8_t* box = dst + tile * L::kTile + bx * kBN * L::kSw;
    *reinterpret_cast<uint4*>(box + swz<L::kSw>(r, ch)) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(box + swz<L::kSw>(r, ch + 1)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <int D, typename KV, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmo,
                     const Params p) {
  using L = Layout<D, KV>;
  constexpr int kBN = L::kBN;
  constexpr bool kScaled = std::is_same<KV, int8_t>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  const uint32_t qbar = bars + 8u * L::kStages;
  uint32_t* const done =
      reinterpret_cast<uint32_t*>(sbase + L::kBarOff + 8 * (L::kStages + 1));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, tig = lane & 3;

  // block -> (query tile, b, kv head, head chunk): supergroups of
  // hgroup (b, kv head, chunk) units whose K/V fit in L2 together, in
  // turn; inside one, late query tiles first
  const int per = p.B * p.Hkv * p.chunks;
  const int blk = static_cast<int>(blockIdx.x);
  const int sg = blk / (p.hgroup * p.qtiles);
  const int in_sg = blk - sg * p.hgroup * p.qtiles;
  const int units = min(p.hgroup, per - sg * p.hgroup);
  const int qt = p.qtiles - 1 - in_sg / units;
  const int rest = sg * p.hgroup + in_sg % units;
  const int chunk = rest % p.chunks, hk = (rest / p.chunks) % p.Hkv;
  const int b = rest / (p.chunks * p.Hkv);
  const int h0 = hk * p.gh + chunk * p.G;   // the block's first query head
  const int pos0 = qt * kWG * p.P;          // its first position
  const int pw = pos0 + wg * p.P;           // this warpgroup's first
  const int used = p.G * p.P;               // rows of a tile with a query
  const int start = p.q_start[b];
  const int kv_lim = min(p.kv_len[b], p.T);
  // keys any query of the block sees: t < kv_len and t <= position, and
  // with a window t > position - window of its earliest position
  const int kv_end =
      max(0, min(kv_lim, start + min(pos0 + kWG * p.P, p.S)));
  const int j0 = p.window ? max(0, start + pos0 - p.window + 1) / kBN : 0;
  const int ntiles = max(0, (kv_end + kBN - 1) / kBN - j0);

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Q rows past `used` (G*P < 64 when G does not divide 64) stay zero
  constexpr int kCh = L::kSw / 16;
  const int pad = (kRows - used) * kCh;
  for (int i = tid; i < kWG * L::kBoxes * pad; i += kThreads) {
    const int box = i / pad, r = used + (i - box * pad) / kCh, ch = i % kCh;
    *reinterpret_cast<uint4*>(sbase + box * kRows * L::kSw + r * L::kSw +
                              ch * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  // Stage of the block's K/V tile j (tile j0 + j), issued by one thread.
  auto fill = [&](int j) {
    const int s = j % L::kStages;
    const uint32_t st = base + L::kStageOff + s * L::kFill;
    const int t0 = (j0 + j) * kBN;
    const int c1 = p.kv_swap ? hk : t0, c2 = p.kv_swap ? t0 : hk;
    fence_proxy_async();
    mbar_expect_tx(full(s), L::kFill);
    if constexpr (L::k8) {
      tma_4d(st, &tmk, full(s), 0, c1, c2, b);
      tma_4d(st + kBN * D, &tmv, full(s), 0, c1, c2, b);
    } else {
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx) {
        tma_4d(st + bx * kBN * L::kSw, &tmk, full(s), bx * L::kBoxCols, c1,
               c2, b);
        tma_4d(st + L::kTile + bx * kBN * L::kSw, &tmv, full(s),
               bx * L::kBoxCols, c1, c2, b);
      }
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, kWG * L::kBoxes * used * L::kSw);
    for (int w = 0; w < kWG; ++w)
      for (int bx = 0; bx < L::kBoxes; ++bx)
        tma_4d(base + (w * L::kBoxes + bx) * kRows * L::kSw, &tmq, qbar,
               bx * L::kBoxCols, h0, pos0 + w * p.P, b);
    for (int j = 0; j < ntiles && j < L::kStages; ++j) fill(j);
  }

  // This thread's rows of the warpgroup's tile: r0 and r0 + 8.
  const int r0 = 16 * wl + g8;
  int qpos[2], qlo[2];   // positions; first visible keys (window)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = start + pw + (r0 + 8 * h) / p.G;
    qlo[h] = p.window ? qpos[h] - p.window + 1 : -(1 << 30);
  }
  // the first key every row of the warpgroup sees (window)
  const int wg_lo = p.window ? start + pw + p.P - p.window : -(1 << 30);
  const uint32_t qs = base + wg * L::kQ;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {ti::kNegInf, ti::kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % L::kStages;
    const int kt = (j0 + j) * kBN;
    mbar_wait(full(s), (j / L::kStages) & 1);
    uint32_t ks;
    const float* scl = nullptr;   // int8: the tile's key, then value scales
    if constexpr (L::k8) {
      const int u = j & 1;
      decode_stage<D, KV>(sbase + L::kStageOff + s * L::kFill,
                          sbase + L::kConvOff + u * 2 * L::kTile);
      if constexpr (kScaled) {
        float* sc = reinterpret_cast<float*>(sbase + L::kSclOff) + u * 2 * kBN;
        const long long row = b * p.ssb + hk * p.ssh + kt;
        for (int i = tid; i < 2 * kBN; i += kThreads) {
          const int t = i % kBN;
          sc[i] = kt + t < kv_lim ? (i < kBN ? p.k_scale : p.v_scale)[row + t]
                                  : 0.f;
        }
        scl = sc;
      }
      fence_proxy_async();
      __syncthreads();   // decoded; the raw stage is free again
      if (tid == 0 && j + L::kStages < ntiles) fill(j + L::kStages);
      ks = base + L::kConvOff + u * 2 * L::kTile;
    } else {
      ks = base + L::kStageOff + s * L::kFill;
    }
    const uint32_t vs = ks + L::kTile;

    // S[64 rows][kBN keys] = Q K^T
    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int bx = kk * 16 / L::kBoxCols;
      const int off = (kk * 16 - bx * L::kBoxCols) * 2;
      wgmma_qk<kBN>(sc,
                    wgmma_desc(qs + bx * kRows * L::kSw + off, 16,
                               8 * L::kSw, L::kSwizzle),
                    wgmma_desc(ks + bx * kBN * L::kSw + off, 16, 8 * L::kSw,
                               L::kSwizzle),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // sc[4 c + 2 h + e]: row r0 + 8 h, key kt + 8 c + 2 tig + e
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c) {
      float2 f = make_float2(p.scale_log2, p.scale_log2);
      if constexpr (kScaled) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(scl + 8 * c + 2 * tig);
        f.x *= k2.x;
        f.y *= k2.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sc[4 * c + 2 * h] *= f.x;
        sc[4 * c + 2 * h + 1] *= f.y;
      }
    }
    if constexpr (kCap) {
      // cap log2(e) tanh(y) with sc = 2 log2(e) y: c - 2 c / (2^sc + 1)
      const float c1 = p.cap_log2, c2 = 2.f * p.cap_log2;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        sc[i] = c1 - __fdividef(c2, ex2(sc[i]) + 1.f);
    }
    if (kt + kBN > kv_lim || kt + kBN - 1 > start + pw || kt < wg_lo) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int t = kt + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int h = (i >> 1) & 1;
        if (t >= kv_lim || t > qpos[h] || t < qlo[h]) sc[i] = ti::kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P as wgmma A fragments: k16 step kk is key chunks 2 kk and 2 kk + 1
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        float a = sc[i], c = sc[i + 1];
        if constexpr (kScaled) {
          const float2 vsc = *reinterpret_cast<const float2*>(
              scl + kBN + 8 * (i >> 2) + 2 * tig);
          a *= vsc.x;
          c *= vsc.y;
        }
        pf[kk][r] = f2_bf2(a, c);
      }

    // O[64 rows][D] += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv<D, L>(o, pf[kk], vs + kk * 16 * L::kSw);
    wgmma_commit();
    wgmma_wait<0>();

    if constexpr (!L::k8) {
      // the last of the block's warps done with the stage refills it
      __syncwarp();
      uint32_t last = 0;
      if (lane == 0) {
        __threadfence_block();
        last = atomicAdd(&done[s], 1u) % kWarps == kWarps - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0) && lane == 0 &&
          j + L::kStages < ntiles)
        fill(j + L::kStages);
    }
  }

  // out = O / max(l, 1e-30), through this warpgroup's Q tile (swizzled
  // as the TMA box) and a TMA store
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
  uint8_t* const ot = sbase + wg * L::kQ;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c, bx = col / L::kBoxCols;
    const int ch = (col - bx * L::kBoxCols) / 8;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(ot + bx * kRows * L::kSw +
                                   swz<L::kSw>(r0 + 8 * h, ch) + 4 * tig) =
          f2_bf2(o[4 * c + 2 * h] * inv[h], o[4 * c + 2 * h + 1] * inv[h]);
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if ((tid & 127) == 0) {
    for (int bx = 0; bx < L::kBoxes; ++bx)
      tma_store_4d(&tmo, qs + bx * kRows * L::kSw, bx * L::kBoxCols, h0, pw,
                   b);
    tma_store_wait();
  }
}

// One call's arguments, as ti_flash_prefill takes them (strides in
// elements: {qsb, qss, qsh, ksb, ksh, kst, vsb, vsh, vst, osb, oss, osh,
// ssb, ssh}).
struct Call {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  void* o;
  const int* kv_len;
  const int* q_start;
  int B, S, Hq, Hkv, T, D;
  const long long* st;
  float scale;
  int window;     // 0: none
  float softcap;  // 0: none
  cudaStream_t stream;
};

// Heads a block packs: the group, or its largest divisor <= 64.
inline int heads_a_block(int gh) {
  int G = gh < kRows ? gh : kRows;
  while (gh % G) --G;
  return G;
}

template <int D, typename KV, bool kCap>
int launch(const Call& c) {
  using L = Layout<D, KV>;
  auto kernel = flash_prefill_kernel<D, KV, kCap>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (c.B == 0 || c.S == 0) return 0;
  const long long* st = c.st;
  Params p{};
  p.k_scale = c.k_scale;
  p.v_scale = c.v_scale;
  p.kv_len = c.kv_len;
  p.q_start = c.q_start;
  p.ssb = st[12];
  p.ssh = st[13];
  p.B = c.B;
  p.S = c.S;
  p.T = c.T;
  p.Hkv = c.Hkv;
  p.gh = c.Hq / c.Hkv;
  p.G = heads_a_block(p.gh);
  p.chunks = p.gh / p.G;
  p.P = kRows / p.G;
  p.qtiles = (c.S + kWG * p.P - 1) / (kWG * p.P);
  // units a supergroup: their K/V (all T rows) within 16 MB of L2
  const long long per = (long long)c.B * c.Hkv * p.chunks;
  const long long kv_bytes = 2LL * c.T * D * sizeof(KV) + 1;
  p.hgroup = static_cast<int>(
      std::max(1LL, std::min(per, (16LL << 20) / kv_bytes)));
  p.window = c.window;
  p.scale_log2 = kCap ? c.scale * 2.f * kLog2e / c.softcap : c.scale * kLog2e;
  p.cap_log2 = c.softcap * kLog2e;
  // the fresh view's T stride exceeds its head stride: heads listed first
  p.kv_swap = st[4] < st[5];
  if ((st[7] < st[8]) != (p.kv_swap != 0))
    return static_cast<int>(cudaErrorInvalidValue);

  const CUtensorMapSwizzle sw =
      L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tmq, tmk, tmv, tmo;
  const long long qd[4] = {D, c.Hq, c.S, c.B};
  const int qbox[4] = {L::kBoxCols, p.G, p.P, 1};
  const long long qst[3] = {2 * st[2], 2 * st[1], 2 * st[0]};
  const long long ost[3] = {2 * st[11], 2 * st[10], 2 * st[9]};
  bool ok = tensor_map_nd(&tmq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.q, 4, qd,
                          qst, qbox, sw) &&
            tensor_map_nd(&tmo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, c.o, 4, qd,
                          ost, qbox, sw);
  const long long es = sizeof(KV);
  const long long kd[4] = {D, p.kv_swap ? c.Hkv : c.T,
                           p.kv_swap ? c.T : c.Hkv, c.B};
  const int kbox[4] = {L::k8 ? D : L::kBoxCols, p.kv_swap ? 1 : L::kBN,
                       p.kv_swap ? L::kBN : 1, 1};
  const CUtensorMapDataType kt = L::k8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle ksw = L::k8 ? CU_TENSOR_MAP_SWIZZLE_NONE : sw;
  for (int i = 0; i < 2 && ok; ++i) {
    const long long* s = st + 3 + 3 * i;   // {sb, sh, st}
    const long long kst[3] = {es * (p.kv_swap ? s[1] : s[2]),
                              es * (p.kv_swap ? s[2] : s[1]), es * s[0]};
    ok = tensor_map_nd(i ? &tmv : &tmk, kt, i ? c.v : c.k, 4, kd, kst, kbox,
                       ksw);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = p.qtiles * per;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kSmem, c.stream>>>(
      tmq, tmk, tmv, tmo, p);
  return ti::launch_status();
}

// Every head dim of one K/V storage type, with and without a softcap;
// instantiated once per type.
template <typename KV, bool kCap>
int run_d(const Call& c) {
  switch (c.D) {
    case 32:
      return launch<32, KV, kCap>(c);
    case 64:
      return launch<64, KV, kCap>(c);
    case 96:
      return launch<96, KV, kCap>(c);
    case 128:
      return launch<128, KV, kCap>(c);
    case 256:
      return launch<256, KV, kCap>(c);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename KV>
int run(const Call& c) {
  return c.softcap > 0.f ? run_d<KV, true>(c) : run_d<KV, false>(c);
}

}  // namespace flash
}  // namespace ti

// Pieces shared by the decode and paged attention kernels
// (decode_attention.cu, paged_attention.cu): the split of a (b, kv head)'s
// live rows into slices of S sub-slices, the online-softmax fold, and the
// swizzled bf16 tiles that mma.sync reads through ldmatrix, with the
// widening of 8-bit K/V rows into them.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ti {
namespace attn {

// The block's slice: S sub-slices of R rows, the block one of nlive
// slices of the live rows [lo, kvl) counted from lo. It reads rows [t0,
// end), R at a time: the current sub-slice is rows [t0, t0 + n).
struct Slice {
  int t0, n, end, nlive;
  // to the next sub-slice; false past the slice's rows
  __device__ __forceinline__ bool next(int R) {
    t0 += R;
    n = min(R, end - t0);
    return t0 < end;
  }
};

// Block s's slice, at its first sub-slice; false past the live rows (the
// block exits). kv_len[b] is clamped to [1, T]; window 0 for none.
__device__ __forceinline__ bool slice_of(const int* kv_len, int b, int s,
                                         int T, int window, int R, int S,
                                         Slice& sl) {
  const int kvl = max(1, min(kv_len[b], T));
  const int lo = window > 0 ? max(kvl - window, 0) : 0;
  const int rows = R * S;
  sl.t0 = lo + s * rows;
  sl.end = min(sl.t0 + rows, kvl);
  sl.n = min(R, sl.end - sl.t0);
  sl.nlive = (kvl - lo + rows - 1) / rows;
  return sl.t0 < kvl;
}

// A softcap (cap > 0; cap2 = 2 log2(e) / cap) over the n scores row[0..n),
// lane by lane (lane, lane + 32, ...: the lanes then read their own
// scores back, so no barrier). The kernels run it only in their instances
// for calls with a softcap (a template flag), so an uncapped call runs
// the code it ran before there was one.
__device__ __forceinline__ void cap_scores(float* row, int n, float cap,
                                           float cap2, int lane) {
  for (int i = lane; i < n; i += 32) row[i] = ti::softcap(row[i], cap, cap2);
}

// Folds a sub-slice's (max, sum) (m, l) into the slice's running (M, L)
// and returns the factors (a, c) of the running and the new unnormalised
// outputs: O = a O + c o. The first fold (M = -inf) gives (0, 1).
__device__ __forceinline__ float2 fold(float& M, float& L, float m, float l) {
  const float mn = fmaxf(M, m), a = __expf(M - mn), c = __expf(m - mn);
  L = L * a + l * c;
  M = mn;
  return make_float2(a, c);
}

// 16-byte chunk c of bf16 row t, XOR-swizzled so the 8 rows an ldmatrix
// reads sit in 8 different bank groups. A row of D = 96 is 12 chunks: the
// first 8 XOR with t & 7 and the last 4 with (t >> 1) & 3, so every chunk
// stays in its row (c ^ (t & 7) would carry chunks 8-11 into the next
// row) and, rows being 12 chunks (4 bank groups mod 8) apart, the 8 rows
// still meet 8 bank groups.
template <int D>
__device__ __forceinline__ int swz(int t, int c) {
  if constexpr (D == 96) {
    return t * 12 + (c < 8 ? c ^ (t & 7) : 8 + ((c - 8) ^ ((t >> 1) & 3)));
  } else {
    constexpr int kMask = (D / 8 < 8 ? D / 8 : 8) - 1;
    return t * (D / 8) + (c ^ (t & kMask));
  }
}

// The lanes of a CUDA-core row kernel (a lone head's decode and paged
// kernels, kThreads threads): a row of D values is kLpr = D / kE 16-byte
// chunks, and its score is read by kGrp = lane_group(kLpr) lanes (at D =
// 96, 12 chunks of bf16 or 6 of 8-bit codes: lanes 12-15 of each 16, or
// 6-7 of each 8, hold zeros). P V takes kGroups row groups of kLpr
// threads; the kThreads % kLpr threads left over sit it out.
template <int D, int kE, int kThreads>
struct RowLanes {
  static constexpr int kLpr = D / kE;
  static constexpr int kGrp = lane_group(kLpr);
  static constexpr int kRpw = 32 / kGrp;          // rows a warp pass
  static constexpr int kGroups = kThreads / kLpr;  // row groups of P V
  static_assert(kLpr * kE == D && kGrp <= 32, "head dims 32-256");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p,
                                            bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// int8: byte p of a word w -> its code as an exact f32, 2^23 + (code +
// 128) minus 2^23 + 128 (byte permutes and adds; no per-byte I2F).
__device__ __forceinline__ float i8_at(uint32_t w, int p) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     p | 0x7440)) - 8388736.0f;
}

// The bf16 form of R rows of 8-bit codes into the swizzled layout
// (exact: int8 codes and e4m3 values are bf16 values; zero-filled rows
// decode to zeros). All kThreads threads of the block take part.
template <typename KV, int D, int kThreads = 128>
__device__ __forceinline__ void widen(const unsigned char* raw, uint4* dst,
                                      int R) {
  for (int i = threadIdx.x; i < R * D / 16; i += kThreads) {
    const int t = i / (D / 16), c = i % (D / 16);
    const uint4 u = *reinterpret_cast<const uint4*>(raw + i * 16);
    uint32_t o[8];
    if constexpr (std::is_same_v<KV, int8_t>) {
      // an integer code's f32 has its bf16 in the top half, exactly
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = __byte_perm(__float_as_uint(i8_at(w[k >> 1], 2 * (k & 1))),
                           __float_as_uint(i8_at(w[k >> 1], 2 * (k & 1) + 1)),
                           0x7632);
    } else {
      float f[16];
      ti::kv16_to_float<KV>(u, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = ti::pack_bf16(f[2 * k], f[2 * k + 1]);
    }
    dst[swz<D>(t, 2 * c)] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[swz<D>(t, 2 * c + 1)] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

}  // namespace attn
}  // namespace ti

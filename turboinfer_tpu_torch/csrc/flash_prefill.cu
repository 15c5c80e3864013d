// flash_prefill: causal GQA attention for prefill with online softmax.
//
// Replaces the TPU kernel turboinfer_tpu/kernels/pallas/flash_attention.py
// prefill_pallas (_prefill, body _kernel) and the model-dtype part of
// _prefill_stacked: the K/V operand is any [B, Hkv, T, D] view given by
// base pointer and strides, so the same kernel reads the just-computed
// [B, S, Hkv, D] block of a fresh prefill (transposed by strides, no
// copy) or layer li of the stacked [L, B, Hkv, T, D] cache (a pointer
// offset). Query s of sequence b sits at position q_start[b] + s; keys
// at t >= kv_len[b] or t > position are masked with -1e30 and the final
// denominator is clamped to 1e-30, as in the JAX kernel, so padded
// query rows come out finite.
//
// What bounds it on the H100: 4*B*Hq*S*T*D operations (half of them
// masked away by causality) over the bf16 tensor-core rate. One block
// of 4 warps owns 64 queries of one (b, head); it walks 64-key tiles up
// to min(kv_len, last query position + 1), skipping tiles that are dead
// by causality or kv_len. Q*K^T and P*V run on WMMA bf16 tensor cores
// with f32 accumulation; the score tile and the output accumulator live
// in shared memory, where the per-row online softmax rescales them. A
// register-resident mma.sync/wgmma version is future work.
//
// int8 and fp8 stacked caches (the compressed reads of _prefill_stacked:
// `scaled` and _load_kv): K/V rows are decoded while the 64-row tile is
// loaded into shared memory, so the WMMA bf16 path is unchanged. Both
// decodes are exact in bf16: fp8 bits become their e4m3 values (0x7F/0xFF
// as +-480, as e4m3_to_bf16 reads them), int8 codes stay codes, and, as
// in the Pallas body, the int8 scales ride the score and probability
// tiles: score columns times the key rows' scales, probability columns
// times the value rows' scales before P V, the denominator summing the
// unscaled probabilities. A fresh prefill's K/V is always bf16.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 128;
constexpr int kSsLd = kBKV + 4;   // f32 score tile
constexpr int kPsLd = kBKV + 8;   // bf16 probability tile

constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;   // bf16 q/k/v tiles
  static constexpr int kOsLd = D + 4; // f32 output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(__nv_bfloat16) * kBQ * kLd);
  static constexpr size_t v = align128(k + sizeof(__nv_bfloat16) * kBKV * kLd);
  static constexpr size_t sc = align128(v + sizeof(__nv_bfloat16) * kBKV * kLd);
  static constexpr size_t p = align128(sc + sizeof(float) * kBQ * kSsLd);
  static constexpr size_t o = align128(p + sizeof(__nv_bfloat16) * kBQ * kPsLd);
  static constexpr size_t m = align128(o + sizeof(float) * kBQ * kOsLd);
  static constexpr size_t l = align128(m + sizeof(float) * kBQ);
  static constexpr size_t ksc = align128(l + sizeof(float) * kBQ);
  static constexpr size_t vsc = align128(ksc + sizeof(float) * kBKV);
  static constexpr size_t total = align128(vsc + sizeof(float) * kBKV);
};

// Load rows [row0, row0 + 64) of a [rows, D] operand (row stride
// `rs`, elements) into smem as bf16; rows at or beyond `nvalid` are
// zero. 8-bit rows decode to exact bf16 values (int8: the codes).
template <int D, typename KV>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const KV* src,
                                          long long rs, int row0, int nvalid) {
  constexpr int kE = ti::KvVec<KV>::kE;
  constexpr int kVec = D / kE;
  for (int i = threadIdx.x; i < kBQ * kVec; i += kThreads) {
    const int r = i / kVec, c = (i - r * kVec) * kE;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nvalid)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    if constexpr (kE == 8) {
      *reinterpret_cast<uint4*>(dst + r * Smem<D>::kLd + c) = val;
    } else {
      float f[16];
      ti::kv16_to_float<KV>(val, f);
      __nv_bfloat162 h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      uint4* d4 = reinterpret_cast<uint4*>(dst + r * Smem<D>::kLd + c);
      d4[0] = *reinterpret_cast<const uint4*>(h);
      d4[1] = *reinterpret_cast<const uint4*>(h + 4);
    }
  }
}

// Scales of rows [row0, row0 + 64) of one (b, kv head) into smem (int8
// caches only); 0 beyond `nvalid`, where the keys are masked anyway.
__device__ __forceinline__ void load_scales(float* dst, const float* src,
                                            int row0, int nvalid) {
  for (int r = threadIdx.x; r < kBKV; r += kThreads)
    dst[r] = row0 + r < nvalid ? src[row0 + r] : 0.f;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const KV* __restrict__ k, const KV* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     __nv_bfloat16* __restrict__ o,
                     const int* __restrict__ kv_len,
                     const int* __restrict__ q_start, int S, int Hq, int Hkv,
                     int T, long long qsb, long long qss, long long qsh,
                     long long ksb, long long ksh, long long kst,
                     long long vsb, long long vsh, long long vst,
                     long long osb, long long oss, long long osh,
                     long long ssb, long long ssh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<D>;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::sc);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* mrow = reinterpret_cast<float*>(smem + L::m);
  float* lrow = reinterpret_cast<float*>(smem + L::l);
  float* ksc = reinterpret_cast<float*>(smem + L::ksc);
  float* vsc = reinterpret_cast<float*>(smem + L::vsc);

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = q_start[b];
  const int kv_lim = min(kv_len[b], T);
  // Keys a query of this tile can see: t < kv_len and t <= position.
  const int kv_end = min(kv_lim, start + q0 + kBQ);

  load_tile<D>(qs, q + b * qsb + h * qsh, qss, q0, S);
  const bool scaled = k_scale != nullptr;
  for (int i = threadIdx.x; i < kBQ * L::kOsLd; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    mrow[i] = ti::kNegInf;
    lrow[i] = 0.f;
  }

  const KV* kb = k + b * ksb + hk * ksh;
  const KV* vb = v + b * vsb + hk * vsh;
  const float* kscl = scaled ? k_scale + b * ssb + hk * ssh : nullptr;
  const float* vscl = scaled ? v_scale + b * ssb + hk * ssh : nullptr;
  const int row = warp * 16 + (lane >> 1);   // softmax row of this lane
  const int c0 = (lane & 1) * (kBKV / 2);    // its half of the key tile
  const int qpos = start + q0 + row;

  for (int kt = 0; kt < kv_end; kt += kBKV) {
    __syncthreads();   // previous tile fully consumed
    load_tile<D>(ks, kb, kst, kt, kv_lim);
    load_tile<D>(vs, vb, vst, kt, kv_lim);
    if (scaled) {
      load_scales(ksc, kscl, kt, kv_lim);
      load_scales(vsc, vscl, kt, kv_lim);
    }
    __syncthreads();

    // S[16 rows of this warp][64 keys] = Q K^T
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + warp * 16 * L::kLd + kk, L::kLd);
        wmma::load_matrix_sync(bt, ks + j * 16 * L::kLd + kk, L::kLd);
        wmma::mma_sync(sacc, a, bt, sacc);
      }
      wmma::store_matrix_sync(ss + warp * 16 * kSsLd + j * 16, sacc, kSsLd,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's 32 keys of its row.
    float* srow = ss + row * kSsLd;
    float mx = ti::kNegInf;
#pragma unroll 8
    for (int c = c0; c < c0 + kBKV / 2; ++c) {
      const int t = kt + c;
      const float sk = scaled ? scale * ksc[c] : scale;
      const float sv = (t < kv_lim && t <= qpos) ? srow[c] * sk : ti::kNegInf;
      srow[c] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = mrow[row];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = __expf(m_prev - m_new);
    float psum = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + kBKV / 2; ++c) {
      const float p = __expf(srow[c] - m_new);
      psum += p;
      ps[row * kPsLd + c] = __float2bfloat16(scaled ? p * vsc[c] : p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    float* orow = os + row * L::kOsLd;
    for (int d = (lane & 1) * (D / 2); d < (lane & 1) * (D / 2) + D / 2; ++d)
      orow[d] *= alpha;
    __syncwarp();
    if ((lane & 1) == 0) {
      mrow[row] = m_new;
      lrow[row] = lrow[row] * alpha + psum;
    }

    // O[16 rows][D] += P[16][64] V[64][D]
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      float* optr = os + warp * 16 * L::kOsLd + j * 16;
      wmma::load_matrix_sync(oacc, optr, L::kOsLd, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + warp * 16 * kPsLd + kk, kPsLd);
        wmma::load_matrix_sync(bv, vs + kk * L::kLd + j * 16, L::kLd);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(optr, oacc, L::kOsLd, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // out = O / max(l, 1e-30) for the valid query rows.
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (q0 + r >= S) continue;
    const float den = fmaxf(lrow[r], 1e-30f);
    o[b * osb + (q0 + r) * oss + h * osh + d] =
        __float2bfloat16(os[r * L::kOsLd + d] / den);
  }
}

template <int D, typename KV>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* kv_len, const int* q_start,
           int B, int S, int Hq, int Hkv, int T, const long long* st,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(Smem<D>::total);
  if (!configured) {
    cudaFuncSetAttribute(flash_prefill_kernel<D, KV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<D, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, static_cast<__nv_bfloat16*>(o),
      kv_len, q_start, S, Hq, Hkv, T, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      scale);
  return ti::launch_status();
}

template <typename KV>
int launch_kv(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, void* o, const int* kl, const int* qs, int B,
              int S, int Hq, int Hkv, int T, int D, const long long* st,
              float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32, KV>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, st, scale, stream);
    case 64:
      return launch<64, KV>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, st, scale, stream);
    case 128:
      return launch<128, KV>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: bf16 [B, S, Hq, D]; k, v: [B, Hkv, T, D] of bf16 (kv_dtype 0), int8
// codes (1) or float8_e4m3fn bits (2); o: bf16 [B, S, Hq, D], each given
// by strides in elements (the last dimension contiguous): strides =
// {qsb, qss, qsh, ksb, ksh, kst, vsb, vsh, vst, osb, oss, osh, ssb, ssh}.
// k_scale, v_scale: for int8, f32 [B, Hkv, T] with strides {ssb, ssh}
// and contiguous T, else null. kv_len, q_start: int32 [B] on the device.
// D in {32, 64, 128}.
int ti_flash_prefill(const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale, void* o,
                     const void* kv_len, const void* q_start, int B, int S,
                     int Hq, int Hkv, int T, int D, int kv_dtype,
                     const long long* strides, float scale, void* stream) {
  if (kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* kl = static_cast<const int*>(kv_len);
  const int* qs = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch_kv<__nv_bfloat16>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, D, strides, scale, st);
  if (kv_dtype == 1)
    return launch_kv<int8_t>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, D, strides, scale, st);
  return launch_kv<uint8_t>(q, k, v, ks, vs, o, kl, qs, B, S, Hq, Hkv, T, D, strides, scale, st);
}

}  // extern "C"

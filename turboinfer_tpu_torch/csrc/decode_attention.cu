// decode_attention: one query per sequence against the first kv_len[b]
// rows of one layer of the head-major cache.
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/decode_attention.py
// decode_pallas (_decode, body _kernel) and decode_fused_pallas
// (_decode_fused, body _fused_kernel) for a bf16 cache, and
// decode_pallas's int8 (`scaled`) and fp8 (_load_kv, e4m3_to_bf16)
// reads of a compressed cache. The cache operand is layer li of the
// stacked [L, B, Hkv, T, D] cache, selected by the caller's pointer
// offset. kv_len is clamped to
// [1, T] as the JAX kernel clamps it to >= 1. The fused-head cache of
// decode_fused_pallas exists for TPU lane alignment; the port keeps this
// head-major layout and takes its semantics here: an optional window
// (keys [max(kv_len - window, 0), kv_len) only) and optional per-head
// sink logits (softmax over [scores, sink], the sink adding no value).
//
// What bounds it on the H100: bytes, the 2 * kv_len * D * itemsize bytes
// of K and V (plus 8 bytes of scales per int8 row) each (b, kv head)
// must read, over 3.35 TB/s; the cost follows the fill, not max_seq.
// Pass 1 splits T into 256-row slices: one block
// of 4 warps per (b, kv head, slice) computes all Gh query heads of the
// group together, so each K/V row is read once for the whole group.
// Lanes read 16-byte vectors (a warp covers 32/(D/8) bf16 rows per load),
// scores and probabilities of the slice stay in shared memory, and the
// block writes its unnormalised output with its running max and sum.
// Slices past kv_len, and slices wholly below the window's first row
// lo, exit at once; the slice holding lo starts there. Pass 2 merges
// only the slices [lo / 256, ceil(kv_len / 256)) of each (b, head), so
// an exited slice's stale workspace is never read, and the sink enters
// that merge once, as one more partial (max = sink, sum = 1, no value).
//
// int8 and fp8 caches: the row read is templated on the element type. A
// 16-byte vector holds 16 eight-bit elements, so a row takes D / 16
// lanes (D / 8 for bf16) and half the bytes. fp8 bits decode in
// registers (0x7F/0xFF read as +-480, as e4m3_to_bf16 reads them); int8
// codes are exact in float, and the scales ride the score and
// probability rows as in the Pallas body: scores times the key row's
// scale after q.k, probabilities times the value row's scale before
// P V, the denominator summing the unscaled probabilities.
#include "common.cuh"

namespace {

constexpr int kSplit = 256;   // cache rows per pass-1 block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename KV, int D, int GH>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ kc, const KV* __restrict__ vc,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    const int* __restrict__ kv_len, int Hq, int Hkv, int T,
                    int gh, int nsplit, int window, long long qsb,
                    long long qsh, long long csb, long long csh,
                    float scale) {
  constexpr int kE = ti::KvVec<KV>::kE;   // elements per 16-byte load
  constexpr int kLpr = D / kE;         // lanes per cache row
  constexpr int kRpw = 32 / kLpr;      // rows per warp per pass
  constexpr int kRpb = kRpw * kWarps;  // rows per block per pass
  __shared__ float sc[GH][kSplit];
  __shared__ float red[kWarps][GH][D];
  __shared__ float ml[GH][2];

  const int b = blockIdx.x, hk = blockIdx.y, sp = blockIdx.z;
  const int kvl = max(1, min(kv_len[b], T));
  const int lo = window > 0 ? max(kvl - window, 0) : 0;
  if (sp * kSplit >= kvl || (sp + 1) * kSplit <= lo) return;
  const int t0 = max(sp * kSplit, lo);
  const int t1 = min((sp + 1) * kSplit, kvl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lrow = lane / kLpr, dl = (lane % kLpr) * kE;

  float qf[GH][kE];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (g < gh) {
      ti::load_bf16_row<kE>(q + b * qsb + (hk * gh + g) * qsh + dl, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) qf[g][e] = 0.f;
    }
  }
  const KV* kb = kc + b * csb + hk * csh;
  const KV* vb = vc + b * csb + hk * csh;
  // int8: the per-row scales of this (b, kv head), [T] f32 planes laid
  // out as the cache's rows
  const long long srow = (b * csb + hk * csh) / D;
  const float* ksr = ks ? ks + srow : nullptr;
  const float* vsr = vs ? vs + srow : nullptr;

  // Pass 1a: scores of the slice (int8: times the key row's scale).
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    const bool ok = t < t1;
    float kf[kE];
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = *reinterpret_cast<const uint4*>(kb + (long long)t * D + dl);
    ti::kv16_to_float<KV>(u, kf);
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (ok && (lane % kLpr) == 0 && g < gh)
        sc[g][t - t0] = ksr ? d * scale * ksr[t] : d * scale;
    }
  }
  __syncthreads();

  // Pass 1b: max, exp and sum per head, one warp per head. The sum takes
  // the unscaled probabilities; int8 then folds the value row's scale
  // into each probability for P V.
  const int n = t1 - t0;
  for (int g = warp; g < gh; g += kWarps) {
    float mx = ti::kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[g][i]);
    mx = ti::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = __expf(sc[g][i] - mx);
      sc[g][i] = vsr ? p * vsr[t0 + i] : p;
      sum += p;
    }
    sum = ti::warp_sum(sum);
    if (lane == 0) {
      ml[g][0] = mx;
      ml[g][1] = sum;
    }
  }
  __syncthreads();

  // Pass 1c: unnormalised P V of the slice.
  float acc[GH][kE];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    if (t < t1) {
      float vf[kE];
      const uint4 u = *reinterpret_cast<const uint4*>(vb + (long long)t * D + dl);
      ti::kv16_to_float<KV>(u, vf);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float p = (g < gh) ? sc[g][t - t0] : 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float a = acc[g][e];
#pragma unroll
      for (int off = kLpr; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[g][e] = a;
    }
  if (lrow == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g)
#pragma unroll
      for (int e = 0; e < kE; ++e) red[warp][g][dl + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gh * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[w][g][d];
    const long long row = ((long long)b * Hq + hk * gh + g) * nsplit + sp;
    part_o[row * D + d] = o;
    if (d == 0) {
      part_ml[row * 2] = ml[g][0];
      part_ml[row * 2 + 1] = ml[g][1];
    }
  }
}

__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      const int* __restrict__ kv_len,
                                      const float* __restrict__ sinks,
                                      __nv_bfloat16* __restrict__ out, int Hq,
                                      int T, int D, int nsplit, int window) {
  const int bh = blockIdx.x, b = bh / Hq, d = threadIdx.x;
  const int kvl = max(1, min(kv_len[b], T));
  const int lo = window > 0 ? max(kvl - window, 0) : 0;
  const int ns = (kvl + kSplit - 1) / kSplit;
  const long long row0 = (long long)bh * nsplit;
  const float m0 = sinks ? sinks[bh % Hq] : ti::kNegInf;
  out[(long long)bh * D + d] = __float2bfloat16(ti::merge_splits(
      part_o + row0 * D, part_ml + row0 * 2, ns, D, d, lo / kSplit, m0,
      sinks ? 1.f : 0.f));
}

struct DecodeArgs {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  float *po, *pml;
  const int* kl;
  int B, Hq, Hkv, T, gh, nsplit, window;
  const long long* st;
  float scale;
};

template <typename KV, int D, int GH>
void launch_split(const DecodeArgs& a, cudaStream_t stream) {
  dim3 grid(a.B, a.Hkv, a.nsplit);
  decode_split_kernel<KV, D, GH><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.kc),
      static_cast<const KV*>(a.vc), a.ks, a.vs, a.po, a.pml, a.kl, a.Hq,
      a.Hkv, a.T, a.gh, a.nsplit, a.window, a.st[0], a.st[1], a.st[2],
      a.st[3], a.scale);
}

template <typename KV, int D>
void launch_d(const DecodeArgs& a, cudaStream_t stream) {
  if (a.gh <= 1)
    launch_split<KV, D, 1>(a, stream);
  else if (a.gh <= 2)
    launch_split<KV, D, 2>(a, stream);
  else if (a.gh <= 4)
    launch_split<KV, D, 4>(a, stream);
  else
    launch_split<KV, D, 8>(a, stream);
}

template <typename KV>
int launch_kv(const DecodeArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch_d<KV, 32>(a, stream);
      return 0;
    case 64:
      launch_d<KV, 64>(a, stream);
      return 0;
    case 128:
      launch_d<KV, 128>(a, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int ti_decode_split_rows() { return kSplit; }

// f32 scratch elements the call needs: per (b, head, slice) D outputs
// plus the slice's max and sum.
long long ti_decode_workspace(int B, int Hq, int T, int D) {
  const long long nsplit = (T + kSplit - 1) / kSplit;
  return (long long)B * Hq * nsplit * (D + 2);
}

// q: bf16 [B, Hq, D] with strides {qsb, qsh}; k_cache, v_cache: the
// [B, Hkv, T, D] plane of layer li with strides {csb, csh} (elements)
// and contiguous [T, D] rows, of bf16 (kv_dtype 0), int8 codes (1) or
// float8_e4m3fn bits (2); k_scale, v_scale: for int8, the f32 [B, Hkv, T]
// scale planes of layer li laid out as the cache's rows, else null;
// out: bf16 [B, Hq, D] contiguous; kv_len: int32 [B] on the device;
// work: ti_decode_workspace(...) f32 elements; sinks: f32 [Hq] on the
// device, or null; window: rows before kv_len - window are masked, 0
// for none. strides = {qsb, qsh, csb, csh}. D in {32, 64, 128};
// Hq / Hkv <= 8.
int ti_decode_attention(const void* q, const void* k_cache,
                        const void* v_cache, const void* k_scale,
                        const void* v_scale, void* out, void* work,
                        const void* kv_len, const void* sinks, int B, int Hq,
                        int Hkv, int T, int D, int kv_dtype, int window,
                        const long long* strides, float scale, void* stream) {
  const int gh = Hq / Hkv;
  if (gh > 8 || Hq % Hkv || window < 0 || kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.kc = k_cache;
  a.vc = v_cache;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.gh = gh;
  a.nsplit = (T + kSplit - 1) / kSplit;
  a.window = window;
  a.st = strides;
  a.scale = scale;
  a.po = static_cast<float*>(work);
  a.pml = a.po + (long long)B * Hq * a.nsplit * D;
  a.kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = kv_dtype == 0   ? launch_kv<__nv_bfloat16>(a, D, st)
                  : kv_dtype == 1 ? launch_kv<int8_t>(a, D, st)
                                  : launch_kv<uint8_t>(a, D, st);
  if (bad) return bad;
  decode_combine_kernel<<<B * Hq, D, 0, st>>>(
      a.po, a.pml, a.kl, static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), Hq, T, D, a.nsplit, window);
  return ti::launch_status();
}

}  // extern "C"

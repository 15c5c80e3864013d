// decode_attention: one query per sequence against the first kv_len[b]
// rows of one layer of the head-major cache.
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/decode_attention.py
// decode_pallas (_decode, body _kernel) and decode_fused_pallas
// (_decode_fused, body _fused_kernel) for a model-dtype (bf16) cache.
// The cache operand is layer li of the stacked [L, B, Hkv, T, D] cache,
// selected by the caller's pointer offset. kv_len is clamped to
// [1, T] as the JAX kernel clamps it to >= 1. The fused-head cache of
// decode_fused_pallas exists for TPU lane alignment; the port keeps this
// head-major layout and takes its semantics here: an optional window
// (keys [max(kv_len - window, 0), kv_len) only) and optional per-head
// sink logits (softmax over [scores, sink], the sink adding no value).
//
// What bounds it on the H100: bytes, the 2 * kv_len * D * 2 bytes of K
// and V each (b, kv head) must read, over 3.35 TB/s; the cost follows
// the fill, not max_seq. Pass 1 splits T into 256-row slices: one block
// of 4 warps per (b, kv head, slice) computes all Gh query heads of the
// group together, so each K/V row is read once for the whole group.
// Lanes read 16-byte vectors (a warp covers 32/(D/8) rows per load),
// scores and probabilities of the slice stay in shared memory, and the
// block writes its unnormalised output with its running max and sum.
// Slices past kv_len, and slices wholly below the window's first row
// lo, exit at once; the slice holding lo starts there. Pass 2 merges
// only the slices [lo / 256, ceil(kv_len / 256)) of each (b, head), so
// an exited slice's stale workspace is never read, and the sink enters
// that merge once, as one more partial (max = sink, sum = 1, no value).
#include "common.cuh"

namespace {

constexpr int kSplit = 256;   // cache rows per pass-1 block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D, int GH>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    const int* __restrict__ kv_len, int Hq, int Hkv, int T,
                    int gh, int nsplit, int window, long long qsb,
                    long long qsh, long long csb, long long csh,
                    float scale) {
  constexpr int kLpr = D / 8;          // lanes per cache row
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
  const int lrow = lane / kLpr, dl = (lane % kLpr) * 8;

  float qf[GH][8];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (g < gh) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + b * qsb + (hk * gh + g) * qsh + dl);
      ti::bf16x8_to_float(u, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
  }
  const __nv_bfloat16* kb = kc + b * csb + hk * csh;
  const __nv_bfloat16* vb = vc + b * csb + hk * csh;

  // Pass 1a: scores of the slice.
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    const bool ok = t < t1;
    float kf[8];
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = *reinterpret_cast<const uint4*>(kb + (long long)t * D + dl);
    ti::bf16x8_to_float(u, kf);
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (ok && (lane % kLpr) == 0 && g < gh) sc[g][t - t0] = d * scale;
    }
  }
  __syncthreads();

  // Pass 1b: max, exp and sum per head, one warp per head.
  const int n = t1 - t0;
  for (int g = warp; g < gh; g += kWarps) {
    float mx = ti::kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[g][i]);
    mx = ti::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = __expf(sc[g][i] - mx);
      sc[g][i] = p;
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
  float acc[GH][8];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    if (t < t1) {
      float vf[8];
      const uint4 u = *reinterpret_cast<const uint4*>(vb + (long long)t * D + dl);
      ti::bf16x8_to_float(u, vf);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float p = (g < gh) ? sc[g][t - t0] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
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
      for (int e = 0; e < 8; ++e) red[warp][g][dl + e] = acc[g][e];
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

template <int D, int GH>
void launch_split(const void* q, const void* kc, const void* vc, float* po,
                  float* pml, const int* kl, int B, int Hq, int Hkv, int T,
                  int gh, int nsplit, int window, const long long* st,
                  float scale, cudaStream_t stream) {
  dim3 grid(B, Hkv, nsplit);
  decode_split_kernel<D, GH><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), po, pml, kl, Hq, Hkv, T, gh,
      nsplit, window, st[0], st[1], st[2], st[3], scale);
}

template <int D>
void launch_d(const void* q, const void* kc, const void* vc, float* po,
              float* pml, const int* kl, int B, int Hq, int Hkv, int T,
              int gh, int nsplit, int window, const long long* st,
              float scale, cudaStream_t stream) {
  if (gh <= 1)
    launch_split<D, 1>(q, kc, vc, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, st, scale, stream);
  else if (gh <= 2)
    launch_split<D, 2>(q, kc, vc, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, st, scale, stream);
  else if (gh <= 4)
    launch_split<D, 4>(q, kc, vc, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, st, scale, stream);
  else
    launch_split<D, 8>(q, kc, vc, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, st, scale, stream);
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
// [B, Hkv, T, D] plane of layer li with strides {csb, csh} and contiguous
// [T, D] rows; out: bf16 [B, Hq, D] contiguous; kv_len: int32 [B] on the
// device; work: ti_decode_workspace(...) f32 elements; sinks: f32 [Hq]
// on the device, or null; window: rows before kv_len - window are
// masked, 0 for none. strides = {qsb, qsh, csb, csh}. D in {32, 64,
// 128}; Hq / Hkv <= 8.
int ti_decode_attention(const void* q, const void* k_cache,
                        const void* v_cache, void* out, void* work,
                        const void* kv_len, const void* sinks, int B, int Hq,
                        int Hkv, int T, int D, int window,
                        const long long* strides, float scale, void* stream) {
  const int gh = Hq / Hkv;
  if (gh > 8 || Hq % Hkv || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nsplit = (T + kSplit - 1) / kSplit;
  float* po = static_cast<float*>(work);
  float* pml = po + (long long)B * Hq * nsplit * D;
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      launch_d<32>(q, k_cache, v_cache, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, strides, scale, st);
      break;
    case 64:
      launch_d<64>(q, k_cache, v_cache, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, strides, scale, st);
      break;
    case 128:
      launch_d<128>(q, k_cache, v_cache, po, pml, kl, B, Hq, Hkv, T, gh, nsplit, window, strides, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_combine_kernel<<<B * Hq, D, 0, st>>>(
      po, pml, kl, static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), Hq, T, D, nsplit, window);
  return ti::launch_status();
}

}  // extern "C"

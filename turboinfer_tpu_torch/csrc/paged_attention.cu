// paged_attention: G query tokens per sequence attend that sequence's
// cache through its block table over one layer of the page pool.
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/paged_attention.py
// paged_decode_pallas (G = 1) and paged_verify_pallas (G = spec_k + 1),
// which are one Pallas body (_paged_decode, _kernel) at g_tokens = 1 and
// g_tokens = G, for a bf16, int8 (with scale pages) or fp8 (uint8 e4m3
// bits) pool. The pool operand is layer li of the stacked
// [L, P, Hkv, page, D] pool, selected by the caller's pointer offset. Page ids are clamped to [0, P-1] (unassigned -1 rows
// read page 0, never page P-1) and kv_len to [1, max_pages * page], as
// the JAX kernel clamps them. Query row r of a kv head belongs to token
// g = r / Gh, sits at position kv_len - G + g, and sees keys col <= qpos;
// a row that sees no key averages the keys of its sequence uniformly, as
// the Pallas kernel's -1e30 masks make it do (the caller discards it).
//
// What bounds it on the H100: bytes, the 2 * kv_len * D * itemsize bytes
// of K and V (plus 8 bytes of scales per int8 row) each (b, kv head)
// must read through its table, over 3.35 TB/s; pages at or past
// ceil(kv_len / page) are never read, so the cost
// follows the fill, not the pool or max_seq. The design is
// decode_attention.cu's split-T scheme with a table lookup per key row:
// pass 1 splits [0, kv_len) into 256-key slices, one block of 4 warps per
// (b, kv head, group of up to 8 query rows, slice) computes the rows of
// its group together, so for G * Gh <= 8 each K/V row is read once for
// all G tokens of a verify and all Gh heads of the GQA group. Lanes read
// 16-byte vectors of a key row (a warp covers 32 / (D / 8) rows per
// load); scores and probabilities of the slice stay in shared memory; the
// block writes its unnormalised output with its running max and sum.
// Pass 2 merges the slices of each (b, kv head, row).
//
// int8 and fp8 pools (the Pallas body's `scaled` and _load_kv reads):
// the key row read is templated on the element type as in
// decode_attention.cu (D / 16 lanes per 8-bit row; fp8 decoded in
// registers, 0x7F/0xFF as +-480). An int8 pool's scale pages [P, Hkv,
// page] f32 of the layer are indexed with the row's own clamped table
// entry: scores times the key row's scale, probabilities times the
// value row's scale before P V, the denominator summing the unscaled
// probabilities. Pages stay multiples of 8 up to 256 (the TPU's page %
// 128 limit for scales does not apply).
#include "common.cuh"

namespace {

constexpr int kSplit = 256;   // keys per pass-1 block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct PagedArgs {
  const __nv_bfloat16* q;   // [B, Hkv, R, D], strides {qsb, qsh, qsr}
  const void* kp;           // one layer's pool [P, Hkv, page, D]
  const void* vp;
  const float* ks;          // int8: the layer's scale pages [P, Hkv, page]
  const float* vs;
  const int* table;         // [B, max_pages]
  const int* kv_len;        // [B]
  float* part_o;            // [B, Hkv, R, nsplit, D]
  float* part_ml;           // [B, Hkv, R, nsplit, 2]
  long long qsb, qsh, qsr;
  int Hkv, R, gh, g_tokens, P, page, max_pages, nsplit;
  float scale;
};

// Address of row `off` of page `i` of sequence b, kv head hk (page id
// read from the table and clamped into the pool).
__device__ __forceinline__ long long page_row(const PagedArgs& a, int b,
                                              int hk, int t) {
  const int i = t / a.page;
  const int off = t - i * a.page;
  const int pid = min(max(a.table[(long long)b * a.max_pages + i], 0),
                      a.P - 1);
  return ((long long)pid * a.Hkv + hk) * a.page + off;
}

template <typename KV, int D, int RB>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const PagedArgs a) {
  constexpr int kE = ti::KvVec<KV>::kE;   // elements per 16-byte load
  constexpr int kLpr = D / kE;         // lanes per key row
  constexpr int kRpw = 32 / kLpr;      // key rows per warp per pass
  constexpr int kRpb = kRpw * kWarps;  // key rows per block per pass
  __shared__ float sc[RB][kSplit];
  __shared__ float red[kWarps][RB][D];
  __shared__ float ml[RB][2];

  const int nchunk = (a.R + RB - 1) / RB;
  const int b = blockIdx.x, hk = blockIdx.y / nchunk;
  const int r0 = (blockIdx.y - hk * nchunk) * RB;
  const int rb = min(RB, a.R - r0);
  const int sp = blockIdx.z;
  const int kvl = max(1, min(a.kv_len[b], a.max_pages * a.page));
  const int t0 = sp * kSplit;
  if (t0 >= kvl) return;
  const int t1 = min(t0 + kSplit, kvl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lrow = lane / kLpr, dl = (lane % kLpr) * kE;
  const KV* kp = static_cast<const KV*>(a.kp);
  const KV* vp = static_cast<const KV*>(a.vp);

  float qf[RB][kE];
  int qpos[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    qpos[r] = kvl - a.g_tokens + (r0 + r) / a.gh;
    if (r < rb) {
      ti::load_bf16_row<kE>(a.q + b * a.qsb + hk * a.qsh + (r0 + r) * a.qsr + dl,
                            qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) qf[r][e] = 0.f;
    }
  }

  // Pass 1a: masked scores of the slice (int8: times the key row's scale).
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    const bool ok = t < t1;
    float kf[kE];
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    float sk = a.scale;
    if (ok) {
      const long long pr = page_row(a, b, hk, t);
      u = *reinterpret_cast<const uint4*>(kp + pr * D + dl);
      if (a.ks) sk *= a.ks[pr];
    }
    ti::kv16_to_float<KV>(u, kf);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qf[r][e], kf[e], d);
#pragma unroll
      for (int off = kLpr / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (ok && (lane % kLpr) == 0 && r < rb)
        sc[r][t - t0] = (t <= qpos[r]) ? d * sk : ti::kNegInf;
    }
  }
  __syncthreads();

  // Pass 1b: max, exp and sum per row, one warp per row.
  const int n = t1 - t0;
  for (int r = warp; r < rb; r += kWarps) {
    float mx = ti::kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sc[r][i]);
    mx = ti::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = __expf(sc[r][i] - mx);
      sc[r][i] = p;
      sum += p;
    }
    sum = ti::warp_sum(sum);
    if (lane == 0) {
      ml[r][0] = mx;
      ml[r][1] = sum;
    }
  }
  __syncthreads();

  // Pass 1c: unnormalised P V of the slice (int8: probabilities times
  // the value row's scale; the sums above took them unscaled).
  float acc[RB][kE];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  for (int base = t0 + warp * kRpw; base < t1; base += kRpb) {
    const int t = base + lrow;
    if (t < t1) {
      float vf[kE];
      const long long pr = page_row(a, b, hk, t);
      const uint4 u = *reinterpret_cast<const uint4*>(vp + pr * D + dl);
      const float sv = a.vs ? a.vs[pr] : 1.f;
      ti::kv16_to_float<KV>(u, vf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = (r < rb) ? sc[r][t - t0] * sv : 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      float v = acc[r][e];
#pragma unroll
      for (int off = kLpr; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][e] = v;
    }
  if (lrow == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < kE; ++e) red[warp][r][dl + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rb * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[w][r][d];
    const long long row =
        (((long long)b * a.Hkv + hk) * a.R + r0 + r) * a.nsplit + sp;
    a.part_o[row * D + d] = o;
    if (d == 0) {
      a.part_ml[row * 2] = ml[r][0];
      a.part_ml[row * 2 + 1] = ml[r][1];
    }
  }
}

__global__ void paged_combine_kernel(const PagedArgs a,
                                     __nv_bfloat16* __restrict__ out, int D) {
  const int row = blockIdx.x, d = threadIdx.x;
  const int b = row / (a.Hkv * a.R);
  const int kvl = max(1, min(a.kv_len[b], a.max_pages * a.page));
  const int ns = (kvl + kSplit - 1) / kSplit;
  const long long row0 = (long long)row * a.nsplit;
  out[(long long)row * D + d] = __float2bfloat16(ti::merge_splits(
      a.part_o + row0 * D, a.part_ml + row0 * 2, ns, D, d));
}

template <typename KV, int D, int RB>
void launch_split(const PagedArgs& a, int B, cudaStream_t stream) {
  dim3 grid(B, a.Hkv * ((a.R + RB - 1) / RB), a.nsplit);
  paged_split_kernel<KV, D, RB><<<grid, kThreads, 0, stream>>>(a);
}

template <typename KV, int D>
void launch_d(const PagedArgs& a, int B, cudaStream_t stream) {
  if (a.R <= 1)
    launch_split<KV, D, 1>(a, B, stream);
  else if (a.R <= 2)
    launch_split<KV, D, 2>(a, B, stream);
  else if (a.R <= 4)
    launch_split<KV, D, 4>(a, B, stream);
  else
    launch_split<KV, D, 8>(a, B, stream);
}

template <typename KV>
int launch_kv(const PagedArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch_d<KV, 32>(a, B, stream);
      return 0;
    case 64:
      launch_d<KV, 64>(a, B, stream);
      return 0;
    case 128:
      launch_d<KV, 128>(a, B, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// f32 scratch elements the call needs: per (b, kv head, row, slice) D
// outputs plus the slice's max and sum; cap = max_pages * page.
long long ti_paged_workspace(int B, int Hkv, int R, int cap, int D) {
  const long long nsplit = (cap + kSplit - 1) / kSplit;
  return (long long)B * Hkv * R * nsplit * (D + 2);
}

// q: bf16 [B, Hkv, R, D], R = G * Gh rows (row r is token r / Gh, head
// r % Gh of the group), strides q_strides = {qsb, qsh, qsr} and
// contiguous D; k_pages, v_pages: one layer's pool [P, Hkv, page, D]
// contiguous, of bf16 (kv_dtype 0), int8 codes (1) or float8_e4m3fn bits
// (2); k_scale, v_scale: for int8 the layer's f32 scale pages
// [P, Hkv, page] contiguous, else null; out: bf16 [B, Hkv, R, D]
// contiguous; table: int32 [B, max_pages]; kv_len: int32 [B] (the G
// chunk tokens included); work: ti_paged_workspace(...) f32 elements.
// D in {32, 64, 128}.
int ti_paged_attention(const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scale,
                       const void* v_scale, void* out, void* work,
                       const void* table, const void* kv_len, int B, int Hkv,
                       int R, int gh, int g_tokens, int P, int page,
                       int max_pages, int D, int kv_dtype,
                       const long long* q_strides, float scale, void* stream) {
  if (R <= 0 || gh <= 0 || R % gh || page <= 0 || P <= 0 || max_pages <= 0 ||
      kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.kv_len = static_cast<const int*>(kv_len);
  a.nsplit = (max_pages * page + kSplit - 1) / kSplit;
  a.part_o = static_cast<float*>(work);
  a.part_ml = a.part_o + (long long)B * Hkv * R * a.nsplit * D;
  a.qsb = q_strides[0];
  a.qsh = q_strides[1];
  a.qsr = q_strides[2];
  a.Hkv = Hkv;
  a.R = R;
  a.gh = gh;
  a.g_tokens = g_tokens;
  a.P = P;
  a.page = page;
  a.max_pages = max_pages;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = kv_dtype == 0   ? launch_kv<__nv_bfloat16>(a, B, D, st)
                  : kv_dtype == 1 ? launch_kv<int8_t>(a, B, D, st)
                                  : launch_kv<uint8_t>(a, B, D, st);
  if (bad) return bad;
  paged_combine_kernel<<<B * Hkv * R, D, 0, st>>>(
      a, static_cast<__nv_bfloat16*>(out), D);
  return ti::launch_status();
}

}  // extern "C"

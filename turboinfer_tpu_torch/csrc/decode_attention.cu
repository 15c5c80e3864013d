// decode_attention: one query per sequence against the first kv_len[b]
// rows of one layer of the head-major cache.
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/decode_attention.py
// decode_pallas (_decode, body _kernel) and decode_fused_pallas
// (_decode_fused, body _fused_kernel) for a bf16 cache, and
// decode_pallas's int8 (`scaled`) and fp8 (_load_kv, e4m3_to_bf16)
// reads of a compressed cache. The cache operand is layer li of the
// stacked [L, B, Hkv, T, D] cache, selected by the caller's pointer
// offset. kv_len is clamped to [1, T] as the JAX kernel clamps it to
// >= 1. The fused-head cache of decode_fused_pallas exists for TPU lane
// alignment; the port keeps this head-major layout and takes its
// semantics here: an optional window (keys [lo, kv_len) only, lo =
// max(kv_len - window, 0)) and optional per-head sink logits (softmax
// over [scores, sink], the sink adding no value). An optional softcap
// (Gemma-2) turns each scaled score s (times the int8 key scale) into
// cap * tanh(s / cap), as decode_pallas does before its mask; here only
// live rows are scored, so nothing is masked after it (ti::softcap, a
// few f32 ulps). The cap is a pass of its own over a sub-slice's scores
// in shared memory, in the kernels' kCap instances only (a template
// flag), so an uncapped call runs exactly the code it ran before.
//
// What bounds it on the H100: bytes, the 2 * (kv_len - lo) * D *
// itemsize bytes of K and V (plus 8 bytes of scales per int8 row) each
// (b, kv head) must read, over 3.35 TB/s. At a batch of 8 that is tens
// of MB and the card streams it; at batch 1 it is a few MB, under 2 us
// of bandwidth, and what costs is latency: each DRAM round trip, each
// dependent step, each launch. The design:
//  * One launch. A block owns one (b, kv head, slice of rows counted
//    from lo) and computes all gh query heads of the GQA group, so each
//    K/V row is read once for the whole group. A slice is one sub-slice
//    of R rows, or, past 64 of them a kv head (long contexts), S
//    sub-slices that the block reads in turn, folding each into a
//    running max, sum and output. plan_of picks R and S (the wrapper
//    sizes the scratch by ti_decode_workspace, which reads the same
//    plan). A 128-row window is one slice. Blocks past kv_len exit at
//    once.
//  * A sub-slice arrives whole, K and V in flight together: every thread
//    starts 16-byte cp.async copies of its share of the slice's K rows
//    (with the int8 scale rows), then of its V rows, as two groups;
//    scores start when K has landed while V is still on its way. K/V
//    rows of one (b, kv head) are contiguous, so the copies coalesce.
//  * A GQA group (gh 2..8, decode_gqa_kernel) runs on the tensor cores:
//    S^T = K Q^T and O^T = V^T P^T as mma.sync m16n8k16 bf16 products,
//    16 keys or 16 d by the group's heads (up to 8, padded), K and V^T
//    through ldmatrix from bf16 rows laid out with an XOR swizzle; 8-bit
//    rows are widened to bf16 in shared memory first (exact). The
//    probabilities enter P V as bf16, as the flash prefill's do. A lone
//    head (gh = 1, decode_row_kernel) runs on the CUDA cores: D / kE
//    lanes a row and 16-byte reads for the scores, then P V with each
//    thread owning kE outputs over a share of the rows.
//  * Head dim 96 (Phi-3), whose row is 12 16-byte chunks of bf16 or 6 of
//    8-bit codes: the lone head's score lanes come in groups of 16 (or
//    8), the chunks in the first 12 (or 6) and zeros in the rest, so the
//    butterfly that sums a row never reaches into its neighbour's lanes;
//    P V takes floor(128 / 12) = 10 (or 21) row groups and the 8 (or 2)
//    threads left over sit out (attention.cuh RowLanes). The tensor-core
//    kernel's swizzle keeps chunks 8-11 of a row inside it
//    (attention.cuh swz).
//  * The merge rides the same launch. Each block writes its unnormalised
//    output with its max and sum, and counts itself in an arrival counter
//    of its (b, kv head); the last block to arrive merges the slices in
//    slice order (so repeat calls give the same bits, whichever block is
//    last) and zeroes the counter again. A slice alone (kv_len - lo <= R)
//    skips the partials and writes its output directly. The sink enters
//    the merge once, as a partial with max = sink, sum = 1 and no value.
//    The merge runs one warp a head pair, its weights in the dead K
//    rows: no shared memory of its own, so none grows with T.
//
// int8 and fp8 caches: the rows arrive as stored. fp8 bits decode as
// e4m3_to_bf16 reads them (0x7F/0xFF as +-480); int8 codes are exact,
// and the scales ride the score and probability rows as in the Pallas
// body: scores times the key row's scale after q.k, probabilities times
// the value row's scale before P V, the denominator summing the
// unscaled probabilities.
#include "attention.cuh"

namespace {

using namespace ti::attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8;            // query heads an mma column tile holds

// The sub-slice's rows into shared memory as two cp.async groups in
// flight together: K rows with both int8 scale rows, then V rows; rows
// n .. R - 1 are zero-filled. chunk(t, c) places 16-byte chunk c of row t.
template <typename KV, int D, typename Chunk>
__device__ __forceinline__ void load_slice(
    const KV* kc, const KV* vc, const float* ks, const float* vs,
    long long cbase, const Slice& sl, int R, unsigned char* dk,
    unsigned char* dv, float* sks, float* svs, Chunk chunk) {
  constexpr int kCpr = D * static_cast<int>(sizeof(KV)) / 16;   // chunks a row
  const long long srow = cbase / D + sl.t0;                     // scale row
  for (int h = 0; h < 2; ++h) {
    const unsigned char* g = reinterpret_cast<const unsigned char*>(
        (h ? vc : kc) + cbase + (long long)sl.t0 * D);
    for (int i = threadIdx.x; i < R * kCpr; i += kThreads) {
      const int t = i / kCpr;
      ti::async_copy<16>((h ? dv : dk) + 16 * chunk(t, i % kCpr), g + i * 16,
                         t < sl.n ? 16 : 0);
    }
    if (h == 0 && ks)
      for (int i = threadIdx.x; i < R; i += kThreads) {
        const int t = min(i, sl.n - 1), bytes = i < sl.n ? 4 : 0;
        ti::async_copy<4>(sks + i, ks + srow + t, bytes);
        ti::async_copy<4>(svs + i, vs + srow + t, bytes);
      }
    ti::async_commit();
  }
}

// One head row's output d from the slice's unnormalised o and its (max,
// sum) (m, l): out directly for a lone slice (the sink entering once),
// else the slice's partial.
__device__ __forceinline__ void emit(float o, float m, float l, long long row,
                                     int d, int D, int s, const Slice& sl,
                                     int nslices, int Hq,
                                     const float* sinks, float* po,
                                     float* pml, __nv_bfloat16* out) {
  if (sl.nlive == 1) {
    const float m0 = sinks ? sinks[row % Hq] : ti::kNegInf;
    const float mx = fmaxf(m0, m), w = __expf(m - mx);
    const float den = (sinks ? __expf(m0 - mx) : 0.f) + w * l;
    out[row * D + d] = __float2bfloat16(o * w / fmaxf(den, 1e-30f));
  } else {
    po[(row * nslices + s) * D + d] = o;
    if (d == 0) {
      pml[(row * nslices + s) * 2] = m;
      pml[(row * nslices + s) * 2 + 1] = l;
    }
  }
}

// The last block of a (b, kv head) merges its heads' nlive slices (at
// most 64, plan_of) in slice order, each warp its heads w and w + 4 at
// once: lanes j and j + 32 hold slice j's and j + 32's (max, sum); the
// warp finds the largest max (and the sink) and the total of the
// rescaled sums, turns them into weights exp(m_j - mx) / l in its own
// rows of wts, and its lanes sum the outputs, 4 a lane per unit, over
// the slices in order with independent loads. wts is the block's K rows,
// dead by now (at least 2 KB; a lone head uses 256 bytes of it), so the
// merge adds no shared memory and nothing grows with T; no block-wide
// barrier. Thread 0 zeroes the counter for the next launch.
constexpr int kHpw = kHeads / kWarps;   // heads a warp merges
constexpr int kMaxSlices = 64;          // two a lane
constexpr int kWtsRow = kMaxSlices + 1;  // a head's weights (+1: banks)
static_assert(kHpw == 2, "a warp merges two heads");
static_assert(kWarps * kHpw * kWtsRow * 4 <= 128 * 32,
              "the weights fit a GQA block's K rows");

__device__ __forceinline__ void merge_slices(
    const float* po, const float* pml, const float* sinks,
    __nv_bfloat16* out, int* counter, float* wts, long long row0, int gh,
    int D, int nslices, int nlive, int Hq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) *counter = 0;
  if (warp >= gh) return;
  float* ww = wts + warp * kHpw * kWtsRow;   // this warp's heads
#pragma unroll
  for (int k = 0; k < kHpw; ++k) {
    const int h = warp + k * kWarps;
    if (h >= gh) continue;
    const long long row = row0 + h;
    const float2* pm = reinterpret_cast<const float2*>(pml) + row * nslices;
    const float m0 = sinks ? sinks[row % Hq] : ti::kNegInf;
    const float2 none = make_float2(ti::kNegInf, 0.f);
    const float2 a = lane < nlive ? __ldcg(pm + lane) : none;
    const float2 c = lane + 32 < nlive ? __ldcg(pm + lane + 32) : none;
    const float mx = ti::warp_max(fmaxf(m0, fmaxf(a.x, c.x)));
    const float ea = __expf(a.x - mx), ec = __expf(c.x - mx);
    const float l = ti::warp_sum(ea * a.y + ec * c.y) +
                    (sinks ? __expf(m0 - mx) : 0.f);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    ww[k * kWtsRow + lane] = ea * inv;
    ww[k * kWtsRow + lane + 32] = ec * inv;
  }
  __syncwarp();
  // unit u = lane + 32 i: head k = u / (D / 4), outputs 4 (u % (D / 4));
  // kHpw heads of at most 256 outputs are 4 units a lane
  const int units = D / 4;
#pragma unroll
  for (int i = 0; i < kHpw * 256 / 4 / 32; ++i) {
    const int u = lane + 32 * i, k = u / units, d = (u % units) * 4;
    const int h = warp + k * kWarps;
    if (k >= kHpw || h >= gh) break;
    const float4* pv = reinterpret_cast<const float4*>(
        po + (row0 + h) * nslices * D + d);
    const float* wr = ww + k * kWtsRow;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < nlive; ++j) {
      const float wt = wr[j];
      const float4 v = __ldcg(pv + (long long)j * units);
      o.x = fmaf(wt, v.x, o.x);
      o.y = fmaf(wt, v.y, o.y);
      o.z = fmaf(wt, v.z, o.z);
      o.w = fmaf(wt, v.w, o.w);
    }
    __nv_bfloat162* op =
        reinterpret_cast<__nv_bfloat162*>(out + (row0 + h) * D + d);
    op[0] = __floats2bfloat162_rn(o.x, o.y);
    op[1] = __floats2bfloat162_rn(o.z, o.w);
  }
}

struct Params {
  const __nv_bfloat16* q;
  const float *ks, *vs, *sinks;
  float *po, *pml;
  int* counters;
  const int* kv_len;
  __nv_bfloat16* out;
  int Hq, Hkv, T, gh, R, S, nslices, window;
  long long qsb, qsh, csb, csh;
  float scale;
  float softcap, cap2;   // softcap (0: none) and 2 log2(e) / softcap
};

// ---- one query head a kv head (gh = 1): the CUDA cores ----------------

// Shared memory at R rows: K and V rows, the int8 scales, scores [R],
// the P V sums of the row groups, max and sum.
template <typename KV, int D>
struct RowLayout {
  static constexpr int kE = 16 / static_cast<int>(sizeof(KV));
  __host__ __device__ static constexpr int kv(int R) {
    return R * D * static_cast<int>(sizeof(KV));
  }
  __host__ __device__ static constexpr int ks(int R) { return 2 * kv(R); }
  __host__ __device__ static constexpr int sc(int R) { return ks(R) + 8 * R; }
  __host__ __device__ static constexpr int red(int R) { return sc(R) + 4 * R; }
  __host__ __device__ static constexpr int ml(int R) {
    return red(R) + kThreads * kE * 4;
  }
  __host__ __device__ static constexpr int total(int R) { return ml(R) + 16; }
};

template <typename KV, int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_row_kernel(const KV* __restrict__ kc, const KV* __restrict__ vc,
                  Params p) {
  using L = RowLayout<KV, D>;
  constexpr int kE = L::kE;                    // elements per 16 bytes
  constexpr int kRowB = D * static_cast<int>(sizeof(KV));
  using RL = RowLanes<D, kE, kThreads>;
  constexpr int kLpr = RL::kLpr;               // chunks a row (P V)
  constexpr int kGrp = RL::kGrp;               // lanes a row (scores)
  constexpr int kRpw = RL::kRpw;               // rows per warp pass
  constexpr int kGroups = RL::kGroups;         // row groups of P V
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::kv(p.R);
  float* sKs = reinterpret_cast<float*>(smem + L::ks(p.R));
  float* sVs = sKs + p.R;
  float* sc = reinterpret_cast<float*>(smem + L::sc(p.R));
  float* red = reinterpret_cast<float*>(smem + L::red(p.R));
  float* ml = reinterpret_cast<float*>(smem + L::ml(p.R));
  int* flag = reinterpret_cast<int*>(ml + 2);

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lrow = lane / kGrp, dl = (lane % kGrp) * kE;
  const bool live = kGrp == kLpr || dl < D;    // the lane holds a chunk
  float qf[kE];   // in flight beside kv_len's load
  ti::load_bf16_row<kE>(p.q + b * p.qsb + hk * p.qsh + (live ? dl : 0),
                        qf);
  if (!live)
#pragma unroll
    for (int e = 0; e < kE; ++e) qf[e] = 0.f;
  Slice sl;
  if (!slice_of(p.kv_len, b, s, p.T, p.window, p.R, p.S, sl)) return;
  const long long cbase = b * p.csb + hk * p.csh;
  const int c = tid % kLpr, rg = tid / kLpr;
  const bool pv = kThreads % kLpr == 0 || rg < kGroups;   // a P V thread
  // the slice's running max, sum and outputs d = tid + kThreads j
  constexpr int kOut = (D + kThreads - 1) / kThreads;
  float M = ti::kNegInf, Lsum = 0.f, O[kOut] = {};
  do {
    __syncthreads();   // the last sub-slice's rows are read
    load_slice<KV, D>(kc, vc, p.ks, p.vs, cbase, sl, p.R, sK, sV, sKs, sVs,
                      [](int t, int c) { return t * (kRowB / 16) + c; });
    ti::async_wait<1>();
    __syncthreads();

    // Scores (int8: times the key row's scale).
    for (int base = warp * kRpw; base < sl.n; base += kWarps * kRpw) {
      const int t = base + lrow;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (t < sl.n && live)
        u = *reinterpret_cast<const uint4*>(sK + t * kRowB +
                                            dl * static_cast<int>(sizeof(KV)));
      float kf[kE];
      ti::kv16_to_float<KV>(u, kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
      for (int off = kGrp / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (t < sl.n && (lane % kGrp) == 0)
        sc[t] = p.ks ? d * p.scale * sKs[t] : d * p.scale;
    }
    __syncthreads();

    // Softcap, max, exp and sum, one warp, while V may still be in flight.
    if (warp == 0) {
      if constexpr (kCap) cap_scores(sc, sl.n, p.softcap, p.cap2, lane);
      float mx = ti::kNegInf;
      for (int i = lane; i < sl.n; i += 32) mx = fmaxf(mx, sc[i]);
      mx = ti::warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < sl.n; i += 32) {
        const float e = __expf(sc[i] - mx);
        sc[i] = e;
        sum += e;
      }
      sum = ti::warp_sum(sum);
      if (lane == 0) {
        ml[0] = mx;
        ml[1] = sum;
      }
    }
    ti::async_wait<0>();
    __syncthreads();

    // Unnormalised P V: thread (row group rg, chunk c) sums kE outputs over
    // rows rg, rg + kGroups, ... (int8: the value row's scale folded into
    // each probability); the groups meet in red[rg][d].
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int t = rg; pv && t < sl.n; t += kGroups) {
      const float pr = p.vs ? sc[t] * sVs[t] : sc[t];
      float vf[kE];
      ti::kv16_to_float<KV>(
          *reinterpret_cast<const uint4*>(sV + t * kRowB + c * 16), vf);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
    }
    float4* rv = reinterpret_cast<float4*>(red + rg * D + c * kE);
    if (pv)
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        rv[e / 4] = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    __syncthreads();
    if (tid < D) {
      const float2 f = fold(M, Lsum, ml[0], ml[1]);
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        float o = 0.f;
#pragma unroll
        for (int r = 0; r < kGroups; ++r) o += red[r * D + tid + kThreads * j];
        O[j] = f.x * O[j] + f.y * o;
      }
    }
  } while (sl.next(p.R));
  const long long row = (long long)b * p.Hq + hk;
  if (tid < D)
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      emit(O[j], M, Lsum, row, tid + kThreads * j, D, s, sl, p.nslices, p.Hq,
           p.sinks, p.po, p.pml, p.out);
  if (sl.nlive == 1 ||
      !ti::last_to_arrive(p.counters + (long long)b * p.Hkv + hk, sl.nlive,
                          flag))
    return;
  merge_slices(p.po, p.pml, p.sinks, p.out,
               p.counters + (long long)b * p.Hkv + hk,
               reinterpret_cast<float*>(smem), row, 1, D, p.nslices,
               sl.nlive, p.Hq);
}

// ---- a GQA group (gh = 2..8): the tensor cores -------------------------

// Shared memory at R rows: the K and V rows as copied (8-bit caches
// only), their bf16 form (bf16 rows are copied straight into it; K's
// buffer is reused for V's), the int8 scales, scores [8][R + 4] f32,
// probabilities [8][R + 8] bf16, the heads' max and sum.
template <typename KV, int D>
struct GqaLayout {
  static constexpr bool k8 = sizeof(KV) == 1;
  __host__ __device__ static constexpr int raw(int R) { return k8 ? R * D : 0; }
  __host__ __device__ static constexpr int kb(int R) { return 2 * raw(R); }
  __host__ __device__ static constexpr int vb(int R) {
    return kb(R) + (k8 ? 0 : R * D * 2);
  }
  __host__ __device__ static constexpr int ks(int R) {
    return vb(R) + R * D * 2;
  }
  __host__ __device__ static constexpr int sc(int R) { return ks(R) + 8 * R; }
  __host__ __device__ static constexpr int p(int R) {
    return sc(R) + kHeads * (R + 4) * 4;
  }
  __host__ __device__ static constexpr int ml(int R) {
    return p(R) + kHeads * (R + 8) * 2;
  }
  __host__ __device__ static constexpr int total(int R) {
    return ml(R) + kHeads * 8 + 16;
  }
};

template <typename KV, int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_gqa_kernel(const KV* __restrict__ kc, const KV* __restrict__ vc,
                  Params p) {
  using L = GqaLayout<KV, D>;
  constexpr int kDs = D / 16;                  // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.R;
  unsigned char* sK = smem;                    // 8-bit rows as copied
  unsigned char* sV = smem + L::raw(R);
  uint4* kb = reinterpret_cast<uint4*>(smem + L::kb(R));   // bf16, swizzled
  uint4* vb = reinterpret_cast<uint4*>(smem + L::vb(R));
  float* sKs = reinterpret_cast<float*>(smem + L::ks(R));
  float* sVs = sKs + R;
  float* sc = reinterpret_cast<float*>(smem + L::sc(R));  // [8][R + 4]
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + L::p(R));
  float* ml = reinterpret_cast<float*>(smem + L::ml(R));   // [8][2]
  int* flag = reinterpret_cast<int*>(ml + 2 * kHeads);

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, gh = p.gh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, q4 = lane & 3;

  // The query heads as the B operand of S^T = K Q^T: head gi, d = 16 k +
  // 2 q4 (+ 1) and + 8; heads past gh are zeros. In flight beside
  // kv_len's load.
  uint32_t qb[kDs][2];
#pragma unroll
  for (int k = 0; k < kDs; ++k) qb[k][0] = qb[k][1] = 0u;
  if (gi < gh) {
    const __nv_bfloat16* qr = p.q + b * p.qsb + (hk * gh + gi) * p.qsh;
#pragma unroll
    for (int k = 0; k < kDs; ++k) {
      qb[k][0] = *reinterpret_cast<const uint32_t*>(qr + 16 * k + 2 * q4);
      qb[k][1] = *reinterpret_cast<const uint32_t*>(qr + 16 * k + 2 * q4 + 8);
    }
  }
  Slice sl;
  if (!slice_of(p.kv_len, b, s, p.T, p.window, R, p.S, sl)) return;
  const long long cbase = b * p.csb + hk * p.csh;
  // The slice's unnormalised outputs (this thread's elements of the
  // warp's d tiles) and its running (max, sum) of heads 2 q4, 2 q4 + 1.
  constexpr int kDt = (D / 16 + kWarps - 1) / kWarps;   // d tiles a warp
  float O[kDt][4], M[2] = {ti::kNegInf, ti::kNegInf}, Lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kDt; ++k) O[k][0] = O[k][1] = O[k][2] = O[k][3] = 0.f;
  do {
    __syncthreads();   // the last sub-slice's rows are read
    // bf16 rows go straight to their swizzled places
    if constexpr (L::k8)
      load_slice<KV, D>(kc, vc, p.ks, p.vs, cbase, sl, R, sK, sV, sKs, sVs,
                        [](int t, int c) { return t * (D / 16) + c; });
    else
      load_slice<KV, D>(kc, vc, p.ks, p.vs, cbase, sl, R,
                        reinterpret_cast<unsigned char*>(kb),
                        reinterpret_cast<unsigned char*>(vb), sKs, sVs,
                        [](int t, int c) { return swz<D>(t, c); });
    ti::async_wait<1>();
    __syncthreads();
    if constexpr (L::k8) {
      widen<KV, D>(sK, kb, R);
      __syncthreads();
    }

    // Scores S^T[t][h] = K[t] . q[h]: warp w takes key tiles w, w + 4, ...
    // (16 keys), all D; times scale (int8: and the key row's scale) into
    // sc[h][t].
    for (int mt = warp; mt < R / 16; mt += kWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kDs; ++k) {
        // A = K rows 16 mt .. + 16, d 16 k .. + 16: matrices (rows 0-7, d
        // 0-7), (rows 8-15, d 0-7), (rows 0-7, d 8-15), (rows 8-15, d 8-15)
        const int r = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t a[4];
        ldmatrix_x4(a, kb + swz<D>(r, 2 * k + (lane >> 4)), false);
        ti::mma_bf16(acc, a, qb[k][0], qb[k][1]);
      }
      // acc: key 16 mt + gi (+ 8 for e >= 2), head 2 q4 + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + gi + (e >> 1) * 8, h = 2 * q4 + (e & 1);
        sc[h * (R + 4) + t] =
            p.ks ? acc[e] * p.scale * sKs[t] : acc[e] * p.scale;
      }
    }
    ti::async_wait<0>();
    __syncthreads();
    if constexpr (L::k8) widen<KV, D>(sV, vb, R);   // over K's bf16 rows

    // Softcap, max, exp and sum per head, one warp a head; the
    // probabilities go to sp[h][t] as bf16, int8 with the value row's
    // scale folded in (the sum takes them unscaled); rows past n and heads
    // past gh are zeros.
    for (int h = warp; h < kHeads; h += kWarps) {
      float* row = sc + h * (R + 4);
      __nv_bfloat16* prow = sp + h * (R + 8);
      if (h >= gh) {
        for (int i = lane; i < R; i += 32) prow[i] = __float2bfloat16(0.f);
        continue;
      }
      if constexpr (kCap) cap_scores(row, sl.n, p.softcap, p.cap2, lane);
      float mx = ti::kNegInf;
      for (int i = lane; i < sl.n; i += 32) mx = fmaxf(mx, row[i]);
      mx = ti::warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < R; i += 32) {
        const float e = i < sl.n ? __expf(row[i] - mx) : 0.f;
        sum += e;
        prow[i] = __float2bfloat16(p.vs ? e * sVs[i] : e);
      }
      sum = ti::warp_sum(sum);
      if (lane == 0) {
        ml[2 * h] = mx;
        ml[2 * h + 1] = sum;
      }
    }
    __syncthreads();
    float2 f[2];        // heads 2 q4 (+ 1): the sub-slice folded in
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = 2 * q4 + i;
      f[i] = h < gh ? fold(M[i], Lsum[i], ml[2 * h], ml[2 * h + 1])
                    : make_float2(0.f, 0.f);
    }

    // O^T[d][h] = sum_t V^T[d][t] P^T[t][h]: warp w takes d tiles w, w + 4
    // (16 d), all keys; A = V^T through ldmatrix.trans, B = P^T from sp.
#pragma unroll
    for (int k = 0; k < kDt; ++k) {
      const int dt = warp + k * kWarps;
      if (dt >= D / 16) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kt = 0; kt < R / 16; ++kt) {
        // matrices: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d
        // 0-7), (keys 8-15, d 8-15) of the tile
        const int r = 16 * kt + (lane & 7) + ((lane >> 4) << 3);
        uint32_t a[4];
        ldmatrix_x4(a, vb + swz<D>(r, 2 * dt + ((lane >> 3) & 1)), true);
        const __nv_bfloat16* pr = sp + gi * (R + 8) + 16 * kt + 2 * q4;
        ti::mma_bf16(acc, a, *reinterpret_cast<const uint32_t*>(pr),
                 *reinterpret_cast<const uint32_t*>(pr + 8));
      }
      // acc: d = 16 dt + gi (+ 8 for e >= 2), head 2 q4 + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        O[k][e] = f[e & 1].x * O[k][e] + f[e & 1].y * acc[e];
    }
  } while (sl.next(R));
  const long long row0 = (long long)b * p.Hq + hk * gh;   // first head row
#pragma unroll
  for (int k = 0; k < kDt; ++k) {
    const int dt = warp + k * kWarps;
    if (dt >= D / 16) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = 2 * q4 + (e & 1), d = 16 * dt + gi + (e >> 1) * 8;
      if (h < gh)
        emit(O[k][e], M[e & 1], Lsum[e & 1], row0 + h, d, D, s, sl,
             p.nslices, p.Hq, p.sinks, p.po, p.pml, p.out);
    }
  }
  if (sl.nlive == 1 ||
      !ti::last_to_arrive(p.counters + (long long)b * p.Hkv + hk, sl.nlive,
                          flag))
    return;
  merge_slices(p.po, p.pml, p.sinks, p.out,
               p.counters + (long long)b * p.Hkv + hk,
               reinterpret_cast<float*>(smem), row0, gh, D, p.nslices,
               sl.nlive, p.Hq);
}

template <typename KV, int D, bool kCap>
int launch_c(const void* kc, const void* vc, const Params& p, int B,
             cudaStream_t stream) {
  const dim3 grid(p.nslices, p.Hkv, B);
  const bool rows = p.gh == 1;
  const int smem = rows ? RowLayout<KV, D>::total(p.R)
                        : GqaLayout<KV, D>::total(p.R);
  auto rk = decode_row_kernel<KV, D, kCap>;
  auto gk = decode_gqa_kernel<KV, D, kCap>;
  constexpr int kSmemMax = 227 * 1024;
  static const int allowed = ti::allow_smem(rk, kSmemMax) |
                             ti::allow_smem(gk, kSmemMax);
  if (allowed || smem > kSmemMax)
    return allowed ? allowed : static_cast<int>(cudaErrorInvalidValue);
  if (rows)
    rk<<<grid, kThreads, smem, stream>>>(static_cast<const KV*>(kc),
                                          static_cast<const KV*>(vc), p);
  else
    gk<<<grid, kThreads, smem, stream>>>(static_cast<const KV*>(kc),
                                          static_cast<const KV*>(vc), p);
  return 0;
}

template <typename KV, int D>
int launch_d(const void* kc, const void* vc, const Params& p, int B,
             cudaStream_t stream) {
  return p.softcap > 0.f ? launch_c<KV, D, true>(kc, vc, p, B, stream)
                         : launch_c<KV, D, false>(kc, vc, p, B, stream);
}

template <typename KV>
int launch_kv(const void* kc, const void* vc, const Params& p, int B, int D,
              cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<KV, 32>(kc, vc, p, B, stream);
    case 64:
      return launch_d<KV, 64>(kc, vc, p, B, stream);
    case 96:
      return launch_d<KV, 96>(kc, vc, p, B, stream);
    case 128:
      return launch_d<KV, 128>(kc, vc, p, B, stream);
    case 256:
      return launch_d<KV, 256>(kc, vc, p, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The slice plan: a block's slice is S sub-slices of R rows, counted
// from lo, and the grid holds nslices slices, enough for the live rows
// [lo, kv_len) of a (b, kv head), at most min(window, T) of them. A GQA
// group (the tensor-core kernel) reads 128 rows a sub-slice (64 at D =
// 256, so a block's shared memory stays that of D = 128: two bf16 K/V
// tiles of 32 KB each), a lone head (the CUDA-core kernel) 64, as
// measured on the H100. A slice is one sub-slice up to kMaxSlices of
// them a kv head; past that (long contexts) each block loops over S
// sub-slices, so the last block's merge never weighs more than
// kMaxSlices partials. Blocks past kv_len
// exit at once.

struct Plan {
  int rows, S, nslices;
};

Plan plan_of(int Hq, int Hkv, int T, int D, int window) {
  const int span = window > 0 && window < T ? window : T;
  const int rows = Hq > Hkv && D <= 128 ? 128 : 64;
  const int sub = (span + rows - 1) / rows;
  const int S = (sub + kMaxSlices - 1) / kMaxSlices;
  return {rows, S, (sub + S - 1) / S};
}

}  // namespace

extern "C" {

// f32 scratch elements a call needs: per (b, query head, slice) its D
// unnormalised outputs and its max and sum; 0 when one slice covers
// every live row (nothing to merge).
long long ti_decode_workspace(int B, int Hq, int Hkv, int T, int D,
                              int window) {
  const Plan pl = plan_of(Hq, Hkv, T, D, window);
  return pl.nslices > 1 ? (long long)B * Hq * pl.nslices * (D + 2) : 0;
}

// q: bf16 [B, Hq, D] with strides {qsb, qsh}; k_cache, v_cache: the
// [B, Hkv, T, D] plane of layer li with strides {csb, csh} (elements)
// and contiguous [T, D] rows, of bf16 (kv_dtype 0), int8 codes (1) or
// float8_e4m3fn bits (2); k_scale, v_scale: for int8, the f32 [B, Hkv, T]
// scale planes of layer li laid out as the cache's rows, else null;
// out: bf16 [B, Hq, D] contiguous; kv_len: int32 [B] on the device;
// sinks: f32 [Hq] on the device, or null; window: rows before kv_len -
// window are masked, 0 for none; work: ti_decode_workspace(B, Hq, Hkv,
// T, D, window) f32 elements; counters: B * Hkv int32 zeros, left
// zeros. strides = {qsb, qsh, csb, csh}. D in {32, 64, 96, 128, 256};
// Hq / Hkv <= 8. softcap: scores s become softcap * tanh(s / softcap), 0
// for none.
int ti_decode_attention(const void* q, const void* k_cache,
                        const void* v_cache, const void* k_scale,
                        const void* v_scale, void* out, void* work,
                        void* counters, const void* kv_len, const void* sinks,
                        int B, int Hq, int Hkv, int T, int D, int kv_dtype,
                        int window, const long long* strides, float scale,
                        float softcap, void* stream) {
  const int gh = Hq / Hkv;
  if (gh > 8 || Hq % Hkv || window < 0 || !(softcap >= 0.f) ||
      kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_of(Hq, Hkv, T, D, window);
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const float*>(sinks),
           static_cast<float*>(work),
           static_cast<float*>(work) + (long long)B * Hq * pl.nslices * D,
           static_cast<int*>(counters),
           static_cast<const int*>(kv_len),
           static_cast<__nv_bfloat16*>(out),
           Hq, Hkv, T, gh, pl.rows, pl.S, pl.nslices, window,
           strides[0], strides[1], strides[2], strides[3], scale,
           softcap, softcap > 0.f ? 2.8853900817779268f / softcap : 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad =
      kv_dtype == 0   ? launch_kv<__nv_bfloat16>(k_cache, v_cache, p, B, D, st)
      : kv_dtype == 1 ? launch_kv<int8_t>(k_cache, v_cache, p, B, D, st)
                      : launch_kv<uint8_t>(k_cache, v_cache, p, B, D, st);
  if (bad) return bad;
  return ti::launch_status();
}

}  // extern "C"

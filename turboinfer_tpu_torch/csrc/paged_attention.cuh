// paged_attention: G query tokens per sequence attend that sequence's
// cache through its block table over one layer of the page pool. The
// kernel templates live here; one source per K/V storage type
// instantiates them (paged_attention.cu: bf16 and the C interface,
// paged_attention_int8.cu, paged_attention_fp8.cu), so the three compile
// side by side.
//
// Replaces the TPU kernels turboinfer_tpu/kernels/pallas/paged_attention.py
// paged_decode_pallas (G = 1) and paged_verify_pallas (G = spec_k + 1),
// which are one Pallas body (_paged_decode, _kernel) at g_tokens = 1 and
// g_tokens = G, for a bf16, int8 (with scale pages) or fp8 (uint8 e4m3
// bits) pool. The pool operand is layer li of the stacked
// [L, P, Hkv, page, D] pool, selected by the caller's pointer offset.
// Page ids are clamped to [0, P-1] (unassigned -1 rows read page 0, never
// page P-1) and kv_len to [1, max_pages * page], as the JAX kernel clamps
// them. Query row r of a kv head belongs to token g = r / gh, sits at
// position kv_len - G + g, and sees keys col <= that position; a row that
// sees no key stays finite (it averages its keys; the caller discards it).
// With a window (Mistral, Gemma-2's local layers) it sees only keys col >
// position - window, and with a softcap (Gemma-2) each scaled score s
// (times the int8 key scale) becomes cap * tanh(s / cap) before the mask,
// as in the Pallas body (ti::softcap, a few f32 ulps), in a pass of its
// own over the scores. Both run only in the kernels' kMask instances (a
// template flag, for calls with a window or a softcap), so a call with
// neither runs exactly the code it ran before they existed.
//
// What bounds it on the H100: bytes, the 2 * kv_len * D * itemsize bytes
// of K and V (plus 8 bytes of scales per int8 row) each (b, kv head)
// must read through its table, over 3.35 TB/s; pages at or past
// ceil(kv_len / page) are never read, so the cost follows the fill, not
// the pool. At serving batches that is a few MB and what costs is
// latency: launches, dependent loads, DRAM round trips. The design is
// decode_attention.cu's, read through the block table:
//  * One launch. A block owns one (b, kv head, slice of keys) and every
//    query row of that kv head: R = G * gh rows, up to 16 * 8 = 128. A
//    slice is one sub-slice of 128 keys (64 for R = 1 or D = 256), or,
//    past 64
//    slices a kv head, S sub-slices the block reads in turn, folding
//    each into a running max, sum and output. plan_of picks the slices
//    from the pool's capacity and the shapes alone (the wrapper sizes the
//    scratch by ti_paged_workspace, which reads the same plan, and never
//    reads kv_len on the host); blocks past kv_len exit at once. Each
//    block writes its unnormalised output with its max and sum and counts
//    itself in an arrival counter of its (b, kv head); the last block to
//    arrive merges the slices in slice order (repeat calls give the same
//    bits), 16 rows at a time over all its threads, and zeroes the
//    counter. A lone slice writes its output directly. With a window the
//    slices count from the earliest query's first visible key, lo =
//    kv_len - G + 1 - window (JAX's lo), so the blocks of slices wholly
//    below it exit with the others past kv_len and the plan still
//    follows the capacity alone; a block looks its first rows up again
//    once kv_len is read. A later query's rows may see none of a slice's
//    keys: their max stays -1e30 (finite, as the Pallas body's mask), so
//    the merge weighs that slice by exp(-1e30 - m) = 0.
//  * Paged loads in flight, K and V together. Before a sub-slice's copies
//    start, each thread looks up one key row's pool row through the table
//    (one lookup per 128 rows at 256-token pages; those of the next
//    sub-slice are read while this one computes) into shared memory. Then
//    every thread issues 16-byte cp.async copies of its share of the K
//    rows with the int8 scale rows, and of the V rows as a second group;
//    scores start when K has landed.
//  * R >= 2 runs on the tensor cores (paged_tc_kernel): S^T = K Q^T and
//    O^T = V^T P^T as mma.sync m16n8k16 bf16 products, 16 keys or 16 d by
//    8 query rows, K and V^T through ldmatrix from bf16 rows laid out
//    with an XOR swizzle (8-bit rows widened to bf16 in shared memory
//    first, exactly), the queries from a swizzled tile. A block takes its
//    rows in chunks of 8, 16 or 32 (the template's NT n-tiles of 8) over
//    the same staged sub-slice, so K and V leave device memory once per
//    (b, kv head) for every R; with more than one chunk and more than one
//    sub-slice, the chunks' running outputs wait in shared memory. The
//    softmax stays in the score registers: a row's max and sum over a
//    warp's keys meet the other warps' in shared memory. The
//    probabilities enter P V as bf16, as in the decode and flash kernels.
//    The causal mask is tested only in a sub-slice past kv_len - G, the
//    window's only in one before the latest query's first visible key.
//  * R = 1 (a lone head's decode, paged_row_kernel) runs on the CUDA
//    cores: D / kE lanes a key row and 16-byte reads for the scores, then
//    P V with each thread owning kE outputs over a share of the rows. At
//    head dim 96 (Phi-3) a row's lanes are padded to a power of two and
//    the leftover P V threads sit out, as in decode_attention.cu, and the
//    tensor-core kernel's swizzle keeps a row's 12 chunks inside it
//    (attention.cuh RowLanes, swz).
//
// int8 and fp8 pools: the rows arrive as stored. fp8 bits decode as
// e4m3_to_bf16 reads them (0x7F/0xFF as +-480); int8 codes are exact, and
// the scales ride the score and probability rows as in the Pallas body:
// scores times the key row's scale after q.k, probabilities times the
// value row's scale before P V, the denominator summing the unscaled
// probabilities. Each scale is read through the row's own clamped table
// entry. Pages are multiples of 8 up to 256.
#pragma once

#include <climits>

#include "attention.cuh"

namespace ti {
namespace paged {

using namespace ti::attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowRows = 64;            // keys a sub-slice, R = 1
constexpr int kMaxSlices = 64;          // slices a kv head (two a lane)
constexpr int kWtsRow = kMaxSlices + 1;  // a row's merge weights (+1: banks)
constexpr int kSmemMax = 227 * 1024;

// Keys a sub-slice for R >= 2: 128, 64 at D = 256 (so the bf16 K and V
// tiles stay 32 KB each, as at D = 128).
constexpr int tc_rows(int D) { return D > 128 ? 64 : 128; }
static_assert(tc_rows(32) <= kThreads, "a thread looks up one key row");

struct Params {
  const __nv_bfloat16* q;   // [B, Hkv, R, D], strides {qsb, qsh, qsr}
  const float *ks, *vs;     // int8: the layer's scale pages [P, Hkv, page]
  const int* table;         // [B, max_pages]
  const int* kv_len;        // [B]
  float *po, *pml;          // slice partials [B, Hkv, R, nslices, D | 2]
  int* counters;            // [B, Hkv]
  __nv_bfloat16* out;       // [B, Hkv, R, D]
  long long qsb, qsh, qsr;
  int Hkv, R, gh, G, P, page, max_pages, cap, S, nslices;
  float scale;
  int window;            // keys col <= position - window masked; 0: none
  float softcap, cap2;   // softcap (0: none) and 2 log2(e) / softcap
};

// Row of the layer's pool [P, Hkv, page] that holds key t of sequence b,
// kv head hk: the page id read from the table and clamped into the pool
// (t past the table reads a valid row; such rows are never copied).
__device__ __forceinline__ int pool_row(const Params& p, int b, int hk, int t) {
  const int i = min(t / p.page, p.max_pages - 1);
  const int off = min(t - i * p.page, p.page - 1);
  const int pid = min(max(__ldg(p.table + (long long)b * p.max_pages + i), 0),
                      p.P - 1);
  return (pid * p.Hkv + hk) * p.page + off;
}

// The sub-slice's rows (pool rows srow[0 .. R)) into shared memory as two
// cp.async groups in flight together: K rows with both int8 scale rows
// (and any copies the caller issued before), then V rows; rows n .. R - 1
// are zero-filled. chunk(t, c) places 16-byte chunk c of row t.
template <typename KV, int D, typename Chunk>
__device__ __forceinline__ void load_rows(
    const KV* kp, const KV* vp, const float* ks, const float* vs,
    const int* srow, int n, int R, unsigned char* dk, unsigned char* dv,
    float* sks, float* svs, Chunk chunk) {
  constexpr int kRowB = D * static_cast<int>(sizeof(KV));
  constexpr int kCpr = kRowB / 16;   // chunks a row
  for (int h = 0; h < 2; ++h) {
    const unsigned char* g = reinterpret_cast<const unsigned char*>(h ? vp
                                                                      : kp);
    for (int i = threadIdx.x; i < R * kCpr; i += kThreads) {
      const int t = i / kCpr, c = i % kCpr;
      ti::async_copy<16>((h ? dv : dk) + 16 * chunk(t, c),
                         g + (long long)srow[t] * kRowB + 16 * c,
                         t < n ? 16 : 0);
    }
    if (h == 0 && ks)
      for (int i = threadIdx.x; i < R; i += kThreads) {
        const int bytes = i < n ? 4 : 0;
        ti::async_copy<4>(sks + i, ks + srow[i], bytes);
        ti::async_copy<4>(svs + i, vs + srow[i], bytes);
      }
    ti::async_commit();
  }
}

// Output d of row `row` ([B, Hkv, R] flattened) from the slice's
// unnormalised o and its (max, sum) (m, l): out directly for a lone
// slice, else slice s's partial.
__device__ __forceinline__ void emit(const Params& p, float o, float m,
                                     float l, long long row, int d, int D,
                                     int s, int nlive) {
  if (nlive == 1) {
    p.out[row * D + d] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  } else {
    const long long i = row * p.nslices + s;
    p.po[i * D + d] = o;
    if (d == 0) {
      p.pml[2 * i] = m;
      p.pml[2 * i + 1] = l;
    }
  }
}

// The last block of a (b, kv head) merges its R rows' nlive slices (at
// most kMaxSlices) in slice order, kMergeRows rows at a time: warp w finds
// the weights of the group's rows w, w + 4, ... (lanes j and j + 32 hold
// slice j's and j + 32's (max, sum); the largest max and the total of the
// rescaled sums make them exp(m_j - mx) / l) into wts, dead shared
// memory; then the threads take the group's units of 4 outputs in turn
// and sum each over the slices in order, 8 loads in flight. Thread 0
// zeroes the counter for the next launch.
constexpr int kMergeRows = 16;
constexpr int kMergeBytes = kMergeRows * kWtsRow * 4;

template <int D>
__device__ __forceinline__ void merge_rows(const Params& p, int* counter,
                                           float* wts, long long row0,
                                           int nlive) {
  constexpr int kRpw = kMergeRows / kWarps;   // weight rows a warp
  constexpr int kUnits = D / 4;               // float4s a row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) *counter = 0;
  const float2 none = make_float2(ti::kNegInf, 0.f);
  for (int g = 0; g < p.R; g += kMergeRows) {
    const int rows = min(kMergeRows, p.R - g);
    float2 a[kRpw], c[kRpw];   // the warp's rows' loads in flight together
#pragma unroll
    for (int k = 0; k < kRpw; ++k) {
      const int r = warp + k * kWarps;
      const float2* pm = reinterpret_cast<const float2*>(p.pml) +
                         (row0 + g + r) * p.nslices;
      a[k] = r < rows && lane < nlive ? __ldcg(pm + lane) : none;
      c[k] = r < rows && lane + 32 < nlive ? __ldcg(pm + lane + 32) : none;
    }
#pragma unroll
    for (int k = 0; k < kRpw; ++k) {
      if (warp + k * kWarps >= rows) break;   // warp-uniform
      const float mx = ti::warp_max(fmaxf(a[k].x, c[k].x));
      const float ea = __expf(a[k].x - mx), ec = __expf(c[k].x - mx);
      const float inv =
          1.f / fmaxf(ti::warp_sum(ea * a[k].y + ec * c[k].y), 1e-30f);
      float* ww = wts + (warp + k * kWarps) * kWtsRow;
      ww[lane] = ea * inv;
      ww[lane + 32] = ec * inv;
    }
    __syncthreads();
    // unit u: row u / kUnits of the group, outputs 4 (u % kUnits) .. + 4
    for (int u = tid; u < rows * kUnits; u += kThreads) {
      const int rr = u / kUnits;
      const float4* pv = reinterpret_cast<const float4*>(
                             p.po + (row0 + g + rr) * p.nslices * D) +
                         u % kUnits;
      const float* wr = wts + rr * kWtsRow;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < nlive; ++j) {
        const float wt = wr[j];
        const float4 v = __ldcg(pv + (long long)j * kUnits);
        o.x = fmaf(wt, v.x, o.x);
        o.y = fmaf(wt, v.y, o.y);
        o.z = fmaf(wt, v.z, o.z);
        o.w = fmaf(wt, v.w, o.w);
      }
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
          p.out + (row0 + g + rr) * D + 4 * (u % kUnits));
      op[0] = __floats2bfloat162_rn(o.x, o.y);
      op[1] = __floats2bfloat162_rn(o.z, o.w);
    }
    __syncthreads();   // the group's weights are read
  }
}

// ---- one query row a kv head (R = 1): the CUDA cores ----------------------

// Shared memory: K rows, V rows, the int8 scales, the pool rows, scores,
// the P V sums of the row groups, max and sum (and the merge flag).
template <typename KV, int D>
struct RowLayout {
  static constexpr int kR = kRowRows;
  static constexpr int kE = 16 / static_cast<int>(sizeof(KV));
  static constexpr int kv = kR * D * static_cast<int>(sizeof(KV));
  static constexpr int ks = 2 * kv;
  static constexpr int srow = ks + 8 * kR;
  static constexpr int sc = srow + 4 * kR;
  static constexpr int red = sc + 4 * kR;
  static constexpr int ml = red + kThreads * kE * 4;
  static constexpr int total = ml + 16;
  static_assert(ml >= kMergeBytes, "the merge weights fit the dead rows");
};

template <typename KV, int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
paged_row_kernel(const KV* __restrict__ kp, const KV* __restrict__ vp,
                 Params p) {
  using L = RowLayout<KV, D>;
  constexpr int kR = L::kR;
  constexpr int kE = L::kE;                    // elements per 16 bytes
  constexpr int kRowB = D * static_cast<int>(sizeof(KV));
  using RL = RowLanes<D, kE, kThreads>;
  constexpr int kLpr = RL::kLpr;               // chunks a row (P V)
  constexpr int kGrp = RL::kGrp;               // lanes a row (scores)
  constexpr int kRpw = RL::kRpw;               // rows per warp pass
  constexpr int kGroups = RL::kGroups;         // row groups of P V
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::kv;
  float* sKs = reinterpret_cast<float*>(smem + L::ks);
  float* sVs = sKs + kR;
  int* srow = reinterpret_cast<int*>(smem + L::srow);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* red = reinterpret_cast<float*>(smem + L::red);
  float* ml = reinterpret_cast<float*>(smem + L::ml);
  int* flag = reinterpret_cast<int*>(ml + 2);

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lrow = lane / kGrp, dl = (lane % kGrp) * kE;
  const bool live = kGrp == kLpr || dl < D;    // the lane holds a chunk
  // the query row and this thread's key row in flight beside kv_len's load
  float qf[kE];
  ti::load_bf16_row<kE>(p.q + b * p.qsb + hk * p.qsh + (live ? dl : 0),
                        qf);
  if (!live)
#pragma unroll
    for (int e = 0; e < kE; ++e) qf[e] = 0.f;
  int prow = tid < kR ? pool_row(p, b, hk, s * kR * p.S + tid) : 0;
  Slice sl;
  if (!slice_of(p.kv_len, b, s, p.cap, kMask ? p.window : 0, kR, p.S, sl))
    return;
  // a window's slices start at kv_len - window: its rows looked up again
  if (kMask && p.window && tid < kR) prow = pool_row(p, b, hk, sl.t0 + tid);
  const int c = tid % kLpr, rg = tid / kLpr;
  const bool pv = kThreads % kLpr == 0 || rg < kGroups;   // a P V thread
  // the slice's running max, sum and outputs d = tid + kThreads j
  constexpr int kOut = (D + kThreads - 1) / kThreads;
  float M = ti::kNegInf, Lsum = 0.f, O[kOut] = {};
  do {
    __syncthreads();   // the last sub-slice's rows and row ids are read
    if (tid < kR) srow[tid] = prow;
    __syncthreads();
    load_rows<KV, D>(kp, vp, p.ks, p.vs, srow, sl.n, kR, sK, sV, sKs, sVs,
                     [](int t, int c) { return t * (kRowB / 16) + c; });
    if (tid < kR && sl.t0 + kR < sl.end)   // the next sub-slice's rows
      prow = pool_row(p, b, hk, sl.t0 + kR + tid);
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
      if (kMask && p.softcap > 0.f)
        cap_scores(sc, sl.n, p.softcap, p.cap2, lane);
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
  } while (sl.next(kR));
  const long long row = (long long)b * p.Hkv + hk;   // R = 1
  if (tid < D)
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      emit(p, O[j], M, Lsum, row, tid + kThreads * j, D, s, sl.nlive);
  int* counter = p.counters + (long long)b * p.Hkv + hk;
  if (sl.nlive == 1 || !ti::last_to_arrive(counter, sl.nlive, flag)) return;
  merge_rows<D>(p, counter, reinterpret_cast<float*>(smem), row, sl.nlive);
}

// ---- R >= 2 query rows a kv head: the tensor cores ------------------------

// Shared memory of a block taking its R rows in nch chunks of 8 NT: the K
// and V rows as copied (8-bit pools only), their bf16 form (bf16 rows are
// copied straight into it; with one chunk an 8-bit pool's V takes K's
// buffer once the scores are out), the queries, the int8 scales, the pool
// rows, probabilities [8 NT][128 + 8] bf16 (with one chunk, where they fit,
// in K's rows, dead once the scores are out: bf16 K, or the copied 8-bit
// K), each warp's partial max and sum of the chunk's rows, and with `keep`
// (several chunks and several sub-slices) every chunk's running outputs,
// max and sum. The merge's weights take the dead rows at the start.
template <typename KV, int D, int NT>
struct TcLayout {
  static constexpr bool k8 = sizeof(KV) == 1;
  static constexpr int kR = tc_rows(D);
  static constexpr int kRc = 8 * NT;
  static constexpr int kTile = kR * D;   // elements of a K or V tile
  static constexpr int kP = kRc * (kR + 8) * 2;   // probability bytes
  static constexpr bool kPinK = kP <= (k8 ? kTile : 2 * kTile);
  static_assert(2 * kTile >= kMergeBytes, "the merge weights fit the dead rows");
  int kb, vb, q, ks, srow, sp, red, save, flag, total;
  __host__ __device__ TcLayout(int nch, bool keep) {
    kb = k8 ? 2 * kTile : 0;
    vb = k8 && nch == 1 ? kb : kb + 2 * kTile;
    q = vb + 2 * kTile;
    ks = q + nch * kRc * D * 2;
    srow = ks + 8 * kR;
    const bool in_k = nch == 1 && kPinK;
    sp = in_k ? 0 : srow + 4 * kR;
    red = srow + 4 * kR + (in_k ? 0 : kP);
    save = red + 2 * kWarps * kRc * 4;
    flag = save + (keep ? nch * kRc * (D + 2) * 4 : 0);
    total = flag + 16;
  }
};

template <typename KV, int D, int NT, bool kMask>
__global__ void __launch_bounds__(kThreads)
paged_tc_kernel(const KV* __restrict__ kp, const KV* __restrict__ vp,
                Params p) {
  using L = TcLayout<KV, D, NT>;
  constexpr int kR = L::kR, kRc = L::kRc, kDs = D / 16;
  constexpr int kDt = (D / 16 + kWarps - 1) / kWarps;   // d tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (p.R + kRc - 1) / kRc;
  const bool keep = nch > 1 && p.S > 1;
  const L lay(nch, keep);
  unsigned char* sK = smem;                    // 8-bit rows as copied
  unsigned char* sV = smem + L::kTile;
  uint4* kb = reinterpret_cast<uint4*>(smem + lay.kb);   // bf16, swizzled
  uint4* vb = reinterpret_cast<uint4*>(smem + lay.vb);
  uint4* qt = reinterpret_cast<uint4*>(smem + lay.q);
  float* sKs = reinterpret_cast<float*>(smem + lay.ks);
  float* sVs = sKs + kR;
  int* srow = reinterpret_cast<int*>(smem + lay.srow);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + lay.sp);
  float* red_m = reinterpret_cast<float*>(smem + lay.red);   // [kWarps][kRc]
  float* red_s = red_m + kWarps * kRc;
  float* so = reinterpret_cast<float*>(smem + lay.save);  // [nch kRc][D]
  float* sml = so + nch * kRc * D;                        // [nch kRc][2]
  int* flag = reinterpret_cast<int*>(smem + lay.flag);

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, q4 = lane & 3;
  // this thread's key row (tid < kR), beside kv_len's load
  int prow = tid < kR ? pool_row(p, b, hk, s * kR * p.S + tid) : 0;
  Slice sl;
  if (!slice_of(p.kv_len, b, s, p.cap,
                kMask && p.window ? p.window + p.G - 1 : 0, kR, p.S, sl))
    return;
  // a window's slices start at the earliest query's first visible key:
  // its rows looked up again
  if (kMask && p.window && tid < kR) prow = pool_row(p, b, hk, sl.t0 + tid);
  const int q0 = max(1, min(p.kv_len[b], p.cap)) - p.G;   // token 0's position
  // keys a row sees before its own (window - 1; with none, all), and the
  // latest query's first visible key
  const int wspan = kMask && p.window ? p.window - 1 : INT_MAX / 2;
  const int wlo = q0 + p.G - 1 - wspan;
  const long long row0 = ((long long)b * p.Hkv + hk) * p.R;
  {
    // the query rows into their swizzled tile (rows past R zero-filled),
    // in the first sub-slice's K group
    const __nv_bfloat16* qg = p.q + b * p.qsb + hk * p.qsh;
    for (int i = tid; i < nch * kRc * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = i % (D / 8);
      const bool ok = r < p.R;
      ti::async_copy<16>(qt + swz<D>(r, c), qg + (ok ? r * p.qsr + 8 * c : 0),
                         ok ? 16 : 0);
    }
  }
  // this thread's running outputs (d tiles warp + 4 k, rows 8 nt + gi's
  // columns 2 q4 (+ 1)) and the (max, sum) of its rows 8 nt + 2 q4 (+ 1)
  float O[kDt][NT][4], M[NT][2], Ls[NT][2];
  bool first = true;
  do {
    __syncthreads();   // the last sub-slice's rows and row ids are read
    if (tid < kR) srow[tid] = prow;
    __syncthreads();
    if constexpr (L::k8)
      load_rows<KV, D>(kp, vp, p.ks, p.vs, srow, sl.n, kR, sK, sV, sKs, sVs,
                       [](int t, int c) { return t * (D / 16) + c; });
    else
      load_rows<KV, D>(kp, vp, p.ks, p.vs, srow, sl.n, kR,
                       reinterpret_cast<unsigned char*>(kb),
                       reinterpret_cast<unsigned char*>(vb), sKs, sVs,
                       [](int t, int c) { return swz<D>(t, c); });
    if (tid < kR && sl.t0 + kR < sl.end)   // the next sub-slice's rows
      prow = pool_row(p, b, hk, sl.t0 + kR + tid);
    ti::async_wait<1>();
    __syncthreads();
    if constexpr (L::k8) {
      widen<KV, D>(sK, kb, kR);
      __syncthreads();
    }
    const int n = sl.n, nkt = (n + 15) / 16;
    // a key past token 0, or before the latest query's window
    const bool masked = sl.t0 + n > q0 + 1 || (kMask && sl.t0 < wlo);
    const bool last = sl.t0 + kR >= sl.end;      // the slice's last sub-slice

    for (int ch = 0; ch < nch; ++ch) {
      const int rb = ch * kRc;
      if (first || nch > 1) {
        // the chunk's running state: fresh, or as the last sub-slice left it
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rb + 8 * nt + 2 * q4 + i;
            M[nt][i] = first ? ti::kNegInf : sml[2 * r];
            Ls[nt][i] = first ? 0.f : sml[2 * r + 1];
          }
#pragma unroll
        for (int k = 0; k < kDt; ++k)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = rb + 8 * nt + 2 * q4 + (e & 1);
              const int d = 16 * (warp + k * kWarps) + gi + (e >> 1) * 8;
              O[k][nt][e] = first || d >= D ? 0.f : so[r * D + d];
            }
      }
      int qpos[NT][2];   // positions of this thread's score columns
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          qpos[nt][i] = q0 + (rb + 8 * nt + 2 * q4 + i) / p.gh;

      // Scores S^T[t][r] = K[t] . q[r]: warp w takes key tiles w, w + 4
      // (16 keys), all D, the chunk's rows as NT n-tiles; times scale
      // (int8: and the key row's scale), soft-capped, masked with -1e30 as
      // the Pallas body masks, keys past n -inf (outside the softmax); in
      // registers.
      constexpr int kKt = kR / 16 / kWarps;   // key tiles a warp
      const float kOut = -__int_as_float(0x7f800000);   // -inf
      float sv[kKt][NT][4];
#pragma unroll
      for (int j = 0; j < kKt; ++j) {
        const int mt = warp + j * kWarps;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          sv[j][nt][0] = sv[j][nt][1] = sv[j][nt][2] = sv[j][nt][3] = 0.f;
        if (mt < nkt) {
#pragma unroll
          for (int k = 0; k < kDs; ++k) {
            // A = K rows 16 mt .. + 16, d 16 k .. + 16
            const int r = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
            uint32_t a[4];
            ldmatrix_x4(a, kb + swz<D>(r, 2 * k + (lane >> 4)), false);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              // B = the queries: row rb + 8 nt + gi, d 16 k + 2 q4 (+ 1), + 8
              const int qr = rb + 8 * nt + gi;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
                  reinterpret_cast<const __nv_bfloat16*>(
                      qt + swz<D>(qr, 2 * k)) +
                  2 * q4);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
                  reinterpret_cast<const __nv_bfloat16*>(
                      qt + swz<D>(qr, 2 * k + 1)) +
                  2 * q4);
              ti::mma_bf16(sv[j][nt], a, b0, b1);
            }
          }
        }
        // sv: key 16 mt + gi (+ 8 for e >= 2), row 8 nt + 2 q4 + (e & 1)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * mt + gi + (e >> 1) * 8;
            float v = sv[j][nt][e] * p.scale;
            if (p.ks && t < n) v *= sKs[t];
            if (!kMask && masked && sl.t0 + t > qpos[nt][e & 1])
              v = ti::kNegInf;
            sv[j][nt][e] = kMask || t < n ? v : kOut;
          }
      }
      if constexpr (kMask) {
        // the softcap (a pass of its own), then the causal and window masks
        if (p.softcap > 0.f) {
#pragma unroll
          for (int j = 0; j < kKt; ++j)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sv[j][nt][e] = ti::softcap(sv[j][nt][e], p.softcap, p.cap2);
        }
#pragma unroll
        for (int j = 0; j < kKt; ++j) {
          const int mt = warp + j * kWarps;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = sl.t0 + 16 * mt + gi + (e >> 1) * 8;
              const int q = qpos[nt][e & 1];
              if (masked && (t > q || t < q - wspan))
                sv[j][nt][e] = ti::kNegInf;
              if (t >= sl.t0 + n) sv[j][nt][e] = kOut;
            }
        }
      }
      // Each row's max: over this thread's keys, the warp's lanes (gi),
      // then the warps through red_m.
      float mx[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float m = kOut;
#pragma unroll
          for (int j = 0; j < kKt; ++j)
            m = fmaxf(m, fmaxf(sv[j][nt][i], sv[j][nt][i + 2]));
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          mx[nt][i] = m;
          if (gi == 0) red_m[warp * kRc + 8 * nt + 2 * q4 + i] = m;
        }
      if (ch == 0) ti::async_wait<0>();
      __syncthreads();   // the partial maxes; K read; V landed
      if (ch == 0) {
        if constexpr (L::k8) widen<KV, D>(sV, vb, kR);   // K's buffer if nch 1
      }
      // The probabilities go to sp[r][t] as bf16, int8 with the value
      // row's scale folded in (the sum takes them unscaled); keys past n
      // are zeros. Each row's sum as its max, through red_s.
      float sm[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int h = 8 * nt + 2 * q4 + i;
          float m = red_m[h];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[w * kRc + h]);
          mx[nt][i] = m;
          sm[nt][i] = 0.f;
        }
#pragma unroll
      for (int j = 0; j < kKt; ++j) {
        const int mt = warp + j * kWarps;
        if (mt >= nkt) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * mt + gi + (e >> 1) * 8;
            const int h = 8 * nt + 2 * q4 + (e & 1);
            const float x = __expf(sv[j][nt][e] - mx[nt][e & 1]);
            sm[nt][e & 1] += x;
            sp[h * (kR + 8) + t] = __float2bfloat16(p.vs ? x * sVs[t] : x);
          }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = sm[nt][i];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          if (gi == 0) red_s[warp * kRc + 8 * nt + 2 * q4 + i] = x;
        }
      __syncthreads();   // the probabilities, partial sums, V's bf16 rows
      float2 f[NT][2];   // rows 8 nt + 2 q4 (+ 1): the sub-slice folded in
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int h = 8 * nt + 2 * q4 + i;
          float l = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) l += red_s[w * kRc + h];
          f[nt][i] = fold(M[nt][i], Ls[nt][i], mx[nt][i], l);
        }

      // O^T[d][r] = sum_t V^T[d][t] P^T[t][r]: warp w takes d tiles w,
      // w + 4 (16 d), all keys; A = V^T through ldmatrix.trans, B = P^T.
#pragma unroll
      for (int k = 0; k < kDt; ++k) {
        const int dt = warp + k * kWarps;
        if (dt >= D / 16) break;
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        for (int kt = 0; kt < nkt; ++kt) {
          // matrices: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d
          // 0-7), (keys 8-15, d 8-15) of the tile
          const int r = 16 * kt + (lane & 7) + ((lane >> 4) << 3);
          uint32_t a[4];
          ldmatrix_x4(a, vb + swz<D>(r, 2 * dt + ((lane >> 3) & 1)), true);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* pr =
                sp + (8 * nt + gi) * (kR + 8) + 16 * kt + 2 * q4;
            ti::mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(pr),
                         *reinterpret_cast<const uint32_t*>(pr + 8));
          }
        }
        // acc: d = 16 dt + gi (+ 8 for e >= 2), row 8 nt + 2 q4 + (e & 1)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            O[k][nt][e] = f[nt][e & 1].x * O[k][nt][e] +
                          f[nt][e & 1].y * acc[nt][e];
      }

      if (last) {
#pragma unroll
        for (int k = 0; k < kDt; ++k) {
          const int dt = warp + k * kWarps;
          if (dt >= D / 16) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = rb + 8 * nt + 2 * q4 + (e & 1);
              if (r < p.R)
                emit(p, O[k][nt][e], M[nt][e & 1], Ls[nt][e & 1], row0 + r,
                     16 * dt + gi + (e >> 1) * 8, D, s, sl.nlive);
            }
        }
      } else if (keep) {
        // the chunk's state waits for the next sub-slice (read back by
        // this same thread)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rb + 8 * nt + 2 * q4 + i;
            sml[2 * r] = M[nt][i];
            sml[2 * r + 1] = Ls[nt][i];
          }
#pragma unroll
        for (int k = 0; k < kDt; ++k)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = rb + 8 * nt + 2 * q4 + (e & 1);
              const int d = 16 * (warp + k * kWarps) + gi + (e >> 1) * 8;
              if (d < D) so[r * D + d] = O[k][nt][e];
            }
      }
    }
    first = false;
  } while (sl.next(kR));
  int* counter = p.counters + (long long)b * p.Hkv + hk;
  if (sl.nlive == 1 || !ti::last_to_arrive(counter, sl.nlive, flag)) return;
  merge_rows<D>(p, counter, reinterpret_cast<float*>(smem), row0, sl.nlive);
}

template <typename KV, typename F>
int launch(F kernel, const KV* kp, const KV* vp, const Params& p, int B,
           int smem, cudaStream_t stream) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.nslices, p.Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(kp, vp, p);
  return 0;
}

template <typename KV, int D, int NT, bool kMask>
int launch_tc(const void* kp, const void* vp, const Params& p, int B,
              cudaStream_t stream) {
  auto k = paged_tc_kernel<KV, D, NT, kMask>;
  static const int allowed = ti::allow_smem(k, kSmemMax);
  if (allowed) return allowed;
  const int nch = (p.R + 8 * NT - 1) / (8 * NT);
  return launch(k, static_cast<const KV*>(kp), static_cast<const KV*>(vp), p,
                B, TcLayout<KV, D, NT>(nch, nch > 1 && p.S > 1).total,
                stream);
}

template <typename KV, int D, bool kMask>
int launch_m(const void* kp, const void* vp, const Params& p, int B,
             cudaStream_t stream) {
  if (p.R == 1) {
    auto k = paged_row_kernel<KV, D, kMask>;
    static const int allowed = ti::allow_smem(k, kSmemMax);
    if (allowed) return allowed;
    return launch(k, static_cast<const KV*>(kp), static_cast<const KV*>(vp),
                  p, B, RowLayout<KV, D>::total, stream);
  }
  if (p.R <= 8) return launch_tc<KV, D, 1, kMask>(kp, vp, p, B, stream);
  if (p.R <= 16) return launch_tc<KV, D, 2, kMask>(kp, vp, p, B, stream);
  return launch_tc<KV, D, 4, kMask>(kp, vp, p, B, stream);
}

// The kMask instances for calls with a window or a softcap.
template <typename KV, int D>
int launch_d(const void* kp, const void* vp, const Params& p, int B,
             cudaStream_t stream) {
  return p.window > 0 || p.softcap > 0.f
             ? launch_m<KV, D, true>(kp, vp, p, B, stream)
             : launch_m<KV, D, false>(kp, vp, p, B, stream);
}

template <typename KV>
int launch_kv(const void* kp, const void* vp, const Params& p, int B, int D,
              cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<KV, 32>(kp, vp, p, B, stream);
    case 64:
      return launch_d<KV, 64>(kp, vp, p, B, stream);
    case 96:
      return launch_d<KV, 96>(kp, vp, p, B, stream);
    case 128:
      return launch_d<KV, 128>(kp, vp, p, B, stream);
    case 256:
      return launch_d<KV, 256>(kp, vp, p, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace paged
}  // namespace ti

// paged_attention: the C interface of the paged decode and verify kernel
// and its bf16 instances; the kernels and their design are in
// paged_attention.cuh, the int8 and fp8 instances in
// paged_attention_int8.cu and paged_attention_fp8.cu (compiled in parallel
// with this file).
#include "paged_attention.cuh"

namespace ti {
namespace paged {
extern template int launch_kv<int8_t>(const void*, const void*, const Params&,
                                      int, int, cudaStream_t);
extern template int launch_kv<uint8_t>(const void*, const void*,
                                       const Params&, int, int, cudaStream_t);
}  // namespace paged
}  // namespace ti

namespace {

using ti::paged::kMaxSlices;
using ti::paged::kRowRows;
using ti::paged::tc_rows;

// The slice plan, from the pool's capacity cap = max_pages * page, the
// rows R and D alone (never from kv_len): a block's slice is S sub-slices
// of `rows` keys (128 on the tensor cores, 64 there at D = 256 and for
// R = 1), and the grid holds
// nslices slices a kv head, one sub-slice each up to kMaxSlices of them;
// past that each block reads S sub-slices in turn, so the last block's
// merge never weighs more than kMaxSlices partials.
struct Plan {
  int rows, S, nslices;
};

Plan plan_of(int R, int cap, int D) {
  const int rows = R > 1 ? tc_rows(D) : kRowRows;
  const int sub = (cap + rows - 1) / rows;
  const int S = (sub + kMaxSlices - 1) / kMaxSlices;
  return {rows, S, (sub + S - 1) / S};
}

}  // namespace

extern "C" {

// f32 scratch elements a call needs: per (b, kv head, row, slice) D
// unnormalised outputs plus the slice's max and sum; 0 when one slice
// covers the capacity cap = max_pages * page (nothing to merge).
long long ti_paged_workspace(int B, int Hkv, int R, int cap, int D) {
  const Plan pl = plan_of(R, cap, D);
  return pl.nslices > 1 ? (long long)B * Hkv * R * pl.nslices * (D + 2) : 0;
}

// q: bf16 [B, Hkv, R, D], R = G * gh rows (row r is token r / gh, head
// r % gh of the group), strides q_strides = {qsb, qsh, qsr} and
// contiguous, 16-byte aligned D rows; k_pages, v_pages: one layer's pool
// [P, Hkv, page, D] contiguous, of bf16 (kv_dtype 0), int8 codes (1) or
// float8_e4m3fn bits (2); k_scale, v_scale: for int8 the layer's f32
// scale pages [P, Hkv, page] contiguous, else null; out: bf16
// [B, Hkv, R, D] contiguous; table: int32 [B, max_pages]; kv_len: int32
// [B] (the G chunk tokens included); work: ti_paged_workspace(...) f32
// elements; counters: B * Hkv int32 zeros, left zeros. D in {32, 64,
// 96, 128, 256}; R <= 128 (at D = 256, over a pool of more than 64 sub-slices
// of 64 keys, R <= 96 for bf16 and R <= 64 for 8-bit pools: the chunks'
// kept outputs outgrow shared memory past that, and the call is
// refused); page a multiple of 8 up to 256. window: query g sees
// keys col > its position - window, 0 for none; softcap: scores s become
// softcap * tanh(s / softcap), 0 for none.
int ti_paged_attention(const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scale,
                       const void* v_scale, void* out, void* work,
                       void* counters, const void* table, const void* kv_len,
                       int B, int Hkv, int R, int gh, int g_tokens, int P,
                       int page, int max_pages, int D, int kv_dtype,
                       const long long* q_strides, float scale, int window,
                       float softcap, void* stream) {
  if (R <= 0 || R > 128 || gh <= 0 || R % gh || R / gh != g_tokens ||
      window < 0 || !(softcap >= 0.f) ||
      page <= 0 || page % 8 || page > 256 || P <= 0 || max_pages <= 0 ||
      (long long)P * Hkv * page > INT_MAX || kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_pages * page;
  const Plan pl = plan_of(R, cap, D);
  ti::paged::Params p{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(table),
      static_cast<const int*>(kv_len),
      static_cast<float*>(work),
      static_cast<float*>(work) + (long long)B * Hkv * R * pl.nslices * D,
      static_cast<int*>(counters),
      static_cast<__nv_bfloat16*>(out),
      q_strides[0], q_strides[1], q_strides[2],
      Hkv, R, gh, g_tokens, P, page, max_pages, cap, pl.S, pl.nslices,
      scale, window, softcap,
      softcap > 0.f ? 2.8853900817779268f / softcap : 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad =
      kv_dtype == 0
          ? ti::paged::launch_kv<__nv_bfloat16>(k_pages, v_pages, p, B, D, st)
      : kv_dtype == 1
          ? ti::paged::launch_kv<int8_t>(k_pages, v_pages, p, B, D, st)
          : ti::paged::launch_kv<uint8_t>(k_pages, v_pages, p, B, D, st);
  if (bad) return bad;
  return ti::launch_status();
}

}  // extern "C"

// flash_prefill: the C interface of the flash prefill kernel and its bf16
// K/V instances; the kernel and its design are in flash_prefill.cuh, the
// int8 and fp8 instances in flash_prefill_int8.cu and flash_prefill_fp8.cu
// (compiled in parallel with this file).
#include "flash_prefill.cuh"

namespace ti {
namespace flash {
extern template int run<int8_t>(const Call&);
extern template int run<uint8_t>(const Call&);
}  // namespace flash
}  // namespace ti

extern "C" {

// q: bf16 [B, S, Hq, D]; k, v: [B, Hkv, T, D] of bf16 (kv_dtype 0), int8
// codes (1) or float8_e4m3fn bits (2); o: bf16 [B, S, Hq, D], each given
// by strides in elements (the last dimension contiguous, the others
// multiples of 16 bytes): strides = {qsb, qss, qsh, ksb, ksh, kst, vsb,
// vsh, vst, osb, oss, osh, ssb, ssh}. k_scale, v_scale: for int8, f32
// [B, Hkv, T] with strides {ssb, ssh} and contiguous T, else null.
// kv_len, q_start: int32 [B] on the device. D in {32, 64, 96, 128, 256}.
// window: a query at position p sees keys t > p - window, 0 for none;
// softcap: scores s (times the int8 key scale) become softcap * tanh(s /
// softcap) before the mask, 0 for none.
int ti_flash_prefill(const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale, void* o,
                     const void* kv_len, const void* q_start, int B, int S,
                     int Hq, int Hkv, int T, int D, int kv_dtype,
                     const long long* strides, float scale, int window,
                     float softcap, void* stream) {
  if (kv_dtype < 0 || kv_dtype > 2 || Hkv <= 0 || Hq % Hkv || window < 0 ||
      !(softcap >= 0.f) ||
      (kv_dtype == 1) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ti::flash::Call c{q, k, v, static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale), o,
                          static_cast<const int*>(kv_len),
                          static_cast<const int*>(q_start), B, S, Hq, Hkv, T,
                          D, strides, scale, window, softcap,
                          static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 0) return ti::flash::run<__nv_bfloat16>(c);
  if (kv_dtype == 1) return ti::flash::run<int8_t>(c);
  return ti::flash::run<uint8_t>(c);
}

}  // extern "C"

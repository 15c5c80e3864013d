// The flash prefill kernel over fp8 (e4m3 bits) K/V (flash_prefill.cuh);
// compiled beside flash_prefill.cu.
#include "flash_prefill.cuh"

template int ti::flash::run<uint8_t>(const ti::flash::Call&);

// The flash prefill kernel over int8 K/V with f32 scale planes
// (flash_prefill.cuh); compiled beside flash_prefill.cu.
#include "flash_prefill.cuh"

template int ti::flash::run<int8_t>(const ti::flash::Call&);

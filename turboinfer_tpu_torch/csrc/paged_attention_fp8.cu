// The paged decode and verify kernels over fp8 (e4m3 bits) pages
// (paged_attention.cuh); compiled beside paged_attention.cu.
#include "paged_attention.cuh"

template int ti::paged::launch_kv<uint8_t>(
    const void*, const void*, const ti::paged::Params&, int, int, cudaStream_t);

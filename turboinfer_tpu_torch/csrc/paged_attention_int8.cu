// The paged decode and verify kernels over int8 pages with f32 scale pages
// (paged_attention.cuh); compiled beside paged_attention.cu.
#include "paged_attention.cuh"

template int ti::paged::launch_kv<int8_t>(
    const void*, const void*, const ti::paged::Params&, int, int, cudaStream_t);

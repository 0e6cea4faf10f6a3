// Helpers shared by the port's CUDA sources: fp32 loads and stores of fp32
// or bf16 elements, and the launch grid of a grid-stride elementwise kernel.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even
}

// Blocks for a grid-stride loop over `total` elements at `threads` a block:
// enough to fill every SM several times over, the loop covers the rest.
inline cudaError_t grid_stride_blocks(int64_t total, int threads, int* blocks) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int64_t want = (total + threads - 1) / threads;
    const int64_t cap = (int64_t)sms * 16;
    *blocks = (int)(want < cap ? want : cap);
    return cudaSuccess;
}

}  // namespace

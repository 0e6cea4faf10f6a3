// Helpers shared by the port's CUDA sources: fp32 loads and stores of fp32
// or bf16 elements, the launch grid of a grid-stride elementwise kernel, and
// the second pass of the batch-norm statistics (bn_stats.cu, matmul.cu).

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

constexpr int STATS_TX = 32;  // columns of a finishing block: one warp
constexpr int STATS_TY = 8;   // partial lanes of a finishing block

// The second pass of the batch-norm statistics: partials is (P, 2, C) fp32,
// the first pass's column sums (row 0) and sums of squares (row 1) over P
// disjoint row ranges that together hold `count` rows. Lane y of a block sums
// p = y, y+8, ... and the eight lane sums are added in lane order, so two
// runs give bit-equal results. Then, as the JAX kernels' wrappers do,
//   mean = s / count,  var = max(ss / count - mean*mean, 0)
// with every operation rounded on its own (no contracted FMA); a NaN stays.
__global__ void __launch_bounds__(STATS_TX * STATS_TY)
stats_finish_kernel(const float* __restrict__ partials, float* __restrict__ mean,
                    float* __restrict__ var, int C, int P, float count) {
    __shared__ float red[2][STATS_TY][STATS_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * STATS_TX + tx;
    float s = 0.0f, ss = 0.0f;
    if (c < C) {
        for (int p = ty; p < P; p += STATS_TY) {
            s += partials[(int64_t)(2 * p) * C + c];
            ss += partials[(int64_t)(2 * p + 1) * C + c];
        }
    }
    red[0][ty][tx] = s;
    red[1][ty][tx] = ss;
    __syncthreads();
    if (ty == 0 && c < C) {
        float st = 0.0f, sst = 0.0f;
#pragma unroll
        for (int y = 0; y < STATS_TY; ++y) {
            st += red[0][y][tx];
            sst += red[1][y][tx];
        }
        const float m = __fdiv_rn(st, count);
        const float v = __fsub_rn(__fdiv_rn(sst, count), __fmul_rn(m, m));
        mean[c] = m;
        var[c] = v < 0.0f ? 0.0f : v;
    }
}

inline cudaError_t launch_stats_finish(const float* partials, float* mean, float* var,
                                       int C, int P, int64_t count, cudaStream_t stream) {
    const int blocks = (C + STATS_TX - 1) / STATS_TX;
    stats_finish_kernel<<<blocks, dim3(STATS_TX, STATS_TY), 0, stream>>>(
        partials, mean, var, C, P, (float)count);
    return cudaGetLastError();
}

}  // namespace

// Helpers shared by the port's CUDA sources: fp32 loads and stores of fp32
// or bf16 elements, the launch grid of a grid-stride elementwise kernel, the
// channel vectors and input window of the depthwise kernels
// (depthwise3x3.cu, depthwise3x3_bwd.cu), and the second pass of the
// batch-norm statistics (bn_stats.cu, matmul.cu).

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

inline bool aligned(const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}
inline bool aligned16(const void* p) { return aligned(p, 16); }

// ---- channel vectors of the depthwise kernels ----------------------------

constexpr int VEC_THREADS = 128;  // threads of a channel-vector block
constexpr int VEC_TILE = 32;      // channel vectors of a block, at most

// V neighbouring channels of one pixel, loaded with one load and kept raw
// (four registers for 4 fp32 or 8 bf16, two for 4 bf16), widened to fp32
// where a tap uses it, and stored from fp32 sums. The default V fills 16
// bytes.
template <typename T, int V_ = 16 / (int)sizeof(T)> struct Vec;
template <> struct Vec<float, 4> {
    static constexpr int V = 4;
    using Raw = float4;
    static __device__ __forceinline__ Raw load(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
    static __device__ __forceinline__ void widen(const Raw& r, float (&v)[4]) {
        v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
    }
    static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};
template <> struct Vec<__nv_bfloat16, 8> {
    static constexpr int V = 8;
    using Raw = uint4;
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint4*>(p);
    }
    static __device__ __forceinline__ void widen(const Raw& r, float (&v)[8]) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
        uint4 t;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = t;
    }
};
// 4 bf16 channels in 8 bytes: the dw kernel's vector (read only)
template <> struct Vec<__nv_bfloat16, 4> {
    static constexpr int V = 4;
    using Raw = uint2;
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return *reinterpret_cast<const uint2*>(p);
    }
    static __device__ __forceinline__ void widen(const Raw& r, float (&v)[4]) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
};

// One column (wi) of the R rows a strip reads: the vectors of rows inside
// the image and of a column inside it (0 <= wi < W); the rest are never
// read.
template <typename T, int V = 16 / (int)sizeof(T), int R>
__device__ __forceinline__ void load_column(const T* const* rows, const bool* row_ok, int wi,
                                            int W, int C, typename Vec<T, V>::Raw (&col)[R]) {
    if (wi < 0 || wi >= W) return;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (row_ok[r]) col[r] = Vec<T, V>::load(rows[r] + (int64_t)wi * C);
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

// Batch-norm statistics: per-channel mean and biased variance of x (..., C),
// taken in one read of x.
//
// Replaces: dorknet_tpu/ops/pallas/bn_stats.py, function batch_norm_stats and
// its Pallas body _stats_kernel, which walks (512, C) row blocks in grid order
// and carries the fp32 column sum and sum of squares from step to step in a
// VMEM accumulator.
//
//   s[c] = sum_r x[r,c],  ss[c] = sum_r x[r,c]^2     over the M = numel/C rows
//   mean = s / M,  var = max(ss / M - mean^2, 0)
//
// The one-pass E[x^2] - E[x]^2 formula is the JAX package's own
// (dorknet_tpu/ops/norm.py:60-62), so the training step's batch norms compute
// exactly what the JAX step computes. Sums are fp32; x is fp32 or bf16, read
// and widened in registers (no fp32 copy of x is made).
//
// What bounds it on an H100: device-memory bytes. It reads x once (M*C*4 bytes
// in fp32) and does 3 flops per element, far below the card's rate; the
// flagship ResNet-18-depsep's 34 train-mode batch norms read about 1.0 GB per
// batch of 64 in fp32, about 0.30 ms at 3.35 TB/s.
//
// What the design does about it. Blocks on Hopper run in no order and carry
// nothing between them, so the TPU kernel's running accumulator becomes two
// passes, without atomics, and two runs give bit-equal results:
// - pass 1: a block of 32 channels x 8 row lanes owns one band of rows and one
//   channel tile. A warp reads 32 neighbouring channels of one row, coalesced;
//   each thread keeps its fp32 sum and sum of squares over the rows of its
//   lane, four loads in flight at a time. The 8 lanes are added in shared
//   memory in lane order and the block writes one (2, 32) slice of the fp32
//   partials (P, 2, C).
// - pass 2 (stats_finish_kernel, common.cuh): sums the P partials of each
//   channel in a fixed order and forms mean and the clamped variance.
// The caller picks P (the wrapper: about eight blocks per SM, at least 64 and
// at most 2048 rows a band), so a thread's serial run is at most 256 rows and
// the long sums of the stem's 802,816 rows are taken in three short stages,
// which keeps the rounding of s and ss, and so the cancellation in
// ss/M - mean^2, small.
//
// C entry point: dorknet_bn_stats. It launches on the caller's stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after the
// launches.

#include "common.cuh"

namespace {

constexpr int BN_UNROLL = 4;  // loads a thread keeps in flight

template <typename T>
__global__ void __launch_bounds__(STATS_TX * STATS_TY)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                        int64_t M, int C, int P) {
    __shared__ float red[2][STATS_TY][STATS_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * STATS_TX + tx;
    const int band = blockIdx.y;
    const int64_t r1 = M * (band + 1) / P;
    float s = 0.0f, ss = 0.0f;
    if (c < C) {
        const T* col = x + c;
        int64_t r = M * band / P + ty;
        for (; r + (BN_UNROLL - 1) * STATS_TY < r1; r += BN_UNROLL * STATS_TY) {
            float v[BN_UNROLL];
#pragma unroll
            for (int k = 0; k < BN_UNROLL; ++k)
                v[k] = load_f32(col + (r + k * STATS_TY) * C);
#pragma unroll
            for (int k = 0; k < BN_UNROLL; ++k) {
                s += v[k];
                ss += v[k] * v[k];
            }
        }
        for (; r < r1; r += STATS_TY) {
            const float v = load_f32(col + r * C);
            s += v;
            ss += v * v;
        }
    }
    red[0][ty][tx] = s;
    red[1][ty][tx] = ss;
    __syncthreads();
    // lane 0 adds the eight sums, lane 1 the eight sums of squares
    if (ty < 2 && c < C) {
        float t = 0.0f;
#pragma unroll
        for (int y = 0; y < STATS_TY; ++y) t += red[ty][y][tx];
        partials[((int64_t)band * 2 + ty) * C + c] = t;
    }
}

template <typename T>
cudaError_t stats_launch(const void* x, float* partials, float* mean, float* var,
                         int64_t M, int C, int P, cudaStream_t stream) {
    const dim3 grid((C + STATS_TX - 1) / STATS_TX, P);
    bn_stats_partial_kernel<T><<<grid, dim3(STATS_TX, STATS_TY), 0, stream>>>(
        static_cast<const T*>(x), partials, M, C, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_stats_finish(partials, mean, var, C, P, M, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, contiguous (M, C)). partials is
// float32 (P, 2, C) scratch; mean and var are float32 (C,). M and C must be
// positive and 1 <= P <= min(M, 65535).
int dorknet_bn_stats(const void* x, void* partials, void* mean, void* var,
                     long long M, int C, int P, int dtype, void* stream, int device) {
    if (M < 1 || C < 1 || P < 1 || P > 65535 || P > M)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* pp = static_cast<float*>(partials);
    float* mp = static_cast<float*>(mean);
    float* vp = static_cast<float*>(var);
    switch (dtype) {
        case 0: return (int)stats_launch<float>(x, pp, mp, vp, M, C, P, s);
        case 1: return (int)stats_launch<__nv_bfloat16>(x, pp, mp, vp, M, C, P, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

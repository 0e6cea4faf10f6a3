// GEMM y = a @ b, a (M,K) and b (K,N) row-major, fp32 accumulation, with an
// optional batch-norm statistics epilogue over the columns of y.
//
// Replaces: dorknet_tpu/ops/pallas/matmul.py, functions matmul (Pallas body
// _matmul_kernel: one (bm, bn) output tile per grid step, the whole K
// resident in VMEM, M padded to 8 and N to 128) and matmul_bn_stats (body
// _mm_stats_kernel: the same product, plus the per-column sum and sum of
// squares of the fp32 tile while it is live, carried down the M sweep in a
// VMEM accumulator).
//
//   y[m,n] = sum_k a[m,k] * b[k,n]            (fp32 sum, y in fp32 or bf16)
//   mean[n] = s[n] / M, var[n] = max(ss[n] / M - mean[n]^2, 0)
//     with s, ss the column sum and sum of squares of the fp32 product,
//     taken before y is rounded to its output type.
//
// a and b are both fp32 or both bf16; a bf16 element is widened to fp32 as it
// is staged in shared memory, and every product is an fp32 FMA on the CUDA
// cores (TF32 and the tensor cores are not used: the port keeps fp32 exact).
//
// What bounds it on an H100: for the flagship's pointwise layers in fp32,
// operations (2*M*N*K flops at the 67 TFLOP/s of the fp32 cores against
// (M*K + K*N + M*N) * 4 bytes at 3.35 TB/s: K, N >= 64 puts them past the
// ridge); for bf16 inputs the bound is the tensor cores' 989 TFLOP/s, or the
// bytes, which this kernel, on the fp32 cores, cannot reach.
//
// What the design does about it: a classic register-blocked tiling. A block
// of 256 threads owns a 128 x 128 tile of y; it loops over K in chunks of 8,
// staging a (128 x 8) slice of a (transposed, so each k is a contiguous row
// of 128) and an (8 x 128) slice of b in shared memory, and each thread keeps
// an 8 x 8 sub-tile of fp32 sums in registers, reading its 8 + 8 operands of
// a k as four 16-byte shared-memory loads for 64 FMAs. There is no "K
// resident" limit. The ragged edges are masked, not padded: loads past M, N
// or K stage zeros, and stores and statistics skip rows past M and columns
// past N. The statistics are the JAX kernel's, split in two passes for
// blocks that run in no order: each block sums its rows' fp32 products per
// column (in registers, then over its 16 row groups in shared memory, in a
// fixed order) and writes one partial per M tile, (tiles, 2, N); the second
// pass (stats_finish_kernel, common.cuh) sums them in a fixed order. No
// atomics: two runs give bit-equal results.
//
// Later work, not done here: bf16 through mma.sync or wgmma with TMA, and
// double-buffered staging.
//
// C entry point: dorknet_matmul. It launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launches.

#include "common.cuh"

namespace {

constexpr int MM_BM = 128;  // rows of a block's tile of y
constexpr int MM_BN = 128;  // columns of a block's tile of y
constexpr int MM_BK = 8;    // depth of one staged chunk of K
constexpr int MM_T = 8;     // a thread's sub-tile is MM_T x MM_T
constexpr int MM_GROUPS = MM_BM / MM_T;  // 16 row groups (and 16 column groups)
constexpr int MM_THREADS = MM_GROUPS * (MM_BN / MM_T);  // 256

template <typename TI, typename TO, bool STATS>
__global__ void __launch_bounds__(MM_THREADS)
matmul_kernel(const TI* __restrict__ a, const TI* __restrict__ b, TO* __restrict__ y,
              float* __restrict__ partials, int M, int K, int N) {
    // the main loop stages a and b in the first 2 * 8 * 128 floats; the
    // statistics epilogue reuses all of it for its (2, 16, 128) column sums
    __shared__ __align__(16) float smem[2 * MM_GROUPS * MM_BN];
    float* As = smem;                  // [MM_BK][MM_BM]: a's slice, k-major
    float* Bs = smem + MM_BK * MM_BM;  // [MM_BK][MM_BN]
    const int tid = threadIdx.x;
    const int tx = tid % MM_GROUPS;  // column group: columns tx*8 .. tx*8+7
    const int ty = tid / MM_GROUPS;  // row group: rows ty*8 .. ty*8+7
    const int m0 = blockIdx.x * MM_BM;
    const int n0 = blockIdx.y * MM_BN;
    // staging: thread t loads a[m0 + t/2, k0 + (t%2)*4 + 0..3] and
    // b[k0 + t/32, n0 + (t%32)*4 + 0..3]
    const int a_row = tid >> 1, a_k = (tid & 1) * 4;
    const int b_k = tid >> 5, b_col = (tid & 31) * 4;
    const int64_t a_m = m0 + a_row;
    const TI* a_ptr = a + a_m * K;

    float acc[MM_T][MM_T];
#pragma unroll
    for (int i = 0; i < MM_T; ++i)
#pragma unroll
        for (int j = 0; j < MM_T; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += MM_BK) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = k0 + a_k + i;
            As[(a_k + i) * MM_BM + a_row] = (a_m < M && k < K) ? load_f32(a_ptr + k) : 0.0f;
        }
        const int kb = k0 + b_k;
        const TI* b_ptr = b + (int64_t)kb * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + b_col + j;
            Bs[b_k * MM_BN + b_col + j] = (kb < K && n < N) ? load_f32(b_ptr + n) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < MM_BK; ++kk) {
            const float4* ap = reinterpret_cast<const float4*>(As + kk * MM_BM + ty * MM_T);
            const float4* bp = reinterpret_cast<const float4*>(Bs + kk * MM_BN + tx * MM_T);
            const float4 a0 = ap[0], a1 = ap[1], b0 = bp[0], b1 = bp[1];
            const float af[MM_T] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bf[MM_T] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < MM_T; ++i)
#pragma unroll
                for (int j = 0; j < MM_T; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
        }
        __syncthreads();
    }

    const int row0 = m0 + ty * MM_T, col0 = n0 + tx * MM_T;
#pragma unroll
    for (int i = 0; i < MM_T; ++i) {
        if (row0 + i >= M) break;
        TO* y_row = y + (int64_t)(row0 + i) * N;
#pragma unroll
        for (int j = 0; j < MM_T; ++j)
            if (col0 + j < N) store_f32(y_row + col0 + j, acc[i][j]);
    }

    if constexpr (STATS) {
        // this thread's rows first, then the 16 row groups in order
        float* red_s = smem;                       // [MM_GROUPS][MM_BN]
        float* red_ss = smem + MM_GROUPS * MM_BN;  // [MM_GROUPS][MM_BN]
#pragma unroll
        for (int j = 0; j < MM_T; ++j) {
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int i = 0; i < MM_T; ++i) {
                if (row0 + i < M) {  // rows past M add nothing
                    s += acc[i][j];
                    ss += acc[i][j] * acc[i][j];
                }
            }
            red_s[ty * MM_BN + tx * MM_T + j] = s;
            red_ss[ty * MM_BN + tx * MM_T + j] = ss;
        }
        __syncthreads();
        const int n = n0 + tid;
        if (tid < MM_BN && n < N) {
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int g = 0; g < MM_GROUPS; ++g) {
                s += red_s[g * MM_BN + tid];
                ss += red_ss[g * MM_BN + tid];
            }
            partials[(int64_t)(2 * blockIdx.x) * N + n] = s;
            partials[(int64_t)(2 * blockIdx.x + 1) * N + n] = ss;
        }
    }
}

template <typename TI, typename TO>
cudaError_t mm_launch(const void* a, const void* b, void* y, float* partials, float* mean,
                      float* var, int M, int K, int N, bool stats, cudaStream_t stream) {
    const int m_tiles = (M + MM_BM - 1) / MM_BM;
    const dim3 grid(m_tiles, (N + MM_BN - 1) / MM_BN);
    const TI* ap = static_cast<const TI*>(a);
    const TI* bp = static_cast<const TI*>(b);
    TO* yp = static_cast<TO*>(y);
    if (!stats) {
        matmul_kernel<TI, TO, false><<<grid, MM_THREADS, 0, stream>>>(
            ap, bp, yp, nullptr, M, K, N);
        return cudaGetLastError();
    }
    matmul_kernel<TI, TO, true><<<grid, MM_THREADS, 0, stream>>>(ap, bp, yp, partials, M, K, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_stats_finish(partials, mean, var, N, m_tiles, M, stream);
}

template <typename TI>
cudaError_t mm_dispatch_out(const void* a, const void* b, void* y, float* partials,
                            float* mean, float* var, int M, int K, int N, int out_dtype,
                            bool stats, cudaStream_t stream) {
    switch (out_dtype) {
        case 0: return mm_launch<TI, float>(a, b, y, partials, mean, var, M, K, N, stats, stream);
        case 1: return mm_launch<TI, __nv_bfloat16>(a, b, y, partials, mean, var, M, K, N,
                                                    stats, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// in_dtype (a and b) and out_dtype (y): 0 = float32, 1 = bfloat16. a is
// contiguous (M,K), b (K,N), y (M,N). With stats != 0, partials is float32
// (ceil(M/128), 2, N) scratch and mean, var are float32 (N,); M must then be
// positive. M, N >= 1, K >= 0.
int dorknet_matmul(const void* a, const void* b, void* y, void* partials, void* mean,
                   void* var, int M, int K, int N, int in_dtype, int out_dtype, int stats,
                   void* stream, int device) {
    if (M < 1 || N < 1 || K < 0 || (N + MM_BN - 1) / MM_BN > 65535)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* pp = static_cast<float*>(partials);
    float* mp = static_cast<float*>(mean);
    float* vp = static_cast<float*>(var);
    switch (in_dtype) {
        case 0: return (int)mm_dispatch_out<float>(a, b, y, pp, mp, vp, M, K, N, out_dtype,
                                                   stats != 0, s);
        case 1: return (int)mm_dispatch_out<__nv_bfloat16>(a, b, y, pp, mp, vp, M, K, N,
                                                           out_dtype, stats != 0, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

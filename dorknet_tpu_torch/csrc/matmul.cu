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
// Three routes, chosen by the caller (ops/cuda/matmul.py:_gemm_route) and
// passed as `route`; the entry point refuses a route the input cannot take:
// - 0, the CUDA cores, classic (this file, matmul_kernel): any a and b, both
//   fp32 or both bf16; a bf16 element is widened to fp32 as it is staged in
//   shared memory, and every product is an fp32 FMA (TF32 is not used: the
//   port keeps fp32 exact). It takes ragged K or N and misaligned views;
// - 1, the tensor cores (matmul_sm90.cu): bf16 a and b with K and N
//   multiples of 8 and 16-byte aligned pointers, TMA and wgmma;
// - 2, the CUDA cores, pipelined (this file, matmul_pipelined_kernel): fp32
//   a and b with K > 0, K and N multiples of 4, 16-byte aligned a, b and y,
//   in one of three tiles that the caller picks (ops/cuda/matmul.py:
//   _gemm_tile): BM x BN = 64 x 64 for y alone, 128 x 64 with the
//   statistics (half the partials for the finishing pass to sum), and
//   128 x 128, kept to be timed against them.
//
// What bounds the CUDA-core routes on an H100: for the flagship's pointwise
// layers in fp32, operations (2*M*N*K flops at the 67 TFLOP/s of the fp32
// cores against (M*K + K*N + M*N) * 4 bytes at 3.35 TB/s: K, N >= 64 puts
// them past the ridge, except 200,704 x 64 x 64, which its bytes bound).
//
// What the designs do about it. Both are register-blocked: each thread keeps
// an 8 x 8 sub-tile of fp32 sums in registers and every y element is one
// sequential fmaf chain over k = 0 .. K-1 (zero padding past K adds
// fmaf(0, 0, acc) = acc), so the two CUDA-core routes give bit-equal y at
// every shape and tile. The ragged edges are masked, not padded: loads past
// M, N or K stage zeros, and stores and statistics skip rows past M and
// columns past N.
// - Route 0: a block of 256 threads owns a 128 x 128 tile and loops over K
//   in chunks of 8 through one shared-memory buffer (load, sync, FMAs, sync),
//   staging a transposed with 4-byte loads.
// - Route 2 hides the loads behind the FMAs: a ring of PL_STAGES chunks of
//   16 k, filled by 16-byte cp.async copies (cp.async.cg, zero-filled past M
//   and K), so chunks c+1 and c+2 are in flight while chunk c's FMAs run,
//   with one __syncthreads a chunk. a stays m-major as it lies in memory; a
//   thread reads 4 k of each of its 8 rows with one 16-byte load (the lanes
//   of a quarter-warp share the row: a broadcast) and b's two 4-column
//   halves with 16-byte loads that the quarter-warp's lanes take from
//   consecutive addresses (no bank conflict). y is stored 16 bytes a thread.
//   The 64-wide tiles mask no column at N = 64, and 64 rows give the most
//   blocks where a grid would leave SMs idle.
// The statistics are the JAX kernel's, split in two passes for blocks that
// run in no order: each block sums its rows' fp32 products per column (in
// registers, then over its row groups in shared memory, in a fixed order)
// and writes one partial per M tile, (ceil(M / BM), 2, N); the second pass
// (stats_finish_kernel, common.cuh) sums them in a fixed order. No atomics:
// two runs give bit-equal results. The partials follow the tile's BM, so
// the two CUDA-core routes' statistics are not bit-equal to each other.
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

// ---- route 2: the pipelined CUDA-core kernel -------------------------------

constexpr int PL_BK = 16;     // depth of one staged chunk of K
constexpr int PL_STAGES = 3;  // the ring of chunks in shared memory

// A 16-byte copy from device to shared memory that bypasses L1; with
// pred false it reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src, bool pred) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
    uint2 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = t;
}

template <int BM, int BN>
constexpr int pl_threads() { return (BM / 8) * (BN / 8); }
template <int BM, int BN>
constexpr int pl_smem_bytes() { return PL_STAGES * (BM * PL_BK + PL_BK * BN) * 4; }
// blocks an SM must hold: 128 registers a thread at 256 and 128 threads;
// the 64-thread tile, whose copies hold more addresses, gets up to 168
template <int BM, int BN>
constexpr int pl_min_blocks() {
    return pl_threads<BM, BN>() == 64 ? 6 : 512 / pl_threads<BM, BN>();
}

// A block of (BM/8) x (BN/8) threads owns a BM x BN tile of y. Thread (tx,
// ty) holds rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3 and BN/2 + tx*4 ..
// BN/2 + tx*4+3 of it. Shared memory: PL_STAGES slots of a's chunk [BM][PL_BK]
// (m-major, as a lies in memory) and b's chunk [PL_BK][BN]; the statistics
// epilogue reuses it for its (2, BM/8, BN) column sums.
template <int BM, int BN, typename TO, bool STATS>
__global__ void __launch_bounds__(pl_threads<BM, BN>(), pl_min_blocks<BM, BN>())
matmul_pipelined_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        TO* __restrict__ y, float* __restrict__ partials, int M, int K, int N) {
    constexpr int TX = BN / 8, TY = BM / 8, THREADS = TX * TY;
    constexpr int A_SLOT = BM * PL_BK, B_SLOT = PL_BK * BN;  // floats
    constexpr int A_PIECES = A_SLOT / 4, B_PIECES = B_SLOT / 4;  // 16-byte copies
    static_assert(A_PIECES % THREADS == 0 && B_PIECES % THREADS == 0, "copy split");
    static_assert(2 * TY * BN <= PL_STAGES * (A_SLOT + B_SLOT), "statistics scratch");
    extern __shared__ __align__(16) float smem[];
    float* As = smem;
    float* Bs = smem + PL_STAGES * A_SLOT;
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int chunks = (K + PL_BK - 1) / PL_BK;

    // chunk c of K into ring slot s: a[m0 .. m0+BM, k0 .. k0+16] and
    // b[k0 .. k0+16, n0 .. n0+BN], zeros past M, K and N (K and N are
    // multiples of 4, so a 16-byte piece is all inside or all outside)
    auto load_chunk = [&](int c, int s) {
        const int k0 = c * PL_BK;
        float* as = As + s * A_SLOT;
        float* bs = Bs + s * B_SLOT;
#pragma unroll
        for (int e = 0; e < A_PIECES / THREADS; ++e) {
            const int i = tid + e * THREADS;
            const int r = i / (PL_BK / 4), q = i % (PL_BK / 4);
            const int m = m0 + r, k = k0 + q * 4;
            const bool ok = m < M && k < K;
            cp_async16(as + r * PL_BK + q * 4, ok ? a + (int64_t)m * K + k : a, ok);
        }
#pragma unroll
        for (int e = 0; e < B_PIECES / THREADS; ++e) {
            const int i = tid + e * THREADS;
            const int r = i / (BN / 4), q = i % (BN / 4);
            const int k = k0 + r, n = n0 + q * 4;
            const bool ok = k < K && n < N;
            cp_async16(bs + r * BN + q * 4, ok ? b + (int64_t)k * N + n : b, ok);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    // the first PL_STAGES - 1 chunks in flight; one commit group a chunk,
    // empty past the last, so the wait below always counts the same
#pragma unroll
    for (int s = 0; s < PL_STAGES - 1; ++s) {
        if (s < chunks) load_chunk(s, s);
        cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<PL_STAGES - 2>();  // chunk c has landed (this thread's copies)
        __syncthreads();                 // ... everyone's; and chunk c-1's slot is free
        const int next = c + PL_STAGES - 1;
        if (next < chunks) load_chunk(next, next % PL_STAGES);
        cp_async_commit();
        const int s = c % PL_STAGES;
        const float* as = As + s * A_SLOT + ty * 8 * PL_BK;
        const float* bs = Bs + s * B_SLOT + tx * 4;
#pragma unroll
        for (int kq = 0; kq < PL_BK / 4; ++kq) {
            float4 av[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                av[i] = *reinterpret_cast<const float4*>(as + i * PL_BK + kq * 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* brow = bs + (kq * 4 + kk) * BN;
                const float4 b0 = *reinterpret_cast<const float4*>(brow);
                const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
                const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                                   : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bf[j], acc[i][j]);
                }
            }
        }
    }

    const int row0 = m0 + ty * 8;
    const int col_a = n0 + tx * 4, col_b = n0 + BN / 2 + tx * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (row0 + i >= M) break;
        TO* y_row = y + (int64_t)(row0 + i) * N;
        const float va[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
        const float vb[4] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
        if (col_a < N) store4(y_row + col_a, va);
        if (col_b < N) store4(y_row + col_b, vb);
    }

    if constexpr (STATS) {
        cp_async_wait<0>();  // the ring's last (empty) groups, before reuse
        __syncthreads();
        float* red_s = smem;              // [TY][BN]
        float* red_ss = smem + TY * BN;   // [TY][BN]
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (row0 + i < M) {  // rows past M add nothing
                    s += acc[i][j];
                    ss += acc[i][j] * acc[i][j];
                }
            }
            const int col = (j < 4 ? tx * 4 : BN / 2 + tx * 4) + (j & 3);
            red_s[ty * BN + col] = s;
            red_ss[ty * BN + col] = ss;
        }
        __syncthreads();
        for (int col = tid; col < BN; col += THREADS) {
            const int n = n0 + col;
            if (n >= N) break;
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int g = 0; g < TY; ++g) {
                s += red_s[g * BN + col];
                ss += red_ss[g * BN + col];
            }
            partials[(int64_t)(2 * blockIdx.x) * N + n] = s;
            partials[(int64_t)(2 * blockIdx.x + 1) * N + n] = ss;
        }
    }
}

template <int BM, int BN, typename TO>
cudaError_t pl_launch(const void* a, const void* b, void* y, float* partials, float* mean,
                      float* var, int M, int K, int N, bool stats, cudaStream_t stream) {
    const int m_tiles = (M + BM - 1) / BM;
    const dim3 grid(m_tiles, (N + BN - 1) / BN);
    constexpr int smem = pl_smem_bytes<BM, BN>();
    const float* ap = static_cast<const float*>(a);
    const float* bp = static_cast<const float*>(b);
    TO* yp = static_cast<TO*>(y);
    auto kernel = stats ? matmul_pipelined_kernel<BM, BN, TO, true>
                        : matmul_pipelined_kernel<BM, BN, TO, false>;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, pl_threads<BM, BN>(), smem, stream>>>(ap, bp, yp, partials, M, K, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !stats) return err;
    return launch_stats_finish(partials, mean, var, N, m_tiles, M, stream);
}

template <typename TO>
cudaError_t pl_dispatch_tile(const void* a, const void* b, void* y, float* partials,
                             float* mean, float* var, int M, int K, int N, int bm, int bn,
                             bool stats, cudaStream_t stream) {
    if (bm == 128 && bn == 128)
        return pl_launch<128, 128, TO>(a, b, y, partials, mean, var, M, K, N, stats, stream);
    if (bm == 128 && bn == 64)
        return pl_launch<128, 64, TO>(a, b, y, partials, mean, var, M, K, N, stats, stream);
    if (bm == 64 && bn == 64)
        return pl_launch<64, 64, TO>(a, b, y, partials, mean, var, M, K, N, stats, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// matmul_sm90.cu
cudaError_t dorknet_matmul_tensor_cores(const void* a, const void* b, void* y, float* partials,
                                        float* mean, float* var, int M, int K, int N,
                                        int in_dtype, int out_dtype, bool stats,
                                        cudaStream_t stream);

extern "C" {

// in_dtype (a and b) and out_dtype (y): 0 = float32, 1 = bfloat16. a is
// contiguous (M,K), b (K,N), y (M,N). (bm, bn) is the tile a block owns:
// 128 x 128 on routes 0 and 1, one of 128 x 128, 128 x 64 and 64 x 64 on
// route 2. With stats != 0, partials is float32 (ceil(M/bm), 2, N) scratch
// and mean, var are float32 (N,); M must then be positive. M, N >= 1,
// K >= 0. route: 0 = CUDA cores, 1 = tensor cores, 2 = CUDA cores pipelined
// (see the top of this file for what routes 1 and 2 take).
int dorknet_matmul(const void* a, const void* b, void* y, void* partials, void* mean,
                   void* var, int M, int K, int N, int in_dtype, int out_dtype, int stats,
                   int route, int bm, int bn, void* stream, int device) {
    if (M < 1 || N < 1 || K < 0 || route < 0 || route > 2 || bn < 1 ||
        (N + bn - 1) / bn > 65535 || (route != 2 && (bm != MM_BM || bn != MM_BN)))
        return (int)cudaErrorInvalidValue;
    if (route == 2 && (in_dtype != 0 || K == 0 || K % 4 != 0 || N % 4 != 0 || !aligned16(a) ||
                       !aligned16(b) || !aligned16(y)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* pp = static_cast<float*>(partials);
    float* mp = static_cast<float*>(mean);
    float* vp = static_cast<float*>(var);
    if (route == 1)
        return (int)dorknet_matmul_tensor_cores(a, b, y, pp, mp, vp, M, K, N, in_dtype,
                                                out_dtype, stats != 0, s);
    if (route == 2) {
        switch (out_dtype) {
            case 0: return (int)pl_dispatch_tile<float>(a, b, y, pp, mp, vp, M, K, N, bm, bn,
                                                        stats != 0, s);
            case 1: return (int)pl_dispatch_tile<__nv_bfloat16>(a, b, y, pp, mp, vp, M, K, N,
                                                                bm, bn, stats != 0, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    switch (in_dtype) {
        case 0: return (int)mm_dispatch_out<float>(a, b, y, pp, mp, vp, M, K, N, out_dtype,
                                                   stats != 0, s);
        case 1: return (int)mm_dispatch_out<__nv_bfloat16>(a, b, y, pp, mp, vp, M, K, N,
                                                           out_dtype, stats != 0, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

// GEMM y = a @ b on Hopper's tensor cores: a (M,K) and b (K,N) row-major
// bf16, fp32 sums, y in fp32 or bf16, with the optional batch-norm statistics
// epilogue of matmul.cu. This is the tensor-core route of dorknet_matmul
// (matmul.cu keeps the CUDA-core route for every other input).
//
// Replaces: dorknet_tpu/ops/pallas/matmul.py, functions matmul (body
// _matmul_kernel) and matmul_bn_stats (body _mm_stats_kernel), for bf16
// inputs with K and N multiples of 8 and 16-byte aligned a and b.
//
//   y[m,n] = sum_k a[m,k] * b[k,n]            (fp32 sum, y in fp32 or bf16)
//   s[n], ss[n] = column sum and sum of squares of the fp32 product, taken
//     before y is rounded, one partial per 128-row tile of y
//
// What bounds it on an H100: bf16 products run at 989 TFLOP/s on the tensor
// cores, about 295 flops a byte of device memory, so the BN-fusion A/B's
// shapes are bound by bytes: ResNet-50's early 1x1 (K = 64) by writing y, the
// deep one (K = 1024) by reading a. On the CUDA cores (matmul.cu) the same
// products are capped at 67 TFLOP/s.
//
// What the design does about it: Hopper's own GEMM shape.
// - Copies: one producer warp issues TMA loads (cp.async.bulk.tensor, tensor
//   maps built per call on the host and passed as __grid_constant__
//   parameters) of a 128 x 64 tile of a (K contiguous) and a 64 x 128 tile of
//   b (N contiguous, two 64-column boxes) into a ring of 3 shared-memory
//   stages with full and empty mbarriers. TMA's out-of-bounds zero fill pads
//   the ragged M and K edges; a box wholly past N is not loaded.
// - Math: two consumer warpgroups, one 64-row slab of the tile each, run
//   wgmma.mma_async m64n128k16 bf16 -> fp32 from shared memory in 128-byte
//   swizzle. b is MN-major for the B operand: wgmma's transpose flag for B,
//   legal for 16-bit types, reads it as it lies (no copy of b).
// - Tile: 128 x 128 (BM = 128 keeps the statistics' per-tile partial layout
//   of matmul.cu). BN = 128 rather than 256 keeps 64 fp32 accumulators a
//   thread and 105 KB of shared memory a block, so two blocks fit on an SM.
//   At the early shape (one K step a tile) one block's epilogue, which
//   writes y, then overlaps the other block's loads: the overlap comes from
//   two resident blocks, not a persistent grid (one of two blocks an SM,
//   its producer running ahead into the next tile under this tile's
//   epilogue, was tried on an H100 and was slower at both shapes). The deep
//   shape is 392 blocks, 1.5 waves of 264.
// - Epilogue: from the accumulator fragments, masked at M and N. y is
//   rounded to its type and staged in the free ring as each warpgroup's
//   64-row slab, then leaves in 16-byte chunks, whole rows of consecutive
//   threads: full 32-byte sectors and 128-byte lines for fp32 and bf16 y
//   alike (a quad's fragment holds only 8 bytes of bf16 a row). The
//   statistics: each thread adds its two rows per column, __shfl_xor over
//   the three lane bits that index rows, then the eight warps' sums in warp
//   order through shared memory, and one partial per 128-row tile as in
//   matmul.cu, finished by stats_finish_kernel (common.cuh). No atomics and
//   no split K: two runs give bit-equal results.
//
// Later work, not done here: a finishing pass with more than 8 blocks for
// the early shape's 3,136 partials, TMA stores of y, clusters that multicast
// b's tile, and three blocks an SM for the deep shape's 392 tiles.
//
// Called from dorknet_matmul (matmul.cu) with route 1; it refuses
// (cudaErrorInvalidValue) a shape or an alignment this route cannot take.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int TC_BM = 128;     // rows of y a block owns
constexpr int TC_BN = 128;     // columns of y a block owns
constexpr int TC_BK = 64;      // depth of one stage: 64 bf16 = one 128-byte swizzle row
constexpr int TC_STAGES = 3;   // the ring of shared-memory stages
constexpr int TC_SLAB = 64;    // rows of one warpgroup's wgmma
constexpr int TC_CONSUMERS = 128 * (TC_BM / TC_SLAB);  // 256: two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;          // and one producer warp
constexpr int TC_WARPS = TC_CONSUMERS / 32;            // 8 consumer warps
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;          // 16 KB
constexpr int TC_B_BOX = TC_BK * 64 * 2;               // 8 KB: 64 rows of k x 64 columns
constexpr int TC_STAGE_BYTES = TC_A_BYTES + 2 * TC_B_BOX;
constexpr int TC_RED_BYTES = 2 * TC_WARPS * TC_BN * 4;  // the statistics' warp sums
static_assert(2 * 64 * (TC_BN * 4 + 16) <= TC_STAGES * TC_STAGE_BYTES,
              "the epilogue stages both warpgroups' fp32 slabs of y in the ring");
// 1 KB of slack to align the stages to the 1024 bytes the 128-byte swizzle needs
constexpr int TC_SMEM = 1024 + TC_STAGES * TC_STAGE_BYTES + TC_RED_BYTES + 2 * TC_STAGES * 8;

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 in bits
// 62-63). a's tile is K-major: 8-row groups 1024 bytes apart (SBO); LBO is
// unused there. b's is MN-major: the two 64-column boxes TC_B_BOX apart
// (LBO), 8-row groups of k 1024 bytes apart (SBO).
constexpr uint32_t TC_A_LBO = 16, TC_A_SBO = 1024;
constexpr uint32_t TC_B_LBO = TC_B_BOX, TC_B_SBO = 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins until the phase of the given parity has completed. A pipeline fault
// (bytes that never arrive) traps after about ten seconds, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done = 0;
    do {
        if (clock64() - start > 20000000000LL) __trap();
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// One TMA load of a 2-D box at (c0 innermost, c1) into shared memory; the
// bytes are reported to the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 rows x 128 columns, fp32) += A (64 x 16, K-major) @ B (16 x 128,
// MN-major: transpose flag 1), both bf16 from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);  // nearest even
}

template <typename TO, bool STATS>
__global__ void __launch_bounds__(TC_THREADS, 2)
matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, TO* __restrict__ y,
                 float* __restrict__ partials, int M, int K, int N) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    float* red = reinterpret_cast<float*>(smem + TC_STAGES * TC_STAGE_BYTES);
    const uint32_t base = smem_addr(smem);
    const uint32_t full0 = base + TC_STAGES * TC_STAGE_BYTES + TC_RED_BYTES;
    const uint32_t empty0 = full0 + TC_STAGES * 8;
    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * TC_BM;
    const int n0 = blockIdx.y * TC_BN;
    const int k_tiles = (K + TC_BK - 1) / TC_BK;

    if (tid == 0) {
        for (int s = 0; s < TC_STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, TC_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= TC_CONSUMERS) {
        // the producer warp: one lane keeps the ring full
        if (tid == TC_CONSUMERS) {
            const bool two_boxes = n0 + 64 < N;
            const uint32_t bytes = TC_A_BYTES + (two_boxes ? 2 : 1) * TC_B_BOX;
            for (int kt = 0; kt < k_tiles; ++kt) {
                const int s = kt % TC_STAGES;
                if (kt >= TC_STAGES) mbar_wait(empty0 + 8 * s, ((kt / TC_STAGES) - 1) & 1);
                const uint32_t a_s = base + s * TC_STAGE_BYTES, b_s = a_s + TC_A_BYTES;
                const uint32_t full = full0 + 8 * s;
                mbar_expect_tx(full, bytes);
                tma_load(a_s, &map_a, full, kt * TC_BK, m0);
                tma_load(b_s, &map_b, full, n0, kt * TC_BK);
                if (two_boxes) tma_load(b_s + TC_B_BOX, &map_b, full, n0 + 64, kt * TC_BK);
            }
        }
        return;
    }

    // the consumers: warpgroup g computes rows g*64 .. g*64+63 of the tile
    const int g = tid / 128, warp = tid / 32, lane = tid % 32;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % TC_STAGES;
        mbar_wait(full0 + 8 * s, (kt / TC_STAGES) & 1);
        const uint32_t a_s = base + s * TC_STAGE_BYTES + g * TC_SLAB * TC_BK * 2;
        const uint32_t b_s = base + s * TC_STAGE_BYTES + TC_A_BYTES;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
            // 16 more k: 32 bytes along a's swizzled rows, 16 rows of b's box
            wgmma_m64n128k16(d, sw128_desc(a_s + kk * 32, TC_A_LBO, TC_A_SBO),
                             sw128_desc(b_s + kk * 16 * 128, TC_B_LBO, TC_B_SBO));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // fragment of m64n128: d[4c + e] is row lr, d[4c + 2 + e] row lr + 8 of
    // the warpgroup's slab, both at column 8c + 2*(lane % 4) + e
    const int lr = (warp % 4) * 16 + lane / 4;
    const int r0 = m0 + g * TC_SLAB + lr;
    const bool ok0 = r0 < M, ok1 = r0 + 8 < M;

    // y leaves through shared memory in whole rows: every consumer is past
    // the main loop, so the stages are free; each warpgroup writes its slab
    // of fragments (rows padded by 16 bytes against bank conflicts), then
    // stores it as 16-byte chunks, consecutive threads on consecutive chunks
    asm volatile("bar.sync 1, %0;" ::"n"(TC_CONSUMERS) : "memory");
    constexpr int ROW_BYTES = TC_BN * (int)sizeof(TO) + 16;
    constexpr int CHUNKS = TC_BN * (int)sizeof(TO) / 16;  // 16-byte chunks of a row
    uint8_t* slab = smem + g * TC_SLAB * ROW_BYTES;
#pragma unroll
    for (int c = 0; c < TC_BN / 8; ++c) {
        const int col = 8 * c + 2 * (lane % 4);
        store2(reinterpret_cast<TO*>(slab + lr * ROW_BYTES) + col, d[4 * c], d[4 * c + 1]);
        store2(reinterpret_cast<TO*>(slab + (lr + 8) * ROW_BYTES) + col, d[4 * c + 2],
               d[4 * c + 3]);
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + g) : "memory");
    for (int i = tid % 128; i < TC_SLAB * CHUNKS; i += 128) {
        const int row = i / CHUNKS, chunk = i % CHUNKS;
        const int m = m0 + g * TC_SLAB + row;
        const int n = n0 + chunk * (16 / (int)sizeof(TO));
        // N is a multiple of 8, so a chunk is wholly inside or outside
        if (m < M && n < N)
            *reinterpret_cast<uint4*>(y + (int64_t)m * N + n) =
                *reinterpret_cast<const uint4*>(slab + row * ROW_BYTES + chunk * 16);
    }

    if constexpr (STATS) {
        float* red_s = red;                     // [TC_WARPS][TC_BN]
        float* red_ss = red + TC_WARPS * TC_BN;  // [TC_WARPS][TC_BN]
#pragma unroll
        for (int c = 0; c < TC_BN / 8; ++c) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float v0 = ok0 ? d[4 * c + e] : 0.0f;  // rows past M add nothing
                const float v1 = ok1 ? d[4 * c + 2 + e] : 0.0f;
                float s = v0 + v1;
                float ss = v0 * v0 + v1 * v1;
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {  // the lane bits of the row
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                    ss += __shfl_xor_sync(0xffffffffu, ss, off);
                }
                if (lane < 4) {
                    red_s[warp * TC_BN + 8 * c + 2 * lane + e] = s;
                    red_ss[warp * TC_BN + 8 * c + 2 * lane + e] = ss;
                }
            }
        }
        asm volatile("bar.sync 1, %0;" ::"n"(TC_CONSUMERS) : "memory");
        const int n = n0 + tid;
        if (tid < TC_BN && n < N) {
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int w = 0; w < TC_WARPS; ++w) {  // warp order: fixed
                s += red_s[w * TC_BN + tid];
                ss += red_ss[w * TC_BN + tid];
            }
            partials[(int64_t)(2 * blockIdx.x) * N + n] = s;
            partials[(int64_t)(2 * blockIdx.x + 1) * N + n] = ss;
        }
    }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiledFn* out) {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
        fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    *out = fn;
    return cudaSuccess;
}

// A row-major (outer, inner) bf16 matrix, read in (box_outer, box_inner)
// boxes with 128-byte swizzle; out-of-bounds elements read zero.
cudaError_t make_map(CUtensorMap* map, const void* base, int inner, int outer, int box_inner,
                     int box_outer) {
    EncodeTiledFn encode = nullptr;
    const cudaError_t err = encode_tiled(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
    const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
    const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TO, bool STATS>
cudaError_t tc_launch(const CUtensorMap& map_a, const CUtensorMap& map_b, void* y,
                      float* partials, int M, int K, int N, cudaStream_t stream) {
    auto kernel = matmul_tc_kernel<TO, STATS>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN);
    kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(map_a, map_b, static_cast<TO*>(y), partials,
                                                  M, K, N);
    return cudaGetLastError();
}

}  // namespace

// The tensor-core route of dorknet_matmul (matmul.cu): a and b bf16,
// K >= 8 and K, N multiples of 8 (TMA's 16-byte row strides), a, b and y
// 16-byte aligned. Anything else is refused with cudaErrorInvalidValue.
cudaError_t dorknet_matmul_tensor_cores(const void* a, const void* b, void* y, float* partials,
                                        float* mean, float* var, int M, int K, int N,
                                        int in_dtype, int out_dtype, bool stats,
                                        cudaStream_t stream) {
    if (in_dtype != 1 || K < 8 || K % 8 != 0 || N % 8 != 0 || !aligned16(a) || !aligned16(b) ||
        !aligned16(y) || (N + TC_BN - 1) / TC_BN > 65535 || (out_dtype != 0 && out_dtype != 1))
        return cudaErrorInvalidValue;
    CUtensorMap map_a, map_b;
    cudaError_t err = make_map(&map_a, a, K, M, TC_BK, TC_BM);
    if (err != cudaSuccess) return err;
    err = make_map(&map_b, b, N, K, 64, TC_BK);
    if (err != cudaSuccess) return err;
    if (out_dtype == 0) {
        err = stats ? tc_launch<float, true>(map_a, map_b, y, partials, M, K, N, stream)
                    : tc_launch<float, false>(map_a, map_b, y, partials, M, K, N, stream);
    } else {
        err = stats ? tc_launch<__nv_bfloat16, true>(map_a, map_b, y, partials, M, K, N, stream)
                    : tc_launch<__nv_bfloat16, false>(map_a, map_b, y, partials, M, K, N, stream);
    }
    if (err != cudaSuccess || !stats) return err;
    return launch_stats_finish(partials, mean, var, N, (M + TC_BM - 1) / TC_BM, M, stream);
}

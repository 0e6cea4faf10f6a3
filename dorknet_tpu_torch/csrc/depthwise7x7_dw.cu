// Depthwise 7x7 convolution, padding 3, stride 1, NHWC: the weight gradient.
//
// Replaces no TPU kernel. The JAX package leaves every depthwise shape but
// 3x3 to XLA's convolution (dorknet_tpu/ops/conv.py). This kernel was added
// because cuDNN's fp32 NHWC grouped weight gradient
// (wgrad2d_grouped_direct_kernel) took 61% of ConvNeXt-T's training step on
// an H100, about 300x its bound. The forward and dx stay on cuDNN
// (ops/cuda/depthwise7x7.py).
//
//   dw[c,di,dj] = sum_{n,ho,wo} x[n, ho+di-3, wo+dj-3, c] * g[n,ho,wo,c]
//
// over 0 <= ho < H, 0 <= wo < W (stride 1, padding 3: g is as large as x);
// taps outside the image read zero. x and g are fp32 or bf16, the sums
// fp32, dw fp32 (C,7,7).
//
// What bounds it on an H100: the bytes, though not by far. It reads x and g
// once, 8 bytes an element of g in fp32: ConvNeXt-T's 18 layers at batch 128
// hold 274.6 M elements, 2.20 GB, 0.656 ms at 3.35 TB/s. It does 49 FMAs an
// element, 0.40 ms at 67 TFLOP/s. So the FMAs have to be fed from registers,
// with few other instructions beside them: a design that loads an operand
// for every few FMAs, or spends instructions on addresses and edge tests,
// runs out of instruction slots before the device memory runs out of bytes.
//
// Pass 1. A thread owns one channel and all 49 taps (49 fp32 sums in
// registers) and walks strips of DW7_TH = 7 output rows by the whole image
// width, one x column wi at a time. It keeps in registers a window of the 7 g
// columns wo = wi-3 .. wi+3 of its strip's rows (7 x 7 values; g has 7 rows
// in a strip where x has 13). Each step takes one x column (13 values) and
// the g column that enters the window (7 values), and does 7 x 7 x 7 = 343
// FMAs: each x value meets the 49 g values it pairs with. The window is a
// ring indexed by the column mod 7, and the walk is unrolled by 7, so every
// index is a constant and the ring stays in registers.
//
// A warp is 32 neighbouring channels of one strip. It stages its columns in
// shared memory, DW7_STAGES steps ahead, with cp.async: a stage is the 13 x
// rows and 7 g rows of one column, 20 rows of 32 channels, copied as 4
// channels (16 bytes fp32, 8 bytes bf16) a copy, 5 copies a lane. Rows and
// columns outside the image and channels past C are zero-filled by the copy,
// so the FMA loop has no edge test, and a step reads its 20 values from the
// stage at constant offsets. Each g element is read from device memory once;
// each x element by 13/7 strips on average, the second time mostly from L2.
// The padding columns of x are never loaded (the walk covers the image's
// columns); the window's g columns outside the image are zeros.
//
// Pass 1 splits the strips into P bands (dorknet_depthwise7x7_dw_bands sizes
// P so that the grid is one wave); a block of 4 warps owns one band
// and a tile of 32 channels, its warps walk the band's strips in turn, their
// sums are added in shared memory in warp order, and the block writes its
// (49, 32) slice of the fp32 partials (P, 49, C). Pass 2 sums the P partials
// of each tap in a fixed order. There are no atomics, so two runs give
// bit-equal dw.
//
// On an H100 ConvNeXt-T's 18 layers at batch 128 take 1.19 ms, 55% of the
// bound, where cuDNN took 193 ms (chip_smoke.py phase 20, PERF.md).
//
// C entry points: dorknet_depthwise7x7_dw_bands gives the band count P, and
// so the size of the partials, for a shape on a card; dorknet_depthwise7x7_dw
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() after the launches. The launch geometry
// lives here alone: the wrapper (ops/cuda/depthwise7x7.py) asks for P and
// allocates the partials.

#include "common.cuh"

namespace {

constexpr int K7 = 7;             // filter side
constexpr int PAD7 = 3;           // padding
constexpr int TAPS7 = K7 * K7;    // 49
constexpr int DW7_TH = 7;         // output rows of a strip
constexpr int DW7_R = DW7_TH + K7 - 1;  // x rows of a strip: 13
constexpr int DW7_ROWS = DW7_R + DW7_TH;  // rows of a stage: 13 x rows, then 7 g rows
constexpr int DW7_WARPS = 4;      // warps of a pass-1 block
constexpr int DW7_THREADS = 32 * DW7_WARPS;
constexpr int DW7_TILE = 32;      // channels of a pass-1 block: one a lane
constexpr int DW7_STAGES = 4;     // columns a warp keeps in flight, a power of 2
// blocks an SM: the grid is one wave of them. With 4 warps a block, 2 were
// faster than 3 (and than 4, which spills at 128 registers) in an A/B on an
// H100: 1.19 against 1.26 ms over ConvNeXt-T's 18 layers at batch 128.
constexpr int DW7_BLOCKS_PER_SM = 2;
constexpr int DW7_COPIES = DW7_ROWS * DW7_TILE / 4 / 32;  // 4-channel copies a lane a stage: 5
static_assert(DW7_ROWS * DW7_TILE / 4 % 32 == 0, "a stage's copies fill the warp");

// A copy of 4 channels (16 bytes fp32, 8 bytes bf16) from device to shared
// memory; with pred false it reads nothing and writes zeros.
template <typename T>
__device__ __forceinline__ void cp_async4ch(T* smem_dst, const T* src, bool pred) {
    if constexpr (sizeof(T) == 4) cp_async16(smem_dst, src, pred);
    else cp_async8(smem_dst, src, pred);
}

// One warp's stages: [stage][row][channel], rows 0..12 x, 13..19 g.
template <typename T> using Dw7Ring = T[DW7_STAGES][DW7_ROWS][DW7_TILE];

// The copies of one lane into the stage of column wi: copy i is row
// lane / 8 + 4 i of the stage, channels 4 (lane % 8) .. +3. A stage holds x
// column wi in its x rows and g column wi + 3 in its g rows (the column
// that enters the window at step wi). rows[i] points at the copy's row of
// the strip's image at the column of step 0, ok[i] says whether the row
// and the channels lie inside the image, and the copy reads while
// wi < lim[i]; a copy that reads nothing is given a valid address, safe.
template <typename T>
struct Dw7Copies {
    const T* rows[DW7_COPIES];
    bool ok[DW7_COPIES];
    int lim[DW7_COPIES];
    int dst[DW7_COPIES];  // the copy's offset in a stage, in elements
    const T* safe;
    int C;

    __device__ __forceinline__ void fetch(T* stage, int wi) const {
#pragma unroll
        for (int i = 0; i < DW7_COPIES; ++i) {
            const bool in = ok[i] && wi < lim[i];
            cp_async4ch(stage + dst[i], in ? rows[i] + (int64_t)wi * C : safe, in);
        }
    }
};

// The 49 sums of one warp's thread over one strip of DW7_TH output rows
// (image rows ho0 .. ho0+6) and the whole width. xs and gs point at channel
// 0 of the block's tile in the strip's image; lane is the thread's lane,
// ring its warp's stages.
template <typename T>
__device__ __forceinline__ void dw7_strip(const T* __restrict__ xs, const T* __restrict__ gs,
                                          int ho0, int H, int W, int C, int c_base, int lane,
                                          Dw7Ring<T>& ring, float (&acc)[K7][K7]) {
    constexpr int TH = DW7_TH, R = DW7_R;
    const int64_t WC = (int64_t)W * C;
    Dw7Copies<T> cp;
    cp.C = C;
    cp.safe = xs;
    const bool ch_ok = c_base + 4 * (lane % 8) < C;
#pragma unroll
    for (int i = 0; i < DW7_COPIES; ++i) {
        const int row = lane / 8 + 4 * i;
        const bool is_x = row < R;
        const int h = is_x ? ho0 - PAD7 + row : ho0 + row - R;
        cp.ok[i] = ch_ok && h >= 0 && h < H;
        cp.lim[i] = is_x ? W : W - PAD7;
        cp.rows[i] = (is_x ? xs : gs + PAD7 * C) + (cp.ok[i] ? h : 0) * WC + 4 * (lane % 8);
        cp.dst[i] = row * DW7_TILE + 4 * (lane % 8);
    }
    const int w_end = (W + K7 - 1) / K7 * K7;  // whole groups of 7 columns
#pragma unroll
    for (int k = 0; k < DW7_STAGES - 1; ++k) {
        cp.fetch(&ring[k][0][0], k);
        cp_async_commit();
    }

    // gw[o][(wo + 3) % 7] holds g row o at column wo: columns -3..-1 are
    // zero, 0..2 are read here, and step wi brings in column wi + 3
    const int c = c_base + lane;
    float gw[TH][K7];
#pragma unroll
    for (int o = 0; o < TH; ++o) {
        const bool row_ok = c < C && ho0 + o < H;
        const T* grow = gs + (row_ok ? ho0 + o : 0) * WC + lane;
#pragma unroll
        for (int j = 0; j < K7; ++j)
            gw[o][j] = j >= PAD7 && j - PAD7 < W && row_ok ? load_f32(grow + (j - PAD7) * C)
                                                            : 0.0f;
    }

    for (int w0 = 0; w0 < w_end; w0 += K7) {
#pragma unroll
        for (int s = 0; s < K7; ++s) {
            const int wi = w0 + s;
            cp_async_wait<DW7_STAGES - 2>();  // column wi's stage has landed
            __syncwarp();                     // for every lane, and every lane read wi - 1's
            const T* st = &ring[wi & (DW7_STAGES - 1)][0][lane];
            float xv[R];
#pragma unroll
            for (int r = 0; r < R; ++r) xv[r] = load_f32(st + r * DW7_TILE);
            // the g column that enters the window: wi + 3
#pragma unroll
            for (int o = 0; o < TH; ++o)
                gw[o][(s + 2 * PAD7) % K7] = load_f32(st + (R + o) * DW7_TILE);
            if (wi + DW7_STAGES - 1 < w_end)
                cp.fetch(&ring[(wi + DW7_STAGES - 1) & (DW7_STAGES - 1)][0][0],
                         wi + DW7_STAGES - 1);
            cp_async_commit();
            // x row r meets g row o at tap row di = r - o, and g column
            // wo = wi + 3 - dj at tap column dj
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int o = 0; o < TH; ++o) {
                    const int di = r - o;
                    if (di < 0 || di >= K7) continue;
#pragma unroll
                    for (int dj = 0; dj < K7; ++dj)
                        acc[di][dj] = fmaf(xv[r], gw[o][(s + 2 * PAD7 - dj) % K7], acc[di][dj]);
                }
        }
    }
    cp_async_wait<0>();
    __syncwarp();
}

// Pass 1. Block (channel tile blockIdx.x, band blockIdx.y), warp y of
// DW7_WARPS, lane = the thread's channel in the tile. Strip p is image
// p / strip_rows, output rows (p % strip_rows) * DW7_TH onward; band b holds
// the strips [S*b/P, S*(b+1)/P) of the S strips, and warp y walks strips
// y, y + DW7_WARPS, ... of its band.
template <typename T>
__global__ void __launch_bounds__(DW7_THREADS, DW7_BLOCKS_PER_SM)
depthwise7x7_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                               float* __restrict__ partials, int H, int W, int C,
                               int strip_rows, int64_t strips, int P) {
    // the warps' stages, then (after the walk) the block's sums
    constexpr int RING_BYTES = DW7_WARPS * (int)sizeof(Dw7Ring<T>);
    constexpr int RED_BYTES = DW7_WARPS * TAPS7 * DW7_TILE * (int)sizeof(float);
    __shared__ __align__(16) unsigned char smem[RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int c_base = blockIdx.x * DW7_TILE;
    const int band = blockIdx.y;
    const int64_t p0 = strips * band / P;
    const int64_t p1 = strips * (band + 1) / P;
    Dw7Ring<T>& ring = reinterpret_cast<Dw7Ring<T>*>(smem)[warp];

    float acc[K7][K7];
#pragma unroll
    for (int di = 0; di < K7; ++di)
#pragma unroll
        for (int dj = 0; dj < K7; ++dj) acc[di][dj] = 0.0f;
    const int64_t HWC = (int64_t)H * W * C;
    for (int64_t p = p0 + warp; p < p1; p += DW7_WARPS) {
        const int ho0 = (int)(p % strip_rows) * DW7_TH;
        const int64_t n = p / strip_rows;
        dw7_strip<T>(x + n * HWC + c_base, g + n * HWC + c_base, ho0, H, W, C, c_base, lane,
                     ring, acc);
    }
    __syncthreads();  // every warp is done with its stages
    float* red = reinterpret_cast<float*>(smem);  // [warp][tap][channel of the tile]
#pragma unroll
    for (int di = 0; di < K7; ++di)
#pragma unroll
        for (int dj = 0; dj < K7; ++dj)
            red[(warp * TAPS7 + di * K7 + dj) * DW7_TILE + lane] = acc[di][dj];
    __syncthreads();
    // TAPS7 * 32 sums of the block's warps, in warp order
    for (int o = threadIdx.x; o < TAPS7 * DW7_TILE; o += DW7_THREADS) {
        const int k = o / DW7_TILE, cl = o % DW7_TILE;
        float s = 0.0f;
#pragma unroll
        for (int y = 0; y < DW7_WARPS; ++y) s += red[(y * TAPS7 + k) * DW7_TILE + cl];
        if (c_base + cl < C) partials[((int64_t)band * TAPS7 + k) * C + c_base + cl] = s;
    }
}

constexpr int FIN7_TX = 32;  // outputs of a finishing block: one warp's coalesced row
constexpr int FIN7_TY = 32;  // partial lanes of a finishing block

// Pass 2. dw[c, k] = sum over p of partials[p, k, c]. Lane y of a block sums
// p = y, y + 32, ... of its 32 outputs, then the 32 lane sums are added in a
// fixed tree (lane y += lane y + s for s = 16, 8, 4, 2, 1), so two runs give
// bit-equal results.
__global__ void __launch_bounds__(FIN7_TX * FIN7_TY)
depthwise7x7_dw_finish_kernel(const float* __restrict__ partials, float* __restrict__ dw,
                              int C, int P) {
    __shared__ float red[FIN7_TY][FIN7_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t nout = (int64_t)TAPS7 * C;
    const int64_t i = (int64_t)blockIdx.x * FIN7_TX + tx;  // = k*C + c
    float s = 0.0f;
    if (i < nout) {
        for (int p = ty; p < P; p += FIN7_TY) s += partials[(int64_t)p * nout + i];
    }
    red[ty][tx] = s;
#pragma unroll
    for (int half = FIN7_TY / 2; half > 0; half /= 2) {
        __syncthreads();
        if (ty < half) red[ty][tx] += red[ty + half][tx];
    }
    if (ty == 0 && i < nout) {
        const int64_t k = i / C, c = i % C;
        dw[c * TAPS7 + k] = red[0][tx];
    }
}

template <typename T>
cudaError_t dw7_launch(const void* x, const void* g, void* partials, void* dw, int N, int H,
                       int W, int C, int P, cudaStream_t stream) {
    if (!aligned(x, 4 * sizeof(T)) || !aligned(g, 4 * sizeof(T))) return cudaErrorInvalidValue;
    const dim3 grid((C + DW7_TILE - 1) / DW7_TILE, P);
    const int strip_rows = (H + DW7_TH - 1) / DW7_TH;
    const int64_t strips = (int64_t)N * strip_rows;
    float* pp = static_cast<float*>(partials);
    depthwise7x7_dw_partial_kernel<T><<<grid, DW7_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), pp, H, W, C, strip_rows, strips, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t nout = (int64_t)TAPS7 * C;
    const int blocks = (int)((nout + FIN7_TX - 1) / FIN7_TX);
    depthwise7x7_dw_finish_kernel<<<blocks, dim3(FIN7_TX, FIN7_TY), 0, stream>>>(
        pp, static_cast<float*>(dw), C, P);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bands of pass 1 for x of (N,H,W,C) on a card of `sms` SMs:
// DW7_BLOCKS_PER_SM blocks an SM over the channel tiles, rounded down so
// that the grid is one wave, at least one strip for each of a block's warps,
// at most 65535 bands, at least one (one for an empty shape).
int dorknet_depthwise7x7_dw_bands(int N, int H, int C, int sms) {
    if (N < 1 || H < 1 || C < 1 || sms < 1) return 1;
    const int64_t tiles = (C + DW7_TILE - 1) / DW7_TILE;
    const int64_t strips = (int64_t)N * ((H + DW7_TH - 1) / DW7_TH);
    int64_t p = (int64_t)DW7_BLOCKS_PER_SM * sms / tiles;
    if (strips / DW7_WARPS < p) p = strips / DW7_WARPS;
    if (p > 65535) p = 65535;
    return p < 1 ? 1 : (int)p;
}

// x and g (N,H,W,C) contiguous and aligned to 4 channels (16 bytes fp32, 8
// bytes bf16), dtype 0 = float32, 1 = bfloat16; partials float32 (P,49,C)
// scratch; dw float32 (C,7,7). N, H, W and C must be positive, C a multiple
// of 4, and 1 <= P <= 65535.
int dorknet_depthwise7x7_dw(const void* x, const void* g, void* partials, void* dw, int N,
                            int H, int W, int C, int P, int dtype, void* stream, int device) {
    if (N < 1 || H < 1 || W < 1 || C < 1 || C % 4 != 0 || P < 1 || P > 65535)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)dw7_launch<float>(x, g, partials, dw, N, H, W, C, P, s);
        case 1: return (int)dw7_launch<__nv_bfloat16>(x, g, partials, dw, N, H, W, C, P, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

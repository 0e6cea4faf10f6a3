// Depthwise 3x3 convolution, padding 1, stride 1 or 2, NHWC: the backward.
//
// Replaces: dorknet_tpu/ops/pallas/depthwise.py, _depthwise_bwd, the custom
// VJP of depthwise3x3. Its dx half runs the forward Pallas program
// (_run_fwd) on the zero-dilated, padded gradient with the flipped filter;
// its dw half is _run_dw, with the Pallas bodies _dw_kernel (stride 1) and
// _dw2_kernel (stride 2) writing per-image partials that XLA sums over N.
//
//   dx[n,h,w,c] = sum_{di,dj} g[n,ho,wo,c] * w[c,di,dj]
//                 over s*ho+di-1 = h, s*wo+dj-1 = w, 0 <= ho < Ho, 0 <= wo < Wo
//   dw[c,di,dj] = sum_{n,ho,wo} x[n, s*ho+di-1, s*wo+dj-1, c] * g[n,ho,wo,c]
//
// Taps outside the image read zero. Sums are kept in fp32; x, g and dx are
// fp32 or bf16 (dx in g's type), w and dw are fp32 (C,3,3).
//
// What bounds them on an H100: device-memory bytes, as for the forward. dx
// reads g once and writes dx once; dw reads x and g once. Each does 18 flops
// per element of g, far below the card's rate. For the flagship
// ResNet-18-depsep's 16 depthwise layers that is about 0.79 GB per batch of
// 64 in fp32 for each of the two, about 0.24 ms at 3.35 TB/s.
//
// Each has two routes, chosen by the caller (ops/cuda/depthwise.py:
// _dx_route, _dwgrad_route) and passed as `route`; the C entry points refuse
// (cudaErrorInvalidValue) a route or a strip width the input cannot take.
//
// dx, route 1, channel vectors (C a multiple of a 16-byte vector, 4 fp32 or
// 8 bf16; g and dx 16-byte aligned): the forward's vector design
// (depthwise3x3.cu) on the transposed stencil. A thread owns one vector of
// channels of one dx row (n, hi) and a strip of TW consecutive wi, and
// decomposes its index once per strip. Its block stages its channel range's
// weights tap-major in shared memory once; each thread keeps its nine weight
// vectors in registers. Tap row di of dx row hi reads g row
// ho = (hi + 1 - di) / s where that divides (one valid row at even hi, two
// at odd hi, at stride 2). A window of raw g vectors slides along the
// strip, each loaded once with a 16-byte load: three columns at stride 1
// (output wi reads columns wi + 1, wi, wi - 1); at stride 2 an even wi = 2m
// reads column m alone and an odd wi = 2m + 1 columns m + 1 and m, so a
// strip of TW reads TW/2 + 1 columns, and the taps that fall between g's
// columns are skipped, never multiplied by zero. Each dx vector leaves in
// one 16-byte store. No zero-dilated or padded copy of g is made.
//
// dx, route 0, scalar (every other C or alignment): one thread per element
// of dx, channel index fastest, so a warp reads 32 neighbouring channels of g
// and writes 32 of dx, coalesced; at stride 2 the taps whose source row or
// column falls between g's are skipped by a parity test.
//
// The two dx routes compute every element with the same fp32 operations in
// the same order (taps di outer, dj inner, over ho = hi + 1 - di and
// wo = wi + 1 - dj; one fmaf(g, w, acc) per valid tap), so they agree bit
// for bit at every strip width.
//
// dw is a reduction over N*Ho*Wo for each of the 9*C taps, done in two
// passes without atomics, so that two runs give bit-equal results. Pass 1
// splits the work into P bands; a block owns one band and one tile of
// channels, each thread keeps its nine tap sums per channel in registers
// while it walks its share of the band, the block's lanes are summed in
// shared memory in a fixed order, and the block writes its (9, tile) slice
// of the fp32 partials (P, 9, C). Pass 2 sums the P partials of each tap in
// a fixed order, 32 lanes to an output so that its chains of dependent
// loads stay short at a few hundred bands. The partials are small beside x
// and g.
//
// dw, route 1, channel vectors (C a multiple of 4; x and g aligned to 4
// channels: 16 bytes fp32, 8 bytes bf16). A thread owns 4 channels (36
// fp32 accumulators; 8 bf16 channels would need 72 and took 150-200
// registers) and walks strips of TH output rows by DWV_TW consecutive wo of
// its band, decomposing its index once per strip. Along a strip it slides
// the forward's window of raw x vectors (three columns of the strip's x
// rows), so at stride 1 each new output column loads one new x column and
// the strip's g vectors, instead of nine scalar x loads and one g load per
// channel. TH is 1 in fp32 and 2 in bf16 (DwVec). The grid is one wave:
// the caller's band count (ops/cuda/depthwise.py:dw_vec_bands) gives about
// four blocks of 128 threads an SM, what about 120 registers a thread
// allow.
//
// dw, route 0, scalar: a block of 32 channels x 8 pixel lanes walks the
// flattened (n, ho, wo) pixels of its band; each thread loads one g value
// and the nine x values of its pixel and channel, with four divisions per
// pixel.
//
// C entry points: dorknet_depthwise3x3_dx and dorknet_depthwise3x3_dw. They
// launch on the caller's stream, do not synchronise, allocate nothing, and
// return cudaGetLastError() after the launches.

#include "common.cuh"

namespace {

// ---- dx, route 0: scalar -------------------------------------------------

// The flat index of dx decomposed into (n, h, w, c) in Idx arithmetic,
// 32-bit whenever dx has fewer than 2^32 elements (see depthwise3x3.cu).
template <typename T, int STRIDE, typename Idx>
__global__ void depthwise3x3_dx_kernel(const T* __restrict__ g,
                                       const float* __restrict__ w,
                                       T* __restrict__ dx,
                                       int H, int W, int C, int Ho, int Wo,
                                       Idx total) {
    const Idx step = (Idx)gridDim.x * blockDim.x;
    for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        const int c = (int)(i % (Idx)C);
        Idx p = i / (Idx)C;
        const int wi = (int)(p % (Idx)W);
        p /= (Idx)W;
        const int hi = (int)(p % (Idx)H);
        const int64_t n = (int64_t)(p / (Idx)H);

        const float* wc = w + (int64_t)c * 9;
        float acc = 0.0f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
            int ho = hi + 1 - di;  // >= -1
            if (STRIDE == 2) {
                if (ho & 1) continue;  // also skips -1
                ho >>= 1;
            }
            if (ho < 0 || ho >= Ho) continue;
            const T* row = g + ((n * Ho + ho) * (int64_t)Wo) * C + c;
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
                int wo = wi + 1 - dj;
                if (STRIDE == 2) {
                    if (wo & 1) continue;
                    wo >>= 1;
                }
                if (wo < 0 || wo >= Wo) continue;
                acc = fmaf(load_f32(row + (int64_t)wo * C), __ldg(wc + di * 3 + dj), acc);
            }
        }
        store_f32(dx + i, acc);
    }
}

template <typename T, int STRIDE>
void launch_dx_scalar(const T* g, const float* w, T* dx, int64_t total, int H, int W,
                      int C, int Ho, int Wo, int blocks, int threads,
                      cudaStream_t stream) {
    const int64_t step = (int64_t)blocks * threads;
    if (total + step < ((int64_t)1 << 32)) {
        depthwise3x3_dx_kernel<T, STRIDE, uint32_t><<<blocks, threads, 0, stream>>>(
            g, w, dx, H, W, C, Ho, Wo, (uint32_t)total);
    } else {
        depthwise3x3_dx_kernel<T, STRIDE, int64_t><<<blocks, threads, 0, stream>>>(
            g, w, dx, H, W, C, Ho, Wo, total);
    }
}

// ---- dx, route 1: channel vectors ----------------------------------------

// Grid as the forward's vector kernel: x over strips (n, hi, strip of TW
// wi) in a grid-stride loop, threadIdx.y the strip lane; y over tiles of
// VEC_TILE channel vectors, threadIdx.x the vector in the tile. Idx as in
// the scalar kernel.
template <typename T, int STRIDE, int TW, typename Idx>
__global__ void __launch_bounds__(VEC_THREADS)
depthwise3x3_dx_vec_kernel(const T* __restrict__ g, const float* __restrict__ w,
                           T* __restrict__ dx, int H, int W, int C, int Ho, int Wo,
                           int strips_per_row, Idx strips) {
    using VT = Vec<T>;
    constexpr int V = VT::V;
    __shared__ float w_s[9][VEC_TILE * V];  // the tile's weights, tap-major
    const int tile_c = blockDim.x * V;
    const int c_base = blockIdx.y * tile_c;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 9 * tile_c;
         i += blockDim.x * blockDim.y) {
        const int tap = i / tile_c, cl = i % tile_c;
        const int c = c_base + cl;
        w_s[tap][cl] = c < C ? w[(int64_t)c * 9 + tap] : 0.0f;
    }
    __syncthreads();
    const int c0 = c_base + threadIdx.x * V;
    if (c0 >= C) return;
    float wr[9][V];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) wr[t][v] = w_s[t][threadIdx.x * V + v];

    const Idx step = (Idx)gridDim.x * blockDim.y;
    for (Idx p = (Idx)blockIdx.x * blockDim.y + threadIdx.y; p < strips; p += step) {
        const int strip = (int)(p % (Idx)strips_per_row);
        const Idx q = p / (Idx)strips_per_row;
        const int hi = (int)(q % (Idx)H);
        const int64_t n = (int64_t)(q / (Idx)H);
        const int wi0 = strip * TW;
        // tap row di reads g row ho = (hi + 1 - di) / STRIDE, where that divides
        const T* rows[3];
        bool row_ok[3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
            const int a = hi + 1 - di;  // >= -1
            const int ho = STRIDE == 1 ? a : a >> 1;
            row_ok[di] = a >= 0 && (STRIDE == 1 || (a & 1) == 0) && ho < Ho;
            rows[di] = g + ((n * Ho + (row_ok[di] ? ho : 0)) * (int64_t)Wo) * C + c0;
        }
        T* dx_row = dx + ((n * H + hi) * (int64_t)W) * C + c0;

        if (STRIDE == 1) {
            // win[k] holds g column wi - 1 + k of the current output wi; tap
            // dj reads column wi + 1 - dj, which is win[2 - dj]
            typename VT::Raw win[3][3] = {};
#pragma unroll
            for (int k = 0; k < 3; ++k)
                load_column<T>(rows, row_ok, wi0 - 1 + k, Wo, C, win[k]);
#pragma unroll
            for (int t = 0; t < TW; ++t) {
                const int wi = wi0 + t;
                if (wi >= W) break;
                if (t > 0) {
#pragma unroll
                    for (int di = 0; di < 3; ++di) {
                        win[0][di] = win[1][di];
                        win[1][di] = win[2][di];
                    }
                    load_column<T>(rows, row_ok, wi + 1, Wo, C, win[2]);
                }
                float acc[V];
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
                for (int di = 0; di < 3; ++di) {
                    if (!row_ok[di]) continue;
#pragma unroll
                    for (int dj = 0; dj < 3; ++dj) {
                        const int wo = wi + 1 - dj;
                        if (wo < 0 || wo >= Wo) continue;
                        float gv[V];
                        VT::widen(win[2 - dj][di], gv);
#pragma unroll
                        for (int v = 0; v < V; ++v) acc[v] = fmaf(gv[v], wr[di * 3 + dj][v], acc[v]);
                    }
                }
                VT::store(dx_row + (int64_t)wi * C, acc);
            }
        } else {
            // an even wi = 2m reads g column m (tap dj = 1); an odd
            // wi = 2m + 1 reads column m + 1 (dj = 0) and column m (dj = 2).
            // cur holds column m, nxt column m + 1. wi0 is even when TW > 1.
            typename VT::Raw cur[3] = {}, nxt[3] = {};
            load_column<T>(rows, row_ok, wi0 >> 1, Wo, C, cur);
#pragma unroll
            for (int t = 0; t < TW; ++t) {
                const int wi = wi0 + t;
                if (wi >= W) break;
                const bool odd = TW == 1 ? (wi & 1) != 0 : (t & 1) != 0;
                if (odd) {
                    load_column<T>(rows, row_ok, (wi >> 1) + 1, Wo, C, nxt);
                } else if (t > 0) {
#pragma unroll
                    for (int di = 0; di < 3; ++di) cur[di] = nxt[di];
                }
                float acc[V];
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
                for (int di = 0; di < 3; ++di) {
                    if (!row_ok[di]) continue;
#pragma unroll
                    for (int dj = 0; dj < 3; ++dj) {
                        if (odd == (dj == 1)) continue;  // between g's columns
                        const int wo = (wi + 1 - dj) >> 1;
                        if (wo >= Wo) continue;
                        float gv[V];
                        VT::widen(dj == 0 ? nxt[di] : cur[di], gv);
#pragma unroll
                        for (int v = 0; v < V; ++v) acc[v] = fmaf(gv[v], wr[di * 3 + dj][v], acc[v]);
                    }
                }
                VT::store(dx_row + (int64_t)wi * C, acc);
            }
        }
    }
}

template <typename T, int STRIDE, int TW>
cudaError_t launch_dx_vec_tw(const T* g, const float* w, T* dx, int N, int H, int W, int C,
                             int Ho, int Wo, cudaStream_t stream) {
    constexpr int V = Vec<T>::V;
    const int vectors = C / V;
    const int tile = vectors < VEC_TILE ? vectors : VEC_TILE;
    const dim3 block(tile, VEC_THREADS / tile);
    const int strips_per_row = (W + TW - 1) / TW;
    const int64_t strips = (int64_t)N * H * strips_per_row;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(strips, block.y, &blocks);
    if (err != cudaSuccess) return err;
    const dim3 grid(blocks, (vectors + tile - 1) / tile);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const int64_t step = (int64_t)blocks * block.y;
    if (strips + step < ((int64_t)1 << 32)) {
        depthwise3x3_dx_vec_kernel<T, STRIDE, TW, uint32_t><<<grid, block, 0, stream>>>(
            g, w, dx, H, W, C, Ho, Wo, strips_per_row, (uint32_t)strips);
    } else {
        depthwise3x3_dx_vec_kernel<T, STRIDE, TW, int64_t><<<grid, block, 0, stream>>>(
            g, w, dx, H, W, C, Ho, Wo, strips_per_row, strips);
    }
    return cudaGetLastError();
}

template <typename T, int STRIDE>
cudaError_t launch_dx_vec(const T* g, const float* w, T* dx, int N, int H, int W, int C,
                          int Ho, int Wo, int tw, cudaStream_t stream) {
    switch (tw) {
        case 1: return launch_dx_vec_tw<T, STRIDE, 1>(g, w, dx, N, H, W, C, Ho, Wo, stream);
        case 2: return launch_dx_vec_tw<T, STRIDE, 2>(g, w, dx, N, H, W, C, Ho, Wo, stream);
        case 4: return launch_dx_vec_tw<T, STRIDE, 4>(g, w, dx, N, H, W, C, Ho, Wo, stream);
        case 8: return launch_dx_vec_tw<T, STRIDE, 8>(g, w, dx, N, H, W, C, Ho, Wo, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t dx_launch(const void* g, const void* w, void* dx, int N, int H,
                      int W, int C, int stride, int route, int tw, cudaStream_t stream) {
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const int64_t total = (int64_t)N * H * W * C;
    if (route == 1 && (C % Vec<T>::V != 0 || !aligned16(g) || !aligned16(dx) ||
                       (tw != 1 && tw != 2 && tw != 4 && tw != 8)))
        return cudaErrorInvalidValue;
    if (total == 0) return cudaSuccess;
    const T* gp = static_cast<const T*>(g);
    const float* wp = static_cast<const float*>(w);
    T* dxp = static_cast<T*>(dx);
    if (route == 1) {
        return stride == 1 ? launch_dx_vec<T, 1>(gp, wp, dxp, N, H, W, C, Ho, Wo, tw, stream)
                           : launch_dx_vec<T, 2>(gp, wp, dxp, N, H, W, C, Ho, Wo, tw, stream);
    }
    const int threads = 256;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(total, threads, &blocks);
    if (err != cudaSuccess) return err;
    if (stride == 1) {
        launch_dx_scalar<T, 1>(gp, wp, dxp, total, H, W, C, Ho, Wo, blocks, threads, stream);
    } else {
        launch_dx_scalar<T, 2>(gp, wp, dxp, total, H, W, C, Ho, Wo, blocks, threads, stream);
    }
    return cudaGetLastError();
}

// ---- dw, route 0: scalar -------------------------------------------------

constexpr int DW_TX = 32;  // channels of a block: one warp
constexpr int DW_TY = 8;   // pixel lanes of a block

// Pass 1. Block (channel tile blockIdx.x, band blockIdx.y) of the P bands
// of Q = N*Ho*Wo pixels. Idx is the type of a pixel index: 32-bit whenever
// Q + DW_TY < 2^32.
template <typename T, int STRIDE, typename Idx>
__global__ void __launch_bounds__(DW_TX * DW_TY)
depthwise3x3_dw_partial_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               float* __restrict__ partials,
                               int H, int W, int C, int Ho, int Wo,
                               int64_t Q, int P) {
    __shared__ float red[DW_TY][9][DW_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * DW_TX + tx;
    const int band = blockIdx.y;
    const Idx q0 = (Idx)(Q * band / P);
    const Idx q1 = (Idx)(Q * (band + 1) / P);

    float acc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
    if (c < C) {
        for (Idx q = q0 + ty; q < q1; q += DW_TY) {
            const int wo = (int)(q % (Idx)Wo);
            const Idx t = q / (Idx)Wo;
            const int ho = (int)(t % (Idx)Ho);
            const int64_t n = (int64_t)(t / (Idx)Ho);
            const float gv = load_f32(g + (int64_t)q * C + c);
            const int hi0 = ho * STRIDE - 1;
            const int wi0 = wo * STRIDE - 1;
#pragma unroll
            for (int di = 0; di < 3; ++di) {
                const int hi = hi0 + di;
                if (hi < 0 || hi >= H) continue;
                const T* row = x + ((n * H + hi) * (int64_t)W) * C + c;
#pragma unroll
                for (int dj = 0; dj < 3; ++dj) {
                    const int wi = wi0 + dj;
                    if (wi < 0 || wi >= W) continue;
                    acc[di * 3 + dj] += load_f32(row + (int64_t)wi * C) * gv;
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) red[ty][k][tx] = acc[k];
    __syncthreads();
    // 9*32 sums of 8 lanes each, in lane order
    for (int o = ty * DW_TX + tx; o < 9 * DW_TX; o += DW_TX * DW_TY) {
        const int k = o / DW_TX;
        const int lane = o % DW_TX;
        const int cc = blockIdx.x * DW_TX + lane;
        float s = 0.0f;
#pragma unroll
        for (int y = 0; y < DW_TY; ++y) s += red[y][k][lane];
        if (cc < C) partials[((int64_t)band * 9 + k) * C + cc] = s;
    }
}

template <typename T, int STRIDE>
void launch_dw_partial(const T* x, const T* g, float* partials, int H, int W,
                       int C, int Ho, int Wo, int64_t Q, int P,
                       cudaStream_t stream) {
    const dim3 grid((C + DW_TX - 1) / DW_TX, P);
    const dim3 block(DW_TX, DW_TY);
    if (Q + DW_TY < ((int64_t)1 << 32)) {
        depthwise3x3_dw_partial_kernel<T, STRIDE, uint32_t><<<grid, block, 0, stream>>>(
            x, g, partials, H, W, C, Ho, Wo, Q, P);
    } else {
        depthwise3x3_dw_partial_kernel<T, STRIDE, int64_t><<<grid, block, 0, stream>>>(
            x, g, partials, H, W, C, Ho, Wo, Q, P);
    }
}

// ---- dw, route 1: channel vectors ----------------------------------------

constexpr int DWV_TW = 8;  // outputs wo of a strip
// V: channels of a thread, 4 (16 bytes fp32, 8 bytes bf16). TH: output rows
// ho of a strip; two rows read 4 x rows (5 at stride 2) instead of 6, which
// was faster in bf16 (about 125 registers) and slower in fp32 (about 150
// registers: three blocks an SM instead of four) in an A/B on an H100.
template <typename T> struct DwVec {
    static constexpr int V = 4;
    static constexpr int TH = sizeof(T) == 2 ? 2 : 1;
};

// Pass 1. Block (channel tile blockIdx.x, band blockIdx.y): threadIdx.x the
// thread's V channels in the tile, threadIdx.y its lane. A strip is TH
// output rows by DWV_TW outputs wo of one image, added wo by wo, the rows
// in order at each; band b holds the strips [S*b/P, S*(b+1)/P) of the S
// strips, and lane y walks strips y, y + blockDim.y, ... of its band. Idx
// is the type of a strip index: 32-bit whenever S + blockDim.y < 2^32.
template <typename T, int STRIDE, typename Idx>
__global__ void __launch_bounds__(VEC_THREADS)
depthwise3x3_dw_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           float* __restrict__ partials, int H, int W, int C, int Ho, int Wo,
                           int strips_per_row, int strip_rows, int64_t strips, int P) {
    constexpr int V = DwVec<T>::V;
    constexpr int TH = DwVec<T>::TH;
    constexpr int R = STRIDE * (TH - 1) + 3;  // x rows of a strip
    using VT = Vec<T, V>;
    __shared__ float red[VEC_THREADS * 9 * V];  // [lane][tap][channel of the tile]
    const int tile_c = blockDim.x * V;
    const int c_base = blockIdx.x * tile_c;
    const int c0 = c_base + threadIdx.x * V;
    const int band = blockIdx.y;
    const Idx p0 = (Idx)(strips * band / P);
    const Idx p1 = (Idx)(strips * (band + 1) / P);

    float acc[9][V];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;
    if (c0 < C) {
        for (Idx p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
            const int strip = (int)(p % (Idx)strips_per_row);
            const Idx q = p / (Idx)strips_per_row;
            const int ho0 = (int)(q % (Idx)strip_rows) * TH;
            const int64_t n = (int64_t)(q / (Idx)strip_rows);
            const int wo0 = strip * DWV_TW;
            const int hi0 = ho0 * STRIDE - 1;
            const T* rows[R];
            bool row_ok[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int hi = hi0 + r;
                row_ok[r] = hi >= 0 && hi < H;
                rows[r] = x + ((n * H + (row_ok[r] ? hi : 0)) * (int64_t)W) * C + c0;
            }
            const T* g_rows[TH];
            bool g_ok[TH];
#pragma unroll
            for (int o = 0; o < TH; ++o) {
                g_ok[o] = ho0 + o < Ho;
                g_rows[o] = g + ((n * Ho + (g_ok[o] ? ho0 + o : 0)) * (int64_t)Wo) * C + c0;
            }

            // win[j] holds x column STRIDE*wo - 1 + j of the current output
            typename VT::Raw win[3][R] = {};
#pragma unroll
            for (int j = 0; j < 3; ++j)
                load_column<T, V>(rows, row_ok, STRIDE * wo0 - 1 + j, W, C, win[j]);
#pragma unroll
            for (int t = 0; t < DWV_TW; ++t) {
                const int wo = wo0 + t;
                if (wo >= Wo) break;
                const int wi0 = STRIDE * wo - 1;
                if (t > 0) {
                    if (STRIDE == 1) {
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            win[0][r] = win[1][r];
                            win[1][r] = win[2][r];
                        }
                        load_column<T, V>(rows, row_ok, wi0 + 2, W, C, win[2]);
                    } else {
#pragma unroll
                        for (int r = 0; r < R; ++r) win[0][r] = win[2][r];
                        load_column<T, V>(rows, row_ok, wi0 + 1, W, C, win[1]);
                        load_column<T, V>(rows, row_ok, wi0 + 2, W, C, win[2]);
                    }
                }
#pragma unroll
                for (int o = 0; o < TH; ++o) {
                    if (!g_ok[o]) continue;
                    float gv[V];
                    VT::widen(VT::load(g_rows[o] + (int64_t)wo * C), gv);
#pragma unroll
                    for (int di = 0; di < 3; ++di) {
                        const int r = o * STRIDE + di;
                        if (!row_ok[r]) continue;
#pragma unroll
                        for (int dj = 0; dj < 3; ++dj) {
                            const int wi = wi0 + dj;
                            if (wi < 0 || wi >= W) continue;
                            float xv[V];
                            VT::widen(win[dj][r], xv);
#pragma unroll
                            for (int v = 0; v < V; ++v)
                                acc[di * 3 + dj][v] = fmaf(xv[v], gv[v], acc[di * 3 + dj][v]);
                        }
                    }
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v)
            red[(threadIdx.y * 9 + k) * tile_c + threadIdx.x * V + v] = acc[k][v];
    __syncthreads();
    // 9 * tile_c sums of the block's lanes, in lane order
    for (int o = threadIdx.y * blockDim.x + threadIdx.x; o < 9 * tile_c;
         o += blockDim.x * blockDim.y) {
        const int k = o / tile_c, cl = o % tile_c;
        float s = 0.0f;
        for (int y = 0; y < (int)blockDim.y; ++y) s += red[(y * 9 + k) * tile_c + cl];
        const int c = c_base + cl;
        if (c < C) partials[((int64_t)band * 9 + k) * C + c] = s;
    }
}

template <typename T, int STRIDE>
void launch_dw_vec(const T* x, const T* g, float* partials, int N, int H, int W, int C,
                   int Ho, int Wo, int P, cudaStream_t stream) {
    const int vectors = C / DwVec<T>::V;
    const int tile = vectors < VEC_TILE ? vectors : VEC_TILE;
    const dim3 block(tile, VEC_THREADS / tile);
    const dim3 grid((vectors + tile - 1) / tile, P);
    const int strips_per_row = (Wo + DWV_TW - 1) / DWV_TW;
    const int strip_rows = (Ho + DwVec<T>::TH - 1) / DwVec<T>::TH;
    const int64_t strips = (int64_t)N * strip_rows * strips_per_row;
    if (strips + block.y < ((int64_t)1 << 32)) {
        depthwise3x3_dw_vec_kernel<T, STRIDE, uint32_t><<<grid, block, 0, stream>>>(
            x, g, partials, H, W, C, Ho, Wo, strips_per_row, strip_rows, strips, P);
    } else {
        depthwise3x3_dw_vec_kernel<T, STRIDE, int64_t><<<grid, block, 0, stream>>>(
            x, g, partials, H, W, C, Ho, Wo, strips_per_row, strip_rows, strips, P);
    }
}

// ---- dw, pass 2 (both routes) ----------------------------------------------

constexpr int FIN_TX = 32;  // outputs of a finishing block: one warp's coalesced row
constexpr int FIN_TY = 32;  // partial lanes of a finishing block

// dw[c, k] = sum over p of partials[p, k, c]. Lane y of a block sums
// p = y, y + 32, ... of its 32 outputs, then the 32 lane sums are added in a
// fixed tree (lane y += lane y + s for s = 16, 8, 4, 2, 1), so two runs give
// bit-equal results; the chains stay short (P/32 loads) when P is a few
// hundred bands.
__global__ void __launch_bounds__(FIN_TX * FIN_TY)
depthwise3x3_dw_finish_kernel(const float* __restrict__ partials,
                              float* __restrict__ dw, int C, int P) {
    __shared__ float red[FIN_TY][FIN_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t nout = (int64_t)9 * C;
    const int64_t i = (int64_t)blockIdx.x * FIN_TX + tx;  // = k*C + c
    float s = 0.0f;
    if (i < nout) {
        for (int p = ty; p < P; p += FIN_TY) s += partials[(int64_t)p * nout + i];
    }
    red[ty][tx] = s;
#pragma unroll
    for (int half = FIN_TY / 2; half > 0; half /= 2) {
        __syncthreads();
        if (ty < half) red[ty][tx] += red[ty + half][tx];
    }
    if (ty == 0 && i < nout) {
        const int64_t k = i / C, c = i % C;
        dw[c * 9 + k] = red[0][tx];
    }
}

template <typename T>
cudaError_t dw_launch(const void* x, const void* g, void* partials, void* dw,
                      int N, int H, int W, int C, int stride, int P, int route,
                      cudaStream_t stream) {
    constexpr int V = DwVec<T>::V;
    const int vec_bytes = V * (int)sizeof(T);
    if (route == 1 && (C % V != 0 || !aligned(x, vec_bytes) || !aligned(g, vec_bytes)))
        return cudaErrorInvalidValue;
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const T* xp = static_cast<const T*>(x);
    const T* gp = static_cast<const T*>(g);
    float* pp = static_cast<float*>(partials);
    if (route == 1) {
        if (stride == 1) {
            launch_dw_vec<T, 1>(xp, gp, pp, N, H, W, C, Ho, Wo, P, stream);
        } else {
            launch_dw_vec<T, 2>(xp, gp, pp, N, H, W, C, Ho, Wo, P, stream);
        }
    } else {
        const int64_t Q = (int64_t)N * Ho * Wo;
        if (stride == 1) {
            launch_dw_partial<T, 1>(xp, gp, pp, H, W, C, Ho, Wo, Q, P, stream);
        } else {
            launch_dw_partial<T, 2>(xp, gp, pp, H, W, C, Ho, Wo, Q, P, stream);
        }
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t nout = (int64_t)9 * C;
    const int blocks = (int)((nout + FIN_TX - 1) / FIN_TX);
    depthwise3x3_dw_finish_kernel<<<blocks, dim3(FIN_TX, FIN_TY), 0, stream>>>(
        pp, static_cast<float*>(dw), C, P);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (g and dx); w is float32 (C,3,3).
// g is (N,Ho,Wo,C), dx (N,H,W,C), with Ho = (H-1)/stride+1, likewise Wo.
// route: 0 = scalar, 1 = channel vectors (C a multiple of 4 fp32 or 8 bf16,
// g and dx 16-byte aligned) in strips of tw (1, 2, 4 or 8) outputs; tw is
// read by route 1 only.
int dorknet_depthwise3x3_dx(const void* g, const void* w, void* dx, int N,
                            int H, int W, int C, int stride, int dtype,
                            int route, int tw, void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 0 || H < 1 || W < 1 || C < 0 ||
        (route != 0 && route != 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)dx_launch<float>(g, w, dx, N, H, W, C, stride, route, tw, s);
        case 1: return (int)dx_launch<__nv_bfloat16>(g, w, dx, N, H, W, C, stride, route, tw, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dtype: 0 = float32, 1 = bfloat16 (x and g); partials is float32 (P,9,C)
// scratch, dw float32 (C,3,3). N*Ho*Wo and C must be positive and
// 1 <= P <= 65535. route: 0 = scalar, 1 = channel vectors (C a multiple of
// 4, x and g aligned to 4 channels: 16 bytes fp32, 8 bytes bf16).
int dorknet_depthwise3x3_dw(const void* x, const void* g, void* partials,
                            void* dw, int N, int H, int W, int C, int stride,
                            int P, int dtype, int route, void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 1 || H < 1 || W < 1 || C < 1 ||
        P < 1 || P > 65535 || (route != 0 && route != 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)dw_launch<float>(x, g, partials, dw, N, H, W, C, stride, P, route, s);
        case 1: return (int)dw_launch<__nv_bfloat16>(x, g, partials, dw, N, H, W, C, stride, P,
                                                     route, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

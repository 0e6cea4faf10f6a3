// Depthwise 3x3 convolution, padding 1, stride 1 or 2, NHWC, forward (the
// backward is depthwise3x3_bwd.cu).
//
// Replaces: dorknet_tpu/ops/pallas/depthwise.py, function depthwise3x3 and
// its two Pallas bodies _fwd_kernel (stride 1) and _fwd2_kernel (stride 2).
//
//   y[n,ho,wo,c] = sum_{di,dj in 0..2} x[n, s*ho+di-1, s*wo+dj-1, c] * w[c,di,dj]
//
// Taps outside the image read zero. The sum is kept in fp32; x and y are
// fp32 or bf16, w is fp32 (C,3,3). Bias is added by the caller.
//
// What bounds it on an H100: device-memory bytes. Each output element costs
// 18 flops against one input and one output element of traffic (the nine
// taps overlap, so neighbouring threads reuse the same lines through L1 and
// L2). The flagship ResNet-18-depsep's 16 depthwise layers move about
// 12.4 MB per image in fp32 (input + output), about 0.79 GB at batch 64,
// which is about 0.24 ms at the card's published 3.35 TB/s.
//
// Two routes, chosen by the caller (ops/cuda/depthwise.py:_dw_route) and
// passed as `route`; both compute every output with the same fp32
// operations in the same order, so they agree bit for bit:
//
// Route 1, channel vectors (every C that is a multiple of V = 16 bytes of
// channels, 4 fp32 or 8 bf16, with x and y 16-byte aligned). A thread owns
// one vector of V channels of one output row (n, ho) and a strip of TW
// consecutive wo, and decomposes its index once per strip, not per element.
// Its block covers a range of at most 32 channel vectors (threadIdx.x) and
// stages their (C,3,3) weights into shared memory tap-major once, since a
// channel vector's tap is strided by 9 in w; each thread then keeps its nine
// weight vectors in registers. Along the strip it holds a window of three
// input columns x three rows of vectors, each loaded once with a 16-byte
// load (TW+2 columns a strip at stride 1, 2*TW+1 at stride 2), so the taps
// of neighbouring outputs are reused in registers, and each output vector
// leaves in one 16-byte store. The window keeps its vectors as loaded (four
// registers each, 8 bf16 as well as 4 fp32) and widens a tap to fp32 where
// it is used, so a bf16 thread needs about 150 registers rather than 190;
// blocks of 128 threads then let three blocks share an SM. TW (1, 2, 4 or
// 8) is chosen per layer by the caller from Wo and the SM count
// (ops/cuda/depthwise.py:dw_strip): the widest strip that still leaves 128
// threads an SM. Filling every thread slot of the card is not the aim
// (chip_smoke.py phase 5 times every width): the flagship's 7x7x512 layer at
// batch 64
// has 401k output vectors, a strip of 8 (7 outputs) leaves 57k threads, and
// that strip is still faster than narrower ones, since a wider strip reads
// each input vector once instead of up to three times. A shared-memory
// input tile with a halo was the alternative; registers were taken because
// the window already gives each input vector one load per strip, and the
// bounds checks stay the scalar kernel's.
//
// Route 0, scalar (every other C or alignment): one thread per output
// element with the channel index fastest, so a warp reads and writes 32
// neighbouring channels of one pixel, coalesced; the nine fp32 weights of a
// channel go through the read-only cache (__ldg). A grid-stride loop with
// 64-bit memory offsets covers any size; the flat index is decomposed in
// 32-bit arithmetic wherever the output allows (see Idx below).
//
// The arithmetic of both: taps in the order di outer, dj inner; a tap
// outside the image is skipped, not added as zero; one fp32
// fmaf(x, w, acc) per tap. None of the TPU kernel's workarounds are carried
// over: no padded copy of the input (bounds checks do the padding), no four
// stride-2 phase planes (strided taps are read directly), and no channel
// blocking against VMEM.
//
// C entry point: dorknet_depthwise3x3_fwd. It launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch; it refuses (cudaErrorInvalidValue) a
// route or a strip width the input cannot take.

#include "common.cuh"

namespace {

// Idx is the type of the flat output index and of its decomposition into
// (n, ho, wo, c): uint32_t whenever the output has fewer than 2^32
// elements, since a 64-bit division costs several times a 32-bit one and
// the six of them per element bound the kernel otherwise. Memory offsets
// are always 64-bit.
template <typename T, int STRIDE, typename Idx>
__global__ void depthwise3x3_fwd_kernel(const T* __restrict__ x,
                                        const float* __restrict__ w,
                                        T* __restrict__ y,
                                        int H, int W, int C, int Ho, int Wo,
                                        Idx total) {
    const Idx step = (Idx)gridDim.x * blockDim.x;
    for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += step) {
        const int c = (int)(i % (Idx)C);
        Idx p = i / (Idx)C;
        const int wo = (int)(p % (Idx)Wo);
        p /= (Idx)Wo;
        const int ho = (int)(p % (Idx)Ho);
        const int64_t n = (int64_t)(p / (Idx)Ho);

        const float* wc = w + (int64_t)c * 9;
        const int hi0 = ho * STRIDE - 1;
        const int wi0 = wo * STRIDE - 1;
        float acc = 0.0f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
            const int hi = hi0 + di;
            if (hi < 0 || hi >= H) continue;
            const T* row = x + ((n * H + hi) * (int64_t)W) * C + c;
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
                const int wi = wi0 + dj;
                if (wi < 0 || wi >= W) continue;
                acc = fmaf(load_f32(row + (int64_t)wi * C), __ldg(wc + di * 3 + dj), acc);
            }
        }
        store_f32(y + i, acc);
    }
}

template <typename T, int STRIDE>
void launch_kernel(const T* x, const float* w, T* y, int H, int W, int C,
                   int Ho, int Wo, int64_t total, int blocks, int threads,
                   cudaStream_t stream) {
    // the loop's last i + step must not wrap a 32-bit index either
    const int64_t step = (int64_t)blocks * threads;
    if (total + step < ((int64_t)1 << 32)) {
        depthwise3x3_fwd_kernel<T, STRIDE, uint32_t><<<blocks, threads, 0, stream>>>(
            x, w, y, H, W, C, Ho, Wo, (uint32_t)total);
    } else {
        depthwise3x3_fwd_kernel<T, STRIDE, int64_t><<<blocks, threads, 0, stream>>>(
            x, w, y, H, W, C, Ho, Wo, total);
    }
}

// ---- route 1: channel vectors (Vec, load_column: common.cuh) -------------

// Grid: x over strips (n, ho, strip of TW wo) in a grid-stride loop,
// threadIdx.y the strip lane; y over tiles of VEC_TILE channel vectors,
// threadIdx.x the vector in the tile. Idx as in the scalar kernel.
template <typename T, int STRIDE, int TW, typename Idx>
__global__ void __launch_bounds__(VEC_THREADS)
depthwise3x3_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            T* __restrict__ y, int H, int W, int C, int Ho, int Wo,
                            int strips_per_row, Idx strips) {
    constexpr int V = Vec<T>::V;
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
        const int ho = (int)(q % (Idx)Ho);
        const int64_t n = (int64_t)(q / (Idx)Ho);
        const int wo0 = strip * TW;
        const int hi0 = ho * STRIDE - 1;
        const T* rows[3];
        bool row_ok[3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
            const int hi = hi0 + di;
            row_ok[di] = hi >= 0 && hi < H;
            rows[di] = x + ((n * H + (row_ok[di] ? hi : 0)) * (int64_t)W) * C + c0;
        }
        T* y_row = y + ((n * Ho + ho) * (int64_t)Wo) * C + c0;

        // win[j] holds input column STRIDE*wo - 1 + j of the current output
        typename Vec<T>::Raw win[3][3] = {};
#pragma unroll
        for (int j = 0; j < 3; ++j)
            load_column<T>(rows, row_ok, STRIDE * wo0 - 1 + j, W, C, win[j]);
#pragma unroll
        for (int t = 0; t < TW; ++t) {
            const int wo = wo0 + t;
            if (wo >= Wo) break;
            const int wi0 = STRIDE * wo - 1;
            if (t > 0) {
                if (STRIDE == 1) {
#pragma unroll
                    for (int di = 0; di < 3; ++di) {
                        win[0][di] = win[1][di];
                        win[1][di] = win[2][di];
                    }
                    load_column<T>(rows, row_ok, wi0 + 2, W, C, win[2]);
                } else {
#pragma unroll
                    for (int di = 0; di < 3; ++di) win[0][di] = win[2][di];
                    load_column<T>(rows, row_ok, wi0 + 1, W, C, win[1]);
                    load_column<T>(rows, row_ok, wi0 + 2, W, C, win[2]);
                }
            }
            float acc[V];
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
            for (int di = 0; di < 3; ++di) {
                if (!row_ok[di]) continue;
#pragma unroll
                for (int dj = 0; dj < 3; ++dj) {
                    const int wi = wi0 + dj;
                    if (wi < 0 || wi >= W) continue;
                    float xv[V];
                    Vec<T>::widen(win[dj][di], xv);
#pragma unroll
                    for (int v = 0; v < V; ++v) acc[v] = fmaf(xv[v], wr[di * 3 + dj][v], acc[v]);
                }
            }
            Vec<T>::store(y_row + (int64_t)wo * C, acc);
        }
    }
}

template <typename T, int STRIDE, int TW>
cudaError_t launch_vec_tw(const T* x, const float* w, T* y, int N, int H, int W, int C, int Ho,
                          int Wo, cudaStream_t stream) {
    constexpr int V = Vec<T>::V;
    const int vectors = C / V;
    const int tile = vectors < VEC_TILE ? vectors : VEC_TILE;
    const dim3 block(tile, VEC_THREADS / tile);
    const int strips_per_row = (Wo + TW - 1) / TW;
    const int64_t strips = (int64_t)N * Ho * strips_per_row;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(strips, block.y, &blocks);
    if (err != cudaSuccess) return err;
    const dim3 grid(blocks, (vectors + tile - 1) / tile);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const int64_t step = (int64_t)blocks * block.y;
    if (strips + step < ((int64_t)1 << 32)) {
        depthwise3x3_fwd_vec_kernel<T, STRIDE, TW, uint32_t><<<grid, block, 0, stream>>>(
            x, w, y, H, W, C, Ho, Wo, strips_per_row, (uint32_t)strips);
    } else {
        depthwise3x3_fwd_vec_kernel<T, STRIDE, TW, int64_t><<<grid, block, 0, stream>>>(
            x, w, y, H, W, C, Ho, Wo, strips_per_row, strips);
    }
    return cudaGetLastError();
}

template <typename T, int STRIDE>
cudaError_t launch_vec(const T* x, const float* w, T* y, int N, int H, int W, int C, int Ho,
                       int Wo, int tw, cudaStream_t stream) {
    switch (tw) {
        case 1: return launch_vec_tw<T, STRIDE, 1>(x, w, y, N, H, W, C, Ho, Wo, stream);
        case 2: return launch_vec_tw<T, STRIDE, 2>(x, w, y, N, H, W, C, Ho, Wo, stream);
        case 4: return launch_vec_tw<T, STRIDE, 4>(x, w, y, N, H, W, C, Ho, Wo, stream);
        case 8: return launch_vec_tw<T, STRIDE, 8>(x, w, y, N, H, W, C, Ho, Wo, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int N, int H, int W,
                   int C, int stride, int route, int tw, cudaStream_t stream) {
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const int64_t total = (int64_t)N * Ho * Wo * C;
    if (route == 1 && (C % Vec<T>::V != 0 || !aligned16(x) || !aligned16(y) ||
                       (tw != 1 && tw != 2 && tw != 4 && tw != 8)))
        return cudaErrorInvalidValue;
    if (total == 0) return cudaSuccess;
    const T* xp = static_cast<const T*>(x);
    const float* wp = static_cast<const float*>(w);
    T* yp = static_cast<T*>(y);
    if (route == 1) {
        return stride == 1 ? launch_vec<T, 1>(xp, wp, yp, N, H, W, C, Ho, Wo, tw, stream)
                           : launch_vec<T, 2>(xp, wp, yp, N, H, W, C, Ho, Wo, tw, stream);
    }

    const int threads = 256;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(total, threads, &blocks);
    if (err != cudaSuccess) return err;
    if (stride == 1) {
        launch_kernel<T, 1>(xp, wp, yp, H, W, C, Ho, Wo, total, blocks, threads, stream);
    } else {
        launch_kernel<T, 2>(xp, wp, yp, H, W, C, Ho, Wo, total, blocks, threads, stream);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); w is always float32 (C,3,3).
// route: 0 = scalar, 1 = channel vectors (C a multiple of 4 fp32 or 8 bf16,
// x and y 16-byte aligned) in strips of tw (1, 2, 4 or 8) outputs; tw is
// read by route 1 only. device: the CUDA device the pointers and the stream
// belong to.
int dorknet_depthwise3x3_fwd(const void* x, const void* w, void* y, int N,
                             int H, int W, int C, int stride, int dtype,
                             int route, int tw, void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 0 || H < 1 || W < 1 || C < 0 ||
        (route != 0 && route != 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)launch<float>(x, w, y, N, H, W, C, stride, route, tw, s);
        case 1: return (int)launch<__nv_bfloat16>(x, w, y, N, H, W, C, stride, route, tw, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* dorknet_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

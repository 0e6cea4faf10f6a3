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
// What the design does about it:
// - dx: one thread per element of dx, channel index fastest, so a warp reads
//   32 neighbouring channels of g and writes 32 of dx, coalesced. It is the
//   transpose of the forward read directly: no zero-dilated or padded copy
//   of g is made (the TPU kernel needs both), and at stride 2 the taps whose
//   source row or column is odd are skipped by a parity test.
// - dw: a reduction over N*Ho*Wo for each of the 9*C taps. Done in two
//   passes without atomics, so that two runs give bit-equal results. Pass 1:
//   a block of 32 channels x 8 pixel lanes owns one band of the flattened
//   (n, ho, wo) pixels and one channel tile; each thread keeps its nine tap
//   sums in registers while it walks the band, so a warp reads 32
//   neighbouring channels of x and g, coalesced, and every element of g is
//   loaded once. The 8 lanes are summed in shared memory in a fixed order
//   and the block writes its (9, 32) slice of the fp32 partials (P, 9, C).
//   Pass 2 sums the P partials of each tap, again in a fixed order. The
//   partials are small beside x and g (P is chosen by the caller to fill the
//   card about eight blocks per SM).
//
// C entry points: dorknet_depthwise3x3_dx and dorknet_depthwise3x3_dw. They
// launch on the caller's stream, do not synchronise, allocate nothing, and
// return cudaGetLastError() after the launches.

#include "common.cuh"

namespace {

// dx: the flat index of dx decomposed into (n, h, w, c) in Idx arithmetic,
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
                acc += load_f32(row + (int64_t)wo * C) * __ldg(wc + di * 3 + dj);
            }
        }
        store_f32(dx + i, acc);
    }
}

template <typename T, int STRIDE>
void launch_dx(const T* g, const float* w, T* dx, int64_t total, int H, int W,
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

template <typename T>
cudaError_t dx_launch(const void* g, const void* w, void* dx, int N, int H,
                      int W, int C, int stride, cudaStream_t stream) {
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const int64_t total = (int64_t)N * H * W * C;
    if (total == 0) return cudaSuccess;
    const int threads = 256;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(total, threads, &blocks);
    if (err != cudaSuccess) return err;
    const T* gp = static_cast<const T*>(g);
    const float* wp = static_cast<const float*>(w);
    T* dxp = static_cast<T*>(dx);
    if (stride == 1) {
        launch_dx<T, 1>(gp, wp, dxp, total, H, W, C, Ho, Wo, blocks, threads, stream);
    } else {
        launch_dx<T, 2>(gp, wp, dxp, total, H, W, C, Ho, Wo, blocks, threads, stream);
    }
    return cudaGetLastError();
}

constexpr int DW_TX = 32;  // channels of a block: one warp
constexpr int DW_TY = 8;   // pixel lanes of a block

// dw pass 1. Block (channel tile blockIdx.x, band blockIdx.y) of the P bands
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

// dw pass 2: dw[c, k] = sum over p of partials[p, k, c]. A block of 32
// outputs x 8 lanes; lane y sums p = y, y+8, ... and the 8 lane sums are
// added in lane order.
__global__ void __launch_bounds__(DW_TX * DW_TY)
depthwise3x3_dw_finish_kernel(const float* __restrict__ partials,
                              float* __restrict__ dw, int C, int P) {
    __shared__ float red[DW_TY][DW_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t nout = (int64_t)9 * C;
    const int64_t i = (int64_t)blockIdx.x * DW_TX + tx;  // = k*C + c
    float s = 0.0f;
    if (i < nout) {
        for (int p = ty; p < P; p += DW_TY) s += partials[(int64_t)p * nout + i];
    }
    red[ty][tx] = s;
    __syncthreads();
    if (ty == 0 && i < nout) {
        float total = 0.0f;
#pragma unroll
        for (int y = 0; y < DW_TY; ++y) total += red[y][tx];
        const int64_t k = i / C, c = i % C;
        dw[c * 9 + k] = total;
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

template <typename T>
cudaError_t dw_launch(const void* x, const void* g, void* partials, void* dw,
                      int N, int H, int W, int C, int stride, int P,
                      cudaStream_t stream) {
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const int64_t Q = (int64_t)N * Ho * Wo;
    const T* xp = static_cast<const T*>(x);
    const T* gp = static_cast<const T*>(g);
    float* pp = static_cast<float*>(partials);
    if (stride == 1) {
        launch_dw_partial<T, 1>(xp, gp, pp, H, W, C, Ho, Wo, Q, P, stream);
    } else {
        launch_dw_partial<T, 2>(xp, gp, pp, H, W, C, Ho, Wo, Q, P, stream);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t nout = (int64_t)9 * C;
    const int blocks = (int)((nout + DW_TX - 1) / DW_TX);
    depthwise3x3_dw_finish_kernel<<<blocks, dim3(DW_TX, DW_TY), 0, stream>>>(
        pp, static_cast<float*>(dw), C, P);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (g and dx); w is float32 (C,3,3).
// g is (N,Ho,Wo,C), dx (N,H,W,C), with Ho = (H-1)/stride+1, likewise Wo.
int dorknet_depthwise3x3_dx(const void* g, const void* w, void* dx, int N,
                            int H, int W, int C, int stride, int dtype,
                            void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 0 || H < 1 || W < 1 || C < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)dx_launch<float>(g, w, dx, N, H, W, C, stride, s);
        case 1: return (int)dx_launch<__nv_bfloat16>(g, w, dx, N, H, W, C, stride, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dtype: 0 = float32, 1 = bfloat16 (x and g); partials is float32 (P,9,C)
// scratch, dw float32 (C,3,3). N*Ho*Wo and C must be positive and
// 1 <= P <= 65535.
int dorknet_depthwise3x3_dw(const void* x, const void* g, void* partials,
                            void* dw, int N, int H, int W, int C, int stride,
                            int P, int dtype, void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 1 || H < 1 || W < 1 || C < 1 ||
        P < 1 || P > 65535)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)dw_launch<float>(x, g, partials, dw, N, H, W, C, stride, P, s);
        case 1: return (int)dw_launch<__nv_bfloat16>(x, g, partials, dw, N, H, W, C, stride, P, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"

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
// What the design does about it: one thread per output element with the
// channel index fastest, so a warp reads and writes 32 neighbouring channels
// of one pixel, coalesced, and each input line is fetched from device memory
// about once while the nine taps hit it in cache. The nine fp32 weights of a
// channel go through the read-only cache (__ldg). None of the TPU kernel's
// workarounds are carried over: no padded copy of the input (bounds checks
// do the padding), no four stride-2 phase planes (strided taps are read
// directly), and no channel blocking against VMEM. A grid-stride loop with
// 64-bit memory offsets covers any size; the flat index is decomposed in
// 32-bit arithmetic wherever the output allows (see Idx below).
//
// C entry point: dorknet_depthwise3x3_fwd. It launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.

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
                acc += load_f32(row + (int64_t)wi * C) * __ldg(wc + di * 3 + dj);
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

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int N, int H, int W,
                   int C, int stride, cudaStream_t stream) {
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const int64_t total = (int64_t)N * Ho * Wo * C;
    if (total == 0) return cudaSuccess;

    const int threads = 256;
    int blocks = 0;
    const cudaError_t err = grid_stride_blocks(total, threads, &blocks);
    if (err != cudaSuccess) return err;

    const T* xp = static_cast<const T*>(x);
    const float* wp = static_cast<const float*>(w);
    T* yp = static_cast<T*>(y);
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
// device: the CUDA device the pointers and the stream belong to.
int dorknet_depthwise3x3_fwd(const void* x, const void* w, void* y, int N,
                             int H, int W, int C, int stride, int dtype,
                             void* stream, int device) {
    if ((stride != 1 && stride != 2) || N < 0 || H < 1 || W < 1 || C < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)launch<float>(x, w, y, N, H, W, C, stride, s);
        case 1: return (int)launch<__nv_bfloat16>(x, w, y, N, H, W, C, stride, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* dorknet_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused training augmentation of a uint8 BGR batch: crop, cv2-matched HSV
// scaling, three-shear rotation and horizontal flip, one pass from the
// (B, H, W, 3) HWC input to the (B, 3, oh, ow) uint8 planes.
//
// Replaces: dorknet_tpu/ops/pallas/augment.py, function augment_planes_fused
// and its Pallas body _aug_kernel (with _rotate_one, _shift_resample_kernel
// and _hsv_apply). It computes what the JAX package's planes path,
// data_loading/device_augment.py:augment_batch_planes, computes for uint8
// input, rounding as it rounds:
//
//   crop     x[n, r + y, c + x, :] (r, c from the table for every crop mode)
//   HSV      cv2 HSV of (b, g, r), scaled by (sh, ss, sv), clipped, back to
//            BGR in fp32, rounded half up to uint8
//   rotate   three shears out[i] = lerp(in[i + t]), t = coef*(coord - ctr) + P
//            clipped to [0, t_hi]; along W with a over the rows, along H
//            with b over the columns of the P-padded image, along W with a
//            again; every read index wraps modulo the padded length, and
//            each shear rounds half up to uint8
//   flip     the output column mirrored when the table says so
//
// Every multiply, add and divide of the HSV and lerp arithmetic is written
// with the round-to-nearest intrinsics so that nvcc cannot contract a*b + c
// into one FMA: the plain PyTorch version rounds each operation separately,
// and the aim is bit-equality with it.
//
// The per-image table (B, 8) fp32 is [r, c, sh, ss, sv, a, b, flip], with
// a = -tan(theta/2) and b = sin(theta) computed by the caller: the kernel
// computes no trigonometry.
//
// What bounds it on an H100: device-memory bytes. Each image is read once
// (3 H W bytes) and written once (3 oh ow bytes), about 23.3 MB at the
// flagship's batch of 60 images 281 -> 225, or 7 us at 3.35 TB/s; its
// arithmetic (about 50 flops a pixel for HSV, 7 a pixel of each shear) is
// below that at 67 TFLOP/s.
//
// What the design does about it: one block per (image, channel) holds the
// whole channel in shared memory through the three shears, in two uint8
// stage buffers of oh x (ow + 2P) (130,050 bytes at the flagship's size,
// P = 32), so device memory sees one read of the image and one write of the
// channel. Only rows that carry content are kept: the first shear's margin
// rows are zero, and the third shear writes only the P:P+ow columns,
// straight to the output with the flip folded into the store. A block
// reads its crop at its origin directly (the TPU kernel barrel-shifts it,
// because Mosaic rejects unaligned dynamic reads) and recomputes the HSV of
// each pixel from its three bytes, since its channel depends on all three.
// Each line's shift (floor and fraction) is computed once into shared
// memory. Without rotation a grid-stride kernel writes each output byte
// from its three input bytes, with no shared memory.
//
// C entry points: dorknet_augment_planes, which launches on the caller's
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launch; and dorknet_max_block_smem, the
// shared memory a block of the device can opt into.

#include "common.cuh"

namespace {

constexpr int kRotateThreads = 1024;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// Round half up to uint8 with the clamp that keeps a value from wrapping.
__device__ __forceinline__ uint8_t round_u8(float v) {
    return (uint8_t)__float2int_rz(clampf(__fadd_rn(v, 0.5f), 0.f, 255.f));
}

// One output channel of the HSV perturbation of the BGR pixel px, as
// device_augment.py's _bgr_to_hsv_chw, hsv_batch_planes and
// _hsv_to_bgr_chw compute it in fp32.
__device__ __forceinline__ uint8_t hsv_channel(const uint8_t* px, int ch, float sh,
                                               float ss, float sv) {
    const float kInv255 = 1.0f / 255.0f;  // the fp32 reciprocals, correctly rounded
    const float kInv60 = 1.0f / 60.0f;
    const float b = px[0], g = px[1], r = px[2];
    float v = fmaxf(fmaxf(b, g), r);
    const float mn = fminf(fminf(b, g), r);
    const float diff = __fsub_rn(v, mn);
    const float safe = diff == 0.f ? 1.f : diff;
    float h;
    if (v == r) {
        h = __fdiv_rn(__fmul_rn(60.f, __fsub_rn(g, b)), safe);
    } else if (v == g) {
        h = __fadd_rn(120.f, __fdiv_rn(__fmul_rn(60.f, __fsub_rn(b, r)), safe));
    } else {
        h = __fadd_rn(240.f, __fdiv_rn(__fmul_rn(60.f, __fsub_rn(r, g)), safe));
    }
    if (diff == 0.f) h = 0.f;
    if (h < 0.f) h = __fadd_rn(h, 360.f);
    h = __fmul_rn(h, 0.5f);
    float s = v == 0.f ? 0.f : __fdiv_rn(__fmul_rn(255.f, diff), v);

    h = clampf(__fmul_rn(h, sh), 0.f, 179.f);
    s = clampf(__fmul_rn(s, ss), 0.f, 255.f);
    v = clampf(__fmul_rn(v, sv), 0.f, 255.f);

    const float c = __fmul_rn(v, __fmul_rn(s, kInv255));
    const float hp = __fmul_rn(__fmul_rn(h, 2.f), kInv60);
    const float x = __fmul_rn(c, __fsub_rn(1.f, fabsf(__fsub_rn(fmodf(hp, 2.f), 1.f))));
    const int idx = min(max((int)floorf(hp), 0), 5);
    // sector tables of (r, g, b) = c, x or 0, as _hsv_to_bgr_chw's selects
    float sel;
    if (ch == 0) {         // blue:  0 0 x c c x
        sel = idx < 2 ? 0.f : (idx == 2 || idx == 5) ? x : c;
    } else if (ch == 1) {  // green: x c c x 0 0
        sel = idx >= 4 ? 0.f : (idx == 0 || idx == 3) ? x : c;
    } else {               // red:   c x 0 0 x c
        sel = (idx == 2 || idx == 3) ? 0.f : (idx == 1 || idx == 4) ? x : c;
    }
    const float out = clampf(__fadd_rn(sel, __fsub_rn(v, c)), 0.f, 255.f);
    return round_u8(out);
}

// The shift of one line of a shear: t = coef * (coord - centre) + P clipped
// to [0, t_hi], split into floor and fraction.
__device__ __forceinline__ void line_shift(float coef, float coord, int P, float t_hi,
                                           int* t0, float* frac) {
    const float t = clampf(__fadd_rn(__fmul_rn(coef, coord), (float)P), 0.f, t_hi);
    const float f = floorf(t);
    *t0 = (int)f;
    *frac = __fsub_rn(t, f);
}

// The lerp of two uint8 values in fp32, rounded half up.
__device__ __forceinline__ uint8_t lerp_u8(uint8_t v0, uint8_t v1, float frac) {
    return round_u8(__fadd_rn(__fmul_rn(__fsub_rn(1.f, frac), (float)v0),
                              __fmul_rn(frac, (float)v1)));
}

// Without rotation: one output byte per iteration, (n, ch, y, x) with x
// fastest, from the three bytes of its source pixel.
template <bool HSV>
__global__ void augment_pointwise_kernel(const uint8_t* __restrict__ img,
                                         const float* __restrict__ table,
                                         uint8_t* __restrict__ out, int H, int W,
                                         int oh, int ow, int64_t total) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += step) {
        const int xo = (int)(i % ow);
        int64_t p = i / ow;
        const int y = (int)(p % oh);
        p /= oh;
        const int ch = (int)(p % 3);
        const int64_t n = p / 3;
        const float* prm = table + n * 8;
        const int xs = prm[7] != 0.f ? ow - 1 - xo : xo;
        const uint8_t* px =
            img + ((n * H + (int)prm[0] + y) * (int64_t)W + (int)prm[1] + xs) * 3;
        out[i] = HSV ? hsv_channel(px, ch, prm[2], prm[3], prm[4]) : px[ch];
    }
}

// With rotation: one block per (image, channel), blockIdx.x = n * 3 + ch.
// Shared memory: stage buffers sa and sb of oh x Wp bytes (Wp = ow + 2P),
// then the per-line shifts: int t0 and float frac for the oh rows (shears
// 1 and 3 use the same row coordinates) and the Wp columns (shear 2).
template <bool HSV>
__global__ void __launch_bounds__(kRotateThreads)
augment_rotate_kernel(const uint8_t* __restrict__ img, const float* __restrict__ table,
                      uint8_t* __restrict__ out, int H, int W, int oh, int ow, int P,
                      float t_hi) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int Wp = ow + 2 * P;
    const int Hp = oh + 2 * P;
    const int n = blockIdx.x / 3;
    const int ch = blockIdx.x - 3 * n;
    uint8_t* sa = smem;
    uint8_t* sb = smem + oh * Wp;
    int* row_t0 = reinterpret_cast<int*>(smem + ((2 * oh * Wp + 3) & ~3));
    float* row_frac = reinterpret_cast<float*>(row_t0 + oh);
    int* col_t0 = reinterpret_cast<int*>(row_frac + oh);
    float* col_frac = reinterpret_cast<float*>(col_t0 + Wp);

    const float* prm = table + (int64_t)n * 8;
    const int r0 = (int)prm[0], c0 = (int)prm[1];
    const float sh = prm[2], ss = prm[3], sv = prm[4];
    const float a = prm[5], b = prm[6];
    const bool flip = prm[7] != 0.f;
    const float cy = 0.5f * (float)oh, cx = 0.5f * (float)ow;
    const uint8_t* src = img + (int64_t)n * H * W * 3;

    // the shifts: rows y (coordinate y - cy), columns j (coordinate j - P - cx)
    for (int i = threadIdx.x; i < oh + Wp; i += blockDim.x) {
        if (i < oh) {
            line_shift(a, __fsub_rn((float)i, cy), P, t_hi, row_t0 + i, row_frac + i);
        } else {
            const int j = i - oh;
            line_shift(b, __fsub_rn((float)(j - P), cx), P, t_hi, col_t0 + j, col_frac + j);
        }
    }
    // stage 0: the crop of this channel (after HSV) into sb, pitch ow
    for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
        const int y = i / ow, xx = i - y * ow;
        const uint8_t* px = src + ((int64_t)(r0 + y) * W + c0 + xx) * 3;
        sb[i] = HSV ? hsv_channel(px, ch, sh, ss, sv) : px[ch];
    }
    __syncthreads();
    // shear 1, along W over the content rows: padded column k holds crop
    // column k - P for P <= k < P + ow and zero elsewhere; sb -> sa
    for (int i = threadIdx.x; i < oh * Wp; i += blockDim.x) {
        const int y = i / Wp, j = i - y * Wp;
        const int t0 = row_t0[y];
        int k0 = (j + t0 - P) % Wp;
        if (k0 < 0) k0 += Wp;
        const int k1 = k0 + 1 == Wp ? 0 : k0 + 1;
        const uint8_t* line = sb + y * ow;
        const uint8_t v0 = (k0 >= P && k0 < P + ow) ? line[k0 - P] : 0;
        const uint8_t v1 = (k1 >= P && k1 < P + ow) ? line[k1 - P] : 0;
        sa[i] = lerp_u8(v0, v1, row_frac[y]);
    }
    __syncthreads();
    // shear 2, along H over all Wp columns, keeping padded rows P..P+oh-1:
    // padded row k holds sa's row k - P for P <= k < P + oh and zero
    // elsewhere; sa -> sb
    for (int i = threadIdx.x; i < oh * Wp; i += blockDim.x) {
        const int y = i / Wp, j = i - y * Wp;
        int k0 = (y + col_t0[j]) % Hp;  // (y + P) + t0 - P
        const int k1 = k0 + 1 == Hp ? 0 : k0 + 1;
        const uint8_t v0 = (k0 >= P && k0 < P + oh) ? sa[(k0 - P) * Wp + j] : 0;
        const uint8_t v1 = (k1 >= P && k1 < P + oh) ? sa[(k1 - P) * Wp + j] : 0;
        sb[i] = lerp_u8(v0, v1, col_frac[j]);
    }
    __syncthreads();
    // shear 3, along W, output columns P..P+ow-1 only, flipped on the store
    uint8_t* dst = out + ((int64_t)n * 3 + ch) * oh * ow;
    for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
        const int y = i / ow, xo = i - y * ow;
        int k0 = (xo + row_t0[y]) % Wp;  // (xo + P) + t0 - P
        const int k1 = k0 + 1 == Wp ? 0 : k0 + 1;
        const uint8_t* line = sb + y * Wp;
        dst[y * ow + (flip ? ow - 1 - xo : xo)] = lerp_u8(line[k0], line[k1], row_frac[y]);
    }
}

}  // namespace

extern "C" {

// The dynamic shared memory a block of `device` can opt into, in bytes, or
// the negated CUDA error code.
int dorknet_max_block_smem(int device) {
    int v = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return err == cudaSuccess ? v : -(int)err;
}

// x: (B, H, W, 3) uint8; table: (B, 8) fp32; out: (B, 3, oh, ow) uint8.
// P = 0: no rotation; else the rotation's zero margin, with t_hi =
// 2^bitlen(2P - 2) - 1. hsv: 0 or 1.
int dorknet_augment_planes(const void* x, const void* table, void* out, int B, int H,
                           int W, int oh, int ow, int P, float t_hi, int hsv,
                           void* stream, int device) {
    if (B < 0 || oh < 1 || ow < 1 || oh > H || ow > W || P < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* xp = static_cast<const uint8_t*>(x);
    const float* tp = static_cast<const float*>(table);
    uint8_t* op = static_cast<uint8_t*>(out);
    if (P == 0) {
        const int64_t total = (int64_t)B * 3 * oh * ow;
        const int threads = 256;
        int blocks = 0;
        err = grid_stride_blocks(total, threads, &blocks);
        if (err != cudaSuccess) return (int)err;
        if (hsv) {
            augment_pointwise_kernel<true><<<blocks, threads, 0, s>>>(xp, tp, op, H, W, oh,
                                                                      ow, total);
        } else {
            augment_pointwise_kernel<false><<<blocks, threads, 0, s>>>(xp, tp, op, H, W, oh,
                                                                       ow, total);
        }
        return (int)cudaGetLastError();
    }
    const int Wp = ow + 2 * P;
    const size_t smem = (size_t)((2 * oh * Wp + 3) & ~3) + (size_t)8 * (oh + Wp);
    auto kernel = hsv ? augment_rotate_kernel<true> : augment_rotate_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B * 3, kRotateThreads, smem, s>>>(xp, tp, op, H, W, oh, ow, P, t_hi);
    return (int)cudaGetLastError();
}

}  // extern "C"

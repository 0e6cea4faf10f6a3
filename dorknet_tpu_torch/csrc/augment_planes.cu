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
// What bounds it on an H100: device-memory bytes. Each crop is read once
// (3 oh ow bytes) and written once, 18.2 MB at the flagship's batch of 60
// images 281 -> 225, or 5.4 us at 3.35 TB/s; its arithmetic (about 40 flops
// a pixel for HSV, 7 a pixel of each shear) is below that at 67 TFLOP/s.
// What holds it back is instruction issue: every lerp converts two bytes
// and rounds one, the HSV of a pixel takes two correctly rounded divisions,
// and a rotated output byte costs more than three lerps.
//
// Two designs with rotation, chosen by the caller (ops/cuda/augment.py) and
// passed as `route`:
//
// - 1, "band" (augment_band_kernel), the one the port runs. A block owns a
//   tile of output rows x columns (a band of rows cut into column chunks) of
//   one image, all three channels, so the grid holds many short blocks
//   (900 at the flagship's size, tiles of 45 x 75) and four fit an SM.
//   Shear 1 is row-local, shear 2 column-local, shear 3 row-local, so going
//   back from the tile gives the windows it needs: the columns J of shear
//   2's output that shear 3 reads, the padded rows R that shear 2 reads
//   there, the crop columns K that shear 1 reads on those rows. Every shift
//   is monotone along its lines, so the ends of a run bound a window; each
//   window is a run of a circular index space (reads wrap modulo the padded
//   length, which puts the top rows of the image in a bottom band's R once
//   t_hi > 2P and a column's shift reaches 3P). The block stages only R x J
//   after shear 1: each pixel of K x R goes through HSV once for its three
//   channels (the plane route recomputes it in each channel's block), and
//   the halo beyond the tile is a few rows and columns, not the whole
//   plane. Crop rows come in as aligned 4-byte words and are de-interleaved
//   from shared memory. Loops run over rows, then columns: no division, and
//   a read's slot is its loop index plus a constant of its line, so only
//   the staging wraps an index (by compare and subtract), once a staged
//   element. Bytes become floats and back without the conversion unit
//   (u8_to_f32, floor_int). The windows' capacities come from
//   the largest coefficient the margin P allows; a tile whose windows exceed
//   them (a table with angles beyond P's range) computes each output byte
//   from the input through the three shears instead, so every size runs.
// - 0, "plane" (augment_rotate_kernel), kept to be timed against it: one
//   block per (image, channel) holds the whole channel in shared memory
//   through the three shears, in two uint8 stage buffers of oh x (ow + 2P)
//   (130,050 bytes at the flagship's size, P = 32), so only oh x ow up to
//   about 227 KB / 2 fits, and one block fills an SM: 180 blocks run in two
//   waves.
//
// A block reads its crop at its origin directly (the TPU kernel barrel-
// shifts it, because Mosaic rejects unaligned dynamic reads). Each line's
// shift (floor and fraction) comes from one expression wherever it is used.
// Without rotation a kernel of 8 rows x 32 columns a block writes the three
// output bytes of a pixel from its three input bytes, with no shared memory
// and no division.
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

// uint8 <-> fp32 and floors without the conversion unit (I2F, F2I and FRND
// issue at a small fraction of the FMA rate on Hopper, and every lerp needs
// three): the bits 0x4B000000 | v are the float 2^23 + v, so subtracting
// 2^23 gives v exactly; and for 0 <= t < 2^23, t + 2^23 rounded toward zero
// is 2^23 + floor(t) exactly.
constexpr float kTwo23 = 8388608.f;

__device__ __forceinline__ float u8_to_f32(uint32_t v) {
    return __fsub_rn(__uint_as_float(0x4B000000u | v), kTwo23);
}
__device__ __forceinline__ int floor_int(float t) {  // 0 <= t < 2^23
    return __float_as_int(__fadd_rz(t, kTwo23)) - 0x4B000000;
}
__device__ __forceinline__ float floor_f32(float t) {  // 0 <= t < 2^23
    return __fsub_rn(__fadd_rz(t, kTwo23), kTwo23);
}

// Round half up to uint8 with the clamp that keeps a value from wrapping
// (the truncation of a value in [0, 255] is its floor).
__device__ __forceinline__ uint8_t round_u8(float v) {
    return (uint8_t)floor_int(clampf(__fadd_rn(v, 0.5f), 0.f, 255.f));
}

// The HSV perturbation of the BGR pixel px, as device_augment.py's
// _bgr_to_hsv_chw, hsv_batch_planes and _hsv_to_bgr_chw compute it in fp32,
// up to the choice of channel (hsv_select): the chroma c, the second
// component x, the offset m = v - c and the hue sector idx.
struct HsvPixel {
    float c, x, m;
    int idx;
};

__device__ __forceinline__ HsvPixel hsv_pixel(const uint8_t* px, float sh, float ss,
                                              float sv) {
    const float kInv255 = 1.0f / 255.0f;  // the fp32 reciprocals, correctly rounded
    const float kInv60 = 1.0f / 60.0f;
    const float b = u8_to_f32(px[0]), g = u8_to_f32(px[1]), r = u8_to_f32(px[2]);
    float v = fmaxf(fmaxf(b, g), r);
    const float mn = fminf(fminf(b, g), r);
    const float diff = __fsub_rn(v, mn);
    const float safe = diff == 0.f ? 1.f : diff;
    // one division whatever the sector: the operands are selected, so the
    // lanes of a warp do not diverge
    const bool is_r = v == r, is_g = !is_r && v == g;
    const float p = is_r ? g : is_g ? b : r;
    const float q = is_r ? b : is_g ? r : g;
    const float sector = __fdiv_rn(__fmul_rn(60.f, __fsub_rn(p, q)), safe);
    float h = is_r ? sector : __fadd_rn(is_g ? 120.f : 240.f, sector);
    if (diff == 0.f) h = 0.f;
    if (h < 0.f) h = __fadd_rn(h, 360.f);
    h = __fmul_rn(h, 0.5f);
    float s = v == 0.f ? 0.f : __fdiv_rn(__fmul_rn(255.f, diff), v);

    h = clampf(__fmul_rn(h, sh), 0.f, 179.f);
    s = clampf(__fmul_rn(s, ss), 0.f, 255.f);
    v = clampf(__fmul_rn(v, sv), 0.f, 255.f);

    HsvPixel o;
    o.c = __fmul_rn(v, __fmul_rn(s, kInv255));
    const float hp = __fmul_rn(__fmul_rn(h, 2.f), kInv60);
    // fmod(hp, 2) for hp in [0, 6) (h <= 179): hp - 2 floor(hp / 2), every
    // step exact, so equal to fmodf's exact result
    const float hm = __fsub_rn(hp, 2.f * floor_f32(hp * 0.5f));
    o.x = __fmul_rn(o.c, __fsub_rn(1.f, fabsf(__fsub_rn(hm, 1.f))));
    o.idx = min(floor_int(hp), 5);
    o.m = __fsub_rn(v, o.c);
    return o;
}

// Channel ch (0 blue, 1 green, 2 red) of a perturbed pixel, rounded half up.
__device__ __forceinline__ uint8_t hsv_select(const HsvPixel& p, int ch) {
    // sector tables of (r, g, b) = c, x or 0, as _hsv_to_bgr_chw's selects
    const int idx = p.idx;
    float sel;
    if (ch == 0) {         // blue:  0 0 x c c x
        sel = idx < 2 ? 0.f : (idx == 2 || idx == 5) ? p.x : p.c;
    } else if (ch == 1) {  // green: x c c x 0 0
        sel = idx >= 4 ? 0.f : (idx == 0 || idx == 3) ? p.x : p.c;
    } else {               // red:   c x 0 0 x c
        sel = (idx == 2 || idx == 3) ? 0.f : (idx == 1 || idx == 4) ? p.x : p.c;
    }
    return round_u8(clampf(__fadd_rn(sel, p.m), 0.f, 255.f));
}

__device__ __forceinline__ uint8_t hsv_channel(const uint8_t* px, int ch, float sh,
                                               float ss, float sv) {
    return hsv_select(hsv_pixel(px, sh, ss, sv), ch);
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

// The lerp of two uint8 values in fp32, rounded half up. For frac in [0, 1)
// the two weights are non-negative and sum to at most 1 + 2^-24, so the
// value lies in [0, 255.5), where round_u8's clamp changes nothing: it is
// left out.
__device__ __forceinline__ uint8_t lerp_u8(uint8_t v0, uint8_t v1, float frac) {
    const float v = __fadd_rn(__fmul_rn(__fsub_rn(1.f, frac), u8_to_f32(v0)),
                              __fmul_rn(frac, u8_to_f32(v1)));
    return (uint8_t)floor_int(__fadd_rn(v, 0.5f));
}

// Without rotation: a block of 32 x 8 threads covers 8 output rows of one
// image (blockIdx.x the row group, blockIdx.y the image); thread (tx, ty)
// writes the three channels of the pixels tx, tx + 32, ... of its row from
// the three bytes of each source pixel.
constexpr int kPointwiseRows = 8;

template <bool HSV>
__global__ void __launch_bounds__(32 * kPointwiseRows)
augment_pointwise_kernel(const uint8_t* __restrict__ img, const float* __restrict__ table,
                         uint8_t* __restrict__ out, int H, int W, int oh, int ow) {
    const int n = blockIdx.y;
    const int y = blockIdx.x * kPointwiseRows + threadIdx.y;
    if (y >= oh) return;
    const float* prm = table + (int64_t)n * 8;
    const bool flip = prm[7] != 0.f;
    const uint8_t* src = img + (((int64_t)n * H + (int)prm[0] + y) * W + (int)prm[1]) * 3;
    const int64_t plane = (int64_t)oh * ow;
    uint8_t* dst = out + (int64_t)n * 3 * plane + (int64_t)y * ow;
    for (int xo = threadIdx.x; xo < ow; xo += 32) {
        const uint8_t* px = src + 3 * (flip ? ow - 1 - xo : xo);
        if (HSV) {
            const HsvPixel p = hsv_pixel(px, prm[2], prm[3], prm[4]);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) dst[ch * plane + xo] = hsv_select(p, ch);
        } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) dst[ch * plane + xo] = px[ch];
        }
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

constexpr int kBandWarps = 8;

// k brought into [0, n) by whole periods: one compare and subtract (or add)
// where k lies within one period of the range, as every index here does.
__device__ __forceinline__ int wrap_index(int k, int n) {
    while (k >= n) k -= n;
    while (k < 0) k += n;
    return k;
}

__device__ __forceinline__ int shift_floor(float coef, float coord, int P, float t_hi) {
    int t0;
    float frac;
    line_shift(coef, coord, P, t_hi, &t0, &frac);
    return t0;
}

// A window of a circular index space of n: slot i holds index (s + i) mod n
// for i < len. s stays as the reads compute it, not reduced modulo n, so a
// read's slot is its unwrapped index minus s, with no modulo in the inner
// loops; len may pass n, and then a slot repeats an index (and its value).
struct Window {
    int s, len;
};

// The window's indices as one run [lo, end) with 0 <= lo < n and end < 2n,
// or the whole period where len >= n.
__device__ __forceinline__ void window_run(const Window& w, int n, int* lo, int* end) {
    *lo = w.len >= n ? 0 : wrap_index(w.s, n);
    *end = w.len >= n ? n : *lo + w.len;
}

// The least and largest integer shift t0 of the second shear's columns in
// window w of the Wp columns: t0 is monotone in the column, so the ends of
// the window's one or two runs bound it.
__device__ __forceinline__ void column_shift_range(float b, const Window& w, int P, int Wp,
                                                   float cx, float t_hi, int* lo, int* hi) {
    int s, e;
    window_run(w, Wp, &s, &e);
    --e;  // the last
    const int ends[4] = {s, e < Wp ? e : Wp - 1, 0, e - Wp};
    *lo = 1 << 30;
    *hi = -1;
    for (int i = 0; i < (e < Wp ? 2 : 4); ++i) {
        const int t = shift_floor(b, __fsub_rn((float)(ends[i] - P), cx), P, t_hi);
        *lo = min(*lo, t);
        *hi = max(*hi, t);
    }
}

// The least and largest shift of the first shear over the content rows of
// window w of the Hp padded rows (padded row p holds content row p - P for
// P <= p < P + oh); the shift is monotone in the row. 0, 0 without content.
__device__ __forceinline__ void row_shift_range(float a, const Window& w, int P, int oh,
                                                int Hp, float cy, float t_hi, int* lo,
                                                int* hi) {
    *lo = 1 << 30;
    *hi = -1;
    int s, e;  // e one past the last
    window_run(w, Hp, &s, &e);
#pragma unroll
    for (int period = 0; period < 2; ++period) {
        const int c0 = max(s, period * Hp + P) - period * Hp - P;
        const int c1 = min(e, period * Hp + P + oh) - period * Hp - P;  // one past
        if (c0 < c1) {
            const int t0 = shift_floor(a, __fsub_rn((float)c0, cy), P, t_hi);
            const int t1 = shift_floor(a, __fsub_rn((float)(c1 - 1), cy), P, t_hi);
            *lo = min(*lo, min(t0, t1));
            *hi = max(*hi, max(t0, t1));
        }
    }
    if (*hi < 0) *lo = *hi = 0;
}

// One output byte of channel ch computed from the input alone, through the
// three shears' reads (eight HSV pixels): the band route's path for a tile
// whose windows exceed the staged capacity (a table with angles beyond the
// range its margin P was sized for). The same operations as the staged path.
template <bool HSV>
__device__ uint8_t rotated_direct(const uint8_t* src, int W, int r0, int c0, int ch, float sh,
                                  float ss, float sv, float a, float b, int y, int x, int oh,
                                  int ow, int P, float t_hi, float cy, float cx) {
    const int Wp = ow + 2 * P, Hp = oh + 2 * P;
    int t3;
    float f3;
    line_shift(a, __fsub_rn((float)y, cy), P, t_hi, &t3, &f3);
    const int k3 = wrap_index(x + t3, Wp);
    const int j_of[2] = {k3, k3 + 1 == Wp ? 0 : k3 + 1};
    uint8_t v3[2];
    for (int e3 = 0; e3 < 2; ++e3) {
        const int j = j_of[e3];
        int t2;
        float f2;
        line_shift(b, __fsub_rn((float)(j - P), cx), P, t_hi, &t2, &f2);
        const int q = wrap_index(y + t2, Hp);
        const int q_of[2] = {q, q + 1 == Hp ? 0 : q + 1};
        uint8_t v2[2];
        for (int e2 = 0; e2 < 2; ++e2) {
            const int c = q_of[e2] - P;
            v2[e2] = 0;
            if (c < 0 || c >= oh) continue;
            int t1;
            float f1;
            line_shift(a, __fsub_rn((float)c, cy), P, t_hi, &t1, &f1);
            const int k = wrap_index(j + t1 - P, Wp);
            const int k_of[2] = {k, k + 1 == Wp ? 0 : k + 1};
            uint8_t v1[2];
            for (int e1 = 0; e1 < 2; ++e1) {
                const int u = k_of[e1] - P;
                v1[e1] = 0;
                if (u < 0 || u >= ow) continue;
                const uint8_t* px = src + ((int64_t)(r0 + c) * W + c0 + u) * 3;
                v1[e1] = HSV ? hsv_channel(px, ch, sh, ss, sv) : px[ch];
            }
            v2[e2] = lerp_u8(v1[0], v1[1], f1);
        }
        v3[e3] = lerp_u8(v2[0], v2[1], f2);
    }
    return lerp_u8(v3[0], v3[1], f3);
}

// With rotation, route "band": block (column chunk, band, image) writes the
// output tile of rows [th * blockIdx.y, + th) and columns [tw * blockIdx.x,
// + tw) of all three channels of image blockIdx.z. Going back from the tile
// through the shears gives three windows, each a run of a circular index
// space: J, the columns of the second shear's output that the third shear
// reads (shifts of the tile's rows); R, the padded rows that the second shear
// reads at those columns (their shifts); K, the padded columns of the crop
// that the first shear reads on those rows (the rows' shifts). The block
// stages R x J of the first shear's output in shared memory (sa, zero rows
// for the margin), and each warp takes one row of R at a time: its K run of
// crop bytes by aligned 4-byte words into the warp's scratch, HSV once a
// pixel for the three channels, then the first shear. Then each warp takes
// one output row: the second shear over J into its three row buffers, the
// third straight to the output with the flip folded into the store. Loops
// run over rows, then columns; a read's slot is the loop index plus a
// constant of its line, so the inner loops hold no division and no wrap.
// caps (cap_j, cap_r, cap_k) bound the windows (ops/cuda/augment.py:
// band_plan, from the largest shift coefficient that the margin P allows);
// a tile whose windows exceed them computes each output byte through
// rotated_direct instead.
template <bool HSV>
__global__ void __launch_bounds__(32 * kBandWarps)
augment_band_kernel(const uint8_t* __restrict__ img, const float* __restrict__ table,
                    uint8_t* __restrict__ out, int H, int W, int oh, int ow, int P,
                    float t_hi, int th, int tw, int cap_j, int cap_r, int cap_k,
                    int region) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int Wp = ow + 2 * P, Hp = oh + 2 * P;
    const int n = blockIdx.z;
    const int y_lo = blockIdx.y * th, y_hi = min(y_lo + th, oh);
    const int x_lo = blockIdx.x * tw, x_hi = min(x_lo + tw, ow);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    const float* prm = table + (int64_t)n * 8;
    const int r0 = (int)prm[0], c0 = (int)prm[1];
    const float sh = prm[2], ss = prm[3], sv = prm[4];
    const float a = prm[5], b = prm[6];
    const bool flip = prm[7] != 0.f;
    const float cy = 0.5f * (float)oh, cx = 0.5f * (float)ow;
    const uint8_t* src = img + (int64_t)n * H * W * 3;
    const int64_t plane = (int64_t)oh * ow;
    uint8_t* dst = out + (int64_t)n * 3 * plane;

    // the windows, each in unwrapped indices: the tile's row shifts bound J
    // (the shift is monotone in y), J's column shifts bound R, the shifts of
    // R's content rows bound K
    const int ty0 = shift_floor(a, __fsub_rn((float)y_lo, cy), P, t_hi);
    const int ty1 = shift_floor(a, __fsub_rn((float)(y_hi - 1), cy), P, t_hi);
    const Window wj{x_lo + min(ty0, ty1), (x_hi - x_lo) + abs(ty1 - ty0) + 1};
    int tc_lo, tc_hi;
    column_shift_range(b, wj, P, Wp, cx, t_hi, &tc_lo, &tc_hi);
    const Window wr{y_lo + tc_lo, (y_hi - y_lo) + (tc_hi - tc_lo) + 1};
    int tr_lo, tr_hi;
    row_shift_range(a, wr, P, oh, Hp, cy, t_hi, &tr_lo, &tr_hi);
    const Window wk{wj.s + tr_lo - P, wj.len + (tr_hi - tr_lo) + 1};

    if (wj.len > cap_j || wr.len > cap_r || wk.len > cap_k) {
        for (int y = y_lo + warp; y < y_hi; y += kBandWarps)
            for (int x = x_lo + lane; x < x_hi; x += 32)
                for (int ch = 0; ch < 3; ++ch)
                    dst[ch * plane + (int64_t)y * ow + (flip ? ow - 1 - x : x)] =
                        rotated_direct<HSV>(src, W, r0, c0, ch, sh, ss, sv, a, b, y, x, oh,
                                            ow, P, t_hi, cy, cx);
        return;
    }

    int* col_t0 = reinterpret_cast<int*>(smem);               // [cap_j]
    float* col_frac = reinterpret_cast<float*>(col_t0 + cap_j);  // [cap_j]
    uint8_t* sa = smem + 8 * cap_j;                           // [3][cap_r][cap_j]
    uint8_t* wbuf = smem + ((8 * cap_j + 3 * cap_r * cap_j + 15) & ~15) + warp * region;

    for (int jj = threadIdx.x; jj < wj.len; jj += blockDim.x) {
        const int j = wrap_index(wj.s + jj, Wp);
        line_shift(b, __fsub_rn((float)(j - P), cx), P, t_hi, col_t0 + jj, col_frac + jj);
    }

    // the crop columns u0 .. u1 - 1 that K's content columns span, the same
    // on every row
    int u0 = ow, u1 = 0;
    {
        int s, e;
        window_run(wk, Wp, &s, &e);
#pragma unroll
        for (int period = 0; period < 2; ++period) {
            const int lo = max(s, period * Wp + P) - period * Wp - P;
            const int hi = min(e, period * Wp + P + ow) - period * Wp - P;
            if (lo < hi) {
                u0 = min(u0, lo);
                u1 = max(u1, hi);
            }
        }
    }

    // staging, one row of R a warp at a time; a slot's value depends only on
    // its index, so the slots of a read follow from the loop's
    uint32_t* scratch = reinterpret_cast<uint32_t*>(wbuf);
    uint8_t* row0 = wbuf + 4 * ((3 * ow + 6) / 4);  // [3][cap_k]: the crop after HSV
    for (int rr = warp; rr < wr.len; rr += kBandWarps) {
        const int c = wrap_index(wr.s + rr, Hp) - P;
        if (c < 0 || c >= oh || u0 >= u1) {  // a margin row: zeros
            for (int jj = lane; jj < wj.len; jj += 32)
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) sa[(ch * cap_r + rr) * cap_j + jj] = 0;
            continue;
        }
        // the aligned words that hold the run's bytes (a word never crosses
        // the end of an allocation); crop column u lands at raw + 3 (u - u0)
        const uintptr_t addr =
            reinterpret_cast<uintptr_t>(src + ((int64_t)(r0 + c) * W + c0 + u0) * 3);
        const int off = (int)(addr & 3);
        const uint32_t* words = reinterpret_cast<const uint32_t*>(addr - off);
        const int nwords = (off + 3 * (u1 - u0) + 3) >> 2;
        for (int w = lane; w < nwords; w += 32) scratch[w] = __ldg(words + w);
        __syncwarp();
        const uint8_t* raw = wbuf + off;
        for (int kk = lane; kk < wk.len; kk += 32) {
            const int u = wrap_index(wk.s + kk, Wp) - P;
            if (u >= 0 && u < ow) {
                const uint8_t* px = raw + 3 * (u - u0);
                if (HSV) {
                    const HsvPixel hp = hsv_pixel(px, sh, ss, sv);
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch) row0[ch * cap_k + kk] = hsv_select(hp, ch);
                } else {
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch) row0[ch * cap_k + kk] = px[ch];
                }
            } else {
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) row0[ch * cap_k + kk] = 0;
            }
        }
        __syncwarp();
        // the first shear, along W: slot jj (column wj.s + jj) reads column
        // wj.s + jj + t0 - P, K's slot jj + t0 - tr_lo, and the next
        int t0;
        float frac;
        line_shift(a, __fsub_rn((float)c, cy), P, t_hi, &t0, &frac);
        const int d = t0 - tr_lo;
        for (int jj = lane; jj < wj.len; jj += 32) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
                sa[(ch * cap_r + rr) * cap_j + jj] =
                    lerp_u8(row0[ch * cap_k + jj + d], row0[ch * cap_k + jj + d + 1], frac);
        }
        __syncwarp();
    }
    __syncthreads();

    // the tile's rows, one a warp at a time: the second shear along H over J
    // into the warp's three rows (slot jj reads padded row y + col_t0[jj], R's
    // slot y + col_t0[jj] - wr.s, and the next), then the third along W to
    // the output (output column x reads J's slot x + t0 - wj.s and the next)
    uint8_t* rowb = wbuf;  // [3][cap_j]
    for (int y = y_lo + warp; y < y_hi; y += kBandWarps) {
        for (int jj = lane; jj < wj.len; jj += 32) {
            const int q = (y + col_t0[jj] - wr.s) * cap_j + jj;
            const float f = col_frac[jj];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const uint8_t* sac = sa + ch * cap_r * cap_j;
                rowb[ch * cap_j + jj] = lerp_u8(sac[q], sac[q + cap_j], f);
            }
        }
        __syncwarp();
        int t0;
        float frac;
        line_shift(a, __fsub_rn((float)y, cy), P, t_hi, &t0, &frac);
        const int d = t0 - wj.s;
        uint8_t* drow = dst + (int64_t)y * ow;
        for (int x = x_lo + lane; x < x_hi; x += 32) {
            const int xs = flip ? ow - 1 - x : x;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
                drow[ch * plane + xs] =
                    lerp_u8(rowb[ch * cap_j + x + d], rowb[ch * cap_j + x + d + 1], frac);
        }
        __syncwarp();
    }
}

// A warp's region and a block's dynamic shared memory on the band route for
// the caps of ops/cuda/augment.py:band_plan (which mirrors this).
inline void band_layout(int ow, int cap_j, int cap_r, int cap_k, int* region, size_t* smem) {
    if (cap_j == 0) {  // every tile on the direct path, which stages nothing
        *region = 0;
        *smem = 0;
        return;
    }
    const int stage = 4 * ((3 * ow + 6) / 4) + 3 * cap_k;
    *region = ((stage > cap_j ? stage : cap_j) + 15) & ~15;
    *smem = (((size_t)8 * cap_j + (size_t)3 * cap_r * cap_j + 15) & ~(size_t)15) +
            (size_t)kBandWarps * *region;
}

template <bool HSV>
cudaError_t launch_band(const uint8_t* xp, const float* tp, uint8_t* op, int B, int H, int W,
                        int oh, int ow, int P, float t_hi, int th, int tw, int cap_j, int cap_r,
                        int cap_k, cudaStream_t s) {
    int region = 0;
    size_t smem = 0;
    band_layout(ow, cap_j, cap_r, cap_k, &region, &smem);
    cudaError_t err = cudaFuncSetAttribute(augment_band_kernel<HSV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((ow + tw - 1) / tw, (oh + th - 1) / th, B);
    augment_band_kernel<HSV><<<grid, 32 * kBandWarps, smem, s>>>(
        xp, tp, op, H, W, oh, ow, P, t_hi, th, tw, cap_j, cap_r, cap_k, region);
    return cudaGetLastError();
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
// 2^bitlen(2P - 2) - 1. hsv: 0 or 1. With rotation, route 0 ("plane") or 1
// ("band": tiles of th rows x tw columns, windows up to cap_j, cap_r, cap_k;
// caps of 0 send every tile through rotated_direct).
int dorknet_augment_planes(const void* x, const void* table, void* out, int B, int H,
                           int W, int oh, int ow, int P, float t_hi, int hsv, int route,
                           int th, int tw, int cap_j, int cap_r, int cap_k, void* stream,
                           int device) {
    if (B < 0 || B > 65535 || oh < 1 || ow < 1 || oh > H || ow > W || P < 0 || route < 0 ||
        route > 1 || (route == 1 && (th < 1 || tw < 1 || cap_j < 0 || cap_r < 0 || cap_k < 0)))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* xp = static_cast<const uint8_t*>(x);
    const float* tp = static_cast<const float*>(table);
    uint8_t* op = static_cast<uint8_t*>(out);
    if (P == 0) {
        const dim3 grid((oh + kPointwiseRows - 1) / kPointwiseRows, B);
        const dim3 block(32, kPointwiseRows);
        if (hsv) {
            augment_pointwise_kernel<true><<<grid, block, 0, s>>>(xp, tp, op, H, W, oh, ow);
        } else {
            augment_pointwise_kernel<false><<<grid, block, 0, s>>>(xp, tp, op, H, W, oh, ow);
        }
        return (int)cudaGetLastError();
    }
    if (route == 1)
        return (int)(hsv ? launch_band<true>(xp, tp, op, B, H, W, oh, ow, P, t_hi, th, tw,
                                             cap_j, cap_r, cap_k, s)
                         : launch_band<false>(xp, tp, op, B, H, W, oh, ow, P, t_hi, th, tw,
                                              cap_j, cap_r, cap_k, s));
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

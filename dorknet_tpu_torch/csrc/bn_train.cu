// Train-mode batch norm after its statistics: the normalise (bn_apply) and
// the two-reduction backward (bn_bwd_reduce, bn_bwd_dx) of x (..., C), M
// rows of C channels; and the same pointwise pass as a test-mode layer's
// bias add and activation (bias_act).
//
// Replaces no TPU kernel. The JAX package leaves these passes to XLA, which
// fuses dorknet_tpu/ops/norm.py:_bn_core_fwd_impl and _bn_core_bwd into a
// few passes; run as eager PyTorch ops they took 22 activation-sized reads
// and writes a batch norm. The statistics come from bn_stats.cu first.
//
// The JAX formulas (dorknet_tpu/ops/norm.py:57-87), in fp32, every operation
// rounded on its own (no contracted FMA), so that the plain PyTorch versions
// (ops/cuda/bn_train.py) give the same elementwise results:
//   inv = rsqrt(var + eps)          the card's rsqrtf, as torch.rsqrt's
//   x^  = (x - mean) * inv
//   y   = gamma * x^ + beta                         in x's dtype
// and the backward, with x^ recomputed from x by the same function (bn_xhat)
// and rounded to x's dtype, which is what _bn_core_fwd saves:
//   dbeta = sum_r dy,  dgamma = sum_r dy * x^       fp32 sums
//   dx    = (gamma * inv) * (dy - dbeta / M - x^ * (dgamma / M))   in dy's dtype
// x, y, dy and dx are fp32 or bf16 (dy in x's dtype); the per-channel
// vectors are fp32.
//
// What bounds them on an H100: device-memory bytes. bn_apply reads x and
// writes y; bn_bwd_reduce reads dy and x; bn_bwd_dx reads dy and x and
// writes dx: 7 activation passes a batch norm, a handful of flops an
// element. The flagship's 34 batch norms at its trained batch of 120 hold
// 471.2 M elements, 1.885 GB a fp32 pass: 13.2 GB a step, about 3.9 ms at
// 3.35 TB/s.
//
// What the design does about it.
// - The two pointwise kernels (bn_apply, bn_bwd_dx) run a grid-stride loop
//   over the flat array in vectors of V channels: 16 bytes (4 fp32, 8 bf16)
//   where C is a multiple of that and the activations are 16-byte aligned,
//   else one element (the scalar route, V = 1). The caller makes the grid a
//   whole number G of rows of C/V vectors, so thread t always meets the same
//   channel vector, t mod C/V, at every step of G: it forms its per-channel
//   factors once, in registers, and a warp reads 32 neighbouring vectors,
//   coalesced, whatever C is. Two vectors are in flight a thread.
// - bn_bwd_reduce is a reduction over the M rows, in two passes without
//   atomics, so two runs give bit-equal results, as in bn_stats.cu. Pass 1:
//   a block owns one band of rows and one tile of TW channel vectors, with
//   R = 256 / TW row lanes, so narrow layers (C = 16, 24, 40) still keep
//   every thread of a warp on neighbouring vectors of neighbouring rows;
//   each thread sums dy and dy * x^ of its vector over its lane's rows, and
//   the R lanes are added in shared memory in lane order into one (2, TW*V)
//   slice of the fp32 partials (P, 2, C). Pass 2 (bn_bwd_finish_kernel)
//   adds the P partials of each channel in a fixed order and writes dgamma,
//   dbeta and the three factors dx needs: gamma * inv, dbeta / M and
//   dgamma / M.
// The caller picks G, the tile, R and P from M, C, V and the SM count
// (ops/cuda/bn_train.py).
//
// The activation epilogue. Each kernel takes the activation that follows the
// batch norm as a template parameter A: none, ReLU or hard-swish. bn_apply
// writes act(y) in place of y; bn_bwd_reduce and bn_bwd_dx take the
// gradient of act(y) and recompute y from x with the forward's exact
// arithmetic (x^ unrounded, gamma * x^ + beta rounded to T), form
// dy = g * act'(y) in registers and go on as without an activation. y is
// never written, and nothing more is read than without the epilogue.
//   relu(y)   = max(y, 0)             relu'  = 1 where y > 0, else 0
//   hswish(y) = y * h, h = min(max(y + 3, 0), 6) * (1/6), each step rounded
//               to T as the unfused ops round it (layers/activations.py)
//   hswish'   = h + y * (1/6) * clip'(y + 3), clip' 1 inside (0, 6), 0.5 at
//               0 and 6 (jnp.clip's gradient), 0 outside
// In fp32 dy is the unfused autograd chain's value; in bf16 it stays in
// fp32, where the unfused chain rounds it to bf16 before the batch norm.
//
// The bias pass (bias_act). A test-mode conv or dense layer (a folded batch
// norm's among them) adds its bias and applies the activation after it in
// one read and one write of its output: out = act(y + b[c]), the add in
// fp32, then rounded and activated as the unfused ops do (act_out). It is
// bn_apply's pointwise loop with y + b where bn_apply has the affine
// normalise. Replaces no TPU kernel: XLA fuses the JAX package's bias add
// and activation into neighbouring passes; as eager PyTorch ops they took 2
// activation passes for the add, 2 more for ReLU and 11 for hard-swish.
//
// C entry points: dorknet_bn_apply, dorknet_bn_bwd_reduce, dorknet_bn_bwd_dx,
// dorknet_bias_act. Each launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after its
// launches.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PW_THREADS = 256;  // threads of a pointwise block
constexpr int MAX_REDUCE_THREADS = 512;  // threads of a reduce block, at most
constexpr int MAX_REDUCE_SMEM = 48 * 1024;

// the activation after the batch norm (the C entry points' act argument)
enum class Act : int { kNone = 0, kRelu = 1, kHSwish = 2 };

// V neighbouring channels of one row, read into and written from fp32.
template <typename T, int V> struct Chan {
    static_assert(V == 16 / (int)sizeof(T), "a channel vector fills 16 bytes");
    static __device__ __forceinline__ void load(const T* p, float (&v)[V]) {
        Vec<T>::widen(Vec<T>::load(p), v);
    }
    static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
        Vec<T>::store(p, v);
    }
};
template <typename T> struct Chan<T, 1> {
    static __device__ __forceinline__ void load(const T* p, float (&v)[1]) {
        v[0] = load_f32(p);
    }
    static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
        store_f32(p, v[0]);
    }
};

// x rounded to T and widened back: the x^ that the JAX forward saves
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bn_inv(float var, float eps) {
    return rsqrtf(__fadd_rn(var, eps));
}

// x^ = (x - mean) * inv: the forward's arithmetic, which the backward
// repeats on the saved x
__device__ __forceinline__ float bn_xhat(float x, float mean, float inv) {
    return __fmul_rn(__fsub_rn(x, mean), inv);
}

template <int V>
__device__ __forceinline__ void load_chan(const float* p, int c0, float (&v)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[c0 + k];
}

// y = gamma * x^ + beta, unrounded
__device__ __forceinline__ float bn_affine(float xh, float g, float b) {
    return __fadd_rn(__fmul_rn(g, xh), b);
}

// 1/6 in T, as the unfused chain's constant (a 0-dim tensor of T)
template <typename T> __device__ __forceinline__ float sixth() {
    return round_to<T>(1.0f / 6.0f);
}

// t = y + 3 in T and h = min(max(t, 0), 6) * (1/6) in T, for y in T
template <typename T>
__device__ __forceinline__ void hswish_parts(float y, float& t, float& h) {
    t = round_to<T>(__fadd_rn(y, 3.0f));
    h = round_to<T>(__fmul_rn(fminf(fmaxf(t, 0.0f), 6.0f), sixth<T>()));
}

// The value stored for the unrounded y: y itself (the store rounds it to
// T), or act(y in T), whose last operation the store rounds.
template <typename T, Act A> __device__ __forceinline__ float act_out(float y) {
    if constexpr (A == Act::kNone) {
        return y;
    } else if constexpr (A == Act::kRelu) {
        const float r = round_to<T>(y);
        return r <= 0.0f ? 0.0f : r;  // torch.relu on the card: NaN kept, -0 gives +0
    } else {
        const float r = round_to<T>(y);
        float t, h;
        hswish_parts<T>(r, t, h);
        return __fmul_rn(r, h);
    }
}

// The batch norm's dy from g, the gradient of act(y), at the unrounded y:
// threshold_backward's rule for ReLU; for hard-swish the mul's two branches
// added, the clip's branch halved at a bound and masked outside it, in the
// unfused autograd chain's order.
template <typename T, Act A> __device__ __forceinline__ float act_grad(float g, float y) {
    if constexpr (A == Act::kNone) {
        return g;
    } else if constexpr (A == Act::kRelu) {
        return round_to<T>(y) <= 0.0f ? 0.0f : g;
    } else {
        const float r = round_to<T>(y);
        float t, h;
        hswish_parts<T>(r, t, h);
        float through = 0.0f;
        if (t >= 0.0f && t <= 6.0f) {
            through = __fmul_rn(__fmul_rn(g, r), sixth<T>());
            if (t == 0.0f || t == 6.0f) through = __fmul_rn(through, 0.5f);
        }
        return __fadd_rn(__fmul_rn(g, h), through);
    }
}

// The pointwise kernels' grid-stride loop: thread t (< G) meets the
// vectors t, t + G, t + 2G, ... of the flat array x, all of channel vector
// t mod C/V, two in flight, and writes f(v, k) of element k of each to y.
template <typename T, int V, typename F>
__device__ __forceinline__ void map_vectors(const T* __restrict__ x, T* __restrict__ y,
                                            int64_t t, int64_t nvec, int64_t G, F f) {
    int64_t i = t;
    for (; i + G < nvec; i += 2 * G) {
        float a[V], a2[V];
        Chan<T, V>::load(x + i * V, a);
        Chan<T, V>::load(x + (i + G) * V, a2);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            a[k] = f(a[k], k);
            a2[k] = f(a2[k], k);
        }
        Chan<T, V>::store(y + i * V, a);
        Chan<T, V>::store(y + (i + G) * V, a2);
    }
    if (i < nvec) {
        float a[V];
        Chan<T, V>::load(x + i * V, a);
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = f(a[k], k);
        Chan<T, V>::store(y + i * V, a);
    }
}

// ---- forward --------------------------------------------------------------

// norm is (2, C): this kernel writes mean (a copy) and inv there, the
// per-channel pair the backward reads.
template <typename T, int V, Act A>
__global__ void __launch_bounds__(PW_THREADS)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ var, const float* __restrict__ gamma,
                const float* __restrict__ beta, float eps, T* __restrict__ y,
                float* __restrict__ norm, int64_t nvec, int Cv, int64_t G) {
    const int64_t t = (int64_t)blockIdx.x * PW_THREADS + threadIdx.x;
    if (t >= G) return;
    const int c0 = (int)(t % Cv) * V;
    const int C = Cv * V;
    float m[V], iv[V], g[V], b[V];
    load_chan<V>(mean, c0, m);
    load_chan<V>(gamma, c0, g);
    load_chan<V>(beta, c0, b);
#pragma unroll
    for (int k = 0; k < V; ++k) iv[k] = bn_inv(var[c0 + k], eps);
    if (t < Cv) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
            norm[c0 + k] = m[k];
            norm[C + c0 + k] = iv[k];
        }
    }
    map_vectors<T, V>(x, y, t, nvec, G, [&](float v, int k) {
        return act_out<T, A>(bn_affine(bn_xhat(v, m[k], iv[k]), g[k], b[k]));
    });
}

// ---- the bias pass ------------------------------------------------------------

template <typename T, int V, Act A>
__global__ void __launch_bounds__(PW_THREADS)
bias_act_kernel(const T* __restrict__ y, const float* __restrict__ bias, T* __restrict__ out,
                int64_t nvec, int Cv, int64_t G) {
    const int64_t t = (int64_t)blockIdx.x * PW_THREADS + threadIdx.x;
    if (t >= G) return;
    float b[V];
    load_chan<V>(bias, (int)(t % Cv) * V, b);
    map_vectors<T, V>(y, out, t, nvec, G, [&](float v, int k) {
        return act_out<T, A>(__fadd_rn(v, b[k]));
    });
}

// ---- backward, pass 1: partial sums of dy and dy * x^ ----------------------

// gamma and beta of V channels, read only where an activation follows
template <Act A, int V>
__device__ __forceinline__ void load_affine(const float* gamma, const float* beta, int c0,
                                            float (&ga)[V], float (&be)[V]) {
    if constexpr (A != Act::kNone) {
        load_chan<V>(gamma, c0, ga);
        load_chan<V>(beta, c0, be);
    }
}

template <typename T, int V, Act A>
__device__ __forceinline__ void accumulate(const T* gy, const T* x, const float (&m)[V],
                                           const float (&iv)[V], const float (&ga)[V],
                                           const float (&be)[V], float (&s0)[V],
                                           float (&s1)[V]) {
    float g[V], a[V];
    Chan<T, V>::load(gy, g);
    Chan<T, V>::load(x, a);
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const float xh = bn_xhat(a[k], m[k], iv[k]);
        const float dy = act_grad<T, A>(g[k], bn_affine(xh, ga[k], be[k]));
        s0[k] += dy;
        s1[k] = fmaf(dy, round_to<T>(xh), s1[k]);
    }
}

template <typename T, int V, Act A>
__global__ void __launch_bounds__(MAX_REDUCE_THREADS)
bn_bwd_reduce_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                     const float* __restrict__ norm, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ partials,
                     int64_t M, int C, int TW, int R, int P) {
    extern __shared__ float red[];  // [R][TW][2][V], when R > 1
    const int t = threadIdx.x;
    const int cw = t % TW, lane = t / TW;
    const int cv = blockIdx.x * TW + cw;
    const int band = blockIdx.y;
    const int64_t r1 = M * (band + 1) / P;
    float s0[V], s1[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s0[k] = s1[k] = 0.0f;
    if (cv * V < C) {
        const int c0 = cv * V;
        float m[V], iv[V], ga[V], be[V];
        load_chan<V>(norm, c0, m);
        load_chan<V>(norm + C, c0, iv);
        load_affine<A, V>(gamma, beta, c0, ga, be);
        int64_t r = M * band / P + lane;
        for (; r + R < r1; r += 2 * R) {
            accumulate<T, V, A>(gy + r * C + c0, x + r * C + c0, m, iv, ga, be, s0, s1);
            accumulate<T, V, A>(gy + (r + R) * C + c0, x + (r + R) * C + c0, m, iv, ga, be,
                                s0, s1);
        }
        if (r < r1)
            accumulate<T, V, A>(gy + r * C + c0, x + r * C + c0, m, iv, ga, be, s0, s1);
    }
    float* out = partials + (int64_t)band * 2 * C;
    if (R == 1) {
        if (cv * V < C) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                out[cv * V + k] = s0[k];
                out[C + cv * V + k] = s1[k];
            }
        }
        return;
    }
    float* mine = red + (lane * TW + cw) * 2 * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        mine[k] = s0[k];
        mine[V + k] = s1[k];
    }
    __syncthreads();
    // output o: sum s (0: dy, 1: dy * x^) of element j of the tile, added
    // over the R lanes in lane order
    const int width = TW * V;
    for (int o = t; o < 2 * width; o += blockDim.x) {
        const int s = o / width, j = o % width;
        const int c = blockIdx.x * width + j;
        if (c >= C) continue;
        const float* src = red + ((j / V) * 2 + s) * V + j % V;
        float acc = 0.0f;
        for (int q = 0; q < R; ++q) acc += src[q * TW * 2 * V];
        out[s * C + c] = acc;
    }
}

// ---- backward, pass 2: dgamma, dbeta and the factors of dx -----------------

// grads is (2, C): dgamma, dbeta. coef is (3, C): gamma * inv, dbeta / count,
// dgamma / count. Lane y of a block adds p = y, y+8, ... and the eight lanes
// are added in lane order, as bn_stats.cu's finish does.
__global__ void __launch_bounds__(STATS_TX * STATS_TY)
bn_bwd_finish_kernel(const float* __restrict__ partials, const float* __restrict__ norm,
                     const float* __restrict__ gamma, float* __restrict__ grads,
                     float* __restrict__ coef, int C, int P, float count) {
    __shared__ float red[2][STATS_TY][STATS_TX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * STATS_TX + tx;
    float s0 = 0.0f, s1 = 0.0f;
    if (c < C) {
        for (int p = ty; p < P; p += STATS_TY) {
            s0 += partials[(int64_t)(2 * p) * C + c];
            s1 += partials[(int64_t)(2 * p + 1) * C + c];
        }
    }
    red[0][ty][tx] = s0;
    red[1][ty][tx] = s1;
    __syncthreads();
    if (ty == 0 && c < C) {
        float dbeta = 0.0f, dgamma = 0.0f;
#pragma unroll
        for (int y = 0; y < STATS_TY; ++y) {
            dbeta += red[0][y][tx];
            dgamma += red[1][y][tx];
        }
        grads[c] = dgamma;
        grads[C + c] = dbeta;
        coef[c] = __fmul_rn(gamma[c], norm[C + c]);
        coef[C + c] = __fdiv_rn(dbeta, count);
        coef[2 * C + c] = __fdiv_rn(dgamma, count);
    }
}

// ---- backward, dx -----------------------------------------------------------

template <typename T, int V, Act A>
__device__ __forceinline__ void dx_vec(const T* gy, const T* x, T* dx, const float (&m)[V],
                                       const float (&iv)[V], const float (&ga)[V],
                                       const float (&be)[V], const float (&sc)[V],
                                       const float (&mb)[V], const float (&mg)[V]) {
    float g[V], a[V];
    Chan<T, V>::load(gy, g);
    Chan<T, V>::load(x, a);
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const float xu = bn_xhat(a[k], m[k], iv[k]);
        const float dy = act_grad<T, A>(g[k], bn_affine(xu, ga[k], be[k]));
        const float xh = round_to<T>(xu);
        g[k] = __fmul_rn(sc[k], __fsub_rn(__fsub_rn(dy, mb[k]), __fmul_rn(xh, mg[k])));
    }
    Chan<T, V>::store(dx, g);
}

template <typename T, int V, Act A>
__global__ void __launch_bounds__(PW_THREADS)
bn_bwd_dx_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                 const float* __restrict__ norm, const float* __restrict__ coef,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ dx, int64_t nvec, int Cv, int64_t G) {
    const int64_t t = (int64_t)blockIdx.x * PW_THREADS + threadIdx.x;
    if (t >= G) return;
    const int c0 = (int)(t % Cv) * V;
    const int C = Cv * V;
    float m[V], iv[V], ga[V], be[V], sc[V], mb[V], mg[V];
    load_chan<V>(norm, c0, m);
    load_chan<V>(norm + C, c0, iv);
    load_affine<A, V>(gamma, beta, c0, ga, be);
    load_chan<V>(coef, c0, sc);
    load_chan<V>(coef + C, c0, mb);
    load_chan<V>(coef + 2 * C, c0, mg);
    int64_t i = t;
    for (; i + G < nvec; i += 2 * G) {
        dx_vec<T, V, A>(gy + i * V, x + i * V, dx + i * V, m, iv, ga, be, sc, mb, mg);
        dx_vec<T, V, A>(gy + (i + G) * V, x + (i + G) * V, dx + (i + G) * V, m, iv, ga, be,
                        sc, mb, mg);
    }
    if (i < nvec) dx_vec<T, V, A>(gy + i * V, x + i * V, dx + i * V, m, iv, ga, be, sc, mb, mg);
}

// ---- launches -----------------------------------------------------------------

// The pointwise grid: G threads, a whole number of rows of C / V vectors.
inline bool pointwise_ok(int64_t M, int C, int V, int64_t G) {
    return M >= 1 && C >= 1 && C % V == 0 && G >= 1 && G % (C / V) == 0 &&
           G / (C / V) <= M;
}

inline unsigned pointwise_blocks(int64_t G) {
    return (unsigned)((G + PW_THREADS - 1) / PW_THREADS);
}

template <typename T, int V, Act A>
cudaError_t apply_launch(const void* x, const float* mean, const float* var,
                         const float* gamma, const float* beta, float eps, void* y,
                         float* norm, int64_t M, int C, int64_t G, cudaStream_t s) {
    if (!pointwise_ok(M, C, V, G)) return cudaErrorInvalidValue;
    if (V > 1 && !(aligned16(x) && aligned16(y))) return cudaErrorInvalidValue;
    bn_apply_kernel<T, V, A><<<pointwise_blocks(G), PW_THREADS, 0, s>>>(
        static_cast<const T*>(x), mean, var, gamma, beta, eps, static_cast<T*>(y), norm,
        M * C / V, C / V, G);
    return cudaGetLastError();
}

template <typename T, int V, Act A>
cudaError_t bias_act_launch(const void* y, const float* bias, void* out, int64_t M, int C,
                            int64_t G, cudaStream_t s) {
    if (!pointwise_ok(M, C, V, G)) return cudaErrorInvalidValue;
    if (V > 1 && !(aligned16(y) && aligned16(out))) return cudaErrorInvalidValue;
    bias_act_kernel<T, V, A><<<pointwise_blocks(G), PW_THREADS, 0, s>>>(
        static_cast<const T*>(y), bias, static_cast<T*>(out), M * C / V, C / V, G);
    return cudaGetLastError();
}

template <typename T, int V, Act A>
cudaError_t reduce_launch(const void* gy, const void* x, const float* norm,
                          const float* gamma, const float* beta, float* partials,
                          float* grads, float* coef, int64_t M, int C, int TW, int R, int P,
                          cudaStream_t s) {
    if (C % V != 0 || TW < 1 || R < 1 || (int64_t)TW * R > MAX_REDUCE_THREADS)
        return cudaErrorInvalidValue;
    if (V > 1 && !(aligned16(gy) && aligned16(x))) return cudaErrorInvalidValue;
    const size_t smem = R > 1 ? (size_t)R * TW * 2 * V * sizeof(float) : 0;
    if (smem > MAX_REDUCE_SMEM) return cudaErrorInvalidValue;
    const int tiles = (C / V + TW - 1) / TW;
    bn_bwd_reduce_kernel<T, V, A><<<dim3(tiles, P), TW * R, smem, s>>>(
        static_cast<const T*>(gy), static_cast<const T*>(x), norm, gamma, beta, partials, M,
        C, TW, R, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bn_bwd_finish_kernel<<<(C + STATS_TX - 1) / STATS_TX, dim3(STATS_TX, STATS_TY), 0, s>>>(
        partials, norm, gamma, grads, coef, C, P, (float)M);
    return cudaGetLastError();
}

template <typename T, int V, Act A>
cudaError_t dx_launch(const void* gy, const void* x, const float* norm, const float* coef,
                      const float* gamma, const float* beta, void* dx, int64_t M, int C,
                      int64_t G, cudaStream_t s) {
    if (!pointwise_ok(M, C, V, G)) return cudaErrorInvalidValue;
    if (V > 1 && !(aligned16(gy) && aligned16(x) && aligned16(dx)))
        return cudaErrorInvalidValue;
    bn_bwd_dx_kernel<T, V, A><<<pointwise_blocks(G), PW_THREADS, 0, s>>>(
        static_cast<const T*>(gy), static_cast<const T*>(x), norm, coef, gamma, beta,
        static_cast<T*>(dx), M * C / V, C / V, G);
    return cudaGetLastError();
}

template <typename T> struct Type { using type = T; };
template <int V> using Width = std::integral_constant<int, V>;
template <Act A> using Epilogue = std::integral_constant<Act, A>;

// f(Type<T>, Width<V>, Epilogue<A>) for the entry points' dtype, vec and act
// codes: 2 x 2 x 3 instantiations of each kernel.
template <typename F>
cudaError_t dispatch(int dtype, int vec, int act, F&& f) {
    auto by_act = [&](auto type, auto width) -> cudaError_t {
        switch (act) {
            case 0: return f(type, width, Epilogue<Act::kNone>{});
            case 1: return f(type, width, Epilogue<Act::kRelu>{});
            case 2: return f(type, width, Epilogue<Act::kHSwish>{});
            default: return cudaErrorInvalidValue;
        }
    };
    switch (dtype * 2 + vec) {
        case 0: return by_act(Type<float>{}, Width<1>{});
        case 1: return by_act(Type<float>{}, Width<4>{});
        case 2: return by_act(Type<__nv_bfloat16>{}, Width<1>{});
        case 3: return by_act(Type<__nv_bfloat16>{}, Width<8>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

#define BN_F(p) static_cast<const float*>(p)
#define BN_ROUTE(type, width, epi) \
    typename decltype(type)::type, decltype(width)::value, decltype(epi)::value

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the activations, contiguous (M, C)); the
// per-channel vectors are float32 (C,), norm (2, C). vec: 1 = vectors of 16
// bytes (C a multiple of 4 fp32 or 8 bf16, activations 16-byte aligned),
// 0 = one element. act: the activation after the batch norm, 0 = none,
// 1 = ReLU, 2 = hard-swish; y is act(y). threads: the pointwise grid G, a
// multiple of C / V and at most M rows of it.
int dorknet_bn_apply(const void* x, const void* mean, const void* var, const void* gamma,
                     const void* beta, float eps, void* y, void* norm, long long M, int C,
                     int vec, int act, long long threads, int dtype, void* stream,
                     int device) {
    if (vec != 0 && vec != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* np = static_cast<float*>(norm);
    return (int)dispatch(dtype, vec, act, [&](auto type, auto width, auto epi) {
        return apply_launch<BN_ROUTE(type, width, epi)>(
            x, BN_F(mean), BN_F(var), BN_F(gamma), BN_F(beta), eps, y, np, M, C, threads, s);
    });
}

// gy is the gradient of act(y); beta is read only when act is not 0.
// partials: float32 (P, 2, C) scratch; grads: float32 (2, C), dgamma then
// dbeta; coef: float32 (3, C), gamma * inv, dbeta / M, dgamma / M. The
// block is tile channel vectors x lanes rows (at most 512 threads);
// 1 <= P <= min(M, 65535).
int dorknet_bn_bwd_reduce(const void* gy, const void* x, const void* norm, const void* gamma,
                          const void* beta, void* partials, void* grads, void* coef,
                          long long M, int C, int tile, int lanes, int P, int vec, int act,
                          int dtype, void* stream, int device) {
    if (M < 1 || C < 1 || P < 1 || P > 65535 || P > M || (vec != 0 && vec != 1))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* pp = static_cast<float*>(partials);
    float* gp = static_cast<float*>(grads);
    float* cp = static_cast<float*>(coef);
    return (int)dispatch(dtype, vec, act, [&](auto type, auto width, auto epi) {
        return reduce_launch<BN_ROUTE(type, width, epi)>(
            gy, x, BN_F(norm), BN_F(gamma), BN_F(beta), pp, gp, cp, M, C, tile, lanes, P, s);
    });
}

// dx in dy's dtype; norm (2, C) and coef (3, C) as above; gy is the
// gradient of act(y); gamma and beta are read only when act is not 0.
int dorknet_bn_bwd_dx(const void* gy, const void* x, const void* norm, const void* coef,
                      const void* gamma, const void* beta, void* dx, long long M, int C,
                      int vec, int act, long long threads, int dtype, void* stream,
                      int device) {
    if (vec != 0 && vec != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)dispatch(dtype, vec, act, [&](auto type, auto width, auto epi) {
        return dx_launch<BN_ROUTE(type, width, epi)>(
            gy, x, BN_F(norm), BN_F(coef), BN_F(gamma), BN_F(beta), dx, M, C, threads, s);
    });
}

// out = act(y + bias) in y's dtype, y and out (M, C) contiguous, bias
// float32 (C,); dtype, vec, act and threads as dorknet_bn_apply's.
int dorknet_bias_act(const void* y, const void* bias, void* out, long long M, int C, int vec,
                     int act, long long threads, int dtype, void* stream, int device) {
    if (vec != 0 && vec != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)dispatch(dtype, vec, act, [&](auto type, auto width, auto epi) {
        return bias_act_launch<BN_ROUTE(type, width, epi)>(y, BN_F(bias), out, M, C, threads,
                                                          s);
    });
}

}  // extern "C"

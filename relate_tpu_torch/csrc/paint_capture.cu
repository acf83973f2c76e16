// Capture sweeps of the Li & Stephens painting for sm_90a: the forward sweep
// up to row want[b] (B3) and the backward sweep from row D[b]-1 down to row
// want[b] (B4), each keeping only that row and its logscale.
//
// Replaces the TPU kernels relate_tpu/ops/paint_kernels.py:_fwd_capture_kernel
// (fwd_capture_pallas) and _bwd_capture_kernel (bwd_capture_pallas). State is
// (B, N), the mismatch stream (Dmax, B, N) int8, the step vectors (B, Dmax),
// unshifted (see ops/paint_kernels.py).
//
// Recurrences, identical to the plain versions in ops/paint_kernels.py
// (float32, rescale into [1e-10, 1e10] by division, Kahan-compensated
// logscale):
//   forward   row 0: alpha = alpha0 * kmask, ls = 0
//             0 < j <= min(want, D-1): alpha = (alpha + asum * pfac[j-1])
//                 * (1 + tr * mism[j]) * kmask; rescale; ls += nxt[j-1] + log
//             output: alpha and ls after row min(want, D-1); zeros where
//             want < 0 or want >= Dmax
//   backward  row D-1: beta = beta_end * kmask, no rescale, logscale 0
//             want <= j < D-1: rx = bsum * pfac[j+1]; b1 = rx / (1-theta);
//                 bt = rx/theta - b1; dn = mism[j+1];
//                 beta = (beta + dn*bt + b1) * (1 + tr*dn) * kmask;
//                 bsum = sum(w * beta), w = mism[j] > 0 ? theta : 1-theta;
//                 rescale; pls += nxt[j+1] + log
//             output: beta and pls after row want; zeros where want < 0 or
//             want >= D
//
// What bounds them: the mismatch stream, one byte per (row, target, source),
// read once; and, per target, a chain of rows in which each row needs the
// previous row's sum. The design streams the bytes ahead of the chain and
// keeps the chain short:
//   - one thread block per target; a thread owns V sources in runs of G = 16
//     consecutive ones (paint_sweep.cuh), so a warp reads 512 contiguous
//     bytes of a row with one 16-byte load a thread. Three variants:
//       N <= 1024   one warp (V = 32), kmask in registers;
//       N <= 2048   one warp (V = 64), kmask in shared memory;
//       above       32 ceil(N / 1024) threads (V = 32, up to N = 26,624),
//                   kmask in shared memory.
//     A one-warp target needs no block barrier at all, and with 64 sources a
//     thread the 2048 targets of N = 2048 fit the card in one wave;
//   - the state row (alpha or beta) lives in registers, V floats a thread;
//   - the rows a target will read stream ahead into a ring in shared memory,
//     the step values come 32 rows ahead by shuffle, one sum a row, and the
//     backward chain is the one the full backward sweep runs (bwd_chain):
//     paint_sweep.cuh, shared with paint_bwd.cu, says how each piece works.

#include "paint_sweep.cuh"

namespace {

constexpr int G = 16;                     // sources a run (paint_sweep.cuh)
constexpr int WARP32_MAX_N = 1024;        // one warp, 32 sources a thread
constexpr int WARP64_MAX_N = 2048;        // one warp, 64 sources a thread
constexpr int BLOCK_MAX_THREADS = 832;    // the block variant: N <= 32 * 832

// The capture: row v into out[b] (zeros for v == nullptr), and the logscale.
template <int V>
__device__ __forceinline__ void store_row(const Params& p, size_t bn,
                                          const float* v, float ls) {
    store_sources<V, G>(p, p.out + bn, v);
    if (threadIdx.x == 0) p.lsout[blockIdx.x] = ls;
}

// The three variants (V sources a thread): one warp a target with kmask in
// registers (V = 32, N <= 1024) or in shared memory (V = 64, N <= 2048),
// and a block of up to BLOCK_MAX_THREADS with kmask in shared memory (V =
// 32): threads a block at most, and the ring's slots.
template <int V, bool KMS> struct Shape {
    static constexpr bool warp = V == 64 || !KMS;
    static constexpr int max_threads = warp ? 32 : BLOCK_MAX_THREADS;
    // V = 64: at most 128 registers, so that 16 targets fit a SM
    static constexpr int min_blocks = V == 64 ? 16 : 1;
    static constexpr int ring = V == 64 ? 2 : KMS ? 4 : 8;
};

template <int V, bool KMS>
__global__ void __launch_bounds__(Shape<V, KMS>::max_threads,
                                  Shape<V, KMS>::min_blocks)
fwd_capture_kernel(Params p) {
    constexpr int K = Shape<V, KMS>::ring;
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ __align__(16) float red[2][32];

    const int b = blockIdx.x;
    const int warps = (int)blockDim.x >> 5;
    const size_t bn = (size_t)b * p.N;
    const int Db = p.D[b], w = p.want[b];
    if (w < 0 || w >= p.Dmax) {     // no such row: the capture stays zero
        store_row<V>(p, bn, nullptr, 0.f);
        return;
    }
    // rows past D[b] hold the state, and nothing after the wanted row is
    // read: the sequence is rows j = 1 .. R, row j at sequence index j - 1,
    // stepping with pfac/nxt[j - 1]
    const int R = max(min(w + 1, Db) - 1, 0);
    const size_t stride = (size_t)p.B * p.N;
    const int8_t* row = p.mism + stride + bn;     // row 1
    unsigned char* ring = dyn;
    float* kms = reinterpret_cast<float*>(dyn + (size_t)K * p.slot_bytes);
#pragma unroll
    for (int i = 0; i < K; ++i) {
        if (i < R) fetch_row<V>(ring + (size_t)i * p.slot_bytes, row + i * stride,
                             p.N);
        cp_async_commit();
    }
    zero_red(&red[0][0]);
    auto h_of = [](int i) { return i; };
    Steps<decltype(h_of)> st{p.pfac + (size_t)b * p.Dmax,
                             p.nxt + (size_t)b * p.Dmax, R, h_of};
    st.start();

    float a[V], km[KMS ? 1 : V];
    const float part = load_state<V, KMS, G>(p, bn, a, km, kms);
    cp_async_wait<K - 1>();                       // my pieces of row 1
    float asum_eff = block_sum(part, red[1], warps);
    float ls = 0.f, comp = 0.f;
    const uint32_t hi = p.magic_hi;

    int s = 0;
    for (int i = 0; i < R; ++i) {
        const unsigned char* slot = ring + (size_t)s * p.slot_bytes;
        const int off = (int)((uintptr_t)row & 15);
        float pfv, nxv;
        st.at(i, pfv, nxv);
        const float rx = asum_eff * pfv;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < V / G; ++r) {
            uint32_t wd[G / 4];
            read_run<G>(slot, off, r, wd);
#pragma unroll
            for (int u = 0; u < G / 4; ++u) {
                const int q = r * (G / 4) + u;
                const uint32_t xw = wd[u] ^ 0x80808080u;
                float k[4];
                km_get<KMS>(km, kms, q, k);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int idx = 4 * q + e;
                    const float em = 1.0f + p.theta_ratio * byte_value(xw, hi, e);
                    const float v = (a[idx] + rx) * em * k[e];
                    a[idx] = v;
                    acc[e] += v;
                }
            }
        }
        cp_async_wait<K - 2>();                   // my pieces of the next row
        const float asum = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]),
                                     red[i & 1], warps);
        // every thread has read the slot: it takes sequence row i + K
        if (i + K < R) fetch_row<V>(ring + (size_t)s * p.slot_bytes,
                                 row + K * stride, p.N);
        cp_async_commit();
        const bool cond = (asum < LOWER_RESCALE) || (asum > UPPER_RESCALE);
        const float safe = asum > 0.f ? asum : 1.0f;
        float logcorr = 0.f;
        asum_eff = asum;
        if (cond) {
#pragma unroll
            for (int k = 0; k < V; ++k) a[k] = a[k] / safe;
            logcorr = logf(safe);
            asum_eff = 1.0f;
        }
        const float y = (nxv + logcorr) - comp;
        const float t = ls + y;
        comp = (t - ls) - y;
        ls = t;
        row += stride;
        if (++s == K) s = 0;
    }
    cp_async_wait<0>();
    store_row<V>(p, bn, a, ls);
}

template <int V, bool KMS>
__global__ void __launch_bounds__(Shape<V, KMS>::max_threads,
                                  Shape<V, KMS>::min_blocks)
bwd_capture_kernel(Params p) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ __align__(16) float red[2][32];

    const size_t bn = (size_t)blockIdx.x * p.N;
    const int Db = p.D[blockIdx.x], w = p.want[blockIdx.x];
    if (w < 0 || w >= Db || w >= p.Dmax) {   // no such row: zero
        store_row<V>(p, bn, nullptr, 0.f);
        return;
    }
    // the sequence is rows j0, j0 - 1, ..., w
    const int j0 = min(Db, p.Dmax) - 1;
    float be[V];
    Nothing none;
    const float pls = bwd_chain<V, KMS, Shape<V, KMS>::ring, G>(
        p, j0, j0 == Db - 1, j0 - w + 1, dyn, red, be, none, none);
    store_row<V>(p, bn, be, pls);
}

enum Variant { WARP32 = 0, WARP64 = 1, BLOCK32 = 2 };

struct Config {
    Variant variant;
    int V, threads, slot_bytes, ring;
    size_t smem;    // dynamic shared bytes: the ring (and kmask)
};

// Variant, threads, ring and shared memory of a block at width N. Fails
// past 32 * BLOCK_MAX_THREADS.
cudaError_t config_for(int N, Config* c) {
    if (N < 1 || N > 32 * BLOCK_MAX_THREADS) return cudaErrorInvalidValue;
    c->variant = N <= WARP32_MAX_N ? WARP32
               : N <= WARP64_MAX_N ? WARP64 : BLOCK32;
    c->V = c->variant == WARP64 ? 64 : 32;
    c->threads = c->variant == BLOCK32 ? 32 * ((N + 32 * 32 - 1) / (32 * 32)) : 32;
    // the runs start up to 15 bytes into a slot and a read ends at most 4
    // bytes past a run; a row's pieces span at most N + 30 bytes
    c->slot_bytes = c->V * c->threads + 32;
    c->ring = c->variant == WARP32 ? Shape<32, false>::ring
            : c->variant == WARP64 ? Shape<64, true>::ring
                                   : Shape<32, true>::ring;
    const size_t km = c->variant == WARP32 ? 0 : (size_t)c->V * c->threads * 4;
    c->smem = (size_t)c->ring * c->slot_bytes + km;
    return cudaSuccess;
}

const void* kernel_for(int backward, Variant v) {
    if (backward)
        return v == WARP32 ? (const void*)bwd_capture_kernel<32, false>
             : v == WARP64 ? (const void*)bwd_capture_kernel<64, true>
                           : (const void*)bwd_capture_kernel<32, true>;
    return v == WARP32 ? (const void*)fwd_capture_kernel<32, false>
         : v == WARP64 ? (const void*)fwd_capture_kernel<64, true>
                       : (const void*)fwd_capture_kernel<32, true>;
}

}  // namespace

// The launch configuration at width N (backward: B4, else B3): info =
// threads a block, sources a thread, ring slots, slot bytes, dynamic shared
// bytes, blocks a SM, SMs, registers a thread, local (spilled) bytes a thread.
extern "C" int paint_capture_config(int N, int backward, int* info) {
    Config c;
    cudaError_t e = config_for(N, &c);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_info(kernel_for(backward, c.variant), c.threads, c.V,
                            c.ring, c.slot_bytes, c.smem, info);
}

// One capture sweep (backward: B4, else B3) of B targets on `stream`. D,
// want (B) int32; state0 (alpha0 or beta_end), kmask (B, N) float32; mism
// (Dmax, B, N) int8; pfac, nxt (B, Dmax) float32; outputs out (B, N) and
// lsout (B) float32. Returns the CUDA error of the set-up or the launch.
extern "C" int paint_capture_launch(int backward, const void* D,
                                    const void* want, const void* state0,
                                    const void* kmask, const void* mism,
                                    const void* pfac, const void* nxt,
                                    void* out, void* lsout, int Dmax, int B,
                                    int N, float theta, float ntheta,
                                    float theta_ratio, void* stream) {
    Config c;
    cudaError_t e = config_for(N, &c);
    if (e != cudaSuccess) return (int)e;
    const void* k = kernel_for(backward, c.variant);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.smem);
    if (e != cudaSuccess) return (int)e;
    Params p = make_params(D, state0, kmask, mism, pfac, nxt, out, lsout, Dmax,
                           B, N, c.slot_bytes, theta, ntheta, theta_ratio);
    p.want = (const int*)want;
    void* args[] = {&p};
    e = cudaLaunchKernel(k, dim3(B), dim3(c.threads), args, c.smem,
                         (cudaStream_t)stream);
    return (int)e;
}

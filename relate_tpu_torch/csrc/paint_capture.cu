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
//   - one thread block per target; a thread owns V sources in groups of 16
//     consecutive ones, group g at 16 (t + g T) .. 16 (t + g T) + 15, so the
//     threads of a warp cover 512 contiguous bytes of a row. Three variants:
//       N <= 1024   one warp (V = 32), kmask in registers;
//       N <= 2048   one warp (V = 64), kmask in shared memory;
//       above       32 ceil(N / 1024) threads (V = 32, up to N = 26,624),
//                   kmask in shared memory.
//     A one-warp target needs no block barrier at all, and with 64 sources a
//     thread the 2048 targets of N = 2048 fit the card in one wave;
//   - the state row (alpha or beta) lives in registers, V floats a thread;
//   - the rows a target will read are copied ahead into a ring of K slots in
//     shared memory (cp.async.cg, 16-byte pieces shared out over the threads,
//     one commit group a row): row i + K is requested as soon as every thread
//     has read row i, so K - 1 rows are in flight while a row is computed. A
//     row is the N bytes at mism + (j B + b) N, which need not start on a
//     16-byte boundary: the copy takes the pieces that cover it (a piece
//     never leaves the pages of the bytes it carries) and the row starts
//     `off` bytes into its slot. A thread reads its 16 bytes of a group with
//     one 16-byte load where off == 0, else with five 4-byte loads and
//     funnel shifts;
//   - the two step values a row needs (pfac, nxt) are loaded 32 rows ahead,
//     one row a lane, and taken by every lane with a shuffle;
//   - one sum a row: a butterfly of shuffles, which leaves the same value in
//     every lane; in a block of several warps each warp's sum goes into a
//     word of a buffer chosen by row parity and after the one barrier every
//     thread adds the words in the same order, so all threads hold the same
//     sum bit for bit and take the same rescale;
//   - a byte becomes a float without a conversion instruction: byte ^ 0x80 in
//     the low byte of 0x4B000000 is the float 2^23 + 128 + byte, exactly;
//   - the backward sweep keeps the bytes of the row it came from (mism[j+1])
//     in registers, so no row is read twice, and divides by theta and
//     1 - theta through their reciprocals (`quotient`).
// The rescale divides in registers as the plain version does (alpha / safe).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOWER_RESCALE = 1e-10f;
constexpr float UPPER_RESCALE = 1e10f;
constexpr int WARP32_MAX_N = 1024;        // one warp, 32 sources a thread
constexpr int WARP64_MAX_N = 2048;        // one warp, 64 sources a thread
constexpr int BLOCK_MAX_THREADS = 832;    // the block variant: N <= 32 * 832
constexpr float MAGIC = 8388736.0f;       // 2^23 + 128

struct Params {
    const int* D;
    const int* want;
    const float* state0;    // alpha0 (forward) or beta_end (backward)
    const float* kmask;
    const int8_t* mism;
    const float* pfac;
    const float* nxt;
    float* out;
    float* lsout;
    int Dmax, B, N;
    int slot_bytes;         // bytes of one ring slot
    uint32_t magic_hi;      // 0x4B000000, a register operand of PRMT
    float theta, ntheta, theta_ratio;
    float inv_theta, inv_ntheta;   // 1 / theta, 1 / ntheta, rounded once
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ uintptr_t floor16(const void* p) {
    return (uintptr_t)p & ~(uintptr_t)15;
}

// Start copying the N bytes at `row` into `slot`: the 16-byte pieces that
// cover them, at most V / 16 + 1 a thread (the block has N / V threads or
// more). A piece never leaves the pages of the bytes it carries.
template <int V>
__device__ __forceinline__ void fetch_row(unsigned char* slot,
                                          const int8_t* row, int N) {
    const uintptr_t a0 = floor16(row);
    const int pieces = (int)((floor16(row + N + 15) - a0) >> 4);
#pragma unroll
    for (int m = 0; m <= V / 16; ++m) {
        const int k = (int)threadIdx.x + m * (int)blockDim.x;
        if (k < pieces)
            cp_async16(slot + 16 * k, (const void*)(a0 + 16 * (uintptr_t)k));
    }
}

// The 16 bytes of group u of the row that starts `off` bytes into `slot`.
__device__ __forceinline__ void read_group(const unsigned char* slot, int off,
                                           int u, uint32_t w[4]) {
    if (off == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(slot + 16 * u);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
        const uint32_t* s = reinterpret_cast<const uint32_t*>(slot);
        const int q = off + 16 * u;
        const int i0 = q >> 2;
        const unsigned sh = (unsigned)(q & 3) * 8u;
        uint32_t x[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) x[k] = s[i0 + k];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(x[k], x[k + 1], sh);
    }
}

// Byte e of `xw` (a word of mismatch bytes XOR 0x80808080) as the bits of
// the float 2^23 + 128 + byte. `hi` is 0x4B000000, passed in from the host
// so that it stays in a register and the selector is the immediate.
__device__ __forceinline__ int magic_bits(uint32_t xw, uint32_t hi, int e) {
    return (int)__byte_perm(xw, hi, 0x7440u + (unsigned)e);
}

__device__ __forceinline__ float byte_value(uint32_t xw, uint32_t hi, int e) {
    return __int_as_float(magic_bits(xw, hi, e)) - MAGIC;
}

// The step values (pfac, nxt) of the rows of a target's sequence: lane l of
// each warp holds those of rows 32 c + l of the current batch c and of the
// next batch, loaded 32 rows before they are needed; row i takes its
// values from lane i % 32 with a shuffle. `h_of(i)` is the index into
// pfac/nxt of sequence row i, negative for none.
template <typename H>
struct Steps {
    const float* pf;
    const float* nx;
    int R;
    H h_of;
    float pf_cur, nx_cur, pf_next, nx_next;

    __device__ __forceinline__ void load(int batch, float& p, float& n) const {
        const int i = 32 * batch + (int)(threadIdx.x & 31);
        const int h = i < R ? h_of(i) : -1;
        p = h >= 0 ? pf[h] : 0.f;
        n = h >= 0 ? nx[h] : 0.f;
    }
    __device__ __forceinline__ void start() {
        load(0, pf_cur, nx_cur);
        load(1, pf_next, nx_next);
    }
    // the values of row i, and after the batch's last row the next batches
    __device__ __forceinline__ void at(int i, float& p, float& n) {
        p = __shfl_sync(0xffffffffu, pf_cur, i & 31);
        n = __shfl_sync(0xffffffffu, nx_cur, i & 31);
        if ((i & 31) == 31) {
            pf_cur = pf_next;
            nx_cur = nx_next;
            load((i >> 5) + 2, pf_next, nx_next);
        }
    }
};

// The bytes of the row after this one in the backward sweep (row j + 1),
// kept from the row before: as float values where registers are plenty
// (one warp a target), else as packed words (a quarter of a register a
// source).
template <int V, bool PACKED> struct NextRow;

template <int V> struct NextRow<V, false> {
    float f[V];
    __device__ __forceinline__ float value(int idx, uint32_t) const {
        return f[idx];
    }
    __device__ __forceinline__ void set(int idx, uint32_t, int mb) {
        f[idx] = __int_as_float(mb) - MAGIC;
    }
};

template <int V> struct NextRow<V, true> {
    uint32_t w[V / 4];
    __device__ __forceinline__ float value(int idx, uint32_t hi) const {
        return byte_value(w[idx >> 2], hi, idx & 3);
    }
    __device__ __forceinline__ void set(int idx, uint32_t xw, int) {
        if ((idx & 3) == 3) w[idx >> 2] = xw;
    }
};

// a / d from the reciprocal of d rounded once: q = a (1/d), then one fused
// correction, q + (a - d q) (1/d) (Markstein), which rounds as a / d does
// for normal operands and keeps the division's slow path off the chain.
__device__ __forceinline__ float quotient(float a, float d, float inv) {
    const float q = a * inv;
    return fmaf(fmaf(-d, q, a), inv, q);
}

// Sum over the block; every thread returns the same value. A butterfly of
// shuffles leaves the same sum in every lane (a + b == b + a), so a block of
// one warp needs nothing more than __syncwarp (which also publishes the
// warp's copies and step values). Otherwise each warp's sum goes into `red`
// (zero-padded to a multiple of 4, alternating with the row parity), and
// after the one barrier every thread adds the words in the same order.
__device__ __forceinline__ float block_sum(float v, float* red, int warps) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (warps == 1) {
        __syncwarp();
        return v;
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll 1
    for (int k = 0; k < warps; k += 4) {
        const float4 r = *reinterpret_cast<const float4*>(red + k);
        s += r.x; s += r.y; s += r.z; s += r.w;
    }
    return s;
}

// The state, kmask and output rows move in 16-byte pieces where each row
// starts on a 16-byte boundary, else one float at a time.
__device__ __forceinline__ bool vec4_ok(const Params& p) {
    return (p.N & 3) == 0 &&
           (((uintptr_t)p.state0 | (uintptr_t)p.kmask | (uintptr_t)p.out)
            & 15) == 0;
}

// Where thread t keeps kmask quad q (sources 4q .. 4q + 3 of its groups) in
// shared memory: quads interleaved over the threads, so a warp's 16-byte
// loads fall on consecutive addresses.
__device__ __forceinline__ float4* km_quad(float* kms, int q) {
    return reinterpret_cast<float4*>(kms) + (size_t)q * blockDim.x +
           threadIdx.x;
}

// The target's state0 * kmask into v (and kmask into km, or with KMS into
// the shared kms), zero past N; returns this thread's sum.
template <int V, bool KMS>
__device__ __forceinline__ float load_state(const Params& p, size_t bn,
                                            float* v, float* km, float* kms) {
    const int T = blockDim.x;
    const bool vec = vec4_ok(p);
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < V / 16; ++g) {
        const int n0 = 16 * ((int)threadIdx.x + g * T);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int n = n0 + 4 * q;
            float k4[4], s4[4];
            if (vec && n < p.N) {
                const float4 a = *reinterpret_cast<const float4*>(p.state0 + bn + n);
                const float4 k = *reinterpret_cast<const float4*>(p.kmask + bn + n);
                s4[0] = a.x; s4[1] = a.y; s4[2] = a.z; s4[3] = a.w;
                k4[0] = k.x; k4[1] = k.y; k4[2] = k.z; k4[3] = k.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool in = n + e < p.N;
                    s4[e] = in ? p.state0[bn + n + e] : 0.f;
                    k4[e] = in ? p.kmask[bn + n + e] : 0.f;
                }
            }
            if constexpr (KMS)
                *km_quad(kms, 4 * g + q) = make_float4(k4[0], k4[1], k4[2], k4[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = 16 * g + 4 * q + e;
                v[i] = s4[e] * k4[e];
                if constexpr (!KMS) km[i] = k4[e];
                s += v[i];
            }
        }
    }
    return s;
}

// kmask of quad q of this thread's sources.
template <bool KMS>
__device__ __forceinline__ void km_get(const float* km, float* kms, int q,
                                       float k[4]) {
    if constexpr (KMS) {
        const float4 v = *km_quad(kms, q);
        k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) k[e] = km[4 * q + e];
    }
}

// The row v into out[b] (zeros for v == nullptr), and the logscale.
template <int V>
__device__ __forceinline__ void store_row(const Params& p, size_t bn,
                                          const float* v, float ls) {
    const int T = blockDim.x;
    const bool vec = vec4_ok(p);
#pragma unroll
    for (int g = 0; g < V / 16; ++g) {
        const int n0 = 16 * ((int)threadIdx.x + g * T);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int n = n0 + 4 * q;
            const int i = 16 * g + 4 * q;
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) o[e] = v ? v[i + e] : 0.f;
            if (vec && n < p.N) {
                *reinterpret_cast<float4*>(p.out + bn + n) =
                    make_float4(o[0], o[1], o[2], o[3]);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (n + e < p.N) p.out[bn + n + e] = o[e];
            }
        }
    }
    if (threadIdx.x == 0) p.lsout[blockIdx.x] = ls;
}

__device__ __forceinline__ void zero_red(float* red) {
    for (int k = threadIdx.x; k < 64; k += blockDim.x) red[k] = 0.f;
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
    const int T = blockDim.x, warps = T >> 5;
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
    const float part = load_state<V, KMS>(p, bn, a, km, kms);
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
        for (int g = 0; g < V / 16; ++g) {
            const int u = (int)threadIdx.x + g * T;
            uint32_t wd[4];
            read_group(slot, off, u, wd);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t xw = wd[q] ^ 0x80808080u;
                float k[4];
                km_get<KMS>(km, kms, 4 * g + q, k);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int idx = 16 * g + 4 * q + e;
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

// One row of the backward sweep over this thread's sources: with STEP, beta
// = (beta + dn*bt + b1) * (1 + tr*dn) * kmask from the previous row's bytes
// dn (`nxt`); then the weighted sum over the row's own bytes, which become
// the next row's. Returns this thread's part of the sum.
template <int V, bool KMS, bool STEP>
__device__ __forceinline__ float bwd_row(const Params& p, const unsigned char* slot,
                                         int off, float* be, const float* km,
                                         float* kms, NextRow<V, KMS>& nxt,
                                         float b1, float bt) {
    const uint32_t hi = p.magic_hi;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int g = 0; g < V / 16; ++g) {
        uint32_t cur[4];
        read_group(slot, off, (int)threadIdx.x + g * (int)blockDim.x, cur);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t xw = cur[q] ^ 0x80808080u;
            float k[4];
            if (STEP) km_get<KMS>(km, kms, 4 * g + q, k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int idx = 16 * g + 4 * q + e;
                float v = be[idx];
                const int mb = magic_bits(xw, hi, e);
                if (STEP) {
                    const float dn = nxt.value(idx, hi);
                    const float em = 1.0f + p.theta_ratio * dn;
                    v = (v + dn * bt + b1) * em * k[e];
                    be[idx] = v;
                }
                nxt.set(idx, xw, mb);
                const float wt = mb > 0x4B000080 ? p.theta : p.ntheta;
                acc[e] += wt * v;
            }
        }
    }
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int V, bool KMS>
__global__ void __launch_bounds__(Shape<V, KMS>::max_threads,
                                  Shape<V, KMS>::min_blocks)
bwd_capture_kernel(Params p) {
    constexpr int K = Shape<V, KMS>::ring;
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ __align__(16) float red[2][32];

    const int b = blockIdx.x;
    const int T = blockDim.x, warps = T >> 5;
    const size_t bn = (size_t)b * p.N;
    const int Db = p.D[b], w = p.want[b];
    if (w < 0 || w >= Db || w >= p.Dmax) {   // no such row: zero
        store_row<V>(p, bn, nullptr, 0.f);
        return;
    }
    // the sequence is rows j0, j0 - 1, ..., w; row j0 = D[b] - 1 starts the
    // chain (for D <= Dmax, the contract) and row j steps with pfac/nxt
    // [j + 1], clamped as the plain version clamps it
    const int j0 = min(Db, p.Dmax) - 1;
    const bool init = j0 == Db - 1;
    const int R = j0 - w + 1;
    const size_t stride = (size_t)p.B * p.N;
    const int8_t* row = p.mism + (size_t)j0 * stride + bn;
    unsigned char* ring = dyn;
    float* kms = reinterpret_cast<float*>(dyn + (size_t)K * p.slot_bytes);
#pragma unroll
    for (int i = 0; i < K; ++i) {
        if (i < R) fetch_row<V>(ring + (size_t)i * p.slot_bytes, row - i * stride,
                             p.N);
        cp_async_commit();
    }
    zero_red(&red[0][0]);
    const int Dmax = p.Dmax;
    auto h_of = [j0, init, Dmax](int i) {
        return i == 0 && init ? -1 : min(j0 - i + 1, Dmax - 1);
    };
    Steps<decltype(h_of)> st{p.pfac + (size_t)b * p.Dmax,
                             p.nxt + (size_t)b * p.Dmax, R, h_of};
    st.start();

    float be[V], km[KMS ? 1 : V];
    load_state<V, KMS>(p, bn, be, km, kms);
    NextRow<V, KMS> next;
    float pls = 0.f, comp = 0.f, bsum_eff = 1.0f;
    cp_async_wait<K - 1>();                       // my pieces of row j0
    __syncthreads();

    // after a row's own part of the sum: wait for the next row's bytes,
    // sum, request row i + K into the slot just read, rescale (not the first
    // row of the chain) and add to the logscale
    int s = 0;
    auto finish = [&](int i, float part, float inc, bool first) {
        cp_async_wait<K - 2>();                   // my pieces of the next row
        const float bsum = block_sum(part, red[i & 1], warps);
        if (i + K < R) fetch_row<V>(ring + (size_t)s * p.slot_bytes,
                                 row - K * stride, p.N);
        cp_async_commit();
        const bool cond = !first &&
                          ((bsum < LOWER_RESCALE) || (bsum > UPPER_RESCALE));
        const float safe = bsum > 0.f ? bsum : 1.0f;
        float logcorr = 0.f;
        bsum_eff = bsum;
        if (cond) {
#pragma unroll
            for (int k = 0; k < V; ++k) be[k] = be[k] / safe;
            logcorr = logf(safe);
            bsum_eff = 1.0f;
        }
        const float y = (inc + logcorr) - comp;
        const float t = pls + y;
        comp = (t - pls) - y;
        pls = t;
        row -= stride;
        if (++s == K) s = 0;
    };
    float inc = 0.f;
    auto step = [&](int i) {
        float pfv;
        st.at(i, pfv, inc);
        const float rx = bsum_eff * pfv;
        const float b1 = quotient(rx, p.ntheta, p.inv_ntheta);
        const float bt = quotient(rx, p.theta, p.inv_theta) - b1;
        return bwd_row<V, KMS, true>(p, ring + (size_t)s * p.slot_bytes,
                                     (int)((uintptr_t)row & 15), be, km, kms,
                                     next, b1, bt);
    };
    const unsigned char* slot0 = ring;
    const int off0 = (int)((uintptr_t)row & 15);
    if (init) {
        // row D[b] - 1: beta_end * kmask, no step, no rescale, logscale 0
        finish(0, bwd_row<V, KMS, false>(p, slot0, off0, be, km, kms, next,
                                         0.f, 0.f), 0.f, true);
    } else {
        // past the last row (D > Dmax) the next row is the row itself
#pragma unroll
        for (int k = 0; k < V; ++k) be[k] = 0.f;
        bwd_row<V, KMS, false>(p, slot0, off0, be, km, kms, next, 0.f, 0.f);
        const float part = step(0);
        finish(0, part, inc, false);
    }
    for (int i = 1; i < R; ++i) {
        const float part = step(i);
        finish(i, part, inc, false);
    }
    cp_async_wait<0>();
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
    // a thread's last group reads up to 20 bytes past its own 16, and a
    // row's pieces span at most N + 30 bytes
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
    const void* k = kernel_for(backward, c.variant);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, c.threads,
                                                      c.smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return (int)e;
    info[0] = c.threads;
    info[1] = c.V;
    info[2] = c.ring;
    info[3] = c.slot_bytes;
    info[4] = (int)c.smem;
    info[5] = per_sm;
    info[6] = sms;
    info[7] = attr.numRegs;
    info[8] = (int)attr.localSizeBytes;
    return 0;
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
    Params p;
    p.D = (const int*)D;
    p.want = (const int*)want;
    p.state0 = (const float*)state0;
    p.kmask = (const float*)kmask;
    p.mism = (const int8_t*)mism;
    p.pfac = (const float*)pfac;
    p.nxt = (const float*)nxt;
    p.out = (float*)out;
    p.lsout = (float*)lsout;
    p.Dmax = Dmax;
    p.B = B;
    p.N = N;
    p.slot_bytes = c.slot_bytes;
    p.magic_hi = 0x4B000000u;
    p.theta = theta;
    p.ntheta = ntheta;
    p.theta_ratio = theta_ratio;
    p.inv_theta = (float)(1.0 / (double)theta);
    p.inv_ntheta = (float)(1.0 / (double)ntheta);
    void* args[] = {&p};
    e = cudaLaunchKernel(k, dim3(B), dim3(c.threads), args, c.smem,
                         (cudaStream_t)stream);
    return (int)e;
}

// Device code shared by the streaming painting sweeps for sm_90a: the
// capture sweeps (paint_capture.cu, B3 and B4) and the full backward sweep
// with the posterior (paint_bwd.cu, B2). Included by both sources; the
// build hashes this file with each of them (ops/_build.py).
//
// Layout (see ops/paint_kernels.py): per-target state (B, N), the mismatch
// stream and the full outputs (Dmax, B, N), the step vectors (B, Dmax),
// unshifted. One thread block per target, T threads; thread t owns V
// sources in runs of G consecutive ones, run r at G (t + r T) .. G (t + r T)
// + G - 1, each run G / 4 quads of 4 sources. The run length is the
// sweep's choice between its two kinds of traffic:
//   G = 16  a run's mismatch bytes are one 16-byte read from shared memory
//           (the capture sweeps, which move little else);
//   G = 4   a warp's 16-byte accesses to a float row (alpha, the output)
//           cover 512 contiguous bytes, whole sectors; with runs of 16 a
//           warp's store would write 16 bytes in every 64 (the full
//           backward sweep, whose float rows are most of its bytes).
//
// What the pieces do:
//   - the rows a target will read are copied ahead into a ring of K slots in
//     shared memory (cp.async.cg, 16-byte pieces shared out over the threads,
//     one commit group a row): row i + K is requested as soon as every thread
//     has read row i, so K - 1 rows are in flight while a row is computed. A
//     row is the N bytes at mism + (j B + b) N, which need not start on a
//     16-byte boundary: the copy takes the pieces that cover it (a piece
//     never leaves the pages of the bytes it carries) and the row starts
//     `off` bytes into its slot. A thread reads a run's bytes with one
//     16-byte load where off == 0 (G = 16) or one 4-byte load where off is a
//     multiple of 4 (G = 4), else with G / 4 + 1 4-byte loads and funnel
//     shifts;
//   - the two step values a row needs (pfac, nxt) are loaded 32 rows ahead,
//     one row a lane, and taken by every lane with a shuffle;
//   - one sum a row: a butterfly of shuffles, which leaves the same value in
//     every lane; in a block of several warps each warp's sum goes into a
//     word of a buffer chosen by row parity and after the one barrier every
//     thread adds the words in the same order, so all threads hold the same
//     sum bit for bit and take the same rescale;
//   - a byte becomes a float without a conversion instruction: byte ^ 0x80 in
//     the low byte of 0x4B000000 is the float 2^23 + 128 + byte, exactly;
//   - the backward chain keeps the bytes of the row it came from (mism[j+1])
//     in registers, so no row is read twice, and divides by theta and
//     1 - theta through their reciprocals (`quotient`). The rescale divides
//     in registers as the plain version does (beta / safe).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOWER_RESCALE = 1e-10f;
constexpr float UPPER_RESCALE = 1e10f;
constexpr float MAGIC = 8388736.0f;       // 2^23 + 128

struct Params {
    const int* D;
    const int* want;        // capture sweeps only
    const float* state0;    // alpha0 (forward) or beta_end (backward)
    const float* kmask;
    const int8_t* mism;
    const float* pfac;
    const float* nxt;
    const float* alphas;    // full backward sweep, posterior mode only
    const float* lsf;       // idem
    float* out;
    float* lsout;
    int Dmax, B, N;
    int slot_bytes;         // bytes of one ring slot
    uint32_t magic_hi;      // 0x4B000000, a register operand of PRMT
    float theta, ntheta, theta_ratio;
    float inv_theta, inv_ntheta;   // 1 / theta, 1 / ntheta, rounded once
};

// The fields every sweep fills alike.
inline Params make_params(const void* D, const void* state0, const void* kmask,
                          const void* mism, const void* pfac, const void* nxt,
                          void* out, void* lsout, int Dmax, int B, int N,
                          int slot_bytes, float theta, float ntheta,
                          float theta_ratio) {
    Params p{};
    p.D = (const int*)D;
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
    p.slot_bytes = slot_bytes;
    p.magic_hi = 0x4B000000u;
    p.theta = theta;
    p.ntheta = ntheta;
    p.theta_ratio = theta_ratio;
    p.inv_theta = (float)(1.0 / (double)theta);
    p.inv_ntheta = (float)(1.0 / (double)ntheta);
    return p;
}

// Registers, spills and occupancy of kernel k at `threads` threads and
// `smem` dynamic shared bytes: info = threads, V, ring, slot bytes, smem,
// blocks a SM, SMs, registers a thread, local (spilled) bytes a thread.
inline cudaError_t launch_info(const void* k, int threads, int V, int ring,
                               int slot_bytes, size_t smem, int* info) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return e;
    info[0] = threads;
    info[1] = V;
    info[2] = ring;
    info[3] = slot_bytes;
    info[4] = (int)smem;
    info[5] = per_sm;
    info[6] = sms;
    info[7] = attr.numRegs;
    info[8] = (int)attr.localSizeBytes;
    return cudaSuccess;
}

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

// The first source of this thread's quad q (runs of G sources).
template <int G>
__device__ __forceinline__ int quad_source(int q) {
    return G * ((int)threadIdx.x + (q / (G / 4)) * (int)blockDim.x) +
           4 * (q % (G / 4));
}

// The G bytes of this thread's run r of the row that starts `off` bytes
// into `slot`, as G / 4 words (reading at most 4 bytes past the run).
template <int G>
__device__ __forceinline__ void read_run(const unsigned char* slot, int off,
                                         int r, uint32_t* w) {
    constexpr int W = G / 4;
    const int u = (int)threadIdx.x + r * (int)blockDim.x;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(slot);
    const int i0 = (off >> 2) + W * u;
    if constexpr (G == 16) {
        if (off == 0) {
            const uint4 v = *reinterpret_cast<const uint4*>(slot + 16 * u);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
            return;
        }
    } else {
        if ((off & 3) == 0) {
#pragma unroll
            for (int k = 0; k < W; ++k) w[k] = s[i0 + k];
            return;
        }
    }
    const unsigned sh = (unsigned)(off & 3) * 8u;
    uint32_t x[W + 1];
#pragma unroll
    for (int k = 0; k <= W; ++k) x[k] = s[i0 + k];
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] = __funnelshift_r(x[k], x[k + 1], sh);
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
// (one warp a target, kmask in registers), else as packed words (a quarter
// of a register a source).
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

// The state, kmask, alpha and output rows move in 16-byte pieces where each
// row starts on a 16-byte boundary, else one float at a time.
__device__ __forceinline__ bool vec4_ok(const Params& p) {
    return (p.N & 3) == 0 &&
           (((uintptr_t)p.state0 | (uintptr_t)p.kmask | (uintptr_t)p.out |
             (uintptr_t)p.alphas) & 15) == 0;
}

// Sources n .. n + 3 of a float row that is read once (zeros past N).
__device__ __forceinline__ void load_quad(const float* row, int n, int N,
                                          bool vec, float* x) {
    if (vec && n < N) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(row + n));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = n + e < N ? __ldcs(row + n + e) : 0.f;
    }
}

// Sources n .. n + 3 of an output row, written once (streaming stores).
__device__ __forceinline__ void store_quad(float* row, int n, int N, bool vec,
                                           const float* x) {
    if (vec && n < N) {
        __stcs(reinterpret_cast<float4*>(row + n),
               make_float4(x[0], x[1], x[2], x[3]));
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (n + e < N) __stcs(row + n + e, x[e]);
    }
}

// This thread's sources of the row v into `dst` (zeros for v == nullptr).
template <int V, int G>
__device__ __forceinline__ void store_sources(const Params& p, float* dst,
                                              const float* v) {
    const bool vec = vec4_ok(p);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = v ? v[4 * k + e] : 0.f;
        store_quad(dst, quad_source<G>(k), p.N, vec, o);
    }
}

// Where thread t keeps kmask of its quad q in shared memory: quads
// interleaved over the threads, so a warp's 16-byte loads fall on
// consecutive addresses.
__device__ __forceinline__ float4* km_quad(float* kms, int q) {
    return reinterpret_cast<float4*>(kms) + (size_t)q * blockDim.x +
           threadIdx.x;
}

// The target's state0 * kmask into v (and kmask into km, or with KMS into
// the shared kms), zero past N; returns this thread's sum.
template <int V, bool KMS, int G>
__device__ __forceinline__ float load_state(const Params& p, size_t bn,
                                            float* v, float* km, float* kms) {
    const bool vec = vec4_ok(p);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
        const int n = quad_source<G>(q);
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
            *km_quad(kms, q) = make_float4(k4[0], k4[1], k4[2], k4[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = 4 * q + e;
            v[i] = s4[e] * k4[e];
            if constexpr (!KMS) km[i] = k4[e];
            s += v[i];
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

__device__ __forceinline__ void zero_red(float* red) {
    for (int k = threadIdx.x; k < 64; k += blockDim.x) red[k] = 0.f;
}

// A hook that does nothing (emit or after of a chain that keeps no rows).
struct Nothing {
    template <typename... A>
    __device__ __forceinline__ void operator()(A...) const {}
};

// One row of the backward sweep over this thread's sources: with STEP, beta
// = (beta + dn*bt + b1) * (1 + tr*dn) * kmask from the previous row's bytes
// dn (`nxt`); then the weighted sum over the row's own bytes, which become
// the next row's. emit(q, v) gets each quad's beta before the rescale.
// Returns this thread's part of the sum.
template <int V, bool KMS, bool STEP, int G, typename Emit>
__device__ __forceinline__ float bwd_row(const Params& p, const unsigned char* slot,
                                         int off, float* be, const float* km,
                                         float* kms, NextRow<V, KMS>& nxt,
                                         float b1, float bt, Emit& emit) {
    const uint32_t hi = p.magic_hi;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < V / G; ++r) {
        uint32_t w[G / 4];
        read_run<G>(slot, off, r, w);
#pragma unroll
        for (int u = 0; u < G / 4; ++u) {
            const int q = r * (G / 4) + u;
            const uint32_t xw = w[u] ^ 0x80808080u;
            float k[4], vq[4];
            if (STEP) km_get<KMS>(km, kms, q, k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int idx = 4 * q + e;
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
                vq[e] = v;
            }
            emit(q, vq);
        }
    }
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The backward chain of target blockIdx.x over the R rows j0, j0 - 1, ...,
// j0 - R + 1 (R >= 1), with a ring of K slots at the start of `dyn` and
// kmask after it (KMS). Row j0 = min(D, Dmax) - 1 starts the chain: with
// `init` (j0 == D - 1) as beta_end * kmask, no rescale, logscale 0; else
// (D > Dmax) as a step from zeros, its next row the row itself. Row j steps
// with pfac/nxt[j + 1], clamped as the plain version clamps it. Per row:
// emit(q, v) with each quad's beta before the rescale, then after(i,
// pls, be) with the logscale and beta after it. Leaves the last row's beta
// in `be` and returns its logscale.
template <int V, bool KMS, int K, int G, typename Emit, typename After>
__device__ __forceinline__ float bwd_chain(const Params& p, int j0, bool init,
                                           int R, unsigned char* dyn,
                                           float (*red)[32], float* be,
                                           Emit& emit, After& after) {
    const int warps = (int)blockDim.x >> 5;
    const int b = blockIdx.x;
    const size_t bn = (size_t)b * p.N;
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

    float km[KMS ? 1 : V];
    load_state<V, KMS, G>(p, bn, be, km, kms);
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
        after(i, pls, be);
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
        return bwd_row<V, KMS, true, G>(p, ring + (size_t)s * p.slot_bytes,
                                     (int)((uintptr_t)row & 15), be, km, kms,
                                     next, b1, bt, emit);
    };
    const int off0 = (int)((uintptr_t)row & 15);
    if (init) {
        finish(0, bwd_row<V, KMS, false, G>(p, ring, off0, be, km, kms, next,
                                         0.f, 0.f, emit), 0.f, true);
    } else {
        Nothing none;
#pragma unroll
        for (int k = 0; k < V; ++k) be[k] = 0.f;
        bwd_row<V, KMS, false, G>(p, ring, off0, be, km, kms, next, 0.f, 0.f,
                                  none);
        const float part = step(0);
        finish(0, part, inc, false);
    }
    for (int i = 1; i < R; ++i) {
        const float part = step(i);
        finish(i, part, inc, false);
    }
    cp_async_wait<0>();
    return pls;
}

}  // namespace

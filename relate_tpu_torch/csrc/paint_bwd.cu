// Full backward Li & Stephens sweep fused with the posterior for sm_90a
// (B2): every row of the backward chain, as alpha * beta (posterior mode)
// or as beta (beta mode), with its logscale.
//
// Replaces the TPU kernel relate_tpu/ops/paint_kernels.py:_bwd_kernel
// (bwd_pallas, with and without emit_beta). State is (B, N), the mismatch
// stream, alphas and the outputs (Dmax, B, N), the step vectors (B, Dmax),
// unshifted, lsf and the output logscales (Dmax, B).
//
// Recurrence, identical to the plain version in ops/paint_kernels.py:
//   j >= D[b]:    inactive, the outputs of that row are zero
//   j == D[b]-1:  beta = beta_end * kmask, no rescale, logscale 0
//   j <  D[b]-1:  rx = bsum * pfac[b, j+1]; b1 = rx/(1-theta);
//                 bt = rx/theta - b1; dn = mism[j+1]
//                 beta = (beta + dn*bt + b1) * (1 + tr*dn) * kmask
//                 bsum = sum(w * beta), w = mism[j] ? theta : 1-theta
//                 posterior row = alpha[j] * beta BEFORE the rescale;
//                 then the rescale; pls += nxt[b, j+1] + log (Kahan)
//   outputs: MODE_POST  alpha*beta and lsf[j] + pls
//            MODE_BETA  post-rescale beta and pls
//
// What bounds it: bytes. A cell moves 9 of them in the posterior mode (1 of
// mismatch and 4 of alpha read, 4 written) and 5 in the beta mode; only the
// mismatch byte feeds the chain of rows, in which each row needs the
// previous row's sum. The design keeps the chain that of the backward
// capture sweep and streams everything else past it:
//   - the chain is bwd_chain of paint_sweep.cuh (one block a target, the
//     beta row in registers, the mismatch rows copied ahead into a ring in
//     shared memory, step values 32 rows ahead by shuffle, one sum a row),
//     with runs of G = 4 sources a thread: a warp's 16-byte access to a
//     float row covers 512 contiguous bytes;
//   - the alpha row and the output row never touch shared memory. Each
//     thread holds the alpha quads of its sources for the NEXT row in
//     registers: a quad's product alpha * beta is taken as soon as the
//     chain has its beta, written with a 16-byte streaming store
//     (st.global.cs), and its register is refilled at once with a 16-byte
//     streaming load (ld.global.cs) of the row below, so a whole alpha row
//     is in flight while a row is computed (4 N bytes a target);
//   - the beta mode writes the row after its rescale from the same
//     registers; rows past D[b] are zeroed with the same stores, one row
//     with each row of the chain and the rest after it; the logscales of 32
//     rows are written at once by the lanes of warp 0, lsf read a batch
//     ahead.
// Four variants (V sources a thread, threads a block):
//   N <= 1024    one warp, V = 32, kmask in registers;
//   N <= 2048    one warp, V = 64, kmask in shared memory;
//   N <= 8192    32 ceil(N / 1024) threads, V = 32, kmask in shared memory,
//                up to 255 registers a thread (capped at 128 for blocks of
//                512 threads, the alpha registers spilled and the sweep ran
//                slower at N = 4096);
//   above        the same blocks up to 832 threads (N <= 26,624), whose
//                registers cannot also hold an alpha row: each quad of
//                alpha is read in its own row, a round trip a row.

#include "paint_sweep.cuh"

namespace {

constexpr int G = 4;                      // sources a run (paint_sweep.cuh)
constexpr int MODE_POST = 0, MODE_BETA = 1;
constexpr int WARP32_MAX_N = 1024;
constexpr int WARP64_MAX_N = 2048;
constexpr int BLOCK_MAX_THREADS = 256;    // with an alpha row ahead: N <= 8192
constexpr int WIDE_MAX_THREADS = 832;     // N <= 32 * 832

template <int V, bool KMS, bool AHEAD> struct Shape {
    static constexpr bool warp = V == 64 || !KMS;
    static constexpr int max_threads =
        warp ? 32 : AHEAD ? BLOCK_MAX_THREADS : WIDE_MAX_THREADS;
    static constexpr int ring = KMS ? 4 : 8;
};

template <int V, bool KMS, bool AHEAD, int MODE>
__global__ void __launch_bounds__(Shape<V, KMS, AHEAD>::max_threads, 1)
paint_bwd_kernel(Params p) {
    constexpr bool POST = MODE == MODE_POST;
    constexpr bool HELD = POST && AHEAD;          // the next alpha row in registers
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ __align__(16) float red[2][32];

    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const size_t bn = (size_t)b * p.N;
    const size_t stride = (size_t)p.B * p.N;
    const int Db = p.D[b];
    const int R = max(min(Db, p.Dmax), 0);        // rows R - 1 .. 0 are active
    const bool vec = vec4_ok(p);

    int zrow = p.Dmax - 1;                        // the next row past D to zero
    auto zero_row = [&]() {
        store_sources<V, G>(p, p.out + (size_t)zrow * stride + bn, nullptr);
        if (threadIdx.x == 0) p.lsout[(size_t)zrow * p.B + b] = 0.f;
        --zrow;
    };

    if (R > 0) {
        const int j0 = R - 1;
        int j = j0;                               // the chain's row
        float* orow = p.out + (size_t)j0 * stride + bn;
        const float* arow = POST ? p.alphas + (size_t)j0 * stride + bn : nullptr;
        float al[HELD ? V : 1];
        if constexpr (HELD) {
#pragma unroll
            for (int q = 0; q < V / 4; ++q)
                load_quad(arow, quad_source<G>(q), p.N, vec, &al[4 * q]);
        }
        // logscales: lane l of warp 0 holds lsf and pls of sequence row
        // 32 c + l of batch c (row j0 - 32 c - l), lsf read a batch ahead
        auto lsf_of = [&](int c) {
            const int i = 32 * c + lane;
            return POST && i < R ? p.lsf[(size_t)(j0 - i) * p.B + b] : 0.f;
        };
        float lsf_cur = 0.f, lsf_next = 0.f, pls_mine = 0.f;
        if (threadIdx.x < 32) {
            lsf_cur = lsf_of(0);
            lsf_next = lsf_of(1);
        }

        auto emit = [&](int q, const float* v) {
            if constexpr (POST) {
                const int n = quad_source<G>(q);
                float x[4];
                if constexpr (HELD) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) x[e] = al[4 * q + e];
                } else {
                    load_quad(arow, n, p.N, vec, x);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) x[e] *= v[e];
                store_quad(orow, n, p.N, vec, x);
                if constexpr (HELD)
                    if (j > 0)
                        load_quad(arow - stride, n, p.N, vec, &al[4 * q]);
            }
        };
        auto after = [&](int i, float pls, const float* be) {
            if constexpr (!POST) store_sources<V, G>(p, orow, be);
            if (threadIdx.x < 32) {
                if (lane == (i & 31)) pls_mine = pls;
                if ((i & 31) == 31 || i == R - 1) {
                    const int r = (i & ~31) + lane;
                    if (r <= i)
                        p.lsout[(size_t)(j0 - r) * p.B + b] =
                            POST ? lsf_cur + pls_mine : pls_mine;
                    lsf_cur = lsf_next;
                    lsf_next = lsf_of((i >> 5) + 2);
                }
            }
            if (zrow >= R) zero_row();
            --j;
            orow -= stride;
            if constexpr (POST) arow -= stride;
        };
        float be[V];
        bwd_chain<V, KMS, Shape<V, KMS, AHEAD>::ring, G>(
            p, j0, j0 == Db - 1, R, dyn, red, be, emit, after);
    }
    while (zrow >= R) zero_row();
}

enum Variant { WARP32 = 0, WARP64 = 1, BLOCK32 = 2, WIDE32 = 3 };

struct Config {
    Variant variant;
    int V, threads, slot_bytes, ring;
    size_t smem;    // dynamic shared bytes: the ring (and kmask)
};

// Variant, threads, ring and shared memory of a block at width N. Fails
// past 32 * WIDE_MAX_THREADS.
cudaError_t config_for(int N, Config* c) {
    if (N < 1 || N > 32 * WIDE_MAX_THREADS) return cudaErrorInvalidValue;
    const int T = 32 * ((N + 32 * 32 - 1) / (32 * 32));
    c->variant = N <= WARP32_MAX_N ? WARP32
               : N <= WARP64_MAX_N ? WARP64
               : T <= BLOCK_MAX_THREADS ? BLOCK32 : WIDE32;
    c->V = c->variant == WARP64 ? 64 : 32;
    c->threads = c->variant == WARP32 || c->variant == WARP64 ? 32 : T;
    // the runs start up to 15 bytes into a slot and a read ends at most 4
    // bytes past a run; a row's pieces span at most N + 30 bytes
    c->slot_bytes = c->V * c->threads + 32;
    c->ring = c->variant == WARP32 ? Shape<32, false, true>::ring
                                   : Shape<32, true, true>::ring;
    const size_t km = c->variant == WARP32 ? 0 : (size_t)c->V * c->threads * 4;
    c->smem = (size_t)c->ring * c->slot_bytes + km;
    return cudaSuccess;
}

template <int MODE>
const void* kernel_of(Variant v) {
    return v == WARP32 ? (const void*)paint_bwd_kernel<32, false, true, MODE>
         : v == WARP64 ? (const void*)paint_bwd_kernel<64, true, true, MODE>
         : v == BLOCK32 ? (const void*)paint_bwd_kernel<32, true, true, MODE>
                        : (const void*)paint_bwd_kernel<32, true, false, MODE>;
}

const void* kernel_for(int mode, Variant v) {
    return mode == MODE_POST ? kernel_of<MODE_POST>(v) : kernel_of<MODE_BETA>(v);
}

}  // namespace

// The launch configuration at width N in `mode` (0 posterior, 1 beta): info
// = threads a block, sources a thread, ring slots, slot bytes, dynamic
// shared bytes, blocks a SM, SMs, registers a thread, local (spilled) bytes
// a thread, alpha rows held ahead in registers (0 or 1).
extern "C" int paint_bwd_config(int N, int mode, int* info) {
    Config c;
    cudaError_t e = config_for(N, &c);
    if (e != cudaSuccess) return (int)e;
    e = launch_info(kernel_for(mode, c.variant), c.threads, c.V, c.ring,
                    c.slot_bytes, c.smem, info);
    info[9] = mode == MODE_POST && c.variant != WIDE32;
    return (int)e;
}

// One full backward sweep of B targets on `stream`, mode 0: posterior (alpha
// * beta, lsf + pls), mode 1: beta and pls. D (B) int32; beta_end, kmask
// (B, N) float32; mism (Dmax, B, N) int8; pfac, nxt (B, Dmax) float32;
// alphas (Dmax, B, N) and lsf (Dmax, B) float32 (read in mode 0 only);
// outputs out (Dmax, B, N) and lsout (Dmax, B) float32. Returns the CUDA
// error of the set-up or the launch.
extern "C" int paint_bwd_launch(const void* D, const void* beta_end,
                                const void* kmask, const void* mism,
                                const void* pfac, const void* nxt,
                                const void* alphas, const void* lsf, void* out,
                                void* lsout, int Dmax, int B, int N,
                                float theta, float ntheta, float theta_ratio,
                                int mode, void* stream) {
    Config c;
    cudaError_t e = config_for(N, &c);
    if (e != cudaSuccess) return (int)e;
    const void* k = kernel_for(mode, c.variant);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.smem);
    if (e != cudaSuccess) return (int)e;
    Params p = make_params(D, beta_end, kmask, mism, pfac, nxt, out, lsout,
                           Dmax, B, N, c.slot_bytes, theta, ntheta, theta_ratio);
    if (mode == MODE_POST) {
        p.alphas = (const float*)alphas;
        p.lsf = (const float*)lsf;
    }
    void* args[] = {&p};
    e = cudaLaunchKernel(k, dim3(B), dim3(c.threads), args, c.smem,
                         (cudaStream_t)stream);
    return (int)e;
}

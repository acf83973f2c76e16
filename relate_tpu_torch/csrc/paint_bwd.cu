// Backward Li & Stephens sweep for sm_90a: posterior and beta modes (the
// capture sweep is in paint_capture.cu).
//
// Replaces the TPU kernel relate_tpu/ops/paint_kernels.py:_bwd_kernel (with
// and without emit_beta). One thread block per target
// haplotype b walks the rows j = Dmax-1..0; its threads cover the N sources
// (contiguous: state is (B, N), streams are (Dmax, B, N)). The beta row and
// the previous row's mismatch bytes stay in shared memory, so each mismatch
// byte is read from device memory once.
//
// Bound: memory. Per cell the posterior mode reads 1 byte of mismatch and
// 4 bytes of alpha and writes 4 bytes; the beta mode reads 1 and writes 4.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOWER_RESCALE = 1e-10f;
constexpr float UPPER_RESCALE = 1e10f;
constexpr int MODE_POST = 0, MODE_BETA = 1;

__device__ __forceinline__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    return s;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
paint_bwd_kernel(const int* __restrict__ D, const float* __restrict__ beta_end,
                 const float* __restrict__ kmask,
                 const int8_t* __restrict__ mism,
                 const float* __restrict__ pfac, const float* __restrict__ nxt,
                 const float* __restrict__ alphas,
                 const float* __restrict__ lsf,
                 float* __restrict__ out, float* __restrict__ lsout,
                 int Dmax, int B, int N, float theta, float ntheta,
                 float theta_ratio) {
    extern __shared__ float smem[];
    float* beta = smem;                          // N
    float* km = smem + N;                        // N
    int8_t* mnext = (int8_t*)(smem + 2 * N);     // N bytes: mismatch of row j+1
    __shared__ float red[2][THREADS / 32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int Db = D[b];
    const size_t bn = (size_t)b * N;
    const size_t row_stride = (size_t)B * N;

    for (int n = tid; n < N; n += THREADS) km[n] = kmask[bn + n];

    // rows at and past D[b] carry nothing
    for (int j = Dmax - 1; j >= Db; --j) {
        float* orow = out + (size_t)j * row_stride + bn;
        for (int n = tid; n < N; n += THREADS) orow[n] = 0.f;
        if (tid == 0) lsout[(size_t)j * B + b] = 0.f;
    }

    float pls = 0.f, comp = 0.f, bsum_eff = 1.0f;
    for (int j = min(Db, Dmax) - 1; j >= 0; --j) {
        const bool is_init = (j == Db - 1);
        const int8_t* mrow = mism + (size_t)j * row_stride + bn;
        float lsf_j = 0.f;
        if (MODE == MODE_POST) lsf_j = lsf[(size_t)j * B + b];
        float rx = 0.f, inc = 0.f;
        if (!is_init) {
            rx = bsum_eff * pfac[(size_t)b * Dmax + j + 1];
            inc = nxt[(size_t)b * Dmax + j + 1];
        }
        const float b1 = rx / ntheta;
        const float bt = rx / theta - b1;
        float part = 0.f;
        for (int n = tid; n < N; n += THREADS) {
            const int8_t mj = mrow[n];
            float bnew;
            if (is_init) {
                bnew = beta_end[bn + n] * km[n];
            } else {
                const float dn = (float)mnext[n];
                const float em = 1.0f + theta_ratio * dn;
                bnew = (beta[n] + dn * bt + b1) * em * km[n];
            }
            const float w = mj > 0 ? theta : ntheta;
            part += w * bnew;
            if (MODE == MODE_POST)
                out[(size_t)j * row_stride + bn + n] =
                    alphas[(size_t)j * row_stride + bn + n] * bnew;
            beta[n] = bnew;
            mnext[n] = mj;
        }
        const float bsum = block_sum(part, red[j & 1]);
        const bool cond = !is_init &&
                          ((bsum < LOWER_RESCALE) || (bsum > UPPER_RESCALE));
        const float safe = bsum > 0.f ? bsum : 1.0f;
        float logcorr = 0.f;
        bsum_eff = bsum;
        if (cond) {
            for (int n = tid; n < N; n += THREADS) beta[n] = beta[n] / safe;
            logcorr = logf(safe);
            bsum_eff = 1.0f;
        }
        if (is_init) { pls = 0.f; comp = 0.f; }
        const float y = (inc + logcorr) - comp;
        const float t = pls + y;
        comp = (t - pls) - y;
        pls = t;

        if (MODE == MODE_POST) {
            if (tid == 0) lsout[(size_t)j * B + b] = lsf_j + pls;
        } else {
            float* orow = out + (size_t)j * row_stride + bn;
            for (int n = tid; n < N; n += THREADS) orow[n] = beta[n];
            if (tid == 0) lsout[(size_t)j * B + b] = pls;
        }
    }
}

template <int MODE>
int launch(const void* D, const void* beta_end, const void* kmask,
           const void* mism, const void* pfac, const void* nxt,
           const void* alphas, const void* lsf, void* out, void* lsout,
           int Dmax, int B, int N, float theta, float ntheta,
           float theta_ratio, cudaStream_t st) {
    const size_t shmem = (size_t)2 * N * sizeof(float) + (size_t)((N + 3) / 4) * 4;
    // above the 48 KB default (N > 5461) the block's dynamic shared memory
    // must be asked for; a refusal (N rows past 227 KB) is returned
    const cudaError_t e = cudaFuncSetAttribute(
        paint_bwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
    paint_bwd_kernel<MODE><<<B, THREADS, shmem, st>>>(
        (const int*)D, (const float*)beta_end, (const float*)kmask,
        (const int8_t*)mism, (const float*)pfac, (const float*)nxt,
        (const float*)alphas, (const float*)lsf, (float*)out, (float*)lsout,
        Dmax, B, N, theta, ntheta, theta_ratio);
    return (int)cudaGetLastError();
}

}  // namespace

// mode 0: posterior (alpha * beta, lsf + pls), mode 1: beta and pls.
extern "C" int paint_bwd_launch(const void* D, const void* beta_end,
                                const void* kmask, const void* mism,
                                const void* pfac, const void* nxt,
                                const void* alphas, const void* lsf, void* out,
                                void* lsout, int Dmax, int B, int N,
                                float theta, float ntheta, float theta_ratio,
                                int mode, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == MODE_POST)
        return launch<MODE_POST>(D, beta_end, kmask, mism, pfac, nxt, alphas,
                                 lsf, out, lsout, Dmax, B, N, theta, ntheta,
                                 theta_ratio, st);
    return launch<MODE_BETA>(D, beta_end, kmask, mism, pfac, nxt, alphas, lsf,
                             out, lsout, Dmax, B, N, theta, ntheta,
                             theta_ratio, st);
}

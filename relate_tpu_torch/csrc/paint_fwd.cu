// Forward Li & Stephens sweep for sm_90a, full output (the capture sweep is
// in paint_capture.cu).
//
// Replaces the TPU kernel relate_tpu/ops/paint_kernels.py:_fwd_kernel. One
// thread block per target haplotype b: the targets
// are independent chains, so nothing is shared between blocks. The block
// walks the derived-site rows j = 0..Dmax-1 in order; its threads cover the
// N copying sources (contiguous in memory: state is (B, N), streams are
// (Dmax, B, N)). The alpha row lives in shared memory for the whole sweep
// and every row needs one block-wide sum.
//
// Bound: memory. Per cell it reads 1 byte of mismatch and writes 4 bytes of
// alpha.
//
// Recurrence (float32, rescale into [1e-10, 1e10], Kahan-compensated
// logscale), identical to the plain version in ops/paint_kernels.py:
//   row 0:        alpha = alpha0 * kmask, ls = 0
//   0 < j < D[b]: alpha = (alpha + asum * pfac[b, j-1]) * (1 + tr * mism)
//                         * kmask, then the rescale; ls += nxt[b, j-1] + log
//   j >= D[b]:    the row is held.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOWER_RESCALE = 1e-10f;
constexpr float UPPER_RESCALE = 1e10f;

// Sum over the block; every thread gets the same value. `red` holds one
// float per warp and is double-buffered by the caller (row parity), so one
// __syncthreads per sum is enough.
__device__ __forceinline__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    return s;
}

__global__ void __launch_bounds__(THREADS)
paint_fwd_kernel(const int* __restrict__ D, const float* __restrict__ alpha0,
                 const float* __restrict__ kmask,
                 const int8_t* __restrict__ mism,
                 const float* __restrict__ pfac, const float* __restrict__ nxt,
                 float* __restrict__ alphas, float* __restrict__ lss,
                 int Dmax, int B, int N, float theta_ratio) {
    extern __shared__ float smem[];
    float* alpha = smem;            // N
    float* km = smem + N;           // N
    __shared__ float red[2][THREADS / 32];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int Db = D[b];
    const size_t bn = (size_t)b * N;
    const size_t row_stride = (size_t)B * N;

    float part = 0.f;
    for (int n = tid; n < N; n += THREADS) {
        const float k = kmask[bn + n];
        const float a = alpha0[bn + n] * k;
        km[n] = k;
        alpha[n] = a;
        part += a;
    }
    float asum_eff = block_sum(part, red[0]);   // row 0's parity
    float ls = 0.f, comp = 0.f;

    for (int n = tid; n < N; n += THREADS) alphas[bn + n] = alpha[n];
    if (tid == 0) lss[b] = 0.f;

    for (int j = 1; j < Dmax; ++j) {
        if (j < Db) {
            const float rx = asum_eff * pfac[(size_t)b * Dmax + j - 1];
            const float nx = nxt[(size_t)b * Dmax + j - 1];
            const int8_t* mrow = mism + (size_t)j * row_stride + bn;
            part = 0.f;
            for (int n = tid; n < N; n += THREADS) {
                const float em = 1.0f + theta_ratio * (float)mrow[n];
                const float a = (alpha[n] + rx) * em * km[n];
                alpha[n] = a;
                part += a;
            }
            const float asum = block_sum(part, red[j & 1]);
            const bool cond = (asum < LOWER_RESCALE) || (asum > UPPER_RESCALE);
            const float safe = asum > 0.f ? asum : 1.0f;
            float logcorr = 0.f;
            asum_eff = asum;
            if (cond) {
                for (int n = tid; n < N; n += THREADS) alpha[n] = alpha[n] / safe;
                logcorr = logf(safe);
                asum_eff = 1.0f;
            }
            const float y = (nx + logcorr) - comp;
            const float t = ls + y;
            comp = (t - ls) - y;
            ls = t;
        }
        float* orow = alphas + (size_t)j * row_stride + bn;
        for (int n = tid; n < N; n += THREADS) orow[n] = alpha[n];
        if (tid == 0) lss[(size_t)j * B + b] = ls;
    }
}

}  // namespace

extern "C" int paint_fwd_launch(const void* D, const void* alpha0,
                                const void* kmask, const void* mism,
                                const void* pfac, const void* nxt,
                                void* alphas, void* lss, int Dmax, int B,
                                int N, float theta_ratio, void* stream) {
    const size_t shmem = (size_t)2 * N * sizeof(float);
    cudaStream_t st = (cudaStream_t)stream;
    // above the 48 KB default (N > 6144) the block's dynamic shared memory
    // must be asked for; a refusal (N rows past 227 KB) is returned
    const cudaError_t e = cudaFuncSetAttribute(
        paint_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
    paint_fwd_kernel<<<B, THREADS, shmem, st>>>(
        (const int*)D, (const float*)alpha0, (const float*)kmask,
        (const int8_t*)mism, (const float*)pfac, (const float*)nxt,
        (float*)alphas, (float*)lss, Dmax, B, N, theta_ratio);
    return (int)cudaGetLastError();
}

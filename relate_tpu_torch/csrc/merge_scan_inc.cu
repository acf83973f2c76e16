// Incremental MinMatch merge scan for sm_90a (2 <= N <= 16384).
//
// merge_scan_inc_launch replaces the TPU kernel of
// relate_tpu/ops/merge_scan_inc.py (_make_kernel -> kernel via _run_inc). The
// semantics are those of that file's NumPy twin merge_scan_inc_host: per-row
// caches (the row minima rm and rmcf, one merge candidate a row: score, tie
// key, partner), a step picks the live row with the least (score, tie, row),
// merges it with its partner, and rescans ("repairs") only the rows whose
// cached minimum or cached partner the merge touched, in ascending row order.
// If no row has a candidate the step falls back to the global symmetric
// argmin over the live pairs.
//
// What is NOT carried over from the TPU kernel: its 8-row DMA groups, the
// pending column cache with slot ages and row versions, the flush through the
// matrix unit, the padding to a multiple of 128. On this card a merged column
// is a strided store. d is not symmetric, so its transpose dt is kept beside
// it (and dcft beside dcf): every read of a step is then contiguous, and a
// merge writes row j of each of the four matrices contiguously and column j
// of each with stride N.
//
// Launch scheme. One C call enqueues everything on the caller's stream; the
// chosen pair never leaves the card and the host never waits inside the scan.
//   set-up  init_state; init_min (one block a row: rm, rmcf); init_cand (one
//           block a row: the row's candidate); select (one block)
//   a step  fallback_kernel  grid-wide; returns at once unless the last
//                            select found no candidate, else every block
//                            reduces its rows of d + dt to one record
//           step_kernel      ONE block: takes the pair (from select, or by
//                            reducing the fallback records), reads rows i and
//                            j of the four matrices, blends, maintains rm,
//                            builds the dirty set, writes the merged row and
//                            column, runs the repairs one after the other,
//                            and selects the next pair
// Repairs are a serial chain by definition (a rescan reads rm entries that an
// earlier repair of the same step refreshed, and folds into the candidates a
// later one reads), so one block loses no parallelism there; what it costs is
// one SM's latency, and its 4 N strided column stores a step.
//
// Bound: the latency of the chain of 2 (N - 1) dependent launches and of the
// block-wide passes inside step_kernel, not bytes: a step moves 8 rows in,
// 4 rows and 4 strided columns out and 4 rows a repair (well under 1 MB at
// N = 4096), against set-up passes that read the four matrices once.
//
// The merge reads everything before it writes anything: the new column is
// blended from the OLD columns (the dense scans of merge_scan.cu blend it from
// the updated row; the two files share no merge code for that reason). After
// both writes d[j][j] holds the column's value.
//
// The merge list is discrete: one rounding in w*x + (1-w)*y can flip a merge
// and every later step. This file is built with -fmad=false so that the blend
// rounds as two products and a sum, like the plain PyTorch version and the
// NumPy twin; w = s_i / (s_i + s_j) is an IEEE float32 division. All
// reductions are minima, so their order does not matter. The tie hash is per
// PAIR (no step term), 32-bit wrap-around arithmetic with logical shifts
// (uint32_t). INF is the finite 3.0e38, and "has a candidate" is score < INF.
// Element offsets a * N + b reach 2.7e8 at N = 16384 and stay inside int;
// pointer arithmetic is done in size_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 3.0e38f;
constexpr int ROW_THREADS = 256;
constexpr int STEP_THREADS = 1024;
constexpr int FB_BLOCKS = 528;     // fallback grid: 4 blocks an SM
constexpr int F_ROWS = 9;          // (N,) float vectors of the scan state
constexpr int I_ROWS = 5;          // (N,) int vectors of the scan state
constexpr int SEL_INTS = 8;        // the scalars of State::sel
constexpr unsigned FULL = 0xffffffffu;
// Lanes a thread handles at once. Every pass below first starts the loads of
// U lanes together and only then branches on them: a pass is then one round
// trip to memory, not one for every test of every lane.
constexpr int U = 4;

struct Cand {
    float score;
    float tie;
    int idx;       // a lane, or a flat index a * N + b in the fallback
};

__device__ __forceinline__ Cand worst() { return Cand{INF, INF, 0x7fffffff}; }

// Scan state: the four working matrices and (N,) vectors in device memory.
struct State {
    float *d, *dt, *dcf, *dcft;
    float *rm, *rmcf;              // cached row minima of d and dcf
    float *cand_s, *cand_t;        // cached candidate: score, tie key
    float *sizes;                  // cluster sizes
    float *nrow, *ncol, *nrow_cf, *ncol_cf;   // the blended row and column
    int *cand_p;                   // cached candidate: partner, -1 if none
    int *active, *conv;            // live rows; node id of each row
    int *flags;                    // bit 0 dirty, bit 1 hit
    int *dlist;                    // the dirty rows in ascending order
    int *sel;     // [0] a, [1] b, [2] no row has a candidate,
                  // [4] repairs so far, [5] fallback steps so far,
                  // [6], [7] low and high word of the live entries of d
                  // that the fallback steps so far had to look at
    Cand* fb;                      // FB_BLOCKS fallback records
    int *cis, *cjs;
    int N, use_cf;
    float thr, thrcf;
    uint32_t mix;                  // seed * 747796405
};

__device__ __forceinline__ bool better(const Cand& x, const Cand& y) {
    if (x.score != y.score) return x.score < y.score;
    if (x.tie != y.tie) return x.tie < y.tie;
    return x.idx < y.idx;
}

__device__ __forceinline__ Cand warp_best(Cand c) {
    for (int o = 16; o > 0; o >>= 1) {
        Cand r;
        r.score = __shfl_xor_sync(FULL, c.score, o);
        r.tie = __shfl_xor_sync(FULL, c.tie, o);
        r.idx = __shfl_xor_sync(FULL, c.idx, o);
        if (better(r, c)) c = r;
    }
    return c;
}

// Best candidate of the block, returned to every thread. `buf`: one slot a
// warp. Called by all threads of the block.
__device__ __forceinline__ Cand block_best(Cand c, Cand* buf) {
    c = warp_best(c);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();               // buf may still be read from the last call
    if (lane == 0) buf[warp] = c;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    return warp_best(lane < nw ? buf[lane] : worst());
}

// Minimum over the block, returned to every thread.
__device__ __forceinline__ float block_min(float v, float* buf) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) buf[warp] = v;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? buf[lane] : INF;
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// Static tie key of the pair (a, b), a float in [0, 2^23).
__device__ __forceinline__ float tie_hash(int a, int b, uint32_t mix) {
    const uint32_t lo = (uint32_t)min(a, b), hi = (uint32_t)max(a, b);
    uint32_t h = lo * 2654435769u + hi * 2246822507u;
    h ^= mix;
    h ^= h >> 15;
    h *= 739213477u;
    h ^= h >> 12;
    return (float)(h & 0x7FFFFFu);
}

// Minimum of row w of `mat` over the live partners, to every thread.
__device__ __forceinline__ float row_min(const State& s, const float* mat,
                                         int w, float* buf) {
    const float* row = mat + (size_t)w * s.N;
    const int N = s.N, B = blockDim.x;
    float m = INF;
    for (int c0 = threadIdx.x; c0 < N; c0 += U * B) {
        int act[U];
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * B;
            act[u] = c < N ? s.active[c] : 0;
            v[u] = c < N ? row[c] : INF;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (act[u] && c0 + u * B != w) m = fminf(m, v[u]);
    }
    return block_min(m, buf);
}

// Full pass of the block over row w: rebuilds the row's candidate; with FOLD
// every other live row c takes w as its candidate where (eff, tie) improves
// on its cached one. As in the twin a row without a candidate (score INF)
// still takes the tie key and the partner of a smaller tie. Ends with a
// barrier: the caches are coherent for the next pass.
template <bool FOLD>
__device__ __forceinline__ void rescan(const State& s, int w, Cand* buf) {
    const int N = s.N;
    const size_t rw = (size_t)w * N;
    const float lim = s.rm[w] + s.thr, lim_cf = s.rmcf[w] + s.thrcf;
    const int B = blockDim.x;
    Cand best = worst();
    for (int c0 = threadIdx.x; c0 < N; c0 += U * B) {
        int act[U];
        float dwc[U], dcw[U], rmc[U], fwc[U] = {}, fcw[U] = {}, rmf[U] = {},
            cs[U] = {}, ct[U] = {};
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * B;
            const bool in = c < N;
            act[u] = in ? s.active[c] : 0;
            dwc[u] = in ? s.d[rw + c] : 0.0f;
            dcw[u] = in ? s.dt[rw + c] : 0.0f;
            rmc[u] = in ? s.rm[c] : 0.0f;
            if (s.use_cf) {
                fwc[u] = in ? s.dcf[rw + c] : 0.0f;
                fcw[u] = in ? s.dcft[rw + c] : 0.0f;
                rmf[u] = in ? s.rmcf[c] : 0.0f;
            }
            if (FOLD) {
                cs[u] = in ? s.cand_s[c] : 0.0f;
                ct[u] = in ? s.cand_t[c] : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * B;
            if (!act[u] || c == w) continue;
            float eff = INF;
            if (dwc[u] <= lim && dcw[u] <= rmc[u] + s.thr) {
                eff = dwc[u] + dcw[u];
                if (s.use_cf && fwc[u] <= lim_cf && fcw[u] <= rmf[u] + s.thrcf)
                    eff = 0.0f;
            }
            const float tie = tie_hash(w, c, s.mix);
            const Cand x{eff, tie, c};
            if (eff < INF && better(x, best)) best = x;
            if (FOLD && (eff < cs[u] || (eff == cs[u] && tie < ct[u]))) {
                s.cand_s[c] = eff;
                s.cand_t[c] = tie;
                s.cand_p[c] = w;
            }
        }
    }
    best = block_best(best, buf);
    if (threadIdx.x == 0) {
        const bool have = best.score < INF;
        s.cand_s[w] = have ? best.score : INF;
        s.cand_t[w] = have ? best.tie : INF;
        s.cand_p[w] = have ? best.idx : -1;
    }
    __syncthreads();
}

// The live row with the least (score, tie, row) and its partner into sel, or
// the flag "no row has a candidate".
__device__ __forceinline__ void select(const State& s, Cand* buf) {
    const int N = s.N, B = blockDim.x;
    Cand best = worst();
    for (int c0 = threadIdx.x; c0 < N; c0 += U * B) {
        int act[U];
        float cs[U], ct[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * B;
            act[u] = c < N ? s.active[c] : 0;
            cs[u] = c < N ? s.cand_s[c] : INF;
            ct[u] = c < N ? s.cand_t[c] : INF;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const Cand x{cs[u], ct[u], c0 + u * B};
            if (act[u] && x.score < INF && better(x, best)) best = x;
        }
    }
    best = block_best(best, buf);
    if (threadIdx.x == 0) {
        const bool have = best.score < INF;
        s.sel[0] = have ? best.idx : 0;
        s.sel[1] = have ? s.cand_p[best.idx] : 0;
        s.sel[2] = have ? 0 : 1;
    }
}

__global__ void init_state_kernel(State s) {
    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    if (a < s.N) {
        s.active[a] = 1;
        s.sizes[a] = 1.0f;
        s.conv[a] = a;
    }
    if (a < SEL_INTS) s.sel[a] = 0;
}

__global__ void __launch_bounds__(ROW_THREADS) init_min_kernel(State s) {
    __shared__ float buf[ROW_THREADS / 32];
    const int a = blockIdx.x;
    const float m = row_min(s, s.d, a, buf);
    const float mc = row_min(s, s.dcf, a, buf);
    if (threadIdx.x == 0) {
        s.rm[a] = m;
        s.rmcf[a] = mc;
    }
}

__global__ void __launch_bounds__(ROW_THREADS) init_cand_kernel(State s) {
    __shared__ Cand buf[ROW_THREADS / 32];
    rescan<false>(s, blockIdx.x, buf);
}

__global__ void __launch_bounds__(STEP_THREADS) select_kernel(State s) {
    __shared__ Cand buf[STEP_THREADS / 32];
    select(s, buf);
}

// Stage one of the fallback: block k reduces rows k, k + FB_BLOCKS, ... of
// d + dt over the live pairs to one record (score, tie key, flat index).
__global__ void __launch_bounds__(ROW_THREADS) fallback_kernel(State s) {
    if (!s.sel[2]) return;
    __shared__ Cand buf[ROW_THREADS / 32];
    const int N = s.N;
    Cand best = worst();
    for (int a = blockIdx.x; a < N; a += gridDim.x) {
        if (!s.active[a]) continue;
        const size_t ra = (size_t)a * N;
        for (int b = threadIdx.x; b < N; b += ROW_THREADS) {
            if (b == a || !s.active[b]) continue;
            const Cand x{s.d[ra + b] + s.dt[ra + b], tie_hash(a, b, s.mix),
                         a * N + b};
            if (better(x, best)) best = x;
        }
    }
    best = block_best(best, buf);
    if (threadIdx.x == 0) s.fb[blockIdx.x] = best;
}

__global__ void __launch_bounds__(STEP_THREADS) step_kernel(State s, int t) {
    __shared__ Cand cbuf[STEP_THREADS / 32];
    __shared__ float fbuf[STEP_THREADS / 32];
    __shared__ int wcount[STEP_THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = s.N;

    // the pair of this step
    const int fell_back = s.sel[2];
    int a, b;
    if (fell_back) {
        Cand best = worst();
        for (int k = tid; k < FB_BLOCKS; k += STEP_THREADS) {
            const Cand x = s.fb[k];
            if (better(x, best)) best = x;
        }
        best = block_best(best, cbuf);
        a = best.idx / N;
        b = best.idx % N;
    } else {
        a = s.sel[0];
        b = s.sel[1];
    }
    const int i = min(a, b), j = max(a, b);
    const size_t ri = (size_t)i * N, rj = (size_t)j * N;
    const float si = s.sizes[i], sj = s.sizes[j];
    const float w = si / (si + sj), w1 = 1.0f - w;

    // read rows i and j of the four matrices, blend, maintain rm, mark the
    // dirty rows; nothing of the matrices is written yet
    for (int c0 = tid; c0 < N; c0 += U * STEP_THREADS) {
        float ri_d[U], rj_d[U], ci[U], cj[U], ri_f[U], rj_f[U], ci_f[U],
            cj_f[U], rmc[U];
        int act[U], p[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * STEP_THREADS;
            const bool in = c < N;
            ri_d[u] = in ? s.d[ri + c] : 0.0f;
            rj_d[u] = in ? s.d[rj + c] : 0.0f;
            ci[u] = in ? s.dt[ri + c] : 0.0f;
            cj[u] = in ? s.dt[rj + c] : 0.0f;
            ri_f[u] = in ? s.dcf[ri + c] : 0.0f;
            rj_f[u] = in ? s.dcf[rj + c] : 0.0f;
            ci_f[u] = in ? s.dcft[ri + c] : 0.0f;
            cj_f[u] = in ? s.dcft[rj + c] : 0.0f;
            rmc[u] = in ? s.rm[c] : 0.0f;
            act[u] = in ? s.active[c] : 0;
            p[u] = in ? s.cand_p[c] : -1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + u * STEP_THREADS;
            if (c >= N) continue;
            const float nc = w * ci[u] + w1 * cj[u];
            s.nrow[c] = w * ri_d[u] + w1 * rj_d[u];
            s.ncol[c] = nc;
            s.nrow_cf[c] = w * ri_f[u] + w1 * rj_f[u];
            s.ncol_cf[c] = w * ci_f[u] + w1 * cj_f[u];
            const bool other = act[u] && c != i && c != j;
            // the row's cached minimum sat in column i or j: it needs a
            // rescan; any other row's minimum still stands (the new entry
            // is no smaller)
            const bool hit = other && (ci[u] == rmc[u] || cj[u] == rmc[u]);
            if (other && !hit) s.rm[c] = fminf(rmc[u], nc);
            bool dirty = (act[u] && (p[u] == i || p[u] == j)) || hit;
            if (c == j) dirty = true;
            if (c == i) dirty = false;
            s.flags[c] = (dirty ? 1 : 0) | (hit ? 2 : 0);
        }
    }
    __syncthreads();

    // the merged row j and column j; on the diagonal the column's value
    for (int c = tid; c < N; c += STEP_THREADS) {
        const size_t rc = (size_t)c * N;
        const float nr = s.nrow[c], nc = s.ncol[c];
        const float nrf = s.nrow_cf[c], ncf = s.ncol_cf[c];
        s.d[rj + c] = c == j ? nc : nr;
        s.dt[rj + c] = nc;
        s.dcf[rj + c] = c == j ? ncf : nrf;
        s.dcft[rj + c] = ncf;
        s.d[rc + j] = nc;
        s.dt[rc + j] = c == j ? nc : nr;
        s.dcf[rc + j] = ncf;
        s.dcft[rc + j] = c == j ? ncf : nrf;
    }
    if (tid == 0) {
        s.cis[t] = s.conv[i];
        s.cjs[t] = s.conv[j];
        s.active[i] = 0;
        s.cand_s[i] = INF;
        s.sizes[j] = si + sj;
        s.conv[j] = N + t;
    }
    __syncthreads();

    // the dirty rows in ascending order (ordered compaction of the flags)
    const int nw = STEP_THREADS / 32;
    int total = 0;
    for (int base = 0; base < N; base += STEP_THREADS) {
        const int c = base + tid;
        const bool f = c < N && (s.flags[c] & 1);
        const unsigned bal = __ballot_sync(FULL, f);
        if (lane == 0) wcount[warp] = __popc(bal);
        __syncthreads();
        int before = 0, round = 0;
        for (int k = 0; k < nw; ++k) {
            const int v = wcount[k];
            if (k < warp) before += v;
            round += v;
        }
        if (f) s.dlist[total + before + __popc(bal & ((1u << lane) - 1u))] = c;
        total += round;
        __syncthreads();
    }

    // the repairs, one after the other: rm is refreshed for hit rows and j,
    // rmcf for row j only (the other rows keep their stale clade-prior minima)
    for (int k = 0; k < total; ++k) {
        const int r = s.dlist[k];
        if ((s.flags[r] & 2) || r == j) {
            const float m = row_min(s, s.d, r, fbuf);
            if (tid == 0) s.rm[r] = m;
        }
        if (r == j) {
            const float m = row_min(s, s.dcf, r, fbuf);
            if (tid == 0) s.rmcf[r] = m;
        }
        __syncthreads();
        rescan<true>(s, r, cbuf);
    }
    if (tid == 0) {
        s.sel[4] += total;
        s.sel[5] += fell_back;
        if (fell_back) {
            // N - t rows were live when this step fell back
            const uint64_t live = (uint64_t)(N - t);
            const uint64_t sum = ((uint64_t)(uint32_t)s.sel[7] << 32 |
                                  (uint32_t)s.sel[6]) + live * live;
            s.sel[6] = (int)(uint32_t)sum;
            s.sel[7] = (int)(uint32_t)(sum >> 32);
        }
    }
    select(s, cbuf);
}

}  // namespace

// Sizes of the scratch that merge_scan_inc_launch needs at this N: floats of
// fstate, ints of istate, and where in istate the four counters start
// (repairs, fallback steps, then the low and high 32 bits of the number of
// live entries of d that the fallback steps had to look at).
extern "C" void merge_scan_inc_scratch(int N, long long* n_float,
                                       long long* n_int,
                                       long long* counters_at) {
    const long long sel = (long long)I_ROWS * N;
    *n_float = (long long)F_ROWS * N;
    *n_int = sel + SEL_INTS
        + (long long)(FB_BLOCKS * sizeof(Cand) / sizeof(int));
    *counters_at = sel + 4;
}

// d, dt, dcf, dcft: (N, N) float32 working copies, updated in place.
// fstate, istate: uninitialised scratch of the sizes merge_scan_inc_scratch
// gives. Outputs cis, cjs (N-1) int32; afterwards istate holds the counters
// at the place merge_scan_inc_scratch names.
extern "C" int merge_scan_inc_launch(void* d, void* dt, void* dcf, void* dcft,
                                     void* fstate, void* istate, void* cis,
                                     void* cjs, int N, int use_cf,
                                     float threshold, float threshold_cf,
                                     int seed, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    float* f = (float*)fstate;
    int* q = (int*)istate;
    State s;
    s.d = (float*)d;
    s.dt = (float*)dt;
    s.dcf = (float*)dcf;
    s.dcft = (float*)dcft;
    s.rm = f;
    s.rmcf = f + (size_t)N;
    s.cand_s = f + (size_t)2 * N;
    s.cand_t = f + (size_t)3 * N;
    s.sizes = f + (size_t)4 * N;
    s.nrow = f + (size_t)5 * N;
    s.ncol = f + (size_t)6 * N;
    s.nrow_cf = f + (size_t)7 * N;
    s.ncol_cf = f + (size_t)8 * N;
    s.cand_p = q;
    s.active = q + (size_t)N;
    s.conv = q + (size_t)2 * N;
    s.flags = q + (size_t)3 * N;
    s.dlist = q + (size_t)4 * N;
    s.sel = q + (size_t)I_ROWS * N;
    s.fb = (Cand*)(s.sel + SEL_INTS);
    s.cis = (int*)cis;
    s.cjs = (int*)cjs;
    s.N = N;
    s.use_cf = use_cf;
    s.thr = threshold;
    s.thrcf = threshold_cf;
    s.mix = (uint32_t)seed * 747796405u;

    init_state_kernel<<<(N + 255) / 256, 256, 0, st>>>(s);
    init_min_kernel<<<N, ROW_THREADS, 0, st>>>(s);
    init_cand_kernel<<<N, ROW_THREADS, 0, st>>>(s);
    select_kernel<<<1, STEP_THREADS, 0, st>>>(s);
    for (int t = 0; t < N - 1; ++t) {
        fallback_kernel<<<FB_BLOCKS, ROW_THREADS, 0, st>>>(s);
        step_kernel<<<1, STEP_THREADS, 0, st>>>(s, t);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

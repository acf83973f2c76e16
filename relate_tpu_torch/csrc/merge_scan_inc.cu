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
//           cluster_step_kernel
//                            ONE CLUSTER of 8 blocks (CL_THREADS each). Block
//                            r owns the lanes (columns) [r C, r C + C),
//                            C = ceil(N / 8) rounded up to 4, and holds the
//                            (N,) state of its lanes in shared memory for the
//                            launch. It takes the pair, blends rows i and j
//                            over its lanes, maintains rm, flags its dirty
//                            lanes, writes its lanes of row j and column j,
//                            runs the repairs one after the other and
//                            selects the next pair; every reduction is a
//                            partial over its lanes, combined through
//                            distributed shared memory.
// Repairs are a serial chain by definition (a rescan folds into candidates
// that a later rescan reads), and stay one after the other in ascending row
// order. Two facts take the round trips to device memory out of the chain:
//   - repairs never write the matrices and the dirty list is known before
//     the first one, so the rows a repair reads (its lanes of d[w], dt[w]
//     and, with the prior on, dcf[w], dcft[w]) are fetched STAGES - 1
//     repairs ahead into a ring in shared memory (cp.async.cg);
//   - the limits of a rescan are known before the first repair too: a
//     refreshed rm[w] (hit rows and j) is the minimum of row w over the live
//     lanes, and neither changes during the repairs; any other row's rm[w]
//     and rmcf[w] is changed by no repair but its own. So the limits of up
//     to BATCH repairs are reduced over the cluster in one exchange, and the
//     owner of row w stores the refreshed value just before w's rescan.
// A repair is then one pass of each block over its lanes, from shared
// memory, and one exchange of the blocks' best candidates: a push of each
// block's record into every block's slot, then one cluster barrier
// (barrier.cluster arrive.release / wait.acquire). The slots alternate by
// parity, so one barrier serves one exchange. All minima are lexicographic
// (score, tie, lane) or plain fminf, so the combined result is the one-block
// result bit for bit.
//
// Coherence. L1 is not coherent across SMs, and inside one launch a block
// reads matrix entries that another block wrote (d[w][j] is stored by the
// owner of lane w and read by the owner of lane j). So every read of d, dt,
// dcf or dcft in cluster_step_kernel goes through L2 (__ldcg, cp.async.cg);
// the merge writes no entry that another block reads during the merge (it
// writes live lanes only, and row i is dead); and a cluster barrier
// (release / acquire) separates the merge's writes from the first repair's
// reads. A block leaves only after the last exchange, so no block reads or
// writes the shared memory of a block that has ended.
//
// Bound: the latency of the chain of 2 (N - 1) dependent launches and, inside
// cluster_step_kernel, of one cluster exchange a repair plus a few a step; not
// bytes: a step moves 8 rows in, 4 rows and 4 strided columns out and 4 rows a
// repair (well under 1 MB at N = 4096), against set-up passes that read the
// four matrices once.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float INF = 3.0e38f;
constexpr int ROW_THREADS = 256;
constexpr int SELECT_THREADS = 1024;
constexpr int FB_BLOCKS = 528;     // fallback grid: 4 blocks an SM
constexpr int CLUSTER = 8;         // blocks of the step's cluster (portable)
constexpr int CL_THREADS = 512;    // threads of each of its blocks
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int STAGES = 4;          // ring of rows fetched ahead (>= 2)
constexpr int BATCH = 64;          // repairs whose limits share one exchange
constexpr int STATE_VECS = 8;      // (C,) vectors a block keeps in shared
constexpr int F_ROWS = 5;          // (N,) float vectors of the scan state
constexpr int I_ROWS = 3;          // (N,) int vectors of the scan state
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
    int *cand_p;                   // cached candidate: partner, -1 if none
    int *active, *conv;            // live rows; node id of each row
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

// Full pass of the block over row w (set-up): builds the row's candidate.
__device__ __forceinline__ void scan_row(const State& s, int w, Cand* buf) {
    const int N = s.N;
    const size_t rw = (size_t)w * N;
    const float lim = s.rm[w] + s.thr, lim_cf = s.rmcf[w] + s.thrcf;
    const int B = blockDim.x;
    Cand best = worst();
    for (int c0 = threadIdx.x; c0 < N; c0 += U * B) {
        int act[U];
        float dwc[U], dcw[U], rmc[U], fwc[U] = {}, fcw[U] = {}, rmf[U] = {};
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
        }
    }
    best = block_best(best, buf);
    if (threadIdx.x == 0) {
        const bool have = best.score < INF;
        s.cand_s[w] = have ? best.score : INF;
        s.cand_t[w] = have ? best.tie : INF;
        s.cand_p[w] = have ? best.idx : -1;
    }
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
    scan_row(s, blockIdx.x, buf);
}

__global__ void __launch_bounds__(SELECT_THREADS) select_kernel(State s) {
    __shared__ Cand buf[SELECT_THREADS / 32];
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

// Lanes a block of the step's cluster owns: ceil(N / CLUSTER) rounded up to
// a multiple of 4, so that a block's first lane starts a 16-byte piece of
// every row that does.
__host__ __device__ __forceinline__ int chunk_of(int N) {
    return ((N + CLUSTER - 1) / CLUSTER + 3) & ~3;
}

// Floats of one slice of a ring stage: a block's lanes of one row, copied as
// whole 16-byte pieces from the piece that holds the first lane.
__host__ __device__ __forceinline__ int slice_of(int N) {
    return chunk_of(N) + 8;
}

// Dynamic shared memory of a step block: the ring of STAGES stages of four
// slices, then STATE_VECS vectors of its lanes.
__host__ __device__ __forceinline__ size_t step_smem_bytes(int N) {
    return ((size_t)STAGES * 4 * slice_of(N)
            + (size_t)STATE_VECS * chunk_of(N)) * sizeof(float);
}

// A block's best candidate as it is exchanged in the cluster; `partner` is
// the candidate's cached partner, for the select.
struct Rec {
    float score;
    float tie;
    int idx;
    int partner;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Start copying the block's lanes [lo, hi) of row w of d, dt (and dcf, dcft
// with the prior on) into `stage` through L2. Slice m starts with the
// 16-byte piece that holds d[w][lo]; lane c is then at (w N + lo) % 4 +
// c - lo. The last piece of the last row stops at the end of the matrix.
__device__ __forceinline__ void fetch_row(const State& s, float* stage, int w,
                                          int lo, int hi, int SL) {
    if (lo >= hi) return;
    const size_t e0 = (size_t)w * s.N + lo, a0 = e0 & ~(size_t)3;
    const int pieces = (int)(((size_t)w * s.N + hi - a0 + 3) >> 2);
    const size_t end = (size_t)s.N * s.N;
    for (int p = threadIdx.x; p < pieces; p += CL_THREADS) {
        const size_t at = a0 + 4 * (size_t)p;
        const int bytes = end - at >= 4 ? 16 : (int)(end - at) * 4;
        cp_async16(stage + 4 * p, s.d + at, bytes);
        cp_async16(stage + SL + 4 * p, s.dt + at, bytes);
        if (s.use_cf) {
            cp_async16(stage + 2 * SL + 4 * p, s.dcf + at, bytes);
            cp_async16(stage + 3 * SL + 4 * p, s.dcft + at, bytes);
        }
    }
}

// Order-preserving 32-bit keys of a candidate's fields, for the warp's
// integer minimum (redux.sync): a score's key orders as the float does (-0
// is taken as +0, which compares equal to it); a tie key is an integer in
// [0, 2^23) or INF.
__device__ __forceinline__ unsigned score_key(float f) {
    const unsigned u = __float_as_uint(f + 0.0f);
    return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
    return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

// The same as warp_best, in three integer minima of the warp.
__device__ __forceinline__ Cand warp_best_redux(Cand c) {
    const unsigned ks = score_key(c.score);
    const unsigned ms = __reduce_min_sync(FULL, ks);
    const unsigned kt = ks != ms ? 0xffffffffu
                        : c.tie < INF ? (unsigned)c.tie : 0xfffffffeu;
    const unsigned mt = __reduce_min_sync(FULL, kt);
    const unsigned ki = ks == ms && kt == mt ? (unsigned)c.idx : 0xffffffffu;
    const unsigned mi = __reduce_min_sync(FULL, ki);
    return Cand{key_score(ms), mt == 0xfffffffeu ? INF : (float)mt, (int)mi};
}

// Best candidate of the block, to warp 0 (the other warps get worst()).
// `buf`: one slot a warp; the caller orders the slots' reuse.
__device__ __forceinline__ Cand block_best_w0(Cand c, Cand* buf) {
    c = warp_best_redux(c);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) buf[warp] = c;
    __syncthreads();
    if (warp != 0) return worst();
    return warp_best_redux(lane < CL_WARPS ? buf[lane] : worst());
}

// Push warp 0's record into slot `rank` of `slots` in every block of the
// cluster (lane r writes block r's).
__device__ __forceinline__ void push_rec(cg::cluster_group& cluster,
                                         Rec* slots, int rank, Rec x) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 && lane < CLUSTER)
        cluster.map_shared_rank(slots, lane)[rank] = x;
}

// Least record over the CLUSTER slots, to every thread.
__device__ __forceinline__ Rec best_of(const Rec* slots) {
    Rec b = slots[0];
    for (int r = 1; r < CLUSTER; ++r) {
        const Rec x = slots[r];
        if (better(Cand{x.score, x.tie, x.idx}, Cand{b.score, b.tie, b.idx}))
            b = x;
    }
    return b;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(CL_THREADS)
cluster_step_kernel(State s, int t) {
    extern __shared__ __align__(16) float smem[];
    __shared__ Cand wbuf[CL_WARPS];
    __shared__ Rec xc[2][CLUSTER];           // best-candidate slots, by parity
    __shared__ float xlim[2][CLUSTER][BATCH];  // limits' partials: rm, rmcf
    __shared__ int xcnt[CLUSTER];            // dirty lanes of each block
    __shared__ int xpre[CLUSTER + 1];        // their prefix sums
    __shared__ int bw[BATCH + STAGES];       // dirty-list entries of a batch
    __shared__ float blim[2][BATCH];         // their limits: rm, rmcf
    __shared__ int wcount[CL_WARPS];

    cg::cluster_group cluster = cg::this_cluster();
    const int N = s.N, C = chunk_of(N), SL = slice_of(N);
    const int rank = (int)cluster.block_rank();
    const int lo = min(N, rank * C), hi = min(N, lo + C);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* ring = smem;
    float* rm = ring + STAGES * 4 * SL;
    float* rmcf = rm + C;
    float* cs = rmcf + C;
    float* ct = cs + C;
    int* cp = (int*)(ct + C);
    int* act = cp + C;
    int* flg = act + C;                      // bit 0 dirty, bit 1 hit
    int* llist = flg + C;                    // dirty lanes | hit << 30
    int par = 0;                             // parity of the next exchange

    // the pair of this step and the block's state, loaded together
    const int fell_back = s.sel[2];
    int a = s.sel[0], b = s.sel[1];
    for (int c = lo + tid; c < hi; c += CL_THREADS) {
        const int l = c - lo;
        rm[l] = s.rm[c];
        rmcf[l] = s.rmcf[c];
        cs[l] = s.cand_s[c];
        ct[l] = s.cand_t[c];
        cp[l] = s.cand_p[c];
        act[l] = s.active[c];
    }

    // a fallback step: every block reduces the fallback records
    if (fell_back) {
        Cand best = worst();
        for (int k = tid; k < FB_BLOCKS; k += CL_THREADS) {
            const Cand x = s.fb[k];
            if (better(x, best)) best = x;
        }
        best = block_best(best, wbuf);
        a = best.idx / N;
        b = best.idx % N;
    }
    const int i = min(a, b), j = max(a, b);
    const size_t ri = (size_t)i * N, rj = (size_t)j * N;
    const float si = s.sizes[i], sj = s.sizes[j];
    const float w = si / (si + sj), w1 = 1.0f - w;

    // read rows i and j over the block's lanes, blend into ring stage 0,
    // maintain rm, flag the dirty lanes
    for (int c = lo + tid; c < hi; c += CL_THREADS) {
        const int l = c - lo;
        const float ci = __ldcg(s.dt + ri + c), cj = __ldcg(s.dt + rj + c);
        const float nc = w * ci + w1 * cj;
        ring[l] = w * __ldcg(s.d + ri + c) + w1 * __ldcg(s.d + rj + c);
        ring[SL + l] = nc;
        if (s.use_cf) {
            ring[2 * SL + l] = w * __ldcg(s.dcf + ri + c)
                               + w1 * __ldcg(s.dcf + rj + c);
            ring[3 * SL + l] = w * __ldcg(s.dcft + ri + c)
                               + w1 * __ldcg(s.dcft + rj + c);
        }
        const bool other = act[l] && c != i && c != j;
        // the row's cached minimum sat in column i or j: it needs a rescan;
        // any other row's minimum still stands (the new entry is no smaller)
        const bool hit = other && (ci == rm[l] || cj == rm[l]);
        if (other && !hit) rm[l] = fminf(rm[l], nc);
        bool dirty = (act[l] && (cp[l] == i || cp[l] == j)) || hit;
        if (c == j) dirty = true;
        if (c == i) dirty = false;
        flg[l] = (dirty ? 1 : 0) | (hit ? 2 : 0);
    }
    __syncthreads();

    // the block's live lanes of the merged row j and column j; on the
    // diagonal the column's value. A dead row or column is never read
    // again, and row i is dead from now on: it is not written, so no block
    // writes an entry that another block reads above (d[i][j] is read by
    // the owner of lane j), and the merge needs no cluster barrier between
    // its reads and its writes. Each lane's thread reads its lanes of rows
    // i and j before it writes them.
    for (int c = lo + tid; c < hi; c += CL_THREADS) {
        const int l = c - lo;
        if (c == i || !act[l]) continue;
        const size_t rc = (size_t)c * N;
        const float nr = ring[l], nc = ring[SL + l];
        s.d[rj + c] = c == j ? nc : nr;
        s.dt[rj + c] = nc;
        s.d[rc + j] = nc;
        s.dt[rc + j] = c == j ? nc : nr;
        if (s.use_cf) {
            const float nrf = ring[2 * SL + l], ncf = ring[3 * SL + l];
            s.dcf[rj + c] = c == j ? ncf : nrf;
            s.dcft[rj + c] = ncf;
            s.dcf[rc + j] = ncf;
            s.dcft[rc + j] = c == j ? ncf : nrf;
        }
    }
    if (tid == 0 && lo <= i && i < hi) {
        act[i - lo] = 0;
        cs[i - lo] = INF;
    }

    // the block's dirty lanes in ascending order (ordered compaction)
    int nloc = 0;
    for (int base = lo; base < hi; base += CL_THREADS) {
        const int c = base + tid;
        const int f = c < hi ? flg[c - lo] : 0;
        const unsigned bal = __ballot_sync(FULL, f & 1);
        if (lane == 0) wcount[warp] = __popc(bal);
        __syncthreads();
        int before = 0, round = 0;
        for (int k = 0; k < CL_WARPS; ++k) {
            const int v = wcount[k];
            if (k < warp) before += v;
            round += v;
        }
        if (f & 1)
            llist[nloc + before + __popc(bal & ((1u << lane) - 1u))] =
                c | ((f & 2) << 29);
        nloc += round;
        __syncthreads();
    }
    if (tid < CLUSTER) cluster.map_shared_rank(xcnt, tid)[rank] = nloc;
    cluster.sync();             // the merge's writes and the counts are seen
    if (tid == 0) {
        xpre[0] = 0;
        for (int r = 0; r < CLUSTER; ++r) xpre[r + 1] = xpre[r] + xcnt[r];
    }
    __syncthreads();
    const int total = xpre[CLUSTER];

    // the repairs, in batches of BATCH: first the batch's rescan limits in
    // one exchange, then each repair one pass and one exchange
    constexpr int MASK = 0x3fffffff;
    constexpr int RU = 16;      // loads of a lane in flight in a row minimum
    for (int b0 = 0; b0 < total; b0 += BATCH) {
        const int nb = min(BATCH, total - b0);
        const int nw = min(BATCH + STAGES - 1, total - b0);
        // the batch's entries of the dirty list (and those of the rows
        // fetched ahead of its last repairs), read from the owners' lists
        for (int e = tid; e < nw; e += CL_THREADS) {
            const int g = b0 + e;
            int r = 0;
            while (g >= xpre[r + 1]) ++r;
            bw[e] = cluster.map_shared_rank(llist, r)[g - xpre[r]];
        }
        __syncthreads();
        if (b0 == 0) {
            for (int p = 0; p < STAGES - 1; ++p) {
                if (p < total)
                    fetch_row(s, ring + p * 4 * SL, bw[p] & MASK, lo, hi, SL);
                cp_async_commit();
            }
        }
        // the limits' partials, one warp an entry: a refreshed row (hit, or
        // j) takes its minimum over the block's live lanes, rmcf only for j;
        // any other value is the owner's cached one
        for (int e = warp; e < nb; e += CL_WARPS) {
            const int wr = bw[e] & MASK;
            const bool refresh = (bw[e] >> 30) || wr == j;
            const bool own = lo <= wr && wr < hi;
            float m = !refresh && own ? rm[wr - lo] : INF;
            float mc = wr != j && own ? rmcf[wr - lo] : INF;
            if (refresh) {
                const size_t rw = (size_t)wr * N;
                for (int c0 = lo + lane; c0 < hi; c0 += 32 * RU) {
                    float v[RU], vc[RU];
#pragma unroll
                    for (int u = 0; u < RU; ++u) {
                        const int c = c0 + 32 * u;
                        v[u] = c < hi ? __ldcg(s.d + rw + c) : INF;
                        vc[u] = c < hi && wr == j ? __ldcg(s.dcf + rw + c)
                                                  : INF;
                    }
#pragma unroll
                    for (int u = 0; u < RU; ++u) {
                        const int c = c0 + 32 * u;
                        if (c < hi && act[c - lo] && c != wr) {
                            m = fminf(m, v[u]);
                            mc = fminf(mc, vc[u]);
                        }
                    }
                }
                for (int o = 16; o > 0; o >>= 1) {
                    m = fminf(m, __shfl_xor_sync(FULL, m, o));
                    mc = fminf(mc, __shfl_xor_sync(FULL, mc, o));
                }
            }
            if (lane < CLUSTER) {
                float* dst = cluster.map_shared_rank(&xlim[0][0][0], lane);
                dst[rank * BATCH + e] = m;
                dst[(CLUSTER + rank) * BATCH + e] = mc;
            }
        }
        cluster.sync();
        for (int e = tid; e < nb; e += CL_THREADS) {
            float m = INF, mc = INF;
            for (int r = 0; r < CLUSTER; ++r) {
                m = fminf(m, xlim[0][r][e]);
                mc = fminf(mc, xlim[1][r][e]);
            }
            blim[0][e] = m;
            blim[1][e] = mc;
        }
        // (the first repair's barrier orders blim before its reads)

        for (int e = 0; e < nb; ++e) {
            const int g = b0 + e;
            // keep STAGES - 1 rows in flight: the next one goes into the
            // stage that the last repair read
            const int gn = g + STAGES - 1;
            if (gn < total)
                fetch_row(s, ring + (gn % STAGES) * 4 * SL, bw[gn - b0] & MASK,
                          lo, hi, SL);
            cp_async_commit();
            cp_async_wait<STAGES - 1>();
            __syncthreads();
            const int wr = bw[e] & MASK;
            const bool own = lo <= wr && wr < hi;
            const float lim = blim[0][e], limc = blim[1][e];
            // rm of a refreshed row, rmcf of row j: stored just before the
            // row's own rescan (an earlier rescan read the old value)
            if (own && tid == 0 && ((bw[e] >> 30) || wr == j)) {
                rm[wr - lo] = lim;
                if (wr == j) rmcf[wr - lo] = limc;
            }
            // the rescan of row wr over the block's lanes, folding wr into
            // every other live lane's candidate. As in the twin a lane
            // without a candidate (score INF) still takes the tie key and
            // the partner of a smaller tie.
            const float* st = ring + (g % STAGES) * 4 * SL
                              + (int)(((size_t)wr * N + lo) & 3);
            const float lr = lim + s.thr, lc = limc + s.thrcf;
            Cand best = worst();
            for (int c = lo + tid; c < hi; c += CL_THREADS) {
                const int l = c - lo;
                if (!act[l] || c == wr) continue;
                const float dwc = st[l], dcw = st[SL + l];
                float eff = INF;
                if (dwc <= lr && dcw <= rm[l] + s.thr) {
                    eff = dwc + dcw;
                    if (s.use_cf && st[2 * SL + l] <= lc
                        && st[3 * SL + l] <= rmcf[l] + s.thrcf)
                        eff = 0.0f;
                }
                const float tie = tie_hash(wr, c, s.mix);
                const Cand x{eff, tie, c};
                if (eff < INF && better(x, best)) best = x;
                if (eff < cs[l] || (eff == cs[l] && tie < ct[l])) {
                    cs[l] = eff;
                    ct[l] = tie;
                    cp[l] = wr;
                }
            }
            best = block_best_w0(best, wbuf);
            push_rec(cluster, xc[par], rank,
                     Rec{best.score, best.tie, best.idx, 0});
            cluster.sync();
            if (own && tid == 0) {
                const Rec x = best_of(xc[par]);
                const bool have = x.score < INF;
                cs[wr - lo] = have ? x.score : INF;
                ct[wr - lo] = have ? x.tie : INF;
                cp[wr - lo] = have ? x.idx : -1;
            }
            par ^= 1;
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the live lane with the least (score, tie, lane) and its partner; the
    // block's state goes back to device memory for the next launch
    Cand best = worst();
    for (int c = lo + tid; c < hi; c += CL_THREADS) {
        const int l = c - lo;
        const Cand x{cs[l], ct[l], c};
        if (act[l] && x.score < INF && better(x, best)) best = x;
        s.rm[c] = rm[l];
        s.rmcf[c] = rmcf[l];
        s.cand_s[c] = cs[l];
        s.cand_t[c] = ct[l];
        s.cand_p[c] = cp[l];
        s.active[c] = act[l];
    }
    best = block_best_w0(best, wbuf);
    push_rec(cluster, xc[par], rank,
             Rec{best.score, best.tie, best.idx,
                 best.score < INF ? cp[best.idx - lo] : 0});
    // the last exchange, and the closing barrier: after it no block reads or
    // writes another block's shared memory
    cluster.sync();
    if (rank == 0 && tid == 0) {
        const Rec x = best_of(xc[par]);
        const bool have = x.score < INF;
        s.sel[0] = have ? x.idx : 0;
        s.sel[1] = have ? x.partner : 0;
        s.sel[2] = have ? 0 : 1;
        // every block has read sizes[i] and sizes[j] by now
        s.cis[t] = s.conv[i];
        s.cjs[t] = s.conv[j];
        s.sizes[j] = si + sj;
        s.conv[j] = N + t;
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

// The step's launch configuration at this N, set up for launching: lets
// cluster_step_kernel take its dynamic shared memory (above the 48 KB
// default) and asks how many of its clusters the card can hold at once.
// info: blocks a cluster, threads a block, dynamic shared bytes a block, and
// cudaOccupancyMaxActiveClusters. Returns a CUDA error, or
// cudaErrorLaunchOutOfResources when not one cluster fits.
extern "C" int merge_scan_inc_cluster(int N, int* info) {
    const size_t smem = step_smem_bytes(N);
    info[0] = CLUSTER;
    info[1] = CL_THREADS;
    info[2] = (int)smem;
    info[3] = 0;
    cudaError_t e = cudaFuncSetAttribute(
        cluster_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = smem;
    e = cudaOccupancyMaxActiveClusters(&info[3], cluster_step_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    return info[3] >= 1 ? 0 : (int)cudaErrorLaunchOutOfResources;
}

// d, dt, dcf, dcft: (N, N) float32 working copies, updated in place, each
// aligned to 16 bytes. fstate, istate: uninitialised scratch of the sizes
// merge_scan_inc_scratch gives. Outputs cis, cjs (N-1) int32; afterwards
// istate holds the counters at the place merge_scan_inc_scratch names.
extern "C" int merge_scan_inc_launch(void* d, void* dt, void* dcf, void* dcft,
                                     void* fstate, void* istate, void* cis,
                                     void* cjs, int N, int use_cf,
                                     float threshold, float threshold_cf,
                                     int seed, void* stream) {
    if (((uintptr_t)d | (uintptr_t)dt | (uintptr_t)dcf | (uintptr_t)dcft)
        & 15)
        return (int)cudaErrorMisalignedAddress;
    int info[4];
    const int e0 = merge_scan_inc_cluster(N, info);
    if (e0 != 0) return e0;
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
    s.cand_p = q;
    s.active = q + (size_t)N;
    s.conv = q + (size_t)2 * N;
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
    select_kernel<<<1, SELECT_THREADS, 0, st>>>(s);
    for (int t = 0; t < N - 1; ++t) {
        fallback_kernel<<<FB_BLOCKS, ROW_THREADS, 0, st>>>(s);
        cluster_step_kernel<<<CLUSTER, CL_THREADS, info[2], st>>>(s, t);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

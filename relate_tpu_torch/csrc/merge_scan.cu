// Dense MinMatch merge scan for sm_90a (N <= 2048): one persistent
// cooperative kernel a scan, two entry points.
//
// merge_scan_launch replaces the TPU kernel relate_tpu/ops/merge_scan.py:
// _kernel (N <= 1024: merge lists and clade rows). merge_scan_large_launch
// replaces _kernel_large (1024 < N <= 2048: the same selection rule and tie
// hash, merge lists only; the caller rebuilds the clade rows from the lists).
// Both launch merge_scan_coop_kernel, with and without the clade rows.
//
// The scan is a chain of N-1 steps; each step reduces over the whole live
// matrix, picks one pair (i, j), i < j, and blends row j and column j of the
// four working matrices d, dt, dcf, dcft (dt and dcft are the transposes, so
// that d[b][a] is read as dt[a][b], contiguous like the rest). The kernel is
// launched once, with cudaLaunchCooperativeKernel, on G blocks of 512
// threads: as many as the card holds at once, capped at one warp a row
// (N = 1024: 64 blocks, N = 2048: 128). It loops over the steps itself; a
// grid that the card cannot hold is refused by the launch, and the error
// goes back to the caller. Rows have owners for the whole scan: row r
// belongs to block r % G, warp r / G, so the live rows stay spread over the
// SMs as rows die. A step is two phases and two grid barriers:
//
//   phase M  every block reduces the G candidate slots that phase P of the
//            last step wrote (the same total order in every block, so every
//            block finds the same pair; "mutual if any, else symmetric" is
//            decided on the global minima), takes w = s_i / (s_i + s_j) from
//            its own copy of the sizes and marks i dead in its own copy of
//            the live flags (both in shared memory, updated the same way in
//            every block: no block reads a size that another is writing).
//            Block 0 writes the merge lists. Block g blends its slice of
//            columns of row j (and, with the clade rows, of the clade set
//            and clade row) and folds the slice's minima into the step's
//            minima of row j (one atomicMin a block). The owner of every
//            other live row r writes r's column-j entry in the four matrices
//            from r's own entries (r, i) and (r, j), and the minima of row r
//            plus the thresholds (mv, mvcf).
//   barrier
//   phase P  every block copies mv and mvcf into shared memory, with row
//            j's from the step's minima. The owner of row a tests every b:
//            the two band tests, the score, the tie key; each block reduces
//            its rows to one mutual and one symmetric candidate and writes
//            them to its slot g.
//   barrier
//
// Step 0 runs only the minima; the last pass only the merge. No phase runs
// on a single block.
//
// Dead entries hold INF. In every live row, the entries of d and dcf on the
// diagonal (from the start) and in the columns of dead rows (column i from
// the merge that kills row i) are INF, exactly the value the plain version
// puts in their place. So a row's minima and its pairs' scores need no mask
// an entry: a warp streams its row from L2 into registers, 16 bytes a lane
// where N is a multiple of 4 and the matrices are 16-byte aligned, and takes
// a minimum (the row minima, the least symmetric score of a stretch). Only
// the pairs that reach the warp's best score so far or pass the band tests
// take the tie key, and only the mutual ones the clade prior's entries.
//
// What a block reads that another block wrote in the same launch (matrix
// entries, mv, mvcf, the slots, row j's minima) is read through L2
// (__ldcg): L1 is not coherent across SMs, and a read-only (ld.global.nc)
// path would be wrong inside one launch. Every such read comes after a grid
// barrier that follows the write (the barrier is a release/acquire on one
// counter). In phase M no block writes what another reads: the slices of
// row j write row j, which nobody else reads in phase M (the column pass
// skips r = j); a column entry (r, i) or (r, j) is written and read by r's
// owner only; row i is only read. The crossing entries of the sequential
// merge (which blends row j first and then column j from the updated row)
// are (j, i), (i, j) and (j, j): two lie in the dead row or column i and one
// on the diagonal, all three masked from then on, so the live entries come
// out bit for bit as in the plain version, with dt staying the exact
// transpose of d. The slots are overwritten in phase P of the next step,
// after the barrier that follows every block's reading them in phase M.
//
// Bound: at N = 2048 the four matrices are 67 MB, more than the 50 MB L2,
// so the first steps stream the live rows of d, dcf (phase M) and d, dt
// (phase P) from device memory; the later steps and every step at N = 1024
// read them from L2. Then a step's time is latency: the two grid barriers,
// the slots' reduction, and each warp's round trips to L2 along its row.
//
// A block with no live row pushes {INF, INF, 0x7fffffff} into both slots and
// still takes part in every barrier and every merge reduction. Flat indices
// a * N + b stay inside int up to N = 2048 (4.2 M). Live entries are taken
// to be below INF, as distances are.
//
// The merge list is discrete: a 1-ulp difference in w*x + (1-w)*y can flip a
// later merge. This file is built with -fmad=false so that the expression
// rounds as two products and a sum, like the plain PyTorch version and the
// JAX kernel; the redesign changed who computes each blend, not the blend,
// so the flag still holds. The hash is 32-bit wrap-around arithmetic with
// logical shifts (uint32_t). INF is 3.0e38, not infinity, as in the JAX
// kernel.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 3.0e38f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 2048;
constexpr int PER_THREAD = (MAX_N + THREADS - 1) / THREADS;

// A candidate pair, padded to 16 bytes so that a slot is one load.
struct alignas(16) Cand {
    float score;
    float tie;
    int flat;
    int pad;
};

__device__ __forceinline__ bool better(const Cand& x, const Cand& y) {
    if (x.score != y.score) return x.score < y.score;
    if (x.tie != y.tie) return x.tie < y.tie;
    return x.flat < y.flat;
}

__device__ __forceinline__ Cand worst() {
    return Cand{INF, INF, 0x7fffffff, 0};
}

// Order-preserving int keys of floats, so that a minimum over blocks is an
// integer atomicMin.
__device__ __forceinline__ int fkey(float f) {
    const int b = __float_as_int(f);
    return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float funkey(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The warp's best candidate, in every lane: three integer minima over the
// lanes (redux.sync), of the score's key, then of the tie key among the
// lanes that hold that score, then of the flat index among those that also
// hold that tie key. `+ 0.0f` makes -0 and +0 one key, as `better` treats
// them. Tie keys are integers below 2^23, or INF.
__device__ __forceinline__ Cand warp_best(const Cand& c) {
    const unsigned full = 0xffffffffu;
    const int ks = fkey(c.score + 0.0f);
    const int ms = __reduce_min_sync(full, ks);
    const int kt = ks != ms ? INT_MAX
                 : c.tie < 8388608.0f ? (int)c.tie : INT_MAX;
    const int mt = __reduce_min_sync(full, kt);
    const int kf = ks == ms && kt == mt ? c.flat : INT_MAX;
    const int mf = __reduce_min_sync(full, kf);
    return Cand{funkey(ms), mt == INT_MAX ? INF : (float)mt, mf, 0};
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The block's best of two candidates each, valid in thread 0; one
// __syncthreads. `bm`, `bs` have one slot per warp.
__device__ __forceinline__ void block_best2(Cand& m, Cand& s, Cand* bm,
                                            Cand* bs) {
    m = warp_best(m);
    s = warp_best(s);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        bm[warp] = m;
        bs[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
        m = warp_best(lane < WARPS ? bm[lane] : worst());
        s = warp_best(lane < WARPS ? bs[lane] : worst());
    }
}

__device__ __forceinline__ Cand load_cand(const Cand* c) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(c));
    return Cand{v.x, v.y, __float_as_int(v.z), 0};
}

__device__ __forceinline__ uint32_t ld_acquire(const unsigned int* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Grid-wide barrier on a counter that only grows (zeroed before the
// launch): the k-th barrier waits for k * gridDim.x arrivals. The block's
// writes are ordered before thread 0's arrival by __syncthreads and the
// release; the acquire load orders the block's later reads after every
// other block's arrival. A wait of 10 s means a block is lost, not slow:
// the kernel traps, and the launch reports an error instead of hanging the
// card.
__device__ __forceinline__ void arrive_and_wait(unsigned int* bar,
                                                unsigned int target) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(bar) : "memory");
    const uint64_t t0 = global_ns();
    while (ld_acquire(bar) < target) {
        if (global_ns() - t0 > 10000000000ull) __trap();
    }
}

__device__ __forceinline__ bool is_live(const uint32_t* live, int b) {
    return (live[b >> 5] >> (b & 31)) & 1u;
}

// One warp's share of a stretch of two rows p and q, read through L2 into
// registers: E = 4 * CHUNK entries a lane, all loads issued before any is
// used; entries past N read as INF. With VEC (N a multiple of 4, rows
// 16-byte aligned) a lane takes runs of four consecutive entries, 16 bytes a
// load; otherwise one entry a load. Entry e of the lane is column
// col(c0, lane, e) of the stretch that starts at c0; a stretch covers SPAN
// columns. The row minima take longer stretches (fewer round trips to L2
// a row) than the pair tests, which keep more registers an entry.
constexpr int CHUNK_MIN = 4;
constexpr int CHUNK_PAIR = 2;

template <bool VEC, int CHUNK>
struct RowChunk {
    static constexpr int E = 4 * CHUNK;
    static constexpr int SPAN = 32 * E;
    float x[E], y[E];

    __device__ __forceinline__ static int col(int c0, int lane, int e) {
        return VEC ? c0 + 4 * lane + 128 * (e / 4) + (e % 4)
                   : c0 + lane + 32 * e;
    }

    // whether column b is one of this lane's entries of the stretch
    __device__ __forceinline__ static bool holds(int c0, int lane, int b) {
        const int off = b - col(c0, lane, 0);
        return VEC ? off >= 0 && off < 128 * CHUNK && (off & 127) < 4
                   : off >= 0 && off < 32 * E && (off & 31) == 0;
    }

    __device__ __forceinline__ void load(const float* p, const float* q,
                                         int c0, int lane, int N) {
        if (VEC) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) {
                const int b = col(c0, lane, 4 * k);
                float4 u = make_float4(INF, INF, INF, INF), v = u;
                if (b < N) {
                    u = __ldcg(reinterpret_cast<const float4*>(p + b));
                    v = __ldcg(reinterpret_cast<const float4*>(q + b));
                }
                x[4 * k] = u.x;
                x[4 * k + 1] = u.y;
                x[4 * k + 2] = u.z;
                x[4 * k + 3] = u.w;
                y[4 * k] = v.x;
                y[4 * k + 1] = v.y;
                y[4 * k + 2] = v.z;
                y[4 * k + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int b = col(c0, lane, e);
                x[e] = b < N ? __ldcg(p + b) : INF;
                y[e] = b < N ? __ldcg(q + b) : INF;
            }
        }
    }

    // z[e] = v[col(c0, lane, e)] from shared memory, below N
    __device__ __forceinline__ void gather(float* z, const float* v, int c0,
                                           int lane, int N) const {
        if (VEC) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) {
                const int b = col(c0, lane, 4 * k);
                if (b < N) {
                    const float4 u = *reinterpret_cast<const float4*>(v + b);
                    z[4 * k] = u.x;
                    z[4 * k + 1] = u.y;
                    z[4 * k + 2] = u.z;
                    z[4 * k + 3] = u.w;
                }
            }
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int b = col(c0, lane, e);
                if (b < N) z[e] = v[b];
            }
        }
    }
};

// f(chunk, c0) for every stretch of two rows, in order.
template <bool VEC, int CHUNK, class F>
__device__ __forceinline__ void for_chunks(const float* p, const float* q,
                                           int N, int lane, F f) {
    for (int c0 = 0; c0 < N; c0 += RowChunk<VEC, CHUNK>::SPAN) {
        RowChunk<VEC, CHUNK> ch;
        ch.load(p, q, c0, lane, N);
        f(ch, c0);
    }
}

// The test of pair (a, b) where it can change a candidate: the updates of
// this lane's best mutual (bm) and symmetric (bs) candidates. cfab and cfba
// are dcf[a][b] and dcf[b][a], read where the pair is mutual and the clade
// prior is on.
__device__ __forceinline__ void consider(Cand& bm, Cand& bs, int a, int b,
                                         int N, float sym, bool mutual,
                                         bool use_cf, float cfab, float cfba,
                                         float mvcfa, float mvcfb,
                                         uint32_t mix) {
    const uint32_t lo = (uint32_t)min(a, b), hi = (uint32_t)max(a, b);
    uint32_t h = lo * 2654435769u + hi * 2246822507u;
    h ^= mix;
    h ^= h >> 15;
    h *= 739213477u;
    h ^= h >> 12;
    Cand c;
    c.tie = (float)(h & 0x7FFFFFu);
    c.flat = a * N + b;
    c.pad = 0;
    c.score = sym;
    if (better(c, bs)) bs = c;
    if (!mutual) return;
    if (use_cf && cfab <= mvcfa && cfba <= mvcfb) c.score = 0.0f;
    if (better(c, bm)) bm = c;
}

struct Params {
    float* d;
    float* dt;
    float* dcf;
    float* dcft;
    float* csets;         // CLADES: (N, N) clade sets, and the clade rows
    float* clades;        //   (N-1, N) written from them
    float* mv;            // (N) row minima + threshold, written in phase M
    float* mvcf;
    Cand* slot_m;         // (G) each block's mutual and symmetric candidate
    Cand* slot_s;
    unsigned int* bar;    // the grid barrier's counter, zeroed before launch
    int* jmin;            // [4] keys of row j's minima of d and dcf, by the
                          //   step's parity: jmin[2 * (t & 1) + {0, 1}]
    int* cis;
    int* cjs;
    int N;
    int use_cf;
    float thr;
    float thr_cf;
    uint32_t seed;
};

template <bool CLADES, bool VEC>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
merge_scan_coop_kernel(const Params p) {
    extern __shared__ float smem[];
    const int N = p.N;
    float* sizes = smem;            // this block's copy of the cluster sizes
    float* mvs = smem + N;          // phase P: mv, mvcf of every live row
    float* mvcs = smem + 2 * N;
    int* conv = reinterpret_cast<int*>(smem + 3 * N);  // node ids
    uint32_t* live = reinterpret_cast<uint32_t*>(conv + N);   // live rows,
                                                              // one bit each
    __shared__ Cand buf_m[WARPS], buf_s[WARPS];
    __shared__ int s_i, s_j, s_kd, s_kc;
    __shared__ float s_w;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = blockIdx.x, G = gridDim.x;
    // this block's slice of columns for the blend of row j: at most one
    // column a thread (grid_config keeps S <= THREADS)
    const int S = (N + G - 1) / G;
    const int c_slice = g * S + lane * WARPS + warp;
    const bool in_slice = lane * WARPS + warp < S && c_slice < N;
    for (int b = tid; b < N; b += THREADS) {
        sizes[b] = 1.0f;
        conv[b] = b;
    }
    for (int k = tid; k < (N + 31) / 32; k += THREADS)
        live[k] = N - 32 * k >= 32 ? 0xffffffffu : (1u << (N - 32 * k)) - 1u;
    for (int r = g + G * warp; r < N; r += G * WARPS) {
        if (lane == 0) {
            p.d[(size_t)r * N + r] = INF;
            p.dcf[(size_t)r * N + r] = INF;
        }
    }
    __syncthreads();
    unsigned int barriers = 0;

    for (int t = 0;; ++t) {
        // ---- phase M: the merge of step t - 1, then the row minima ----
        int i = -1, j = -1;
        float w = 0.0f, w1 = 0.0f;
        if (t > 0) {
            const int s = t - 1;
            Cand bm = worst(), bs = worst();
            for (int k = tid; k < G; k += THREADS) {
                const Cand m = load_cand(p.slot_m + k);
                const Cand y = load_cand(p.slot_s + k);
                if (better(m, bm)) bm = m;
                if (better(y, bs)) bs = y;
            }
            block_best2(bm, bs, buf_m, buf_s);
            if (tid == 0) {
                // no mutual candidate anywhere: the symmetric argmin
                const Cand c = (bm.score < INF) ? bm : bs;
                const int a = c.flat / N, b = c.flat % N;
                const int ii = min(a, b), jj = max(a, b);
                const float si = sizes[ii], sj = sizes[jj];
                s_i = ii;
                s_j = jj;
                s_w = si / (si + sj);
                s_kd = s_kc = fkey(INF);
                if (g == 0) {
                    p.cis[s] = conv[ii];
                    p.cjs[s] = conv[jj];
                }
                sizes[jj] = si + sj;
                conv[jj] = N + s;
                live[ii >> 5] &= ~(1u << (ii & 31));
            }
            __syncthreads();
            i = s_i;
            j = s_j;
            w = s_w;
            w1 = 1.0f - w;
        }
        if (g == 0 && tid == 0) {
            // the next step's keys, last read in phase P of the step before
            p.jmin[2 * ((t + 1) & 1)] = fkey(INF);
            p.jmin[2 * ((t + 1) & 1) + 1] = fkey(INF);
        }
        // Every load of the phase is issued before its first store: this
        // thread's column of the slice of row j, then (lane 0) the entries
        // (r, i), (r, j) of an owned row r, then the row itself.
        const bool blend = j >= 0 && in_slice;
        float xi[4], xj[4], ci = 0.0f, cj = 0.0f;
        if (blend) {
            const size_t ri = (size_t)i * N + c_slice, rj = (size_t)j * N + c_slice;
            xi[0] = __ldcg(p.d + ri);
            xj[0] = __ldcg(p.d + rj);
            xi[1] = __ldcg(p.dt + ri);
            xj[1] = __ldcg(p.dt + rj);
            xi[2] = __ldcg(p.dcf + ri);
            xj[2] = __ldcg(p.dcf + rj);
            xi[3] = __ldcg(p.dcft + ri);
            xj[3] = __ldcg(p.dcft + rj);
            if (CLADES) {
                ci = __ldcg(p.csets + ri);
                cj = __ldcg(p.csets + rj);
            }
        }
        if (t < N - 1) {
            for (int r = g + G * warp; r < N; r += G * WARPS) {
                if (!is_live(live, r) || r == j) continue;
                const size_t rr = (size_t)r * N;
                float yi[4], yj[4];
                if (j >= 0 && lane == 0) {
                    yi[0] = __ldcg(p.d + rr + i);
                    yj[0] = __ldcg(p.d + rr + j);
                    yi[1] = __ldcg(p.dt + rr + i);
                    yj[1] = __ldcg(p.dt + rr + j);
                    yi[2] = __ldcg(p.dcf + rr + i);
                    yj[2] = __ldcg(p.dcf + rr + j);
                    yi[3] = __ldcg(p.dcft + rr + i);
                    yj[3] = __ldcg(p.dcft + rr + j);
                }
                // the minima of row r without columns i and j (their
                // entries change below); column j is the blend
                float m = INF, mc = INF;
                using Min = RowChunk<VEC, CHUNK_MIN>;
                for_chunks<VEC, CHUNK_MIN>(
                    p.d + rr, p.dcf + rr, N, lane,
                    [&](const Min& ch, int c0) {
                        if (j >= 0 && (Min::holds(c0, lane, i) ||
                                       Min::holds(c0, lane, j))) {
#pragma unroll
                            for (int e = 0; e < Min::E; ++e) {
                                const int b = Min::col(c0, lane, e);
                                const bool ok = b != i && b != j;
                                m = ok ? fminf(m, ch.x[e]) : m;
                                mc = ok ? fminf(mc, ch.y[e]) : mc;
                            }
                        } else {
#pragma unroll
                            for (int e = 0; e < Min::E; ++e) {
                                m = fminf(m, ch.x[e]);
                                mc = fminf(mc, ch.y[e]);
                            }
                        }
                    });
                m = warp_min(m);
                mc = warp_min(mc);
                if (lane == 0) {
                    if (j >= 0) {
                        // column j of row r, from row r's own (r, i), (r, j);
                        // column i is dead from now on
                        const float nd = w * yi[0] + w1 * yj[0];
                        const float nc = w * yi[2] + w1 * yj[2];
                        p.d[rr + j] = nd;
                        p.dt[rr + j] = w * yi[1] + w1 * yj[1];
                        p.dcf[rr + j] = nc;
                        p.dcft[rr + j] = w * yi[3] + w1 * yj[3];
                        p.d[rr + i] = INF;
                        p.dcf[rr + i] = INF;
                        m = fminf(m, nd);
                        mc = fminf(mc, nc);
                    }
                    p.mv[r] = m + p.thr;
                    p.mvcf[r] = mc + p.thr_cf;
                }
            }
        }
        if (blend) {
            // dead columns, and the diagonal (j, j), stay INF
            const size_t rj = (size_t)j * N + c_slice;
            const bool dead = c_slice == j || !is_live(live, c_slice);
            const float nd = dead ? INF : w * xi[0] + w1 * xj[0];
            const float nc = dead ? INF : w * xi[2] + w1 * xj[2];
            p.d[rj] = nd;
            p.dt[rj] = w * xi[1] + w1 * xj[1];
            p.dcf[rj] = nc;
            p.dcft[rj] = w * xi[3] + w1 * xj[3];
            if (CLADES) {
                const float cl = ci + cj;
                p.csets[rj] = cl;
                p.clades[(size_t)(t - 1) * N + c_slice] = cl;
            }
            atomicMin(&s_kd, fkey(nd));
            atomicMin(&s_kc, fkey(nc));
        }
        if (t == N - 1) break;
        __syncthreads();
        if (tid == 0) {
            if (j >= 0) {
                // this block's minimum of its slice of row j, into the
                // step's global minimum
                atomicMin(p.jmin + 2 * (t & 1), s_kd);
                atomicMin(p.jmin + 2 * (t & 1) + 1, s_kc);
            }
            arrive_and_wait(p.bar, ++barriers * G);
        }
        __syncthreads();

        // ---- phase P: every owned row's best candidates ----
        {
            // all loads first, then the stores
            float va[PER_THREAD], vc[PER_THREAD];
#pragma unroll
            for (int k = 0; k < PER_THREAD; ++k) {
                const int b = tid + k * THREADS;
                if (b < N && b != j) {
                    va[k] = __ldcg(p.mv + b);
                    vc[k] = __ldcg(p.mvcf + b);
                }
            }
#pragma unroll
            for (int k = 0; k < PER_THREAD; ++k) {
                const int b = tid + k * THREADS;
                if (b < N && b != j) {
                    mvs[b] = va[k];
                    mvcs[b] = vc[k];
                }
            }
        }
        if (j >= 0 && tid == 0) {
            mvs[j] = funkey(__ldcg(p.jmin + 2 * (t & 1))) + p.thr;
            mvcs[j] = funkey(__ldcg(p.jmin + 2 * (t & 1) + 1)) + p.thr_cf;
        }
        __syncthreads();
        const uint32_t mix = p.seed * 747796405u + (uint32_t)t * 374761393u;
        const bool use_cf = p.use_cf != 0;
        Cand bm = worst(), bs = worst();
        // the warp's best symmetric score so far: a pair whose symmetric
        // score is above it and which is not mutual cannot be the block's
        // candidate, and skips the tie key
        float wbest = INF;
        for (int a = g + G * warp; a < N; a += G * WARPS) {
            if (!is_live(live, a)) continue;
            const size_t ra = (size_t)a * N;
            const float mva = mvs[a], mvcfa = mvcs[a];
            using Pair = RowChunk<VEC, CHUNK_PAIR>;
            for_chunks<VEC, CHUNK_PAIR>(
                p.d + ra, p.dt + ra, N, lane, [&](const Pair& ch, int c0) {
                    float mvb[Pair::E];
                    // x = d[a][b], y = d[b][a] (x is INF where b is dead or
                    // b = a, and such a pair is never mutual and never
                    // below INF): first the stretch's least symmetric
                    // score, then the pairs that reach it or are mutual
                    float cm = INF;
                    uint32_t near = 0, mutual = 0;
#pragma unroll
                    for (int e = 0; e < Pair::E; ++e) {
                        cm = fminf(cm, ch.x[e] + ch.y[e]);
                        near |= (uint32_t)(ch.x[e] <= mva) << e;
                    }
                    wbest = fminf(wbest, funkey(__reduce_min_sync(
                                             0xffffffffu, fkey(cm + 0.0f))));
                    if (near) {
                        ch.gather(mvb, mvs, c0, lane, N);
#pragma unroll
                        for (int e = 0; e < Pair::E; ++e)
                            mutual |= (uint32_t)(((near >> e) & 1u) &&
                                                 ch.y[e] <= mvb[e]) << e;
                    }
                    // most stretches hold no pair that reaches the warp's
                    // best score and none that is mutual
                    if (!__any_sync(0xffffffffu, mutual || cm <= wbest)) return;
                    // the clade prior's entries of this lane's mutual pairs
                    Pair cf;
                    if (use_cf && mutual) {
                        cf.load(p.dcf + ra, p.dcft + ra, c0, lane, N);
                        ch.gather(mvb, mvcs, c0, lane, N);
                    }
#pragma unroll
                    for (int e = 0; e < Pair::E; ++e) {
                        const float sym = ch.x[e] + ch.y[e];
                        const bool mut = (mutual >> e) & 1u;
                        if (mut || (sym <= wbest && sym < INF))
                            consider(bm, bs, a, Pair::col(c0, lane, e), N, sym,
                                     mut, use_cf, cf.x[e], cf.y[e], mvcfa,
                                     mvb[e], mix);
                    }
                });
        }
        block_best2(bm, bs, buf_m, buf_s);
        if (tid == 0) {
            p.slot_m[g] = bm;
            p.slot_s[g] = bs;
            arrive_and_wait(p.bar, ++barriers * G);
        }
        __syncthreads();
    }
}

template <bool CLADES>
const void* kernel_for(bool vec) {
    return vec ? (const void*)merge_scan_coop_kernel<CLADES, true>
               : (const void*)merge_scan_coop_kernel<CLADES, false>;
}

// sizes, mv, mvcf and node ids (four words a row) and the live bits
size_t smem_bytes(int N) {
    return (size_t)4 * N * sizeof(float) + (size_t)(N + 31) / 32 * 4;
}

// The launch configuration at this N: info = {blocks, blocks a SM, threads
// a block, dynamic shared bytes a block, SMs}. The grid is every block the
// card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs),
// capped at one warp a row. Returns a CUDA error, or
// cudaErrorLaunchOutOfResources when not one block fits.
template <bool CLADES>
int grid_config(int N, bool vec, int* info) {
    if (N < 2 || N > MAX_N) return (int)cudaErrorInvalidValue;
    const void* k = kernel_for<CLADES>(vec);
    const size_t smem = smem_bytes(N);
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    info[0] = min(per_sm * sms, (N + WARPS - 1) / WARPS);
    if ((N + info[0] - 1) / info[0] > THREADS)
        return (int)cudaErrorLaunchOutOfResources;
    info[1] = per_sm;
    info[2] = THREADS;
    info[3] = (int)smem;
    info[4] = sms;
    return 0;
}

bool vec_ok(int N, const void* d, const void* dt, const void* dcf,
            const void* dcft) {
    return N % 4 == 0 &&
           !(((uintptr_t)d | (uintptr_t)dt | (uintptr_t)dcf | (uintptr_t)dcft)
             & 15);
}

// One cooperative launch a scan on `stream`.
template <bool CLADES>
int run_scan(void* d, void* dt, void* dcf, void* dcft, void* csets, void* mv,
             void* mvcf, void* best, void* cis, void* cjs, void* clades, int N,
             int use_cf, float threshold, float threshold_cf, int seed,
             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = vec_ok(N, d, dt, dcf, dcft);
    int info[5];
    const int e0 = grid_config<CLADES>(N, vec, info);
    if (e0 != 0) return e0;
    Params p;
    p.d = (float*)d;
    p.dt = (float*)dt;
    p.dcf = (float*)dcf;
    p.dcft = (float*)dcft;
    p.csets = (float*)csets;
    p.clades = (float*)clades;
    p.mv = (float*)mv;
    p.mvcf = (float*)mvcf;
    p.slot_m = (Cand*)best;
    p.slot_s = p.slot_m + N;
    p.bar = (unsigned int*)(p.slot_s + N);
    p.jmin = (int*)p.bar + 4;
    p.cis = (int*)cis;
    p.cjs = (int*)cjs;
    p.N = N;
    p.use_cf = use_cf;
    p.thr = threshold;
    p.thr_cf = threshold_cf;
    p.seed = (uint32_t)seed;
    cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned int), st);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(kernel_for<CLADES>(vec), dim3(info[0]),
                                    dim3(THREADS), args, smem_bytes(N), st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// The launch configuration of the scan at width N (clades: 1 for
// merge_scan_launch, 0 for merge_scan_large_launch). info: blocks, blocks a
// SM, threads a block, dynamic shared bytes a block, SMs.
extern "C" int merge_scan_grid(int N, int clades, int* info) {
    const bool vec = N % 4 == 0;
    return clades ? grid_config<true>(N, vec, info)
                  : grid_config<false>(N, vec, info);
}

// d, dt, dcf, dcft: (N, N) float32 working copies (d, dcf and their
// transposes), updated in place; csets (N, N) float32 = identity. Scratch:
// mv, mvcf (N) float32 and best (8N + 8) int32, 16-byte aligned (the
// candidate slots, the barrier's counter and row j's minima). Outputs cis,
// cjs (N-1) int32 and clades (N-1, N) float32.
extern "C" int merge_scan_launch(void* d, void* dt, void* dcf, void* dcft,
                                 void* csets, void* mv, void* mvcf, void* best,
                                 void* cis, void* cjs, void* clades, int N,
                                 int use_cf, float threshold,
                                 float threshold_cf, int seed, void* stream) {
    return run_scan<true>(d, dt, dcf, dcft, csets, mv, mvcf, best, cis, cjs,
                          clades, N, use_cf, threshold, threshold_cf, seed,
                          stream);
}

// The same scan without clade sets and clade rows (N <= 2048): outputs cis,
// cjs (N-1) int32 only.
extern "C" int merge_scan_large_launch(void* d, void* dt, void* dcf,
                                       void* dcft, void* mv, void* mvcf,
                                       void* best, void* cis, void* cjs, int N,
                                       int use_cf, float threshold,
                                       float threshold_cf, int seed,
                                       void* stream) {
    return run_scan<false>(d, dt, dcf, dcft, nullptr, mv, mvcf, best, cis,
                           cjs, nullptr, N, use_cf, threshold, threshold_cf,
                           seed, stream);
}

// Dense MinMatch merge scan for sm_90a (N <= 2048): one persistent
// cooperative kernel a scan, two entry points.
//
// merge_scan_launch replaces the TPU kernel relate_tpu/ops/merge_scan.py:
// _kernel (N <= 1024: merge lists and clade rows). merge_scan_large_launch
// replaces _kernel_large (1024 < N <= 2048: the same selection rule and tie
// hash, merge lists only; the caller rebuilds the clade rows from the lists).
// Both launch merge_scan_coop_kernel, with and without the clade rows.
//
// The scan is a chain of N-1 steps; each step picks one pair (i, j), i < j,
// among the pairs of live rows that are mutual within the thresholds, and
// blends row j and column j of the four working matrices d, dt, dcf, dcft
// (dt and dcft are the transposes, so that d[b][a] is read as dt[a][b],
// contiguous like the rest; with the clade prior off, dcf and dcft are
// neither read nor written). The caller pads their rows to a stride `ld`, a
// multiple of 4, with INF, so that every row starts on 16 bytes and a pass
// over a row takes one 16-byte load a thread and matrix. The kernel is
// launched once, with cudaLaunchCooperativeKernel, on G blocks of 512
// threads, G = ceil(N / 16) (N = 1006: 63 blocks, N = 1858: 117): one row a
// warp. It loops over the steps itself; a grid that the card cannot hold is
// refused by the launch, and the error goes back to the caller. Row r
// belongs to block r % G, warp r / G, for the whole scan.
//
// Step state. Each live row keeps, in the shared memory of its block, its
// minimum of d (and of dcf) with the number of live columns that hold it,
// and its near set: the columns b with d[a][b] <= mv[a] = min + threshold,
// each with d[a][b], d[b][a], dcf[a][b], dcf[b][a], while there are at most
// NEAR_CAP of them ("over" otherwise). No row's state is rebuilt from the
// whole matrix unless the state cannot say it:
//
//   * After the merge (i, j) the owner of a row r other than i, j reads its
//     entries (r, i), (r, j), writes the blend (r, j), and updates in place:
//     the old entries leave the count of the minimum, the blend enters it.
//     Only when no column holds the minimum any more and the blend lies
//     above it is the row passed in full (a rescan, below). The near set
//     drops columns i and j, and the entries above a lowered threshold, and
//     takes column j if it passes. The other entries of the row did not
//     change, so the minima and the near set stay exact.
//   * Row j is new. The blocks blend it slice by slice, and reduce the
//     slices' minima into global memory (a key each, atomicMin). After the
//     barrier each block adds how many of its slice's columns hold the
//     minimum, and pushes the columns of its slice that pass row j's band
//     test into a list, for the owner of row j to take at the next step.
//     Row j is left out of this step's pair test: a mutual pair (j, b) has
//     d[b][j] <= mv[b], so it lies in row b's near set.
//   * The pair test reads the near sets from shared memory: a member b of
//     row a's set is mutual if d[b][a] <= mv[b]; its score is 0 where the
//     pair is mutual in dcf too, else d[a][b] + d[b][a]; its tie key is
//     hashed with the step term. A row whose set is over is passed in full.
//   * The symmetric fallback (no mutual pair anywhere) is taken only in the
//     steps that need it: every warp walks its row for the least
//     d[a][b] + d[b][a], and one more grid barrier collects the blocks'
//     candidates.
//
// A full pass over a row (the first step's, a rescan, an over row's pair
// test) is made by the whole block: one 16-byte load a thread and matrix
// (N <= 2048 = 4 x 512), the minima and counts reduced over the block, the
// near set written from an exclusive prefix of the threads' counts. A step:
//
//   phase M  every block reduces the G candidate slots that phase P of the
//            last step wrote (the same total order in every block, so every
//            block finds the same pair; the fallback where none is mutual),
//            takes w = s_i / (s_i + s_j) from its own copy of the sizes and
//            marks i dead in its own copy of the live flags. Block 0 writes
//            the merge lists. Block g blends its slice of columns of row j
//            (and, with the clade rows, of the clade set and clade row). The
//            owners update their rows as above; the owner of the row born at
//            the last merge first takes its state from the list.
//   barrier
//   phase P  every block copies mv and mvcf into shared memory, row j's
//            from its minima; pushes its slice of row j's near set; tests
//            its rows' pairs; reduces them to one mutual candidate and
//            writes it to its slot g.
//   barrier
//
// Dead entries hold INF. In every live row, the entries of d and dcf on the
// diagonal (from the start) and in the columns of dead rows (column i from
// the merge that kills row i) are INF, exactly the value the plain version
// puts in their place, as are the padding columns. So a row's minima and
// its near set need no mask an entry.
//
// What a block reads that another block wrote in the same launch (matrix
// entries, mv, mvcf, the slots, row j's minima and list) is read through L2
// (__ldcg): L1 is not coherent across SMs, and a read-only (ld.global.nc)
// path would be wrong inside one launch. Every such read comes after a grid
// barrier that follows the write (the barrier is a release/acquire on one
// counter). In phase M no block writes what another reads: the slices of
// row j write row j, which nobody else reads in phase M; a column entry
// (r, i) or (r, j) is written and read by r's owner only (a rescan of row r
// takes the step's two entries from registers, not from memory); row i is
// only read. The crossing entries of the sequential merge (which blends row
// j first and then column j from the updated row) are (j, i), (i, j) and
// (j, j): two lie in the dead row or column i and one on the diagonal, all
// three masked from then on, so the live entries come out bit for bit as in
// the plain version, with dt staying the exact transpose of d. The state of
// the row born at step t lives in buffer t % 3: written in phase M and P of
// step t, read in phase M of step t + 1, reset by block 0 in phase M of step
// t + 2 for step t + 3.
//
// Counters (int32 [4], zeroed before the launch): the steps, the rows
// updated in place, the rescans (full passes after the first step's: rows
// whose minimum died, and the pair tests of over rows) and the steps that
// took the fallback.
//
// A block with no live row pushes {INF, INF, 0x7fffffff} into its slot and
// still takes part in every barrier and every merge reduction. Flat indices
// lo * N + hi stay inside int up to N = 2048 (4.2 M). Live entries are taken
// to be below INF, as distances are.
//
// The merge list is discrete: a 1-ulp difference in w*x + (1-w)*y can flip a
// later merge. This file is built with -fmad=false so that the expression
// rounds as two products and a sum, like the plain PyTorch version and the
// JAX kernel. The hash is 32-bit wrap-around arithmetic with logical shifts
// (uint32_t). INF is 3.0e38, not infinity, as in the JAX kernel.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 3.0e38f;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 2048;
constexpr int PER_THREAD = (MAX_N + THREADS - 1) / THREADS;
// near-set entries a row keeps (read by ops/merge_scan.py through
// merge_scan_near_cap)
constexpr int NEAR_CAP = 256;
// the born row's state a buffer: keys of its minima of d and dcf, the
// columns that hold them, the entries of its near set pushed
constexpr int JB_KD = 0, JB_KC = 1, JB_CD = 2, JB_CC = 3, JB_NN = 4;
constexpr int JB_INTS = 8;
constexpr int NEAR_FIELDS = 5;      // column, d[a][b], d[b][a], dcf, dcft
constexpr unsigned FULL = 0xffffffffu;

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
    const int ks = fkey(c.score + 0.0f);
    const int ms = __reduce_min_sync(FULL, ks);
    const int kt = ks != ms ? INT_MAX
                 : c.tie < 8388608.0f ? (int)c.tie : INT_MAX;
    const int mt = __reduce_min_sync(FULL, kt);
    const int kf = ks == ms && kt == mt ? c.flat : INT_MAX;
    const int mf = __reduce_min_sync(FULL, kf);
    return Cand{funkey(ms), mt == INT_MAX ? INF : (float)mt, mf, 0};
}

// The block's best candidate, valid in warp 0; one __syncthreads. `buf`
// has one slot per warp.
__device__ __forceinline__ Cand block_best(Cand c, Cand* buf) {
    c = warp_best(c);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) buf[warp] = c;
    __syncthreads();
    if (warp == 0) c = warp_best(lane < WARPS ? buf[lane] : worst());
    return c;
}

// The least of (m, c) pairs over the warp, in every lane: c counts the
// entries that hold m.
__device__ __forceinline__ void warp_min_count(float& m, int& c) {
    for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(FULL, m, o);
        const int c2 = __shfl_xor_sync(FULL, c, o);
        const float mn = fminf(m, m2);
        c = (m == mn ? c : 0) + (m2 == mn ? c2 : 0);
        m = mn;
    }
}

// Adds the lanes where `hit` holds to *ctr with one atomic a warp; returns
// the lane's position among them, after what *ctr held, in hitting lanes.
__device__ __forceinline__ int warp_add(int* ctr, bool hit) {
    const unsigned bal = __ballot_sync(FULL, hit);
    if (!bal) return 0;
    const int lane = threadIdx.x & 31, leader = __ffs(bal) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(ctr, __popc(bal));
    base = __shfl_sync(FULL, base, leader);
    return base + __popc(bal & ((1u << lane) - 1u));
}

__device__ __forceinline__ Cand load_cand(const Cand* c) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(c));
    return Cand{v.x, v.y, __float_as_int(v.z), 0};
}

__device__ __forceinline__ void load4(float* v, const float* p) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
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

// The step's tie key of the pair (lo, hi).
__device__ __forceinline__ float tie_key(int lo, int hi, uint32_t mix) {
    uint32_t h = (uint32_t)lo * 2654435769u + (uint32_t)hi * 2246822507u;
    h ^= mix;
    h ^= h >> 15;
    h *= 739213477u;
    h ^= h >> 12;
    return (float)(h & 0x7FFFFFu);
}

__device__ __forceinline__ void consider(Cand& best, int a, int b, int N,
                                         float score, uint32_t mix) {
    const int lo = min(a, b), hi = max(a, b);
    const Cand c{score, tie_key(lo, hi, mix), lo * N + hi, 0};
    if (better(c, best)) best = c;
}

__device__ __forceinline__ uint32_t step_mix(uint32_t seed, int t) {
    return seed * 747796405u + (uint32_t)t * 374761393u;
}

// The fallback's walk of one row by its warp: stretches of two rows read
// through L2 into registers, E = 16 entries a lane in runs of four (16 bytes
// a load), all loads issued before any is used; entries past N read as INF.
constexpr int CHUNK = 4;

struct RowChunk {
    static constexpr int E = 4 * CHUNK;
    static constexpr int SPAN = 32 * E;
    float x[E], y[E];

    __device__ __forceinline__ static int col(int c0, int lane, int e) {
        return c0 + 4 * lane + 128 * (e / 4) + (e % 4);
    }

    __device__ __forceinline__ void load(const float* p, const float* q,
                                         int c0, int lane, int N) {
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
    }
};

struct Params {
    float* d;             // (N, ld) working copies, padded with INF
    float* dt;
    float* dcf;
    float* dcft;
    float* csets;         // CLADES: (N, N) clade sets, and the clade rows
    float* clades;        //   (N-1, N) written from them
    float* mv;            // (N) row minima + threshold
    float* mvcf;
    Cand* slot_m;         // (G) each block's mutual candidate, and its
    Cand* slot_s;         //   symmetric one in a fallback step
    unsigned int* bar;    // the grid barrier's counter, zeroed before launch
    int* jbuf;            // [3][JB_INTS] the born row's state, by step % 3
    int* jnear;           // [3][NEAR_FIELDS][NEAR_CAP] its near set
    int* counts;          // [4] steps, updates, rescans, fallback steps
    int* cis;
    int* cjs;
    int N;
    int ld;
    int use_cf;
    float thr;
    float thr_cf;
    uint32_t seed;
};

template <bool CLADES>
__global__ void __launch_bounds__(THREADS, 1)
merge_scan_coop_kernel(const Params p) {
    extern __shared__ __align__(16) float smem[];
    const int N = p.N, ld = p.ld;
    float* sizes = smem;            // this block's copy of the cluster sizes
    float* mvs = smem + N;          // phase P: mv, mvcf of every live row
    float* mvcs = smem + 2 * N;
    int* conv = reinterpret_cast<int*>(smem + 3 * N);  // node ids
    uint32_t* live = reinterpret_cast<uint32_t*>(conv + N);   // live rows,
                                                              // one bit each
    // the near sets of this block's rows, NEAR_CAP entries a row
    int* ncol = reinterpret_cast<int*>(smem + 4 * N
                                       + ((N + 31) / 32 + 3) / 4 * 4);
    float* nx = reinterpret_cast<float*>(ncol + WARPS * NEAR_CAP);
    float* ny = nx + WARPS * NEAR_CAP;
    float* ncx = ny + WARPS * NEAR_CAP;
    float* ncy = ncx + WARPS * NEAR_CAP;
    __shared__ Cand buf[WARPS];
    __shared__ Cand s_cand;
    // a row's minima of d and dcf, the live columns that hold them, its
    // near entries (-1: over), and the step's new entries of column j
    __shared__ float rm[WARPS], rmc[WARPS];
    __shared__ int rcnt[WARPS], rcntc[WARPS], nn[WARPS];
    __shared__ float cjv[WARPS][4];
    __shared__ float red_m[WARPS], red_mc[WARPS];
    __shared__ int red_c[WARPS], red_cc[WARPS], red_n[WARPS];
    __shared__ int s_list[WARPS], s_over[WARPS];
    __shared__ int s_i, s_j, s_kd, s_kc, s_nlist, s_nover;
    __shared__ int s_upd, s_resc, s_fb;
    __shared__ float s_w;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = blockIdx.x, G = gridDim.x;
    const bool use_cf = p.use_cf != 0;
    // this block's slice of columns for the blend of row j: at most one
    // column a thread (grid_config keeps S <= THREADS)
    const int S = (N + G - 1) / G;
    const int c_slice = g * S + lane * WARPS + warp;
    const bool in_slice = lane * WARPS + warp < S && c_slice < N;
    // this warp's row (grid_config keeps N <= G * WARPS)
    const int my_row = g + G * warp;
    const bool has_row = my_row < N;
    for (int b = tid; b < N; b += THREADS) {
        sizes[b] = 1.0f;
        conv[b] = b;
    }
    for (int k = tid; k < (N + 31) / 32; k += THREADS)
        live[k] = N - 32 * k >= 32 ? 0xffffffffu : (1u << (N - 32 * k)) - 1u;
    if (has_row && lane == 0) {
        p.d[(size_t)my_row * ld + my_row] = INF;
        if (use_cf) p.dcf[(size_t)my_row * ld + my_row] = INF;
    }
    if (tid == 0) {
        s_upd = s_resc = s_fb = 0;
        s_nlist = s_nover = 0;
    }
    __syncthreads();
    unsigned int barriers = 0;

    // A pass over row r (warp k's) by the whole block: thread tid takes
    // columns 4 tid .. 4 tid + 3. With `pairs` (phase P, a row whose near
    // set is over) it tests the row's pairs into `bm`; else it takes the
    // row's minima and counts (the step's entries (r, i), (r, j) from
    // cjv[k]; i = j = -1 at the first step). Both rebuild the near set.
    // `counted`: a rescan.
    auto row_pass = [&](int r, int k, bool pairs, int i, int j,
                        uint32_t mix, Cand& bm, bool counted) {
        const int c0 = 4 * tid;
        const size_t rr = (size_t)r * ld;
        float x[4], y[4], cx[4], cy[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = y[e] = cx[e] = cy[e] = INF;
        if (c0 < ld) {
            load4(x, p.d + rr + c0);
            load4(y, p.dt + rr + c0);
            if (use_cf) {
                load4(cx, p.dcf + rr + c0);
                load4(cy, p.dcft + rr + c0);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int b = c0 + e;
            if (b == r || b == i) {
                x[e] = INF;
                cx[e] = INF;
            } else if (b == j) {
                x[e] = cjv[k][0];
                y[e] = cjv[k][1];
                cx[e] = cjv[k][2];
                cy[e] = cjv[k][3];
            }
        }
        float m, mc;
        if (pairs) {
            m = rm[k];
            mc = rmc[k];
        } else {
            m = fminf(fminf(x[0], x[1]), fminf(x[2], x[3]));
            mc = fminf(fminf(cx[0], cx[1]), fminf(cx[2], cx[3]));
            int c = 0, cc = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                c += x[e] == m;
                cc += cx[e] == mc;
            }
            warp_min_count(m, c);
            warp_min_count(mc, cc);
            if (lane == 0) {
                red_m[warp] = m;
                red_c[warp] = c;
                red_mc[warp] = mc;
                red_cc[warp] = cc;
            }
            __syncthreads();
            m = red_m[0];
            c = red_c[0];
            mc = red_mc[0];
            cc = red_cc[0];
            for (int w = 1; w < WARPS; ++w) {
                const float m2 = red_m[w], mc2 = red_mc[w];
                const float mn = fminf(m, m2), mcn = fminf(mc, mc2);
                c = (m == mn ? c : 0) + (m2 == mn ? red_c[w] : 0);
                cc = (mc == mcn ? cc : 0) + (mc2 == mcn ? red_cc[w] : 0);
                m = mn;
                mc = mcn;
            }
            if (tid == 0) {
                rm[k] = m;
                rcnt[k] = c;
                rmc[k] = mc;
                rcntc[k] = cc;
                p.mv[r] = m + p.thr;
                if (use_cf) p.mvcf[r] = mc + p.thr_cf;
            }
        }
        const float mva = m + p.thr, mvcfa = mc + p.thr_cf;
        unsigned bits = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) bits |= (unsigned)(x[e] <= mva) << e;
        if (pairs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int b = c0 + e;
                if (((bits >> e) & 1u) && y[e] <= mvs[b]) {
                    const bool cf0 = use_cf && cx[e] <= mvcfa
                                     && cy[e] <= mvcs[b];
                    consider(bm, r, b, N, cf0 ? 0.0f : x[e] + y[e], mix);
                }
            }
        }
        // the near set, from an exclusive prefix of the threads' counts
        const int n = __popc(bits);
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) red_n[warp] = incl;
        __syncthreads();
        int q = incl - n, total = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int v = red_n[w];
            q += w < warp ? v : 0;
            total += v;
        }
        if (total <= NEAR_CAP) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (!((bits >> e) & 1u)) continue;
                const int at = k * NEAR_CAP + q++;
                ncol[at] = c0 + e;
                nx[at] = x[e];
                ny[at] = y[e];
                ncx[at] = cx[e];
                ncy[at] = cy[e];
            }
        }
        if (tid == 0) {
            nn[k] = total <= NEAR_CAP ? total : -1;
            if (counted) ++s_resc;
        }
        __syncthreads();
    };

    // the first step's minima and near sets
    {
        Cand none = worst();
        for (int k = 0; k < WARPS && g + G * k < N; ++k)
            row_pass(g + G * k, k, false, -1, -1, 0u, none, false);
    }

    int born = -1;     // the row born at the last merge
    for (int t = 0;; ++t) {
        // ---- phase M: the merge of step t - 1, then the rows' state ----
        int i = -1, j = -1;
        float w = 0.0f, w1 = 0.0f;
        if (t > 0) {
            const int s = t - 1;
            Cand c = worst();
            for (int k = tid; k < G; k += THREADS) {
                const Cand m = load_cand(p.slot_m + k);
                if (better(m, c)) c = m;
            }
            c = block_best(c, buf);
            if (tid == 0) s_cand = c;
            __syncthreads();
            c = s_cand;
            if (!(c.score < INF)) {
                // no mutual pair anywhere: the symmetric argmin of step s
                const uint32_t mix = step_mix(p.seed, s);
                Cand bs = worst();
                if (has_row && is_live(live, my_row)) {
                    const size_t ra = (size_t)my_row * ld;
                    float wbest = INF;
                    for (int c0 = 0; c0 < N; c0 += RowChunk::SPAN) {
                        RowChunk ch;
                        ch.load(p.d + ra, p.dt + ra, c0, lane, N);
                        float cm = INF;
#pragma unroll
                        for (int e = 0; e < RowChunk::E; ++e)
                            cm = fminf(cm, ch.x[e] + ch.y[e]);
                        wbest = fminf(wbest, funkey(__reduce_min_sync(
                                                 FULL, fkey(cm + 0.0f))));
                        if (!__any_sync(FULL, cm <= wbest)) continue;
#pragma unroll
                        for (int e = 0; e < RowChunk::E; ++e) {
                            const float sym = ch.x[e] + ch.y[e];
                            if (sym <= wbest && sym < INF)
                                consider(bs, my_row,
                                         RowChunk::col(c0, lane, e), N, sym,
                                         mix);
                        }
                    }
                }
                bs = block_best(bs, buf);
                if (tid == 0) {
                    p.slot_s[g] = bs;
                    ++s_fb;
                    arrive_and_wait(p.bar, ++barriers * G);
                }
                __syncthreads();
                bs = worst();
                for (int k = tid; k < G; k += THREADS) {
                    const Cand y = load_cand(p.slot_s + k);
                    if (better(y, bs)) bs = y;
                }
                bs = block_best(bs, buf);
                if (tid == 0) s_cand = bs;
                __syncthreads();
                c = s_cand;
            }
            if (tid == 0) {
                const int ii = c.flat / N, jj = c.flat % N;
                const float si = sizes[ii], sj = sizes[jj];
                s_i = ii;
                s_j = jj;
                s_w = si / (si + sj);
                s_kd = s_kc = fkey(INF);
                s_nlist = s_nover = 0;
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
            // the buffer of step t + 1, last read in phase M of step t - 1
            int* jb = p.jbuf + JB_INTS * ((t + 1) % 3);
            jb[JB_KD] = jb[JB_KC] = fkey(INF);
            jb[JB_CD] = jb[JB_CC] = jb[JB_NN] = 0;
        }
        // Every load of the phase is issued before its first store: this
        // thread's column of the slice of row j, the born row's state where
        // this block owns it, then (lane 0) the entries (r, i), (r, j) of
        // the warp's row.
        const bool blend = j >= 0 && in_slice;
        const bool rows = t < N - 1 && j >= 0;
        float xi[4], xj[4], ci = 0.0f, cj = 0.0f;
        if (blend) {
            const size_t ri = (size_t)i * ld + c_slice;
            const size_t rj = (size_t)j * ld + c_slice;
            xi[0] = __ldcg(p.d + ri);
            xj[0] = __ldcg(p.d + rj);
            xi[1] = __ldcg(p.dt + ri);
            xj[1] = __ldcg(p.dt + rj);
            if (use_cf) {
                xi[2] = __ldcg(p.dcf + ri);
                xj[2] = __ldcg(p.dcf + rj);
                xi[3] = __ldcg(p.dcft + ri);
                xj[3] = __ldcg(p.dcft + rj);
            }
            if (CLADES) {
                ci = __ldcg(p.csets + (size_t)i * N + c_slice);
                cj = __ldcg(p.csets + (size_t)j * N + c_slice);
            }
        }
        const bool take = rows && born >= 0 && born % G == g && born != i
                          && born != j;
        const int kb = born / G;
        int jb_v = 0, jb_n = 0;
        int jw[(NEAR_FIELDS * NEAR_CAP + THREADS - 1) / THREADS];
        if (take) {
            const int* jb = p.jbuf + JB_INTS * ((t - 1) % 3);
            const int* jn = p.jnear + NEAR_FIELDS * NEAR_CAP * ((t - 1) % 3);
            jb_n = __ldcg(jb + JB_NN);
            if (tid < 4) jb_v = __ldcg(jb + tid);
#pragma unroll
            for (int q = 0; q * THREADS < NEAR_FIELDS * NEAR_CAP; ++q) {
                const int at = tid + q * THREADS;
                if (at < NEAR_FIELDS * NEAR_CAP) jw[q] = __ldcg(jn + at);
            }
        }
        const bool upd = rows && has_row && is_live(live, my_row)
                         && my_row != j;
        float yi[4], yj[4];
        if (upd && lane == 0) {
            const size_t rr = (size_t)my_row * ld;
            yi[0] = __ldcg(p.d + rr + i);
            yj[0] = __ldcg(p.d + rr + j);
            yi[1] = __ldcg(p.dt + rr + i);
            yj[1] = __ldcg(p.dt + rr + j);
            if (use_cf) {
                yi[2] = __ldcg(p.dcf + rr + i);
                yj[2] = __ldcg(p.dcf + rr + j);
                yi[3] = __ldcg(p.dcft + rr + i);
                yj[3] = __ldcg(p.dcft + rr + j);
            }
        }
        if (take) {
            // the born row's minima, counts and near set, as its slices
            // left them
            if (tid == JB_KD) {
                rm[kb] = funkey(jb_v);
                nn[kb] = jb_n <= NEAR_CAP ? jb_n : -1;
            } else if (tid == JB_KC) {
                rmc[kb] = funkey(jb_v);
            } else if (tid == JB_CD) {
                rcnt[kb] = jb_v;
            } else if (tid == JB_CC) {
                rcntc[kb] = jb_v;
            }
            if (jb_n <= NEAR_CAP) {
#pragma unroll
                for (int q = 0; q * THREADS < NEAR_FIELDS * NEAR_CAP; ++q) {
                    const int at = tid + q * THREADS;
                    const int f = at / NEAR_CAP, e = at % NEAR_CAP;
                    if (at >= NEAR_FIELDS * NEAR_CAP || e >= jb_n) continue;
                    const int to = kb * NEAR_CAP + e;
                    if (f == 0) ncol[to] = jw[q];
                    else if (f == 1) nx[to] = __int_as_float(jw[q]);
                    else if (f == 2) ny[to] = __int_as_float(jw[q]);
                    else if (f == 3) ncx[to] = __int_as_float(jw[q]);
                    else ncy[to] = __int_as_float(jw[q]);
                }
            }
        }
        __syncthreads();
        if (upd) {
            // column j of the row from its own (r, i), (r, j); column i is
            // dead from now on. Then the minima in place, or a rescan.
            const int k = warp;
            int ok = 0;
            float mvo = 0.0f, mvn = 0.0f, nd = 0.0f;
            if (lane == 0) {
                const size_t rr = (size_t)my_row * ld;
                nd = w * yi[0] + w1 * yj[0];
                const float ndt = w * yi[1] + w1 * yj[1];
                p.d[rr + j] = nd;
                p.dt[rr + j] = ndt;
                p.d[rr + i] = INF;
                float nc = INF, nct = INF;
                if (use_cf) {
                    nc = w * yi[2] + w1 * yj[2];
                    nct = w * yi[3] + w1 * yj[3];
                    p.dcf[rr + j] = nc;
                    p.dcft[rr + j] = nct;
                    p.dcf[rr + i] = INF;
                }
                cjv[k][0] = nd;
                cjv[k][1] = ndt;
                cjv[k][2] = nc;
                cjv[k][3] = nct;
                const float m = rm[k];
                const int c2 = rcnt[k] - (yi[0] == m) - (yj[0] == m);
                ok = c2 > 0 || nd <= m;
                const float m2 = nd < m ? nd : m;
                const int n2 = nd < m ? 1 : nd == m ? c2 + 1 : c2;
                float mc2 = 0.0f;
                int nc2 = 0;
                if (use_cf) {
                    const float mc = rmc[k];
                    const int cc2 = rcntc[k] - (yi[2] == mc) - (yj[2] == mc);
                    ok = ok && (cc2 > 0 || nc <= mc);
                    mc2 = nc < mc ? nc : mc;
                    nc2 = nc < mc ? 1 : nc == mc ? cc2 + 1 : cc2;
                }
                mvo = m + p.thr;
                if (ok) {
                    rm[k] = m2;
                    rcnt[k] = n2;
                    mvn = m2 + p.thr;
                    p.mv[my_row] = mvn;
                    if (use_cf) {
                        rmc[k] = mc2;
                        rcntc[k] = nc2;
                        p.mvcf[my_row] = mc2 + p.thr_cf;
                    }
                    atomicAdd(&s_upd, 1);
                } else {
                    s_list[atomicAdd(&s_nlist, 1)] = k;
                }
            }
            ok = __shfl_sync(FULL, ok, 0);
            if (ok && nn[k] >= 0) {
                // the near set: drop columns i and j, and the entries above
                // a lowered threshold; then take column j if it passes
                mvo = __shfl_sync(FULL, mvo, 0);
                mvn = __shfl_sync(FULL, mvn, 0);
                nd = __shfl_sync(FULL, nd, 0);
                const bool drop = mvn < mvo;
                const int n = nn[k];
                int kept = 0;
                for (int e0 = 0; e0 < n; e0 += 32) {
                    const int e = e0 + lane, at = k * NEAR_CAP + e;
                    int col = 0;
                    float ex = 0.0f, ey = 0.0f, ecx = 0.0f, ecy = 0.0f;
                    bool keep = false;
                    if (e < n) {
                        col = ncol[at];
                        ex = nx[at];
                        ey = ny[at];
                        ecx = ncx[at];
                        ecy = ncy[at];
                        keep = col != i && col != j && (!drop || ex <= mvn);
                    }
                    const unsigned bal = __ballot_sync(FULL, keep);
                    if (keep) {
                        const int to = k * NEAR_CAP + kept
                                       + __popc(bal & ((1u << lane) - 1u));
                        ncol[to] = col;
                        nx[to] = ex;
                        ny[to] = ey;
                        ncx[to] = ecx;
                        ncy[to] = ecy;
                    }
                    kept += __popc(bal);
                }
                __syncwarp();
                if (lane == 0) {
                    if (!(nd <= mvn)) {
                        nn[k] = kept;
                    } else if (kept < NEAR_CAP) {
                        const int to = k * NEAR_CAP + kept;
                        ncol[to] = j;
                        nx[to] = cjv[k][0];
                        ny[to] = cjv[k][1];
                        ncx[to] = cjv[k][2];
                        ncy[to] = cjv[k][3];
                        nn[k] = kept + 1;
                    } else {
                        nn[k] = -1;
                    }
                }
            }
        }
        // the slice of row j; dead columns, and the diagonal (j, j), stay
        // INF. Kept in registers for phase P.
        float sx = INF, sy = INF, scx = INF, scy = INF;
        if (blend) {
            const size_t rj = (size_t)j * ld + c_slice;
            const bool dead = c_slice == j || !is_live(live, c_slice);
            sx = dead ? INF : w * xi[0] + w1 * xj[0];
            sy = w * xi[1] + w1 * xj[1];
            p.d[rj] = sx;
            p.dt[rj] = sy;
            atomicMin(&s_kd, fkey(sx + 0.0f));
            if (use_cf) {
                scx = dead ? INF : w * xi[2] + w1 * xj[2];
                scy = w * xi[3] + w1 * xj[3];
                p.dcf[rj] = scx;
                p.dcft[rj] = scy;
                atomicMin(&s_kc, fkey(scx + 0.0f));
            }
            if (CLADES) {
                const float cl = ci + cj;
                p.csets[(size_t)j * N + c_slice] = cl;
                p.clades[(size_t)(t - 1) * N + c_slice] = cl;
            }
        }
        if (t == N - 1) break;
        __syncthreads();
        {
            // the rows whose minimum died: a pass each
            const int nl = s_nlist;
            Cand none = worst();
            for (int q = 0; q < nl; ++q) {
                const int k = s_list[q];
                row_pass(g + G * k, k, false, i, j, 0u, none, true);
            }
        }
        if (tid == 0) {
            if (j >= 0) {
                // this block's minimum of its slice of row j, into the
                // step's global minimum
                int* jb = p.jbuf + JB_INTS * (t % 3);
                atomicMin(jb + JB_KD, s_kd);
                if (use_cf) atomicMin(jb + JB_KC, s_kc);
            }
            arrive_and_wait(p.bar, ++barriers * G);
        }
        __syncthreads();

        // ---- phase P: every owned row's best mutual candidate ----
        {
            // all loads first, then the stores
            float va[PER_THREAD], vc[PER_THREAD];
            int* jb = p.jbuf + JB_INTS * (t % 3);
            int kd = 0, kc = 0;
            if (j >= 0) {
                kd = __ldcg(jb + JB_KD);
                if (use_cf) kc = __ldcg(jb + JB_KC);
            }
#pragma unroll
            for (int k = 0; k < PER_THREAD; ++k) {
                const int b = tid + k * THREADS;
                if (b < N && b != j) {
                    va[k] = __ldcg(p.mv + b);
                    vc[k] = use_cf ? __ldcg(p.mvcf + b) : 0.0f;
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
            if (j >= 0) {
                const float mvj = funkey(kd) + p.thr;
                if (tid == 0) {
                    mvs[j] = mvj;
                    mvcs[j] = funkey(kc) + p.thr_cf;
                }
                // row j: the columns of this slice that hold its minima,
                // and those of its near set
                warp_add(jb + JB_CD, in_slice && fkey(sx + 0.0f) == kd);
                if (use_cf)
                    warp_add(jb + JB_CC, in_slice && fkey(scx + 0.0f) == kc);
                const bool pass = in_slice && sx <= mvj;
                const int e = warp_add(jb + JB_NN, pass);
                if (pass && e < NEAR_CAP) {
                    int* jn = p.jnear + NEAR_FIELDS * NEAR_CAP * (t % 3);
                    jn[e] = c_slice;
                    jn[NEAR_CAP + e] = __float_as_int(sx);
                    jn[2 * NEAR_CAP + e] = __float_as_int(sy);
                    jn[3 * NEAR_CAP + e] = __float_as_int(scx);
                    jn[4 * NEAR_CAP + e] = __float_as_int(scy);
                }
            }
        }
        const bool mine = has_row && is_live(live, my_row) && my_row != j;
        const bool over = mine && nn[warp] < 0;
        if (over && lane == 0) s_over[atomicAdd(&s_nover, 1)] = warp;
        __syncthreads();
        const uint32_t mix = step_mix(p.seed, t);
        Cand bm = worst();
        {
            // rows whose near set is over: a pass each
            const int no = s_nover;
            for (int q = 0; q < no; ++q) {
                const int k = s_over[q];
                row_pass(g + G * k, k, true, -1, -1, mix, bm, true);
            }
        }
        if (mine && !over) {
            const int k = warp, n = nn[k];
            const float mva = mvs[my_row], mvcfa = mvcs[my_row];
            for (int e = lane; e < n; e += 32) {
                const int at = k * NEAR_CAP + e, b = ncol[at];
                const float x = nx[at], y = ny[at];
                if (x <= mva && y <= mvs[b]) {
                    const bool cf0 = use_cf && ncx[at] <= mvcfa
                                     && ncy[at] <= mvcs[b];
                    consider(bm, my_row, b, N, cf0 ? 0.0f : x + y, mix);
                }
            }
        }
        bm = block_best(bm, buf);
        if (tid == 0) {
            p.slot_m[g] = bm;
            arrive_and_wait(p.bar, ++barriers * G);
        }
        __syncthreads();
        born = j;
    }
    if (tid == 0) {
        atomicAdd(p.counts + 1, s_upd);
        atomicAdd(p.counts + 2, s_resc);
        if (g == 0) {
            atomicAdd(p.counts, N - 1);
            atomicAdd(p.counts + 3, s_fb);
        }
    }
}

template <bool CLADES>
const void* kernel_for() {
    return (const void*)merge_scan_coop_kernel<CLADES>;
}

// sizes, mv, mvcf and node ids (four words a row), the live bits (padded
// to 16 bytes) and the near sets of a block's rows
size_t smem_bytes(int N) {
    return (size_t)4 * N * sizeof(float)
           + (size_t)((N + 31) / 32 + 3) / 4 * 16
           + (size_t)NEAR_FIELDS * WARPS * NEAR_CAP * 4;
}

// int32 words of the scratch: two slots of 16-byte candidates a block
// (blocks <= N), the barrier's counter (padded to 16 bytes), the born
// row's three buffers and their near sets, then mv and mvcf (2N floats)
constexpr int MV_AT_8N = 4 + 3 * JB_INTS + 3 * NEAR_FIELDS * NEAR_CAP;
size_t scratch_ints(int N) {
    return (size_t)8 * N + MV_AT_8N + 2 * (size_t)N;
}

// The launch configuration at this N: info = {blocks, blocks a SM, threads
// a block, dynamic shared bytes a block, SMs}. The grid is one warp a row,
// ceil(N / 16) blocks; returns cudaErrorLaunchOutOfResources where the card
// cannot hold them at once, or not one block fits.
template <bool CLADES>
int grid_config(int N, int* info) {
    if (N < 2 || N > MAX_N) return (int)cudaErrorInvalidValue;
    const void* k = kernel_for<CLADES>();
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
    info[0] = (N + WARPS - 1) / WARPS;
    if (per_sm < 1 || per_sm * sms < info[0])
        return (int)cudaErrorLaunchOutOfResources;
    info[1] = per_sm;
    info[2] = THREADS;
    info[3] = (int)smem;
    info[4] = sms;
    return 0;
}

// One cooperative launch a scan on `stream`.
template <bool CLADES>
int run_scan(void* d, void* dt, void* dcf, void* dcft, void* csets,
             void* best, void* counts, void* cis, void* cjs, void* clades,
             int N, int ld, int use_cf, float threshold, float threshold_cf,
             int seed, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (ld < N || ld % 4 != 0 ||
        (((uintptr_t)d | (uintptr_t)dt | (uintptr_t)dcf | (uintptr_t)dcft |
          (uintptr_t)best) & 15))
        return (int)cudaErrorInvalidValue;
    int info[5];
    const int e0 = grid_config<CLADES>(N, info);
    if (e0 != 0) return e0;
    Params p;
    p.d = (float*)d;
    p.dt = (float*)dt;
    p.dcf = (float*)dcf;
    p.dcft = (float*)dcft;
    p.csets = (float*)csets;
    p.clades = (float*)clades;
    p.slot_m = (Cand*)best;
    p.slot_s = p.slot_m + N;
    p.bar = (unsigned int*)(p.slot_s + N);
    p.jbuf = (int*)p.bar + 4;
    p.jnear = p.jbuf + 3 * JB_INTS;
    p.mv = (float*)((int*)p.bar + MV_AT_8N);
    p.mvcf = p.mv + N;
    p.counts = (int*)counts;
    p.cis = (int*)cis;
    p.cjs = (int*)cjs;
    p.N = N;
    p.ld = ld;
    p.use_cf = use_cf;
    p.thr = threshold;
    p.thr_cf = threshold_cf;
    p.seed = (uint32_t)seed;
    cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned int), st);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(counts, 0, 4 * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel(kernel_for<CLADES>(), dim3(info[0]),
                                    dim3(THREADS), args, smem_bytes(N), st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// The launch configuration of the scan at width N (clades: 1 for
// merge_scan_launch, 0 for merge_scan_large_launch). info: blocks, blocks a
// SM, threads a block, dynamic shared bytes a block, SMs.
extern "C" int merge_scan_grid(int N, int clades, int* info) {
    return clades ? grid_config<true>(N, info) : grid_config<false>(N, info);
}

// int32 words of the scratch `best` at width N.
extern "C" long long merge_scan_scratch_ints(int N) {
    return (long long)scratch_ints(N);
}

// The near-set entries a row keeps: the capacity the CPU model of the
// step state (merge_scan_counts) must count with.
extern "C" int merge_scan_near_cap() { return NEAR_CAP; }

// d, dt, dcf, dcft: (N, ld) float32 working copies (d, dcf and their
// transposes, ld a multiple of 4, the columns from N on INF, 16-byte
// aligned), updated in place; csets (N, N) float32 = identity. Scratch: best
// (merge_scan_scratch_ints(N)) int32, 16-byte aligned. Outputs counts [4]
// int32 (steps, rows updated in place, rescans, fallback steps), cis, cjs
// (N-1) int32 and clades (N-1, N) float32.
extern "C" int merge_scan_launch(void* d, void* dt, void* dcf, void* dcft,
                                 void* csets, void* best, void* counts,
                                 void* cis, void* cjs, void* clades, int N,
                                 int ld, int use_cf, float threshold,
                                 float threshold_cf, int seed, void* stream) {
    return run_scan<true>(d, dt, dcf, dcft, csets, best, counts, cis, cjs,
                          clades, N, ld, use_cf, threshold, threshold_cf, seed,
                          stream);
}

// The same scan without clade sets and clade rows (N <= 2048): outputs
// counts, cis, cjs only.
extern "C" int merge_scan_large_launch(void* d, void* dt, void* dcf,
                                       void* dcft, void* best, void* counts,
                                       void* cis, void* cjs, int N, int ld,
                                       int use_cf, float threshold,
                                       float threshold_cf, int seed,
                                       void* stream) {
    return run_scan<false>(d, dt, dcf, dcft, nullptr, best, counts, cis, cjs,
                           nullptr, N, ld, use_cf, threshold, threshold_cf,
                           seed, stream);
}

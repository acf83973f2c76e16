"""Incremental MinMatch merge scan (2048 < N <= 16384): the CUDA kernel and
the plain version.

Counterpart of ``relate_tpu/ops/merge_scan_inc.py`` (behavioural reference
``MinMatch::Coalesce``, include/src/tree_builder.cpp:1843-2070). The dense
scans of ``merge_scan.py`` reduce over the whole live matrix at every step,
O(N^3) a tree. This one keeps per-row caches, the row minima ``rm`` and
``rmcf`` and one merge candidate a row (score, tie key, partner), and
rescans a row ("repair") only when a merge touched its cached minimum or its
cached partner: amortised O(N) work a step. Row minima of ``d`` only grow
through the scan (a merged column is a convex blend of two live entries), so
the caches can be kept incrementally.

Semantics, those of the JAX package's NumPy twin ``merge_scan_inc_host``,
which differ from the dense scans' in three documented ways:

- the tie key is a static hash of the PAIR (min, max, seed) with no step
  term, because a cached candidate must keep its key;
- the clade-prior row minima follow the reference: ``rmcf`` is refreshed for
  the newly merged row only, the other rows keep their (possibly stale)
  value;
- the merged row and column are both blended from the values before the
  merge (the dense scans blend the column from the updated row).

Otherwise the rule is the same: candidates are pairs mutual within the
thresholds, the score is d[a,b] + d[b,a] (0 where the pair is mutual in
``dcf`` too), the fallback is the global symmetric argmin over the live
pairs, and the merge is weighted by cluster size. Repairs run in ascending
row order.

Which TPU kernel this replaces: ``_make_kernel`` -> ``kernel`` via
``_run_inc`` (``merge_scan_inc.py:248-783``). Its 8-row DMA groups, the
pending column cache with its flush and the padding to a multiple of 128
are TPU mechanics and have no counterpart here: on the card a merged
column is a strided store, so ``csrc/merge_scan_inc.cu`` keeps ``d`` and
its transpose (and ``dcf`` and its transpose) and writes row j and column j
of each directly. A step is one thread-block cluster of 8 blocks, each
owning an eighth of the columns and their state in shared memory; the
repairs stay one after the other, each a pass over rows fetched ahead into
shared memory and one exchange of the blocks' best candidates through
distributed shared memory. Matrix entries written by one block are read by
another inside the launch, so the kernel reads the matrices through L2 only.
What bounds it on the card: the latency of a chain of N-1 dependent steps,
each a cluster barrier a repair plus a few a step; see the source.

``merge_scan_inc_plain`` is the same scan in PyTorch ops on the device of
``d``. A CUDA tensor goes to the kernel or raises; only a CPU tensor takes
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .merge_scan import (INF, MAX_N_INC, _check_inputs, clades_from_merges,
                         launches)

_M32 = 0xFFFFFFFF


def _tie_hash(lo: torch.Tensor, hi: torch.Tensor, seed: int):
    """Static per-pair tie-break hash -> float32 in [0, 2^23): 32-bit
    wrap-around arithmetic done in int64 and masked (logical shifts by
    construction). ``lo``/``hi`` int64 tensors below 2^15."""
    h = (lo * 2654435769 + hi * 2246822507) & _M32
    h = h ^ ((int(seed) * 747796405) & _M32)
    h = h ^ (h >> 15)
    h = (h * 739213477) & _M32
    h = h ^ (h >> 12)
    return (h & 0x7FFFFF).to(torch.float32)


def merge_scan_inc_plain(d, dcf, use_cf, threshold, threshold_cf, seed,
                         counts: Optional[dict] = None):
    """The incremental scan step by step in PyTorch, on the device of ``d``,
    float32 throughout: the merge lists of ``merge_scan_inc_host``.

    d, dcf: (N, N) float32, not modified. Returns (cis, cjs) (N-1,) int32 in
    node-id space (leaves 0..N-1, the cluster born at step t is N+t).
    ``counts``, if given, receives ``repairs`` (rows rescanned after the
    set-up), ``fallback_steps`` and ``fallback_entries`` (the live rows times
    the live columns of ``d``, summed over the fallback steps: what their
    argmin had to look at).

    Every blend is two products and a sum, each rounded to float32 (no fused
    multiply-add): one rounding can flip a merge and every later step.
    """
    N = d.shape[0]
    dev = d.device
    d = d.to(torch.float32).clone()
    dcf = dcf.to(torch.float32).clone()
    use_cf = bool(use_cf)
    seed = int(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    thr = torch.tensor(float(threshold), **f32)
    thrcf = torch.tensor(float(threshold_cf), **f32)
    inf = torch.tensor(INF, **f32)
    zero = torch.zeros((), **f32)
    lanes = torch.arange(N, device=dev, dtype=torch.int64)
    no_lane = torch.full((), N, dtype=torch.int64, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    sizes = [1.0] * N           # small integers, exact in float32
    conv = list(range(N))

    def row_min(mat, a):
        return torch.where(active & (lanes != a), mat[a], inf).min()

    rm = torch.stack([row_min(d, a) for a in range(N)])
    rmcf = torch.stack([row_min(dcf, a) for a in range(N)])
    cand_s = torch.full((N,), INF, **f32)
    cand_t = torch.full((N,), INF, **f32)
    cand_p = torch.full((N,), -1, dtype=torch.int64, device=dev)

    def rescan(w, fold):
        """Row w's candidate from a full pass over its partners; with
        ``fold`` every other live row takes w where w improves on its own
        cached candidate."""
        mask = active & (lanes != w)
        dw, dtw = d[w], d[:, w]
        mutual = mask & (dw <= rm[w] + thr) & (dtw <= rm + thr)
        score = dw + dtw
        if use_cf:
            cfm = (dcf[w] <= rmcf[w] + thrcf) & (dcf[:, w] <= rmcf + thrcf)
            score = torch.where(cfm, zero, score)
        eff = torch.where(mutual, score, inf)
        tie = _tie_hash(lanes.clamp(max=w), lanes.clamp(min=w), seed)
        m = eff.min()
        have = m < inf
        t1 = torch.where(eff == m, tie, inf).min()
        p = torch.where((eff == m) & (tie == t1), lanes, no_lane).min()
        cand_s[w] = m
        cand_t[w] = torch.where(have, t1, inf)
        cand_p[w] = torch.where(have, p, -torch.ones_like(p))
        if fold:
            better = mask & ((eff < cand_s)
                             | ((eff == cand_s) & (tie < cand_t)))
            cand_s.copy_(torch.where(better, eff, cand_s))
            cand_t.copy_(torch.where(better, tie, cand_t))
            cand_p.masked_fill_(better, w)

    for w in range(N):
        rescan(w, fold=False)

    tie2 = None                 # the (N, N) tie keys, made if a step falls back
    cis, cjs = [], []
    n_repairs = n_fallback = n_fallback_entries = 0
    for t in range(N - 1):
        ok = active & (cand_s < inf)
        m = torch.where(ok, cand_s, inf).min()
        t1 = torch.where(ok & (cand_s == m), cand_t, inf).min()
        a = torch.where(ok & (cand_s == m) & (cand_t == t1), lanes,
                        no_lane).min()
        a = int(a)
        if a < N:
            b = int(cand_p[a])
        else:
            # no row has a candidate: the global symmetric argmin over the
            # live pairs, ties by the pair hash and then the least flat index
            n_fallback += 1
            n_fallback_entries += (N - t) ** 2
            if tie2 is None:
                tie2 = _tie_hash(torch.minimum(lanes[:, None], lanes[None, :]),
                                 torch.maximum(lanes[:, None], lanes[None, :]),
                                 seed)
            mask2 = (active[:, None] & active[None, :]
                     & (lanes[:, None] != lanes[None, :]))
            eff2 = torch.where(mask2, d + d.t(), inf)
            tsel = torch.where(eff2 == eff2.min(), tie2, inf)
            flat = torch.where(tsel == tsel.min(),
                               lanes[:, None] * N + lanes[None, :],
                               N * N).min()
            flat = int(flat)
            a, b = flat // N, flat % N
        i, j = min(a, b), max(a, b)
        cis.append(conv[i])
        cjs.append(conv[j])

        si = torch.tensor(sizes[i], **f32)
        sj = torch.tensor(sizes[j], **f32)
        w = si / (si + sj)
        w1 = 1.0 - w
        # everything is read before anything is written: the new column is
        # blended from the old columns
        ci_d, cj_d = d[:, i].clone(), d[:, j].clone()
        nrow = w * d[i] + w1 * d[j]
        ncol = w * ci_d + w1 * cj_d
        nrow_cf = w * dcf[i] + w1 * dcf[j]
        ncol_cf = w * dcf[:, i] + w1 * dcf[:, j]

        # rows whose cached minimum sat in column i or j need a rescan; the
        # others can only have grown past a minimum that still stands
        others = active & (lanes != i) & (lanes != j)
        hit = others & ((ci_d == rm) | (cj_d == rm))
        rm.copy_(torch.where(others & ~hit, torch.minimum(rm, ncol), rm))
        dirty = (active & ((cand_p == i) | (cand_p == j))) | hit
        dirty[j] = True
        dirty[i] = False

        d[j, :] = nrow
        d[:, j] = ncol          # the column write wins on the diagonal
        dcf[j, :] = nrow_cf
        dcf[:, j] = ncol_cf
        active[i] = False
        cand_s[i] = INF
        sizes[j] = sizes[i] + sizes[j]
        conv[j] = N + t

        rows = torch.nonzero(dirty & active).flatten()
        for w_, was_hit in zip(rows.tolist(), hit[rows].tolist()):
            if was_hit or w_ == j:
                rm[w_] = row_min(d, w_)
            if w_ == j:
                # the reference's clade-prior minima: only row j is
                # refreshed, the other rows keep their stale value
                rmcf[j] = row_min(dcf, j)
            rescan(w_, fold=True)
            n_repairs += 1

    if counts is not None:
        counts.update(repairs=n_repairs, fallback_steps=n_fallback,
                      fallback_entries=n_fallback_entries)
    return (torch.tensor(cis, dtype=torch.int32, device=dev),
            torch.tensor(cjs, dtype=torch.int32, device=dev))


def _fns():
    lib = _build.load("merge_scan_inc")
    fn = lib.merge_scan_inc_launch
    # d, dt, dcf, dcft, fstate, istate, cis, cjs
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.merge_scan_inc_scratch
    scratch.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_longlong)] * 3
    scratch.restype = None
    return fn, scratch


def cluster_config(N: int, device=None) -> dict:
    """The step kernel's launch configuration at width N on the card:
    blocks a cluster, threads a block, dynamic shared bytes a block and
    ``cudaOccupancyMaxActiveClusters``. Raises if the card refuses the
    shared memory or cannot hold one cluster."""
    lib = _build.load("merge_scan_inc")
    fn = lib.merge_scan_inc_cluster
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else "cuda"):
        err = fn(int(N), info)
    _build.check(err, "merge_scan_inc (cluster configuration)")
    return dict(blocks_per_cluster=info[0], threads_per_block=info[1],
                dynamic_shared_bytes=info[2], max_active_clusters=info[3])


def _launch(d, dcf, use_cf, threshold, threshold_cf, seed):
    """Enqueue one scan on the card of ``d``. Returns cis, cjs and the
    kernel's four counters (repairs, fallback steps, low and high word of
    the fallback steps' live entries), all on the card."""
    N = d.shape[0]
    dev = d.device
    fn, scratch = _fns()
    n_float, n_int, at = (ctypes.c_longlong() for _ in range(3))
    scratch(N, ctypes.byref(n_float), ctypes.byref(n_int), ctypes.byref(at))
    # working copies, updated in place by the kernel; the transposes make
    # the column reads of a merge and of a rescan contiguous
    dw, dtw = d.clone(), d.t().contiguous()
    cw, ctw = dcf.clone(), dcf.t().contiguous()
    fstate = torch.empty(n_float.value, dtype=torch.float32, device=dev)
    istate = torch.empty(n_int.value, dtype=torch.int32, device=dev)
    cis = torch.empty(N - 1, dtype=torch.int32, device=dev)
    cjs = torch.empty(N - 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        st = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (dw, dtw, cw, ctw, fstate, istate, cis, cjs)),
                 N, 1 if use_cf else 0, float(threshold),
                 float(threshold_cf), int(seed), st)
    _build.check(err, "merge_scan_inc")
    _build.count_launch(launches, "merge_scan_inc", dev)
    return cis, cjs, istate[at.value:at.value + 4]


def merge_scan_inc_lists(d, dcf, use_cf, threshold, threshold_cf, seed,
                         counts: Optional[dict] = None):
    """The incremental scan's merge lists (cis, cjs (N-1,) int32), for any
    2 <= N <= ``MAX_N_INC``. A CUDA tensor goes to the kernel, a CPU tensor
    to the plain version. ``counts``, if given, receives ``repairs``,
    ``fallback_steps`` and ``fallback_entries`` as the plain version counts
    them (on the card this waits for the scan to end)."""
    _check_inputs(d, dcf, MAX_N_INC)
    if d.device.type == "cpu":
        return merge_scan_inc_plain(d, dcf, use_cf, threshold, threshold_cf,
                                    seed, counts)
    cis, cjs, stats = _launch(d, dcf, use_cf, threshold, threshold_cf, seed)
    if counts is not None:
        repairs, fallback, lo, hi = stats.tolist()
        counts.update(repairs=repairs, fallback_steps=fallback,
                      fallback_entries=((hi & _M32) << 32) | (lo & _M32))
    return cis, cjs


def merge_scan_incremental(d, dcf, use_cf, threshold, threshold_cf, seed):
    """Drop-in for ``merge_scan`` at large N (replaces
    ``merge_scan_incremental`` of the JAX package): returns (cis, cjs
    (N-1,) int32, clades (N-1, N) float32), the clade rows rebuilt from the
    merge lists by ``clades_from_merges``."""
    N = d.shape[0]
    cis, cjs = merge_scan_inc_lists(d, dcf, use_cf, threshold, threshold_cf,
                                    seed)
    return cis, cjs, clades_from_merges(cis, cjs, N)

"""MinMatch merge scan: the dense CUDA kernel (N <= 2048), its plain
version, and the route to the incremental scan above that.

Counterpart of ``relate_tpu/ops/merge_scan.py`` (behavioural reference
``include/src/tree_builder.cpp``). The scan runs N-1 sequential steps on a
NON-symmetric distance matrix ``d`` and the clade-consistency matrix
``dcf``: masked row minima plus a threshold, mutual-minimum candidates, a
score of 0 where the pair is mutual in ``dcf`` too, a fallback to the global
symmetric argmin when no pair is mutual, ties broken by an integer hash of
(min, max, seed, step) and then by the smallest flat index, and a
size-weighted merge of row j and then column j.

Which TPU kernels this replaces: ``_kernel`` (``merge_scan.py:46``, N <=
``MAX_N_SMALL``: merge lists and clade rows) and ``_kernel_large``
(``merge_scan.py:164``, ``MAX_N_SMALL`` < N <= ``MAX_N_LARGE``: merge lists
only, the clade rows rebuilt outside by ``clades_from_merges``).

Design (``csrc/merge_scan.cu``): one persistent kernel a scan, launched
cooperatively on ceil(N / 16) blocks, one warp a row, that loops over the
steps itself. Each live row keeps its step state in its block's shared
memory: its minima of ``d`` and ``dcf`` with the number of live columns
that hold them, and its near set (the columns within the row's band, up to
``near_cap()`` of them). After a merge a row updates that state from the two
entries the merge changed; it is passed in full only when no column holds
its minimum any more or its near set overflows. A step is two phases and
two grid barriers: in the first, every block reduces the candidates of the
last step to the same pair, blends its slice of row j, and the owners
update their rows; in the second, each block tests its rows' near sets and
writes its best mutual candidate. The symmetric fallback runs only in the
steps where no pair is mutual, with one more barrier. The working copies
are padded with INF to rows of a multiple of 4 floats, so that a pass over
a row is one 16-byte load a thread. The kernel counts its steps, rows
updated in place, rescans and fallback steps; the next launch, or the end
of a BuildTopology section, adds them to the stage record open at the
launch once their copy has reached the host (``read_counts``), and
``merge_scan_counts`` is the same bookkeeping in NumPy, which the card's
counters must match. The entries that the sequential merge updates twice
(row j, then column j) lie in the dead row or column i or on the diagonal,
which are masked from then on, so the owners can blend row j and column j
at once and the lists stay those of ``merge_scan_plain``.

Sizes above ``MAX_N_LARGE``, up to ``MAX_N_INC``, go to the incremental scan
of ``merge_scan_inc.py`` (amortised O(N) work a step in place of O(N^2); its
tie hash has no step term and its clade-prior row minima are the reference's
stale ones, so its lists are its own). Larger sizes raise ``ValueError``.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..utils.trace import carry, count, open_record, span
from . import _build

INF = 3.0e38   # a large finite float32, not infinity (as the JAX kernel)
MAX_N_SMALL = 1024   # up to here the kernel that also emits the clade rows
MAX_N_LARGE = 2048   # up to here the kernel without clade state
MAX_N_INC = 16384    # up to here the incremental scan (merge_scan_inc.py)

launches = {"merge_scan": 0, "merge_scan_large": 0, "merge_scan_inc": 0}

_M32 = 0xFFFFFFFF
_U32 = np.uint64(_M32)


def _tie_pairs(lo: torch.Tensor, hi: torch.Tensor):
    """The per-pair term of the tie-break hash (the same at every step)."""
    return (lo * 2654435769 + hi * 2246822507) & _M32


def _tie_hash(seed: int, t: int, pairs: torch.Tensor):
    """Symmetric per-step tie-break hash of ``pairs = _tie_pairs(min, max)``,
    32-bit wrap-around arithmetic done in int64 and masked (logical shifts
    by construction)."""
    h = pairs ^ ((seed * 747796405 + t * 374761393) & _M32)
    h = h ^ (h >> 15)
    h = (h * 739213477) & _M32
    h = h ^ (h >> 12)
    return (h & 0x7FFFFF).to(torch.float32)


def merge_scan_plain(d, dcf, use_cf, threshold, threshold_cf, seed,
                     with_clades: bool = True):
    """The scan step by step in PyTorch, on the device of ``d``.

    d, dcf: (N, N) float32. Returns (cis (N-1,) int32, cjs (N-1,) int32,
    clades (N-1, N) float32), or the two merge lists alone with
    ``with_clades=False`` (the plain version of the large kernel, which
    keeps no clade state). Node ids: [0, N) leaves, N+t the cluster born at
    step t.
    """
    N = d.shape[0]
    dev = d.device
    d = d.to(torch.float32).clone()
    dcf = dcf.to(torch.float32).clone()
    use_cf = bool(use_cf)
    seed = int(seed)
    thr = torch.tensor(float(threshold), dtype=torch.float32, device=dev)
    thr_cf = torch.tensor(float(threshold_cf), dtype=torch.float32, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    ids = torch.arange(N, device=dev, dtype=torch.int64)
    row_ids, col_ids = ids[:, None], ids[None, :]
    pairs = _tie_pairs(torch.minimum(row_ids, col_ids),
                       torch.maximum(row_ids, col_ids))
    offdiag = row_ids != col_ids
    flat_ids = row_ids * N + col_ids
    active = torch.ones(N, dtype=torch.bool, device=dev)
    sizes = [1.0] * N
    conv = list(range(N))
    cis, cjs = [], []
    if with_clades:
        csets = torch.eye(N, dtype=torch.float32, device=dev)
        clades = torch.empty((N - 1, N), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    for t in range(N - 1):
        mask2 = active[:, None] & active[None, :] & offdiag
        mv = torch.where(mask2, d, inf).min(dim=1).values + thr
        mutual = mask2 & (d <= mv[:, None]) & (d.t() <= mv[None, :])
        sym = d + d.t()
        score = sym
        if use_cf:
            mvcf = torch.where(mask2, dcf, inf).min(dim=1).values + thr_cf
            cfmut = (dcf <= mvcf[:, None]) & (dcf.t() <= mvcf[None, :])
            score = torch.where(cfmut, torch.zeros_like(sym), sym)
        eff_mut = torch.where(mutual, score, inf)
        if bool(eff_mut.min() < inf):
            eff = eff_mut
        else:
            eff = torch.where(mask2, sym, inf)
        tie = _tie_hash(seed, t, pairs)
        m = eff.min()
        tsel = torch.where(eff == m, tie, inf)
        best = tsel.min()
        flat = torch.where(tsel == best, flat_ids,
                           torch.full_like(flat_ids, N * N - 1))
        idx = int(flat.min())
        a, b = idx // N, idx % N
        i, j = min(a, b), max(a, b)
        # float32 weight: sizes are small integers, exact in float32
        w = (one * sizes[i]) / (one * (sizes[i] + sizes[j]))
        w1 = 1.0 - w
        for mat in (d, dcf):
            mat[j, :] = w * mat[i, :] + w1 * mat[j, :]
            # the column update reads the updated row j
            mat[:, j] = w * mat[:, i] + w1 * mat[:, j]
        if with_clades:
            clade = csets[i] + csets[j]
            csets[j] = clade
            clades[t] = clade
        cis.append(conv[i])
        cjs.append(conv[j])
        sizes[j] = sizes[i] + sizes[j]
        conv[j] = N + t
        active[i] = False
    cis = torch.tensor(cis, dtype=torch.int32, device=dev)
    cjs = torch.tensor(cjs, dtype=torch.int32, device=dev)
    return (cis, cjs, clades) if with_clades else (cis, cjs)


def _tie_np(lo, hi, seed: int, t: int):
    """``_tie_hash`` of the pairs (lo, hi) in NumPy."""
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    h = (lo * np.uint64(2654435769) + hi * np.uint64(2246822507)) & _U32
    h ^= np.uint64((seed * 747796405 + t * 374761393) & _M32)
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(739213477)) & _U32
    h ^= h >> np.uint64(12)
    return (h & np.uint64(0x7FFFFF)).astype(np.float32)


def _best_pair(score, lo, hi, seed: int, t: int, N: int):
    """The pair of least (score, tie key, lo * N + hi)."""
    k = score == score.min()
    lo, hi = lo[k], hi[k]
    tie = _tie_np(lo, hi, seed, t)
    k = tie == tie.min()
    flat = lo[k] * N + hi[k]
    f = int(flat.min())
    return f // N, f % N


def merge_scan_counts(d, dcf, use_cf, threshold, threshold_cf, seed,
                      cap: int | None = None, check: bool = False):
    """The dense kernels' step state in NumPy: the merge lists they give and
    what their four counters read.

    Each live row keeps its minimum of ``d`` (and of ``dcf`` with the clade
    prior) with the number of live columns that hold it, and its near set,
    the columns b with d[a][b] <= mv[a], while it holds at most ``cap`` of
    them ("over" otherwise; ``cap`` defaults to the kernels' ``near_cap()``).
    After the merge (i, j) a row r other than i, j drops its entries (r, i),
    (r, j) from its minimum and takes the blend (r, j) in; only when no column holds the minimum any more and the blend
    lies above it is the row passed in full ("rescan"). The row born at a
    merge takes its minima and its near set from the blend of its slices,
    and is left out of the next pair test: each of its mutual pairs lies in
    its partner's near set. A pair test reads the near sets and passes each
    over row in full (a rescan too); the symmetric fallback runs only in the
    steps where no pair is mutual.

    Returns (cis, cjs, counts): the merge lists as ``merge_scan_plain``'s,
    and ``steps``, ``row_updates`` (rows whose minima were updated in place),
    ``row_rescans`` (full passes after the first step's) and
    ``fallback_steps``. With ``check`` every step holds the kept minima,
    their counts and the near sets against a full pass over the matrix.
    """
    if cap is None:
        cap = near_cap()
    f32 = np.float32
    d = np.array(d, dtype=f32)
    dcf = np.array(dcf, dtype=f32)
    N = d.shape[0]
    seed = int(seed)
    mats = [d, dcf] if use_cf else [d]
    thr, thr_cf = f32(threshold), f32(threshold_cf)
    inf = f32(INF)
    live = np.ones(N, dtype=bool)
    sizes = np.ones(N, dtype=f32)
    conv = list(range(N))
    m = np.zeros((len(mats), N), dtype=f32)
    cnt = np.zeros((len(mats), N), dtype=np.int64)
    near = np.zeros((N, N), dtype=bool)
    over = np.zeros(N, dtype=bool)
    counts = dict(steps=0, row_updates=0, row_rescans=0, fallback_steps=0)

    def others(r):
        mask = live.copy()
        mask[r] = False
        return mask

    def exact_near(r):
        return others(r) & (d[r] <= m[0, r] + thr)

    def keep_near(r, nr):
        over[r] = int(nr.sum()) > cap
        near[r] = nr & ~over[r]

    def full_pass(r):
        mask = others(r)
        for k, mat in enumerate(mats):
            row = mat[r][mask]
            m[k, r] = row.min()
            cnt[k, r] = int((row == m[k, r]).sum())
        keep_near(r, exact_near(r))

    for r in range(N):
        full_pass(r)
    born = -1
    cis, cjs = [], []
    for t in range(N - 1):
        if check:
            for r in np.nonzero(live)[0]:
                mask = others(r)
                for k, mat in enumerate(mats):
                    row = mat[r][mask]
                    assert m[k, r] == row.min(), (t, r, k)
                    assert cnt[k, r] == int((row == row.min()).sum()), (t, r)
                if not over[r]:
                    assert np.array_equal(near[r], exact_near(r)), (t, r)
        # the pair test: near sets, and over rows in full
        mv = m[0] + thr
        cand = near & live[:, None]
        for a in np.nonzero(live & over)[0]:
            if a == born:
                continue
            counts["row_rescans"] += 1
            cand[a] = exact_near(a)
            keep_near(a, cand[a])
        if born >= 0:
            cand[born] = False
        A, B = np.nonzero(cand)
        mut = d[B, A] <= mv[B]
        A, B = A[mut], B[mut]
        score = d[A, B] + d[B, A]
        if use_cf:
            mvcf = m[1] + thr_cf
            zero = (dcf[A, B] <= mvcf[A]) & (dcf[B, A] <= mvcf[B])
            score = np.where(zero, f32(0.0), score)
        if len(score) and score.min() < inf:
            a, b = _best_pair(score, np.minimum(A, B), np.maximum(A, B),
                              seed, t, N)
        else:
            counts["fallback_steps"] += 1
            L = np.nonzero(live)[0]
            A, B = np.triu_indices(len(L), 1)
            A, B = L[A], L[B]
            a, b = _best_pair(d[A, B] + d[B, A], A, B, seed, t, N)
        i, j = min(a, b), max(a, b)
        counts["steps"] += 1
        cis.append(conv[i])
        cjs.append(conv[j])
        # the merge, as merge_scan_plain's: row j, then column j
        w = sizes[i] / (sizes[i] + sizes[j])
        w1 = f32(1.0) - w
        old = [(mat[:, i].copy(), mat[:, j].copy()) for mat in mats]
        for mat in mats:
            mat[j, :] = w * mat[i, :] + w1 * mat[j, :]
            mat[:, j] = w * mat[:, i] + w1 * mat[:, j]
        sizes[j] = sizes[i] + sizes[j]
        conv[j] = N + t
        live[i] = False
        if t == N - 2:
            break
        # every other live row: its minima in place, or a rescan
        R = np.nonzero(live)[0]
        R = R[R != j]
        ok = np.ones(len(R), dtype=bool)
        new = []
        for k, mat in enumerate(mats):
            mk, ck, nd = m[k, R], cnt[k, R], mat[R, j]
            c2 = ck - (old[k][0][R] == mk) - (old[k][1][R] == mk)
            ok &= (c2 > 0) | (nd <= mk)
            new.append((np.where(nd < mk, nd, mk),
                        np.where(nd < mk, 1, np.where(nd == mk, c2 + 1, c2))))
        mv_old = m[0, R] + thr
        for k, (mk, ck) in enumerate(new):
            m[k, R] = np.where(ok, mk, m[k, R])
            cnt[k, R] = np.where(ok, ck, cnt[k, R])
        counts["row_updates"] += int(ok.sum())
        for r, mvo in zip(R[ok], mv_old[ok]):
            if over[r]:
                continue
            mvr = m[0, r] + thr
            near[r, i] = False
            near[r, j] = d[r, j] <= mvr
            if mvr < mvo:
                near[r] &= d[r] <= mvr
            keep_near(r, near[r])
        for r in R[~ok]:
            counts["row_rescans"] += 1
            full_pass(r)
        # the row born at this merge, from its slices
        full_pass(j)
        born = j
    return (np.asarray(cis, dtype=np.int32), np.asarray(cjs, dtype=np.int32),
            counts)


def clades_from_merges(cis, cjs, N: int):
    """(N-1, N) clade leaf-indicator rows from the merge lists. Node ids:
    [0, N) leaves, N+t the cluster born at step t.

    Every leaf walks up its chain of ancestors, all leaves at once: one
    round (a gather and a scatter of N elements, one ``any()`` download) per
    level of the tree, not one launch per merge. Each download is a
    ``merge_scan.readback`` span and counts under ``merge_scan.readbacks``
    (``utils.trace``): the first waits for the scan. The rows are exact 0/1
    values, as the sums of disjoint indicator rows are."""
    dev = cis.device
    born = torch.arange(N, 2 * N - 1, device=dev, dtype=torch.int64)
    parent = torch.full((2 * N - 1,), -1, dtype=torch.int64, device=dev)
    parent[cis.long()] = born
    parent[cjs.long()] = born
    C = torch.zeros((N - 1, N), dtype=torch.float32, device=dev)
    leaf = torch.arange(N, device=dev, dtype=torch.int64)
    anc = parent[:N].clone()
    while True:
        live = anc >= 0
        with span("merge_scan.readback", dev):
            more = bool(live.any())
        count("merge_scan.readbacks")
        if not more:
            return C
        C[anc[live] - N, leaf[live]] = 1.0
        anc = torch.where(live, parent[anc.clamp(min=0)], anc)


def _check_inputs(d, dcf, max_n: int):
    if d.dim() != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"d must be square, got {tuple(d.shape)}")
    N = d.shape[0]
    if N > max_n:
        raise ValueError(f"merge scan supports N <= {max_n} (got {N})")
    if N < 2:
        raise ValueError("merge scan needs N >= 2")
    for name, t in (("d", d), ("dcf", dcf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (N, N):
            raise ValueError(f"{name} must be ({N}, {N})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dcf.device != d.device:
        raise ValueError("d and dcf must be on one device")
    return N


def _fn(large: bool):
    lib = _build.load("merge_scan")
    fn = lib.merge_scan_large_launch if large else lib.merge_scan_launch
    # d, dt, dcf, dcft, [csets,] best, counts, cis, cjs, [clades]
    fn.argtypes = ([ctypes.c_void_p] * (8 if large else 10)
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def near_cap() -> int:
    """The near-set entries a row keeps in the dense kernels (built into
    ``csrc/merge_scan.cu``; loading it builds the library)."""
    fn = _build.load("merge_scan").merge_scan_near_cap
    fn.restype = ctypes.c_int
    return int(fn())


def grid_config(N: int, large: bool, device=None) -> dict:
    """The scan's launch configuration at width N on the card: blocks,
    blocks a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads
    a block, dynamic shared bytes a block and SMs. Raises if the card cannot
    hold the grid."""
    fn = _build.load("merge_scan").merge_scan_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(device if device is not None else "cuda"):
        err = fn(int(N), 0 if large else 1, info)
    _build.check(err, "merge_scan (grid configuration)")
    return dict(blocks=info[0], blocks_per_sm=info[1],
                threads_per_block=info[2], dynamic_shared_bytes=info[3],
                sms=info[4])


COUNTERS = ("steps", "row_updates", "row_rescans", "fallback_steps")
# scans whose counters are on their way to the host: (event, pinned copy,
# the function that counts them in the stage record open at the launch)
_PENDING: list = []
_PENDING_LOCK = threading.Lock()


def _count_scan(values) -> None:
    for name, v in zip(COUNTERS, values):
        count("merge_scan." + name, int(v))


def read_counts() -> None:
    """Count the counters of every scan whose copy has reached the host as
    ``merge_scan.steps``, ``.row_updates``, ``.row_rescans`` and
    ``.fallback_steps`` in the stage record that was open at its launch.
    Waits for nothing: called after a read that waited for the card, it
    finds every earlier scan's copy done."""
    done, wait = [], []
    with _PENDING_LOCK:
        for e in _PENDING:
            (done if e[0].query() else wait).append(e)
        _PENDING[:] = wait
    for _, host, add in done:
        add(host.tolist())


def _launch(d, dcf, use_cf, threshold, threshold_cf, seed, large: bool):
    """Enqueue one scan on the card of ``d`` (one cooperative launch): the
    kernel with the clade rows (returns cis, cjs, clades) or, with
    ``large``, the one without (returns cis, cjs). Inside a stage record its
    counters are copied to pinned host memory behind it, for
    ``read_counts``. Raises if the card
    cannot hold the grid."""
    read_counts()
    N = d.shape[0]
    dev = d.device
    lib = _build.load("merge_scan")
    # working copies, updated in place by the kernel, rows padded with INF
    # to a multiple of 4 floats; the transposes make every "column" read of
    # a step contiguous
    ld = (N + 3) // 4 * 4
    work = torch.full((4, N, ld), INF, dtype=torch.float32, device=dev)
    work[0, :, :N] = d
    work[1, :, :N] = d.t()
    if use_cf:
        work[2, :, :N] = dcf
        work[3, :, :N] = dcf.t()
    # scratch: the candidate slots, the grid barrier's counter, the state of
    # the row born at each step and the row minima
    lib.merge_scan_scratch_ints.restype = ctypes.c_longlong
    best = torch.empty(lib.merge_scan_scratch_ints(N), dtype=torch.int32,
                       device=dev)
    counts = torch.empty(len(COUNTERS), dtype=torch.int32, device=dev)
    cis = torch.empty(N - 1, dtype=torch.int32, device=dev)
    cjs = torch.empty(N - 1, dtype=torch.int32, device=dev)
    state = list(work)
    outs = [best, counts, cis, cjs]
    if not large:
        state.append(torch.eye(N, dtype=torch.float32, device=dev))
        outs.append(torch.empty((N - 1, N), dtype=torch.float32, device=dev))
    name = "merge_scan_large" if large else "merge_scan"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = _fn(large)(*(ctypes.c_void_p(t.data_ptr())
                           for t in state + outs),
                         N, ld, 1 if use_cf else 0, float(threshold),
                         float(threshold_cf), int(seed),
                         ctypes.c_void_p(stream.cuda_stream))
        _build.count_launch(launches, name, dev)
        _build.check(err, name)
        if open_record() is None:       # no stage to count the scan in
            return tuple(outs[2:])
        host = torch.empty(len(COUNTERS), dtype=torch.int32, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    with _PENDING_LOCK:
        _PENDING.append((done, host, carry(_count_scan)))
    return tuple(outs[2:])


def merge_scan_large(d, dcf, use_cf, threshold, threshold_cf, seed):
    """The scan without clade state (replaces ``_run_large``): merge lists
    (cis, cjs (N-1,) int32) only, for any 2 <= N <= ``MAX_N_LARGE``. A CUDA
    tensor goes to the kernel, a CPU tensor to the plain version."""
    _check_inputs(d, dcf, MAX_N_LARGE)
    if d.device.type == "cpu":
        return merge_scan_plain(d, dcf, use_cf, threshold, threshold_cf, seed,
                                with_clades=False)
    return _launch(d, dcf, use_cf, threshold, threshold_cf, seed, large=True)


def merge_scan(d, dcf, use_cf, threshold, threshold_cf, seed):
    """MinMatch merge scan (replaces ``merge_scan_pallas``), 2 <= N <=
    ``MAX_N_INC``.

    d, dcf: (N, N) float32 contiguous tensors on one device; neither is
    modified. Returns (cis, cjs (N-1,) int32, clades (N-1, N) float32). Up to
    ``MAX_N_SMALL`` one kernel emits all three; above it the large kernel
    emits the merge lists and ``clades_from_merges`` rebuilds the clades
    (the same lists and clades either way); above ``MAX_N_LARGE`` the
    incremental scan takes over (its own semantics, see its module).
    """
    N = _check_inputs(d, dcf, MAX_N_INC)
    if N > MAX_N_LARGE:
        from .merge_scan_inc import merge_scan_incremental
        return merge_scan_incremental(d, dcf, use_cf, threshold, threshold_cf,
                                      seed)
    if N > MAX_N_SMALL:
        cis, cjs = merge_scan_large(d, dcf, use_cf, threshold, threshold_cf,
                                    seed)
        return cis, cjs, clades_from_merges(cis, cjs, N)
    if d.device.type == "cpu":
        return merge_scan_plain(d, dcf, use_cf, threshold, threshold_cf, seed)
    return _launch(d, dcf, use_cf, threshold, threshold_cf, seed, large=False)

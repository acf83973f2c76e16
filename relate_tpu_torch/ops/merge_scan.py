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
cooperatively on every block the card holds at once (``grid_config``), that
loops over the steps itself. Each row has one owning warp for the whole
scan. A step is two phases and two grid barriers: in the first, every block
reduces the candidates of the last step to the same pair, blends its slice
of row j, and the owner of every other live row blends that row's column-j
entry and takes the row's minima; in the second, every owner tests its row's
pairs and each block writes its best mutual and symmetric candidate. No
phase runs on a single block. The entries of dead columns and of the
diagonal are kept at INF, the value the plain version masks them with, so
the passes over a row need no mask. What a block reads that another wrote
in the same launch goes through L2. What bounds it: at N = 2048 the four
N x N float32 matrices are 67 MB, more than the 50 MB L2, so the early steps
stream the live rows from device memory; after that, and at N = 1024
(16 MB), the latency of the two grid barriers, the reductions and the round
trips to L2 along a row. The entries that the sequential merge updates
twice (row j, then column j) lie in the dead row or column i or on the
diagonal, which are masked from then on, so the owners can blend row j and
column j at once and the lists stay those of ``merge_scan_plain``.

Sizes above ``MAX_N_LARGE``, up to ``MAX_N_INC``, go to the incremental scan
of ``merge_scan_inc.py`` (amortised O(N) work a step in place of O(N^2); its
tie hash has no step term and its clade-prior row minima are the reference's
stale ones, so its lists are its own). Larger sizes raise ``ValueError``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.trace import count, span
from . import _build

INF = 3.0e38   # a large finite float32, not infinity (as the JAX kernel)
MAX_N_SMALL = 1024   # up to here the kernel that also emits the clade rows
MAX_N_LARGE = 2048   # up to here the kernel without clade state
MAX_N_INC = 16384    # up to here the incremental scan (merge_scan_inc.py)

launches = {"merge_scan": 0, "merge_scan_large": 0, "merge_scan_inc": 0}

_M32 = 0xFFFFFFFF


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
    # d, dt, dcf, dcft, [csets,] mv, mvcf, best, cis, cjs, [clades]
    fn.argtypes = ([ctypes.c_void_p] * (9 if large else 11)
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def grid_config(N: int, large: bool, device=None) -> dict:
    """The scan's launch configuration at width N on the card: blocks,
    blocks a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads
    a block, dynamic shared bytes a block and SMs. Raises if not one block
    fits."""
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


def _launch(d, dcf, use_cf, threshold, threshold_cf, seed, large: bool):
    """Enqueue one scan on the card of ``d`` (one cooperative launch): the
    kernel with the clade rows (returns cis, cjs, clades) or, with
    ``large``, the one without (returns cis, cjs). Raises if the card cannot
    hold the grid."""
    N = d.shape[0]
    dev = d.device
    # working copies, updated in place by the kernel; the transposes make
    # every "column" read of a step contiguous
    dw, dtw = d.clone(), d.t().contiguous()
    cw, ctw = dcf.clone(), dcf.t().contiguous()
    # scratch: the row minima; two slots of 16-byte candidates a block
    # (blocks <= N), the grid barrier's counter and row j's minima
    mv = torch.empty(N, dtype=torch.float32, device=dev)
    mvcf = torch.empty(N, dtype=torch.float32, device=dev)
    best = torch.empty(8 * N + 8, dtype=torch.int32, device=dev)
    cis = torch.empty(N - 1, dtype=torch.int32, device=dev)
    cjs = torch.empty(N - 1, dtype=torch.int32, device=dev)
    state = [dw, dtw, cw, ctw]
    outs = [mv, mvcf, best, cis, cjs]
    if not large:
        state.append(torch.eye(N, dtype=torch.float32, device=dev))
        outs.append(torch.empty((N - 1, N), dtype=torch.float32, device=dev))
    name = "merge_scan_large" if large else "merge_scan"
    with torch.cuda.device(dev):
        st = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = _fn(large)(*(ctypes.c_void_p(t.data_ptr())
                           for t in state + outs),
                         N, 1 if use_cf else 0, float(threshold),
                         float(threshold_cf), int(seed), st)
    _build.count_launch(launches, name, dev)
    _build.check(err, name)
    return tuple(outs[3:])


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

"""MinMatch merge scan: CUDA kernel (N <= 1024) and its plain version.

Counterpart of ``relate_tpu/ops/merge_scan.py`` (behavioural reference
``include/src/tree_builder.cpp``). The scan runs N-1 sequential steps on a
NON-symmetric distance matrix ``d`` and the clade-consistency matrix
``dcf``: masked row minima plus a threshold, mutual-minimum candidates, a
score of 0 where the pair is mutual in ``dcf`` too, a fallback to the global
symmetric argmin when no pair is mutual, ties broken by an integer hash of
(min, max, seed, step) and then by the smallest flat index, and a
size-weighted merge of row j and then column j.

Which TPU kernel this replaces: ``_kernel`` (``merge_scan.py:46``). What
bounds it on the card: the latency of a chain of N-1 dependent steps, each
of which reduces over the whole live matrix; the bytes (four N x N float32
matrices, 16 MB at N = 1024) stay in the L2 cache. What the design does
about it: ``csrc/merge_scan.cu`` enqueues three small launches per step from
one C call, with the chosen pair kept on the card, so the host never waits
inside the scan.

Sizes above 1024 are the routes of the two TPU kernels that are not ported
yet (``_kernel_large`` for N <= 2048, the incremental kernel of
``merge_scan_inc.py`` above) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

INF = 3.0e38   # a large finite float32, not infinity (as the JAX kernel)
MAX_N = 1024

launches = {"merge_scan": 0}

_M32 = 0xFFFFFFFF


def _tie_hash(seed: int, t: int, lo: torch.Tensor, hi: torch.Tensor):
    """Symmetric per-step tie-break hash, 32-bit wrap-around arithmetic done
    in int64 and masked (logical shifts by construction)."""
    h = (lo * 2654435769 + hi * 2246822507) & _M32
    h = h ^ ((seed * 747796405 + t * 374761393) & _M32)
    h = h ^ (h >> 15)
    h = (h * 739213477) & _M32
    h = h ^ (h >> 12)
    return (h & 0x7FFFFF).to(torch.float32)


def merge_scan_plain(d, dcf, use_cf, threshold, threshold_cf, seed):
    """The scan step by step in PyTorch, on the device of ``d``.

    d, dcf: (N, N) float32. Returns (cis (N-1,) int32, cjs (N-1,) int32,
    clades (N-1, N) float32). Node ids: [0, N) leaves, N+t the cluster born
    at step t.
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
    lo = torch.minimum(row_ids, col_ids)
    hi = torch.maximum(row_ids, col_ids)
    offdiag = row_ids != col_ids
    flat_ids = row_ids * N + col_ids
    active = torch.ones(N, dtype=torch.bool, device=dev)
    sizes = [1.0] * N
    conv = list(range(N))
    csets = torch.eye(N, dtype=torch.float32, device=dev)
    cis, cjs = [], []
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
        tie = _tie_hash(seed, t, lo, hi)
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
        clade = csets[i] + csets[j]
        csets[j] = clade
        clades[t] = clade
        cis.append(conv[i])
        cjs.append(conv[j])
        sizes[j] = sizes[i] + sizes[j]
        conv[j] = N + t
        active[i] = False
    return (torch.tensor(cis, dtype=torch.int32, device=dev),
            torch.tensor(cjs, dtype=torch.int32, device=dev), clades)


def clades_from_merges(cis, cjs, N: int):
    """(N-1, N) clade leaf-indicator rows from the merge lists. Node ids:
    [0, N) leaves, N+t the cluster born at step t."""
    dev = cis.device
    C = torch.cat([torch.eye(N, dtype=torch.float32, device=dev),
                   torch.zeros((N - 1, N), dtype=torch.float32, device=dev)])
    ci = cis.tolist()
    cj = cjs.tolist()
    for t in range(N - 1):
        C[N + t] = C[ci[t]] + C[cj[t]]
    return C[N:]


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_void_p]


def _fn():
    fn = _build.load("merge_scan").merge_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def merge_scan(d, dcf, use_cf, threshold, threshold_cf, seed):
    """MinMatch merge scan (replaces ``merge_scan_pallas`` for N <= 1024).

    d, dcf: (N, N) float32 contiguous tensors on one device; neither is
    modified. Returns (cis, cjs (N-1,) int32, clades (N-1, N) float32).
    """
    if d.dim() != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"d must be square, got {tuple(d.shape)}")
    N = d.shape[0]
    if N > MAX_N:
        raise NotImplementedError(
            f"merge scan for N = {N} > {MAX_N}: the routes of the TPU kernels "
            "B6 (_kernel_large, N <= 2048) and B7 (the incremental kernel of "
            "merge_scan_inc.py) are not ported yet")
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
    if d.device.type == "cpu":
        return merge_scan_plain(d, dcf, use_cf, threshold, threshold_cf, seed)

    dev = d.device
    # working copies, updated in place by the kernel; the transposes make
    # every "column" read of a step contiguous
    dw, dtw = d.clone(), d.t().contiguous()
    cw, ctw = dcf.clone(), dcf.t().contiguous()
    active = torch.ones(N, dtype=torch.int32, device=dev)
    sizes = torch.ones(N, dtype=torch.float32, device=dev)
    conv = torch.arange(N, dtype=torch.int32, device=dev)
    csets = torch.eye(N, dtype=torch.float32, device=dev)
    mv = torch.empty(N, dtype=torch.float32, device=dev)
    mvcf = torch.empty(N, dtype=torch.float32, device=dev)
    best = torch.empty(2 * N * 3, dtype=torch.int32, device=dev)
    cis = torch.empty(N - 1, dtype=torch.int32, device=dev)
    cjs = torch.empty(N - 1, dtype=torch.int32, device=dev)
    clades = torch.empty((N - 1, N), dtype=torch.float32, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        st = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = _fn()(p(dw), p(dtw), p(cw), p(ctw), p(active), p(sizes),
                    p(conv), p(csets), p(mv), p(mvcf), p(best), p(cis),
                    p(cjs), p(clades), N, 1 if use_cf else 0,
                    float(threshold), float(threshold_cf), int(seed), st)
    launches["merge_scan"] += 1
    _build.check(err, "merge_scan")
    return cis, cjs, clades

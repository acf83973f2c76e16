"""MinMatch hierarchical tree building (``MinMatch::QuickBuild``,
``include/src/tree_builder.cpp:1061-1303,2357-2644``) and its priors.

Counterpart of ``relate_tpu/core/treebuilder.py``. Selection per merge step
(N-1 steps) as in that module's docstring: masked row minima plus a
threshold, mutual-minimum candidates, a score of 0 where the pair is mutual
in the clade-consistency matrix ``d_cf`` too, the global symmetric argmin
when no pair is mutual, ties broken by a symmetric draw and then by the
smallest flat index, and a size-weighted merge.

Without sample ages ``quick_build`` is the merge-scan kernel
(``ops/merge_scan.py:merge_scan``: B5, B6 or B7 by N on the card, their
plain versions on the CPU). With sample ages it runs ``quick_build_scan_ages``,
the counterpart of the JAX ``lax.scan`` with its age channel: pairs whose
older sample is above the step's heuristic coalescent age bound
(tree_builder.cpp:1153-1217) get 1e20 added to their score, one step a merge
as PyTorch ops on the device of the matrix. Both break ties with the
kernels' hash of (min, max, seed, step) (``ops/merge_scan.py:_tie_hash``) in
place of the JAX package's threefry draw, so given the same seed they give
the JAX package's merge lists wherever each step has one best candidate.
Reproduced as the JAX module has them: in float32 ``score + 1e20`` is 1e20
for every barred pair, so the tie draw picks among them; the symmetric
fallback ignores the ages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.merge_scan import _tie_hash, _tie_pairs, merge_scan
from ..utils.devmem import resolve_device
from .distance import _assemble_ops
from .trees import Tree

AGE_BARRED = 1e20   # added to the score of a pair older than the age bound


def thresholds(theta: float) -> Tuple[float, float]:
    base = -float(np.log(theta / (1.0 - theta)))
    return 0.2 * base, 0.001 * base


def age_grid(sample_ages: np.ndarray, Ne: float) -> np.ndarray:
    """(N-1,) float64 age bound at each merge step: a forward simulation of
    the coalescent from the youngest samples, adding the next age class's
    lineages when fewer than two remain (tree_builder.cpp:1153-1217)."""
    ages = np.sort(np.asarray(sample_ages, dtype=np.float64))
    N = len(ages)
    uniq, counts = np.unique(ages, return_counts=True)
    grid = np.empty(N - 1, dtype=np.float64)
    level = 0
    num_lins = counts[0]
    cur = uniq[0] + 2.0 / (num_lins * max(num_lins - 1.0, 1.0)) * Ne
    for t in range(N - 1):
        grid[t] = cur
        num_lins = max(num_lins - 1, 1)
        if level + 1 < len(uniq) and num_lins < 2:
            level += 1
            num_lins += counts[level]
        cur += 2.0 / max(num_lins * (num_lins - 1.0), 1.0) * Ne
    return grid


def quick_build_scan_ages(d, dcf, use_cf: bool, threshold: float,
                          threshold_cf: float, seed: int, ages, grid):
    """The N-1 merge steps with the age channel, on the device of ``d``.

    d, dcf: (N, N) float32 (neither is modified; ``dcf`` is read only with
    ``use_cf``); ages: (N,) float32 sample ages; grid: (N-1,) float32 age
    bounds. Returns (cis, cjs) (N-1,) int64 CPU tensors of node ids ([0, N)
    leaves, N+t the cluster born at step t). No step waits for the device:
    the merged pairs are read back once, at the end."""
    N = d.shape[0]
    dev = d.device
    f32 = torch.float32
    # d and dcf stacked, so that one blend merges both
    mats = torch.stack([d, dcf] if use_cf else [d]).to(f32)
    d = mats[0]
    dcf = mats[1] if use_cf else None
    ages = ages.to(f32).clone()
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    barred = torch.tensor(AGE_BARRED, dtype=f32, device=dev)
    thr = torch.tensor(float(threshold), dtype=f32, device=dev)
    thr_cf = torch.tensor(float(threshold_cf), dtype=f32, device=dev)
    ids = torch.arange(N, device=dev, dtype=torch.int64)
    row_ids, col_ids = ids[:, None], ids[None, :]
    pairs = _tie_pairs(torch.minimum(row_ids, col_ids),
                       torch.maximum(row_ids, col_ids))
    flat_ids = row_ids * N + col_ids
    no_flat = torch.full((), N * N, dtype=torch.int64, device=dev)
    mask2 = row_ids != col_ids          # both rows live, off the diagonal
    sizes = torch.ones(N, dtype=f32, device=dev)
    merged = torch.empty((N - 1, 2), dtype=torch.int64, device=dev)
    for t in range(N - 1):
        mv = torch.where(mask2, d, inf).amin(dim=1) + thr
        within = d <= mv[:, None]
        mutual = mask2 & within & within.t()
        sym = d + d.t()
        score = sym
        if use_cf:
            mvcf = torch.where(mask2, dcf, inf).amin(dim=1) + thr_cf
            within_cf = dcf <= mvcf[:, None]
            score = torch.where(within_cf & within_cf.t(), zero, sym)
        # + 1e20 where the older sample of the pair is above the bound
        bar = torch.where(ages <= grid[t], zero, barred)
        score = score + torch.maximum(bar[:, None], bar[None, :])
        # the mutual candidates, or all live pairs by the symmetric sum
        have = mutual.any()
        eff = torch.where(torch.where(have, mutual, mask2),
                          torch.where(have, score, sym), inf)
        tsel = torch.where(eff == eff.amin(), _tie_hash(seed, t, pairs), inf)
        flat = torch.where(tsel == tsel.amin(), flat_ids, no_flat).amin()
        a, b = flat // N, flat % N
        ij = torch.stack([torch.minimum(a, b), torch.maximum(a, b)])
        j = ij[1:]
        s_ij = sizes.index_select(0, ij)
        w = s_ij[0] / s_ij.sum()
        wv = torch.stack([w, 1 - w])
        # w * (row i) + (1 - w) * (row j), rows and columns both from the
        # matrices before the merge, row j set first
        rows = (wv[None, :, None] * mats.index_select(1, ij)).sum(dim=1)
        cols = (wv[None, None, :] * mats.index_select(2, ij)).sum(dim=2)
        mats.index_copy_(1, j, rows[:, None, :])
        mats.index_copy_(2, j, cols[:, :, None])
        merged[t] = ij
        sizes.index_add_(0, j, s_ij[:1])
        mask2.index_fill_(0, ij[:1], False)
        mask2.index_fill_(1, ij[:1], False)
        ages.index_copy_(0, j, ages.index_select(0, ij).amax().view(1))
    conv = np.arange(N)
    cis = np.empty(N - 1, dtype=np.int64)
    cjs = np.empty(N - 1, dtype=np.int64)
    for t, (i, jj) in enumerate(merged.cpu().numpy()):
        cis[t], cjs[t] = conv[i], conv[jj]
        conv[jj] = N + t
    return torch.from_numpy(cis), torch.from_numpy(cjs)


def quick_build(d, d_cf=None, theta: float = 0.001, seed: int = 1,
                sample_ages: Optional[np.ndarray] = None, Ne: float = 3e4,
                device=None) -> Tree:
    """Build one binary tree (2N-1 nodes) from an asymmetric distance matrix
    ``d`` (array or tensor) on ``device`` (None: the CUDA card).

    d_cf: optional consistency-prior matrix from the previous tree's clades
    (anc_builder.cpp:583-608). ``seed`` is the tie-break hash's seed."""
    device = resolve_device(device)
    d = torch.as_tensor(d, dtype=torch.float32).to(device).contiguous()
    N = d.shape[0]
    thr, thr_cf = thresholds(theta)
    use_cf = d_cf is not None
    dcf = torch.as_tensor(d_cf, dtype=torch.float32).to(device).contiguous() \
        if use_cf else torch.zeros_like(d)
    use_ages = sample_ages is not None and len(sample_ages) == N and \
        np.any(np.asarray(sample_ages) != 0)
    if use_ages:
        ages = torch.as_tensor(np.asarray(sample_ages, dtype=np.float32),
                               device=device)
        grid = torch.as_tensor(age_grid(sample_ages, Ne).astype(np.float32),
                               device=device)
        cis, cjs = quick_build_scan_ages(d, dcf, use_cf, thr, thr_cf,
                                         int(seed), ages, grid)
    else:
        cis, cjs, _ = merge_scan(d, dcf, use_cf, thr, thr_cf, int(seed))
    return tree_from_merges(cis.cpu().numpy(), cjs.cpu().numpy(), N)


def tree_from_merges(cis: np.ndarray, cjs: np.ndarray, N: int) -> Tree:
    """Build the flat tree arrays from merge child lists."""
    M = 2 * N - 1
    parent = np.full(M, -1, dtype=np.int32)
    lab = np.arange(N - 1) + N
    parent[cis] = lab
    parent[cjs] = lab
    cl = np.full(M, -1, dtype=np.int32)
    cr = np.full(M, -1, dtype=np.int32)
    cl[N:] = cis
    cr[N:] = cjs
    return Tree(parent=parent, child_left=cl, child_right=cr)


def clade_prior_matrix(prev_tree: Tree, theta: float,
                       device=None) -> torch.Tensor:
    """Consistency prior d_CF from the previous tree's internal clades
    (anc_builder.cpp:583-608), (N, N) float32 on ``device``: for each
    internal clade C and each member i, add val = -log(theta/(1-theta)) to
    d_CF[i, j] for every j not in C. Summed as the JAX module sums it, val
    times the members' rows first."""
    device = resolve_device(device)
    N = prev_tree.N
    val = -float(np.log(theta / (1.0 - theta)))
    member = torch.from_numpy(prev_tree.leaf_matrix()[N:]).to(device).to(
        torch.float32)
    return (val * member.t()) @ (1.0 - member)


def same_rpos_penalty(d: torch.Tensor, carriers_sets,
                      theta: float) -> torch.Tensor:
    """Extra penalty for carriers at SNPs with identical rpos
    (anc_builder.cpp:555-581): for each such SNP's carrier set S, rows of S
    get +val everywhere and then -val toward other members of S (two float32
    roundings, as the JAX module)."""
    val = -float(np.log(theta / (1.0 - theta)))
    out = d.clone()
    for S in carriers_sets:
        S = torch.as_tensor(np.asarray(S, dtype=np.int64), device=d.device)
        if len(S) == 0:
            continue
        out[S, :] += val
        out[S[:, None], S[None, :]] -= val
    return out


def make_fused_rebuild(theta: float, N: int, mode: int,
                       ancestral_state: bool):
    """The rebuild of the host topology builder: distance assembly
    (GetMatrix), symmetrised with an unknown ancestral allele, the same-rpos
    carrier penalty, the clade-consistency prior from the previous tree's
    leaf matrix, then the merge scan. Returns fn(topology, logscale, rows,
    is_exact, wl, wr, kcol, carriers, prev_leafmat, seed) -> (cis, cjs)
    merge lists, on the device of ``topology``."""
    thr, thr_cf = thresholds(theta)
    val = -float(np.log(theta / (1.0 - theta)))
    use_cf = mode == 1

    def fn(topology, logscale, rows, is_exact, wl, wr, kcol, carriers,
           prev_leafmat, seed):
        mat = _assemble_ops(topology, logscale, rows, is_exact, wl, wr, kcol)
        if not ancestral_state:
            mat = 0.5 * (mat + mat.t())
        car = carriers.to(torch.float32)
        mat = mat + val * car[:, None] * (1.0 - car[None, :])
        if use_cf:
            member = prev_leafmat[N:].to(torch.float32)
            dcf = val * (member.t() @ (1.0 - member))
        else:
            dcf = torch.zeros_like(mat)
        cis, cjs, _ = merge_scan(mat.contiguous(), dcf, use_cf, thr, thr_cf,
                                 int(seed))
        return cis, cjs

    return fn


def upgma(d: np.ndarray) -> Tree:
    """UPGMA (average-linkage) tree from a distance matrix
    (MinMatch::UPGMA, include/src/tree_builder.hpp:106: an unused
    alternative builder kept for API completeness). Works on the
    symmetrised matrix; sequential host implementation."""
    dd = 0.5 * (np.asarray(d, dtype=np.float64)
                + np.asarray(d, dtype=np.float64).T)
    N = dd.shape[0]
    M = 2 * N - 1
    parent = np.full(M, -1, np.int32)
    cl = np.full(M, -1, np.int32)
    cr = np.full(M, -1, np.int32)
    bl = np.zeros(M, np.float64)
    height = np.zeros(M, np.float64)
    size = np.ones(M, np.float64)
    D = np.full((M, M), np.inf)
    D[:N, :N] = dd
    np.fill_diagonal(D, np.inf)
    active = list(range(N))
    for t in range(N - 1):
        sub = D[np.ix_(active, active)]
        k = int(np.argmin(sub))
        ai, aj = divmod(k, len(active))
        i, j = active[ai], active[aj]
        v = N + t
        h = 0.5 * D[i, j]
        parent[i] = parent[j] = v
        cl[v], cr[v] = min(i, j), max(i, j)
        height[v] = h
        bl[i] = h - height[i]
        bl[j] = h - height[j]
        size[v] = size[i] + size[j]
        for x in active:
            if x in (i, j):
                continue
            D[v, x] = D[x, v] = ((size[i] * D[i, x] + size[j] * D[j, x])
                                 / (size[i] + size[j]))
        active = [x for x in active if x not in (i, j)] + [v]
    return Tree(parent=parent, child_left=cl, child_right=cr,
                branch_length=bl)

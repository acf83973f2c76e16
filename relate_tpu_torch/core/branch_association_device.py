"""FindEquivalentBranches on the device: leaf matrices, Pearson
correlations and the staged matcher as batched tensor code over adjacent
tree pairs.

Counterpart of ``relate_tpu/core/branch_association_device.py`` (behavioural
reference ``AncesTreeBuilder::BranchAssociation``,
include/src/anc_builder.cpp:1433-1614, and ``Correlation::Pearson``,
include/src/anc.cpp:821-860). The semantics are those of the host matcher
in ``branch_association.py``, whose ``_match_from_corr`` is the oracle: the
equivalence vectors are identical, integer for integer.

No hand-written kernel is involved (the JAX package has none here either):
the leaf indicators come from a walk up the tree with gathers, all pairwise
leaf-set intersections of a pair are one ``(M, N) @ (N, M)`` product, and
the three matching stages are masks and scatter-max. The reference's
best-score-first greedy assignment of approximate matches is computed
exactly by iterated locally-dominant locking (see ``_match_pairs``), a short
data-dependent loop with one ``any()`` download per round.

Per pair only the (M,) equivalence vector leaves the device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.devmem import resolve_device
from ..utils.trace import note
from .branch_association import EXACT, THRESHOLD_BRANCHEQ, _count_compat_table
from .trees import Tree

MAX_PAIR_CHUNK = 256


def _leafmats(parent: torch.Tensor, N: int) -> torch.Tensor:
    """(T, M) int64 parent arrays -> (T, M, N) float32 leaf indicators
    (``Tree.leaf_matrix`` of every tree).

    Every leaf walks up its chain of ancestors, all leaves of all trees at
    once: one gather and one scatter of T*N elements per level of the tallest
    tree. (The JAX package log-squares a (T, M, M) adjacency matrix because
    gathers are slow on a TPU; both give the same 0/1 matrix.)"""
    T, M = parent.shape
    dev = parent.device
    L = torch.zeros((T, M, N), dtype=torch.float32, device=dev)
    leaf = torch.arange(N, device=dev)
    L[:, leaf, leaf] = 1.0
    tree = torch.arange(T, device=dev)[:, None].expand(T, N)
    leaf = leaf[None, :].expand(T, N)
    anc = parent[:, :N]
    while True:
        live = anc >= 0
        if not bool(live.any()):
            return L
        L[tree[live], anc[live], leaf[live]] = 1.0
        anc = torch.where(live, torch.gather(parent, 1, anc.clamp(min=0)),
                          anc)


def _pearson_device(prod, n1, n2, N: int):
    """Tensor twin of ``branch_association._pearson_from_products``, batched:
    prod (P, M, M) exact intersection counts, n1/n2 (P, M) clade sizes, all
    float32. Same operations in the same order as the host function, each
    rounded as IEEE float32 rounds it, so that a correlation lands on the
    same side of a threshold as the host matcher's: N is a tensor (a
    division by a Python number may be turned into a multiplication by its
    reciprocal), and the square roots are taken in float64 and rounded
    (PyTorch's vectorised float32 ``sqrt`` on a CPU is not correctly
    rounded; the float64 one rounded to float32 is)."""
    Nf = torch.full((), float(N), dtype=prod.dtype, device=prod.device)

    def sqrt32(x):
        return torch.sqrt(x.double()).to(x.dtype)

    r = prod - n1[:, :, None] * (n2[:, None, :] / Nf)
    d1 = sqrt32((n1 / Nf) * (Nf - n1))
    d2 = sqrt32((n2 / Nf) * (Nf - n2))
    denom = d1[:, :, None] * d2[:, None, :]
    nz = denom != 0
    r = torch.where(nz, r / torch.where(nz, denom, torch.ones_like(denom)), r)
    r = r.clamp_(min=0.0)
    exact_eq = (prod == n1[:, :, None]) & (prod == n2[:, None, :])
    r = torch.where(exact_eq, torch.ones_like(r), r)
    full1 = (n1 == Nf)[:, :, None]
    full2 = (n2 == Nf)[:, None, :]
    r = torch.where(full1 | full2, (full1 & full2).to(r.dtype), r)
    return r


def _scatter_max(dst, index, src):
    """dst[p, index[p, k]] = max(dst[p, index[p, k]], src[p, k]); an index
    equal to M (one past the end) is a write that is dropped."""
    P, M = dst.shape
    ext = torch.cat([dst, dst.new_full((P, 1), -1)], dim=1)
    ext.scatter_reduce_(1, index, src, "amax", include_self=True)
    return ext[:, :M]


def _match_pairs(corr, tp, t_cl, t_cr, rp, r_cl, r_cr, nl_t, nl_r, N: int,
                 compat_tab):
    """Tensor twin of ``branch_association._match_from_corr``, batched over
    P pairs: corr (P, M, M) float32, the tree arrays (P, M) int64, the clade
    sizes (P, M) int64.

    ``compat_tab``: the host oracle's (N+1, N+1) leaf-count compatibility
    table, derived in float64, as a bool tensor. Computing the limit in
    float32 on the device can flip the strict comparison on borderline
    (c, c2, N) combinations and part from the oracle. Returns eq (P, M)
    int64."""
    P, M, _ = corr.shape
    dev = corr.device
    ar = torch.arange(M, device=dev)
    pid = torch.arange(P, device=dev)[:, None]

    eq = torch.full((P, M), -1, dtype=torch.int64, device=dev)
    eq_ref = torch.full((P, M), -1, dtype=torch.int64, device=dev)

    # --- stage 1: leaves ------------------------------------------------
    li = ar[None, :N]
    par = tp[:, :N]
    rpar = rp[:, :N]
    cl_par = torch.gather(t_cl, 1, par)
    sib = torch.where(cl_par == li, torch.gather(t_cr, 1, par), cl_par)
    leaf_sib = sib < N
    rsib_match = ((torch.gather(r_cl, 1, rpar) == sib)
                  | (torch.gather(r_cr, 1, rpar) == sib))
    cond_a = leaf_sib & rsib_match
    cond_b = ~leaf_sib & (corr[pid, par, rpar] >= THRESHOLD_BRANCHEQ)
    leaf_val = torch.where(cond_a | cond_b, li, -1)
    eq[:, :N] = leaf_val
    eq_ref[:, :N] = leaf_val
    # cond_a additionally pairs the (leaf) sibling with itself
    sib_val = torch.where(cond_a, sib, -1)
    sib_idx = torch.where(cond_a, sib, 0)
    eq = _scatter_max(eq, sib_idx, sib_val)
    eq_ref = _scatter_max(eq_ref, sib_idx, sib_val)

    # --- stage 2: internal exact matches --------------------------------
    is_int = ((ar >= N) & (ar < M - 1))[None, :]
    # the root's parent is -1; like an index of -1 it reads the last row
    tpw = torch.where(tp < 0, M - 1, tp)
    rpw = torch.where(rp < 0, M - 1, rp)
    diag_ok = (is_int & (torch.diagonal(corr, dim1=1, dim2=2) >= EXACT)
               & (corr[pid, tpw, rpw] >= EXACT))
    # rows without a diagonal match scan equal-leaf-count branches for the
    # lowest exactly-matching j
    pc = corr[pid[:, :, None], tpw[:, :, None], rpw[:, None, :]]
    cand2 = ((corr >= EXACT) & (pc >= EXACT)
             & (nl_t[:, :, None] == nl_r[:, None, :]))
    j_first = torch.where(cand2, ar.to(torch.int32)[None, None, :],
                          M).amin(dim=2).to(torch.int64)
    del cand2
    use_scan = is_int & ~diag_ok & (j_first < M)
    eq_int = torch.where(diag_ok, ar[None, :],
                         torch.where(use_scan, j_first, -1))
    eq = torch.where(is_int, eq_int, eq)
    # eq_ref last-write-wins in ascending-i order == scatter max
    targets = torch.where(diag_ok, ar[None, :],
                          torch.where(use_scan, j_first, M))
    vals = torch.where(diag_ok | use_scan, ar[None, :], -1)
    eq_ref = _scatter_max(eq_ref, targets, vals)

    # --- stage 3: approximate matches, best score first ------------------
    # The host matcher walks candidates in the total order
    # lexsort((j, nl_r[j], i, -score)) and greedily assigns pairs whose
    # endpoints are still free. Greedy matching under a TOTAL order equals
    # iterated locally-dominant locking: lock every (i, j) that is the
    # order-minimal live candidate of BOTH its row and its column, remove
    # locked rows/columns, repeat. (The order-minimal global candidate is
    # always mutual-best, so each round reproduces a prefix of the greedy
    # walk; induction gives exact equality.) Each round is a handful of
    # masked (M, M) reductions.
    unpaired = is_int & (eq == -1)
    compat_ab = compat_tab[nl_t[:, :, None], nl_r[:, None, :]]
    cand3 = ((corr >= THRESHOLD_BRANCHEQ) & (pc >= THRESHOLD_BRANCHEQ)
             & (eq_ref[:, None, :] == -1) & compat_ab & unpaired[:, :, None])
    del pc, compat_ab
    # row tie-break key among equal scores: (nl_r[j], j); column: i. Both
    # stay below M * (M + 2), inside int32 for every M the merge scan allows.
    big = torch.iinfo(torch.int32).max
    row_tie = (nl_r * (M + 1) + ar[None, :]).to(torch.int32)[:, None, :]
    col_tie = ar.to(torch.int32)[None, :, None]
    neg_inf = torch.full((), -float("inf"), dtype=corr.dtype, device=dev)
    # one round per download; a pair that locked nothing has finished and
    # stays as it is while the others go on
    changed = cand3.any(dim=2).any(dim=1)
    while bool(changed.any()):
        live = cand3 & (eq[:, :, None] == -1) & (eq_ref[:, None, :] == -1)
        s = torch.where(live, corr, neg_inf)
        rt = live & (s == s.amax(dim=2, keepdim=True))
        rbest = torch.where(rt, row_tie, big).argmin(dim=2)
        has_r = rt.any(dim=2)
        ct = live & (s == s.amax(dim=1, keepdim=True))
        cbest = torch.where(ct, col_tie, big).argmin(dim=1)
        has_c = ct.any(dim=1)
        lock = (has_r & (torch.gather(cbest, 1, rbest) == ar[None, :])
                & torch.gather(has_c, 1, rbest) & changed[:, None])
        eq = torch.where(lock, rbest, eq)
        eq_ref = _scatter_max(eq_ref, torch.where(lock, rbest, M),
                              torch.where(lock, ar[None, :], -1))
        changed = lock.any(dim=1)
    return eq


def _pair_bytes(N: int, M: int) -> float:
    """Device bytes one pair holds at the batch's peak, which is inside
    ``_pearson_device``: the product, the correlations, the outer product of
    the denominators and three more float32 (M, M) temporaries, a few bool
    masks, and the (M, N) leaf matrices. Reckoned, with room to spare, as
    eight float32 (M, M) matrices and two leaf matrices; at N = 2048 that is
    0.60 GB, and 0.37 GB a pair was measured there (20.4 GB for a batch of
    56 pairs on an H100 80GB, ``chip_smoke.py``'s ``run_all`` phase)."""
    return 8 * 4.0 * M * M + 2 * 4.0 * M * N


def pair_chunk_for(N: int, device) -> int:
    """Pairs per batch: a share of the card's free memory over
    ``_pair_bytes``; on the CPU a fixed 16."""
    device = torch.device(device)
    if device.type != "cuda":
        return 16
    free, _total = torch.cuda.mem_get_info(device)
    return int(max(1, min(MAX_PAIR_CHUNK,
                          0.4 * free / _pair_bytes(N, 2 * N - 1))))


def branch_association_many_device(trees: List[Tree],
                                   pair_chunk: Optional[int] = None,
                                   device=None) -> List[np.ndarray]:
    """Equivalences for every adjacent pair of ``trees``, computed on
    ``device`` (None: the CUDA card) in batches of ``pair_chunk`` pairs;
    identical to ``branch_association.branch_association_many``.

    The chunk is sized from the device's free memory (``pair_chunk_for``):
    at N = 2048 one pair holds a 67 MB ``corr``, as much again for its
    parent-indexed copy, and several (M, M) temporaries (``_pair_bytes``)."""
    device = resolve_device(device)
    T = len(trees)
    if T < 2:
        return []
    N = trees[0].N
    if pair_chunk is None:
        pair_chunk = pair_chunk_for(N, device)
    compat_tab = torch.from_numpy(_count_compat_table(N)).to(device)
    note("feb", dict(pairs=T - 1, pair_chunk=pair_chunk,
                     batches=-(-(T - 1) // pair_chunk)))

    def up(field):
        return torch.from_numpy(
            np.stack([getattr(t, field) for t in trees]).astype(np.int64)
        ).to(device)
    parent, cl, cr = up("parent"), up("child_left"), up("child_right")

    eqs: List[np.ndarray] = []
    for s in range(0, T - 1, pair_chunk):
        e = min(s + pair_chunk, T - 1)
        L = _leafmats(parent[s:e + 1], N)               # (P+1, M, N)
        nl = L.sum(dim=2)
        # 0/1 operands: whichever float32 matmul mode is set (full float32
        # or TF32, whose 10-bit mantissa holds 0 and 1 unchanged), every
        # product is exactly 0 or 1 and the sums, at most N < 2^24, are
        # exact in the float32 accumulator. The counts do not depend on
        # torch.backends.cuda.matmul.allow_tf32.
        prod = torch.bmm(L[1:], L[:-1].transpose(1, 2))
        corr = _pearson_device(prod, nl[1:], nl[:-1], N)
        del prod, L
        nli = nl.to(torch.int64)
        eq = _match_pairs(corr, parent[s + 1:e + 1], cl[s + 1:e + 1],
                          cr[s + 1:e + 1], parent[s:e], cl[s:e], cr[s:e],
                          nli[1:], nli[:-1], N, compat_tab)
        del corr
        eq = eq.to(torch.int32).cpu().numpy()
        eqs.extend(eq[k] for k in range(e - s))
    return eqs

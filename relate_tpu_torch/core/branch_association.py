"""Equivalent-branch identification across adjacent marginal trees.

Behavioral reference: ``AncesTreeBuilder::BranchAssociation``
(``include/src/anc_builder.cpp:1433-1614``), ``Correlation::Pearson``
(``include/src/anc.cpp:821-860``) and the forward/backward propagation
``AssociateTrees`` (anc_builder.cpp:658-818).

Own NumPy copy of ``relate_tpu/core/branch_association.py`` (the port
imports nothing of that package). All pairwise leaf-set intersections of two
trees are one ``(2N-1, N) @ (N, 2N-1)`` matrix product (0/1 operands, so the
float32 counts are exact integers). The matching stages are vectorized numpy
over the (M, M) correlation matrix; only the final greedy assignment over
the (tiny) above-threshold candidate list is a host loop. This host matcher
is the oracle of the device matcher in ``branch_association_device.py``;
the three ``associate_*`` sweeps run on the main path after either matcher.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .trees import Tree

THRESHOLD_BRANCHEQ = 0.95   # anc_builder.cpp:364
EXACT = 0.9999


def _pearson_from_products(prod: np.ndarray, n1: np.ndarray,
                           n2: np.ndarray, N: int) -> np.ndarray:
    """Pearson correlations given exact intersection counts ``prod`` (M, M)
    and clade sizes n1/n2 (anc.cpp:823-860 incl. special cases).

    float32 throughout — the reference's Correlation::Pearson is float
    (anc.cpp:822). In-place ops: this runs once per adjacent tree pair
    over (2N-1)^2 entries."""
    prod = prod.astype(np.float32, copy=False)
    n1 = n1.astype(np.float32, copy=False)
    n2 = n2.astype(np.float32, copy=False)
    Nf = np.float32(N)
    r = np.multiply.outer(n1, n2 / Nf)
    np.subtract(prod, r, out=r)
    d1 = np.sqrt((n1 / Nf) * (Nf - n1))
    d2 = np.sqrt((n2 / Nf) * (Nf - n2))
    denom = np.multiply.outer(d1, d2)
    with np.errstate(divide="ignore", invalid="ignore"):
        np.divide(r, denom, out=r, where=denom != 0)
    np.maximum(r, np.float32(0.0), out=r)          # r <= 0 -> 0
    # exact equality -> 1
    exact_eq = (prod == n1[:, None]) & (prod == n2[None, :])
    r[exact_eq] = 1.0
    # full sets (only possible for the root clade): 1 if equal sizes else 0
    full1 = np.nonzero(n1 == Nf)[0]
    full2 = np.nonzero(n2 == Nf)[0]
    if full1.size:
        r[full1, :] = np.where(n2[None, :] == Nf, np.float32(1.0),
                               np.float32(0.0))
    if full2.size:
        r[:, full2] = np.where(n1[:, None] == Nf, np.float32(1.0),
                               np.float32(0.0))
    return r


def pearson_matrix(L1: np.ndarray, L2: np.ndarray) -> np.ndarray:
    """Pairwise Pearson correlations of two trees' leaf sets.

    L1, L2: (M, N) uint8 clade indicators. Implements anc.cpp:823-860
    including its special cases.
    """
    M, N = L1.shape
    n1 = L1.sum(axis=1).astype(np.float32)
    n2 = L2.sum(axis=1).astype(np.float32)
    prod = L1.astype(np.float32) @ L2.astype(np.float32).T   # exact ints
    return _pearson_from_products(prod, n1, n2, N)


# (N -> (N+1, N+1) bool) cache of the PreCalcPotentialBranches leaf-count
# compatibility predicate (anc_builder.cpp:1434-1452): clades of sizes
# (c, c2) can only correlate >= threshold when the sizes are close enough.
_COMPAT_CACHE: Dict[int, np.ndarray] = {}


def _count_compat_table(N: int) -> np.ndarray:
    tab = _COMPAT_CACHE.get(N)
    if tab is None:
        thr_inv = 1.0 / (THRESHOLD_BRANCHEQ * THRESHOLD_BRANCHEQ)
        c = np.arange(N + 1, dtype=np.float64)
        lo = np.minimum(c[:, None], c[None, :])
        hi = np.maximum(c[:, None], c[None, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            lim = hi / (N - hi + 1e-30) * ((N - lo) / np.where(lo == 0, 1.0,
                                                               lo))
        tab = ~((c[:, None] != c[None, :]) & (thr_inv < lim))
        _COMPAT_CACHE[N] = tab
    return tab


def _match_from_corr(ref_tree: Tree, tree: Tree, corr: np.ndarray,
                     nl_r: Optional[np.ndarray] = None,
                     nl_t: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized staged matching given the (M, M) correlation matrix.

    The write/override order of the reference's loops is replicated, so
    the result equals the loop transcription of anc_builder.cpp:1455-1614
    (``tests/test_torch_branch_association.py`` holds it against the JAX
    package's matchers)."""
    N = tree.N
    M = tree.num_nodes
    tp = tree.parent
    rp = ref_tree.parent

    eq = np.full(M, -1, dtype=np.int32)
    eq_ref = np.full(M, -1, dtype=np.int32)

    # 1. leaves: sibling identity or parent-clade correlation
    li = np.arange(N)
    par = tp[:N]
    rpar = rp[:N]
    sib = np.where(tree.child_left[par] == li, tree.child_right[par],
                   tree.child_left[par])
    leaf_sib = sib < N
    rsib_match = (ref_tree.child_left[rpar] == sib) \
        | (ref_tree.child_right[rpar] == sib)
    cond_a = leaf_sib & rsib_match
    cond_b = ~leaf_sib & (corr[par, rpar] >= THRESHOLD_BRANCHEQ)
    sel = cond_a | cond_b
    eq[li[sel]] = li[sel]
    eq_ref[li[sel]] = li[sel]
    # cond_a additionally pairs the (leaf) sibling with itself
    sibs_a = sib[cond_a]
    eq[sibs_a] = sibs_a
    eq_ref[sibs_a] = sibs_a

    if nl_r is None:
        nl_r = ref_tree.leaf_matrix().sum(axis=1)
    if nl_t is None:
        nl_t = tree.leaf_matrix().sum(axis=1)
    nl_r = nl_r.astype(np.int64)
    nl_t = nl_t.astype(np.int64)

    # 2. internal nodes (root excluded): exact matches. Same-index first;
    #    rows without one scan branches of equal leaf count for the lowest
    #    exactly-matching j. eq_ref writes happen in ascending-i order in
    #    the reference, so a later row overrides an earlier claim on the
    #    same target — replicated here with maximum.at (values ascend).
    ii = np.arange(N, M - 1)
    parent_corr_ii = corr[tp[ii], rp[ii]]
    diag_ok = (corr[ii, ii] >= EXACT) & (parent_corr_ii >= EXACT)

    need = ii[~diag_ok]
    j_first = None
    if need.size:
        # candidate mask over (need, M): exact corr + exact parent corr +
        # equal leaf counts (by_count scan order == ascending j)
        cand = (corr[need] >= EXACT) \
            & (corr[tp[need]][:, rp] >= EXACT) \
            & (nl_t[need][:, None] == nl_r[None, :])
        j_first = np.where(cand.any(axis=1),
                           np.where(cand, np.arange(M)[None, :],
                                    M).argmin(axis=1), -1)

    eq[ii[diag_ok]] = ii[diag_ok]
    # interleave the eq_ref writes of both stage-2 branches in i order:
    # targets are >= N and initialized -1, values are the writing row i
    # (ascending), so last-write-wins == elementwise max.
    targets = np.full(M, -1, dtype=np.int64)
    vals = np.full(M, -1, dtype=np.int64)
    targets[ii[diag_ok]] = ii[diag_ok]
    vals[ii[diag_ok]] = ii[diag_ok]
    if need.size:
        hasj = j_first >= 0
        eq[need[hasj]] = j_first[hasj]
        targets[need[hasj]] = j_first[hasj]
        vals[need[hasj]] = need[hasj]
    w = targets >= 0
    if w.any():
        np.maximum.at(eq_ref, targets[w], vals[w].astype(np.int32))

    # 3. approximate matches: all >= threshold pairs with compatible leaf
    #    counts and unclaimed ref branch, assigned best score first
    #    (anc_builder.cpp:1434-1452). Tie order replicates the reference
    #    loop's generation order (i asc, then ref leaf count, then j asc).
    unpaired = ii[eq[ii] == -1]
    if unpaired.size:
        compat = _count_compat_table(N)
        cand = (corr[unpaired] >= THRESHOLD_BRANCHEQ) \
            & (corr[tp[unpaired]][:, rp] >= THRESHOLD_BRANCHEQ) \
            & (eq_ref[None, :] == -1) \
            & compat[nl_t[unpaired][:, None], nl_r[None, :]]
        ri, cj = np.nonzero(cand)
        if ri.size:
            i_arr = unpaired[ri]
            score = corr[i_arr, cj]
            order = np.lexsort((cj, nl_r[cj], i_arr, -score))
            for k in order:
                i, j = i_arr[k], cj[k]
                if eq[i] == -1 and eq_ref[j] == -1:
                    eq[i] = j
                    eq_ref[j] = i
    return eq


def branch_association(ref_tree: Tree, tree: Tree) -> np.ndarray:
    """equivalent[k] = branch of ref_tree equivalent to branch k of tree
    (-1 if none), replicating the reference's staged matching."""
    Lt = tree.leaf_matrix()
    Lr = ref_tree.leaf_matrix()
    return _match_from_corr(ref_tree, tree, pearson_matrix(Lt, Lr),
                            nl_r=Lr.sum(axis=1), nl_t=Lt.sum(axis=1))


def branch_association_many(trees: List[Tree], pair_chunk: int = 64
                            ) -> List[np.ndarray]:
    """Equivalences for every adjacent pair of ``trees`` (the full
    FindEquivalentBranches sweep, FindEquivalentBranches.cpp:80-125), on
    the host.

    The (M, N) @ (N, M) leaf-set intersection products are batched
    ``pair_chunk`` pairs at a time; leaf matrices are built once per tree
    instead of twice per pair."""
    T = len(trees)
    if T < 2:
        return []
    eqs: List[np.ndarray] = []
    L_cache: Optional[np.ndarray] = None
    N = trees[0].N
    for s in range(0, T - 1, pair_chunk):
        e = min(s + pair_chunk, T - 1)
        # leaf matrices for trees[s .. e]; reuse the last one of the
        # previous chunk
        Ls = []
        for t in range(s, e + 1):
            if t == s and L_cache is not None:
                Ls.append(L_cache)
            else:
                Ls.append(trees[t].leaf_matrix())
        L_cache = Ls[-1]
        stack = np.stack(Ls).astype(np.float32)        # (B+1, M, N)
        prods = np.matmul(stack[1:], stack[:-1].transpose(0, 2, 1))
        ns = stack.sum(axis=2)                         # clade sizes
        for k in range(e - s):
            corr = _pearson_from_products(prods[k], ns[k + 1], ns[k], N)
            eqs.append(_match_from_corr(trees[s + k], trees[s + k + 1],
                                        corr, nl_r=ns[k], nl_t=ns[k + 1]))
    return eqs


def associate_forward(trees: List[Tree], equivalences: List[np.ndarray]):
    """Forward half of AssociateTrees (anc_builder.cpp:658-737): accumulate
    events and earliest SNP_begin along equivalence chains. ``trees`` is any
    CONSECUTIVE run of marginal trees; ``equivalences[t]`` maps branches of
    trees[t+1] to trees[t]. Streamable: a later call whose first tree is the
    last tree of an earlier call continues the same sweep."""
    for t in range(len(trees) - 1):
        eq = equivalences[t]
        prev, cur = trees[t], trees[t + 1]
        idx = np.nonzero(eq != -1)[0]
        cur.num_events[idx] += prev.num_events[eq[idx]]
        cur.SNP_begin[idx] = prev.SNP_begin[eq[idx]]


def associate_backward(trees: List[Tree], equivalences: List[np.ndarray]):
    """Backward half of AssociateTrees (anc_builder.cpp:739-818): copy the
    accumulated events and latest SNP_end back down the chains. Streamable
    in REVERSE window order (a later call whose last tree is the first tree
    of an earlier call continues the sweep)."""
    for t in range(len(trees) - 2, -1, -1):
        eq = equivalences[t]
        prev, cur = trees[t], trees[t + 1]
        idx = np.nonzero(eq != -1)[0]
        prev.num_events[eq[idx]] = cur.num_events[idx]
        prev.SNP_end[eq[idx]] = cur.SNP_end[idx]


def associate_trees(trees: List[Tree], equivalences: List[np.ndarray]):
    """Propagate num_events / SNP spans through equivalent-branch chains
    (AssociateTrees, anc_builder.cpp:658-818).

    trees: all marginal trees of a chunk in order; equivalences[t][k] = branch
    of trees[t] equivalent to branch k of trees[t+1]. Mutates trees in place.
    """
    if len(equivalences) != len(trees) - 1:
        raise ValueError("one equivalence vector per adjacent pair is needed")
    associate_forward(trees, equivalences)
    associate_backward(trees, equivalences)

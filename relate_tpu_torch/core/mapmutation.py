"""Mutation-to-branch mapping.

Behavioral reference: ``AncesTreeBuilder::MapMutation`` /
``PropagateMutationGlobal`` / ``PropagateMutationLocal``
(``include/src/anc_builder.cpp:981-1413``).

Batched reformulation: the reference's per-SNP recursive tree walk becomes
a batched computation. Carrier counts per clade for a *block* of SNPs are one
matmul ``leaf_matrix (2N-1, N) @ carriers (N, B)`` (one matrix product), the placement
conditions are elementwise, and the reference's tie-breaking recursion
("descendant beats ancestor, left subtree beats right") is exactly an argmin
over (mismatch count, post-order index).

Key facts replicated:
- threshold thr = 0.03*N mismatches (anc_builder.cpp:365).
- A mutation carried by all N haplotypes maps to the root and always
  increments its event count (anc_builder.cpp:984-991); zero carriers maps
  nowhere.
- Placement conditions (0.3/0.7 fractions) differ between leaves and
  internal nodes (anc_builder.cpp:1295-1338 vs 1254-1293): leaves use the
  reduced forms.
- is_mapping: 1 = mapped (unflipped), 2 = mapped flipped, 3 = not mappable
  (caller then uses the multi-branch local propagation).
- On an exact tie between flipped and unflipped placements the deterministic
  variant keeps unflipped (anc_builder.cpp:1090-1092); the
  ``anc_allele_unknown`` variant flips a seeded coin (anc_builder.cpp:1011).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .trees import Tree


def postorder_index(tree: Tree) -> np.ndarray:
    """Post-order DFS position per node (left child first)."""
    M = tree.num_nodes
    out = np.empty(M, dtype=np.int64)
    stack = [(tree.root, False)]
    c = 0
    while stack:
        node, expanded = stack.pop()
        if tree.child_left[node] < 0:
            out[node] = c
            c += 1
        elif expanded:
            out[node] = c
            c += 1
        else:
            stack.append((node, True))
            stack.append((int(tree.child_right[node]), False))
            stack.append((int(tree.child_left[node]), False))
    return out


class MapResult(NamedTuple):
    is_mapping: np.ndarray   # (B,) int8 in {1,2,3}
    branch: np.ndarray       # (B,) int32 best branch (-1 if none)
    flipped: np.ndarray      # (B,) bool
    min_value: np.ndarray    # (B,) float32 mismatch count of the placement


class TreeMapper:
    """The JAX module's ``map_mutations_block`` for one tree: what depends
    only on the tree (the clade matrix in float64, clade sizes, post-order)
    is computed once, for all the blocks mapped onto it."""

    def __init__(self, tree: Tree, leaf_mat: np.ndarray):
        """leaf_mat: (2N-1, N) clade indicator (tree.leaf_matrix())."""
        self.leaf64 = np.asarray(leaf_mat, dtype=np.float64)
        self.csize = self.leaf64.sum(axis=1)[:, None]     # (M, 1)
        self.post = postorder_index(tree)

    def __call__(self, carriers: np.ndarray,
                 flip_coins: Optional[np.ndarray] = None) -> MapResult:
        """Map a block of SNPs. A SNP's result does not depend on the other
        SNPs of the block.

        carriers: (B, N) uint8 carrier indicator per SNP.
        flip_coins: (B,) uniforms in [0, 1): if given, an exact flip tie of
        SNP b flips when ``flip_coins[b] >= 0.5`` (unknown ancestral allele
        mode); else the tie keeps unflipped.
        """
        leaf64, csize, post = self.leaf64, self.csize, self.post
        M, N = leaf64.shape
        B = carriers.shape[0]

        tc = carriers.sum(axis=1).astype(np.float64)      # (B,)
        tnc = N - tc
        cc = (carriers.astype(np.float64) @ leaf64.T).T   # (M, B)
        icn = csize - cc                                  # non-carriers inside

        nc = tc[None, :] - cc                             # carriers outside
        cnc = tnc[None, :] - icn                          # noncarriers outside

        with np.errstate(divide="ignore", invalid="ignore"):
            is_leaf = (np.arange(M) < N)[:, None]
            # internal-node conditions (anc_builder.cpp:1254-1293)
            cond_u = (nc / tc[None, :] < 0.3) & (icn / tnc[None, :] < 0.3)
            denom1 = cc + icn
            cond_u &= (denom1 <= 0) | (cc / np.maximum(denom1, 1e-30) > 0.7)
            denom2 = nc + cnc
            cond_u &= (denom2 <= 0) | (cnc / np.maximum(denom2, 1e-30) > 0.7)

            cond_f = (cc / tc[None, :] < 0.3) & (cnc / tnc[None, :] < 0.3)
            cond_f &= (denom2 <= 0) | (nc / np.maximum(denom2, 1e-30) > 0.7)
            cond_f &= (denom1 <= 0) | (icn / np.maximum(denom1, 1e-30) > 0.7)

            # leaf conditions (anc_builder.cpp:1295-1338)
            is_carrier = cc > 0.5  # for leaves cc in {0,1}
            leaf_cond_u = np.where(is_carrier,
                                   nc / tc[None, :] < 0.3,
                                   (nc / tc[None, :] < 0.3)
                                   & (icn / tnc[None, :] < 0.3))
            leaf_cond_f = np.where(is_carrier,
                                   (cc / tc[None, :] < 0.3)
                                   & (cnc / tnc[None, :] < 0.3),
                                   cnc / tnc[None, :] < 0.3)
            cond_u = np.where(is_leaf, leaf_cond_u, cond_u)
            cond_f = np.where(is_leaf, leaf_cond_f, cond_f)

        sum_u = nc + icn
        sum_f = cc + cnc

        BIGV = np.float64(1e18)
        eff_u = np.where(cond_u, sum_u, BIGV)
        eff_f = np.where(cond_f, sum_f, BIGV)

        # argmin with (value, postorder) tie-break
        key_u = eff_u * (2 * M) + post[:, None]
        key_f = eff_f * (2 * M) + post[:, None]
        bu = key_u.argmin(axis=0)
        bf = key_f.argmin(axis=0)
        min_u = eff_u[bu, np.arange(B)]
        min_f = eff_f[bf, np.arange(B)]

        thr = 0.03 * N
        out_map = np.full(B, 3, dtype=np.int8)
        out_branch = np.full(B, -1, dtype=np.int32)
        out_flip = np.zeros(B, dtype=bool)
        out_min = np.zeros(B, dtype=np.float32)

        tie = min_u == min_f
        if flip_coins is not None:
            flip_on_tie = np.asarray(flip_coins) >= 0.5
        else:
            flip_on_tie = np.zeros(B, dtype=bool)

        use_f = np.where(tie, flip_on_tie, min_f < min_u)
        chosen_min = np.where(use_f, min_f, min_u)
        chosen_branch = np.where(use_f, bf, bu)
        ok = chosen_min <= thr
        out_map[ok & ~use_f] = 1
        out_map[ok & use_f] = 2
        out_branch[ok] = chosen_branch[ok]
        out_flip[ok] = use_f[ok]
        out_min[:] = np.where(chosen_min >= BIGV, np.inf, chosen_min)

        # special cases: all carriers -> root; none -> nothing (is_mapping 1)
        all_c = tc == N
        out_map[all_c] = 1
        out_branch[all_c] = 2 * N - 2
        out_flip[all_c] = False
        out_min[all_c] = 0.0
        none_c = tc == 0
        out_map[none_c] = 1
        out_branch[none_c] = -1
        out_flip[none_c] = False
        out_min[none_c] = 0.0

        return MapResult(out_map, out_branch, out_flip, out_min)


def propagate_local(tree: Tree, carriers: np.ndarray
                    ) -> Tuple[List[int], List[int]]:
    """PropagateMutationLocal (anc_builder.cpp:1343-1413): branch sets that
    jointly cover the carriers (and the flipped complement). Host recursion;
    only invoked for the rare non-mapping SNPs."""
    branches: List[int] = []
    branches_flipped: List[int] = []

    def rec(node: int):
        # returns (num_carriers, num_flipped_carriers, best, best_flipped)
        cl = int(tree.child_left[node])
        if cl < 0:
            if carriers[node]:
                return 1, 0, node, -1
            return 0, 1, -1, node
        cr = int(tree.child_right[node])
        n1, f1, b1, bf1 = rec(cl)
        n2, f2, b2, bf2 = rec(cr)
        ncar = n1 + n2
        nfl = f1 + f2
        tot = ncar + nfl
        if nfl / tot < 0.03 and b1 != -1 and b2 != -1:
            if n1 > 0 and n2 > 0:
                best = node
            elif n1 > 0:
                best = b1
            else:
                best = b2
        else:
            if b1 != -1:
                branches.append(b1)
            if b2 != -1:
                branches.append(b2)
            best = -1
        if ncar / tot < 0.03 and bf1 != -1 and bf2 != -1:
            if f1 > 0 and f2 > 0:
                bestf = node
            elif f1 > 0:
                bestf = bf1
            else:
                bestf = bf2
        else:
            if bf1 != -1:
                branches_flipped.append(bf1)
            if bf2 != -1:
                branches_flipped.append(bf2)
            bestf = -1
        return ncar, nfl, best, bestf

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * tree.num_nodes + 100))
    try:
        ncar, nfl, best, bestf = rec(tree.root)
    finally:
        sys.setrecursionlimit(old)
    # The reference does NOT append the top-level best branches
    # (anc_builder.cpp:1155-1156 uses the pushed lists as-is); keep that,
    # but guard the fully-consistent corner case where nothing was pushed.
    if not branches and not branches_flipped and best != -1:
        branches.append(best)
    return branches, branches_flipped


def force_map_mutation(tree: Tree, carriers: np.ndarray
                       ) -> Tuple[List[int], bool]:
    """ForceMapMutation (anc_builder.cpp:1142-1204): choose the smaller of
    the unflipped/flipped branch sets (ties prefer unflipped).
    Returns (branches, flipped)."""
    N = tree.N
    num = int(carriers.sum())
    if num == 0 or num == N:
        return [], False
    branches, branches_flipped = propagate_local(tree, carriers)
    if len(branches_flipped) == 0:
        return branches, False
    if len(branches) <= len(branches_flipped) and len(branches) > 0:
        return branches, False
    return branches_flipped, True

"""Tree-sequence extraction utilities.

Counterpart of ``relate_tpu/io/extract.py``. Behavioral reference:
``include/extract/`` (RelateExtract.cpp:43-116 modes): AncToNewick
(GetTreeOfInterest.cpp), SubTreesForSubpopulation
(CreateAncesTreeFileForSubpopulation.cpp), AncMutForSubregion,
RemoveTreesWithFewMutations, ExtractDistFromMut, DivideAncMut/CombineAncMut
(AncMutChunks.cpp), MapMutations, UnlinkTips, GetMut, AncientToModern and
the Annotate.cpp modes, and ConvertNewickToTimeb (Convert.cpp, through
``io/importers.py``). Host code over the in-memory tree sequence.
"""
from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

import numpy as np

from ..core.mapmutation import TreeMapper, force_map_mutation
from ..core.topology import MutationRecord
from ..core.trees import AncesTree, MarginalTree, Tree, children_from_parent
from . import ancmut


def anc_mut_for_subregion(anc: AncesTree, muts: List[MutationRecord],
                          bp: np.ndarray, first_bp: int, last_bp: int):
    """Restrict to SNPs with first_bp <= bp <= last_bp (AncMutForSubregion);
    trees are renumbered from 0. Returns (anc, muts, (lo, hi)), the SNP
    range kept."""
    sel = np.nonzero((bp >= first_bp) & (bp <= last_bp))[0]
    if len(sel) == 0:
        raise ValueError("no SNPs in subregion")
    lo, hi = int(sel[0]), int(sel[-1])
    t_lo = muts[lo].tree
    t_hi = muts[hi].tree
    L_new = hi - lo + 1
    new_seq = []
    for t in range(t_lo, t_hi + 1):
        mt = anc.seq[t]
        tr = mt.tree.copy()
        tr.SNP_begin = np.clip(tr.SNP_begin - lo, 0, L_new - 1).astype(
            tr.SNP_begin.dtype)
        tr.SNP_end = np.clip(tr.SNP_end - lo, 0, L_new - 1).astype(
            tr.SNP_end.dtype)
        new_seq.append(MarginalTree(pos=max(mt.pos - lo, 0), tree=tr))
    new_muts = [MutationRecord(tree=m.tree - t_lo, branch=list(m.branch),
                               flipped=m.flipped, age_begin=m.age_begin,
                               age_end=m.age_end)
                for m in muts[lo: hi + 1]]
    return AncesTree(N=anc.N, seq=new_seq, sample_ages=anc.sample_ages), \
        new_muts, (lo, hi)


def remove_trees_with_few_mutations(anc: AncesTree,
                                    muts: List[MutationRecord],
                                    threshold_frac: float = 0.5):
    """Drop trees with fewer mutations than threshold_frac * average
    (RemoveTreesWithFewMutations); their SNPs remap to the nearest kept tree
    and are no longer mapped to a branch."""
    T = len(anc.seq)
    counts = np.zeros(T)
    for m in muts:
        counts[m.tree] += 1
    thr = threshold_frac * counts.mean()
    kept = np.nonzero(counts >= thr)[0]
    if len(kept) == 0:
        return anc, muts
    remap = np.empty(T, dtype=np.int64)
    for t in range(T):
        i = np.searchsorted(kept, t)
        if i == len(kept):
            remap[t] = len(kept) - 1
        elif kept[i] == t or i == 0:
            remap[t] = i
        else:
            remap[t] = i if (kept[i] - t) <= (t - kept[i - 1]) else i - 1
    new_muts = []
    for m in muts:
        nm = MutationRecord(tree=int(remap[m.tree]), branch=list(m.branch),
                            flipped=m.flipped, age_begin=m.age_begin,
                            age_end=m.age_end)
        if remap[m.tree] != np.searchsorted(kept, m.tree) \
                or counts[m.tree] < thr:
            nm.branch = []          # mutation no longer mapped
        new_muts.append(nm)
    # tree k now starts at the first SNP mapped to it
    starts = np.zeros(len(kept), dtype=np.int64)
    seen = set()
    for snp, m in enumerate(new_muts):
        if m.tree not in seen:
            starts[m.tree] = snp
            seen.add(m.tree)
    out_seq = [MarginalTree(pos=int(starts[i]), tree=anc.seq[t].tree)
               for i, t in enumerate(kept)]
    return AncesTree(N=anc.N, seq=out_seq, sample_ages=anc.sample_ages), \
        new_muts


def extract_dist_from_mut(muts_d: List[dict], path: str):
    """Write the .dist file ('#pos dist' rows) from a final .mut's records
    (ExtractDistFromMut)."""
    with open(path, "w") as f:
        f.write("#pos dist\n")
        for m in muts_d:
            f.write(f"{m['pos']} {m['dist']}\n")


def anc_to_newick(anc: AncesTree, muts: List[MutationRecord],
                  bp: np.ndarray, first_bp: int, last_bp: int) -> List[str]:
    """Newick strings of all marginal trees overlapping [first_bp, last_bp]
    (AncToNewick / GetTreeOfInterest)."""
    out = []
    T = len(anc.seq)
    for t, mt in enumerate(anc.seq):
        lo = bp[min(mt.pos, len(bp) - 1)]
        hi_snp = (anc.seq[t + 1].pos - 1) if t + 1 < T else len(bp) - 1
        hi = bp[min(hi_snp, len(bp) - 1)]
        if hi < first_bp or lo > last_bp:
            continue
        out.append(mt.tree.to_newick())
    return out


def subtree_for_leaves(tree: Tree, keep: np.ndarray
                       ) -> Tuple[Tree, np.ndarray]:
    """Induced subtree on a leaf subset (SubTreesForSubpopulation).

    Returns (new_tree, branch_map) where branch_map[old_node] = new node the
    old branch maps onto (-1 if pruned). Unary nodes are suppressed with
    branch lengths and event counts summed along the path.
    """
    keep = np.asarray(keep)
    n_new = len(keep)
    leafmat = tree.leaf_matrix()
    kept_count = leafmat[:, keep].sum(axis=1)

    # new leaf ids
    new_id = np.full(tree.num_nodes, -1, dtype=np.int64)
    for i, h in enumerate(keep):
        new_id[h] = i

    M_new = 2 * n_new - 1
    parent = np.full(M_new, -1, dtype=np.int32)
    bl = np.zeros(M_new)
    ne = np.zeros(M_new, dtype=np.float32)
    sb = np.zeros(M_new, dtype=np.int32)
    se = np.zeros(M_new, dtype=np.int32)
    branch_map = np.full(tree.num_nodes, -1, dtype=np.int64)

    # internal nodes that are "junctions": both children have kept leaves
    next_internal = n_new

    def build(v: int) -> Tuple[int, float, float]:
        """Returns (new node id, accumulated bl, accumulated events) of the
        highest surviving node at/below v."""
        nonlocal next_internal
        if tree.child_left[v] < 0:
            branch_map[v] = new_id[v]
            return new_id[v], float(tree.branch_length[v]), \
                float(tree.num_events[v])
        cl, cr = int(tree.child_left[v]), int(tree.child_right[v])
        lc = kept_count[cl] > 0
        rc = kept_count[cr] > 0
        if lc and rc:
            a, bla, nea = build(cl)
            b, blb, neb = build(cr)
            w = next_internal
            next_internal += 1
            parent[a] = w
            parent[b] = w
            bl[a] = bla
            bl[b] = blb
            ne[a] = nea
            ne[b] = neb
            sb[a] = sb[b] = tree.SNP_begin[v]
            se[a] = se[b] = tree.SNP_end[v]
            branch_map[v] = w
            return w, float(tree.branch_length[v]), float(tree.num_events[v])
        child = cl if lc else cr
        nid, blc, nec = build(child)
        branch_map[v] = nid
        # suppress unary: extend the surviving edge through v
        return nid, blc + float(tree.branch_length[v]), \
            nec + float(tree.num_events[v])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * tree.num_nodes + 100))
    try:
        build(tree.root)
    finally:
        sys.setrecursionlimit(old)
    assert next_internal == M_new
    cl_arr, cr_arr = children_from_parent(parent)
    new_tree = Tree(parent=parent, child_left=cl_arr, child_right=cr_arr,
                    branch_length=bl, num_events=ne, SNP_begin=sb, SNP_end=se)
    return new_tree, branch_map


def subtrees_for_subpopulation(anc: AncesTree, muts: List[MutationRecord],
                               keep: Sequence[int]):
    """Restrict the whole tree sequence to a haplotype subset; remap
    mutations onto surviving branches (dropped if their branch was pruned)."""
    keep = np.asarray(sorted(keep))
    new_seq = []
    maps = []
    for mt in anc.seq:
        t, bm = subtree_for_leaves(mt.tree, keep)
        new_seq.append(MarginalTree(pos=mt.pos, tree=t))
        maps.append(bm)
    new_muts = []
    for m in muts:
        nm = MutationRecord(tree=m.tree, flipped=m.flipped,
                            age_begin=m.age_begin, age_end=m.age_end)
        bm = maps[m.tree]
        nb = sorted({int(bm[b]) for b in m.branch if bm[b] >= 0})
        nm.branch = nb
        new_muts.append(nm)
    ages = anc.sample_ages[keep] if anc.sample_ages is not None else None
    return AncesTree(N=len(keep), seq=new_seq, sample_ages=ages), new_muts


def divide_anc_mut(anc: AncesTree, muts: List[MutationRecord],
                   num_chunks: int):
    """Split a tree sequence into ~equal tree-count chunks for parallel
    post-processing (DivideAncMut, AncMutChunks.cpp:13)."""
    T = len(anc.seq)
    bounds = np.linspace(0, T, num_chunks + 1).astype(np.int64)
    out = []
    for c in range(num_chunks):
        t0, t1 = int(bounds[c]), int(bounds[c + 1])
        if t0 == t1:
            continue
        seq = []
        snp0 = anc.seq[t0].pos
        for t in range(t0, t1):
            mt = anc.seq[t]
            seq.append(MarginalTree(pos=mt.pos - snp0, tree=mt.tree))
        sub_muts = [MutationRecord(tree=m.tree - t0, branch=list(m.branch),
                                   flipped=m.flipped, age_begin=m.age_begin,
                                   age_end=m.age_end)
                    for m in muts if t0 <= m.tree < t1]
        out.append((AncesTree(N=anc.N, seq=seq,
                              sample_ages=anc.sample_ages), sub_muts))
    return out


def combine_anc_mut(chunks):
    """Inverse of divide_anc_mut (CombineAncMut, AncMutChunks.cpp:214)."""
    seq = []
    muts: List[MutationRecord] = []
    t_off = 0
    snp_off = 0
    ages = None
    N = None
    for anc, sub in chunks:
        N = anc.N
        ages = anc.sample_ages
        for mt in anc.seq:
            seq.append(MarginalTree(pos=mt.pos + snp_off, tree=mt.tree))
        for m in sub:
            muts.append(MutationRecord(tree=m.tree + t_off,
                                       branch=list(m.branch),
                                       flipped=m.flipped,
                                       age_begin=m.age_begin,
                                       age_end=m.age_end))
        t_off += len(anc.seq)
        snp_off += len(sub)
    return AncesTree(N=N, seq=seq, sample_ages=ages), muts


def unlink_tips(anc: AncesTree, tips: Sequence[int]):
    """Set branch lengths of given tips to 0 and clear their events
    (UnlinkTips)."""
    for mt in anc.seq:
        for t in tips:
            mt.tree.branch_length[t] = 0.0
            mt.tree.num_events[t] = 0.0
    return anc


def map_extra_mutations(anc: AncesTree, muts: List[MutationRecord],
                        bp: np.ndarray, extra_bp: np.ndarray,
                        extra_carriers: np.ndarray):
    """Map additional SNPs onto existing trees (MapMutations mode): place
    each extra SNP on the tree covering its position using the same
    propagate-mutation machinery as BuildTopology."""
    out = []
    mappers = {}
    for i, b in enumerate(extra_bp):
        snp = int(np.searchsorted(bp, b, side="right")) - 1
        snp = max(snp, 0)
        t = muts[min(snp, len(muts) - 1)].tree
        tree = anc.seq[t].tree
        if t not in mappers:
            mappers[t] = TreeMapper(tree, tree.leaf_matrix())
        res = mappers[t](extra_carriers[i: i + 1].astype(np.uint8))
        rec = MutationRecord(tree=t)
        if res.is_mapping[0] <= 2 and res.branch[0] >= 0:
            rec.branch = [int(res.branch[0])]
            rec.flipped = bool(res.flipped[0])
        else:
            brs, flp = force_map_mutation(
                tree, extra_carriers[i].astype(bool))
            rec.branch = brs
            rec.flipped = flp
        out.append(rec)
    ancmut.get_age(anc, out)
    return out


def get_mut(anc: AncesTree, muts: List[MutationRecord]):
    """Re-derive mutation age intervals from the trees and return the
    records (RelateExtract --mode GetMut; extract/Annotate.cpp:6-49 calls
    Mutations::GetAge then dumps)."""
    ancmut.get_age(anc, muts)
    return muts


def ancient_to_modern(anc: AncesTree):
    """Fold sample ages into the tip branch lengths and drop them
    (extract/Annotate.cpp:611-650)."""
    if anc.sample_ages is None:
        return anc
    for mt in anc.seq:
        mt.tree.branch_length[: anc.N] += np.asarray(anc.sample_ages)
    anc.sample_ages = None
    return anc


def count_mut_on_branches(anc: AncesTree, muts: List[MutationRecord]):
    """Per-tree per-branch mutation counts (RelateExtract --mode
    CountMutonBranches / Annotate.cpp PrintMutonBranches): rows of
    (tree_index, branch, count) for branches carrying >= 1 mutation."""
    counts = {}
    for m in muts:
        if len(m.branch) == 1:
            counts[(m.tree, int(m.branch[0]))] = \
                counts.get((m.tree, int(m.branch[0])), 0) + 1
    return sorted((t, b, c) for (t, b), c in counts.items())


def all_branches_of_mut(muts: List[MutationRecord]):
    """(snp, branches) for every mutation incl. non-mapping multi-branch
    ones (RelateExtract --mode GetAllBranchesOfMut)."""
    return [(snp, list(m.branch)) for snp, m in enumerate(muts)]


def check_branch_persistence(anc: AncesTree, muts: List[MutationRecord],
                             bp: np.ndarray):
    """Per SNP: how many bases the mutation's branch persists, from the
    branch's propagated SNP span (RelateExtract --mode
    CheckBranchPersistence, Annotate.cpp:512-608; spans come from
    AssociateTrees exactly like the reference's equivalent-branch
    propagation)."""
    out = np.zeros(len(muts), dtype=np.float64)
    L = len(bp)
    for snp, m in enumerate(muts):
        if len(m.branch) != 1:
            continue
        tree = anc.seq[m.tree].tree
        b = int(m.branch[0])
        sb = int(tree.SNP_begin[b])
        se = min(int(tree.SNP_end[b]), L - 1)
        out[snp] = float(bp[se]) - float(bp[sb])
    return out


def generate_snp_annotations_using_tree(anc: AncesTree,
                                        muts: List[MutationRecord],
                                        bp: np.ndarray,
                                        alleles: List[str]):
    """.annot rows ``upstream;downstream;carriers`` per SNP, with carrier
    counts taken from the mapped branch's leaf set (RelateExtract --mode
    GenerateSNPAnnotationsUsingTree, Annotate.cpp:52-190)."""
    rows = []
    for snp, m in enumerate(muts):
        up = alleles[snp - 1].split("/")[0] if snp > 0 and "/" in \
            alleles[snp - 1] else "."
        dn = alleles[snp + 1].split("/")[0] if snp + 1 < len(alleles) and \
            "/" in alleles[snp + 1] else "."
        ncar = 0
        if len(m.branch) == 1:
            tree = anc.seq[m.tree].tree
            ncar = num_leaves_below(tree, int(m.branch[0]))
        rows.append(f"{up};{dn};{ncar}")
    return rows


def num_leaves_below(tree: Tree, v: int) -> int:
    N = tree.N
    if v < N:
        return 1
    stack = [v]
    n = 0
    while stack:
        u = stack.pop()
        if u < N:
            n += 1
        else:
            stack.append(int(tree.child_left[u]))
            stack.append(int(tree.child_right[u]))
    return n


def convert_newick_to_timeb(newick_path: str, out_path: str):
    """Sampled newicks of one tree -> binary .timeb node-age samples
    (RelateExtract --mode ConvertNewickToTimeb, extract/Convert.cpp:167):
    an int32 header (samples, 1, nodes), then each sample's node ages as
    float32."""
    from . import importers
    ages = []
    with open(newick_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ages.append(importers.newick_to_tree(line).coordinates())
    arr = np.asarray(ages, dtype=np.float32)
    S, M = arr.shape
    with open(out_path, "wb") as f:
        np.asarray([S, 1, M], dtype=np.int32).tofile(f)
        arr.tofile(f)
    return out_path

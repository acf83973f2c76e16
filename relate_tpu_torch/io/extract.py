"""Tree-sequence extraction utilities, the part the coalescence-rate tools
use.

Behavioral reference: ``include/extract/`` (RelateExtract.cpp:43-116
modes): AncMutForSubregion, RemoveTreesWithFewMutations and
ExtractDistFromMut. Host code over the in-memory tree sequence.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.topology import MutationRecord
from ..core.trees import AncesTree, MarginalTree


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

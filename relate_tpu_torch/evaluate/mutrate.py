"""Mutation-rate-through-time estimation.

Counterpart of ``relate_tpu/evaluate/mutrate.py``. Behavioral reference:
``include/evaluate/mutation_rate/`` — AvgMutationRate.cpp (:296-1010): per
epoch, mutations (each SNP's age interval [age_begin, age_end] spread
uniformly across epochs) over opportunity (total tree branch length in the
epoch times the bases each SNP accounts for); MutationDensity (:1015-)
walks one sample's root path. RelateMutationRate.cpp adds the 96
trinucleotide-context categories (cf. include/test/test_applications.cpp:
3-40) for the WithContext modes.

On ``device`` (None: the CUDA card), in float64:
- ``branch_length_in_epochs`` takes every tree of the sequence at once, as
  (T, M) node times and parents, and gives (T, E);
- ``spread_mutations`` spreads every SNP's interval at once;
- ``avg_mutation_rate`` takes the mutations as one product of the spread
  weights (n, E) and the SNPs' categories, and the opportunity as one
  product of the per-tree epoch lengths (T, E) and each tree's bases per
  category (T, C).
The category and context code and ``mutation_density`` (one root path) are
host code.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.topology import MutationRecord
from ..core.trees import AncesTree
from ..utils.devmem import batch_rows, resolve_device

BASES = "ACGT"


def mutation_categories() -> List[str]:
    """The 96 strand-collapsed trinucleotide context categories, in the
    reference's ordering (RelateMutationRate.cpp; test_applications.cpp)."""
    cats = []
    for up in BASES:
        for down in BASES:
            for anc in BASES:
                for der in BASES:
                    if anc != der:
                        cats.append(f"{up}{anc}{down}/{up}{der}{down}")
    # reference collapses strands: keep categories with ancestral in {C, T}
    out = [c for c in cats if c[1] in "CT"]
    assert len(out) == 96
    return out


def reverse_complement(s: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def collapse_category(up: str, anc: str, der: str, down: str) -> Optional[str]:
    """Map a mutation with context to its strand-collapsed category."""
    if anc not in BASES or der not in BASES or up not in BASES \
            or down not in BASES or anc == der:
        return None
    if anc in "CT":
        return f"{up}{anc}{down}/{up}{der}{down}"
    rc = reverse_complement(f"{up}{anc}{down}")
    rcd = reverse_complement(f"{up}{der}{down}")
    return f"{rc}/{rcd}"


def _epoch_bounds(epochs: np.ndarray, device):
    """(lower, upper) bounds of each epoch as float64 on ``device``; the
    last epoch is unbounded."""
    lo = np.asarray(epochs, np.float64)
    return (torch.from_numpy(lo).to(device),
            torch.from_numpy(np.append(lo[1:], np.inf)).to(device))


def branch_length_in_epochs(trees, epochs: np.ndarray,
                            sample_ages: Optional[np.ndarray] = None,
                            device=None) -> np.ndarray:
    """Total branch length of each tree within each epoch, (T, E) float64,
    on ``device`` (None: the CUDA card) for batches of trees at once."""
    device = resolve_device(device)
    T, E = len(trees), len(epochs)
    out = np.zeros((T, E))
    if T == 0:
        return out
    e_lo, e_hi = _epoch_bounds(epochs, device)
    M = trees[0].num_nodes
    # node times and parents, and a few (B, M) float64 temporaries a tree
    batch = batch_rows(M * 64, T, device, share=0.25)
    for s in range(0, T, batch):
        part = trees[s: s + batch]
        coords = torch.from_numpy(np.stack(
            [t.coordinates(sample_ages) for t in part])).to(device)
        par = torch.from_numpy(np.stack(
            [t.parent[:-1] for t in part]).astype(np.int64)).to(device)
        lo = coords[:, :-1]
        hi = torch.where(par >= 0,
                         torch.gather(coords, 1, par.clamp(min=0)), lo)
        blep = torch.stack(
            [(torch.minimum(hi, e_hi[e]) - torch.maximum(lo, e_lo[e]))
             .clamp(min=0.0).sum(dim=1) for e in range(E)], dim=1)
        out[s: s + len(part)] = blep.cpu().numpy()
    return out


def _spread_weights(ages: torch.Tensor, epochs_d: torch.Tensor,
                    e_hi: torch.Tensor) -> torch.Tensor:
    """(n, E) share of each mutation's [age_begin, age_end] in each epoch
    (AvgMutationRate.cpp:540-570); a point mutation (age_end <= age_begin)
    puts all of it into the epoch that holds age_begin."""
    E = len(epochs_d)
    ab, ae = ages[:, 0:1], ages[:, 1:2]
    bl = (ae - ab).clamp(min=1e-30)
    ov = (torch.minimum(ae, e_hi[None, :])
          - torch.maximum(ab, epochs_d[None, :])).clamp(min=0.0)
    w = ov / bl
    e = (torch.searchsorted(epochs_d, ages[:, 0].contiguous(), right=True)
         - 1).clamp(0, E - 1)
    point = (ae <= ab)
    one = (torch.arange(E, device=ages.device)[None, :] == e[:, None])
    return torch.where(point, one.to(w.dtype), w)


def spread_mutations(ages: np.ndarray, epochs: np.ndarray,
                     device=None) -> np.ndarray:
    """Spread each mutation's [age_begin, age_end] uniformly over epochs
    (AvgMutationRate.cpp:540-570). ages: (n, 2). Returns (E,) counts. On
    ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    epochs_d, e_hi = _epoch_bounds(epochs, device)
    a = torch.from_numpy(np.asarray(ages, np.float64).reshape(-1, 2)).to(
        device)
    return _spread_weights(a, epochs_d, e_hi).sum(dim=0).cpu().numpy()


def snp_bases(dist: np.ndarray) -> np.ndarray:
    """Bases accounted to each SNP: half the flanking gaps
    (AvgMutationRate count_bases)."""
    L = len(dist)
    b = np.zeros(L)
    b += 0.5 * dist
    b[1:] += 0.5 * dist[:-1]
    return b


def avg_mutation_rate(anc: AncesTree, muts: List[MutationRecord],
                      dist: np.ndarray, epochs: np.ndarray,
                      categories: Optional[np.ndarray] = None,
                      num_categories: int = 1, device=None):
    """Mutations / opportunity per epoch (optionally split by category), on
    ``device`` (None: the CUDA card).

    categories: per-SNP integer category (or None for a single category;
    SNPs of category -1 count nowhere).
    Returns (mutation (E, C), opportunity (E, C), rate (E, C))."""
    device = resolve_device(device)
    C = num_categories
    if categories is None:
        categories = np.zeros(len(muts), dtype=np.int64)
    categories = np.asarray(categories, dtype=np.int64)
    bases = snp_bases(dist)
    tree_of_snp = np.asarray([m.tree for m in muts], dtype=np.int64)
    ages = np.asarray([[m.age_begin, m.age_end] for m in muts],
                      dtype=np.float64).reshape(-1, 2)
    in_cat = (categories >= 0) & (categories < C)

    # mutations: only mapped, single-branch SNPs contribute
    mapped = np.asarray([len(m.branch) == 1 and m.age_end > 0 for m in muts],
                        dtype=bool)
    sel = np.nonzero(mapped & in_cat)[0]
    epochs_d, e_hi = _epoch_bounds(epochs, device)
    w = _spread_weights(torch.from_numpy(ages[sel]).to(device), epochs_d,
                        e_hi)                                     # (n, E)
    onehot = torch.zeros((len(sel), C), dtype=torch.float64, device=device)
    onehot[torch.arange(len(sel), device=device),
           torch.from_numpy(categories[sel]).to(device)] = 1.0
    mutation = (w.T @ onehot).cpu().numpy()

    # opportunity: per-tree epoch lengths times each tree's bases by
    # category
    T = len(anc.seq)
    per_tree = np.zeros((T, C))
    np.add.at(per_tree, (tree_of_snp[in_cat], categories[in_cat]),
              bases[in_cat])
    blep = branch_length_in_epochs([mt.tree for mt in anc.seq], epochs,
                                   anc.sample_ages, device)
    opportunity = (torch.from_numpy(blep).to(device).T
                   @ torch.from_numpy(per_tree).to(device)).cpu().numpy()

    with np.errstate(divide="ignore", invalid="ignore"):
        rate = np.where(opportunity > 0, mutation / opportunity, np.nan)
    return mutation, opportunity, rate


def categorize_snps(bp: np.ndarray, ancestral: List[str],
                    alternative: List[str], ancestor_seq: str
                    ) -> Tuple[np.ndarray, List[str]]:
    """Per-SNP trinucleotide-context category index from an ancestral-genome
    fasta (RelateMutationRate WithContext modes). -1 for unusable SNPs."""
    cats = mutation_categories()
    index = {c: i for i, c in enumerate(cats)}
    out = np.full(len(bp), -1, dtype=np.int64)
    n = len(ancestor_seq)
    for i, pos in enumerate(bp):
        p = int(pos) - 1          # bp is 1-based
        if p <= 0 or p + 1 >= n:
            continue
        up, down = ancestor_seq[p - 1], ancestor_seq[p + 1]
        a, d = ancestral[i], alternative[i]
        if len(a) != 1 or len(d) != 1:
            continue
        cat = collapse_category(up, a.upper(), d.upper(), down)
        if cat is not None and cat in index:
            out[i] = index[cat]
    return out, cats


def write_rate(path: str, epochs: np.ndarray, rate: np.ndarray):
    """<output>_avg.rate format: 'epoch rate' lines."""
    rate = np.atleast_2d(rate.T).T
    with open(path, "w") as f:
        for e in range(len(epochs)):
            r = rate[e, 0] if e < rate.shape[0] else np.nan
            f.write(f"{epochs[e]:g} {r:g}\n")


def mutation_density(anc: AncesTree, muts: List[MutationRecord],
                     dist: np.ndarray, epochs: np.ndarray, sample: int):
    """Per-epoch mutation counts and opportunity along one sample's
    root path (MutationDensity, AvgMutationRate.cpp:1015-). Host code: one
    walk up each tree."""
    E = len(epochs)
    out_m = np.zeros((len(anc.seq), E))
    out_o = np.zeros((len(anc.seq), E))
    S = np.zeros(len(dist) + 1)
    np.cumsum(dist, out=S[1:])
    e_lo = epochs
    e_hi = np.append(epochs[1:], np.inf)
    for t, mt in enumerate(anc.seq):
        tree = mt.tree
        coords = tree.coordinates(anc.sample_ages)
        node = sample
        total_age = coords[sample]
        while tree.parent[node] >= 0:
            bl = coords[tree.parent[node]] - coords[node]
            ne = float(tree.num_events[node])
            sb, se = int(tree.SNP_begin[node]), int(tree.SNP_end[node])
            persistence = S[se + 1] - S[sb]
            lo, hi = total_age, total_age + bl
            ov = np.clip(np.minimum(hi, e_hi) - np.maximum(lo, e_lo),
                         0.0, None)
            if bl > 0:
                out_m[t] += ne * ov / bl
            out_o[t] += persistence * ov
            total_age = hi
            node = int(tree.parent[node])
    return out_m, out_o

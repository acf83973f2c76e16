"""Tree-sequence topology building along a window ("section"): the host
builder of ``AncesTreeBuilder::BuildTopology``
(``include/src/anc_builder.cpp:397-656``) and the result records that it and
the device section builder (``core/topology_device.py``) share.

Counterpart of ``relate_tpu/core/topology.py``. The device builder serves the
default options; this one serves sample ages and an unknown ancestral allele
(``ancestral_state=False``, CLI ``--anc_allele_unknown``). Control flow per
SNP:

1. map the SNP's carriers onto the current marginal tree (on the host, for a
   block of ``BLOCK`` SNPs at once, ``core/mapmutation.py``);
2. if it maps to a single branch (possibly allele-flipped), record it and
   (for ``state`` SNPs) count the event on that branch;
3. otherwise (or on a ``--fb`` force interval) build a candidate tree on the
   device from the distance matrix at this SNP, with the same-rpos carrier
   penalty and the previous tree's clade-consistency prior, and keep it only
   if the SNP maps at least as well as on the old tree
   (anc_builder.cpp:621-646);
4. non-mappable SNPs get the multi-branch force-mapping.

One generator feeds two things with an unknown ancestral allele: the merge
seeds and the mapper's flip coins, one coin per SNP of every block mapped.
So the coins are drawn for the blocks of the JAX module (``BLOCK`` SNPs from
the SNP after each rebuild, one coin for each candidate tree): any other
slicing gives other seeds from the first rebuild on. What is mapped of a
block is its prefix up to the first SNP that asks for a rebuild, in pieces
of ``FIRST_PIECE``, then twice as many SNPs, and so on: a SNP's mapping does
not depend on the other SNPs of its block, so the records are those of the
whole block, and a rebuild every few SNPs does not cost a block of mapping.

Replicated reference quirks:
- carriers are collected for snp in [start, end): the final SNP of a section
  is always treated as carrying no mutation (anc_builder.cpp:408);
- on revert after a flipped mapping, the recorded ``flipped`` flag keeps the
  candidate tree's value (the reference's ``flipped == 1`` statement at
  anc_builder.cpp:625 is a comparison, not an assignment).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import mapmutation
from .distance import DistanceAssembler
from .painting import Checkpoint, Painter
from .treebuilder import (clade_prior_matrix, make_fused_rebuild,
                          quick_build, same_rpos_penalty, tree_from_merges)
from .trees import AncesTree, MarginalTree, Tree
from ..utils.trace import note

BLOCK = 1024       # SNPs a block, as the JAX module's
FIRST_PIECE = 16   # SNPs of a block mapped first


@dataclass
class MutationRecord:
    tree: int = 0
    branch: List[int] = field(default_factory=list)
    flipped: bool = False
    age_begin: float = 0.0
    age_end: float = 0.0

    @property
    def is_not_mapping(self) -> bool:
        return len(self.branch) > 1


@dataclass
class SectionResult:
    anc: AncesTree
    muts: List[MutationRecord]   # for snps [start, end]
    start: int
    end: int


def build_topology_section(painter: Painter, cp: Checkpoint,
                           G: np.ndarray, rpos: np.ndarray,
                           state: np.ndarray, bp: np.ndarray,
                           start: int, end: int, seed: int,
                           mode: int = 1, ancestral_state: bool = True,
                           fb: int = 0,
                           sample_ages: Optional[np.ndarray] = None,
                           paint=None) -> SectionResult:
    """Build the tree sequence for one window [start, end] (inclusive) on
    the painter's device. ``seed`` seeds the generator of the merge seeds
    (and of the flip coins when ``ancestral_state`` is False). ``paint`` may
    be a ready ``PaintOutput`` of this window; by default the window is
    repainted from ``cp``."""
    L, N = G.shape
    dev = painter.device
    theta = painter.model.theta
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if paint is None:
        paint = painter.repaint(cp)
    assembler = DistanceAssembler(G, rpos, nxt=_next_derived_rpos(
        G, rpos, start, end), nxt_start=start)
    dstate = assembler.init_state(paint.plan, start)

    # carriers matrix for the section; final SNP forced empty (quirk)
    car = G[start:end + 1].astype(np.uint8).copy()
    car[end - start] = 0
    car_row_sum = car.sum(axis=1)
    tree_builds = 0

    def coins(n):
        """The flip coins of n SNPs (unknown ancestral allele), or None."""
        return None if ancestral_state else rng.random(n)

    def build_first():
        mat = assembler.get_matrix(paint, dstate, start,
                                   is_first_or_last=(start == 0
                                                     or start == L - 1))
        if not ancestral_state:
            mat = 0.5 * (mat + mat.t())
        tr = quick_build(mat, theta=theta, seed=int(rng.integers(1 << 31)),
                         sample_ages=sample_ages, device=dev)
        tr.SNP_begin[:] = start
        return tr

    tree = build_first()
    tree_builds += 1
    leafmat = tree.leaf_matrix()
    mapper = mapmutation.TreeMapper(tree, leafmat)
    kcol_dev = t(np.arange(N, dtype=np.int64))
    fused = make_fused_rebuild(theta, N, mode, ancestral_state)
    muts = [MutationRecord() for _ in range(end - start + 1)]
    anc = AncesTree(N=N, seq=[MarginalTree(pos=start, tree=tree)])

    def apply_mapping(tr: Tree, snp: int, r, rec: MutationRecord):
        """Record a block-map result for one SNP and update num_events."""
        im = int(r.is_mapping)
        b = int(r.branch)
        rec.flipped = bool(r.flipped)
        if im in (1, 2):
            rec.branch = [b] if b >= 0 else []
            if b == 2 * N - 2 and int(car_row_sum[snp - start]) == N:
                tr.num_events[b] += 1.0       # root case: always counted
            elif b >= 0 and state[snp]:
                tr.num_events[b] += 1.0
        return im

    # map the first SNP
    res0 = mapper(car[:1], coins(1))
    muts[0].tree = 0
    im0 = apply_mapping(tree, start, _row(res0, 0), muts[0])
    if im0 > 2:
        brs, flp = mapmutation.force_map_mutation(tree, car[0].astype(bool))
        muts[0].branch = brs
        muts[0].flipped = flp

    num_tree = 1
    s = start + 1
    # force-build flags (anc_builder.cpp:522-526)
    force = np.zeros(end - start + 1, dtype=bool)
    if fb > 0:
        idxs = np.arange(start + 1, end)
        force[idxs - start] = (bp[idxs + 1] // fb - bp[idxs] // fb) >= 1

    while s <= end:
        blk_end = min(s - start + BLOCK, end - start + 1)
        blk = slice(s - start, blk_end)
        res, bad_rel = _map_to_first_rebuild(mapper, car[blk], force[blk],
                                             coins(blk_end - (s - start)))
        n_ok = bad_rel[0] if len(bad_rel) else (blk_end - (s - start))

        # commit cleanly-mapped SNPs s .. s+n_ok-1
        for i in range(n_ok):
            snp = s + i
            rec = muts[snp - start]
            rec.tree = num_tree - 1
            apply_mapping(tree, snp, _row(res, i), rec)
        # advance distance-row state through the committed range (and the
        # rebuild SNP itself, whose carriers advance before GetMatrix)
        upto = s + n_ok if len(bad_rel) else s + n_ok - 1
        if upto >= s:
            _advance_state(dstate, car, rpos, start, s, min(upto, end))
        if not len(bad_rel):
            s = s + n_ok
            continue

        snp = s + n_ok
        rec = muts[snp - start]
        rec.tree = num_tree - 1
        r = _row(res, n_ok)
        im = apply_mapping(tree, snp, r, rec)
        min_value = float(r.min_value)
        frc = bool(force[snp - start])
        prev_branch = rec.branch[0] if (im == 2 or (im == 1 and frc)) \
            and rec.branch else -1

        # candidate tree: distance assembly, penalties, the previous tree's
        # clade prior and the merge scan on the device
        is_fl = snp == 0 or snp == L - 1
        if sample_ages is None:
            rows, is_exact, wl, wr = assembler.matrix_inputs(dstate, snp,
                                                             is_fl)
            cis, cjs = fused(paint.topology, paint.logscale, t(rows),
                             t(is_exact), t(wl), t(wr), kcol_dev,
                             t(car[snp - start]), t(leafmat),
                             int(rng.integers(1 << 31)))
            newtree = tree_from_merges(cis.cpu().numpy(), cjs.cpu().numpy(),
                                       N)
        else:
            # the age-aware builder, its inputs assembled step by step
            mat = assembler.get_matrix(paint, dstate, snp, is_fl)
            if not ancestral_state:
                mat = 0.5 * (mat + mat.t())
            mat = same_rpos_penalty(mat, [np.nonzero(car[snp - start])[0]],
                                    theta)
            d_cf = clade_prior_matrix(tree, theta, device=dev) \
                if mode == 1 else None
            newtree = quick_build(mat, d_cf=d_cf, theta=theta,
                                  seed=int(rng.integers(1 << 31)),
                                  sample_ages=sample_ages, device=dev)
        tree_builds += 1
        new_leafmat = newtree.leaf_matrix()
        new_mapper = mapmutation.TreeMapper(newtree, new_leafmat)
        res_alt = new_mapper(car[snp - start: snp - start + 1], coins(1))
        ra = _row(res_alt, 0)
        im_alt = int(ra.is_mapping)
        min_alt = float(ra.min_value)

        if im_alt > 1 and min_alt >= min_value and not frc:
            # keep old tree (anc_builder.cpp:621-629)
            if im == 2:
                rec.branch = [prev_branch]
                rec.flipped = bool(ra.flipped)   # reference quirk (== bug)
            if im > 2:
                brs, flp = mapmutation.force_map_mutation(
                    tree, car[snp - start].astype(bool))
                rec.branch = brs
                rec.flipped = flp
        else:
            # accept new tree (anc_builder.cpp:630-646)
            apply_mapping(newtree, snp, ra, rec)
            if (im == 2 or (im == 1 and frc)) and prev_branch >= 0 \
                    and state[snp]:
                tree.num_events[prev_branch] -= 1.0
            if im_alt > 2:
                brs, flp = mapmutation.force_map_mutation(
                    newtree, car[snp - start].astype(bool))
                rec.branch = brs
                rec.flipped = flp
            rec.tree = num_tree
            tree.SNP_end[:] = snp
            newtree.SNP_begin[:] = snp
            anc.seq.append(MarginalTree(pos=snp, tree=newtree))
            tree = newtree
            leafmat = new_leafmat
            mapper = new_mapper
            num_tree += 1

        s = snp + 1

    tree.SNP_end[:] = end
    # a reverted candidate was built and is no tree of the section
    note("topology", dict(trees=num_tree, tree_builds=tree_builds))
    return SectionResult(anc=anc, muts=muts, start=start, end=end)


def _next_derived_rpos(G, rpos, start, end):
    """(end - start + 1, N) float64: for each SNP of the section and each
    target, the rpos of the target's first non-zero allele at or after the
    SNP, or of the chunk's last SNP where there is none. This is what
    ``DistanceAssembler.matrix_inputs`` otherwise finds one stale target at
    a time."""
    L, N = G.shape
    after = np.full(N, L - 1)
    if end + 1 < L:
        tail = G[end + 1:] != 0
        after = np.where(tail.any(axis=0), end + 1 + tail.argmax(axis=0),
                         L - 1)
    idx = np.where(G[start:end + 1] != 0,
                   np.arange(start, end + 1)[:, None], after[None, :])
    idx = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    return np.asarray(rpos, dtype=np.float64)[idx]


def _map_to_first_rebuild(mapper, car_blk, force_blk, coins):
    """Map a block's SNPs in growing pieces until a piece holds a SNP that
    asks for a rebuild (not mapping to one branch, or forced). Returns the
    mapped prefix's ``MapResult`` and the rebuild SNPs found in it (block
    offsets, ascending; empty if the whole block maps)."""
    n = len(car_blk)
    parts = []
    lo, size = 0, FIRST_PIECE
    while lo < n:
        hi = min(lo + size, n)
        res = mapper(car_blk[lo:hi], None if coins is None else coins[lo:hi])
        parts.append(res)
        bad = np.nonzero((res.is_mapping > 1) | force_blk[lo:hi])[0]
        if len(bad):
            break
        lo, size = hi, 2 * size
    res = mapmutation.MapResult(*(np.concatenate(f) for f in zip(*parts)))
    return res, np.nonzero((res.is_mapping > 1) | force_blk[:len(res[0])])[0]


def _row(res: mapmutation.MapResult, i: int) -> mapmutation.MapResult:
    """Row ``i`` of a block-map result."""
    return mapmutation.MapResult(*(a[i] for a in res))


def _advance_state(dstate, car, rpos, start, s, upto):
    """Advance v_snp_prev / v_rpos_prev through snps [s, upto] inclusive."""
    lo = s - start
    hi = upto - start + 1
    block = car[lo:hi]                       # (n, N)
    counts = block.sum(axis=0).astype(np.int64)
    dstate.row[:] += counts
    # last carrier snp per target within the block
    n, N = block.shape
    if n > 0:
        rev = block[::-1].argmax(axis=0)
        has = block.any(axis=0)
        last_rel = (n - 1 - rev)
        snps = s + last_rel
        dstate.rpos_prev[has] = rpos[snps[has]]

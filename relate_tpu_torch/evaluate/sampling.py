"""Branch-length posterior sampling and whole-chromosome re-estimation.

Counterpart of ``relate_tpu/evaluate/sampling.py``. Behavioral reference:
``include/evaluate/coalescent_rate/ReEstimateBranchLengths.cpp`` —
ReEstimateBranchLengths (:35-407) reruns the MCMC on a final .anc/.mut under
a .coal prior; SampleBranchLengths (:409-1107) draws posterior samples every
``num_proposals`` (default ``1000*max(N/10,10)``, :683) after an initial
converged run, writing per-sample anc/mut, newick, or the binary .timeb
format.

All trees sample in lockstep (the chains of ``core/mcmc.py`` on the card);
a sample is one download of the chains' node ages.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..core import mcmc
from ..core.topology import MutationRecord
from ..core.trees import AncesTree
from ..parallel.mesh import device_and_mesh
from ..utils.trace import note


def _normalized_prior(epochs, rates):
    """(average Ne, rates times it, epochs over it): the .coal prior in
    units of the average Ne, 1 / the mean of the positive finite rates."""
    rts = np.asarray(rates, dtype=np.float64)
    pos = rts[np.isfinite(rts) & (rts > 0)]
    avg_ne = 1.0 / pos.mean()
    return avg_ne, np.where(np.isfinite(rts) & (rts > 0), rts, 0.0) * avg_ne, \
        np.asarray(epochs, dtype=np.float64) / avg_ne


def reestimate_branch_lengths(anc: AncesTree, muts: List[MutationRecord],
                              dist: np.ndarray, mu: float,
                              epochs: np.ndarray, rates: np.ndarray,
                              seed: int = 1,
                              group_rates: Optional[np.ndarray] = None,
                              memberships: Optional[np.ndarray] = None,
                              device=None):
    """Re-run the branch-length MCMC under a .coal prior, in place, on
    ``device`` (None: the CUDA card).

    With ``group_rates`` (E, G, G) and per-haplotype ``memberships``, the
    prior uses pairwise group coalescence rates
    (EstimateBranchLengthsWithSampleAge::MCMCCoalRatesForRelate)."""
    avg_ne, r_norm, e_norm = _normalized_prior(epochs, rates)
    trees = [mt.tree for mt in anc.seq]
    group_R = None
    if group_rates is not None:
        # normalize the pair matrix by the same average Ne so times stay in
        # Ne-generations units (ReEstimateBranchLengths.cpp:202-218)
        gr = np.asarray(group_rates, dtype=np.float64)
        group_R = np.where(np.isfinite(gr) & (gr > 0), gr, 0.0) * avg_ne
    bl = mcmc.run_mcmc(trees, dist.astype(np.float64), len(muts),
                       Ne=avg_ne, mu=mu, seed=seed,
                       epochs=e_norm, rates=r_norm,
                       group_R=group_R, memberships=memberships,
                       device=device)
    for i, mt in enumerate(anc.seq):
        mt.tree.branch_length = bl[i]
    return anc


def sample_branch_lengths(anc: AncesTree, muts: List[MutationRecord],
                          dist: np.ndarray, mu: float,
                          epochs: np.ndarray, rates: np.ndarray,
                          num_samples: int = 100,
                          num_proposals: Optional[int] = None,
                          seed: int = 1, device=None,
                          mesh=None) -> np.ndarray:
    """Posterior samples of branch lengths for every tree, on ``device``
    (None: the CUDA card).

    The chains run to convergence under the piecewise prior (the
    reference's init=1 converged run), then each sample is ``num_proposals``
    proposals more without accumulation, and one download of the node ages.
    Batches above ``mcmc.chain_batch_cap`` run in parts with their own
    seeds. Each part adds one dict (chains, nodes, rounds, converged,
    device) under ``mcmc`` to the record of the ``utils.trace`` stage it
    runs in.

    ``mesh`` (a ``parallel.mesh.Mesh``, the tools' ``--devices``) runs on
    its first card. A part's chains are launch-bound on the host, so no
    way of using more cards from this process was faster: ``run_mcmc
    (mesh=)``, which cuts one batch over the cards, was 11.1–13.6 times
    slower than one card, and four whole parts of 256 chains at N = 2048
    took 5.878 s on one card, 6.399 s dealt to four cards from one thread
    and 33.149 s from a thread a card (NVIDIA H100 80GB HBM3, 700 W;
    ``chip_smoke.py --phases dealing``, ``sample_parts``). A process a
    card for the chain parts is ROADMAP item 4b-iii.
    Returns (num_samples, num_trees, 2N-1) branch lengths in generations."""
    device, _ = device_and_mesh(device, mesh)
    trees = [mt.tree for mt in anc.seq]
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    L = len(muts)
    cap = mcmc.chain_batch_cap(M)
    if B > cap:
        outs = []
        for s in range(0, B, cap):
            sub = AncesTree(N=anc.N, seq=anc.seq[s: s + cap],
                            sample_ages=anc.sample_ages)
            outs.append(sample_branch_lengths(
                sub, muts, dist, mu, epochs, rates,
                num_samples=num_samples, num_proposals=num_proposals,
                seed=seed + 7 * (s + 1), device=device))
        return np.concatenate(outs, axis=1)
    if num_proposals is None:
        num_proposals = 1000 * int(max(N / 10.0, 10.0))
    avg_ne, r_norm, e_norm = _normalized_prior(epochs, rates)
    delta = int(max(N / 10.0, 10.0))

    st = mcmc.chain_static(trees, dist, L, avg_ne, mu, e_norm, r_norm,
                           device)
    tie = mcmc.Draws(seed ^ 0x5BF03A7, device).uniform(B, M, high=0.99)
    state, _ = mcmc.device_init_state(st.parent, N, tie, st.depth)
    draws = mcmc.Draws(seed, device)
    # burn-in to convergence (the reference's init=1 converged run,
    # SampleBranchLengths -> EstimateBranchLengths init pass)
    state, rounds, conv = mcmc.run_to_convergence(
        st, state, draws, 50 * delta, max(delta, 128), 2000, True)
    note("mcmc", dict(chains=B, nodes=M, rounds=rounds,
                      converged=int(conv.sum().item()), device=str(device)))

    # num_proposals is a proposal budget in the reference's units
    iters = max(8, int(np.ceil(num_proposals
                               / mcmc.proposals_per_iteration(N, M))))
    aux = mcmc.sweep_aux(st)
    parent = st.parent.cpu().numpy()
    p = np.maximum(parent, 0)
    out = np.empty((num_samples, B, M), dtype=np.float64)
    for s in range(num_samples):
        state = mcmc.run(st, state, draws, iters, True, False, aux=aux)
        coords = state.coords.cpu().numpy().astype(np.float64)
        bl = np.where(parent >= 0, avg_ne * (np.take_along_axis(
            coords, p, axis=1) - coords), 0.0)
        out[s] = np.maximum(bl, 0.0)
    return out


def write_newick_samples(path: str, anc: AncesTree, samples: np.ndarray,
                         tree_index: int = 0):
    """One newick line per posterior sample of one tree."""
    with open(path, "w") as f:
        for s in range(samples.shape[0]):
            t = anc.seq[tree_index].tree.copy()
            t.branch_length = samples[s, tree_index]
            f.write(t.to_newick() + "\n")


def _preorder(tree):
    """(pre (M,), size (M,)): pre-order rank and subtree size of every
    node; v is in the subtree of b iff pre[b] <= pre[v] < pre[b] + size[b]."""
    M = tree.num_nodes
    pre = np.empty(M, dtype=np.int64)
    size = np.ones(M, dtype=np.int64)
    stack = [tree.root]
    k = 0
    while stack:
        v = stack.pop()
        pre[v] = k
        k += 1
        if tree.child_left[v] >= 0:
            stack.append(int(tree.child_right[v]))
            stack.append(int(tree.child_left[v]))
    for v in np.argsort(-pre):
        if tree.child_left[v] >= 0:
            size[v] += size[tree.child_left[v]] + size[tree.child_right[v]]
    return pre, size


def write_timeb(path: str, anc: AncesTree, samples: np.ndarray,
                muts=None, bp=None, alleles=None):
    """Byte-compatible .timeb (SampleBranchLengthsBinary,
    ReEstimateBranchLengths.cpp:1310-1453 / parse_timeb.py):

    header ``int32 num_mapping_SNPs, int32 num_samples``; then per SNP with
    <= 1 mapped branch: ``int32 BP, char anc_allele, char der_allele,
    int32 DAF, int32 N``, followed by ``float32
    anctimes[num_samples * max(0, N-DAF-1)]`` (sorted coalescence ages of
    internal nodes outside the derived clade, excluding the mapped
    branch's parent, per sample) and ``float32
    dertimes[num_samples * max(0, DAF-1)]`` (sorted ages within the
    derived clade).

    Without ``muts`` every tree is written once as a root-mapped pseudo-SNP
    (DAF=N: all internal ages are dertimes).

    A tree's internal node ages are sorted once per sample; a record takes
    the sorted ages of the nodes in and out of its branch's subtree (a
    pre-order range), which are the sorted ages of those sets."""
    S, T, M = samples.shape
    N = anc.N
    root = 2 * N - 2

    if muts is None:
        muts = [MutationRecord(tree=t, branch=[root]) for t in range(T)]
        bp = np.arange(T)
        alleles = ["N/N"] * T

    recs = [(snp, m) for snp, m in enumerate(muts) if len(m.branch) <= 1]
    per_tree = {}

    def tree_data(t):
        if t not in per_tree:
            per_tree.clear()
            tree = anc.seq[t].tree
            # Tree.coordinates under each sample's lengths (the same bits)
            rows = [torch.from_numpy(np.repeat(a[None].astype(np.int64), S, 0))
                    for a in (tree.child_left, tree.child_right, tree.parent)]
            ages = mcmc.node_ages(rows[0], rows[1],
                                  mcmc.clade_levels(rows[2], N),
                                  torch.from_numpy(samples[:, t].astype(
                                      np.float64)), anc.sample_ages).numpy()
            internal = np.arange(N, M)
            nodes = internal[np.argsort(ages[:, N:], axis=1, kind="stable")]
            pre, size = _preorder(tree)
            per_tree[t] = (tree, np.take_along_axis(ages, nodes, axis=1),
                           nodes, pre[nodes], pre, size)
        return per_tree[t]

    with open(path, "wb") as f:
        f.write(struct.pack("ii", len(recs), S))
        for snp, m in recs:
            tree, srt, nodes, pre_n, pre, size = tree_data(m.tree)
            al = alleles[snp] if alleles is not None else "N/N"
            anc_a = (al.split("/")[0] or "N")[0] if al else "N"
            der_a = (al.split("/")[1] or "N")[0] if "/" in al else "N"
            if len(m.branch) == 1:
                b = int(m.branch[0])
                sub = (pre_n >= pre[b]) & (pre_n < pre[b] + size[b])
                daf = int(((pre[:N] >= pre[b])
                           & (pre[:N] < pre[b] + size[b])).sum()) \
                    if b != root else N
                par = int(tree.parent[b]) if b != root else -1
            else:
                daf = 0
                sub = np.zeros(nodes.shape, dtype=bool)
                par = -1
            f.write(struct.pack("i", int(bp[snp]) if bp is not None
                                else snp))
            f.write(anc_a.encode()[:1] or b"N")
            f.write(der_a.encode()[:1] or b"N")
            f.write(struct.pack("ii", daf, N))
            anct = srt[~sub & (nodes != par)].reshape(S, -1).astype(
                np.float32)
            dert = srt[sub].reshape(S, -1).astype(np.float32)
            anct[:, : max(0, N - daf - 1)].tofile(f)
            dert[:, : max(0, daf - 1)].tofile(f)


def read_timeb(path: str):
    """parse_timeb.py equivalent: read a .timeb into a list of records
    {bp, anc_allele, der_allele, daf, N, anctimes (S, N-DAF-1),
    dertimes (S, DAF-1)}."""
    out = []
    with open(path, "rb") as f:
        num_snps, S = struct.unpack("ii", f.read(8))
        for _ in range(num_snps):
            bp_v = struct.unpack("i", f.read(4))[0]
            anc_a = f.read(1).decode(errors="replace")
            der_a = f.read(1).decode(errors="replace")
            daf, N = struct.unpack("ii", f.read(8))
            na = max(0, N - daf - 1)
            nd = max(0, daf - 1)
            anct = np.fromfile(f, dtype=np.float32,
                               count=S * na).reshape(S, na)
            dert = np.fromfile(f, dtype=np.float32,
                               count=S * nd).reshape(S, nd)
            out.append({"bp": bp_v, "anc_allele": anc_a,
                        "der_allele": der_a, "daf": daf, "N": N,
                        "anctimes": anct, "dertimes": dert})
    return out

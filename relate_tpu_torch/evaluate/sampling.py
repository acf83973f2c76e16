"""Branch-length posterior sampling and whole-chromosome re-estimation.

Counterpart of ``relate_tpu/evaluate/sampling.py``. Behavioral reference:
``include/evaluate/coalescent_rate/ReEstimateBranchLengths.cpp`` —
ReEstimateBranchLengths (:35-407) reruns the MCMC on a final .anc/.mut under
a .coal prior; SampleBranchLengths (:409-1107) draws posterior samples every
``num_proposals`` (default ``1000*max(N/10,10)``, :683) after an initial
converged run, writing per-sample anc/mut, newick, or the binary .timeb
format.

All trees of a part sample in lockstep (the chains of ``core/mcmc.py`` on
the card); a sample is one download of the chains' node ages. Parts of
``mcmc.chain_batch_cap`` trees run one after another on one card, or each
in a process of its own on a card of a mesh (``parallel.pool.CardPool``).
"""
from __future__ import annotations

import struct
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import mcmc
from ..core.topology import MutationRecord
from ..core.trees import AncesTree
from ..parallel.mesh import device_and_mesh
from ..parallel.pool import HERE, CardPool
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
                              device=None, pool: Optional[CardPool] = None):
    """Re-run the branch-length MCMC under a .coal prior, in place, on
    ``device`` (None: the CUDA card), or with its parts above
    ``mcmc.chain_batch_cap`` on the workers of ``pool`` (``mcmc.run_mcmc
    (pool=)``).

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
                       device=device, pool=pool)
    for i, mt in enumerate(anc.seq):
        mt.tree.branch_length = bl[i]
    return anc


def sample_branch_lengths(anc: AncesTree, muts: List[MutationRecord],
                          dist: np.ndarray, mu: float,
                          epochs: np.ndarray, rates: np.ndarray,
                          num_samples: int = 100,
                          num_proposals: Optional[int] = None,
                          seed: int = 1, device=None,
                          mesh=None, pool: Optional[CardPool] = None
                          ) -> np.ndarray:
    """Posterior samples of branch lengths for every tree, on ``device``
    (None: the CUDA card).

    The chains run to convergence under the piecewise prior (the
    reference's init=1 converged run), then each sample is ``num_proposals``
    proposals more without accumulation, and one download of the node ages.
    The trees run in parts of ``mcmc.chain_batch_cap`` chains, the part
    that starts at tree s with the seed ``seed + 7 * (s + 1)`` (one part:
    ``seed``), whatever runs them (``sample_part``). Each part adds one dict
    (chains, nodes, rounds, converged, device, seconds) under ``mcmc`` to
    the record of the ``utils.trace`` stage it runs in.

    With a ``pool`` (``parallel.pool.CardPool``) every part goes to its
    workers, one process a card, in part order; with a ``mesh`` (a
    ``parallel.mesh.Mesh``, the tools' ``--devices``) of more than one
    device and at least two parts, a pool of the mesh's own for this call.
    Otherwise the parts run here on the first card and no process starts.
    The chains are launch-bound on the host, so more cards from one process
    were no faster (four parts of 256 chains at N = 2048 took 5.878 s on
    one card, 6.399 s dealt to four cards from one thread and 33.149 s from
    a thread a card; NVIDIA H100 80GB HBM3, 700 W, PERF.md §5). A part is
    never cut over cards (that would change its draws), so the samples are
    one device's bit for bit. A part sends its trees' rows (24 bytes a
    node: 25 MB a part of 256 trees at N = 2048) and a worker returns its
    float32 node ages; the float64 lengths are formed here, with the
    arithmetic of one device and half the bytes through the pipe. On four
    H100s four such parts took 2.064 s through a warm pool against 3.565 s
    on one card, each part 0.77–1.09 s in its worker (PERF.md §5).
    Returns (num_samples, num_trees, 2N-1) branch lengths in generations."""
    device, mesh = device_and_mesh(
        device, pool.mesh if pool is not None and mesh is None else mesh)
    trees = [mt.tree for mt in anc.seq]
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    if num_proposals is None:
        num_proposals = 1000 * int(max(N / 10.0, 10.0))
    cap = mcmc.chain_batch_cap(M)
    starts = range(0, B, cap)
    seeds = [seed + 7 * (s + 1) for s in starts] if B > cap else [seed]
    if pool is None and mesh is not None and len(mesh) > 1 and B > cap:
        with CardPool(mesh) as own:
            return sample_branch_lengths(
                anc, muts, dist, mu, epochs, rates, num_samples=num_samples,
                num_proposals=num_proposals, seed=seed, pool=own)
    jobs = [(mcmc.chain_rows(trees[s: s + cap]), dist, len(muts), mu,
             epochs, rates, num_samples, num_proposals, sd)
            for s, sd in zip(starts, seeds)]
    if pool is not None:
        pool.note_start()
        ages = pool.map(sample_part, [job + (HERE,) for job in jobs])
    else:
        ages = [sample_part(*job, device) for job in jobs]
    avg_ne = _normalized_prior(epochs, rates)[0]
    out = np.empty((num_samples, B, M), dtype=np.float64)
    for s, job, coords32 in zip(starts, jobs, ages):
        parent = job[0]["parent"].astype(np.int64)
        p = np.maximum(parent, 0)
        for k in range(num_samples):
            coords = coords32[k].astype(np.float64)
            bl = np.where(parent >= 0, avg_ne * (np.take_along_axis(
                coords, p, axis=1) - coords), 0.0)
            out[k, s: s + len(parent)] = np.maximum(bl, 0.0)
    return out


def sample_part(rows: dict, dist: np.ndarray, L: int, mu: float,
                epochs: np.ndarray, rates: np.ndarray, num_samples: int,
                num_proposals: int, seed: int, device) -> np.ndarray:
    """The chains of one part of ``sample_branch_lengths`` on ``device``,
    the trees given as ``mcmc.chain_rows``: run in the caller or as a
    ``parallel.pool.CardPool`` task. Everything it reads comes in its
    arguments (a stand-in set in the caller never reaches a worker).
    Notes the part's chains, rounds, converged chains, device and seconds
    under ``mcmc``. Returns the (num_samples, B, M) float32 node ages
    (units of the average Ne) of every sample."""
    t0 = time.time()
    trees = mcmc.trees_of_rows(rows)
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
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

    # num_proposals is a proposal budget in the reference's units
    iters = max(8, int(np.ceil(num_proposals
                               / mcmc.proposals_per_iteration(N, M))))
    aux = mcmc.sweep_aux(st)
    out = np.empty((num_samples, B, M), dtype=np.float32)
    for s in range(num_samples):
        state = mcmc.run(st, state, draws, iters, True, False, aux=aux)
        out[s] = state.coords.cpu().numpy()
    note("mcmc", dict(chains=B, nodes=M, rounds=rounds,
                      converged=int(conv.sum().item()), device=str(device),
                      wall_s=round(time.time() - t0, 3)))
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

"""Coalescence-rate estimation and the population-size EM.

Counterpart of ``relate_tpu/evaluate/coalrate.py``. Behavioral reference:
``include/evaluate/coalescent_rate/`` — CoalescentRateForSection.cpp
(pairwise per-epoch coalescence counts and opportunity, :17-120; epoch
grids :300-380), FinalizePopulationSize.cpp (rate = sum counts / sum
opportunity, whole-sample :13-110 / by group :138),
SummarizeCoalescentRateForGenome.cpp (cross-chromosome sum) and the EM loop
of scripts/EstimatePopulationSize/EstimatePopulationSize.sh (re-estimate
branch lengths under .coal <-> re-estimate rates, default 10 iterations).

The reference accumulates N x N float matrices per epoch through a per-tree
recursion. Here each internal node contributes its cross-clade pair block in
*group space*: with the clade-by-group counts ``C`` (M, G) of a tree, the
per-epoch statistics of a node are the outer product of its two children's
rows. On the device (``coalescence_stats``):

- ``C`` is propagated level by level, deepest first (``mcmc.clade_levels``,
  ``mcmc.sum_over_clades``: the counts are integers, so any order of the
  sums gives the same values), and the node ages likewise from the branch
  lengths (``mcmc.node_ages``);
- the nodes of a batch are grouped by epoch, and one float64 product per
  epoch that has nodes weights each node's pair block by its tree's factor
  (and by the node's time in its own epoch, for the opportunity); the
  opportunity of the epochs below a node's is the epoch width times the
  sum of the later epochs' blocks;
- only (E, G, G) leaves the card, and batches accumulate in float64.

``_coalescence_stats_host`` keeps the reference's per-tree recursion as the
plain twin (``use_device=False``).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import mcmc
from ..core.topology import MutationRecord
from ..core.trees import AncesTree, topological_order
from ..parallel.mesh import device_and_mesh
from ..parallel.pool import CardPool
from ..utils.devmem import batch_rows, resolve_device
from ..utils.trace import note, stage

# the share of the card's free memory one batch of coalescence_stats may use
BATCH_MEMORY_SHARE = 0.5


# ---------------------------------------------------------------------------
# epoch grids (CoalescentRateForSection.cpp:300-380)
# ---------------------------------------------------------------------------

def default_epochs(years_per_gen: float = 28.0) -> np.ndarray:
    num_epochs = 31
    e = np.zeros(num_epochs)
    e[1] = 1e3 / years_per_gen
    for i in range(2, num_epochs - 1):
        e[i] = 10 ** (3.0 + 4.0 * (i - 1.0) / (num_epochs - 3.0)) \
            / years_per_gen
    e[num_epochs - 1] = 1e8 / years_per_gen
    return e


def epochs_from_bins(lower: float, upper: float, step: float,
                     years_per_gen: float = 28.0) -> np.ndarray:
    """--bins lower,upper,step in log10 years."""
    out = [0.0]
    b = lower
    while b < upper:
        out.append(10 ** b / years_per_gen)
        b += step
    out.append(10 ** upper / years_per_gen)
    out.append(max(1e8, 10.0 * out[-1] * years_per_gen) / years_per_gen)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# per-tree spans (AncMutIterators::NextTree, mutations.cpp:853-908)
# ---------------------------------------------------------------------------

def tree_spans(anc: AncesTree, muts: List[MutationRecord],
               dist: np.ndarray) -> np.ndarray:
    """num_bases_tree_persists per tree: sum of its SNPs' dist, plus half of
    the preceding SNP's dist, minus half of its last SNP's dist (interior
    trees); 0 for trees without mutations."""
    T = len(anc.seq)
    L = len(muts)
    spans = np.zeros(T)
    tree_of_snp = np.asarray([m.tree for m in muts])
    for t in range(T):
        snps = np.nonzero(tree_of_snp == t)[0]
        if len(snps) == 0:
            continue
        s = float(dist[snps].sum())
        if snps[0] > 0:
            s += dist[snps[0] - 1] / 2.0
        if snps[-1] < L - 1:
            s -= dist[snps[-1]] / 2.0
        spans[t] = s
    return spans


# ---------------------------------------------------------------------------
# sufficient statistics
# ---------------------------------------------------------------------------

def _epoch_overlap(epochs: np.ndarray, t: float) -> np.ndarray:
    """Per-epoch length of [0, t] intersected with each epoch.

    Convention (matches the .coal format): one interval per boundary,
    interval i = [epochs[i], epochs[i+1]), the last extending to infinity.
    """
    lo = epochs
    hi = np.append(epochs[1:], np.inf)
    return np.clip(np.minimum(hi, t) - lo, 0.0, None)


class _Nodes:
    """The internal nodes of a batch of trees on the device, sorted by the
    epoch of their age: ``C`` (B*M, G) float32 clade-by-group counts (exact
    integers), ``left``/``right`` the flat rows of each node's two children
    in ``C``, ``tree`` the batch index of each node's tree, ``e`` its epoch,
    ``dt`` its time within that epoch (float64), ``sizes`` the nodes of
    each epoch (host list) and ``levels`` the depth levels of the batch."""

    def __init__(self, trees, idx, onehot, epochs_d, sample_ages, device):
        def up(field, dt):
            return torch.from_numpy(np.stack(
                [getattr(trees[i], field) for i in idx]).astype(dt)).to(
                    device)
        cl, cr = up("child_left", np.int64), up("child_right", np.int64)
        B, M = cl.shape
        N = onehot.shape[0]
        levels = mcmc.clade_levels(up("parent", np.int64), N)
        self.levels = len(levels)
        self.C = mcmc.sum_over_clades(cl, cr, levels, onehot).view(B * M, -1)
        t = mcmc.node_ages(cl, cr, levels, up("branch_length", np.float64),
                           sample_ages)[:, N:].reshape(-1)
        E = len(epochs_d)
        e = (torch.searchsorted(epochs_d, t, right=True) - 1).clamp(0, E - 1)
        order = torch.argsort(e, stable=True)
        off = torch.arange(B, device=device)[:, None] * M
        self.left = (cl[:, N:] + off).reshape(-1)[order]
        self.right = (cr[:, N:] + off).reshape(-1)[order]
        self.tree = order // (M - N)
        self.e = e[order]
        self.dt = (t - epochs_d[e])[order]
        self.sizes = torch.bincount(e, minlength=E).tolist()


def _opportunity(P, R, epochs_d):
    """Opportunity per epoch from the pair blocks P[e] of the nodes in
    epoch e and R[e], the same weighted by each node's time within its
    epoch: a node of epoch e' adds the whole width of every epoch below e'
    (the last epoch, unbounded, lies below none)."""
    later = torch.flip(torch.cumsum(torch.flip(P[1:], [0]), 0), [0])
    width = torch.diff(epochs_d)
    opp = R.clone()
    opp[:-1] += width.view(-1, *([1] * (P.dim() - 1))) * later
    return opp


def _stats_batch(nodes: _Nodes, f, PR):
    """Adds the factor-weighted pair blocks of one batch to ``PR`` (E, 2G,
    G) float64 on its device: the counts P in ``PR[:, :G]`` and in
    ``PR[:, G:]`` R, the same weighted by each node's time within its
    epoch; one product a non-empty epoch. ``f`` (B,) float64 factors."""
    C = nodes.C
    G = C.shape[1]
    n = len(nodes.e)
    X = torch.empty((n, 2 * G), dtype=torch.float64, device=C.device)
    X[:, :G] = C.index_select(0, nodes.left)
    X[:, :G] *= f[nodes.tree][:, None]
    torch.mul(X[:, :G], nodes.dt[:, None], out=X[:, G:])
    Bs = C.index_select(0, nodes.right).double()
    s = 0
    for k, m in enumerate(nodes.sizes):
        if m:
            PR[k].addmm_(X[s: s + m].T, Bs[s: s + m])
        s += m


# (E, G, G) float64 blocks a coalescence_stats call holds at its peak: the
# two halves of PR, then the opportunity, its temporaries and the
# symmetrised results
STATS_BLOCKS = 6


def _batch_size(M: int, G: int, E: int, device, T: int) -> int:
    """Trees a batch may hold: C (M*G*4 bytes a tree) and the node blocks
    (a tree's M/2 nodes: 2G float64 weighted left rows, G right rows and
    the float32 rows they are gathered from, about 32*G bytes a node),
    against half the card's free memory less the call's ``STATS_BLOCKS``
    (E, G, G) float64 blocks, or a fixed budget on the CPU."""
    per_tree = M * G * 4 + (M // 2) * (32 * G + 64)
    return batch_rows(per_tree, T, device, share=BATCH_MEMORY_SHARE,
                      reserve=STATS_BLOCKS * E * G * G * 8)


def coalescence_stats(trees, factors: np.ndarray, epochs: np.ndarray,
                      group_of_hap: Optional[np.ndarray] = None,
                      sample_ages: Optional[np.ndarray] = None,
                      batch: Optional[int] = None, use_device: bool = True,
                      device=None, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-epoch coalescence counts and opportunity by group pair.

    Returns (counts (E, G, G), opp (E, G, G)) float64, symmetric in the
    group axes, where each unordered haplotype pair contributes once (to
    [a,b] and [b,a] half each for a != b; the diagonal gets the within-group
    pairs). Trees with factor 0 are skipped.

    On ``device`` (None: the CUDA card) in batches of ``batch`` trees (None:
    sized from the card's free memory); ``use_device=False`` runs the plain
    host twin ``_coalescence_stats_host``. ``mesh`` (a
    ``parallel.mesh.Mesh``, the tools' ``--devices``) runs on its first
    card: each batch is a level loop of small launches that waits on the
    host at ``_Nodes``, so the host, not the card, sets the pace. On four
    NVIDIA H100 80GB HBM3 (700 W) 8 batches of 8 trees at N = 2048 took
    120.2 ms on one card, 112.0 ms dealt to the cards from one thread and
    675.4 ms from a thread a card (``chip_smoke.py --phases dealing``,
    ``coal_stats_dealt``): nothing to gain. Adds one dict (trees, groups,
    batch, batches, levels, device, wall_s) under ``coal_stats`` to the
    record of the ``utils.trace`` stage it runs in."""
    E = len(epochs)
    N = trees[0].N
    if group_of_hap is None:
        group_of_hap = np.zeros(N, dtype=np.int64)
    G = int(np.max(group_of_hap)) + 1
    onehot = np.zeros((N, G))
    onehot[np.arange(N), group_of_hap] = 1.0
    if not use_device:
        return _coalescence_stats_host(trees, factors, epochs, onehot,
                                       sample_ages)

    device, _ = device_and_mesh(device, mesh)
    t0 = time.time()
    M = trees[0].num_nodes
    factors = np.asarray(factors, dtype=np.float64)
    live = [i for i in range(len(trees)) if factors[i] != 0.0]
    if batch is None:
        batch = _batch_size(M, G, E, device, max(len(live), 1))
    eps_d = torch.from_numpy(np.asarray(epochs, np.float64)).to(device)
    oh_d = torch.from_numpy(onehot.astype(np.float32)).to(device)
    f_d = torch.from_numpy(factors).to(device)
    PR = torch.zeros((E, 2 * G, G), dtype=torch.float64, device=device)
    levels = 0
    for s in range(0, len(live), batch):
        idx = live[s: s + batch]
        nodes = _Nodes(trees, idx, oh_d, eps_d, sample_ages, device)
        levels = max(levels, nodes.levels)
        _stats_batch(nodes, f_d[torch.as_tensor(idx, device=device)], PR)
        del nodes
    # the opportunity is linear in P and R: taken once, from the sums
    counts, opp = PR[:, :G], _opportunity(PR[:, :G], PR[:, G:], eps_d)
    counts = 0.5 * (counts + counts.transpose(1, 2))
    opp = 0.5 * (opp + opp.transpose(1, 2))
    out = counts.cpu().numpy(), opp.cpu().numpy()
    note("coal_stats", dict(trees=len(live), groups=G, batch=batch,
                            batches=-(-len(live) // batch), levels=levels,
                            device=str(device),
                            wall_s=round(time.time() - t0, 4)))
    return out


def _coalescence_stats_host(trees, factors, epochs, onehot, sample_ages):
    """Reference-structured host twin of `coalescence_stats` (kept for
    differential testing of the device path)."""
    E = len(epochs)
    N = trees[0].N
    G = onehot.shape[1]
    counts = np.zeros((E, G, G))
    opp = np.zeros((E, G, G))
    for tree, f in zip(trees, factors):
        if f == 0.0:
            continue
        coords = tree.coordinates(sample_ages)
        C = np.zeros((tree.num_nodes, G))
        C[:N] = onehot
        order = topological_order(tree.parent)
        for v in order:
            C[v] = C[tree.child_left[v]] + C[tree.child_right[v]]
        for v in order:
            t = coords[v]
            a = C[tree.child_left[v]]
            b = C[tree.child_right[v]]
            pair = np.outer(a, b)
            pair = 0.5 * (pair + pair.T)   # symmetrize unordered pairs
            e = np.searchsorted(epochs, t, side="right") - 1
            e = min(max(e, 0), E - 1)
            counts[e] += f * pair
            ov = _epoch_overlap(epochs, t)
            opp += f * ov[:, None, None] * pair[None]
    return counts, opp


def finalize_rates(counts: np.ndarray, opp: np.ndarray) -> np.ndarray:
    """rate[e,a,b] = counts/opportunity (FinalizePopulationSize.cpp:70-92);
    nan where there is no opportunity."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(opp > 0, counts / np.maximum(opp, 1e-300), np.nan)


# ---------------------------------------------------------------------------
# .coal file IO (FinalizePopulationSize.cpp:96-110)
# ---------------------------------------------------------------------------

def write_coal(path: str, epochs: np.ndarray, rates: np.ndarray,
               group_names: Optional[List[str]] = None):
    """rates: (E,) whole-sample or (E, G, G) by group pair."""
    rates = np.asarray(rates)
    if rates.ndim == 1:
        rates = rates[:, None, None]
    G = rates.shape[1]
    if group_names is None:
        group_names = [str(g) for g in range(G)]
    # '%g' writes what format(x, 'g') writes, 'nan' for nan; one row
    # formatted at a time keeps G * G rows (G = N with --poplabels hap)
    # cheap in time and host memory
    fmt = " ".join(["%g"] * rates.shape[0]) + "\n"
    with open(path, "w") as f:
        f.write(" ".join(group_names) + "\n")
        f.write(" ".join(f"{e:g}" for e in epochs) + "\n")
        for a in range(G):
            f.writelines(f"{a} {b} " + fmt % tuple(row)
                         for b, row in enumerate(rates[:, a, :].T.tolist()))


def read_coal(path: str):
    """(group names, epochs (E,), rates (E, G, G), nan where absent)."""
    with open(path) as f:
        names = f.readline().split()
        epochs = np.asarray([float(x) for x in f.readline().split()])
        G = len(names)
        E = len(epochs)
        rates = np.full((E, G, G), np.nan)
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            a, b = int(parts[0]), int(parts[1])
            vals = np.asarray([float(x) for x in parts[2:]])
            rates[: len(vals), a, b] = vals
    return names, epochs, rates


# ---------------------------------------------------------------------------
# the EM (EstimatePopulationSize.sh)
# ---------------------------------------------------------------------------

def filled_rates(counts: np.ndarray, opp: np.ndarray) -> np.ndarray:
    """Whole-sample per-epoch rates with the reference's gap convention
    (coal_tree::Dump, coal_tree.cpp:311-327): rate = counts/opportunity;
    where an epoch has NO opportunity the previous epoch's rate is carried
    forward (epoch 0 stays 0). Epochs with opportunity but no events keep
    rate 0."""
    num = counts.sum(axis=tuple(range(1, counts.ndim)))
    den = opp.sum(axis=tuple(range(1, opp.ndim)))
    E = len(num)
    out = np.zeros(E)
    for i in range(E):
        if den[i] > 0:
            out[i] = num[i] / den[i]
        elif i > 0:
            out[i] = out[i - 1]
    return out


def estimate_popsize_em(anc: AncesTree, muts: List[MutationRecord],
                        dist: np.ndarray, mu: float = 1.25e-8,
                        years_per_gen: float = 28.0,
                        epochs: Optional[np.ndarray] = None,
                        num_iter: int = 10, seed: int = 1,
                        group_of_hap: Optional[np.ndarray] = None,
                        verbose: bool = False, device=None, mesh=None,
                        pool: Optional[CardPool] = None):
    """Joint branch-length / coalescence-rate EM on ``device`` (None: the
    CUDA card).

    Mirrors EstimatePopulationSize.sh's loop: per-epoch rates from the
    current branch lengths (CoalRateForTree + Dump fill), then ONE
    posterior *draw* of branch lengths under that prior
    (SampleBranchLengths --num_samples 1) — a draw, not the posterior
    mean, so the age spread (and hence the next rate estimate) is
    unbiased. Mutates ``anc`` in place (trees carry the last draw); each
    iteration is the ``utils.trace`` stage ``em_iter<i>``. Returns (epochs,
    pairwise rates (E, G, G), whole-sample filled rates).

    The draws' chain parts (``sampling.sample_branch_lengths``) go to the
    workers of ``pool`` (``parallel.pool.CardPool``), one process a card;
    with a ``mesh`` of more than one device and trees of at least two
    parts, to one pool of the mesh for the whole EM, started as the call
    begins (its start overlaps the first ``coalescence_stats``) and closed
    as it ends. Each iteration sends the trees as they stand then. The
    statistics run on the first card: their batches gained nothing on more
    cards (PERF.md §5). The rates and draws are one device's bit for bit."""
    from . import sampling

    device, mesh = device_and_mesh(
        device, pool.mesh if pool is not None and mesh is None else mesh)
    if epochs is None:
        epochs = default_epochs(years_per_gen)
    trees = [mt.tree for mt in anc.seq]
    own = None
    if pool is None and mesh is not None and len(mesh) > 1 \
            and num_iter > 0 \
            and len(trees) > mcmc.chain_batch_cap(trees[0].num_nodes):
        pool = own = CardPool(mesh)
    try:
        spans = tree_spans(anc, muts, dist)
        counts, opp = coalescence_stats(trees, spans, epochs, device=device)
        coal = filled_rates(counts, opp)
        for it in range(num_iter):
            if verbose:
                pos = coal[coal > 0]
                ne = 0.5 / pos.mean() if len(pos) else float("nan")
                print(f"[em] iter {it}: mean Ne ~ {ne:.0f}")
            if not (coal > 0).any():
                break
            with stage(f"em_iter{it}", verbose=False):
                draws = sampling.sample_branch_lengths(
                    anc, muts, dist, mu, epochs, coal, num_samples=1,
                    seed=seed + it, device=device, pool=pool)
                for i, mt in enumerate(anc.seq):
                    mt.tree.branch_length = draws[0, i]
                counts, opp = coalescence_stats(trees, spans, epochs,
                                                device=device)
                coal = filled_rates(counts, opp)

        counts_g, opp_g = coalescence_stats(trees, spans, epochs,
                                            group_of_hap, device=device)
    finally:
        if own is not None:
            own.close()
    rates = finalize_rates(counts_g, opp_g)
    return epochs, rates, coal


# ---------------------------------------------------------------------------
# additional modes (RelateCoalescentRate.cpp:40-202)
# ---------------------------------------------------------------------------

def per_tree_epoch_stats(trees, epochs: np.ndarray,
                         sample_ages: Optional[np.ndarray] = None,
                         batch: Optional[int] = None, device=None):
    """(T, E) per-tree whole-sample coalescence counts and opportunity,
    float64, on ``device`` (None: the CUDA card) in batches of ``batch``
    trees (None: sized from the card's free memory)."""
    device = resolve_device(device)
    T = len(trees)
    E = len(epochs)
    N = trees[0].N
    M = trees[0].num_nodes
    if batch is None:
        batch = _batch_size(M, 1, E, device, T)
    eps_d = torch.from_numpy(np.asarray(epochs, np.float64)).to(device)
    oh_d = torch.ones((N, 1), dtype=torch.float32, device=device)
    counts = np.zeros((T, E))
    opp = np.zeros((T, E))
    for s in range(0, T, batch):
        idx = list(range(s, min(s + batch, T)))
        B = len(idx)
        nodes = _Nodes(trees, idx, oh_d, eps_d, sample_ages, device)
        ab = (nodes.C[nodes.left, 0].double()
              * nodes.C[nodes.right, 0].double())
        at = nodes.tree * E + nodes.e
        P = torch.zeros(B * E, dtype=torch.float64, device=device)
        R = torch.zeros_like(P)
        P.index_add_(0, at, ab)
        R.index_add_(0, at, ab * nodes.dt)
        P, R = P.view(B, E), R.view(B, E)
        o = _opportunity(P.T, R.T, eps_d).T
        counts[s: s + B] = P.cpu().numpy()
        opp[s: s + B] = o.cpu().numpy()
    return counts, opp


def coal_rate_for_tree(trees, epochs: np.ndarray,
                       sample_ages: Optional[np.ndarray] = None, device=None):
    """Per-tree per-epoch coalescence rates (CoalescenceRateForTree,
    CoalescentRateForSection.cpp:605-858): counts/opportunity per tree."""
    counts, opp = per_tree_epoch_stats(trees, epochs,
                                       sample_ages=sample_ages,
                                       device=device)
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = np.where(opp > 0, counts / np.maximum(opp, 1e-300), np.nan)
    return counts, opp, rates


def generate_const_coal(path: str, Ne: float, epochs: np.ndarray):
    """GenerateConstCoalFile: a .coal with rate 1/Ne in every epoch
    (CoalescentRateForSection.cpp GenerateConstCoal)."""
    write_coal(path, epochs, np.full(len(epochs), 1.0 / Ne), ["0"])


def summarize_for_genome(per_chr_stats):
    """Sum per-chromosome (counts, opp) sufficient statistics — the
    in-memory replacement of SummarizeCoalescentRateForGenome.cpp's
    filesystem all-reduce."""
    counts = sum(c for c, _ in per_chr_stats)
    opp = sum(o for _, o in per_chr_stats)
    return counts, opp


def finalize_coalescence_count(counts: np.ndarray):
    """FinalizeCoalescenceCount: emit raw per-epoch pairwise counts."""
    return counts


def bootstrap_rates(trees, factors: np.ndarray, epochs: np.ndarray,
                    num_bootstrap: int = 100, block_size: int = 100,
                    seed: int = 1,
                    sample_ages: Optional[np.ndarray] = None, device=None):
    """Block-bootstrap MLE coalescence rates over trees (coal_tree.hpp:19-46):
    resample contiguous blocks of trees with replacement and recompute
    rate = counts/opportunity per replicate. Returns (E, num_bootstrap)."""
    T = len(trees)
    E = len(epochs)
    factors = np.asarray(factors, dtype=np.float64)
    per_tree_c, per_tree_o = per_tree_epoch_stats(trees, epochs,
                                                  sample_ages=sample_ages,
                                                  device=device)
    per_tree_c *= factors[:, None]
    per_tree_o *= factors[:, None]
    rng = np.random.default_rng(seed)
    nblocks = max(T // block_size, 1)
    out = np.empty((E, num_bootstrap))
    for b in range(num_bootstrap):
        starts = rng.integers(0, max(T - block_size, 1), size=nblocks)
        sel = np.concatenate([np.arange(s, min(s + block_size, T))
                              for s in starts])
        c = per_tree_c[sel].sum(axis=0)
        o = per_tree_o[sel].sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            out[:, b] = np.where(o > 0, c / np.maximum(o, 1e-300), np.nan)
    return out

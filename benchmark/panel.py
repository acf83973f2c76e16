"""Seeded haplotype panels and the files ``run_all`` reads.

The generator follows ``relate_tpu_torch/utils/synth.py:
synth_coalescent_panel``: a Kingman coalescent tree, a block of ``block``
SNPs each dropped on a branch with probability proportional to its length,
then ``nni_per_block`` height-preserving nearest-neighbour interchanges
before the next block. That generator draws one interchange at a time (a
dozen microseconds each in Python), and the panel needs about a hundred a
SNP before the port rebuilds its tree as often as on real data; so here
the interchanges of a block are drawn in rounds of candidates and applied
together where they touch disjoint nodes (v, its parent p, its sibling,
its two children), which makes them commute: an interchange at (v, p)
changes the clade of v alone (the clade of p holds the same leaves before
and after), and no interchange of a round changes a node another one
reads. The same seed gives the same panel.

Internal node ids rise with height, and an interchange keeps every child
below its parent in height, so a clade is always built after its children.
Nothing here imports the program.
"""
from __future__ import annotations

import math
import os

import numpy as np


def watterson_spacing_bp(N: int, Ne: float, mu: float) -> int:
    """SNP spacing in bp of Watterson's expectation: one SNP in
    1 / (2 Ne mu a_N) bp, with a_N = sum_{k<N} 1/k (Relate's Ne counts
    haplotypes)."""
    a_n = sum(1.0 / k for k in range(1, N))
    return int(round(1.0 / (2.0 * Ne * mu * a_n)))


def kingman_tree(N: int, rng):
    """(parent, child_l, child_r, height) of a Kingman coalescent tree:
    node N + t joins two random lineages after an exponential wait."""
    M = 2 * N - 1
    parent = np.full(M, -1, np.int64)
    child_l = np.full(M, -1, np.int64)
    child_r = np.full(M, -1, np.int64)
    height = np.zeros(M)
    avail = list(range(N))
    t = 0.0
    for nxt in range(N, M):
        k = len(avail)
        t += rng.exponential(2.0 / (k * (k - 1)))
        a = avail.pop(int(rng.integers(len(avail))))
        b = avail.pop(int(rng.integers(len(avail))))
        parent[a] = nxt
        parent[b] = nxt
        child_l[nxt], child_r[nxt] = a, b
        height[nxt] = t
        avail.append(nxt)
    return parent, child_l, child_r, height


def clade_matrix(child_l, child_r, N: int) -> np.ndarray:
    """(M, ceil(N / 8)) leaf indicators of every node, eight leaves a byte
    (``np.packbits``)."""
    M = 2 * N - 1
    clades = np.zeros((M, (N + 7) // 8), dtype=np.uint8)
    clades[:N] = np.packbits(np.eye(N, dtype=np.uint8), axis=1)
    for v in range(N, M):
        clades[v] = clades[child_l[v]] | clades[child_r[v]]
    return clades


def interchanges(rng, want: int, tree, clades, round_size: int = 256):
    """Applies ``want`` height-preserving interchanges, in rounds of
    ``round_size`` candidates: a candidate is internal node v (not the
    root), one of its children c taken at random, and its sibling s, kept
    where s is lower than v and where its nodes (v, p, s, c and v's other
    child) are touched by no earlier candidate of the round. c and s swap
    places; the clades of the changed nodes are rebuilt after the round."""
    parent, cl, cr, height = tree
    M = len(parent)
    N = (M + 1) // 2
    done = 0
    while done < want:
        v = rng.integers(N, M - 1, size=round_size)
        left = rng.integers(2, size=round_size).astype(bool)
        p = parent[v]
        sib = np.where(cl[p] == v, cr[p], cl[p])
        c = np.where(left, cl[v], cr[v])
        o = np.where(left, cr[v], cl[v])
        ok = height[sib] < height[v]
        nodes = np.stack([v, p, sib, c, o], axis=1)
        # keep a candidate only where none of its nodes is taken before it
        # in the round
        flat = nodes.reshape(-1)
        first = np.full(M, round_size, dtype=np.int64)
        owner = np.repeat(np.arange(round_size), 5)
        np.minimum.at(first, flat, np.where(np.repeat(ok, 5), owner,
                                             round_size))
        ok &= (first[nodes] == np.arange(round_size)[:, None]).all(axis=1)
        idx = np.nonzero(ok)[0][:want - done]
        v, p, sib, c, o = v[idx], p[idx], sib[idx], c[idx], o[idx]
        c_left = cl[v] == c
        cl[v] = np.where(c_left, sib, cl[v])
        cr[v] = np.where(c_left, cr[v], sib)
        s_left = cl[p] == sib
        cl[p] = np.where(s_left, c, cl[p])
        cr[p] = np.where(s_left, cr[p], c)
        parent[sib] = v
        parent[c] = p
        clades[v] = clades[cl[v]] | clades[cr[v]]
        done += len(idx)


def coalescent_panel(N: int, L: int, seed: int, bp_spacing: int,
                     block: int, nni_per_block: int):
    """Genealogy-structured panel (the module's docstring). Returns
    (G (L, N) uint8, bp (L,) int64). The first L' SNPs of a longer panel
    are the panel of L' SNPs."""
    rng = np.random.default_rng(seed)
    M = 2 * N - 1
    tree = kingman_tree(N, rng)
    parent, cl, cr, height = tree
    clades = clade_matrix(cl, cr, N)
    G = np.zeros((L, N), dtype=np.uint8)
    for start in range(0, L, block):
        lengths = height[parent[:M - 1]] - height[:M - 1]
        picks = rng.choice(M - 1, size=min(block, L - start),
                           p=lengths / lengths.sum())
        G[start:start + len(picks)] = np.unpackbits(clades[picks], axis=1,
                                                    count=N)
        interchanges(rng, nni_per_block, tree, clades)
    bp = (np.arange(L, dtype=np.int64) + 1) * bp_spacing
    return G, bp


def write_haps(path: str, G: np.ndarray, bp: np.ndarray):
    """``.haps`` rows ``1 snp<l> <bp> A T a_1 ... a_N``."""
    L, N = G.shape
    body = np.full((L, 2 * N), ord(" "), dtype=np.uint8)
    body[:, 0::2] = G + ord("0")
    body[:, -1] = ord("\n")
    with open(path, "wb") as f:
        for l in range(L):
            f.write(f"1 snp{l} {bp[l]} A T ".encode())
            f.write(body[l].tobytes())


def write_sample(path: str, N: int):
    """Diploid individuals, two haplotypes each."""
    if N % 2:
        raise ValueError(f"N = {N} haplotypes is not a panel of diploids")
    with open(path, "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(N // 2):
            f.write(f"s{i} s{i} 0\n")


def write_flat_map(path: str, max_bp: int, cm_per_mb: float):
    with open(path, "w") as f:
        f.write("pos COMBINED_rate Genetic_Map\n")
        step = 1000000
        for b in range(0, max_bp + 2 * step, step):
            f.write(f"{b} {cm_per_mb} {b / 1e6 * cm_per_mb}\n")


def write_region(dirname: str, G: np.ndarray, bp: np.ndarray,
                 cm_per_mb: float) -> dict:
    """One job's input files in ``dirname``; returns their paths. The region
    keeps its own bp (a piece of the chromosome), the map covers it."""
    os.makedirs(dirname, exist_ok=True)
    paths = {k: os.path.join(dirname, f"region.{k}")
             for k in ("haps", "sample", "map")}
    write_haps(paths["haps"], G, bp)
    write_sample(paths["sample"], G.shape[1])
    write_flat_map(paths["map"], int(math.ceil(bp[-1])), cm_per_mb)
    return paths

"""Deterministic synthetic haplotype panels for benchmarking.

Allele frequencies follow the neutral-ish site-frequency spectrum
(p(f) ~ 1/f), giving realistic per-target derived-site densities — the
quantity that determines painting work. Not a coalescent simulator; used
only for like-for-like throughput comparisons between this framework and
the reference binary on identical inputs.
"""
from __future__ import annotations

import numpy as np


def synth_panel(N: int, L: int, seed: int = 7, bp_spacing: int = 500):
    """Returns (G (L, N) uint8, bp (L,) int64)."""
    rng = np.random.default_rng(seed)
    # SFS-like derived counts: P(k) ~ 1/k for k in 1..N-1
    k = np.arange(1, N)
    w = 1.0 / k
    counts = rng.choice(k, size=L, p=w / w.sum())
    G = np.zeros((L, N), dtype=np.uint8)
    # correlated carriers: choose a contiguous block of a random permutation
    # per segment to mimic LD (cheap approximation)
    perm = rng.permutation(N)
    for l in range(L):
        if l % 64 == 0:
            perm = rng.permutation(N)
        off = int(rng.integers(N))
        idx = np.concatenate([perm[off:], perm[:off]])[:counts[l]]
        G[l, idx] = 1
    bp = (np.arange(L, dtype=np.int64) + 1) * bp_spacing
    return G, bp


def write_haps_sample(G: np.ndarray, bp: np.ndarray, prefix: str):
    """Write .haps/.sample files readable by both frameworks."""
    L, N = G.shape
    assert N % 2 == 0
    with open(prefix + ".haps", "w") as f:
        for l in range(L):
            alleles = " ".join(str(int(x)) for x in G[l])
            f.write(f"1 snp{l} {bp[l]} A T {alleles}\n")
    with open(prefix + ".sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(N // 2):
            f.write(f"s{i} s{i} 0\n")


def write_flat_map(path: str, max_bp: int, cm_per_mb: float = 1.0):
    with open(path, "w") as f:
        f.write("pos COMBINED_rate Genetic_Map\n")
        step = 1000000
        for bp in range(0, max_bp + 2 * step, step):
            f.write(f"{bp} {cm_per_mb} {bp / 1e6 * cm_per_mb}\n")


def synth_coalescent_panel(N: int, L: int, seed: int = 7,
                           bp_spacing: int = 500, block: int = 150,
                           nni_per_block: int = 6):
    """Genealogy-structured panel: a Kingman coalescent tree per block of
    ``block`` SNPs, adjacent blocks related by a few NNI moves, each SNP a
    mutation dropped on a branch with probability proportional to branch
    length (reproducing the neutral SFS and real LD/tree-block structure).

    This is the *end-to-end* benchmark workload: unlike ``synth_panel``
    (independent sites), it gives the inference a recoverable genealogy, so
    tree counts / MCMC effort match real data rather than the
    one-tree-per-three-SNPs pathology of LD-free noise.

    Returns (G (L, N) uint8, bp (L,) int64).
    """
    rng = np.random.default_rng(seed)
    M = 2 * N - 1

    # -- Kingman tree: exponential coalescence times ---------------------
    parent = np.full(M, -1, np.int32)
    child_l = np.full(M, -1, np.int32)
    child_r = np.full(M, -1, np.int32)
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

    def leaf_sets():
        out = np.zeros((M, N), dtype=np.uint8)
        out[np.arange(N), np.arange(N)] = 1
        for v in range(N, M):
            out[v] = out[child_l[v]] | out[child_r[v]]
        return out

    def nni():
        """One height-preserving nearest-neighbor interchange."""
        for _ in range(64):
            v = int(rng.integers(N, M - 1))
            p = parent[v]
            if p < 0:
                continue
            sib = child_r[p] if child_l[p] == v else child_l[p]
            c = child_l[v] if rng.integers(2) else child_r[v]
            if height[sib] >= height[v]:
                continue        # sib must fit under v
            # swap c <-> sib
            if child_l[v] == c:
                child_l[v] = sib
            else:
                child_r[v] = sib
            if child_l[p] == sib:
                child_l[p] = c
            else:
                child_r[p] = c
            parent[sib] = v
            parent[c] = p
            return

    G = np.zeros((L, N), dtype=np.uint8)
    lengths = np.zeros(M)
    clades = leaf_sets()
    for start in range(0, L, block):
        # branch lengths above every non-root node
        lengths[:M - 1] = height[parent[:M - 1]] - height[:M - 1]
        w = lengths[:M - 1] / lengths[:M - 1].sum()
        picks = rng.choice(M - 1, size=min(block, L - start), p=w)
        G[start:start + len(picks)] = clades[picks]
        for _ in range(nni_per_block):
            nni()
        clades = leaf_sets()
    bp = (np.arange(L, dtype=np.int64) + 1) * bp_spacing
    return G, bp

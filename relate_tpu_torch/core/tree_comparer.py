"""Tree-distance metrics.

Counterpart of ``relate_tpu/core/tree_comparer.py``. Behavioral reference:
``include/src/tree_comparer.{hpp,cpp}`` (tree_comparer.hpp:9-18):
Pearson-correlation distance, Robinson-Foulds partition metric,
branch-score distance, time-while-k-ancestors, pairwise TMRCA matrix.

``pearson_distance`` and ``pairwise_tmrca`` run on ``device`` (None: the
CUDA card) as products of the trees' 0/1 leaf matrices
(``branch_association_device._leafmats``): the correlations with the
float32 operations of the host matcher (``_pearson_device``), the TMRCAs
in float64, where each pair takes the age of the one node that joins it
and so the products are exact. The other metrics are host code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.devmem import resolve_device
from .branch_association_device import _leafmats, _pearson_device
from .trees import Tree


def partition_metric(t1: Tree, t2: Tree) -> int:
    """Robinson-Foulds distance: clades present in one tree but not the
    other (internal, non-root clades); each clade is its leaf-matrix row's
    bytes."""
    A = {r.tobytes() for r in t1.leaf_matrix()[t1.N: -1]}
    B = {r.tobytes() for r in t2.leaf_matrix()[t2.N: -1]}
    return len(A ^ B)


def _leaf_matrix(t: Tree, device) -> torch.Tensor:
    parent = torch.as_tensor(np.asarray(t.parent, np.int64), device=device)
    return _leafmats(parent[None, :], t.N)[0]


def pearson_distance(t1: Tree, t2: Tree, device=None) -> float:
    """1 - mean over branches of the best-matching Pearson correlation of
    leaf sets (symmetrized). The correlations and their maxima on
    ``device``, the means on the host: the same float32 value on the card
    and the CPU."""
    device = resolve_device(device)
    L1 = _leaf_matrix(t1, device)[t1.N: -1]
    L2 = _leaf_matrix(t2, device)[t2.N: -1]
    if L1.shape[0] == 0 or L2.shape[0] == 0:
        return 0.0
    c = _pearson_device((L1 @ L2.T)[None], L1.sum(dim=1)[None],
                        L2.sum(dim=1)[None], t1.N)[0]
    rows = c.max(dim=1).values.cpu().numpy()
    cols = c.max(dim=0).values.cpu().numpy()
    return float(1.0 - 0.5 * (rows.mean() + cols.mean()))


def branch_score(t1: Tree, t2: Tree) -> float:
    """Branch-score distance: L2 over clades of branch-length differences
    (0 where a clade is absent)."""
    def lengths(t: Tree):
        out = {}
        lm = t.leaf_matrix()
        for v in range(t.N, t.num_nodes - 1):
            out[tuple(lm[v])] = out.get(tuple(lm[v]), 0.0) \
                + float(t.branch_length[v])
        return out
    a = lengths(t1)
    b = lengths(t2)
    keys = set(a) | set(b)
    return float(np.sqrt(sum((a.get(k, 0.0) - b.get(k, 0.0)) ** 2
                             for k in keys)))


def time_while_k_ancestors(tree: Tree, k: int,
                           sample_ages=None) -> float:
    """Total time during which exactly k ancestral lineages exist."""
    coords = np.sort(tree.coordinates(sample_ages)[tree.N:])
    N = tree.N
    # N lineages on [0, coords[0]]; after the i-th coalescence (age
    # coords[i-1]) there are N-i lineages, until coords[i]
    if k > N or k < 2:
        return 0.0
    if k == N:
        return float(coords[0])
    i = N - k  # number of coalescences that have happened
    return float(coords[i] - coords[i - 1])


def pairwise_tmrca(tree: Tree, sample_ages=None, device=None) -> np.ndarray:
    """(N, N) float64 matrix of pairwise TMRCAs via the cross-clade
    decomposition: each unordered pair coalesces at exactly one internal
    node v, with one leaf below each child, so the matrix is
    A^T diag(age) B + its transpose, A and B the leaf sets of the nodes'
    left and right children. Computed on ``device``; the diagonal is 0."""
    device = resolve_device(device)
    N = tree.N
    ages = torch.as_tensor(tree.coordinates(sample_ages)[N:],
                           dtype=torch.float64, device=device)
    L = _leaf_matrix(tree, device).double()
    A = L[torch.as_tensor(np.asarray(tree.child_left[N:], np.int64),
                          device=device)]
    B = L[torch.as_tensor(np.asarray(tree.child_right[N:], np.int64),
                          device=device)]
    half = (A * ages[:, None]).T @ B
    return (half + half.T).cpu().numpy()

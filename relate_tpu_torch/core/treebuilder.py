"""Tree-builder helpers shared by the device section builder.

Only ``thresholds`` and ``tree_from_merges``; the host ``quick_build`` and
its priors come with the host topology builder.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .trees import Tree


def thresholds(theta: float) -> Tuple[float, float]:
    base = -float(np.log(theta / (1.0 - theta)))
    return 0.2 * base, 0.001 * base


def tree_from_merges(cis: np.ndarray, cjs: np.ndarray, N: int) -> Tree:
    """Build the flat tree arrays from merge child lists."""
    M = 2 * N - 1
    parent = np.full(M, -1, dtype=np.int32)
    lab = np.arange(N - 1) + N
    parent[cis] = lab
    parent[cjs] = lab
    cl = np.full(M, -1, dtype=np.int32)
    cr = np.full(M, -1, dtype=np.int32)
    cl[N:] = cis
    cr[N:] = cjs
    return Tree(parent=parent, child_left=cl, child_right=cr)

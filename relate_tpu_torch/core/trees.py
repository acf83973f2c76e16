"""Array-based marginal-tree structures.

The reference uses pointer-linked ``Node``/``Tree`` objects
(``include/src/anc.hpp:21-254``). The layout here is flat arrays over
2N-1 nodes — leaves 0..N-1, internal nodes N..2N-2 in coalescence order, root
= 2N-2 — so whole *batches* of trees stack naturally:

  parent      (2N-1,) int32, -1 at root
  child_left  (2N-1,) int32, -1 at leaves
  child_right (2N-1,) int32, -1 at leaves
  branch_length (2N-1,) float64
  num_events  (2N-1,) float32
  SNP_begin/SNP_end (2N-1,) int32
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Tree:
    parent: np.ndarray
    child_left: np.ndarray
    child_right: np.ndarray
    branch_length: np.ndarray = None
    num_events: np.ndarray = None
    SNP_begin: np.ndarray = None
    SNP_end: np.ndarray = None

    def __post_init__(self):
        n = len(self.parent)
        if self.branch_length is None:
            self.branch_length = np.zeros(n, dtype=np.float64)
        if self.num_events is None:
            self.num_events = np.zeros(n, dtype=np.float32)
        if self.SNP_begin is None:
            self.SNP_begin = np.zeros(n, dtype=np.int32)
        if self.SNP_end is None:
            self.SNP_end = np.zeros(n, dtype=np.int32)

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def N(self) -> int:
        return (self.num_nodes + 1) // 2

    @property
    def root(self) -> int:
        return self.num_nodes - 1

    def copy(self) -> "Tree":
        return Tree(self.parent.copy(), self.child_left.copy(),
                    self.child_right.copy(), self.branch_length.copy(),
                    self.num_events.copy(), self.SNP_begin.copy(),
                    self.SNP_end.copy())

    # -- leaf sets -------------------------------------------------------
    def leaf_matrix(self) -> np.ndarray:
        """(2N-1, N) uint8: leaves[b, l] = 1 iff leaf l descends through
        branch b (incl. b itself for leaves). Bottom-up accumulation —
        node order guarantees children precede parents only for the
        merge-order coalescence labeling; handle general parents by sweeping.
        """
        M = self.num_nodes
        N = self.N
        out = np.zeros((M, N), dtype=np.uint8)
        out[np.arange(N), np.arange(N)] = 1
        order = topological_order(self.parent)
        for b in order:
            if self.child_left[b] >= 0:
                out[b] = out[self.child_left[b]] | out[self.child_right[b]]
        return out

    def num_leaves(self) -> np.ndarray:
        return self.leaf_matrix().sum(axis=1).astype(np.int32)

    # -- coordinates -----------------------------------------------------
    def coordinates(self, sample_ages: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """Node ages from branch lengths (max over children, like
        branch_length_estimator.cpp:2754-2769)."""
        M, N = self.num_nodes, self.N
        coords = np.zeros(M, dtype=np.float64)
        if sample_ages is not None:
            coords[:N] = sample_ages
        for b in topological_order(self.parent):
            if self.child_left[b] >= 0:
                cl, cr = self.child_left[b], self.child_right[b]
                coords[b] = max(coords[cl] + self.branch_length[cl],
                                coords[cr] + self.branch_length[cr])
        return coords

    def to_newick(self, use_branch_lengths: bool = True) -> str:
        """Newick string (leaves labeled by index)."""
        def rec(b: int) -> str:
            if self.child_left[b] < 0:
                s = str(b)
            else:
                s = f"({rec(self.child_left[b])},{rec(self.child_right[b])})"
            if use_branch_lengths and self.parent[b] >= 0:
                s += f":{self.branch_length[b]:.5f}"
            return s
        return rec(self.root) + ";"

    def to_nhx(self, properties) -> str:
        """New Hampshire eXtended string: every node carries an
        ``[&&NHX:S=<property>]`` tag (Tree::WriteNHX, anc.cpp:213-284;
        ``properties`` is one string per node)."""
        if len(properties) != self.num_nodes:
            raise ValueError("property vector has wrong size")

        def rec(b: int) -> str:
            if self.child_left[b] < 0:
                s = str(b)
            else:
                s = f"({rec(self.child_left[b])},{rec(self.child_right[b])})"
            if self.parent[b] >= 0:
                s += f":{self.branch_length[b]:f}[&&NHX:S={properties[b]}]"
            return s
        return rec(self.root) + ";"

    def to_oriented(self) -> str:
        """Oriented-tree line: ``parent:branch_length`` per node, -1 at
        the root (Tree::WriteOrientedTree, anc.cpp:287-317)."""
        return " ".join(
            f"{int(self.parent[v])}:{self.branch_length[v]:f}"
            for v in range(self.num_nodes)) + " "


def topological_order(parent: np.ndarray) -> np.ndarray:
    """Indices of internal nodes in children-before-parents order."""
    M = len(parent)
    N = (M + 1) // 2
    order = []
    done = np.zeros(M, dtype=bool)
    done[:N] = True
    remaining = set(range(N, M))
    child_l = np.full(M, -1, dtype=np.int64)
    child_r = np.full(M, -1, dtype=np.int64)
    for i in range(M):
        p = parent[i]
        if p >= 0:
            if child_l[p] < 0:
                child_l[p] = i
            else:
                child_r[p] = i
    while remaining:
        progressed = False
        for b in sorted(remaining):
            if done[child_l[b]] and done[child_r[b]]:
                order.append(b)
                done[b] = True
                remaining.discard(b)
                progressed = True
        if not progressed:
            raise ValueError("cycle in parent array")
    return np.asarray(order, dtype=np.int64)


def children_from_parent(parent: np.ndarray):
    """Recover (child_left, child_right) arrays from a parent array.
    Left child = lower index (the .anc format stores only parents)."""
    cl, cr = children_from_parent_batch(parent[None, :])
    return cl[0], cr[0]


def children_from_parent_batch(parent: np.ndarray):
    """(T, M)-batched :func:`children_from_parent`.

    For the merge-order node labeling (leaves 0..N-1, internal N..M-1, one
    root with parent -1, every internal node exactly two children) a stable
    argsort of each row by parent value groups the children: position 0 is
    the root, then consecutive pairs are the (lower, higher)-index children
    of internal nodes N, N+1, ... — an O(T·M log M) vectorized pass where
    the per-node Python loop cost ~0.2 ms/tree at 10^4-tree chunks."""
    parent = np.asarray(parent)
    T, M = parent.shape
    N = (M + 1) // 2
    cl = np.full((T, M), -1, dtype=np.int32)
    cr = np.full((T, M), -1, dtype=np.int32)
    if M == 1:
        return cl, cr
    sidx = np.argsort(parent, axis=1, kind="stable").astype(np.int32)
    pv = np.take_along_axis(parent, sidx.astype(np.int64), axis=1)
    expect = np.concatenate(
        [[-1], np.repeat(np.arange(N, M, dtype=parent.dtype), 2)])
    if (pv == expect[None, :]).all():
        cl[:, N:] = sidx[:, 1::2]
        cr[:, N:] = sidx[:, 2::2]
        return cl, cr
    # general fallback (non-canonical labelings, e.g. imported trees)
    for t in range(T):
        row = parent[t]
        for i in range(M):
            p = row[i]
            if p >= 0:
                if cl[t, p] < 0:
                    cl[t, p] = i
                else:
                    cr[t, p] = i
    return cl, cr


@dataclass
class MarginalTree:
    pos: int            # first SNP (chunk-local) at which this tree applies
    tree: Tree


@dataclass
class AncesTree:
    """A tree sequence: list of (pos, tree), like the reference's
    ``AncesTree = std::list<MarginalTree>`` (anc.hpp:200-254)."""
    N: int
    seq: List[MarginalTree] = field(default_factory=list)
    sample_ages: Optional[np.ndarray] = None

    @property
    def num_trees(self) -> int:
        return len(self.seq)

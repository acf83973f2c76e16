"""Tree visualization coordinates.

Counterpart of ``relate_tpu/io/treeview.py``. Behavioral reference:
``include/treeview/`` (RelateTreeView.cpp:29-44 modes TreeView,
TreeViewSample, MutationsOnBranches, BranchesBelowMutation): emit plot
coordinates consumed by the R plotting scripts. Here the same quantities
are produced as arrays/records, and a ``.png`` by ``render_tree`` when
matplotlib imports. Host code: the layout walks the tree with an explicit
stack, so a tree as deep as it has leaves needs no raised recursion limit.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.topology import MutationRecord
from ..core.trees import AncesTree, Tree


def tree_layout(tree: Tree, sample_ages: Optional[np.ndarray] = None):
    """Plot coordinates for one marginal tree: per node (x, y) with leaves
    in subtree order at y=age and internal nodes centered over children."""
    M = tree.num_nodes
    coords = tree.coordinates(sample_ages)
    x = np.zeros(M)
    counter = 0.0
    stack = [(tree.root, False)]
    while stack:
        v, done = stack.pop()
        cl, cr = tree.child_left[v], tree.child_right[v]
        if cl < 0:
            x[v] = counter
            counter += 1.0
        elif done:
            x[v] = 0.5 * (x[cl] + x[cr])
        else:
            stack += [(v, True), (int(cr), False), (int(cl), False)]
    return {"x": x, "y": coords, "parent": tree.parent.copy()}


def tree_at_bp(anc: AncesTree, muts: List[MutationRecord],
               bp: np.ndarray, bp_of_interest: int) -> int:
    """Index of the marginal tree covering a basepair position."""
    snp = int(np.searchsorted(bp, bp_of_interest, side="right")) - 1
    snp = min(max(snp, 0), len(muts) - 1)
    return muts[snp].tree


def mutations_on_branches(anc: AncesTree, muts: List[MutationRecord],
                          tree_index: int):
    """Per-branch mutation lists for one tree (MutationsOnBranches mode)."""
    out = {}
    for snp, m in enumerate(muts):
        if m.tree == tree_index and len(m.branch) == 1:
            out.setdefault(int(m.branch[0]), []).append(snp)
    return out


def branches_below_mutation(anc: AncesTree, muts: List[MutationRecord],
                            snp: int):
    """All branches in the subtree below a mutation (BranchesBelowMutation):
    the nodes whose leaf set lies within the mutation's branch's. On the
    host: one (2N-1, N) leaf matrix of the tree and one vectorised test of
    every row against the branch's."""
    m = muts[snp]
    if len(m.branch) != 1:
        return []
    tree = anc.seq[m.tree].tree
    leafmat = tree.leaf_matrix().astype(bool)
    outside = ~leafmat[m.branch[0]]
    return [int(v) for v in
            np.nonzero(~(leafmat & outside).any(axis=1))[0]]


def write_plot_coords(path: str, anc: AncesTree,
                      muts: List[MutationRecord], tree_index: int,
                      poplabels=None):
    """Text plot-coordinate file consumed by external plotting (one row per
    node: id x y parent group)."""
    layout = tree_layout(anc.seq[tree_index].tree, anc.sample_ages)
    with open(path, "w") as f:
        f.write("node x y parent group\n")
        N = anc.N
        for v in range(len(layout["x"])):
            g = poplabels.group_of_haplotype[v] \
                if (poplabels is not None and v < N) else -1
            f.write(f"{v} {layout['x'][v]:g} {layout['y'][v]:g} "
                    f"{layout['parent'][v]} {g}\n")


def render_tree(tree: Tree, path: str,
                sample_ages: Optional[np.ndarray] = None,
                highlight_branch: Optional[int] = None):  # pragma: no cover
    """Optional matplotlib rendering of one tree; raises ImportError
    without matplotlib (the TreeView tool then writes only the
    ``.coords``)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("matplotlib not available for rendering") from e
    lay = tree_layout(tree, sample_ages)
    fig, ax = plt.subplots(figsize=(8, 5))
    for v in range(tree.num_nodes):
        p = lay["parent"][v]
        if p < 0:
            continue
        col = "crimson" if v == highlight_branch else "black"
        ax.plot([lay["x"][v], lay["x"][v]], [lay["y"][v], lay["y"][p]],
                color=col, lw=1)
        ax.plot([lay["x"][v], lay["x"][p]], [lay["y"][p], lay["y"][p]],
                color="black", lw=0.8)
    ax.set_xlabel("haplotypes")
    ax.set_ylabel("generations")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path

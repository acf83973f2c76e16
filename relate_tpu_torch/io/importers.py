"""Tree-sequence importers: Newick, RENT+, ARGweaver .smc, msprime text.

Counterpart of ``relate_tpu/io/importers.py``: functional equivalents of
``AncesTree::ReadNewick/ReadRent/ReadArgweaverSMC/ReadMsPrime``
(``include/src/anc.cpp:1173-1750``) built on one generic Newick parser
instead of the reference's per-format character scanners. All return
:class:`~relate_tpu_torch.core.trees.AncesTree`. The parser and the id
assignment walk the tree with an explicit stack, not by recursion, so a
tree nested as deep as it has leaves (a caterpillar of 2,048 leaves nests
2,047 levels) reads like any other; the trees are those of the JAX module.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from ..core.trees import AncesTree, MarginalTree, Tree
from .haps import smart_open

_NAME = re.compile(r"[^(),:;]*")
_LENGTH = re.compile(r"[^(),:;]+")


class _NwNode:
    __slots__ = ("name", "length", "children")

    def __init__(self):
        self.name = ""
        self.length = 0.0
        self.children: List["_NwNode"] = []


def _label(s: str, pos: int, node: _NwNode) -> int:
    """Read a node's name and ``:length`` at ``pos``; the position after."""
    node.name = _NAME.match(s, pos).group(0)
    pos += len(node.name)
    if pos < len(s) and s[pos] == ":":
        m = _LENGTH.match(s, pos + 1)
        if m is None:
            raise ValueError(f"malformed newick: no branch length at {pos}")
        node.length = float(m.group(0))
        pos = m.end()
    return pos


def _parse_newick_str(s: str) -> _NwNode:
    """Parse one Newick string (';' optional) into a nested node tree.
    NHX/argweaver comments in [...] are ignored; node names may be any
    token not containing '(),:;'."""
    s = re.sub(r"\[[^\]]*\]", "", s.strip())
    if s.endswith(";"):
        s = s[:-1]
    pos = 0
    root = node = _NwNode()
    open_nodes: List[_NwNode] = []     # nodes whose '(' is not closed yet
    while True:
        while pos < len(s) and s[pos] == "(":
            pos += 1
            open_nodes.append(node)
            node = _NwNode()
            open_nodes[-1].children.append(node)
        pos = _label(s, pos, node)
        while True:
            if not open_nodes:
                return root
            if pos >= len(s):
                raise ValueError("malformed newick: unbalanced '('")
            if s[pos] == ",":
                pos += 1
                node = _NwNode()
                open_nodes[-1].children.append(node)
                break
            if s[pos] != ")":
                raise ValueError(
                    f"malformed newick: {s[pos]!r} at {pos}")
            pos += 1
            node = open_nodes.pop()
            pos = _label(s, pos, node)


def _leaves(root: _NwNode) -> List[_NwNode]:
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        if not n.children:
            out.append(n)
        stack.extend(reversed(n.children))
    return out


def _assign(root: _NwNode, leaf_id, check_binary: bool, scale: float
            ) -> Tree:
    """Array tree of a parsed Newick tree: leaves numbered by
    ``leaf_id(node)``, internal nodes N, N+1, ... in post-order (children
    left to right), so the root lands at 2N-2."""
    N = len(_leaves(root))
    M = 2 * N - 1
    parent = np.full(M, -1, np.int32)
    cl = np.full(M, -1, np.int32)
    cr = np.full(M, -1, np.int32)
    bl = np.zeros(M, np.float64)
    ids = {}
    nxt = N
    stack = [(root, False)]
    while stack:
        n, done = stack.pop()
        if not n.children:
            ids[id(n)] = leaf_id(n)
            continue
        if not done:
            if check_binary and len(n.children) != 2:
                raise ValueError("importers require strictly binary trees")
            stack.append((n, True))
            stack.append((n.children[1], False))
            stack.append((n.children[0], False))
            continue
        a, b = ids[id(n.children[0])], ids[id(n.children[1])]
        v = nxt
        nxt += 1
        parent[a] = parent[b] = v
        cl[v], cr[v] = a, b
        bl[a] = n.children[0].length * scale
        bl[b] = n.children[1].length * scale
        ids[id(n)] = v
    if check_binary and ids[id(root)] != M - 1:
        raise ValueError("malformed newick tree")
    return Tree(parent=parent, child_left=cl, child_right=cr,
                branch_length=bl)


def newick_to_tree(s: str, leaf_base: int = 0, scale: float = 1.0,
                   leaf_map: Optional[Dict[str, int]] = None) -> Tree:
    """Newick -> array Tree. Leaves must be labeled with integers (minus
    ``leaf_base``) or resolvable through ``leaf_map``; internal ids are
    assigned in post-order so the root lands at 2N-1."""
    def leaf_id(n):
        if leaf_map is not None and n.name in leaf_map:
            return leaf_map[n.name]
        return int(n.name) - leaf_base
    return _assign(_parse_newick_str(s), leaf_id, True, scale)


def _read_pos_newick(path: str, leaf_base: int, Ne: float) -> AncesTree:
    seq = []
    with smart_open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            pos_s, nw = line.split(None, 1)
            t = newick_to_tree(nw, leaf_base=leaf_base, scale=Ne)
            seq.append(MarginalTree(pos=int(float(pos_s)), tree=t))
    return AncesTree(N=seq[0].tree.N, seq=seq)


def read_newick(path: str, Ne: float = 1.0) -> AncesTree:
    """Lines of ``pos newick`` with 0-based integer leaf labels
    (AncesTree::ReadNewick, anc.cpp:1556); branch lengths scaled by Ne."""
    return _read_pos_newick(path, 0, Ne)


def read_rent(path: str, Ne: float = 1.0) -> AncesTree:
    """RENT+ trees output: ``pos newick`` with 1-based leaf labels
    (AncesTree::ReadRent, anc.cpp:1416)."""
    return _read_pos_newick(path, 1, Ne)


def read_argweaver_smc(path: str) -> AncesTree:
    """ARGweaver .smc: a NAMES header mapping leaves, then
    ``TREE\\tstart\\tend\\tnewick`` lines with [&&NHX] annotations
    (AncesTree::ReadArgweaverSMC, anc.cpp:1215). Leaf k of the newick maps
    to NAMES column k; argweaver's internal node labels are ignored (ids
    are reassigned in post-order)."""
    seq = []
    leaf_map: Dict[str, int] = {}
    with smart_open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] == "NAMES":
                # argweaver: NAMES n1 n2 ... — newick leaf j is sample
                # int(names[j])-1 in the reference's convention
                for j, name in enumerate(parts[1:]):
                    leaf_map[str(j)] = int(name) - 1 \
                        if name.isdigit() else j
            elif parts[0] == "TREE":
                start = int(float(parts[1]))
                t = _assign_with_map(_parse_newick_str(parts[3]), leaf_map)
                seq.append(MarginalTree(pos=start, tree=t))
    return AncesTree(N=seq[0].tree.N, seq=seq)


def _assign_with_map(root: _NwNode, leaf_map: Dict[str, int]) -> Tree:
    """Array tree with the leaves routed through ``leaf_map`` (a name
    missing from it must be an integer, its own id)."""
    return _assign(root, lambda n: leaf_map.get(n.name, int(n.name)),
                   False, 1.0)


def read_msprime(path: str) -> AncesTree:
    """msprime text export (AncesTree::ReadMsPrime / Tree::GetMsPrime,
    anc.cpp:6-36,1173): a comment line; ``N num_snps``; then per SNP a
    position line followed by 2N-1 node lines ``node [cl cr bl_l bl_r]``."""
    seq = []
    with smart_open(path) as f:
        f.readline()
        N, num_snp = (int(x) for x in f.readline().split()[:2])
        M = 2 * N - 1
        for _ in range(num_snp):
            pos = int(float(f.readline().strip()))
            parent = np.full(M, -1, np.int32)
            cl = np.full(M, -1, np.int32)
            cr = np.full(M, -1, np.int32)
            bl = np.zeros(M, np.float64)
            for _ in range(M):
                toks = f.readline().split()
                v = int(float(toks[0]))
                if len(toks) > 1:
                    a, b = int(float(toks[1])), int(float(toks[2]))
                    cl[v], cr[v] = a, b
                    parent[a] = parent[b] = v
                    bl[a] = float(toks[3])
                    bl[b] = float(toks[4])
            seq.append(MarginalTree(pos=pos, tree=_canonicalize(
                N, parent, cl, cr, bl)))
    return AncesTree(N=N, seq=seq)


def _canonicalize(N: int, parent, cl, cr, bl) -> Tree:
    """Renumber internal nodes into post-order (root last), the layout the
    rest of the framework assumes; msprime ids can be arbitrary."""
    M = 2 * N - 1
    root = int(np.nonzero(parent < 0)[0][-1])
    newid = np.full(M, -1, np.int32)
    newid[:N] = np.arange(N)
    nxt = N
    stack = [(root, False)]
    while stack:
        v, done = stack.pop()
        if v < N:
            continue
        if done:
            newid[v] = nxt
            nxt += 1
        else:
            stack.append((v, True))
            stack.append((int(cr[v]), False))
            stack.append((int(cl[v]), False))
    p2 = np.full(M, -1, np.int32)
    c1 = np.full(M, -1, np.int32)
    c2 = np.full(M, -1, np.int32)
    b2 = np.zeros(M, np.float64)
    for v in range(M):
        nv = newid[v]
        b2[nv] = bl[v]
        if parent[v] >= 0:
            p2[nv] = newid[parent[v]]
        if cl[v] >= 0:
            c1[nv] = newid[cl[v]]
            c2[nv] = newid[cr[v]]
    return Tree(parent=p2, child_left=c1, child_right=c2, branch_length=b2)

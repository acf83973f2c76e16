"""Topology post-processing: the PostProcess mode.

Counterpart of ``relate_tpu/pipeline/postprocess.py`` (behavioural reference
``include/pipeline/PostProcess.cpp``, standalone entry :311, per-chunk entry
:980). For every internal branch with no mapped mutation, the three
nearest-neighbour-interchange resolutions of the (child1, child2, sibling)
triplet are scored against the carrier sets of nearby SNPs with the
approximate-match criterion of ``Map`` (PostProcess.cpp:136-203); the
resolution whose supporting SNP is closest wins (:630-695), up to 5 sweeps a
tree (:488). With ``randomise`` (:700-860) unsupported adjacent node pairs
are re-resolved at random. Then nodes are relabelled so that every parent's
label exceeds its children's (Relabel, :18-70), spans are reset to the tree
span and every SNP is mapped again onto the new topologies (:879-955).

The decisions and their order are the JAX module's. What differs is where
the carrier counts come from. The JAX module sums a (K, N) boolean block
over each clade's columns, three to seven times for every node it visits.
Here the tree's SNP window is one (K, N) slice of the eligible rows that the
sequence's trees reach, uploaded once as uint8, and one product
``block @ leaf_matrix.T`` (the block cast to float32) gives every node's
carrier count in a (K, 2N-1) matrix of integer columns. A pairing of two
clades, or the fallback's union of three, is disjoint, so its count is a sum
of columns; after an interchange at node i only i's clade changes, and its
column becomes the sum of its new children's. The scores and the nearest
supporting distance of every node of a sweep are computed in one batch on
the device; the host loop then walks the nodes in the JAX module's order and
recomputes, again in one batch, the nodes whose triplet an interchange has
changed. The comparisons are the JAX module's: ``0.7 * d`` and the distances
in float64, the counts as integers; float32 holds the product's 0/1 sums
exactly up to 2^24.

``device=None`` is the CUDA card; ``device="cpu"`` runs the same code on CPU
tensors.
"""
from __future__ import annotations

import heapq
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.mapmutation import TreeMapper, force_map_mutation
from ..core.topology import MutationRecord
from ..core.trees import AncesTree, Tree
from ..utils.devmem import resolve_device
from ..utils.trace import note

BUF = 5000          # ring buffer of DAF>1 SNPs (PostProcess.cpp:414)
SWEEPS = 5          # sweeps a tree at most (PostProcess.cpp:488)
# (window SNPs x nodes) cells a batch of node evaluations may hold: bounds
# the float64 temporaries of the batch at N = 16384
BATCH_CELLS = 1 << 24


def _map_scores(matching: torch.Tensor, nd: torch.Tensor, daf: torch.Tensor,
                thr: int, N: int) -> torch.Tensor:
    """Vectorized Map (PostProcess.cpp:136-203) from carrier counts.

    matching: (K, B) carriers of each of K SNPs inside each of B clades;
    nd: (B,) clade sizes; daf: (K,) derived-allele counts. Returns the (K, B)
    int64 scores of the JAX module's ``_map_scores``: 0 = exact support,
    ``thr`` = none, in between the approximate mismatch count."""
    m = matching.to(torch.int64)
    d = daf.to(torch.int64)[:, None]
    nd = nd.to(torch.int64)[None, :]
    nm = nd - m
    ok = (d - nd).abs() < thr              # the outer guard (:145-147)
    exact = (nm == 0) & (m == d)
    none = torch.full_like(m, thr)
    zero = torch.zeros_like(m)
    if thr <= 1:
        return torch.where(ok & exact, zero, none)
    approx = d - m + nm
    d64, m64, nm64 = d.double(), m.double(), nm.double()
    nd64 = nd.double()
    cond = ((nm < thr) & (approx < thr) & (m64 > 0.7 * d64)
            & (nm64 < 0.3 * (N - d64))
            & (m64 > 0.7 * nd64) & ((N - d - nm).double() > 0.7 * (N - nd64)))
    s = torch.where(exact, zero,
                    torch.where((d >= 4) & cond, approx, none))
    return torch.where(ok, s, none)


def _nearest(dist: torch.Tensor, mask: torch.Tensor,
             default: float) -> torch.Tensor:
    """(B,) smallest ``dist`` over each column's masked SNPs, else
    ``default``."""
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dist.device)
    best = torch.where(mask, dist[:, None], inf).amin(dim=0)
    return torch.where(torch.isinf(best), torch.full_like(best, default),
                       best)


class _Window:
    """One tree's support window on the device: the carrier counts of every
    node for every SNP of the window, and what a node's costs need."""

    def __init__(self, counts, nd, daf, dist, thr, N, threshold, bp_init):
        self.counts = counts           # (K, M) int32
        self.nd = nd                   # (M,) int64, on the device
        self.daf = daf                 # (K,) int64
        self.dist = dist               # (K,) float64
        self.thr, self.N = thr, N
        self.threshold, self.bp_init = threshold, bp_init
        self.fallback = 0              # node evaluations that fell back

    def costs(self, n1: np.ndarray, n2: np.ndarray,
              n3: np.ndarray) -> np.ndarray:
        """(B, 3) float64 distances of the nearest support of the pairings
        (n1, n2), (n1, n3), (n2, n3) of B nodes: the JAX module's ce12,
        ce13 and ce23, the approximate fallback included."""
        K = self.counts.shape[0]
        step = max(1, BATCH_CELLS // max(K, 1))
        out = [self._costs(n1[i:i + step], n2[i:i + step], n3[i:i + step])
               for i in range(0, len(n1), step)]
        return np.concatenate(out) if out else np.zeros((0, 3))

    def _costs(self, n1, n2, n3):
        dev = self.counts.device
        ids = torch.from_numpy(np.stack([n1, n2, n3]).astype(np.int64)).to(
            dev)
        a, b, c = (self.counts.index_select(1, ids[k]) for k in range(3))
        na, nb, nc = (self.nd.index_select(0, ids[k]) for k in range(3))
        thr, N, daf = self.thr, self.N, self.daf
        s12 = _map_scores(a + b, na + nb, daf, thr, N)
        s13 = _map_scores(a + c, na + nc, daf, thr, N)
        s23 = _map_scores(b + c, nb + nc, daf, thr, N)
        # exact support: priority 12 > 13 > 23 (the reference evaluates the
        # next pairing only when the previous failed)
        e12 = s12 == 0
        e13 = (s13 == 0) & ~e12
        e23 = (s23 == 0) & ~e12 & ~e13
        ce = torch.stack([_nearest(self.dist, e, self.bp_init)
                          for e in (e12, e13, e23)], dim=1)
        if thr > 1:
            fb = torch.nonzero((ce > self.threshold).all(dim=1)).flatten()
            self.fallback += len(fb)
            if len(fb):
                # approximate fallback (PostProcess.cpp:592-625): the best
                # partial score wins if it beats mapping onto each child
                # alone or all three together
                def sub(x):
                    return x.index_select(1, fb)
                smin = torch.full((len(self.dist), len(fb)), thr,
                                  dtype=torch.int64, device=dev)
                for cnt, size in ((a, na), (b, nb), (c, nc),
                                  (a + b + c, na + nb + nc)):
                    smin = torch.minimum(smin, _map_scores(
                        sub(cnt), size.index_select(0, fb), daf, thr, N))
                f12, f13, f23 = sub(s12), sub(s13), sub(s23)
                d2 = self.dist + self.threshold
                inf = float("inf")
                won = ((f12 < f13) & (f12 < f23) & (f12 < smin),
                       (f13 < f12) & (f13 < f23) & (f13 < smin),
                       (f23 < f12) & (f23 < f13) & (f23 < smin))
                near = torch.stack([_nearest(d2, w, inf) for w in won], 1)
                ce[fb] = torch.minimum(ce[fb], near)
        return ce.cpu().numpy()


def _relabel(tree: Tree) -> np.ndarray:
    """Relabel internal nodes so every parent's label exceeds its
    children's (Relabel, PostProcess.cpp:18-70). Returns old->new map and
    rewires the tree arrays in place."""
    M = tree.num_nodes
    N = tree.N
    indeg = np.zeros(M, dtype=np.int64)
    indeg[N:] = 2
    ready = list(range(N))
    heapq.heapify(ready)
    newlab = np.empty(M, dtype=np.int32)
    nxt = 0
    parent = tree.parent
    while ready:
        v = heapq.heappop(ready)
        newlab[v] = nxt
        nxt += 1
        p = int(parent[v])
        if p >= 0:
            indeg[p] -= 1
            if indeg[p] == 0:
                heapq.heappush(ready, p)
    assert nxt == M
    inv = np.empty(M, dtype=np.int64)
    inv[newlab] = np.arange(M)
    for name in ("branch_length", "num_events", "SNP_begin", "SNP_end"):
        arr = getattr(tree, name)
        arr[:] = arr[inv]

    def moved(old):
        new = np.full(M, -1, dtype=old.dtype)
        has = old >= 0
        new[newlab[has]] = newlab[old[has]]
        return new
    tree.parent[:], tree.child_left[:], tree.child_right[:] = (
        moved(tree.parent), moved(tree.child_left), moved(tree.child_right))
    return newlab


def _sibling(tree: Tree, i: int, parent: int) -> int:
    n3 = int(tree.child_left[parent])
    return int(tree.child_right[parent]) if n3 == i else n3


def _triplets(tree: Tree, nodes: np.ndarray):
    """(n1, n2, n3) of ``nodes``: their children and their siblings."""
    par = tree.parent[nodes]
    left = tree.child_left[par]
    n3 = np.where(left == nodes, tree.child_right[par], left)
    return (tree.child_left[nodes].astype(np.int64),
            tree.child_right[nodes].astype(np.int64), n3.astype(np.int64))


def _sweeps(tree: Tree, coords: np.ndarray, win: _Window, stats: dict
            ) -> int:
    """The JAX module's node loop (up to ``SWEEPS`` sweeps) on one tree.
    Returns the number of rearranged nodes."""
    N = tree.N
    root = 2 * N - 2
    M = root + 1
    num_updated = 0
    # an interchange at node i changes i's clade: its column in the counts
    # and its size. A node's costs stay valid while its triplet and the
    # clades of the triplet's members are those they were computed from.
    changed = np.zeros(M, dtype=np.int64)
    version = 0
    for _ in range(SWEEPS):
        stats["sweeps"] += 1
        cand = np.arange(root - 1, N - 1, -1)
        cand = cand[(tree.num_events[cand] < 1.0) & (tree.parent[cand] >= 0)]
        trip = np.full((M, 3), -1, dtype=np.int64)
        cost = np.zeros((M, 3))
        at = np.zeros(M, dtype=np.int64)

        def refresh(nodes):
            n1, n2, n3 = _triplets(tree, nodes)
            cost[nodes] = win.costs(n1, n2, n3)
            trip[nodes] = np.stack([n1, n2, n3], axis=1)
            at[nodes] = version
            stats["batches"] += 1

        if len(cand):
            refresh(cand)
        is_updated = False
        for k, i in enumerate(cand.tolist()):
            if tree.num_events[i] >= 1.0:
                continue
            parent = int(tree.parent[i])
            if parent < 0:
                continue
            stats["nodes_visited"] += 1
            n1 = int(tree.child_left[i])
            n2 = int(tree.child_right[i])
            n3 = _sibling(tree, i, parent)
            t = trip[i]
            if (t[0] != n1 or t[1] != n2 or t[2] != n3
                    or max(changed[n1], changed[n2], changed[n3]) > at[i]):
                # stale: recompute it with every other stale node still to
                # be visited in this sweep
                rest = cand[k:]
                rest = rest[tree.num_events[rest] < 1.0]
                r1, r2, r3 = _triplets(tree, rest)
                stale = ((trip[rest, 0] != r1) | (trip[rest, 1] != r2)
                         | (trip[rest, 2] != r3)
                         | (np.maximum(np.maximum(changed[r1], changed[r2]),
                                       changed[r3]) > at[rest]))
                refresh(rest[stale])
            ce12, ce13, ce23 = cost[i]

            if ((ce13 < ce12 and ce13 <= ce23)
                    or (ce13 <= ce12 and ce13 < ce23)):
                keep, move, displaced = n1, n3, n2
            elif ((ce23 < ce12 and ce23 <= ce13)
                    or (ce23 <= ce12 and ce23 < ce13)):
                keep, move, displaced = n2, n3, n1
            elif ((ce12 < ce23 and ce12 <= ce13)
                    or (ce12 <= ce23 and ce12 < ce13)):
                tree.num_events[i] = 1.0
                continue
            else:
                continue

            is_updated = True
            num_updated += 1
            tree.child_left[i] = keep
            tree.child_right[i] = move
            tree.parent[keep] = i
            tree.parent[move] = i
            tree.child_left[parent] = i
            tree.child_right[parent] = displaced
            tree.parent[i] = parent
            tree.parent[displaced] = parent
            if coords[move] >= coords[i]:
                coords[i] = (coords[parent] + coords[move]) / 2.0
            tree.num_events[i] = 1.0
            tree.branch_length[keep] = coords[i] - coords[keep]
            tree.branch_length[move] = coords[i] - coords[move]
            tree.branch_length[displaced] = coords[parent] - coords[displaced]
            tree.branch_length[i] = coords[parent] - coords[i]
            win.counts[:, i] = win.counts[:, keep] + win.counts[:, move]
            win.nd[i] = win.nd[keep] + win.nd[move]
            version += 1
            changed[i] = version
        if not is_updated:
            break
    return num_updated


def post_process(anc: AncesTree, muts: List[MutationRecord],
                 G: np.ndarray, bp: np.ndarray,
                 rdist: Optional[np.ndarray] = None,
                 seed: int = 1, randomise: bool = False,
                 first_snp: int = 0, device=None) -> int:
    """Full PostProcess pass over a tree sequence on ``device``. Mutates
    ``anc`` and ``muts`` in place; returns the number of rearranged nodes.

    ``G`` (L, N) and ``bp`` are the chunk's; record i of ``muts`` is SNP
    ``first_snp + i`` of it (a window's records start at the window's first
    SNP), and the last tree ends at the records' last SNP. ``rdist``:
    per-SNP genetic position (cM); when given, the support window threshold
    is 10 cM (PostProcess.cpp:368), else physical bp with 10 Mb (:359).

    Adds to the open stage's record (``utils.trace.note``, key
    ``postprocess``): trees, rearranged nodes, sweeps, nodes visited, node
    batches, node evaluations that took the approximate fallback, uploaded
    rows, and the host seconds of the products (with the leaf matrices and
    their uploads), of the node loops and of the remapping."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = anc.N
    root = 2 * N - 2
    thr = int(0.03 * N) + 1
    L = G.shape[0]
    if rdist is None:
        rdist = np.asarray(bp, dtype=np.float64)
        threshold = 10e6
    else:
        rdist = np.asarray(rdist, dtype=np.float64)
        threshold = 10.0
    bp_init = float(rdist[-1])
    last_snp = min(first_snp + len(muts), L) - 1

    daf_all = G.sum(axis=1, dtype=np.int64)
    elig = np.nonzero(daf_all > 1)[0]          # buffer-eligible SNPs
    elig_rank = np.searchsorted(elig, np.arange(L))
    # the eligible rows within BUF/2 of a tree position: the only ones a
    # support window reads, uploaded once as uint8 (tree positions ascend)
    if len(anc.seq):
        base = max(int(elig_rank[min(anc.seq[0].pos, L - 1)]) - BUF // 2, 0)
        top = min(int(elig_rank[min(anc.seq[-1].pos, L - 1)]) + BUF // 2,
                  len(elig))
    else:
        base = top = 0
    up = elig[base:top]
    rows = torch.from_numpy(np.ascontiguousarray(G[up], dtype=np.uint8)).to(
        dev)
    daf_dev = torch.from_numpy(daf_all[up]).to(dev)
    rd_dev = torch.from_numpy(rdist[up]).to(dev)

    stats = dict(trees=len(anc.seq), nodes_rearranged=0, sweeps=0,
                 nodes_visited=0, batches=0, fallback_nodes=0,
                 uploaded_rows=len(up), product_s=0.0, loop_s=0.0)
    num_updated = 0
    for t, mt in enumerate(anc.seq):
        t0 = time.perf_counter()
        tree = mt.tree
        coords = tree.coordinates(anc.sample_ages).astype(np.float64)
        tree_r = float(rdist[min(mt.pos, L - 1)])

        # SNP window: the BUF eligible SNPs around the tree position, within
        # the distance threshold (rdist ascends, so they are one slice)
        center = int(elig_rank[min(mt.pos, L - 1)])
        lo = max(center - BUF // 2, 0)
        hi = min(center + BUF // 2, len(elig))
        kept = np.nonzero(np.abs(rdist[elig[lo:hi]] - tree_r) < threshold)[0]
        if len(kept) and kept[-1] - kept[0] + 1 == len(kept):
            sl = slice(lo - base + int(kept[0]), lo - base + int(kept[-1]) + 1)
            block, daf, dist = rows[sl], daf_dev[sl], rd_dev[sl]
        else:
            idx = torch.from_numpy(lo - base + kept).to(dev)
            block, daf = rows.index_select(0, idx), daf_dev.index_select(
                0, idx)
            dist = rd_dev.index_select(0, idx)
        dist = (dist - tree_r).abs()

        if len(kept):
            leaf = tree.leaf_matrix()
            leaf_dev = torch.from_numpy(leaf).to(dev).to(torch.float32)
            counts = (block.to(torch.float32) @ leaf_dev.t()).to(
                torch.int32)                                     # (K, M)
            nd = torch.from_numpy(leaf.sum(axis=1, dtype=np.int64)).to(dev)
            win = _Window(counts, nd, daf, dist, thr, N, threshold, bp_init)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)     # the product's time ends here
            t1 = time.perf_counter()
            num_updated += _sweeps(tree, coords, win, stats)
            stats["fallback_nodes"] += win.fallback
        else:
            # no SNP to support anything: the JAX module's node loop breaks
            # at its first node, and the sweep ends without an update
            t1 = time.perf_counter()
            stats["sweeps"] += 1

        if randomise:
            _randomise_pass(tree, coords, rng, N, root)

        _relabel(tree)
        # reset spans + events (PostProcess.cpp:866-875)
        nxt_pos = anc.seq[t + 1].pos if t + 1 < len(anc.seq) else last_snp
        tree.SNP_begin[:] = mt.pos
        tree.SNP_end[:] = nxt_pos
        tree.num_events[:] = 0.0
        t2 = time.perf_counter()
        stats["product_s"] += t1 - t0
        stats["loop_s"] += t2 - t1

    t0 = time.perf_counter()
    _remap_mutations(anc, muts, G, first_snp)
    stats["remap_s"] = time.perf_counter() - t0
    stats["nodes_rearranged"] = num_updated
    note("postprocess", stats)
    return num_updated


def _randomise_pass(tree: Tree, coords: np.ndarray,
                    rng: np.random.Generator, N: int, root: int):
    """--randomise (PostProcess.cpp:700-860): for adjacent unsupported
    node pairs (node + unsupported sibling with children), redistribute
    the four grandchildren uniformly over the two internal nodes."""
    for i in range(root - 1, N - 1, -1):
        if tree.num_events[i] >= 1.0:
            continue
        parent = int(tree.parent[i])
        if parent < 0:
            continue
        node2 = _sibling(tree, i, parent)
        if tree.num_events[node2] >= 1.0 or tree.child_left[node2] < 0:
            continue
        node1 = i
        remaining = [int(tree.child_left[node1]),
                     int(tree.child_right[node1]),
                     int(tree.child_left[node2]),
                     int(tree.child_right[node2])]

        for ch in remaining:
            if coords[ch] >= coords[node1]:
                coords[node1] = (coords[parent] + coords[ch]) / 2.0
            if coords[ch] >= coords[node2]:
                coords[node2] = (coords[parent] + coords[ch]) / 2.0
        if node2 > node1:
            node1, node2 = node2, node1
        if coords[node2] > coords[node1]:
            coords[node1], coords[node2] = coords[node2], coords[node1]

        # pick node2's pair uniformly from the 6 pairings (:1003-1040)
        val = rng.random()
        pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        a, b = pairs[min(int(val * 6), 5)]
        picked = [remaining[a], remaining[b]]
        rest = [remaining[j] for j in range(4) if j not in (a, b)]
        tree.child_left[node2] = picked[0]
        tree.child_right[node2] = picked[1]
        tree.parent[picked[0]] = node2
        tree.parent[picked[1]] = node2
        tree.branch_length[picked[0]] = coords[node2] - coords[picked[0]]
        tree.branch_length[picked[1]] = coords[node2] - coords[picked[1]]

        rest.append(node2)
        # pick node1's pair uniformly from the 3 pairings of the rest
        val = rng.random()
        pairs3 = [(0, 1), (0, 2), (1, 2)]
        a, b = pairs3[min(int(val * 3), 2)]
        picked1 = [rest[a], rest[b]]
        top = [rest[j] for j in range(3) if j not in (a, b)] + [node1]
        for ch in picked1:
            if coords[ch] >= coords[node1]:
                coords[node1] = (coords[parent] + coords[ch]) / 2.0
        tree.child_left[node1] = picked1[0]
        tree.child_right[node1] = picked1[1]
        tree.parent[picked1[0]] = node1
        tree.parent[picked1[1]] = node1
        tree.branch_length[picked1[0]] = coords[node1] - coords[picked1[0]]
        tree.branch_length[picked1[1]] = coords[node1] - coords[picked1[1]]
        tree.child_left[parent] = top[0]
        tree.child_right[parent] = top[1]
        tree.parent[top[0]] = parent
        tree.parent[top[1]] = parent
        tree.branch_length[top[0]] = coords[parent] - coords[top[0]]
        tree.branch_length[top[1]] = coords[parent] - coords[top[1]]


def _remap_mutations(anc: AncesTree, muts: List[MutationRecord],
                     G: np.ndarray, first_snp: int = 0):
    """Re-map every SNP onto its (possibly rearranged) tree and refresh
    branch / flipped / ages from the new coordinates
    (PostProcess.cpp:879-955). Record i is SNP ``first_snp + i`` of G."""
    N = anc.N
    root = 2 * N - 2
    last = G.shape[0] - 1
    by_tree = {}
    for i, m in enumerate(muts):
        by_tree.setdefault(m.tree, []).append(i)
    for t, recs in by_tree.items():
        tree = anc.seq[t].tree
        coords = tree.coordinates(anc.sample_ages).astype(np.float64)
        carriers = G[[min(first_snp + i, last) for i in recs]].astype(
            np.uint8)
        res = TreeMapper(tree, tree.leaf_matrix())(carriers)
        for j, i in enumerate(recs):
            m = muts[i]
            daf = int(carriers[j].sum())
            if daf == N:
                tree.num_events[root] += 1.0
                m.branch = [root]
                m.flipped = False
                m.age_begin = float(coords[root])
                m.age_end = float(coords[root])
                continue
            if res.is_mapping[j] <= 2 and res.branch[j] >= 0:
                b = int(res.branch[j])
                m.branch = [b]
                m.flipped = bool(res.flipped[j])
                tree.num_events[b] += 1.0
                m.age_begin = float(coords[b])
                m.age_end = (float(coords[int(tree.parent[b])])
                             if b < root else float(coords[b]))
            else:
                brs, flp = force_map_mutation(tree, carriers[j].astype(bool))
                m.branch = list(brs)
                m.flipped = flp
                m.age_begin = 0.0
                m.age_end = 0.0

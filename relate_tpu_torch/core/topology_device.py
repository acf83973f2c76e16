"""Device-resident BuildTopology for one section.

Counterpart of ``relate_tpu/core/topology_device.py``. Semantics follow
``AncesTreeBuilder::BuildTopology`` (include/src/anc_builder.cpp:397-656)
with the JAX package's documented deviation: the mutation-placement
tie-break among equal-mismatch candidates uses (clade size, node label)
instead of the reference's DFS post-order.

The JAX package compiles the whole per-section SNP loop into one two-level
scan. Eager PyTorch would drown in launches if it visited every SNP, so the
loop here works on blocks of ``KB`` SNPs: a whole block is mapped against
the current tree at once (one ``leafmat @ car_blk.T`` product and
``_map_on_tree`` vectorised over the block), the host finds the first SNP of
the block that asks for a rebuild, the records before it are emitted, the
tree is rebuilt there (distance assembly, same-rpos and clade priors, the
merge scan kernel, accept or revert), the rest of the block is mapped again
if the new tree was accepted, and so on. The records equal those of the
per-SNP formulation; device work is proportional to the number of rebuilds.

Non-mapping SNPs (is_mapping == 3) are flagged and their multi-branch
force-mapping is filled in on the host afterwards.

Merge seeds. Each merge scan takes one int32 seed for its tie-break hash:
``merge_seeds[0]`` for the first tree and ``merge_seeds[i + 1]`` for a
rebuild at the section's i-th SNP. By default they are drawn from
``numpy.random.default_rng(seed)``; a caller that wants the JAX package's
merge lists passes the seeds that package derives from its own generator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import mapmutation
from .distance import DistanceAssembler, _assemble_ops
from .painting import Checkpoint, Painter
from .topology import MutationRecord, SectionResult
from .treebuilder import thresholds, tree_from_merges
from .trees import AncesTree, MarginalTree
from ..ops.merge_scan import merge_scan, read_counts
from ..utils.trace import count, note, span

KB = 64        # SNPs mapped against the current tree per block
_BIG = 1e9


class _Mapped(NamedTuple):
    im: torch.Tensor        # (K,) int64: 1 mapped, 2 mapped flipped, 3 not
    branch: torch.Tensor    # (K,) int64, -1 where none
    flipped: torch.Tensor   # (K,) bool
    minv: torch.Tensor      # (K,) float32


def _map_on_tree(leafmat, csize, car, tc, N, M, thr, cc=None) -> _Mapped:
    """Vectorised MapMutation for K SNPs at once (mapmutation.py is the host
    twin). ``leafmat`` (M, N) clade indicators, ``csize`` (M,) clade sizes,
    ``car`` (K, N) float32 carrier rows, ``tc`` (K,) carrier counts, ``cc``
    (M, K) per-branch carrier counts if already known. Products and sums of
    0/1 entries are exact in float32, so a block gives what one SNP at a
    time gives."""
    if cc is None:
        cc = leafmat @ car.t()              # (M, K)
    dev = leafmat.device
    tnc = N - tc
    cs = csize[:, None]
    icn = cs - cc
    nc_ = tc[None, :] - cc
    cnc = tnc[None, :] - icn

    tc_s = torch.clamp(tc, min=1e-9)[None, :]
    tnc_s = torch.clamp(tnc, min=1e-9)[None, :]
    is_leaf = (torch.arange(M, device=dev) < N)[:, None]
    is_carrier = cc > 0.5

    den1 = cc + icn
    den2 = nc_ + cnc
    r_nc = nc_ / tc_s < 0.3
    r_icn = icn / tnc_s < 0.3
    r_cc = cc / tc_s < 0.3
    r_cnc = cnc / tnc_s < 0.3
    d1 = torch.clamp(den1, min=1e-9)
    d2 = torch.clamp(den2, min=1e-9)
    cond_u = r_nc & r_icn
    cond_u &= (den1 <= 0) | (cc / d1 > 0.7)
    cond_u &= (den2 <= 0) | (cnc / d2 > 0.7)
    cond_f = r_cc & r_cnc
    cond_f &= (den2 <= 0) | (nc_ / d2 > 0.7)
    cond_f &= (den1 <= 0) | (icn / d1 > 0.7)
    leaf_u = torch.where(is_carrier, r_nc, r_nc & r_icn)
    leaf_f = torch.where(is_carrier, r_cc & r_cnc, r_cnc)
    cond_u = torch.where(is_leaf, leaf_u, cond_u)
    cond_f = torch.where(is_leaf, leaf_f, cond_f)

    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    eff_u = torch.where(cond_u, nc_ + icn, big)
    eff_f = torch.where(cond_f, cc + cnc, big)
    # prefer-deeper tie-break: smallest clade, then smallest label
    rank = (csize * (M + 1)
            + torch.arange(M, device=dev, dtype=torch.float32))[:, None]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    def pick(eff):
        m = eff.min(dim=0).values
        sub = torch.where(eff == m[None, :], rank, inf)
        return m, sub.argmin(dim=0)

    min_u, bu = pick(eff_u)
    min_f, bf = pick(eff_f)

    use_f = min_f < min_u               # exact tie -> unflipped (determ.)
    chosen_min = torch.where(use_f, min_f, min_u)
    branch = torch.where(use_f, bf, bu)
    ok = chosen_min <= thr
    three = torch.full_like(branch, 3)
    is_mapping = torch.where(ok, torch.where(use_f, 2, 1), three)
    flipped = ok & use_f
    branch = torch.where(ok, branch, torch.full_like(branch, -1))
    minv = torch.where(chosen_min >= _BIG, inf, chosen_min)

    all_c = tc == N
    none_c = tc == 0
    triv = all_c | none_c
    is_mapping = torch.where(triv, torch.ones_like(is_mapping), is_mapping)
    branch = torch.where(all_c, torch.full_like(branch, M - 1),
                         torch.where(none_c, torch.full_like(branch, -1),
                                     branch))
    flipped = flipped & ~triv
    minv = torch.where(triv, torch.zeros_like(minv), minv)
    return _Mapped(is_mapping, branch, flipped, minv)


def next_derived_rpos(G: np.ndarray, rpos: np.ndarray) -> np.ndarray:
    """NXT[l, n] = rpos of the first derived site of n at/after l (or the
    last SNP): the fresh-value equivalent of the reference's lazily
    refreshed v_rpos_next (anc_builder.cpp:139-147)."""
    L, N = G.shape
    idx = np.where(G == 1, np.arange(L, dtype=np.int32)[:, None],
                   np.int32(L - 1))
    m = np.minimum.accumulate(idx[::-1], axis=0)[::-1]
    return np.asarray(rpos, dtype=np.float64)[m].astype(np.float32)


def default_merge_seeds(seed: int, S: int) -> np.ndarray:
    """(S+1,) int32 seeds: first tree, then one per SNP of the section."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**31 - 1, size=S + 1).astype(np.int32)


def build_topology_section_device(painter: Painter, cp: Checkpoint,
                                  G: np.ndarray, rpos: np.ndarray,
                                  state: np.ndarray, bp: np.ndarray,
                                  start: int, end: int, seed: int,
                                  mode: int = 1, fb: int = 0,
                                  merge_seeds: Optional[np.ndarray] = None,
                                  paint=None) -> SectionResult:
    """Device-resident BuildTopology for one window [start, end].

    ``paint`` may be a ready ``PaintOutput`` of this window (state carried
    across); by default the window is repainted from ``cp``."""
    L, N = G.shape
    S = end - start + 1
    M = 2 * N - 1
    dev = painter.device
    theta = painter.model.theta
    thr_map = 0.03 * N
    threshold, threshold_cf = thresholds(theta)
    val = -float(np.log(theta / (1.0 - theta)))
    use_cf = mode == 1
    if merge_seeds is None:
        merge_seeds = default_merge_seeds(seed, S)
    merge_seeds = np.asarray(merge_seeds)
    if merge_seeds.shape != (S + 1,):
        raise ValueError(f"merge_seeds must have shape ({S + 1},)")

    nxt_full = next_derived_rpos(G, rpos)
    if paint is None:
        paint = painter.repaint(cp)
    assembler = DistanceAssembler(G, rpos, nxt=nxt_full)
    dstate = assembler.init_state(paint.plan, start)
    topology, logscale = paint.topology, paint.logscale

    car = G[start:end + 1].astype(np.uint8).copy()
    car[S - 1] = 0
    force = np.zeros(S, dtype=bool)
    if fb > 0:
        idxs = np.arange(start + 1, end)
        force[idxs - start] = (bp[idxs + 1] // fb - bp[idxs] // fb) >= 1
    state_flag = np.asarray(state[start:end + 1]) > 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # per-SNP row state, as the per-SNP loop would carry it: carriers of
    # every SNP but the section's first advance their row and refresh
    # rpos_prev (anc_builder.cpp:487-495)
    car_dev = t(car)                                   # (S, N) uint8
    car_f = car_dev.to(torch.float32)
    tc_all = car_f.sum(dim=1)                          # (S,)
    rpos32 = t(np.asarray(rpos[start:end + 1], dtype=np.float32))
    nxt_dev = t(nxt_full[start:end + 1])               # (S, N) float32
    adv = car_dev.to(torch.int64)
    adv[0] = 0
    row_all = t(dstate.row.astype(np.int64))[None, :] + adv.cumsum(dim=0)
    snp_ids = torch.arange(S, device=dev, dtype=torch.int64)[:, None]
    last_adv = torch.where(adv > 0, snp_ids,
                           torch.full_like(snp_ids, -1)).cummax(dim=0).values
    rp_prev_all = torch.where(
        last_adv >= 0, rpos32[last_adv.clamp(min=0)],
        t(dstate.rpos_prev.astype(np.float32))[None, :])
    del adv, last_adv
    kcol = torch.arange(N, device=dev, dtype=torch.int64)
    eye = torch.eye(N, dtype=torch.float32, device=dev)
    force_dev = t(force)
    state_dev = t(state_flag)

    def assemble(i):
        snp = start + i
        is_fl = (snp == 0) or (snp == L - 1)
        cf = car_f[i]
        is_exact = (cf > 0.5) | is_fl
        rp_prev, rp_next, rp = rp_prev_all[i], nxt_dev[i], rpos32[i]
        denom = rp_next - rp_prev
        same = denom == 0
        safe = torch.where(same, torch.ones_like(denom), denom)
        half = torch.full_like(denom, 0.5)
        wl = torch.where(same, half, (rp_next - rp) / safe)
        wr = torch.where(same, half, (rp - rp_prev) / safe)
        return _assemble_ops(topology, logscale, row_all[i], is_exact, wl,
                             wr, kcol)

    tree_builds = 0

    def new_tree(mat, dcf, ucf, seed_):
        nonlocal tree_builds
        tree_builds += 1
        cis, cjs, clades = merge_scan(mat, dcf, ucf, threshold, threshold_cf,
                                      int(seed_))
        merges = torch.stack([cis, cjs], dim=1)
        return merges, torch.cat([eye, clades], dim=0)

    # first tree: plain build from the start-SNP matrix
    with span("topology.first_tree", dev):
        mat0 = assembler.get_matrix(paint, dstate, start,
                                    is_first_or_last=(start == 0
                                                      or start == L - 1))
        first_merges, leafmat = new_tree(mat0.contiguous(),
                                         torch.zeros_like(mat0), False,
                                         merge_seeds[0])
        csize = leafmat.sum(dim=1)
    events = torch.zeros(M, dtype=torch.float32, device=dev)
    num_tree = 1

    flush = np.zeros(S, dtype=bool)
    im_arr = np.zeros(S, dtype=np.int8)
    b_arr = np.zeros(S, dtype=np.int64)
    fl_arr = np.zeros(S, dtype=bool)
    t_arr = np.zeros(S, dtype=np.int64)
    merges_f, events_f = [], []

    for b0 in range(0, S, KB):
        b1 = min(b0 + KB, S)
        p = b0
        while p < b1:
            # map SNPs p..b1-1 against the current tree
            with span("topology.map", dev):
                cf = car_f[p:b1]
                tc = tc_all[p:b1]
                mp = _map_on_tree(leafmat, csize, cf, tc, N, M, thr_map)
                add_ev = ((mp.im <= 2) & (mp.branch >= 0)
                          & (((mp.branch == M - 1) & (tc == N))
                             | state_dev[p:b1]))
                do_rebuild = (mp.im > 1) | force_dev[p:b1]
                if p == 0:
                    do_rebuild[0] = False       # the section's first SNP
                h = torch.stack([mp.im, mp.branch, mp.flipped.to(torch.int64),
                                 do_rebuild.to(torch.int64)])
                with span("topology.readback", dev):
                    host = h.cpu().numpy()
                count("topology.readbacks")
            hits = np.nonzero(host[3])[0]
            q = p + int(hits[0]) if len(hits) else b1    # first rebuild SNP
            n_emit = min(q + 1, b1) - p       # q itself adds its event too
            events.index_add_(0, mp.branch[:n_emit].clamp(min=0),
                              add_ev[:n_emit].to(torch.float32))
            sl = slice(p, q)
            im_arr[sl] = host[0, :q - p]
            b_arr[sl] = host[1, :q - p]
            fl_arr[sl] = host[2, :q - p] > 0
            t_arr[sl] = num_tree - 1
            if q == b1:
                break

            # rebuild at SNP q: candidate tree from the distance matrix with
            # the same-rpos carrier penalty and the old tree's clade prior
            k = q - p
            cfq = car_f[q]
            im, branch = int(host[0, k]), int(host[1, k])
            force_q = bool(force[q])
            with span("topology.rebuild", dev):
                mat = assemble(q)
                mat = mat + val * cfq[:, None] * (1.0 - cfq[None, :])
                member = leafmat[N:]
                dcf = val * (member.t() @ (1.0 - member))
                merges, new_leafmat = new_tree(mat.contiguous(), dcf, use_cf,
                                               merge_seeds[q + 1])
                csize2 = new_leafmat.sum(dim=1)
                mp2 = _map_on_tree(new_leafmat, csize2, cfq[None, :],
                                   tc_all[q:q + 1], N, M, thr_map)
                h = torch.stack([mp2.im[0], mp2.branch[0],
                                 mp2.flipped[0].to(torch.int64),
                                 (mp2.minv[0] >= mp.minv[k]).to(torch.int64)])
                with span("topology.readback", dev):
                    h2 = h.cpu().numpy()
                count("topology.readbacks")
            im2, b2, fl2 = int(h2[0]), int(h2[1]), bool(h2[2])
            revert = (im2 > 1) and bool(h2[3]) and not force_q
            # the reverted record keeps the candidate tree's flipped flag
            # (anc_builder.cpp:625 compares where it meant to assign)
            fl_arr[q] = fl2
            if revert:
                count("topology.reverts")
                im_arr[q], b_arr[q], t_arr[q] = im, branch, num_tree - 1
            else:
                sflag = bool(state_flag[q])
                was_prev = ((im == 2) or (im == 1 and force_q)) \
                    and branch >= 0
                if was_prev and sflag:
                    events[branch] -= 1.0
                events_f.append(events)
                merges_f.append(merges)
                events = torch.zeros(M, dtype=torch.float32, device=dev)
                tcq = int(car[q].sum())
                if im2 <= 2 and b2 >= 0 and ((b2 == M - 1 and tcq == N)
                                             or sflag):
                    events[b2] += 1.0
                leafmat, csize = new_leafmat, csize2
                flush[q] = True
                im_arr[q], b_arr[q], t_arr[q] = im2, b2, num_tree
                num_tree += 1
            p = q + 1

    # reconstitute trees: tree 0 from first_merges; tree t > 0 from the flush
    # at its creating step; tree t's events come from the NEXT flush (or the
    # final state for the last tree)
    flush_steps = np.nonzero(flush)[0]
    assert len(flush_steps) == num_tree - 1, (len(flush_steps), num_tree)
    with span("topology.collect", dev):
        merge_list = [first_merges.cpu().numpy()] + \
            [m.cpu().numpy() for m in merges_f]
        event_list = [e.cpu().numpy() for e in events_f] + \
            [events.cpu().numpy()]
    pos_list = [start] + [start + int(i) for i in flush_steps]

    seq = []
    with span("topology.tree_from_merges"):
        for ti in range(num_tree):
            tr = tree_from_merges(merge_list[ti][:, 0], merge_list[ti][:, 1],
                                  N)
            tr.num_events = event_list[ti].astype(np.float32)
            tr.SNP_begin[:] = pos_list[ti]
            tr.SNP_end[:] = (pos_list[ti + 1] if ti + 1 < num_tree else end)
            seq.append(MarginalTree(pos=int(pos_list[ti]), tree=tr))
    anc = AncesTree(N=N, seq=seq)
    # a reverted candidate was built and is no tree of the section
    note("topology", dict(trees=num_tree, tree_builds=tree_builds))

    muts = []
    with span("topology.force_map"):
        for i in range(S):
            rec = MutationRecord(tree=int(t_arr[i]), flipped=bool(fl_arr[i]))
            if im_arr[i] <= 2 and b_arr[i] >= 0:
                rec.branch = [int(b_arr[i])]
            elif im_arr[i] > 2:
                tr = anc.seq[rec.tree].tree
                brs, flp = mapmutation.force_map_mutation(
                    tr, car[i].astype(bool))
                rec.branch = brs
                rec.flipped = flp
            muts.append(rec)
    # every scan of the section has been read back by now: count them
    read_counts()
    return SectionResult(anc=anc, muts=muts, start=start, end=end)

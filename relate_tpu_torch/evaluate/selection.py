"""Selection-evidence scan.

Counterpart of ``relate_tpu/evaluate/selection.py``. Behavioral reference:
``include/evaluate/selection/RelateSelection.cpp``:
- ``Frequency`` (:330-...): per SNP, the number of carrier lineages and
  total lineages at each epoch boundary (.freq/.lin files; epochs listed
  oldest-first), plus the lineage counts when the derived allele reaches
  half its present count and count 2.
- ``Selection`` (:190-330): log10 p-value that a mutation observed at fk of
  k lineages rises to fN of N under neutrality, the hypergeometric tail
  P(f >= fN | N, k, fk) (log_pvalue, :141-178), per epoch and for the
  DAF-half / freq-2 anchor points (.sele).
- ``Quality``, ``SDS`` (:816-1090) and ``FreqDiff`` (:1098-1330).

On ``device`` (None: the CUDA card):
- ``compute_freq_lin`` takes each tree's leaf matrix from
  ``branch_association_device._leafmats`` on the card; subtree membership
  and the carrier counts are products of 0/1 float32 matrices (exact: sums
  of at most N < 2^24 ones, also under TF32), every comparison of a node
  time with an epoch boundary is in float64, and the anchor ages come from
  a sort of each SNP's subtree ages. The counts leave the card once.
- ``log_pvalue_batch`` evaluates every tail in float64, in chunks sized
  from the card's free memory, in the JAX module's term order.
- ``sds`` sums each tree's derived and ancestral tip branch lengths as two
  float64 products.
``quality``, ``freq_diff`` and the writers are host code.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.branch_association_device import _leafmats
from ..core.topology import MutationRecord
from ..core.trees import AncesTree, Tree
from ..utils.devmem import batch_rows, resolve_device
from ..utils.trace import note

# bytes a cell of a log_pvalue_batch chunk takes at its peak: about a dozen
# float64 and int64 (rows, terms) temporaries
PVALUE_CELL_BYTES = 128


def lineages_at(tree: Tree, coords: np.ndarray,
                times: np.ndarray) -> np.ndarray:
    """Number of branches crossing each time (0 above the root age)."""
    N = tree.N
    internal = coords[N:]
    counts = 1 + (internal[None, :] > times[:, None]).sum(axis=1)
    counts = np.where(times > coords[tree.root], 0, counts)
    return counts


def carriers_at(tree: Tree, coords: np.ndarray, leafmat: np.ndarray,
                branch: int, times: np.ndarray) -> np.ndarray:
    """Number of carrier lineages crossing each time: branches in the
    mutation branch's subtree (incl. itself) whose span covers t; 0 at/above
    the parent of the mutation branch."""
    # subtree membership: node u is in subtree(b) iff clade(u) subset clade(b)
    sub = (leafmat & ~leafmat[branch]).sum(axis=1) == 0   # (M,)
    par = tree.parent
    par_coord = np.where(par >= 0, coords[np.maximum(par, 0)], np.inf)
    crossing = (coords[None, :] <= times[:, None]) \
        & (times[:, None] < par_coord[None, :])
    counts = (crossing & sub[None, :]).sum(axis=1)
    ptop = coords[tree.parent[branch]] if tree.parent[branch] >= 0 else np.inf
    counts = np.where(times >= ptop, 0, counts)
    return counts


def _leaf_matrices(anc: AncesTree, tree_ids: List[int], device):
    """(t, L) for each tree t of ``tree_ids`` in order: L the tree's (M, N)
    float32 leaf indicators on ``device``, built in batches of trees."""
    N = anc.N
    M = 2 * N - 1
    batch = batch_rows(M * N * 4, len(tree_ids), device, share=0.25)
    for s in range(0, len(tree_ids), batch):
        ids = tree_ids[s: s + batch]
        parent = torch.from_numpy(np.stack(
            [anc.seq[t].tree.parent for t in ids]).astype(np.int64)).to(device)
        L = _leafmats(parent, N)
        for k, t in enumerate(ids):
            yield t, L[k]


def _usable_by_tree(anc: AncesTree, muts: List[MutationRecord]):
    """{tree: (snps, branches)} of the SNPs on one branch, not flipped,
    below the root (the SNPs the scan keeps), trees in order."""
    by_tree = {}
    for snp, m in enumerate(muts):
        if len(m.branch) != 1 or m.flipped:
            continue
        b = m.branch[0]
        if 0 <= b < anc.seq[m.tree].tree.root:
            by_tree.setdefault(m.tree, ([], []))
            by_tree[m.tree][0].append(snp)
            by_tree[m.tree][1].append(b)
    return dict(sorted(by_tree.items()))


def _freq_lin_tree(L, c, par, bs, times, N):
    """One tree's counts on the device for the SNPs on branches ``bs``:
    (freq (S, E), lin (E,), daf (S,), lin_when_half (S,), lin_when_freq2
    (S,)), int64. L (M, N) float32 leaf indicators, c (M,) float64 node
    times, par (M,) int64 parents, times (E,) float64 oldest first."""
    M = L.shape[0]
    dev = L.device
    inf = torch.tensor(math.inf, dtype=torch.float64, device=dev)
    root_t = c[M - 1]
    internal = c[N:]
    lin = 1 + (internal[None, :] > times[:, None]).sum(dim=1)
    lin = torch.where(times > root_t, torch.zeros_like(lin), lin)
    # node u lies in subtree(b) iff clade(u) is a subset of clade(b)
    sub = (L @ (1.0 - L[bs]).T) == 0                         # (M, S)
    par_c = torch.where(par >= 0, c[par.clamp(min=0)], inf)
    crossing = (c[None, :] <= times[:, None]) \
        & (times[:, None] < par_c[None, :])                  # (E, M)
    frq = crossing.to(torch.float32) @ sub.to(torch.float32)  # (E, S)
    ptop = par_c[bs]
    frq = torch.where(times[:, None] >= ptop[None, :], torch.zeros_like(frq),
                      frq).to(torch.int64)
    daf = L[bs].sum(dim=1).to(torch.int64)
    # anchor ages: subtree internal-node coalescence times, descending
    sub_int = sub[N:]                                        # (M-N, S)
    ages_desc = torch.sort(torch.where(sub_int, internal[:, None], -inf),
                           dim=0, descending=True).values
    n_sub = sub_int.sum(dim=0)
    int_sorted = torch.sort(internal).values
    S = len(bs)
    cols = torch.arange(S, device=dev)

    def lin_at(tq):
        # lineages crossing time tq-eps: 1 + #internal ages > tq-eps
        q = tq - 1e-9
        cnt = 1 + (M - N) - torch.searchsorted(int_sorted, q, right=True)
        return torch.where(q > root_t, torch.zeros_like(cnt), cnt)

    def anchor_lin(target):
        # target <= 1 -> parent age of b; else the (target-1)-th subtree
        # coalescence age (descending)
        use_par = target <= 1
        k = (target - 2).clamp(min=0, max=ages_desc.shape[0] - 1)
        has_k = (target - 2) < n_sub
        tq = torch.where(use_par, ptop, ages_desc[k, cols])
        valid = (use_par & torch.isfinite(ptop)) | (~use_par & has_k)
        return torch.where(valid, lin_at(tq), torch.full_like(target, -1))

    daf_half = (daf + 1) // 2
    lw_half = torch.where(daf_half > 1, anchor_lin(daf_half),
                          torch.full_like(daf, -1))
    lw_2 = anchor_lin(torch.full_like(daf, 2))
    return frq.T, lin, daf, lw_half, lw_2


def freq_lin_arrays(anc: AncesTree, muts: List[MutationRecord],
                    epochs: np.ndarray, device=None) -> dict:
    """The counts of ``compute_freq_lin`` as arrays, one row a usable SNP in
    SNP order: ``snp`` (S,), ``freq`` and ``lin`` (S, E) oldest first,
    ``daf``, ``lin_when_half``, ``lin_when_freq2`` (S,), all int64."""
    device = resolve_device(device)
    E = len(epochs)
    N = anc.N
    times = torch.from_numpy(
        np.ascontiguousarray(np.asarray(epochs, np.float64)[::-1])).to(device)
    by_tree = _usable_by_tree(anc, muts)
    M = 2 * N - 1
    # the (M, S) membership and (M-N, S) sorted ages of a chunk of columns
    cols = batch_rows(M * 48, 1 << 62, device, share=0.25)
    parts, snps = [], []
    for t, L in _leaf_matrices(anc, list(by_tree), device):
        tree = anc.seq[t].tree
        c = torch.from_numpy(tree.coordinates(anc.sample_ages)).to(device)
        par = torch.from_numpy(tree.parent.astype(np.int64)).to(device)
        s_t, b_t = by_tree[t]
        for s in range(0, len(b_t), cols):
            bs = torch.as_tensor(b_t[s: s + cols], dtype=torch.int64,
                                 device=device)
            frq, lin, daf, lwh, lw2 = _freq_lin_tree(L, c, par, bs, times, N)
            parts.append(torch.cat([frq, lin.expand(len(bs), E),
                                    torch.stack([daf, lwh, lw2], 1)], 1))
            snps.extend(s_t[s: s + cols])
    snp = np.asarray(snps, dtype=np.int64)
    if parts:
        a = torch.cat(parts).cpu().numpy()
    else:
        a = np.zeros((0, 2 * E + 3), dtype=np.int64)
    order = np.argsort(snp, kind="stable")
    snp, a = snp[order], a[order]
    return {"snp": snp, "freq": a[:, :E], "lin": a[:, E: 2 * E],
            "daf": a[:, 2 * E], "lin_when_half": a[:, 2 * E + 1],
            "lin_when_freq2": a[:, 2 * E + 2]}


def _rows(a: dict, n: int, bp=None, rsid=None) -> list:
    """The JAX module's rows (dicts, None for skipped SNPs) from
    ``freq_lin_arrays``."""
    rows: list = [None] * n
    for j, snp in enumerate(a["snp"].tolist()):
        rows[snp] = {
            "snp": snp,
            "pos": int(bp[snp]) if bp is not None else snp,
            "rsid": rsid[snp] if rsid is not None else ".",
            "freq": a["freq"][j], "lin": a["lin"][j],
            "daf": int(a["daf"][j]),
            "lin_when_half": int(a["lin_when_half"][j]),
            "lin_when_freq2": int(a["lin_when_freq2"][j]),
        }
    return rows


def compute_freq_lin(anc: AncesTree, muts: List[MutationRecord],
                     epochs: np.ndarray, bp=None, rsid=None, device=None):
    """Per-SNP carrier/lineage counts at epoch boundaries (oldest-first,
    like the reference's .freq/.lin) plus the DAF-half and freq-2 lineage
    anchors. Returns a list of dict rows (None for skipped SNPs:
    non-mapping, flipped, or at the root), the JAX module's rows. On
    ``device`` (None: the CUDA card)."""
    return _rows(freq_lin_arrays(anc, muts, epochs, device), len(muts), bp,
                 rsid)


def log_pvalue(k: int, fk: float, N: int, fN: float,
               logF: np.ndarray) -> float:
    """log10 P(frequency >= fN | N, k, fk) (RelateSelection.cpp:141-178),
    on the host."""
    return float(log_pvalue_batch(np.asarray([k]), np.asarray([fk]), N,
                                  np.asarray([fN]), logF, device="cpu")[0])


def log_pvalue_batch(k: np.ndarray, fk: np.ndarray, N: int, fN: np.ndarray,
                     logF: np.ndarray, max_cells: Optional[int] = None,
                     device=None) -> np.ndarray:
    """Vectorized :func:`log_pvalue` over arrays of (k, fk, fN), on
    ``device`` (None: the CUDA card) in float64.

    The reference's per-call O(N) tail recursion
    (RelateSelection.cpp:141-178: ``px += log(...)``, ``logp =
    logaddexp(logp, px)``) is a logsumexp over ``px(x) = px(x0) +
    cumsum(log terms)``, in the JAX module's term order: ``px0``, then
    ``px0 + cumsum(term)``, then the max-subtracted logsumexp, then
    ``min(., 0) / ln 10``. Rows are taken longest first in chunks of at
    most ``max_cells`` cells (None: sized from the card's free memory),
    each as wide as its longest row. Returns host float64; 1 where the
    tail is undefined. Adds one dict (rows, chunks, cells, wall_s) under
    ``log_pvalue`` to the record of the ``utils.trace`` stage it runs in."""
    device = resolve_device(device)
    t0 = time.time()
    k = np.asarray(k, dtype=np.int64)
    fk = np.asarray(fk, dtype=np.int64)
    fN = np.asarray(fN, dtype=np.int64)
    out = np.ones(len(k), dtype=np.float64)
    valid = (fk >= 2) & (k != -1) & (fN < N) & (fk < k) & (fN > 0)
    if not valid.any():
        return out
    # recursion terms (none where k > N)
    L_h = np.maximum((N - k[valid]) - (fN[valid] - fk[valid]), 0)
    order_h = np.argsort(-L_h, kind="stable")
    if max_cells is None:
        max_cells = batch_rows(PVALUE_CELL_BYTES, 1 << 62, device)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    kv, fkv, fNv = up(k[valid]), up(fk[valid]), up(fN[valid])
    lf = up(np.asarray(logF, dtype=np.float64))
    n_lf = len(logF)

    def at(i):
        if isinstance(i, int):
            return lf[min(max(i, 0), n_lf - 1)]
        return lf[i.clamp(0, n_lf - 1)]

    px0 = (at(N - fNv - 1) - at(kv - fkv - 1) - at(N - kv + fkv - fNv)
           + at(fNv - 1) - at(fkv - 1) - at(fNv - fkv)
           - (at(N - 1) - at(kv - 1) - at(N - kv)))
    x0 = fNv - fkv
    y = N - kv
    c = N - 1
    L = y - x0
    res = torch.empty_like(px0)
    neg_inf = torch.tensor(-math.inf, dtype=torch.float64, device=device)
    order = up(order_h)
    s, chunks, cells = 0, 0, 0
    while s < len(order_h):
        mL = int(L_h[order_h[s]])                      # the chunk's longest
        e = min(len(order_h), s + max(1, max_cells // (mL + 1)))
        idx = order[s:e]
        chunks += 1
        cells += (e - s) * (mL + 1)
        s = e
        p0 = px0[idx]
        if mL == 0:
            res[idx] = p0
            continue
        j = torch.arange(mL, dtype=torch.int64, device=device)[None, :]
        xs = x0[idx][:, None] + j                     # term evaluated at x
        in_range = j < L[idx][:, None]
        var = fkv[idx][:, None] + xs
        num = ((y[idx][:, None] - xs) * var).to(torch.float64)
        den = (xs.to(torch.float64) + 1.0) * (c - var).to(torch.float64)
        term = torch.where(in_range & (num > 0) & (den > 0),
                           torch.log(num.clamp(min=1e-300))
                           - torch.log(den.clamp(min=1e-300)), neg_inf)
        del xs, var, num, den
        px = torch.where(in_range, p0[:, None] + torch.cumsum(term, dim=1),
                         neg_inf)
        del term, in_range
        allpx = torch.cat([p0[:, None], px], dim=1)
        del px
        mx = allpx.max(dim=1, keepdim=True).values
        res[idx] = mx[:, 0] + torch.log(torch.exp(allpx - mx).sum(dim=1))
        del allpx
    ln10 = torch.tensor(math.log(10), dtype=torch.float64, device=device)
    out[valid] = (res.clamp(max=0.0) / ln10).cpu().numpy()
    note("log_pvalue", dict(rows=int(valid.sum()), chunks=chunks,
                            cells=cells, wall_s=round(time.time() - t0, 4)))
    return out


def selection_tails(a: dict):
    """The (k, fk, fN) of every tail the scan evaluates, from
    ``freq_lin_arrays``' arrays: for each SNP with DAF > 2 (``live``, in
    SNP order) its E epochs, then the DAF-half and the freq-2 anchors.
    Returns (k, fk, fN, live), the first three flat (int64)."""
    live = a["daf"] > 2
    n = int(live.sum())
    E = a["freq"].shape[1]
    daf = a["daf"][live]
    k = np.concatenate([a["lin"][live], a["lin_when_half"][live, None],
                        a["lin_when_freq2"][live, None]], axis=1)
    fk = np.concatenate([a["freq"][live], ((daf + 1) // 2)[:, None],
                         np.full((n, 1), 2, dtype=np.int64)], axis=1)
    return k.ravel(), fk.ravel(), np.repeat(daf, E + 2), live


def selection_scan(anc: AncesTree, muts: List[MutationRecord],
                   epochs: np.ndarray, bp=None, rsid=None, device=None):
    """Frequency + Selection in one pass. Returns (rows, pvalue table):
    for each usable SNP, per-epoch log10 p-values (oldest-first) and the
    DAF-half / freq-2 p-values. One ``log_pvalue_batch`` call over every
    (SNP, epoch) pair and the two anchors of the SNPs with DAF > 2, whose
    p-values leave the card once."""
    device = resolve_device(device)
    N = anc.N
    logF = np.zeros(N + 1)
    logF[1:] = np.cumsum(np.log(np.arange(1, N + 1)))
    a = freq_lin_arrays(anc, muts, epochs, device)
    rows = _rows(a, len(muts), bp, rsid)
    E = len(epochs)
    k, fk, fN, live = selection_tails(a)
    flat = log_pvalue_batch(k, fk, N, fN, logF, device=device).reshape(
        -1, E + 2)
    pv_map = {snp: flat[i] for i, snp in enumerate(a["snp"][live].tolist())}
    out = []
    for row in rows:
        if row is None:
            out.append(None)
            continue
        if row["daf"] <= 2:
            pv = np.ones(E)
            p_half = p_2 = 1.0
        else:
            p = pv_map[row["snp"]]
            pv, p_half, p_2 = p[:E], p[E], p[E + 1]
        out.append({"snp": row["snp"], "pos": row["pos"],
                    "rsid": row["rsid"], "pvalues": pv,
                    "p_half": p_half, "p_freq2": p_2})
    return rows, out


def write_freq_lin(path_prefix: str, rows, epochs: np.ndarray):
    times = epochs[::-1]
    hdr = "pos rs_id " + " ".join(f"{t:f}" for t in times)
    with open(path_prefix + ".freq", "w") as ff, \
            open(path_prefix + ".lin", "w") as fl:
        ff.write(hdr + " TreeFreq DataFreq\n")
        fl.write(hdr + " when_DAF_is_half when_mutation_has_freq2\n")
        for row in rows:
            if row is None:
                continue
            ff.write(f"{row['pos']} {row['rsid']} "
                     + " ".join(str(int(x)) for x in row["freq"])
                     + f" {row['daf']} {row['daf']}\n")
            fl.write(f"{row['pos']} {row['rsid']} "
                     + " ".join(str(int(x)) for x in row["lin"])
                     + f" {row['lin_when_half']} {row['lin_when_freq2']}\n")


def write_sele(path: str, scan, epochs: np.ndarray):
    times = epochs[::-1]
    with open(path, "w") as f:
        f.write("pos rs_id " + " ".join(f"{t:f}" for t in times)
                + " when_DAF_is_half when_mutation_has_freq2\n")
        for row in scan:
            if row is None:
                continue
            f.write(f"{row['pos']} {row['rsid']} "
                    + " ".join(f"{p:.4g}" for p in row["pvalues"])
                    + f" {row['p_half']:.4g} {row['p_freq2']:.4g}\n")


def quality(anc: AncesTree, muts: List[MutationRecord]):
    """Per-tree mapping-quality metrics (RelateSelection Quality mode):
    SNPs on tree, fraction of branches carrying >= 1 mutation, fraction of
    non-mapping SNPs."""
    T = len(anc.seq)
    num_snps = np.zeros(T)
    num_notmapping = np.zeros(T)
    for m in muts:
        num_snps[m.tree] += 1
        if len(m.branch) > 1:
            num_notmapping[m.tree] += 1
    frac_branches = np.zeros(T)
    for t, mt in enumerate(anc.seq):
        ne = mt.tree.num_events
        frac_branches[t] = (ne[:-1] > 0).mean()
    with np.errstate(invalid="ignore", divide="ignore"):
        frac_nm = np.where(num_snps > 0, num_notmapping / num_snps, 0.0)
    return {"num_snps_on_tree": num_snps,
            "frac_branches_with_mut": frac_branches,
            "frac_not_mapping": frac_nm}


def write_quality(path: str, q: dict):
    """The ``.qual`` file of ``quality``'s metrics, a row a tree."""
    with open(path, "w") as f:
        f.write("tree num_snps frac_branches_with_mut frac_not_mapping\n")
        for t in range(len(q["num_snps_on_tree"])):
            f.write(f"{t} {q['num_snps_on_tree'][t]:g} "
                    f"{q['frac_branches_with_mut'][t]:g} "
                    f"{q['frac_not_mapping'][t]:g}\n")


def sds(anc: AncesTree, muts: List[MutationRecord], bp=None, rsid=None,
        device=None):
    """SDS-like statistic (RelateSelection.cpp:816-1090): per usable SNP,
    log((sum of ancestral tip branch lengths / sum of derived tip branch
    lengths) * DAF) / (N - DAF). On ``device`` (None: the CUDA card) each
    tree's derived sums are one float64 product of its SNPs' leaf rows and
    the tip branch lengths, the ancestral sums one of the complement
    rows."""
    device = resolve_device(device)
    N = anc.N
    by_tree = _usable_by_tree(anc, muts)
    parts, snps = [], []
    for t, L in _leaf_matrices(anc, list(by_tree), device):
        s_t, b_t = by_tree[t]
        tip = torch.from_numpy(np.asarray(
            anc.seq[t].tree.branch_length[:N], np.float64)).to(device)
        rows = L[torch.as_tensor(b_t, device=device), :N].to(torch.float64)
        parts.append(torch.stack([rows.sum(dim=1), rows @ tip,
                                  (1.0 - rows) @ tip], 1))
        snps.extend(s_t)
    found = {}
    if parts:
        a = torch.cat(parts).cpu().numpy()
        found = {snp: a[j] for j, snp in enumerate(snps)}
    out = []
    for snp in range(len(muts)):
        if snp not in found:
            out.append(None)
            continue
        daf, d_sds, a_sds = found[snp]
        daf = int(daf)
        d_sds, a_sds = float(d_sds), float(a_sds)
        if daf == 0 or daf == N or d_sds <= 0:
            out.append(None)
            continue
        r = float(np.log((a_sds / d_sds) * daf) / (N - daf))
        out.append({"snp": snp,
                    "pos": int(bp[snp]) if bp is not None else snp,
                    "rsid": rsid[snp] if rsid is not None else ".",
                    "rSDS": r})
    return out


def write_sds(path: str, rows):
    with open(path, "w") as f:
        f.write("pos rs_id rSDS\n")
        for r in rows:
            if r is None:
                continue
            f.write(f"{r['pos']} {r['rsid']} {r['rSDS']:g}\n")


def freq_diff(rows, N: int):
    """FreqDiff (RelateSelection.cpp:1098-1330): per-epoch derived-fraction
    changes (newest-first), -10 where undefined, plus a z-scored version
    standardized within SNPs of the same present-day count.

    rows: output of compute_freq_lin. Returns (diffs, zdiffs) lists aligned
    with rows; each entry is (pos, rsid, diff array, fN)."""
    diffs = []
    E = None
    for row in rows:
        if row is None:
            diffs.append(None)
            continue
        # reverse to newest-first and drop the anchor columns
        f = row["freq"][::-1].astype(np.float64)
        k = row["lin"][::-1].astype(np.float64)
        E = len(f)
        d = np.full(E - 1, -10.0)
        ok = (f[1:] > 0) & (k[1:] > 0.1 * N)
        with np.errstate(divide="ignore", invalid="ignore"):
            val = f[1:] / np.maximum(k[1:], 1e-30) \
                - f[:-1] / np.maximum(k[:-1], 1e-30)
        d[ok] = val[ok]
        diffs.append({"pos": row["pos"], "rsid": row["rsid"], "diff": d,
                      "fN": int(row["freq"][-1])})
    # per-fN mean/sd over valid entries
    stats = {}
    for r in diffs:
        if r is None:
            continue
        m = stats.setdefault(r["fN"], [np.zeros(E - 1), np.zeros(E - 1),
                                       np.zeros(E - 1)])
        ok = r["diff"] != -10
        m[0][ok] += r["diff"][ok]
        m[1][ok] += r["diff"][ok] ** 2
        m[2][ok] += 1
    zdiffs = []
    for r in diffs:
        if r is None or r["fN"] <= 1:
            zdiffs.append(None)
            continue
        s, s2, c = stats[r["fN"]]
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = np.where(c > 0, s / np.maximum(c, 1), 0.0)
            var = np.where(c > 1, (s2 - c * mean * mean)
                           / np.maximum(c - 1, 1), 0.0)
            sd = np.sqrt(np.maximum(var, 0.0))
            z = np.where((r["diff"] != -10) & (sd > 0),
                         (r["diff"] - mean) / np.where(sd > 0, sd, 1.0),
                         np.nan)
        zdiffs.append({"pos": r["pos"], "rsid": r["rsid"], "z": z,
                       "fN": r["fN"]})
    return diffs, zdiffs


def write_freqdiff(prefix: str, diffs, zdiffs, epochs=None):
    """Write .freqdiff/.zfreqdiff in the reference's layout
    (RelateSelection.cpp FreqDiff): header row of epoch boundaries in
    generations OLDEST-first (float32-printed), one row per usable SNP
    with the per-epoch diffs oldest-first, then the present-day derived
    count (TreeFreq)."""
    header = None
    if epochs is not None:
        header = ("pos rs_id "
                  + " ".join(f"{x:f}" for x in
                             np.asarray(epochs, np.float32)[::-1])
                  + " TreeFreq\n")
    with open(prefix + ".freqdiff", "w") as f:
        if header:
            f.write(header)
        for r in diffs:
            if r is None:
                continue
            f.write(f"{r['pos']} {r['rsid']} "
                    + " ".join(f"{x:g}" for x in r["diff"][::-1])
                    + f" {r['fN']}\n")
    with open(prefix + ".zfreqdiff", "w") as f:
        if header:
            f.write(header)
        for r in zdiffs:
            if r is None:
                continue
            f.write(f"{r['pos']} {r['rsid']} "
                    + " ".join("NA" if np.isnan(x) else f"{x:g}"
                               for x in r["z"][::-1]) + f" {r['fN']}\n")

"""The plain reference that decides ``correct``: NumPy and PyTorch only.

It imports nothing of the program and takes nothing the program made but
the outputs it judges (the final ``.anc``/``.mut`` of a job). From the
panel the harness generated it works out again:

- ``recombination``: positions in Morgans and the painting's
  recombination distances of Relate's flat map (``data.cpp:442-481``);
- ``Painting``: the Li & Stephens forward and backward chains of every
  target over the whole region in one pass each (``fast_painting.cpp``),
  rescaled as Relate rescales (only outside [1e-10, 1e10]), with its two
  quirks kept (the backward step into step j uses the interval of step
  j + 1; a posterior row where the backward rescales keeps the beta before
  the rescale and the logscale after it), and the posterior rows that a
  tree built at SNP q reads: the last step at or before q and the first
  after it, of every target;
- ``distance_matrix``: Relate's ``GetMatrix`` (``anc_builder.cpp:108-207``)
  from those rows, with its ``fast_log`` (``fast_log.hpp``);
- ``merge_regret``: the merges of a tree of the output replayed on that
  matrix and the clade prior of the tree before it
  (``tree_builder.cpp``: row minima plus a threshold, mutual candidates,
  a score of 0 for pairs mutual in the prior, the symmetric fallback,
  size-weighted merges). At each step it reads by how much the program's
  pair falls short of the reference's best (0 where it is the best or
  tied with it), as a served model's check reads the gap of a served
  token below the reference's best logit;
- ``map_check``: every SNP of the output against its tree
  (``MapMutation``, ``ForceMapMutation``, ``mutations.cpp`` ages) and the
  tree's structure; and the SNPs kept on a tree on which Relate's rule
  would have tried a rebuild (``anc_builder.cpp``: a SNP that maps flipped
  or not at all), each a candidate tree that must have been reverted;
- ``clock``: the mutations that the output's branch lengths predict,
  mu times each tree's span in bp times its total length, against the SNPs
  the region holds (the chains' Poisson clock, ``mcmc.cpp``).

Everything the reference decides by a float comparison that the program
makes in float32 on values the reference also computes exactly (the clade
prior, carrier ratios) it makes in float32 the same way; the painting and
the distances it computes in float64 (``dtype``), or in a lower precision
for the control.
"""
from __future__ import annotations

import numpy as np
import torch

LOWER, UPPER = 1e-10, 1e10
P_CAP = 0.99
R_SCALE, R_LOWER = 2500.0, 1e-10
MAP_SHARE = 0.03          # a SNP maps onto a branch with at most 3 % of N off


# ---------------------------------------------------------------------------
# recombination
# ---------------------------------------------------------------------------

def recombination(bp: np.ndarray, cm_per_mb: float):
    """(rpos (L+1,) Morgans with rpos[L] at bp[L-1] + 1, r (L,))."""
    bpe = np.concatenate([bp, [bp[-1] + 1]]).astype(np.float64)
    rpos = bpe * (cm_per_mb * 1e-8)
    r = np.maximum(np.diff(rpos), R_LOWER) * R_SCALE
    return rpos, r


def fast_log(val: torch.Tensor) -> torch.Tensor:
    """Relate's float32 log approximation, evaluated in float32."""
    val = val.to(torch.float32).contiguous()
    x = val.view(torch.int32)
    log_2 = ((x >> 23) & 255) - 128
    x = (x & ~(255 << 23)) + (127 << 23)
    m = x.view(torch.float32)
    m = (m * (-1.0 / 3) + 2) * m - (2.0 / 3)
    return (m + log_2.to(torch.float32)) * 0.69314718


# ---------------------------------------------------------------------------
# painting
# ---------------------------------------------------------------------------

def window_bounds(G: np.ndarray, memory_gb: float):
    """Relate's windows of one chunk (``Data::MakeChunks``): derived cells
    times N + 1 accumulate until the budget, memory_gb * 1e9 / 4 less two
    N x N matrices and 3N, is reached with more than 10 SNPs in the
    window; the SNP there starts the next window."""
    L, N = G.shape
    budget = memory_gb * 1e9 / 4.0 - (2 * N * N + 3 * N)
    if L + 1 > budget / N:
        raise ValueError("the region would be more than one chunk")
    derived = G.sum(axis=1).astype(np.int64)
    bounds = [0]
    mem, n = 0.0, 0
    for snp in range(L):
        mem += float(derived[snp]) * (N + 1)
        if mem >= budget and n > 10:
            n, mem = 0, 0.0
            bounds.append(snp)
        n += 1
    bounds.append(L)
    return bounds


def window_sites(G: np.ndarray, bounds):
    """(bsb, bse) (W, N): each target's first and last step of each
    window's repaint (``window_boundary_sites``): the last step before the
    window (site 0 for the first) and the first step at or after its end
    (the region's last SNP for the last window)."""
    L, N = G.shape
    W = len(bounds) - 1
    ends = np.asarray(bounds[1:], dtype=np.int64)
    bsb = np.zeros((W, N), dtype=np.int64)
    bse = np.zeros((W, N), dtype=np.int64)
    for k in range(N):
        sites = np.unique(np.concatenate([[0], np.nonzero(G[:, k])[0],
                                          [L - 1]]))
        j = np.searchsorted(sites, ends, side="left")
        before = sites[np.maximum(j - 1, 0)]
        bse[:, k] = sites[np.minimum(j, len(sites) - 1)]
        bsb[1:, k] = before[:-1]
    bse[W - 1] = L - 1
    return bsb, bse


class Painting:
    """Forward and backward chains of all N targets over a region of L SNPs
    (one chunk, the region's first and last SNP its ends), in ``dtype``,
    as Relate runs them: stepping stones over the whole region, then each
    window repainted from its checkpoints (``RePaintSection``). The
    forward of a window continues the stepping stones' exactly. Its
    backward starts at each target's first step at or after the window's
    end (``bse``) from the stepping stones' beta there, does not rescale
    that row, and steps into the row before with that row's own interval
    (r at ``bse``) where the whole pass has the interval to the next step
    (``fast_painting.cpp:711-712``). ``posterior(q)`` gives what GetMatrix
    reads at SNP q."""

    def __init__(self, G: np.ndarray, r: np.ndarray, theta: float,
                 qs, bounds, dtype=torch.float64, device=None):
        self.G = np.ascontiguousarray(G, dtype=np.uint8)
        self.L, self.N = G.shape
        self.r = np.asarray(r, np.float64)
        self.S = np.concatenate([[0.0], np.cumsum(self.r)])
        self.theta = theta
        self.th = theta
        self.nth = 1.0 - theta
        self.tr = theta / (1.0 - theta) - 1.0
        self.dt = dtype
        self.dev = torch.device(device) if device is not None else \
            torch.device("cuda")
        self.Gd = torch.from_numpy(self.G).to(self.dev)
        self.qs = sorted(set(int(q) for q in qs))
        if any(q < 0 or q >= self.L - 1 for q in self.qs):
            raise ValueError("a build SNP must lie before the region's last")
        self.bsb, self.bse = window_sites(self.G, bounds)
        self.win = {q: int(np.searchsorted(bounds, q, side="right") - 1)
                    for q in self.qs}
        self.carriers = [np.nonzero(self.G[l])[0] for l in range(self.L)]
        self.fwd = {}
        self.bwd = {}
        self._forward()
        wins = sorted(set(self.win.values()))
        ckpt = self._backward(None, {w: None for w in wins})
        for w in wins:
            self._backward(w, ckpt[w])

    # interval quantities of Relate's planner, float64 on the host
    def _interval(self, raw):
        p = 1.0 - np.exp(-raw)
        capped = p > P_CAP
        p = np.where(capped, P_CAP, p)
        log_nth = np.log(1.0 - self.theta)
        nxt = np.where(capped, np.log(0.01) + log_nth, -raw + log_nth)
        pfac = p / ((1.0 - p) * (self.N - 1.0))
        return pfac, nxt

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.array(a, copy=True),
                               dtype=dtype or self.dt, device=self.dev)

    def _mism(self, sites, targets):
        """(B, N) 1 where each target carries the derived allele at its site
        (one site for all, or one a target) and the source does not."""
        targets = np.asarray(targets)
        if np.ndim(sites) == 0:
            g = self.Gd[int(sites)].to(self.dt)
            seqk = self.G[int(sites), targets]
            if seqk.all():          # a SNP's carriers: one row for all
                return (1.0 - g)[None, :].expand(len(targets), -1)
            return self._t(seqk)[:, None] * (1.0 - g)[None, :]
        g = self.Gd[self._t(sites, torch.int64)].to(self.dt)
        seqk = self._t(self.G[sites, targets])
        return seqk[:, None] * (1.0 - g)

    def _kmask(self, targets):
        km = torch.ones((len(targets), self.N), dtype=self.dt,
                        device=self.dev)
        return self._own(km, self._t(targets, torch.int64))

    def _own(self, x, Td):
        """``x`` (B, N) with each target's own column set to 0."""
        x[torch.arange(len(Td), device=self.dev), Td] = 0.0
        return x

    def _steppers(self, l):
        if l == 0 or l == self.L - 1:
            return np.arange(self.N)
        return self.carriers[l]

    def _rescaled(self, x, s):
        """Relate's rescale of rows whose sum ``s`` left [1e-10, 1e10]:
        (rows, the rows' sums after it, the log corrections)."""
        cond = (s < LOWER) | (s > UPPER)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        x = torch.where(cond[:, None], x / safe[:, None], x)
        corr = torch.where(cond, torch.log(safe.double()),
                           torch.zeros_like(safe, dtype=torch.float64))
        return x, torch.where(cond, torch.ones_like(s), s), corr

    def _fwd_step(self, alpha, asum, sites, prev, targets, Td):
        """One forward step of ``targets`` from their step at ``prev`` into
        their step at ``sites``: (alpha, asum_eff, logscale increment)."""
        pfac, nxt = self._interval(self.S[sites] - self.S[prev])
        em = 1.0 + self.tr * self._mism(sites, targets)
        a = self._own((alpha + (asum * self._t(pfac))[:, None]) * em, Td)
        a, s, corr = self._rescaled(a, a.sum(dim=1))
        return a, s, self._t(nxt, torch.float64) + corr

    def _forward(self):
        th = self.theta
        N = self.N
        allk = np.arange(N)
        # alpha at site 0: prior times emission, own column 0
        mism0 = self._mism(0, allk)
        alpha = (mism0 * (th / (N - 1.0) - (1.0 - th) / (N - 1.0))
                 + (1.0 - th) / (N - 1.0)) * self._kmask(allk)
        ls = torch.zeros(N, dtype=torch.float64, device=self.dev)
        asum = alpha.sum(dim=1)
        prev = np.zeros(N, dtype=np.int64)
        if 0 in self.qs:
            self.fwd[0] = (alpha.clone(), ls.clone(), asum.clone(),
                           prev.copy())
        for l in range(1, self.L):
            T = self._steppers(l)
            if len(T):
                Td = self._t(T, torch.int64)
                a, s, inc = self._fwd_step(alpha[Td], asum[Td], l, prev[T], T,
                                           Td)
                ls[Td] += inc
                alpha[Td] = a
                asum[Td] = s
                prev[T] = l
            if l in self.qs:
                self.fwd[l] = (alpha.clone(), ls.clone(), asum.clone(),
                               prev.copy())

    def _back_step(self, T, Td, beta_next, bsum_next, site_next, raw_next,
                   sites):
        """One backward step of targets T from their step at ``site_next``
        into their step at ``sites``, with the interval ``raw_next`` of the
        step at ``site_next`` (the quirk). Returns (beta, bsum_eff, beta
        before the rescale, logscale increment)."""
        pfac, inc = self._interval(raw_next)
        dnext = self._mism(site_next, T)
        rx = bsum_next * self._t(pfac)
        b1 = rx / self.nth
        bt = rx / self.th - b1
        step = self._own((beta_next + dnext * bt[:, None] + b1[:, None])
                         * (1.0 + self.tr * dnext), Td)
        w = torch.where(self._mism(sites, T) > 0, self.th,
                        self.nth).to(self.dt)
        fin, s, corr = self._rescaled(step, (w * step).sum(dim=1))
        return fin, s, step, self._t(inc, torch.float64) + corr

    def _backward(self, w, ckpt):
        """The whole region's backward (``w`` None), which returns the beta
        at each target's ``bse`` of the windows in ``ckpt``; or window w's
        repaint from ``ckpt``, which keeps the states after SNP q + 1 of
        its build SNPs."""
        N, L = self.N, self.L
        want = {q + 1 for q in self.qs if self.win[q] == w}
        beta = torch.zeros((N, N), dtype=self.dt, device=self.dev)
        pre = torch.zeros_like(beta)
        pls = torch.zeros(N, dtype=torch.float64, device=self.dev)
        bsum = torch.zeros(N, dtype=self.dt, device=self.dev)
        nxt_site = np.full(N, L - 1, dtype=np.int64)
        raw_next = np.zeros(N)
        if w is None:
            start = np.full(N, L - 1, dtype=np.int64)
            init = {L - 1: np.arange(N)}
            out = {v: torch.zeros_like(beta) for v in ckpt}
        else:
            start = self.bse[w]
            init = {}
            for k in range(N):
                init.setdefault(int(start[k]), []).append(k)
            init = {l: np.asarray(ks) for l, ks in init.items()}
        stop = 0 if w is None else min(want)
        for l in range(int(start.max()), stop - 1, -1):
            I = init.get(l)
            if I is not None:
                Id = self._t(I, torch.int64)
                b0 = self._kmask(I) if w is None else ckpt[Id]
                wts = torch.where(self._mism(l, I) > 0, self.th,
                                  self.nth).to(self.dt)
                beta[Id] = b0
                pre[Id] = b0
                pls[Id] = 0.0
                bsum[Id] = (wts * b0).sum(dim=1)
                nxt_site[I] = l
                raw_next[I] = self.r[l]
            T = self._steppers(l)
            T = T[start[T] > l]
            if len(T):
                Td = self._t(T, torch.int64)
                fin, s, step, inc = self._back_step(
                    T, Td, beta[Td], bsum[Td], nxt_site[T], raw_next[T], l)
                beta[Td] = fin
                pre[Td] = step
                pls[Td] += inc
                bsum[Td] = s
                raw_next[T] = self.S[nxt_site[T]] - self.S[l]
                nxt_site[T] = l
            if w is None:
                for v in ckpt:
                    hit = np.nonzero(self.bse[v] == l)[0]
                    if len(hit):
                        hd = self._t(hit, torch.int64)
                        out[v][hd] = beta[hd]
            elif l in want:
                self.bwd[l] = (beta.clone(), pre.clone(), pls.clone(),
                               bsum.clone(), nxt_site.copy(), raw_next.copy())
        return out if w is None else None

    def posterior(self, q: int):
        """(topo_prev, ls_prev, topo_next, ls_next, site_prev, site_next):
        every target's posterior row (in Relate's scaled representation)
        and logscale (relative to its window) at its last step at or before
        q and at its first step after q."""
        allk = np.arange(self.N)
        alld = self._t(allk, torch.int64)
        alpha, ls_a, asum, prev = self.fwd[q]
        beta_n, pre_n, pls_n, bsum_n, nsite, raw_n = self.bwd[q + 1]
        # the previous step's beta: one backward step from the next
        _, _, pre_p, inc = self._back_step(allk, alld, beta_n, bsum_n, nsite,
                                           raw_n, prev)
        pls_p = pls_n + inc
        # the next step's alpha: one forward step from the previous
        a_n, _, inc_a = self._fwd_step(alpha, asum, nsite, prev, allk, alld)
        return (alpha * pre_p, ls_a + pls_p, a_n * pre_n, ls_a + inc_a + pls_n,
                prev, nsite)


def distance_matrix(paint: Painting, rpos: np.ndarray, q: int):
    """GetMatrix at SNP q, float64 (N, N): row-min normalised, diagonal 0."""
    N, L = paint.N, paint.L
    top_p, ls_p, top_n, ls_n, sp, sn = paint.posterior(q)
    dev = paint.dev
    f64 = torch.float64
    exact = paint.Gd[q].bool() | (q == 0 or q == L - 1)
    # rpos of the last true derived site <= q (site 0 if none) and of the
    # next derived site (the region's last SNP if none)
    last_der = np.where(paint.G[sp, np.arange(N)] == 1, sp, 0)
    rp_prev = torch.as_tensor(rpos[last_der], dtype=f64, device=dev)
    rp_next = torch.as_tensor(rpos[sn], dtype=f64, device=dev)
    rq = float(rpos[q])
    den = rp_next - rp_prev
    same = den == 0
    safe = torch.where(same, torch.ones_like(den), den)
    wl = torch.where(same, 0.5, (rp_next - rq) / safe)
    wr = torch.where(same, 0.5, (rq - rp_prev) / safe)
    tp, tn = top_p.to(f64), top_n.to(f64)
    exact_val = fast_log(tp).to(f64) + ls_p[:, None]
    use_next = ls_p <= ls_n
    e_pn = torch.exp(ls_p - ls_n)
    e_np = torch.exp(ls_n - ls_p)
    i_next = fast_log(wl[:, None] * tp * e_pn[:, None]
                      + wr[:, None] * tn).to(f64) + ls_n[:, None]
    i_prev = fast_log(wl[:, None] * tp
                      + wr[:, None] * tn * e_np[:, None]).to(f64) \
        + ls_p[:, None]
    val = torch.where(exact[:, None], exact_val,
                      torch.where(use_next[:, None], i_next, i_prev))
    mat = -val
    mat = mat - mat.min(dim=1).values[:, None]
    mat.fill_diagonal_(0.0)
    return mat.to(paint.dt)


# ---------------------------------------------------------------------------
# trees of the output
# ---------------------------------------------------------------------------

def read_anc(path: str):
    """(N, [(pos, parent (M,) int64, length (M,) float64)])."""
    with open(path) as f:
        N = int(f.readline().split()[1])
        T = int(f.readline().split()[1])
        trees = []
        for line in f:
            head, rest = line.split(":", 1)
            toks = rest.replace(":(", " ").replace(")", " ").split()
            a = np.asarray(toks, dtype=np.float64).reshape(-1, 5)
            trees.append((int(head), a[:, 0].astype(np.int64), a[:, 1]))
    if len(trees) != T:
        raise ValueError(f"{path}: NUM_TREES {T} but {len(trees)} trees")
    return N, trees


def read_mut(path: str):
    """Rows of a final .mut: (snp, bp, tree, [branches], not_mapping,
    flipped, age_begin, age_end)."""
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.split(";")
            br = [int(b) for b in p[5].split()]
            rows.append((int(p[0]), int(p[1]), int(p[4]), br, int(p[6]),
                         int(p[7]), float(p[8]), float(p[9])))
    return rows


def merges_of(parent: np.ndarray, N: int):
    """The merge list (row i < row j, by step) of a tree whose node N + t
    was born at step t: the matrix rows of the scan that made it."""
    M = 2 * N - 1
    kids = [[] for _ in range(M)]
    for v in range(M - 1):
        kids[parent[v]].append(v)
    rowof = np.arange(M)
    steps = []
    for t in range(N - 1):
        c = kids[N + t]
        if len(c) != 2:
            raise ValueError(f"node {N + t} has {len(c)} children")
        a, b = int(rowof[c[0]]), int(rowof[c[1]])
        i, j = min(a, b), max(a, b)
        steps.append((i, j))
        rowof[N + t] = j
    return steps


def clade_rows(parent: np.ndarray, N: int, device) -> torch.Tensor:
    """(M, N) float32 leaf indicators of every node (leaves first): each
    leaf walks up to the root on the host, one scatter on the device."""
    M = 2 * N - 1
    leaf = np.arange(N)
    nodes, leaves = [leaf], [leaf]
    anc = parent[:N].astype(np.int64)
    while True:
        live = anc >= 0
        if not live.any():
            break
        nodes.append(anc[live])
        leaves.append(leaf[live])
        anc = np.where(live, parent[np.maximum(anc, 0)], -1)
    C = torch.zeros((M, N), dtype=torch.float32, device=device)
    C[torch.as_tensor(np.concatenate(nodes), device=device),
      torch.as_tensor(np.concatenate(leaves), device=device)] = 1.0
    return C


def tree_shape(parent: np.ndarray, N: int):
    """(child_l, child_r) of a binary tree whose internal node N + t has two
    children of lower id and whose root is 2N - 2; None if it is not."""
    M = 2 * N - 1
    if len(parent) != M or parent[M - 1] != -1:
        return None
    p = parent[:M - 1]
    v = np.arange(M - 1)
    if (p < N).any() or (p >= M).any() or (p <= v).any():
        return None
    if (np.bincount(p - N, minlength=N - 1) != 2).any():
        return None
    order = np.argsort(p, kind="stable")
    kids = order.reshape(N - 1, 2)
    cl = np.full(M, -1, np.int64)
    cr = np.full(M, -1, np.int64)
    cl[N:], cr[N:] = kids[:, 0], kids[:, 1]
    return cl, cr


def node_ages(cl, cr, length, N: int):
    """Each node's age down its left-child chain (Relate's ``get_age``), and
    the widest gap between the ages its two children give it."""
    M = 2 * N - 1
    age = np.zeros(M)
    w = np.arange(M)
    while True:
        inner = w >= N
        if not inner.any():
            break
        c = np.where(inner, cl[np.maximum(w, 0)], w)
        age += np.where(inner, length[np.maximum(c, 0)], 0.0)
        w = c
    v = np.arange(N, M)
    gap = np.abs(age[cl[v]] + length[cl[v]] - age[cr[v]] - length[cr[v]])
    return age, gap


# ---------------------------------------------------------------------------
# the merge replay
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    return float(np.float32(x))


def merge_regret(d: torch.Tensor, steps, dcf: torch.Tensor, use_cf: bool,
                 theta: float, control: torch.Tensor | None = None):
    """Replays ``steps`` (the program's merges) on the reference matrix
    ``d`` (float64) and the clade prior ``dcf`` (float32, as Relate forms
    it). Returns (widest regret of the program's pairs, widest regret of
    the pairs that ``control`` (the same matrix in a lower precision,
    replayed along the same merges) would have picked first, or None).

    A pair's regret under the reference: the least of what it misses under
    the mutual-candidate rule (its shortfall from being mutual, plus its
    score above the best mutual score) and under the symmetric fallback
    (how far the reference's mutual pairs are from not being mutual, plus
    its symmetric sum above the least). 0 when the pair is a best choice
    of the reference."""
    base = -float(np.log(theta / (1.0 - theta)))
    thr, thr_cf = 0.2 * base, 0.001 * base
    N = d.shape[0]
    dev = d.device
    inf = float("inf")
    d = d.clone()
    dcf = dcf.to(torch.float32).clone()
    ctl = control.clone() if control is not None else None
    active = torch.ones(N, dtype=torch.bool, device=dev)
    offdiag = ~torch.eye(N, dtype=torch.bool, device=dev)
    ids = torch.arange(N, device=dev)
    flat_ids = ids[:, None] * N + ids[None, :]
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    worst_ctl = torch.zeros((), dtype=torch.float64, device=dev)
    sizes = [1.0] * N
    thr_cf32 = torch.tensor(_f32(thr_cf), dtype=torch.float32, device=dev)
    for i, j in steps:
        live = active[:, None] & active[None, :] & offdiag
        cfmut = None
        if use_cf:
            mvcf = torch.where(live, dcf, inf).amin(dim=1) + thr_cf32
            cfmut = live & (dcf <= mvcf[:, None]) & (dcf.t() <= mvcf[None, :])
        reg = _regrets(d, live, cfmut, thr)
        worst = torch.maximum(worst, reg[i, j])
        if ctl is not None:
            pick = _pick(ctl, live, cfmut, thr, flat_ids, N)
            worst_ctl = torch.maximum(worst_ctl, reg.view(-1)[pick])
        # Relate's weights: float32 sizes, merges as two products and a sum
        w = np.float32(sizes[i]) / np.float32(sizes[i] + sizes[j])
        w1 = np.float32(1.0) - w
        for mat, ww, ww1 in ((d, float(w), float(w1)),
                             (dcf, float(w), float(w1))) + \
                (((ctl, float(w), float(w1)),) if ctl is not None else ()):
            mat[j, :] = ww * mat[i, :] + ww1 * mat[j, :]
            mat[:, j] = ww * mat[:, i] + ww1 * mat[:, j]
        sizes[j] = sizes[i] + sizes[j]
        active[i] = False
    return (float(worst), float(worst_ctl) if ctl is not None else None)


def _regrets(d, live, cfmut, thr):
    """(N, N) float64 regret of every pair at this step (see
    ``merge_regret``)."""
    inf = float("inf")
    dm = torch.where(live, d, inf)
    mv = dm.amin(dim=1) + thr
    margin = torch.minimum(mv[:, None] - d, mv[None, :] - d.t())
    mutual = live & (margin >= 0)
    sym = d + d.t()
    score = torch.where(cfmut, torch.zeros_like(sym), sym) \
        if cfmut is not None else sym
    best_mut = torch.where(mutual, score, inf).amin()
    have = mutual.any()
    viol = torch.clamp(-margin, min=0.0)
    rule_a = viol + torch.where(have, torch.clamp(score - best_mut, min=0.0),
                                torch.zeros_like(score))
    near = torch.where(mutual, margin, torch.zeros_like(margin)).amax()
    best_sym = torch.where(live, sym, inf).amin()
    rule_b = near + (sym - best_sym)
    return torch.where(live, torch.minimum(rule_a, rule_b),
                       torch.full_like(d, inf))


def _pick(ctl, live, cfmut, thr, flat_ids, N):
    """The flat index of the pair that the selection rule picks first on
    ``ctl`` (ties: the smallest flat index)."""
    inf = float("inf")
    c = ctl
    dm = torch.where(live, c, torch.full_like(c, inf))
    mv = dm.amin(dim=1) + thr
    mutual = live & (c <= mv[:, None]) & (c.t() <= mv[None, :])
    sym = c + c.t()
    score = torch.where(cfmut, torch.zeros_like(sym), sym) \
        if cfmut is not None else sym
    eff_mut = torch.where(mutual, score, torch.full_like(score, inf))
    eff = torch.where(mutual.any(), eff_mut,
                      torch.where(live, sym, torch.full_like(sym, inf)))
    m = eff.amin()
    return torch.where(eff == m, flat_ids,
                       torch.full_like(flat_ids, N * N)).amin()


def clade_prior(prev_parent: np.ndarray, N: int, theta: float, device):
    """Relate's clade-consistency prior from the tree before: val times the
    number of the tree's internal clades that hold i but not j, float32."""
    val = -float(np.log(theta / (1.0 - theta)))
    member = clade_rows(prev_parent, N, device)[N:]
    return val * (member.t() @ (1.0 - member))


def carrier_penalty(d: torch.Tensor, car: np.ndarray, theta: float):
    """+ val from each carrier of the rebuild SNP to each non-carrier."""
    val = -float(np.log(theta / (1.0 - theta)))
    c = torch.as_tensor(car, dtype=d.dtype, device=d.device)
    return d + val * c[:, None] * (1.0 - c[None, :])


# ---------------------------------------------------------------------------
# the SNPs and the trees of the output
# ---------------------------------------------------------------------------

def _map_rule(C, csize, car, N, M):
    """MapMutation of K SNPs on one tree (float32, as Relate): the branch
    (-1: none), whether it maps (chosen mismatch within 3 % of N) and
    whether it maps flipped, for carrier rows ``car`` (K, N) float32."""
    dev = C.device
    tc = car.sum(dim=1)
    cc = C @ car.t()
    tnc = N - tc
    cs = csize[:, None]
    icn = cs - cc
    nc_ = tc[None, :] - cc
    cnc = tnc[None, :] - icn
    tc_s = torch.clamp(tc, min=1e-9)[None, :]
    tnc_s = torch.clamp(tnc, min=1e-9)[None, :]
    is_leaf = (torch.arange(M, device=dev) < N)[:, None]
    is_carrier = cc > 0.5
    den1, den2 = cc + icn, nc_ + cnc
    r_nc, r_icn = nc_ / tc_s < 0.3, icn / tnc_s < 0.3
    r_cc, r_cnc = cc / tc_s < 0.3, cnc / tnc_s < 0.3
    d1, d2 = torch.clamp(den1, min=1e-9), torch.clamp(den2, min=1e-9)
    cond_u = r_nc & r_icn & ((den1 <= 0) | (cc / d1 > 0.7)) \
        & ((den2 <= 0) | (cnc / d2 > 0.7))
    cond_f = r_cc & r_cnc & ((den2 <= 0) | (nc_ / d2 > 0.7)) \
        & ((den1 <= 0) | (icn / d1 > 0.7))
    cond_u = torch.where(is_leaf, torch.where(is_carrier, r_nc, r_nc & r_icn),
                         cond_u)
    cond_f = torch.where(is_leaf, torch.where(is_carrier, r_cc & r_cnc, r_cnc),
                         cond_f)
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    eff_u = torch.where(cond_u, nc_ + icn, big)
    eff_f = torch.where(cond_f, cc + cnc, big)
    rank = (csize * (M + 1)
            + torch.arange(M, device=dev, dtype=torch.float32))[:, None]
    inf = float("inf")

    def pick(eff):
        m = eff.min(dim=0).values
        return m, torch.where(eff == m[None, :], rank, inf).argmin(dim=0)

    min_u, bu = pick(eff_u)
    min_f, bf = pick(eff_f)
    use_f = min_f < min_u
    chosen = torch.where(use_f, min_f, min_u)
    branch = torch.where(use_f, bf, bu)
    ok = chosen <= MAP_SHARE * N
    all_c, none_c = tc == N, tc == 0
    flipped = ok & use_f & ~(all_c | none_c)
    ok = ok | all_c | none_c
    branch = torch.where(all_c, M - 1, torch.where(none_c, -1, branch))
    return torch.where(ok, branch, -1), ok, flipped


def map_check(G: np.ndarray, bp: np.ndarray, anc, mut, device):
    """Faults of one job's output against its panel: (tree faults, SNP
    faults, SNPs kept, detail). A tree fault: not a binary tree of N leaves
    with node N + t born at step t, a branch length that is negative or not
    finite, children that disagree on their parent's age by more than the
    printing's rounding, or a root at age 0. A SNP fault: a row missing or
    out of place, a tree that does not cover it, a branch other than the
    one MapMutation picks on that tree (or a mapping flag that disagrees
    with it), branches of a SNP that does not map that do not cover its
    carriers exactly, ages other than its branch's, or no branch where
    the SNP is not the last of a section. A SNP kept: one that is not the
    first of its tree and maps on it flipped or not at all, so that Relate
    built a candidate tree there and reverted it."""
    N, trees = anc
    L = G.shape[0]
    M = 2 * N - 1
    tree_faults, snp_faults, kept = 0, 0, 0
    detail = []
    pos = np.array([t[0] for t in trees], dtype=np.int64)
    if len(mut) != L:
        snp_faults += abs(len(mut) - L)
        detail.append(f"{len(mut)} SNP rows for {L} SNPs")
    ages = []
    for ti, (p, parent, length) in enumerate(trees):
        shape = tree_shape(parent, N)
        ok = (shape is not None and np.isfinite(length).all()
              and (length >= 0).all())
        age = None
        if ok:
            age, gap = node_ages(shape[0], shape[1], length, N)
            # printed lengths keep 5 decimals, ages 6 digits
            ok = bool((gap <= 1e-5 * age[N:] + N * 1e-5).all()
                      and age[M - 1] > 0)
        if not ok:
            tree_faults += 1
            if len(detail) < 8:
                detail.append(f"tree {ti} at SNP {p} is malformed")
        ages.append(age)
    if pos[0] != 0 or (np.diff(pos) <= 0).any():
        tree_faults += 1
        detail.append("tree positions do not start at 0 and rise")
    car_all = torch.as_tensor(G, dtype=torch.float32, device=device)
    rows_by_tree = {}
    for k, row in enumerate(mut[:L]):
        snp, b, tree, br, notmap, flipped, ab, ae = row
        t_cov = int(np.searchsorted(pos, snp, side="right") - 1)
        if snp != k or b != bp[k] or tree != t_cov:
            snp_faults += 1
            if len(detail) < 8:
                detail.append(f"SNP row {k}: index, position or tree wrong")
            continue
        rows_by_tree.setdefault(tree, []).append(k)
    starts = set(pos.tolist())
    for ti, ks in rows_by_tree.items():
        if ages[ti] is None:
            snp_faults += len(ks)
            continue
        parent = trees[ti][1]
        C = clade_rows(parent, N, device)
        csize = C.sum(dim=1)
        kk = torch.as_tensor(ks, device=device)
        branch, maps, flip = _map_rule(C, csize, car_all[kk], N, M)
        branch, maps = branch.cpu().numpy(), maps.cpu().numpy()
        flip = flip.cpu().numpy()
        for n, k in enumerate(ks):
            if k not in starts and (flip[n] or not maps[n]):
                kept += 1
            _, _, _, br, notmap, flipped, ab, ae = mut[k]
            bad = False
            if not br:
                # a section's last SNP is mapped with no carriers
                bad = not (k == L - 1 or (k + 1) in starts)
            elif len(br) == 1:
                bad = notmap != 0 or not maps[n] or br[0] != branch[n]
                if not bad:
                    age = ages[ti]
                    v = br[0]
                    want_b = age[v]
                    want_e = age[v] + trees[ti][2][v]
                    bad = not (_close(ab, want_b) and _close(ae, want_e))
            else:
                bad = notmap != 1 or bool(maps[n])
                if not bad:
                    cover = C[torch.as_tensor(br, device=device)].sum(dim=0)
                    want = car_all[k] if not flipped else 1.0 - car_all[k]
                    bad = not bool(torch.equal(cover, want))
            if bad:
                snp_faults += 1
                if len(detail) < 8:
                    detail.append(f"SNP {k}: branch {br} flags {notmap},"
                                  f"{flipped} against the tree's {branch[n]}")
    return tree_faults, snp_faults, kept, detail


def clock(trees, bp: np.ndarray, mu: float):
    """(mutations predicted, SNPs): mu times each tree's span in bp (from
    its first SNP to the next tree's, the last to one spacing past the
    region's last SNP) times its total branch length, summed over the
    trees, and the SNPs of the region."""
    L = len(bp)
    end = bp[-1] + (bp[-1] - bp[0]) / max(1, L - 1)
    x = np.append(bp.astype(np.float64), end)
    pos = [t[0] for t in trees] + [L]
    pred = 0.0
    for (p, _, length), nxt in zip(trees, pos[1:]):
        pred += mu * (x[nxt] - x[p]) * float(length.sum())
    return pred, L


def _close(a: float, b: float) -> bool:
    """Equal as printed (``%g``: six significant digits)."""
    return abs(a - b) <= 1e-5 * max(abs(a), abs(b)) + 1e-3

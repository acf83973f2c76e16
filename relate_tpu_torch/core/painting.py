"""Li & Stephens chromosome-painting HMM on PyTorch.

Counterpart of ``relate_tpu/core/painting.py`` (behavioural reference
``include/src/fast_painting.cpp``: PaintSteppingStones :17-618,
RePaintSection :620-1092). All target haplotypes advance in lockstep over
their *derived-site steps*; the sweeps themselves are the kernels of
``ops/paint_kernels.py``.

Model recap (per target haplotype k):
- The chain runs only over k's *derived* sites (plus the first and last SNP
  of the range); recombination over skipped sites is folded into one
  transition with probability ``p_j = 1 - exp(-sum r)`` capped at 0.99
  (fast_painting.cpp:118-121).
- Emission at a derived step multiplies sources that do NOT carry the
  derived allele by ``theta/(1-theta)``; the common ``(1-theta)`` factor per
  step is absorbed into a running logscale (fast_painting.cpp:112-121,291).
- alpha/beta are dynamically rescaled into [1e-10, 1e10].
- Quirks kept for parity: the backward transition into step j uses the
  interval factor of step j+1, and a posterior row at which a backward
  rescale triggers stores the pre-rescale beta while its logscale includes
  the correction (fast_painting.cpp:1033-1066); both cancel in the
  row-min-normalised distance matrix.

Layout: sources are contiguous everywhere. Per-target state is ``(B, N)``
on the host and on the device alike, the posterior is ``(Dmax, B, N)``.

Memory model: the full posterior of one window is materialised at once;
windows are sized upstream so that it fits. Stepping-stone checkpoints
between windows play the role of activation checkpointing.

Several cards (``Painter(mesh=)``): the sweeps run on the mesh's first
card, as on one card, and each card of the mesh gets a one-card replica of
the Painter (``shards``) for BuildTopology's sections on that card. Cutting
the targets over the cards, a host thread a card, took 1.9 to 2.4 times
one card's time on four H100s, the stepping stones alone 5 to 7 times
(PERF.md §5): each card's thread plans every window (``_prep``, mostly
small launches) and waits for the interpreter lock at each step.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import paint_kernels
from ..parallel.mesh import device_and_mesh
from ..utils.devmem import device_memory_gb, resolve_device

P_CAP = 0.99


@dataclass(frozen=True)
class PaintingModel:
    """Scalar painting parameters (data.cpp:81, fast_painting.hpp:26-39)."""
    N: int
    theta: float = 0.001

    @property
    def ntheta(self) -> float:
        return 1.0 - self.theta

    @property
    def theta_ratio(self) -> float:
        # emission trick multiplier: em = 1 + theta_ratio * mismatch
        return self.theta / (1.0 - self.theta) - 1.0

    @property
    def prior_theta(self) -> float:
        return self.theta / (self.N - 1.0) - self.ntheta / (self.N - 1.0)

    @property
    def prior_ntheta(self) -> float:
        return self.ntheta / (self.N - 1.0)

    @property
    def log_ntheta(self) -> float:
        return float(np.log(self.ntheta))


class TargetPlan(NamedTuple):
    """Per-target derived-site step arrays, padded to ``Dmax`` columns.

    ``idx[b, j]`` is the absolute SNP index (into the chunk) of target b's
    j-th step; padded steps repeat the final site and have zero transition.
    ``build_target_plan`` fills it with NumPy arrays, the device planner
    with tensors.
    """
    targets: np.ndarray       # (B,) target haplotype ids
    idx: np.ndarray           # (B, Dmax) int32 site index per step
    seqk: np.ndarray          # (B, Dmax) uint8 target allele at that site
    pfac: np.ndarray          # (B, Dmax) f32 p/((1-p)(N-1)) per interval
    nxt: np.ndarray           # (B, Dmax) f32 -raw + log(1-theta) per interval
    D: np.ndarray             # (B,) int32 true number of steps
    kmask: np.ndarray         # (B, N) f32: 0.0 at target's own column else 1.0

    @property
    def Dmax(self) -> int:
        return self.idx.shape[1]


def build_target_plan(G: np.ndarray, r: np.ndarray, model: PaintingModel,
                      first_arr, last_arr,
                      targets: Optional[np.ndarray] = None,
                      final_raw: Optional[np.ndarray] = None) -> TargetPlan:
    """Vectorised host precompute of derived-site steps (float64), after
    fast_painting.cpp:640-716. ``first_arr``/``last_arr`` may be scalars or
    per-target arrays (stepping-stone boundaries differ per target).

    Derived steps of target k = {first} u {l in (first,last): G[l,k]=1} u
    {last}. Interval j accumulates r over [idx_j, idx_{j+1}); the final
    interval is r[last] alone.
    """
    L, N = G.shape
    if targets is None:
        targets = np.arange(N, dtype=np.int32)
    targets = np.asarray(targets, dtype=np.int32)
    B = len(targets)
    first_arr = np.broadcast_to(np.asarray(first_arr, dtype=np.int64), (B,))
    last_arr = np.broadcast_to(np.asarray(last_arr, dtype=np.int64), (B,))

    S = np.zeros(L + 1, dtype=np.float64)
    np.cumsum(r, out=S[1:])

    pos = np.arange(L, dtype=np.int64)[None, :]
    inner_mask = ((G.T[targets] != 0)
                  & (pos > first_arr[:, None]) & (pos < last_arr[:, None]))
    rows, cols = np.nonzero(inner_mask)
    counts = np.bincount(rows, minlength=B).astype(np.int64)
    starts = np.zeros(B, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    D = (counts + 2).astype(np.int32)
    Dmax = int(D.max())
    idx = np.broadcast_to(last_arr[:, None], (B, Dmax)).copy()
    idx[:, 0] = first_arr
    if len(rows):
        rank = np.arange(len(rows), dtype=np.int64) - starts[rows]
        idx[rows, rank + 1] = cols

    col = np.arange(Dmax, dtype=np.int64)[None, :]
    bidx = np.arange(B)[:, None]
    nxt_pos = np.minimum(col + 1, D[:, None].astype(np.int64) - 1)
    raw = S[idx[bidx, nxt_pos]] - S[idx]
    # interval past the range end: r[last] alone for a plain repaint
    # (fast_painting.cpp:711-712), or an explicit override (checkpoint
    # chaining extends it to the next derived site beyond the window)
    fin = (r[last_arr] if final_raw is None
           else np.asarray(final_raw, dtype=np.float64))
    raw = np.where(col == D[:, None] - 1, fin[:, None], raw)
    raw = np.where(col >= D[:, None], 0.0, raw)

    p = 1.0 - np.exp(-raw)
    capped = p > P_CAP
    p = np.where(capped, P_CAP, p)
    nxt = np.where(capped, np.log(0.01) + model.log_ntheta,
                   -raw + model.log_ntheta)
    pfac = p / ((1.0 - p) * (model.N - 1.0))
    pad = np.arange(Dmax)[None, :] >= D[:, None]
    pfac = np.where(pad, 0.0, pfac)
    nxt = np.where(pad, 0.0, nxt)

    seqk = G[idx, targets[:, None]].astype(np.uint8)
    kmask = np.ones((B, N), dtype=np.float32)
    kmask[np.arange(B), targets] = 0.0
    return TargetPlan(targets=targets, idx=idx.astype(np.int32), seqk=seqk,
                      pfac=pfac.astype(np.float32), nxt=nxt.astype(np.float32),
                      D=D, kmask=kmask)


def initial_alpha(G: np.ndarray, model: PaintingModel, first: int,
                  targets: np.ndarray) -> np.ndarray:
    """Prior-times-emission alpha at the first chromosome site
    (fast_painting.cpp:205-230)."""
    row = G[first]
    seqk = G[first, targets]
    derived = (seqk[:, None] > row[None, :]).astype(np.float32)
    alpha0 = derived * model.prior_theta + model.prior_ntheta
    alpha0[np.arange(len(targets)), targets] = 0.0
    return alpha0.astype(np.float32)


def normalizing_constant(model: PaintingModel, num_steps) -> np.ndarray:
    """log(N-1) - D*log(1-theta) (fast_painting.cpp:399), per target."""
    return np.asarray(np.log(model.N - 1.0)
                      - np.asarray(num_steps) * model.log_ntheta,
                      dtype=np.float32)


def device_plan(model: PaintingModel, G: torch.Tensor, GT: torch.Tensor,
                S: torch.Tensor, targets: torch.Tensor, first: torch.Tensor,
                last: torch.Tensor, fin: torch.Tensor, Dmax: int):
    """Device twin of :func:`build_target_plan`, feeding the sweep kernels.

    ``G`` (L, N) uint8 and ``GT`` (N, L) are the panel (or the window's
    slice of it) and its transpose, ``S`` (L+1,) the float64 prefix sum of
    r over the same rows, ``first``/``last`` (B,) int64 row indices into
    them, ``fin`` (B,) float64 the interval past each target's last step,
    ``Dmax`` the largest step count (known on the host from prefix counts).

    The ragged derived-site lists are compacted with one sort per call;
    interval lengths are float64 differences of the prefix sum.
    Returns (idx (B,Dmax) int32, seqk (B,Dmax) uint8, D (B,) int32,
    mism (Dmax,B,N) int8, pfac (B,Dmax) f32, nxt (B,Dmax) f32,
    kmask (B,N) f32).
    """
    L, N = G.shape
    B = targets.shape[0]
    dev = G.device
    GTt = GT[targets]                                        # (B, L)
    pos = torch.arange(L, device=dev, dtype=torch.int64)[None, :]
    first_c = first[:, None]
    last_c = last[:, None]
    mask = (GTt != 0) & (pos > first_c) & (pos < last_c)
    counts = mask.sum(dim=1, keepdim=True)                   # (B, 1)
    D = counts + 2
    # left-compact the derived positions of every target
    keys = torch.where(mask, pos, torch.full_like(pos, L))
    # (Dmax - 1 = most derived sites of one target + 1 <= L - 1 columns)
    skeys = torch.sort(keys, dim=1).values[:, :Dmax - 1]
    col = torch.arange(Dmax, device=dev, dtype=torch.int64)[None, :]
    inner_sel = col <= counts
    idx = torch.cat([first_c, skeys], dim=1)
    idx = torch.where(col == 0, first_c, torch.where(inner_sel, idx, last_c))
    # interval j runs from step j to step j+1 (left-compacted: a shift)
    idx_next = torch.cat([idx[:, 1:], last_c], dim=1)
    raw = torch.where(col < D - 1, S[idx_next] - S[idx],
                      torch.zeros((), dtype=torch.float64, device=dev))
    raw = torch.where(col == D - 1, fin[:, None], raw)
    # target allele per step: inner steps are derived by construction, only
    # the boundary steps read the panel
    gfirst = torch.gather(GTt, 1, first_c)
    glast = torch.gather(GTt, 1, last_c)
    seqk = torch.where(col == 0, gfirst,
                       torch.where(inner_sel, torch.ones_like(gfirst), glast))
    p = -torch.expm1(-raw)
    capped = p > P_CAP
    p = torch.where(capped, torch.full_like(p, P_CAP), p)
    log_ntheta = model.log_ntheta
    nxt = torch.where(capped,
                      torch.full_like(raw, float(np.log(0.01)) + log_ntheta),
                      -raw + log_ntheta)
    pfac = p / ((1.0 - p) * (model.N - 1.0))
    padm = col >= D
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    pfac = torch.where(padm, zero, pfac).to(torch.float32)
    nxt = torch.where(padm, zero, nxt).to(torch.float32)

    mism = mismatch_rows(G, idx, seqk)
    ncol = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    kmask = (ncol != targets[:, None]).to(torch.float32)
    return (idx.to(torch.int32), seqk, D[:, 0].to(torch.int32), mism,
            pfac.contiguous(), nxt.contiguous(), kmask)


def mismatch_rows(G: torch.Tensor, idx: torch.Tensor,
                  seqk: torch.Tensor) -> torch.Tensor:
    """The per-step mismatch stream (Dmax, B, N) int8 of a plan's ``idx`` /
    ``seqk`` (B, Dmax): 1 where the target carries the derived allele at its
    step and the source does not. One gather of panel rows."""
    B, Dmax = idx.shape
    rows = G[idx.t().reshape(-1).long()].view(Dmax, B, G.shape[1])
    return (seqk.t()[:, :, None] > rows).contiguous().view(torch.int8)


class PaintOutput(NamedTuple):
    """Posterior for a set of targets over one window.

    ``topology[j, b, :]`` is alpha*beta at target b's j-th step (rows past
    D[b] are zero). The total logscale of row (j, b) is
    ``logscale[j, b] + ls_base[b]``: the in-window part is float32 (small
    magnitude), the cross-window base float64 (host-chained). Distance
    assembly only ever needs in-row logscale *differences*, so the base
    cancels there.
    """
    topology: torch.Tensor   # (Dmax, B, N) float32
    logscale: torch.Tensor   # (Dmax, B) float32, relative to ls_base
    ls_base: np.ndarray      # (B,) float64
    plan: TargetPlan


class Checkpoint:
    """Stepping-stone boundary state for one window, all targets (the analog
    of one ``paint/relate_<w>.bin`` record set).

    ``alpha``/``beta`` are (B, N) host arrays, materialised lazily: the
    stepping-stone pass keeps the slabs on the device (``a0_dev``/``be_dev``,
    (B, N) float32 tensors) and host copies are produced only when read
    (artifact writes).
    """

    __slots__ = ("_alpha", "ls_alpha", "bsb", "_beta", "ls_beta", "bse",
                 "a0_dev", "be_dev")

    def __init__(self, alpha=None, ls_alpha=None, bsb=None, beta=None,
                 ls_beta=None, bse=None, a0_dev=None, be_dev=None):
        self._alpha = alpha
        self.ls_alpha = ls_alpha
        self.bsb = bsb
        self._beta = beta
        self.ls_beta = ls_beta
        self.bse = bse
        self.a0_dev = a0_dev
        self.be_dev = be_dev

    @property
    def alpha(self):
        if self._alpha is None:
            self._alpha = self.a0_dev.cpu().numpy()
        return self._alpha

    @property
    def beta(self):
        if self._beta is None:
            self._beta = self.be_dev.cpu().numpy()
        return self._beta


class Painter:
    """Painting front end for one chunk: holds the genotype panel on the device,
    computes stepping-stone checkpoints per window and full posteriors.

    With a ``mesh`` (``parallel.mesh.Mesh`` or a list of devices) the sweeps
    run on the mesh's first device, which is ``device``, and ``shards``
    holds a one-card Painter a card of the mesh, sharing the host caches."""

    def __init__(self, G: np.ndarray, r: np.ndarray, model: PaintingModel,
                 device=None, mesh=None):
        self.device, self.mesh = device_and_mesh(device, mesh)
        self.G_host = np.ascontiguousarray(G, dtype=np.uint8)
        self.G = torch.from_numpy(self.G_host).to(self.device)
        self.GT = self.G.t().contiguous()
        self.r = np.asarray(r, dtype=np.float64)
        self.model = model
        self.L, self.N = G.shape
        self._csr = None
        self._cumG = None
        self._S = None
        self._S_dev = None
        self.shards = None
        if self.mesh is not None:
            self._cum_counts()
            self._r_prefix()
            self._derived_csr()
            self.shards = [self._replica(d) for d in self.mesh]

    def _replica(self, device) -> "Painter":
        """A one-card Painter of the same panel on ``device``, sharing this
        one's host caches (its device tensors are its own)."""
        device = resolve_device(device)
        p = copy.copy(self)
        p.mesh = p.shards = None
        if device != self.device:
            p.device = device
            p.G = torch.from_numpy(self.G_host).to(device)
            p.GT = p.G.t().contiguous()
            p._S_dev = None
        return p

    # -- caches ------------------------------------------------------------
    def _cum_counts(self) -> np.ndarray:
        """(L+1, N) prefix counts of derived sites per haplotype."""
        if self._cumG is None:
            c = np.zeros((self.L + 1, self.N), dtype=np.int32)
            np.cumsum(self.G_host, axis=0, out=c[1:])
            self._cumG = c
        return self._cumG

    def _r_prefix(self) -> np.ndarray:
        if self._S is None:
            S = np.zeros(self.L + 1, dtype=np.float64)
            np.cumsum(self.r, out=S[1:])
            self._S = S
        return self._S

    def _derived_csr(self):
        """CSR layout of per-haplotype derived-site positions: column k's
        sorted positions are ``cols[indptr[k]:indptr[k+1]]``."""
        if self._csr is None:
            rows, cols = np.nonzero(self.G_host.T)
            indptr = np.zeros(self.N + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows, minlength=self.N), out=indptr[1:])
            self._csr = (indptr, cols.astype(np.int64))
        return self._csr

    # -- window plan -------------------------------------------------------
    def _prep(self, targets, first_arr, last_arr, final_raw=None):
        """Device plan for one window run.

        The planner only looks at panel rows inside [min(first), max(last)]
        (the window plus its boundary stretch), so the panel is sliced to
        that span before the (B, L) masked sort."""
        B = len(targets)
        first_arr = np.broadcast_to(
            np.asarray(first_arr, dtype=np.int64), (B,))
        last_arr = np.broadcast_to(np.asarray(last_arr, dtype=np.int64), (B,))
        targets = np.asarray(targets, dtype=np.int64)

        cumG = self._cum_counts()
        counts = (cumG[last_arr, targets]
                  - cumG[first_arr + 1, targets]).astype(np.int64)
        Dmax = int(counts.max()) + 2

        lo = int(first_arr.min())
        hi = int(last_arr.max()) + 1
        if self._S_dev is None:
            self._S_dev = torch.from_numpy(self._r_prefix()).to(self.device)
        fin = self.r[last_arr].astype(np.float64)
        if final_raw is not None:
            fin = np.asarray(final_raw, dtype=np.float64)

        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        idx, seqk, D, mism, pfac, nxt, kmask = device_plan(
            self.model, self.G[lo:hi], self.GT[:, lo:hi],
            self._S_dev[lo:hi + 1], t(targets), t(first_arr - lo),
            t(last_arr - lo), t(fin), Dmax)
        if lo:
            idx = idx + lo              # back to absolute sites
        return dict(B=B, counts=counts, first=first_arr, last=last_arr,
                    targets=targets, idx=idx, seqk=seqk, D=D, mism=mism,
                    pfac=pfac, nxt=nxt, kmask=kmask)

    def _rows_of_sites(self, prep, targets, sites):
        """Step-row index of absolute sites within a window plan, from
        prefix counts. Sites must be plan steps (a boundary or a derived
        site of the target)."""
        cumG = self._cum_counts()
        sites = np.asarray(sites, dtype=np.int64)
        first = prep["first"]
        cnt = cumG[sites + 1, targets] - cumG[first + 1, targets]
        rows = np.where(sites <= first, 0,
                        np.where(sites >= prep["last"],
                                 prep["counts"] + 1, cnt))
        return rows.astype(np.int64)

    def _to_dev(self, arr, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            arr, dtype=np.float32)).to(device or self.device)

    # -- boundaries ------------------------------------------------------
    def window_boundary_sites(self, boundaries: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(window, target) stepping-stone boundary SNPs.

        alpha checkpoint of window w = last derived step < boundaries[w+1]
        of the previous stretch; beta checkpoint = first derived step >=
        boundaries[w+1] (fast_painting.cpp:56-107). Window 0 starts at 0; the
        last window ends at L-1.
        """
        G = self.G_host
        L, N = G.shape
        W = len(boundaries) - 1
        bsb = np.zeros((W, N), dtype=np.int64)
        bse = np.zeros((W, N), dtype=np.int64)
        indptr, csr_cols = self._derived_csr()
        wends = np.asarray(boundaries[1:], dtype=np.int64)
        for k in range(N):
            core = csr_cols[indptr[k]:indptr[k + 1]]
            dsites = np.unique(np.concatenate([[0], core, [L - 1]]))
            jpos = np.searchsorted(dsites, wends, side="left")
            bsb[:, k] = dsites[np.maximum(jpos - 1, 0)]
            bse[:, k] = dsites[np.minimum(jpos, len(dsites) - 1)]
        # alpha checkpoint for window w is captured at boundaries[w]: the
        # last derived step < boundaries[w] (i.e. the bsb of window w-1).
        out_bsb = np.zeros((W, N), dtype=np.int64)
        out_bsb[1:, :] = bsb[:-1, :]
        bse[W - 1, :] = L - 1
        return out_bsb, bse

    # -- stepping stones -------------------------------------------------
    def paint_stepping_stones(self, boundaries: np.ndarray):
        """Per-window checkpoints via chained window sweeps.

        Forward: window w's sweep starts from checkpoint w, and the alpha row
        at window w+1's begin-boundary (inside window w's range) is the next
        checkpoint. Backward symmetric. The boundary slabs stay on the device
        between windows (each captured (B, N) slab feeds the next sweep
        directly); logscales are chained in float64 on the host. Same total
        cost as the reference's full passes, single-window memory.
        """
        boundaries = np.asarray(boundaries)
        W = len(boundaries) - 1
        N = self.N
        bsb, bse = self.window_boundary_sites(boundaries)

        # device-resident slab budget: keep at most K windows' checkpoint
        # slabs on the card (a quarter of its memory), download the rest
        slab = N * N * 4
        if self.device.type == "cuda":
            K_dev = max(2, int(device_memory_gb(self.device) * 1e9 * 0.25
                               / (2 * slab)))
        else:
            K_dev = W

        a_sl, lsa0, b_sl, lsbW = self._stones(
            bsb, bse, np.arange(N, dtype=np.int32), K_dev)

        def dev(x):
            return x if isinstance(x, torch.Tensor) else None

        def host(x):
            return None if isinstance(x, torch.Tensor) else x
        return [Checkpoint(alpha=host(a_sl[w]), beta=host(b_sl[w]),
                           ls_alpha=lsa0[w], bsb=bsb[w],
                           ls_beta=lsbW[w], bse=bse[w],
                           a0_dev=dev(a_sl[w]), be_dev=dev(b_sl[w]))
                for w in range(W)]

    def _stones(self, bsb, bse, targets, K_dev):
        """The chained sweeps of ``targets`` on this Painter's device. Returns
        per window the alpha slab (a (B, N) tensor for the first ``K_dev``
        windows, else a host array), the float64 alpha logscales, the beta
        slab and the beta logscales."""
        W = bsb.shape[0]
        N = self.N
        B = len(targets)
        bsb, bse = bsb[:, targets], bse[:, targets]
        theta = float(self.model.theta)

        def keep(w, dev_slab):
            return dev_slab if w < K_dev else dev_slab.cpu().numpy()

        alphas0: list = [None] * W
        lsa0: list = [None] * W
        betasW: list = [None] * W
        lsbW: list = [None] * W

        def want_of(rows):
            return torch.from_numpy(rows.astype(np.int32)).to(self.device)

        a_dev = self._to_dev(initial_alpha(self.G_host, self.model, 0,
                                           targets))
        lsa = np.zeros(B, dtype=np.float64)
        for w in range(W):
            alphas0[w] = keep(w, a_dev)
            lsa0[w] = lsa
            if w == W - 1:
                break
            prep = self._prep(targets, bsb[w], bse[w])
            rows = self._rows_of_sites(prep, targets, bsb[w + 1])
            a_dev, lv = paint_kernels.fwd_capture(
                prep["D"], want_of(rows), a_dev, prep["kmask"], prep["mism"],
                prep["pfac"], prep["nxt"], theta=theta)
            lsa = lsa + lv.cpu().numpy().astype(np.float64)
            del prep

        Dtot = self.G_host[1:-1].sum(axis=0).astype(np.int64)[targets] + 2
        b_dev = torch.ones((B, N), dtype=torch.float32, device=self.device)
        lsb = normalizing_constant(self.model, Dtot).astype(np.float64)
        for w in range(W - 1, -1, -1):
            betasW[w] = keep(w, b_dev)
            lsbW[w] = lsb
            if w == 0:
                break
            # extend the final interval to the next derived site beyond the
            # window so the chained checkpoints reproduce the reference's
            # single full-pass interval structure exactly
            final_raw = self._extended_final_raw(bse[w], targets)
            prep = self._prep(targets, bsb[w], bse[w], final_raw=final_raw)
            rows = self._rows_of_sites(prep, targets, bse[w - 1])
            b_dev, lv = paint_kernels.bwd_capture(
                prep["D"], want_of(rows), b_dev, prep["kmask"], prep["mism"],
                prep["pfac"], prep["nxt"], theta=theta)
            lsb = lsb + lv.cpu().numpy().astype(np.float64)
            del prep
        return alphas0, lsa0, betasW, lsbW

    def _extended_final_raw(self, bse_row: np.ndarray,
                            targets: np.ndarray) -> np.ndarray:
        """Full-pass interval at each target's window-end step (``bse_row``,
        one a target): accumulated r from bse to the next derived step of
        that target beyond it."""
        r = self.r
        L = self.L
        S = self._r_prefix()
        indptr, csr_cols = self._derived_csr()
        out = np.empty(len(targets), dtype=np.float64)
        for i, k in enumerate(targets):
            b = int(bse_row[i])
            if b >= L - 1:
                out[i] = r[L - 1]
                continue
            core = csr_cols[indptr[k]:indptr[k + 1]]
            j = np.searchsorted(core, b, side="right")
            nd = int(core[j]) if j < len(core) else L - 1
            out[i] = S[nd] - S[b]
        return out

    # -- full posterior --------------------------------------------------
    def repaint(self, cp: Checkpoint,
                targets: Optional[np.ndarray] = None) -> PaintOutput:
        """Full posterior over a window from its checkpoint
        (RePaintSection equivalent): one forward and one backward sweep."""
        if targets is None:
            targets = np.arange(self.N, dtype=np.int32)
        targets = np.asarray(targets, dtype=np.int32)
        base = (np.asarray(cp.ls_alpha, np.float64)[targets]
                + np.asarray(cp.ls_beta, np.float64)[targets])
        all_t = len(targets) == self.N and \
            np.array_equal(targets, np.arange(self.N))
        bsb = cp.bsb[targets] if np.ndim(cp.bsb) else cp.bsb
        bse = cp.bse[targets] if np.ndim(cp.bse) else cp.bse
        bsb = np.broadcast_to(np.asarray(bsb, dtype=np.int64), targets.shape)
        bse = np.broadcast_to(np.asarray(bse, dtype=np.int64), targets.shape)
        if cp.a0_dev is not None and cp.be_dev is not None and all_t:
            a0, be = cp.a0_dev.to(self.device), cp.be_dev.to(self.device)
        else:
            a0 = self._to_dev(cp.alpha[targets])
            be = self._to_dev(cp.beta[targets])
        return self._repaint(targets, a0, be, bsb, bse, base)

    def _repaint(self, targets, a0, be, bsb, bse, base) -> PaintOutput:
        """The sweeps of one repaint on this Painter's device, from the
        slabs ``a0``/``be`` (B, N) of ``targets``."""
        prep = self._prep(targets, bsb, bse)
        theta = float(self.model.theta)
        alphas, lsf = paint_kernels.fwd(prep["D"], a0, prep["kmask"],
                                        prep["mism"], prep["pfac"],
                                        prep["nxt"], theta=theta)
        topo, lstot = paint_kernels.bwd(prep["D"], be, prep["kmask"],
                                        prep["mism"], prep["pfac"],
                                        prep["nxt"], alphas, lsf, theta=theta)
        del alphas
        plan = TargetPlan(targets=targets, idx=prep["idx"], seqk=prep["seqk"],
                          pfac=prep["pfac"], nxt=prep["nxt"],
                          D=(prep["counts"] + 2).astype(np.int32),
                          kmask=prep["kmask"])
        return PaintOutput(topology=topo, logscale=lstot,
                           ls_base=np.asarray(base, np.float64), plan=plan)

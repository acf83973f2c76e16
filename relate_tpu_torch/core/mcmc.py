"""Branch-length MCMC under the coalescent, batched over trees.

Counterpart of ``relate_tpu/core/mcmc.py`` (behavioural reference
``EstimateBranchLengthsWithSampleAge``,
``include/src/branch_length_estimator.cpp``): Poisson mutation likelihood
per branch (rate ``mut_rate[i] = Ne*mu*sum(dist)`` over the branch's SNP
span, :215-237) times a coalescent prior (constant-Ne :839-898 or
piecewise coalescence rates :1023-1156); proposals are

- ``UpdateOneEvent`` (:1539-1900): move one internal node's age uniformly
  between its older child and parent (exponential proposal at the root);
- ``SwitchOrder`` (:385-583): swap an event with another event of adjacent
  order, exchanging their ages (the sorted coordinate multiset is invariant,
  so the prior cancels).

Mixture 70/30 (:2789), transient ``50*max(N/10,10)`` proposals, then blocks
of ``delta`` proposals until every internal node was proposed >= 50 times and
the running-average ages are monotone along the tree (:2983-3073). Output
branch length = ``Ne * (avg[parent] - avg[node])`` (:3077-3079).

One chain per tree, all trees of a section advanced in lockstep as (B, M)
tensors. Each iteration is one single proposal per chain plus two phases of
a **parallel age gap sweep** and one phase of a **parallel order sweep**
(adjacent transpositions); the selected nodes of a phase form an
independent set in the tree and in the sorted order, so the simultaneous
Metropolis decisions are exact (the arguments are in ``age_sweep`` and
``order_sweep``). Coordinate running means use Kahan compensation, so
float32 state is safe for long chains.

What differs from the JAX module, on purpose:

- permutations are applied with ``torch.gather``/``scatter`` by ``parent``,
  ``child_left``, ``child_right``, ``sorted_idx`` and ``order`` (the JAX
  module sorts because gathers are slow on a TPU; every sort key there is a
  permutation, so both give the same arrays);
- ``update_one_event`` and ``switch_order`` are written over the batch
  directly, not per chain under ``vmap``;
- every function that draws takes its uniforms as arguments, and ``Draws``
  (a ``torch.Generator`` on the device plus a host generator for the one
  global coin per step) is only their default source. Chains are therefore
  not draw-for-draw those of the JAX package, but fed the same uniforms a
  step, a sweep or an iteration gives the same state;
- PyTorch runs eagerly, so there is no compiled block to cache, no
  power-of-two batch bucket and no fused span of rounds: the convergence loop
  checks once per round, with ``conv.all()`` as its only download;
- ``run_mcmc(mesh=)`` runs the whole batch on the mesh's first card (the
  JAX package cuts it over the devices): the chains are bound by the host's
  launches, and a batch cut over four H100s, a host thread a card, took
  10.5 to 13.6 times one card's time (PERF.md §5). Several cards serve
  whole parts from a process each: ``run_mcmc(pool=)`` gives its parts
  above ``max_batch`` to a ``parallel.pool.CardPool`` (``chain_part``), and
  ``pipeline.relate.infer_branch_lengths`` whole sections. ``Draws(rows=)``
  still lets a block of a batch draw as the whole batch would
  (``parallel.mesh.multichip_step``).

Deliberate deviations from the reference, shared with the JAX module
(distribution-level): the acceptance ratio of ``UpdateOneEvent`` includes
the full affected prior window; ``log(1+t)`` is ``log1p``; the initial event
order is a random linear extension of the tree poset; the >= 50 gate counts
sweep proposals as well as singles.

Priors: constant Ne and piecewise rates (``use_vp``), contemporary and
ancient samples (``use_ages``: ``sample_ages`` in generations, divided by
Ne; the lineage profile follows the sorted leaf/internal pattern, and the
chains start from ``_pseudo_order`` / ``_initial_coords``), and the
pairwise-group prior (``group_R``: per-epoch G x G coalescence rates
between groups of haplotypes, MCMCCoalRatesForRelate). Under the pairwise
prior every step is an ``UpdateOneEvent`` (the reference's p2 = 1.0,
branch_length_estimator.cpp:4075): no coin, no sweeps, one proposal an
iteration.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import device_and_mesh
from ..parallel.pool import HERE
from ..utils.devmem import resolve_device
from ..utils.trace import count, note, span
from .trees import Tree

P2 = 0.7  # UpdateOneEvent share of proposals

# max B*M cells per chain batch: bounds the device memory of one batch (an
# iteration holds some tens of (B, M) temporaries beside the state)
MAX_CHAIN_CELLS = 4096 * 511


def chain_batch_cap(M: int, max_cells: int = MAX_CHAIN_CELLS) -> int:
    cap = max(max_cells // max(M, 1), 256)
    return 1 << (cap.bit_length() - 1)


class ChainStatic(NamedTuple):
    parent: torch.Tensor       # (B, M) int64 (-1 at root)
    child_left: torch.Tensor   # (B, M) int64 (-1 at leaves)
    child_right: torch.Tensor  # (B, M) int64
    num_events: torch.Tensor   # (B, M) f32
    mut_rate: torch.Tensor     # (B, M) f32
    kc2_pos: torch.Tensor      # (M,) f32 C(nl(p),2) per sorted position
    # piecewise coalescent prior (constant Ne -> single epoch, rate 1)
    epochs: torch.Tensor       # (E,) f32 boundaries (epochs[0]=0)
    rates: torch.Tensor        # (B, E) f32 rate in [epochs[i], epochs[i+1])
    cumR: torch.Tensor         # (B, E) f32 integral of rate up to boundary
    depth: torch.Tensor        # (B, M) int64 depth below the root (the gap
    #   sweep's independent-set selection)
    # pairwise group-rate prior: per-node leaf group fractions and per-epoch
    # G x G rate matrices. The reference's per-node-pair rate
    # (branch_length_estimator.cpp:4052-4070) is the bilinear form
    # f_i^T R_e f_j, so a level's intensity reduces to S^T R S with S the
    # active lineages' fraction sum (O(G^2) a level instead of O(N^2)).
    F: Optional[torch.Tensor] = None       # (B, M, G) f32 group fractions
    Rg: Optional[torch.Tensor] = None      # (E, G, G) f32 rates per epoch
    cumIRg: Optional[torch.Tensor] = None  # (E, G, G) f32 integral to epoch


class ChainState(NamedTuple):
    coords: torch.Tensor       # (B, M) f32 node ages (units of Ne generations)
    order: torch.Tensor        # (B, M) int64 sorted position of each node
    sorted_idx: torch.Tensor   # (B, M) int64 node at each sorted position
    cs: torch.Tensor           # (B, M) f32 ages in sorted order; the
    #   invariant cs == coords[sorted_idx] is maintained by every move
    ssum: torch.Tensor         # (B, M) f32 Kahan sum of coords
    scomp: torch.Tensor        # (B, M) f32 Kahan compensation
    count: torch.Tensor        # (B,) f32
    cprop: torch.Tensor        # (B, M) int32 proposal counts


def init_chain_state(coords0, order0, sidx0, device=None) -> ChainState:
    """A ChainState from host arrays, establishing the cs invariant."""
    device = resolve_device(device)
    coords0 = np.asarray(coords0, np.float32)
    sidx0 = np.asarray(sidx0, np.int64)
    B, M = coords0.shape
    cs0 = np.take_along_axis(coords0, sidx0, axis=1)
    z = lambda dt: torch.zeros((B, M), dtype=dt, device=device)  # noqa: E731
    return ChainState(
        coords=torch.from_numpy(coords0).to(device),
        order=torch.from_numpy(np.asarray(order0, np.int64)).to(device),
        sorted_idx=torch.from_numpy(sidx0).to(device),
        cs=torch.from_numpy(cs0).to(device),
        ssum=z(torch.float32), scomp=z(torch.float32),
        count=torch.zeros((B,), dtype=torch.float32, device=device),
        cprop=z(torch.int32))


def _kahan_add(s, c, x):
    y = x - c
    t = s + y
    c2 = (t - s) - y
    return t, c2


def _rate_integral_bm(st: ChainStatic, t):
    """Piecewise rate integral R(t) and rate r(t) for t of shape (B, K),
    row b under the rates of chain b."""
    e = (torch.searchsorted(st.epochs, t.contiguous(), right=True) - 1
         ).clamp(0, st.rates.shape[1] - 1)
    cum = torch.gather(st.cumR, 1, e)
    rt = torch.gather(st.rates, 1, e)
    return cum + rt * (t - st.epochs[e]), rt


def _log_rate(r):
    return torch.log(r.clamp(min=1e-30))


def _kc2_from_sorted(sorted_idx, N: int):
    """(B, M) C(num_lineages, 2) per sorted position from the sorted
    leaf/internal pattern: the profile with ancient samples (leaves at any
    position). For contemporary samples it equals ``kc2_pos`` from the last
    leaf's position on; the intervals before it are empty."""
    leaf = (sorted_idx < N).to(torch.float32)
    nl = torch.cumsum(leaf, dim=1) - torch.cumsum(1.0 - leaf, dim=1)
    return nl * (nl - 1.0) * 0.5


def _prior_window(st: ChainStatic, cs, lo, hi, kc2, leaf_pos):
    """Per chain: -sum_{p in [lo, hi)} C(nl(p),2) * (R(cs[p+1]) - R(cs[p]))
    + sum of log rate at coalescence endpoints in (lo, hi]. cs (B, M),
    lo/hi (B,), kc2 (M,) or (B, M), leaf_pos (M,) or (B, M) bool."""
    M = cs.shape[1]
    p = torch.arange(M - 1, device=cs.device)[None, :]
    mask = (p >= lo[:, None]) & (p < hi[:, None])
    Ra, rate = _rate_integral_bm(st, cs)
    seg = kc2[..., :-1] * (Ra[:, 1:] - Ra[:, :-1])
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    out = -torch.where(mask, seg, zero).sum(dim=1)
    logr = torch.where(mask & ~leaf_pos[..., 1:], _log_rate(rate[:, 1:]),
                       zero).sum(dim=1)
    return out + logr


def _pair_epoch(st: ChainStatic, t):
    return (torch.searchsorted(st.epochs, t.contiguous(), right=True) - 1
            ).clamp(0, st.Rg.shape[0] - 1)


def _pair_IR(st: ChainStatic, t):
    """(..., G, G) integral of the per-epoch rate matrices from 0 to t."""
    e = _pair_epoch(st, t)
    return st.cumIRg[e] + st.Rg[e] * (t - st.epochs[e])[..., None, None]


def _bilinear(f1, Mx, f2):
    """f1^T Mx f2 over the last axes: (..., G), (..., G, G), (..., G)."""
    return (f1[..., :, None] * Mx * f2[..., None, :]).sum(dim=(-2, -1))


def _prior_window_pair(st: ChainStatic, N: int, cs, sidx, lo, hi):
    """Pairwise-group-rate twin of :func:`_prior_window` (CalculatePrior
    with coal_rate_pair, branch_length_estimator.cpp:1159). ``cs``/``sidx``
    are (..., B, M): leading axes evaluate several states of the same chains
    at once; lo/hi (B,).

    Level p (between sorted events p and p+1) has intensity
    ``0.5*(S_p^T R_e S_p - <D_p, R_e>)`` with S_p the sum and D_p the sum of
    outer products of the active lineages' group-fraction vectors; both are
    cumulative sums along the sorted order (a leaf joins, an internal node
    replaces its two children). The epoch-crossing time integral uses the
    precomputed cumulative-rate matrices. Coalescence events add
    ``log f_cl^T R_e f_cr``."""
    M = cs.shape[-1]
    G = st.F.shape[-1]
    lead = sidx.shape[:-2]
    F = st.F.expand(*lead, *st.F.shape)

    def frac(idx):
        return torch.gather(F, -2, idx[..., None].expand(*idx.shape, G))

    def at(a):
        return torch.gather(a.expand(*lead, *a.shape), -1, sidx)
    fv = frac(sidx)
    f1 = frac(_wrap(at(st.child_left), M))
    f2 = frac(_wrap(at(st.child_right), M))
    leaf = (sidx < N)[..., None]
    S = torch.cumsum(torch.where(leaf, fv, fv - f1 - f2), dim=-2)

    def outer(f):
        return f[..., :, None] * f[..., None, :]
    o_v = outer(fv)
    D = torch.cumsum(torch.where(leaf[..., None], o_v,
                                 o_v - outer(f1) - outer(f2)), dim=-3)
    IRa = _pair_IR(st, cs)
    dIR = IRa[..., 1:, :, :] - IRa[..., :-1, :, :]
    Sp = S[..., :-1, :]
    lam = 0.5 * (_bilinear(Sp, dIR, Sp)
                 - (D[..., :-1, :, :] * dIR).sum(dim=(-2, -1)))
    p = torch.arange(M - 1, device=cs.device)
    mask = (p >= lo[:, None]) & (p < hi[:, None])
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    out = -torch.where(mask, lam, zero).sum(dim=-1)
    # event terms: coalescences at sorted positions p+1 in (lo, hi]
    Re = st.Rg[_pair_epoch(st, cs[..., 1:])]
    rate_ev = _bilinear(f1[..., 1:, :], Re, f2[..., 1:, :])
    logr = torch.where(mask & (sidx[..., 1:] >= N), _log_rate(rate_ev),
                       zero).sum(dim=-1)
    return out + logr


def clade_levels(parent, N: int, depth=None):
    """The internal nodes of a (B, M) tree batch grouped by depth, deepest
    first: a list of int64 tensors of flat indices ``b * M + v``. A node's
    children are deeper than the node, so visiting the levels in this order
    sees every child before its parent. One download (the level sizes)."""
    B, M = parent.shape
    if depth is None:
        depth = tree_depths_dev(parent)
    dep = depth[:, N:].reshape(-1)
    flat = (torch.arange(B, device=parent.device)[:, None] * M
            + torch.arange(N, M, device=parent.device)[None, :]).reshape(-1)
    order = torch.argsort(dep, descending=True, stable=True)
    sizes = torch.bincount(dep).tolist()[::-1]
    return list(torch.split(flat[order], sizes))


def sum_over_clades(child_left, child_right, levels, leaf_values):
    """(B, M, G): ``leaf_values`` (N, G) at the leaves, and at every internal
    node the sum over its two children, level by level (``clade_levels``):
    a node's clade-by-group counts when the leaf values are one-hot."""
    B, M = child_left.shape
    N, G = leaf_values.shape
    dev = child_left.device
    off = torch.arange(B, device=dev)[:, None] * M
    cl = (child_left + off).reshape(-1)
    cr = (child_right + off).reshape(-1)
    C = torch.zeros((B, M, G), dtype=leaf_values.dtype, device=dev)
    C[:, :N] = leaf_values
    C = C.view(B * M, G)
    for nodes in levels:
        C.index_copy_(0, nodes, C.index_select(0, cl[nodes])
                      + C.index_select(0, cr[nodes]))
    return C.view(B, M, G)


def node_ages(child_left, child_right, levels, branch_length,
              sample_ages=None):
    """(B, M) node ages from branch lengths, ``Tree.coordinates`` of every
    tree of the batch (the older of the two children's ages plus their
    branch lengths, level by level; float64 in, the same bits out)."""
    B, M = child_left.shape
    N = (M + 1) // 2
    dev = child_left.device
    off = torch.arange(B, device=dev)[:, None] * M
    cl = (child_left + off).reshape(-1)
    cr = (child_right + off).reshape(-1)
    bl = branch_length.reshape(-1)
    t = torch.zeros((B, M), dtype=branch_length.dtype, device=dev)
    if sample_ages is not None:
        t[:, :N] = torch.as_tensor(sample_ages, dtype=t.dtype, device=dev)
    t = t.view(-1)
    for nodes in levels:
        a, b = cl[nodes], cr[nodes]
        t.index_copy_(0, nodes, torch.maximum(t[a] + bl[a], t[b] + bl[b]))
    return t.view(B, M)


def tree_depths_dev(parent):
    """(B, M) node depths below the root from (B, M) int64 parent arrays:
    ceil(log2(M))+1 pointer-doubling rounds of gathers."""
    B, M = parent.shape
    d = (parent >= 0).to(torch.int64)
    iota = torch.arange(M, device=parent.device).expand(B, M)
    j = torch.where(parent >= 0, parent, iota)
    for _ in range(int(np.ceil(np.log2(max(M, 2)))) + 1):
        d = d + torch.gather(d, 1, j)
        j = torch.gather(j, 1, j)
    return d


def tree_depths(parent: np.ndarray) -> np.ndarray:
    """Host twin of :func:`tree_depths_dev` (pointer doubling until
    nothing changes)."""
    parent = np.asarray(parent)
    d = (parent >= 0).astype(np.int32)
    j = np.maximum(parent, 0).astype(np.int64)
    root_mask = parent < 0
    j[root_mask] = np.broadcast_to(
        np.arange(parent.shape[1]), parent.shape)[root_mask]
    while True:
        d2 = d + np.take_along_axis(d, j, axis=1)
        if np.array_equal(d2, d):
            return d
        d = d2
        j = np.take_along_axis(j, j, axis=1)


def device_init_state(parent, N: int, tie, depth=None):
    """Initial ChainState built on the device (contemporary samples).

    The initial sorted order is (leaves first, then internal nodes by
    DESCENDING root-depth with the random tie-break ``tie``, (B, M)
    uniforms in [0, 0.99)): any such order is a linear extension (a parent
    is strictly shallower than its children). Initial ages follow the
    coalescent-prior profile per sorted position (InitializeBranchLengths,
    branch_length_estimator.cpp:61-136). Returns (state, depth)."""
    B, M = parent.shape
    dev = parent.device
    if depth is None:
        depth = tree_depths_dev(parent)
    iota = torch.arange(M, device=dev)[None, :]
    keys = torch.where(iota < N,
                       torch.full((), -float(M + 1) + 0.5, device=dev),
                       -(depth.to(torch.float32)) + tie)
    # stable: the leaves share one key and keep their index order
    sidx = torch.sort(keys, dim=1, stable=True).indices
    # lineages entering the p-th sorted event: N at the first coalescence,
    # then 2N-p (p = N+1..M-1)
    nl_int = np.concatenate([[N], 2 * N - np.arange(N + 1, M)]).astype(
        np.float64)
    cur = np.zeros(M, dtype=np.float64)
    cur[N:] = np.cumsum(2.0 / (nl_int * (nl_int - 1.0)))
    csvals = torch.from_numpy(cur.astype(np.float32)).to(dev).expand(B, M)
    pos = iota.expand(B, M)
    order = torch.empty((B, M), dtype=torch.int64, device=dev)
    order.scatter_(1, sidx, pos)
    coords = torch.empty((B, M), dtype=torch.float32, device=dev)
    coords.scatter_(1, sidx, csvals)
    z = lambda dt: torch.zeros((B, M), dtype=dt, device=dev)  # noqa: E731
    state = ChainState(
        coords=coords, order=order, sorted_idx=sidx,
        cs=csvals.contiguous(), ssum=z(torch.float32),
        scomp=z(torch.float32),
        count=torch.zeros((B,), dtype=torch.float32, device=dev),
        cprop=z(torch.int32))
    return state, depth


class SweepAux(NamedTuple):
    """Loop-invariant inputs of the sweeps, computed once per batch."""
    ne_cl: torch.Tensor    # (B, M) f32 event counts of the two children
    ne_cr: torch.Tensor
    mr_cl: torch.Tensor    # (B, M) f32 mutation rates of the two children
    mr_cr: torch.Tensor
    par_idx: torch.Tensor  # (B, M) int64 parent, the root its own index
    cl_idx: torch.Tensor   # (B, M) int64 children, leaves index 0
    cr_idx: torch.Tensor
    is_root: torch.Tensor  # (B, M) bool
    is_leaf: torch.Tensor  # (B, M) bool


def sweep_aux(st: ChainStatic) -> SweepAux:
    """Child-indexed event counts and mutation rates, and the gather
    indices of a node's family. The root reads its own age as "parent age"
    and a leaf reads child ages of 0 (as the family sort of the JAX module
    delivers them)."""
    B, M = st.parent.shape
    cl = st.child_left.clamp(min=0)
    cr = st.child_right.clamp(min=0)
    is_root = st.parent < 0
    iota = torch.arange(M, device=st.parent.device).expand(B, M)
    g = torch.gather
    return SweepAux(
        ne_cl=g(st.num_events, 1, cl), ne_cr=g(st.num_events, 1, cr),
        mr_cl=g(st.mut_rate, 1, cl), mr_cr=g(st.mut_rate, 1, cr),
        par_idx=torch.where(is_root, iota, st.parent), cl_idx=cl, cr_idx=cr,
        is_root=is_root, is_leaf=st.child_left < 0)


def _shift_prev(x):
    """x at the position before (the first keeps its own value)."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def _shift_next(x):
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _family_ages(aux: SweepAux, coords):
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    page = torch.gather(coords, 1, aux.par_idx)
    cage_l = torch.where(aux.is_leaf, zero,
                         torch.gather(coords, 1, aux.cl_idx))
    cage_r = torch.where(aux.is_leaf, zero,
                         torch.gather(coords, 1, aux.cr_idx))
    return page, cage_l, cage_r


def _mut_delta(st, aux, coords, page, cage_l, cage_r, delta):
    """Mutation log-likelihood ratio of moving every node by ``delta`` with
    its family fixed; +inf / -inf where the move is degenerate / crosses a
    family member. Returns (m, tb, tbl, tbr)."""
    is_root = aux.is_root
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    tb = page - coords
    tbl = coords - cage_l
    tbr = coords - cage_r
    coeff = torch.where(is_root, -(aux.mr_cl + aux.mr_cr),
                        st.mut_rate - aux.mr_cl - aux.mr_cr)
    m = coeff * delta
    m = m + torch.where((~is_root) & (st.num_events >= 1.0),
                        st.num_events * torch.log1p(-delta / tb), zero)
    m = m + torch.where(aux.ne_cl >= 1.0,
                        aux.ne_cl * torch.log1p(delta / tbl), zero)
    m = m + torch.where(aux.ne_cr >= 1.0,
                        aux.ne_cr * torch.log1p(delta / tbr), zero)
    return m, tb, tbl, tbr


def _accumulate(s: ChainState, coords, dprop, active, accumulate):
    """Running sums, iteration count and proposal counts after a move."""
    if not accumulate:
        return s.ssum, s.scomp, s.count, s.cprop
    ssum, scomp = _kahan_add(s.ssum, s.scomp, coords)
    if active is not None:
        ssum = torch.where(active[:, None], ssum, s.ssum)
        scomp = torch.where(active[:, None], scomp, s.scomp)
        count = s.count + active.to(torch.float32)
    else:
        count = s.count + 1.0
    return ssum, scomp, count, s.cprop + dprop


def age_sweep(st: ChainStatic, s: ChainState, aux: SweepAux, phase: int,
              u1, u2, use_vp: bool, active=None, accumulate=True,
              use_ages: bool = False):
    """Parallel gap sweep: age-only MH proposals for ALL internal nodes
    whose (tree-depth parity, sorted-position parity) matches the phase
    ``(phase >> 1) & 1, phase & 1``: each internal node is proposed exactly
    once every 4 phases. ``u1``, ``u2``: (B, M) uniforms.

    The selected nodes form an independent set in the tree (equal depth
    parity excludes parent/child pairs) AND in the sorted order (equal
    position parity excludes adjacent positions), and every proposal stays
    inside the node's current sorted gap (cs[p-1], cs[p+1]): the event
    order, and hence the lineage-count profile, is invariant, so the
    posterior ratio factorizes per node and the simultaneous accept/reject
    decisions are an exact Metropolis kernel. Prior delta per node:
    (kc2[p] - kc2[p-1]) * (R(t') - R(t)) plus the event-rate term under a
    piecewise prior; the root keeps the exponential tail proposal with its
    Hastings ratio (branch_length_estimator.cpp:1841-1900). With
    ``use_ages`` the lineage profile is taken from the sorted order."""
    coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
    B, M = coords.shape
    N = (M + 1) // 2
    dev = coords.device
    is_root = aux.is_root
    node_is_internal = (torch.arange(M, device=dev) >= N)[None, :]
    sel = (node_is_internal & ((st.depth & 1) == ((phase >> 1) & 1))
           & ((order & 1) == (phase & 1)))

    page, cage_l, cage_r = _family_ages(aux, coords)
    cmax = torch.maximum(cage_l, cage_r)

    # sorted-neighbour ages and lineage weights, by node
    cs_lo = torch.gather(_shift_prev(cs), 1, order)
    cs_hi = torch.gather(_shift_next(cs), 1, order)
    if use_ages:
        kc2 = _kc2_from_sorted(sidx, N)
        kc2_p = torch.gather(kc2, 1, order)
        kc2_pm1 = torch.gather(_shift_prev(kc2), 1, order)
    else:
        kc2 = st.kc2_pos
        kc2_p = kc2[order]
        kc2_pm1 = torch.cat([kc2[:1], kc2[:-1]])[order]

    t = coords
    # non-root: symmetric uniform draw inside the sorted gap
    tnew_nr = cs_lo + u1 * (cs_hi - cs_lo)
    # root: exponential tail proposal + Hastings ratio
    tau_old = t - cmax
    posr = tau_old > 0
    lu = -torch.log(u1.clamp(min=1e-30))
    tau_new = torch.where(posr, lu * tau_old, lu)
    safe_old = tau_old.clamp(min=1e-30)
    safe_new = tau_new.clamp(min=1e-30)
    hast_r = torch.where(
        posr,
        torch.log(safe_old / safe_new) + (tau_new / safe_old
                                          - tau_old / safe_new),
        torch.log(1.0 / safe_new) + tau_new)
    tnew = torch.where(is_root, cmax + tau_new, tnew_nr)
    delta = tnew - t

    w = torch.where(is_root, -kc2_pm1, kc2_p - kc2_pm1)
    if use_vp:
        Rt, rt = _rate_integral_bm(st, t)
        Rt2, rt2 = _rate_integral_bm(st, tnew)
        pr = w * (Rt2 - Rt) + _log_rate(rt2) - _log_rate(rt)
    else:
        pr = w * delta

    mut, tb, tbl, tbr = _mut_delta(st, aux, coords, page, cage_l, cage_r,
                                   delta)
    zero = torch.zeros((), dtype=coords.dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=coords.dtype, device=dev)
    llr = pr + mut + torch.where(is_root, hast_r, zero)
    bad_inf = (tbl == 0.0) | (tbr == 0.0) | (~is_root & (tb == 0.0))
    bad_rej = ((tbl <= -delta) | (tbr <= -delta)
               | (~is_root & (tb <= delta)))
    # the root move must not cross the second-oldest event (the sweep is
    # order-preserving by construction)
    bad_rej = bad_rej | (is_root & (tnew <= cs[:, M - 2][:, None]))
    llr = torch.where(bad_inf, inf, llr)
    llr = torch.where(bad_rej, -inf, llr)
    acc = sel & (torch.log(u2) < llr)
    if active is not None:
        acc = acc & active[:, None]

    coords2 = torch.where(acc, tnew, coords)
    cs2 = torch.gather(coords2, 1, sidx)
    # gap-sweep proposals count toward the per-node cprop gate
    dprop = sel.to(torch.int32)
    if active is not None:
        dprop = dprop * active[:, None].to(torch.int32)
    ssum, scomp, count, cprop = _accumulate(s, coords2, dprop, active,
                                            accumulate)
    return ChainState(coords2, order, sidx, cs2, ssum, scomp, count, cprop)


def order_sweep(st: ChainStatic, s: ChainState, aux: SweepAux, phase: int,
                u2, active=None, accumulate=True):
    """Parallel adjacent-transposition ORDER sweep: for every sorted
    position pair (p, p+1) with p = phase (mod 8), propose exchanging the
    AGES of the two events (equivalently, swapping their order): the
    batched counterpart of the reference's ``SwitchOrder``
    (branch_length_estimator.cpp:385-583), restricted to adjacent events.
    ``u2``: (B, M) uniforms, read by position.

    Exactness of the simultaneous decisions:

    - the sorted age multiset and the per-position lineage profile are
      invariant under every swap, so the coalescent prior cancels exactly;
      only the per-branch Poisson mutation terms enter the ratio;
    - two nodes at ADJACENT sorted positions can only be poset-related as
      direct parent/child, so ``parent[u] == v`` is the complete
      order-validity check;
    - a pair's ratio involves the ages of the pair's nodes and their
      parents/children only; a pair is invalidated when any such family
      member is internal AND sits at a position of class
      ``(r - phase) mod 8 in {0, 1}`` (it could itself be swapped this
      phase). Position classes are invariant under the swaps and leaves
      never swap, so the selection predicate is measurable with respect to
      the frozen complement and the joint kernel factorizes per pair;
    - this also covers the within-pair relation: ``parent[u] == v`` puts an
      internal family member at p+1 (in class), invalidating the pair.

    The stride is 8, not 4: with stride-4 pairs half of all positions are
    swap slots and the family predicate kills nearly every pair."""
    coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
    B, M = coords.shape
    N = (M + 1) // 2
    dev = coords.device
    is_root = aux.is_root
    pos_iota = torch.arange(M, device=dev)[None, :]
    inf = torch.full((), float("inf"), dtype=coords.dtype, device=dev)

    # parent/child ages and positions, by node
    page, cage_l, cage_r = _family_ages(aux, coords)
    page_ord = torch.gather(order, 1, aux.par_idx)
    cord_l = torch.gather(order, 1, aux.cl_idx)
    cord_r = torch.gather(order, 1, aux.cr_idx)
    cs_lo = torch.gather(_shift_prev(cs), 1, order)
    cs_hi = torch.gather(_shift_next(cs), 1, order)

    # mutation llr of moving to the age one position up / down
    def mut_delta(delta):
        m, tb, tbl, tbr = _mut_delta(st, aux, coords, page, cage_l, cage_r,
                                     delta)
        bad_inf = (tbl == 0.0) | (tbr == 0.0) | (~is_root & (tb == 0.0))
        bad_rej = ((tbl <= -delta) | (tbr <= -delta)
                   | (~is_root & (tb <= delta)))
        m = torch.where(bad_inf, inf, m)
        return torch.where(bad_rej, -inf, m)

    m_up = mut_delta(cs_hi - coords)
    m_dn = mut_delta(cs_lo - coords)

    # family invalidation: internal member at an in-class position
    def touched(r):
        return ((r - phase) & 7) < 2

    fam_ok = ~(touched(page_ord) & ~is_root)
    fam_ok &= ~((st.child_left >= N) & touched(cord_l))
    fam_ok &= ~((st.child_right >= N) & touched(cord_r))
    fam_ok &= pos_iota >= N                       # internal nodes only
    # into position order
    fam_ok_p = torch.gather(fam_ok, 1, sidx)
    m_up_p = torch.gather(m_up, 1, sidx)
    m_dn_p = torch.gather(m_dn, 1, sidx)

    # pair (p, p+1), p = phase (mod 8)
    fam_ok_n = torch.cat([fam_ok_p[:, 1:],
                          torch.zeros((B, 1), dtype=torch.bool, device=dev)],
                         dim=1)
    m_dn_n = torch.cat([m_dn_p[:, 1:], -inf.expand(B, 1)], dim=1)
    sel = ((pos_iota & 7) == phase) & (pos_iota < M - 2)
    valid = sel & fam_ok_p & fam_ok_n
    llr = m_up_p + m_dn_n
    acc = valid & (torch.log(u2) < llr)
    if active is not None:
        acc = acc & active[:, None]
        valid = valid & active[:, None]
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    acc_prev = torch.cat([no, acc[:, :-1]], dim=1)

    new_sidx = torch.where(acc, _shift_next(sidx),
                           torch.where(acc_prev, _shift_prev(sidx), sidx))
    # node-major order and ages: each node takes the position, and that
    # position's age, where it now sits
    new_order = torch.empty_like(order)
    new_order.scatter_(1, new_sidx, pos_iota.expand(B, M))
    new_coords = torch.empty_like(coords)
    new_coords.scatter_(1, new_sidx, cs)

    # per-node order-proposal counts: members of valid pairs
    valid_prev = torch.cat([no, valid[:, :-1]], dim=1)
    dprop = torch.gather((valid | valid_prev).to(torch.int32), 1, new_order)
    ssum, scomp, count, cprop = _accumulate(s, new_coords, dprop, active,
                                            accumulate)
    return ChainState(new_coords, new_order, new_sidx, cs, ssum, scomp,
                      count, cprop)


def _wrap(idx, M: int):
    """An index of -1 (no parent, no child) reads the last element."""
    return torch.where(idx < 0, idx + M, idx)


def update_one_event(st: ChainStatic, s: ChainState, node_k, u1, u2,
                     use_vp: bool, use_ages: bool = False):
    """``UpdateOneEvent`` for one node per chain: node_k (B,) int64, u1/u2
    (B,) uniforms. Where ``st`` holds the pairwise-group prior (``st.F``,
    ``st.Rg``, ``st.cumIRg``), it takes the place of the per-chain rates.
    Returns (coords, order, sorted_idx, cs)."""
    use_pair = st.F is not None
    coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
    B, M = coords.shape
    N = (M + 1) // 2
    dev = coords.device
    g = torch.gather
    zero = torch.zeros((), dtype=coords.dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=coords.dtype, device=dev)

    is_root = node_k == M - 1
    nk = node_k[:, None]
    # the node, its parent and its two children in one packed (B, 4) read
    idx4 = _wrap(torch.cat([nk, g(st.parent, 1, nk), g(st.child_left, 1, nk),
                            g(st.child_right, 1, nk)], dim=1), M)
    co4 = g(coords, 1, idx4)
    or4 = g(order, 1, idx4)
    ne4 = g(st.num_events, 1, idx4)
    mr4 = g(st.mut_rate, 1, idx4)

    # --- root branch ---------------------------------------------------
    cmax = torch.maximum(co4[:, 2], co4[:, 3])
    tau_old_r = co4[:, 0] - cmax
    pos_r = tau_old_r > 0
    nlu = -torch.log(u1)
    tau_new_r = torch.where(pos_r, nlu * tau_old_r, nlu)
    delta_r = torch.where(pos_r, tau_new_r - tau_old_r, tau_new_r)
    llr_r = torch.where(
        pos_r,
        torch.log(tau_old_r / tau_new_r)
        + (tau_new_r / tau_old_r - tau_old_r / tau_new_r),
        torch.log(1.0 / tau_new_r.clamp(min=1e-30)) + tau_new_r)
    rootc = co4[:, 0]
    if use_pair:
        # the top level holds only the root's two children; its intensity
        # is their pair rate f_c1^T R f_c2 (branch_length_estimator.cpp:613)
        G = st.F.shape[2]
        fc = torch.gather(st.F, 1, idx4[:, 2:, None].expand(B, 2, G))
        t3 = torch.stack([rootc + delta_r, cmax, rootc], dim=1)
        f1, f2 = fc[:, None, 0], fc[:, None, 1]
        I3 = _bilinear(f1, _pair_IR(st, t3), f2)
        r3 = _bilinear(f1, st.Rg[_pair_epoch(st, t3)], f2)
        llr_r = llr_r + (-(I3[:, 0] - I3[:, 1]) + _log_rate(r3[:, 0])
                         + (I3[:, 2] - I3[:, 1]) - _log_rate(r3[:, 2]))
    elif use_vp:
        R3, r3 = _rate_integral_bm(
            st, torch.stack([rootc + delta_r, cmax, rootc], dim=1))
        llr_r = llr_r + (-(R3[:, 0] - R3[:, 1]) + _log_rate(r3[:, 0])
                         + (R3[:, 2] - R3[:, 1]) - _log_rate(r3[:, 2]))
    else:
        llr_r = llr_r - delta_r
    # mutation terms (children only)
    tbl = co4[:, 0] - co4[:, 2]
    tbr = co4[:, 0] - co4[:, 3]
    mut_r = (-mr4[:, 2] - mr4[:, 3]) * delta_r
    mut_r = mut_r + torch.where(ne4[:, 2] >= 1.0,
                                ne4[:, 2] * torch.log1p(delta_r / tbl), zero)
    mut_r = mut_r + torch.where(ne4[:, 3] >= 1.0,
                                ne4[:, 3] * torch.log1p(delta_r / tbr), zero)
    llr_r = llr_r + mut_r
    llr_r = torch.where((tbl == 0.0) | (tbr == 0.0), inf, llr_r)
    llr_r = torch.where((tbl <= -delta_r) | (tbr <= -delta_r), -inf, llr_r)
    acc_r = torch.log(u2) < llr_r
    pos = torch.arange(M, device=dev)[None, :]
    at_node = pos == nk
    coords_root = coords + torch.where(at_node & acc_r[:, None],
                                       delta_r[:, None], zero)
    # the root always occupies the last sorted position (it is the oldest
    # event: every node's ancestor chain ends at it)
    cs_root = cs + torch.where((pos == M - 1) & acc_r[:, None],
                               delta_r[:, None], zero)

    # --- internal branch -------------------------------------------------
    tb = co4[:, 1] - co4[:, 0]
    tau_below = torch.minimum(tbl, tbr)
    T = tau_below + tb
    delta = u1 * T - tau_below
    cnew = co4[:, 0] + delta
    k = or4[:, 0:1]
    kp = or4[:, 1:2]
    kc = torch.maximum(or4[:, 2], or4[:, 3])[:, None]
    cn = cnew[:, None]

    up_cnt = ((pos > k) & (pos < kp) & (cs < cn)).sum(dim=1, keepdim=True)
    dn_cnt = ((pos < k) & (pos > kc) & (cs > cn)).sum(dim=1, keepdim=True)
    k_new = k + up_cnt - dn_cnt

    o = order
    newo = torch.where((o > k) & (o <= k_new), o - 1,
                       torch.where((o < k) & (o >= k_new), o + 1, o))
    newo = torch.where(at_node, k_new, newo)
    # moving position k to k_new shifts the subrange between them by one
    up_region = (k_new > k) & (pos >= k) & (pos < k_new)
    dn_region = (k_new < k) & (pos > k_new) & (pos <= k)
    at_new = pos == k_new
    sorted_new = torch.where(
        at_new, nk,
        torch.where(up_region, torch.roll(sidx, -1, dims=1),
                    torch.where(dn_region, torch.roll(sidx, 1, dims=1),
                                sidx)))
    cs_new = torch.where(
        at_new, cn,
        torch.where(up_region, torch.roll(cs, -1, dims=1),
                    torch.where(dn_region, torch.roll(cs, 1, dims=1), cs)))
    coords_new = torch.where(at_node, cn, coords)

    lo = (torch.minimum(k, k_new) - 1).clamp(min=0)[:, 0]
    hi = (torch.maximum(k, k_new) + 1).clamp(max=M - 1)[:, 0]
    if use_ages:
        kc2_old = _kc2_from_sorted(sidx, N)
        kc2_new = _kc2_from_sorted(sorted_new, N)
    else:
        # contemporary samples: leaves always occupy the first N sorted
        # positions, so the lineage profile is position-static
        kc2_old = kc2_new = st.kc2_pos
    if use_pair:
        # the new and the old state evaluated together
        pr = _prior_window_pair(st, N, torch.stack([cs_new, cs]),
                                torch.stack([sorted_new, sidx]), lo, hi)
        pr_new, pr_old = pr[0], pr[1]
    elif use_vp:
        if use_ages:
            leaf_old, leaf_new = sidx < N, sorted_new < N
        else:
            leaf_old = leaf_new = pos[0] < N
        pr_new = _prior_window(st, cs_new, lo, hi, kc2_new, leaf_new)
        pr_old = _prior_window(st, cs, lo, hi, kc2_old, leaf_old)
    else:
        p = pos[:, :M - 1]
        mask = (p >= lo[:, None]) & (p < hi[:, None])
        pr_new = -torch.where(
            mask, kc2_new[..., :-1] * (cs_new[:, 1:] - cs_new[:, :-1]),
            zero).sum(dim=1)
        pr_old = -torch.where(
            mask, kc2_old[..., :-1] * (cs[:, 1:] - cs[:, :-1]),
            zero).sum(dim=1)
    llr = pr_new - pr_old
    mut = (mr4[:, 0] - mr4[:, 2] - mr4[:, 3]) * delta
    mut = mut + torch.where(ne4[:, 0] >= 1.0,
                            ne4[:, 0] * torch.log1p(-delta / tb), zero)
    mut = mut + torch.where(ne4[:, 2] >= 1.0,
                            ne4[:, 2] * torch.log1p(delta / tbl), zero)
    mut = mut + torch.where(ne4[:, 3] >= 1.0,
                            ne4[:, 3] * torch.log1p(delta / tbr), zero)
    llr = llr + mut
    llr = torch.where((tb == 0.0) | (tbl == 0.0) | (tbr == 0.0), inf, llr)
    llr = torch.where((tb <= delta) | (tbl <= -delta) | (tbr <= -delta),
                      -inf, llr)
    valid = (tau_below >= 0) & (tb >= 0)
    acc = (valid & (torch.log(u2) < llr) & ~is_root)[:, None]

    rt = is_root[:, None]
    coords_out = torch.where(rt, coords_root,
                             torch.where(acc, coords_new, coords))
    order_out = torch.where(acc, newo, order)
    sorted_out = torch.where(acc, sorted_new, sidx)
    cs_out = torch.where(rt, cs_root, torch.where(acc, cs_new, cs))
    return coords_out, order_out, sorted_out, cs_out


def switch_order(st: ChainStatic, s: ChainState, node_k, u1, u2):
    """``SwitchOrder`` for one node per chain (never the root): node_k (B,)
    int64, u1/u2 (B,) uniforms. Returns (coords, order, sorted_idx, cs)."""
    coords, order, sidx, cs = s.coords, s.order, s.sorted_idx, s.cs
    B, M = coords.shape
    N = (M + 1) // 2
    dev = coords.device
    g = torch.gather
    zero = torch.zeros((), dtype=coords.dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=coords.dtype, device=dev)

    def family(node):
        n = node[:, None]
        return _wrap(torch.cat([n, g(st.parent, 1, n),
                                g(st.child_left, 1, n),
                                g(st.child_right, 1, n)], dim=1), M)

    fam_k = family(node_k)
    ork = g(order, 1, fam_k)
    k = ork[:, 0]
    par_o = ork[:, 1]
    ch_o = torch.maximum(ork[:, 2], ork[:, 3])
    gap = par_o - ch_o
    span = (gap - 1).clamp(min=1)
    new_order = ch_o + 1 + torch.minimum(
        (u1 * span.to(torch.float32)).to(torch.int64), span - 1)
    node_swap = g(sidx, 1, new_order[:, None])[:, 0]
    valid = (gap > 2) & (node_swap >= N)
    fam_s = family(node_swap)
    ors = g(order, 1, fam_s)
    valid &= (torch.maximum(ors[:, 2], ors[:, 3]) < k) & (k < ors[:, 1])

    # all eight node ages / rates / event counts in one packed read
    idx8 = torch.cat([fam_k, fam_s], dim=1)
    co8 = g(coords, 1, idx8)
    ne8 = g(st.num_events, 1, idx8)
    mr8 = g(st.mut_rate, 1, idx8)
    delta = co8[:, 4] - co8[:, 0]

    def mut_terms(o, dlt):
        tb = co8[:, o + 1] - co8[:, o]
        tbl = co8[:, o] - co8[:, o + 2]
        tbr = co8[:, o] - co8[:, o + 3]
        m = (mr8[:, o] - mr8[:, o + 2] - mr8[:, o + 3]) * dlt
        m = m + torch.where(ne8[:, o] >= 0.0,
                            ne8[:, o] * torch.log1p(-dlt / tb), zero)
        m = m + torch.where(ne8[:, o + 3] >= 0.0,
                            ne8[:, o + 3] * torch.log1p(dlt / tbr), zero)
        m = m + torch.where(ne8[:, o + 2] >= 0.0,
                            ne8[:, o + 2] * torch.log1p(dlt / tbl), zero)
        bad_inf = (tb == 0.0) | (tbl == 0.0) | (tbr == 0.0)
        bad_rej = (tb <= dlt) | (tbl <= -dlt) | (tbr <= -dlt)
        return m, bad_inf, bad_rej

    m1, inf1, rej1 = mut_terms(0, delta)
    m2, inf2, rej2 = mut_terms(4, -delta)
    llr = m1 + m2
    llr = torch.where(inf1 | inf2, inf, llr)
    llr = torch.where(rej1 | rej2, -inf, llr)
    acc = (valid & (torch.log(u2) < llr) & (new_order != k))[:, None]

    ck = co8[:, 0:1]
    csw = co8[:, 4:5]
    nodes = torch.arange(M, device=dev)[None, :]
    is_k = nodes == node_k[:, None]
    is_sw = nodes == node_swap[:, None]
    coords2 = torch.where(acc & is_k, csw,
                          torch.where(acc & is_sw, ck, coords))
    order2 = torch.where(acc & is_k, new_order[:, None],
                         torch.where(acc & is_sw, k[:, None], order))
    at_k = nodes == k[:, None]
    at_new = nodes == new_order[:, None]
    sidx2 = torch.where(acc & at_k, node_swap[:, None],
                        torch.where(acc & at_new, node_k[:, None], sidx))
    # the two events exchange ages, so the sorted age multiset, and hence
    # cs, is invariant under SwitchOrder
    return coords2, order2, sidx2, cs


def step(st: ChainStatic, s: ChainState, do_ue: bool, un, u1s, u2s,
         use_vp: bool, accumulate: bool, active=None,
         use_ages: bool = False):
    """One single proposal per chain. ``do_ue`` is the one global coin of
    the step (True: UpdateOneEvent for every chain, False: SwitchOrder; the
    chains remain a valid 70/30 kernel mixture, the coin just is not
    independent across trees); ``un``, ``u1s``, ``u2s`` are (B,) uniforms
    (node choice and the two draws of the proposal). ``active`` (B,) bool,
    when given, freezes retired chains: their state and running sums stop
    updating (the reference converges each tree independently,
    branch_length_estimator.cpp:2983-3073). Under the pairwise group prior
    (``st.F`` set) every step is ``UpdateOneEvent``, whatever the coin
    (SwitchOrder would not cancel in the prior when the rate depends on
    which pair coalesces)."""
    B, M = s.coords.shape
    N = (M + 1) // 2
    if do_ue or st.F is not None:
        node = N + torch.clamp((un * (M - N)).to(torch.int64), max=M - N - 1)
        coords, order, sidx, cs = update_one_event(st, s, node, u1s, u2s,
                                                   use_vp, use_ages)
        dprop = (torch.arange(M, device=un.device)[None, :]
                 == node[:, None]).to(torch.int32)
    else:
        node = N + torch.clamp((un * (M - N - 1)).to(torch.int64),
                               max=M - N - 2)
        coords, order, sidx, cs = switch_order(st, s, node, u1s, u2s)
        dprop = torch.zeros_like(s.cprop)
    if active is not None:
        m = active[:, None]
        coords = torch.where(m, coords, s.coords)
        order = torch.where(m, order, s.order)
        sidx = torch.where(m, sidx, s.sorted_idx)
        cs = torch.where(m, cs, s.cs)
        dprop = dprop * m.to(torch.int32)
    ssum, scomp, count, cprop = _accumulate(s, coords, dprop, active,
                                            accumulate)
    return ChainState(coords, order, sidx, cs, ssum, scomp, count, cprop)


class IterationDraws(NamedTuple):
    """The random numbers of one iteration."""
    do_ue: bool                # the step's global coin
    un: torch.Tensor           # (B,) node choice of the single proposal
    u1s: torch.Tensor          # (B,)
    u2s: torch.Tensor          # (B,)
    age: tuple                 # ((u1, u2), (u1, u2)), each (B, M)
    order_u: torch.Tensor      # (B, M)


class Draws:
    """Default source of an iteration's random numbers: a ``torch.Generator``
    on the chains' device for the uniforms, and a host generator for the one
    coin per step (drawing the coin on the card would cost a download per
    iteration). Both are seeded from ``seed`` and owned by one ``run_mcmc``
    call.

    ``rows`` (lo, hi, B): these chains are rows lo:hi of a batch of B. A
    draw over the batch axis (``batch_axis``) then draws the whole batch's
    uniforms and keeps these rows, so a block of a batch advances its chains
    as the whole batch would (a generator gives the same numbers for one
    seed and shape on every card)."""

    def __init__(self, seed: int, device, rows=None):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
        self.host = np.random.default_rng(int(seed))
        self.rows = rows

    def uniform(self, *shape, high: float = 1.0,
                batch_axis: Optional[int] = None):
        if self.rows is not None and batch_axis is not None:
            lo, hi, B = self.rows
            full = list(shape)
            full[batch_axis] = B
            u = torch.rand(full, generator=self.gen, device=self.device,
                           dtype=torch.float32).narrow(batch_axis, lo, hi - lo)
        else:
            u = torch.rand(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)
        return u if high == 1.0 else u * high

    def iteration(self, B: int, M: int) -> IterationDraws:
        small = self.uniform(3, B, batch_axis=1)
        big = self.uniform(5, B, M, batch_axis=1)
        return IterationDraws(
            do_ue=bool(self.host.random() <= P2), un=small[0], u1s=small[1],
            u2s=small[2], age=((big[0], big[1]), (big[2], big[3])),
            order_u=big[4])


def proposals_per_iteration(N: int, M: int) -> float:
    """Nominal proposals of one iteration, used to convert the reference's
    proposal budgets (transient, convergence blocks) into iteration counts:
    1 single proposal + the two age-sweep phases' ~(M-N)/2 selected nodes +
    the order sweep's ~(M-N)/8 pair slots."""
    return 1.0 + 0.625 * (M - N)


def iteration(st: ChainStatic, aux: SweepAux, s: ChainState, i: int,
              d: IterationDraws, use_vp: bool, accumulate: bool,
              active=None, use_ages: bool = False) -> ChainState:
    """Iteration ``i``: one single proposal, then two age-sweep phases (the
    same depth parity, both position parities, so every internal node of
    that depth parity gets one age proposal) and one order-sweep phase."""
    s = step(st, s, d.do_ue, d.un, d.u1s, d.u2s, use_vp, accumulate, active,
             use_ages)
    for (u1, u2), ph in zip(d.age, (i % 4, (i % 4) ^ 1)):
        s = age_sweep(st, s, aux, ph, u1, u2, use_vp, active, accumulate,
                      use_ages)
    return order_sweep(st, s, aux, i % 8, d.order_u, active, accumulate)


PAIR_CHUNK = 16   # pair-prior iterations drawn at once (one CUDA graph)


def pair_chunk(st: ChainStatic, s: ChainState, u, accumulate: bool,
               active=None, use_ages: bool = False) -> ChainState:
    """Pair-prior iterations, one ``UpdateOneEvent`` step each, with the
    draws ``u`` (K, 3, B): the node choice and the two uniforms of step
    k."""
    for k in range(u.shape[0]):
        s = step(st, s, True, u[k, 0], u[k, 1], u[k, 2], False, accumulate,
                 active, use_ages)
    return s


class PairRunner:
    """Pair-prior iterations of one chain batch, drawn in blocks of
    ``PAIR_CHUNK`` (the last block of a call may be shorter).

    A step is some 300 small kernels issued by the host, so the chains are
    host-bound (4.1 ms an iteration at N = 512 on an H100, the card busy
    7 %). On a CUDA device a whole block is therefore captured once as a
    CUDA graph, one for each (accumulate, with or without ``active``), and
    replayed: the same kernels on the same draws, so the same chains as
    issuing them one by one, at one host call a block. The state, the
    block's draws and the active mask live in the graph's static
    buffers."""

    def __init__(self, st: ChainStatic, draws: Draws,
                 use_ages: bool = False):
        self.st, self.draws, self.use_ages = st, draws, use_ages
        self.graphs = {}

    def _graph(self, s: ChainState, accumulate: bool, active):
        key = (accumulate, active is None)
        if key not in self.graphs:
            B = s.coords.shape[0]
            u = torch.full((PAIR_CHUNK, 3, B), 0.5, device=s.coords.device)
            act = None if active is None else active.clone()
            state = ChainState(*(x.clone() for x in s))
            side = torch.cuda.Stream(s.coords.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):       # warm-up; results dropped
                pair_chunk(self.st, ChainState(*(x.clone() for x in s)), u,
                           accumulate, act, self.use_ages)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = pair_chunk(self.st, state, u, accumulate, act,
                                 self.use_ages)
                for dst, src in zip(state, out):
                    dst.copy_(src)
            self.graphs[key] = (graph, state, u, act)
        return self.graphs[key]

    def __call__(self, s: ChainState, nsteps: int, accumulate: bool,
                 active=None) -> ChainState:
        """``nsteps`` iterations from ``s``; returns the new state."""
        B = s.coords.shape[0]
        full, rest = divmod(nsteps, PAIR_CHUNK)
        if full and s.coords.is_cuda:
            graph, state, u, act = self._graph(s, accumulate, active)
            for dst, src in zip(state, s):
                dst.copy_(src)
            if act is not None:
                act.copy_(active)
            for _ in range(full):
                u.copy_(self.draws.uniform(PAIR_CHUNK, 3, B, batch_axis=2))
                graph.replay()
            s = ChainState(*(x.clone() for x in state))
        else:
            for _ in range(full):
                s = pair_chunk(self.st, s,
                               self.draws.uniform(PAIR_CHUNK, 3, B,
                                                  batch_axis=2),
                               accumulate, active, self.use_ages)
        if rest:
            s = pair_chunk(self.st, s,
                           self.draws.uniform(rest, 3, B, batch_axis=2),
                           accumulate, active, self.use_ages)
        return s


def run(st: ChainStatic, s: ChainState, draws: Draws, nsteps: int,
        use_vp: bool, accumulate: bool, active=None,
        aux: Optional[SweepAux] = None,
        use_ages: bool = False) -> ChainState:
    """``nsteps`` iterations with the draws of ``draws``, each a
    ``chains.iteration`` span, counted under ``chains.iterations``
    (``utils.trace``). The pairwise prior's iterations, one
    ``UpdateOneEvent`` step each, run through ``PairRunner`` in blocks
    (CUDA graphs on a card), neither spanned nor counted."""
    B, M = s.coords.shape
    if aux is None:
        aux = sweep_aux(st)
    for i in range(nsteps):
        with span("chains.iteration"):
            s = iteration(st, aux, s, i, draws.iteration(B, M), use_vp,
                          accumulate, active, use_ages)
    count("chains.iterations", nsteps)
    return s


def converged(st: ChainStatic, s: ChainState):
    """Per tree: every internal node proposed >= 50 times AND the
    running-average ages monotone along the tree. (B,) bool."""
    M = s.coords.shape[1]
    N = (M + 1) // 2
    count_ok = s.cprop[:, N:].min(dim=1).values >= 50
    avg = s.ssum / s.count.clamp(min=1.0)[:, None]
    pav = torch.gather(avg, 1, st.parent.clamp(min=0))
    node_ok = (avg <= pav + 1e-7) | (st.parent < 0)
    return count_ok & node_ok[:, N:].all(dim=1)


def run_to_convergence(st: ChainStatic, s: ChainState, draws: Draws,
                       transient_steps: int, block_steps: int,
                       max_rounds: int, use_vp: bool,
                       use_ages: bool = False):
    """Transient, then rounds of ``block_steps`` until every tree has
    converged or ``max_rounds`` is reached; converged chains are frozen.
    ``transient_steps``/``block_steps`` are PROPOSAL budgets in the
    reference's units, converted to iterations through
    ``proposals_per_iteration`` (one proposal an iteration under the
    pairwise prior, ``st.F`` set). One ``conv.all()`` download per round.
    Returns (state, rounds, conv)."""
    B, M = s.coords.shape
    use_pair = st.F is not None
    ppi = 1.0 if use_pair else proposals_per_iteration((M + 1) // 2, M)
    transient_iters = max(32, int(np.ceil(transient_steps / ppi)))
    block_iters = max(8, int(np.ceil(block_steps / ppi)))
    if use_pair:
        advance = PairRunner(st, draws, use_ages)
    else:
        aux = sweep_aux(st)

        def advance(s, nsteps, accumulate, active):
            return run(st, s, draws, nsteps, use_vp, accumulate, active, aux,
                       use_ages)
    s = advance(s, transient_iters, False, None)
    conv = torch.zeros(B, dtype=torch.bool, device=s.coords.device)
    rounds = 0
    while rounds < max_rounds:
        s = advance(s, block_iters, True, ~conv)
        conv = conv | converged(st, s)
        rounds += 1
        if bool(conv.all()):
            break
    return s, rounds, conv


def _initial_coords(sorted_idx: np.ndarray, N: int,
                    sample_ages=None) -> np.ndarray:
    """Coalescent-prior starting ages (InitializeBranchLengths,
    branch_length_estimator.cpp:61-136); with sample ages, lineage counts
    follow the sorted leaf/internal pattern and internal ages stack above
    the running maximum."""
    M = len(sorted_idx)
    coords = np.zeros(M, dtype=np.float64)
    if sample_ages is None:
        cur = 0.0
        for p in range(N, M):
            nl = N if p == N else 2 * N - p
            cur += 2.0 / (nl * (nl - 1.0))
            coords[sorted_idx[p]] = cur
        return coords
    coords[:N] = sample_ages
    cur = 0.0
    nl = 0
    for p in range(M):
        v = sorted_idx[p]
        if v < N:
            nl += 1
            cur = max(cur, coords[v])
        else:
            if nl >= 2:
                cur = cur + 2.0 / (nl * (nl - 1.0))
            else:
                cur = cur + 1e-6
            nl -= 1
            coords[v] = cur
    return coords


def _pseudo_order(tree: Tree, sample_ages: np.ndarray):
    """InitializeOrder (branch_length_estimator.cpp:138-212): stack an
    epsilon above each child along every leaf-to-root path, then argsort.
    Returns (sorted_idx, order), (M,) int32 each."""
    M = tree.num_nodes
    N = tree.N
    eps = 1.0 / np.log(max(N, 3)) / 10.0
    pseudo = np.zeros(M)
    pseudo[:N] = sample_ages
    for i in range(N):
        k2 = i
        while tree.parent[k2] >= 0:
            k1, k2 = k2, int(tree.parent[k2])
            if pseudo[k2] < pseudo[k1] + eps:
                pseudo[k2] = np.nextafter(pseudo[k1] + eps, np.inf)
    sorted_idx = np.lexsort((np.arange(M), pseudo)).astype(np.int32)
    order = np.empty(M, dtype=np.int32)
    order[sorted_idx] = np.arange(M)
    return sorted_idx, order


def branch_mut_rates(trees: List[Tree], dist: np.ndarray, L: int,
                     Ne: float, mu: float) -> np.ndarray:
    """mut_rate[i] = Ne*mu*(sum dist over SNP span + half edge SNPs)
    (InitializeMCMC, branch_length_estimator.cpp:214-237)."""
    S = np.zeros(L + 1, dtype=np.float64)
    np.cumsum(dist, out=S[1:])
    out = np.empty((len(trees), trees[0].num_nodes), dtype=np.float32)
    for t, tr in enumerate(trees):
        sb = tr.SNP_begin.astype(np.int64)
        se = tr.SNP_end.astype(np.int64)
        m = S[se] - S[sb]
        m = m + np.where(sb > 0, 0.5 * dist[np.maximum(sb - 1, 0)], 0.0)
        m = m + np.where(se < L - 1, 0.5 * dist[np.minimum(se, L - 1)], 0.0)
        out[t] = (Ne * mu) * m
    return out


def group_fractions(parent, child_left, child_right, memberships,
                    num_groups: int, depth=None) -> torch.Tensor:
    """(B, M, G) float32 per-node leaf group-fraction vectors of a (B, M)
    tree batch on its device (branch_length_estimator.cpp:4061-4066
    computes the equivalent node-pair means leaf-pair by leaf-pair): the
    clade-by-group counts in float64, divided by the clade size."""
    N = (parent.shape[1] + 1) // 2
    memb = torch.as_tensor(np.asarray(memberships, dtype=np.int64),
                           device=parent.device)
    eye = torch.eye(num_groups, dtype=torch.float64, device=parent.device)
    cnt = sum_over_clades(child_left, child_right,
                          clade_levels(parent, N, depth), eye[memb])
    return (cnt / cnt.sum(dim=2, keepdim=True).clamp(min=1.0)).to(
        torch.float32)


def chain_static(trees: List[Tree], dist: np.ndarray, L: int, Ne: float,
                 mu: float, epochs=None, rates=None, device=None,
                 group_R=None, memberships=None) -> ChainStatic:
    """The static arrays of one chain batch on ``device``. With
    ``epochs``/``rates`` (units of Ne generations) the piecewise prior:
    one rate per boundary; interval i = [epochs[i], epochs[i+1]), the last
    extending to infinity (.coal convention). With ``group_R`` (E, G, G)
    (same units, one matrix per epoch) and ``memberships`` (N,) the
    pairwise-group prior: ``rates`` is then ignored, the chains' rates are
    ones and their integrals zeros."""
    device = resolve_device(device)
    B = len(trees)
    N = trees[0].N
    use_pair = group_R is not None
    if use_pair:
        ep = np.asarray(epochs, dtype=np.float64)
        rt = np.ones((B, 1))
        cumR = np.zeros((B, 1))
    elif epochs is not None:
        ep = np.asarray(epochs, dtype=np.float64)
        E = len(ep)
        rt = np.broadcast_to(np.asarray(rates, dtype=np.float64), (B, E))
        cumR = np.zeros((B, E))
        cumR[:, 1:] = np.cumsum(rt[:, : E - 1] * np.diff(ep), axis=1)
    else:
        ep = np.zeros(1)
        rt = np.ones((B, 1))
        cumR = np.zeros((B, 1))
    # position-indexed C(nl,2) (contemporary samples)
    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, 2 * N - 1)])
    kc2 = nl * (nl - 1) / 2.0

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)
    parent = up(np.stack([t.parent for t in trees]), np.int64)
    cl = up(np.stack([t.child_left for t in trees]), np.int64)
    cr = up(np.stack([t.child_right for t in trees]), np.int64)
    depth = tree_depths_dev(parent)
    pair = {}
    if use_pair:
        Rgm = np.asarray(group_R, dtype=np.float64)
        E, G = Rgm.shape[0], Rgm.shape[1]
        if E != len(ep):
            raise ValueError(f"group_R has {E} epochs, epochs {len(ep)}")
        cumIR = np.zeros((E, G, G))
        cumIR[1:] = np.cumsum(Rgm[: E - 1] * np.diff(ep)[:, None, None],
                              axis=0)
        pair = dict(F=group_fractions(parent, cl, cr, memberships, G, depth),
                    Rg=up(Rgm, np.float32), cumIRg=up(cumIR, np.float32))
    return ChainStatic(
        parent=parent, child_left=cl, child_right=cr,
        num_events=up(np.stack([t.num_events for t in trees]), np.float32),
        mut_rate=up(branch_mut_rates(trees, dist, L, Ne, mu), np.float32),
        kc2_pos=up(kc2, np.float32), epochs=up(ep, np.float32),
        rates=up(rt, np.float32), cumR=up(cumR, np.float32),
        depth=depth, **pair)


def run_mcmc(trees: List[Tree], dist: np.ndarray, L: int,
             Ne: float = 3e4, mu: float = 1.25e-8, seed: int = 1,
             epochs: Optional[np.ndarray] = None,
             rates: Optional[np.ndarray] = None,
             sample_ages: Optional[np.ndarray] = None,
             group_R: Optional[np.ndarray] = None,
             memberships: Optional[np.ndarray] = None,
             max_rounds: int = 2000, max_batch: Optional[int] = None,
             device=None, mesh=None, pool=None) -> np.ndarray:
    """Estimate branch lengths for a batch of trees on ``device`` (None:
    the CUDA card).

    epochs/rates: optional piecewise coalescence-rate prior in units of Ne
    generations (epochs ascending starting at 0); constant-Ne prior if None.
    ``sample_ages``: (N,) ages of the samples in generations (ancient
    samples where not 0). group_R/memberships: the pairwise group-rate
    prior, group_R (E, G, G) rates per epoch of ``epochs`` (same Ne units)
    and memberships the (N,) group index of each haplotype
    (MCMCCoalRatesForRelate); ``rates`` is then not used. ``max_batch``
    bounds the chains advanced together (default ``chain_batch_cap``);
    larger batches run in parts with their own seeds, ``seed + 7 * (s + 1)``
    for the part that starts at tree s. ``mesh``
    (``parallel.mesh.Mesh``, the JAX function's argument): every part runs
    on the mesh's first card, which ``device`` may only repeat; cutting a
    part over four H100s, a host thread a card, took 10.5 to 13.6 times
    one card's time (PERF.md §5). With a ``pool`` (a
    ``parallel.pool.CardPool``) every part goes to its workers, one process
    a card (``chain_part``); a part keeps its seed wherever it runs, so the
    lengths are those of one device. This function never starts a pool.
    Each part adds one dict (chains, nodes, rounds, chains converged, the
    device it ran on, its seconds) under ``mcmc`` to the record of the
    ``utils.trace`` stage it runs in. Every call makes its generators from
    ``seed`` and shares none, so calls on several threads give what they
    give alone.
    Returns branch lengths (B, M) in generations, float64."""
    if (group_R is None) != (memberships is None):
        raise ValueError("group_R and memberships go together")
    device, _ = device_and_mesh(
        device, pool.mesh if pool is not None and mesh is None else mesh)
    B = len(trees)
    if max_batch is None:
        max_batch = chain_batch_cap(trees[0].num_nodes)
    starts = range(0, B, max_batch)
    seeds = [seed + 7 * (s + 1) for s in starts] if B > max_batch else [seed]
    kw = dict(Ne=Ne, mu=mu, epochs=epochs, rates=rates,
              sample_ages=sample_ages, group_R=group_R,
              memberships=memberships, max_rounds=max_rounds)
    jobs = [(chain_rows(trees[s: s + max_batch]), dist, L, sd, kw)
            for s, sd in zip(starts, seeds)]
    if pool is not None:
        pool.note_start()
        outs = pool.map(chain_part, [job + (HERE,) for job in jobs])
    else:
        outs = [chain_part(*job, device) for job in jobs]
    return np.concatenate(outs, axis=0)


# the arrays of a tree that the chains read (``chain_static``,
# ``branch_mut_rates``, ``_pseudo_order``)
CHAIN_FIELDS = ("parent", "child_left", "child_right", "num_events",
                "SNP_begin", "SNP_end")


def chain_rows(trees: List[Tree]) -> dict:
    """The arrays of ``trees`` that the chains read, each stacked to
    (B, M): what a chain part sends to a pool worker (no branch lengths)."""
    return {f: np.stack([getattr(t, f) for t in trees]) for f in CHAIN_FIELDS}


def trees_of_rows(rows: dict) -> List[Tree]:
    """The trees of ``chain_rows`` (zero branch lengths)."""
    return [Tree(**{f: rows[f][b] for f in CHAIN_FIELDS})
            for b in range(len(rows["parent"]))]


def chain_part(rows: dict, dist: np.ndarray, L: int, seed: int, kw: dict,
               device) -> np.ndarray:
    """One part of ``run_mcmc``'s chains on ``device``, the trees given as
    ``chain_rows``: run in the caller or as a ``parallel.pool.CardPool``
    task. ``kw``: the prior and ``max_rounds`` (``_run_chains``). Notes the
    part under ``mcmc``; returns its (B, M) branch lengths."""
    t0 = time.time()
    trees = trees_of_rows(rows)
    bl, rounds, conv = _run_chains(trees, dist, L, seed=seed, device=device,
                                   **kw)
    note("mcmc", dict(chains=len(trees), nodes=trees[0].num_nodes,
                      rounds=rounds, converged=conv, device=str(device),
                      wall_s=round(time.time() - t0, 3)))
    return bl


def _run_chains(trees: List[Tree], dist: np.ndarray, L: int, Ne: float,
                mu: float, seed: int, epochs, rates, sample_ages, group_R,
                memberships, max_rounds: int, device):
    """One batch of chains on ``device``. Returns (branch lengths, rounds,
    chains converged)."""
    B = len(trees)
    N = trees[0].N
    M = trees[0].num_nodes
    delta = int(max(N / 10.0, 10.0))
    use_vp = epochs is not None and group_R is None

    st = chain_static(trees, dist, L, Ne, mu, epochs, rates, device,
                      group_R, memberships)
    use_ages = sample_ages is not None and bool(
        np.any(np.asarray(sample_ages) != 0))
    if use_ages:
        # ancient samples: the reference's pseudo-age order and starting
        # ages, built on the host tree by tree
        ages_n = np.asarray(sample_ages, dtype=np.float64) / Ne
        sidx0 = np.empty((B, M), dtype=np.int32)
        order0 = np.empty((B, M), dtype=np.int32)
        coords0 = np.empty((B, M), dtype=np.float32)
        for b, tr in enumerate(trees):
            sidx0[b], order0[b] = _pseudo_order(tr, ages_n)
            coords0[b] = _initial_coords(sidx0[b], N, ages_n)
        state = init_chain_state(coords0, order0, sidx0, device)
    else:
        tie = Draws(seed ^ 0x5BF03A7, device).uniform(B, M, high=0.99)
        state, _ = device_init_state(st.parent, N, tie, st.depth)
    draws = Draws(seed, device)

    # transient + PER-TREE convergence loop: converged chains freeze (their
    # state and running sums stop updating) while the rest continue
    block_steps = max(delta, 128)
    state, rounds, conv = run_to_convergence(
        st, state, draws, 50 * delta, block_steps, max_rounds, use_vp,
        use_ages)

    # float64 host epilogue
    final_ssum = state.ssum.cpu().numpy().astype(np.float64)
    final_count = state.count.cpu().numpy().astype(np.float64)
    parent = st.parent.cpu().numpy()
    avg = final_ssum / np.maximum(final_count, 1.0)[:, None]
    pav = np.take_along_axis(avg, np.maximum(parent, 0), axis=1)
    bl = np.where(parent >= 0, Ne * (pav - avg), 0.0)
    return np.maximum(bl, 0.0), rounds, int(conv.sum().item())

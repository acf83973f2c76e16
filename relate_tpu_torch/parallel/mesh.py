"""Several cards of one host.

Counterpart of ``relate_tpu/parallel/mesh.py``. The reference distributes
with shell-level job arrays over a shared filesystem (chunks x sections,
"write per-shard matrices, sum in a finalize step" as the all-reduce;
scripts/RelateParallel/RelateParallel.sh:231-396). Here a ``Mesh`` names
the cards of one host, each once, and the work is cut along its
independent axes:

- **sections**: BuildTopology gives whole sections to the cards,
  ``windows[k::D]`` to card k, each card driven by a host thread of its own
  (``per_card``) that has entered its card before it allocates or launches;
  InferBranchLengths gives whole sections to a pool of one process a card
  (``parallel.pool.CardPool``; ``pipeline.relate``): its chains are bound by
  the host's launches, which threads of one process issue in turn;
- **reductions**: each card sums its shard and the sums are added onto the
  first card in mesh order (``reduce_sum``, ``coalescence_counts_psum``);
- the JAX package's cuts of the targets and of a chain batch stay as its
  twins here (``make_sharded_paint_fn``, ``shard_batch``, ``multichip_step``,
  ``dryrun``), while the entry points that take a mesh run those on its
  first card: ``core.painting.Painter(mesh=)`` (the sweeps; its ``shards``
  are the sections' replicas), ``core.mcmc.run_mcmc(mesh=)`` and the tools
  (``evaluate.coalrate``, ``evaluate.sampling``). None of them gained on
  four cards driven from one process (PERF.md §5).

A CUDA device appears at most once in a mesh; ``"cpu"`` may repeat, so that
the tests run 2, 3 or 8 shards on the host (the JAX package's tests use 8
virtual CPU devices for this).

Sharding rule of ``shard_batch``: a ``ChainStatic``/``ChainState`` mixes
batch-leading (B, ...) tensors with per-tree constants (``kc2_pos`` (M,),
``epochs`` (E,), ``Rg`` (E, G, G)); only tensors whose leading axis is the
batch are cut, everything else is copied to every card, so constants that
do not divide the mesh are never split.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.devmem import resolve_device


class Mesh(tuple):
    """An ordered tuple of ``torch.device``: the cards of one host, each
    named once (``"cuda:0"``, ``"cuda:1"``, ...), or ``"cpu"`` entries,
    which may repeat. The first device is where results are gathered."""

    def __new__(cls, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        seen = set()
        for d in devs:
            if d.type == "cpu":
                continue
            if d.type != "cuda":
                raise ValueError(f"a mesh holds CUDA cards or 'cpu', not {d}")
            if d.index is None:
                raise ValueError(f"name the card's index: {d} -> 'cuda:0'")
            if d.index in seen:
                raise ValueError(
                    f"{d} appears twice in the mesh: each card is named "
                    "once (only 'cpu' may repeat)")
            seen.add(d.index)
        if seen and len(seen) != len(devs):
            raise ValueError("a mesh holds either CUDA cards or 'cpu' "
                             "entries, not both")
        return super().__new__(cls, devs)

    @property
    def first(self) -> torch.device:
        return self[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self]})"


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first ``n_devices`` CUDA cards, or all of them. Raises when fewer
    are visible; never shrinks the mesh and never turns to the CPU."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n < 1 or count < n:
        raise RuntimeError(
            f"requested a {n}-card mesh but only {count} CUDA device(s) are "
            "visible. For a mesh on the host pass Mesh(['cpu'] * n) "
            "explicitly.")
    return Mesh([f"cuda:{i}" for i in range(n)])


def as_mesh(mesh) -> Optional[Mesh]:
    """``None``, or ``mesh`` (a Mesh or a sequence of devices) as a Mesh."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return Mesh(mesh)


def device_and_mesh(device, mesh):
    """(device, mesh) of an entry point: without a mesh ``device`` resolved
    (None: the CUDA card); with one, the mesh and its first device, which
    ``device`` may only repeat."""
    mesh = as_mesh(mesh)
    if mesh is None:
        return resolve_device(device), None
    if device is not None and resolve_device(device) != mesh.first:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.first}")
    return mesh.first, mesh


def blocks(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous blocks of ceil(n / parts) rows, the non-empty ones only:
    block k, (lo, hi), goes to device k of a mesh of ``parts``."""
    size = -(-n // parts) if n else 0
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)] if size \
        else []


def per_card(mesh: Mesh, fn: Callable, n: Optional[int] = None) -> list:
    """``fn(k, device)`` for the first ``n`` devices of the mesh (all by
    default), each on a host thread of its own that has entered its card
    and sees the stage record open on the caller's thread (``utils.trace``).
    Returns the results in mesh order; raises the first failure once every
    thread has ended."""
    n = len(mesh) if n is None else n
    rec = trace.open_record()

    def run(k):
        dev = mesh[k]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with trace.within(rec), ctx:
            return fn(k, dev)

    with ThreadPoolExecutor(max_workers=max(n, 1)) as pool:
        futs = [pool.submit(run, k) for k in range(n)]
    return [f.result() for f in futs]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 0):
    """The tensors of the cards joined along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def shard_batch(mesh: Mesh, tree, batch_size: int) -> list:
    """A tensor, array or NamedTuple of them (a ``ChainStatic``, a
    ``ChainState``) placed on the mesh: one copy a device. Leaves whose
    leading axis is ``batch_size`` are cut into the contiguous blocks of
    ``blocks``; every other leaf (per-tree constants such as ``kc2_pos``,
    ``epochs``, ``Rg``) is copied whole to every device. A device past the
    last block gets the batch leaves with no rows."""
    mesh = as_mesh(mesh)
    parts = blocks(batch_size, len(mesh))
    parts += [(batch_size, batch_size)] * (len(mesh) - len(parts))

    def place(x, dev, lo, hi):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(place(v, dev, lo, hi) for v in x))
        t = torch.as_tensor(x)
        if t.dim() >= 1 and t.shape[0] == batch_size:
            t = t[lo:hi]
        return t.to(dev)

    return [place(tree, dev, lo, hi)
            for dev, (lo, hi) in zip(mesh, parts)]


def make_sharded_paint_fn(mesh: Mesh, model):
    """The painting forward sweep (B1) with the target axis cut over the
    mesh and the panel copied to every card. Returns a function of the plan
    arrays (G (L, N), idx, seqk, pfac, nxt (B, Dmax), D (B,), kmask,
    alpha0 (B, N); tensors or arrays) giving (alphas (Dmax, B, N), logscales
    (Dmax, B)) joined on the mesh's first device."""
    from ..core.painting import mismatch_rows
    from ..ops import paint_kernels
    mesh = as_mesh(mesh)
    theta = float(model.theta)

    def fn(G, idx, seqk, pfac, nxt, D, kmask, alpha0):
        B = int(np.shape(idx)[0])
        parts = blocks(B, len(mesh))
        G = torch.as_tensor(np.asarray(G, dtype=np.uint8))

        def run(k, dev):
            lo, hi = parts[k]

            def t(a, dt):
                return torch.as_tensor(a)[lo:hi].to(
                    device=dev, dtype=dt).contiguous()
            Gd = G.to(dev)
            mism = mismatch_rows(Gd, t(idx, torch.int64),
                                 t(seqk, torch.uint8))
            return paint_kernels.fwd(
                t(D, torch.int32), t(alpha0, torch.float32),
                t(kmask, torch.float32), mism, t(pfac, torch.float32),
                t(nxt, torch.float32), theta=theta)

        outs = per_card(mesh, run, len(parts))
        return (gather([o[0] for o in outs], mesh.first, dim=1),
                gather([o[1] for o in outs], mesh.first, dim=1))

    return fn


def _epoch_counts(ages: torch.Tensor, epochs: torch.Tensor) -> torch.Tensor:
    """(E,) float32 counts of the ages in each epoch [epochs[e],
    epochs[e+1]); ages below epochs[0] are not counted."""
    E = epochs.shape[0]
    e = torch.searchsorted(epochs, ages.reshape(-1).contiguous(),
                           right=True) - 1
    return torch.bincount(e[e >= 0], minlength=E).to(torch.float32)


def reduce_sum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of one tensor a device (the first ``len(parts)`` devices of
    the mesh) onto the mesh's first device: each part copied there and
    added in mesh order, so the result is the same between calls. On four
    NVIDIA H100 80GB HBM3 (700 W; ``chip_smoke.py --phases mesh``, one
    (31, 4, 2) float64 tensor a card) its first call took 40.7 ms and later
    ones 0.147 ms, where ``torch.cuda.comm.reduce_add`` took 3,453.7 ms on
    its first call (it sets up a communicator) and 0.121 ms later; at
    (31, 512, 256) 0.487 against 0.334 ms. A tool calls it a few times, so
    the first call decides."""
    out = parts[0].to(mesh.first, copy=True)
    for p in parts[1:]:
        out += p.to(mesh.first)
    return out


def coalescence_counts_psum(mesh: Mesh, ages, epochs) -> torch.Tensor:
    """Per-epoch coalescence-event counts reduced across the mesh (in place
    of the reference's filesystem sum of per-shard matrices,
    SummarizeCoalescentRateForGenome.cpp:8).

    ``ages``: (B, M) node ages (a tensor or array), cut over the mesh by
    rows; each card counts its rows. Returns the (E,) float32 counts on the
    mesh's first device."""
    mesh = as_mesh(mesh)
    ages = torch.as_tensor(ages, dtype=torch.float32)
    ep = torch.as_tensor(np.asarray(epochs, dtype=np.float32))
    parts = blocks(ages.shape[0], len(mesh))
    local = [_epoch_counts(ages[lo:hi].to(dev), ep.to(dev))
             for dev, (lo, hi) in zip(mesh, parts)]
    return reduce_sum(local, mesh)


def multichip_step(mesh: Mesh, model, paint_args, mcmc_static,
                   mcmc_state, seed: int, epochs):
    """One sharded step of the pipeline: the painting forward sweep with
    the targets cut over the mesh, one MCMC proposal with the chains cut
    over it (the uniforms of the whole batch drawn on every card from
    ``seed``, each card keeping its rows), and the coalescence counts of
    the new ages reduced across it. ``mcmc_static``/``mcmc_state`` are one
    ``ChainStatic``/``ChainState`` of the whole batch on any device.
    Returns (alphas, logscales, the new ChainState on the first device,
    counts (E,))."""
    from ..core import mcmc
    mesh = as_mesh(mesh)
    alphas, lss = make_sharded_paint_fn(mesh, model)(*paint_args)
    B = int(mcmc_state.coords.shape[0])
    parts = blocks(B, len(mesh))
    st = shard_batch(mesh, mcmc_static, B)
    s = shard_batch(mesh, mcmc_state, B)
    ep = torch.as_tensor(np.asarray(epochs, dtype=np.float32))

    def run(k, dev):
        lo, hi = parts[k]
        d = mcmc.Draws(seed, dev, rows=(lo, hi, B))
        it = d.iteration(hi - lo, int(mcmc_state.coords.shape[1]))
        s2 = mcmc.step(st[k], s[k], it.do_ue, it.un, it.u1s, it.u2s,
                       use_vp=False, accumulate=True)
        return s2, _epoch_counts(s2.coords, ep.to(dev))

    outs = per_card(mesh, run, len(parts))
    state = mcmc.ChainState(*(gather(f, mesh.first)
                              for f in zip(*(o[0] for o in outs))))
    return alphas, lss, state, reduce_sum([o[1] for o in outs], mesh)


def dryrun(n_devices: int, device=None):
    """A full sharded step on tiny shapes (16 haplotypes, 64 SNPs, two
    trees a device): builds an ``n_devices`` mesh (``default_mesh``, which
    raises rather than shrink; with ``device="cpu"`` a mesh of that many
    ``"cpu"`` entries), runs ``multichip_step`` and holds its reduced counts
    against a count of the gathered ages on the host. Returns the counts."""
    from ..core import mcmc, painting
    from ..core.treebuilder import quick_build
    mesh = (Mesh(["cpu"] * n_devices) if device == "cpu"
            else default_mesh(n_devices))
    host = torch.device("cpu")
    rng = np.random.default_rng(0)
    N, L = 16, 64
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    r = np.full(L, 1e-4)
    model = painting.PaintingModel(N=N, theta=0.001)
    plan = painting.build_target_plan(G, r, model, 0, L - 1)
    alpha0 = painting.initial_alpha(G, model, 0, plan.targets)
    paint_args = (G, plan.idx, plan.seqk, plan.pfac, plan.nxt, plan.D,
                  plan.kmask, alpha0)

    B = 2 * n_devices
    d = rng.random((N, N)).astype(np.float32)
    tree = quick_build(d, theta=0.01, device=host)
    for t in (tree,):
        t.num_events[:] = 0.0
        t.SNP_begin[:] = 0
        t.SNP_end[:] = L - 1
    trees = [tree] * B
    st = mcmc.chain_static(trees, np.ones(L), L, 3e4, 1e-8, device=host)
    tie = mcmc.Draws(1, host).uniform(B, tree.num_nodes, high=0.99)
    s, _ = mcmc.device_init_state(st.parent, N, tie, st.depth)

    epochs = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    alphas, lss, s2, counts = multichip_step(mesh, model, paint_args, st, s,
                                             0, epochs)
    counts_h = counts.cpu().numpy()
    if not (np.isfinite(counts_h).all() and torch.isfinite(alphas).all()
            and torch.isfinite(lss).all()):
        raise RuntimeError("dryrun: non-finite output")
    ages = s2.coords.cpu().numpy()
    e = np.searchsorted(epochs, ages.ravel(), side="right") - 1
    expect = np.bincount(e[e >= 0], minlength=len(epochs))
    if not np.array_equal(counts_h, expect.astype(np.float32)):
        raise RuntimeError(f"dryrun: reduced counts {counts_h} against "
                           f"{expect} on the host")
    return counts_h

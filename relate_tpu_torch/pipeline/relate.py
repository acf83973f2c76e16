"""The Relate pipeline: MakeChunks -> Paint -> BuildTopology ->
FindEquivalentBranches -> InferBranchLengths -> CombineSections -> Finalize,
and ``run_all`` (``Relate --mode All``).

Counterpart of ``relate_tpu/pipeline/relate.py`` (behavioural reference
``include/pipeline/Relate.cpp``). Stages communicate through the
ArtifactStore (filesystem), mirroring the reference's restartable
staged-file design; each stage is independently callable (resume = rerun a
stage). The store layout is the JAX package's, byte for byte, so either
package reads a store the other wrote.

Every entry point that computes takes ``device=None``: the CUDA card, or an
error if there is none. ``device="cpu"`` runs the plain PyTorch versions of
the kernels. No environment variable picks a code path: what the JAX package
reads from the environment is a function argument here, with its default.

PostProcess (``post_process_chunk``, ``run_all(postprocess=True)``) and
OptimizeParameters (``optimize_parameters``) run here too.

Several cards of one host (``mesh=``, a ``parallel.mesh.Mesh``):
BuildTopology gives whole sections to the cards, ``windows[k::D]`` to card
k, each card driven by a host thread of its own with its own replica of the
panel; InferBranchLengths gives whole sections to a pool of one process a
card (``parallel.pool.CardPool``, which ``run_all`` starts as it begins and
closes as it ends), the longest first. A section keeps its own seed wherever
it runs, so the artifacts are those of one card byte for byte. Paint
(``Painter(mesh=)``), FindEquivalentBranches, CombineSections, Finalize and
PostProcess run on the first card.

Several hosts (``run_all(num_hosts=, host_id=)``, the CLI's ``--num_hosts``
and ``--host_id``): one process a host, each with its own card or mesh, all
on one store that every host sees (a shared filesystem; no other channel).
Host 0 runs MakeChunks; the others wait for its ``plan.json``, which is
written last. Chunk c goes to host c mod num_hosts. Each chunk's
CombineSections writes a ``DONE`` sentinel last; every host waits for all
of them, and host 0 runs Finalize. A wait longer than ``barrier_timeout_s``
raises ``TimeoutError``. The files are one host's byte for byte.
"""
from __future__ import annotations

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..core import mcmc, painting, topology, topology_device
from ..core.branch_association import (associate_backward, associate_forward,
                                       associate_trees)
from ..core.branch_association_device import branch_association_many_device
from ..core.distance import DistanceAssembler
from ..core.mapmutation import TreeMapper
from ..core.treebuilder import quick_build
from ..core.trees import AncesTree, MarginalTree
from ..io import ancmut, chunking
from ..io import haps as hio
from ..io.chunking import ArtifactStore, MERGE_DISCARD
from ..parallel.mesh import device_and_mesh, per_card
from ..parallel.pool import HERE, CardPool
from ..utils.devmem import resolve_device
from ..utils import trace
from ..utils.trace import span, stage, summary
from .postprocess import post_process

# from this many windows on, FindEquivalentBranches streams a chunk window by
# window and run_all hands no trees from stage to stage in memory
STREAM_WINDOWS = 16
# run_all keeps a chunk's painting checkpoints in memory for BuildTopology
# while they stay below this many bytes
CP_HANDOFF_BYTES = 4e9


def make_chunks(haps_path: str, sample_path: str, map_path: str, outdir: str,
                memory_gb=None, dist_path: Optional[str] = None,
                use_transitions: bool = True,
                sample_ages_path: Optional[str] = None,
                device=None) -> chunking.ChunkPlan:
    """Parse the inputs and write the chunk/window plan and chunk arrays.
    ``memory_gb=None`` sizes the windows from the memory of ``device``."""
    device = resolve_device(device)
    with span("make_chunks"):
        data = hio.read_haps(haps_path, sample_path)
        gmap = hio.read_map(map_path)
        dist = hio.read_dist_file(dist_path, data.bp) if dist_path else None
        store = ArtifactStore(outdir)
        ages = None
        if sample_ages_path:
            ages = hio.read_sample_ages(sample_ages_path, data.N)
        return store.make_chunks(data, gmap, memory_gb, dist,
                                 use_transitions, ages, device=device)


def paint(store: ArtifactStore, c: int, theta: float = 0.001,
          rho_scale: float = 1.0, cache: Optional[dict] = None, device=None,
          mesh=None):
    """Compute and persist stepping-stone checkpoints for all windows of a
    chunk (pipeline/Paint.cpp equivalent; npz instead of RLE .bin).

    With a ``cache``, the in-memory checkpoints (device slabs where
    retained) are handed to build_topology so sections skip both the npz
    reload and the host-to-device upload. ``mesh``: the targets are cut
    over its cards; the slabs are joined on its first card."""
    device, mesh = device_and_mesh(device, mesh)
    ch = store.load_chunk(c)
    r = ch.r * rho_scale
    model = painting.PaintingModel(N=ch.N, theta=theta)
    painter = painting.Painter(ch.G, r, model, device=device, mesh=mesh)
    with span("paint.sweeps", device):
        cps = painter.paint_stepping_stones(np.asarray(ch.windows.boundaries))
    os.makedirs(store.path(f"chunk_{c}"), exist_ok=True)
    for w, cp in enumerate(cps):
        path = store.path(f"chunk_{c}", f"paint_{w}.npz")
        with span("paint.write"):
            np.savez_compressed(path, alpha=cp.alpha, ls_alpha=cp.ls_alpha,
                                bsb=cp.bsb, beta=cp.beta, ls_beta=cp.ls_beta,
                                bse=cp.bse)
        trace.wrote(path)
    if cache is not None:
        cache[("cps", c)] = cps


def load_checkpoint(store: ArtifactStore, c: int, w: int):
    z = np.load(store.path(f"chunk_{c}", f"paint_{w}.npz"))
    return painting.Checkpoint(alpha=z["alpha"], ls_alpha=z["ls_alpha"],
                               bsb=z["bsb"], beta=z["beta"],
                               ls_beta=z["ls_beta"], bse=z["bse"])


def section_seeds(seed: int, c: int, W: int) -> np.ndarray:
    """One seed per section of chunk ``c`` (placement-independent)."""
    rng = np.random.default_rng(seed + 1000003 * c)
    return rng.integers(1 << 31, size=W)


def build_topology(store: ArtifactStore, c: int, seed: int = 1,
                   theta: float = 0.001, rho_scale: float = 1.0,
                   mode: int = 1, ancestral_state: bool = True, fb: int = 0,
                   first_section: int = 0,
                   last_section: Optional[int] = None,
                   cache: Optional[dict] = None, device=None,
                   merge_seeds: Optional[dict] = None, mesh=None):
    """Build per-section tree sequences (pipeline/BuildTopology.cpp) and
    write ``trees_<w>.anc`` + ``muts_<w>.mut``.

    The device section builder (``core/topology_device.py``) serves the
    default options; an unknown ancestral allele (``ancestral_state=False``)
    or sample ages in the store go to the host builder
    (``core/topology.py``), which rebuilds on ``device`` too.
    ``merge_seeds`` optionally maps a section index to the (S+1,) int32
    tie-break seeds of the device builder's merge scans. With a ``mesh``
    the device builder gives whole sections to its cards
    (``_build_topology_sections_on_cards``); the host builder stays on the
    first card."""
    device, mesh = device_and_mesh(device, mesh)
    ch = store.load_chunk(c)
    model = painting.PaintingModel(N=ch.N, theta=theta)
    bounds = ch.windows.boundaries
    W = len(bounds) - 1
    if last_section is None:
        last_section = W - 1
    last_section = min(W - 1, last_section)
    ages = store.load_sample_ages(ch.N)
    use_device = ancestral_state and ages is None
    sec_seeds = section_seeds(seed, c, W)
    if mesh is not None and use_device:
        return _build_topology_sections_on_cards(
            store, c, ch, model, bounds, W, first_section, last_section,
            sec_seeds, mesh, rho_scale, mode, fb, ages, cache, merge_seeds)
    painter = painting.Painter(ch.G, ch.r * rho_scale, model, device=device)

    # overlap the host-bound ends of each section (checkpoint npz load,
    # .anc/.mut writes) with the next section's device build. Device work
    # stays on one stream and strictly ordered (same seeds, same outputs as
    # a serial loop).
    windows = list(range(first_section, last_section + 1))
    cps_mem = cache.pop(("cps", c), None) if cache is not None else None

    def _load_cp(w):
        if cps_mem is not None:
            return cps_mem[w]
        return load_checkpoint(store, c, w)

    @trace.carry
    def _persist(w, res):
        res.anc.sample_ages = ages
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                             res.anc)
        ancmut.get_age(res.anc, res.muts)
        ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                               res.muts)

    with ThreadPoolExecutor(max_workers=2) as pool:
        cp_futs = {w: pool.submit(_load_cp, w) for w in windows[:2]}
        write_futs = []
        for i, w in enumerate(windows):
            start = bounds[w]
            end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
            end = min(end, ch.L - 1)
            cp = cp_futs.pop(w).result()
            if i + 2 < len(windows):
                nxt = windows[i + 2]
                cp_futs[nxt] = pool.submit(_load_cp, nxt)
            if use_device:
                res = topology_device.build_topology_section_device(
                    painter, cp, ch.G, ch.rpos, ch.state, ch.bp, start, end,
                    seed=int(sec_seeds[w]), mode=mode, fb=fb,
                    merge_seeds=None if merge_seeds is None
                    else merge_seeds.get(w))
            else:
                res = topology.build_topology_section(
                    painter, cp, ch.G, ch.rpos, ch.state, ch.bp, start, end,
                    seed=int(sec_seeds[w]), mode=mode,
                    ancestral_state=ancestral_state, fb=fb,
                    sample_ages=ages)
            # free this window's device-resident checkpoint slabs now: the
            # handoff list would otherwise pin 2 x (N, N) f32 per window on
            # the card through the whole stage. Host copies were made by
            # paint()'s npz write, so dropping the device refs costs nothing.
            if cps_mem is not None and cp.a0_dev is not None:
                cp.alpha, cp.beta  # noqa: B018 - force host materialisation
                cp.a0_dev = None
                cp.be_dev = None
            if cache is not None:
                cache[("anc", c, w)] = res.anc
                cache[("muts", c, w)] = res.muts
            write_futs.append(pool.submit(_persist, w, res))
        for f in write_futs:
            f.result()


def _build_topology_sections_on_cards(store, c, ch, model, bounds, W,
                                      first_section, last_section, sec_seeds,
                                      mesh, rho_scale, mode, fb, ages, cache,
                                      merge_seeds):
    """BuildTopology with whole sections on the cards of ``mesh``: card k
    builds sections ``windows[k::D]`` one after the other, on a host thread
    of its own, with its own replica of the panel, and writes them. A
    section's checkpoint slabs are moved to its card first. Same section
    seeds as one card, so the same artifacts."""
    windows = list(range(first_section, last_section + 1))
    D = len(mesh)
    cps_mem = cache.pop(("cps", c), None) if cache is not None else None
    painter = painting.Painter(ch.G, ch.r * rho_scale, model, mesh=mesh)

    def cp_for(w, dev):
        if cps_mem is None:
            return load_checkpoint(store, c, w)
        cp = cps_mem[w]
        if cp.a0_dev is None:
            return cp
        moved = painting.Checkpoint(
            alpha=cp._alpha, beta=cp._beta, ls_alpha=cp.ls_alpha,
            ls_beta=cp.ls_beta, bsb=cp.bsb, bse=cp.bse,
            a0_dev=cp.a0_dev.to(dev), be_dev=cp.be_dev.to(dev))
        # free the first card's slabs now (paint()'s npz write made the
        # host copies): holding every window's through the stage pins 2 x
        # (N, N) f32 a window there
        cp.alpha, cp.beta  # noqa: B018 - force host materialisation
        cp.a0_dev = None
        cp.be_dev = None
        return moved

    def run(k, dev):
        for w in windows[k::D]:
            start = bounds[w]
            end = min((bounds[w + 1] - 1) if w < W - 1 else ch.L - 1,
                      ch.L - 1)
            res = topology_device.build_topology_section_device(
                painter.shards[k], cp_for(w, dev), ch.G, ch.rpos, ch.state,
                ch.bp, start, end, seed=int(sec_seeds[w]), mode=mode, fb=fb,
                merge_seeds=None if merge_seeds is None
                else merge_seeds.get(w))
            res.anc.sample_ages = ages
            ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"),
                                 res.anc)
            ancmut.get_age(res.anc, res.muts)
            ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                                   res.muts)
            if cache is not None:
                cache[("anc", c, w)] = res.anc
                cache[("muts", c, w)] = res.muts

    per_card(mesh, run, min(D, len(windows)))


def _read_section(store: ArtifactStore, c: int, w: int,
                  cache: Optional[dict]) -> AncesTree:
    if cache is not None and ("anc", c, w) in cache:
        return cache[("anc", c, w)]
    return ancmut.read_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"))


def find_equivalent_branches(store: ArtifactStore, c: int,
                             cache: Optional[dict] = None,
                             stream_windows: int = STREAM_WINDOWS,
                             device=None):
    """Associate branches across all adjacent trees of a chunk (incl. window
    boundaries) and propagate events/spans
    (pipeline/FindEquivalentBranches.cpp). The matcher runs on ``device``
    whatever the number of trees; its equivalences are those of the host
    matcher.

    ``cache``: run_all's in-memory stage handoff. Stages still WRITE every
    artifact (the resume model is unchanged) but skip re-READING what the
    previous stage just produced. A chunk of ``stream_windows`` windows or
    more is streamed window by window instead (byte-identical output)."""
    device = resolve_device(device)
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    if W >= stream_windows:
        return _find_equivalent_branches_streamed(store, c, W, device)

    ancs = [_read_section(store, c, w, cache) for w in range(W)]
    all_trees = [mt.tree for anc in ancs for mt in anc.seq]
    eqs = branch_association_many_device(all_trees, device=device)
    associate_trees(all_trees, eqs)
    with ThreadPoolExecutor(max_workers=2) as pool:
        write = trace.carry(ancmut.write_anc_bin)
        futs = [pool.submit(write, store.path(f"chunk_{c}", f"trees_{w}.anc"),
                            ancs[w]) for w in range(W)]
        for f in futs:
            f.result()
    if cache is not None:
        for w in range(W):
            cache[("anc", c, w)] = ancs[w]


def _find_equivalent_branches_streamed(store: ArtifactStore, c: int, W: int,
                                       device):
    """Streaming FindEquivalentBranches for long chunks: the in-memory path
    holds EVERY window's trees at once; here at most two windows are
    resident.

    - forward pass (window order): match each window's adjacent pairs,
      including the boundary pair with the previous window's last tree, and
      run the forward association sweep continuing through the carried
      boundary tree; write the window back (its trees now hold
      forward-accumulated events/SNP_begin) and keep only the per-window
      equivalence vectors.
    - backward pass (reverse order): re-read each window, run the backward
      sweep continuing through the carried boundary tree, write it back.

    Byte-identical to the in-memory path (the sweeps factor exactly across
    consecutive runs)."""
    def path(w):
        return store.path(f"chunk_{c}", f"trees_{w}.anc")

    eqs_by_window: List[List[np.ndarray]] = []
    prev_last = None       # last tree of the previous window
    for w in range(W):
        anc = ancmut.read_anc_bin(path(w))
        trees = [mt.tree for mt in anc.seq]
        run = ([prev_last] if prev_last is not None else []) + trees
        eqs = branch_association_many_device(run, device=device)
        associate_forward(run, eqs)
        eqs_by_window.append(eqs)
        ancmut.write_anc_bin(path(w), anc)
        prev_last = trees[-1]
    next_first = None      # first tree of the following window
    next_eq = None         # equivalence of the boundary pair
    for w in range(W - 1, -1, -1):
        anc = ancmut.read_anc_bin(path(w))
        trees = [mt.tree for mt in anc.seq]
        # a window after the first starts with its boundary pair, which
        # belongs to the run of the window before
        eqs = eqs_by_window[w][1:] if w > 0 else eqs_by_window[w]
        if next_first is not None:
            associate_backward(trees + [next_first], eqs + [next_eq])
        else:
            associate_backward(trees, eqs)
        ancmut.write_anc_bin(path(w), anc)
        next_first = trees[0]
        next_eq = eqs_by_window[w][0] if w > 0 else None


def infer_branch_lengths(store: ArtifactStore, c: int, Ne: float = 3e4,
                         mu: float = 1.25e-8, seed: int = 1,
                         epochs: Optional[np.ndarray] = None,
                         rates: Optional[np.ndarray] = None,
                         first_section: int = 0,
                         last_section: Optional[int] = None,
                         cache: Optional[dict] = None, device=None,
                         mesh=None, pool: Optional[CardPool] = None):
    """Branch-length MCMC per section (pipeline/InferBranchLengths.cpp);
    the trees of a section are one batch of chains on ``device``.

    With a ``pool`` (``parallel.pool.CardPool``), or a ``mesh`` of more
    than one device (a pool of its own for this call), whole sections go to
    the pool's workers, one process a card, the longest sections first:
    each worker reads ``trees_<w>.anc``, runs its chains and writes the
    file back; the lengths come back to update ``cache``. The stage is
    bound by the host's launches, which one process issues for one card at
    a time (PERF.md §5). A section keeps its seed wherever it runs, so the
    files are those of one card byte for byte. The stage record gets each
    section's ``mcmc`` note in window order and the pool's ``pool_start_s``
    (seconds until each worker was ready, in mesh order).

    With a coalescence-rate prior, epochs (generations) and rates
    (per-generation) are normalized by the implied average Ne = 1/mean(rate)
    into coalescent units (InferBranchLengths.cpp:86-152)."""
    device, mesh = device_and_mesh(
        device, pool.mesh if pool is not None and mesh is None else mesh)
    if pool is None and mesh is not None and len(mesh) > 1:
        with CardPool(mesh) as pool:
            return infer_branch_lengths(
                store, c, Ne=Ne, mu=mu, seed=seed, epochs=epochs, rates=rates,
                first_section=first_section, last_section=last_section,
                cache=cache, device=device, mesh=mesh, pool=pool)
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    if last_section is None:
        last_section = W - 1
    if epochs is not None:
        rts = np.asarray(rates, dtype=np.float64)
        pos = rts[np.isfinite(rts) & (rts > 0)]
        avg_ne = 1.0 / pos.mean()
        Ne = avg_ne
        rates = rts * avg_ne
        epochs = np.asarray(epochs, dtype=np.float64) / avg_ne
    ages = store.load_sample_ages(ch.N)
    windows = list(range(first_section, last_section + 1))
    dist64 = ch.dist.astype(np.float64)

    def seed_of(w):
        return seed + 7919 * (c + 1) + w

    if pool is not None:
        pool.note_start()
        # FindEquivalentBranches has written every trees_<w>.anc by now (its
        # writes end before it returns); each is then written by one worker
        bounds = np.append(ch.windows.boundaries[:W], ch.L)
        jobs = [(store.path(f"chunk_{c}", f"trees_{w}.anc"), dist64, ch.L, Ne,
                 mu, seed_of(w), epochs, rates, ages, HERE) for w in windows]
        longest = sorted(range(len(windows)),
                         key=lambda i: bounds[windows[i]]
                         - bounds[windows[i] + 1])
        lengths = pool.map(section_branch_lengths, jobs, order=longest)
        if cache is not None:
            for w, bl in zip(windows, lengths):
                if ("anc", c, w) in cache:
                    _set_lengths(cache[("anc", c, w)], bl)
        return

    # overlap the per-section .anc reads/writes with the chain batches of
    # neighbouring sections
    with ThreadPoolExecutor(max_workers=2) as ex:
        read_futs = {w: ex.submit(_read_section, store, c, w, cache)
                     for w in windows[:2]}
        write_futs = []
        for i, w in enumerate(windows):
            anc = read_futs.pop(w).result()
            if i + 2 < len(windows):
                nxt = windows[i + 2]
                read_futs[nxt] = ex.submit(_read_section, store, c, nxt,
                                           cache)
            _set_lengths(anc, _chains(anc, dist64, ch.L, Ne, mu, seed_of(w),
                                      epochs, rates, ages, device))
            if cache is not None:
                cache[("anc", c, w)] = anc
            write_futs.append(ex.submit(
                trace.carry(ancmut.write_anc_bin),
                store.path(f"chunk_{c}", f"trees_{w}.anc"), anc))
        for f in write_futs:
            f.result()


def _chains(anc: AncesTree, dist, L, Ne, mu, seed, epochs, rates, ages,
            device) -> np.ndarray:
    """The (trees, nodes) branch lengths of one section's chains."""
    return mcmc.run_mcmc([mt.tree for mt in anc.seq], dist, L, Ne=Ne, mu=mu,
                         seed=seed, epochs=epochs, rates=rates,
                         sample_ages=ages, device=device)


def _set_lengths(anc: AncesTree, bl: np.ndarray) -> None:
    for k, mt in enumerate(anc.seq):
        mt.tree.branch_length = bl[k]


def section_branch_lengths(path: str, dist, L, Ne, mu, seed, epochs, rates,
                           ages, device) -> np.ndarray:
    """InferBranchLengths of one section as a task of a
    ``parallel.pool.CardPool`` worker: reads the section's ``.anc`` at
    ``path``, runs its chains on ``device`` and writes the file with their
    lengths. Returns the (trees, nodes) lengths."""
    anc = ancmut.read_anc_bin(path)
    bl = _chains(anc, dist, L, Ne, mu, seed, epochs, rates, ages, device)
    _set_lengths(anc, bl)
    ancmut.write_anc_bin(path, anc)
    return bl


def combine_sections(store: ArtifactStore, c: int,
                     cache: Optional[dict] = None):
    """Splice per-section tree sequences + fill mutation ages
    (pipeline/CombineSections.cpp). Host only."""
    ch = store.load_chunk(c)
    W = ch.windows.num_windows
    seq: List[MarginalTree] = []
    muts = []
    ages = None
    for w in range(W):
        anc = _read_section(store, c, w, cache)
        ages = anc.sample_ages
        if cache is not None and ("muts", c, w) in cache:
            mshort = cache[("muts", c, w)]
        else:
            mshort = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                      f"muts_{w}.mut"))
        off = len(seq)
        for m in mshort:
            m.tree += off
        seq.extend(anc.seq)
        muts.extend(mshort)
    anc = AncesTree(N=ch.N, seq=seq, sample_ages=ages)
    ancmut.get_age(anc, muts)
    if cache is not None:
        cache[("combined", c)] = (anc, muts)
    ancmut.write_anc_bin(store.path(f"chunk_{c}", "combined.anc"), anc)
    ancmut.write_mut_short(store.path(f"chunk_{c}", "combined.mut"), muts)
    # completion sentinel: written last, after BOTH combined artifacts are
    # atomically in place
    with ancmut.atomic_write(store.path(f"chunk_{c}", "DONE")) as f:
        f.write("ok\n")


def post_process_chunk(store: ArtifactStore, c: int, seed: int = 1,
                       randomise: bool = False, device=None) -> int:
    """Topology post-processing of a chunk's sections on ``device``
    (pipeline/PostProcess.cpp:311,980): NNI-refine unsupported branches
    against the local carrier sets and map every SNP again; the caller then
    runs find_equivalent_branches again (Relate.cpp:276-279 re-associates
    after PostProcess inside --mode All). Returns the rearranged nodes.

    A window's records are its own SNPs only (``muts_<w>.mut`` holds
    end - start + 1 of them): each window is post-processed with its first
    SNP, so that record i is mapped with the genotypes of SNP start + i and
    the window's last tree ends at the window's last SNP. (The JAX package's
    ``post_process_chunk`` passes no such offset, so from window 1 on it
    maps each record with the genotypes of the SNP ``start`` rows
    earlier.)"""
    device = resolve_device(device)
    ch = store.load_chunk(c)
    total = 0
    for w, start in enumerate(ch.windows.boundaries[:-1]):
        anc = ancmut.read_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"))
        muts = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                f"muts_{w}.mut"))
        total += post_process(anc, muts, ch.G, ch.bp, seed=seed + w,
                              randomise=randomise, first_snp=int(start),
                              device=device)
        ancmut.write_anc_bin(store.path(f"chunk_{c}", f"trees_{w}.anc"), anc)
        ancmut.get_age(anc, muts)
        ancmut.write_mut_short(store.path(f"chunk_{c}", f"muts_{w}.mut"),
                               muts)
    return total


def _read_annot(path: str):
    """Read a .annot file: header line + one row per SNP
    (Finalize.cpp:61-84 joins these onto the final .mut)."""
    with hio.smart_open(path) as f:
        header = f.readline().rstrip("\n")
        rows = [line.rstrip("\n") for line in f]
    return header, rows


def finalize(store: ArtifactStore, output: str, cleanup: bool = False,
             annot_path: Optional[str] = None,
             cache: Optional[dict] = None):
    """Merge chunks dropping half-overlaps, write final text .anc/.mut
    (pipeline/Finalize.cpp:107-290). With ``annot_path``, each kept SNP's
    annotation row is appended to its .mut line and the annot header to the
    .mut header (Finalize.cpp:98-183). Host only."""
    plan, _ = store.load_plan()
    props = np.load(store.path("props.npz"), allow_pickle=False)
    rsid = props["rsid"]
    anc_al = props["ancestral"]
    alt_al = props["alternative"]
    bp = props["bp"]
    dist = props["dist"]

    annot_header = None
    annot_rows = None
    if annot_path:
        annot_header, annot_rows = _read_annot(annot_path)

    mut_rows: List[str] = []
    out_trees: List[MarginalTree] = []
    num_trees_cum = 0
    num_flips = 0
    num_non_mapping = 0
    sample_ages = None

    for c in range(plan.num_chunks):
        start_chunk = plan.start[c]
        end_chunk = plan.end[c]
        if cache is not None and ("combined", c) in cache:
            anc, muts = cache[("combined", c)]
        else:
            anc = ancmut.read_anc_bin(store.path(f"chunk_{c}",
                                                 "combined.anc"))
            muts = ancmut.read_mut_short(store.path(f"chunk_{c}",
                                                    "combined.mut"))
        sample_ages = anc.sample_ages
        ov = MERGE_DISCARD if c > 0 else 0
        if plan.num_chunks > 1 and c + 1 != plan.num_chunks:
            keep_end = end_chunk - MERGE_DISCARD
        else:
            keep_end = end_chunk

        # ---- mutations -----------------------------------------------
        first_tree = None
        for local in range(ov, keep_end - start_chunk):
            snp = start_chunk + local
            m = muts[local]
            if first_tree is None:
                first_tree = m.tree
            if m.is_not_mapping:
                num_non_mapping += 1
            if m.flipped:
                num_flips += 1
            tree_out = m.tree - first_tree + num_trees_cum
            br = " ".join(str(b) for b in m.branch)
            row = (
                f"{snp};{bp[snp]};{dist[snp]};{rsid[snp]};{tree_out};{br};"
                f"{1 if m.is_not_mapping else 0};{int(m.flipped)};"
                f"{ancmut._fmt_g(m.age_begin)};{ancmut._fmt_g(m.age_end)};"
                f"{anc_al[snp]}/{alt_al[snp]};")
            if annot_rows is not None and snp < len(annot_rows):
                row += annot_rows[snp]
            mut_rows.append(row)

        # ---- trees ---------------------------------------------------
        seq = list(anc.seq)
        if c > 0:
            # drop leading trees fully inside the discarded overlap
            while len(seq) > 1 and seq[1].pos <= MERGE_DISCARD:
                seq.pop(0)
            seq[0] = MarginalTree(pos=MERGE_DISCARD + start_chunk,
                                  tree=seq[0].tree)
        else:
            seq[0] = MarginalTree(pos=start_chunk + seq[0].pos,
                                  tree=seq[0].tree)
        kept = [seq[0]]
        for mt in seq[1:]:
            pos = mt.pos + start_chunk
            if pos < keep_end:
                kept.append(MarginalTree(pos=pos, tree=mt.tree))
        for mt in kept:
            mt.tree.SNP_begin[:] = mt.tree.SNP_begin + start_chunk
            mt.tree.SNP_end[:] = mt.tree.SNP_end + start_chunk
        out_trees.extend(kept)
        num_trees_cum += len(kept)

    final = AncesTree(N=plan.N, seq=out_trees, sample_ages=sample_ages)
    ancmut.write_anc_text(output + ".anc", final)
    ancmut.write_mut_final(output + ".mut", mut_rows,
                           extra_header=annot_header or "")
    if cleanup:
        shutil.rmtree(store.outdir, ignore_errors=True)
    return num_non_mapping, num_flips


def run_all(haps_path: str, sample_path: str, map_path: str, output: str,
            Ne: float = 3e4, mu: float = 1.25e-8, seed: int = 1,
            memory_gb=None, theta: float = 0.001,
            dist_path: Optional[str] = None, use_transitions: bool = True,
            sample_ages_path: Optional[str] = None,
            coal: Optional[tuple] = None, cleanup: bool = True,
            verbose: bool = True, rho_scale: float = 1.0,
            postprocess: bool = False, annot_path: Optional[str] = None,
            threads: int = 1, stream_windows: int = STREAM_WINDOWS,
            cp_handoff_bytes: float = CP_HANDOFF_BYTES, device=None,
            mesh=None, num_hosts: int = 1, host_id: int = 0,
            barrier_timeout_s: float = 86400.0):
    """Relate --mode All (pipeline/Relate.cpp:257-287) on ``device`` (None:
    the CUDA card), or on the cards of ``mesh`` (``parallel.mesh.Mesh``,
    e.g. ``default_mesh(4)``): BuildTopology gives them whole sections, a
    host thread a card, InferBranchLengths whole sections, a process a card
    (a ``parallel.pool.CardPool`` of the mesh, started here so that its
    workers' start overlaps the earlier stages, and closed on the way out,
    also after a failure), and the other stages run on the first card. The
    ``.anc``/``.mut`` are those of ``device=mesh[0]`` byte for byte, also
    with ``threads`` (the chunks' threads share the pool, one stage at a
    time). Each stage record gives the peak memory of every card of the
    mesh (``dev_peak_mb_by_card``, with the pool workers'); with
    ``threads`` > 1 the chunks' stages overlap and share the cards' peak
    counters (each stage resets them), so a record's peaks are not its
    stage's alone.

    ``sample_ages_path`` names a file of the haplotypes' ages in
    generations (ancient samples), which BuildTopology (through the host
    builder) and the MCMC take from the store. ``rho_scale`` applies the
    reference's ``--painting theta,rho`` override (Paint.cpp:38-61) to both
    Paint and BuildTopology; ``annot_path`` joins
    annotations into the final .mut (Finalize.cpp:98-183); ``coal`` is an
    (epochs, rates) prior for the branch lengths; ``threads`` runs that many
    chunks at a time (their host-bound stages overlap with other chunks'
    device work; the output is byte-identical to the sequential order).
    ``stream_windows`` and ``cp_handoff_bytes`` bound what is handed from
    stage to stage in memory. Each chunk's ``infer_branch_lengths`` record in
    ``utils.trace.STAGES`` carries the MCMC's rounds to convergence.
    ``postprocess`` inserts PostProcess and a second FindEquivalentBranches
    after the first (Relate.cpp:276-279; stages ``chunk<c>.post_process``
    and ``chunk<c>.find_equivalent_branches.post``).

    ``num_hosts`` > 1: this process is host ``host_id`` of that many, each
    called with the same arguments and ``output`` on one shared store (the
    module docstring). Host 0 plans the chunks; another host waits for the
    plan, runs its chunks (c mod num_hosts == host_id) and returns once
    every chunk is done, or once ``output``.anc exists (host 0 may have
    finalized and removed the store); host 0 waits for every chunk and
    finalizes. A wait longer than ``barrier_timeout_s`` seconds raises
    ``TimeoutError``."""
    device, mesh = device_and_mesh(device, mesh)
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} is not in [0, {num_hosts})")
    # with several devices the chains run one process a card
    # (infer_branch_lengths); the workers start now, behind MakeChunks,
    # Paint and BuildTopology
    pool = CardPool(mesh) if mesh is not None and len(mesh) > 1 else None
    try:
        store = ArtifactStore(output + ".tmpdir")
        if host_id == 0:
            plan = make_chunks(haps_path, sample_path, map_path, store.outdir,
                               memory_gb, dist_path, use_transitions,
                               sample_ages_path, device=device)
        else:
            # plan.json is written atomically and last: once it is there, so
            # is every chunk's input
            _wait_for(lambda: os.path.exists(store.path("plan.json")),
                      barrier_timeout_s,
                      f"host {host_id}: {store.path('plan.json')} did not "
                      f"appear within {barrier_timeout_s} s: did host 0 "
                      "fail?")
            plan = store.load_plan()[0]
        if verbose:
            print(f"[relate] N={plan.N} L={plan.L} chunks={plan.num_chunks}")
        epochs = rates = None
        if coal is not None:
            epochs, rates = coal

        # run-level handoff for Finalize's combined-artifact reads, bounded:
        # only kept for small chunk counts (each entry holds a whole chunk's
        # trees in memory; with many chunks finalize re-reads)
        fin_cache: Optional[dict] = {} if plan.num_chunks <= 2 else None
        _, wplans_all = store.load_plan()

        def _process_chunk(c: int):
            # in-memory stage handoff: every artifact is still written (the
            # resume model is unchanged) but the next stage skips re-reading
            # what the previous stage just produced in this process. Long
            # chunks skip the handoff so that peak memory stays bounded at
            # about two windows (FindEquivalentBranches then streams).
            W_c = wplans_all[c].num_windows
            if W_c >= stream_windows:
                cache = None
            else:
                cache = {} if fin_cache is None else fin_cache
            # the paint -> build checkpoint handoff has its own bound:
            # re-reading and re-uploading a 2 x (N, N) checkpoint per section
            # is costly at large N, and the streaming threshold should not
            # disable it
            paint_cache = cache
            if (cache is None
                    and 2 * 4 * plan.N * plan.N * W_c <= cp_handoff_bytes):
                paint_cache = {}
            with stage(f"chunk{c}.paint", verbose, mesh):
                paint(store, c, theta, rho_scale=rho_scale, cache=paint_cache,
                      device=device, mesh=mesh)
            with stage(f"chunk{c}.build_topology", verbose, mesh):
                build_topology(store, c, seed=seed, theta=theta,
                               rho_scale=rho_scale, cache=paint_cache,
                               device=device, mesh=mesh)
            if paint_cache is not None and cache is None:
                paint_cache.clear()
            with stage(f"chunk{c}.find_equivalent_branches", verbose, mesh):
                find_equivalent_branches(store, c, cache=cache,
                                         stream_windows=stream_windows,
                                         device=device)
            if postprocess:
                # post_process_chunk works on the files: this chunk's trees and
                # records in the handoff are stale after it, and the second
                # FindEquivalentBranches reads its output from the files
                if cache is not None:
                    for k in [k for k in cache if k[0] in ("anc", "muts")
                              and k[1] == c]:
                        del cache[k]
                with stage(f"chunk{c}.post_process", verbose, mesh):
                    post_process_chunk(store, c, seed=seed, device=device)
                with stage(f"chunk{c}.find_equivalent_branches.post", verbose,
                           mesh):
                    find_equivalent_branches(store, c, cache=cache,
                                             stream_windows=stream_windows,
                                             device=device)
            with stage(f"chunk{c}.infer_branch_lengths", verbose, mesh):
                infer_branch_lengths(store, c, Ne=Ne, mu=mu, seed=seed,
                                     epochs=epochs, rates=rates, cache=cache,
                                     device=device, mesh=mesh, pool=pool)
            with stage(f"chunk{c}.combine_sections", verbose, mesh):
                combine_sections(store, c, cache=cache)

        chunks = [c for c in range(plan.num_chunks)
                  if c % num_hosts == host_id]
        if threads > 1 and len(chunks) > 1:
            with ThreadPoolExecutor(max_workers=threads) as ex:
                for _ in ex.map(_process_chunk, chunks):
                    pass
        else:
            for c in chunks:
                _process_chunk(c)
        if num_hosts > 1:
            # DONE is written after both combined artifacts are in place, so a
            # host never reads half a chunk
            def all_done():
                return ((host_id != 0 and os.path.exists(output + ".anc"))
                        or all(os.path.exists(store.path(f"chunk_{c}", "DONE"))
                               for c in range(plan.num_chunks)))
            _wait_for(all_done, barrier_timeout_s,
                      f"host {host_id}: not every chunk's DONE appeared "
                      f"within {barrier_timeout_s} s: did a host fail?")
            if host_id != 0:
                return output
        with stage("finalize", verbose, mesh):
            nnm, nfl = finalize(store, output, cleanup=cleanup,
                                annot_path=annot_path, cache=fin_cache)
        if verbose:
            print(f"[relate] Number of not mapping SNPs: {nnm}")
            print(f"[relate] Number of flipped SNPs    : {nfl}")
            summary()
        return output
    finally:
        if pool is not None:
            pool.close()


def _wait_for(ready, timeout_s: float, what: str, poll_s: float = 0.2):
    """Polls ``ready()`` until it is true; raises ``TimeoutError(what)``
    after ``timeout_s`` seconds."""
    t0 = time.time()
    while not ready():
        if time.time() - t0 > timeout_s:
            raise TimeoutError(what)
        time.sleep(poll_s)


def read_opt_grid(path: str):
    """Parse an OptimizeParameters --input grid file: line 1 = theta values
    in (0,1), line 2 = recombination factors
    (OptimizeParameters.cpp:81-113)."""
    with open(path) as f:
        thetas = [float(x) for x in f.readline().split()]
        rhos = [float(x) for x in f.readline().split()]
    for t in thetas:
        if not 0.0 < t < 1.0:
            raise ValueError("theta value has to be in (0,1)")
    return thetas, rhos


def write_opt(path: str, results):
    """Write the .opt grid-search output: one 'theta rho num_notmapping'
    line per combination (OptimizeParameters.cpp:183-189)."""
    with open(path, "w") as f:
        for theta, rho, score in results:
            f.write(f"{theta:g} {rho:g} {score:g}\n")


def optimize_parameters(store: ArtifactStore, c: int,
                        thetas=None, rho_scales=None,
                        section: int = 0, max_snps: int = 2000,
                        seed: int = 1, device=None):
    """Grid-search painting parameters on ``device``
    (pipeline/OptimizeParameters.cpp: theta in {1e-4..1e-1}, rho-scale in
    {0.001..100}, :76-77): for each combination, repaint a section and count
    the SNPs that do not map onto a tree built from the distance matrix with
    the SNP's own signal cancelled (anc_builder.cpp:821-979). Returns a list
    of (theta, rho, fraction not mapping).

    The stepping stones and the repaint are the Painter's sweeps; each
    SNP's distance matrix stays on the device, where its own signal is
    cancelled, and its tree is built there by the merge scan; the tree is
    mapped on the host."""
    device = resolve_device(device)
    if thetas is None:
        thetas = [1e-4, 1e-3, 1e-2, 1e-1]
    if rho_scales is None:
        rho_scales = [0.001, 0.1, 1.0, 10.0, 100.0]
    ch = store.load_chunk(c)
    G, L, N = ch.G, ch.L, ch.N
    bounds = ch.windows.boundaries
    start = bounds[section]
    end = min(bounds[section + 1] - 1, L - 1, start + max_snps)
    nxt = topology._next_derived_rpos(G, ch.rpos, start, end)
    rpos = np.asarray(ch.rpos, dtype=np.float64)
    car = G[start:end + 1].astype(np.uint8)
    derived = torch.from_numpy(car == 1).to(device)
    results = []
    for theta in thetas:
        # as NumPy adds a Python float to a float32 matrix
        log_ratio = np.float32(np.log(theta / (1.0 - theta)))
        for rho in rho_scales:
            model = painting.PaintingModel(N=N, theta=theta)
            painter = painting.Painter(G, ch.r * rho, model, device=device)
            cps = painter.paint_stepping_stones(np.asarray(bounds))
            paint = painter.repaint(cps[section])
            assembler = DistanceAssembler(G, rpos, nxt=nxt, nxt_start=start)
            dstate = assembler.init_state(paint.plan, start)
            nonmap = 0
            total = 0
            for snp in range(start, end + 1):
                if snp > start:
                    # carriers advance to their own row and refresh
                    # rpos_prev (anc_builder.cpp:487-495)
                    topology._advance_state(dstate, car, rpos, start, snp,
                                            snp)
                daf = int(car[snp - start].sum())
                if daf == 0 or daf == N:
                    continue
                mat = assembler.get_matrix(
                    paint, dstate, snp, is_first_or_last=(snp in (0, L - 1)))
                # cancel the current SNP's own signal
                # (anc_builder.cpp:869-881): + log(theta / (1 - theta)) from
                # each carrier to each non-carrier, then each carrier's row
                # minimum taken out
                mask = derived[snp - start]
                cross = mask[:, None] & ~mask[None, :]
                mat = torch.where(cross, mat + float(log_ratio), mat)
                mat = torch.where(mask[:, None],
                                  mat - mat.amin(dim=1, keepdim=True), mat)
                tree = quick_build(mat, theta=theta, seed=seed, device=device)
                res = TreeMapper(tree, tree.leaf_matrix())(
                    car[snp - start:snp - start + 1])
                total += 1
                if res.is_mapping[0] > 1:
                    nonmap += 1
            results.append((theta, rho, nonmap / max(total, 1)))
    return results

"""The first three Relate stages: MakeChunks -> Paint -> BuildTopology.

Counterpart of ``relate_tpu/pipeline/relate.py`` (behavioural reference
``include/pipeline/Relate.cpp``). Stages communicate through the
ArtifactStore (filesystem), mirroring the reference's restartable
staged-file design; each stage is independently callable (resume = rerun a
stage). The store layout is the JAX package's, byte for byte, so either
package reads a store the other wrote.

Every entry point takes ``device=None``: the CUDA card, or an error if there
is none. ``device="cpu"`` runs the plain PyTorch versions of the kernels.

FindEquivalentBranches, InferBranchLengths, CombineSections and Finalize
are not in this package yet.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..core import painting, topology_device
from ..io import ancmut, chunking
from ..io import haps as hio
from ..io.chunking import ArtifactStore
from ..utils.devmem import resolve_device


def make_chunks(haps_path: str, sample_path: str, map_path: str, outdir: str,
                memory_gb=None, dist_path: Optional[str] = None,
                use_transitions: bool = True,
                sample_ages_path: Optional[str] = None,
                device=None) -> chunking.ChunkPlan:
    """Parse the inputs and write the chunk/window plan and chunk arrays.
    ``memory_gb=None`` sizes the windows from the memory of ``device``."""
    device = resolve_device(device)
    data = hio.read_haps(haps_path, sample_path)
    gmap = hio.read_map(map_path)
    dist = hio.read_dist_file(dist_path, data.bp) if dist_path else None
    store = ArtifactStore(outdir)
    ages = None
    if sample_ages_path:
        ages = hio.read_sample_ages(sample_ages_path, data.N)
    return store.make_chunks(data, gmap, memory_gb, dist, use_transitions,
                             ages, device=device)


def paint(store: ArtifactStore, c: int, theta: float = 0.001,
          rho_scale: float = 1.0, cache: Optional[dict] = None, device=None):
    """Compute and persist stepping-stone checkpoints for all windows of a
    chunk (pipeline/Paint.cpp equivalent; npz instead of RLE .bin).

    With a ``cache``, the in-memory checkpoints (device slabs where
    retained) are handed to build_topology so sections skip both the npz
    reload and the host-to-device upload."""
    device = resolve_device(device)
    ch = store.load_chunk(c)
    r = ch.r * rho_scale
    model = painting.PaintingModel(N=ch.N, theta=theta)
    painter = painting.Painter(ch.G, r, model, device=device)
    cps = painter.paint_stepping_stones(np.asarray(ch.windows.boundaries))
    os.makedirs(store.path(f"chunk_{c}"), exist_ok=True)
    for w, cp in enumerate(cps):
        np.savez_compressed(store.path(f"chunk_{c}", f"paint_{w}.npz"),
                            alpha=cp.alpha, ls_alpha=cp.ls_alpha, bsb=cp.bsb,
                            beta=cp.beta, ls_beta=cp.ls_beta, bse=cp.bse)
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
                   merge_seeds: Optional[dict] = None):
    """Build per-section tree sequences (pipeline/BuildTopology.cpp) and
    write ``trees_<w>.anc`` + ``muts_<w>.mut``.

    Only the device section builder is ported: an unknown ancestral allele
    or sample ages need the host builder and raise ``NotImplementedError``.
    ``merge_seeds`` optionally maps a section index to the (S+1,) int32
    tie-break seeds of its merge scans (see ``core/topology_device.py``)."""
    device = resolve_device(device)
    ch = store.load_chunk(c)
    model = painting.PaintingModel(N=ch.N, theta=theta)
    bounds = ch.windows.boundaries
    W = len(bounds) - 1
    if last_section is None:
        last_section = W - 1
    last_section = min(W - 1, last_section)
    ages = store.load_sample_ages(ch.N)
    if not ancestral_state or ages is not None:
        raise NotImplementedError(
            "an unknown ancestral allele and sample ages go through the host "
            "topology builder, which is not ported yet")
    sec_seeds = section_seeds(seed, c, W)
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
            res = topology_device.build_topology_section_device(
                painter, cp, ch.G, ch.rpos, ch.state, ch.bp, start, end,
                seed=int(sec_seeds[w]), mode=mode, fb=fb,
                merge_seeds=None if merge_seeds is None
                else merge_seeds.get(w))
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

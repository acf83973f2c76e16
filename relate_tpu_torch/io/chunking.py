"""Chunk/window planning — the long-genome partitioning layer.

Replicates the semantics of ``Data::MakeChunks`` (``include/src/data.cpp:117-518``):

- The genome is split into memory-bounded *chunks* with a 20,000-SNP overlap
  between consecutive chunks (``data.cpp:137``); chunks are fully independent
  through painting/tree-building and merged at Finalize, which drops a
  10,000-SNP half-overlap on each side (``pipeline/Finalize.cpp:36``).
- Within a chunk, *windows* are sized by a memory model: a window closes when
  ``sum(num_derived * (N+1))`` floats exceed ``memory*1e9/4 - (2N^2+3N)``
  (``data.cpp:129,219-229``), with at most 500 windows per chunk
  (``data.cpp:134``) and at least 10 SNPs per window.

A window is the unit of device work: the window memory model bounds the
size of the painting posterior tensor that must live on the card at once.

Artifacts are stored as ``.npz`` under an output directory, mirroring the
reference's staged-file recovery model (every stage restartable from disk).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, asdict
from typing import List, Optional

import numpy as np

from ..utils import trace
from . import haps as haps_io

OVERLAP = 20000             # chunk overlap in SNPs (data.cpp:137)
MERGE_DISCARD = 10000       # SNPs dropped per side at Finalize (Finalize.cpp:36)
MAX_WINDOWS_PER_CHUNK = 500  # open-file bound in the reference (data.cpp:134)
MIN_SNPS_IN_WINDOW = 10


@dataclass
class ChunkPlan:
    """Global plan: chunk boundaries over the full chromosome."""
    N: int
    L: int
    num_chunks: int
    start: List[int]           # per-chunk section start (absolute SNP index)
    end: List[int]             # per-chunk section end (exclusive, absolute)
    actual_min_memory_gb: float

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(s: str) -> "ChunkPlan":
        return ChunkPlan(**json.loads(s))


@dataclass
class WindowPlan:
    """Per-chunk window boundaries, chunk-local SNP indices.

    boundaries[w] .. boundaries[w+1]-1 is window w; boundaries[-1] == L_chunk.
    """
    N: int
    L_chunk: int
    boundaries: List[int]

    @property
    def num_windows(self) -> int:
        return len(self.boundaries) - 1


def plan_chunks_and_windows(G: np.ndarray, memory_gb=None, device=None):
    """Compute chunk boundaries and per-chunk window boundaries.

    ``memory_gb=None`` sizes the budget from the card's memory
    (utils.devmem.auto_memory_gb) instead of the reference's fixed 5 GB
    default; on ``device="cpu"`` the caller must give ``memory_gb``.

    Follows the streaming logic of ``Data::MakeChunks``: windows accumulate
    until the memory model is exceeded; a chunk closes when the window count
    (including windows inherited from the overlap region) reaches the cap or
    ``max_chunk_size`` SNPs are consumed.

    Returns (ChunkPlan, [WindowPlan]) with window boundaries chunk-local.
    """
    L, N = G.shape
    if memory_gb is None:
        from ..utils.devmem import auto_memory_gb
        memory_gb = auto_memory_gb(device)
    min_memory_size = memory_gb * 1e9 / 4.0 - (2 * N * N + 3 * N)
    if min_memory_size <= 0:
        raise ValueError("memory allowance too small for this N")
    max_chunk_size = min(L + 1, int(min_memory_size / N))
    if memory_gb >= 100:
        max_chunk_size = 2500000

    num_derived = G.sum(axis=1).astype(np.int64)

    starts: List[int] = [0]
    ends: List[int] = []
    window_plans: List[WindowPlan] = []
    actual_min_memory = 0.0

    snp = 0
    prev_boundaries: List[int] = []  # absolute boundaries of previous chunk
    while snp < L:
        if snp > 0:
            snp_section_begin = snp - OVERLAP
            starts.append(snp_section_begin)
            # windows inherited from the overlap of the previous chunk
            overlap_bounds = [snp_section_begin] + [
                b for b in prev_boundaries if b > snp_section_begin
            ]
        else:
            snp_section_begin = 0
            overlap_bounds = []

        num_windows_overlap = len(overlap_bounds)
        snp_begin = snp
        boundaries = [snp_begin]
        window_mem = 0.0
        snps_in_window = 0
        chunk_size = 0
        # chunk_size == 0 guard: always consume >= 1 SNP per chunk, else a
        # pathological case (overlap windows alone filling the window cap)
        # would loop forever without advancing
        while (chunk_size == 0
               or (len(boundaries) + num_windows_overlap
                   < MAX_WINDOWS_PER_CHUNK
                   and chunk_size < max_chunk_size)) and snp < L:
            window_mem += float(num_derived[snp]) * (N + 1)
            if window_mem >= min_memory_size and snps_in_window > 10:
                actual_min_memory = max(actual_min_memory, window_mem)
                snps_in_window = 0
                window_mem = 0.0
                boundaries.append(snp)
            snp += 1
            snps_in_window += 1
            chunk_size += 1
        actual_min_memory = max(actual_min_memory, window_mem)
        boundaries.append(snp)
        ends.append(snp)

        all_bounds = overlap_bounds + boundaries
        local = [b - snp_section_begin for b in all_bounds]
        window_plans.append(WindowPlan(N=N, L_chunk=snp - snp_section_begin,
                                       boundaries=local))
        prev_boundaries = all_bounds[:-1]

    actual_min_memory = (actual_min_memory + 2 * N * N + 3 * N) * 4.0 / 1e9
    plan = ChunkPlan(N=N, L=L, num_chunks=len(starts), start=starts, end=ends,
                     actual_min_memory_gb=actual_min_memory)
    return plan, window_plans


@dataclass
class ChunkData:
    """In-memory view of one chunk's inputs (device-ready host arrays)."""
    chunk_index: int
    G: np.ndarray            # (L_chunk, N) uint8
    bp: np.ndarray           # (L_chunk,) int64
    dist: np.ndarray         # (L_chunk,) int64
    r: np.ndarray            # (L_chunk,) float64
    rpos: np.ndarray         # (L_chunk+1,) float64
    state: np.ndarray        # (L_chunk,) int32
    windows: WindowPlan

    @property
    def L(self):
        return self.G.shape[0]

    @property
    def N(self):
        return self.G.shape[1]


class ArtifactStore:
    """Filesystem artifact store mirroring the reference's staged files.

    Layout under ``outdir``:
      plan.json                  -- ChunkPlan + window plans + props metadata
      chunk_<c>.npz              -- genotypes/bp/dist/r/rpos/state + windows
      chunk_<c>/paint_<w>.npz    -- painting checkpoints for window w
      chunk_<c>/trees_<w>.anc    -- per-section tree sequences
      chunk_<c>/muts_<w>.mut     -- per-section mutation records
      props.npz                  -- rsid/ancestral/alternative per SNP
    """

    def __init__(self, outdir: str):
        self.outdir = outdir

    def path(self, *parts: str) -> str:
        return os.path.join(self.outdir, *parts)

    # -- creation --------------------------------------------------------
    def make_chunks(self, data: haps_io.HapsData, gmap: haps_io.GeneticMap,
                    memory_gb=None,
                    dist: Optional[np.ndarray] = None,
                    use_transitions: bool = True,
                    sample_ages: Optional[np.ndarray] = None,
                    device=None) -> "ChunkPlan":
        G = data.genotypes
        plan, wplans = plan_chunks_and_windows(G, memory_gb, device)
        os.makedirs(self.outdir, exist_ok=False)
        rpos = haps_io.interpolate_rpos(gmap, data.bp)
        r = haps_io.rates_from_rpos(rpos)
        if dist is None:
            dist = haps_io.compute_dist(data.bp)
        state = haps_io.transversion_state(data.ancestral, data.alternative,
                                           use_transitions)
        meta = {
            "plan": asdict(plan),
            "windows": [asdict(w) for w in wplans],
        }
        np.savez_compressed(
            self.path("props.npz"),
            rsid=np.asarray(data.rsid), ancestral=np.asarray(data.ancestral),
            alternative=np.asarray(data.alternative),
            chrom=np.asarray(data.chrom), bp=data.bp, dist=dist)
        trace.wrote(self.path("props.npz"))
        if sample_ages is not None:
            np.save(self.path("sample_ages.npy"), sample_ages)
            trace.wrote(self.path("sample_ages.npy"))
        for c in range(plan.num_chunks):
            s, e = plan.start[c], plan.end[c]
            np.savez_compressed(
                self.path(f"chunk_{c}.npz"),
                G=G[s:e], bp=data.bp[s:e], dist=dist[s:e], r=r[s:e],
                rpos=rpos[s:e + 1], state=state[s:e],
                boundaries=np.asarray(wplans[c].boundaries, dtype=np.int64))
            trace.wrote(self.path(f"chunk_{c}.npz"))
            os.makedirs(self.path(f"chunk_{c}"), exist_ok=True)
        # plan.json is written LAST and atomically: it doubles as the
        # "make_chunks complete" sentinel, so its existence must imply
        # every chunk artifact above is fully on disk
        tmp = self.path(f"plan.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self.path("plan.json"))
        trace.wrote(self.path("plan.json"))
        return plan

    # -- access ----------------------------------------------------------
    def load_plan(self):
        with open(self.path("plan.json")) as f:
            meta = json.load(f)
        plan = ChunkPlan(**meta["plan"])
        wplans = [WindowPlan(**w) for w in meta["windows"]]
        return plan, wplans

    def load_chunk(self, c: int) -> ChunkData:
        with trace.span("load_chunk"):
            z = np.load(self.path(f"chunk_{c}.npz"))
            wp = WindowPlan(N=int(z["G"].shape[1]),
                            L_chunk=int(z["G"].shape[0]),
                            boundaries=list(map(int, z["boundaries"])))
            return ChunkData(chunk_index=c, G=z["G"], bp=z["bp"],
                             dist=z["dist"], r=z["r"], rpos=z["rpos"],
                             state=z["state"], windows=wp)

    def load_sample_ages(self, N: int) -> Optional[np.ndarray]:
        p = self.path("sample_ages.npy")
        if os.path.exists(p):
            ages = np.load(p)
            if len(ages) == N:
                return ages
        return None


# ---------------------------------------------------------------------------
# Interop: readers for the reference's binary chunk formats, used by the
# differential test-suite to load golden artifacts produced by the C++ binary.
# ---------------------------------------------------------------------------

def read_reference_chunk(prefix: str) -> ChunkData:
    """Read ``chunk_<c>.{hap,bp,dist,r,rpos,state}`` written by the reference
    binary (formats at ``data.cpp:253-304,486-516``)."""
    import struct

    with open(prefix + ".hap", "rb") as f:
        L, N = struct.unpack("QQ", f.read(16))
        seq = np.frombuffer(f.read(L * N), dtype=np.uint8).reshape(L, N)
        G = (seq == ord("1")).astype(np.uint8)

    def read_vec(path, dtype, count_dtype="I"):
        with open(path, "rb") as f:
            n = struct.unpack(count_dtype, f.read(4))[0]
            return np.frombuffer(f.read(), dtype=dtype)[:n]

    bp = read_vec(prefix + ".bp", np.int32)
    dist = read_vec(prefix + ".dist", np.int32)
    r = read_vec(prefix + ".r", np.float64)
    rpos = read_vec(prefix + ".rpos", np.float64)
    with open(prefix + ".state", "rb") as f:
        n = struct.unpack("i", f.read(4))[0]
        state = np.frombuffer(f.read(), dtype=np.int32)[:n]
    return ChunkData(chunk_index=0, G=G, bp=bp.astype(np.int64),
                     dist=dist.astype(np.int64), r=r, rpos=rpos,
                     state=state,
                     windows=None)


def read_reference_parameters(path: str):
    """Read parameters.bin / parameters_c*.bin (``data.cpp:260-298,364-375``)."""
    import struct
    with open(path, "rb") as f:
        blob = f.read()
    N, L, n3 = struct.unpack("iii", blob[:12])
    if os.path.basename(path).startswith("parameters_c"):
        nw = n3
        bounds = struct.unpack(f"{nw}i", blob[12:12 + 4 * nw])
        return {"N": N, "L_chunk": L, "num_windows": nw - 1,
                "boundaries": list(bounds)}
    num_chunks = n3
    off = 12
    (mem,) = struct.unpack("d", blob[off:off + 8])
    off += 8
    start = struct.unpack(f"{num_chunks}i", blob[off:off + 4 * num_chunks])
    off += 4 * num_chunks
    end = struct.unpack(f"{num_chunks}i", blob[off:off + 4 * num_chunks])
    return {"N": N, "L": L, "num_chunks": num_chunks, "memory": mem,
            "start": list(start), "end": list(end)}

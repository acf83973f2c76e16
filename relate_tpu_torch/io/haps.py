"""Host-side parsers for Relate input formats.

Formats (behavioral reference, not a code port):
- ``.haps``: one line per SNP: ``chr rsid bp ancestral alternative a_1 ... a_N``
  (reference reader: ``include/src/data.hpp:110-193``, ``data.cpp:543-573``).
- ``.sample``: two header lines, then one row per individual
  ``ID_1 ID_2 missing``; diploid (2 haplotypes) if ID_1 == ID_2, else haploid
  (``data.hpp:135-143``).
- genetic map: header + ``pos rate gen_pos(cM)`` rows (``data.cpp:591-625``).
- ``.dist``: header + ``bp dist`` rows (``data.cpp:401-418``).
- ``.poplabels``: header + ``ID POP GROUP SEX`` (``include/src/sample.cpp``).
- fasta: one header line, then one sequence (``data.cpp:627-646``).

All parsers transparently handle gzip by magic-byte sniffing, like the
reference's popen-gunzip wrapper (``data.cpp:6-67``) but in-process.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def smart_open(path: str, mode: str = "rt"):
    """Open a file, transparently gunzipping if it has gzip magic bytes."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class HapsData:
    """A parsed haplotype panel.

    genotypes: (L, N) uint8 matrix, SNP-major (0 = ancestral, 1 = derived).
    """

    genotypes: np.ndarray
    bp: np.ndarray                  # (L,) int64 basepair positions
    rsid: List[str]
    ancestral: List[str]
    alternative: List[str]
    chrom: List[str]

    @property
    def L(self) -> int:
        return self.genotypes.shape[0]

    @property
    def N(self) -> int:
        return self.genotypes.shape[1]


def read_sample(path: str) -> Tuple[int, List[str]]:
    """Count haplotypes from a .sample file.

    Returns (N, ids). Two header lines are skipped; each data row contributes
    2 haplotypes if ID_1 == ID_2 (diploid) else 1 (reference semantics,
    ``data.hpp:137-143``).
    """
    n = 0
    ids: List[str] = []
    with smart_open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    for row in lines[2:]:
        id1, id2 = row[0], row[1]
        if id1 == id2:
            n += 2
            ids.extend([id1 + "_0", id1 + "_1"])
        else:
            n += 1
            ids.append(id1)
    return n, ids


def read_haps(haps_path: str, sample_path: str,
              use_native: bool = True) -> HapsData:
    """Parse a .haps(.gz) + .sample(.gz) pair into a HapsData panel.

    ``use_native=True`` parses the ``.haps`` with the native zlib library
    (``io/native.py``, built from ``csrc/relate_io.cpp`` at first use) and
    raises if it cannot be built or loaded; ``use_native=False`` takes the
    pure-Python parser. Both give the same panel."""
    N, _ = read_sample(sample_path)
    if use_native:
        from . import native
        G, bp, chroms, rsids, anc, alt = native.read_haps_rows(haps_path, N)
        return HapsData(genotypes=G, bp=bp, rsid=rsids, ancestral=anc,
                        alternative=alt, chrom=chroms)
    chroms: List[str] = []
    rsids: List[str] = []
    bps: List[int] = []
    anc: List[str] = []
    alt: List[str] = []
    rows: List[np.ndarray] = []
    with smart_open(haps_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            chroms.append(parts[0])
            rsids.append(parts[1])
            bps.append(int(parts[2]))
            anc.append(parts[3])
            alt.append(parts[4])
            alleles = parts[5:]
            if len(alleles) != N:
                raise ValueError(
                    f"SNP {parts[1]}@{parts[2]}: {len(alleles)} alleles, expected {N}"
                )
            rows.append(np.frombuffer(("".join(alleles)).encode(), dtype=np.uint8) - ord("0"))
    G = np.vstack(rows).astype(np.uint8)
    return HapsData(
        genotypes=G,
        bp=np.asarray(bps, dtype=np.int64),
        rsid=rsids,
        ancestral=anc,
        alternative=alt,
        chrom=chroms,
    )


@dataclass
class GeneticMap:
    bp: np.ndarray       # (M,) positions
    gen_pos: np.ndarray  # (M,) cumulative genetic position in cM


def read_map(path: str) -> GeneticMap:
    bps: List[float] = []
    gens: List[float] = []
    with smart_open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            bps.append(float(parts[0]))
            gens.append(float(parts[2]))
    return GeneticMap(np.asarray(bps), np.asarray(gens))


def interpolate_rpos(gmap: GeneticMap, bp: np.ndarray) -> np.ndarray:
    """Per-SNP cumulative recombination position in Morgans, replicating the
    reference's piecewise-linear interpolation (``data.cpp:442-469``).

    Returns rpos of length len(bp) + 1; the final entry duplicates the
    reference's convention of evaluating at bp[L] = bp[L-1] + 1.
    """
    L = len(bp)
    bp_ext = np.concatenate([bp, [bp[-1] + 1]])
    rpos = np.empty(L + 1, dtype=np.float64)
    mbp, mgen = gmap.bp, gmap.gen_pos
    M = len(mbp)
    map_pos = 0
    for i, b in enumerate(bp_ext):
        # replicate: first entry special-case when map starts beyond first SNP
        if i == 0 and mbp[0] > b:
            rpos[0] = mgen[0] * 1e-2
            continue
        while map_pos < M - 2 and mbp[map_pos + 1] <= b:
            map_pos += 1
        if mbp[map_pos + 1] - mbp[map_pos] == 0 or mbp[map_pos] > b:
            rpos[i] = mgen[map_pos] * 1e-2
        else:
            frac = (b - mbp[map_pos]) / (mbp[map_pos + 1] - mbp[map_pos])
            rpos[i] = (frac * (mgen[map_pos + 1] - mgen[map_pos]) + mgen[map_pos]) * 1e-2
    return rpos


R_LOWER_BOUND = 1e-10
R_SCALE = 2500.0


def rates_from_rpos(rpos: np.ndarray) -> np.ndarray:
    """Per-SNP recombination distances r[l] = 2500 * max(drpos, 1e-10)
    (``data.cpp:471-481``)."""
    r = np.diff(rpos)
    r = np.maximum(r, R_LOWER_BOUND)
    return r * R_SCALE


def compute_dist(bp: np.ndarray) -> np.ndarray:
    """Default per-SNP distance = bp gap to the next SNP, last = 1
    (``data.cpp:381-399``)."""
    d = np.empty(len(bp), dtype=np.int64)
    d[:-1] = np.diff(bp)
    if np.any(d[:-1] <= 0):
        bad = int(bp[np.nonzero(d[:-1] <= 0)[0][0]])
        raise ValueError(f"SNPs not sorted by bp (or duplicate) at {bad}")
    d[-1] = 1
    return d


def read_dist_file(path: str, bp: np.ndarray) -> np.ndarray:
    """Read a .dist file (header + 'bp dist' rows), validated against bp."""
    vals = []
    with smart_open(path) as f:
        next(f)
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                vals.append((int(parts[0]), int(parts[1])))
    if len(vals) != len(bp):
        raise ValueError("dist file length mismatch")
    arr = np.empty(len(bp), dtype=np.int64)
    for i, (b, d) in enumerate(vals):
        if b != bp[i]:
            raise ValueError(f"dist file bp mismatch at row {i}")
        arr[i] = d
    return arr


TRANSITION_PAIRS = {("C", "T"), ("T", "C"), ("G", "A"), ("A", "G")}


def transversion_state(ancestral: Sequence[str], alternative: Sequence[str],
                       use_transitions: bool = True) -> np.ndarray:
    """Per-SNP flag: use this SNP for branch-length estimation.

    With use_transitions=True (default) all SNPs are used; otherwise
    transitions (C<->T, G<->A) are flagged 0 (``data.cpp:307-341``).
    """
    L = len(ancestral)
    if use_transitions:
        return np.ones(L, dtype=np.int32)
    state = np.ones(L, dtype=np.int32)
    for i, (a, b) in enumerate(zip(ancestral, alternative)):
        if (a, b) in TRANSITION_PAIRS:
            state[i] = 0
    return state


def read_sample_ages(path: str, N: int) -> Optional[np.ndarray]:
    """Read per-haplotype sample ages; None if count mismatches N."""
    if not os.path.exists(path):
        return None
    vals: List[float] = []
    with smart_open(path) as f:
        for tok in f.read().split():
            vals.append(float(tok))
            if len(vals) == N:
                break
    if len(vals) < N:
        return None
    return np.asarray(vals[:N], dtype=np.float64)


@dataclass
class PopLabels:
    ids: List[str]
    pop: List[str]
    group: List[str]
    sex: List[str]
    groups: List[str] = field(default_factory=list)   # unique group names
    group_of_haplotype: np.ndarray = None             # (N,) int

    @property
    def num_groups(self) -> int:
        return len(self.groups)


def read_poplabels(path: str) -> PopLabels:
    """Parse .poplabels (``include/src/sample.cpp``): header + ID POP GROUP
    SEX. Each individual contributes 2 haplotypes (the reference's diploid
    Sample convention); groups are numbered in order of first appearance."""
    ids, pops, grps, sexs = [], [], [], []
    with smart_open(path) as f:
        next(f)
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ids.append(parts[0])
            pops.append(parts[1] if len(parts) > 1 else "NA")
            grps.append(parts[2] if len(parts) > 2 else "NA")
            sexs.append(parts[3] if len(parts) > 3 else "NA")
    groups = list(dict.fromkeys(grps))
    index = {g: i for i, g in enumerate(groups)}
    goh = np.repeat(np.asarray([index[g] for g in grps], dtype=np.int32), 2)
    return PopLabels(ids, pops, grps, sexs, groups, goh)


def read_fasta(path: str) -> str:
    """Read a single-sequence fasta, uppercased (``data.cpp:627-646``)."""
    seq = io.StringIO()
    with smart_open(path) as f:
        next(f)
        for line in f:
            seq.write(line.strip().upper())
    return seq.getvalue()

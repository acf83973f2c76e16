"""Input-file conversion and preparation utilities.

Counterpart of ``relate_tpu/io/fileformats.py``. Behavioral reference:
``include/file_formats/FileFormats.cpp`` — ConvertFromVcf (:217),
ConvertFromHapLegendSample (:17), RemoveNonBiallelicSNPs (:534),
RemoveSamples (:628), FilterHapsUsingMask (:802), FlipHapsUsingAncestor
(:955), GenerateSNPAnnotations (:1128) — and ConvertToTreeSequence.cpp (the
tskit export, written by ``io/kastore.py``). Host code; the files hold the
JAX package's bytes. Where the JAX module loops over genotypes one by one
(the VCF rows, the ``.haps`` writer, the annotation counts) this module
takes whole rows with numpy and writes the same text.
"""
from __future__ import annotations

import gzip
from typing import List, Optional, Tuple

import numpy as np

from . import kastore
from .haps import HapsData, smart_open

_ZERO, _ONE, _SPACE = ord("0"), ord("1"), ord(" ")


def _row_alleles(fields: List[str]) -> Optional[List[str]]:
    """The alleles of a VCF row's genotype fields (the first two of each),
    or None if one of them is neither 0 nor 1: the row is skipped."""
    gts = []
    for g in fields:
        for a in g.split(":")[0].replace("|", "/").split("/")[:2]:
            if a not in ("0", "1"):
                return None
            gts.append(a)
    return gts


def _phased_row(genotypes: str) -> Optional[str]:
    """The alleles of a row whose genotype fields are all ``a|b`` or ``a/b``
    with a, b in {0, 1}, space-separated as ``.haps`` writes them; None for
    any other row (``_row_alleles`` takes those)."""
    b = np.frombuffer(genotypes.encode(), np.uint8)
    if (len(b) + 1) % 4:
        return None
    a0, sep, a1, tab = b[0::4], b[1::4], b[2::4], b[3::4]
    if not (((a0 == _ZERO) | (a0 == _ONE)).all()
            and ((a1 == _ZERO) | (a1 == _ONE)).all()
            and ((sep == ord("|")) | (sep == ord("/"))).all()
            and (tab == ord("\t")).all()):
        return None
    out = np.full(4 * len(a0) - 1, _SPACE, np.uint8)
    out[0::4] = a0
    out[2::4] = a1
    return out.tobytes().decode()


def convert_from_vcf(vcf_path: str, out_prefix: str):
    """Phased VCF -> .haps/.sample (ConvertFromVcf, FileFormats.cpp:217)."""
    ids: List[str] = []
    with smart_open(vcf_path) as f, open(out_prefix + ".haps", "w") as fo:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                ids = line.split()[9:]
                continue
            line = line.rstrip("\n")
            p = line.split("\t", 9)
            chrom, pos, rsid, ref, alt = p[0], p[1], p[2], p[3], p[4]
            genotypes = p[9] if len(p) > 9 else ""
            alleles = _phased_row(genotypes) if genotypes else None
            if alleles is None:
                gts = _row_alleles(genotypes.split("\t") if len(p) > 9
                                   else [])
                if gts is None:
                    continue
                alleles = " ".join(gts)
            fo.write(f"{chrom} {rsid} {pos} {ref} {alt} {alleles}\n")
    with open(out_prefix + ".sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in ids:
            f.write(f"{i} {i} 0\n")


def convert_from_hap_legend_sample(hap_path: str, legend_path: str,
                                   sample_path: str, out_prefix: str,
                                   chrom: str = "1"):
    """IMPUTE hap/legend/sample -> .haps/.sample
    (ConvertFromHapLegendSample, FileFormats.cpp:17)."""
    with smart_open(legend_path) as f:
        next(f)
        legend = [ln.split() for ln in f if ln.strip()]
    with smart_open(hap_path) as fh, open(out_prefix + ".haps", "w") as fo:
        for (lid, pos, a0, a1), line in zip(
                ((r[0], r[1], r[2], r[3]) for r in legend), fh):
            alleles = line.split()
            fo.write(f"{chrom} {lid} {pos} {a0} {a1} "
                     + " ".join(alleles) + "\n")
    with smart_open(sample_path) as f, \
            open(out_prefix + ".sample", "w") as fo:
        lines = [ln.split() for ln in f if ln.strip()]
        fo.write("ID_1 ID_2 missing\n0 0 0\n")
        for r in lines[1:]:
            fo.write(f"{r[0]} {r[0]} 0\n")


def remove_non_biallelic_snps(data: HapsData) -> Tuple[HapsData, np.ndarray]:
    """Drop SNPs at duplicated positions (RemoveNonBiallelicSNPs,
    FileFormats.cpp:534). Returns (filtered, kept index)."""
    bp = data.bp
    dup = np.zeros(len(bp), dtype=bool)
    dup[1:] |= bp[1:] == bp[:-1]
    dup[:-1] |= bp[1:] == bp[:-1]
    keep = np.nonzero(~dup)[0]
    return _subset_snps(data, keep), keep


def remove_samples(data: HapsData, drop_haps: List[int]) -> HapsData:
    """Remove haplotype columns (RemoveSamples, FileFormats.cpp:628)."""
    drop = set(drop_haps)
    keep = np.asarray([i for i in range(data.N) if i not in drop],
                      dtype=np.int64)
    return HapsData(genotypes=data.genotypes[:, keep], bp=data.bp,
                    rsid=data.rsid, ancestral=data.ancestral,
                    alternative=data.alternative, chrom=data.chrom)


def filter_haps_using_mask(data: HapsData, mask_seq: str,
                           pass_chars: str = "P"
                           ) -> Tuple[HapsData, np.ndarray]:
    """Keep SNPs whose (1-based) position passes the genome mask
    (FilterHapsUsingMask, FileFormats.cpp:802)."""
    keep = []
    n = len(mask_seq)
    for i, pos in enumerate(data.bp):
        p = int(pos) - 1
        if 0 <= p < n and mask_seq[p] in pass_chars:
            keep.append(i)
    keep = np.asarray(keep, dtype=np.int64)
    return _subset_snps(data, keep), keep


def flip_haps_using_ancestor(data: HapsData, ancestor_seq: str
                             ) -> Tuple[HapsData, np.ndarray]:
    """Polarize alleles against an ancestral genome: SNPs whose stated
    ancestral allele mismatches the ancestor fasta are flipped; SNPs with
    no confident ancestral base are dropped (FlipHapsUsingAncestor,
    FileFormats.cpp:955)."""
    G = data.genotypes.copy()
    anc = list(data.ancestral)
    alt = list(data.alternative)
    keep = []
    n = len(ancestor_seq)
    for i, pos in enumerate(data.bp):
        p = int(pos) - 1
        if not (0 <= p < n):
            continue
        base = ancestor_seq[p].upper()
        if base not in "ACGT":
            continue
        if base == anc[i].upper():
            keep.append(i)
        elif base == alt[i].upper():
            G[i] = 1 - G[i]
            anc[i], alt[i] = alt[i], anc[i]
            keep.append(i)
    keep = np.asarray(keep, dtype=np.int64)
    out = HapsData(genotypes=G[keep], bp=data.bp[keep],
                   rsid=[data.rsid[i] for i in keep],
                   ancestral=[anc[i] for i in keep],
                   alternative=[alt[i] for i in keep],
                   chrom=[data.chrom[i] for i in keep])
    return out, keep


def generate_snp_annotations(data: HapsData, ancestor_seq: Optional[str],
                             poplabels=None) -> Tuple[str, List[str]]:
    """Per-SNP annotation rows: upstream/downstream ancestral bases and
    per-group carrier counts (GenerateSNPAnnotations,
    FileFormats.cpp:1128). Returns (header, rows)."""
    groups = poplabels.groups if poplabels is not None else []
    header = "upstream_allele;downstream_allele;" \
        + ";".join(groups) + (";" if groups else "")
    counts = None
    if poplabels is not None:
        # carriers by group: one product of 0/1 rows, exact in float64
        goh = np.asarray(poplabels.group_of_haplotype)
        if len(goh) < data.N:
            raise ValueError(f"the poplabels name {len(goh)} haplotypes, "
                             f"the panel has {data.N}")
        onehot = np.zeros((data.N, len(groups)), dtype=np.float64)
        onehot[np.arange(data.N), goh[:data.N]] = 1.0
        counts = ((data.genotypes != 0).astype(np.float64) @ onehot
                  ).astype(np.int64)
    rows = []
    for i, pos in enumerate(data.bp):
        up = down = "NA"
        if ancestor_seq is not None:
            p = int(pos) - 1
            if 1 <= p < len(ancestor_seq) - 1:
                up = ancestor_seq[p - 1].upper()
                down = ancestor_seq[p + 1].upper()
        row = f"{up};{down};"
        if counts is not None:
            row += ";".join(str(c) for c in counts[i]) + ";"
        rows.append(row)
    return header, rows


def _subset_snps(data: HapsData, keep: np.ndarray) -> HapsData:
    return HapsData(genotypes=data.genotypes[keep], bp=data.bp[keep],
                    rsid=[data.rsid[i] for i in keep],
                    ancestral=[data.ancestral[i] for i in keep],
                    alternative=[data.alternative[i] for i in keep],
                    chrom=[data.chrom[i] for i in keep])


def write_haps(data: HapsData, path: str):
    """``chr rsid bp ancestral alternative a_1 ... a_N`` a SNP, gzipped if
    ``path`` ends in ``.gz``. Single-digit alleles are written a row at a
    time from their bytes; any other value as ``str(int(x))``."""
    G = np.asarray(data.genotypes)
    op = gzip.open if path.endswith(".gz") else open
    digits = G.size and G.min() >= 0 and G.max() <= 9
    if digits:
        text = np.full((data.L, 2 * data.N), _SPACE, np.uint8)
        text[:, 0::2] = G + _ZERO
        text[:, -1] = ord("\n")
    with op(path, "wb") as f:
        for i in range(data.L):
            head = (f"{data.chrom[i]} {data.rsid[i]} {data.bp[i]} "
                    f"{data.ancestral[i]} {data.alternative[i]} ").encode()
            if digits:
                f.write(head + text[i].tobytes())
            else:
                f.write(head + (" ".join(str(int(x)) for x in G[i])
                                + "\n").encode())


# the least time by which a node is older than its children in the export
TIME_EPSILON = 1e-6


def export_node_times(tree, coords: np.ndarray) -> np.ndarray:
    """Node times of one tree as ConvertToTreeSequence writes them: a node
    keeps its age unless that is less than TIME_EPSILON above one of its
    children's (a zero-length branch), and is then raised to that. Leaves
    keep their sample ages.

    The JAX package raises every internal node above the previous one in
    age order, starting from the oldest sample, which moves every
    coalescence younger than an ancient sample up to its age (ROADMAP
    section C); without sample ages both give the same times wherever no
    two nodes' ages lie within TIME_EPSILON of each other."""
    t = np.array(coords, dtype=np.float64)
    N = tree.N
    internal = np.arange(N, tree.num_nodes)
    cl = tree.child_left[internal]
    cr = tree.child_right[internal]
    while True:
        floor = np.maximum(t[cl], t[cr]) + TIME_EPSILON
        low = t[internal] < floor
        if not low.any():
            return t
        t[internal[low]] = floor[low]


def to_tree_sequence(anc, muts, bp: np.ndarray, out_path: str,
                     alleles=None):
    """Export .anc/.mut to a tskit .trees file (ConvertToTreeSequence,
    ``include/file_formats/ConvertToTreeSequence.cpp:221``).

    Writes the kastore/tskit file-format-12 container natively
    (``io/kastore.py``), no tskit package required. Leaves are shared
    sample nodes 0..N-1; each marginal tree contributes its own internal
    nodes, numbered in age order, at the times of ``export_node_times``.
    A SNP mapped to one branch becomes a site and a mutation above that
    branch's node."""
    N = anc.N
    seq_len = float(bp[-1]) + 1.0
    sample_ages = anc.sample_ages
    node_time = [np.asarray(sample_ages, np.float64)[:N]
                 if sample_ages is not None else np.zeros(N)]
    num_nodes = N

    T = len(anc.seq)
    starts = [mt.pos for mt in anc.seq] + [len(bp)]
    muts_by_tree = {}
    for snp, m in enumerate(muts):
        if len(m.branch) == 1:
            muts_by_tree.setdefault(m.tree, []).append(snp)

    e_left, e_right, e_parent, e_child = [], [], [], []
    s_pos, s_anc = [], []
    m_site, m_node, m_der = [], [], []
    for t, mt in enumerate(anc.seq):
        tree = mt.tree
        left = 0.0 if t == 0 else float(bp[min(starts[t], len(bp) - 1)])
        right = (float(bp[min(starts[t + 1], len(bp) - 1)])
                 if t + 1 < T else seq_len)
        if right <= left:
            continue
        coords = tree.coordinates(sample_ages)
        times = export_node_times(tree, coords)
        order = np.argsort(coords[N:], kind="stable") + N
        node_map = np.arange(tree.num_nodes, dtype=np.int64)
        node_map[order] = num_nodes + np.arange(len(order))
        node_time.append(times[order])
        num_nodes += len(order)
        child = np.nonzero(tree.parent >= 0)[0]
        e_left.append(np.full(len(child), left))
        e_right.append(np.full(len(child), right))
        e_parent.append(node_map[tree.parent[child]])
        e_child.append(node_map[child])
        for snp in muts_by_tree.get(t, []):
            a0, a1 = ("0", "1")
            if alleles is not None and "/" in alleles[snp]:
                a0, a1 = alleles[snp].split("/")[:2]
            m_site.append(len(s_pos))
            s_pos.append(float(bp[snp]))
            s_anc.append(a0 or "0")
            m_node.append(node_map[int(muts[snp].branch[0])])
            m_der.append(a1 or "1")

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.zeros(0, dtype))

    nt = np.concatenate(node_time)
    ep = cat(e_parent, np.int32)
    ec = cat(e_child, np.int32)
    el = cat(e_left, np.float64)
    er = cat(e_right, np.float64)
    node_flags = np.zeros(num_nodes, np.uint32)
    node_flags[:N] = 1                       # TSK_NODE_IS_SAMPLE
    # tskit edge ordering: (time[parent], parent, child, left)
    o = np.lexsort((el, ec, ep, nt[ep]))
    kastore.trees_dump(
        out_path, sequence_length=seq_len,
        node_time=nt, node_flags=node_flags,
        edge_left=el[o], edge_right=er[o],
        edge_parent=ep[o], edge_child=ec[o],
        site_position=np.asarray(s_pos), site_ancestral=s_anc,
        mut_site=np.asarray(m_site, np.int32),
        mut_node=np.asarray(m_node, np.int32), mut_derived=m_der,
        provenance="")
    return out_path

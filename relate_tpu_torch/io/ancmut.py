"""Readers/writers for Relate's .anc/.mut tree-sequence formats.

Formats (behavioral reference):
- binary .anc (anc.cpp:1104-1167): header ``bool has_sample_ages, u32 N,
  [f64 ages], u32 num_trees``; per tree ``i32 pos`` then per node
  ``i32 parent, f64 branch_length, f32 num_events, i32 SNP_begin,
  i32 SNP_end``.
- short .mut (mutations.cpp:511-545): header
  ``tree_index;branch_index;is_mapping;is_flipped;age_of_mutation`` then
  ``tree;b1[ b2...];is_not_mapping;flipped;age_begin;age_end;``.

- text .anc (anc.cpp:760-815, Dump): ``NUM_HAPLOTYPES N [ages]``,
  ``NUM_TREES T``, then per tree ``pos: parent:(branch_length num_events
  SNP_begin SNP_end) ...``.
- final .mut (Finalize.cpp:98-183): ``FINAL_MUT_HEADER`` and one
  ``;``-separated row per SNP.
"""
from __future__ import annotations

import contextlib
import os
import struct
from typing import List, Optional, TextIO

import numpy as np

from ..core.topology import MutationRecord
from ..core.trees import (AncesTree, MarginalTree, Tree,
                          children_from_parent, children_from_parent_batch)
from ..utils import trace
from .haps import smart_open


# ---------------------------------------------------------------------------
# binary .anc
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Write to a same-directory temp file and ``os.replace`` into place on
    success: a reader polling for ``path`` can never observe a half-written artifact. POSIX
    rename is atomic within a filesystem; NFS renames are atomic on the
    server, which is exactly the shared-store case. The file's size is
    counted under ``bytes_written`` (``utils.trace``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    f = open(tmp, mode)
    try:
        yield f
        f.close()
        os.replace(tmp, path)
        trace.wrote(path)
    except BaseException:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_anc_bin(path: str, anc: AncesTree):
    # per-tree structured-array dump ('<' packed layout, matching the C++
    # packed record stream) — a per-node struct.pack loop costs ~100x at
    # 10^4-tree chunks
    rec = np.dtype([("parent", "<i4"), ("bl", "<f8"), ("ne", "<f4"),
                    ("sb", "<i4"), ("se", "<i4")])
    with atomic_write(path, "wb") as f:
        has_ages = anc.sample_ages is not None and len(anc.sample_ages) > 0
        f.write(struct.pack("?", has_ages))
        f.write(struct.pack("I", anc.N))
        if has_ages:
            f.write(np.asarray(anc.sample_ages, np.float64).tobytes())
        f.write(struct.pack("I", len(anc.seq)))
        if not anc.seq:
            return
        # one (T,)-records dump instead of a per-tree pack loop
        M = anc.seq[0].tree.num_nodes
        trec = np.dtype([("pos", "<i4"), ("nodes", rec, (M,))])
        arr = np.empty(len(anc.seq), dtype=trec)
        nodes = arr["nodes"]
        arr["pos"] = [mt.pos for mt in anc.seq]
        # stack per-field first (contiguous), then one strided field copy
        # each — per-tree strided assignment costs ~10x
        nodes["parent"] = np.stack([mt.tree.parent for mt in anc.seq])
        nodes["bl"] = np.stack([mt.tree.branch_length for mt in anc.seq])
        nodes["ne"] = np.stack([mt.tree.num_events for mt in anc.seq])
        nodes["sb"] = np.stack([mt.tree.SNP_begin for mt in anc.seq])
        nodes["se"] = np.stack([mt.tree.SNP_end for mt in anc.seq])
        f.write(arr.tobytes())


def read_anc_bin(path: str) -> AncesTree:
    with open(path, "rb") as f:
        (has_ages,) = struct.unpack("?", f.read(1))
        (N,) = struct.unpack("I", f.read(4))
        ages = None
        if has_ages:
            ages = np.frombuffer(f.read(8 * N), dtype=np.float64).copy()
        (num_trees,) = struct.unpack("I", f.read(4))
        M = 2 * N - 1
        rec = np.dtype([("parent", "<i4"), ("bl", "<f8"), ("ne", "<f4"),
                        ("sb", "<i4"), ("se", "<i4")])
        trec = np.dtype([("pos", "<i4"), ("nodes", rec, (M,))])
        # bulk-read every tree record, then batch-decode: contiguous
        # column copies + one batched children recovery (the per-tree
        # loop cost ~0.25 ms/tree, dominated by children_from_parent)
        arr = np.frombuffer(f.read(trec.itemsize * num_trees), dtype=trec,
                            count=num_trees)
        nodes = arr["nodes"]
        pos_v = arr["pos"]
        parent_b = np.ascontiguousarray(nodes["parent"])
        bl_b = np.ascontiguousarray(nodes["bl"])
        ne_b = np.ascontiguousarray(nodes["ne"])
        sb_b = np.ascontiguousarray(nodes["sb"])
        se_b = np.ascontiguousarray(nodes["se"])
        cl_b, cr_b = children_from_parent_batch(parent_b)
        seq = []
        for t in range(num_trees):
            tr = Tree(parent=parent_b[t], child_left=cl_b[t],
                      child_right=cr_b[t], branch_length=bl_b[t],
                      num_events=ne_b[t], SNP_begin=sb_b[t],
                      SNP_end=se_b[t])
            seq.append(MarginalTree(pos=int(pos_v[t]), tree=tr))
    return AncesTree(N=N, seq=seq, sample_ages=ages)


# ---------------------------------------------------------------------------
# text .anc
# ---------------------------------------------------------------------------

def _fmt_g5(x: float) -> str:
    """%.5f-style like the reference's Dump (anc.cpp:810)."""
    return f"{x:.5f}"


def write_anc_text(path: str, anc: AncesTree,
                   num_trees: Optional[int] = None,
                   use_native: bool = True):
    """Text .anc. ``use_native=True`` formats the tree lines with the
    native library (``io/native.py``; raises if it cannot be built or
    loaded), ``use_native=False`` in Python: the same bytes."""
    if anc.sample_ages is None or len(anc.sample_ages) == 0:
        header = f"NUM_HAPLOTYPES {anc.N}\n"
    else:
        header = (f"NUM_HAPLOTYPES {anc.N} "
                  + " ".join(f"{a:f}" for a in anc.sample_ages) + " \n")
    header += (f"NUM_TREES "
               f"{num_trees if num_trees is not None else len(anc.seq)}\n")
    if use_native and anc.seq:
        from . import native
        trees = [mt.tree for mt in anc.seq]
        open(path, "w").close()          # truncate; the library appends
        native.write_anc_trees(
            path, header, [mt.pos for mt in anc.seq],
            np.stack([t.parent for t in trees]),
            np.stack([t.branch_length for t in trees]),
            np.stack([t.num_events for t in trees]),
            np.stack([t.SNP_begin for t in trees]),
            np.stack([t.SNP_end for t in trees]))
    else:
        with open(path, "w") as f:
            f.write(header)
            for mt in anc.seq:
                write_anc_tree_line(f, mt)
    trace.wrote(path)


def write_anc_tree_line(f: TextIO, mt: MarginalTree):
    t = mt.tree
    parts = [f"{mt.pos}:"]
    # plain Python numbers format several times faster than numpy scalars
    for p, bl, ne, sb, se in zip(
            t.parent.tolist(), np.asarray(t.branch_length, np.float64).tolist(),
            np.asarray(t.num_events, np.float64).tolist(),
            t.SNP_begin.tolist(), t.SNP_end.tolist()):
        parts.append(f"{p}:({_fmt_g5(bl)} {ne:.3f} {sb} {se})")
    f.write(" ".join(parts) + " \n")


def read_anc_shape(path: str):
    """(haplotypes, trees) of a text .anc, from its two header lines."""
    with smart_open(path) as f:
        N = int(f.readline().split()[1])
        return N, int(f.readline().split()[1])


def read_anc_text(path: str) -> AncesTree:
    with smart_open(path) as f:
        header = f.readline().split()
        N = int(header[1])
        ages = None
        if len(header) > 2:
            ages = np.asarray([float(x) for x in header[2:]])
        num_trees = int(f.readline().split()[1])
        M = 2 * N - 1
        seq = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            pos_s, rest = line.split(":", 1)
            toks = rest.replace("(", " ").replace(")", " ").replace(
                ":", " ").split()
            if len(toks) != 5 * M:
                raise ValueError(
                    f"{path}: tree at {pos_s} has {len(toks)} fields, "
                    f"expected {5 * M}")
            cols = np.asarray(toks).reshape(M, 5)
            parent = cols[:, 0].astype(np.int32)
            cl, cr = children_from_parent(parent)
            seq.append(MarginalTree(pos=int(pos_s), tree=Tree(
                parent=parent, child_left=cl, child_right=cr,
                branch_length=cols[:, 1].astype(np.float64),
                num_events=cols[:, 2].astype(np.float32),
                SNP_begin=cols[:, 3].astype(np.int32),
                SNP_end=cols[:, 4].astype(np.int32))))
        if len(seq) != num_trees:
            raise ValueError(f"{path}: {len(seq)} trees, header says "
                             f"{num_trees}")
    return AncesTree(N=N, seq=seq, sample_ages=ages)


# ---------------------------------------------------------------------------
# .mut (short format)
# ---------------------------------------------------------------------------

def write_mut_short(path: str, muts: List[MutationRecord]):
    with atomic_write(path, "w") as f:
        f.write("tree_index;branch_index;is_mapping;is_flipped;"
                "age_of_mutation\n")
        for m in muts:
            br = " ".join(str(b) for b in m.branch)
            nm = 1 if len(m.branch) > 1 else 0
            f.write(f"{m.tree};{br};{nm};{int(m.flipped)};"
                    f"{_fmt_g(m.age_begin)};{_fmt_g(m.age_end)};\n")


def _fmt_g(x: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    s = f"{x:g}"
    return s


def read_mut_short(path: str) -> List[MutationRecord]:
    out: List[MutationRecord] = []
    with smart_open(path) as f:
        next(f)
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            branch = [int(x) for x in parts[1].split()] if parts[1] else []
            out.append(MutationRecord(
                tree=int(parts[0]), branch=branch,
                flipped=bool(int(parts[3])),
                age_begin=float(parts[4]), age_end=float(parts[5])))
    return out


def get_age(anc: AncesTree, muts: List[MutationRecord]):
    """Fill age_begin/age_end from the tree (mutations.cpp:27-60):
    age_begin = age of the branch's lower node (sum of branch lengths down
    its left-child chain to a leaf, plus that leaf's sample age);
    age_end adds the branch's own length.

    Vectorized: one (T, M) fixed-point pass computes every node's
    left-chain age and left-descendant leaf at once, then each mutation is
    an O(1) lookup (the per-SNP Python chain walk cost seconds at
    10^4-tree chunks)."""
    if not anc.seq:
        return
    M = anc.seq[0].tree.num_nodes
    ages = anc.sample_ages
    has_ages = ages is not None and len(ages)
    bl = np.stack([mt.tree.branch_length for mt in anc.seq])
    if not bl.any() and not has_ages:
        # zero-length trees (BuildTopology stage, before the MCMC): every
        # age is 0; skip the chain walk entirely
        for m in muts:
            if len(m.branch) == 1:
                m.age_begin = 0.0
                m.age_end = 0.0
        return
    cl = np.stack([mt.tree.child_left for mt in anc.seq])
    age = np.zeros_like(bl)
    # walker per node: descend the left-child chain, summing each visited
    # child's branch length; the final walker position is the chain's leaf
    w = np.broadcast_to(np.arange(M, dtype=np.int64)[None, :],
                        cl.shape).copy()
    while True:
        cw = np.take_along_axis(cl, w, axis=1)
        act = cw >= 0
        if not act.any():
            break
        sc = np.maximum(cw, 0)
        age = np.where(act, age + np.take_along_axis(bl, sc, axis=1), age)
        w = np.where(act, sc, w)
    leaf = w
    # gather every single-branch mutation's ages in one vectorized pass,
    # then assign plain Python floats (numpy-scalar attribute sets cost
    # ~40 us each at 10^4-mutation chunks)
    sel = [i for i, m in enumerate(muts) if len(m.branch) == 1]
    if not sel:
        return
    ti = np.asarray([muts[i].tree for i in sel])
    bi = np.asarray([muts[i].branch[0] for i in sel])
    a = age[ti, bi]
    if has_ages:
        a = a + np.asarray(ages)[leaf[ti, bi]]
    ae = (a + bl[ti, bi]).tolist()
    ab = a.tolist()
    for k, i in enumerate(sel):
        muts[i].age_begin = ab[k]
        muts[i].age_end = ae[k]


# ---------------------------------------------------------------------------
# final .mut
# ---------------------------------------------------------------------------

FINAL_MUT_HEADER = ("snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;"
                    "is_not_mapping;is_flipped;age_begin;age_end;"
                    "ancestral_allele/alternative_allele;")


def write_mut_final(path: str, rows: List[str], extra_header: str = ""):
    """``extra_header`` is the .annot header appended to the standard one
    when Finalize joins annotations (Finalize.cpp:97-99)."""
    with open(path, "w") as f:
        f.write(FINAL_MUT_HEADER + extra_header + "\n")
        for r in rows:
            f.write(r + "\n")
    trace.wrote(path)


def read_mut_final(path: str):
    """Parse a final .mut into a list of dicts."""
    out = []
    with smart_open(path) as f:
        next(f)
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            p = line.split(";")
            out.append({
                "snp": int(p[0]), "pos": int(p[1]), "dist": int(p[2]),
                "rsid": p[3], "tree": int(p[4]),
                "branch": [int(x) for x in p[5].split()] if p[5] else [],
                "is_not_mapping": int(p[6]), "flipped": int(p[7]),
                "age_begin": float(p[8]), "age_end": float(p[9]),
                "alleles": p[10] if len(p) > 10 else "",
            })
    return out

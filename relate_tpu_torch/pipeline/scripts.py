"""Python equivalents of the reference's shell scripts of the
post-inference tools (``scripts/``): EstimatePopulationSize.sh,
SampleBranchLengths.sh, ReEstimateBranchLengths.sh and DetectSelection.sh,
and of the input script PrepareInputFiles.sh (host code).

Counterpart of the same functions of ``relate_tpu/pipeline/scripts.py``.
The shell scripts orchestrate binaries through temp files; here each one
is a plain function over the in-memory tree sequence, on ``device`` (None:
the CUDA card). The estimators are called through their modules
(``coalrate.*``, ``sampling.*``), so a caller can replace them.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..core import mcmc
from ..core.topology import MutationRecord
from ..evaluate import coalrate, sampling, selection
from ..io import ancmut, extract, fileformats
from ..io import haps as hio
from ..parallel.mesh import device_and_mesh
from ..parallel.pool import CardPool
from ..utils.devmem import resolve_device


def _load_pair(prefix: str):
    """(anc, records, bp, dist, rsid, alleles) of ``prefix``.anc/.mut."""
    anc = ancmut.read_anc_text(prefix + ".anc")
    md = ancmut.read_mut_final(prefix + ".mut")
    recs = [MutationRecord(tree=m["tree"], branch=m["branch"],
                           flipped=bool(m["flipped"]),
                           age_begin=m["age_begin"], age_end=m["age_end"])
            for m in md]
    bp = np.asarray([m["pos"] for m in md])
    dist = np.asarray([m["dist"] for m in md], dtype=np.float64)
    rsid = [m["rsid"] for m in md]
    alleles = [m["alleles"] for m in md]
    return anc, recs, bp, dist, rsid, alleles


def _dump_pair(prefix: str, anc, recs, bp, dist, rsid, alleles):
    """Write ``prefix``.anc/.mut, the mutation ages from the trees."""
    ancmut.get_age(anc, recs)
    rows = []
    for snp, m in enumerate(recs):
        br = " ".join(str(b) for b in m.branch)
        rows.append(
            f"{snp};{bp[snp]};{int(dist[snp])};{rsid[snp]};{m.tree};{br};"
            f"{1 if len(m.branch) > 1 else 0};{int(m.flipped)};"
            f"{ancmut._fmt_g(m.age_begin)};{ancmut._fmt_g(m.age_end)};"
            f"{alleles[snp]};")
    ancmut.write_anc_text(prefix + ".anc", anc)
    ancmut.write_mut_final(prefix + ".mut", rows)


def _pool_for(prefix: str, mesh) -> Optional[CardPool]:
    """A ``CardPool`` of ``mesh``, started before ``prefix``.anc is read so
    that its start overlaps the read, where the mesh has several devices
    and the file's trees make two chain parts or more; else None."""
    if mesh is None or len(mesh) < 2:
        return None
    N, T = ancmut.read_anc_shape(prefix + ".anc")
    return CardPool(mesh) if T > mcmc.chain_batch_cap(2 * N - 1) else None


def estimate_population_size(input_prefix: str, output_prefix: str,
                             mu: float = 1.25e-8,
                             years_per_gen: float = 28.0,
                             poplabels_path: Optional[str] = None,
                             bins: Optional[tuple] = None,
                             num_iter: int = 10, seed: int = 1,
                             threshold_frac: float = 0.5,
                             reestimate_final: bool = True,
                             verbose: bool = True, device=None, mesh=None):
    """EstimatePopulationSize.sh: joint EM over coalescence rates and branch
    lengths; writes <output>.coal (+ by-group pairwise if poplabels) and the
    re-estimated <output>.anc/.mut. With a ``mesh`` of more than one device
    the chain parts go to a ``parallel.pool.CardPool`` of it, one process a
    card: with the final re-estimate, where the input's trees make two
    parts or more, one pool started before the input is read serves the
    EM's draws and the re-estimate (``sampling.reestimate_branch_lengths``);
    otherwise ``coalrate.estimate_popsize_em`` starts one for its draws
    where they make two parts. The files are one device's byte for byte."""
    device, mesh = device_and_mesh(device, mesh)
    pool = _pool_for(input_prefix, mesh) if reestimate_final else None
    try:
        anc, recs, bp, dist, rsid, alleles = _load_pair(input_prefix)
        if threshold_frac > 0:
            anc, recs = extract.remove_trees_with_few_mutations(
                anc, recs, threshold_frac)
        group_of_hap = None
        names = None
        if poplabels_path:
            pl = hio.read_poplabels(poplabels_path)
            group_of_hap = pl.group_of_haplotype[: anc.N]
            names = pl.groups
        epochs = coalrate.epochs_from_bins(*bins, years_per_gen) if bins \
            else coalrate.default_epochs(years_per_gen)
        epochs, rates, whole = coalrate.estimate_popsize_em(
            anc, recs, dist, mu=mu, epochs=epochs, num_iter=num_iter,
            seed=seed, group_of_hap=group_of_hap, verbose=verbose,
            device=device, mesh=mesh, pool=pool)
        coalrate.write_coal(output_prefix + ".coal", epochs, whole, ["0"])
        if verbose:
            # terminal popsize plot (plot.cpp via FinalizePopulationSize.cpp:2)
            from ..utils.asciiplot import ascii_plot
            with np.errstate(divide="ignore"):
                ne = np.where(np.asarray(whole) > 0,
                              0.5 / np.maximum(np.asarray(whole), 1e-300),
                              0.0)
            sys.stderr.write(ascii_plot(epochs, ne))
        if group_of_hap is not None:
            coalrate.write_coal(output_prefix + ".pairwise.coal", epochs,
                                rates, names)
        if reestimate_final:
            # final pass mirrors the .sh: posterior-MEAN re-estimate of the
            # ORIGINAL (unfiltered) trees under the final .coal
            anc_f, recs_f, bp_f, dist_f, rsid_f, alleles_f = \
                _load_pair(input_prefix)
            sampling.reestimate_branch_lengths(anc_f, recs_f, dist_f, mu,
                                               epochs, whole,
                                               seed=seed + num_iter,
                                               device=device, pool=pool)
            _dump_pair(output_prefix, anc_f, recs_f, bp_f, dist_f, rsid_f,
                       alleles_f)
    finally:
        if pool is not None:
            pool.close()
    return epochs, rates


def detect_selection(input_prefix: str, output_prefix: str,
                     mu: float = 1.25e-8, years_per_gen: float = 28.0,
                     first_bp: Optional[int] = None,
                     last_bp: Optional[int] = None, device=None):
    """DetectSelection.sh: frequency-through-time + selection p-values +
    per-tree quality; writes .freq/.lin/.sele/.qual. On ``device`` (None:
    the CUDA card)."""
    device = resolve_device(device)
    anc, recs, bp, dist, rsid, alleles = _load_pair(input_prefix)
    if first_bp is not None and last_bp is not None:
        anc, recs, (lo, hi) = extract.anc_mut_for_subregion(
            anc, recs, bp, first_bp, last_bp)
        bp, rsid = bp[lo:hi + 1], rsid[lo:hi + 1]
    epochs = coalrate.default_epochs(years_per_gen)
    rows, scan = selection.selection_scan(anc, recs, epochs, bp, rsid,
                                          device=device)
    selection.write_freq_lin(output_prefix, rows, epochs)
    selection.write_sele(output_prefix + ".sele", scan, epochs)
    selection.write_quality(output_prefix + ".qual",
                            selection.quality(anc, recs))
    return output_prefix


def sample_branch_lengths(input_prefix: str, output_prefix: str,
                          coal_path: str, mu: float = 1.25e-8,
                          num_samples: int = 100,
                          first_bp: Optional[int] = None,
                          last_bp: Optional[int] = None,
                          fmt: str = "anc", seed: int = 1, device=None,
                          mesh=None):
    """SampleBranchLengths.sh: posterior branch-length samples under a .coal
    prior; fmt in {anc, newick, timeb}. With a ``mesh`` of more than one
    device the chain parts go to a pool of it, one process a card, where
    they make two parts or more: for the whole input a pool started before
    the input is read, for a subregion one of ``sampling.
    sample_branch_lengths``."""
    device, mesh = device_and_mesh(device, mesh)
    subregion = first_bp is not None and last_bp is not None
    pool = None if subregion else _pool_for(input_prefix, mesh)
    try:
        anc, recs, bp, dist, rsid, alleles = _load_pair(input_prefix)
        if subregion:
            anc, recs, (lo, hi) = extract.anc_mut_for_subregion(
                anc, recs, bp, first_bp, last_bp)
            bp, dist = bp[lo:hi + 1], dist[lo:hi + 1]
            rsid, alleles = rsid[lo:hi + 1], alleles[lo:hi + 1]
            extract.extract_dist_from_mut(
                [{"pos": bp[i], "dist": int(dist[i])}
                 for i in range(len(bp))], output_prefix + ".dist")
        names, epochs, rates = coalrate.read_coal(coal_path)
        samples = sampling.sample_branch_lengths(
            anc, recs, dist, mu, epochs, rates[:, 0, 0],
            num_samples=num_samples, seed=seed, device=device, mesh=mesh,
            pool=pool)
    finally:
        if pool is not None:
            pool.close()
    if fmt == "newick":
        with open(output_prefix + ".newick", "w") as f:
            for t in range(len(anc.seq)):
                for s in range(num_samples):
                    tr = anc.seq[t].tree.copy()
                    tr.branch_length = samples[s, t]
                    f.write(tr.to_newick() + "\n")
    elif fmt == "timeb":
        sampling.write_timeb(output_prefix + ".timeb", anc, samples,
                             muts=recs, bp=bp, alleles=alleles)
    else:
        # mean over samples into one anc/mut (plus all samples as .npy)
        mean_bl = samples.mean(axis=0)
        for i, mt in enumerate(anc.seq):
            mt.tree.branch_length = mean_bl[i]
        _dump_pair(output_prefix, anc, recs, bp, dist, rsid, alleles)
        np.save(output_prefix + "_samples.npy", samples)
    return samples


def reestimate_branch_lengths(input_prefix: str, output_prefix: str,
                              coal_path: str, mu: float = 1.25e-8,
                              seed: int = 1,
                              poplabels_path: Optional[str] = None,
                              device=None):
    """ReEstimateBranchLengths.sh: whole-chromosome re-estimation under a
    .coal prior; with ``poplabels_path`` the prior uses pairwise group
    rates (ReEstimateBranchLengths.cpp:144-232 with --poplabels)."""
    device = resolve_device(device)
    anc, recs, bp, dist, rsid, alleles = _load_pair(input_prefix)
    names, epochs, rates = coalrate.read_coal(coal_path)
    memberships = None
    if poplabels_path is not None:
        pl = hio.read_poplabels(poplabels_path)
        memberships = pl.group_of_haplotype[: anc.N]
        if rates.shape[1] != pl.num_groups:
            raise SystemExit(
                f"coal file has {rates.shape[1]} groups, poplabels "
                f"{pl.num_groups}")
    sampling.reestimate_branch_lengths(anc, recs, dist, mu, epochs,
                                       rates[:, 0, 0], seed=seed,
                                       group_rates=(rates if memberships
                                                    is not None else None),
                                       memberships=memberships,
                                       device=device)
    _dump_pair(output_prefix, anc, recs, bp, dist, rsid, alleles)


def prepare_input_files(haps_path: str, sample_path: str, out_prefix: str,
                        ancestor_path: Optional[str] = None,
                        mask_path: Optional[str] = None,
                        remove_ids: Optional[List[str]] = None,
                        poplabels_path: Optional[str] = None):
    """PrepareInputFiles.sh: flip against ancestor, apply mask, drop
    samples, remove non-biallelics; writes <out>.haps.gz/.sample/.dist and,
    with an ancestor or poplabels, .annot. The ``.dist`` holds the plain bp
    gaps of the SNPs that are left, as the JAX function writes it."""
    data = hio.read_haps(haps_path, sample_path)
    _, ids = hio.read_sample(sample_path)
    if remove_ids:
        drop = [i for i, x in enumerate(ids)
                if x.rsplit("_", 1)[0] in set(remove_ids)]
        data = fileformats.remove_samples(data, drop)
        ids = [x for i, x in enumerate(ids) if i not in set(drop)]
    data, _ = fileformats.remove_non_biallelic_snps(data)
    if ancestor_path:
        anc_seq = hio.read_fasta(ancestor_path)
        data, _ = fileformats.flip_haps_using_ancestor(data, anc_seq)
    else:
        anc_seq = None
    if mask_path:
        mask = hio.read_fasta(mask_path)
        data, _ = fileformats.filter_haps_using_mask(data, mask)
    fileformats.write_haps(data, out_prefix + ".haps.gz")
    with open(out_prefix + ".sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(0, len(ids), 2):
            f.write(f"{ids[i].rsplit('_', 1)[0]} "
                    f"{ids[i].rsplit('_', 1)[0]} 0\n")
    d = hio.compute_dist(data.bp)
    with open(out_prefix + ".dist", "w") as f:
        f.write("#pos dist\n")
        for i in range(data.L):
            f.write(f"{data.bp[i]} {d[i]}\n")
    if poplabels_path or anc_seq is not None:
        pl = hio.read_poplabels(poplabels_path) if poplabels_path else None
        header, rows = fileformats.generate_snp_annotations(data, anc_seq, pl)
        with open(out_prefix + ".annot", "w") as f:
            f.write(header + "\n")
            for r in rows:
                f.write(r + "\n")
    return out_prefix

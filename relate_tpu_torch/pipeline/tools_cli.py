"""CLI of the post-inference tools, mirroring the reference binaries
RelateCoalescentRate, RelateMutationRate, RelateSelection, RelateExtract,
RelateFileFormats and RelateTreeView; counterpart of
``relate_tpu/pipeline/tools_cli.py``.

Usage:
  python -m relate_tpu_torch.pipeline.tools_cli <tool> --mode <Mode> \
      -i in -o out [--device cpu]

CoalescentRate: EstimatePopulationSize (``.coal`` and, with ``--poplabels``
or ``--poplabels hap``, ``.pairwise.coal``; ``--chr chrs.txt`` or
``--first_chr 1 --last_chr 22``, ``--bins 3,7,0.2``), CoalRateForTree
(``.rates.npz``), GenerateConstCoalFile, ReEstimateBranchLengths
(``--coal``, with ``--poplabels`` the pairwise prior), SampleBranchLengths
(``--coal``, ``--format anc|newick|timeb``) and EstimatePopulationSizeEM
(``--num_iter``).

MutationRate: Avg / FinalizeAvg (``_avg.rate``, ``_avg.npz``), WithContext,
WithContextForChromosome, MutationRateForCategory, ForCategoryForChromosome
and ForCategoryForPopForChromosome (``--ancestor`` fasta; the last with
``--poplabels`` and ``--pop_of_interest``; ``.rate``, ``_bycat.npz``),
MutationDensity (``--sample_id``), each over ``--chr`` /
``--first_chr..--last_chr`` too; and the summaries of per-chromosome
outputs (``-i a,b,...``): SummarizeForGenome[ForCategory],
Finalize[ForCategory], FinalizeMutationCount and XY.

Selection: Frequency (``.freq``, ``.lin``), Selection (``.sele``), Quality
(``.qual``), SDS (``.sds``) and FreqDiff (``.freqdiff``, ``.zfreqdiff``).

Extract: every mode of RelateExtract, ConvertNewickToTimeb among them
(``-i x`` reads ``x.newick``, one sampled tree a line; writes ``.timeb``).

FileFormats: ConvertFromVcf (``-i x.vcf[.gz]``), ConvertFromHapLegendSample
(``-i x``: ``x.hap.gz``, ``x.legend.gz``, ``x.sample``), the ``.haps``
modes on ``-i x`` (``x.haps.gz``, ``x.sample.gz``; RemoveNonBiallelicSNPs,
RemoveSamples ``--remove_ids``, FilterHapsUsingMask ``--mask``,
FlipHapsUsingAncestor ``--ancestor``, which write the ``.haps`` text to
``-o`` itself, and GenerateSNPAnnotations, ``.annot``),
ConvertToTreeSequence[Txt] (``.trees``, tskit file format 12) and the
importers ConvertFromNewick, ConvertFromRent (``-N`` scales the branch
lengths), ConvertFromArgweaverSMC and ConvertFromMsPrime (``.anc``).

TreeView: TreeView and TreeViewSample (``.coords`` at ``--bp_of_interest``,
and a ``.png`` when matplotlib imports), MutationsOnBranches (``.muts``)
and BranchesBelowMutation (``.branches``).

Extract, FileFormats and TreeView are host code. The other tools run on the
CUDA card; ``--device cpu`` asks for the host. ``--devices N`` runs
CoalescentRate's EstimatePopulationSize (also with ``--poplabels``),
EstimatePopulationSizeEM and SampleBranchLengths on the first N cards of
the host (``parallel.mesh.default_mesh``, which raises if fewer are
visible): the chain parts of EstimatePopulationSizeEM (its draws and its
final re-estimate) and of SampleBranchLengths go to a pool of one process
a card (``parallel.pool.CardPool``) where there are two parts or more, and
the coalescence statistics run on the first card, as EstimatePopulationSize
does, since more cards driven from one process were no faster. The files
are those of one card. It does not go with ``--device`` nor with another
tool or mode. ``Relate --mode All --devices N`` is ``pipeline/cli.py``'s.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

# the CoalescentRate modes that take --devices
MESH_MODES = ("EstimatePopulationSize", "EstimatePopulationSizeEM",
              "SampleBranchLengths")
TOOLS = ("CoalescentRate", "MutationRate", "Selection", "Extract",
         "TreeView", "FileFormats")
COALESCENT_RATE_MODES = ("EstimatePopulationSize", "CoalRateForTree",
                         "GenerateConstCoalFile", "ReEstimateBranchLengths",
                         "SampleBranchLengths", "EstimatePopulationSizeEM")
MUTATION_RATE_SUMMARIES = ("SummarizeForGenome",
                           "SummarizeForGenomeForCategory", "Finalize",
                           "FinalizeForCategory", "FinalizeMutationCount",
                           "XY")
MUTATION_RATE_CONTEXT_MODES = ("WithContext", "WithContextForChromosome",
                               "MutationRateForCategory",
                               "ForCategoryForChromosome",
                               "ForCategoryForPopForChromosome")
MUTATION_RATE_MODES = (("Avg", "FinalizeAvg") + MUTATION_RATE_CONTEXT_MODES
                       + ("MutationDensity",) + MUTATION_RATE_SUMMARIES)
SELECTION_MODES = ("Frequency", "Selection", "Quality", "SDS", "FreqDiff")
EXTRACT_MODES = ("AncToNewick", "SubTreesForSubpopulation",
                 "AncMutForSubregion", "RemoveTreesWithFewMutations",
                 "ExtractDistFromMut", "DivideAncMut", "MapMutations",
                 "UnlinkTips", "GetMut", "AncientToModern",
                 "CountMutonBranches", "GetAllBranchesOfMut",
                 "CheckBranchPersistence", "GenerateSNPAnnotationsUsingTree")
HAPS_MODES = ("RemoveNonBiallelicSNPs", "RemoveSamples",
              "FilterHapsUsingMask", "FlipHapsUsingAncestor",
              "GenerateSNPAnnotations")
IMPORT_MODES = ("ConvertFromNewick", "ConvertFromRent",
                "ConvertFromArgweaverSMC", "ConvertFromMsPrime")
FILE_FORMATS_MODES = (("ConvertFromVcf", "ConvertFromHapLegendSample")
                      + HAPS_MODES + ("ConvertToTreeSequence",
                                      "ConvertToTreeSequenceTxt")
                      + IMPORT_MODES)
TREE_VIEW_MODES = ("TreeView", "TreeViewSample", "MutationsOnBranches",
                   "BranchesBelowMutation")


def _chr_list(args):
    """Chromosome names from --chr (file of names) or
    --first_chr..--last_chr (RelateCoalescentRate.cpp:57-79); None when
    neither is given (single whole-genome input)."""
    if args.chr:
        from ..io.haps import smart_open
        with smart_open(args.chr) as f:
            return [line.strip() for line in f if line.strip()]
    if args.first_chr is not None and args.last_chr is not None:
        if args.first_chr < 0 or args.last_chr < 0:
            raise SystemExit("Do not use negative chr indices.")
        return [str(c) for c in range(args.first_chr, args.last_chr + 1)]
    return None


def coalescent_rate(args):
    from ..evaluate import coalrate
    from ..utils.devmem import resolve_device
    from ..parallel import mesh as pm
    from . import scripts
    mesh = pm.default_mesh(args.devices) if args.devices else None
    device = mesh.first if mesh is not None else resolve_device(args.device)
    epochs = coalrate.epochs_from_bins(*args.bins, args.years_per_gen) \
        if args.bins else coalrate.default_epochs(args.years_per_gen)
    if args.mode == "EstimatePopulationSize":
        chrs = _chr_list(args)
        inputs = [args.input] if chrs is None else \
            [f"{args.input}_chr{c}" for c in chrs]
        group = None
        names = ["0"]
        per_chr = []
        for prefix in inputs:
            anc, recs, bp, dist, rsid, alleles = scripts._load_pair(prefix)
            spans = coalrate.tree_spans(anc, recs, dist)
            trees = [mt.tree for mt in anc.seq]
            if args.poplabels and group is None:
                if args.poplabels == "hap":
                    # per-haplotype-pair rates
                    # (FinalizePopulationSizeByHaplotype)
                    group = np.arange(anc.N)
                    names = [str(h) for h in range(anc.N)]
                else:
                    from ..io import haps as hio
                    pl = hio.read_poplabels(args.poplabels)
                    group = pl.group_of_haplotype[: anc.N]
                    names = pl.groups
            per_chr.append(coalrate.coalescence_stats(
                trees, spans, epochs, group, device=device))
        # genome-level sum: the in-memory replacement of the reference's
        # per-chromosome .bin sum (SummarizeCoalescentRateForGenome.cpp:8)
        c, o = coalrate.summarize_for_genome(per_chr)
        whole = coalrate.finalize_rates(c.sum(axis=(1, 2)), o.sum(axis=(1, 2)))
        coalrate.write_coal(args.output + ".coal", epochs, whole, ["0"])
        if group is not None:
            coalrate.write_coal(args.output + ".pairwise.coal", epochs,
                                coalrate.finalize_rates(c, o), names)
    elif args.mode == "CoalRateForTree":
        anc = scripts._load_pair(args.input)[0]
        trees = [mt.tree for mt in anc.seq]
        counts, opp, rates = coalrate.coal_rate_for_tree(trees, epochs,
                                                         device=device)
        np.savez(args.output + ".rates.npz", epochs=epochs, counts=counts,
                 opportunity=opp, rates=rates)
    elif args.mode == "GenerateConstCoalFile":
        coalrate.generate_const_coal(args.output + ".coal", args.effectiveN,
                                     epochs)
    elif args.mode == "ReEstimateBranchLengths":
        scripts.reestimate_branch_lengths(
            args.input, args.output, args.coal, mu=args.mutation_rate,
            seed=args.seed, poplabels_path=args.poplabels, device=device)
    elif args.mode == "SampleBranchLengths":
        scripts.sample_branch_lengths(
            args.input, args.output, args.coal, mu=args.mutation_rate,
            num_samples=args.num_samples, first_bp=args.first_bp,
            last_bp=args.last_bp, fmt=args.format, seed=args.seed,
            device=device, mesh=mesh)
    elif args.mode == "EstimatePopulationSizeEM":
        scripts.estimate_population_size(
            args.input, args.output, mu=args.mutation_rate,
            years_per_gen=args.years_per_gen, poplabels_path=args.poplabels,
            bins=args.bins, num_iter=args.num_iter, seed=args.seed,
            device=device, mesh=mesh)
    else:
        raise SystemExit(f"unknown mode {args.mode!r}; CoalescentRate takes "
                         + ", ".join(COALESCENT_RATE_MODES))


def _merged_mut_rows(recs, bp, dist, rsid, alleles,
                     extra_bp, extra_recs, extra_rsid, extra_alleles):
    """Interleave existing mutation records with newly-mapped extra SNPs by
    position; extras carry dist=0 (GetTreeOfInterest.cpp:250-259)."""
    from ..io import ancmut
    items = [(int(bp[i]), recs[i], int(dist[i]), rsid[i], alleles[i])
             for i in range(len(bp))]
    items += [(int(extra_bp[i]), extra_recs[i], 0, extra_rsid[i],
               extra_alleles[i]) for i in range(len(extra_bp))]
    items.sort(key=lambda t: t[0])
    rows = []
    for snp, (pos, m, d, rs, al) in enumerate(items):
        br = " ".join(str(b) for b in m.branch)
        rows.append(
            f"{snp};{pos};{d};{rs};{m.tree};{br};"
            f"{1 if len(m.branch) != 1 else 0};{int(m.flipped)};"
            f"{ancmut._fmt_g(m.age_begin)};{ancmut._fmt_g(m.age_end)};"
            f"{al};")
    return rows


def _keep_of(args, N):
    """The haplotypes whose group in ``--poplabels`` is one of the
    comma-separated ``--pop_of_interest``."""
    from ..io import haps as hio
    pl = hio.read_poplabels(args.poplabels)
    wanted = set(args.pop_of_interest.split(","))
    return [h for h in range(N)
            if pl.groups[pl.group_of_haplotype[h]] in wanted]


def mutation_rate(args):
    from ..evaluate import coalrate, mutrate
    from ..utils.devmem import resolve_device
    from . import scripts
    if args.mode not in MUTATION_RATE_MODES:
        raise SystemExit(f"unknown mode {args.mode!r}; MutationRate takes "
                         + ", ".join(MUTATION_RATE_MODES))
    if args.mode in MUTATION_RATE_SUMMARIES:
        return mutation_rate_summary(args)
    device = resolve_device(args.device)
    chrs = _chr_list(args)
    if chrs is not None:
        # per-chromosome loop + genome summarize + finalize
        # (RelateMutationRate ForChromosome modes -> SummarizeForGenome ->
        # Finalize; EstimatePopulationSize.sh:428-461)
        import copy
        outs = []
        for c in chrs:
            a = copy.copy(args)
            a.chr = None
            a.first_chr = a.last_chr = None
            a.input = f"{args.input}_chr{c}"
            a.output = f"{args.output}_chr{c}"
            mutation_rate(a)
            outs.append(a.output)
        a = copy.copy(args)
        a.input = ",".join(outs)
        a.mode = "SummarizeForGenomeForCategory" \
            if "Category" in args.mode or "Context" in args.mode \
            else "SummarizeForGenome"
        mutation_rate_summary(a)
        a.input = a.output
        a.mode = "FinalizeForCategory" if "ForCategory" in a.mode \
            else "Finalize"
        mutation_rate_summary(a)
        return
    anc, recs, bp, dist, rsid, alleles = scripts._load_pair(args.input)
    epochs = coalrate.epochs_from_bins(*args.bins, args.years_per_gen) \
        if args.bins else coalrate.default_epochs(args.years_per_gen)
    if args.mode in ("Avg", "FinalizeAvg"):
        m, o, r = mutrate.avg_mutation_rate(anc, recs, dist, epochs,
                                            device=device)
        mutrate.write_rate(args.output + "_avg.rate", epochs, r)
        np.savez(args.output + "_avg.npz", epochs=epochs, mutation=m,
                 opportunity=o)
    elif args.mode in MUTATION_RATE_CONTEXT_MODES:
        from ..io import haps as hio
        anc_seq = hio.read_fasta(args.ancestor)
        if args.mode == "ForCategoryForPopForChromosome" and args.poplabels:
            # restrict the trees to the population of interest first
            from ..io import extract
            anc, recs = extract.subtrees_for_subpopulation(
                anc, recs, _keep_of(args, anc.N))
        ancestral = [a.split("/")[0] for a in alleles]
        alternative = [a.split("/")[1] if "/" in a else "N" for a in alleles]
        cats, names = mutrate.categorize_snps(bp, ancestral, alternative,
                                              anc_seq)
        m, o, r = mutrate.avg_mutation_rate(anc, recs, dist, epochs,
                                            categories=cats,
                                            num_categories=len(names),
                                            device=device)
        _write_cat_rate(args.output + ".rate", epochs, names, r)
        np.savez(args.output + "_bycat.npz", epochs=epochs, mutation=m,
                 opportunity=o, names=np.asarray(names))
    else:
        m, o = mutrate.mutation_density(anc, recs, dist, epochs,
                                        args.sample_id)
        np.savez(args.output + ".density.npz", epochs=epochs, mutation=m,
                 opportunity=o)


def _write_cat_rate(path, epochs, names, r):
    with open(path, "w") as f:
        f.write("epoch " + " ".join(names) + "\n")
        for e in range(len(epochs)):
            row = r[e] if np.ndim(r[e]) else [r[e]]
            f.write(f"{epochs[e]:g} " + " ".join(f"{x:g}" for x in row)
                    + "\n")


def mutation_rate_summary(args):
    """Genome-level aggregation modes that consume per-chromosome .npz
    stats instead of anc/mut (SummarizeForGenome[ForCategory],
    Finalize[ForCategory], FinalizeMutationCount, XY;
    RelateMutationRate.cpp:3453-3634). ``--input`` is a comma-separated
    list of per-chromosome output prefixes. Host code."""
    suffix = "_bycat.npz" if "ForCategory" in args.mode else "_avg.npz"
    parts = [np.load(p + suffix, allow_pickle=True)
             for p in args.input.split(",")]
    epochs = parts[0]["epochs"]
    m = sum(p["mutation"] for p in parts)
    o = sum(p["opportunity"] for p in parts)
    names = (list(parts[0]["names"]) if "names" in parts[0].files
             else ["all"])
    if args.mode.startswith("SummarizeForGenome"):
        np.savez(args.output + suffix, epochs=epochs, mutation=m,
                 opportunity=o, names=np.asarray(names))
    elif args.mode in ("Finalize", "FinalizeForCategory"):
        r = np.where(o > 0, m / np.maximum(o, 1e-300), 0.0)
        _write_cat_rate(args.output + ".rate", epochs, names, r)
    elif args.mode == "FinalizeMutationCount":
        _write_cat_rate(args.output + ".count", epochs, names, m)
    else:
        # XY: the ratio of the X to the autosome mutation rate per epoch
        if len(parts) < 2:
            raise SystemExit("XY needs two inputs: autosomes,chrX")
        ra, rx = (np.where(p["opportunity"] > 0, p["mutation"]
                           / np.maximum(p["opportunity"], 1e-300), 0.0)
                  for p in parts[:2])
        ratio = np.where(ra > 0, rx / np.maximum(ra, 1e-300), 0.0)
        _write_cat_rate(args.output + ".xy", epochs, names, ratio)


def selection_tool(args):
    from ..evaluate import coalrate, selection
    from ..utils.devmem import resolve_device
    from . import scripts
    device = resolve_device(args.device)
    if args.mode not in SELECTION_MODES:
        raise SystemExit(f"unknown mode {args.mode!r}; Selection takes "
                         + ", ".join(SELECTION_MODES))
    anc, recs, bp, dist, rsid, alleles = scripts._load_pair(args.input)
    epochs = coalrate.default_epochs(args.years_per_gen)
    if args.mode == "Frequency":
        rows = selection.compute_freq_lin(anc, recs, epochs, bp, rsid,
                                          device=device)
        selection.write_freq_lin(args.output, rows, epochs)
    elif args.mode == "Selection":
        rows, scan = selection.selection_scan(anc, recs, epochs, bp, rsid,
                                              device=device)
        selection.write_sele(args.output + ".sele", scan, epochs)
    elif args.mode == "Quality":
        selection.write_quality(args.output + ".qual",
                                selection.quality(anc, recs))
    elif args.mode == "SDS":
        rows = selection.sds(anc, recs, bp, rsid, device=device)
        selection.write_sds(args.output + ".sds", rows)
    else:
        rows = selection.compute_freq_lin(anc, recs, epochs, bp, rsid,
                                          device=device)
        diffs, zdiffs = selection.freq_diff(rows, anc.N)
        selection.write_freqdiff(args.output, diffs, zdiffs, epochs)


def extract_tool(args):
    """RelateExtract's modes: host code over the tree sequence, so
    ``--device`` plays no part."""
    from ..io import ancmut, extract
    from .scripts import _dump_pair, _load_pair
    if args.mode == "ConvertNewickToTimeb":
        extract.convert_newick_to_timeb(args.input + ".newick",
                                        args.output + ".timeb")
        return
    if args.mode == "CombineAncMut":
        # inverse of DivideAncMut: chunks live at <output>_chr<i>; their
        # per-chunk metadata is concatenated, NOT taken from --input
        # (extract/AncMutChunks.cpp:214-325)
        import os
        parts, bps, dists, rsids, alls = [], [], [], [], []
        i = 1
        while os.path.exists(f"{args.output}_chr{i}.anc"):
            a, m, b, d, r, al = _load_pair(f"{args.output}_chr{i}")
            parts.append((a, m))
            bps.append(b)
            dists.append(d)
            rsids.extend(r)
            alls.extend(al)
            i += 1
        if not parts:
            raise SystemExit(f"no chunks found at {args.output}_chr1.anc")
        anc2, recs2 = extract.combine_anc_mut(parts)
        _dump_pair(args.output, anc2, recs2, np.concatenate(bps),
                   np.concatenate(dists), rsids, alls)
        return
    if args.mode not in EXTRACT_MODES:
        raise SystemExit(f"unknown mode {args.mode!r}; Extract takes "
                         "ConvertNewickToTimeb, CombineAncMut, "
                         + ", ".join(EXTRACT_MODES))
    anc, recs, bp, dist, rsid, alleles = _load_pair(args.input)
    if args.mode == "AncToNewick":
        nw = extract.anc_to_newick(anc, recs, bp, args.first_bp,
                                   args.last_bp)
        with open(args.output + ".newick", "w") as f:
            f.write("\n".join(nw) + "\n")
    elif args.mode == "SubTreesForSubpopulation":
        sub_anc, sub_muts = extract.subtrees_for_subpopulation(
            anc, recs, _keep_of(args, anc.N))
        _dump_pair(args.output, sub_anc, sub_muts, bp, dist, rsid, alleles)
    elif args.mode == "AncMutForSubregion":
        sub, subm, (lo, hi) = extract.anc_mut_for_subregion(
            anc, recs, bp, args.first_bp, args.last_bp)
        _dump_pair(args.output, sub, subm, bp[lo:hi + 1], dist[lo:hi + 1],
                   rsid[lo:hi + 1], alleles[lo:hi + 1])
    elif args.mode == "RemoveTreesWithFewMutations":
        anc2, recs2 = extract.remove_trees_with_few_mutations(
            anc, recs, args.threshold)
        _dump_pair(args.output, anc2, recs2, bp, dist, rsid, alleles)
    elif args.mode == "ExtractDistFromMut":
        extract.extract_dist_from_mut(
            [{"pos": bp[i], "dist": int(dist[i])} for i in range(len(bp))],
            args.output + ".dist")
    elif args.mode == "DivideAncMut":
        off = 0
        for i, (a, m) in enumerate(extract.divide_anc_mut(anc, recs,
                                                          args.threads)):
            n = len(m)
            _dump_pair(f"{args.output}_chr{i+1}", a, m, bp[off:off + n],
                       dist[off:off + n], rsid[off:off + n],
                       alleles[off:off + n])
            off += n
    elif args.mode == "MapMutations":
        # read extra SNPs from a second haps/sample pair, map each onto the
        # tree covering its position, and write a merged .mut; SNPs at
        # already-existing positions are skipped
        # (extract/GetTreeOfInterest.cpp:128-290)
        if not args.haps or not args.sample:
            raise SystemExit("MapMutations needs --haps and --sample for "
                             "the extra SNPs")
        from ..io import haps as hio
        data = hio.read_haps(args.haps, args.sample)
        new = ~np.isin(data.bp, bp)
        extras = extract.map_extra_mutations(
            anc, recs, bp, data.bp[new], data.genotypes[new])
        rows = _merged_mut_rows(
            recs, bp, dist, rsid, alleles,
            data.bp[new], extras,
            [data.rsid[i] for i in np.nonzero(new)[0]],
            [f"{data.ancestral[i]}/{data.alternative[i]}"
             for i in np.nonzero(new)[0]])
        ancmut.write_mut_final(args.output + ".mut", rows)
    elif args.mode == "UnlinkTips":
        tips = [int(x) for x in args.pop_of_interest.split(",") if x]
        anc2 = extract.unlink_tips(anc, tips)
        _dump_pair(args.output, anc2, recs, bp, dist, rsid, alleles)
    elif args.mode == "GetMut":
        extract.get_mut(anc, recs)
        _dump_pair(args.output, anc, recs, bp, dist, rsid, alleles)
    elif args.mode == "AncientToModern":
        anc2 = extract.ancient_to_modern(anc)
        _dump_pair(args.output, anc2, recs, bp, dist, rsid, alleles)
    elif args.mode == "CountMutonBranches":
        rows = extract.count_mut_on_branches(anc, recs)
        with open(args.output + ".mutcount", "w") as f:
            f.write("tree branch count\n")
            for t, b, c in rows:
                f.write(f"{t} {b} {c}\n")
    elif args.mode == "GetAllBranchesOfMut":
        with open(args.output + ".branches", "w") as f:
            f.write("snp branches\n")
            for snp, brs in extract.all_branches_of_mut(recs):
                f.write(f"{snp} {' '.join(str(b) for b in brs)}\n")
    elif args.mode == "CheckBranchPersistence":
        per = extract.check_branch_persistence(anc, recs, bp)
        with open(args.output + ".persistence", "w") as f:
            f.write("snp bp persisted_bases\n")
            for snp, v in enumerate(per):
                f.write(f"{snp} {bp[snp]} {v:g}\n")
    else:
        rows = extract.generate_snp_annotations_using_tree(anc, recs, bp,
                                                           alleles)
        with open(args.output + ".annot", "w") as f:
            f.write("upstream_allele;downstream_allele;\n")
            f.write("\n".join(rows) + "\n")


def fileformats_tool(args):
    """RelateFileFormats (FileFormats.cpp:17-1128, the anc.cpp importers
    and ConvertToTreeSequence.cpp); host code."""
    from ..io import ancmut, fileformats, importers
    from ..io import haps as hio
    from .scripts import _load_pair
    if args.mode not in FILE_FORMATS_MODES:
        raise SystemExit(f"unknown mode {args.mode!r}; FileFormats takes "
                         + ", ".join(FILE_FORMATS_MODES))
    if args.mode == "ConvertFromVcf":
        fileformats.convert_from_vcf(args.input, args.output)
    elif args.mode == "ConvertFromHapLegendSample":
        fileformats.convert_from_hap_legend_sample(
            args.input + ".hap.gz", args.input + ".legend.gz",
            args.input + ".sample", args.output)
    elif args.mode in HAPS_MODES:
        data = hio.read_haps(args.input + ".haps.gz",
                             args.input + ".sample.gz")
        if args.mode == "RemoveNonBiallelicSNPs":
            data, _ = fileformats.remove_non_biallelic_snps(data)
        elif args.mode == "RemoveSamples":
            # writes the .haps without a matching .sample, as the JAX CLI
            # (ROADMAP section C)
            with open(args.remove_ids) as f:
                drop_names = {x.strip() for x in f if x.strip()}
            _, ids = hio.read_sample(args.input + ".sample.gz")
            drop = [i for i, x in enumerate(ids)
                    if x.rsplit("_", 1)[0] in drop_names]
            data = fileformats.remove_samples(data, drop)
        elif args.mode == "FilterHapsUsingMask":
            data, _ = fileformats.filter_haps_using_mask(
                data, hio.read_fasta(args.mask))
        elif args.mode == "FlipHapsUsingAncestor":
            data, _ = fileformats.flip_haps_using_ancestor(
                data, hio.read_fasta(args.ancestor))
        else:
            anc_seq = hio.read_fasta(args.ancestor) if args.ancestor else None
            pl = hio.read_poplabels(args.poplabels) if args.poplabels \
                else None
            header, rows = fileformats.generate_snp_annotations(
                data, anc_seq, pl)
            with open(args.output + ".annot", "w") as f:
                f.write(header + "\n")
                f.write("\n".join(rows) + "\n")
            return
        fileformats.write_haps(data, args.output)
    elif args.mode in ("ConvertToTreeSequence", "ConvertToTreeSequenceTxt"):
        anc, recs, bp, dist, rsid, alleles = _load_pair(args.input)
        fileformats.to_tree_sequence(anc, recs, bp, args.output + ".trees",
                                     alleles=alleles)
    else:
        if args.mode == "ConvertFromNewick":
            anc = importers.read_newick(args.input, args.effectiveN)
        elif args.mode == "ConvertFromRent":
            anc = importers.read_rent(args.input, args.effectiveN)
        elif args.mode == "ConvertFromArgweaverSMC":
            anc = importers.read_argweaver_smc(args.input)
        else:
            anc = importers.read_msprime(args.input)
        ancmut.write_anc_text(args.output + ".anc", anc)


def treeview_tool(args):
    """RelateTreeView's four modes (treeview/RelateTreeView.cpp:29-44);
    host code. The ``.png`` of TreeView needs matplotlib and is left out
    without it; the ``.coords`` file is always written."""
    from ..io import treeview
    from .scripts import _load_pair
    mode = args.mode or "TreeView"
    if mode not in TREE_VIEW_MODES:
        raise SystemExit(f"unknown mode {mode!r}; TreeView takes "
                         + ", ".join(TREE_VIEW_MODES))
    anc, recs, bp, dist, rsid, alleles = _load_pair(args.input)
    if mode in ("TreeView", "TreeViewSample"):
        t = treeview.tree_at_bp(anc, recs, bp, args.bp_of_interest)
        treeview.write_plot_coords(args.output + ".coords", anc, recs, t)
        try:
            treeview.render_tree(anc.seq[t].tree, args.output + ".png",
                                 anc.sample_ages)
        except ImportError:
            pass
    elif mode == "MutationsOnBranches":
        t = treeview.tree_at_bp(anc, recs, bp, args.bp_of_interest)
        by_branch = treeview.mutations_on_branches(anc, recs, t)
        with open(args.output + ".muts", "w") as f:
            f.write("branch snp pos\n")
            for b in sorted(by_branch):
                for snp in by_branch[b]:
                    f.write(f"{b} {snp} {bp[snp]}\n")
    else:
        snp = int(np.searchsorted(bp, args.bp_of_interest, side="right")) - 1
        snp = min(max(snp, 0), len(recs) - 1)
        nodes = treeview.branches_below_mutation(anc, recs, snp)
        tree = anc.seq[recs[snp].tree].tree
        coords = tree.coordinates(anc.sample_ages)
        with open(args.output + ".branches", "w") as f:
            f.write("node parent age\n")
            for v in nodes:
                f.write(f"{v} {tree.parent[v]} {coords[v]:g}\n")


def build_parser():
    p = argparse.ArgumentParser(prog="relate_tpu_torch.tools")
    p.add_argument("tool", choices=TOOLS)
    p.add_argument("--mode", default="")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--haps")
    p.add_argument("--sample")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-m", "--mutation_rate", type=float, default=1.25e-8)
    p.add_argument("-N", "--effectiveN", type=float, default=3e4)
    p.add_argument("--coal")
    p.add_argument("--poplabels")
    p.add_argument("--pop_of_interest", default="")
    p.add_argument("--ancestor")
    p.add_argument("--years_per_gen", type=float, default=28.0)
    # multi-chromosome looping (RelateCoalescentRate.cpp:57-79):
    # --chr = file of chromosome names; or an integer range
    p.add_argument("--chr")
    p.add_argument("--first_chr", type=int)
    p.add_argument("--last_chr", type=int)
    p.add_argument("--bins", type=lambda s: tuple(map(float, s.split(","))))
    p.add_argument("--num_iter", type=int, default=10)
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--first_bp", type=int)
    p.add_argument("--last_bp", type=int)
    p.add_argument("--bp_of_interest", type=int, default=0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--sample_id", type=int, default=0)
    p.add_argument("--format", default="anc")
    p.add_argument("--mask")
    p.add_argument("--remove_ids")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--devices", type=int, default=0,
                   help="ask for N CUDA cards (CoalescentRate --mode "
                        + ", ".join(MESH_MODES) + "); raises if fewer "
                        "are visible; the chain parts go to a process a "
                        "card, the rest runs on the first; 0: one device")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (an error if "
                        "there is none). 'cpu' runs on the host.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices:
        if args.device is not None:
            raise SystemExit("--devices N runs on the first N cards; it "
                             "does not go with --device")
        if args.tool != "CoalescentRate" or args.mode not in MESH_MODES:
            raise SystemExit(
                "--devices applies to CoalescentRate --mode "
                + ", ".join(MESH_MODES) + f", not {args.tool} --mode "
                + (args.mode or "(none)"))
    from ..utils.trace import stage
    with stage(f"{args.tool}.{args.mode or 'default'}"):
        {"CoalescentRate": coalescent_rate, "MutationRate": mutation_rate,
         "Selection": selection_tool, "Extract": extract_tool,
         "FileFormats": fileformats_tool, "TreeView": treeview_tool}[
             args.tool](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI of the post-inference tools, mirroring the reference binary
RelateCoalescentRate; counterpart of ``relate_tpu/pipeline/tools_cli.py``.

Usage:
  python -m relate_tpu_torch.pipeline.tools_cli CoalescentRate \
      --mode EstimatePopulationSize -i in -o out [--poplabels x.poplabels]
      [--chr chrs.txt | --first_chr 1 --last_chr 22] [--bins 3,7,0.2]

The modes of CoalescentRate: EstimatePopulationSize (``.coal`` and, with
``--poplabels`` or ``--poplabels hap``, ``.pairwise.coal``),
CoalRateForTree (``.rates.npz``), GenerateConstCoalFile,
ReEstimateBranchLengths (``--coal``, with ``--poplabels`` the pairwise
prior), SampleBranchLengths (``--coal``, ``--format anc|newick|timeb``) and
EstimatePopulationSizeEM (``--num_iter``). They run on the CUDA card;
``--device cpu`` asks for the host. The other tools (MutationRate,
Selection, Extract, TreeView, FileFormats) and ``--devices`` are not ported
yet and exit with the ROADMAP item that names them.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

TOOLS = ("CoalescentRate", "MutationRate", "Selection", "Extract",
         "TreeView", "FileFormats")
COALESCENT_RATE_MODES = ("EstimatePopulationSize", "CoalRateForTree",
                         "GenerateConstCoalFile", "ReEstimateBranchLengths",
                         "SampleBranchLengths", "EstimatePopulationSizeEM")
# the ROADMAP (section A) item of each tool not ported yet
NOT_PORTED = {"MutationRate": 2, "Selection": 2, "Extract": 3,
              "TreeView": 3, "FileFormats": 3}


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
    from . import scripts
    device = resolve_device(args.device)
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
            device=device)
    elif args.mode == "EstimatePopulationSizeEM":
        scripts.estimate_population_size(
            args.input, args.output, mu=args.mutation_rate,
            years_per_gen=args.years_per_gen, poplabels_path=args.poplabels,
            bins=args.bins, num_iter=args.num_iter, seed=args.seed,
            device=device)
    else:
        raise SystemExit(f"unknown mode {args.mode!r}; CoalescentRate takes "
                         + ", ".join(COALESCENT_RATE_MODES))


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
                   help="several cards: not ported yet (ROADMAP section A, "
                        "item 4)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (an error if "
                        "there is none). 'cpu' runs on the host.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices:
        raise SystemExit("--devices (several cards) is not ported yet: "
                         "ROADMAP section A, item 4")
    if args.tool in NOT_PORTED:
        raise SystemExit(f"the {args.tool} tool is not ported yet: ROADMAP "
                         f"section A, item {NOT_PORTED[args.tool]}")
    from ..utils.trace import stage
    with stage(f"{args.tool}.{args.mode or 'default'}"):
        coalescent_rate(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface mirroring the reference ``Relate`` binary modes
(include/pipeline/Relate.cpp:60-314), for the stages that are ported.

Usage:
  python -m relate_tpu_torch.pipeline.cli --mode MakeChunks --haps x.haps.gz \
      --sample x.sample.gz --map map.txt -o out
  python -m relate_tpu_torch.pipeline.cli --mode Paint -o out
  python -m relate_tpu_torch.pipeline.cli --mode BuildTopology -o out --seed 1

The stages run on the CUDA card; ``--device cpu`` asks for the host.
"""
from __future__ import annotations

import argparse
import sys

from . import relate
from ..io.chunking import ArtifactStore
from ..utils.trace import stage

PORTED = ("MakeChunks", "Paint", "BuildTopology")
NOT_PORTED = ("All", "FindEquivalentBranches", "InferBranchLengths",
              "CombineSections", "Finalize", "PostProcess",
              "OptimizeParameters", "Clean")


def build_parser():
    p = argparse.ArgumentParser(prog="relate_tpu_torch")
    p.add_argument("--mode", required=True, choices=PORTED + NOT_PORTED)
    p.add_argument("--haps")
    p.add_argument("--sample")
    p.add_argument("--map", dest="map_path")
    p.add_argument("--dist")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--memory", type=float, default=None,
                   help="window-planner budget in GB; default: sized from "
                        "the card's memory")
    p.add_argument("--theta", type=float, default=0.001)
    p.add_argument("--sample_ages")
    p.add_argument("--chunk_index", type=int, default=0)
    p.add_argument("--first_section", type=int, default=0)
    p.add_argument("--last_section", type=int, default=None)
    p.add_argument("--no_consistency", action="store_true")
    p.add_argument("--anc_allele_unknown", action="store_true")
    p.add_argument("--transversion", action="store_true")
    p.add_argument("--fb", type=int, default=0)
    # --painting "theta,rho" overrides the painting parameters
    # (Paint.cpp:38-61); rho multiplies the per-SNP recombination rates
    p.add_argument("--painting",
                   type=lambda s: tuple(map(float, s.split(","))))
    p.add_argument("--store")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (an error if "
                        "there is none). 'cpu' runs the plain versions.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = args.output
    mode = args.mode
    if mode in NOT_PORTED:
        print(f"relate_tpu_torch: mode {mode} is not ported yet "
              f"(ported: {', '.join(PORTED)})", file=sys.stderr)
        return 2
    theta = args.theta
    rho_scale = 1.0
    if args.painting:
        theta, rho_scale = args.painting

    with stage(mode):
        store = ArtifactStore(args.store if args.store else out)
        if mode == "MakeChunks":
            relate.make_chunks(args.haps, args.sample, args.map_path, out,
                               args.memory, args.dist, not args.transversion,
                               args.sample_ages, device=args.device)
        elif mode == "Paint":
            relate.paint(store, args.chunk_index, theta, rho_scale=rho_scale,
                         device=args.device)
        elif mode == "BuildTopology":
            relate.build_topology(store, args.chunk_index, seed=args.seed,
                                  theta=theta, rho_scale=rho_scale,
                                  mode=0 if args.no_consistency else 1,
                                  ancestral_state=not args.anc_allele_unknown,
                                  fb=args.fb,
                                  first_section=args.first_section,
                                  last_section=args.last_section,
                                  device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

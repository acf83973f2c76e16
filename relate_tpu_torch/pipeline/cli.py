"""Command-line interface mirroring the reference ``Relate`` binary modes
(include/pipeline/Relate.cpp:60-314).

Usage:
  python -m relate_tpu_torch.pipeline.cli --mode All --haps x.haps.gz \
      --sample x.sample.gz --map map.txt -N 30000 -m 1.25e-8 -o out --seed 1
or stage by stage, on one store:
  python -m relate_tpu_torch.pipeline.cli --mode MakeChunks --haps x.haps.gz \
      --sample x.sample.gz --map map.txt -o out
  python -m relate_tpu_torch.pipeline.cli --mode Paint -o out
  python -m relate_tpu_torch.pipeline.cli --mode BuildTopology -o out --seed 1
  ... FindEquivalentBranches, InferBranchLengths, CombineSections ...
  python -m relate_tpu_torch.pipeline.cli --mode Finalize -o final --store out

PostProcess (after FindEquivalentBranches; ``--randomise``) refines a
store's trees and associates them again; OptimizeParameters writes
``<out>.opt`` from a store (``--input`` grid file); Clean
removes ``<out>.tmpdir``; ``--mode All --postprocess`` runs PostProcess
inside ``run_all``.

The stages run on the CUDA card; ``--device cpu`` asks for the host.
``--devices N`` runs the modes All, Paint, BuildTopology and
InferBranchLengths on the first N cards of the host
(``parallel.mesh.default_mesh``; it raises if fewer are visible, and it
does not go with ``--device``); InferBranchLengths then runs one process a
card (``parallel.pool.CardPool``). ``--num_hosts H --host_id k`` runs ``--mode
All`` as host k of H on one shared store (the same command on every host,
each with its own cards): host 0 plans the chunks and finalizes, chunk c
runs on host c mod H, and a host that waits longer than
``--barrier_timeout`` seconds for the plan or the other hosts' chunks
raises. ``--sample_ages`` (All, MakeChunks) and
``--anc_allele_unknown`` (BuildTopology) send BuildTopology to the host
topology builder.
"""
from __future__ import annotations

import argparse
import shutil
import sys

import numpy as np

from . import relate
from ..io.chunking import ArtifactStore
from ..parallel.mesh import default_mesh
from ..utils.trace import stage

MODES = ("All", "MakeChunks", "Paint", "BuildTopology",
         "FindEquivalentBranches", "InferBranchLengths", "CombineSections",
         "Finalize", "PostProcess", "OptimizeParameters", "Clean")
# the modes that take --devices
MESH_MODES = ("All", "Paint", "BuildTopology", "InferBranchLengths")


def build_parser():
    p = argparse.ArgumentParser(prog="relate_tpu_torch")
    p.add_argument("--mode", required=True, choices=MODES)
    p.add_argument("--haps")
    p.add_argument("--sample")
    p.add_argument("--map", dest="map_path")
    p.add_argument("--dist")
    p.add_argument("-N", "--effectiveN", type=float, default=3e4)
    p.add_argument("-m", "--mutation_rate", type=float, default=1.25e-8)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--memory", type=float, default=None,
                   help="window-planner budget in GB; default: sized from "
                        "the card's memory")
    p.add_argument("--theta", type=float, default=0.001)
    p.add_argument("--coal")
    p.add_argument("--annot")
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
    p.add_argument("--postprocess", action="store_true")
    p.add_argument("--randomise", action="store_true")
    # OptimizeParameters --input: line 1 thetas, line 2 rho factors
    p.add_argument("--input")
    # Finalize: where the stage artifacts live. Defaults to <output>.tmpdir
    # (the run_all layout); the per-stage flow passes the MakeChunks -o dir
    p.add_argument("--store")
    # host thread pool over chunks (RelateParallel.sh --threads): a chunk's
    # host-bound stages overlap with other chunks' device work
    p.add_argument("--threads", type=int, default=1)
    # several cards of this host (RelateParallel.sh --threads over
    # sections): Paint cuts the targets over the first N cards,
    # BuildTopology gives them whole sections, InferBranchLengths runs on
    # the first
    p.add_argument("--devices", type=int, default=0,
                   help="run on the first N CUDA cards (modes "
                        + ", ".join(MESH_MODES) + "); 0: one device")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (an error if "
                        "there is none). 'cpu' runs the plain versions.")
    # several hosts on one shared store (--mode All): the reference's job
    # arrays over a shared filesystem (RelateParallel.sh)
    p.add_argument("--num_hosts", type=int, default=1,
                   help="--mode All on this many hosts, one process each, "
                        "on one shared store")
    p.add_argument("--host_id", type=int, default=0,
                   help="which of the --num_hosts this process is (0: plans "
                        "and finalizes)")
    p.add_argument("--barrier_timeout", type=float, default=86400.0,
                   help="seconds a host waits for the plan or the other "
                        "hosts' chunks before it raises")
    return p


def read_coal_file(path: str):
    """Parse a .coal file: line 1 group names, line 2 epoch boundaries
    (generations), then 'g1 g2 rate...' rows
    (FinalizePopulationSize.cpp:96-110)."""
    with open(path) as f:
        f.readline()
        epochs = np.asarray([float(x) for x in f.readline().split()])
        line = f.readline().split()
        rates = np.asarray([float(x) for x in line[2:]])
    return epochs, rates


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = args.output
    mode = args.mode
    coal = read_coal_file(args.coal) if args.coal else None
    theta = args.theta
    rho_scale = 1.0
    if args.painting:
        theta, rho_scale = args.painting
    if (args.num_hosts != 1 or args.host_id != 0) and mode != "All":
        raise SystemExit(f"--num_hosts and --host_id apply to --mode All, "
                         f"not {mode}")
    mesh = None
    if args.devices:
        if args.device is not None:
            raise SystemExit("--devices N runs on the first N cards; it "
                             "does not go with --device")
        if mode not in MESH_MODES:
            raise SystemExit(f"--devices applies to the modes "
                             f"{', '.join(MESH_MODES)}, not {mode}")
        mesh = default_mesh(args.devices)

    if mode == "All":
        relate.run_all(args.haps, args.sample, args.map_path, out,
                       Ne=args.effectiveN, mu=args.mutation_rate,
                       seed=args.seed, memory_gb=args.memory, theta=theta,
                       dist_path=args.dist,
                       use_transitions=not args.transversion,
                       sample_ages_path=args.sample_ages, coal=coal,
                       rho_scale=rho_scale, postprocess=args.postprocess,
                       annot_path=args.annot, threads=args.threads,
                       device=args.device, mesh=mesh,
                       num_hosts=args.num_hosts, host_id=args.host_id,
                       barrier_timeout_s=args.barrier_timeout)
        return 0

    with stage(mode):
        store = ArtifactStore(args.store if args.store else
                              (out if mode != "Finalize"
                               else out + ".tmpdir"))
        if mode == "MakeChunks":
            relate.make_chunks(args.haps, args.sample, args.map_path, out,
                               args.memory, args.dist, not args.transversion,
                               args.sample_ages, device=args.device)
        elif mode == "Paint":
            relate.paint(store, args.chunk_index, theta, rho_scale=rho_scale,
                         device=args.device, mesh=mesh)
        elif mode == "BuildTopology":
            relate.build_topology(store, args.chunk_index, seed=args.seed,
                                  theta=theta, rho_scale=rho_scale,
                                  mode=0 if args.no_consistency else 1,
                                  ancestral_state=not args.anc_allele_unknown,
                                  fb=args.fb,
                                  first_section=args.first_section,
                                  last_section=args.last_section,
                                  device=args.device, mesh=mesh)
        elif mode == "FindEquivalentBranches":
            relate.find_equivalent_branches(store, args.chunk_index,
                                            device=args.device)
        elif mode == "PostProcess":
            # PostProcess + re-association, as Relate.cpp:296-302
            relate.post_process_chunk(store, args.chunk_index,
                                      seed=args.seed,
                                      randomise=args.randomise,
                                      device=args.device)
            relate.find_equivalent_branches(store, args.chunk_index,
                                            device=args.device)
        elif mode == "InferBranchLengths":
            epochs, rates = coal if coal else (None, None)
            relate.infer_branch_lengths(store, args.chunk_index,
                                        Ne=args.effectiveN,
                                        mu=args.mutation_rate, seed=args.seed,
                                        epochs=epochs, rates=rates,
                                        first_section=args.first_section,
                                        last_section=args.last_section,
                                        device=args.device, mesh=mesh)
        elif mode == "CombineSections":
            relate.combine_sections(store, args.chunk_index)
        elif mode == "OptimizeParameters":
            thetas = rhos = None
            if args.input:
                thetas, rhos = relate.read_opt_grid(args.input)
            results = relate.optimize_parameters(
                store, args.chunk_index, thetas=thetas, rho_scales=rhos,
                seed=args.seed, device=args.device)
            relate.write_opt(out + ".opt", results)
        elif mode == "Finalize":
            relate.finalize(store, out, annot_path=args.annot)
        elif mode == "Clean":
            shutil.rmtree(out + ".tmpdir", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

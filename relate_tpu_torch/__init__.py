"""relate_tpu_torch: the PyTorch/CUDA port of relate-tpu.

Same sub-package and module names as ``relate_tpu`` so that a reader finds
each counterpart. The package imports ``torch`` and ``numpy`` only. What is
ported so far is the main path, ``Relate --mode All`` (MakeChunks, Paint,
BuildTopology, FindEquivalentBranches, InferBranchLengths, CombineSections,
Finalize; ``pipeline.relate.run_all``) up to 16384 haplotypes, with
hand-written CUDA kernels for the painting sweeps, the two dense merge scans
(up to 1024 and 2048 haplotypes) and the incremental merge scan above that
(``csrc/``, built at first use by ``ops/_build.py``).

Every entry point takes ``device=None``, which means the CUDA card and
raises when there is none; pass ``device="cpu"`` to run the plain PyTorch
versions on the host.
"""

__version__ = "0.3.0"

"""relate_tpu_torch: the PyTorch/CUDA port of relate-tpu.

Same sub-package and module names as ``relate_tpu`` so that a reader finds
each counterpart. The package imports ``torch`` and ``numpy`` only. What is
ported so far is the first three pipeline stages (MakeChunks, Paint,
BuildTopology) with hand-written CUDA kernels for the painting sweeps and
the dense merge scan (``csrc/``, built at first use by ``ops/_build.py``).

Every entry point takes ``device=None``, which means the CUDA card and
raises when there is none; pass ``device="cpu"`` to run the plain PyTorch
versions on the host.
"""

__version__ = "0.1.0"

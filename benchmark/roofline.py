"""Peaks of one NVIDIA H100 SXM and the least time of each kernel.

The arithmetic is copied from ``chip_smoke.py`` (``make_row``,
``sweep_rows``, ``merge_scan_row``, ``merge_scan_large_row``): bytes over
the memory rate, each input read once and each output written once;
operations over the float32 rate outside the tensor cores; the larger of
the two is the bound. The sweeps' counts follow the steps each target
walks (``D``, the wanted rows), so they are read from the launch's own
arguments.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
L2_BYTES = 50e6                # what is re-read from below this stays on chip


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def _small(Dmax: int, B: int, N: int) -> int:
    return 3 * B * N * 4 + 2 * B * Dmax * 4 + Dmax * B * 4


def paint_fwd(Dmax: int, B: int, N: int, cells: int) -> float:
    """B1, the forward full sweep: ``cells`` = the sum of D."""
    return bound_s((cells - B) * N + Dmax * B * N * 4 + _small(Dmax, B, N),
                   6 * cells * N)


def paint_bwd(Dmax: int, B: int, N: int, cells: int) -> float:
    """B2, the backward sweep with the posterior."""
    return bound_s(cells * N * 5 + Dmax * B * N * 4 + _small(Dmax, B, N)
                   + Dmax * B * 4, 8 * cells * N)


def paint_fwd_capture(Dmax: int, B: int, N: int, rows: int) -> float:
    """B3: ``rows`` = the sum over targets of min(want, D - 1)."""
    return bound_s(rows * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 6 * rows * N)


def paint_bwd_capture(Dmax: int, B: int, N: int, rows: int) -> float:
    """B4: ``rows`` = the sum over targets with want < D of D - want."""
    return bound_s(rows * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 8 * rows * N)


def _live_pairs(N: int) -> int:
    return sum((N - t) * (N - t - 1) for t in range(N - 1))


def merge_scan_b5(N: int) -> float:
    """B5, the merge scan with clade rows: its matrices stay in L2."""
    return bound_s(2 * N * N * 4 + (N - 1) * N * 4 + 2 * (N - 1) * 4,
                   9 * _live_pairs(N))


def merge_scan_b6(N: int) -> float:
    """B6: the live entries of four matrices come from device memory while
    they are larger than the L2, and the inputs are read at least once."""
    io_bytes = 2 * N * N * 4 + 2 * (N - 1) * 4
    hbm = sum((N - t) * (N - t - 1) * 16 for t in range(N - 1)
              if (N - t) * (N - t) * 16 > L2_BYTES)
    return bound_s(max(io_bytes, hbm), 9 * _live_pairs(N))

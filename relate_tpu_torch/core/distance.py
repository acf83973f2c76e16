"""Distance-matrix assembly from painting posteriors.

Counterpart of ``relate_tpu/core/distance.py`` (behavioural reference
``DistanceMeasure::GetMatrix``, ``include/src/anc_builder.cpp:108-207``).
For target n at SNP s:

- if n carries the derived allele at s (or s is the first/last SNP of the
  chunk), its distance row is ``-(fast_log(posterior_row) + logscale)`` with
  the row minimum subtracted and the diagonal zeroed;
- otherwise the row interpolates between n's bracketing derived-site
  posterior rows, weighted by recombination position
  (anc_builder.cpp:139-188).

The per-target row state (index of the last derived step <= s, bracketing
rpos values) is tracked by the caller (the topology builder) like the
reference's ``v_snp_prev``/``v_rpos_prev``/``v_rpos_next`` bookkeeping.
All rows are assembled in one batched call per rebuild SNP, on the device
that holds the posterior.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fastlog import fast_log


class RowState(NamedTuple):
    """Per-target interpolation state at the current SNP."""
    row: np.ndarray         # (N,) int64: index of last derived step <= snp
    rpos_prev: np.ndarray   # (N,) float64
    rpos_next: np.ndarray   # (N,) float64


def _assemble_ops(topology, logscale, rows, is_exact, wl, wr, kcol):
    """Batched GetMatrix.

    topology: (Dmax, B, N); logscale: (Dmax, B); rows: (B,) int64 step index
    per target; is_exact: (B,) bool; wl/wr: (B,) float32 interpolation
    weights; kcol: (B,) int64 own-column index of each target.
    Returns (B, N) float32 distance matrix (row-min normalised, diag 0).
    """
    B = rows.shape[0]
    bidx = torch.arange(B, device=rows.device)
    top_prev = topology[rows, bidx]                 # (B, N)
    ls_prev = logscale[rows, bidx]                  # (B,)
    rows_n = torch.clamp(rows + 1, max=topology.shape[0] - 1)
    top_next = topology[rows_n, bidx]
    ls_next = logscale[rows_n, bidx]

    exact_val = fast_log(top_prev) + ls_prev[:, None]

    # interpolated value, computed in the branch with the larger logscale
    # (anc_builder.cpp:170-186)
    use_next = ls_prev <= ls_next
    e_pn = torch.exp(ls_prev - ls_next)
    e_np = torch.exp(ls_next - ls_prev)
    interp_next = fast_log(wl[:, None] * top_prev * e_pn[:, None]
                           + wr[:, None] * top_next) + ls_next[:, None]
    interp_prev = fast_log(wl[:, None] * top_prev
                           + wr[:, None] * top_next * e_np[:, None]) \
        + ls_prev[:, None]
    interp_val = torch.where(use_next[:, None], interp_next, interp_prev)

    val = torch.where(is_exact[:, None], exact_val, interp_val)
    mat = -val                                       # scale = -1.0
    mat = mat - mat.min(dim=1).values[:, None]
    mat[bidx, kcol] = 0.0
    return mat


class DistanceAssembler:
    """Stateful per-window distance assembly, mirroring DistanceMeasure."""

    def __init__(self, G: np.ndarray, rpos: np.ndarray,
                 nxt: np.ndarray | None = None, nxt_start: int = 0):
        self.G = G
        self.rpos = np.asarray(rpos, dtype=np.float64)
        self.L, self.N = G.shape
        # optional precomputed next-derived-rpos rows from SNP nxt_start on
        # (topology_device.next_derived_rpos: all L rows); avoids O(L)
        # per-target np.nonzero scans in matrix_inputs
        self.nxt = nxt
        self.nxt_start = nxt_start

    def init_state(self, plan, snp: int) -> RowState:
        """Row/rpos state at window entry (DistanceMeasure::Assign /
        GetTopologyWithRepaint, anc_builder.cpp:17-46,77-106).

        row[n] = index of the last plan step <= snp: the count of derived
        sites of n in (first_n, snp], from prefix counts;
        rpos_prev[n] = rpos at the last true-derived site of n <= snp (or 0).
        """
        N = self.N
        idx0 = plan.idx[:, 0]
        if isinstance(idx0, torch.Tensor):
            idx0 = idx0.cpu().numpy()
        first = np.asarray(idx0).astype(np.int64)
        lo = int(first.min())
        seg = np.zeros((snp + 2 - lo, N), dtype=np.int32)
        np.cumsum(self.G[lo:snp + 1] != 0, axis=0, out=seg[1:])
        cols = np.arange(N)
        row = (seg[snp + 1 - lo, cols]
               - seg[first + 1 - lo, cols]).astype(np.int64)
        # last true-derived site <= snp per target (reference's tsnp loop,
        # anc_builder.cpp:31-38), as one masked running max
        posmax = np.where(self.G[:snp + 1] == 1,
                          np.arange(snp + 1, dtype=np.int64)[:, None], 0)
        tsnp = posmax.max(axis=0)
        rpos_prev = self.rpos[tsnp]
        return RowState(row=row, rpos_prev=rpos_prev,
                        rpos_next=rpos_prev.copy())

    def matrix_inputs(self, state: RowState, snp: int,
                      is_first_or_last: bool):
        """Host-side per-SNP inputs for the assembly:
        (rows, is_exact, wl, wr), updating the stale rpos_next state."""
        G = self.G
        derived = G[snp] == 1
        is_exact = derived | is_first_or_last
        rpos_next = state.rpos_next.copy()
        stale = ~is_exact & (rpos_next <= state.rpos_prev)
        if self.nxt is not None:
            rpos_next[stale] = self.nxt[snp - self.nxt_start][stale]
        else:
            for n in np.nonzero(stale)[0]:
                nd = np.nonzero(G[snp:, n])[0]
                l = snp + nd[0] if len(nd) else self.L - 1
                rpos_next[n] = self.rpos[l]
        state.rpos_next[:] = rpos_next

        denom = rpos_next - state.rpos_prev
        same = denom == 0
        safe = np.where(same, 1.0, denom)
        wl = np.where(same, 0.5, (rpos_next - self.rpos[snp]) / safe)
        wr = np.where(same, 0.5, (self.rpos[snp] - state.rpos_prev) / safe)
        return (state.row.astype(np.int64), is_exact,
                wl.astype(np.float32), wr.astype(np.float32))

    def get_matrix(self, paint_out, state: RowState, snp: int,
                   is_first_or_last: bool) -> torch.Tensor:
        """Assemble the full N x N distance matrix at ``snp`` on the device
        of the posterior."""
        rows, is_exact, wl, wr = self.matrix_inputs(state, snp,
                                                    is_first_or_last)
        dev = paint_out.topology.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        kcol = np.asarray(paint_out.plan.targets).astype(np.int64)
        return _assemble_ops(paint_out.topology, paint_out.logscale, t(rows),
                             t(is_exact), t(wl), t(wr), t(kcol))

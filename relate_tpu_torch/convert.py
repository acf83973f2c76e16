"""State carried across from the JAX package, as NumPy arrays.

The artifact store (``chunk_<c>.npz``, ``paint_<w>.npz``, ``trees_<w>.anc``,
``muts_<w>.mut``) is byte-compatible between the two packages, so a store
written by one is read by the other without this module. What it adds is
the in-memory state: a painting checkpoint, a target plan, a window
posterior, a marginal tree and the static arrays and the state of an MCMC
chain batch, each read out of the JAX objects as NumPy arrays by the caller
(this module imports nothing of the JAX package) and rebuilt as the port's
objects on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.mcmc import ChainState, ChainStatic
from .core.painting import Checkpoint, PaintOutput, TargetPlan
from .core.trees import Tree
from .utils.devmem import resolve_device


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def checkpoint_from_numpy(alpha, ls_alpha, bsb, beta, ls_beta, bse,
                          device=None) -> Checkpoint:
    """The port's ``Checkpoint`` from the fields of
    ``relate_tpu.core.painting.Checkpoint``: ``alpha``/``beta`` (B, N)
    float32, ``ls_alpha``/``ls_beta`` (B,) float64, ``bsb``/``bse`` (B,)
    int64. The slabs are placed on ``device`` so that a repaint starts
    from them without another upload."""
    device = resolve_device(device)
    alpha = np.ascontiguousarray(alpha, dtype=np.float32)
    beta = np.ascontiguousarray(beta, dtype=np.float32)
    return Checkpoint(
        alpha=alpha, ls_alpha=np.asarray(ls_alpha, np.float64),
        bsb=np.asarray(bsb, np.int64), beta=beta,
        ls_beta=np.asarray(ls_beta, np.float64),
        bse=np.asarray(bse, np.int64),
        a0_dev=torch.from_numpy(alpha).to(device),
        be_dev=torch.from_numpy(beta).to(device))


def target_plan_from_numpy(targets, idx, seqk, D, pfac=None, nxt=None,
                           kmask=None, device=None) -> TargetPlan:
    """The port's device ``TargetPlan``. ``idx``/``seqk`` are (B, Dmax);
    the JAX repaint leaves ``pfac``/``nxt``/``kmask`` out of its plan and
    so may the caller (the section builder reads ``idx[:, 0]``, ``targets``
    and ``D`` only)."""
    device = resolve_device(device)
    opt = lambda a, dt: None if a is None else _tensor(a, dt, device)  # noqa: E731
    return TargetPlan(
        targets=np.asarray(targets, np.int32),
        idx=_tensor(idx, np.int32, device),
        seqk=_tensor(seqk, np.uint8, device),
        pfac=opt(pfac, np.float32), nxt=opt(nxt, np.float32),
        D=np.asarray(D, np.int32), kmask=opt(kmask, np.float32))


def paint_output_from_numpy(topology, logscale, ls_base, targets, idx, seqk,
                            D, device=None) -> PaintOutput:
    """The port's ``PaintOutput`` from a JAX one: ``topology`` (Dmax, B, N)
    and ``logscale`` (Dmax, B) in the public layout both packages share
    (any step-axis padding of the JAX arrays is kept: rows past D[b] are
    never read), ``ls_base`` (B,) float64, and the plan arrays."""
    device = resolve_device(device)
    plan = target_plan_from_numpy(targets, idx, seqk, D, device=device)
    return PaintOutput(topology=_tensor(topology, np.float32, device),
                       logscale=_tensor(logscale, np.float32, device),
                       ls_base=np.asarray(ls_base, np.float64), plan=plan)


def tree_from_numpy(parent, child_left, child_right, branch_length=None,
                    num_events=None, SNP_begin=None, SNP_end=None) -> Tree:
    """The port's ``Tree`` from the arrays of ``relate_tpu.core.trees.Tree``
    (copies, so that neither package's sweeps write into the other's)."""
    def cp(a, dt):
        return None if a is None else np.array(a, dtype=dt)
    return Tree(cp(parent, np.int32), cp(child_left, np.int32),
                cp(child_right, np.int32), cp(branch_length, np.float64),
                cp(num_events, np.float32), cp(SNP_begin, np.int32),
                cp(SNP_end, np.int32))


def chain_static_from_numpy(parent, child_left, child_right, num_events,
                            mut_rate, kc2_pos, epochs, rates, cumR, depth,
                            F=None, Rg=None, cumIRg=None,
                            device=None) -> ChainStatic:
    """The port's ``ChainStatic`` from the fields of the JAX one (index
    arrays become int64 tensors, the rest float32; the pairwise prior's
    fields stay None where they are)."""
    device = resolve_device(device)
    i64 = lambda a: _tensor(a, np.int64, device)      # noqa: E731
    f32 = lambda a: None if a is None else _tensor(   # noqa: E731
        a, np.float32, device)
    return ChainStatic(
        parent=i64(parent), child_left=i64(child_left),
        child_right=i64(child_right), num_events=f32(num_events),
        mut_rate=f32(mut_rate), kc2_pos=f32(kc2_pos), epochs=f32(epochs),
        rates=f32(rates), cumR=f32(cumR), depth=i64(depth), F=f32(F),
        Rg=f32(Rg), cumIRg=f32(cumIRg))


def chain_state_from_numpy(coords, order, sorted_idx, cs, ssum, scomp, count,
                           cprop, device=None) -> ChainState:
    """The port's ``ChainState`` from the fields of the JAX one."""
    device = resolve_device(device)
    f32 = lambda a: _tensor(a, np.float32, device)    # noqa: E731
    return ChainState(
        coords=f32(coords), order=_tensor(order, np.int64, device),
        sorted_idx=_tensor(sorted_idx, np.int64, device), cs=f32(cs),
        ssum=f32(ssum), scomp=f32(scomp), count=f32(count),
        cprop=_tensor(cprop, np.int32, device))

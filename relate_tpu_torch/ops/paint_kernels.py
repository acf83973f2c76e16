"""Li & Stephens painting sweeps: CUDA kernels and their plain versions.

Counterpart of ``relate_tpu/ops/paint_kernels.py``. The four TPU kernels
(``fwd_pallas``, ``bwd_pallas``, ``fwd_capture_pallas``,
``bwd_capture_pallas``) become three CUDA sources: ``csrc/paint_fwd.cu``
and ``csrc/paint_bwd.cu`` for the full sweeps, ``csrc/paint_capture.cu``
for the two capture sweeps. The backward sweep and the capture sweeps run
the same chain code, ``csrc/paint_sweep.cuh``.

Layout. Sources are contiguous: per-target state is ``(B, N)`` and the
per-row streams are ``(Dmax, B, N)``, which is also the public layout of
``PaintOutput.topology`` (the JAX kernels use ``(N, B)`` / ``(Dmax, N, B)``;
compare with a transpose). Per-target step vectors are ``(B, Dmax)``:

- ``D`` ``(B,)`` int32: number of steps of each target (2 <= D <= Dmax);
- ``alpha0`` / ``beta_end`` / ``kmask`` ``(B, N)`` float32;
- ``mism`` ``(Dmax, B, N)`` int8: 1 where the target carries the derived
  allele at that step and the source does not;
- ``pfac`` / ``nxt`` ``(B, Dmax)`` float32, UNSHIFTED planner outputs
  (interval j at column j). The forward row j reads column j-1 and the
  backward row j column j+1, which is what the JAX kernels receive as the
  pre-shifted ``pfacm1``/``nxtm1``/``pfacp1``/``nxtp1``;
- logscale outputs are ``(Dmax, B)`` float32.

What bounds the kernels on the card: memory traffic (1 mismatch byte read
and 4 to 8 bytes of float32 moved per cell, a handful of flops). Every
target gets its own thread block, so each stream byte crosses device memory
once; rows of one target are a dependent chain with one block-wide sum
each. The forward full sweep keeps the state row in shared memory and
relies on the B blocks in flight to hide the chain's latency. The capture
sweeps and the backward full sweep keep the state in registers and stream
the mismatch rows ahead of the chain into shared memory; the backward
sweep also holds the next row of alpha in registers and writes its output
rows with streaming stores, so a row's bytes are in flight while the
chain computes the one before (``csrc/paint_bwd.cu``).

A CUDA tensor goes to the kernel or raises; only a CPU tensor takes the
plain version. ``launches`` counts kernel launches per wrapper
(``_build.launches_by_card`` the same by card).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

LOWER_RESCALE = 1e-10
UPPER_RESCALE = 1e10

# The sweeps take N <= 25,827: nine bytes a source of the 232,448 bytes of
# shared memory a block of this card can use, a limit every kernel meets.
# The forward full sweep keeps its state and kmask rows in shared memory (8
# N bytes); the other three keep the state in registers and kmask and a
# ring of mismatch rows in shared memory, in blocks of up to 832 threads (N
# <= 26,624).
MAX_N = 232448 // 9

launches = {"fwd": 0, "bwd": 0, "fwd_capture": 0, "bwd_capture": 0}

_MODE_POST, _MODE_BETA = 0, 1


def _theta_consts(theta: float) -> Tuple[float, float, float]:
    """(theta, 1-theta, theta/(1-theta)-1), each rounded to float32."""
    return (float(np.float32(theta)), float(np.float32(1.0 - theta)),
            float(np.float32(theta / (1.0 - theta) - 1.0)))


def _check(name, t, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(D, state, kmask, mism, pfac, nxt):
    if mism.dim() != 3:
        raise ValueError("mism must be (Dmax, B, N)")
    Dmax, B, N = mism.shape
    if N > MAX_N:
        raise ValueError(
            f"the painting sweeps support N <= {MAX_N} (got {N}): a "
            "target's rows must fit one block's shared memory")
    _check("mism", mism, torch.int8, (Dmax, B, N))
    _check("D", D, torch.int32, (B,))
    _check("state", state, torch.float32, (B, N))
    _check("kmask", kmask, torch.float32, (B, N))
    _check("pfac", pfac, torch.float32, (B, Dmax))
    _check("nxt", nxt, torch.float32, (B, Dmax))
    dev = mism.device
    for name, t in (("D", D), ("state", state), ("kmask", kmask),
                    ("pfac", pfac), ("nxt", nxt)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, mism on {dev}")
    return Dmax, B, N


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
    [ctypes.c_float, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + \
    [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
_CAPTURE_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + \
    [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]


def _fwd_fn():
    fn = _build.load("paint_fwd").paint_fwd_launch
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("paint_bwd").paint_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _capture_fn():
    fn = _build.load("paint_capture").paint_capture_launch
    fn.argtypes = _CAPTURE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def capture_config(N: int, B: int, backward: bool, device=None) -> dict:
    """The launch configuration of a capture sweep (``backward``: B4, else
    B3) at width N for B targets on the card: threads a block (one block a
    target), sources a thread, ring slots and bytes a slot, dynamic shared
    bytes, blocks a SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    SMs, waves of the grid, registers and spilled bytes a thread."""
    fn = _build.load("paint_capture").paint_capture_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 9)()
    with torch.cuda.device(device if device is not None else "cuda"):
        err = fn(int(N), int(bool(backward)), info)
    _build.check(err, "paint_capture (configuration)")
    return dict(threads_per_block=info[0], sources_per_thread=info[1],
                ring_rows=info[2], slot_bytes=info[3],
                dynamic_shared_bytes=info[4], blocks_per_sm=info[5],
                sms=info[6], waves=B / max(info[5] * info[6], 1),
                registers=info[7], local_bytes=info[8])


def bwd_config(N: int, B: int, device=None, *, emit_beta=False) -> dict:
    """The launch configuration of the full backward sweep (B2) at width N
    for B targets on the card, in the posterior mode (``emit_beta``: the
    beta mode): as ``capture_config``, plus the alpha rows each thread
    holds ahead in registers (1, or 0 where the registers cannot hold a row
    and in the beta mode) and the bytes in flight a SM while the blocks
    resident there compute a row: the mismatch rows of the ring past the
    one being read and the alpha row held ahead, a target each."""
    fn = _build.load("paint_bwd").paint_bwd_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 10)()
    with torch.cuda.device(device if device is not None else "cuda"):
        err = fn(int(N), _MODE_BETA if emit_beta else _MODE_POST, info)
    _build.check(err, "paint_bwd (configuration)")
    per_sm, sms = info[5], info[6]
    resident = min(per_sm, -(-B // max(sms, 1)))
    return dict(threads_per_block=info[0], sources_per_thread=info[1],
                ring_rows=info[2], slot_bytes=info[3],
                dynamic_shared_bytes=info[4], blocks_per_sm=per_sm, sms=sms,
                waves=B / max(per_sm * sms, 1), registers=info[7],
                local_bytes=info[8], alpha_rows_ahead=info[9],
                bytes_in_flight_per_sm=resident * ((info[2] - 1) * N
                                                   + info[9] * 4 * N))


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device; the wrappers take them for CPU tensors)
# ---------------------------------------------------------------------------

def _fwd_rows(D, alpha0, kmask, mism, pfac, nxt, theta):
    """Generator over forward rows: yields (j, alpha (B,N), ls (B,))."""
    _, _, tr = _theta_consts(theta)
    Dmax = mism.shape[0]
    alpha = alpha0 * kmask
    ls = torch.zeros_like(alpha[:, 0])
    comp = torch.zeros_like(ls)
    asum_eff = alpha.sum(dim=1)
    yield 0, alpha, ls
    one = torch.ones_like(ls)
    zero = torch.zeros_like(ls)
    for j in range(1, Dmax):
        upd = j < D
        rx = asum_eff * pfac[:, j - 1]
        em = 1.0 + tr * mism[j].to(torch.float32)
        a_new = (alpha + rx[:, None]) * em * kmask
        asum = a_new.sum(dim=1)
        cond = (asum < LOWER_RESCALE) | (asum > UPPER_RESCALE)
        safe = torch.where(asum > 0, asum, one)
        a_new = torch.where(cond[:, None], a_new / safe[:, None], a_new)
        logcorr = torch.where(cond, torch.log(safe), zero)
        asum_new = torch.where(cond, one, asum)
        # Kahan-compensated logscale
        y = (nxt[:, j - 1] + logcorr) - comp
        t = ls + y
        comp_new = (t - ls) - y
        alpha = torch.where(upd[:, None], a_new, alpha)
        comp = torch.where(upd, comp_new, comp)
        ls = torch.where(upd, t, ls)
        asum_eff = torch.where(upd, asum_new, asum_eff)
        yield j, alpha, ls


def fwd_plain(D, alpha0, kmask, mism, pfac, nxt, *, theta):
    """Forward sweep, row by row. Returns (alphas (Dmax,B,N), lss (Dmax,B))."""
    Dmax, B, N = mism.shape
    alphas = torch.empty((Dmax, B, N), dtype=torch.float32, device=mism.device)
    lss = torch.empty((Dmax, B), dtype=torch.float32, device=mism.device)
    for j, alpha, ls in _fwd_rows(D, alpha0, kmask, mism, pfac, nxt, theta):
        alphas[j] = alpha
        lss[j] = ls
    return alphas, lss


def fwd_capture_plain(D, want, alpha0, kmask, mism, pfac, nxt, *, theta):
    """Forward sweep keeping only row ``want[b]`` of each target. Returns
    (acap (B,N), lscap (B,)); zeros where ``want`` names no row."""
    acap = torch.zeros_like(alpha0)
    lscap = torch.zeros_like(alpha0[:, 0])
    for j, alpha, ls in _fwd_rows(D, alpha0, kmask, mism, pfac, nxt, theta):
        hit = want == j
        acap = torch.where(hit[:, None], alpha, acap)
        lscap = torch.where(hit, ls, lscap)
    return acap, lscap


def _bwd_rows(D, beta_end, kmask, mism, pfac, nxt, theta):
    """Generator over backward rows, descending: yields
    (j, active (B,), beta_pre (B,N), beta_post (B,N), pls (B,))."""
    th, nth, tr = _theta_consts(theta)
    Dmax, B, N = mism.shape
    beta = torch.zeros_like(beta_end)
    pls = torch.zeros_like(beta_end[:, 0])
    comp = torch.zeros_like(pls)
    bsum_eff = torch.ones_like(pls)
    beta_init = beta_end * kmask
    one = torch.ones_like(pls)
    zero = torch.zeros_like(pls)
    for j in range(Dmax - 1, -1, -1):
        is_init = j == D - 1
        is_step = j < D - 1
        active = j < D
        jn = min(j + 1, Dmax - 1)
        dnext = mism[jn].to(torch.float32)
        rx = bsum_eff * pfac[:, jn]
        b1 = rx / nth
        bt = rx / th - b1
        em_next = 1.0 + tr * dnext
        beta_step = (beta + dnext * bt[:, None] + b1[:, None]) * em_next * kmask
        beta_new = torch.where(is_init[:, None], beta_init, beta_step)
        w = torch.where(mism[j] > 0, th, nth).to(torch.float32)
        bsum = (w * beta_new).sum(dim=1)
        cond = is_step & ((bsum < LOWER_RESCALE) | (bsum > UPPER_RESCALE))
        safe = torch.where(bsum > 0, bsum, one)
        beta_fin = torch.where(cond[:, None], beta_new / safe[:, None],
                               beta_new)
        logcorr = torch.where(cond, torch.log(safe), zero)
        bsum_new = torch.where(cond, one, bsum)
        pls_old = torch.where(is_init, zero, pls)
        comp_old = torch.where(is_init, zero, comp)
        inc = torch.where(is_init, zero, nxt[:, jn])
        y = (inc + logcorr) - comp_old
        pls_new = pls_old + y
        comp_new = (pls_new - pls_old) - y
        beta = torch.where(active[:, None], beta_fin, beta)
        pls = torch.where(active, pls_new, pls)
        comp = torch.where(active, comp_new, comp)
        bsum_eff = torch.where(active, bsum_new, bsum_eff)
        yield j, active, beta_new, beta_fin, pls_new


def bwd_plain(D, beta_end, kmask, mism, pfac, nxt, alphas, lsf, *, theta,
              emit_beta=False):
    """Backward sweep fused with the posterior, row by row. Returns
    (topo (Dmax,B,N), lstot (Dmax,B)); rows >= D[b] are zero. With
    ``emit_beta`` the outputs are the post-rescale beta rows and the
    backward-only logscale."""
    Dmax, B, N = mism.shape
    out = torch.empty((Dmax, B, N), dtype=torch.float32, device=mism.device)
    lsout = torch.empty((Dmax, B), dtype=torch.float32, device=mism.device)
    zrow = torch.zeros((B, N), dtype=torch.float32, device=mism.device)
    zls = zrow[:, 0]
    for j, active, b_pre, b_post, pls in _bwd_rows(D, beta_end, kmask, mism,
                                                   pfac, nxt, theta):
        if emit_beta:
            row, lrow = b_post, pls
        else:
            row, lrow = alphas[j] * b_pre, lsf[j] + pls
        out[j] = torch.where(active[:, None], row, zrow)
        lsout[j] = torch.where(active, lrow, zls)
    return out, lsout


def bwd_capture_plain(D, want, beta_end, kmask, mism, pfac, nxt, *, theta):
    """Backward sweep keeping the post-rescale beta row ``want[b]`` and the
    backward-only logscale there. Returns (bcap (B,N), lscap (B,))."""
    bcap = torch.zeros_like(beta_end)
    lscap = torch.zeros_like(beta_end[:, 0])
    for j, active, _, b_post, pls in _bwd_rows(D, beta_end, kmask, mism,
                                               pfac, nxt, theta):
        hit = (want == j) & active
        bcap = torch.where(hit[:, None], b_post, bcap)
        lscap = torch.where(hit, pls, lscap)
    return bcap, lscap


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fwd(D, alpha0, kmask, mism, pfac, nxt, *, theta):
    """Forward sweep (replaces ``fwd_pallas``). Returns
    (alphas (Dmax,B,N) post-rescale rows, lss (Dmax,B))."""
    Dmax, B, N = _check_common(D, alpha0, kmask, mism, pfac, nxt)
    if mism.device.type == "cpu":
        return fwd_plain(D, alpha0, kmask, mism, pfac, nxt, theta=theta)
    dev = mism.device
    alphas = torch.empty((Dmax, B, N), dtype=torch.float32, device=dev)
    lss = torch.empty((Dmax, B), dtype=torch.float32, device=dev)
    _, _, tr = _theta_consts(theta)
    with torch.cuda.device(dev):
        err = _fwd_fn()(_ptr(D), _ptr(alpha0), _ptr(kmask), _ptr(mism),
                        _ptr(pfac), _ptr(nxt), _ptr(alphas), _ptr(lss), Dmax,
                        B, N, tr, _stream(dev))
    _build.count_launch(launches, "fwd", dev)
    _build.check(err, "paint_fwd")
    return alphas, lss


def fwd_capture(D, want, alpha0, kmask, mism, pfac, nxt, *, theta):
    """Forward sweep capturing row ``want[b]`` per target (replaces
    ``fwd_capture_pallas``). Returns (acap (B,N), lscap (B,))."""
    Dmax, B, N = _check_common(D, alpha0, kmask, mism, pfac, nxt)
    _check("want", want, torch.int32, (B,))
    if mism.device.type == "cpu":
        return fwd_capture_plain(D, want, alpha0, kmask, mism, pfac, nxt,
                                 theta=theta)
    dev = mism.device
    if want.device != dev:
        raise ValueError(f"want is on {want.device}, mism on {dev}")
    acap = torch.empty((B, N), dtype=torch.float32, device=dev)
    lscap = torch.empty((B,), dtype=torch.float32, device=dev)
    err = _capture_launch(False, D, want, alpha0, kmask, mism, pfac, nxt,
                          acap, lscap, theta)
    _build.count_launch(launches, "fwd_capture", dev)
    _build.check(err, "paint_capture (forward)")
    return acap, lscap


def _capture_launch(backward, D, want, state0, kmask, mism, pfac, nxt, out,
                    lsout, theta):
    Dmax, B, N = mism.shape
    th, nth, tr = _theta_consts(theta)
    dev = mism.device
    with torch.cuda.device(dev):
        return _capture_fn()(int(backward), _ptr(D), _ptr(want),
                             _ptr(state0), _ptr(kmask), _ptr(mism),
                             _ptr(pfac), _ptr(nxt), _ptr(out), _ptr(lsout),
                             Dmax, B, N, th, nth, tr, _stream(dev))


def bwd(D, beta_end, kmask, mism, pfac, nxt, alphas, lsf, *, theta,
        emit_beta=False):
    """Backward sweep + posterior (replaces ``bwd_pallas``). ``alphas`` /
    ``lsf`` are the forward outputs. Returns (topo (Dmax,B,N), lstot
    (Dmax,B)), zeros on rows >= D[b]."""
    Dmax, B, N = _check_common(D, beta_end, kmask, mism, pfac, nxt)
    _check("alphas", alphas, torch.float32, (Dmax, B, N))
    _check("lsf", lsf, torch.float32, (Dmax, B))
    if mism.device.type == "cpu":
        return bwd_plain(D, beta_end, kmask, mism, pfac, nxt, alphas, lsf,
                         theta=theta, emit_beta=emit_beta)
    dev = mism.device
    if alphas.device != dev or lsf.device != dev:
        raise ValueError("alphas and lsf must be on the device of mism")
    out = torch.empty((Dmax, B, N), dtype=torch.float32, device=dev)
    lsout = torch.empty((Dmax, B), dtype=torch.float32, device=dev)
    th, nth, tr = _theta_consts(theta)
    with torch.cuda.device(dev):
        err = _bwd_fn()(_ptr(D), _ptr(beta_end), _ptr(kmask), _ptr(mism),
                        _ptr(pfac), _ptr(nxt), _ptr(alphas), _ptr(lsf),
                        _ptr(out), _ptr(lsout), Dmax, B, N, th, nth, tr,
                        _MODE_BETA if emit_beta else _MODE_POST,
                        _stream(dev))
    _build.count_launch(launches, "bwd", dev)
    _build.check(err, "paint_bwd")
    return out, lsout


def bwd_capture(D, want, beta_end, kmask, mism, pfac, nxt, *, theta):
    """Backward sweep capturing the post-rescale beta row ``want[b]`` and the
    backward-only logscale there (replaces ``bwd_capture_pallas``). Needs no
    forward outputs. Returns (bcap (B,N), lscap (B,))."""
    Dmax, B, N = _check_common(D, beta_end, kmask, mism, pfac, nxt)
    _check("want", want, torch.int32, (B,))
    if mism.device.type == "cpu":
        return bwd_capture_plain(D, want, beta_end, kmask, mism, pfac, nxt,
                                 theta=theta)
    dev = mism.device
    if want.device != dev:
        raise ValueError(f"want is on {want.device}, mism on {dev}")
    bcap = torch.empty((B, N), dtype=torch.float32, device=dev)
    lscap = torch.empty((B,), dtype=torch.float32, device=dev)
    err = _capture_launch(True, D, want, beta_end, kmask, mism, pfac, nxt,
                          bcap, lscap, theta)
    _build.count_launch(launches, "bwd_capture", dev)
    _build.check(err, "paint_capture (backward)")
    return bcap, lscap

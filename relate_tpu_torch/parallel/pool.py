"""One process a card: a persistent pool of workers for a mesh.

PyTorch issues every kernel from the host, and a host thread holds the
interpreter lock for each launch. The branch-length chains make some 635
small launches an iteration, so host threads of one process that drive
several cards wait on one another: on four NVIDIA H100 80GB HBM3 (700 W;
PERF.md §5) InferBranchLengths' four sections at N = 2048 took 26.8 to
35.5 s from a thread a card, against 3.3 to 4.8 s on one card and 1.0 to
2.1 s through a pool of four processes. A ``CardPool`` gives each device of
a mesh a process of its own:

- the workers come from ``multiprocessing.get_context("spawn")``, one a
  device, and start in the background when the pool is made (their imports
  and CUDA contexts overlap whatever the caller does next); each enters its
  card (``torch.cuda.set_device``) before it allocates anything, and a
  ``"cpu"`` entry runs with one thread;
- a task is a module-level function of the package and picklable
  arguments; an argument that is ``HERE`` is replaced by the worker's
  device. Results come back pickled, so they should be small;
- ``map`` hands each task to the first free worker, in the order the
  caller gives, and returns the results in the order of the tasks; what the
  tasks ``note`` and ``count`` and each worker's peak device memory go into
  the stage record open on the caller's thread (``utils.trace``);
- a task that raises is raised again in the caller with the worker's
  traceback, and so is a worker that dies or outlasts ``timeout_s``; the
  pool then stops every worker. No task is retried;
- ``close()`` (also on leaving a ``with`` block) ends every process.

The pool never turns a card into the CPU: a worker whose card cannot be
entered fails, and ``map`` raises its traceback.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import pickle
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from ..utils import trace
from .mesh import as_mesh

# how long close() lets the workers end on their own before it stops them
CLOSE_GRACE_S = 10.0


class _Here:
    """The worker's own device, in a task's arguments."""

    def __reduce__(self):
        return "HERE"


HERE = _Here()


def _enter(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)          # the context, before any task
        torch.cuda.synchronize(dev)
    else:
        torch.set_num_threads(1)
    import relate_tpu_torch  # noqa: F401
    return dev


def _worker(device: str, conn) -> None:
    """A worker's loop: enter ``device``, say when ready, then run each task
    received until told to stop (``None``) or the parent's end closes."""
    try:
        dev = _enter(device)
    except BaseException:
        conn.send(("failed", traceback.format_exc()))
        return
    conn.send(("ready", time.time()))
    while True:
        try:
            raw = conn.recv_bytes()
        except EOFError:
            return
        try:
            task = pickle.loads(raw)
            if task is None:
                return
            fn, args = task
            args = tuple(dev if a is HERE else a for a in args)
            rec: dict = {}
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            with trace.within(rec):
                out = fn(*args)
            peak = (round(torch.cuda.max_memory_allocated(dev) / 1e6, 1)
                    if dev.type == "cuda" else None)
            conn.send(("ok", out, rec, peak))
        except BaseException:
            conn.send(("error", traceback.format_exc()))


class CardPool:
    """One worker process a device of ``mesh`` (a ``parallel.mesh.Mesh``
    or a sequence of devices), started when the pool is made."""

    def __init__(self, mesh, timeout_s: float = 86400.0):
        self.mesh = as_mesh(mesh)
        self.timeout_s = float(timeout_s)
        self._lock = threading.RLock()      # one caller of the pipes at a time
        self._conns: list = []
        self._procs: list = []
        self._ready_at: List[Optional[float]] = [None] * len(self.mesh)
        self._closed = False
        ctx = multiprocessing.get_context("spawn")
        self._t0 = time.time()
        try:
            for k, dev in enumerate(self.mesh):
                here, there = ctx.Pipe()
                p = ctx.Process(target=_worker, args=(str(dev), there),
                                name=f"card-pool-{k}-{dev}", daemon=True)
                p.start()
                there.close()
                self._conns.append(here)
                self._procs.append(p)
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> "CardPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _fail(self, exc: BaseException):
        """Stop every worker and raise ``exc``."""
        self.close(grace_s=0.0)
        raise exc

    def _recv(self, k: int, deadline: float):
        """The next message of worker k; raises if it dies first or none
        comes before ``deadline``."""
        conn, proc = self._conns[k], self._procs[k]
        left = max(0.0, deadline - time.time())
        ready = multiprocessing.connection.wait([conn, proc.sentinel], left)
        if conn in ready:
            try:
                return conn.recv()
            except EOFError:
                pass
        elif not ready:
            self._fail(TimeoutError(
                f"the pool's worker on {self.mesh[k]} gave no answer within "
                f"{self.timeout_s} s"))
        proc.join(1.0)
        self._fail(RuntimeError(
            f"the pool's worker on {self.mesh[k]} ended (exit code "
            f"{proc.exitcode})"))

    def start_s(self) -> List[float]:
        """Seconds from the pool's start until each worker was ready, in
        mesh order; waits for the workers that are not yet."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the pool is closed")
            for k in range(len(self.mesh)):
                if self._ready_at[k] is not None:
                    continue
                msg = self._recv(k, time.time() + self.timeout_s)
                if msg[0] != "ready":
                    self._fail(RuntimeError(
                        f"the pool's worker on {self.mesh[k]} failed to "
                        f"start:\n{msg[1]}"))
                self._ready_at[k] = msg[1]
            return [round(t - self._t0, 3) for t in self._ready_at]

    def note_start(self) -> None:
        """Put ``start_s()`` under ``pool_start_s`` in the stage record open
        on this thread (``utils.trace``), unless it has one already."""
        rec = trace.open_record()
        if rec is not None and "pool_start_s" not in rec:
            rec["pool_start_s"] = self.start_s()

    def map(self, fn: Callable, jobs: Sequence[tuple],
            order: Optional[Sequence[int]] = None) -> list:
        """``fn(*job)`` for every job, each on the first free worker, the
        jobs handed out in ``order`` (indices into ``jobs``; default their
        own order). Returns the results in the order of ``jobs``; the lists
        each job's task ``note``d are added to the caller's open stage
        record in that order, and each card's peak device memory joins the
        record's ``dev_peak_mb_by_card``. One caller at a time: other
        threads wait for the pool."""
        jobs = list(jobs)
        order = list(range(len(jobs)) if order is None else order)
        if sorted(order) != list(range(len(jobs))):
            raise ValueError(f"order {order} is no permutation of the "
                             f"{len(jobs)} jobs")
        rec = trace.open_record()
        with self._lock:
            self.start_s()
            results: list = [None] * len(jobs)
            notes: list = [None] * len(jobs)
            peaks: dict = {}
            try:
                self._run(fn, jobs, order, results, notes, peaks)
            except BaseException:
                self.close(grace_s=0.0)     # workers may be mid-task
                raise
        if rec is not None:
            for n in notes:
                trace.merge(rec, n)
            for card, mb in peaks.items():
                trace.peak(rec, card, mb)
        return results

    def _run(self, fn, jobs, order, results, notes, peaks) -> None:
        """The dealing loop of ``map``: at most one job a worker in flight;
        fills ``results``, ``notes`` (by job) and ``peaks`` (by card)."""
        busy: dict = {}             # worker -> (job, deadline)
        todo = order[::-1]
        while todo or busy:
            for k in range(len(self.mesh)):
                if k not in busy and todo:
                    i = todo.pop()
                    self._conns[k].send((fn, tuple(jobs[i])))
                    busy[k] = (i, time.time() + self.timeout_s)
            waits = [c for k in busy
                     for c in (self._conns[k], self._procs[k].sentinel)]
            left = min(d for _, d in busy.values()) - time.time()
            multiprocessing.connection.wait(waits, max(0.0, left))
            for k in list(busy):
                i, deadline = busy[k]
                if not (self._conns[k].poll() or not self._procs[k].is_alive()
                        or time.time() > deadline):
                    continue
                msg = self._recv(k, deadline)
                if msg[0] != "ok":
                    self._fail(RuntimeError(
                        f"a task of the pool failed on {self.mesh[k]}:\n"
                        f"{msg[1]}"))
                results[i], notes[i], peak = msg[1], msg[2], msg[3]
                if peak is not None:
                    card = str(self.mesh[k])
                    peaks[card] = max(peaks.get(card, 0.0), peak)
                del busy[k]

    def close(self, grace_s: float = CLOSE_GRACE_S) -> None:
        """End every worker: each is asked to stop, and one that has not
        ended within ``grace_s`` seconds is stopped. Leaves no process."""
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        end = time.time() + grace_s
        for p in self._procs:
            p.join(max(0.0, end - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

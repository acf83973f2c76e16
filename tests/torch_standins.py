"""Stand-ins for the branch-length chains that tests give the port's pool
workers (``relate_tpu_torch.parallel.pool``), and a pool that records how
it was used. A worker imports a task's function by its module, so this
module imports neither JAX nor the JAX package: only numpy and the port."""
import multiprocessing

import numpy as np

from relate_tpu_torch.evaluate.sampling import sample_part
from relate_tpu_torch.parallel.pool import CardPool


def fixed_lengths(trees, *args, **kwargs):
    """Branch lengths that are one function of each tree's events."""
    out = []
    for tr in trees:
        M = len(tr.parent)
        bl = 10.0 * np.asarray(tr.num_events, dtype=np.float64) \
            + (np.arange(M) % 5) + 1.0
        bl[M - 1] = 0.0
        out.append(bl)
    return np.asarray(out)


def fixed_section_lengths(*args):
    """``pipeline.relate.section_branch_lengths`` in a pool worker with the
    worker's chains replaced by ``fixed_lengths``."""
    from relate_tpu_torch.core import mcmc
    from relate_tpu_torch.pipeline import relate
    mcmc.run_mcmc = fixed_lengths
    return relate.section_branch_lengths(*args)


def part_failing_in_a_worker(*args):
    """``evaluate.sampling.sample_part`` that raises in a pool worker and
    runs as itself in the calling process, where a retry would pass."""
    if multiprocessing.parent_process() is not None:
        raise ValueError("the chains of this part failed in their worker")
    return sample_part(*args)


def recording_pools(monkeypatch, *modules):
    """Make ``CardPool`` in each of ``modules`` a real pool that records
    itself. Returns the list of the pools made; each has ``maps``, one
    (jobs, worker pids) a call of ``map``."""
    made = []

    class RecordingPool(CardPool):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.maps = []
            made.append(self)

        def map(self, fn, jobs, order=None):
            self.maps.append((len(jobs), tuple(p.pid for p in self._procs)))
            return super().map(fn, jobs, order)

    for mod in modules:
        monkeypatch.setattr(mod, "CardPool", RecordingPool)
    return made

"""Stand-ins for the branch-length chains that tests give the port's pool
workers (``relate_tpu_torch.parallel.pool``). A worker imports a task's
function by its module, so this module imports neither JAX nor the JAX
package: only numpy and the port."""
import numpy as np


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

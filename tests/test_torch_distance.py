"""The port's distance assembly against the JAX package's on one posterior.

atol 1e-5: ``exp`` may differ by an ulp between XLA and PyTorch; ``fast_log``
is bit-exact, and the row minimum is subtracted in both."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.core.distance import DistanceAssembler as JaxAssembler
from relate_tpu.core.distance import _assemble_ops as jax_assemble
from relate_tpu_torch.core.distance import DistanceAssembler, _assemble_ops
from relate_tpu_torch.core.topology_device import next_derived_rpos
from relate_tpu.core.topology_device import next_derived_rpos as jax_nxt

torch.set_num_threads(1)


def _posterior(seed, Dmax=9, B=7, N=7):
    rng = np.random.default_rng(seed)
    topo = (rng.random((Dmax, B, N)) ** 6).astype(np.float32) + 1e-20
    ls = (rng.standard_normal((Dmax, B)) * 8).astype(np.float32)
    rows = rng.integers(0, Dmax, B)
    rows[0] = Dmax - 1                       # next row clamps
    is_exact = rng.random(B) < 0.4
    wl = rng.random(B).astype(np.float32)
    return topo, ls, rows, is_exact, wl, (1 - wl).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assemble_ops_matches_jax(seed):
    topo, ls, rows, is_exact, wl, wr = _posterior(seed)
    B = len(rows)
    ref = np.asarray(jax_assemble(
        jnp.asarray(topo), jnp.asarray(ls), jnp.asarray(rows, jnp.int32),
        jnp.asarray(is_exact), jnp.asarray(wl), jnp.asarray(wr),
        jnp.arange(B, dtype=jnp.int32)))
    t = torch.from_numpy
    got = _assemble_ops(t(topo), t(ls), t(rows.astype(np.int64)), t(is_exact),
                        t(wl), t(wr), torch.arange(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (np.diag(got) == 0).all() and (got >= 0).all()


def test_row_state_and_next_rpos_match_jax():
    rng = np.random.default_rng(5)
    L, N = 80, 9
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    rpos = np.concatenate([[0.0], np.cumsum(rng.random(L) * 1e-3)])
    assert np.array_equal(next_derived_rpos(G, rpos), jax_nxt(G, rpos))

    class Plan:
        idx = np.stack([rng.integers(0, 10, N), np.full(N, L - 1)], axis=1)
    ja = JaxAssembler(G, rpos, nxt=jax_nxt(G, rpos))
    ta = DistanceAssembler(G, rpos, nxt=next_derived_rpos(G, rpos))
    for snp in (10, 33, L - 2):
        sj, st = ja.init_state(Plan, snp), ta.init_state(Plan, snp)
        for a, b in zip(sj, st):
            assert np.array_equal(a, b)
        ij = ja.matrix_inputs(sj, snp, False)
        it = ta.matrix_inputs(st, snp, False)
        for a, b in zip(ij, it):
            assert np.array_equal(np.asarray(a), np.asarray(b))

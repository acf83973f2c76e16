"""The port's fast_log against the JAX package's, bit for bit."""
import numpy as np
import pytest
import torch

from relate_tpu.core.fastlog import fast_log as jax_fast_log
from relate_tpu.core.fastlog import fast_log2 as jax_fast_log2
from relate_tpu_torch.core.fastlog import fast_log, fast_log2

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _inputs(kind):
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.random(4096).astype(np.float32)
    if kind == "wide":
        return np.exp(rng.uniform(-80, 80, 4096)).astype(np.float32)
    if kind == "denormal":
        return (rng.integers(1, 1 << 23, 4096).astype(np.int32)
                .view(np.float32))
    if kind == "special":
        return np.array([0.0, 1.0, 2.0, 0.5, 1e-45, 1.1754944e-38, 3.0e38,
                         3.4028235e38, 1e-10, 1e10, 123.456],
                        dtype=np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["uniform", "wide", "denormal", "special"])
def test_fast_log_bit_exact(kind):
    x = _inputs(kind)
    got = fast_log(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(jax_fast_log(x)))
    got2 = fast_log2(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got2), _bits(jax_fast_log2(x)))


def test_fast_log_is_close_to_log_and_keeps_shape():
    x = torch.tensor([[1.0, 2.0, 0.5], [0.1, 123.456, 7.0]])
    got = fast_log(x)
    assert got.shape == x.shape
    assert abs(float(got[0, 0])) < 1e-7      # exact 0 at 1 by construction
    assert torch.allclose(got, torch.log(x), atol=5e-3)
    # a non-contiguous view goes through as well
    assert torch.equal(fast_log(x.t()), got.t())

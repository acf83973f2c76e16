"""The tree metrics of the port (``relate_tpu_torch/core/tree_comparer.py``)
against the JAX package's on pairs of golden trees (N = 8, with and without
sample ages) and on seeded random trees of 64 leaves: every value must be
equal; ``pearson_distance`` and ``pairwise_tmrca`` run as PyTorch products
(here on the CPU). The twin of tests/test_ancbuilder.py's checks."""
import numpy as np
import pytest
import torch

from relate_tpu.core import tree_comparer as jtc
from relate_tpu.core.trees import Tree as JTree
from relate_tpu_torch.core import tree_comparer as ttc
from relate_tpu_torch.core.trees import Tree, children_from_parent
from relate_tpu_torch.pipeline import scripts as tscripts

torch.set_num_threads(1)

AGES = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])
PAIRS = ((0, 0), (0, 1), (5, 6), (100, 2000), (3000, 3001), (9000, 9411))


@pytest.fixture(scope="module")
def trees(golden_dir):
    anc = tscripts._load_pair(str(golden_dir / "golden"))[0]
    return [mt.tree for mt in anc.seq]


def _jax(t):
    return JTree(t.parent.copy(), t.child_left.copy(), t.child_right.copy(),
                 t.branch_length.copy())


def _random_tree(N, seed):
    """Merge-order tree of N leaves joined at random, random lengths."""
    rng = np.random.default_rng(seed)
    M = 2 * N - 1
    parent = np.full(M, -1, np.int32)
    live = list(range(N))
    for v in range(N, M):
        a, b = rng.choice(len(live), 2, replace=False)
        parent[live[a]] = parent[live[b]] = v
        live = [x for i, x in enumerate(live) if i not in (a, b)] + [v]
    cl, cr = children_from_parent(parent)
    bl = rng.exponential(10.0, M)
    bl[-1] = 0.0
    return Tree(parent, cl, cr, bl)


def _cases(trees):
    for a, b in PAIRS:
        yield trees[a], trees[b]
    for s in range(3):
        yield _random_tree(64, s), _random_tree(64, s + 10)


def test_partition_metric_and_branch_score(trees):
    n_diff = 0
    for t1, t2 in _cases(trees):
        got = ttc.partition_metric(t1, t2)
        assert got == jtc.partition_metric(_jax(t1), _jax(t2))
        n_diff += got > 0
        assert ttc.branch_score(t1, t2) == \
            jtc.branch_score(_jax(t1), _jax(t2))
    assert n_diff >= 5


def test_pearson_distance(trees):
    for t1, t2 in _cases(trees):
        got = ttc.pearson_distance(t1, t2, device="cpu")
        assert got == jtc.pearson_distance(_jax(t1), _jax(t2))
    t = trees[0]
    assert ttc.pearson_distance(t, t, device="cpu") < 1e-6


@pytest.mark.parametrize("ages", [None, AGES])
def test_pairwise_tmrca_and_k_ancestors(trees, ages):
    for t1, _ in _cases(trees):
        a = ages if t1.N == 8 else None
        got = ttc.pairwise_tmrca(t1, a, device="cpu")
        want = jtc.pairwise_tmrca(_jax(t1), a)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got, got.T) and not np.diag(got).any()
        for k in range(t1.N + 2):
            assert ttc.time_while_k_ancestors(t1, k, a) == \
                jtc.time_while_k_ancestors(_jax(t1), k, a)


def test_ancbuilder_twin(trees):
    """tests/test_ancbuilder.py's checks of the metrics on one tree."""
    t1 = trees[17]
    assert ttc.partition_metric(t1, t1) == 0
    assert ttc.pearson_distance(t1, t1, device="cpu") < 1e-6
    assert ttc.branch_score(t1, t1) == 0.0
    tm = ttc.pairwise_tmrca(t1, device="cpu")
    c = t1.coordinates()
    assert tm.max() == c[-1]
    total = sum(ttc.time_while_k_ancestors(t1, k) for k in range(2, 9))
    assert abs(total - c[-1]) < 1e-9


def test_device_functions_do_not_fall_back(trees):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttc.pairwise_tmrca(trees[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttc.pearson_distance(trees[0], trees[1])

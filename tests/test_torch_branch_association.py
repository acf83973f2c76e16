"""FindEquivalentBranches of the port against the JAX package: the host
matcher (own NumPy copy), the device matcher on ``device="cpu"``, the leaf
matrices, the Pearson correlations and the association sweeps.

The equivalence vectors are integers and must be identical; the
correlations are float32 and compared at rtol 1e-6 (XLA may contract a
multiply and a subtract that NumPy and PyTorch round separately)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.core import branch_association as jba
from relate_tpu.core import branch_association_device as jbad
from relate_tpu.core.trees import Tree as JTree
from relate_tpu_torch import convert
from relate_tpu_torch.core import branch_association as tba
from relate_tpu_torch.core import branch_association_device as tbad

torch.set_num_threads(1)


def _rand_tree(N, rng):
    M = 2 * N - 1
    parent = np.full(M, -1, np.int32)
    cl = np.full(M, -1, np.int32)
    cr = np.full(M, -1, np.int32)
    act = list(range(N))
    for t in range(N - 1):
        i = act.pop(rng.integers(len(act)))
        j = act.pop(rng.integers(len(act)))
        p = N + t
        parent[i] = p
        parent[j] = p
        cl[p] = i
        cr[p] = j
        act.append(p)
    return JTree(parent, cl, cr)


def _nni_perturb(tree, rng, k):
    """k nearest-neighbour interchanges: a child of an internal node swaps
    places with the node's sibling. The labels stay merge-ordered only by
    luck, which the matchers do not need."""
    t = tree.copy()
    M, N = t.num_nodes, t.N
    done = 0
    for _ in range(200):
        if done == k:
            break
        v = int(rng.integers(N, M - 1))
        p = int(t.parent[v])
        c = int(t.child_left[v])
        sib = int(t.child_right[p] if t.child_left[p] == v
                  else t.child_left[p])
        if t.child_left[v] == c:
            t.child_left[v] = sib
        else:
            t.child_right[v] = sib
        if t.child_left[p] == sib:
            t.child_left[p] = c
        else:
            t.child_right[p] = c
        t.parent[sib] = v
        t.parent[c] = p
        done += 1
    return t


def _sequence(N, seed):
    """6-10 trees: a random one, near-identical neighbours, an unrelated
    one, an identical pair (as tests/test_ancbuilder.py builds them)."""
    rng = np.random.default_rng(seed)
    trees = [_rand_tree(N, rng)]
    for _ in range(int(rng.integers(3, 6))):
        trees.append(_nni_perturb(trees[-1], rng, k=2))
    trees.append(_rand_tree(N, rng))
    trees.append(trees[-1].copy())
    trees.append(_nni_perturb(trees[-1], rng, k=1))
    L = 50 * len(trees)
    for k, t in enumerate(trees):
        t.num_events = rng.poisson(1.0, t.num_nodes).astype(np.float32)
        t.SNP_begin = np.full(t.num_nodes, 50 * k, np.int32)
        t.SNP_end = np.full(t.num_nodes, min(50 * k + 49, L - 1), np.int32)
    return trees


def _port(trees):
    return [convert.tree_from_numpy(t.parent, t.child_left, t.child_right,
                                    t.branch_length, t.num_events,
                                    t.SNP_begin, t.SNP_end) for t in trees]


@pytest.mark.parametrize("N,seed", [(8, 1), (24, 2), (33, 3), (48, 4)])
def test_matchers_are_identical(N, seed):
    """Port host matcher == port device matcher == JAX host matcher == JAX
    device matcher, on every adjacent pair."""
    jt = _sequence(N, seed)
    tt = _port(jt)
    assert 6 <= len(jt) <= 10
    want = jba.branch_association_many(jt)
    want_dev = jbad.branch_association_many_device(jt, pair_chunk=4)
    host = tba.branch_association_many(tt, pair_chunk=3)
    dev = tbad.branch_association_many_device(tt, pair_chunk=4, device="cpu")
    one = tbad.branch_association_many_device(tt, device="cpu")
    assert len(want) == len(host) == len(dev) == len(one) == len(jt) - 1
    matched = 0
    for w, wd, h, d, o in zip(want, want_dev, host, dev, one):
        assert d.dtype == np.int32 and d.shape == (2 * N - 1,)
        np.testing.assert_array_equal(w, wd)
        np.testing.assert_array_equal(w, h)
        np.testing.assert_array_equal(w, d)
        np.testing.assert_array_equal(w, o)
        matched += int((w >= 0).sum())
    assert matched > 2 * N          # the near-identical pairs do match
    # the pairwise entry point of the host copy
    np.testing.assert_array_equal(
        tba.branch_association(tt[0], tt[1]), want[0])


@pytest.mark.parametrize("N", [5, 12, 40])
def test_leafmats_equal_leaf_matrix(N):
    rng = np.random.default_rng(N)
    trees = [_rand_tree(N, rng) for _ in range(4)]
    trees.append(_nni_perturb(trees[-1], rng, k=3))
    parent = torch.from_numpy(
        np.stack([t.parent for t in trees]).astype(np.int64))
    L = tbad._leafmats(parent, N)
    assert L.shape == (len(trees), 2 * N - 1, N) and L.dtype == torch.float32
    for k, t in enumerate(trees):
        assert np.array_equal(L[k].numpy().astype(np.uint8), t.leaf_matrix())
        assert np.array_equal(_port([t])[0].leaf_matrix(), t.leaf_matrix())


def test_pearson_matches_jax():
    N = 33
    jt = _sequence(N, 7)
    Ls = np.stack([t.leaf_matrix() for t in jt]).astype(np.float32)
    prod = np.matmul(Ls[1:], Ls[:-1].transpose(0, 2, 1))
    ns = Ls.sum(axis=2)
    got = tbad._pearson_device(torch.from_numpy(prod),
                               torch.from_numpy(ns[1:]),
                               torch.from_numpy(ns[:-1]), N).numpy()
    for k in range(len(jt) - 1):
        want = np.asarray(jbad._pearson_device(
            jnp.asarray(prod[k]), jnp.asarray(ns[k + 1]), jnp.asarray(ns[k]),
            N))
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=0)
        # and the port's host function, which the matcher's oracle uses
        host = tba._pearson_from_products(prod[k].copy(), ns[k + 1], ns[k],
                                          N)
        np.testing.assert_array_equal(got[k], host)
    np.testing.assert_array_equal(
        tba.pearson_matrix(jt[1].leaf_matrix(), jt[0].leaf_matrix()), got[0])
    assert np.array_equal(tba._count_compat_table(N),
                          jba._count_compat_table(N))


@pytest.mark.parametrize("N,seed", [(12, 5), (33, 6)])
def test_associate_trees_leaves_identical_spans(N, seed):
    jt = _sequence(N, seed)
    tt = _port(jt)
    eqs = jba.branch_association_many(jt)
    jba.associate_trees(jt, eqs)
    tba.associate_trees(tt, [e.copy() for e in eqs])
    moved = False
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.num_events, b.num_events)
        np.testing.assert_array_equal(a.SNP_begin, b.SNP_begin)
        np.testing.assert_array_equal(a.SNP_end, b.SNP_end)
        moved |= bool((b.SNP_begin != b.SNP_begin[0]).any())
    assert moved                     # spans really were propagated
    # forward then backward in two runs equals the sweep in one
    t2 = _port(_sequence(N, seed))
    k = len(t2) // 2
    tba.associate_forward(t2[:k + 1], eqs[:k])
    tba.associate_forward(t2[k:], eqs[k:])
    tba.associate_backward(t2[k:], eqs[k:])
    tba.associate_backward(t2[:k + 1], eqs[:k])
    for a, b in zip(tt, t2):
        np.testing.assert_array_equal(a.num_events, b.num_events)
        np.testing.assert_array_equal(a.SNP_end, b.SNP_end)
    with pytest.raises(ValueError):
        tba.associate_trees(tt, eqs[:-1])


def test_pair_chunk_is_sized_and_device_is_explicit():
    assert tbad.pair_chunk_for(2048, "cpu") == 16
    assert tbad._pair_bytes(2048, 4095) > 3.7e8    # the measured 0.37 GB
    assert tbad.branch_association_many_device([], device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbad.branch_association_many_device(_port(_sequence(8, 1)))

"""The port's incremental merge scan (plain version, CPU) against the JAX
package: its NumPy twin ``merge_scan_inc_host`` and its Pallas kernel in
interpret mode. Merge lists must be equal exactly in every case; no
tolerance is involved (the scan is discrete, and both sides round every
blend as two float32 products and a sum)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.ops.merge_scan import clades_from_merges as jax_clades
from relate_tpu.ops.merge_scan_inc import (_tie_hash_np, merge_scan_inc_host,
                                           merge_scan_incremental
                                           as jax_incremental)
from relate_tpu_torch.ops import merge_scan as tms
from relate_tpu_torch.ops import merge_scan_inc as tmi

torch.set_num_threads(1)


def _matrices(kind, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # integer-valued and tie-heavy: the choice rests on the pair hash
        d = rng.integers(0, 4, (N, N)).astype(np.float32)
        dcf = rng.integers(0, 3, (N, N)).astype(np.float32)
    else:
        d = rng.random((N, N)).astype(np.float32) * 10
        dcf = rng.random((N, N)).astype(np.float32) * 3
    np.fill_diagonal(d, 0)
    np.fill_diagonal(dcf, 0)
    return d, dcf


def _t(a):
    return torch.from_numpy(a.copy())


# kind of matrix, threshold: a wide band on continuous values (candidates
# every step, the clade prior decides among them), tie-heavy integers with a
# narrow band, and a negative threshold (no pair is ever mutual, so the
# fallback runs every step)
CASES = {"continuous": ("real", 5.0), "ties": ("ties", 1e-6),
         "fallback": ("real", -1.0)}


@pytest.mark.parametrize("seed", [11, 2**31 - 1])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("use_cf", [False, True])
# N = 2, 3, 9 and 15 leave blocks of the card's cluster of 8 without lanes
@pytest.mark.parametrize("N", [2, 3, 9, 15, 37, 40, 48, 130, 257])
def test_plain_matches_numpy_twin(N, use_cf, case, seed):
    kind, thr = CASES[case]
    d, dcf = _matrices(kind, N, seed=N + seed % 1000)
    ci, cj = merge_scan_inc_host(d, dcf, use_cf, thr, 0.01, seed)
    counts = {}
    pi, pj = tmi.merge_scan_inc_plain(_t(d), _t(dcf), use_cf, thr, 0.01,
                                      seed, counts)
    assert pi.dtype == torch.int32 and pi.shape == (N - 1,)
    assert np.array_equal(ci, pi.numpy())
    assert np.array_equal(cj, pj.numpy())
    # every step repairs at least the merged row, bar the last one or two
    assert counts["repairs"] >= N - 2
    if case == "fallback":
        assert counts["fallback_steps"] == N - 1
        # the live rows squared, summed over the fallback steps
        assert counts["fallback_entries"] == sum(
            k * k for k in range(2, N + 1))
    if case == "continuous":
        assert counts["fallback_steps"] < N // 2


@pytest.mark.parametrize("N,use_cf,thr,thr_cf,seed", [
    (40, False, 1e-6, 1e-6, 7), (40, False, 5.0, 1e-6, 7),
    (37, False, 1e-6, 1e-6, 7), (37, False, 5.0, 1e-6, 7),
    (40, False, 2.0, 0.5, 11), (40, True, 2.0, 0.5, 11),
    (37, True, 5.0, 0.01, 3),
    (32, False, -1.0, 1e-6, 2),             # the fallback every step
])
def test_plain_matches_pallas_interpret(N, use_cf, thr, thr_cf, seed):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode with a small pending cache (kp=8, so that it flushes mid-scan), and
    the clades against the JAX package's ``clades_from_merges``."""
    kind = "ties" if seed == 3 else "real"
    d, dcf = _matrices(kind, N, seed=seed)
    ci, cj, cl = jax_incremental(jnp.asarray(d), jnp.asarray(dcf), use_cf,
                                 thr, thr_cf, seed, kp=8, interpret=True)
    pi, pj, pl = tmi.merge_scan_incremental(_t(d), _t(dcf), use_cf, thr,
                                            thr_cf, seed)
    assert np.array_equal(np.asarray(ci), pi.numpy())
    assert np.array_equal(np.asarray(cj), pj.numpy())
    assert pl.shape == (N - 1, N) and pl.dtype == torch.float32
    assert np.array_equal(np.asarray(cl), pl.numpy())
    assert np.array_equal(np.asarray(jax_clades(ci, cj, N)), pl.numpy())
    assert tms.launches["merge_scan_inc"] == 0   # CPU tensors: plain version


def test_tie_hash_matches_numpy_twin():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 16384, 4000)
    b = rng.integers(0, 16384, 4000)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    seeds = [0, 1, 2**31 - 1, 12345] + rng.integers(0, 2**31 - 1, 6).tolist()
    for seed in seeds:
        want = _tie_hash_np(lo, hi, seed)
        got = tmi._tie_hash(torch.from_numpy(lo), torch.from_numpy(hi), seed)
        assert got.dtype == torch.float32
        assert np.array_equal(want, got.numpy()), seed
        assert 0 <= got.min() and got.max() < 2**23
    # the key is per pair and static: no step enters it, the seed does
    one = tmi._tie_hash(torch.tensor([3]), torch.tensor([9]), 5)
    assert torch.equal(one, tmi._tie_hash(torch.tensor([3]),
                                          torch.tensor([9]), 5))
    assert not torch.equal(
        tmi._tie_hash(torch.from_numpy(lo), torch.from_numpy(hi), 5),
        tmi._tie_hash(torch.from_numpy(lo), torch.from_numpy(hi), 6))


def test_ties_depend_on_seed_and_cf_on_matrix():
    d, dcf = _matrices("ties", 40, seed=1)
    a = tmi.merge_scan_inc_plain(_t(d), _t(dcf), True, 1e-6, 0.01, 1)
    b = tmi.merge_scan_inc_plain(_t(d), _t(dcf), True, 1e-6, 0.01, 2)
    assert not torch.equal(a[0], b[0]) or not torch.equal(a[1], b[1])
    d, dcf = _matrices("real", 40, seed=1)
    # with wide bands many pairs are mutual in both matrices: the prior
    # sets their score to 0 and steers the scan
    on = tmi.merge_scan_inc_plain(_t(d), _t(dcf), True, 5.0, 1.0, 1)
    off = tmi.merge_scan_inc_plain(_t(d), _t(dcf), False, 5.0, 1.0, 1)
    assert not torch.equal(on[0], off[0]) or not torch.equal(on[1], off[1])


@pytest.mark.parametrize("case", list(CASES))
def test_merge_list_is_a_binary_tree(case):
    kind, thr = CASES[case]
    N = 37
    d, dcf = _matrices(kind, N, seed=4)
    cis, cjs, clades = tmi.merge_scan_incremental(_t(d), _t(dcf), True, thr,
                                                  5.0, 11)
    live = set(range(N))
    for t in range(N - 1):
        a, b = int(cis[t]), int(cjs[t])
        assert a in live and b in live and a != b
        live -= {a, b}
        live.add(N + t)
    assert live == {2 * N - 2}
    assert float(clades[-1].sum()) == N              # the root holds N leaves
    assert (clades.sum(dim=1) >= 2).all()
    assert np.array_equal(
        np.asarray(jax_clades(jnp.asarray(cis.numpy()),
                              jnp.asarray(cjs.numpy()), N)), clades.numpy())


def test_inputs_are_not_modified_and_checked():
    d, dcf = _matrices("real", 16, seed=2)
    td, tc = _t(d), _t(dcf)
    tmi.merge_scan_incremental(td, tc, True, 1.0, 0.1, 3)
    tmi.merge_scan_inc_plain(td, tc, True, 1.0, 0.1, 3)
    assert np.array_equal(td.numpy(), d) and np.array_equal(tc.numpy(), dcf)
    with pytest.raises(TypeError):
        tmi.merge_scan_incremental(td.double(), tc, True, 1.0, 0.1, 3)
    with pytest.raises(ValueError):
        tmi.merge_scan_incremental(td.t(), tc, True, 1.0, 0.1, 3)
    with pytest.raises(ValueError):
        tmi.merge_scan_incremental(td[:, :8], tc, True, 1.0, 0.1, 3)
    with pytest.raises(ValueError):
        tmi.merge_scan_inc_lists(td[:1, :1].contiguous(),
                                 tc[:1, :1].contiguous(), True, 1.0, 0.1, 3)


def test_smallest_sizes():
    """N = 2 and N = 3: one and two merges, the last of the only pair."""
    for N in (2, 3):
        d, dcf = _matrices("real", N, seed=N)
        ci, cj = merge_scan_inc_host(d, dcf, True, 1.0, 0.1, 5)
        pi, pj, pl = tmi.merge_scan_incremental(_t(d), _t(dcf), True, 1.0,
                                                0.1, 5)
        assert np.array_equal(ci, pi.numpy())
        assert np.array_equal(cj, pj.numpy())
        assert float(pl[-1].sum()) == N

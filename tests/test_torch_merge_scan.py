"""The port's plain merge scan against the Pallas kernels of the JAX package
(interpret mode): merge lists and clade rows must be equal exactly, on the
route that emits the clade rows and on the large route that rebuilds them
from the merge lists."""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.ops.merge_scan import clades_from_merges as jax_clades
from relate_tpu.ops.merge_scan import merge_scan_pallas
from relate_tpu_torch.ops import merge_scan as tms

torch.set_num_threads(1)


def _matrices(kind, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "real":
        d = rng.random((N, N)).astype(np.float32) * 10
        dcf = rng.random((N, N)).astype(np.float32) * 3
    else:
        # integer-valued and tie-heavy: the choice rests on the hash
        d = rng.integers(0, 4, (N, N)).astype(np.float32)
        dcf = rng.integers(0, 3, (N, N)).astype(np.float32)
    np.fill_diagonal(d, 0)
    np.fill_diagonal(dcf, 0)
    return d, dcf


# N = 2, 3 and 9 leave most warps and blocks of the card's grid without a
# row; a negative threshold makes no pair mutual, so every step falls back
# to the symmetric argmin
@pytest.mark.parametrize("threshold", [-1.0, 1e-6, 5.0])
@pytest.mark.parametrize("use_cf", [False, True])
@pytest.mark.parametrize("kind", ["real", "ties"])
@pytest.mark.parametrize("N", [2, 3, 9, 33, 40, 48])
def test_merge_scan_plain_matches_pallas(N, kind, use_cf, threshold):
    d, dcf = _matrices(kind, N, seed=N)
    seed = 12345 + N
    ci, cj, cl = merge_scan_pallas(jnp.asarray(d), jnp.asarray(dcf), use_cf,
                                   threshold, 0.01, seed, interpret=True)
    pi, pj, pl = tms.merge_scan(torch.from_numpy(d), torch.from_numpy(dcf),
                                use_cf, threshold, 0.01, seed)
    assert pi.dtype == torch.int32 and pl.shape == (N - 1, N)
    assert np.array_equal(np.asarray(ci), pi.numpy())
    assert np.array_equal(np.asarray(cj), pj.numpy())
    assert np.array_equal(np.asarray(cl), pl.numpy())
    assert np.array_equal(tms.clades_from_merges(pi, pj, N).numpy(),
                          pl.numpy())
    assert tms.launches["merge_scan"] == 0     # CPU tensors: plain version


@pytest.mark.parametrize("threshold", [-1.0, 1e-6, 5.0])
@pytest.mark.parametrize("use_cf", [False, True])
@pytest.mark.parametrize("kind", ["real", "ties"])
@pytest.mark.parametrize("N", [2, 3, 9, 33, 40, 48])
def test_large_plain_matches_large_pallas(N, kind, use_cf, threshold,
                                          monkeypatch):
    """The plain version of the large kernel (merge lists only) against
    ``_kernel_large`` in interpret mode, and the rebuilt clades against the
    JAX package's ``clades_from_merges``: all exactly equal."""
    monkeypatch.setenv("RELATE_TPU_MERGE_LARGE", "1")
    d, dcf = _matrices(kind, N, seed=100 + N)
    seed = 777 + N
    ci, cj, cl = merge_scan_pallas(jnp.asarray(d), jnp.asarray(dcf), use_cf,
                                   threshold, 0.01, seed, interpret=True)
    pi, pj = tms.merge_scan_large(torch.from_numpy(d), torch.from_numpy(dcf),
                                  use_cf, threshold, 0.01, seed)
    assert pi.dtype == torch.int32 and pi.shape == (N - 1,)
    assert np.array_equal(np.asarray(ci), pi.numpy())
    assert np.array_equal(np.asarray(cj), pj.numpy())
    rebuilt = tms.clades_from_merges(pi, pj, N).numpy()
    assert np.array_equal(np.asarray(jax_clades(ci, cj, N)), rebuilt)
    assert np.array_equal(np.asarray(cl), rebuilt)
    assert tms.launches["merge_scan_large"] == 0   # CPU tensors: plain


@pytest.mark.parametrize("kind", ["real", "ties"])
def test_large_route_equals_small_route(kind, monkeypatch):
    """With the small limit lowered, ``merge_scan`` takes the large route
    and gives the same lists and clades as the route with clade rows."""
    N = 40
    d, dcf = _matrices(kind, N, seed=9)
    args = (torch.from_numpy(d), torch.from_numpy(dcf), True, 5.0, 0.01, 31)
    small = tms.merge_scan(*args)
    calls = []
    real_large = tms.merge_scan_large
    monkeypatch.setattr(tms, "merge_scan_large",
                        lambda *a: calls.append(1) or real_large(*a))
    monkeypatch.setattr(tms, "MAX_N_SMALL", 16)
    large = tms.merge_scan(*args)
    assert calls == [1]
    assert len(large) == 3
    for a, b in zip(small, large):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ties_depend_on_seed_and_cf_on_matrix():
    """The tie-heavy case really leans on the hash (another seed gives
    another list) and the clade prior really steers the scan."""
    d, dcf = _matrices("ties", 40, seed=1)
    a = tms.merge_scan_plain(torch.from_numpy(d), torch.from_numpy(dcf),
                             True, 1e-6, 0.01, 1)
    b = tms.merge_scan_plain(torch.from_numpy(d), torch.from_numpy(dcf),
                             True, 1e-6, 0.01, 2)
    assert not torch.equal(a[0], b[0]) or not torch.equal(a[1], b[1])
    # with a wide band every pair is a candidate and the prior decides
    d, dcf = _matrices("real", 40, seed=1)
    on = tms.merge_scan_plain(torch.from_numpy(d), torch.from_numpy(dcf),
                              True, 5.0, 0.01, 1)
    off = tms.merge_scan_plain(torch.from_numpy(d), torch.from_numpy(dcf),
                               False, 5.0, 0.01, 1)
    assert not torch.equal(on[0], off[0]) or not torch.equal(on[1], off[1])


def test_merge_list_is_a_binary_tree():
    d, dcf = _matrices("real", 37, seed=4)
    cis, cjs, clades = tms.merge_scan(torch.from_numpy(d),
                                      torch.from_numpy(dcf), True, 5.0, 5.0,
                                      11)
    N = 37
    live = set(range(N))
    for t in range(N - 1):
        a, b = int(cis[t]), int(cjs[t])
        assert a in live and b in live and a != b
        live -= {a, b}
        live.add(N + t)
    assert live == {2 * N - 2}
    assert float(clades[-1].sum()) == N


def test_inputs_are_not_modified_and_checked():
    d, dcf = _matrices("real", 16, seed=2)
    td, tc = torch.from_numpy(d.copy()), torch.from_numpy(dcf.copy())
    tms.merge_scan(td, tc, True, 1.0, 0.1, 3)
    assert np.array_equal(td.numpy(), d) and np.array_equal(tc.numpy(), dcf)
    with pytest.raises(TypeError):
        tms.merge_scan(td.double(), tc, True, 1.0, 0.1, 3)
    with pytest.raises(ValueError):
        tms.merge_scan(td.t(), tc, True, 1.0, 0.1, 3)
    with pytest.raises(ValueError):
        tms.merge_scan(td[:, :8], tc, True, 1.0, 0.1, 3)


def test_sizes_above_1024_name_the_missing_kernels(monkeypatch):
    """The limits of the three routes (no kernel is missing any more): up to
    1024 the kernel with clade rows, up to 2048 the large one, up to 16384
    the incremental scan, ``ValueError`` above. The limits are lowered here
    so that the route can be taken at a small size."""
    from relate_tpu_torch.ops import merge_scan_inc as tmi
    assert (tms.MAX_N_SMALL, tms.MAX_N_LARGE, tms.MAX_N_INC) == \
        (1024, 2048, 16384)
    # the size is checked before anything is read: a 16385 x 16385 view of
    # one element is enough
    big = torch.zeros(1).expand(16385, 16385)
    with pytest.raises(ValueError, match="supports N <= 16384"):
        tms.merge_scan(big, big, False, 1.0, 0.1, 0)
    with pytest.raises(ValueError, match="supports N <= 16384"):
        tmi.merge_scan_incremental(big, big, False, 1.0, 0.1, 0)
    with pytest.raises(ValueError, match="supports N <= 2048"):
        tms.merge_scan_large(big[:2049, :2049], big[:2049, :2049], False,
                             1.0, 0.1, 0)
    ok = torch.zeros((2048, 2048))
    assert tms._check_inputs(ok, ok, tms.MAX_N_LARGE) == 2048

    N = 40
    d, dcf = _matrices("real", N, seed=9)
    args = (torch.from_numpy(d), torch.from_numpy(dcf), True, 5.0, 0.01, 31)
    calls = []
    real_inc = tmi.merge_scan_incremental
    monkeypatch.setattr(tmi, "merge_scan_incremental",
                        lambda *a: calls.append(1) or real_inc(*a))
    monkeypatch.setattr(tms, "MAX_N_SMALL", 8)
    monkeypatch.setattr(tms, "MAX_N_LARGE", N - 1)     # N is "2049" now
    got = tms.merge_scan(*args)
    assert calls == [1]
    want = tmi.merge_scan_inc_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], tms.clades_from_merges(got[0], got[1], N))
    monkeypatch.setattr(tms, "MAX_N_LARGE", N)         # and "2048" again
    tms.merge_scan(*args)
    assert calls == [1]
    assert tms.launches["merge_scan_inc"] == 0


# the near-set capacity built into the dense kernels (``near_cap()`` on a
# card), read from their source
_NEAR_CAP = int(re.search(
    r"constexpr int NEAR_CAP = (\d+);",
    (Path(tms.__file__).parents[1] / "csrc" / "merge_scan.cu").read_text()
).group(1))


def _genealogy(rng, N):
    """(N, N) coalescence steps of a random merge order, and its merge
    lists in the scan's node ids."""
    members, ids = [[a] for a in range(N)], list(range(N))
    depth = np.zeros((N, N))
    cis, cjs = [], []
    for t in range(N - 1):
        x, y = sorted(rng.choice(len(members), 2, replace=False))
        for a in members[x]:
            depth[a, members[y]] = depth[members[y], a] = t + 1
        cis.append(ids[x])
        cjs.append(ids[y])
        members[x] += members.pop(y)
        ids[x] = N + t
        ids.pop(y)
    return depth, cis, cjs


def _model_inputs(kind, N):
    """(d, dcf, threshold, threshold_cf): distances like a painted panel's
    (a genealogy's coalescence depths with an asymmetric jitter, Relate's
    thresholds at theta = 0.001 and the clade prior of another genealogy),
    tie-heavy integers, or the first with a negative threshold, where no
    pair is ever mutual."""
    from relate_tpu_torch.core.treebuilder import thresholds
    rng = np.random.default_rng(1000 + N)
    if kind == "ties":
        d, dcf = _matrices("ties", N, seed=N)
        return d, dcf, 1e-6, 0.01
    depth, cis, cjs = _genealogy(rng, N)
    d = (depth * (20.0 / N) + rng.random((N, N)) * 0.5).astype(np.float32)
    np.fill_diagonal(d, 0)
    _, cis, cjs = _genealogy(rng, N)
    member = tms.clades_from_merges(torch.tensor(cis), torch.tensor(cjs),
                                    N).numpy()
    val = -float(np.log(0.001 / 0.999))
    dcf = (val * (member.T @ (1.0 - member))).astype(np.float32)
    thr, thr_cf = thresholds(0.001)
    return d, dcf, (-1.0 if kind == "negative_threshold" else thr), thr_cf


@pytest.mark.parametrize("use_cf", [False, True])
@pytest.mark.parametrize("kind", ["posterior", "ties", "negative_threshold"])
@pytest.mark.parametrize("N", [2, 3, 9, 33, 100, 258])
def test_step_state_model_matches_plain(N, kind, use_cf):
    """The dense kernels' step state (``merge_scan_counts``: minima with
    their counts, near sets of the kernels' capacity and the rebuild of those
    that overflow, the fallback on demand) gives the lists of the plain scan,
    holds the row minima and near sets of a full pass at every step, and
    counts what the kernels' counters must read; also with near sets of 4,
    which overflow at every size."""
    d, dcf, thr, thr_cf = _model_inputs(kind, N)
    seed = 4242 + N
    pi, pj = tms.merge_scan_plain(torch.from_numpy(d), torch.from_numpy(dcf),
                                  use_cf, thr, thr_cf, seed,
                                  with_clades=False)
    # after each merge but the last, every live row other than i and j is
    # updated in place or passed in full
    in_place = (N - 1) * (N - 2) // 2
    for cap in (_NEAR_CAP, 4) if N <= 100 else (_NEAR_CAP,):
        ci, cj, c = tms.merge_scan_counts(d, dcf, use_cf, thr, thr_cf, seed,
                                          cap=cap, check=True)
        assert np.array_equal(ci, pi.numpy()) and np.array_equal(cj, pj.numpy())
        assert set(c) == set(tms.COUNTERS) and c["steps"] == N - 1
        assert c["row_updates"] <= in_place
        assert in_place <= c["row_updates"] + c["row_rescans"]
        if kind == "negative_threshold":
            assert c["fallback_steps"] == N - 1
        elif kind == "posterior" and N >= 33:
            assert c["fallback_steps"] < N // 2
            # the minima rarely die: most rows are kept in place
            if cap == _NEAR_CAP:
                assert c["row_rescans"] < 0.2 * c["row_updates"]


def test_counts_land_in_the_record_open_at_the_launch():
    """``read_counts`` takes the scans whose copy has landed, in launch
    order, into the stage record that was open when each was launched, and
    leaves the others waiting."""
    from relate_tpu_torch.utils import trace

    class Copy:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    first, second = {}, {}
    with trace.within(first):
        a = trace.carry(tms._count_scan)
    with trace.within(second):
        b = trace.carry(tms._count_scan)
    late = Copy(False)
    tms._PENDING[:] = [(Copy(True), torch.tensor([8, 20, 2, 1]), a),
                       (late, torch.tensor([8, 20, 0, 0]), b),
                       (Copy(True), torch.tensor([4, 3, 1, 0]), a)]
    try:
        tms.read_counts()
        assert first["counts"] == {"merge_scan.steps": 12,
                                   "merge_scan.row_updates": 23,
                                   "merge_scan.row_rescans": 3,
                                   "merge_scan.fallback_steps": 1}
        assert "counts" not in second and len(tms._PENDING) == 1
        late.done = True
        tms.read_counts()
        assert second["counts"]["merge_scan.row_updates"] == 20
        assert tms._PENDING == []
    finally:
        tms._PENDING[:] = []

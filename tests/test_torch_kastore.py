"""The kastore container and the tskit export of the port
(``relate_tpu_torch/io/kastore.py``, ``io/fileformats.py:to_tree_sequence``)
against the JAX package's: the twins of tests/test_kastore.py, files that
each package writes and the other reads, and both exports of the
reference's ``golden.anc/.mut`` (N = 8, 9,412 trees), which must agree in
every key but ``uuid`` (a fresh uuid4 in each file).

With sample ages the exports differ on purpose (ROADMAP section C): the JAX
export raises every internal node to the oldest sample's age at least; the
port keeps each node's own age and raises it only above its children."""
import numpy as np
import pytest

from relate_tpu.io import fileformats as jff
from relate_tpu.io import kastore as jks
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.core.topology import MutationRecord
from relate_tpu_torch.core.trees import AncesTree, MarginalTree, Tree
from relate_tpu_torch.io import fileformats as tff
from relate_tpu_torch.io import kastore as tks
from relate_tpu_torch.pipeline import scripts as tscripts

AGES = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])


def _items():
    return {
        "alpha": np.arange(7, dtype=np.float64),
        "b/nested": np.asarray([1, -2, 3], np.int32),
        "empty": np.zeros(0, np.uint32),
        "text": np.frombuffer(b"hello", np.int8).copy(),
        "u8": np.arange(5, dtype=np.uint8),
        "i64": np.asarray([-(2 ** 40), 2 ** 40], np.int64),
        "f32": np.asarray([0.5, -1.25], np.float32),
    }


def test_kastore_roundtrip(tmp_path):
    items = _items()
    p = str(tmp_path / "t.kas")
    tks.dump(p, items)
    back = tks.load(p)
    assert sorted(back) == sorted(items)
    for k in items:
        assert back[k].dtype == items[k].dtype
        np.testing.assert_array_equal(back[k], items[k])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_container(tmp_path, writer, reader):
    mods = {"port": tks, "jax": jks}
    items = _items()
    p = str(tmp_path / "t.kas")
    mods[writer].dump(p, items)
    back = mods[reader].load(p)
    assert sorted(back) == sorted(items)
    for k in items:
        assert back[k].dtype == items[k].dtype
        np.testing.assert_array_equal(back[k], items[k])
    q = str(tmp_path / "u.kas")
    mods[reader].dump(q, items)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_container_errors(tmp_path):
    with pytest.raises(ValueError, match="1-D"):
        tks.dump(str(tmp_path / "x"), {"a": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="dtype"):
        tks.dump(str(tmp_path / "x"), {"a": np.zeros(2, np.complex64)})
    (tmp_path / "y").write_bytes(b"not a kastore file at all" * 4)
    with pytest.raises(ValueError, match="kastore"):
        tks.load(str(tmp_path / "y"))


def _tiny_ancmut():
    # 3 leaves: ((0,1),2) then ((1,2),0)
    t1 = Tree(parent=np.asarray([3, 3, 4, 4, -1], np.int32),
              child_left=np.asarray([-1, -1, -1, 0, 3], np.int32),
              child_right=np.asarray([-1, -1, -1, 1, 2], np.int32),
              branch_length=np.asarray([1., 1., 2., 1., 0.]))
    t2 = Tree(parent=np.asarray([4, 3, 3, 4, -1], np.int32),
              child_left=np.asarray([-1, -1, -1, 1, 0], np.int32),
              child_right=np.asarray([-1, -1, -1, 2, 3], np.int32),
              branch_length=np.asarray([3., 1., 1., 2., 0.]))
    anc = AncesTree(N=3, seq=[MarginalTree(0, t1), MarginalTree(2, t2)])
    muts = [MutationRecord(tree=0, branch=[0]),
            MutationRecord(tree=0, branch=[3]),
            MutationRecord(tree=1, branch=[1]),
            MutationRecord(tree=1, branch=[0, 3])]  # not mapping -> skipped
    bp = np.asarray([100, 200, 300, 400])
    return anc, muts, bp


def test_trees_export_native(tmp_path):
    anc, muts, bp = _tiny_ancmut()
    p = str(tmp_path / "out.trees")
    tff.to_tree_sequence(anc, muts, bp, p)
    ks = tks.load(p)
    assert bytes(ks["format/name"]).decode() == "tskit.trees"
    assert list(ks["format/version"]) == [12, 0]
    assert ks["sequence_length"][0] == 401.0
    # 2 trees x 4 edges
    assert len(ks["edges/left"]) == 8
    nt = ks["nodes/time"]
    assert len(nt) == 3 + 2 * 2
    # parent older than child
    tp = nt[ks["edges/parent"]]
    tc = nt[ks["edges/child"]]
    assert (tp > tc).all()
    # edges sorted by (time[parent], parent, child, left)
    order = np.lexsort((ks["edges/left"], ks["edges/child"],
                        ks["edges/parent"], tp))
    assert (order == np.arange(8)).all()
    # mutations: 3 mapping ones, sites at bp of their snps
    assert len(ks["mutations/site"]) == 3
    np.testing.assert_array_equal(ks["sites/position"], [100, 200, 300])
    for key in ("sites/ancestral_state", "mutations/derived_state"):
        off = ks[key + "_offset"]
        assert off[0] == 0 and off[-1] == len(ks[key])
    ins = ks["indexes/edge_insertion_order"]
    assert sorted(ins) == list(range(8))
    assert sorted(ks["indexes/edge_removal_order"]) == list(range(8))


def _same_but_uuid(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "uuid":
            assert len(a[k]) == len(b[k]) == 36
            continue
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def golden_pairs(golden_dir):
    return {name: scripts._load_pair(str(golden_dir / "golden"))
            for name, scripts in (("jax", jscripts), ("port", tscripts))}


def _export(pairs, name, path, ages=None):
    anc, recs, bp, dist, rsid, alleles = pairs[name]
    anc.sample_ages = ages
    (jff if name == "jax" else tff).to_tree_sequence(
        anc, recs, bp, path, alleles=alleles)
    anc.sample_ages = None
    return path


def test_golden_exports_equal_but_uuid(golden_pairs, tmp_path):
    got = {name: _export(golden_pairs, name, str(tmp_path / f"{name}.trees"))
           for name in ("jax", "port")}
    for reader in (jks, tks):
        _same_but_uuid(reader.load(got["jax"]), reader.load(got["port"]))
    ks = tks.load(got["port"])
    anc, recs = golden_pairs["port"][:2]
    M = 2 * anc.N - 1
    assert len(ks["edges/parent"]) == len(anc.seq) * (M - 1)
    nt = ks["nodes/time"]
    assert (nt[ks["edges/parent"]] > nt[ks["edges/child"]]).all()
    assert len(ks["mutations/site"]) == sum(len(m.branch) == 1
                                             for m in recs)
    assert (np.diff(ks["sites/position"]) > 0).all()
    assert bytes(ks["sites/ancestral_state"][:1]).decode() in "ACGT"


def test_sample_ages_keep_each_nodes_own_age(golden_pairs, tmp_path):
    """The JAX export starts its bumps at the oldest sample (4,000
    generations) and moves every younger coalescence up to it; the port's
    nodes keep their ages, raised only above their own children."""
    got = {name: tks.load(_export(golden_pairs, name,
                                  str(tmp_path / f"{name}.trees"), AGES))
           for name in ("jax", "port")}
    N = len(AGES)
    for ks in got.values():
        nt = ks["nodes/time"]
        np.testing.assert_array_equal(nt[:N], AGES)
        assert (nt[ks["edges/parent"]] > nt[ks["edges/child"]]).all()
    jt, pt = got["jax"]["nodes/time"][N:], got["port"]["nodes/time"][N:]
    assert (jt >= AGES.max()).all()
    assert (pt < AGES.max()).mean() > 0.25     # 39 % of the golden nodes
    # the port's node times are the trees' own coordinates but for the
    # bumps above a child (a zero-length branch)
    anc = golden_pairs["port"][0]
    T = 200
    want = []
    for mt in anc.seq[:T]:
        c = mt.tree.coordinates(AGES)
        want.append(np.sort(c[N:]))
    got_t = pt[: T * (N - 1)].reshape(T, N - 1)
    assert np.abs(got_t - np.stack(want)).max() < 1e-5
    assert np.mean(got_t == np.stack(want)) > 0.99
    # the same edges and sites; the edges in another order (by parent time)
    for k in ("sites/position", "mutations/site", "mutations/derived_state"):
        assert np.array_equal(got["jax"][k], got["port"][k]), k
    for k in ("edges/left", "edges/right"):
        assert np.array_equal(np.sort(got["jax"][k]), np.sort(got["port"][k]))


def test_node_times_bump_only_above_children():
    # ((0,1) at 0, 2) at 0: both internal nodes tie with their children
    t = Tree(parent=np.asarray([3, 3, 4, 4, -1], np.int32),
             child_left=np.asarray([-1, -1, -1, 0, 3], np.int32),
             child_right=np.asarray([-1, -1, -1, 1, 2], np.int32),
             branch_length=np.zeros(5))
    ages = np.asarray([0.0, 0.0, 50.0])
    times = tff.export_node_times(t, t.coordinates(ages))
    assert times[3] == 1e-6 and times[4] == 50.0 + 1e-6
    t.branch_length = np.asarray([2.0, 2.0, 1.0, 0.0, 0.0])
    times = tff.export_node_times(t, t.coordinates(ages))
    assert times[3] == 2.0 and times[4] == 51.0

"""The benchmark's files, names and arithmetic."""
import ast
import json
import os
import re

import numpy as np
import pytest

from benchmark import panel, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_panel_is_the_seed_s():
    a = panel.coalescent_panel(40, 600, 2**40 + 3, 178, 10, 4)
    b = panel.coalescent_panel(40, 600, 2**40 + 3, 178, 10, 4)
    c = panel.coalescent_panel(40, 600, 2**40 + 4, 178, 10, 4)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    # a shorter panel is the longer one's first SNPs
    d = panel.coalescent_panel(40, 355, 2**40 + 3, 178, 10, 4)
    assert np.array_equal(d[0], a[0][:355])


def test_interchanges_keep_a_coalescent_tree():
    rng = np.random.default_rng(5)
    N = 200
    tree = panel.kingman_tree(N, rng)
    clades = panel.clade_matrix(tree[1], tree[2], N)
    panel.interchanges(rng, 5000, tree, clades)
    parent, cl, cr, height = tree
    assert (height[parent[:-1]] > height[:-1]).all()
    assert all(parent[cl[v]] == v and parent[cr[v]] == v
               for v in range(N, 2 * N - 1))
    assert np.array_equal(clades, panel.clade_matrix(cl, cr, N))
    leaves = np.unpackbits(clades, axis=1, count=N)
    assert (leaves[2 * N - 2] == 1).all() and (leaves[:N] == np.eye(N)).all()


def test_panel_rows_are_clades():
    G, _ = panel.coalescent_panel(50, 400, 9, 178, 10, 40)
    counts = G.sum(axis=1)
    assert (counts >= 1).all() and (counts <= 49).all()


def test_watterson_spacing():
    assert panel.watterson_spacing_bp(1006, 3e4, 1.25e-8) == 178
    assert panel.watterson_spacing_bp(1858, 3e4, 1.25e-8) == 165


def test_haps_rows(tmp_path):
    G = np.array([[0, 1, 1, 0], [1, 1, 0, 0]], dtype=np.uint8)
    p = panel.write_region(str(tmp_path), G, np.array([10, 20]), 1.0)
    assert open(p["haps"]).read() == ("1 snp0 10 A T 0 1 1 0\n"
                                      "1 snp1 20 A T 1 1 0 0\n")


def test_kernel_table_bounds():
    # PERF.md's kernel table: B5 0.0481 ms at N = 1,024, B6 4.892 ms at 2,048
    assert roofline.merge_scan_b5(1024) * 1e3 == pytest.approx(0.0481,
                                                               abs=5e-5)
    assert roofline.merge_scan_b6(2048) * 1e3 == pytest.approx(4.892,
                                                               abs=5e-4)


def test_cells_name_what_exists():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs
        t = os.path.join(BENCH, "traffic", w["traffic"] + ".json")
        with open(t) as f:
            gen = json.load(f)["generator"]
        assert os.path.exists(os.path.join(BENCH, "traffic", gen + ".py"))
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg)
        assert set(cfg["limits"]) == {"merge_regret", "reverts_per_ksnp",
                                      "clock_gap"}


def test_names_units_and_readers():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert {"snps_per_s", "setup_s"} <= e2e
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return {n.split(".")[0] for n in out}


def test_nothing_imports_jax():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                tops = _imports(os.path.join(d, f))
                assert not tops & {"jax", "jaxlib", "flax", "relate_tpu"}, f


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "panel.py", "roofline.py"):
        tops = _imports(os.path.join(BENCH, f))
        assert tops <= {"__future__", "math", "os", "numpy", "torch"}, f

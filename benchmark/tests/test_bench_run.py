"""A run of the harness on the CPU at a tiny size (the plain versions of the
program's kernels), sound and with the timed path broken underneath: each
fault a cell can have must make ``correct`` false."""
import json
import time

import numpy as np
import pytest

from benchmark import run

SEED = 2**33 + 17


def tiny(monkeypatch, N=24, job_snps=300):
    bench, cell, cfg, tr = run.load_cell("kgp_eur.all")
    cfg = dict(cfg, haplotypes=N, chromosome_snps=4000)
    tr = dict(tr, job_snps=job_snps, regions=2, warmup_snps=100,
              memory_gb_off_card=0.001)
    monkeypatch.setattr(run, "load_cell", lambda name: (bench, cell, cfg, tr))


def run_tiny(cards=None):
    return run.run_cell("kgp_eur.all", SEED, 0.2, False, time.time(),
                        device="cpu", cards=cards)


def test_sound_run_and_its_line(monkeypatch):
    tiny(monkeypatch)
    res = run_tiny()
    assert res["correct"], res["checks"]
    line = json.loads(run.result_line(res))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"snps_per_s", "setup_s"}
    assert list(line["checks"]) == ["jobs_failed", "tree_faults",
                                    "snp_faults", "reverts_per_ksnp",
                                    "clock_gap", "merge_regret"]
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert run.main(["--workload", "kgp_eur.all", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_chains_that_leave_the_trees_as_built(monkeypatch):
    from relate_tpu_torch.pipeline import relate
    tiny(monkeypatch)
    monkeypatch.setattr(relate, "infer_branch_lengths",
                        lambda *a, **k: None)
    res = run_tiny()
    assert not res["correct"] and res["checks"]["tree_faults"]["value"] > 0


def test_half_the_targets_left_out(monkeypatch):
    from relate_tpu_torch.core import topology_device
    tiny(monkeypatch)
    orig = topology_device._assemble_ops

    def half(*a, **k):
        mat = orig(*a, **k)
        B = mat.shape[0]
        mat[B // 2:] = mat[:B // 2].mean(dim=0)
        return mat
    monkeypatch.setattr(topology_device, "_assemble_ops", half)
    res = run_tiny()
    assert not res["correct"]
    assert res["checks"]["merge_regret"]["value"] > \
        res["checks"]["merge_regret"]["limit"]


def test_an_answer_altered_where_it_is_made(monkeypatch):
    from relate_tpu_torch.core import topology_device
    tiny(monkeypatch)
    orig = topology_device.build_topology_section_device

    def altered(*a, **k):
        res = orig(*a, **k)
        m = next(m for m in res.muts[5:] if len(m.branch) == 1)
        m.branch = [(m.branch[0] + 1) % (2 * res.anc.N - 2)]
        return res
    monkeypatch.setattr(topology_device, "build_topology_section_device",
                        altered)
    res = run_tiny()
    assert not res["correct"] and res["checks"]["snp_faults"]["value"] > 0


def test_a_merge_altered_where_it_is_made(monkeypatch):
    from relate_tpu_torch.core import topology_device
    tiny(monkeypatch)
    orig = topology_device.tree_from_merges

    def altered(cis, cjs, N):
        # two leaves trade places: still a tree, not the one the scan built
        cis, cjs = np.array(cis), np.array(cjs)
        both = np.concatenate([cis, cjs])
        a, b = 0, 1
        for arr in (cis, cjs):
            arr[:] = np.where(arr == a, -1, arr)
            arr[:] = np.where(arr == b, a, arr)
            arr[:] = np.where(arr == -1, b, arr)
        assert sorted(both.tolist()) == sorted(
            np.concatenate([cis, cjs]).tolist())
        return orig(cis, cjs, N)
    monkeypatch.setattr(topology_device, "tree_from_merges", altered)
    res = run_tiny()
    assert not res["correct"]


def test_a_section_that_never_rebuilds(monkeypatch, faults):
    tiny(monkeypatch)
    faults.no_rebuild()
    res = run_tiny()
    c = res["checks"]["reverts_per_ksnp"]
    assert not res["correct"] and c["value"] > c["limit"]


def test_chains_off_the_clock(monkeypatch, faults):
    tiny(monkeypatch)
    faults.lengths_doubled()
    res = run_tiny()
    c = res["checks"]["clock_gap"]
    assert not res["correct"] and c["value"] > c["limit"]


def test_the_exchange_between_cards_left_out(monkeypatch):
    from relate_tpu_torch.pipeline import relate
    tiny(monkeypatch)
    monkeypatch.setattr(relate, "_set_lengths", lambda anc, bl: None)
    res = run_tiny(cards=["cpu", "cpu"])
    assert not res["correct"] and res["checks"]["tree_faults"]["value"] > 0

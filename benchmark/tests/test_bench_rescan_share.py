"""The reader of ``scan_rescan_share`` on made-up records."""
import pytest

from benchmark import run


def job(*stages):
    return dict(stages=list(stages))


def record(stage, **counts):
    return dict(stage=stage, counts={"merge_scan." + k: v
                                     for k, v in counts.items()})


def test_share_of_the_build_records():
    ctx = dict(jobs=[
        job(record("run_all.build_topology", row_updates=1000,
                   row_rescans=3),
            record("run_all.paint")),
        job(record("build_topology", row_updates=3000, row_rescans=17))])
    assert run.read_metric("scan_rescan_share", ctx) == pytest.approx(0.5)


def test_no_counts_reads_nothing():
    ctx = dict(jobs=[job(dict(stage="run_all.build_topology",
                              counts={"topology.readbacks": 9}),
                         dict(stage="run_all.paint"))])
    assert run.read_metric("scan_rescan_share", ctx) is None
    assert run.read_metric("scan_rescan_share", dict(jobs=[])) is None


def test_other_records_are_left_out():
    ctx = dict(jobs=[job(
        record("run_all.build_topology", row_updates=200, row_rescans=2),
        record("run_all.optimize_parameters", row_updates=100,
               row_rescans=100),
        record("run_all.build_topology_host", row_updates=5,
               row_rescans=5))])
    assert run.read_metric("scan_rescan_share", ctx) == pytest.approx(1.0)

"""On the card, at each one-card cell's own size: the control (the
reference in bfloat16 put in the program's place) must fail the merge check
that sound runs pass, on three seeds; sound runs read ``reverts_per_ksnp``
and ``clock_gap`` within their limits on a dozen seeds, and the faults
planted for them (no rebuild; the chains' lengths doubled) above, on
three; a traced run carries its breakdown.

    python3 -m pytest benchmark/tests/test_bench_card.py -q -s

prints each seed's readings (``[control] ...``, ``[reading] ...``)."""
import json
import time

import pytest

from benchmark import run

CELLS = ("kgp_eur.all", "hgdp.all")
SEEDS = (2**31 + 11, 977, 123456789)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    limit = None
    for seed in SEEDS:
        res = run.run_cell(cell, seed, 1.0, False, time.time(), control=True)
        limit = res["checks"]["merge_regret"]["limit"]
        prog = res["checks"]["merge_regret"]["value"]
        print(f"[control] {cell} seed {seed}: program {prog} control "
              f"{res['control_regret']} limit {limit}", flush=True)
        assert res["correct"], res["checks"]
        assert res["control_regret"] > limit


READ_SEEDS = (2**31 + 101, 3, 41, 777, 9001, 65537, 123457, 2**32 + 5,
              31415926, 271828, 1618033, 2**33 + 99)
FAULT_SEEDS = READ_SEEDS[:3]
FAULT_OF = dict(no_rebuild="reverts_per_ksnp", lengths_doubled="clock_gap")


def _reading(cell, seed, tag):
    """One job of the cell, checked without the merge replay: the numbers
    the other checks compare."""
    res = run.run_cell(cell, seed, 1.0, False, time.time(), replay=False)
    c = res["checks"]
    print(f"[reading] {tag} {cell} seed {seed}: "
          + " ".join(f"{k} {v['value']} (limit {v['limit']})"
                     for k, v in c.items() if k != "merge_regret"),
          flush=True)
    return c


@pytest.mark.card
@pytest.mark.parametrize("seed", READ_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_within_the_limits(card, cell, seed):
    c = _reading(cell, seed, "sound")
    assert all(v["value"] <= v["limit"] for k, v in c.items()
               if k != "merge_regret"), c


@pytest.mark.card
@pytest.mark.parametrize("seed", FAULT_SEEDS)
@pytest.mark.parametrize("fault", list(FAULT_OF))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_above_the_limits(card, faults, cell, fault, seed):
    getattr(faults, fault)()
    c = _reading(cell, seed, fault)[FAULT_OF[fault]]
    assert c["value"] > c["limit"]


@pytest.mark.card
def test_traced_run_has_its_breakdown(card):
    res = run.run_cell("kgp_eur.all", 31337, 1.0, True, time.time())
    line = json.loads(run.result_line(res))
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "paint_roofline" in line["metrics"]

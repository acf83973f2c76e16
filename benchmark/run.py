#!/usr/bin/env python3
"""Benchmark of ``relate_tpu_torch`` (the PyTorch and CUDA port) on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, and
prints one JSON object as its last line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
then the numbers compared under ``checks``. With ``--trace 0`` the metrics
are the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from the program's stage records of the window's jobs and from the
profiler's trace of its first job.

Set-up (``setup_s``, from the process's start to the window's): the
cell's configuration (``configs/<config>.json``) and traffic
(``traffic/<traffic>.json``, read by ``traffic/<generator>.py``) make the
panel from the seed and write its regions; one warm-up job loads the
program's kernels (built into its checkout at the first run). The window
runs jobs back to back until ``--seconds`` have passed; the job running
then is finished and counted. Then the traffic's ``check`` holds the
outputs against the plain reference (``check.py``). A run without a card,
or with fewer cards than the cell asks for, exits with 2 and prints no
result; so does one in whose process JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "relate_tpu")


def _process_start() -> float:
    """The host clock at this process's start."""
    with open("/proc/self/stat") as f:
        ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules():
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str):
    """(bench, cell, config, traffic) from BENCHMARK.json and the files
    named there."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(ROOT, configs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def metric_names(bench, cell, kind: str):
    out = []
    for m in bench[kind]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        out.append(m)
    return out


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0] if out.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def _write_bytes() -> int:
    """Bytes this process handed to write() (files, pipes): an upper bound
    of what it wrote to disk; the pool workers' writes are not in it."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    return 0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, cards=None,
             control: bool = False, replay: bool = True) -> dict:
    """One run of a cell. ``device``/``cards`` default to the CUDA cards
    (``device="cpu"`` is for the CPU tests, which also give the traffic a
    ``memory_gb``, and ``cards`` for a mesh of host devices); ``control`` also
    reads the control's number (``control_regret``, the reference in
    bfloat16), which the runs of the benchmark do not; ``replay`` False
    leaves the check's merge replay out (for readings of the other numbers;
    such a run is not correct)."""
    import torch
    from benchmark import devtrace
    from relate_tpu_torch.ops import paint_kernels
    from relate_tpu_torch.parallel.mesh import default_mesh
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import trace as ptrace

    bench, cell, cfg, tparams = load_cell(workload)
    chips = int(cell["chips"])
    on_card = device is None
    mesh = None
    if on_card:
        device = torch.device("cuda:0")
        if chips > 1:
            mesh = default_mesh(chips)
    elif cards is not None:
        mesh = cards
    if "memory_gb_off_card" in tparams and not on_card:
        tparams = dict(tparams, memory_gb=tparams["memory_gb_off_card"])
    gen = importlib.import_module(
        f"benchmark.traffic.{tparams['generator']}")
    work = tempfile.mkdtemp(prefix="relate_bench_")
    w0 = _write_bytes()
    try:
        traffic = gen.Traffic(cfg, tparams, seed, os.path.join(work, "in"))
        traffic.run(relate, -1, os.path.join(work, "warm", "out"), device,
                    mesh)
        if on_card:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        jobs = []
        profile = None
        sweeps = None
        t_win = time.time()
        setup_s = t_win - t_start
        i = 0
        while True:
            out = os.path.join(work, "jobs", str(i), "out")
            os.makedirs(os.path.dirname(out))
            n0 = len(ptrace.STAGES)
            profiled = trace and i == 0
            ok = True
            t0 = time.time()
            try:
                if profiled:
                    with devtrace.profiled_job() as profile, \
                            devtrace.SweepLog(paint_kernels) as sweeps:
                        snps = traffic.run(relate, i, out, device, mesh)
                else:
                    snps = traffic.run(relate, i, out, device, mesh)
            except Exception as e:  # noqa: BLE001 - a failed job is counted
                ok = False
                snps = 0
                print(f"[bench] job {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
            t1 = time.time()
            jobs.append(dict(index=i, out=out, ok=ok, snps=snps,
                             wall_s=t1 - t0, profiled=profiled,
                             stages=ptrace.STAGES[n0:]))
            i += 1
            if t1 - t_win >= seconds and (not trace or len(jobs) >= 2):
                break
        t_end = time.time()
        written = _write_bytes() - w0
        peak = 0.0
        for j in jobs:
            for r in j["stages"]:
                peak = max([peak, r.get("dev_peak_mb", 0.0)]
                           + list(r.get("dev_peak_mb_by_card", {}).values()))
        ncards = len(mesh) if mesh is not None else 1
        found = forbidden_modules()
        ctx = dict(jobs=[j for j in jobs if not j["profiled"] and j["ok"]],
                   cfg=cfg, cards=ncards, peak_mb=peak)
        result = dict(correct=False, attempted=len(jobs),
                      failed=sum(not j["ok"] for j in jobs), metrics={})
        if on_card:
            result["device"] = dict(
                platform="gpu", kind=torch.cuda.get_device_name(0),
                count=ncards, memory_peak_bytes=int(peak * 1e6),
                power_limit=_power_limit())
        else:
            result["device"] = dict(platform="cpu", kind="cpu", count=ncards,
                                    memory_peak_bytes=int(peak * 1e6))
        if trace:
            pj = jobs[0]
            stages = []
            s = 0.0
            for r in pj["stages"]:
                stages.append((r["stage"].split(".", 1)[-1], s,
                               s + r["wall_s"]))
                s += r["wall_s"]
            summ = devtrace.summarize(profile.get("events", []),
                                      profile["wall_s"], ncards, stages)
            ctx["profile"] = summ
            ctx["sweep_bounds"] = sweeps.bounds()
            busy = sum(summ["busy"].values()) / ncards
            result["device"].update(busy_s=busy, window_s=summ["wall_s"])
            top = sorted(summ["by_name"].items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(summ["idle"], key=lambda kv: -kv[1])[:10]
            result["breakdown"] = dict(device_ops=[[k, v] for k, v in top],
                                       idle_gaps=[[k, v] for k, v in gaps])
            for m in metric_names(bench, cell, "per_layer"):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    result["metrics"][m["name"]] = dict(value=v,
                                                        unit=m["unit"])
        else:
            done = sum(j["snps"] for j in jobs)
            result["metrics"]["snps_per_s"] = dict(
                value=done / (t_end - t_win), unit="SNPs/s")
            result["metrics"]["setup_s"] = dict(value=setup_s, unit="s")
        tb = sum(n["tree_builds"] for j in jobs for r in j["stages"]
                 for n in r.get("topology", []))
        print(f"[bench] {len(jobs)} jobs, {sum(j['snps'] for j in jobs)} "
              f"SNPs, {tb} tree builds "
              f"({tb / max(1, sum(j['snps'] for j in jobs)):.4f} a SNP), "
              f"{written} bytes written by this process, "
              f"{traffic.regions} regions"
              + (", regions taken again" if len(jobs) > traffic.regions
                 else ""), file=sys.stderr)
        # the program's state is freed before the reference runs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_c = time.time()
        chk = traffic.check(jobs, device, control=control, replay=replay)
        for d in chk["notes"]:
            print(f"[bench] check: {d}", file=sys.stderr)
        print(f"[bench] check: {time.time() - t_c:.1f} s in all",
              file=sys.stderr)
        if found:
            print(f"[bench] loaded in this process: {', '.join(found)}",
                  file=sys.stderr)
            result["forbidden"] = found
        if control:
            result["control_regret"] = chk["control_regret"]
        result["correct"] = chk["correct"]
        result["checks"] = checks = chk["checks"]
        for k, c in checks.items():
            print(f"[bench] {k} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def result_line(res: dict) -> str:
    """The result's JSON line, the numbers compared under its last key."""
    res = dict(res)
    checks = res.pop("checks")
    res.pop("forbidden", None)
    res["checks"] = checks
    return json.dumps(res)


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    _, cell, _, _ = load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    found = forbidden_modules()
    if found or res.get("forbidden"):
        print("JAX or the JAX package was loaded: "
              f"{', '.join(found or res['forbidden'])}", file=sys.stderr)
        return 2
    print(result_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``run_all`` on several hosts (``num_hosts``, ``host_id``; the CLI's
``--num_hosts``, ``--host_id``, ``--barrier_timeout``): one process a host
on one shared store, the counterpart of
``tests/test_cli_smoke.py::test_run_all_two_host_processes_identical``.

Host 0 plans the chunks and finalizes, chunk c runs on host c mod H, and
every host waits for each chunk's ``DONE``. Two real OS processes of the
port's CLI (host 1 started first, so that it waits for the plan) must write
the ``.anc``/``.mut`` of one host byte for byte, and, with the chains of
both packages replaced by one function of the tree (as in
``test_torch_mesh.py``), those of the JAX package's two host processes.
The chunk constants are shrunk in the host processes' script, as the JAX
test does, so that a 600-SNP panel plans as several chunks and each host
owns one or more.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from relate_tpu_torch.io import chunking as tchunking
from relate_tpu_torch.pipeline import cli as tcli
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMORY_GB = 1e-5          # a tiny budget: several chunks on 600 SNPs
SHRUNK = dict(OVERLAP=60, MERGE_DISCARD=30, MAX_WINDOWS_PER_CHUNK=4)
PROCESS_TIMEOUT_S = 300
SHRINK = f"""
chunking.OVERLAP = {SHRUNK['OVERLAP']}
chunking.MERGE_DISCARD = relate.MERGE_DISCARD = {SHRUNK['MERGE_DISCARD']}
chunking.MAX_WINDOWS_PER_CHUNK = {SHRUNK['MAX_WINDOWS_PER_CHUNK']}
"""

HOST_SCRIPT = f"""
import json, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from relate_tpu_torch.io import chunking
from relate_tpu_torch.pipeline import cli, relate
{SHRINK}
owned, finalized = [], []
combine, finalize = relate.combine_sections, relate.finalize

def combine_sections(store, c, **kw):
    owned.append(c)
    return combine(store, c, **kw)

def finalize_once(*a, **kw):
    finalized.append(True)
    return finalize(*a, **kw)

relate.combine_sections = combine_sections
relate.finalize = finalize_once
rc = cli.main(sys.argv[1:])
print(json.dumps(dict(owned=owned, finalized=bool(finalized))))
sys.exit(rc)
"""


# the chains of both packages: one function of the tree
FIXED_LENGTHS = """
import numpy as np

def fixed_lengths(trees, *args, **kwargs):
    out = []
    for tr in trees:
        M = len(tr.parent)
        bl = (10.0 * np.asarray(tr.num_events, dtype=np.float64)
              + (np.arange(M) % 5) + 1.0)
        bl[M - 1] = 0.0
        out.append(bl)
    return np.asarray(out)
"""

# a JAX host: the merge scan's Pallas kernel in interpret mode, the
# painter's scan, the host read from RELATE_TPU_NUM_HOSTS / _HOST_ID
JAX_HOST_SCRIPT = f"""
import os, sys
os.environ.update(RELATE_TPU_PALLAS_INTERPRET="1",
                  RELATE_TPU_PAINT_DMAX_BUCKET="8",
                  RELATE_TPU_PAINT_L_BUCKET="64")
sys.path.insert(0, {REPO!r})
from relate_tpu.core import painting, topology_device
from relate_tpu.io import chunking
from relate_tpu.pipeline import relate
{SHRINK}{FIXED_LENGTHS}
topology_device._pallas_available = lambda n: True
painting.Painter._use_pallas = lambda self: False
relate.mcmc.run_mcmc = fixed_lengths
relate.run_all(*sys.argv[1:5], seed=1, verbose=False, memory_gb={MEMORY_GB})
"""

# a port host: the JAX package's tie-break seeds of the merge scan
PORT_HOST_SCRIPT = f"""
import sys
sys.path.insert(0, {REPO!r})
import jax
import torch
torch.set_num_threads(1)
from relate_tpu_torch.core import topology_device
from relate_tpu_torch.io import chunking
from relate_tpu_torch.pipeline import cli, relate
{SHRINK}{FIXED_LENGTHS}

def jax_merge_seeds(seed, S):
    key = jax.random.PRNGKey(seed)
    return np.asarray([
        int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                               np.int32(2**31 - 1)))
        for i in range(S + 1)], dtype=np.int32)

topology_device.default_merge_seeds = jax_merge_seeds
relate.mcmc.run_mcmc = fixed_lengths
sys.exit(cli.main(sys.argv[1:]))
"""


def _two_hosts(script, argv_of, env_of=lambda host: None):
    """Host 1, then host 0, of ``script`` (``argv_of(host)``, environment
    ``env_of(host)``); the output of each, once both exited with 0."""
    procs, said = {}, {}
    try:
        for host in (1, 0):              # host 1 first: it waits for the plan
            procs[host] = subprocess.Popen(
                [sys.executable, str(script)] + argv_of(host),
                env=env_of(host), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
            if host == 1:
                time.sleep(0.5)
        for host, p in procs.items():
            out, _ = p.communicate(timeout=PROCESS_TIMEOUT_S)
            said[host] = out.decode(errors="replace")
            assert p.returncode == 0, said[host][-3000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return said


@pytest.fixture
def shrunk(monkeypatch):
    for k, v in SHRUNK.items():
        monkeypatch.setattr(tchunking, k, v)
    monkeypatch.setattr(trelate, "MERGE_DISCARD", SHRUNK["MERGE_DISCARD"])


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hosts")
    G, bp = synth.synth_panel(8, 600, seed=11)
    prefix = str(tmp / "p")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    return G, ["--haps", prefix + ".haps", "--sample", prefix + ".sample",
               "--map", prefix + ".map", "--memory", str(MEMORY_GB),
               "--device", "cpu"]


def _args(panel, out):
    a = panel[1]
    return (a[1], a[3], a[5], out)


def test_two_host_processes_write_the_bytes_of_one_host(panel, tmp_path,
                                                        shrunk):
    G, inputs = panel
    plan, _ = tchunking.plan_chunks_and_windows(G, MEMORY_GB)
    assert plan.num_chunks >= 3          # host 0 owns two, host 1 one
    one = str(tmp_path / "one")
    assert tcli.main(["--mode", "All", "-o", one] + inputs) == 0

    script = tmp_path / "host.py"
    script.write_text(HOST_SCRIPT)
    two = str(tmp_path / "two")
    said = _two_hosts(script, lambda host: [
        "--mode", "All", "-o", two, "--num_hosts", "2", "--host_id",
        str(host), "--barrier_timeout", str(PROCESS_TIMEOUT_S)] + inputs)
    said = {h: json.loads(t.strip().splitlines()[-1])
            for h, t in said.items()}
    for ext in (".anc", ".mut"):
        with open(one + ext, "rb") as a, open(two + ext, "rb") as b:
            assert a.read() == b.read(), ext
    assert said[0]["owned"] == list(range(0, plan.num_chunks, 2))
    assert said[1]["owned"] == list(range(1, plan.num_chunks, 2))
    assert said[0]["finalized"] and not said[1]["finalized"]
    assert not os.path.exists(two + ".tmpdir")     # host 0 cleaned up


def test_two_host_processes_write_the_bytes_of_the_jax_hosts(panel,
                                                             tmp_path):
    """Two host processes of each package on a store of its own, the
    chains of both replaced by one function of the tree and the port given
    the JAX package's tie-break seeds (``test_torch_mesh.py``'s stand-ins):
    the whole .anc and .mut byte for byte."""
    args = _args(panel, "")[:3]
    jax_script = tmp_path / "jax_host.py"
    port_script = tmp_path / "port_host.py"
    jax_script.write_text(JAX_HOST_SCRIPT)
    port_script.write_text(PORT_HOST_SCRIPT)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", RELATE_TPU_NUM_HOSTS="2",
               RELATE_TPU_BARRIER_TIMEOUT_S=str(PROCESS_TIMEOUT_S))
    _two_hosts(jax_script, lambda host: list(args) + [jax_out],
               lambda host: dict(env, RELATE_TPU_HOST_ID=str(host)))
    port_env = {k: v for k, v in env.items()
                if not k.startswith("RELATE_TPU_")}
    _two_hosts(port_script, lambda host: [
        "--mode", "All", "-o", port_out, "--num_hosts", "2", "--host_id",
        str(host), "--barrier_timeout", str(PROCESS_TIMEOUT_S)] + panel[1],
        lambda host: port_env)
    for ext in (".anc", ".mut"):
        with open(jax_out + ext, "rb") as a, open(port_out + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_a_lone_host_times_out(panel, tmp_path, shrunk):
    """Host 1 without host 0 raises at the plan within its timeout; with
    host 0's plan in the store it runs its own chunks (each ends with its
    ``DONE``), then raises at the barrier, and writes no final .anc."""
    args = _args(panel, str(tmp_path / "out"))
    store = args[3] + ".tmpdir"
    t0 = time.time()
    with pytest.raises(TimeoutError, match="plan.json"):
        trelate.run_all(*args, memory_gb=MEMORY_GB, verbose=False,
                        device="cpu", num_hosts=2, host_id=1,
                        barrier_timeout_s=1.0)
    assert time.time() - t0 < 10.0
    plan = trelate.make_chunks(*args[:3], store, MEMORY_GB, device="cpu")
    with pytest.raises(TimeoutError, match="DONE"):
        trelate.run_all(*args, memory_gb=MEMORY_GB, verbose=False,
                        device="cpu", num_hosts=2, host_id=1,
                        barrier_timeout_s=2.0)
    done = [os.path.exists(os.path.join(store, f"chunk_{c}", "DONE"))
            for c in range(plan.num_chunks)]
    assert done == [c % 2 == 1 for c in range(plan.num_chunks)]
    assert not os.path.exists(args[3] + ".anc")


def test_a_host_needs_its_card_and_its_place(panel, tmp_path, monkeypatch):
    """No card and no ``device="cpu"``: a host raises before it waits.
    ``host_id`` outside [0, num_hosts) raises."""
    args = _args(panel, str(tmp_path / "out"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trelate.run_all(*args, memory_gb=MEMORY_GB, num_hosts=2, host_id=1,
                        barrier_timeout_s=30.0)
    for host, hosts in ((2, 2), (-1, 2), (0, 0)):
        with pytest.raises(ValueError, match="host_id"):
            trelate.run_all(*args, memory_gb=MEMORY_GB, device="cpu",
                            num_hosts=hosts, host_id=host)
    assert not os.listdir(tmp_path)


def test_cli_host_flags_reach_run_all(panel, tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(trelate, "run_all",
                        lambda *a, **kw: seen.append(kw) or a[3])
    assert tcli.main(["--mode", "All", "-o", str(tmp_path / "o"),
                      "--num_hosts", "3", "--host_id", "2",
                      "--barrier_timeout", "7.5"] + panel[1]) == 0
    assert tcli.main(["--mode", "All", "-o", str(tmp_path / "o")]
                     + panel[1]) == 0
    got = [(kw["num_hosts"], kw["host_id"], kw["barrier_timeout_s"])
           for kw in seen]
    assert got == [(3, 2, 7.5), (1, 0, 86400.0)]
    for flag in (["--num_hosts", "2"], ["--host_id", "1"]):
        with pytest.raises(SystemExit, match="apply to --mode All"):
            tcli.main(["--mode", "Paint", "-o", str(tmp_path / "o")] + flag)
    assert all(isinstance(kw["barrier_timeout_s"], float) for kw in seen)

"""The build of the port's CUDA sources (``relate_tpu_torch/ops/_build.py``)
names each library by a hash of what it is built from, so a changed input
never loads a stale library. Runs without ``nvcc``: only names are made."""
import shutil

from relate_tpu_torch.ops import _build


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """Editing ``csrc/paint_sweep.cuh`` renames the libraries of the two
    sources that include it, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = {n: _build._target(n) for n in _build.SOURCES}
    with open(csrc / "paint_sweep.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == {
        "paint_bwd", "paint_capture"}
    assert _build._target("paint_bwd") == after["paint_bwd"]   # stable

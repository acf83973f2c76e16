"""The benchmark's own tests. Those that need the card are marked ``card``
and skip inside the test (the ``card`` fixture) where none is visible."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")


class Faults:
    """Faults planted in the program where each is made, for the tests that
    must see ``correct`` come out false."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def no_rebuild(self):
        """Every candidate tree is reverted: the section keeps its first
        tree (a one-SNP mapping is the rebuild's; it reads as no better)."""
        import torch
        from relate_tpu_torch.core import topology_device as td
        orig = td._map_on_tree

        def mapped(leafmat, csize, car, tc, N, M, thr, cc=None):
            m = orig(leafmat, csize, car, tc, N, M, thr, cc)
            if car.shape[0] != 1:
                return m
            return m._replace(im=torch.full_like(m.im, 3),
                              branch=torch.full_like(m.branch, -1),
                              flipped=torch.zeros_like(m.flipped),
                              minv=torch.full_like(m.minv, float("inf")))
        self.mp.setattr(td, "_map_on_tree", mapped)

    def lengths_doubled(self):
        """The chains' branch lengths twice what they sampled."""
        from relate_tpu_torch.pipeline import relate
        orig = relate._chains
        self.mp.setattr(relate, "_chains", lambda *a, **k: 2 * orig(*a, **k))


@pytest.fixture
def faults(monkeypatch):
    return Faults(monkeypatch)

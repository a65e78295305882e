"""Shared set-up of the benchmark's tests (`test_gtobench_*.py`): cells
cut to a size the CPU runs in seconds (10 surface points a link, T = 12, a
few problems), on the same code paths as on the card; and the card, or a
skip decided when a test runs."""

from __future__ import annotations

import pytest
import torch

from gtobench import manifest, run


_cell = manifest.cell


def tiny_cell(workload: str) -> manifest.Cell:
    c = _cell(manifest.load(run.ROOT), run.ROOT, workload)
    cfg, tr = dict(c.config), dict(c.traffic)
    cfg.update(points_per_link=10, T=12, goals_per_set=2)
    tr.update(batch=3)
    return manifest.Cell(c.name, 1, cfg, tr, c.limits, c.end_to_end, c.per_layer)


@pytest.fixture
def tiny(monkeypatch):
    """Make `manifest.cell` return the tiny cell of a workload."""
    monkeypatch.setattr(manifest, "cell", lambda m, root, w: tiny_cell(w))
    torch.set_num_threads(2)
    return tiny_cell


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

"""The control on the card: the reference, computed in the precision below
the configuration's (float32 with TF32 matrix products) and put in the
program's place, has to come out as not correct, while the program passes
the same limits, at the cell's own size (the limits hold there: at 256
problems the control's widest gaps are below them). `python3 -m
gtobench.control` reads the same numbers on more seeds. Marked `gpu`: it
skips without a card."""

from __future__ import annotations

import pytest

from gtobench import manifest, run
from gtobench.testcells import cuda_device  # noqa: F401  (a fixture)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["goalset-b2048-stream"])
def test_the_control_is_not_correct(cuda_device, workload):
    import importlib

    import torch

    cell = manifest.cell(manifest.load(run.ROOT), run.ROOT, workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"gtobench.drivers.{cell.config['driver']}").Driver(cell, 2**33 + 7, cuda_device)
    driver.window(1.0)
    driver.release()
    program = dict(driver.check())
    control = dict(driver.control())
    assert all(program[k] <= cell.limits[k] for k in program), program
    assert any(control[k] > cell.limits[k] for k in control), control

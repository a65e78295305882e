"""The port's profiling helpers (`grasptrajopt_tpu_torch.utils.profiling`)
on the CPU: PhaseTimer accumulates with and without sync and keeps the
JAX package's keys and dump format; debug_guard raises FloatingPointError
on an operation that makes a NaN and restores the previous state; trace
writes a trace file; device_memory_stats is None without a card."""

import json
import os
import time

import pytest
import torch

from grasptrajopt_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from grasptrajopt_tpu_torch.utils.profiling import PhaseTimer, debug_guard, device_memory_stats, trace


@pytest.mark.parametrize("sync", [True, False])
def test_phase_timer_accumulates(sync):
    timer = PhaseTimer(sync=sync, device="cpu")
    for _ in range(3):
        with timer.phase("ik"):
            time.sleep(0.01)
    with timer.phase("planning"):
        torch.ones(4).sum()
    assert dict(timer.counts) == {"ik": 3, "planning": 1}
    assert timer.totals["ik"] >= 0.03
    means = timer.means()
    assert set(means) == {"ik_time", "planning_time"}
    assert means["ik_time"] == pytest.approx(timer.totals["ik"] / 3)
    assert timer.report().splitlines()[0].startswith("ik: total ")


def test_phase_timer_keeps_a_phase_that_raises():
    timer = PhaseTimer(device="cpu")
    with pytest.raises(RuntimeError):
        with timer.phase("ik"):
            raise RuntimeError("solver failed")
    assert timer.counts["ik"] == 1


def test_means_keys_and_dump_match_the_jax_timer(tmp_path):
    port, ref = PhaseTimer(device="cpu"), JaxPhaseTimer(sync=False)
    for timer in (port, ref):
        for name in ("checking", "ik", "planning", "ik"):
            with timer.phase(name):
                pass
    assert set(port.means()) == set(ref.means()) == {"checking_time", "ik_time", "planning_time"}
    assert dict(port.counts) == dict(ref.counts)
    path = tmp_path / "timer.json"
    port.dump(str(path))
    data = json.loads(path.read_text())
    assert data == {"totals": dict(port.totals), "counts": dict(port.counts)}
    ref.dump(str(tmp_path / "ref.json"))
    assert set(json.loads((tmp_path / "ref.json").read_text())) == set(data)


def test_debug_guard_raises_on_nan_and_restores():
    zero = torch.zeros(3)
    with debug_guard():
        torch.ones(3) / 2.0  # finite: no error
        with pytest.raises(FloatingPointError):
            zero / zero
        with pytest.raises(FloatingPointError):
            torch.log(-torch.ones(2, dtype=torch.float64))
        torch.ones(3) / zero  # inf is not a NaN (as jax_debug_nans)
        torch.arange(3) // 1  # integer outputs are not checked
    assert bool(torch.isnan(zero / zero).all())  # the state before the guard
    with debug_guard(nans=False, disable_jit=True):
        assert bool(torch.isnan(zero / zero).all())


def test_trace_writes_a_file(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert prof is not None
    with open(os.path.join(logdir, files[0])) as f:
        assert "aten::mm" in f.read()


def test_device_memory_stats_is_none_on_the_cpu():
    assert device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert device_memory_stats() is None

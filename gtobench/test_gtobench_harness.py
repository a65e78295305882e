"""CPU tests of the harness's arithmetic: the manifest found by name, the
whole-call rate and the stream's drain on a fake clock, the goal sets
drawn from the seed, the union of device intervals, K4's roofline bound
and its launch count, and the module-name check."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import numpy as np
import torch

from gtobench import generate, guard, layers, manifest, roofline, run
from gtobench.trace import TraceSummary, gaps, union_s
from gtobench.window import Call, Window, stream_window


# -- the manifest -----------------------------------------------------------------


def test_every_cell_finds_its_files_and_metrics():
    m = manifest.load(run.ROOT)
    for w in m["workloads"]:
        cell = manifest.cell(m, run.ROOT, w["name"])
        assert cell.config["driver"] == "goalset"
        assert cell.traffic["name"] == w["traffic"]
        names = manifest.names(cell.end_to_end)
        assert "setup_s" in names and len(names) == 2
        assert cell.per_layer, w["name"]
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(metric.name))


def test_per_layer_metrics_follow_their_cells():
    m = manifest.load(run.ROOT)
    goal = manifest.cell(m, run.ROOT, "goalset-b2048-stream")
    assert all(x.name.endswith(".goalset") for x in goal.per_layer)
    assert {x.moves for x in goal.per_layer} == {"plans_per_s"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        manifest.cell(manifest.load(run.ROOT), run.ROOT, "no-such-cell")


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    class Run:
        trace = None
        units = "plans"
        layer = {}
        window = Window(0.0, 1.0, [])

    cell = manifest.cell(manifest.load(run.ROOT), run.ROOT, "goalset-b2048-stream")
    assert manifest.read_metrics(cell.per_layer, Run()) == {}


# -- the window -------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_stream_window_counts_every_issued_call_and_drains():
    clock = FakeClock()
    done_at = {}

    def step():
        clock.t += 1.0  # each enqueue takes 1 s of host time
        done_at[len(done_at)] = clock.t + 2.5  # and its work ends 2.5 s later
        return len(done_at) - 1

    def fake_stream(fn, inputs, inflight):
        pending = []
        for _ in inputs:
            if len(pending) >= inflight:
                i = pending.pop(0)
                clock.t = max(clock.t, done_at[i])
                yield i
            pending.append(fn())
        for i in pending:
            clock.t = max(clock.t, done_at[i])
            yield i

    w = stream_window(step, 32, 5.0, 2, fake_stream, clock=clock)
    # enqueues at 100 and 101; the third waits for the first to retire
    # (103.5), the fourth for the second (104.5); at 105.5 the deadline has
    # passed, and the two outstanding calls are drained to their ends
    assert [c.issued for c in w.calls] == [100.0, 101.0, 103.5, 104.5]
    assert w.units == 128
    assert w.end == done_at[3] == 108.0
    assert w.rate == pytest.approx(128 / 8.0)
    assert all(c.done >= c.enqueued >= c.issued for c in w.calls)


# -- the inputs -------------------------------------------------------------------


def test_goal_sets_follow_the_seed_and_each_solve_gets_fresh_jitter():
    traffic = json.loads((run.ROOT / "gtobench" / "traffic" / "goalset-b2048-stream.json").read_text())
    traffic["batch"] = 5
    seed = 2**33 + 5
    first = generate.goal_sets(traffic, 3, seed)
    assert first.shape == (5, 3, 4, 4) and first.dtype == np.float32
    np.testing.assert_array_equal(first, generate.goal_sets(traffic, 3, seed))
    assert not np.array_equal(first, generate.goal_sets(traffic, 3, seed + 1))
    stream = generate.GoalStream(traffic, 3, seed, torch.device("cpu"))
    g0, g1 = stream.goals(0), stream.goals(1)
    torch.testing.assert_close(g0, stream.goals(0), rtol=0, atol=0)
    # the same anchors (rotations) under a fresh jitter of the positions
    torch.testing.assert_close(g0[..., :3, :3], g1[..., :3, :3], rtol=0, atol=0)
    torch.testing.assert_close(g0[..., :3, :3], torch.as_tensor(first[..., :3, :3]), rtol=0, atol=1e-6)
    jump = (g0[..., :3, 3] - g1[..., :3, 3]).abs()
    assert 0 < float(jump.max()) < 0.2


# -- the trace --------------------------------------------------------------------


def test_union_and_gaps_of_device_intervals():
    iv = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0), (9.0, 12.0)]
    assert union_s(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 9.0)]
    assert union_s([], 0.0, 1.0) == 0.0


def test_breakdown_names_idle_gaps_by_host_span():
    s = TraceSummary(
        (0.0, 10.0),
        [("k_a", 1.0, 2.0), ("k_b", 2.0, 2.5), ("k_a", 6.0, 7.0)],
        [("enqueue", 2.0, 6.0), ("retire", 7.0, 10.0)],
    )
    assert s.busy_s == pytest.approx(2.5) and s.ops == 3
    assert s.seconds_of(lambda n: n == "k_a") == (2, pytest.approx(2.0))
    b = s.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(2.0)]
    assert b["idle_gaps"][0] == ["enqueue", pytest.approx(3.5)]
    assert ["retire", pytest.approx(3.0)] in b["idle_gaps"]
    assert ["harness", pytest.approx(1.0)] in b["idle_gaps"]


# -- the rooflines ----------------------------------------------------------------


def test_k4_bound_counts_each_byte_once():
    # a fine pass of the b2048 cell: 2048 x 50 x 1000 points on the shared
    # table of 2 x 95760 rows, one row base
    n = 2048 * 50 * 1000
    assert roofline.k4_bytes(n, 2 * 95760, 1) == 4 * (7 * n + 1 + 8 * 2 * 95760)
    assert roofline.k4_bound_s([(n, 191520, 1), (n, 191520, 1)]) == pytest.approx(
        2 * roofline.k4_bytes(n, 191520, 1) / 3.35e12)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_a_roofline_is_left_out_when_the_launches_differ_from_its_count():
    class Run:
        window = Window(0.0, 1.0, [Call(0.0, 8, done=1.0), Call(0.5, 8, done=2.0)])
        trace = TraceSummary((0.0, 2.0), [("field_lookup_kernel", 0.1 * i, 0.1 * i + 0.01) for i in range(6)])

    # 3 launches a call, 2 calls: the trace's 6 launches of 10 ms, against a bound of 1 ms a call
    assert layers.roofline_pct(Run(), "field_lookup_kernel", 3, 1e-3) == pytest.approx(100 * 2e-3 / 0.06)
    assert layers.roofline_pct(Run(), "field_lookup_kernel", 3, 1e-3, counted=6) == pytest.approx(100 * 2e-3 / 0.06)
    assert layers.roofline_pct(Run(), "field_lookup_kernel", 2, 1e-3) is None
    assert layers.roofline_pct(Run(), "field_lookup_kernel", 3, 1e-3, counted=9) is None
    assert layers.roofline_pct(Run(), "other_kernel", 3, 1e-3) is None


# -- the module check -------------------------------------------------------------


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["grasptrajopt_tpu_torch", "grasptrajopt_tpu_torch.bench", "jaxtyping", "torch"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["jax.numpy", "grasptrajopt_tpu.ops"]) == [
        "grasptrajopt_tpu.ops", "jax.numpy"]


def _loaded_after(imports: str) -> dict:
    code = (f"import sys, json; {imports}; "
            "from gtobench import guard; "
            "print(json.dumps({'bad': guard.forbidden_modules(), "
            "'port': sorted(m for m in sys.modules if m.split('.')[0] == 'grasptrajopt_tpu_torch')}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=run.ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_drivers_load_no_jax():
    loaded = _loaded_after("import gtobench.run, gtobench.drivers.goalset, grasptrajopt_tpu_torch.bench")
    assert loaded["bad"] == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import gtobench.reference.goalset, gtobench.reference.ik, gtobench.reference.slab")
    assert loaded == {"bad": [], "port": []}

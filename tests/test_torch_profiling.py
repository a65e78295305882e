"""The port's profiling helpers (`grasptrajopt_tpu_torch.utils.profiling`)
on the CPU: PhaseTimer accumulates with and without sync and keeps the
JAX package's keys and dump format; debug_guard raises FloatingPointError
on an operation that makes a NaN and restores the previous state; trace
writes a trace file; device_memory_stats is None without a card. The span
recorder records only under torch.profiler, keeps parents, solve ids and
host order in a bounded ring, and covers the trajectory solve and the
stream's retire without changing a solve's result; off the card it keeps
no stream interval and counts no sync."""

import json
import os
import time
import warnings
from collections import deque

import pytest
import torch

from grasptrajopt_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from torch.profiler import ProfilerActivity, profile

from grasptrajopt_tpu_torch.opt.trajectory import TrajectoryConfig, make_trajectory_solver
from grasptrajopt_tpu_torch.parallel import stream_map
from grasptrajopt_tpu_torch.utils import profiling
from grasptrajopt_tpu_torch.utils.profiling import PhaseTimer, debug_guard, device_memory_stats, span, trace


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


# -- spans -----------------------------------------------------------------------


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the module's place."""
    rec = profiling.SpanRecorder()
    monkeypatch.setattr(profiling, "recorder", rec)
    return rec


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_outside_a_profiler_records_nothing(recorder):
    with span("solve", device="cpu"):
        with span("lm.kkt"):
            torch.ones(3).sum()
    assert len(recorder.ring) == 0 and recorder.anchors == {} and profiling.resolved_spans() == []


def test_nested_spans_keep_parent_solve_and_host_order(recorder):
    with profiled():
        with span("solve", device="cpu"):
            with span("lm.iteration", index=0, coarse=True):
                with span("lm.kkt"):
                    torch.ones(3).sum()
        with span("solve", device="cpu"):
            pass
        with span("stream.retire"):
            pass
    spans = profiling.resolved_spans()
    assert [s.name for s in spans] == ["solve", "lm.iteration", "lm.kkt", "solve", "stream.retire"]
    solve, it, kkt, solve2, retire = spans
    assert (solve.parent, it.parent, kkt.parent) == (None, solve.id, it.id)
    assert solve.solve == it.solve == kkt.solve != solve2.solve
    assert retire.solve is None and retire.parent is None
    assert it.meta == {"index": 0, "coarse": True}
    assert solve.host[0] <= it.host[0] <= kkt.host[0] <= kkt.host[1] <= it.host[1] <= solve.host[1]
    assert solve.host[1] <= solve2.host[0] <= solve2.host[1] <= retire.host[0]
    # off the card: no stream interval, no sync counted
    assert all(s.stream is None and s.syncs is None for s in spans)


def test_a_span_that_raises_is_closed():
    rec = profiling.SpanRecorder()
    with profiled():
        with pytest.raises(RuntimeError):
            with rec.record("solve", "cpu", {}):
                raise RuntimeError("diverged")
        with rec.record("solve", "cpu", {}):
            pass
    first, second = rec.resolved()
    assert first.parent is None and second.parent is None and first.host[1] <= second.host[0]


def test_the_ring_drops_the_oldest_spans(recorder):
    recorder.ring = deque(maxlen=3)
    with profiled():
        for i in range(5):
            with span("lm.iteration", index=i):
                pass
    assert [s.meta["index"] for s in profiling.resolved_spans()] == [2, 3, 4]


def test_count_syncs_is_a_no_op_on_the_cpu():
    filters = list(warnings.filters)
    with profiling.count_syncs("cpu") as sites:
        assert warnings.filters == filters
        torch.ones(2).sum().item()
    assert sites == {}
    if not torch.cuda.is_available():
        with profiling.count_syncs() as sites:
            assert warnings.filters == filters
            torch.ones(2).sum().item()
        assert sites == {}


T, N, B = 8, 3, 4


def toy_solver(single_pass: bool, iterations: int, coarse: int):
    """A goal at the last step, smoothness, and a whole-trajectory term
    with its Jacobian (a coarse one of another weight), float64."""

    def res(q, t, aux, p):
        return (t == T - 1).to(q.dtype) * (q - p["target"])

    def term(weight):
        def value(Q, aux, params, shared):
            return weight * torch.sin(Q)

        def value_jac(Q, aux, params, shared):
            return weight * torch.sin(Q), torch.diag_embed(weight * torch.cos(Q))

        return value, value_jac

    cfg = TrajectoryConfig(T=T, smooth_weight=0.5, iterations=iterations, single_pass=single_pass,
                           alphas=(1.0, 0.5))
    return make_trajectory_solver(res, cfg, traj_term=term(0.1),
                                  coarse=(coarse, term(0.2)) if coarse else None)


def toy_problem():
    g = torch.Generator().manual_seed(0)
    qc = 0.3 * torch.randn(B, N, generator=g, dtype=torch.float64)
    X0 = qc[:, None].expand(B, T - 2, N).clone()
    params = {"target": torch.randn(B, N, generator=g, dtype=torch.float64)}
    lim = 3.0 * torch.ones(N, dtype=torch.float64)
    return qc, X0, -lim, lim, params


@pytest.mark.parametrize("single_pass,iterations,coarse", [(True, 4, 2), (False, 3, 0)])
def test_a_solve_records_its_spans_and_its_result_is_unchanged(recorder, single_pass, iterations, coarse):
    solve = toy_solver(single_pass, iterations, coarse)
    Q_off, c_off, _ = solve(*toy_problem())
    assert len(recorder.ring) == 0
    with profiled():
        Q_on, c_on, _ = solve(*toy_problem())
    assert torch.equal(Q_on, Q_off) and torch.equal(c_on, c_off)
    spans = profiling.resolved_spans()
    by = lambda name: [s for s in spans if s.name == name]  # noqa: E731
    (solve_span,) = by("solve")
    its = by("lm.iteration")
    assert [s.meta for s in its] == [{"index": i, "coarse": i < coarse} for i in range(iterations)]
    assert all(s.parent == solve_span.id and s.solve == solve_span.solve for s in its)
    for name in ("lm.residuals", "lm.field_term", "lm.kkt"):
        leaves = by(name)
        assert sorted(s.parent for s in leaves) == [s.id for s in its], name
        assert all(s.solve == solve_span.solve for s in leaves)
    assert len(spans) == 1 + 4 * iterations


def test_stream_map_records_one_retire_per_result(recorder):
    with profiled():
        out = list(stream_map(lambda x: x * 2.0, [torch.ones(2) * i for i in range(5)], inflight=2))
    assert [float(o[0]) for o in out] == [0.0, 2.0, 4.0, 6.0, 8.0]
    retires = [s for s in profiling.resolved_spans() if s.name == "stream.retire"]
    assert len(retires) == 5 and all(s.stream is None and s.parent is None for s in retires)

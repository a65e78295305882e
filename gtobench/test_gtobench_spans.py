"""CPU tests of the arithmetic over the program's spans (`gtobench.spans`)
on synthetic intervals: an operation goes to the innermost span whose
stream interval holds its midpoint, and to none outside every span; each
reader finds nothing without a trace or without spans; a per-solve figure
divides by the window's calls."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from gtobench import manifest, spans
from gtobench.trace import TraceSummary
from gtobench.window import Call, Window
from grasptrajopt_tpu_torch.utils import profiling
from grasptrajopt_tpu_torch.utils.profiling import ResolvedSpan

NEW_METRICS = (
    "residuals_host_ms_per_solve.goalset", "residuals_device_ms_per_solve.goalset",
    "field_term_host_ms_per_solve.goalset", "field_term_device_ms_per_solve.goalset",
    "kkt_host_ms_per_solve.goalset", "kkt_device_ms_per_solve.goalset", "kkt_launches_per_solve.goalset",
    "stream_wait_ms_per_solve.goalset", "host_syncs_per_solve.goalset",
)


def S(name, i, parent, host, stream, syncs=None):
    return ResolvedSpan(name, i, parent, 0, {}, host, stream, syncs)


# two solves over the window [10, 20]: host and stream intervals apart, as on
# a stream whose work runs behind its enqueue
SPANS = [
    S("solve", 0, None, (10.0, 12.0), (10.5, 13.5), syncs=0),
    S("lm.iteration", 1, 0, (10.1, 11.9), (10.6, 13.4)),
    S("lm.residuals", 2, 1, (10.2, 10.8), (10.7, 11.5)),
    S("lm.field_term", 3, 1, (10.8, 11.2), (11.5, 12.0)),
    S("lm.kkt", 4, 1, (11.2, 11.8), (12.0, 13.0)),
    S("stream.retire", 5, None, (12.0, 13.6), (13.6, 13.6)),
    S("solve", 6, None, (14.0, 15.0), (14.0, 16.0), syncs=2),
    S("lm.kkt", 7, 6, (14.2, 14.4), (14.5, 15.0)),
    S("solve", 8, None, (25.0, 26.0), (25.0, 26.0), syncs=5),  # after the window
]
OPS = [
    ("a", 10.55, 10.59),  # in solve 0, before its iteration
    ("b", 10.65, 10.68),  # in the iteration, before its residuals
    ("c", 10.8, 11.0),  # residuals
    ("d", 11.4, 11.6),  # midpoint 11.5: the field term starts there (a boundary goes to the later span)
    ("field_lookup_kernel", 11.7, 11.8),  # field term
    ("e", 12.2, 12.4),  # kkt
    ("f", 12.9, 13.3),  # midpoint 13.1 past the kkt: the iteration
    ("g", 13.8, 13.9),  # between the solves: no span
    ("h", 14.6, 14.8),  # solve 6's kkt
    ("i", 15.5, 15.7),  # solve 6
]


def run_of(events=OPS, calls=2, trace=True):
    window = Window(10.0, 5.0, [Call(issued=10.0 + i, units=8, done=20.0 if i == 0 else 19.0)
                                for i in range(calls)])
    summary = TraceSummary((10.0, 20.0), list(events)) if trace else None
    return SimpleNamespace(trace=summary, window=window, units="plans", layer={})


@pytest.fixture
def program(monkeypatch):
    """The program's recorder replaced by a fixed list of spans."""
    held = []
    monkeypatch.setattr(profiling, "resolved_spans", lambda: list(held))
    spans._memo[:] = [None, None, None]
    return held


def test_an_op_goes_to_the_innermost_span_holding_its_midpoint():
    split = spans.attribute(OPS, [(s.name, *s.stream) for s in SPANS[:8]])
    assert split["lm.residuals"] == (1, pytest.approx(0.2))
    assert split["lm.field_term"] == (2, pytest.approx(0.3))
    assert split["lm.kkt"] == (2, pytest.approx(0.4))
    assert split["lm.iteration"] == (2, pytest.approx(0.43))
    assert split["solve"] == (2, pytest.approx(0.24))
    assert split[None] == (1, pytest.approx(0.1))
    assert sum(n for n, _ in split.values()) == len(OPS)


def test_ops_outside_every_span_go_to_none():
    assert spans.attribute(OPS, []) == {None: (len(OPS), pytest.approx(sum(b - a for _, a, b in OPS)))}
    assert spans.attribute([("x", 0.0, 1.0)], [("lm.kkt", 2.0, 3.0)]) == {None: (1, 1.0)}


def test_innermost_walks_out_of_earlier_siblings():
    at = spans.innermost([("solve", 0.0, 10.0), ("lm.kkt", 1.0, 2.0), ("lm.kkt", 3.0, 4.0), ("x", 11.0, 12.0)])
    assert [at(t) for t in (0.5, 1.5, 2.5, 3.5, 4.5, 10.5, 11.5, 12.5, -1.0)] == [
        "solve", "lm.kkt", "solve", "lm.kkt", "solve", None, "x", None, None]


@pytest.mark.parametrize("name", NEW_METRICS)
def test_each_reader_finds_nothing_without_a_trace_or_spans(program, name):
    read = manifest.reader(name)
    assert read(run_of(trace=False)) is None  # spans but no trace
    assert read(run_of()) is None  # a trace but no span
    program.extend(SPANS)
    spans._memo[:] = [None, None, None]
    assert read(run_of(trace=False)) is None
    assert read(run_of(calls=0)) is None
    assert read(run_of()) is not None


def test_a_program_without_a_recorder_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "resolved_spans")
    spans._memo[:] = [None, None, None]
    assert all(manifest.reader(name)(run_of()) is None for name in NEW_METRICS)


def test_per_solve_figures_divide_by_the_window_calls(program):
    program.extend(SPANS)
    for calls in (1, 2, 4):
        run = run_of(calls=calls)
        got = {name: manifest.reader(name)(run) for name in NEW_METRICS}
        assert got == pytest.approx({
            "residuals_host_ms_per_solve.goalset": 600.0 / calls,
            "residuals_device_ms_per_solve.goalset": 200.0 / calls,
            "field_term_host_ms_per_solve.goalset": 400.0 / calls,
            "field_term_device_ms_per_solve.goalset": 300.0 / calls,
            "kkt_host_ms_per_solve.goalset": 800.0 / calls,
            "kkt_device_ms_per_solve.goalset": 400.0 / calls,
            "kkt_launches_per_solve.goalset": 2.0 / calls,
            "stream_wait_ms_per_solve.goalset": 1600.0 / calls,
            "host_syncs_per_solve.goalset": 2.0 / calls,  # the solve after the window is left out
        })


def test_spans_on_the_host_alone_give_host_figures_only(program):
    program.extend(s._replace(stream=None, syncs=None) for s in SPANS)
    run = run_of()
    assert manifest.reader("kkt_host_ms_per_solve.goalset")(run) == pytest.approx(400.0)
    for name in ("kkt_device_ms_per_solve.goalset", "kkt_launches_per_solve.goalset",
                 "host_syncs_per_solve.goalset"):
        assert manifest.reader(name)(run) is None

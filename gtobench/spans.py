"""The program's own spans over a traced window, reduced to what the
per-layer metrics read.

The port records spans inside its solve while `torch.profiler` runs
(`grasptrajopt_tpu_torch.utils.profiling.span`). Each carries its host
interval and its stream interval, the stretch of the stream's order its
work fills, both on the host clock that `trace.Tracer` maps the device
events onto. A span's host time is the sum of its host intervals; its
device operations are those whose midpoint falls in its stream intervals
and in no span nested inside them.

The arithmetic (`innermost`, `attribute`, `host_s`) is plain Python over
(start, end) pairs in seconds, so the tests drive it with synthetic
intervals. `program_spans` reads the program's recorder and keeps the
spans inside the run's window; it returns None where the run has no trace
and where the program records no span (a checkout whose program has no
recorder).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

_memo: list = [None, None, None]  # [run, its spans in the window, its attribution]


def innermost(intervals: Sequence[Tuple[str, float, float]]):
    """A lookup t -> the label of the innermost interval (label, start,
    end) holding t, or None; the intervals nest or are disjoint, as the
    spans of one stream do."""
    order = sorted(intervals, key=lambda x: (x[1], -x[2]))
    starts = [a for _, a, _ in order]
    ends = [b for _, _, b in order]
    parent: List[int] = []
    stack: List[int] = []
    for i, (_, a, b) in enumerate(order):
        while stack and ends[stack[-1]] <= a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def at(t: float) -> Optional[str]:
        j = bisect_right(starts, t) - 1
        while j >= 0 and ends[j] < t:
            j = parent[j]  # an earlier sibling ends before j starts: only an enclosing span can hold t
        return order[j][0] if j >= 0 else None

    return at


def attribute(events: Sequence[Tuple[str, float, float]],
              intervals: Sequence[Tuple[str, float, float]]) -> Dict[Optional[str], Tuple[int, float]]:
    """{label: (count, summed seconds)} of the device operations (name,
    start, end), each given to the innermost interval holding its
    midpoint; those outside every interval under None."""
    at = innermost(intervals)
    out: Dict[Optional[str], Tuple[int, float]] = {}
    for _, a, b in events:
        label = at((a + b) / 2)
        n, s = out.get(label, (0, 0.0))
        out[label] = (n + 1, s + (b - a))
    return out


def host_s(spans, name: str) -> float:
    """Summed host intervals of the spans named `name`."""
    return sum(s.host[1] - s.host[0] for s in spans if s.name == name)


def program_spans(run):
    """The program's recorded spans whose host interval lies inside the
    run's window, or None where the run has no trace or no call, or the
    program recorded none there."""
    if run.trace is None or not run.window.calls:
        return None
    if _memo[0] is run:
        return _memo[1]
    try:
        from grasptrajopt_tpu_torch.utils import profiling
    except ImportError:
        return None
    resolved = getattr(profiling, "resolved_spans", None)
    if resolved is None:
        return None
    lo, hi = run.window.start, run.window.end
    spans = [s for s in resolved() if lo <= s.host[0] and s.host[1] <= hi] or None
    _memo[:] = [run, spans, None]
    return spans


def _attribution(run, spans):
    if _memo[0] is run and _memo[2] is not None:
        return _memo[2]
    split = attribute(run.trace.events, [(s.name, *s.stream) for s in spans if s.stream is not None])
    if _memo[0] is run:
        _memo[2] = split
    return split


def host_ms_per_call(run, name: str):
    """Host time inside the spans named `name` over the window's calls (ms)."""
    spans = program_spans(run)
    if spans is None or not any(s.name == name for s in spans):
        return None
    return 1e3 * host_s(spans, name) / len(run.window.calls)


def device_per_call(run, name: str):
    """(operations, device ms) of the traced window given to the spans
    named `name`, over the window's calls; None where no such span has a
    stream interval."""
    spans = program_spans(run)
    if spans is None or not any(s.name == name and s.stream is not None for s in spans):
        return None
    n, seconds = _attribution(run, spans).get(name, (0, 0.0))
    calls = len(run.window.calls)
    return n / calls, 1e3 * seconds / calls


def syncs_per_call(run):
    """Synchronizing calls the program counted inside its solves over the
    window's calls; None where no solve counted."""
    spans = program_spans(run)
    counts = [s.syncs for s in spans or () if s.name == "solve" and s.syncs is not None]
    return sum(counts) / len(run.window.calls) if counts else None

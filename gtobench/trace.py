"""The device trace of a window, reduced to what the per-layer metrics read.

`Tracer` wraps the measured window in `torch.profiler` with device
activity only and reads the raw device events (kernels, copies, fills)
without building the profiler's event tree, which costs far more than the
window for the hundreds of thousands of launches a window holds. The host
and device clocks are tied by a marker fill enqueued on an idle card at the
window's start: its device start is taken as the host time it was enqueued.

The arithmetic (`union_s`, `gaps`, `summarize`) is plain Python over
(start, end) pairs in seconds, so the tests drive it with synthetic
intervals.
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def union_s(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers, in order."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def label_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost host span (label, start, end) holding time t, or
    "harness" where none does (the harness's own loop)."""
    best = None
    for label, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (label, a, b)
    return best[0] if best else "harness"


@dataclass
class TraceSummary:
    """The device events of one traced window, in host seconds."""

    window: Tuple[float, float]  # (start, end) of the traced window
    events: List[Tuple[str, float, float]]  # (name, start, end), device ops in the window
    host_spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.events], *self.window)

    @property
    def device_s(self) -> float:
        """Summed duration of the device operations (one stream: equal to
        the busy time up to the clipping at the window's ends)."""
        return sum(b - a for _, a, b in self.events)

    @property
    def ops(self) -> int:
        return len(self.events)

    def seconds_of(self, predicate) -> Tuple[int, float]:
        """(count, summed seconds) of the operations whose name satisfies
        `predicate`."""
        n, s = 0, 0.0
        for name, a, b in self.events:
            if predicate(name):
                n += 1
                s += b - a
        return n, s

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations of most time, summed by name, and the
        longest idle gaps named by what the host was doing."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.events:
            by_name[name[:64]] += b - a
        ops = Counter(by_name).most_common(top)
        idle = sorted(gaps([(a, b) for _, a, b in self.events], *self.window), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label_at(self.host_spans, (a + b) / 2), b - a] for a, b in idle],
        }


class Tracer:
    """`with Tracer(device) as tr: ...window...` then `tr.summary(spans,
    end)`. The card must be idle when the block starts."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_marker = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        marker = torch.empty(1, device=self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_marker = time.perf_counter()
        marker.fill_(0.0)  # the first device event of the trace
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        return False

    def summary(self, host_spans, window_end: float, window_start: Optional[float] = None) -> TraceSummary:
        """The device events, moved onto the host clock by the marker;
        `window_start` defaults to the marker's time."""
        from torch.autograd import DeviceType

        raw = [
            (e.name(), e.start_ns(), e.duration_ns())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
        ]
        if not raw:
            raise RuntimeError("the profiler recorded no device operation in the traced window")
        raw.sort(key=lambda r: r[1])
        offset = self.t_marker - raw[0][1] * 1e-9  # the marker fill is the first event
        lo = self.t_marker if window_start is None else window_start
        events = [(n, s * 1e-9 + offset, (s + d) * 1e-9 + offset) for n, s, d in raw[1:]]
        events = [e for e in events if e[2] > lo and e[1] < window_end]
        return TraceSummary((lo, window_end), events, list(host_spans))

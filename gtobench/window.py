"""The measured window: whole calls back to back, and the rate over them.

A rate counts whole calls: every call issued before the window's time is
up is carried to its end, and the rate is the work of all those calls over
the time from the window's start to the last completion. A window that
counted only the calls finished inside it would gain or lose up to a whole
call at its end.

`stream_window` drives a call through a bounded in-flight stream (the
program's `stream_map`: results in submission order, each retired once the
device has finished its work) and drains it after the last issue. It
takes the clock as an argument so the tests can drive it with a fake one.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class Call:
    issued: float  # host clock when the call was issued
    units: int  # plans it returns
    cpu: float = math.nan  # the process's CPU seconds from the issue to the completion
    enqueued: Optional[float] = None  # host clock when the call returned to the host
    done: Optional[float] = None  # host clock when its result was complete


@dataclass
class Window:
    start: float
    seconds: float
    calls: List[Call]

    @property
    def end(self) -> float:
        """The last completion."""
        return max(c.done for c in self.calls)

    @property
    def units(self) -> int:
        return sum(c.units for c in self.calls)

    @property
    def rate(self) -> float:
        """Units of every call issued in the window over the time to the
        last completion."""
        return self.units / (self.end - self.start)

    def spans(self, label: str = "enqueue") -> list:
        """Host spans (label, start, end) of the calls' enqueue."""
        return [(label, c.issued, c.enqueued) for c in self.calls if c.enqueued is not None]


def stream_window(
    step: Callable, units: int, seconds: float, inflight: int, stream_map: Callable,
    keep: Optional[Callable] = None, clock: Callable = time.perf_counter,
) -> Window:
    """Issue `step()` through `stream_map(fn, inputs, inflight=...)` until
    `seconds` have passed since the start, then drain; `keep(i, result)`
    sees each result as it is retired."""
    calls: List[Call] = []
    start = clock()
    deadline = start + seconds

    def issue():
        while clock() < deadline:
            calls.append(Call(issued=math.nan, units=units))
            yield ()

    def timed():
        calls[-1].issued = clock()  # after any wait to retire an earlier call
        calls[-1].cpu = time.process_time()
        out = step()
        calls[-1].enqueued = clock()
        return out

    for i, result in enumerate(stream_map(timed, issue(), inflight=inflight)):
        calls[i].done = clock()
        calls[i].cpu = time.process_time() - calls[i].cpu
        if keep is not None:
            keep(i, result)
    if not calls:
        raise RuntimeError("the window issued no call")
    return Window(start, seconds, calls)

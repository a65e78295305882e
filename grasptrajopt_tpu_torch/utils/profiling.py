"""Tracing, profiling and debugging helpers.

Port of grasptrajopt_tpu/utils/profiling.py:

  - PhaseTimer: named wall-clock phases; with `sync=True` each phase
    starts and ends with `torch.cuda.synchronize()` on the timer's device,
    so a phase's time includes the device work it enqueued. (The JAX
    timer's `jax.effects_barrier()` waits for effects, not for dispatched
    computations, so its phases may end before the device does.) Exports
    the result schema's `<phase>_time` keys.
  - trace(): `torch.profiler` over the block (CPU activity, and CUDA
    activity where a device is present), written in TensorBoard's format
    by `tensorboard_trace_handler`.
  - debug_guard(): inside it, any operation whose floating-point output
    holds a NaN raises FloatingPointError (the JAX package's
    `jax_debug_nans`). For debugging only: it checks every operation's
    output on the host.
  - device_memory_stats(): `torch.cuda.memory_stats` on the card.

Beside them, what has no counterpart in the JAX package:

  - span(name): a named span of the program's work, recorded only while
    `torch.profiler` runs (`trace()` here, or a benchmark's traced
    window) and one flag check otherwise. A recorded span keeps its host
    interval (`time.perf_counter()`), its parent, the solve it belongs
    to and, for work on a card, two timing events on the current stream
    that mark where its work sits in the stream's order. `resolved_spans()`
    puts both intervals on the host clock once the card has drained,
    between an anchor taken at the first span recorded since the last
    reading and one taken then.
    Spans open no `record_function` or NVTX range: the profiler would
    list those as device events beside the kernels.
  - count_syncs(): counts the synchronizing CUDA calls of a block
    (`torch.cuda.set_sync_debug_mode("warn")`) by the line of this
    package that reached each; a recorded `solve` span runs under it and
    keeps the count.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
import traceback
import warnings
from collections import Counter, defaultdict, deque
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _cuda_or_none(device) -> Optional[torch.device]:
    """The CUDA device to synchronize or query: `device` if it is a CUDA
    device, the current one where `device` is None and a card is present,
    else None (the CPU: nothing to wait for)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class PhaseTimer:
    """Accumulates wall-clock time per named phase.

    with timer.phase("ik"): ...       # accumulates into 'ik'
    timer.means() -> {'ik_time': ...} # result-schema-compatible keys

    `device`: the CUDA device `sync=True` waits for (None: the current
    one where a card is present); on the CPU `sync` waits for nothing.
    """

    def __init__(self, sync: bool = True, device=None):
        self.sync = sync
        self._sync_device = _cuda_or_none(device) if sync else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _wait(self):
        if self._sync_device is not None:
            torch.cuda.synchronize(self._sync_device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._wait()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._wait()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def means(self) -> Dict[str, float]:
        return {
            f"{k}_time": self.totals[k] / self.counts[k] for k in self.totals
        }

    def report(self) -> str:
        lines = [
            f"{k}: total {self.totals[k]:.3f}s over {self.counts[k]} calls "
            f"(mean {self.totals[k]/self.counts[k]:.3f}s)"
            for k in sorted(self.totals)
        ]
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"totals": dict(self.totals), "counts": dict(self.counts)}, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profiler trace of the block (open with TensorBoard's profiler
    plugin, or chrome://tracing); yields the `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)


class _NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError on any operation whose floating-point
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_guard(nans: bool = True, disable_jit: bool = False):
    """NaN checking for debugging solver divergence. `disable_jit` is
    accepted for the JAX package's signature and has no effect: eager
    PyTorch compiles nothing. The previous state comes back on exit."""
    with _NaNCheck() if nans else contextlib.nullcontext():
        yield


def device_memory_stats(device=None) -> Optional[dict]:
    """`torch.cuda.memory_stats` of the card (`device`, or the current
    one); None on the CPU."""
    dev = _cuda_or_none(device)
    return None if dev is None else torch.cuda.memory_stats(dev)


# -- host syncs ------------------------------------------------------------------

_SYNC_WARNING = "synchroniz"  # in the text of sync debug mode's warning ("called a synchronizing CUDA operation")
_sync_sites: list = []  # the Counters of the open count_syncs blocks, outermost first
_sync_notice_seen = False
_PACKAGE_DIR = f"{os.sep}grasptrajopt_tpu_torch{os.sep}"


def _show_sync(show):
    """A `warnings.showwarning` that counts sync warnings, each at the
    innermost frame of this package on the stack (the line that reached
    the sync, also through torch's own Python), and passes other
    warnings to `show`."""

    def record(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        ours = [f for f in traceback.extract_stack()[:-1] if _PACKAGE_DIR in f.filename]
        where = (ours[-1].filename, ours[-1].lineno) if ours else (filename, lineno)
        site = f"{os.path.relpath(where[0])}:{where[1]}"
        for sites in _sync_sites:
            sites[site] += 1

    return record


@contextlib.contextmanager
def count_syncs(device=None):
    """Yields a Counter {file:line: count} of the synchronizing CUDA calls
    made inside the block (`torch.cuda.set_sync_debug_mode("warn")`);
    the previous mode and warning filters come back on exit. Blocks nest:
    an inner block's syncs count in the outer one's Counter too.
    `device`: as PhaseTimer's; on the CPU nothing is counted."""
    global _sync_notice_seen
    sites: Counter = Counter()
    if _cuda_or_none(device) is None:
        yield sites
        return
    outermost = not _sync_sites
    _sync_sites.append(sites)
    with contextlib.ExitStack() as stack:
        if outermost:
            if not _sync_notice_seen:
                # the first set_sync_debug_mode of a process gives a notice
                # once that names synchronizing operations: let it pass
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    torch.cuda.set_sync_debug_mode("warn")
                    torch.cuda.set_sync_debug_mode(0)
                _sync_notice_seen = True
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")  # other warnings keep their filters
            warnings.showwarning = _show_sync(warnings.showwarning)
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, previous)
        try:
            yield sites
        finally:
            _sync_sites.pop()


def _uncounted_sync(device):
    """`torch.cuda.synchronize(device)` that no open `count_syncs` block
    counts: the recorder's own waits, which run only while it records."""
    previous = torch.cuda.get_sync_debug_mode()
    if previous:
        torch.cuda.set_sync_debug_mode(0)
    try:
        torch.cuda.synchronize(device)
    finally:
        if previous:
            torch.cuda.set_sync_debug_mode(previous)


# -- spans -----------------------------------------------------------------------

RING = 50_000  # recorded spans kept, newest last (a traced window of the goal-set cell: ~25 solves of ~14)


class _Span:
    __slots__ = ("name", "id", "parent", "solve", "meta", "device", "stream", "anchor",
                 "host_start", "host_end", "events", "syncs")


class ResolvedSpan(NamedTuple):
    """A recorded span with both intervals on the host clock (seconds of
    `time.perf_counter()`). `id`, `parent`, `solve` and `meta` group an
    operator's trace by solve and LM iteration; the benchmark's readers
    take the name and the intervals."""

    name: str
    id: int
    parent: Optional[int]  # the id of the enclosing span, None at the top
    solve: Optional[int]  # the id of the solve it belongs to, None outside every solve
    meta: dict  # the keywords `span` was given
    host: Tuple[float, float]  # while the host was inside the span
    stream: Optional[Tuple[float, float]]  # where its work sits in its stream; None off the card
    syncs: Optional[int]  # synchronizing calls inside a solve on the card; None elsewhere


class SpanRecorder:
    """Recorded spans in a ring of `RING`, oldest dropped first. One
    anchor a device ties its timing events to the host clock: taken at
    the first span recorded since the last `resolved()`, with the card
    synchronized, as the host time at which an event was recorded on the
    idle card."""

    def __init__(self):
        self.ring: deque = deque(maxlen=RING)
        self.anchors: dict = {}  # {device: (host time, event)} of the spans recorded since the last reading
        self._ids = itertools.count()
        self._solves = itertools.count()
        self._open: list = []  # the open spans, innermost last (the port's solves run on one thread)

    def _anchor(self, device):
        if device not in self.anchors:
            _uncounted_sync(device)
            event = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            event.record(torch.cuda.current_stream(device))
            self.anchors[device] = (t, event)
        return self.anchors[device]

    @contextlib.contextmanager
    def record(self, name: str, device, meta: dict):
        stack = self._open
        parent = stack[-1] if stack else None
        s = _Span()
        s.name, s.id, s.meta = name, next(self._ids), meta
        s.parent = None if parent is None else parent.id
        s.device = torch.device(device) if device is not None else (None if parent is None else parent.device)
        opens_solve = name == "solve" and (parent is None or parent.solve is None)
        s.solve = next(self._solves) if opens_solve else (None if parent is None else parent.solve)
        on_card = s.device is not None and s.device.type == "cuda"
        s.anchor = self._anchor(s.device) if on_card else None
        s.stream = torch.cuda.current_stream(s.device) if on_card else None
        s.events, s.syncs, s.host_end = None, None, None
        s.host_start = time.perf_counter()
        if on_card:
            s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            s.events[0].record(s.stream)
        self.ring.append(s)
        stack.append(s)
        try:
            if opens_solve and on_card:
                with count_syncs(s.device) as sites:
                    yield
                s.syncs = sum(sites.values())
            else:
                yield
        finally:
            stack.pop()
            if on_card:
                s.events[1].record(s.stream)
            s.host_end = time.perf_counter()

    def resolved(self) -> list:
        """ResolvedSpan of every closed span in the ring, oldest first.
        Call once the card has run the spans' work: each anchor is read
        against a closing event recorded now on the idle card, so a stream
        interval follows the host clock's rate as well as its origin (the
        card's event clock drifts from it by some ppm, a fraction of a
        millisecond over a minute). The spans recorded after it take new
        anchors."""
        closing, scales, out = {}, {}, []
        for s in list(self.ring):
            if s.host_end is None:
                continue
            stream = None
            if s.events is not None:
                t, anchor = s.anchor
                if id(anchor) not in scales:
                    if s.device not in closing:
                        _uncounted_sync(s.device)
                        close = torch.cuda.Event(enable_timing=True)
                        closing[s.device] = (time.perf_counter(), close)
                        close.record(torch.cuda.current_stream(s.device))
                        _uncounted_sync(s.device)
                    t_close, close = closing[s.device]
                    card_s = 1e-3 * anchor.elapsed_time(close)
                    scales[id(anchor)] = (t_close - t) / card_s if card_s > 0 else 1.0
                k = 1e-3 * scales[id(anchor)]
                stream = (t + k * anchor.elapsed_time(s.events[0]), t + k * anchor.elapsed_time(s.events[1]))
            out.append(ResolvedSpan(s.name, s.id, s.parent, s.solve, s.meta, (s.host_start, s.host_end),
                                    stream, s.syncs))
        self.anchors = {}
        return out


recorder = SpanRecorder()
_OFF = contextlib.nullcontext()


def span(name: str, device=None, **meta):
    """`with span("lm.kkt"): ...`: records the block into `recorder` while
    `torch.profiler` runs; otherwise one check. `device`: where the
    block's work runs (None: the enclosing span's). A `solve` span outside
    every solve opens a new solve id and, on the card, runs under
    `count_syncs` and keeps its count of synchronizing calls."""
    if torch.autograd._profiler_enabled():
        return recorder.record(name, device, meta)
    return _OFF


def resolved_spans() -> list:
    """`recorder.resolved()`: the recorded spans on the host clock."""
    return recorder.resolved()

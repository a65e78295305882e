"""Arithmetic that several metric readers share: each reader in
`metrics/` is one line over these, so that a quantity split by cell group
(`.goalset`) is worked out the same way in each group."""

from __future__ import annotations

from statistics import mean

from gtobench import roofline


def idle_pct(run):
    """100 minus the device's busy share of the traced window: busy is the
    union of the device operations' intervals."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def device_ms_per_unit(run, per: str):
    """Summed device time of the traced window over its calls (per
    "call") or over the units of work (per "unit")."""
    if run.trace is None or not run.trace.ops:
        return None
    n = len(run.window.calls) if per == "call" else run.window.units
    return 1e3 * run.trace.device_s / n


def ops_per_unit(run, per: str):
    """Device operations of the traced window over its calls or units."""
    if run.trace is None or not run.trace.ops:
        return None
    n = len(run.window.calls) if per == "call" else run.window.units
    return run.trace.ops / n


def host_ms_per_call(run):
    """Mean host time from a call's issue to its return (the enqueue of a
    streamed call)."""
    spans = [c.enqueued - c.issued for c in run.window.calls if c.enqueued is not None]
    return 1e3 * mean(spans) if spans else None


def roofline_pct(run, kernel: str, launches_per_call: int, bound_per_call_s: float, counted=None):
    """100 x the summed bound of the window's calls over the summed time of
    the kernel's launches (operations whose name holds `kernel`) in the
    trace. None where the trace holds no such launch, and where the
    launches in the trace, or those the program's own counter saw
    (`counted`, where it keeps one), are not `launches_per_call` a call:
    the launches the bound was worked out for are then not those that ran."""
    if run.trace is None:
        return None
    n, seconds = run.trace.seconds_of(lambda name: kernel in name)
    expected = launches_per_call * len(run.window.calls)
    if n == 0 or n != expected or (counted is not None and counted != expected):
        return None
    return roofline.share_pct(bound_per_call_s * len(run.window.calls), seconds)

"""Host time inside a solve's `step()`, its enqueue (benchmark span, ms)."""

from gtobench.layers import host_ms_per_call


def read(run):
    return host_ms_per_call(run)

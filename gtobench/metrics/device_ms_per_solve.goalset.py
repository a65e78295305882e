"""Device time of the traced window's solves over their count (ms)."""

from gtobench.layers import device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, "call")

"""Device operations of the traced window over its solves."""

from gtobench.layers import ops_per_unit


def read(run):
    return ops_per_unit(run, "call")

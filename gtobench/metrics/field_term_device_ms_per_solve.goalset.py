"""Device time of the operations in the program's `lm.field_term` spans (the
surface points' FK Jacobians, K4, the field einsum and its GN blocks) over
the traced window's solves (ms)."""

from gtobench.spans import device_per_call


def read(run):
    split = device_per_call(run, "lm.field_term")
    return None if split is None else split[1]

"""Device time of the operations in the program's `lm.kkt` spans (the damped
blocks and the block-tridiagonal solve) over the traced window's solves
(ms)."""

from gtobench.spans import device_per_call


def read(run):
    split = device_per_call(run, "lm.kkt")
    return None if split is None else split[1]

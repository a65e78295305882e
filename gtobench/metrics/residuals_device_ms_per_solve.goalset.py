"""Device time of the operations in the program's `lm.residuals` spans (the
per-step residual Jacobians, their GN blocks and gradient) over the traced
window's solves (ms)."""

from gtobench.spans import device_per_call


def read(run):
    split = device_per_call(run, "lm.residuals")
    return None if split is None else split[1]

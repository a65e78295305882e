"""Host time inside the LM's per-step residual Jacobians (the program's
`lm.residuals` spans: FK of the hand and grip frames, the goal, standoff
and smoothness residuals, their GN blocks and gradient) over the traced
window's solves (ms)."""

from gtobench.spans import host_ms_per_call


def read(run):
    return host_ms_per_call(run, "lm.residuals")

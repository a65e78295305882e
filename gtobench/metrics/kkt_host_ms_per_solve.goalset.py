"""Host time inside the LM's KKT step (the program's `lm.kkt` spans: the
damped diagonal blocks and the block-tridiagonal solve) over the traced
window's solves (ms)."""

from gtobench.spans import host_ms_per_call


def read(run):
    return host_ms_per_call(run, "lm.kkt")

"""Host time inside the LM's field term (the program's `lm.field_term`
spans: the surface points' FK Jacobians, K4's lookups, the field einsum and
its GN blocks) over the traced window's solves (ms)."""

from gtobench.spans import host_ms_per_call


def read(run):
    return host_ms_per_call(run, "lm.field_term")

"""Host time blocked retiring a solve (the program's `stream.retire` spans:
`stream_map` waiting on a solve's event) over the traced window's solves
(ms)."""

from gtobench.spans import host_ms_per_call


def read(run):
    return host_ms_per_call(run, "stream.retire")

"""K4 (`field_lookup_kernel`): its bound over its time in the trace (%).
The bound counts each launch's points, outputs, row bases and table once
(gtobench.roofline.k4_bytes) at 3.35 TB/s. Left out where the trace's K4
launches, or the program's launch counter, differ from the launches the
bound counts."""

from gtobench import roofline
from gtobench.layers import roofline_pct


def read(run):
    launches = run.layer.get("k4_launches_per_call")
    if not launches:
        return None
    return roofline_pct(run, "field_lookup_kernel", len(launches), roofline.k4_bound_s(launches),
                        counted=run.layer.get("k4_launches_counted"))

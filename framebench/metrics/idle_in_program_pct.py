"""Share of the device's idle time in the traced sub-window (the
complement of the union of its activities, as `trace.idle_gaps` takes
it) during which the host was inside the program's `upload` or `render`
span: the idle time the program's own host work accounts for, the rest
being the benchmark's loop and waits (`harness/spans.py`)."""

from framebench.harness.spans import (TOP, idle_gaps, overlap_ns,
                                      window_records)
from framebench.harness.trace import merged


def read(rec):
    recs = window_records(rec)
    if not recs:
        return None
    gaps = idle_gaps(rec)
    idle = sum(e - s for s, e in gaps)
    if not idle:
        return None
    inside = merged((r[3], r[4]) for r in recs
                    if r[0] in TOP and r[2] is None)
    return overlap_ns(gaps, inside) / idle * 100.0

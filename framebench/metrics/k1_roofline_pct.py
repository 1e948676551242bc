"""K1's share of its roofline: the least time of the frames' tails
(`counts/k1.py`, frozen; against the device's peaks in `peaks.json`)
over K1's device time in the traced sub-window (the k1_color_map and
k1_generic kernels), one tail a launch.  Nothing where K1 did not run,
where the tail has no frozen count or where the device has no peaks in
the table."""

from framebench.counts import k1 as counts
from framebench.harness.trace import k1_kernels


def read(rec):
    k1 = k1_kernels(rec)
    if not k1 or rec["peaks"] is None:
        return None
    least = counts.least_seconds(rec["config"], rec["peaks"])
    if least is None:
        return None
    return least * len(k1) / sum(k1) * 100.0

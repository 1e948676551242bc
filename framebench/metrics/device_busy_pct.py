"""Share of the traced sub-window in which some operation ran on the
device: the union of its activity intervals over the window's length,
in one run."""

from framebench.harness.trace import busy_ns


def read(rec):
    w0, w1 = rec["window_ns"]
    busy = busy_ns(rec)
    return busy / (w1 - w0) * 100.0 if busy and w1 > w0 else None

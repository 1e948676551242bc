"""The renderer's plan-cache misses a frame (`render.plan_misses`
events: a signature planned anew, K1's and K2's instances prepared) in
the traced sub-window (`harness/spans.py`): 0 in a steady stream."""

from framebench.harness.spans import events_per_frame


def read(rec):
    return events_per_frame(rec, "render.plan_misses")

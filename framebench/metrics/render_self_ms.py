"""Host milliseconds a frame of the program's `render` span less its
stage spans: `Renderer.render`'s own work (acquire and release, the
degradation ladder, the plan-cache lookup, the glue between stages), in
the traced sub-window (`harness/spans.py`)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "render")

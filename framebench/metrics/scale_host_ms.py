"""Host milliseconds a frame of the program's `render.scale` spans less
their children: the host's launching of the main scaler, EWA
(`ops/polar.py`) or separable (`ops/sampling.py`), alpha included, in
the traced sub-window (`harness/spans.py`).  Nothing where the frame is
not scaled (a 1:1 render)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "render.scale")

"""Host milliseconds a frame of the program's `render.merge` span less
its children: the host's launching of deinterlacing, deband, grain, the
chroma merge and the input hooks (`Renderer._merge_planes`), in the
traced sub-window (`harness/spans.py`)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "render.merge")

"""Host milliseconds a frame inside the program's `upload.pin` spans:
the allocation of pinned staging memory for each plane (and grain
table) uploaded, in the traced sub-window (`harness/spans.py`)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "upload.pin")

"""Host milliseconds a frame inside the program's `upload.stage` spans
less their `upload.pin` children: each plane's (and each grain table's)
host copy into pinned staging memory before its upload
(`utils/device.raw_to_device`, `arrays_to_device`), in the traced
sub-window (`harness/spans.py`)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "upload.stage")

"""Host milliseconds a frame of the program's `render.tail` spans less
their children: the host's launching of the color tail (the peak's stats,
the tone vector, K1's launch and the peak's finish, or the plain stages
and the delinearize), in the traced sub-window (`harness/spans.py`)."""

from framebench.harness.spans import self_ms_per_frame


def read(rec):
    return self_ms_per_frame(rec, "render.tail")

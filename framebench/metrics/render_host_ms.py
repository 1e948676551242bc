"""Host milliseconds inside the program's `Renderer.render` call, the
mean over the traced run's frames outside the profiler session (a
benchmark span around the call): the renderer's host planning and
issue of one frame.  The reader of `render_host_ms.play` and
`render_host_ms.transcode`, the one quantity split by the end-to-end
metric it moves in each kind of cell."""


def read(rec):
    xs = rec["render_host_s"]
    return sum(xs) / len(xs) * 1e3 if xs else None

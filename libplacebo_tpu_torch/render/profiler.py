"""Render telemetry, and the port's spans and counters.

Telemetry: per-pass timing with rolling statistics.  Counterpart of
libplacebo_tpu/render/profiler.py (pl_dispatch_info, dispatch.h:50-82;
renderer.h:109-126): rolling 256-sample windows with last / peak /
average, handed to a user callback.  The renderer records one pass,
"frame", one frame late (`Renderer.telemetry`,
`Renderer.flush_telemetry`): on the card a pair of CUDA events around
the frame's work, read from the next frame on, once the card has
finished it (the host never waits for it, but with eight frames
pending); on the CPU the frame's wall time.

Spans and counters: where the host's time goes inside a frame.  A span
(`span(name)`) wraps one stage where the work happens: the upload
(`upload`, its pinned staging `upload.stage` and allocation
`upload.pin`) and each stage of `Renderer.render` (`render`,
`render.plan`, `render.inputs`, `render.merge`, `render.decode`,
`render.linearize`, `render.scale`, `render.tail`, `render.encode`,
`render.output`).  Spans cost one check of the profiler's state until a
torch.profiler session is active; inside one, each span is a host range
of the profiler named "lt.<name>" (so the profiler's timeline shows the
stage, with the operations and kernels launched inside it) and a
`Record` in a bounded ring, on `time.time_ns()`, the clock the
profiler's host events are stamped on.  The range is an operator-scope
RecordFunction, not `record_function`'s user scope: a user-scope range
is mirrored on the device's timeline as an annotation over its kernels,
which a trace reader that cannot tell an event's kind (torch before
`_KinetoEvent.activity_type`) takes for a kernel.  The spans of one
frame carry its sequence number: the upload stamps it on the `Frame`
(`Frame.seq`) and the renderer's spans carry it.  `count(name)` adds to
a counter (`render.plan_misses`: the renderer planned a signature anew;
`upload.parallel`: the upload copied a plane into pinned memory on
several host threads) and, inside a session, puts a `Record` of it in
the ring too, so a reader can count the events inside a window.  An operator reads them
in two ways: the "lt.*" ranges of a torch.profiler trace (its own
export or `key_averages()`), and `records()` / `counters()` here.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["PassStats", "RenderInfo", "Telemetry", "Record", "span",
           "count", "next_seq", "records", "dropped", "counters"]

WINDOW = 256   # rolling 256-sample windows, as the reference keeps
RING = 1 << 16     # records the ring keeps: ~4,000 frames' spans


@dataclass
class PassStats:
    """Reference pl_dispatch_info timing summary."""
    name: str
    samples: deque = field(default_factory=lambda: deque(maxlen=WINDOW))

    def record(self, seconds: float):
        self.samples.append(seconds)

    @property
    def last(self) -> float:
        return self.samples[-1] if self.samples else 0.0

    @property
    def peak(self) -> float:
        return max(self.samples) if self.samples else 0.0

    @property
    def average(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def count(self) -> int:
        return len(self.samples)


@dataclass
class RenderInfo:
    """Reference pl_render_info: stage label + stats + pass index."""
    stage: str
    stats: PassStats
    index: int = 0


class Telemetry:
    """Attach to a Renderer: `renderer.telemetry = Telemetry(callback)`.
    The callback receives RenderInfo after every timed pass.  It times
    whole frames; for the stages inside one, run a torch.profiler session
    around `Renderer.render` and read its "lt.*" ranges, or `records()`
    (the module's docstring)."""

    def __init__(self, callback: Optional[Callable] = None):
        self.callback = callback
        self.passes: Dict[str, PassStats] = {}

    def record(self, stage: str, seconds: float, index: int = 0):
        stats = self.passes.get(stage)
        if stats is None:
            stats = self.passes[stage] = PassStats(stage)
        stats.record(seconds)
        if self.callback is not None:
            self.callback(RenderInfo(stage=stage, stats=stats, index=index))

    def summary(self) -> str:
        lines = []
        for name, st in self.passes.items():
            lines.append(f"{name:24s} last {st.last*1e3:8.3f} ms  "
                         f"avg {st.average*1e3:8.3f} ms  "
                         f"peak {st.peak*1e3:8.3f} ms  (n={st.count})")
        return "\n".join(lines)


# -- spans and counters ------------------------------------------------

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


class Record(NamedTuple):
    """A span (`n` 0) or a counter's event (`n` its increment, start ==
    end), on time.time_ns(); `parent` is the enclosing span's name."""
    name: str
    seq: int
    parent: Optional[str]
    start_ns: int
    end_ns: int
    n: int = 0


class _Ring:
    """The newest RING records, and how many older ones it dropped."""

    def __init__(self, size: int = RING):
        self.items: deque = deque(maxlen=size)
        self.dropped = 0
        self.dropped_until = 0   # end_ns of the newest record dropped

    def append(self, rec: Record):
        if len(self.items) == self.items.maxlen:
            self.dropped += 1
            self.dropped_until = self.items[0].end_ns
        self.items.append(rec)


_RING = _Ring()
_COUNTS: Dict[str, int] = {}
_SEQ = itertools.count(1)
_open = threading.local()    # each thread's stack of open spans


def _stack() -> list:
    st = getattr(_open, "spans", None)
    if st is None:
        st = _open.spans = []
    return st


class _NoSpan:
    """What `span` returns while no profiler session is active."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "seq", "parent", "range", "start")

    def __init__(self, name: str, seq: Optional[int]):
        self.name = name
        self.seq = seq

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        if self.seq is None:
            self.seq = self.parent.seq if self.parent else 0
        self.range = _range("lt." + self.name)
        self.range.__enter__()
        st.append(self)
        # inside the range, so that the record nests in it
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        self.range.__exit__(*exc)
        _RING.append(Record(self.name, self.seq, self.parent and
                            self.parent.name, self.start, end))
        return False


def span(name: str, seq: Optional[int] = None):
    """A context around one stage.  `seq` is the frame's sequence number;
    None takes the enclosing span's.  Outside a profiler session it is a
    shared object that does nothing."""
    if not _profiling():
        return _NO_SPAN
    return _Span(name, seq)


def next_seq() -> int:
    """A new frame sequence number (from 1; 0 is "none")."""
    return next(_SEQ)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name`; inside a profiler session, also
    record the event in the ring."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _profiling():
        st = _stack()
        parent = st[-1] if st else None
        t = time.time_ns()
        _RING.append(Record(name, parent.seq if parent else 0,
                            parent and parent.name, t, t, n))


def records() -> List[Record]:
    """A copy of the ring, oldest record first (records are appended as
    spans end)."""
    return list(_RING.items)


def dropped() -> Tuple[int, int]:
    """(records the ring dropped, end_ns of the newest one dropped)."""
    return _RING.dropped, _RING.dropped_until


def counters() -> Dict[str, int]:
    """The counters of `count`, and the launch and tail counters where
    they live: kernels K1-K3 (`k1.launches`, `k2.launches` and by
    library `k2.launches.<library>`, `k3.launches`) and the color-map
    tails (`render.k1_tails`, `render.plain_tails`,
    `render.ineligible_tails`)."""
    from ..ops.cuda import color_map, error_diffusion, shear
    from . import renderer
    out = dict(_COUNTS)
    out.update({"k1.launches": color_map.launches,
                "k2.launches": error_diffusion.launches,
                "k3.launches": shear.launches,
                "render.k1_tails": renderer.k1_tails,
                "render.plain_tails": renderer.plain_tails,
                "render.ineligible_tails": renderer.ineligible_tails})
    out.update({f"k2.launches.{k}": v
                for k, v in error_diffusion.launches_by.items()})
    return out

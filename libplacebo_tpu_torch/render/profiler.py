"""Render telemetry: per-pass timing with rolling statistics.

Counterpart of libplacebo_tpu/render/profiler.py (pl_dispatch_info,
dispatch.h:50-82; renderer.h:109-126): rolling 256-sample windows with
last / peak / average, handed to a user callback.  The renderer records
one pass, "frame", one frame late (`Renderer.telemetry`,
`Renderer.flush_telemetry`): on the card a pair of CUDA events around
the frame's work, read from the next frame on, once the card has
finished it (the host never waits for it, but with eight frames
pending); on the CPU the frame's wall time.  For kernel-level detail use torch.profiler
around `Renderer.render`.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

__all__ = ["PassStats", "RenderInfo", "Telemetry"]

WINDOW = 256   # rolling 256-sample windows, as the reference keeps


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
    The callback receives RenderInfo after every timed pass."""

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

"""Frame-mix windows for frame interpolation.

Counterpart of the mix helpers of libplacebo_tpu/render/queue.py
(:62-110): `FrameMix` (reference pl_frame_mix) and the pick helpers.
The frame queue itself is not ported yet (ROADMAP slice 3 item 23).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..core import filters as flt
from .frame import Frame

__all__ = ["FrameMix", "frame_mix_radius", "frame_mix_current",
           "frame_mix_nearest"]


@dataclass
class FrameMix:
    """Reference pl_frame_mix: frames with signed timestamps relative to
    the target's pts, in vsync units."""
    frames: List[Frame] = field(default_factory=list)
    timestamps: List[float] = field(default_factory=list)
    vsync_duration: float = 1.0


def frame_mix_radius(params) -> float:
    """The frame mixer's radius in vsyncs (reference
    pl_frame_mix_radius): 0 without mixing or with "oversample" (no
    kernel footprint), else the mixer kernel's radius."""
    name = getattr(params, "frame_mixer", None)
    if not name or name in ("none", "oversample"):
        return 0.0
    cfg = flt.find_filter_config(name)
    if cfg is None:
        return 0.0
    return float(cfg.radius_bound())


def frame_mix_current(mix: FrameMix) -> Optional[Frame]:
    """The last frame with timestamp <= 0 (zero-order hold), or None
    (reference pl_frame_mix_current)."""
    cur = None
    for frame, ts in zip(mix.frames, mix.timestamps):
        if ts > 0.0:
            break
        cur = frame
    return cur


def frame_mix_nearest(mix: FrameMix) -> Optional[Frame]:
    """The frame closest to the current pts (reference
    pl_frame_mix_nearest); None for an empty mix."""
    if not mix.frames:
        return None
    best, best_dist = mix.frames[0], abs(mix.timestamps[0])
    for frame, ts in zip(mix.frames[1:], mix.timestamps[1:]):
        if abs(ts) < best_dist:
            best, best_dist = frame, abs(ts)
        else:
            break
    return best

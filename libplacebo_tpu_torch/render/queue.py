"""PTS-ordered frame queue decoupling decode from vsync, and frame-mix
windows for frame interpolation.

Counterpart of libplacebo_tpu/render/queue.py (pl_queue,
utils/frame_queue.h): frame sources pushed (`push`, `push_block` with
backpressure, from a decoder thread) or pulled (`QueueParams.get_frame`),
frame and vsync rates estimated from timestamp deltas, drift
compensation, EOF, interpolation-threshold stickiness and the four
emission modes (POINT, NEAREST, OVERSAMPLE, INTERPOLATE) producing
`FrameMix` windows for `render_image_mix`.  The queue is host logic with
the reference's arithmetic, so its emissions equal the reference's.
Frames come eagerly (Frame) or lazily (SourceFrame: `map` uploads the
planes when the queue first needs the frame, so a frame dropped before
display is discarded without its upload).
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from ..core import filters as flt
from .frame import Frame

__all__ = ["QueueStatus", "QueueMode", "QueueParams", "FrameMix",
           "FrameQueue", "SourceFrame", "frame_mix_radius",
           "frame_mix_current", "frame_mix_nearest"]


class QueueStatus(enum.Enum):
    OK = "ok"          # new frame emitted
    EOF = "eof"        # no more frames
    MORE = "more"      # out of frames; caller should add more and retry
    ERR = "error"


class QueueMode(enum.Enum):
    """Emission modes (frame_queue.h:40-72)."""
    POINT = "point"            # closest frame at or before pts
    NEAREST = "nearest"        # closest frame overall
    OVERSAMPLE = "oversample"  # two nearest + relative weights
    INTERPOLATE = "interpolate"  # full mixing window for a frame mixer


@dataclass
class QueueParams:
    """Reference pl_queue_params (frame_queue.h:135-185)."""
    pts: float = 0.0
    radius: float = 0.0          # mixing window radius (in vsyncs)
    vsync_duration: float = 0.0  # 0 = estimate
    frame_duration: float = 0.0  # 0 = estimate
    interpolation_threshold: float = 0.01
    # PTS drift/jitter compensation (reference frame_queue.h:148-157):
    # a requested pts this close to a queued frame's pts snaps to it,
    # and the mismatch is subtracted from all future updates until the
    # queue resets or the pts jumps discontinuously
    drift_compensation: float = 1e-3
    get_frame: Optional[Callable[[], Optional[Frame]]] = None


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


@dataclass
class SourceFrame:
    """Lazily-mapped frame handle (reference pl_source_frame,
    frame_queue.h:45-110): `map()` produces the device Frame only when
    the queue actually needs it for emission — decode handles that get
    dropped before display (seeks, speed-ups) are `discard()`ed without
    ever paying the upload.  `unmap(frame)` releases a mapped frame
    when it leaves the queue."""
    pts: float
    map: Callable[[], Frame]
    unmap: Optional[Callable[[Frame], None]] = None
    discard: Optional[Callable[[], None]] = None


class _Entry:
    """Internal queue slot: a pts plus either an eagerly-supplied Frame
    or a SourceFrame mapped on first use (frame_queue.c:547-587)."""
    __slots__ = ("pts", "_src", "_frame")

    def __init__(self, item):
        if isinstance(item, SourceFrame):
            self._src = item
            self._frame = None
            self.pts = item.pts
        else:
            self._src = None
            self._frame = item
            self.pts = item.pts

    def get(self) -> Frame:
        if self._frame is None:
            self._frame = self._src.map()
            if self._frame.pts != self.pts:
                self._frame.pts = self.pts
        return self._frame

    def drop(self):
        """The entry leaves the queue: unmap if mapped, else discard."""
        if self._src is None:
            return
        if self._frame is not None:
            if self._src.unmap is not None:
                self._src.unmap(self._frame)
            self._frame = None
        elif self._src.discard is not None:
            self._src.discard()


class _RatePool:
    """Windowed rate estimator (reference struct pool + update_estimate,
    frame_queue.c:54-70,247-274): rolling mean over up to 32 deltas; the
    pool RESETS when a new delta deviates >30% from the running mean
    (rate change / seek), and the estimate only updates once 4 samples
    agree — so a single jittery pts can no longer flip emission modes."""
    MAX_SAMPLES = 32
    MIN_SAMPLES = 4
    MAX_DELTA = 0.3

    def __init__(self):
        self.samples: List[float] = []
        self.total = 0
        self.estimate = 0.0

    def default(self, val: float):
        """Seed the estimate from a metadata hint (reference
        default_estimate, frame_queue.c:246): used until real samples
        take over."""
        if not self.estimate and val and val > 0:
            self.estimate = val

    def update(self, cur: float):
        if cur <= 0:
            return
        if self.samples:
            mean = sum(self.samples) / len(self.samples)
            if abs(cur - mean) / max(min(cur, mean), 1e-12) > self.MAX_DELTA:
                self.samples.clear()
        self.samples.append(cur)
        if len(self.samples) > self.MAX_SAMPLES:
            self.samples.pop(0)
        self.total += 1
        if self.total < self.MIN_SAMPLES or \
                len(self.samples) >= self.MIN_SAMPLES:
            self.estimate = sum(self.samples) / len(self.samples)

    @property
    def rate(self) -> float:
        return 1.0 / self.estimate if self.estimate > 0 else 0.0


class FrameQueue:
    """Reference pl_queue object."""

    # interpolation-threshold stickiness (frame_queue.c:58-60): once
    # interpolation is disabled because source and vsync rates match,
    # it stays disabled until the ratio exceeds the threshold for this
    # many consecutive updates
    THRESHOLD_FRAMES = 5

    def __init__(self, params: Optional[QueueParams] = None):
        self.params = params or QueueParams()
        self._frames: List[_Entry] = []       # sorted by pts
        self._eof = False
        self._prev_pts = None
        self._fps_pool = _RatePool()
        self._vps_pool = _RatePool()
        self._last_vsync_pts = None
        self._threshold_stick = 0
        self._pts_offset = 0.0
        # thread-safety + producer backpressure (reference pl_queue is
        # fully thread-safe; push_block waits on this condition,
        # frame_queue.c:462)
        self._cond = threading.Condition(threading.RLock())
        self._last_target = None   # horizon of the last update()

    def pts_offset(self) -> float:
        """Current PTS drift-compensation offset (reference
        pl_queue_pts_offset, frame_queue.c:1079): added to every
        incoming QueueParams.pts."""
        return self._pts_offset

    @property
    def _fps_est(self) -> float:
        return self._fps_pool.rate

    @property
    def _vps_est(self) -> float:
        return self._vps_pool.rate

    # -- ingestion ----------------------------------------------------

    def push(self, frame):
        """Add a Frame or a lazily-mapped SourceFrame (None signals
        EOF); reference pl_queue_push."""
        with self._cond:
            if frame is None:
                self._eof = True
                self._cond.notify_all()
                return
            entry = _Entry(frame)
            self._frames.append(entry)
            self._frames.sort(key=lambda e: e.pts)
            # FPS estimation from successive pts deltas (frame_queue.c:247)
            if self._prev_pts is not None and entry.pts > self._prev_pts:
                self._fps_pool.update(entry.pts - self._prev_pts)
            if self._prev_pts is None or entry.pts > self._prev_pts:
                self._prev_pts = entry.pts

    # producer-side high-water mark: how many frames beyond the last
    # update()'s horizon push_block keeps buffered before blocking
    MAX_AHEAD = 8

    def _wants_frames(self) -> bool:
        if self._eof:
            return False     # nothing more is needed; don't block forever
        if self._last_target is None:
            return len(self._frames) < self.MAX_AHEAD
        ahead = sum(1 for e in self._frames if e.pts > self._last_target)
        return ahead < self.MAX_AHEAD

    def push_block(self, frame, timeout: Optional[float] = None) -> bool:
        """Blocking push for decoder threads (reference
        pl_queue_push_block, frame_queue.c:462): waits until the queue
        wants more frames (bounded lookahead past the last update()'s
        window) or `timeout` seconds elapse.  Returns False on timeout
        (the frame was NOT consumed)."""
        with self._cond:
            if not self._cond.wait_for(self._wants_frames, timeout):
                return False
            self.push(frame)
            return True

    # Reference PREFETCH_FRAMES (frame_queue.c:62): frames pulled beyond
    # the emission window so their decode and upload (an asynchronous
    # copy from pinned memory) overlap the current frame's render instead
    # of stalling the next update().
    PREFETCH_FRAMES = 2

    def _fill_until(self, pts: float):
        if self.params.get_frame is None:
            return
        while not self._eof and (not self._frames or
                                 self._frames[-1].pts <= pts):
            f = self.params.get_frame()
            if f is None:
                self._eof = True
                break
            self.push(f)
        # prefetch ahead of the window
        extra = sum(1 for fr in self._frames if fr.pts > pts)
        while not self._eof and extra < self.PREFETCH_FRAMES:
            f = self.params.get_frame()
            if f is None:
                self._eof = True
                break
            self.push(f)
            extra += 1

    # -- introspection (reference pl_queue_estimate_fps/vps) ----------

    def estimate_fps(self) -> float:
        return self._fps_est

    def estimate_vps(self) -> float:
        return self._vps_est

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    def peek(self, idx: int) -> Optional[Frame]:
        """Inspect (and map, if lazy) the idx'th queued frame
        (reference pl_queue_peek, frame_queue.c:1066)."""
        with self._cond:
            if 0 <= idx < len(self._frames):
                return self._frames[idx].get()
            return None

    def reset(self):
        with self._cond:
            for e in self._frames:
                e.drop()
            self._frames.clear()
            self._eof = False
            self._prev_pts = None
            self._last_vsync_pts = None
            self._fps_pool = _RatePool()
            self._vps_pool = _RatePool()
            self._threshold_stick = 0
            self._pts_offset = 0.0
            self._last_target = None
            self._cond.notify_all()

    # -- emission -----------------------------------------------------

    def update(self, params: Optional[QueueParams] = None,
               mode: QueueMode = QueueMode.INTERPOLATE,
               ) -> Tuple[QueueStatus, Optional[FrameMix]]:
        """Emit the frame mix for the requested pts
        (reference pl_queue_update, frame_queue.c:965)."""
        with self._cond:
            try:
                return self._update_locked(params, mode)
            finally:
                # consumed/dropped frames free producer space
                self._cond.notify_all()

    def _update_locked(self, params, mode):
        if params is not None:
            if params.get_frame is None:
                params.get_frame = self.params.get_frame
            self.params = params
        p = self.params
        pts = p.pts

        # windowed vsync rate estimation from successive update() calls,
        # seeded from the declared vsync duration until samples arrive
        if p.vsync_duration:
            self._vps_pool.default(p.vsync_duration)
        if p.frame_duration:
            self._fps_pool.default(p.frame_duration)
        if self._last_vsync_pts is not None and pts > self._last_vsync_pts:
            delta = pts - self._last_vsync_pts
            if delta > 1.0:
                # discontinuous jump (e.g. resume after suspend):
                # don't poison the vsync estimate, drop the drift
                # offset (reference frame_queue.c:990-997)
                self._pts_offset = 0.0
            else:
                self._vps_pool.update(delta)
        self._last_vsync_pts = pts

        # PTS drift compensation (reference frame_queue.c:1007-1021):
        # snap to a queued frame's pts when within the tolerance and
        # remember the offset for future updates
        if p.drift_compensation > 0.0:
            adj = pts + self._pts_offset
            for f in self._frames:
                if abs(f.pts - adj) < p.drift_compensation:
                    self._pts_offset = f.pts - pts
                    adj = f.pts
                    break
            pts = adj

        self._fill_until(pts + max(p.radius, 1.0) *
                         (p.vsync_duration or 1.0 / max(self._vps_est, 1e-9)
                          if self._vps_est else 1.0))

        if not self._frames:
            return (QueueStatus.EOF if self._eof else QueueStatus.MORE), None

        # drop frames too old to matter (keep one before the window)
        vsync = p.vsync_duration or (
            1.0 / self._vps_est if self._vps_est else
            (1.0 / self._fps_est if self._fps_est else 1.0 / 60.0))
        window = max(p.radius, 1.0) * vsync
        self._last_target = pts + window
        while len(self._frames) > 1 and \
                self._frames[1].pts <= pts - window:
            self._frames.pop(0).drop()

        frame_dur = p.frame_duration or (
            1.0 / self._fps_est if self._fps_est else vsync)

        # source exhausted and playback has moved past the last frame's
        # display window: report EOF instead of holding the final frame
        # forever (reference pl_queue_update's eof return,
        # frame_queue.c:1009-1032)
        if self._eof and pts > self._frames[-1].pts + frame_dur:
            return QueueStatus.EOF, None

        # interpolation pointless when rates are close (reference
        # interpolation_threshold logic + stickiness, frame_queue.c:58)
        if mode == QueueMode.INTERPOLATE and self._fps_est and \
                self._vps_est:
            close = abs(self._fps_est / self._vps_est - 1.0) \
                < p.interpolation_threshold
            if close:
                self._threshold_stick = self.THRESHOLD_FRAMES
            elif self._threshold_stick > 0:
                self._threshold_stick -= 1
            if close or self._threshold_stick > 0:
                mode = QueueMode.POINT

        if mode in (QueueMode.POINT, QueueMode.NEAREST):
            if mode == QueueMode.POINT:
                cands = [e for e in self._frames if e.pts <= pts] \
                    or self._frames[:1]
                best = cands[-1]
            else:
                best = min(self._frames, key=lambda e: abs(e.pts - pts))
            mix = FrameMix([best.get()], [(best.pts - pts) / vsync], 1.0)
            return QueueStatus.OK, mix

        if mode == QueueMode.OVERSAMPLE:
            before = [e for e in self._frames if e.pts <= pts]
            after = [e for e in self._frames if e.pts > pts]
            ents = ([before[-1]] if before else []) + \
                (after[:1] if after else [])
            if not ents:
                ents = self._frames[:1]
            mix = FrameMix([e.get() for e in ents],
                           [(e.pts - pts) / vsync for e in ents], 1.0)
            return QueueStatus.OK, mix

        # INTERPOLATE: all frames within radius*vsync of pts (plus one
        # on each side for kernel support)
        rad = max(p.radius, 1.0) * vsync
        idxs = [i for i, e in enumerate(self._frames)
                if abs(e.pts - pts) <= rad]
        if not idxs:
            before = [i for i, e in enumerate(self._frames)
                      if e.pts <= pts]
            idxs = [before[-1]] if before else [0]
        i0, i1 = idxs[0], idxs[-1]
        if i0 > 0:
            i0 -= 1
        if i1 + 1 < len(self._frames):
            i1 += 1
        ents = self._frames[i0:i1 + 1]
        mix = FrameMix([e.get() for e in ents],
                       [(e.pts - pts) / vsync for e in ents],
                       frame_dur / vsync)
        return QueueStatus.OK, mix

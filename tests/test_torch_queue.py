"""PyTorch port: the frame queue (render/queue.py: FrameQueue,
SourceFrame, QueueParams, the four emission modes) against the JAX
package's on the same pts streams and update sequences, and the
renderer's telemetry (render/profiler.py, Renderer.telemetry).

The queue is host logic copied with the reference's arithmetic, so
every comparison is exact: statuses, the emitted frames' pts, the
timestamps, vsync_duration, the drift offset and the rate estimates.
Every wait on a thread has a timeout of 1 s or less.  Telemetry: the
same PassStats on the same samples, exactly; the frame time recorded
one frame late, and flush_telemetry recording the last one.
"""
import threading

import numpy as np
import pytest

from libplacebo_tpu.render import profiler as jprof
from libplacebo_tpu.render import queue as jq

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.render import profiler as tprof
from libplacebo_tpu_torch.render import queue as tq


class _Src:
    """A stand-in frame: the queue reads only `pts`."""

    def __init__(self, pts):
        self.pts = pts


def _emissions(q_mod, pts_list, updates, mode, push_at=None, pull=False):
    """Run one queue of `q_mod` over a pts stream and a sequence of
    QueueParams kwargs; returns everything each update emitted."""
    frames = [_Src(p) for p in pts_list]
    it = iter(frames)
    q = q_mod.FrameQueue(q_mod.QueueParams(
        get_frame=(lambda: next(it, None)) if pull else None))
    if not pull:
        for f in frames[:push_at]:
            q.push(f)
    out = []
    for i, kw in enumerate(updates):
        if not pull and push_at is not None and i == 3:
            for f in frames[push_at:]:
                q.push(f)
            q.push(None)
        st, mix = q.update(q_mod.QueueParams(**kw), mode)
        out.append((st.value, None if mix is None else (
            [f.pts for f in mix.frames], list(mix.timestamps),
            mix.vsync_duration), q.pts_offset(), q.estimate_fps(),
            q.estimate_vps(), q.num_frames))
    return out


_MODES = ["POINT", "NEAREST", "OVERSAMPLE", "INTERPOLATE"]


def _film(n, fps=24000 / 1001, start=0.0):
    return [start + k / fps for k in range(n)]


def _vsyncs(n, hz=60.0, radius=2.0, declared=True, start=0.0, **kw):
    return [dict(pts=start + v / hz, radius=radius,
                 vsync_duration=1 / hz if declared else 0.0, **kw)
            for v in range(n)]


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("scenario", ["push", "pull", "estimated",
                                      "late_push"])
def test_emissions_equal(mode, scenario):
    """A 23.976 fps film on a 60 Hz display in every mode: pushed up
    front, pulled through get_frame, with the vsync rate estimated
    (vsync_duration 0), and pushed after the first updates (MORE, then
    frames, then EOF)."""
    pts = _film(30)
    kw = dict(declared=scenario != "estimated")
    ups = _vsyncs(80, **kw)
    args = dict(pull=scenario == "pull",
                push_at=5 if scenario == "late_push" else None)
    if scenario == "late_push":
        ups = [dict(pts=-0.5)] * 2 + ups
    a = _emissions(jq, pts, ups, getattr(jq.QueueMode, mode), **args)
    b = _emissions(tq, pts, ups, getattr(tq.QueueMode, mode), **args)
    assert a == b
    assert any(e[0] == "ok" for e in a)


def test_drift_compensation():
    """Requested pts jittering within the tolerance of the frames' snap
    to them and carry the offset; a jump over 1 s drops it."""
    rng = np.random.default_rng(5)
    pts = _film(40)
    ups = [dict(pts=p + float(rng.uniform(-5e-4, 5e-4)),
                vsync_duration=1 / 24, drift_compensation=1e-3)
           for p in pts[:20]]
    ups += [dict(pts=pts[20] + 2.0, vsync_duration=1 / 24)]
    for mode in _MODES:
        a = _emissions(jq, pts, ups, getattr(jq.QueueMode, mode))
        b = _emissions(tq, pts, ups, getattr(tq.QueueMode, mode))
        assert a == b
    assert any(e[2] != 0.0 for e in a) and a[-1][2] == 0.0


def test_eof_past_the_last_frame():
    """After EOF, updates past the last frame's display window report
    EOF in both."""
    pts = _film(6)
    ups = _vsyncs(30)
    a = _emissions(jq, pts, ups, jq.QueueMode.INTERPOLATE, push_at=6)
    b = _emissions(tq, pts, ups, tq.QueueMode.INTERPOLATE, push_at=6)
    assert a == b and a[-1][0] == "eof"


def test_threshold_stickiness():
    """60 fps content on a 60 Hz display turns interpolation off; when
    the rate changes to 50 fps it stays off for THRESHOLD_FRAMES
    updates, identically in both."""
    pts = [k / 60 for k in range(40)] + [40 / 60 + k / 50 for k in range(60)]
    ups = _vsyncs(150, hz=60.0, radius=2.0)
    a = _emissions(jq, pts, ups, jq.QueueMode.INTERPOLATE)
    b = _emissions(tq, pts, ups, tq.QueueMode.INTERPOLATE)
    assert a == b
    assert tq.FrameQueue.THRESHOLD_FRAMES == jq.FrameQueue.THRESHOLD_FRAMES
    singles = [len(e[1][0]) == 1 for e in a if e[1] is not None]
    assert any(singles) and not all(singles)


def _lazy(q_mod, counts, n=12):
    """SourceFrames whose map/unmap/discard count into `counts`."""
    def make(k):
        def mapped():
            counts["map"] += 1
            return _Src(-1.0)
        return q_mod.SourceFrame(
            pts=k / 24, map=mapped,
            unmap=lambda f: counts.__setitem__("unmap", counts["unmap"] + 1),
            discard=lambda: counts.__setitem__("discard",
                                               counts["discard"] + 1))
    return [make(k) for k in range(n)]


def test_lazy_map_and_discard_counts():
    """Lazy frames map when first emitted, unmap when they leave the
    queue, and are discarded unmapped when skipped (a seek, a reset):
    the same counts in both, and the mapped frame takes its pts."""
    res = {}
    for name, q_mod in (("j", jq), ("t", tq)):
        counts = {"map": 0, "unmap": 0, "discard": 0}
        q = q_mod.FrameQueue()
        for f in _lazy(q_mod, counts):
            q.push(f)
        emitted = []
        for v in range(6):
            st, mix = q.update(q_mod.QueueParams(
                pts=v / 60, radius=0.0, vsync_duration=1 / 60),
                q_mod.QueueMode.POINT)
            emitted.append([f.pts for f in mix.frames])
        # a seek far ahead: the frames before it leave unseen
        q.update(q_mod.QueueParams(pts=8 / 24 + 1e-3, vsync_duration=1 / 60),
                 q_mod.QueueMode.POINT)
        q.reset()
        res[name] = (dict(counts), emitted)
    assert res["j"] == res["t"]
    counts = res["t"][0]
    assert counts["map"] >= 1 and counts["discard"] >= 1 and \
        counts["map"] == counts["unmap"]


def test_push_block_backpressure():
    """A decoder thread push_blocks lazily: it stops MAX_AHEAD frames
    past the last update's horizon, times out while the display waits,
    and goes on once an update consumes frames."""
    q = lt.FrameQueue()
    counts = {"map": 0, "unmap": 0, "discard": 0}
    frames = _lazy(tq, counts, n=40)
    pushed, timeouts = [], []
    stop = threading.Event()

    def decoder():
        for f in frames:
            while not stop.is_set():
                if q.push_block(f, timeout=0.05):
                    pushed.append(f.pts)
                    break
                timeouts.append(f.pts)
            if stop.is_set():
                return
        q.push_block(None, timeout=0.5)
    th = threading.Thread(target=decoder, daemon=True)
    th.start()
    try:
        for _ in range(100):
            if timeouts:
                break
            threading.Event().wait(0.01)
        assert timeouts and len(pushed) == tq.FrameQueue.MAX_AHEAD
        before = len(pushed)
        st, mix = q.update(lt.QueueParams(pts=0.5, radius=2.0,
                                          vsync_duration=1 / 60),
                           lt.QueueMode.INTERPOLATE)
        assert st == lt.QueueStatus.OK
        for _ in range(100):
            if len(pushed) > before:
                break
            threading.Event().wait(0.01)
        assert len(pushed) > before
    finally:
        stop.set()
        th.join(timeout=1.0)
    assert not th.is_alive()


def test_telemetry_pass_stats_equal():
    """The same samples through both packages' Telemetry: the same
    last / peak / average / count, callbacks and summary text."""
    rng = np.random.default_rng(9)
    samples = rng.random(300) * 0.02
    seen = {"j": [], "t": []}
    tj = jprof.Telemetry(lambda info: seen["j"].append(
        (info.stage, info.stats.last, info.index)))
    tt = tprof.Telemetry(lambda info: seen["t"].append(
        (info.stage, info.stats.last, info.index)))
    for i, s in enumerate(samples):
        for t in (tj, tt):
            t.record("frame" if i % 3 else "mix", float(s), index=i % 2)
    assert seen["j"] == seen["t"]
    for name in ("frame", "mix"):
        a, b = tj.passes[name], tt.passes[name]
        assert (a.last, a.peak, a.average, a.count) == \
            (b.last, b.peak, b.average, b.count)
        assert b.count == min(tprof.WINDOW, b.count)
    assert tj.summary() == tt.summary()


def test_telemetry_is_one_frame_late():
    """The renderer records a frame's time when the next frame has been
    queued, and flush_telemetry records the last; without telemetry
    nothing is kept."""
    rng = np.random.default_rng(0)
    rgb = rng.random((16, 128, 3)).astype(np.float32)
    frame = lt.frame_from_rgb(rgb, color=lt.CSP_BT709, device="cpu")
    target = lt.Target(w=256, h=32, color=lt.CSP_SRGB, bit_depth=8)
    r = lt.Renderer(device="cpu")
    r.render(frame, target)
    assert r._telemetry_pending == []
    infos = []
    r.telemetry = lt.Telemetry(infos.append)
    r.render(frame, target)
    assert not infos and len(r._telemetry_pending) == 1
    r.render(frame, target)
    assert len(infos) == 1 and infos[0].stage == "frame"
    r.flush_telemetry()
    stats = r.telemetry.passes["frame"]
    assert stats.count == 2 and 0 < stats.peak < 60 and len(infos) == 2
    r.flush_telemetry()
    assert stats.count == 2 and r._telemetry_pending == []

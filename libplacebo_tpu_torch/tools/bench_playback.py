#!/usr/bin/env python3
"""System-level playback benchmark of the port: sustained fps with the
per-frame host->device ingestion included, for u8 yuv420p and p010le
sources (1080p -> the flagship's 4K by default), in one process:

  upload   ingestion alone: every frame mapped as a decoder's AVFrame
           (utils/interop.py: raw integer planes staged in pinned
           memory, copied without waiting, normalized on the card), then
           one synchronization (the ingest ceiling)
  render   one pre-uploaded frame rendered `frames` times with a 2-frame
           in-flight window (the host waits for frame i - 2's end)
  serial   map -> wait -> render -> wait, frame by frame (no overlap)
  queue    the plplay path: the real FrameQueue pulls get_frame()
           PREFETCH_FRAMES=2 ahead of the display window, so the next
           frames' uploads are queued while the current frame renders;
           outputs are waited for with a 2-frame lag

Each mode is timed by CUDA events around it (device ms a frame) and by
the host clock (host ms a frame, printed beside).  Overlap shows as
queue-mode fps above serial fps, approaching the slower of upload and
render.  On the CPU (`--cpu`) only the logic is exercised: its numbers
say nothing of a GPU.

Reference analog: pl_gpu's async transfers (gpu.h:879-896) + plplay's
decode-ahead loop and pl_queue prefetch (frame_queue.c:62).

Usage:
    python3 -m libplacebo_tpu_torch.tools.bench_playback [--frames N]
            [--size WxH] [--out FILE.json] [--device cuda|cpu] [--cpu]
"""
import argparse
import json
import sys
import time
from collections import deque

import numpy as np
import torch

from ..demos import add_device_args, device_from, synchronize

SRC_FPS = 24.0
LAG = 2                      # in-flight display window (double-buffer)


def make_host_frames(fmt: str, n: int, h: int, w: int):
    """n distinct host arrays a plane (np.roll copies), so every frame
    pays a real host->device transfer."""
    rng = np.random.default_rng(11)
    if fmt == "yuv420p":
        base = [
            (rng.random((h, w)) * 219 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
        ]
    elif fmt == "p010le":
        # MSB-aligned 10-bit (ffmpeg p010): samples in the top bits
        base = [
            ((rng.random((h, w)) * 876 + 64).astype(np.uint16) << 6),
            ((rng.random((h // 2, w // 2, 2)) * 896 + 64)
             .astype(np.uint16) << 6),
        ]
    else:
        raise ValueError(fmt)
    return [[np.roll(p, 7 * i, axis=1) for p in base] for i in range(n)]


def ingest(fmt: str, data, dev, pts: float = 0.0):
    """The decoder-interop ingestion path (utils/interop.py)."""
    from ..utils.interop import frame_from_avframe_like
    f = frame_from_avframe_like({
        "format": fmt, "data": data, "colorspace": "bt2020nc",
        "color_trc": "smpte2084", "color_range": "tv"}, device=dev)
    f.pts = pts
    return f


class _Window:
    """At most LAG outputs in flight: each render's end is marked (a CUDA
    event), and the host waits for the oldest mark past the window."""

    def __init__(self, dev):
        self.dev, self.pending = dev, deque()

    def push(self):
        if self.dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append(ev)
        while len(self.pending) > LAG:
            self.pending.popleft().synchronize()

    def drain(self):
        synchronize(self.dev)
        self.pending.clear()


def run_upload(fmt, host_frames, dev):
    frames = [ingest(fmt, d, dev) for d in host_frames]
    synchronize(dev)
    return frames


def run_render_only(frame, r, target, params, n, dev):
    win = _Window(dev)
    for _ in range(n):
        r.render(frame, target, params)
        win.push()
    win.drain()


def run_serial(fmt, host_frames, r, target, params, dev):
    for d in host_frames:
        f = ingest(fmt, d, dev)
        synchronize(dev)
        r.render(f, target, params)
        synchronize(dev)


def run_queue(fmt, host_frames, r, target, params, dev):
    """plplay-shaped loop: FrameQueue + get_frame prefetch + a LAG-frame
    output window, so frame i renders while frames i+1..i+2 upload."""
    from ..render.queue import (FrameQueue, QueueMode, QueueParams,
                                QueueStatus)
    n = len(host_frames)
    counter = iter(range(n))

    def get_frame():
        i = next(counter, None)
        if i is None:
            return None
        return ingest(fmt, host_frames[i], dev, pts=i / SRC_FPS)

    q = FrameQueue(QueueParams(get_frame=get_frame))
    win = _Window(dev)
    emitted = 0
    for i in range(n):
        st, mix = q.update(QueueParams(pts=i / SRC_FPS,
                                       get_frame=get_frame),
                           mode=QueueMode.NEAREST)
        if st != QueueStatus.OK or mix is None or not mix.frames:
            break
        r.render(mix.frames[0], target, params)
        emitted += 1
        win.push()
    win.drain()
    return emitted


def timed(dev, fn, *args):
    """(host s, device ms by CUDA events or None on the CPU, result)."""
    synchronize(dev)
    ev = None
    if dev.type == "cuda":
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    ret = fn(*args)
    if ev is not None:
        ev[1].record()
    synchronize(dev)
    dt = time.perf_counter() - t0
    return dt, (ev[0].elapsed_time(ev[1]) if ev is not None else None), ret


def run(n: int, w: int, h: int, dev) -> dict:
    from ..core.colorspace import CSP_SRGB
    from ..render.renderer import RenderParams, Renderer, Target
    r = Renderer(device=dev)
    target = Target(w=2 * w, h=2 * h, color=CSP_SRGB, bit_depth=8)
    params = RenderParams(upscaler="ewa_lanczos")
    result = {"frames": n, "src": [h, w], "dst": [target.h, target.w],
              "lag": LAG, "prefetch": 2, "device": str(dev), "formats": {}}
    for fmt in ("yuv420p", "p010le"):
        host = make_host_frames(fmt, n, h, w)
        # warm-up: this format's first map and render (kernel libraries,
        # plans)
        r.render(ingest(fmt, host[0], dev), target, params)
        synchronize(dev)

        times = {}
        times["upload"] = timed(dev, run_upload, fmt, host, dev)
        frames = times["upload"][2]
        times["render_dispatch"] = timed(dev, run_render_only, frames[0],
                                         r, target, params, n, dev)
        del frames
        times["serial"] = timed(dev, run_serial, fmt, host, r, target,
                                params, dev)
        times["queue_overlap"] = timed(dev, run_queue, fmt, host, r, target,
                                       params, dev)
        if times["queue_overlap"][2] != n:
            raise RuntimeError(f"the queue emitted "
                               f"{times['queue_overlap'][2]} of {n} frames")
        # device ms a frame where the card timed it, else host ms
        ms = {k: (t[1] if t[1] is not None else t[0] * 1e3) / n
              for k, t in times.items()}
        host_ms = {k: t[0] * 1e3 / n for k, t in times.items()}
        fps = {k: 1e3 / v for k, v in ms.items()}
        slower = max(ms["upload"], ms["render_dispatch"])
        overlap = {
            "speedup_vs_serial": ms["serial"] / ms["queue_overlap"],
            "frac_of_no_overlap_sum": ms["queue_overlap"]
            / (ms["upload"] + ms["render_dispatch"]),
            "frac_of_slower_stage": ms["queue_overlap"] / slower}
        result["formats"][fmt] = {"fps": fps, "ms_per_frame": ms,
                                  "host_ms_per_frame": host_ms,
                                  "overlap": overlap}
        print(json.dumps({fmt: result["formats"][fmt]}), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_playback")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", default="1920x1080", metavar="WxH",
                    help="source size; the target is twice as wide and "
                         "high")
    ap.add_argument("--out", default=None, metavar="FILE")
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev = device_from(args)
    w, h = (int(v) for v in args.size.lower().split("x"))
    result = run(args.frames, w, h, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

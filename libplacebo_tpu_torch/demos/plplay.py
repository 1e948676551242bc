#!/usr/bin/env python3
"""plplay — minimal playback-loop demo (reference: demos/plplay.c).

Decodes synthetic frames (or YUV files via --y4m), runs them through the
frame queue with motion interpolation, and renders each vsync with the
full pipeline on the card. Prints the playback rate, the ms a vsync
(host clock, and CUDA events on the card) and the kernels' launches.

Usage:
    python3 -m libplacebo_tpu_torch.demos.plplay [--frames N] [--fps 24]
            [--vsync 60] [--preset default|fast|high_quality]
            [--options "upscaler=ewa_lanczos,deband=yes"]
            [--size WxH] [--out WxH] [--hdr] [--device cuda|cpu] [--cpu]
            [--y4m in.y4m] [--write-y4m out.y4m] [--write-png dir/]

--y4m plays a real YUV4MPEG2 file (`ffmpeg -i clip.mkv clip.y4m`)
instead of the synthetic source; --write-y4m muxes the rendered output
(renderer encodes straight to the target YUV repr, the muxer
box-averages chroma to 4:2:0); --write-png dumps per-vsync RGB stills.
"""
import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from . import add_device_args, device_from, synchronize


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plplay")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--fps", type=float, default=24.0)
    ap.add_argument("--vsync", type=float, default=60.0)
    ap.add_argument("--preset", default="default")
    ap.add_argument("--options", default="")
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--out", default="1280x720")
    ap.add_argument("--hdr", action="store_true")
    add_device_args(ap)
    ap.add_argument("--zoom", default="fit",
                    choices=["fit", "pad", "crop", "stretch", "raw"],
                    help="how the video fills the target (reference "
                         "plplay target_zoom, demos/plplay.c:404-430)")
    ap.add_argument("--rotate", type=int, default=0,
                    choices=[0, 90, 180, 270],
                    help="display rotation (reference plplay "
                         "target_rot): rotates frames before scaling")
    ap.add_argument("--par", type=float, default=0.0,
                    help="force a pixel aspect ratio on source frames "
                         "(anamorphic content)")
    ap.add_argument("--y4m", default=None, metavar="FILE",
                    help="play a YUV4MPEG2 file instead of synthesizing")
    ap.add_argument("--write-y4m", default=None, metavar="FILE",
                    help="mux rendered output as 4:2:0 YUV4MPEG2")
    ap.add_argument("--write-png", default=None, metavar="DIR",
                    help="dump rendered vsyncs as PNG stills")
    ap.add_argument("--ui", action="store_true",
                    help="live options panel (curses) during playback — "
                         "the reference demos/settings.c analog: every "
                         "option editable mid-stream, applied on the "
                         "next vsync")
    args = ap.parse_args(argv)
    dev = device_from(args)

    from ..core.colorspace import (BitEncoding, ColorLevels, ColorRepr,
                                   ColorSystem, CSP_BT2100_PQ, CSP_SRGB)
    from ..core.common import RectF, Rotation
    from ..core.options import Options
    from ..ops.cuda import color_map as k1
    from ..ops.cuda import error_diffusion as k2
    from ..ops.cuda import shear as k3
    from ..render.frame import frame_from_yuv420p
    from ..render.profiler import Telemetry
    from ..render.queue import (FrameQueue, QueueMode, QueueParams,
                                QueueStatus)
    from ..render.renderer import Renderer, Target, render_image_mix
    from ..utils.y4m import Y4MReader, Y4MWriter, write_png

    w, h = map(int, args.size.split("x"))
    ow, oh = map(int, args.out.split("x"))

    opts = Options()
    if args.preset != "default":
        opts.parse(f"preset={args.preset}")
    if args.options:
        opts.parse(args.options)

    # synthetic "decoder": moving gradient + noise
    rng = np.random.default_rng(0)

    def decode(i):
        yy, xx = np.mgrid[0:h, 0:w]
        phase = i / args.fps
        y = (96 + 60 * np.sin(xx / 64.0 + phase * 3)
             + 40 * np.cos(yy / 48.0 + phase * 2)
             + rng.normal(0, 2, (h, w))).clip(16, 235).astype(np.uint8)
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = (128 + 64 * np.sin(phase)).astype(np.uint8) * \
            np.ones((h // 2, w // 2), np.uint8)
        kwargs = {}
        if args.hdr:
            kwargs = dict(color=CSP_BT2100_PQ,
                          repr=ColorRepr(sys=ColorSystem.BT_2020_NC,
                                         levels=ColorLevels.LIMITED,
                                         bits=BitEncoding(8, 8, 0)))
        f = frame_from_yuv420p(y, u, v, device=dev, **kwargs)
        f.pts = i / args.fps
        f.signature = i + 1
        return f

    decoded = [0]
    if args.y4m:
        reader = Y4MReader(args.y4m, device=dev)
        w, h = reader.info.width, reader.info.height
        if reader.info.fps:
            args.fps = float(reader.info.fps)

        def y4m_frames():
            for i, f in enumerate(reader):
                f.pts = i / args.fps
                f.signature = i + 1
                decoded[0] = i + 1
                yield f
            yield None
        frames = y4m_frames()
        args.frames = 10 ** 9       # plays until the queue reports EOF
    else:
        frames = iter([decode(i) for i in range(args.frames)] + [None])
    queue = FrameQueue(QueueParams(get_frame=lambda: next(frames)))
    renderer = Renderer(device=dev)
    renderer.telemetry = Telemetry()
    if args.write_y4m:
        # renderer encodes to the target's YUV repr; muxer subsamples
        target = Target(w=ow, h=oh, color=CSP_SRGB, bit_depth=8,
                        repr=ColorRepr(sys=ColorSystem.BT_709,
                                       levels=ColorLevels.LIMITED,
                                       bits=BitEncoding(8, 8, 0)))
    else:
        target = Target(w=ow, h=oh, color=CSP_SRGB, bit_depth=8)
    writer = png_dir = None
    if args.write_y4m:
        fr = args.vsync
        # 420jpeg: the box-average downsample sites chroma at the
        # center, which is exactly what the jpeg tag declares
        writer = Y4MWriter(args.write_y4m, ow, oh,
                           fps=(round(fr * 1001), 1001), csp="420jpeg")
    if args.write_png:
        png_dir = args.write_png
        os.makedirs(png_dir, exist_ok=True)

    n_vsyncs = min(int(args.frames / args.fps * args.vsync), 10 ** 9)
    kernels = {"k1": k1, "k2": k2, "k3": k3}
    launches0 = {n: m.launches for n, m in kernels.items()}
    # CUDA events at the start, after the first vsync (whose render plans
    # the pipeline) and at the end
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        synchronize(dev)
        events[0].record()
    state = {"rendered": 0, "out": None, "t0": time.perf_counter()}

    def render_vsync(vs):
        """One vsync of the playback loop; returns False at EOF.
        Reads opts.params fresh each call, so the --ui panel's edits
        take effect on the very next vsync (a changed config plans
        anew; unchanged ones reuse the cached plan)."""
        status, mix = queue.update(
            QueueParams(pts=vs / args.vsync, radius=1.0,
                        vsync_duration=1.0 / args.vsync),
            QueueMode.INTERPOLATE)
        if status != QueueStatus.OK:
            return False
        # aspect handling (reference demos/plplay.c:404-430): stretch
        # the source crop by the pixel aspect ratio, then zoom the
        # target crop around it
        ref_frame = mix.frames[0]
        if args.rotate:
            for mf in mix.frames:
                mf.rotation = Rotation(args.rotate // 90)
        if args.par:
            ref_frame.pixel_aspect_ratio = args.par
        sar = ref_frame.pixel_aspect_ratio
        crop = ref_frame.get_crop()
        if sar and args.zoom != "raw":
            crop = crop.stretch_xy(max(1.0, sar), max(1.0, 1.0 / sar))
        if args.rotate:
            # zoom math sees the displayed (rotated) aspect (reference
            # plplay.c:411 pl_rect2df_rotate)
            crop = crop.rotate(Rotation(args.rotate // 90)).normalized()
        full = RectF(0, 0, ow, oh)
        if args.zoom == "pad":
            tcrop = full.aspect_copy(crop, 0.0)
        elif args.zoom == "crop":
            tcrop = full.aspect_copy(crop, 1.0)
        elif args.zoom == "fit":
            tcrop = full.aspect_fit(crop, 0.0)
        elif args.zoom == "raw":
            tcrop = RectF(0, 0, crop.w, crop.h)
        else:                    # stretch: full target
            tcrop = full
        vt = target if tcrop == full else replace(target, crop=tcrop)
        out = render_image_mix(renderer, mix, vt, opts.params)
        if writer is not None:
            writer.write(out.cpu().numpy())
        if png_dir is not None:
            write_png(os.path.join(png_dir, f"vsync{vs:05d}.png"),
                      out.cpu().numpy())
        state["out"] = out
        state["rendered"] += 1
        if state["rendered"] == 1:
            state["t1"] = time.perf_counter()
            if events is not None:
                events[1].record()
        return True

    if args.ui:
        # live options panel (reference demos/settings.c): options
        # edited in the panel land in opts.params, which render_vsync
        # reads per vsync
        from .settings_ui import SettingsPanel, run_curses
        panel = SettingsPanel(opts)
        counter = iter(range(n_vsyncs))

        def tick():
            vs = next(counter, None)
            if vs is None:
                return None
            # interactive mode paces to the real vsync clock (the
            # non-UI loop free-runs for benchmarking); a late frame
            # renders immediately
            lag = state["t0"] + vs / args.vsync - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            if not render_vsync(vs):
                return None
            dt = time.perf_counter() - state["t0"]
            return (f"plplay {w}x{h}@{args.fps} -> {ow}x{oh}"
                    f"@{args.vsync}  vsync {vs}  "
                    f"{state['rendered'] / dt:.1f} fps")
        run_curses(panel, tick)
    else:
        for vs in range(n_vsyncs):
            if not render_vsync(vs):
                break
    rendered = state["rendered"]
    if events is not None:
        events[2].record()
    synchronize(dev)
    t_end = time.perf_counter()
    if writer is not None:
        writer.close()
    renderer.flush_telemetry()   # telemetry records one frame late
    dt = time.perf_counter() - state["t0"]
    launches = {n: m.launches - launches0[n] for n, m in kernels.items()}
    n1 = max(rendered - 1, 1)
    stats = {"rendered": rendered, "seconds": dt, "fps": rendered / dt,
             "host_ms_per_vsync": dt * 1e3 / max(rendered, 1),
             "event_ms_per_vsync": None, "launches": launches,
             # after the first vsync: the steady state
             "steady_host_ms_per_vsync": (t_end - state.get("t1", t_end))
             * 1e3 / n1, "steady_event_ms_per_vsync": None}
    if events is not None and rendered:
        stats["event_ms_per_vsync"] = \
            events[0].elapsed_time(events[2]) / rendered
        stats["steady_event_ms_per_vsync"] = \
            events[1].elapsed_time(events[2]) / n1

    n_src = decoded[0] if args.y4m else args.frames
    print(f"played {rendered} vsyncs ({n_src} source frames) "
          f"in {dt:.2f}s = {rendered / dt:.1f} fps")
    print(f"source {w}x{h} @ {args.fps} fps -> {ow}x{oh} @ {args.vsync} Hz"
          f"{' (HDR PQ->SDR)' if args.hdr else ''}")
    print("options:", opts.save() or "(defaults)")
    ev, ev1 = stats["event_ms_per_vsync"], stats["steady_event_ms_per_vsync"]
    print(f"kernels on {dev}: K1 {launches['k1']}, K2 {launches['k2']}, "
          f"K3 {launches['k3']} launches; a vsync "
          f"{stats['host_ms_per_vsync']:.3f} ms host-clocked ("
          f"{stats['steady_host_ms_per_vsync']:.3f} after the first), "
          + (f"{ev:.3f} ms CUDA events ({ev1:.3f} after the first)"
             if ev is not None else "CUDA events not measured (CPU)"))
    return stats


if __name__ == "__main__":
    main()

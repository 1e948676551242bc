#!/usr/bin/env python3
"""colors — minimal "make the output colorful" demo (reference:
demos/colors.c): each frame clears the target to an animated RGBA
color (including alpha). The reference drives a window swapchain; here
the "swapchain" is a sequence of tensors on the card, optionally
written to a .y4m clip so the animation can actually be watched.

Usage: python3 -m libplacebo_tpu_torch.demos.colors [--device cuda|cpu]
           [--cpu] [--frames N] [--size WxH] [--write-y4m out.y4m]
"""
import argparse
import math
import time

import torch

from . import add_device_args, device_from, synchronize


def main(argv=None):
    ap = argparse.ArgumentParser(prog="colors")
    add_device_args(ap)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="640x480", metavar="WxH")
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--write-y4m", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    dev = device_from(args)

    from ..render.renderer import Target, clear_target
    from ..utils.y4m import Y4MWriter

    w, h = (int(v) for v in args.size.lower().split("x"))
    target = Target(w=w, h=h)
    writer = None
    if args.write_y4m:
        writer = Y4MWriter(args.write_y4m, w, h, csp="444",
                           fps=(int(round(args.fps)), 1))

    period = 10.0  # seconds, as in colors.c
    t0 = time.perf_counter()
    for i in range(args.frames):
        secs = (i / args.fps) % period
        pos = 2 * math.pi * secs / period
        alpha = (math.cos(pos) + 1.0) / 2.0
        rgba = (alpha * (math.sin(2 * pos + 0.0) + 1.0) / 2.0,
                alpha * (math.sin(2 * pos + 2.0) + 1.0) / 2.0,
                alpha * (math.sin(2 * pos + 4.0) + 1.0) / 2.0,
                alpha)
        out = clear_target(target, rgba, device=dev)
        if writer is not None:
            # quick BT.601-ish full-range for the clip, on the render
            # device: float32 operations in the JAX demo's numpy order,
            # so the codes are the same bytes
            rgb = out[:3]
            luma = 0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]
            yuv = torch.stack([luma, (rgb[2] - luma) * 0.564 + 0.5,
                               (rgb[0] - luma) * 0.713 + 0.5])
            codes = torch.clamp(yuv * 255 + 0.5, 0, 255).to(torch.uint8)
            writer.write(codes.cpu().numpy())
    synchronize(dev)
    if writer is not None:
        writer.close()
        print(f"wrote {args.frames} frames to {args.write_y4m}")
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} fps)")
    return {"frames": args.frames, "seconds": dt}


if __name__ == "__main__":
    main()

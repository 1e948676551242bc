#!/usr/bin/env python3
"""video-filtering — offline filter-chain demo (reference:
demos/video-filtering.c): render-to-array usage without a display,
showing asynchronous dispatch (several frames enqueued on the card
before one synchronization).

With --input the chain runs on a real image (PNG/JPEG via PIL) or a
YUV4MPEG2 clip instead of synthetic noise; --output writes the result
(.png for stills, .y4m for clips).

Usage: python3 -m libplacebo_tpu_torch.demos.video_filtering
           [--device cuda|cpu] [--cpu]
           [--input in.png|in.y4m] [--output out.png|out.y4m]
           [--out WxH]
"""
import argparse
import time

import numpy as np

from . import add_device_args, device_from, synchronize

# a warm-look 3D LUT, an in-memory .cube
WARM_CUBE = """LUT_3D_SIZE 2
0 0 0
1 0.05 0
0 0.95 0
1 1 0
0 0.05 0.9
1 0.1 0.9
0 1 0.9
1 1 0.92
"""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="video_filtering")
    add_device_args(ap)
    ap.add_argument("--input", default=None, metavar="FILE")
    ap.add_argument("--output", default=None, metavar="FILE")
    ap.add_argument("--out", default=None, metavar="WxH",
                    help="output size (default: 2x the input)")
    args = ap.parse_args(argv)
    dev = device_from(args)

    from ..core.colorspace import CSP_SRGB
    from ..core.lut import parse_cube
    from ..ops.deband import DebandParams
    from ..render.frame import frame_from_rgb
    from ..render.renderer import Renderer, RenderParams, Target

    rng = np.random.default_rng(0)
    renderer = Renderer(device=dev)
    params = RenderParams(
        deband=DebandParams(iterations=2),
        lut=parse_cube(WARM_CUBE), lut_type="conversion",
        upscaler="ewa_lanczossharp",
        peak_detect=None)
    # assemble input frames: real file via utils.y4m, or synthetic
    frames = []
    if args.input and args.input.endswith(".y4m"):
        from ..utils.y4m import Y4MReader
        with Y4MReader(args.input, device=dev) as reader:
            frames = list(reader)
    elif args.input:
        from ..utils.y4m import read_png
        frames = [frame_from_rgb(read_png(args.input)[:3], color=CSP_SRGB,
                                 device=dev)]
    else:
        for i in range(8):
            img = rng.random((144, 256, 3)).astype(np.float32)
            frames.append(frame_from_rgb(img, color=CSP_SRGB, device=dev))
    in_w, in_h = frames[0].w, frames[0].h
    if args.out:
        ow, oh = map(int, args.out.split("x"))
    else:
        ow, oh = 2 * in_w, 2 * in_h
    target = Target(w=ow, h=oh, color=CSP_SRGB, bit_depth=8)

    # asynchronous processing: enqueue the batch, synchronize once (the
    # reference demo's async download path)
    t0 = time.perf_counter()
    outs = [renderer.render(f, target, params) for f in frames]
    synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"filtered {len(frames)} frames {in_w}x{in_h} -> {ow}x{oh} "
          f"(deband + EWA upscale + 3DLUT + dither) in {dt:.2f}s")
    result = outs[-1].cpu().numpy()
    print("output:", result.shape, "range",
          round(float(result.min()), 3), round(float(result.max()), 3))

    if args.output and args.output.endswith(".y4m"):
        # re-encode the filtered RGB to 4:2:0 YUV for the muxer
        from ..core.colorspace import (BitEncoding, ColorLevels, ColorRepr,
                                       ColorSystem)
        from ..ops.color import encode_color
        from ..utils.y4m import Y4MWriter
        yuv_repr = ColorRepr(sys=ColorSystem.BT_709,
                             levels=ColorLevels.LIMITED,
                             bits=BitEncoding(8, 8, 0))
        with Y4MWriter(args.output, ow, oh, csp="420jpeg") as wr:
            for o in outs:
                wr.write(encode_color(o, yuv_repr).cpu().numpy())
        print("wrote", args.output)
    elif args.output:
        from ..utils.y4m import write_png
        write_png(args.output, result)
        print("wrote", args.output)
    return {"frames": len(frames), "seconds": dt, "shape": result.shape}


if __name__ == "__main__":
    main()

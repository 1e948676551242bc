#!/usr/bin/env python3
"""image-viewer — still-image rendering demo (reference:
demos/sdlimage.c): load a picture, upload it through the packed
bit-mask plane path (pl_plane_data_from_mask analog), and render it
with the high-quality preset onto a sized target on the card —
optionally through a display ICC profile, a .cube color LUT, and with
an OSD overlay composited in the corner.

This is the offline analog of the reference's SDL window viewer: the
"swapchain frame" is simply an output tensor written to a PNG.

Usage: python3 -m libplacebo_tpu_torch.demos.image_viewer IMAGE
           [--device cuda|cpu] [--cpu]
           [--osd OSD.png] [--icc PROFILE.icc] [--lut LUT.cube]
           [--out WxH] [--output out.png]
"""
import argparse
import os
from dataclasses import replace

import numpy as np
import torch

from . import add_device_args, device_from


def load_image(path):
    """Load PNG via the built-in reader, anything else via PIL if
    present. Returns uint8 (H, W, 3|4)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        from ..utils.y4m import read_png
        arr = read_png(path)            # planar float32 [0,1]
        arr = np.moveaxis(arr, 0, -1)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(f"need PIL to read {ext} files (PNG works "
                         "without it)")
    return np.asarray(Image.open(path).convert("RGBA"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="image_viewer")
    ap.add_argument("image", help="input picture (PNG; JPEG w/ PIL)")
    add_device_args(ap)
    ap.add_argument("--osd", default=None, metavar="FILE",
                    help="OSD picture overlaid in the top-left corner")
    ap.add_argument("--icc", default=None, metavar="FILE",
                    help="display ICC profile applied on output")
    ap.add_argument("--lut", default=None, metavar="FILE",
                    help=".cube LUT applied as a conversion LUT")
    ap.add_argument("--out", default="1280x720", metavar="WxH")
    ap.add_argument("--output", default=None, metavar="FILE",
                    help="output PNG (default: <image>.out.png)")
    args = ap.parse_args(argv)
    dev = device_from(args)

    from ..core.colorspace import (CSP_SRGB, AlphaMode, ColorLevels,
                                   ColorRepr, ColorSystem)
    from ..core.common import RectF
    from ..render.frame import Frame, Overlay, OverlayPart
    from ..render.renderer import HIGH_QUALITY_PARAMS, Renderer, Target
    from ..utils.upload import PlaneData, plane_data_from_mask, upload_plane
    from ..utils.y4m import write_png

    rgb = load_image(args.image)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    if rgb.shape[-1] == 3:
        rgb = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255,
                                           np.uint8)], axis=-1)
    h, w = rgb.shape[:2]

    # Pack into 32-bit RGBA words and describe them by bit masks —
    # exactly how the reference ingests an SDL_Surface
    # (demos/sdlimage.c:100-129 → pl_plane_data_from_mask).
    words = (rgb[..., 0].astype(np.uint32)
             | (rgb[..., 1].astype(np.uint32) << 8)
             | (rgb[..., 2].astype(np.uint32) << 16)
             | (rgb[..., 3].astype(np.uint32) << 24))
    size, pad, cmap = plane_data_from_mask(
        [0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000])
    plane = upload_plane(PlaneData(data=words, component_map=cmap,
                                   component_size=size, component_pad=pad),
                         device=dev)
    image = Frame(planes=[plane], color=CSP_SRGB,
                  repr=ColorRepr(sys=ColorSystem.RGB,
                                 levels=ColorLevels.FULL,
                                 alpha=AlphaMode.INDEPENDENT))

    if args.osd:
        osd_rgba = load_image(args.osd)
        if osd_rgba.shape[-1] == 3:
            osd_rgba = np.concatenate(
                [osd_rgba, np.full(osd_rgba.shape[:2] + (1,), 255,
                                   np.uint8)], axis=-1)
        oh, ow = osd_rgba.shape[:2]
        osd_data = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            osd_rgba.astype(np.float32) / 255.0, -1, 0))).to(dev)
        # top-left corner, native size, in target coordinates
        # (sdlimage.c:158-176 uses PL_OVERLAY_COORDS_DST_FRAME)
        image = Frame(planes=image.planes, color=image.color,
                      repr=image.repr, overlays=(Overlay(
                          data=osd_data, coords="dst_frame",
                          color=CSP_SRGB,
                          parts=(OverlayPart(
                              src=RectF(0, 0, float(ow), float(oh)),
                              dst=RectF(16, 16, 16 + ow, 16 + oh)),)),))

    ow_, oh_ = (int(v) for v in args.out.lower().split("x"))
    icc = None
    if args.icc:
        from ..core.icc import parse_icc
        with open(args.icc, "rb") as f:
            icc = parse_icc(f.read())
    # letterbox the image into the target, preserving aspect
    # (sdlimage.c:156 pl_rect2df_aspect_copy_rot)
    target = Target(w=ow_, h=oh_, color=CSP_SRGB, bit_depth=8, icc=icc,
                    crop=RectF(0, 0, float(ow_), float(oh_)).aspect_copy(
                        RectF(0, 0, float(w), float(h))))

    params = HIGH_QUALITY_PARAMS
    if args.lut:
        from ..core.lut import parse_cube
        with open(args.lut) as f:
            params = replace(params, lut=parse_cube(f.read()),
                             lut_type="conversion")

    out = Renderer(device=dev).render(image, target, params)
    out8 = np.clip(out.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    out_path = args.output or os.path.splitext(args.image)[0] + ".out.png"
    write_png(out_path, np.moveaxis(out8, 0, -1))
    print(f"rendered {w}x{h} -> {ow_}x{oh_}: {out_path}")
    return out_path


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Stage ablations of the flagship pipeline on the card.

Renders the flagship (1080p 8-bit PQ yuv420p -> 3840x2160 sRGB, EWA
Lanczos, peak detection, spline + perceptual on K1, blue-noise dither)
through `Renderer.render` with one stage at a time switched off or
swapped, `n_frames` frames back to back between two CUDA events after
two warm-up frames.  The delta against the full pipeline is each
stage's marginal cost.  A variant that fails is printed with its error
and the run exits 1 at the end.

Usage: python3 -m libplacebo_tpu_torch.tools.profile_stages [n_frames]
           [--size WxH] [--device cuda|cpu] [--cpu]
"""
import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ..demos import (add_device_args, device_from, flagship_frames,
                     synchronize)


def build(w: int, h: int, target_bits: int, dev):
    from ..core.colorspace import CSP_SRGB
    from ..render.renderer import Renderer, Target
    frame = flagship_frames(np.random.default_rng(0), 1, h, w, dev)[0]
    target = Target(w=2 * w, h=2 * h, color=CSP_SRGB, bit_depth=target_bits)
    return Renderer(device=dev), frame, target


def time_frames(r, frame, target, params, n: int, dev) -> float:
    """ms a frame: two warm-up renders, then n back to back between two
    CUDA events (the host clock on the CPU)."""
    for _ in range(2):
        r.render(frame, target, params)
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            r.render(frame, target, params)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        r.render(frame, target, params)
    return (time.perf_counter() - t0) * 1e3 / n


def variants():
    from ..render.renderer import RenderParams
    full = RenderParams(upscaler="ewa_lanczos")
    return [
        ("full", full, 8),
        ("no_peak", replace(full, peak_detect=None), 8),
        ("gamut_clip", replace(full, gamut_mapping="clip"), 8),
        ("gamut_none", replace(full, gamut_mapping="none"), 8),
        ("no_dither", full, 0),
        ("no_antiring", replace(full, antiringing_strength=0.0), 8),
        ("bilinear", replace(full, upscaler="bilinear"), 8),
        ("separable_lanczos", replace(full, upscaler="lanczos"), 8),
        ("no_linear", replace(full, disable_linear_scaling=True), 8),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_stages")
    ap.add_argument("n_frames", type=int, nargs="?", default=50)
    ap.add_argument("--size", default="1920x1080", metavar="WxH",
                    help="source size; the target is twice as wide and "
                         "high")
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev = device_from(args)
    w, h = (int(v) for v in args.size.lower().split("x"))

    results, failed = {}, {}
    base_ms = None
    for name, params, bits in variants():
        try:
            r, frame, target = build(w, h, bits, dev)
            ms = time_frames(r, frame, target, params, args.n_frames, dev)
        except Exception as e:          # noqa: BLE001 - recorded, exit 1
            failed[name] = f"{type(e).__name__}: {e}"
            print(f"{name:20s} FAILED: {failed[name]}", flush=True)
            continue
        results[name] = ms
        if name == "full":
            base_ms = ms
        delta = "" if base_ms is None or name == "full" else \
            f"  (delta {base_ms - ms:+.3f} ms)"
        print(f"{name:20s} {ms:8.3f} ms/frame  {1e3 / ms:6.1f} fps{delta}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""K1 (the fused colour tail: tone and gamut mapping, delinearize,
encode, blue-noise dither) counted as the plain chain of a
configuration's tail needs it.  The counts are frozen in the
configuration's file, so that the yardstick stays the same whatever
implements the tail, and a configuration added later brings its own:

- `k1_ops_per_pixel`: FP32 operations a pixel of the tail;
- `k1_bytes_per_pixel`: bytes read and written a pixel;
- `k1_bytes_per_frame`: bytes read once a frame (the dither matrix).

`tests/test_fb_counts.py` holds each against the program's own count
(`ops.cuda.color_map.ops_per_pixel`) at the commit it was frozen at.
"""
from __future__ import annotations

KEYS = ("k1_ops_per_pixel", "k1_bytes_per_pixel", "k1_bytes_per_frame")


def counts(config: dict):
    """(FP32 operations, bytes) of one frame's tail, or None where the
    configuration has no frozen count."""
    if not all(k in config for k in KEYS):
        return None
    pixels = config["target"]["w"] * config["target"]["h"]
    return (config["k1_ops_per_pixel"] * pixels,
            config["k1_bytes_per_pixel"] * pixels
            + config["k1_bytes_per_frame"])


def least_seconds(config: dict, peaks: dict):
    """The least time one frame's tail could take on a device with these
    peaks: the larger of operations over peak FLOP/s and bytes over peak
    bandwidth, or None."""
    c = counts(config)
    if c is None:
        return None
    ops, nbytes = c
    return max(ops / peaks["fp32_flop_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])

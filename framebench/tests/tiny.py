"""A checkout in miniature for the CPU tests: BENCHMARK.json and a copy
of framebench/ whose configurations and traffic are cut to a few
thousand pixels (same chains, same kinds of source and display), with
the program linked in from the repository."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

# (source width, height) of each mix and (width, height) of each display
# (the 4K mix at the player's display size and twice the transcoder's,
# as at full size)
SOURCES = {"hdr10_1080p": (128, 64), "hdr10_2160p": (256, 128)}
TARGETS = {"mpv_ewa_hdr10_to_sdr4k": (256, 128),
           "ffmpeg_hdr10_4k_to_sdr1080p": (128, 64)}


def make(dst: str) -> str:
    """Build the miniature checkout under `dst`; returns its root."""
    root = os.path.join(dst, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "framebench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "libplacebo_tpu_torch"),
               os.path.join(root, "libplacebo_tpu_torch"))
    for mix, (w, h) in SOURCES.items():
        p = os.path.join(root, "framebench", "traffic", mix + ".json")
        t = json.load(open(p))
        t.update(width=w, height=h)
        json.dump(t, open(p, "w"))
    for cfg, (w, h) in TARGETS.items():
        p = os.path.join(root, "framebench", "configs", cfg + ".json")
        c = json.load(open(p))
        c["target"].update(w=w, h=h)
        json.dump(c, open(p, "w"))
    return root

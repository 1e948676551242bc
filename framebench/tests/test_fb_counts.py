"""The frozen K1 counts behind k1_roofline_pct, which each configuration's
file holds, equal the program's own count
(`ops.cuda.color_map.ops_per_pixel`) for its tail at the commit they
were frozen at, and nothing the benchmark runs calls the program's
count."""
import ast
import json
import os

import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core.colorspace import color_space_infer_map
from libplacebo_tpu_torch.core.common import RectF
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.utils import interop
from framebench.counts import k1 as counts
from framebench.harness import deploy

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "configs"))
                 if f.endswith(".json"))


def _program_ops(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    av = dict(cfg["source_frame"])
    av["data"] = [np.full((16, 16), 300, np.uint16),
                  np.full((8, 8), 512, np.uint16),
                  np.full((8, 8), 512, np.uint16)]
    frame = interop.frame_from_avframe_like(av, device="cpu")
    d = deploy.Deployment(lt, cfg, None, torch.device("cpu"), 0)
    t = d.target
    src, dst = color_space_infer_map(frame.color, t.color)
    tail = d.renderer._fused_tail(d.params, src, dst, t, True, t.w, t.h,
                                  RectF(0, 0, t.w, t.h))
    return cfg, k1.ops_per_pixel(tail.plan.consts, tail.plan.instance)


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_counts_are_the_programs(name):
    """Each configuration's file holds its tail's frozen counts: the
    program's operations a pixel, the float32 frame read and written
    once (24 bytes a pixel) and the 64x64 float32 dither matrix."""
    cfg, ops = _program_ops(name)
    assert cfg["k1_ops_per_pixel"] == ops
    n_ops, n_bytes = counts.counts(cfg)
    px = cfg["target"]["w"] * cfg["target"]["h"]
    assert n_ops == ops * px and n_bytes == 24 * px + 64 * 64 * 4


def test_least_time_is_the_larger_bound():
    cfg = {"k1_ops_per_pixel": 1180, "k1_bytes_per_pixel": 24,
           "k1_bytes_per_frame": 16384, "target": {"w": 3840, "h": 2160}}
    peaks = {"fp32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    t = counts.least_seconds(cfg, peaks)
    assert t == pytest.approx(1180 * 3840 * 2160 / 67e12)
    cheap = dict(cfg, k1_ops_per_pixel=10)
    assert counts.least_seconds(cheap, peaks) == pytest.approx(
        (24 * 3840 * 2160 + 16384) / 3.35e12)
    assert counts.least_seconds({"target": {"w": 1, "h": 1}}, peaks) \
        is None


def test_nothing_calls_the_programs_count():
    for d, _, files in os.walk(BENCH):
        if os.path.basename(d) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                names = {n.attr for n in ast.walk(tree)
                         if isinstance(n, ast.Attribute)} | \
                    {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
                assert "ops_per_pixel" not in names, f

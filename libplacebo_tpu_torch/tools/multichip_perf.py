#!/usr/bin/env python3
"""Collective traffic of the port's sharded render step on a
(data, spatial) mesh, 2 x 4 by default.

Builds the sharded step (parallel/renderer.py) for several configs,
runs it once per config under the collective recorder
(parallel.analysis.collective_stats) and writes each config's
collectives — counts, total and largest bytes on rank 0 — as JSON.  The
halo pipeline's traffic must stay O(halo), never a frame-sized gather
(the reference's multigpu-bench measures the transfers between cards,
demos/multigpu-bench.c).

Configs:
  flagship             halo step: EWA 2x + peak + tone/gamut + dither
  flagship+deband      the same with deband's row halos
  hooks_halo           a bounded-stencil user hook (3x3 sharpen)
  hooks_compute_halo   a shared-tile //!COMPUTE sharpen
  hooks_temporal_halo  cross-frame state (a STORAGE texture EMA and a
                       STORAGE buffer counter)

Where the ranks come from: on the card (the default; raises without a
GPU) one process a card, under torchrun (`torchrun --nproc-per-node 8 -m
libplacebo_tpu_torch.tools.multichip_perf`; the world must be data x
spatial) or alone with `--mesh 1x1`; with `--cpu` or `--device cpu`,
data x spatial gloo ranks on the CPU, spawned here.

Usage: python3 -m libplacebo_tpu_torch.tools.multichip_perf
           [--device cuda|cpu] [--cpu] [--mesh DxS]
           [--out multichip_perf_torch.json]
"""
import argparse
import json
import sys

import numpy as np

from ..demos import add_device_args, flagship_frames, on_ranks


SHARPEN_HOOK = (
    "//!HOOK LUMA\n//!BIND HOOKED\n"
    "vec4 hook() {\n"
    "    vec4 c = HOOKED_texOff(vec2(0.0, 0.0));\n"
    "    vec4 l = HOOKED_texOff(vec2(-1.0, 0.0));\n"
    "    vec4 r = HOOKED_texOff(vec2(1.0, 0.0));\n"
    "    vec4 u = HOOKED_texOff(vec2(0.0, -1.0));\n"
    "    vec4 d = HOOKED_texOff(vec2(0.0, 1.0));\n"
    "    return c + 0.25 * (4.0 * c - l - r - u - d);\n"
    "}\n")

COMPUTE_TILE_HOOK = """//!HOOK LUMA
//!BIND HOOKED
//!DESC test compute sharpen
//!COMPUTE 16 8
#define SW 18
shared float tile[180];
void hook() {
    ivec2 base = ivec2(gl_WorkGroupID.xy) * ivec2(16, 8) - ivec2(1, 1);
    for (uint id = gl_LocalInvocationIndex; id < 180u; id += 128u) {
        ivec2 rel = ivec2(int(id) % SW, int(id) / SW);
        tile[int(id)] =
            HOOKED_tex((vec2(base + rel) + vec2(0.5)) * HOOKED_pt).x;
    }
    barrier();
    int c = (int(gl_LocalInvocationID.y) + 1) * SW
            + int(gl_LocalInvocationID.x) + 1;
    float lap = 4.0 * tile[c] - tile[c-1] - tile[c+1]
              - tile[c-SW] - tile[c+SW];
    vec4 px = HOOKED_texOff(0);
    imageStore(out_image, ivec2(gl_GlobalInvocationID.xy),
               vec4(px.x + 0.25 * lap, px.yzw));
}
"""

TEMPORAL_EMA_HOOK = """\
//!TEXTURE ACC
//!SIZE {w} {h}
//!FORMAT rgba32f
//!STORAGE

//!BUFFER st
//!STORAGE
//!VAR float frames

//!HOOK MAIN
//!BIND HOOKED
//!BIND ACC
//!DESC temporal EMA accumulator
//!COMPUTE 8 8
void hook()
{{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = HOOKED_texOff(0);
    vec4 prev = imageLoad(ACC, pos);
    vec4 ema = (frames < 0.5) ? c : (0.3 * c + 0.7 * prev);
    imageStore(ACC, pos, ema);
    imageStore(out_image, pos, ema);
}}

//!HOOK MAIN
//!BIND HOOKED
//!DESC frame counter bump
vec4 hook()
{{
    frames = frames + 1.0;
    return HOOKED_texOff(0);
}}
"""


def configs(src_w: int, src_h: int) -> dict:
    from ..ops.deband import DebandParams
    from ..ops.peak_detect import PeakDetectParams
    from ..render.mpv_hooks import parse_user_shader, user_shader_hook
    from ..render.renderer import RenderParams
    sharpen = user_shader_hook(parse_user_shader(SHARPEN_HOOK))
    compute_tile = user_shader_hook(parse_user_shader(COMPUTE_TILE_HOOK))
    temporal = user_shader_hook(TEMPORAL_EMA_HOOK.format(w=src_w, h=src_h))
    peak = PeakDetectParams(percentile=99.5)
    return {
        "flagship": RenderParams(upscaler="ewa_lanczos", peak_detect=peak),
        "flagship+deband": RenderParams(upscaler="ewa_lanczos",
                                        peak_detect=peak,
                                        deband=DebandParams()),
        "hooks_halo": RenderParams(upscaler="lanczos", hooks=(sharpen,),
                                   peak_detect=None),
        "hooks_compute_halo": RenderParams(
            upscaler="lanczos", hooks=(compute_tile,), peak_detect=None),
        "hooks_temporal_halo": RenderParams(
            upscaler="lanczos", hooks=(temporal,), peak_detect=None),
    }


def shape(data: int, spatial: int):
    src_h, src_w = 64 * spatial, 192          # 2x4: 256x192 -> 512x384
    return src_h, src_w, 2 * src_h, 2 * src_w, 2 * data


def _rank(rank, world, device, data, spatial):
    """Every config's collectives on this rank, one rank a process."""
    import torch
    from ..core.colorspace import CSP_SRGB
    from ..parallel import (build_sharded_pipeline, make_mesh, shard_planes,
                            sharded_state_init)
    from ..parallel.analysis import collective_stats
    from ..render.renderer import Target

    if world != data * spatial:
        raise ValueError(f"multichip_perf: a {data}x{spatial} mesh needs "
                         f"{data * spatial} ranks, not {world} (on the card "
                         "start one process a card with torchrun, or pass "
                         "--mesh 1x1)")
    mesh = make_mesh(data, spatial, device=device)
    src_h, src_w, dst_h, dst_w, batch = shape(data, spatial)
    frames = flagship_frames(np.random.default_rng(0), batch, src_h, src_w,
                             mesh.device)
    f0 = frames[0]
    target = Target(w=dst_w, h=dst_h, color=CSP_SRGB, bit_depth=8)
    xs = shard_planes(mesh, [torch.stack([f.planes[i].data for f in frames])
                             for i in range(len(f0.planes))])
    out = {}
    for name, params in configs(src_w, src_h).items():
        step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                      f0.color, target, params)
        state = sharded_state_init(mesh, batch)
        out[name] = {"route": step.route,
                     "stats": collective_stats(step, state, *xs)}
    dev = str(mesh.device)
    mesh.close()
    return {"device": dev, "configs": out}


def run(args, data: int, spatial: int):
    """The artifact's dict: rank 0's collectives a config (None on the
    other ranks)."""
    src_h, src_w, dst_h, dst_w, batch = shape(data, spatial)
    rank0 = on_ranks(_rank, args, data * spatial, data, spatial)
    if rank0 is None:
        return None
    frame_bytes = 3 * dst_h * dst_w * 4
    backend = "gloo (CPU)" if rank0["device"] == "cpu" else "NCCL"
    return {"mesh": {"data": data, "spatial": spatial},
            "shape": {"src": [src_h, src_w], "dst": [dst_h, dst_w],
                      "batch": batch, "local_rows": src_h // spatial,
                      "dst_frame_bytes": frame_bytes},
            "device": rank0["device"],
            "collectives": f"{backend}, recorded by parallel/comm.py",
            "configs": {n: c["stats"] for n, c in rank0["configs"].items()},
            "routes": {n: c["route"] for n, c in rank0["configs"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip_perf")
    add_device_args(ap)
    ap.add_argument("--mesh", default="2x4", metavar="DxS",
                    help="data x spatial ranks (default 2x4)")
    ap.add_argument("--out", default="multichip_perf_torch.json",
                    metavar="FILE")
    args = ap.parse_args(argv)
    data, spatial = (int(v) for v in args.mesh.lower().split("x"))
    res = run(args, data, spatial)
    if res is None:                     # a torchrun rank other than 0
        return 0
    frame_bytes = res["shape"]["dst_frame_bytes"]
    for name, stats in res["configs"].items():
        total = sum(s["total_bytes"] for s in stats.values())
        print(f"{name} ({res['routes'][name]} step): {json.dumps(stats)}")
        print(f"  total collective bytes/rank: {total} "
              f"({total / frame_bytes:.2f}x one dst frame)")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

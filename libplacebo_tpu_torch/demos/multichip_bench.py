#!/usr/bin/env python3
"""multichip-bench — multi-device frame pipeline benchmark (reference:
demos/multigpu-bench.c, which measures cross-GPU frame transfer paths).

Measures the FULL renderer sharded over a ('data', 'spatial') mesh of
torch.distributed ranks (parallel/renderer.py): YUV merge -> decode ->
EWA scale [row halos between ring neighbors] -> peak histogram
[all-reduce] -> tone -> gamut -> encode -> dither, per mesh shape.  Each
shape's first call is held against the single-device Renderer on the
same frames (within one LSB on <= 1e-4 of the values, none beyond).

Where the ranks come from:
  - under torchrun (one process a card): the group its environment
    describes, `cuda:{LOCAL_RANK}` each;
  - alone: the one-rank mesh of `GpuContext().make_mesh()` (NCCL on the
    card; NCCL cannot put two ranks on one card);
  - `--ranks N`: N gloo ranks on the CPU, spawned here.

Usage: python3 -m libplacebo_tpu_torch.demos.multichip_bench
           [--ranks N] [--size WxH] [--iters N] [--device cuda|cpu] [--cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from . import (add_device_args, device_from, flagship_frames, run_ranks,
               synchronize)

LSB = 1.0 / 255.0


def configs_for(n: int):
    if n >= 8:
        return [(1, 8), (2, 4), (4, 2), (8, 1)]
    if n >= 2:
        return [(1, n), (n, 1)]
    return [(1, 1)]


def halo_gate(out: torch.Tensor, ref: torch.Tensor):
    """Values more than 1e-5 apart on at most 1e-4 of them, each such one
    exactly one LSB apart; returns (largest difference, fraction)."""
    diff = (out.float() - ref.float()).abs()
    bad = diff > 1e-5
    frac = float(bad.float().mean())
    mx = float(diff.max())
    if frac > 1e-4 or (bad.any() and
                       float((diff[bad] - LSB).abs().max()) > 1e-6):
        raise AssertionError(f"sharded output vs single device: max "
                             f"{mx:.3e}, {frac:.3e} of the values differ")
    return mx, frac


def bench(mesh, w: int, h: int, iters: int, rng) -> dict:
    """One mesh shape: a batch of 2 x data frames, the step's first call
    held against the single-device Renderer, then `iters` calls timed.
    Every rank of the mesh calls it; every rank returns the row."""
    from ..core.colorspace import CSP_SRGB
    from ..ops.peak_detect import PeakDetectParams
    from ..parallel import (build_sharded_pipeline, gather_rows,
                            shard_planes, sharded_state_init)
    from ..render.renderer import RenderParams, Renderer, Target

    dev = mesh.device
    data, spatial = mesh.data, mesh.spatial
    # round the row count so every shard gets whole 16-row tiles
    quantum = max(spatial * 32, 32)
    sh = (h + quantum - 1) // quantum * quantum
    batch = 2 * data

    frames = flagship_frames(rng, batch, sh, w, dev)

    target = Target(w=2 * w, h=2 * sh, color=CSP_SRGB, bit_depth=8)
    params = RenderParams(upscaler="ewa_lanczos",
                          peak_detect=PeakDetectParams(percentile=99.5))
    f0 = frames[0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, target, params)
    xs = shard_planes(mesh, [torch.stack([f.planes[i].data for f in frames])
                             for i in range(len(f0.planes))])
    state = sharded_state_init(mesh, batch)

    out, state2 = step(state, *xs)
    whole = gather_rows(mesh, out, target.h)
    mx = frac = 0.0
    for b, f in enumerate(frames):
        ref = Renderer(device=dev).render(f, target, params)
        m, fr = halo_gate(whole[b], ref)
        mx, frac = max(mx, m), max(frac, fr)
    del whole
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        out, state2 = step(state2, *xs)
    if dev.type == "cuda":
        end.record()
    synchronize(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters if dev.type == "cuda" else host_ms
    return {"data": data, "spatial": spatial, "src": [sh, w],
            "dst": [2 * sh, 2 * w], "batch": batch, "route": step.route,
            "ms_per_batch": ms, "host_ms_per_batch": host_ms,
            "frames_per_s": batch / ms * 1e3, "max_diff": mx,
            "frac_differing": frac}


def run(world: int, w: int, h: int, iters: int, device) -> list:
    """Every mesh shape of `world` ranks, on this rank, each mesh from
    `GpuContext.make_mesh` (a one-rank group of its own when no process
    group is up and the world is one)."""
    from ..runtime import create
    ctx = create(device=device)
    rng = np.random.default_rng(0)
    rows = []
    for data, spatial in configs_for(world):
        mesh = ctx.make_mesh(data, spatial)
        rows.append(bench(mesh, w, h, iters, rng))
        mesh.close()
    return rows


def _rank(rank, world, w, h, iters):
    return run(world, w, h, iters, "cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="multichip_bench")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run N gloo ranks on the CPU, spawned here")
    ap.add_argument("--size", default="512x288")
    ap.add_argument("--iters", type=int, default=20)
    add_device_args(ap)
    args = ap.parse_args(argv)
    w, h = map(int, args.size.split("x"))

    if args.ranks:
        world = args.ranks
        rows = run_ranks(_rank, world, w, h, args.iters)[0]
        kind = "CPU (gloo)"
    else:
        dev = device_from(args)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rows = run(world, w, h, args.iters, dev)
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "CPU")
        if int(os.environ.get("RANK", "0")):
            return rows
    print(f"devices: {world} x {kind}")
    for r in rows:
        sh, w_ = r["src"]
        print(f"mesh data={r['data']} spatial={r['spatial']}: "
              f"{r['ms_per_batch']:7.2f} ms/batch = "
              f"{r['frames_per_s']:7.1f} frames/s "
              f"({sh}x{w_} -> {2 * sh}x{2 * w_}, full pipeline, "
              f"{r['route']} step; vs one device: max "
              f"{r['max_diff']:.2e}, {r['frac_differing']:.1e} differ)")
    return rows


if __name__ == "__main__":
    main()

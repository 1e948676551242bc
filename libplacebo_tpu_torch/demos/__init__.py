"""The port's demo programs, run as modules:

    python3 -m libplacebo_tpu_torch.demos.plplay --hdr ...
    python3 -m libplacebo_tpu_torch.demos.video_filtering ...
    python3 -m libplacebo_tpu_torch.demos.image_viewer IMAGE ...
    python3 -m libplacebo_tpu_torch.demos.colors ...
    python3 -m libplacebo_tpu_torch.demos.multichip_bench ...

Each `main(argv)` renders on the card (`--device cuda`, the default, which
raises without a GPU) unless given `--device cpu` or `--cpu`.  This module
holds what the demos and the tools share: the device flags, the
flagship's seeded source frames and a runner for gloo ranks on the CPU.
"""
from __future__ import annotations

import json
import os
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["add_device_args", "device_from", "synchronize",
           "flagship_frames", "run_ranks", "on_ranks"]


def add_device_args(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; "
                         "raises without a GPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="same as --device cpu (the kernels' plain "
                         "PyTorch versions)")


def device_from(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else args.device)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flagship_frames(rng, n: int, h: int, w: int, device) -> list:
    """n frames of the flagship's source drawn from `rng`: 8-bit limited
    BT.2020-NC PQ yuv420p noise, on `device`."""
    from ..core.colorspace import (BitEncoding, ColorLevels, ColorRepr,
                                   ColorSystem, CSP_BT2100_PQ)
    from ..render.frame import frame_from_yuv420p
    frames = []
    for _ in range(n):
        y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
        u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        frames.append(frame_from_yuv420p(
            y, u, v, color=CSP_BT2100_PQ, device=device,
            repr=ColorRepr(sys=ColorSystem.BT_2020_NC,
                           levels=ColorLevels.LIMITED,
                           bits=BitEncoding(8, 8, 0))))
    return frames


def _rank_main(rank, world, init_file, workdir, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        res = {"ok": fn(rank, world, *args)}
    except Exception:           # noqa: BLE001 - reported to the parent
        res = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def run_ranks(fn, world: int, *args) -> list:
    """Run `fn(rank, world, *args)` on `world` gloo ranks on the CPU, one
    process each, joined through a file store (no network); returns each
    rank's JSON-able result in rank order.  A rank's exception is raised
    here with its traceback.  `fn` must be importable (a module-level
    function), since the ranks are spawned."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as workdir:
        init_file = os.path.join(workdir, "store")
        mp.spawn(_rank_main, args=(world, init_file, workdir, fn, args),
                 nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank_{r}.json")) as f:
                results.append(json.load(f))
    errors = [f"rank {r}:\n{res['error']}" for r, res in enumerate(results)
              if "error" in res]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [res["ok"] for res in results]


def on_ranks(fn, args, cpu_world: int, *fargs):
    """Run `fn(rank, world, device, *fargs)` on every rank of the mesh
    the caller asked for, and return rank 0's result (None on the other
    ranks):
      - `--ranks N`, `--device cpu` or `--cpu`: N (default `cpu_world`)
        gloo ranks on the CPU, spawned here (`run_ranks`), `device` "cpu";
      - else the card (raises without a GPU): this process is one rank on
        `cuda:{LOCAL_RANK}` — under torchrun (one process a card) of the
        NCCL group its environment describes, alone the only rank of a
        one-rank NCCL group (`parallel.make_mesh`); `device` "cuda".
    `fn` makes its mesh with `make_mesh(..., device=device)` and closes
    it; a torchrun group is destroyed here once `fn` returns."""
    import torch.distributed as dist
    ranks = getattr(args, "ranks", None)
    if ranks or device_from(args).type == "cpu":
        return run_ranks(fn, ranks or cpu_world, "cpu", *fargs)[0]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    try:
        out = fn(rank, world, "cuda", *fargs)
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()
    return out if rank == 0 else None

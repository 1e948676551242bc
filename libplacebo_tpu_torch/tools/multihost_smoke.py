#!/usr/bin/env python3
"""Multi-host smoke test of the port: the flagship's sharded pipeline
over OS processes joined in one torch.distributed group over TCP.

The mapping of the reference's multi-GPU frame hand-off
(demos/multigpu-bench.c) to several hosts puts the mesh's 'data' axis
across hosts: each host renders its own frames, and in the steady state
nothing crosses between them.  Each process is a rank on the data axis
(a mesh of data N x spatial 1) and renders a batch of 4 frames of the
global 4 N; process 0 gathers the outputs and holds every frame against
the single-device Renderer on its own device, exactly.

On the card (the default; raises without a GPU) the group is NCCL and
each process renders on its own card; with `--cpu` or `--device cpu` it
is gloo and the processes render on the CPU.

Usage:
    # one machine: spawns --procs processes (default 2) joined over
    # 127.0.0.1, process i on cuda:i (needs that many cards) or the CPU
    python3 -m libplacebo_tpu_torch.tools.multihost_smoke [--cpu]
    # several hosts: each runs one process, given the address and port
    # of process 0 (or under torchrun, which sets RANK, WORLD_SIZE,
    # MASTER_ADDR and MASTER_PORT)
    python3 -m libplacebo_tpu_torch.tools.multihost_smoke \\
        --rank R --world N --addr HOST0 --port PORT [--device cuda:0]
    ... --json OUT   (process 0, or the spawning process, writes it)
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

from ..demos import add_device_args, device_from, flagship_frames

FRAMES_PER_PROC = 4
SRC_W, SRC_H = 96, 64                   # rendered 2x


def host_rank(rank: int, world: int, addr: str, port: int,
              device) -> dict:
    """This process as rank `rank` of `world` on the data axis: render its
    frames, gather on process 0 and hold them against the single-device
    Renderer there.  Returns the figures (process 0's with the parity)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..core.colorspace import CSP_SRGB
    from ..ops.peak_detect import PeakDetectParams
    from ..parallel import (build_sharded_pipeline, gather_rows, make_mesh,
                            shard_planes, sharded_state_init)
    from ..render.renderer import RenderParams, Renderer, Target

    torch.set_num_threads(1)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh(data=world, spatial=1, device=device)
        batch = world * FRAMES_PER_PROC
        frames = flagship_frames(np.random.default_rng(42), batch, SRC_H,
                                 SRC_W, mesh.device)
        f0 = frames[0]
        target = Target(w=2 * SRC_W, h=2 * SRC_H, color=CSP_SRGB,
                        bit_depth=0)
        params = RenderParams(upscaler="ewa_lanczos",
                              peak_detect=PeakDetectParams(percentile=99.5))
        step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                      f0.color, target, params)
        # every process holds the global batch; shard_planes keeps this
        # rank's frames (a real deployment maps only its own)
        xs = shard_planes(mesh, [torch.stack([f.planes[i].data
                                              for f in frames])
                                 for i in range(len(f0.planes))])
        state = sharded_state_init(mesh, batch)
        t0 = time.perf_counter()
        out, _ = step(state, *xs)
        whole = gather_rows(mesh, out, target.h)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        worst = 0.0
        if rank == 0:
            for b, f in enumerate(frames):
                ref = Renderer(device=mesh.device).render(f, target, params)
                worst = max(worst, float((whole[b] - ref).abs().max()))
            if worst >= 1e-6:
                raise SystemExit(f"proc {rank}: parity {worst}")
        print(f"MH-OK proc={rank}/{dist.get_world_size()} "
              f"device={mesh.device} frames={out.shape[0]} "
              f"out={tuple(whole.shape)} max|err|={worst:.2e} "
              f"step={dt * 1e3:.0f}ms", flush=True)
        return {"device": str(mesh.device), "backend": backend,
                "max_abs_err": worst, "step_ms": dt * 1e3}
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _record(path, world, backend, addr):
    rec = {"processes": world, "frames_per_process": FRAMES_PER_PROC,
           "mesh": {"data": world, "spatial": 1}, "size": [SRC_W, SRC_H],
           "collectives": f"{backend} over TCP ({addr})",
           "parity": "exact vs the single-device Renderer", "ok": True}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")


def spawn(procs: int, device, json_path) -> int:
    """`procs` processes on this machine joined over 127.0.0.1, process i
    on cuda:i (or the CPU); 0 when every one passed."""
    import torch
    if device.type == "cuda" and torch.cuda.device_count() < procs:
        raise RuntimeError(
            f"multihost_smoke: {procs} processes need {procs} cards on this "
            f"host, it has {torch.cuda.device_count()} (run one process a "
            "host with --rank/--world/--addr/--port, or pass --cpu)")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    devs = [f"cuda:{i}" if device.type == "cuda" else "cpu"
            for i in range(procs)]
    children = [subprocess.Popen(
        [sys.executable, "-m", "libplacebo_tpu_torch.tools.multihost_smoke",
         "--rank", str(i), "--world", str(procs), "--addr", "127.0.0.1",
         "--port", str(port), "--device", devs[i]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for i in range(procs)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in children]
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 for p in children) and \
        all(f"MH-OK proc={i}" in outs[i] for i in range(procs))
    for i, o in enumerate(outs):
        for line in o.splitlines():
            if line.startswith("MH-OK") or not ok:
                print(f"[proc {i}] {line}")
    if json_path and ok:
        _record(json_path, procs, "NCCL" if device.type == "cuda"
                else "gloo", "127.0.0.1")
    print("MULTIHOST SMOKE:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multihost_smoke")
    add_device_args(ap)
    ap.add_argument("--procs", type=int, default=2,
                    help="processes to spawn on this machine")
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank of a multi-host group")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--addr", default=None, help="process 0's address")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    device = device_from(args)
    env = os.environ
    if args.rank is None and "RANK" in env and "MASTER_ADDR" in env:
        # under torchrun: its environment names the group
        args.rank, args.world = int(env["RANK"]), int(env["WORLD_SIZE"])
        args.addr, args.port = env["MASTER_ADDR"], int(env["MASTER_PORT"])
    if args.rank is None:
        return spawn(args.procs, device, args.json)
    if None in (args.world, args.addr, args.port):
        ap.error("--rank needs --world, --addr and --port")
    res = host_rank(args.rank, args.world, args.addr, args.port, device)
    if args.json and args.rank == 0:
        _record(args.json, args.world, res["backend"], args.addr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

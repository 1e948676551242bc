#!/usr/bin/env python3
"""One-option-at-a-time sharded-vs-single-device parity sweep of the port.

Every key of the option table is rendered at its non-default probe
values (bools flipped, numbers at 70% or 30% of their range, enums at
three representatives — or, with --full, every choice) through the
sharded step (parallel/renderer.py: the halo step, or the replicated
step where the halo pipeline cannot express the options) on a
1 x N mesh, and held against the single-device Renderer on rank 0's
device.  `--pairs N` samples N random pairs of keys at non-default
values instead.

Where the ranks come from: on the card (the default; raises without a
GPU) one process a card — under torchrun the NCCL group its environment
describes (`torchrun --nproc-per-node 4 -m
libplacebo_tpu_torch.tools.option_sweep_parity`), alone a one-rank mesh;
with `--ranks N`, `--cpu` or `--device cpu`, N (default 4) gloo ranks on
the CPU, spawned here.

Only `preset` is left out: it rewrites every other key at once.  The
target is 8-bit, so the dithers and error diffusion (K2 and K3's plain
versions, quick on the CPU) run too.

Gate, as the JAX package's sweep: mean |difference| <= 5e-5 and at most
1% of the values more than 1e-3 apart, every value finite; both sides
refusing an option alike is parity, one side refusing is a failure.

Usage: python3 -m libplacebo_tpu_torch.tools.option_sweep_parity
           [--device cuda|cpu] [--cpu] [--ranks N] [--keys a,b] [--full]
           [--pairs N] [--seed S] [--out FILE.json]
Exit code 1 on any parity failure or one-sided error.
"""
import argparse
import json
import sys
import time

import numpy as np

from ..demos import add_device_args, flagship_frames, on_ranks

EXCLUDE = {"preset": "rewrites every key at once"}

MEAN_TOL = 5e-5
FRAC_1E3_TOL = 1e-2
SRC_H, SRC_W = 64, 96


def sweep_values(opt, default, full: bool):
    """Non-default probe values for one option, as strings."""
    if opt.type == "bool":
        return ["no" if default else "yes"]
    if opt.type in ("int", "float"):
        lo = opt.minimum if opt.minimum is not None else 0.0
        hi = opt.maximum if opt.maximum is not None else lo + 1.0
        for t in (0.7, 0.3):
            v = lo + (hi - lo) * t
            if opt.type == "int":
                v = int(round(v))
            if v != default:
                return [str(v) if opt.type == "int" else f"{v:.6g}"]
        return []
    if opt.choices:
        ch = [c for c in opt.choices if c != default]
        if full or len(ch) <= 3:
            return list(ch)
        # representatives: both ends + middle of the table order
        return [ch[0], ch[len(ch) // 2], ch[-1]]
    return []


def probes(keys=None, full: bool = False) -> dict:
    """{key: [probe values]} of the option table."""
    from ..core.options import OPTION_TABLE, Options
    defaults = Options()
    out = {}
    for opt in OPTION_TABLE():
        if opt.type == "preset" or opt.key in EXCLUDE:
            continue
        if keys and opt.key not in keys:
            continue
        vals = sweep_values(opt, defaults.get(opt.key), full)
        if vals:
            out[opt.key] = vals
    return out


def run_one(kvs, mesh, frames, target) -> dict:
    """Render single-device and sharded (every rank calls it); the row on
    rank 0, with the gate's figures."""
    import torch
    from ..core.options import Options
    from ..parallel import (build_sharded_pipeline, gather_rows,
                            shard_planes, sharded_state_init)
    from ..render.renderer import Renderer

    opts = Options()
    for key, val in kvs:
        opts.set(key, val)
    params = opts.params
    row = {"keys": [k for k, _ in kvs], "values": [v for _, v in kvs],
           "combo": opts.save()}
    t0 = time.perf_counter()
    ref = err_ref = None
    if mesh.rank == 0:
        try:
            ref = Renderer(device=mesh.device)._render_once(
                frames[0], target, params)
        except Exception as e:          # noqa: BLE001 - compared below
            err_ref = f"{type(e).__name__}: {e}"
    out = err_sh = None
    try:
        f0 = frames[0]
        step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                      f0.color, target, params)
        xs = shard_planes(mesh, [torch.stack([f.planes[i].data
                                              for f in frames])
                                 for i in range(len(f0.planes))])
        res = step(sharded_state_init(mesh, len(frames)), *xs)
        out = gather_rows(mesh, res[0], target.h)[0]
        row["route"] = step.route
    except Exception as e:              # noqa: BLE001 - compared below
        err_sh = f"{type(e).__name__}: {e}"
    row["seconds"] = round(time.perf_counter() - t0, 2)
    if mesh.rank != 0:
        return row
    if err_ref or err_sh:
        # both sides refusing alike is parity; one-sided is not
        row["status"] = "both_error" if (err_ref and err_sh) \
            else "one_sided_error"
        row["error_single"] = err_ref
        row["error_sharded"] = err_sh
        row["ok"] = bool(err_ref and err_sh)
        return row
    diff = (out - ref).abs()
    row.update(diff_mean=float(diff.mean()), diff_max=float(diff.max()),
               frac_gt_1e3=float((diff > 1e-3).float().mean()),
               finite=bool(torch.isfinite(out).all()))
    row["ok"] = (row["diff_mean"] <= MEAN_TOL
                 and row["frac_gt_1e3"] <= FRAC_1E3_TOL and row["finite"])
    row["status"] = "ok" if row["ok"] else "DIVERGED"
    return row


def _rank(rank, world, device, combos):
    from ..core.colorspace import CSP_SRGB
    from ..parallel import make_mesh
    from ..render.renderer import Target
    mesh = make_mesh(1, world, device=device)
    target = Target(w=2 * SRC_W, h=2 * SRC_H, color=CSP_SRGB, bit_depth=8)
    frames = flagship_frames(np.random.default_rng(77), 1, SRC_H, SRC_W,
                             mesh.device)
    try:
        rows = [run_one(kvs, mesh, frames, target) for kvs in combos]
    finally:
        mesh.close()
    return {"rows": rows, "world": world, "device": str(mesh.device)}


def combos_for(probe: dict, pairs: int, seed: int) -> list:
    if not pairs:
        return [[(k, v)] for k in probe for v in probe[k]]
    rng = np.random.default_rng(seed)
    keys = sorted(probe)
    combos = []
    for _ in range(pairs):
        ka, kb = (keys[i] for i in rng.choice(len(keys), 2, replace=False))
        combos.append([(ka, probe[ka][rng.integers(len(probe[ka]))]),
                       (kb, probe[kb][rng.integers(len(probe[kb]))])])
    return combos


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="option_sweep_parity")
    add_device_args(ap)
    ap.add_argument("--ranks", type=int, default=None,
                    help="N gloo ranks on the spatial axis, on the CPU "
                         "(default with --cpu: 4)")
    ap.add_argument("--full", action="store_true",
                    help="every enum choice (default: 3 representatives)")
    ap.add_argument("--keys", default=None,
                    help="comma-separated subset of option keys")
    ap.add_argument("--pairs", type=int, default=0,
                    help="instead of the exhaustive single-key sweep, "
                         "sample N random key PAIRS at non-default values")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for --pairs sampling")
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)

    probe = probes(set(args.keys.split(",")) if args.keys else None,
                   args.full)
    combos = combos_for(probe, args.pairs, args.seed)
    res = on_ranks(_rank, args, 4, combos)
    if res is None:                     # a torchrun rank other than 0
        return 0
    rows = res["rows"]
    n_fail = 0
    for kvs, row in zip(combos, rows):
        n_fail += not row["ok"]
        label = " ".join(f"{k}={v}" for k, v in kvs)
        print(f"[{row['status']:>15s}] {label} ({row['seconds']}s"
              + (f", mean {row['diff_mean']:.2e}" if "diff_mean" in row
                 else "") + ")", flush=True)
    summary = {
        "configs": len(rows), "failed": n_fail,
        "mode": f"pairs[{args.pairs}] seed={args.seed}" if args.pairs
                else "single-key exhaustive",
        "excluded": EXCLUDE, "device": res["device"],
        "mesh": {"data": 1, "spatial": res["world"]},
        "size": [SRC_H, SRC_W, 2 * SRC_H, 2 * SRC_W],
        "tolerance": {"mean": MEAN_TOL, "frac_gt_1e3": FRAC_1E3_TOL}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    print(json.dumps(summary))
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

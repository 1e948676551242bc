#!/usr/bin/env python3
"""Run one cell of the benchmark of libplacebo_tpu_torch once.

    python3 framebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from BENCHMARK.json (see
framebench/README.md).  The run:

1. set-up (`setup_s`, from process start to the first timed frame):
   the source frames made on the card from the seed and staged in pinned
   host memory, the renderer, and two frames through the cell's own
   loop, which build and load every kernel it uses (into
   build/libplacebo_tpu_torch of the checkout, so only a checkout's first
   run compiles);
2. the measured window: frames one at a time, closed loop, for
   `--seconds`; each frame's latency runs from the moment its planes are
   handed to the program until the host sees its output finished;
3. with `--trace 1`, the first seconds of the window under one
   torch.profiler session (per-layer metrics and the breakdown), the
   rest without it (the renderer's host time);
4. the check: a sample of the window's frames, drawn from the seed, and
   its last frame against the plain reference (`reference/`).

The last line of standard output is the result as one JSON object; the
numbers compared are printed beside their limits as the last lines of
standard error.  Without a CUDA device, or where the checkout lacks the
program, the run prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "libplacebo_tpu")


def _fail(msg: str, code: int = 2):
    print(f"framebench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    """Top-level names of loaded modules that the run must not load,
    compared whole (libplacebo_tpu_torch is not libplacebo_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(xs, q):
    """numpy's linear percentile."""
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="framebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device=None, root=ROOT, control=None) -> dict:
    """One run; returns the result.  `device` None looks for the card
    and renders on it; the tests pass a CPU device to drive the rest of
    a run without one.  With `control` (a precision of the reference:
    "bfloat16"), the reference computed in that precision
    takes the program's outputs' place in the check: the control, which
    has to come out not correct."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from framebench.harness import spec
    try:
        cell = spec.resolve(args.workload, root)
    except spec.SpecError as e:
        _fail(str(e))
    import torch
    if device is None:
        if not torch.cuda.is_available():
            _fail("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            _fail(f"the cell needs {cell.chips} devices, "
                  f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    if not os.path.isdir(os.path.join(root, "libplacebo_tpu_torch")):
        _fail("the checkout holds no libplacebo_tpu_torch")
    torch.set_num_threads(4)
    from libplacebo_tpu_torch import _build
    _build.set_build_dir(os.path.join(root, "build", "libplacebo_tpu_torch"))
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    from framebench.harness import check, deploy, trace, traffic
    dev = torch.device(device)
    t = cell.traffic
    source = traffic.Source(t, args.seed, dev)
    sampler = traffic.Sampler(args.seed, int(t["check_frames"]))
    d = deploy.Deployment(lt, cell.config, source, dev, sampler.k)
    history = []
    for i in range(2):
        d.step(i, None)
        history.append(source.key(i))
    if dev.type == "cuda" and d.kind == "player":
        # the allocator's blocks for the outputs the check keeps on the
        # card, so that keeping them allocates nothing inside the window
        held = [torch.empty_like(d.last) for _ in range(sampler.k + 2)]
        del held
    gc.collect()
    gc.freeze()

    lat, render_s, failed, attempted = [], [], 0, 0
    rec, i = None, len(history)
    setup_s = time.perf_counter() - T_START
    t0 = time.perf_counter()

    def frame(trace_on=False):
        nonlocal failed, attempted, i
        slot = sampler.offer(i - 2)
        attempted += 1
        history.append(source.key(i))
        try:
            dt, rs, degraded = d.step(i, slot, trace_on)
        except Exception as e:  # noqa: BLE001 - counted, the run goes on
            print(f"framebench: frame {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            i += 1
            return None
        failed += degraded
        i += 1
        lat.append(dt)
        return rs

    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        trace_s = min(float(t["trace_seconds"]), args.seconds / 2)
        launches0 = k1.launches
        n0 = attempted
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the sub-window runs from the session's start, which itself
            # takes seconds
            ts = time.perf_counter()
            with record_function("fb.window"):
                while time.perf_counter() - ts < trace_s:
                    frame(trace_on=True)
        rec = trace.collect(prof)
        del prof
        rec["frames"] = attempted - n0
        rec["counters"] = {"k1_launches": k1.launches - launches0}
    while time.perf_counter() - t0 < args.seconds or \
            (args.trace and len(render_s) < 50):
        rs = frame()
        if rs is not None:
            render_s.append(rs)
    t1 = time.perf_counter()
    done = len(lat)
    mem_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    metrics = {}
    e2e = {"frames_per_s": done / (t1 - t0),
           "frame_ms_p95": percentile(lat, 95) * 1e3 if lat else None,
           "setup_s": setup_s}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    if args.trace:
        k1_seen = len(trace.k1_kernels(rec))
        if k1_seen != rec["counters"]["k1_launches"]:
            _fail(f"the profiler lost device activities: {k1_seen} K1 "
                  f"kernels traced, {rec['counters']['k1_launches']} "
                  f"launched", 4)
        with open(os.path.join(root, "framebench", "peaks.json")) as f:
            peaks = json.load(f)["devices"]
        rec.update(render_host_s=render_s, cell=cell.name,
                   config=cell.config, peaks=peaks.get(device["kind"]))
        for m in cell.per_layer:
            v = cell.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        w0, w1 = rec["window_ns"]
        device["busy_s"] = trace.busy_ns(rec) * 1e-9
        device["window_s"] = (w1 - w0) * 1e-9
        result["breakdown"] = trace.breakdown(rec)
    else:
        for m in cell.end_to_end:
            v = e2e[m["name"]]
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, with the program's state freed
    positions = sorted({2 + j for j in sampler.slots.values()} |
                       {len(history) - 1})
    program = {2 + j: d.outputs[s] for s, j in sampler.slots.items()
               if s in d.outputs}
    if d.last is not None:
        program[len(history) - 1] = d.last
    d.close()
    del d
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if control is not None:
        program = check.reference_outputs(cell.config, source, history,
                                          positions, dev, precision=control)
    t_ref = time.perf_counter()
    reference = check.reference_outputs(cell.config, source, history,
                                        positions, dev)
    numbers = check.compare(cell.config, program, reference)
    ok = check.judge(numbers, cell.limits) and failed == 0 and \
        len(program) == len(positions)
    result["correct"] = ok
    result["metrics"] = metrics
    result["device"] = device
    result["numbers"] = numbers
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in check.NUMBERS if k in cell.limits}
    print(f"check frames_compared {len(program)} failed {failed} "
          f"reference_s {time.perf_counter() - t_ref:.3f}",
          file=sys.stderr, flush=True)
    # the numbers a limit holds last, each beside its limit
    for k in sorted(check.NUMBERS, key=lambda k: k in cell.limits):
        lim = cell.limits.get(k)
        print(f"check {k} {numbers[k]!r}"
              + (f" limit {lim!r}" if lim is not None else " (no limit)"),
              file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        _fail(f"modules loaded that the run must not load: {bad}", 3)
    return result


def main(argv=None) -> int:
    result = run_cell(parse(argv))
    result.pop("numbers")
    result["checks"] = result.pop("checks")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

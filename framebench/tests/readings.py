#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card, at the
cell's own size: the program on many seeds (the lower readings) and the
control on a few (the upper readings), in one process so that set-up is
paid once.  The control is the reference computed in bfloat16 (every
stage's image rounded) in the program's place; TF32, the step below the
configurations' float32, changes nothing the reference computes (it
has no matrix product or convolution).

    python3 framebench/tests/readings.py --workload play_1080p_hdr10 \
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2 \
        [--out FILE]

prints one JSON line a run: the seed, the control (null for the
program), `correct` under the committed limits and every number the
check computes.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from framebench import run  # noqa: E402

CONTROLS = ("bfloat16",)


def readings(workload, seeds, control_seeds, seconds, device=None,
             root=run.ROOT, controls=CONTROLS):
    """Yield one dict a run: the program on `seeds`, then each control
    on `control_seeds`."""
    plan = [(s, None) for s in seeds] + \
        [(s, c) for c in controls for s in control_seeds]
    for seed, control in plan:
        args = run.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"])
        res = run.run_cell(args, device=device, root=root, control=control)
        yield {"workload": workload, "seed": seed, "control": control,
               "correct": res["correct"], "failed": res["failed"],
               "numbers": res["numbers"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    out = open(a.out, "a") if a.out else None
    try:
        for r in readings(a.workload, seeds, cseeds, a.seconds,
                          controls=[c for c in a.controls.split(",") if c]):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare two of the port's per-pass micro-benchmark artifacts
(`tools/bench_micro.py --json`, e.g. the committed
libplacebo_tpu_torch/data/bench_micro_h100.json against a new run).

Any pass slower than REGRESS_X times the old artifact's (beyond a small
absolute floor) is flagged; the transfer passes are not compared, since
their times depend on the host's memory as much as on the card.  Compare
only artifacts of the same size, taken on the same kind of card.

Usage:
    python3 -m libplacebo_tpu_torch.tools.bench_micro_diff OLD.json NEW.json
Exit code 1 if any pass regressed, 2 on a usage error.
"""
import json
import re
import sys

REGRESS_X = 1.5          # flag passes slower than 1.5x the old artifact
NOISE_MS = 0.02          # ... but only beyond this absolute delta
SKIP = re.compile(r"^tex_(upload|download)")


def _ms(artifact: dict) -> dict:
    return {name: p.get("ms") for name, p in
            artifact.get("passes", {}).items()}


def diff(old_path: str, new_path: str):
    with open(old_path) as f:
        old = json.load(f)
    with open(new_path) as f:
        new = json.load(f)
    if old.get("size") != new.get("size"):
        print(f"size mismatch {old.get('size')} vs {new.get('size')} — "
              "not comparable")
        return []
    if old.get("card") != new.get("card"):
        print(f"note: cards differ ({old.get('card')!r} vs "
              f"{new.get('card')!r})")
    old_ms, new_ms = _ms(old), _ms(new)
    regressions = []
    for name, ms_new in new_ms.items():
        ms_old = old_ms.get(name)
        if ms_old is None or ms_new is None or SKIP.match(name):
            continue
        mark = ""
        if ms_new > ms_old * REGRESS_X and ms_new - ms_old > NOISE_MS:
            mark = "  <-- REGRESSED"
            regressions.append((name, ms_old, ms_new))
        elif ms_old > ms_new * REGRESS_X and ms_old - ms_new > NOISE_MS:
            mark = "  (improved)"
        print(f"{name:28s} {ms_old:9.3f} -> {ms_new:9.3f} ms{mark}")
    for name, v in old_ms.items():
        if v is not None and new_ms.get(name) is None:
            print(f"{name:28s} no longer measured (was {v:.3f} ms)")
    return regressions


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    print(f"# {argv[0]} -> {argv[1]}")
    regs = diff(*argv)
    if regs:
        print(f"\n{len(regs)} pass(es) regressed >{REGRESS_X}x")
        return 1
    print("\nno pass-level regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())

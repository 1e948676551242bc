"""The program's own spans and counter events, read beside the trace.

libplacebo_tpu_torch records, while a torch.profiler session is active,
a span at each stage of the upload and of `Renderer.render`, and an
event for each count it makes (`render/profiler.py`: `records()`,
`dropped()`), on `time.time_ns()`, the clock the profiler's host events
are stamped on.  The readers of the per-layer metrics on them
(`metrics/<name>.py`) take the records whose start lies in the traced
window (`rec["window_ns"]`), per frame of the window (`rec["frames"]`).

They read nothing, and return None, where
- the checkout's program keeps no such records (a program before them);
- the program's ring dropped records that may lie in the window;
- more than 1% of the program's `upload` and `render` spans do not nest
  inside the benchmark's own `fb.upload` and `fb.render` spans around
  the same calls (`rec["spans"]`): the two clocks disagree.
"""
from __future__ import annotations

import bisect

from framebench.harness.trace import merged

# the program's top-level spans, each inside the benchmark's span of the
# same name
TOP = ("upload", "render")
CLOCK_MISSES = 0.01


def _profiler():
    """The program's span module, or None where it has no records."""
    try:
        from libplacebo_tpu_torch.render import profiler
    except ImportError:
        return None
    if not all(hasattr(profiler, f) for f in ("records", "dropped")):
        return None
    return profiler


def nested_share(records, spans) -> float:
    """Share of the program's top-level spans (`TOP`) that lie inside a
    benchmark span of the same name; 0 where there are none."""
    by_name = {}
    for name, s, e in spans:
        by_name.setdefault(name, []).append((s, e))
    for v in by_name.values():
        v.sort()
    n = inside = 0
    for r in records:
        if r[0] not in TOP or r[2] is not None:
            continue
        n += 1
        around = by_name.get(r[0], [])
        k = bisect.bisect_right(around, (r[3], float("inf"))) - 1
        if k >= 0 and around[k][1] >= r[4]:
            inside += 1
    return inside / n if n else 0.0


def window_records(rec: dict, prof=None):
    """The program's records that start inside the traced window, or
    None (the module's docstring)."""
    prof = prof or _profiler()
    if prof is None:
        return None
    w0, w1 = rec["window_ns"]
    dropped, until = prof.dropped()
    if dropped and until >= w0:
        return None
    recs = [r for r in prof.records() if w0 <= r[3] <= w1]
    if nested_share(recs, rec["spans"]) < 1.0 - CLOCK_MISSES:
        return None
    return recs


def self_ns(records, name: str) -> int:
    """Nanoseconds inside spans `name` that none of their child spans
    covers: each span's duration less the union of its children's
    intervals (children: spans whose parent is `name`, of the same
    frame, inside it)."""
    kids = {}
    for r in records:
        if r[2] == name and r[5] == 0:
            kids.setdefault(r[1], []).append((r[3], r[4]))
    total = 0
    for r in records:
        if r[0] != name or r[5] != 0:
            continue
        s, e = r[3], r[4]
        covered = sum(min(ke, e) - max(ks, s) for ks, ke in merged(
            c for c in kids.get(r[1], ()) if c[1] > s and c[0] < e))
        total += (e - s) - covered
    return total


def self_ms_per_frame(rec: dict, name: str, prof=None):
    """Self time of the spans `name` in the window, milliseconds a frame;
    None where there are none."""
    recs = window_records(rec, prof)
    if not recs or not rec["frames"] or \
            not any(r[0] == name for r in recs):
        return None
    return self_ns(recs, name) * 1e-6 / rec["frames"]


def events_per_frame(rec: dict, name: str, prof=None):
    """The counter `name`'s increments in the window, a frame (0 where
    the program's spans are there and the counter never moved)."""
    recs = window_records(rec, prof)
    if not recs or not rec["frames"]:
        return None
    return sum(r[5] for r in recs if r[0] == name) / rec["frames"]


def idle_gaps(rec: dict):
    """The device's idle intervals in the window: its complement of the
    union of the device's activities, as `trace.idle_gaps` takes it."""
    w0, w1 = rec["window_ns"]
    gaps, t = [], w0
    for s, e in merged((d[2], d[3]) for d in rec["device"]):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def overlap_ns(a, b) -> int:
    """Nanoseconds two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total

"""One torch.profiler session over a traced sub-window, reduced to plain
records: the device's activities (kernels, copies, fills) and the
benchmark's own host spans, on the profiler's one clock.

The record is what the per-layer readers (`metrics/<name>.py`) read:

  frames         frames in the traced sub-window
  window_ns      (start, end) of the sub-window (the `fb.window` range)
  device         [(name, kind, start_ns, end_ns)] with kind "kernel",
                 "memcpy_htod", "memcpy_dtoh", "memcpy_other" or "memset"
  spans          [(name, start_ns, end_ns)] of the host spans (upload,
                 render, encode_download, sync_wait)
  counters       the program's counters over the sub-window
  render_host_s  host seconds inside render() of each unprofiled frame
  cell, config   the cell's name and configuration
"""
from __future__ import annotations

import bisect
import re

_DEVICE_KINDS = {"kernel": "kernel", "concurrent_kernel": "kernel",
                 "gpu_memset": "memset", "gpu_memcpy": "memcpy"}


def _kind(name: str, activity: str) -> str:
    kind = _DEVICE_KINDS[activity]
    if kind != "memcpy":
        return kind
    if "HtoD" in name:
        return "memcpy_htod"
    if "DtoH" in name:
        return "memcpy_dtoh"
    return "memcpy_other"


def _activity(e) -> str:
    """The kineto activity type of an event.  Builds whose events do not
    say it are read by device and name: on the device, the benchmark's
    own `fb.*` ranges are annotations, "Memcpy ..." and "Memset ..."
    copies and fills, anything else a kernel."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return act()
    on_device = str(e.device_type()).endswith("CUDA")
    name = e.name()
    if not on_device:
        return "user_annotation" if name.startswith("fb.") else "cpu_op"
    if name.startswith("fb."):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def collect(prof) -> dict:
    """Device activities and `fb.*` host ranges of a finished session,
    clipped to the `fb.window` range."""
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, act = e.name(), _activity(e)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if act in _DEVICE_KINDS:
            device.append((name, _kind(name, act), start, end))
        elif act == "user_annotation" and name.startswith("fb."):
            if name == "fb.window":
                window = (start, end)
            else:
                spans.append((name[3:], start, end))
    if window is None:
        raise RuntimeError("the trace holds no fb.window range")
    w0, w1 = window
    device = sorted((d for d in device if d[3] > w0 and d[2] < w1),
                    key=lambda d: d[2])
    spans.sort(key=lambda s: s[1])
    return {"device": device, "spans": spans, "window_ns": window}


def k1_kernels(rec: dict):
    """Device seconds of each K1 launch in the window: the k1_color_map
    (templated) and k1_generic kernels, not K1's partials finish."""
    return [(e - s) * 1e-9 for name, kind, s, e in rec["device"]
            if kind == "kernel" and ("k1_color_map" in name or
                                     "k1_generic" in name)]


def merged(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(rec: dict) -> int:
    """Nanoseconds of the traced window in which some operation ran on
    the device: the union of its activities, clipped to the window."""
    w0, w1 = rec["window_ns"]
    total = 0
    for s, e in merged((d[2], d[3]) for d in rec["device"]):
        s, e = max(s, w0), min(e, w1)
        if e > s:
            total += e - s
    return total


def idle_gaps(rec: dict):
    """The device's idle time in the window split by what the host was
    doing meanwhile: each gap's overlap with each host span, the rest
    "between_frames".  [(name, ns)]."""
    w0, w1 = rec["window_ns"]
    busy = [(max(s, w0), min(e, w1)) for s, e in
            merged((d[2], d[3]) for d in rec["device"]) if e > w0 and s < w1]
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    spans = rec["spans"]
    ends = [sp[2] for sp in spans]
    out = []
    for s, e in gaps:
        covered = 0
        k = bisect.bisect_right(ends, s)
        while k < len(spans) and spans[k][1] < e:
            ov = min(e, spans[k][2]) - max(s, spans[k][1])
            if ov > 0:
                out.append((spans[k][0], ov))
                covered += ov
            k += 1
        if e - s > covered:
            out.append(("between_frames", e - s - covered))
    return out


_LAUNCHERS = {"elementwise_kernel", "vectorized_elementwise_kernel",
              "unrolled_elementwise_kernel", "gpu_kernel_impl",
              "gpu_kernel_impl_nocast", "launch_legacy_kernel"}


def short_name(name: str) -> str:
    """A kernel's name without its signature: PyTorch's elementwise
    launchers keep the operation they run ("vectorized_elementwise_kernel
    <addcmul_cuda_kernel>")."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    natives = re.findall(r"at::native::(?:\w+::)*([A-Za-z_]\w*)", name)
    if natives:
        ops = [n for n in natives[1:] if n not in _LAUNCHERS]
        name = natives[0] + (f"<{ops[0]}>" if ops else "")
    elif "(" in name:
        name = name[:name.index("(")]
    return name[:120]


def breakdown(rec: dict) -> dict:
    """The ten device operations that took most time, by short name, and
    the device's idle time by what the host was doing, in seconds."""
    by_op, by_gap = {}, {}
    for name, _, s, e in rec["device"]:
        name = short_name(name)
        by_op[name] = by_op.get(name, 0) + (e - s)
    for name, ns in idle_gaps(rec):
        by_gap[name] = by_gap.get(name, 0) + ns
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v * 1e-9] for n, v in top],
            "idle_gaps": [[n, v * 1e-9] for n, v in gaps]}

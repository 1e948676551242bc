"""The port's spans and counters (render/profiler.py): nothing recorded
and no profiler range opened outside a torch.profiler session; inside
one, a span at each stage of the upload and of the render, each frame's
spans under its sequence number, on the clock of the profiler's own
events; the plan cache's misses counted; the ring's drops counted; the
output the same with spans on and off."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import libplacebo_tpu_torch as lt
from framebench.harness.spans import self_ns
from libplacebo_tpu_torch.render import profiler
from libplacebo_tpu_torch.utils import interop

H, W = 32, 64
PARAMS = lt.RenderParams(upscaler="ewa_lanczos")
TARGET = lt.Target(w=2 * W, h=2 * H, bit_depth=8, color=lt.CSP_SRGB)
# each frame's spans (a 10-bit HDR10 frame, 2x EWA, K1's tail): name ->
# (parent, count); render.plan on a plan-cache miss only
FRAME_SPANS = {
    "upload": (None, 1), "upload.stage": ("upload", 3),
    "render": (None, 1), "render.inputs": ("render", 1),
    "render.merge": ("render", 1), "render.decode": ("render", 1),
    "render.linearize": ("render", 1), "render.scale": ("render", 1),
    "render.tail": ("render", 1), "render.output": ("render", 1)}


def _avframe(seed):
    rng = np.random.default_rng(seed)
    y = (rng.random((H, W)) * 600 + 64).astype(np.uint16)
    c = [(rng.random((H // 2, W // 2)) * 800 + 64).astype(np.uint16)
         for _ in range(2)]
    return {"format": "yuv420p10le", "data": [y] + c,
            "colorspace": "bt2020nc", "color_primaries": "bt2020",
            "color_trc": "smpte2084", "color_range": "tv"}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring for the test."""
    r = profiler._Ring()
    monkeypatch.setattr(profiler, "_RING", r)
    return r


def _frames(renderer, seeds, target=TARGET, outer=True):
    """Map and render one frame a seed, each call inside the benchmark's
    own `fb.*` ranges when `outer`; the outputs."""
    outs = []
    for s in seeds:
        with record_function("fb.upload") if outer else _null():
            f = interop.frame_from_avframe_like(_avframe(s), device="cpu")
        with record_function("fb.render") if outer else _null():
            outs.append(renderer.render(f, target, PARAMS))
    return outs


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _profiled(renderer, seeds, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _frames(renderer, seeds, **kw)
    return prof, outs


def test_no_session_no_range_no_record(ring, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a profiler range opened outside a "
                                 "session")
    monkeypatch.setattr(profiler, "_range", Refused)
    assert profiler.span("a") is profiler.span("b")   # shared, no alloc
    before = profiler.counters().get("render.plan_misses", 0)
    _frames(lt.Renderer(device="cpu"), [1, 2], outer=False)
    assert profiler.records() == [] and ring.dropped == 0
    # counters count with or without a session
    assert profiler.counters()["render.plan_misses"] == before + 1


def test_each_stage_once_a_frame(ring):
    r = lt.Renderer(device="cpu")
    _frames(r, [0])                    # plans outside the session
    _profiled(r, [1, 2])
    recs = [x for x in profiler.records() if x.n == 0]
    seqs = sorted({x.seq for x in recs})
    assert len(seqs) == 2 and 0 not in seqs
    for seq in seqs:
        mine = [x for x in recs if x.seq == seq]
        got = {}
        for x in mine:
            assert x.start_ns <= x.end_ns
            assert FRAME_SPANS[x.name][0] == x.parent, x
            got[x.name] = got.get(x.name, 0) + 1
        assert got == {k: v[1] for k, v in FRAME_SPANS.items()}
        # children inside their parent
        tops = {x.name: x for x in mine if x.parent is None}
        for x in mine:
            if x.parent is not None:
                p = tops[x.parent]
                assert p.start_ns <= x.start_ns <= x.end_ns <= p.end_ns


def test_spans_nest_in_the_profilers_ranges(ring):
    """The records' clock is the profiler's: every program span lies
    inside the enclosing `fb.*` range of kineto's events, and inside its
    own `lt.*` range, which is an operator's range, not a user
    annotation (one of those is mirrored on the device's timeline)."""
    r = lt.Renderer(device="cpu")
    prof, _ = _profiled(r, [1, 2])
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("fb.", "lt.")):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        if e.name().startswith("lt.") and hasattr(e, "activity_type"):
            assert e.activity_type() == "cpu_op", e.name()
    assert len(ranges["fb.render"]) == 2 and len(ranges["lt.render"]) == 2
    recs = profiler.records()
    assert recs
    for x in recs:
        if x.n:
            continue
        top = x.name.split(".")[0]
        assert any(s <= x.start_ns and x.end_ns <= e
                   for s, e in ranges["fb." + top]), x
        assert any(s <= x.start_ns and x.end_ns <= e
                   for s, e in ranges["lt." + x.name]), x


def test_self_time_on_synthetic_records():
    R = profiler.Record
    recs = [R("render", 1, None, 0, 100),
            R("render.merge", 1, "render", 10, 30),
            R("render.tail", 1, "render", 25, 60),     # overlaps merge
            R("upload.stage", 1, "render.inputs", 70, 80),  # grandchild
            R("render.inputs", 1, "render", 65, 90),
            R("render.plan_misses", 1, "render", 5, 5, 1),  # an event
            R("render", 2, None, 200, 250),
            R("render.merge", 2, "render", 210, 220),
            R("render.merge", 3, "render", 20, 40)]    # another frame's
    # frame 1: 100 less [10, 60] and [65, 90]; frame 2: 50 less 10
    assert self_ns(recs, "render") == (100 - 50 - 25) + (50 - 10)
    assert self_ns(recs, "render.inputs") == 25 - 10
    assert self_ns(recs, "render.merge") == 20 + 10 + 20
    assert self_ns(recs, "render.scale") == 0


def test_plan_misses(ring):
    r = lt.Renderer(device="cpu")
    key = "render.plan_misses"
    before = profiler.counters().get(key, 0)
    _profiled(r, [1, 2])
    assert profiler.counters()[key] - before == 1
    events = [x for x in profiler.records() if x.name == key]
    assert [(x.n, x.parent) for x in events] == [(1, "render")]
    plans = [x for x in profiler.records() if x.name == "render.plan"]
    assert len(plans) == 1 and plans[0].seq == events[0].seq
    other = lt.Target(w=W + 16, h=H + 8, bit_depth=8, color=lt.CSP_SRGB)
    _profiled(r, [3], target=other)
    assert profiler.counters()[key] - before == 2


def test_the_ring_counts_its_drops(monkeypatch):
    r = profiler._Ring(4)
    monkeypatch.setattr(profiler, "_RING", r)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with profiler.span(f"s{i}"):
                pass
    recs = profiler.records()
    assert [x.name for x in recs] == ["s2", "s3", "s4", "s5"]
    n, until = profiler.dropped()
    assert n == 2 and until <= recs[0].end_ns


def test_counters_read_the_launch_counters_where_they_live():
    from libplacebo_tpu_torch.ops.cuda import color_map
    from libplacebo_tpu_torch.render import renderer
    c = profiler.counters()
    assert c["k1.launches"] == color_map.launches
    assert c["render.k1_tails"] == renderer.k1_tails


def test_output_the_same_with_spans_on_and_off(ring):
    off = _frames(lt.Renderer(device="cpu"), [4, 5], outer=False)
    _, on = _profiled(lt.Renderer(device="cpu"), [4, 5], outer=False)
    assert profiler.records()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pinned_staging_spans_on_the_card(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from libplacebo_tpu_torch.utils.device import raw_to_device
    arr = np.arange(64 * 32, dtype=np.uint16).reshape(32, 64)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiler.span("upload"):
            t = raw_to_device(arr, torch.device("cuda"))
            t = t + 1
        torch.cuda.synchronize()
    assert torch.equal(t.cpu(), torch.from_numpy(arr.astype(np.int32)) + 1)
    names = [(x.name, x.parent) for x in profiler.records()]
    assert names == [("upload.pin", "upload.stage"),
                     ("upload.stage", "upload"), ("upload", None)]
    # nothing of the spans on the device's timeline
    on_device = [e.name() for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")]
    assert on_device and not [n for n in on_device if n.startswith("lt.")]
    # a 4K plane: copied into its pinned block on the granted threads,
    # one `upload.parallel` event beside the same spans
    big = np.random.default_rng(0).integers(
        0, 1 << 16, (2160, 3840), dtype=np.uint16)
    ring.items.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            with profiler.span("upload"):
                t = raw_to_device(big, torch.device("cuda"))
            torch.cuda.synchronize()
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(t.cpu(), torch.from_numpy(big.astype(np.int32)))
    recs = profiler.records()
    spans = [(x.name, x.parent) for x in recs if not x.n]
    assert spans == [("upload.pin", "upload.stage"),
                     ("upload.stage", "upload"), ("upload", None)]
    assert [(x.name, x.parent, x.n) for x in recs if x.n] == \
        [("upload.parallel", "upload.stage", 1)]

"""The readers of the program's spans (`harness/spans.py` and the
metrics on it) on a record made as a traced run makes it, from renders
profiled on the CPU: each reads a value, and reads nothing where the
program keeps no records, where its ring dropped records in the window,
where its spans lie outside the window, or where its clock disagrees
with the profiler's."""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from framebench.harness import spans, spec, trace

SPAN_METRICS = ["upload_stage_ms", "upload_pin_ms", "merge_host_ms",
                "scale_host_ms", "tail_host_ms", "render_self_ms",
                "plan_misses_per_frame", "idle_in_program_pct"]
H, W = 32, 64


def _avframe(seed):
    rng = np.random.default_rng(seed)
    y = (rng.random((H, W)) * 600 + 64).astype(np.uint16)
    c = [(rng.random((H // 2, W // 2)) * 800 + 64).astype(np.uint16)
         for _ in range(2)]
    return {"format": "yuv420p10le", "data": [y] + c,
            "colorspace": "bt2020nc", "color_primaries": "bt2020",
            "color_trc": "smpte2084", "color_range": "tv"}


@pytest.fixture
def profiler(monkeypatch):
    from libplacebo_tpu_torch.render import profiler
    monkeypatch.setattr(profiler, "_RING", profiler._Ring())
    return profiler


def _record(scale=2, warm=True, frames=2):
    """A traced window of `frames` frames through the benchmark's loop
    (`fb.window`, `fb.upload`, `fb.render`), reduced as a traced run
    reduces it."""
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.utils import interop
    r = lt.Renderer(device="cpu")
    target = lt.Target(w=scale * W, h=scale * H, bit_depth=8,
                       color=lt.CSP_SRGB)
    params = lt.RenderParams(upscaler="ewa_lanczos")

    def frame(i):
        with record_function("fb.upload"):
            f = interop.frame_from_avframe_like(_avframe(i), device="cpu")
        with record_function("fb.render"):
            r.render(f, target, params)
    if warm:
        frame(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("fb.window"):
            for i in range(frames):
                frame(1 + i)
    rec = trace.collect(prof)
    rec["frames"] = frames
    return rec


def _read(rec):
    return {m: spec.load_reader(spec.HERE, m)(rec) for m in SPAN_METRICS}


def test_each_reader_reads(profiler):
    rec = _record()
    got = _read(rec)
    for m in ("upload_stage_ms", "merge_host_ms", "scale_host_ms",
              "tail_host_ms", "render_self_ms"):
        assert 0 < got[m] < 1e3, (m, got[m])
    assert got["plan_misses_per_frame"] == 0.0
    # no device on the CPU: the window is idle, the program's spans most
    # of it
    assert 50 < got["idle_in_program_pct"] <= 100
    # no pinned memory on the CPU
    assert got["upload_pin_ms"] is None
    # a pinned allocation inside a staging span: read by one, taken out
    # of the other's self time
    st = next(x for x in profiler.records() if x.name == "upload.stage")
    profiler._RING.append(profiler.Record(
        "upload.pin", st.seq, "upload.stage", st.start_ns,
        st.start_ns + 1000))
    again = _read(rec)
    assert again["upload_pin_ms"] == pytest.approx(1000 * 1e-6 / 2)
    assert again["upload_stage_ms"] == pytest.approx(
        got["upload_stage_ms"] - 1000 * 1e-6 / 2)


def test_misses_and_a_render_at_1_1(profiler):
    rec = _record(scale=1, warm=False)
    got = _read(rec)
    assert got["plan_misses_per_frame"] == 0.5
    assert got["scale_host_ms"] is None
    assert got["merge_host_ms"] > 0


def test_nothing_where_the_ring_dropped_in_the_window(profiler):
    rec = _record()
    w0, _ = rec["window_ns"]
    profiler._RING.dropped, profiler._RING.dropped_until = 3, w0 - 1
    assert all(v is not None for k, v in _read(rec).items()
               if k != "upload_pin_ms")
    profiler._RING.dropped_until = w0 + 1
    assert all(v is None for v in _read(rec).values())


def test_nothing_outside_the_window(profiler):
    rec = _record()
    _, w1 = rec["window_ns"]
    rec["window_ns"] = (w1 + 1, w1 + 10 ** 9)
    assert all(v is None for v in _read(rec).values())


def test_nothing_where_the_clocks_disagree(profiler):
    rec = _record()
    # the benchmark's spans 2 ms late against the program's: the
    # program's spans no longer nest inside them
    late = [(n, s + 2_000_000, e + 2_000_000) for n, s, e in rec["spans"]]
    assert spans.nested_share(profiler.records(), rec["spans"]) == 1.0
    assert spans.nested_share(profiler.records(), late) == 0.0
    rec["spans"] = late
    assert all(v is None for v in _read(rec).values())


def test_nothing_from_a_program_without_records(profiler, monkeypatch):
    rec = _record(frames=1)
    monkeypatch.delattr(profiler, "records")
    assert all(v is None for v in _read(rec).values())


def test_gaps_and_overlaps():
    rec = {"window_ns": (0, 100),
           "device": [("k", "kernel", 10, 20), ("k", "kernel", 15, 30),
                      ("c", "memcpy_htod", 90, 120)]}
    assert spans.idle_gaps(rec) == [(0, 10), (30, 90)]
    assert spans.overlap_ns([(0, 10), (30, 90)], [[5, 40], [80, 95]]) == \
        5 + 10 + 10

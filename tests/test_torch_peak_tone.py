"""The colour tail's per-frame scalars (ops/cuda/peak_tone.py): on the
CPU the wrapper is the plain chain (ops/tone_dynamic.py::tone_vector,
ops/peak_detect.py::delayed_stats and finish_from_packed) and refuses
what the kernel does not take, and the renderer still reaches the peak's
finish through `ops_peak.finish_from_packed`; on the card
(`-m cuda`) the kernel against the plain chain run there, at the cells'
stripe counts, over every curve, both percentiles, an unset, a steady
and a cut state, and a 120-frame chain fed back into itself: the tone
vector bit for bit, the state within STATE_ULPS."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.ops import peak_detect as ops_peak
from libplacebo_tpu_torch.ops import tone_dynamic as ops_tone
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.ops.cuda import peak_tone
from libplacebo_tpu_torch.render import profiler
from libplacebo_tpu_torch.render import renderer as trender
from libplacebo_tpu_torch.utils import interop

CURVES = ops_tone.DYNAMIC_TONE_FUNCTIONS
# the flagship's target range and metadata peak (1000 nits), in PQ
DST_MIN, DST_MAX, SRC_MAX_PQ = 0.0625, 0.5081, 0.7518
PERCENTILES = (100.0, 99.995)
# K1's output frames in the cells: the players' 3840x2160 and the
# transcoder's 1920x1080 (270 and 135 stripes of 8 rows)
CELL_SHAPES = ((2160, 3840), (1080, 1920))


def _plan(curve):
    return peak_tone.plan_tone(curve, DST_MIN, DST_MAX, None, SRC_MAX_PQ)


def _frame(kind, H, W, seed, device, level=1.0):
    """A (3, H, W) linear-light frame (NORM units): all black, a typical
    one (up to ~1000 nits) or black with one bright (8000-nit) stripe."""
    g = torch.Generator().manual_seed(seed)
    if kind == "black":
        img = torch.zeros((3, H, W))
    elif kind == "typical":
        img = torch.rand((3, H, W), generator=g) ** 2 * (5.0 * level)
    else:
        img = torch.zeros((3, H, W))
        r = 8 * int(torch.randint(H // 8, (1,), generator=g))
        img[:, r:r + 8] = 40.0
    return img.to(device)


def _partials(img, params):
    """K1's (G, 8, 128) peak partials of `img` (block rows as K1 picks
    them), by the plain stripe reduction."""
    pq, active, bins = ops_peak._pixel_pq(img, params)
    return ops_peak.stripe_partials(pq, active, bins,
                                    k1.pick_block_rows(img.shape[-2]))


def _states(packed, params):
    """Old states: unset, steady (the frame's own), a scene cut, and one
    inside the cut's smoothstep (the stats 2% PQ apart)."""
    own = ops_peak.finish_from_packed_plain(
        packed, torch.zeros(2, device=packed.device), params)[2]
    return {"unset": torch.zeros(2, device=packed.device),
            "steady": own.clone(),
            "cut": torch.tensor([0.05, 0.2], device=packed.device),
            "smoothstep": (own - torch.tensor([0.02, 0.03],
                                              device=packed.device))
            .clamp_min(1e-3)}


# -- CPU ------------------------------------------------------------------

@pytest.mark.parametrize("curve", CURVES)
def test_cpu_tone_vector_is_the_plain_chain(curve):
    plan = _plan(curve)
    for avg, mx in ((0.0, 0.0), (0.31, 0.66), (0.05, 0.3), (0.4, 0.95)):
        state = torch.tensor([avg, mx])
        a, m = ops_peak.delayed_stats(state, SRC_MAX_PQ)
        want = ops_tone.tone_vector(curve, m, a, DST_MIN, DST_MAX)
        assert torch.equal(peak_tone.delayed_tone_vector(plan, state), want)
        want = ops_tone.tone_vector(curve, state[1], state[0], DST_MIN,
                                    DST_MAX)
        got = peak_tone.tone_vector(plan, state[0].clone(),
                                    state[1].clone())
        assert torch.equal(got, want)


@pytest.mark.parametrize("pct", PERCENTILES)
def test_cpu_peak_finish_is_the_plain_chain(pct):
    params = ops_peak.PeakDetectParams(percentile=pct)
    packed = _partials(_frame("typical", 64, 96, 3, "cpu"), params)
    for name, state in _states(packed, params).items():
        before = state.clone()
        want = ops_peak.finish_from_packed_plain(packed, state, params)[2]
        assert torch.equal(peak_tone.peak_finish(packed, state, params),
                           want), name
        assert torch.equal(ops_peak.finish_from_packed(
            packed, state, params)[2], want), name
        assert torch.equal(state, before), name


def _avframe(seed, H=32, W=64):
    rng = np.random.default_rng(seed)
    y = (rng.random((H, W)) * 600 + 64).astype(np.uint16)
    c = [(rng.random((H // 2, W // 2)) * 800 + 64).astype(np.uint16)
         for _ in range(2)]
    return {"format": "yuv420p10le", "data": [y] + c,
            "colorspace": "bt2020nc", "color_primaries": "bt2020",
            "color_trc": "smpte2084", "color_range": "tv"}


def _render(renderer, seeds, device="cpu"):
    params = lt.RenderParams(upscaler="ewa_lanczos")
    target = lt.Target(w=128, h=64, bit_depth=8, color=lt.CSP_SRGB)
    return [renderer.render(interop.frame_from_avframe_like(
        _avframe(s), device=device), target, params) for s in seeds]


def test_renderer_reaches_the_finish_through_the_module(monkeypatch):
    """The fused tail's peak finish is looked up on ops/peak_detect.py at
    each frame (the benchmark's stuck-state fault replaces it there)."""
    real, calls = ops_peak.finish_from_packed, []

    def spy(packed, state, params):
        calls.append(packed.shape)
        return real(packed, state, params)
    monkeypatch.setattr(ops_peak, "finish_from_packed", spy)
    k1_tails = trender.k1_tails
    r = lt.Renderer(device="cpu")
    _render(r, [1, 2, 3])
    assert trender.k1_tails - k1_tails == 3
    assert len(calls) == 3
    stuck = r._peak_state.clone()
    monkeypatch.setattr(ops_peak, "finish_from_packed",
                        lambda packed, state, params:
                        real(packed, state, params)[:2] + (state,))
    _render(r, [4])
    assert torch.equal(r._peak_state, stuck)


def test_tail_scalars_count_nothing_on_the_cpu():
    """CPU renders take the plain chain: no `render.tail_scalars`, no
    launch."""
    counts = profiler.counters()
    _render(lt.Renderer(device="cpu"), [5, 6])
    after = profiler.counters()
    assert after.get("render.tail_scalars", 0) == \
        counts.get("render.tail_scalars", 0)
    assert after["peak_tone.launches"] == counts["peak_tone.launches"]


def _refusals():
    plan = _plan("spline")
    state = torch.zeros(2)
    packed = torch.zeros((4,) + ops_peak.PARTIAL_SHAPE)
    params = ops_peak.PeakDetectParams()
    return {
        "curve_name": lambda: peak_tone.plan_tone("reinhard", DST_MIN,
                                                  DST_MAX, None, SRC_MAX_PQ),
        "plan_type": lambda: peak_tone.delayed_tone_vector("spline", state),
        "state_shape": lambda: peak_tone.delayed_tone_vector(
            plan, torch.zeros(3)),
        "state_dtype": lambda: peak_tone.delayed_tone_vector(
            plan, torch.zeros(2, dtype=torch.float64)),
        "stats_shape": lambda: peak_tone.tone_vector(
            plan, torch.zeros(1), torch.zeros(1)),
        "stats_dtype": lambda: peak_tone.tone_vector(
            plan, torch.tensor(0.1, dtype=torch.float64), torch.tensor(0.5)),
        "packed_shape": lambda: peak_tone.peak_finish(
            torch.zeros(4, 8, 64), state, params),
        "packed_dtype": lambda: peak_tone.peak_finish(
            packed.double(), state, params),
        "packed_strided": lambda: peak_tone.peak_finish(
            torch.zeros((8,) + ops_peak.PARTIAL_SHAPE)[::2], state, params),
        "packed_empty": lambda: peak_tone.peak_finish(
            packed[:0], state, params),
        "finish_state_shape": lambda: peak_tone.peak_finish(
            packed, torch.zeros(2, 1), params),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses(case):
    with pytest.raises(ValueError):
        _refusals()[case]()


def test_layouts_name_every_constant_the_source_reads():
    """The kernel reads its host constants by name (T(...), P(...)); the
    wrapper's layouts define exactly those names."""
    src = (Path(peak_tone.__file__).parents[2] / "csrc" /
           "peak_tone.cu").read_text()
    tone = set(re.findall(r"\bT\((\w+)\)", src)) - {"name"}
    peak = set(re.findall(r"\bP\((\w+)\)", src)) - {"name"}
    assert tone == set(peak_tone.TONE_LAYOUT)
    assert peak == set(peak_tone.PEAK_LAYOUT)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tone_plain(plan, state=None, stats=None):
    """The plain chain on the card: delayed_stats (with `state`) and
    tone_vector."""
    a, m = ops_peak.delayed_stats(state, plan.src_max_pq) \
        if state is not None else stats
    return ops_tone.tone_vector(plan.function, m, a, plan.dst_min,
                                plan.dst_max, plan.constants)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", CURVES)
def test_tone_vector_bit_for_bit_on_card(cuda_device, curve):
    """The prologue equals the plain chain on the card bit for bit: from
    the state (unset, then 400 drawn, some with the average unset or the
    peak below the target's) and from stats."""
    plan = _plan(curve)
    rng = np.random.default_rng(23)
    states = [(0.0, 0.0), (0.0, 0.7), (0.3, 0.0), (0.2, 0.4)] + [
        (rng.uniform(0.0, 0.8) if i % 5 else 0.0, rng.uniform(0.1, 1.0))
        for i in range(400)]
    before = peak_tone.launches
    for avg, mx in states:
        state = torch.tensor([avg, mx], dtype=torch.float32,
                             device=cuda_device)
        got = peak_tone.delayed_tone_vector(plan, state)
        assert torch.equal(got, _tone_plain(plan, state=state)), (avg, mx)
        a, m = state[0].clone(), state[1].clone()
        got = peak_tone.tone_vector(plan, a, m)
        assert torch.equal(got, _tone_plain(plan, stats=(a, m))), (avg, mx)
    torch.cuda.synchronize()
    assert peak_tone.launches - before == 2 * len(states)


def _ulps(a, b):
    """Distance in float32 ulps of same-signed finite values."""
    ia = a.cpu().view(torch.int32).long()
    ib = b.cpu().view(torch.int32).long()
    return int((ia - ib).abs().max())


# The state: histograms, counts and maxima are exact in any order, but
# the kernel adds the (up to 270) stripe means in a fixed order of its
# own (csrc/peak_tone.cu) and torch.sum in ATen's, so their sums, and
# the frame average, may differ by an ulp or two; the IIR passes that
# on, and the scene cut's smoothstep magnifies it in both stats by up to
# ~2x.  The state is held within 4 ulps.
STATE_ULPS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("pct", PERCENTILES)
@pytest.mark.parametrize("kind", ["black", "typical", "bright_stripe"])
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=["2160p", "1080p"])
def test_peak_finish_on_card(cuda_device, pct, kind, shape):
    params = ops_peak.PeakDetectParams(percentile=pct)
    packed = _partials(_frame(kind, *shape, 7, cuda_device), params)
    assert packed.shape[0] == shape[0] // 8
    for name, state in _states(packed, params).items():
        before = state.clone()
        got = peak_tone.peak_finish(packed, state, params)
        want = ops_peak.finish_from_packed_plain(packed, state, params)[2]
        torch.cuda.synchronize()
        assert torch.equal(state, before), name
        assert got.data_ptr() != state.data_ptr()
        assert _ulps(got, want) <= STATE_ULPS, (name, got, want)
        # a fixed order: the same partials give the same state
        assert torch.equal(peak_tone.peak_finish(packed, state, params),
                           got), name


@pytest.mark.cuda
@pytest.mark.parametrize("curve", CURVES)
def test_120_frame_chain_on_card(cuda_device, curve):
    """Each frame's tone vector from the kernel's state equals the plain
    chain's from the same state, and the kernel's and the plain chain's
    states, each fed back into itself through brightening, dimming and
    two scene cuts, stay within STATE_ULPS of each other."""
    params = ops_peak.PeakDetectParams(percentile=99.995)
    plan = _plan(curve)
    s_k = torch.zeros(2, device=cuda_device)
    s_p = s_k.clone()
    for i in range(120):
        level = (0.2 + i / 40.0) if i < 40 else \
            (3.0 - (i - 40) / 40.0) if i < 80 else 0.05
        packed = _partials(_frame("typical", 1080, 1920, 100 + i,
                                  cuda_device, level), params)
        tone = peak_tone.delayed_tone_vector(plan, s_k)
        assert torch.equal(tone, _tone_plain(plan, state=s_k)), i
        s_k = peak_tone.peak_finish(packed, s_k, params)
        s_p = ops_peak.finish_from_packed_plain(packed, s_p, params)[2]
        assert _ulps(s_k, s_p) <= STATE_ULPS, (i, s_k, s_p)


@pytest.mark.cuda
def test_renderer_counts_tail_scalars_on_card(cuda_device, monkeypatch):
    """A flagship render on the card computes its scalars in the kernel:
    one `render.tail_scalars` and two launches a frame.  With the plain
    chain's tone vector on the card in its place, the outputs and the
    state are the same bit for bit; with the plain chain's finish too,
    the first frame (the state unset) is the same and the state is
    within STATE_ULPS after every frame."""
    seeds = [1, 2, 3]
    before = profiler.counters()
    r = lt.Renderer(device=cuda_device)
    outs, states = [], []
    for s in seeds:
        outs += _render(r, [s], device=cuda_device)
        states.append(r._peak_state.clone())
    torch.cuda.synchronize()
    after = profiler.counters()
    assert after["render.tail_scalars"] - \
        before.get("render.tail_scalars", 0) == 3
    assert after["peak_tone.launches"] - before["peak_tone.launches"] == 6
    monkeypatch.setattr(peak_tone, "delayed_tone_vector",
                        lambda plan, state: _tone_plain(plan, state=state))
    p = lt.Renderer(device=cuda_device)
    for a, b in zip(outs, _render(p, seeds, device=cuda_device)):
        assert torch.equal(a, b)
    assert torch.equal(r._peak_state, p._peak_state)
    monkeypatch.setattr(ops_peak, "finish_from_packed",
                        ops_peak.finish_from_packed_plain)
    q = lt.Renderer(device=cuda_device)
    for i, s in enumerate(seeds):
        out = _render(q, [s], device=cuda_device)[0]
        if i == 0:
            assert torch.equal(out, outs[0])
        assert _ulps(q._peak_state, states[i]) <= STATE_ULPS, i

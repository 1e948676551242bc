"""The front (ops/cuda/front.py): the merge, decode and PQ linearize as one
kernel.  On the CPU: the wrapper is the plain merge -> decode ->
linearize chain; the plan's tables, run as the kernel runs them, give
that chain bit for bit; the renderer plans the front of both framebench
configurations at both source sizes and refuses every input the kernel
does not take; `render.front_fused` counts nothing.  On the card
(`-m cuda`): the kernel against the plain chain run there, bit for bit,
over the cells' sizes, every chroma layout and siting, odd sizes, the
extreme codes and both ranges of two matrices, and whole renders of the
framebench configurations against the plain front's."""
import json
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from framebench.harness.deploy import Deployment
from libplacebo_tpu_torch import _build
from libplacebo_tpu_torch.core import transfer as tf
from libplacebo_tpu_torch.core.fastmath import fma
from libplacebo_tpu_torch.core.film_grain import sample_grain
from libplacebo_tpu_torch.ops import color as ops_color
from libplacebo_tpu_torch.ops.cuda import front
from libplacebo_tpu_torch.render import profiler
from libplacebo_tpu_torch.render import renderer as trender
from libplacebo_tpu_torch.utils import interop

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((ROOT / "framebench" / "configs").glob("*.json"))}
# the cells' source sizes (W, H)
CELL_SIZES = ((1920, 1080), (3840, 2160))
FORMATS = {"420": "yuv420p10le", "422": "yuv422p10le", "444": "yuv444p10le",
           "440": "yuv444p10le", "410": "yuv410p"}
# (layout, siting) of every chroma case: 4:2:0 both sitings, 4:2:2,
# 4:4:4 (every plane taken as it is), 4:1:0 (four phases) and 4:4:0 (the
# pass along W first)
LAYOUTS = (("420", "left"), ("420", "center"), ("422", "left"),
           ("444", "left"), ("410", "left"), ("440", "left"))
# (colorspace, range) of the matrices held
MATRICES = (("bt2020nc", "tv"), ("bt2020nc", "pc"), ("bt709", "tv"),
            ("bt709", "pc"))
CODES = (0, 64, 512, 940, 1023)


def _avframe(W, H, layout="420", siting="left", content=1,
             colorspace="bt2020nc", rng_="tv", trc="smpte2084"):
    """An HDR10-like AVFrame dict: 10-bit planes (8-bit at 4:1:0) at
    `layout`, all one code (`content` in CODES, as a 10-bit code) or
    uniform from the seed `content`; 4:4:0 is made from 4:4:4 by
    `_frame`."""
    sub = {"420": (2, 2), "422": (2, 1), "410": (4, 4)}.get(layout, (1, 1))
    cw, ch = -(-W // sub[0]), -(-H // sub[1])
    bits, dt = (8, np.uint8) if layout == "410" else (10, np.uint16)
    if content in CODES:
        planes = [np.full(s, content >> (10 - bits), dt)
                  for s in ((H, W), (ch, cw), (ch, cw))]
    else:
        g = np.random.default_rng(content)
        planes = [g.integers(0, 1 << bits, s).astype(dt)
                  for s in ((H, W), (ch, cw), (ch, cw))]
    return {"format": FORMATS[layout], "data": planes,
            "colorspace": colorspace, "color_primaries": "bt2020",
            "color_trc": trc, "color_range": rng_,
            "chroma_location": siting}


def _frame(device="cpu", **kw):
    f = interop.frame_from_avframe_like(_avframe(**kw), device=device)
    if kw.get("layout") == "440":
        # every other row of the chroma planes, centred
        f.planes = f.planes[:1] + [
            replace(p, data=p.data[:, ::2].contiguous(), shift_y=0.0)
            for p in f.planes[1:]]
    return f


def _player(W, H):
    """A display of the source's size (the 4K player's geometry): the
    linearize right before the tail."""
    return lt.Target(w=W, h=H, bit_depth=8, color=lt.CSP_SRGB)


def _pipeline(frame, target, params=None):
    return lt.Renderer(device="cpu")._plan(frame, target,
                                           params or lt.RenderParams())


def _plain(frame, plan, planes):
    """merge -> decode -> linearize as the plain stages run them, composed
    here."""
    r = lt.Renderer(device="cpu")
    img, _, _ = r._merge_planes(planes, frame.meta_key()[0],
                                lt.RenderParams())
    img = ops_color.decode_color(img, frame.repr, frame.color.primaries)
    return ops_color.linearize(img, frame.color)


def _taps(ax, n, size):
    """An axis's (index, weight, used) tables over n outputs, read from
    the kernel's parameters as the kernel reads them."""
    P = ax.phases
    idx = np.zeros((n, front.MAX_TAPS), np.int64)
    w = np.zeros((n, front.MAX_TAPS), np.float32)
    used = np.zeros((n, front.MAX_TAPS), bool)
    for o in range(n):
        j, p = divmod(o, P)
        for k in range(ax.ntaps[p]):
            idx[o, k] = min(max(ax.base[p] + j + ax.off[p][k], 0), size - 1)
            w[o, k], used[o, k] = ax.w[p][k], True
    return torch.from_numpy(idx), torch.from_numpy(w), \
        torch.from_numpy(used)


def _tap_sum(xs, w, used):
    """Per output, the taps in order, each product and sum rounded on its
    own; a weight of 1 is no product."""
    acc = None
    for k in range(len(xs)):
        term = torch.where(w[k] == 1.0, xs[k], xs[k] * w[k])
        acc = term if acc is None else torch.where(used[k], acc + term, acc)
    return acc


def _mix(xs, r):
    """csrc/front.cu's mix_row of the parameters' row `r`."""
    if r.n == 0:
        zero = torch.zeros_like(xs[0])
        return zero + r.b if r.has_b else zero
    acc = pend = None
    for i in range(r.n):
        x, w, one = xs[r.chan[i]], r.w[i], (r.one >> i) & 1
        if acc is None and pend is None:
            if one:
                acc = x
            else:
                pend = (x, w)
            continue
        if pend is not None:
            if one:
                acc = fma(pend[0], pend[1], x)
            elif pend[1] < 0.0 < w:
                acc = fma(x, w, pend[0] * pend[1])
            else:
                acc = fma(pend[0], pend[1], x * w)
            pend = None
        elif one:
            acc = acc + x
        else:
            acc = fma(x, w, acc)
    if r.has_b:
        return fma(pend[0], pend[1], r.b) if pend else acc + r.b
    return pend[0] * pend[1] if pend else acc


def _model(plan, planes):
    """The kernel's arithmetic over its parameters (plan.params), on the
    CPU."""
    prm, H, W = plan.params, plan.H, plan.W
    K = front.MAX_TAPS
    m = []
    for c, (index, _, _, _) in enumerate(plan.channels):
        pl, s = prm.plane[c], planes[index][0]
        if pl.mode == front.AS_IS:
            m.append(s)
            continue
        ri, rw, ru = _taps(pl.ax[0], H, pl.h)
        ci, cw, cu = _taps(pl.ax[1], W, pl.w)

        def at(t, k):
            return s[ri[:, t]][:, ci[:, k]]
        if pl.mode == front.ROWS_FIRST:
            cols = [_tap_sum([at(t, k) for t in range(K)], rw.T[:, :, None],
                             ru.T[:, :, None]) for k in range(K)]
            m.append(_tap_sum(cols, cw.T[:, None, :], cu.T[:, None, :]))
        else:
            rows = [_tap_sum([at(t, k) for k in range(K)], cw.T[:, None, :],
                             cu.T[:, None, :]) for t in range(K)]
            m.append(_tap_sum(rows, rw.T[:, :, None], ru.T[:, :, None]))
    d = torch.stack([_mix(m, prm.row[c]) for c in range(3)])
    return tf.pq_eotf_fast(torch.clamp_min(d, 0.0)) * \
        prm.v[front._OFF["scale"]]


# -- CPU ------------------------------------------------------------------

CPU_CASES = [(W, H, layout, siting) for (layout, siting) in LAYOUTS
             for W, H in ((48, 32), (96, 56))] + \
    [(48, 33, "422", "left"), (47, 33, "444", "left")]


@pytest.mark.parametrize("W,H,layout,siting", CPU_CASES)
def test_cpu_run_is_the_plain_chain(W, H, layout, siting):
    """On the CPU the wrapper runs the plain merge -> decode -> linearize,
    and the plan's tables, evaluated as the kernel evaluates them, give
    the same frame bit for bit."""
    for content in (3, 64, 1023):
        f = _frame(W=W, H=H, layout=layout, siting=siting, content=content)
        plan = _pipeline(f, _player(W, H)).front
        assert plan is not None
        planes = [p.data for p in f.planes]
        got = front.run(plan, planes)
        want = _plain(f, plan, planes)
        assert got.shape == (3, H, W) and got.is_contiguous()
        assert torch.equal(got, want)
        assert torch.equal(_model(plan, planes), want)


@pytest.mark.parametrize("size", CELL_SIZES, ids=["1080p", "2160p"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plan_takes_the_framebench_fronts(config, size):
    """Both framebench configurations take the front at both source
    sizes: luma as it is, each chroma plane 2x on both axes in two phases
    of at most two taps, rows first."""
    W, H = size
    d = Deployment(lt, CONFIGS[config], None, torch.device("cpu"), 0)
    av = dict(CONFIGS[config]["source_frame"])
    av["format"] = "yuv420p10le"
    av["data"] = [np.full((H, W), 64, np.uint16)] + \
        [np.full((H // 2, W // 2), 512, np.uint16)] * 2
    f = interop.frame_from_avframe_like(av, device="cpu")
    plan = _pipeline(f, d.target, d.params).front
    assert plan is not None and (plan.H, plan.W) == (H, W)
    modes = [mode for _, _, mode, _ in plan.channels]
    assert modes == [front.AS_IS, front.ROWS_FIRST, front.ROWS_FIRST]
    for _, (h, w), _, axes in plan.channels[1:]:
        assert (h, w) == (H // 2, W // 2)
        for P, phases in axes:
            assert P == 2 and all(len(t) <= 2 for _, t in phases)
    assert 153 < front.ops_per_pixel(plan) < 220
    assert front.bytes_per_frame(plan) == 18 * H * W


def _hook():
    return lt.Hook(stages=lt.HookStage.RGB_INPUT, func=lambda img, p: img)


def _icc():
    from test_icc_h274 import _make_profile
    return lt.parse_icc(_make_profile())


def _excluded():
    """Per exclusion, (frame changes, params changes) of a 4:2:0 PQ frame
    the front otherwise takes."""
    def rep(**k):
        return lambda f: replace(f, repr=replace(f.repr, **k))
    return {
        "hooks": (None, dict(hooks=(_hook(),))),
        "deband": (None, dict(deband=lt.DebandParams())),
        "av1_grain": (lambda f: replace(f, film_grain=sample_grain()), {}),
        "h274_grain": (lambda f: replace(f, film_grain=lt.FilmGrainData(
            type="h274", seed=1, h274=lt.H274GrainData(
                model_id=0, log2_scale_factor=2,
                component_model_present=(True, False, False),
                num_intensity_intervals=(1, 0, 0),
                num_model_values=(3, 0, 0),
                intensity_interval_lower_bound=((0,), (), ()),
                intensity_interval_upper_bound=((255,), (), ()),
                comp_model_value=(((100, 8, 8),), (), ())))), {}),
        "deinterlace": (lambda f: replace(f, field=lt.Field.TOP),
                        dict(deinterlace=lt.DeinterlaceParams())),
        "dolby_vision": (rep(sys=lt.ColorSystem.DOLBYVISION,
                             dovi=lt.DoviMetadata()), {}),
        "ictcp": (rep(sys=lt.ColorSystem.BT_2100_PQ), {}),
        "bt2020_c": (rep(sys=lt.ColorSystem.BT_2020_C), {}),
        "xyz": (rep(sys=lt.ColorSystem.XYZ), {}),
        "hlg_transfer": (lambda f: replace(f, color=replace(
            f.color, transfer=lt.ColorTransfer.HLG)), {}),
        "alpha": ("alpha", {}),
        "rotation": (lambda f: replace(f, rotation=lt.Rotation(1)), {}),
        "gamma_adjustment": (None, dict(
            color_adjustment=lt.ColorAdjustment(gamma=1.2))),
        "polar_plane_scaler": (None, dict(plane_upscaler="ewa_lanczos")),
        "frame_icc": (lambda f: replace(f, icc=_icc()), {}),
    }


@pytest.mark.parametrize("case", sorted(_excluded()))
def test_plan_refuses(case):
    """Each input the kernel does not take keeps the plain chain; the
    same frame without it takes the front."""
    W, H = 48, 32
    target = _player(W, H)
    f = _frame(W=W, H=H)
    assert _pipeline(f, target).front is not None
    change, kw = _excluded()[case]
    if change == "alpha":
        av = _avframe(W=W, H=H)
        av["format"] = "yuva420p"
        av["data"] = [(p >> 2).astype(np.uint8) for p in av["data"]] + \
            [np.full((H, W), 255, np.uint8)]
        f = interop.frame_from_avframe_like(av, device="cpu")
    elif change is not None:
        f = change(f)
    assert _pipeline(f, target, lt.RenderParams(**kw)).front is None


def test_plan_refuses_odd_420():
    """An odd 4:2:0 frame's chroma is (W + 1) / 2 texels over W: no
    periodic phase plan, so the plain merge (gather and matmul) runs."""
    for W, H in ((47, 32), (48, 33)):
        assert _pipeline(_frame(W=W, H=H), _player(W, H)).front is None


def test_plan_needs_the_linearize_next_to_the_decode():
    """A scale in non-linear light (linear scaling off), and a PQ target
    of the source's primaries and size (no linearize at all), keep the
    plain chain; linear-light scaling takes the front."""
    W, H = 48, 32
    f = _frame(W=W, H=H)
    up = lt.Target(w=2 * W, h=2 * H, bit_depth=8, color=lt.CSP_SRGB)
    assert _pipeline(f, up).front is not None
    assert _pipeline(f, up, lt.RenderParams(linear_scaling=False)) \
        .front is None
    same = lt.Target(w=W, h=H, color=f.color)
    assert _pipeline(f, same).front is None


def test_front_fused_counts_nothing_on_the_cpu():
    """CPU renders keep the plain stages: no `render.front_fused`, no
    launch, and the same output as a renderer without the plan."""
    W, H = 48, 32
    before = profiler.counters()
    out = lt.Renderer(device="cpu").render(_frame(W=W, H=H), _player(W, H))
    after = profiler.counters()
    assert after.get("render.front_fused", 0) == \
        before.get("render.front_fused", 0)
    assert after["front.launches"] == before["front.launches"]
    assert out.shape == (3, H, W)


def _refusals():
    f = _frame(W=48, H=32)
    plan = _pipeline(f, _player(48, 32)).front
    planes = [p.data for p in f.planes]
    return {
        "plan_type": lambda: front.run(None, planes),
        "plane_dtype": lambda: front.run(plan, [planes[0].double()] +
                                         planes[1:]),
        "plane_shape": lambda: front.run(plan, [planes[0][:, :-1]] +
                                         planes[1:]),
        "plane_batch": lambda: front.run(plan, [planes[0][None]] +
                                         planes[1:]),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses(case):
    with pytest.raises(ValueError):
        _refusals()[case]()


def test_layout_names_every_constant_the_source_reads():
    """The kernel reads the PQ constants by name (FR(...)); the wrapper's
    layout defines exactly those names."""
    src = (Path(front.__file__).parents[2] / "csrc" / "front.cu").read_text()
    names = set(re.findall(r"\bFR\((\w+)\)", src)) - {"name"}
    assert names == {n for n, _ in front.PQ_LAYOUT}


def test_build_digest_covers_the_shared_header(tmp_path):
    """A kernel library's name follows the CUDA headers beside its
    source, so an edit of pq_fast.cuh rebuilds K1 and the front."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    hdr = tmp_path / "shared.cuh"
    hdr.write_text("// one\n")
    a = _build._digest([str(src)], ["-O3"])
    assert _build._digest([str(src)], ["-O3"]) == a
    hdr.write_text("// two\n")
    assert _build._digest([str(src)], ["-O3"]) != a


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(dev, **kw):
    """The kernel's and the plain chain's linear light of one frame on
    the card (planned on the CPU), and the plan."""
    f = _frame(**kw)
    plan = _pipeline(f, _player(kw["W"], kw["H"])).front
    assert plan is not None, kw
    planes = [p.data.to(dev) for p in f.planes]
    before = front.launches
    got = front.run(plan, planes)
    want = plan.plain(*planes)
    torch.cuda.synchronize()
    assert front.launches == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("colorspace,rng_", MATRICES)
@pytest.mark.parametrize("layout,siting", LAYOUTS)
@pytest.mark.parametrize("size", CELL_SIZES, ids=["1080p", "2160p"])
def test_kernel_bit_for_bit_on_card(cuda_device, size, layout, siting,
                                    colorspace, rng_):
    """The kernel equals the plain chain on the card bit for bit: each
    code of CODES in every plane, and a seeded uniform frame."""
    W, H = size
    for content in CODES + (17,):
        got, want = _kernel_vs_plain(cuda_device, W=W, H=H, layout=layout,
                                     siting=siting, content=content,
                                     colorspace=colorspace, rng_=rng_)
        assert got.shape == want.shape == (3, H, W)
        differ = int((got != want).sum())
        assert differ == 0, (content, differ,
                             float((got - want).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("W,H,layout", [(1920, 1081, "422"),
                                        (1919, 1081, "444"),
                                        (34, 17, "422"), (31, 7, "444")])
def test_odd_sizes_bit_for_bit_on_card(cuda_device, W, H, layout):
    """Odd sizes (edge clamping, a partial last block of rows and of
    columns) bit for bit."""
    for content in (0, 940, 23):
        got, want = _kernel_vs_plain(cuda_device, W=W, H=H, layout=layout,
                                     content=content)
        assert torch.equal(got, want), (content,)


# the cells: (configuration, source size)
CELLS = (("mpv_ewa_hdr10_to_sdr4k", (1920, 1080)),
         ("ffmpeg_hdr10_4k_to_sdr1080p", (3840, 2160)),
         ("mpv_ewa_hdr10_to_sdr4k", (3840, 2160)))


@pytest.mark.cuda
@pytest.mark.parametrize("config,size", CELLS,
                         ids=["play_1080p", "transcode_2160p", "play_2160p"])
def test_render_bit_for_bit_on_card(cuda_device, monkeypatch, config, size):
    """A whole render of the framebench configuration with the front
    equals the render with the plain front bit for bit, frame after frame
    (the peak state too); `render.front_fused` reads 1 a frame."""
    W, H = size
    avs = []
    for seed in (1, 2, 3):
        av = dict(CONFIGS[config]["source_frame"])
        g = np.random.default_rng(seed)
        av["format"] = "yuv420p10le"
        av["data"] = [g.integers(64, 722, (H, W)).astype(np.uint16)] + \
            [g.integers(64, 960, (H // 2, W // 2)).astype(np.uint16)
             for _ in range(2)]
        avs.append(av)

    def render_all():
        d = Deployment(lt, CONFIGS[config], None, cuda_device, 0)
        outs = [d.renderer.render(interop.frame_from_avframe_like(
            av, device=cuda_device), d.target, d.params) for av in avs]
        torch.cuda.synchronize()
        return outs, d.renderer._peak_state.clone()
    before = profiler.counters()
    outs, state = render_all()
    after = profiler.counters()
    assert after["render.front_fused"] - \
        before.get("render.front_fused", 0) == len(avs)
    assert after["front.launches"] - before["front.launches"] == len(avs)
    monkeypatch.setattr(trender, "_front_plan", lambda *a, **k: None)
    plain, plain_state = render_all()
    assert profiler.counters()["front.launches"] == after["front.launches"]
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    assert torch.equal(state, plain_state)

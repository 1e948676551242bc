"""PyTorch port vs the JAX package: the color modules of the HDR and SDR
tails (tone curves, gamut operators, peak detection, sigmoidization)
and kernel K1's plain version for every chain it is built for, on the
CPU.

The same numpy inputs, made from a seed, go through the JAX function
(jitted, as the renderer runs it; the Pallas tail in interpret mode,
forced with LPTPU_FUSED_COLORMAP=1) and its port.  Tolerances, with
the measured figure beside each (CPU, this file's inputs):
- host LUTs (`generate`, `sample`): float64 on both sides, equal;
- the closed-form curves (`apply_device`, the dynamic curves): the
  spline and bt2390 round like the reference to <= 2 ulp; the curves
  through the exact (pow-based) PQ curves differ by XLA's exp/log,
  atol 2e-5 (measured <= 6.2e-6 dynamic, see ROADMAP §3);
- color_map_stage with detected stats, every gamut operator: equal
  (measured 0) but for `highlight`'s knife-edge test, atol 1e-5 on
  < 1e-3 of values; with the static curve atol 5e-4 (measured
  <= 3.3e-4, the exact PQ curves' exp/log);
- K1's plain version vs the Pallas tail, dithered to 8 bits: within
  1 LSB on < 1e-3 of values, histograms equal, stripe sums rtol 1e-5;
  K1's plain version vs the port's own plain stages: atol 1e-6;
- sigmoidize/desigmoidize: atol 3e-7 (measured <= 1.8e-7, exp/log);
- detect_peak: the 64-bin histogram equals the reference's bins, the
  state atol 1e-5.
The `cuda`-marked tests hold each K1 instance against its plain version
on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import tone_mapping as jtm
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.ops import peak_detect as jpeak
from libplacebo_tpu.ops import tone_dynamic as jtone
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget
from libplacebo_tpu.render.renderer import color_map_stage as jcms

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import tone_mapping as ttm
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import dithering as tdith
from libplacebo_tpu_torch.ops import peak_detect as tpeak
from libplacebo_tpu_torch.ops import tone_dynamic as ttone
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
TONE_NAMES = [f.name for f in jtm.TONE_MAP_FUNCTIONS]
GAMUT_OPS = ("clip", "perceptual", "softclip", "relative", "desaturate",
             "saturation", "linear", "darken", "absolute", "highlight")


def _linear_input(h, w, seed=11, scale=30.0):
    rng = np.random.default_rng(seed)
    # linear light with out-of-gamut and negative excursions, like the
    # scaler's output of noise
    return (rng.random((3, h, w)) * scale - 1.0).astype(np.float32)


def _tm_params(mod, name, inverse=False):
    fun = mod.find_tone_map_function(name)
    hdr = (jcs if mod is jtm else tcs).HdrMetadata
    lo, hi = (0.0, 0.58) if inverse else (0.0, 0.75)
    out_hi = 0.75 if inverse else 0.58
    return mod.ToneMapParams(
        function=fun, input_scaling=jcs.HdrScaling.PQ if mod is jtm
        else tcs.HdrScaling.PQ, output_scaling=jcs.HdrScaling.PQ
        if mod is jtm else tcs.HdrScaling.PQ, lut_size=64,
        input_min=lo, input_max=hi, input_avg=0.3, output_min=0.06,
        output_max=out_hi, hdr=hdr())


@pytest.mark.parametrize("name", TONE_NAMES)
def test_tone_curve_generate_and_sample_equal(name):
    """The host LUT and the single-value sample of all twelve curves,
    float64 on both sides: equal."""
    jp, tp = _tm_params(jtm, name), _tm_params(ttm, name)
    np.testing.assert_array_equal(ttm.generate(tp), jtm.generate(jp))
    for x in (0.0, 0.1, 0.33, 0.6, 0.75):
        assert ttm.sample(x, tp) == jtm.sample(x, jp)
    inv = ttm.find_tone_map_function(name).map_inverse is not None
    if inv:
        np.testing.assert_array_equal(
            ttm.generate(_tm_params(ttm, name, True)),
            jtm.generate(_tm_params(jtm, name, True)))


@pytest.mark.parametrize("name", TONE_NAMES)
def test_tone_curve_apply_device(name):
    """The closed-form curve on a float32 tensor vs the reference's
    jitted apply_device: atol 2e-5 in PQ."""
    x = np.linspace(0.0, 0.8, 2049).astype(np.float32)
    for inverse in (False, True):
        jp = _tm_params(jtm, name, inverse)
        if inverse and jp.function.map_inverse is None:
            continue
        ref = np.asarray(jax.jit(lambda v: jtm.apply_device(v, jp))(x))
        out = ttm.apply_device(torch.from_numpy(x),
                               _tm_params(ttm, name, inverse)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ttone.DYNAMIC_TONE_FUNCTIONS)
@pytest.mark.parametrize("stats", [(0.3, 0.75), (0.0, 0.9), (0.2, 0.6)])
def test_dynamic_tone_curves(name, stats):
    """The four curves peak detection drives, with the stats as 0-dim
    tensors, vs the jitted reference: spline and bt2390 within 2 ulp,
    the ST 2094 curves (exact PQ curves) atol 2e-5; tone_vector holds
    the curve's scalars in TONE_KEYS order."""
    avg, mx = stats
    x = np.linspace(0.0, 1.0, 4001).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a, b: jtone.tone_map_dynamic(
        v, name, a, b, 0.06, 0.58))(x, np.float32(mx), np.float32(avg)))
    out = ttone.tone_map_dynamic(torch.from_numpy(x), name,
                                 torch.tensor(mx), torch.tensor(avg), 0.06,
                                 0.58).numpy()
    atol = 2.5e-7 if name in ("spline", "bt2390") else 2e-5
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    vec = ttone.tone_vector(name, torch.tensor(mx), torch.tensor(avg), 0.06,
                            0.58)
    n = len(ttone.TONE_KEYS[name])
    assert vec.shape == (ttone.TONE_VECTOR_LEN,) and not vec[n:].any()
    again = ttone.tone_apply(name, torch.from_numpy(x), list(vec[:n]),
                             0.06, 0.58).numpy()
    np.testing.assert_array_equal(again, out)


_JS, _JD = jcs.color_space_infer_map(jcs.CSP_BT2100_PQ, jcs.CSP_SRGB)
_TS, _TD = tcs.color_space_infer_map(tcs.CSP_BT2100_PQ, tcs.CSP_SRGB)


@pytest.mark.parametrize("gamut", GAMUT_OPS)
@pytest.mark.parametrize("tone", ["spline", "bt2390", None])
def test_color_map_stage_every_gamut_operator(gamut, tone):
    """color_map_stage (tone + gamut in one IPT round trip) with every
    gamut operator, with detected stats (spline, bt2390) and with the
    static metadata curve (None), HDR10 -> sRGB: with stats equal
    (highlight atol 1e-5 on < 1e-3 of values), static atol 5e-4."""
    x = _linear_input(16, 64, seed=1)
    kw = dict(gamut_mapping=gamut)
    if tone:
        kw["tone_mapping_function"] = tone
    jp, tp = JParams(**kw), lt.RenderParams(**kw)
    if tone:
        stats = (np.float32(0.3), np.float32(0.72))
        ref = np.asarray(jax.jit(lambda v, a, b: jcms(v, _JS, _JD, jp, (a, b)))(
            x, *stats))
        out = trender.color_map_stage(torch.from_numpy(x), _TS, _TD, tp,
                                      tuple(torch.tensor(s) for s in stats))
    else:
        ref = np.asarray(jax.jit(lambda v: jcms(v, _JS, _JD, jp))(x))
        out = trender.color_map_stage(torch.from_numpy(x), _TS, _TD, tp)
    d = np.abs(out.numpy() - ref)
    if tone is None:
        assert d.max() <= 5e-4, d.max()
    elif gamut == "highlight":
        assert d.max() <= 1e-5 and (d > 0).mean() < 1e-3, d.max()
    else:
        assert d.max() == 0.0, d.max()


@pytest.mark.parametrize("gamut", ["perceptual", "softclip", "relative"])
def test_map_gamut_and_show_clipping(gamut):
    """map_gamut alone (linear RGB in dst primaries), and the
    show_clipping colorization through color_map_stage: atol 1e-5."""
    from libplacebo_tpu.ops import gamut as jg
    from libplacebo_tpu_torch.ops import gamut as tg
    x = _linear_input(8, 64, seed=2, scale=3.0) * 0.05
    jb = jg.fit_boundary(jcs.primaries_get(jcs.ColorPrimaries.BT_2020),
                         0.06, 0.58)
    jd = jg.fit_boundary(jcs.primaries_get(jcs.ColorPrimaries.BT_709),
                         0.06, 0.58)
    tb = tg.fit_boundary(tcs.primaries_get(tcs.ColorPrimaries.BT_2020),
                         0.06, 0.58)
    td = tg.fit_boundary(tcs.primaries_get(tcs.ColorPrimaries.BT_709),
                         0.06, 0.58)
    ref = np.asarray(jax.jit(lambda v: jg.map_gamut(v, gamut, jb, jd))(x))
    out = tg.map_gamut(torch.from_numpy(x), gamut, tb, td).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    jp = JParams(gamut_mapping=gamut, show_clipping=True)
    tp = lt.RenderParams(gamut_mapping=gamut, show_clipping=True)
    y = _linear_input(8, 64, seed=3)
    stats = (np.float32(0.3), np.float32(0.72))
    ref = np.asarray(jax.jit(lambda v, a, b: jcms(v, _JS, _JD, jp, (a, b)))(
        y, *stats))
    out = trender.color_map_stage(torch.from_numpy(y), _TS, _TD, tp,
                                  tuple(torch.tensor(s) for s in stats))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_sigmoidize_round_trip():
    """sigmoidize and desigmoidize vs the jitted reference: atol 3e-7."""
    x = (np.random.default_rng(0).random(20000) * 1.2 - 0.1) \
        .astype(np.float32)
    for name in ("sigmoidize", "desigmoidize"):
        ref = np.asarray(jax.jit(getattr(jcolor, name))(x))
        out = getattr(tcolor, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=3e-7)
    p = tcolor.SigmoidParams(0.6, 8.0)
    y = tcolor.sigmoidize(torch.from_numpy(x), p)
    back = tcolor.desigmoidize(y, p).numpy()
    np.testing.assert_allclose(back, np.clip(x, 0, 1), atol=2e-6)


@pytest.mark.parametrize("percentile, delayed", [(100.0, False),
                                                 (99.995, False),
                                                 (99.0, True)])
def test_detect_peak_and_applied_stats(percentile, delayed):
    """Same-frame peak detection over two chained frames: the 64-bin
    histogram equals the reference's bins, the applied stats and the
    carried state atol 1e-5."""
    jparams = jpeak.PeakDetectParams(percentile=percentile,
                                     allow_delayed=delayed)
    tparams = tpeak.PeakDetectParams(percentile=percentile,
                                     allow_delayed=delayed)
    jstate, tstate = jpeak.peak_detect_state_init(), \
        tpeak.peak_detect_state_init()
    for seed in (4, 5):
        x = _linear_input(40, 72, seed=seed, scale=20.0)
        _, jact, jbins = jax.jit(lambda v: jpeak._pixel_pq(v, jparams))(x)
        want = np.bincount(np.asarray(jbins)[np.asarray(jact)], minlength=64)
        _, tact, tbins = tpeak._pixel_pq(torch.from_numpy(x), tparams)
        got = torch.bincount(tbins[tact], minlength=64).numpy()
        np.testing.assert_array_equal(got, want)
        ja, jm, jstate2 = jax.jit(lambda v, s: jpeak.applied_stats(
            v, s, jparams, 0.75))(x, jstate)
        ta, tm, tstate = tpeak.applied_stats(torch.from_numpy(x), tstate,
                                             tparams, 0.75)
        np.testing.assert_allclose([float(ta), float(tm)],
                                   [float(ja), float(jm)], atol=1e-5)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate2),
                                   atol=1e-5)
        jstate = jstate2


# ---------------------------------------------------------------------------
# K1: every built instance
# ---------------------------------------------------------------------------

_SDR_2020 = (jcs.ColorSpace(jcs.ColorPrimaries.BT_2020,
                            jcs.ColorTransfer.BT_1886),
             tcs.ColorSpace(tcs.ColorPrimaries.BT_2020,
                            tcs.ColorTransfer.BT_1886))
_SDR_709 = (jcs.ColorSpace(jcs.ColorPrimaries.BT_709,
                           jcs.ColorTransfer.BT_1886),
            tcs.ColorSpace(tcs.ColorPrimaries.BT_709,
                           tcs.ColorTransfer.BT_1886))

# (tone, gamut) instance -> (source, params) of a chain that runs it
_CHAINS = {(0, 0): (_SDR_709, {}),
           (0, 2): (_SDR_2020, dict(gamut_mapping="perceptual")),
           (0, 3): (_SDR_2020, dict(gamut_mapping="softclip"))}
for _t, _name in enumerate(k1.TONES[1:], 1):
    for _g, _op in ((1, "clip"), (2, "perceptual"), (3, "softclip")):
        _CHAINS[(_t, _g)] = ((jcs.CSP_BT2100_PQ, tcs.CSP_BT2100_PQ),
                             dict(tone_mapping_function=_name,
                                  gamut_mapping=_op))
_CHAINS["pass_clip"] = (_SDR_2020, dict(gamut_mapping="clip"))


def _tails(key, h, w, dither=True):
    """(port tail, JAX tail, source spaces, params) for a chain."""
    (jsrc, tsrc), kw = _CHAINS[key]
    if not dither:
        kw = dict(kw, dither=None)
    js, jd = jcs.color_space_infer_map(jsrc, jcs.CSP_SRGB)
    ts, td = tcs.color_space_infer_map(tsrc, tcs.CSP_SRGB)
    jp, tp = JParams(**kw), lt.RenderParams(**kw)
    use_peak = ts.is_hdr()
    jt = JTarget(w=w, h=h, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8)
    jtail = JRenderer._fused_tail(jp, js, jd, jt, use_peak, None, False, w,
                                  h, JRectF(0, 0, w, h))
    ttail = lt.Renderer(device="cpu")._fused_tail(tp, ts, td, tt, use_peak,
                                                  w, h, TRectF(0, 0, w, h))
    return ttail, jtail, (ts, td), tp, use_peak


def _capture_plan(monkeypatch):
    seen = []
    launch = k1.color_map_tail

    def capture(img, plan, tone, lut):
        seen.append((img, plan, tone, lut))
        return launch(img, plan, tone, lut)
    monkeypatch.setattr(k1, "color_map_tail", capture)
    return seen


@pytest.mark.parametrize("key", sorted(_CHAINS, key=str))
def test_k1_plain_matches_pallas_tail(monkeypatch, key):
    """K1's plain version of each chain vs fused_pointwise(interpret=
    True) running the reference's tail_fn on the same input and stats:
    within 1 LSB on < 1e-3 of values, histograms equal, stripe sums
    rtol 1e-5; the chain runs the instance it is listed for."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    seen = _capture_plan(monkeypatch)
    h, w = 16, 128
    ttail, jtail, _, _, use_peak = _tails(key, h, w)
    assert ttail is not None and jtail is not None
    scale = 30.0 if use_peak else 1.2
    x = _linear_input(h, w, seed=21, scale=scale)
    stats = (np.float32(0.31), np.float32(0.74)) if use_peak else ()
    jres = jtail(jnp.asarray(x), tuple(jnp.float32(s) for s in stats)
                 if use_peak else None)
    out, tpart = ttail(torch.from_numpy(x), tuple(torch.tensor(s)
                                                  for s in stats)
                       if use_peak else None)
    plan = seen[0][1]
    if key != "pass_clip":
        assert (plan.tone, plan.gamut) == key
    else:
        assert plan.gamut == 0 and plan.flags == (k1.FLAG_PASS_MATRIX |
                                                  k1.FLAG_PASS_CLAMP)
    ref = np.asarray(jres[0] if use_peak else jres)
    d = np.abs(out.numpy() - ref)
    assert d.max() <= LSB + 1e-6, d.max()
    assert (d > 1e-6).mean() < 1e-3, (d > 1e-6).mean()
    if use_peak:
        jpart = np.asarray(jres[1])
        np.testing.assert_array_equal(tpart[:, 0].numpy(), jpart[:, 0])
        np.testing.assert_allclose(tpart[:, 1, :3].numpy(),
                                   jpart[:, 1, :3], rtol=1e-5)
    else:
        assert tpart is None


@pytest.mark.parametrize("key", sorted(_CHAINS, key=str))
def test_k1_plain_is_the_plain_stages(monkeypatch, key):
    """K1's plain version (packed constants) equals the port's own
    stages composed as the reference's tail_fn composes them: atol
    1e-6, partials as block_partials."""
    h, w = 8, 128
    ttail, _, (ts, td), tp, use_peak = _tails(key, h, w)
    x = torch.from_numpy(_linear_input(h, w, seed=22,
                                       scale=30.0 if use_peak else 1.2))
    stats = (torch.tensor(0.28), torch.tensor(0.71)) if use_peak else None
    out, part = ttail(x, stats)
    y = trender.color_map_stage(x, ts, td, tp, stats)
    y = tcolor.delinearize(y, td)
    y = tdith.dither(y, 8, tdith.DitherParams(transfer=td.transfer))
    np.testing.assert_allclose(out.numpy(), y.numpy(), atol=1e-6)
    if use_peak:
        ref = tpeak.block_partials(x, tpeak.PeakDetectParams())
        np.testing.assert_array_equal(part[0, 0].numpy(), ref[0].numpy())


def test_k1_plan_refuses_what_no_instance_runs():
    """plan_tail admits a chain only where a templated instance exists:
    the static curve, same-frame stats, other gamut operators,
    show_clipping and non-sRGB targets get none, and the renderer runs
    those tails on K1's generic instance instead; a tail the reference
    runs plain (an ICC target, a conversion LUT) gets no K1 tail."""
    h, w = 8, 128
    ts, td = tcs.color_space_infer_map(tcs.CSP_BT2100_PQ, tcs.CSP_SRGB)
    r = lt.Renderer(device="cpu")
    tt = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8)

    def tail(params, use_peak=True, target=tt, dst=td):
        return r._fused_tail(params, ts, dst, target, use_peak, w, h,
                             TRectF(0, 0, w, h))
    assert tail(lt.RenderParams(upscaler="ewa_lanczos")).plan.tone == 1
    _, bt709 = tcs.color_space_infer_map(tcs.CSP_BT2100_PQ,
                                         tcs.ColorSpace(
                                             tcs.ColorPrimaries.BT_709,
                                             tcs.ColorTransfer.BT_1886))
    for kw, use_peak, dst in (
            ({}, False, td),
            (dict(peak_detect=lt.PeakDetectParams(allow_delayed=False)),
             True, td),
            (dict(gamut_mapping="relative"), True, td),
            (dict(show_clipping=True), True, td),
            ({}, True, bt709)):
        run = tail(lt.RenderParams(**kw), use_peak=use_peak, dst=dst)
        assert run.plan.tone == k1.GENERIC, kw
        params = lt.RenderParams(**kw)
        chain = trender.color_chain(ts, dst, params, use_peak)
        fused = use_peak and params.peak_detect.allow_delayed
        assert k1.plan_tail(chain, params, dst, tt, fused, tdith.dither_lut(
            tdith.DitherParams(), 0)) is None, kw
    from libplacebo_tpu_torch.core import icc as ticc
    from test_icc_h274 import _make_profile
    icc_target = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8,
                           icc=ticc.parse_icc(_make_profile()))
    assert tail(lt.RenderParams(), target=icc_target) is None
    lut = lt.parse_cube("LUT_1D_SIZE 2\n0 0 0\n1 1 1")
    assert tail(lt.RenderParams(lut=lut, lut_type="conversion")) is None
    assert tail(lt.RenderParams(lut=lut, lut_type="native")) is not None
    assert len(k1.INSTANCES) == 15
    with pytest.raises(ValueError):
        k1.TailPlan(np.zeros(k1.NCONST, np.float32), tone=1, gamut=0)
    with pytest.raises(ValueError):
        k1.TailPlan(np.zeros(k1.NCONST, np.float32), tone=k1.GENERIC,
                    gamut=k1.GENERIC)


def test_k1_ops_per_pixel_per_instance(monkeypatch):
    """The operation count behind each instance's bound: the flagship
    chain keeps its 1180, the pass-through chain is its output stage
    and dither, softclip's hue shift counts its second pass over both
    fits."""
    counts = {}
    for key in _CHAINS:
        seen = _capture_plan(monkeypatch)
        ttail, _, _, _, use_peak = _tails(key, 8, 128)
        ttail(torch.from_numpy(_linear_input(8, 128)),
              (torch.tensor(0.3), torch.tensor(0.7)) if use_peak else None)
        plan = seen[-1][1]
        counts[key] = k1.ops_per_pixel(plan.consts, plan.instance)
        monkeypatch.undo()
    assert counts[(1, 2)] == 1180
    assert counts[(0, 0)] == 36 + 12
    assert counts["pass_clip"] == 36 + 12 + 15 + 6
    assert counts[(2, 3)] > counts[(2, 2)] > counts[(2, 1)]
    assert counts[(3, 2)] - counts[(1, 2)] == 89 - 12


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dither", [True, False])
@pytest.mark.parametrize("key", sorted(_CHAINS, key=str))
def test_k1_instance_matches_plain_on_card(cuda_device, monkeypatch, key,
                                           dither):
    """Each K1 instance on the card vs its plain version on the same
    input: within 1 LSB on < 1e-3 of values (recorded: exact or not),
    histograms equal, stripe sums rtol 1e-5; two launches give identical
    partials and outputs."""
    seen = _capture_plan(monkeypatch)
    h, w = 64, 256
    ttail, _, _, _, use_peak = _tails(key, h, w, dither)
    x = _linear_input(h, w, seed=23, scale=30.0 if use_peak else 1.2)
    stats = (torch.tensor(0.3), torch.tensor(0.72)) if use_peak else None
    ttail(torch.from_numpy(x), stats)
    _, plan, tone, lut = seen[0]
    img = torch.from_numpy(x).to(cuda_device)
    tone = tone.to(cuda_device) if tone is not None else None
    lut = lut.to(cuda_device) if lut is not None else None
    before = k1.launches
    out, part = k1.color_map_tail(img, plan, tone, lut)
    out2, part2 = k1.color_map_tail(img, plan, tone, lut)
    assert k1.launches == before + 2
    ref, rpart = k1.color_map_plain(img, plan.consts, tone, lut,
                                    plan.instance)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    print(f"K1 {key} dither={dither}: max {diff.max().item():.3g}, "
          f"differing {(diff > 0).float().mean().item():.3g}")
    assert diff.max().item() <= LSB + 1e-6
    assert (diff > 1e-6).float().mean().item() < 1e-3
    assert torch.equal(out, out2)
    if use_peak:
        assert torch.equal(part[:, 0], rpart[:, 0])
        torch.testing.assert_close(part[:, 1, :3], rpart[:, 1, :3],
                                   rtol=1e-5, atol=0.0)
        assert torch.equal(part, part2)
    else:
        assert part is None and rpart is None

"""PyTorch port vs the JAX package: the color modules of the HDR and SDR
tails (tone curves, gamut operators, peak detection, sigmoidization)
and kernel K1's plans and operation counts, on the CPU.

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
- sigmoidize/desigmoidize: atol 3e-7 (measured <= 1.8e-7, exp/log);
- detect_peak: the 64-bin histogram equals the reference's bins, the
  state atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import tone_mapping as jtm
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.ops import peak_detect as jpeak
from libplacebo_tpu.ops import tone_dynamic as jtone
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import color_map_stage as jcms

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import tone_mapping as ttm
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import peak_detect as tpeak
from libplacebo_tpu_torch.ops import tone_dynamic as ttone
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

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
# K1: its plans and operation counts (its tails against the reference:
# tests/test_torch_color_tails.py)
# ---------------------------------------------------------------------------

def test_k1_plan_refuses_what_no_instance_runs():
    """K1 plans every tail the renderer fuses — the players', the static
    curve, same-frame stats, other gamut operators, show_clipping and
    non-sRGB targets — for the instance compiled for it; only a tail the
    reference runs plain (an ICC target, a conversion LUT) gets no K1
    tail, and a plan needs its GenericSpec."""
    h, w = 8, 128
    ts, td = tcs.color_space_infer_map(tcs.CSP_BT2100_PQ, tcs.CSP_SRGB)
    r = lt.Renderer(device="cpu")
    tt = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8)

    def tail(params, use_peak=True, target=tt, dst=td):
        return r._fused_tail(params, ts, dst, target, use_peak, w, h,
                             TRectF(0, 0, w, h))
    mode = tail(lt.RenderParams(upscaler="ewa_lanczos")).plan.instance
    assert (k1.G_DYNAMIC[mode.curve], k1.G_GAMUTS[mode.gamut]) == \
        ("spline", "perceptual") and mode.flags & k1.GFLAG_PEAK
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
        assert run is not None and isinstance(run.plan, k1.TailPlan), kw
    from libplacebo_tpu_torch.core import icc as ticc
    from test_icc_h274 import _make_profile
    icc_target = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8,
                           icc=ticc.parse_icc(_make_profile()))
    assert tail(lt.RenderParams(), target=icc_target) is None
    lut = lt.parse_cube("LUT_1D_SIZE 2\n0 0 0\n1 1 1")
    assert tail(lt.RenderParams(lut=lut, lut_type="conversion")) is None
    assert tail(lt.RenderParams(lut=lut, lut_type="native")) is not None
    with pytest.raises(ValueError):
        k1.TailPlan(np.zeros(k1.NCONST, np.float32), None)


def test_k1_ops_per_pixel_per_instance():
    """The operation count behind each tail's bound: the players' chain
    (spline, perceptual, sRGB, dither) counts 1180, the pass-through
    chain is its output stage and dither, softclip's hue shift counts
    its second pass over both fits."""
    from test_torch_color_tails import TAILS, _tail_setup
    counts = {}
    for key in TAILS:
        if key.startswith("chain-"):
            ttail, *_ = _tail_setup(key, 8, 128)
            counts[key] = k1.ops_per_pixel(ttail.plan.consts,
                                           ttail.plan.instance)
    assert counts["chain-spline-perceptual"] == 1180
    assert counts["chain-pass"] == 36 + 12
    assert counts["chain-pass-clip"] == 36 + 12 + 15 + 6
    assert counts["chain-bt2390-softclip"] > \
        counts["chain-bt2390-perceptual"] > counts["chain-bt2390-clip"]
    assert counts["chain-st2094-40-perceptual"] - \
        counts["chain-spline-perceptual"] == 89 - 12

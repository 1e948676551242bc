"""PyTorch port vs the JAX package: the scaling slice's modules on the
CPU at small sizes, inputs made from a seed with numpy.

Tolerances:
- filters (`core/filters.py`): exact — the same float64 numpy on both
  sides; the 18 configs of tests/golden/reference_golden.npz (sampled
  from the C reference) within that file's own atol 2e-6;
- polar samplers (`ops/polar.py`) against the JAX `sample_polar`, run
  eagerly (jitted, its unrolled gather path compiles for seconds; the
  jitted form measured the same): max abs <= 2e-6 on [0, 1] inputs (the
  port sums each phase as one convolution, in another order; measured
  <= 2.4e-7), and <= 2e-6 of the peak on NORM-scaled HDR input up to 49
  (measured 1.1e-5 abs);
- separable samplers (`ops/sampling.py`) against the jitted JAX
  functions: max abs <= 2e-6 on [0, 1] inputs (measured <= 2.4e-7).
"""
import jax
import numpy as np
import pytest
import torch

from libplacebo_tpu.core import filters as jflt
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.ops import polar as jpolar
from libplacebo_tpu.ops import sampling as jsamp

from libplacebo_tpu_torch.core import filters as tflt
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.ops import polar as tpolar
from libplacebo_tpu_torch.ops import sampling as tsamp

CONFIGS = [c.name for c in jflt.FILTER_CONFIGS]
FUNCTIONS = [f.name for f in jflt.FILTER_FUNCTIONS]
GOLDEN_NAMES = [
    "bilinear", "spline16", "spline36", "spline64", "lanczos",
    "ewa_lanczos", "ewa_lanczossharp", "ewa_jinc", "bicubic", "hermite",
    "mitchell", "catmull_rom", "robidoux", "gaussian", "sinc", "ginseng",
    "ewa_hann", "ewa_ginseng",
]
TOL = 2e-6


def _img(seed, h=24, w=32, scale=1.0):
    x = np.random.default_rng(seed).random((3, h, w)) * scale
    return x.astype(np.float32)


def _rects(rect):
    return (JRectF(*rect), TRectF(*rect)) if rect else (None, None)


def test_every_config_and_function_ported():
    assert [c.name for c in tflt.FILTER_CONFIGS] == CONFIGS
    assert len(CONFIGS) == 30
    assert [f.name for f in tflt.FILTER_FUNCTIONS] == FUNCTIONS
    assert len(FUNCTIONS) == 29


@pytest.mark.parametrize("name", CONFIGS)
def test_filter_config_equal(name):
    """Every field, the samples, both cutoff scans and `generate` (polar
    LUT or separable rows) are exact."""
    jc, tc = jflt.find_filter_config(name), tflt.find_filter_config(name)
    for f in ("radius", "clamp", "blur", "taper", "polar", "antiring",
              "params", "wparams", "description"):
        assert getattr(jc, f) == getattr(tc, f), f
    assert (int(jc.allowed), int(jc.recommended)) == \
        (int(tc.allowed), int(tc.recommended))
    assert jc.kernel.name == tc.kernel.name
    assert (jc.window and jc.window.name) == (tc.window and tc.window.name)
    xs = np.linspace(0.0, 5.0, 501)
    np.testing.assert_array_equal(jflt.sample_filter(jc, xs),
                                  tflt.sample_filter(tc, xs))
    for cutoff in (0.0, 1e-3):
        assert jflt.filter_cutoffs(jc, cutoff) == \
            tflt.filter_cutoffs(tc, cutoff)
    for lut, cutoff, max_row in ((64, 0.0, 0), (256, 1e-3, 4)):
        jg = jflt.generate(jc, lut, cutoff, max_row)
        tg = tflt.generate(tc, lut, cutoff, max_row)
        assert (jg.radius, jg.radius_zero, jg.row_size, jg.insufficient) \
            == (tg.radius, tg.radius_zero, tg.row_size, tg.insufficient)
        np.testing.assert_array_equal(jg.weights, tg.weights)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_filter_function_equal(name):
    jf, tf = jflt.find_filter_function(name), tflt.find_filter_function(name)
    assert (jf.radius, jf.resizable, jf.params, jf.tunable, jf.opaque) == \
        (tf.radius, tf.resizable, tf.params, tf.tunable, tf.opaque)
    xs = np.linspace(0.0, jf.radius, 257)
    np.testing.assert_array_equal(jf.weight(xs, jf.radius, *jf.params),
                                  tf.weight(xs, tf.radius, *tf.params))


@pytest.fixture(scope="module")
def golden():
    import os
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "reference_golden.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_filter_matches_reference_golden(golden, name):
    """The C reference's pl_filter_sample, dumped into the golden file."""
    ref = golden[f"filter_{name}"]
    radius = float(golden[f"filter_{name}_radius"][0])
    ours = tflt.sample_filter(tflt.find_filter_config(name),
                              np.linspace(0.0, radius, len(ref)))
    np.testing.assert_allclose(ours, ref, atol=TOL, err_msg=name)


@pytest.mark.parametrize("usage", ["UPSCALING", "DOWNSCALING",
                                   "FRAME_MIXING", "SCALING", "ALL"])
def test_find_filter_config_usage(usage):
    """find_filter_config(name, usage) gives the reference's answer for
    every name (and an unknown one)."""
    ju, tu = getattr(jflt.FilterUsage, usage), getattr(tflt.FilterUsage,
                                                       usage)
    assert int(ju) == int(tu)
    for name in CONFIGS + ["no_such_filter"]:
        jc, tc = jflt.find_filter_config(name, ju), \
            tflt.find_filter_config(name, tu)
        assert (jc and jc.name) == (tc and tc.name), name


# ---------------------------------------------------------------------------
# Polar (EWA) samplers
# ---------------------------------------------------------------------------

# (filter, source h, w, destination h, w, rect, anti-ringing, input
# scale, the path the reference takes)
POLAR_CASES = {
    "phased_ar_2x": ("ewa_lanczos4sharpest", 24, 32, 48, 64, None, 0.8,
                     1.0, "phased"),
    "direct_2x": ("ewa_lanczos4sharpest", 24, 32, 48, 64, None, 0.0,
                  1.0, "direct"),
    "phased_9_phases": ("ewa_lanczossharp", 24, 32, 72, 96, None, 0.0,
                        1.0, "phased"),
    "phased_9_phases_ar": ("ewa_lanczossharp", 24, 32, 72, 96, None, 0.5,
                           1.0, "phased"),
    "gather": ("ewa_lanczos", 24, 32, 37, 51, None, 0.0, 1.0, "gather"),
    "gather_ar": ("ewa_lanczos", 24, 32, 37, 51, None, 0.8, 1.0, "gather"),
    "downscale_stride2_ar": ("ewa_lanczos", 24, 32, 12, 16, None, 0.8, 1.0,
                             "phased"),
    "downscale_gather": ("ewa_robidoux", 24, 32, 17, 23, None, 0.0, 1.0,
                         "gather"),
    "cropped_gather_ar": ("ewa_lanczos", 24, 32, 40, 56,
                          (2.5, 1.25, 22.3, 21.1), 0.8, 1.0, "gather"),
    "cropped_28_phases_ar": ("ewa_lanczos", 24, 32, 40, 56,
                             (2.5, 1.25, 22.5, 21.25), 0.8, 1.0, "phased"),
    "cropped_phased": ("ewa_hann", 24, 32, 40, 40, (2.0, 3.0, 22.0, 23.0),
                       0.8, 1.0, "phased"),
    "hdr_phased_ar": ("ewa_lanczos4sharpest", 24, 32, 48, 64, None, 0.8,
                      49.0, "phased"),
    "hdr_gather_ar": ("ewa_lanczos4sharpest", 24, 32, 37, 51, None, 0.8,
                      49.0, "gather"),
}


def _polar_pair(case, seed=11):
    name, h, w, dh, dw, rect, ar, scale, _ = POLAR_CASES[case]
    x = _img(seed, h, w, scale)
    jr, tr = _rects(rect)
    ref = np.asarray(jpolar.sample_polar(
        x, jflt.find_filter_config(name), dh, dw, jr, antiring=ar))
    out = tpolar.sample_polar(torch.from_numpy(x),
                              tflt.find_filter_config(name), dh, dw, tr,
                              antiring=ar).numpy()
    return x, out, ref


@pytest.mark.parametrize("case", list(POLAR_CASES))
def test_sample_polar(case):
    name, h, w, dh, dw, rect, ar, scale, route = POLAR_CASES[case]
    r = TRectF(*rect) if rect else TRectF(0, 0, w, h)
    plan = tpolar.plan_polar(tflt.find_filter_config(name), h, w, dh, dw, r)
    assert tpolar._route(plan, dh, dw, ar) == route
    _, out, ref = _polar_pair(case)
    assert out.shape == ref.shape == (3, dh, dw)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * scale)
    if ar > 0 and dh > h:
        # anti-ringing moved the upscaled output: the case ran it (a
        # downscale of noise stays inside its soft extrema)
        plain = tpolar.sample_polar(
            torch.from_numpy(_img(11, h, w, scale)),
            tflt.find_filter_config(name), dh, dw,
            TRectF(*rect) if rect else None).numpy()
        assert np.abs(plain - out).max() > 100 * TOL * scale


def test_polar_config3_geometry():
    """1080p -> 2160p with ewa_lanczos4sharpest: 2 x 2 phases at stride
    1, 8 taps an axis, 41 taps a phase inside the radius and 4 inside
    the main lobe (the anti-ringing taps)."""
    cfg = tflt.find_filter_config("ewa_lanczos4sharpest")
    key = (cfg, 1080, 1920, 2160, 3840, TRectF(0, 0, 1920, 1080), 0.8)
    plan = tpolar.plan_polar(*key[:6])
    assert tpolar._route(plan, 2160, 3840, 0.8) == "phased"
    assert plan["taps"] == 8
    pp = tpolar._phase_plan(*key)
    assert (pp.Py, pp.Px, pp.sy, pp.sx) == (2, 2, 1, 1)
    assert [int((w != 0).sum()) for w in pp.wk] == [41] * 4
    assert pp.ar_w.shape == (4, 4) and (pp.ar_w > 0).all()


# ---------------------------------------------------------------------------
# Separable samplers
# ---------------------------------------------------------------------------

def _cmp(jfn, tfn, x, tol=TOL):
    ref = np.asarray(jax.jit(jfn)(x))
    out = tfn(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    return out


@pytest.mark.parametrize("mode", ["gather", "matmul"])
@pytest.mark.parametrize("axis,dst", [(-2, 37), (-1, 51)])
@pytest.mark.parametrize("ar", [0.0, 0.8])
def test_sample_ortho_modes(mode, axis, dst, ar):
    """Both modes on both axes at a non-periodic upscale (lanczos, which
    has negative lobes), with and without anti-ringing."""
    x = _img(12)
    out = _cmp(lambda a: jsamp.sample_ortho(
        a, jflt.find_filter_config("lanczos"), dst, axis, mode=mode,
        antiring=ar),
        lambda a: tsamp.sample_ortho(
            a, tflt.find_filter_config("lanczos"), dst, axis, mode=mode,
            antiring=ar), x)
    if ar > 0:
        plain = tsamp.sample_ortho(torch.from_numpy(x),
                                   tflt.find_filter_config("lanczos"), dst,
                                   axis, mode=mode).numpy()
        assert np.abs(plain - out).max() > 1e-3


@pytest.mark.parametrize("name,axis,dst", [
    ("lanczos", -1, 64), ("spline36", -2, 48), ("lanczos", -2, 36)])
def test_sample_ortho_phased_antiring(name, axis, dst):
    """Anti-ringing on the phased path (periodic upscales)."""
    _cmp(lambda a: jsamp.sample_ortho(a, jflt.find_filter_config(name), dst,
                                      axis, antiring=0.7),
         lambda a: tsamp.sample_ortho(a, tflt.find_filter_config(name), dst,
                                      axis, antiring=0.7), _img(13))


@pytest.mark.parametrize("name,axis,dst,mode", [
    ("lanczos", -1, 13, "auto"), ("lanczos", -2, 12, "auto"),
    ("lanczos", -2, 17, "gather"), ("bilinear", -1, 51, "matmul"),
    ("bilinear", -2, 48, "auto"), ("hermite", -1, 51, "gather")])
def test_sample_ortho_antiring_no_op(name, axis, dst, mode):
    """Anti-ringing does nothing on a downscale or with a filter without
    negative lobes, by the reference's rule: the output equals the one
    without it, and the reference's."""
    x = _img(14)
    cfg = tflt.find_filter_config(name)
    out = _cmp(lambda a: jsamp.sample_ortho(
        a, jflt.find_filter_config(name), dst, axis, mode=mode,
        antiring=0.9),
        lambda a: tsamp.sample_ortho(a, cfg, dst, axis, mode=mode,
                                     antiring=0.9), x)
    np.testing.assert_array_equal(out, tsamp.sample_ortho(
        torch.from_numpy(x), cfg, dst, axis, mode=mode).numpy())


def test_ortho_weights_equal():
    for name, src, dst, s0, s1 in (("lanczos", 32, 51, 0.0, 32.0),
                                   ("mitchell", 32, 13, 1.5, 30.0),
                                   ("spline64", 24, 24, -0.25, 23.75)):
        ji, jw = jsamp.ortho_weights(jflt.find_filter_config(name), src,
                                     dst, s0, s1)
        ti, tw = tsamp.ortho_weights(tflt.find_filter_config(name), src,
                                     dst, s0, s1)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jw, tw)


@pytest.mark.parametrize("ar", [0.0, 0.6])
def test_resize_separable_cropped(ar):
    """A cropped, non-periodic resize with a separate downscaler, both
    pass orders."""
    jr, tr = _rects((1.5, 2.25, 30.5, 22.0))
    for dh, dw in ((50, 70), (16, 70)):
        _cmp(lambda a: jsamp.resize_separable(
            a, dh, dw, jflt.find_filter_config("lanczos"), jr,
            cfg_down=jflt.find_filter_config("hermite"), antiring=ar),
            lambda a: tsamp.resize_separable(
                a, dh, dw, tflt.find_filter_config("lanczos"), tr,
                cfg_down=tflt.find_filter_config("hermite"), antiring=ar),
            _img(15))


@pytest.mark.parametrize("dst", [(37, 51), (17, 20)])
@pytest.mark.parametrize("rect", [None, (1.5, 2.25, 30.5, 22.0)])
def test_direct_samplers(dst, rect):
    """sample_nearest, sample_bilinear and sample_oversample (with and
    without its snapping threshold), up and down."""
    jr, tr = _rects(rect)
    x = _img(16)
    _cmp(lambda a: jsamp.sample_nearest(a, *dst, jr),
         lambda a: tsamp.sample_nearest(a, *dst, tr), x, tol=0.0)
    _cmp(lambda a: jsamp.sample_bilinear(a, *dst, jr),
         lambda a: tsamp.sample_bilinear(a, *dst, tr), x)
    for thr in (0.0, 0.2):
        _cmp(lambda a: jsamp.sample_oversample(a, *dst, jr, threshold=thr),
             lambda a: tsamp.sample_oversample(a, *dst, tr, threshold=thr),
             x)

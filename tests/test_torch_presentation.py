"""PyTorch port: the renderer's presentation stages against the JAX
package on the CPU — rotation, backgrounds and borders around a target
crop, corner rounding, target blending, alpha, cone distortion, each
color-adjustment field, contrast recovery, the tone-curve visualizer,
the three presets, and path F (a letterboxed HDR10 film with
HIGH_QUALITY_PARAMS) over 3 chained frames.

The JAX side runs its fused tail (LPTPU_FUSED_COLORMAP=1) wherever its
gates allow, as tests/test_torch_render.py does.

Tolerances.
- Undithered float outputs: max |difference| <= 2e-5 (measured <= 6e-7;
  the port rounds where XLA's jitted CPU code does, but not every fusion
  is mirrored).
- Undithered outputs of a plain tail with a static tone curve (contrast
  recovery, the visualizer): max <= 5e-3, PSNR >= 80 dB.  The plain
  static curve differs from the reference's without either feature by
  up to 4.4e-3 (86.4 dB) on this frame: XLA's pow, exp and log against
  PyTorch's (ROADMAP §3, slice 7); measured with recovery <= 2.5e-3.
- 8-bit dithered outputs: fewer than 1.2e-3 of the values differing
  (path C's gate, tests/test_torch_dovi.py), more than 1 LSB on at most
  1e-4 of them, PSNR >= 75 dB; the peak state atol 1e-5.  The EWA's
  summation order differs from the reference's in the last ulp (F1,
  ROADMAP §3) and K1's perceptual tail magnifies it on knife-edge
  pixels: measured up to 5.7e-4 differing, 5.1e-5 more than 1 LSB (cone
  distortion; the flagship's frame alone 1.0e-5, one pixel 12 LSB).
- The reference tests' own checks (tests/test_render_features.py) with
  their tolerances, on the port's output.
"""
from dataclasses import asdict

import numpy as np
import pytest

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.ops import deband as jdeband
from libplacebo_tpu.ops.distort import DistortParams as JDistort
from libplacebo_tpu.ops.peak_detect import PeakDetectParams as JPeak
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0
FLOAT_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _jax_fused_tail(monkeypatch):
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")


def _rgb(h, w, seed, comps=3):
    return np.random.default_rng(seed).random((h, w, comps)).astype(
        np.float32)


def _rgb_frames(arr, pq=False):
    return (jfr.frame_from_rgb(arr, color=jcs.CSP_BT2100_PQ if pq
                               else jcs.CSP_SRGB),
            lt.frame_from_rgb(arr, color=lt.CSP_BT2100_PQ if pq
                              else lt.CSP_SRGB, device="cpu"))


def _yuv(h, w, seed, bits=8):
    rng = np.random.default_rng(seed)
    lo, sy, sc = (16, 219, 224) if bits == 8 else (64, 876, 896)
    dt = np.uint8 if bits == 8 else np.uint16
    return ((rng.random((h, w)) * sy + lo).astype(dt),
            (rng.random((h // 2, w // 2)) * sc + lo).astype(dt),
            (rng.random((h // 2, w // 2)) * sc + lo).astype(dt))


def _yuv_frames(yuv, bits=8, max_luma=0.0):
    """The flagship's frame (limited BT.2020-NC PQ) on both sides."""
    jc = jcs.CSP_BT2100_PQ if not max_luma else jcs.ColorSpace(
        jcs.ColorPrimaries.BT_2020, jcs.ColorTransfer.PQ,
        jcs.HdrMetadata(max_luma=max_luma))
    tc = lt.CSP_BT2100_PQ if not max_luma else lt.ColorSpace(
        lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
        lt.HdrMetadata(max_luma=max_luma))
    jf = jfr.frame_from_yuv420p(*yuv, color=jc, bit_depth=bits,
                                repr=jcs.ColorRepr(
                                    sys=jcs.ColorSystem.BT_2020_NC,
                                    levels=jcs.ColorLevels.LIMITED,
                                    bits=jcs.BitEncoding(bits, bits, 0)))
    tf = lt.frame_from_yuv420p(*yuv, color=tc, bit_depth=bits, device="cpu",
                               repr=lt.ColorRepr(
                                   sys=lt.ColorSystem.BT_2020_NC,
                                   levels=lt.ColorLevels.LIMITED,
                                   bits=lt.BitEncoding(bits, bits, 0)))
    return jf, tf


def _targets(w, h, crop=None, bit_depth=0, data=None):
    return (jr.Target(w=w, h=h, color=jcs.CSP_SRGB, bit_depth=bit_depth,
                      crop=JRectF(*crop) if crop else None, data=data),
            lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=bit_depth,
                      crop=lt.RectF(*crop) if crop else None, data=data))


def _params(plain=True, **kw):
    """Both sides' RenderParams; `plain` turns off dither and peak
    detection as the reference's feature tests do.  Objects as plain
    values: color_adjustment a dict, cone (flags, strength) and distort
    a dict; the port's ColorAdjustment and ConeParams are carried from
    the reference's (carry.py)."""
    jk, tk = {}, {}
    if plain:
        kw.setdefault("dither", None)
        kw.setdefault("peak_detect", None)
    for k, v in kw.items():
        if k == "color_adjustment":
            jk[k] = jcs.ColorAdjustment(**v)
            tk[k] = carry.color_adjustment_from_fields(asdict(jk[k]))
        elif k == "cone":
            jk[k] = jcs.ConeParams(jcs.Cone(v[0]), v[1])
            tk[k] = carry.cone_params_from_fields(asdict(jk[k]))
        elif k == "distort":
            jk[k], tk[k] = JDistort(**v), lt.DistortParams(**v)
        else:
            jk[k] = tk[k] = v
    return jr.RenderParams(**jk), lt.RenderParams(**tk)


def _render(frames, targets, params):
    """(JAX output, port output, the port's (K1, plain, ineligible) tail
    counts) of one render each."""
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    out_j = np.asarray(jr.Renderer().render(frames[0], targets[0],
                                            params[0]))
    out_t = lt.Renderer(device="cpu").render(frames[1], targets[1],
                                             params[1]).numpy()
    assert out_t.shape == out_j.shape
    return out_j, out_t, (trr.k1_tails, trr.plain_tails,
                          trr.ineligible_tails)


def _assert_float(out_t, out_j):
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=FLOAT_ATOL)


def _psnr(d):
    return -10 * np.log10(max(float((d ** 2).mean()), 1e-20))


def _assert_toned(out_t, out_j):
    d = np.abs(out_t - out_j)
    assert d.max() <= 5e-3 and _psnr(d) >= 80.0, (d.max(), _psnr(d))


def _assert_gate(out_t, out_j):
    d = np.abs(out_t - out_j)
    assert (d > 1e-6).mean() < 1.2e-3, (d > 1e-6).mean()
    assert (d > LSB + 1e-6).mean() <= 1e-4, (d > LSB + 1e-6).mean()
    assert _psnr(d) >= 75.0, _psnr(d)


def test_rotation_matches_rot90():
    """Reference test_rotation (:30): a quarter turn of an RGB frame,
    the crop in the turned image."""
    arr = _rgb(16, 32, 0)
    frames = _rgb_frames(arr)
    for f in frames:
        f.rotation = 1
    frames[0].crop = JRectF(0, 0, 16, 32)
    frames[1].crop = lt.RectF(0, 0, 16, 32)
    out_j, out_t, _ = _render(frames, _targets(16, 32), _params())
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t, np.rot90(np.moveaxis(arr, -1, 0),
                                               k=1, axes=(-2, -1)),
                               atol=2e-2)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_rotation_keeps_k1(k):
    """The flagship's frame turned k quarters and scaled 2x by the EWA:
    rotation keeps the tail on K1 (dither and peak detection on)."""
    frames = _yuv_frames(_yuv(64, 128, 40 + k))
    for f in frames:
        f.rotation = k
    if k % 2:
        frames[0].crop = JRectF(0, 0, 64, 128)
        frames[1].crop = lt.RectF(0, 0, 64, 128)
    w, h = (128, 256) if k % 2 else (256, 128)
    out_j, out_t, tails = _render(frames, _targets(w, h, bit_depth=8),
                                  _params(False, upscaler="ewa_lanczos"))
    assert tails == (1, 0, 0)
    _assert_gate(out_t, out_j)


def test_background_solid():
    """Reference :40: a solid border around the target crop."""
    frames = _rgb_frames(_rgb(16, 16, 0))
    out_j, out_t, _ = _render(frames, _targets(32, 32, (8, 8, 24, 24)),
                              _params(background_color=(1.0, 0.0, 0.0)))
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 0, 0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out_t[:, -1, -1], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out_t[:, 8:24, 8:24],
                               np.moveaxis(_rgb(16, 16, 0), -1, 0),
                               atol=2e-2)


def test_background_tiles():
    """Reference :55: a checkerboard border, planned once."""
    frames = _rgb_frames(_rgb(8, 8, 0))
    out_j, out_t, _ = _render(frames, _targets(64, 64, (28, 28, 36, 36)),
                              _params(background="tiles", tile_size=16))
    _assert_float(out_t, out_j)
    assert len(np.unique(out_t[0, 0, :])) == 2


@pytest.mark.parametrize("border", ["blur", "skip"])
def test_border_blur_and_skip(border):
    """Reference :360: letterbox bars filled with a blurred cover of the
    image, or transparent black (border "skip", or the legacy
    skip_target_clearing, the same)."""
    frames = _rgb_frames(_rgb(32, 48, 9))
    targets = _targets(96, 96, (0, 16, 96, 80))
    out_j, out_t, _ = _render(frames, targets, _params(
        border=border, blur_radius=8.0))
    _assert_float(out_t, out_j)
    if border == "blur":
        top = out_t[:, :16, :]
        assert top.mean() > 1e-3 and top.std() < out_t[:, 16:80, :].std()
    else:
        np.testing.assert_allclose(out_t[:, :16, :], 0.0, atol=1e-7)
        legacy = lt.Renderer(device="cpu").render(
            frames[1], targets[1],
            _params(skip_target_clearing=True)[1]).numpy()
        np.testing.assert_array_equal(legacy, out_t)


def test_corner_rounding():
    """Corner rounding on the flagship's render: the tail goes plain, as
    in the reference, and the corners are the background."""
    frames = _yuv_frames(_yuv(64, 128, 3))
    out_j, out_t, tails = _render(
        frames, _targets(256, 128, bit_depth=8),
        _params(False, upscaler="ewa_lanczos", corner_rounding=0.5))
    assert tails == (0, 0, 1)
    _assert_gate(out_t, out_j)
    assert not out_t[:, 0, 0].any() and not out_t[:, -1, -1].any()


def test_target_blend_alpha_overlay():
    """Reference :434: an RGBA frame (alpha 0.25) composited onto the
    target's contents with pl_alpha_overlay's factors."""
    rng = np.random.default_rng(13)
    base = rng.random((3, 32, 48)).astype(np.float32)
    rgba = rng.random((32, 48, 4)).astype(np.float32)
    rgba[..., 3] = 0.25
    frames = _rgb_frames(rgba)
    out_j, out_t, _ = _render(frames, _targets(48, 32, data=base),
                              _params(blend=jr.ALPHA_OVERLAY))
    assert lt.ALPHA_OVERLAY == jr.ALPHA_OVERLAY
    _assert_float(out_t, out_j)
    src = lt.Renderer(device="cpu").render(
        lt.frame_from_rgb(rgba, color=lt.CSP_SRGB, device="cpu"),
        lt.Target(w=48, h=32, color=lt.CSP_SRGB),
        _params()[1]).numpy()[:3]
    np.testing.assert_allclose(out_t[:3], src * 0.25 + base * 0.75,
                               atol=2e-2)


def test_alpha_frame_runs_a_plain_tail():
    """The repaired K1 gate: an RGBA frame's tail is plain, as the
    reference's `not has_alpha` gate makes it (counted ineligible: plain
    in the reference too), and its render matches the reference's;
    alpha travels to the output."""
    arr = _rgb(32, 128, 21, comps=4)
    out_j, out_t, tails = _render(_rgb_frames(arr, pq=True),
                                  _targets(256, 64, bit_depth=8),
                                  _params(False, upscaler="ewa_lanczos"))
    assert tails == (0, 0, 1)
    assert out_t.shape == (4, 64, 256)
    _assert_gate(out_t, out_j)


def test_distortion_with_alpha():
    """Reference :418: the distortion's alpha mode marks the area outside
    the image transparent."""
    frames = _rgb_frames(_rgb(32, 32, 12))
    out_j, out_t, _ = _render(frames, _targets(32, 32), _params(
        distort=dict(transform=((0.5, 0.0), (0.0, 0.5)),
                     alpha_mode="independent")))
    _assert_float(out_t, out_j)
    assert out_t.shape[0] == 4
    assert out_t[3, 0, 0] < 0.5 and out_t[3, 16, 16] > 0.5


def _linear_image(h=16, w=32, seed=4):
    return (np.random.default_rng(seed).random((3, h, w)) * 3.0).astype(
        np.float32)


@pytest.mark.parametrize("cones", [1, 2, 4, 3, 6, 5, 7])
@pytest.mark.parametrize("linear", [True, False])
def test_cone_distort_op(cones, linear):
    """ops.color.cone_distort against the reference's on BT.2020 PQ
    light: in linear light rtol 1e-6 (measured 1.2e-7); around its own
    PQ linearize and delinearize rtol 2e-5 (measured 1.03e-5: XLA's pow
    against PyTorch's, as tests/test_torch_color_tails.py records)."""
    import jax
    import jax.numpy as jnp
    import torch
    from libplacebo_tpu.ops import color as jcolor
    from libplacebo_tpu_torch.ops import color as tcolor
    x = _linear_image()
    if not linear:
        x = x / 4.0
    jp = jcs.ConeParams(jcs.Cone(cones), 0.3)
    tp = lt.ConeParams(lt.Cone(cones), 0.3)
    want = np.asarray(jax.jit(lambda v: jcolor.cone_distort(
        v, jcs.CSP_BT2100_PQ, jp, already_linear=linear))(jnp.asarray(x)))
    got = tcolor.cone_distort(torch.from_numpy(x), lt.CSP_BT2100_PQ, tp,
                              already_linear=linear).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6 if linear else 2e-5,
                               atol=1e-7)


def test_cone_distortion_render():
    """Cone distortion in the renderer: after scaling, in linear light;
    K1 keeps the tail."""
    frames = _yuv_frames(_yuv(64, 128, 7))
    out_j, out_t, tails = _render(
        frames, _targets(256, 128, bit_depth=8),
        _params(False, upscaler="ewa_lanczos", cone=(2, 0.5)))
    assert tails == (1, 0, 0)
    _assert_gate(out_t, out_j)


_ADJUST = [("brightness", 0.05), ("contrast", 1.2), ("saturation", 1.3),
           ("hue", 0.4), ("gamma", 1.2), ("temperature", 0.5)]


@pytest.mark.parametrize("system", ["BT_2020_NC", "RGB"])
@pytest.mark.parametrize("name, value", _ADJUST)
def test_color_adjustment_field(name, value, system):
    """Each ColorAdjustment field: the decode matrix equals the
    reference's exactly, and decode_color (gamma after the matrix)
    matches the reference's jitted one on a YCbCr and an RGB frame
    (hue and saturation of RGB through BT.709's YCbCr model); measured
    <= 1.2e-7."""
    import jax
    import jax.numpy as jnp
    import torch
    from libplacebo_tpu.ops import color as jcolor
    from libplacebo_tpu_torch.core import colorspace as tcs
    from libplacebo_tpu_torch.ops import color as tcolor
    jrep = jcs.ColorRepr(sys=getattr(jcs.ColorSystem, system),
                         levels=jcs.ColorLevels.LIMITED,
                         bits=jcs.BitEncoding(10, 10, 0))
    trep = lt.ColorRepr(sys=getattr(lt.ColorSystem, system),
                        levels=lt.ColorLevels.LIMITED,
                        bits=lt.BitEncoding(10, 10, 0))
    ja, ta = jcs.ColorAdjustment(**{name: value}), \
        lt.ColorAdjustment(**{name: value})
    jt, _ = jcs.color_repr_decode(jrep, adjustment=ja)
    tt, _ = tcs.color_repr_decode(trep, ta)
    np.testing.assert_array_equal(tt.mat.m, jt.mat.m)
    np.testing.assert_array_equal(tt.c, jt.c)
    x = np.random.default_rng(6).random((3, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jcolor.decode_color(
        v, jrep, jcs.ColorPrimaries.BT_2020, adjustment=ja))(
            jnp.asarray(x)))
    got = tcolor.decode_color(torch.from_numpy(x), trep,
                              lt.ColorPrimaries.BT_2020,
                              adjustment=ta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_color_adjustment_render():
    """Every field at once through the renderer: folded into the
    decode, K1 keeps the tail."""
    frames = _yuv_frames(_yuv(64, 128, 8))
    out_j, out_t, tails = _render(
        frames, _targets(256, 128, bit_depth=8),
        _params(False, upscaler="ewa_lanczos",
                color_adjustment=dict(_ADJUST)))
    assert tails == (1, 0, 0)
    _assert_gate(out_t, out_j)


def test_contrast_recovery():
    """Reference :93: contrast recovery re-injects the detail of a
    low-passed feature map; the tail goes plain."""
    frames = _yuv_frames(_yuv(32, 48, 8))
    out_j, out_t, tails = _render(frames, _targets(96, 64), _params(
        contrast_recovery=0.6, contrast_smoothness=2.0))
    assert tails == (0, 0, 1)
    _assert_toned(out_t, out_j)


@pytest.mark.parametrize("cr, smoothness", [(0.3, 3.5), (0.6, 8.0),
                                            (0.6, 1.0), (0.0, 3.5)])
def test_tone_with_recovery(cr, smoothness):
    """Reference :343: the feature map's downscale ratio; smoothness
    <= 1 or strength 0 turns the recovery off (measured <= 1.2e-7)."""
    import jax
    import jax.numpy as jnp
    import torch
    x = np.random.default_rng(9).random((37, 53)).astype(np.float32)

    def curve(v):
        return v * 0.8 + 0.05
    want = np.asarray(jax.jit(lambda v: jr.tone_with_recovery(
        v, curve, cr, 0.0, 0.9, smoothness=smoothness))(jnp.asarray(x)))
    got = trr.tone_with_recovery(torch.from_numpy(x), curve, cr, 0.0, 0.9,
                                 smoothness=smoothness).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if cr == 0.0 or smoothness <= 1.0:
        np.testing.assert_allclose(got, curve(x), atol=1e-7)


def test_contrast_recovery_off_below_smoothness_one():
    """Reference :343: smoothness <= 1 turns the recovery off."""
    frames = _yuv_frames(_yuv(32, 48, 8))
    tgt = lt.Target(w=96, h=64, color=lt.CSP_SRGB)
    a = lt.Renderer(device="cpu").render(frames[1], tgt, _params(
        contrast_recovery=0.6, contrast_smoothness=1.0)[1]).numpy()
    b = lt.Renderer(device="cpu").render(frames[1], tgt,
                                         _params()[1]).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_visualize_tone_map():
    """Reference :455: the tone curve drawn into the top-left quarter,
    the rest untouched."""
    frames = _yuv_frames(_yuv(32, 64, 14))
    tg = _targets(64, 32)
    out_j, out_t, tails = _render(frames, tg, _params(
        visualize_lut=True, visualize_rect=(0.0, 0.0, 0.5, 0.5)))
    assert tails == (0, 0, 1)
    _assert_toned(out_t, out_j)
    plain = lt.Renderer(device="cpu").render(frames[1], tg[1],
                                             _params()[1]).numpy()
    changed = np.abs(out_t - plain).max(axis=0) > 1e-6
    assert changed[:16, :32].any()
    assert not changed[16:, :].any() and not changed[:16, 32:].any()


@pytest.mark.parametrize("preset", ["FAST_PARAMS", "DEFAULT_PARAMS",
                                    "HIGH_QUALITY_PARAMS"])
def test_presets(preset):
    """The three presets on the flagship's frame, 8-bit output."""
    jp, tp = getattr(jr, preset), getattr(lt, preset)
    for f in ("upscaler", "downscaler", "linear_scaling", "sigmoid",
              "contrast_recovery", "frame_mixer"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.dither.method.value == jp.dither.method.value
    assert (tp.deband is None) == (jp.deband is None)
    assert tp.peak_detect.percentile == jp.peak_detect.percentile
    out_j, out_t, tails = _render(_yuv_frames(_yuv(64, 128, 2)),
                                  _targets(256, 128, bit_depth=8), (jp, tp))
    assert tails == ((0, 0, 1) if preset == "HIGH_QUALITY_PARAMS"
                     else (1, 0, 0))
    _assert_gate(out_t, out_j)


def test_path_f_three_frames():
    """Path F end to end at 48x128 -> 128x256 (the crop 256x96, 2x):
    10-bit HDR10 at 1000 nits with HIGH_QUALITY_PARAMS, 3 chained frames,
    peak state carried; the tail plain (a crop and contrast recovery),
    the bars black."""
    import chip_smoke
    col, rep, bits, target, params = chip_smoke.path_f_cell(lt, 256, 128,
                                                            16)
    jt = jr.Target(w=256, h=128, color=jcs.CSP_SRGB, bit_depth=8,
                   crop=JRectF(0, 16, 256, 112))
    jparams = jr.HIGH_QUALITY_PARAMS
    assert (params.upscaler, params.contrast_recovery) == (
        jparams.upscaler, jparams.contrast_recovery)
    assert params.deband == lt.DebandParams() and \
        jparams.deband == jdeband.DebandParams()
    assert params.peak_detect.percentile == JPeak(
        percentile=99.995).percentile
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    for i in range(3):
        yuv = _yuv(48, 128, 60 + i, bits=10)
        jf, _ = _yuv_frames(yuv, bits=10, max_luma=1000.0)
        tf = chip_smoke._frame_cell(lt, yuv, "cpu", col, rep, bits)
        out_j = np.asarray(jrend.render(jf, jt, jparams))
        out_t = trend.render(tf, target, params).numpy()
        _assert_gate(out_t, out_j)
        assert not out_t[:, :16].any() and not out_t[:, 112:].any()
        np.testing.assert_allclose(trend._peak_state.numpy(),
                                   np.asarray(jrend._peak_state), atol=1e-5)
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (0, 0, 3)

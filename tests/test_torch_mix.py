"""PyTorch port: frame mixing and the renderer's module functions
against the JAX package on the CPU — the mixer's weights,
render_image_mix over 3 frames, the mix cache's two switches,
frames_infer(_mix), clear_target(_tiles), translate_srgb_color, the
frame-mix pick helpers, get_hdr_metadata — and path E (subtitles and an
OSD on 3 chained source frames, a FrameMix a vsync) end to end.

Tolerances: the weights, the inference and the mix cache exactly; the
clear colors and translated colors rtol 2e-5, atol 1e-6 (XLA's pow
against PyTorch's in the transfer curves, measured 9.5e-6 relative on
PQ, as tests/test_torch_color_tails.py records for transfers);
the measured HDR metadata atol 1e-5, as the peak state's; the mixed
8-bit outputs the gate of tests/test_torch_presentation.py (K1's
perceptual tail magnifies F1's last-ulp EWA differences on knife-edge
pixels; the final dither flips them).
"""
import numpy as np
import pytest

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import queue as jq
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.render import queue as tq
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0


@pytest.fixture(autouse=True)
def _jax_fused_tail(monkeypatch):
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")


def _assert_gate(out_t, out_j):
    d = np.abs(out_t - out_j)
    assert (d > 1e-6).mean() < 1.2e-3, (d > 1e-6).mean()
    assert (d > LSB + 1e-6).mean() <= 1e-4, (d > LSB + 1e-6).mean()


_TIMESTAMPS = [[0.0], [-0.3, 0.7], [-1.2, -0.2, 0.4], [0.2, 1.2],
               [-0.9, -0.1, 0.6, 1.6], [-2.5, -1.5]]


@pytest.mark.parametrize("mixer", ["oversample", "mitchell", "box"])
@pytest.mark.parametrize("ts", _TIMESTAMPS)
@pytest.mark.parametrize("vsync", [1.0, 0.0])
def test_mix_weights(mixer, ts, vsync):
    """The mixer's weights equal the reference's exactly: oversample's
    vsync coverage, a kernel sampled at the timestamps."""
    np.testing.assert_array_equal(
        trr._mix_weights(lt.RenderParams(frame_mixer=mixer), ts, vsync),
        jr._mix_weights(jr.RenderParams(frame_mixer=mixer), ts, vsync))


def _yuv(h, w, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) * 219 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8))


def _pq_frames(yuv, signature):
    rep = dict(sys="bt.2020-nc", levels="limited")
    jf = jfr.frame_from_yuv420p(*yuv, color=jcs.CSP_BT2100_PQ,
                                repr=jcs.ColorRepr(
                                    bits=jcs.BitEncoding(8, 8, 0), **rep))
    tf = lt.frame_from_yuv420p(*yuv, color=lt.CSP_BT2100_PQ, device="cpu",
                               repr=lt.ColorRepr(
                                   bits=lt.BitEncoding(8, 8, 0), **rep))
    jf.signature = tf.signature = signature
    return jf, tf


def test_render_image_mix_three_frames():
    """A mitchell mix of 3 frames: each rendered once (K1, no dither),
    blended and dithered to 8 bits."""
    pairs = [_pq_frames(_yuv(32, 64, 20 + i), i + 1) for i in range(3)]
    ts = [-0.6, 0.3, 1.1]
    jt = jr.Target(w=128, h=64, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=128, h=64, color=lt.CSP_SRGB, bit_depth=8)
    kw = dict(upscaler="ewa_lanczos", frame_mixer="mitchell")
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    out_j = np.asarray(jr.render_image_mix(
        jr.Renderer(), jq.FrameMix([p[0] for p in pairs], ts, 1.0), jt,
        jr.RenderParams(**kw)))
    r = lt.Renderer(device="cpu")
    mix = carry.frame_mix_from_fields([p[1] for p in pairs], ts, 1.0)
    out_t = lt.render_image_mix(r, mix, tt, lt.RenderParams(**kw)).numpy()
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (3, 0, 0)
    assert len(r._mix_cache) == 3
    _assert_gate(out_t, out_j)
    codes = out_t * 255.0
    assert np.abs(codes - np.round(codes)).max() <= 255e-6


def _rgb_pair(seed, signature):
    arr = np.random.default_rng(seed).random((8, 8, 3)).astype(np.float32)
    jf = jfr.frame_from_rgb(arr, color=jcs.CSP_SRGB)
    tf = lt.frame_from_rgb(arr, color=lt.CSP_SRGB, device="cpu")
    jf.signature = tf.signature = signature
    return jf, tf


@pytest.mark.parametrize("preserve", [False, True])
@pytest.mark.parametrize("skip_single", [False, True])
def test_mix_cache_switches(preserve, skip_single):
    """preserve_mixing_cache keeps intermediates across changed params;
    skip_caching_single_frame leaves a lone frame out of the cache: the
    cache holds what the reference's holds after every call."""
    pairs = [_rgb_pair(s, s + 1) for s in range(3)]
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    jt = jr.Target(w=8, h=8, color=jcs.CSP_SRGB)
    tt = lt.Target(w=8, h=8, color=lt.CSP_SRGB)
    steps = [([0, 1], [-0.4, 0.6], "bilinear"), ([1], [0.0], "bilinear"),
             ([1, 2], [-0.2, 0.8], "bilinear"), ([2], [0.0], "bicubic")]
    for idx, ts, up in steps:
        kw = dict(upscaler=up, dither=None, peak_detect=None,
                  preserve_mixing_cache=preserve,
                  skip_caching_single_frame=skip_single)
        out_j = np.asarray(jr.render_image_mix(
            jrend, jq.FrameMix([pairs[i][0] for i in idx], ts),
            jt, jr.RenderParams(**kw)))
        out_t = lt.render_image_mix(
            trend, lt.FrameMix([pairs[i][1] for i in idx], ts), tt,
            lt.RenderParams(**kw)).numpy()
        np.testing.assert_allclose(out_t, out_j, atol=2e-5)
        assert sorted(k[0] for k in trend._mix_cache) == \
            sorted(k[0] for k in jrend._mix_cache)


def test_frames_infer():
    """Reference :535: the target defaults against the source."""
    pair = _rgb_pair(0, 1)
    pair[0].color, pair[1].color = jcs.CSP_BT2100_PQ, lt.CSP_BT2100_PQ
    jf2, jt2 = jr.frames_infer(pair[0], jr.Target(w=16, h=16))
    tf2, tt2 = lt.frames_infer(pair[1], lt.Target(w=16, h=16))
    for a, b in ((tf2.color, jf2.color), (tt2.color, jt2.color)):
        assert (a.primaries.value, a.transfer.value) == \
            (b.primaries.value, b.transfer.value)
        assert (a.hdr.min_luma, a.hdr.max_luma) == \
            (b.hdr.min_luma, b.hdr.max_luma)
    assert tt2.color.primaries == lt.ColorPrimaries.BT_709
    assert tf2.planes[0].data is pair[1].planes[0].data


def test_frames_infer_mix():
    """Reference :552: against the mix's nearest frame; an empty mix
    infers the target alone."""
    a, b = _rgb_pair(1, 1), _rgb_pair(2, 2)
    jt2, jref = jr.frames_infer_mix(
        jq.FrameMix([a[0], b[0]], [-0.2, 0.8]), jr.Target(w=16, h=16))
    tt2, tref = lt.frames_infer_mix(
        lt.FrameMix([a[1], b[1]], [-0.2, 0.8]), lt.Target(w=16, h=16))
    assert tref.signature == jref.signature == 1
    assert tt2.color.transfer.value == jt2.color.transfer.value
    jt3, jref3 = jr.frames_infer_mix(jq.FrameMix(), jr.Target(w=16, h=16))
    tt3, tref3 = lt.frames_infer_mix(lt.FrameMix(), lt.Target(w=16, h=16))
    assert tref3 is None and jref3 is None
    assert tt3.color.hdr.max_luma == jt3.color.hdr.max_luma > 0


_CLEAR_TARGETS = {
    "srgb": dict(),
    "pq": dict(color="pq"),
    "bt709_limited": dict(repr=("bt.709", "limited", "auto")),
    "premultiplied": dict(repr=("rgb", "full", "premultiplied")),
    "no_alpha": dict(repr=("rgb", "full", "none")),
}


def _clear_targets(spec, w=8, h=4):
    kw_j, kw_t = {}, {}
    if spec.get("color") == "pq":
        kw_j["color"], kw_t["color"] = jcs.CSP_BT2100_PQ, lt.CSP_BT2100_PQ
    else:
        kw_j["color"], kw_t["color"] = jcs.CSP_SRGB, lt.CSP_SRGB
    if "repr" in spec:
        sys_, levels, alpha = spec["repr"]
        kw_j["repr"] = jcs.ColorRepr(sys=sys_, levels=levels, alpha=alpha,
                                     bits=jcs.BitEncoding(8, 8, 0))
        kw_t["repr"] = lt.ColorRepr(sys=sys_, levels=levels, alpha=alpha,
                                    bits=lt.BitEncoding(8, 8, 0))
    return jr.Target(w=w, h=h, **kw_j), lt.Target(w=w, h=h, **kw_t)


@pytest.mark.parametrize("name", sorted(_CLEAR_TARGETS))
def test_clear_target(name):
    """Reference :565: an sRGB color in the target's encoding."""
    jt, tt = _clear_targets(_CLEAR_TARGETS[name])
    for rgba in ((1.0, 0.0, 0.0, 1.0), (0.5, 0.5, 0.5, 0.6)):
        want = np.asarray(jr.clear_target(jt, rgba))
        got = lt.clear_target(tt, rgba, device="cpu").numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    if name == "bt709_limited":
        gray = lt.clear_target(tt, (0.5, 0.5, 0.5, 1.0), device="cpu")
        assert abs(float(gray[1, 0, 0]) - 128 / 255) < 1e-3


@pytest.mark.parametrize("name", ["srgb", "pq", "bt709_limited"])
def test_clear_target_tiles(name):
    """Reference :588: a checkerboard of two sRGB colors."""
    jt, tt = _clear_targets(_CLEAR_TARGETS[name], 64, 64)
    want = np.asarray(jr.clear_target_tiles(jt, tile_size=16))
    got = lt.clear_target_tiles(tt, tile_size=16, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert abs(got[0, 0, 0] - got[0, 0, 16]) > 1e-3


@pytest.mark.parametrize("csp", ["srgb", "bt1886", "gamma22_p3", "pq",
                                 "hlg", "linear"])
def test_translate_srgb_color(csp):
    """An sRGB color in each colorspace, as the reference encodes it."""
    spec = {"srgb": ("bt.709", "srgb"), "bt1886": ("bt.709", "bt.1886"),
            "gamma22_p3": ("display-p3", "gamma2.2"),
            "pq": ("bt.2020", "pq"), "hlg": ("bt.2020", "hlg"),
            "linear": ("bt.709", "linear")}[csp]
    for rgb in ((0.5, 0.25, 1.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)):
        np.testing.assert_allclose(
            trr.translate_srgb_color(rgb, lt.ColorSpace(*spec)),
            jr.translate_srgb_color(rgb, jcs.ColorSpace(*spec)),
            rtol=2e-5, atol=1e-6)


def test_frame_mix_pick_helpers():
    """Reference :634: current, nearest, radius."""
    a, b, c = (_rgb_pair(s, s)[1] for s in (1, 2, 3))
    mix = lt.FrameMix(frames=[a, b, c], timestamps=[-0.9, -0.1, 0.6])
    assert tq.frame_mix_current(mix) is b
    assert tq.frame_mix_nearest(mix) is b
    mix2 = lt.FrameMix(frames=[a, b], timestamps=[0.2, 1.2])
    assert tq.frame_mix_current(mix2) is None
    assert tq.frame_mix_nearest(mix2) is a
    assert tq.frame_mix_current(lt.FrameMix()) is None
    assert tq.frame_mix_nearest(lt.FrameMix()) is None
    for mixer in ("oversample", "none", "mitchell", "box", "lanczos"):
        assert tq.frame_mix_radius(lt.RenderParams(frame_mixer=mixer)) == \
            jq.frame_mix_radius(jr.RenderParams(frame_mixer=mixer))
    assert tq.frame_mix_radius(lt.RenderParams(frame_mixer="mitchell")) \
        == 2.0


def test_get_hdr_metadata():
    """Reference :598: the measured metadata after a render with peak
    detection, None before and after a reset; flush_cache drops the
    plans."""
    yuv = _yuv(32, 64, 0)
    jf, tf = _pq_frames(yuv, 0)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    assert trend.get_hdr_metadata() is None
    params = dict(peak_detect=lt.PeakDetectParams(), dither=None)
    jrend.render(jf, jr.Target(w=128, h=64, color=jcs.CSP_SRGB),
                 jr.RenderParams(peak_detect=jr.PeakDetectParams(),
                                 dither=None))
    trend.render(tf, lt.Target(w=128, h=64, color=lt.CSP_SRGB),
                 lt.RenderParams(**params))
    jmd, tmd = jrend.get_hdr_metadata(), trend.get_hdr_metadata()
    assert 0 < tmd.avg_pq_y <= tmd.max_pq_y <= 1.0
    np.testing.assert_allclose([tmd.max_pq_y, tmd.avg_pq_y],
                               [jmd.max_pq_y, jmd.avg_pq_y], atol=1e-5)
    trend.reset_peak_detection()
    assert trend.get_hdr_metadata() is None
    assert len(trend._cache) == 1
    trend.flush_cache()
    assert not trend._cache and trend.get_hdr_metadata() is None


def _jax_overlay(to):
    """The reference's Overlay with the port overlay's fields."""
    prem = to.repr.alpha == lt.AlphaMode.PREMULTIPLIED
    return jfr.Overlay(
        data=to.data.numpy(), mode=to.mode, coords=to.coords,
        rect=JRectF(to.rect.x0, to.rect.y0, to.rect.x1, to.rect.y1)
        if to.rect is not None else None,
        repr=jcs.ColorRepr(alpha=jcs.AlphaMode.PREMULTIPLIED) if prem
        else jcs.ColorRepr(),
        parts=tuple(jfr.OverlayPart(
            JRectF(p.src.x0, p.src.y0, p.src.x1, p.src.y1),
            JRectF(p.dst.x0, p.dst.y0, p.dst.x1, p.dst.y1), p.color)
            for p in to.parts))


def test_path_e_three_frames():
    """Path E end to end at 64x128 -> 128x256: 10-bit PQ source frames
    with subtitles (a new bitmap every third frame) and the OSD, a
    FrameMix a vsync over vsyncs 0-4 (source frames 0-2, each rendered
    once on K1 without dither), the peak state carried, against the
    reference's render_image_mix."""
    import chip_smoke
    yuvs = chip_smoke._flagship_yuv(4, 64, 128, seed=7, bits=10)
    frames_t = chip_smoke.path_e_frames(lt, yuvs, "cpu", 256)
    frames_j = []
    for yuv, tf in zip(yuvs, frames_t):
        jf = jfr.frame_from_yuv420p(
            *yuv, color=jcs.CSP_BT2100_PQ, bit_depth=10,
            repr=jcs.ColorRepr(sys="bt.2020-nc", levels="limited",
                               bits=jcs.BitEncoding(10, 10, 0)))
        jf.overlays = [_jax_overlay(o) for o in tf.overlays]
        jf.pts, jf.signature = tf.pts, tf.signature
        frames_j.append(jf)
    params_t = chip_smoke.path_e_params(lt)
    params_j = jr.RenderParams(
        upscaler="ewa_lanczos", frame_mixer="oversample",
        color_adjustment=jcs.ColorAdjustment(brightness=0.02,
                                             contrast=1.05, saturation=1.1))
    jt = jr.Target(w=256, h=128, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    for v in range(5):
        mix_t = chip_smoke.path_e_mix(lt, frames_t, v)
        mix_j = jq.FrameMix(
            [frames_j[int(v // chip_smoke.PATH_E_SPACING) + i]
             for i in range(2)], mix_t.timestamps, 1.0)
        out_j = np.asarray(jr.render_image_mix(jrend, mix_j, jt, params_j))
        out_t = lt.render_image_mix(trend, mix_t, tt, params_t).numpy()
        _assert_gate(out_t, out_j)
        np.testing.assert_allclose(trend._peak_state.numpy(),
                                   np.asarray(jrend._peak_state), atol=1e-5)
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (3, 0, 0)
    assert len(trend._cache) == 1 and len(trend._mix_cache) == 3

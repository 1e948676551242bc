"""PyTorch port: overlays (subtitles, OSD) against the JAX package on
the CPU — the cases of tests/test_render_features.py (:65, :80,
:740-885, :944): normal and monochrome bitmaps, parts and their source
regions, src_frame scaling, target overlays, clipping at the canvas
edge, the overlay's own encoding converted, premultiplied alpha,
rotation alongside the frame, and invalid modes that raise — plus
overlays on K1's path, new bitmaps through one plan, and carry.py.

Tolerances: the reference tests' own checks on the port's output, and
against the reference's render max |difference| <= 2e-5 for undithered
outputs (measured <= 1.2e-7: the overlay's bilinear resize and blend
round as XLA does); on K1's path (8-bit, dithered, EWA) the gate of
tests/test_torch_presentation.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core.common import RectF as JRectF
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


def _rgb(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _frames(h, w, seed, rotation=0, crop=None):
    arr = _rgb(h, w, seed)
    jf = jfr.frame_from_rgb(arr, color=jcs.CSP_SRGB)
    tf = lt.frame_from_rgb(arr, color=lt.CSP_SRGB, device="cpu")
    for f, rect in ((jf, JRectF), (tf, lt.RectF)):
        f.rotation = rotation
        if crop is not None:
            f.crop = rect(*crop)
    return jf, tf


def _overlays(data, rect=None, parts=(), **kw):
    """The same overlay on both sides; `parts` as (src, dst, color)
    tuples, `kw` mode/coords and "premultiplied" / "limited_bt1886"."""
    enc = kw.pop("encoding", None)
    j_kw, t_kw = dict(kw), dict(kw)
    if enc == "premultiplied":
        j_kw["repr"] = jcs.ColorRepr(alpha=jcs.AlphaMode.PREMULTIPLIED)
        t_kw["repr"] = lt.ColorRepr(alpha=lt.AlphaMode.PREMULTIPLIED)
    elif enc == "limited_bt1886":
        j_kw["repr"] = jcs.ColorRepr(sys=jcs.ColorSystem.RGB,
                                     levels=jcs.ColorLevels.LIMITED)
        j_kw["color"] = jcs.ColorSpace(jcs.ColorPrimaries.BT_709,
                                       jcs.ColorTransfer.BT_1886)
        t_kw["repr"] = lt.ColorRepr(sys=lt.ColorSystem.RGB,
                                    levels=lt.ColorLevels.LIMITED)
        t_kw["color"] = lt.ColorSpace(lt.ColorPrimaries.BT_709,
                                      lt.ColorTransfer.BT_1886)
    jo = jfr.Overlay(
        data=np.asarray(data), rect=JRectF(*rect) if rect else None,
        parts=tuple(jfr.OverlayPart(JRectF(*s), JRectF(*d), c)
                    for s, d, c in parts), **j_kw)
    to = lt.Overlay(
        data=torch.from_numpy(np.asarray(data)), rect=lt.RectF(*rect)
        if rect else None,
        parts=tuple(lt.OverlayPart(lt.RectF(*s), lt.RectF(*d), c)
                    for s, d, c in parts), **t_kw)
    return jo, to


def _render(frames, w, h, on_target=(), plain=True, bit_depth=0, **kw):
    """(JAX output, port output) of one render each; `on_target` are
    overlay pairs drawn on the target."""
    if plain:
        kw.setdefault("dither", None)
        kw.setdefault("peak_detect", None)
    jt = jr.Target(w=w, h=h, color=jcs.CSP_SRGB, bit_depth=bit_depth,
                   overlays=tuple(o[0] for o in on_target))
    tt = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=bit_depth,
                   overlays=tuple(o[1] for o in on_target))
    out_j = np.asarray(jr.Renderer().render(frames[0], jt,
                                            jr.RenderParams(**kw)))
    out_t = lt.Renderer(device="cpu").render(frames[1], tt,
                                             lt.RenderParams(**kw)).numpy()
    assert out_t.shape == out_j.shape
    return out_j, out_t


def _attach(frames, pair):
    frames[0].overlays = [pair[0]]
    frames[1].overlays = [pair[1]]


def _assert_float(out_t, out_j):
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=FLOAT_ATOL)


def test_overlay_blend():
    """Reference :65: an opaque green bitmap at a target rect."""
    frames = _frames(32, 32, 1)
    data = np.zeros((4, 8, 8), np.float32)
    data[1] = data[3] = 1.0
    _attach(frames, _overlays(data, rect=(4, 4, 12, 12)))
    out_j, out_t = _render(frames, 32, 32)
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 6, 6], [0, 1, 0], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 20, 20],
                               np.moveaxis(_rgb(32, 32, 1), -1, 0)[:, 20, 20],
                               atol=2e-2)


def test_overlay_alpha():
    """Reference :80: a half-transparent red bitmap."""
    frames = _frames(16, 16, 2)
    data = np.zeros((4, 4, 4), np.float32)
    data[0], data[3] = 1.0, 0.5
    _attach(frames, _overlays(data, rect=(0, 0, 4, 4)))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    src = np.moveaxis(_rgb(16, 16, 2), -1, 0)
    np.testing.assert_allclose(out_t[0, 2, 2], 0.5 + 0.5 * src[0, 2, 2],
                               atol=2e-2)


def test_overlay_monochrome_parts():
    """Reference :740: a coverage map painted by each part's color."""
    frames = _frames(32, 32, 4)
    mask = np.zeros((1, 8, 8), np.float32)
    mask[0, :4] = 1.0
    _attach(frames, _overlays(
        mask, mode="monochrome", coords="dst_frame", parts=(
            ((0, 0, 8, 8), (4, 4, 12, 12), (0.0, 0.0, 1.0, 1.0)),
            ((0, 0, 8, 8), (20, 4, 28, 12), (1.0, 1.0, 0.0, 0.5)))))
    out_j, out_t = _render(frames, 32, 32)
    _assert_float(out_t, out_j)
    src = np.moveaxis(_rgb(32, 32, 4), -1, 0)
    np.testing.assert_allclose(out_t[:, 5, 8], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 10, 8], src[:, 10, 8], atol=2e-2)
    np.testing.assert_allclose(out_t[:, 5, 24],
                               0.5 * np.array([1, 1, 0]) + 0.5 * src[:, 5, 24],
                               atol=2e-2)


def test_overlay_parts_src_region():
    """Reference :765: part.src selects a region of the bitmap."""
    frames = _frames(16, 16, 5)
    tex = np.zeros((4, 4, 8), np.float32)
    tex[0, :, :4] = 1.0
    tex[1, :, 4:] = 1.0
    tex[3] = 1.0
    _attach(frames, _overlays(tex, coords="dst_frame", parts=(
        ((4, 0, 8, 4), (0, 0, 4, 4), (1.0, 1.0, 1.0, 1.0)),)))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 1, 1], [0, 1, 0], atol=1e-5)


def test_overlay_coords_src_frame_scales():
    """Reference :780: src_frame parts ride the 2x upscale."""
    frames = _frames(16, 16, 6)
    tex = np.zeros((4, 4, 4), np.float32)
    tex[2] = tex[3] = 1.0
    _attach(frames, _overlays(tex, coords="src_frame", parts=(
        ((0, 0, 4, 4), (4, 4, 8, 8), (1.0, 1.0, 1.0, 1.0)),)))
    out_j, out_t = _render(frames, 32, 32)
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 12, 12], [0, 0, 1], atol=1e-5)
    bare = lt.Renderer(device="cpu").render(
        _frames(16, 16, 6)[1], lt.Target(w=32, h=32, color=lt.CSP_SRGB),
        lt.RenderParams(dither=None, peak_detect=None)).numpy()
    np.testing.assert_allclose(out_t[:, 20, 20], bare[:, 20, 20], atol=1e-6)


@pytest.mark.parametrize("coords", ["dst_frame", "dst_crop", "src_crop"])
def test_overlay_other_coords(coords):
    """dst_crop parts are offset by the target crop; src_crop parts are
    relative to the frame's crop and scale with it."""
    frames = _frames(16, 16, 14, crop=(4, 0, 16, 12))
    tex = np.zeros((4, 4, 4), np.float32)
    tex[0] = tex[3] = 1.0
    _attach(frames, _overlays(tex, coords=coords, parts=(
        ((0, 0, 4, 4), (2, 2, 6, 6), (1.0, 1.0, 1.0, 1.0)),)))
    jt = jr.Target(w=48, h=48, color=jcs.CSP_SRGB,
                   crop=JRectF(8, 8, 44, 44))
    tt = lt.Target(w=48, h=48, color=lt.CSP_SRGB, crop=lt.RectF(8, 8, 44, 44))
    params = dict(dither=None, peak_detect=None)
    out_j = np.asarray(jr.Renderer().render(frames[0], jt,
                                            jr.RenderParams(**params)))
    out_t = lt.Renderer(device="cpu").render(
        frames[1], tt, lt.RenderParams(**params)).numpy()
    _assert_float(out_t, out_j)


def test_overlay_on_target():
    """Reference :800: a target overlay defaults to dst_frame."""
    frames = _frames(16, 16, 7)
    tex = np.zeros((4, 4, 4), np.float32)
    tex[0] = tex[3] = 1.0
    out_j, out_t = _render(frames, 32, 32, on_target=(
        _overlays(tex, rect=(28, 28, 32, 32)),))
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 30, 30], [1, 0, 0], atol=1e-5)


def test_overlay_clipped_at_canvas_edge():
    """Reference :813: a part past the target's edge is clipped."""
    frames = _frames(16, 16, 8)
    tex = np.zeros((4, 4, 4), np.float32)
    tex[1] = tex[3] = 1.0
    _attach(frames, _overlays(tex, rect=(14, 14, 22, 22)))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 15, 15], [0, 1, 0], atol=1e-5)


def test_overlay_color_conversion():
    """Reference :826: a limited-range BT.1886 bitmap converted to the
    target's encoding: its white lands at full-range 1."""
    frames = _frames(16, 16, 9)
    tex = np.full((4, 4, 4), 235.0 / 255.0, np.float32)
    tex[3] = 1.0
    _attach(frames, _overlays(tex, rect=(0, 0, 4, 4),
                              encoding="limited_bt1886"))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    np.testing.assert_allclose(out_t[:, 2, 2], [1, 1, 1], atol=5e-3)


def test_overlay_premultiplied_alpha():
    """Reference :843: a premultiplied bitmap blends with factor ONE."""
    frames = _frames(16, 16, 10)
    tex = np.zeros((4, 4, 4), np.float32)
    tex[0] = tex[3] = 0.5
    _attach(frames, _overlays(tex, rect=(0, 0, 4, 4),
                              encoding="premultiplied"))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    src = np.moveaxis(_rgb(16, 16, 10), -1, 0)
    np.testing.assert_allclose(out_t[0, 2, 2], 0.5 + 0.5 * src[0, 2, 2],
                               atol=2e-2)
    np.testing.assert_allclose(out_t[1, 2, 2], 0.5 * src[1, 2, 2],
                               atol=2e-2)


@pytest.mark.parametrize("rotation", [1, 2, 3])
def test_overlay_src_frame_rotates_alongside(rotation):
    """Reference :862: src_frame parts turn with the image; under a
    quarter turn a part at the frame's top-left lands where its content
    lands."""
    frames = _frames(16, 16, 11, rotation=rotation, crop=(0, 0, 16, 16))
    tex = np.zeros((4, 4, 4), np.float32)
    tex[0] = tex[3] = 1.0
    tex[1, :2] = 1.0          # an asymmetric bitmap shows its rotation
    _attach(frames, _overlays(tex, coords="src_frame", parts=(
        ((0, 0, 4, 4), (0, 0, 4, 4), (1.0, 1.0, 1.0, 1.0)),)))
    out_j, out_t = _render(frames, 16, 16)
    _assert_float(out_t, out_j)
    if rotation == 1:
        np.testing.assert_allclose(out_t[0, 14, 2], 1.0, atol=1e-5)


def test_overlay_invalid_mode_coords_raise():
    """Reference :944: an unknown mode or coords raises ValueError."""
    f = _frames(8, 8, 0)[1]
    tex = torch.ones((4, 2, 2))
    tgt = lt.Target(w=8, h=8, color=lt.CSP_SRGB)
    f.overlays = [lt.Overlay(data=tex, rect=lt.RectF(0, 0, 2, 2),
                             mode="bogus")]
    with pytest.raises(ValueError, match="overlay mode"):
        lt.Renderer(device="cpu").render(f, tgt, lt.RenderParams())
    f.overlays = [lt.Overlay(data=tex, rect=lt.RectF(0, 0, 2, 2),
                             coords="sideways")]
    with pytest.raises(ValueError, match="overlay coords"):
        lt.Renderer(device="cpu").render(f, tgt, lt.RenderParams())


def test_overlay_is_simple():
    """The whole-bitmap shorthand's predicate, as the reference's."""
    data = np.ones((4, 2, 2), np.float32)
    for kw in ({}, {"encoding": "premultiplied"}, {"mode": "monochrome"}):
        jo, to = _overlays(data, rect=(0, 0, 2, 2), **kw)
        assert trr.Renderer.overlay_is_simple(to) == \
            jr.Renderer.overlay_is_simple(jo)


def test_subtitles_on_k1_path():
    """Subtitles on the flagship's path: the tail stays on K1, the
    bitmap blends after the dither; a new bitmap of the same shape
    reuses the plan."""
    rng = np.random.default_rng(3)
    y = (rng.random((64, 128)) * 219 + 16).astype(np.uint8)
    u = (rng.random((32, 64)) * 224 + 16).astype(np.uint8)
    rep = dict(sys="bt.2020-nc", levels="limited")
    jf = jfr.frame_from_yuv420p(y, u, u, color=jcs.CSP_BT2100_PQ,
                                repr=jcs.ColorRepr(
                                    bits=jcs.BitEncoding(8, 8, 0), **rep))
    tf = lt.frame_from_yuv420p(y, u, u, color=lt.CSP_BT2100_PQ, device="cpu",
                               repr=lt.ColorRepr(
                                   bits=lt.BitEncoding(8, 8, 0), **rep))
    cover = np.clip(rng.random((1, 6, 40)) * 1.6 - 0.6, 0, 1).astype(
        np.float32)
    _attach((jf, tf), _overlays(cover, mode="monochrome", coords="src_frame",
                                parts=(((0, 0, 40, 6), (44, 50, 84, 56),
                                        (1.0, 1.0, 0.9, 1.0)),)))
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    out_j, out_t = _render((jf, tf), 256, 128, plain=False, bit_depth=8,
                           upscaler="ewa_lanczos")
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (1, 0, 0)
    d = np.abs(out_t - out_j)
    assert (d > 1e-6).mean() < 1.2e-3 and (d > LSB + 1e-6).mean() <= 1e-4
    r = lt.Renderer(device="cpu")
    tgt = lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    params = lt.RenderParams(upscaler="ewa_lanczos")
    a = r.render(tf, tgt, params)
    tf.overlays[0] = dataclasses.replace(
        tf.overlays[0], data=torch.from_numpy(cover[:, ::-1].copy()))
    b = r.render(tf, tgt, params)
    assert len(r._cache) == 1 and not torch.equal(a, b)


def test_overlay_carried_from_the_reference():
    """carry.overlay_from_fields turns the reference's overlay (its
    fields, the bitmap as numpy) into the port's: the renders match."""
    frames = _frames(16, 16, 12)
    tex = np.random.default_rng(2).random((4, 6, 6)).astype(np.float32)
    jo = jfr.Overlay(data=tex, coords="src_frame",
                     repr=jcs.ColorRepr(alpha=jcs.AlphaMode.PREMULTIPLIED),
                     parts=(jfr.OverlayPart(JRectF(0, 0, 6, 6),
                                            JRectF(2, 3, 11, 9),
                                            (1.0, 0.5, 0.5, 1.0)),))
    fields = dataclasses.asdict(jo)
    to = carry.overlay_from_fields(fields, device="cpu")
    assert (to.mode, to.coords, to.repr.alpha) == (
        "normal", "src_frame", lt.AlphaMode.PREMULTIPLIED)
    assert to.parts == (lt.OverlayPart(lt.RectF(0, 0, 6, 6),
                                       lt.RectF(2, 3, 11, 9),
                                       (1.0, 0.5, 0.5, 1.0)),)
    _attach(frames, (jo, to))
    out_j, out_t = _render(frames, 32, 32)
    _assert_float(out_t, out_j)

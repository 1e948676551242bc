"""PyTorch port: mpv .hook user shaders inside the Renderer against the
JAX package on the CPU — the renderer cases of tests/test_mpv_hooks.py
under their names, and path J (chip_smoke.py) at a small size.

Both packages render the same seeded frames at the test module's small
sizes.  Gates, the port's existing ones for whole renders
(tests/test_torch_hooks.py): float outputs within 1 LSB of 8 bits
everywhere and differing by more than 1e-6 on fewer than 1e-3 of the
values; path J (8-bit with Sierra Lite error diffusion, which turns
last-ulp differences upstream into 1-LSB flips) within config 5's gate
of chip_smoke.py: more than 1 LSB apart on at most 5e-4 of the codes,
differing at all on fewer than 12%.  Each case asserts that neither or
both renderers disabled the hook.
"""
import dataclasses

import numpy as np

import chip_smoke
import test_mpv_hooks as JT
from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import options as jopt
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.core.common import Rotation as JRotation
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import mpv_hooks as jm
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.ops.cuda import error_diffusion as k2
from libplacebo_tpu_torch.ops.cuda import shear as k3
from libplacebo_tpu_torch.render import mpv_hooks as tm
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0


def assert_frame_gate(out_j, out_t, frac=1e-3):
    assert out_j.shape == out_t.shape
    d = np.abs(out_t - out_j)
    assert d.max() <= LSB + 1e-6, d.max()
    assert (d > 1e-6).mean() < frac, (d > 1e-6).mean()


def _yuv(seed, h, w, gray_chroma=False):
    rng = np.random.default_rng(seed)
    y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
    if gray_chroma:
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.full((h // 2, w // 2), 128, np.uint8)
    else:
        u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    return y, u, v


def _frames(seed=0, h=64, w=96, gray_chroma=False):
    """(JAX frame, port frame) of test_mpv_hooks._yuv_frame's content:
    8-bit limited BT.709 4:2:0."""
    y, u, v = _yuv(seed, h, w, gray_chroma)
    jf = jfr.frame_from_yuv420p(
        y, u, v, repr=jcs.ColorRepr(sys=jcs.ColorSystem.BT_709,
                                    levels=jcs.ColorLevels.LIMITED,
                                    bits=jcs.BitEncoding(8, 8, 0)))
    tf = lt.frame_from_yuv420p(
        y, u, v, device="cpu",
        repr=lt.ColorRepr(sys=lt.ColorSystem.BT_709,
                          levels=lt.ColorLevels.LIMITED,
                          bits=lt.BitEncoding(8, 8, 0)))
    return jf, tf


def _targets(w, h, bit_depth=0):
    return (jr.Target(w=w, h=h, color=jcs.CSP_SRGB, bit_depth=bit_depth),
            lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=bit_depth))


def render_both(frames, w, h, text=None, bit_depth=0, hooks=None, **kw):
    """Render (JAX frame, port frame) with `text`'s hook (or the given
    (JAX hook, port hook) pair) in both packages: (JAX out, port out,
    JAX renderer, port renderer)."""
    jf, tf = frames
    jt, tt = _targets(w, h, bit_depth)
    if hooks is None and text is not None:
        hooks = (jm.user_shader_hook(text), tm.user_shader_hook(text))
    jh = (hooks[0],) if hooks else ()
    th = (hooks[1],) if hooks else ()
    rj, rt = jr.Renderer(), lt.Renderer(device="cpu")
    out_j = np.asarray(rj._render_once(jf, jt, jr.RenderParams(
        hooks=jh, **kw)))
    out_t = rt._render_once(tf, tt, lt.RenderParams(hooks=th, **kw)) \
        .numpy()
    assert bool(rj._disabled_hooks) == bool(rt._disabled_hooks)
    return out_j, out_t, rj, rt


def test_renderer_integration():
    rgb = np.random.default_rng(5).random((16, 24, 3)).astype(np.float32)
    frames = (jfr.frame_from_rgb(rgb, color=jcs.CSP_SRGB),
              lt.frame_from_rgb(rgb, color=lt.CSP_SRGB, device="cpu"))
    kw = dict(peak_detect=None, dither=None, linear_scaling=False)
    out_j, out_t, rj, rt = render_both(frames, 24, 16, JT.UNSHARP_REAL,
                                       **kw)
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)
    base, _, _, _ = render_both(frames, 24, 16, None, **kw)
    assert not np.allclose(out_t, base)


def test_fsrcnnx_class_luma_doubling_hook():
    """The 3-pass FSRCNNX-style hook at LUMA_INPUT resizes the reference
    grid and is gated by //!WHEN on the target ratio: 2x runs it, 1:1
    bypasses every pass bit for bit."""
    frames = _frames()
    out_j, out_t, rj, rt = render_both(frames, 192, 128, JT.FSRCNNX_LIKE,
                                       upscaler="lanczos")
    assert not rt._disabled_hooks and out_t.shape == (3, 128, 192)
    assert_frame_gate(out_j, out_t)
    out_j, out_t, rj, rt = render_both(frames, 96, 64, JT.FSRCNNX_LIKE,
                                       upscaler="lanczos")
    assert not rt._disabled_hooks
    ref_j, ref_t, _, _ = render_both(frames, 96, 64, None,
                                     upscaler="lanczos")
    np.testing.assert_array_equal(out_t, ref_t)
    np.testing.assert_array_equal(out_j, ref_j)


def test_compute_threads_neq_block_in_renderer():
    out_j, out_t, rj, rt = render_both(_frames(seed=23, h=32, w=48), 48, 32,
                                       JT.FOUR_ARG_COMPUTE, peak_detect=None)
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)


def test_compute_hook_inside_renderer():
    rgb = np.random.default_rng(11).random((16, 24, 3)).astype(np.float32)
    frames = (jfr.frame_from_rgb(rgb), lt.frame_from_rgb(rgb, device="cpu"))
    text = JT.COMPUTE_IDENTITY_HOOK.replace("c * 2.0", "c * 0.5")
    out_j, out_t, rj, rt = render_both(frames, 24, 16, text,
                                       peak_detect=None)
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)


def _with_crop(frames, crop):
    jf, tf = frames
    jf.crop = JRectF(*crop)
    tf.crop = lt.RectF(*crop)
    return jf, tf


def test_offset_on_doubling_hook_shifts_crop():
    """A doubling pass with //!OFFSET -0.5 -0.5 equals the plain pass on
    a crop shifted by -0.25 texels, in both packages, and both agree."""
    h, w = 32, 48
    plain = JT.LUMA_DOUBLER_OFFSET.replace("//!OFFSET -0.5 -0.5\n", "")
    out_j, out_t, _, rt = render_both(
        _frames(seed=9, h=h, w=w, gray_chroma=True), 2 * w, 2 * h,
        JT.LUMA_DOUBLER_OFFSET, upscaler="lanczos")
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)
    orc_j, orc_t, _, _ = render_both(
        _with_crop(_frames(seed=9, h=h, w=w, gray_chroma=True),
                   (-0.25, -0.25, w - 0.25, h - 0.25)),
        2 * w, 2 * h, plain, upscaler="lanczos")
    np.testing.assert_allclose(out_t, orc_t, atol=2e-6)
    ign_j, ign_t, _, _ = render_both(
        _frames(seed=9, h=h, w=w, gray_chroma=True), 2 * w, 2 * h, plain,
        upscaler="lanczos")
    assert np.abs(out_t - ign_t).max() > 1e-3


def test_offset_at_main_stage():
    h, w = 32, 48
    plain = JT.MAIN_IDENTITY_OFFSET.replace("//!OFFSET 0.5 0.0\n", "")
    out_j, out_t, _, rt = render_both(_frames(seed=10, h=h, w=w), 2 * w,
                                      2 * h, JT.MAIN_IDENTITY_OFFSET,
                                      upscaler="lanczos")
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)
    orc_j, orc_t, _, _ = render_both(
        _with_crop(_frames(seed=10, h=h, w=w), (0.5, 0.0, w + 0.5, h)),
        2 * w, 2 * h, plain, upscaler="lanczos")
    np.testing.assert_array_equal(out_t, orc_t)


def test_offset_align_pins_chroma_to_ref_grid():
    h, w = 32, 48
    align = """\
//!HOOK CHROMA
//!BIND HOOKED
//!OFFSET ALIGN
vec4 hook() {
    return HOOKED_tex(HOOKED_pos);
}
"""
    plain = align.replace("//!OFFSET ALIGN\n", "")

    def sited(loc):
        jf, tf = _frames(seed=11, h=h, w=w)
        jf.set_chroma_location(loc)
        tf.set_chroma_location(loc)
        return jf, tf
    out_j, out_t, _, rt = render_both(sited("top_left"), 2 * w, 2 * h,
                                      align, upscaler="lanczos")
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)
    orc_j, orc_t, _, _ = render_both(sited("center"), 2 * w, 2 * h, plain,
                                     upscaler="lanczos")
    np.testing.assert_array_equal(out_t, orc_t)
    sit_j, sit_t, _, _ = render_both(sited("top_left"), 2 * w, 2 * h, plain,
                                     upscaler="lanczos")
    assert np.abs(out_t - sit_t).max() > 1e-5


def test_offset_at_unsupported_stage_auto_disables():
    text = """\
//!HOOK POSTKERNEL
//!BIND HOOKED
//!OFFSET -0.5 -0.5
vec4 hook() {
    return HOOKED_tex(HOOKED_pos);
}
"""
    h, w = 32, 48
    out_j, out_t, rj, rt = render_both(_frames(seed=12, h=h, w=w), 2 * w,
                                       2 * h, text, upscaler="lanczos")
    assert rj._disabled_hooks and rt._disabled_hooks
    ref_j, ref_t, _, _ = render_both(_frames(seed=12, h=h, w=w), 2 * w,
                                     2 * h, None, upscaler="lanczos")
    np.testing.assert_array_equal(out_t, ref_t)


def test_offset_at_native_rotates_with_frame():
    h, w = 32, 48
    text = """\
//!HOOK NATIVE
//!BIND HOOKED
//!OFFSET 0.5 0.0
vec4 hook() {
    return HOOKED_tex(HOOKED_pos);
}
"""
    plain = text.replace("//!OFFSET 0.5 0.0\n", "")

    def rotated(crop):
        jf, tf = _frames(seed=14, h=h, w=w, gray_chroma=True)
        jf.rotation, tf.rotation = JRotation(1), lt.Rotation(1)
        return _with_crop((jf, tf), crop)
    out_j, out_t, _, rt = render_both(rotated((0, 0, h, w)), 2 * h, 2 * w,
                                      text, upscaler="lanczos")
    assert not rt._disabled_hooks
    assert_frame_gate(out_j, out_t)
    orc_j, orc_t, _, _ = render_both(rotated((0, -0.5, h, w - 0.5)),
                                     2 * h, 2 * w, plain,
                                     upscaler="lanczos")
    np.testing.assert_allclose(out_t, orc_t, atol=2e-6)


def _const_rgb(v, h=32, w=48):
    img = np.broadcast_to(np.asarray(v, np.float32), (h, w, 3)).copy()
    return jfr.frame_from_rgb(img), lt.frame_from_rgb(img, device="cpu")


_EMA_VALS = [np.array([0.8, 0.2, 0.4], np.float32),
             np.array([0.1, 0.9, 0.5], np.float32),
             np.array([0.6, 0.3, 0.7], np.float32),
             np.array([0.2, 0.5, 0.1], np.float32)]


def test_temporal_ema_hook_across_frames():
    """The STORAGE-image EMA and STORAGE-buffer counter carried across 4
    frames through both renderers (the JAX test's constant-colour
    frames): each frame within the gate, the port's render of frame i
    equal to its un-hooked render of the running EMA, the counter 4."""
    h, w = 32, 48
    hj = jm.user_shader_hook(JT.TEMPORAL_EMA_SHADER)
    ht = tm.user_shader_hook(JT.TEMPORAL_EMA_SHADER)
    jt, tt = _targets(w, h)
    rj, rt = jr.Renderer(), lt.Renderer(device="cpu")
    pj = jr.RenderParams(hooks=(hj,), peak_detect=None)
    pt = lt.RenderParams(hooks=(ht,), peak_detect=None)
    ema = None
    for i, v in enumerate(_EMA_VALS):
        jf, tf = _const_rgb(v, h, w)
        out_j = np.asarray(rj._render_once(jf, jt, pj))
        out_t = rt._render_once(tf, tt, pt).numpy()
        assert not rj._disabled_hooks and not rt._disabled_hooks
        assert_frame_gate(out_j, out_t)
        ema = v if ema is None else 0.3 * v + 0.7 * ema
        oracle = lt.Renderer(device="cpu")._render_once(
            _const_rgb(ema, h, w)[1], tt,
            lt.RenderParams(peak_detect=None)).numpy()
        np.testing.assert_allclose(out_t, oracle, atol=3e-6,
                                   err_msg=f"frame {i}")
    carried = rt._hook_states[(ht.signature, "buf:frames")]
    assert float(carried[0]) == 4.0
    assert float(np.asarray(rj._hook_states[(hj.signature,
                                             "buf:frames")])[0]) == 4.0
    acc_j = np.asarray(rj._hook_states[(hj.signature, "tex:ACC")])
    acc_t = rt._hook_states[(ht.signature, "tex:ACC")].numpy()
    np.testing.assert_allclose(acc_t, acc_j, rtol=0, atol=2e-6)


def test_temporal_state_reset():
    h, w = 32, 48
    ht = tm.user_shader_hook(JT.TEMPORAL_EMA_SHADER)
    _, tt = _targets(w, h)
    pt = lt.RenderParams(hooks=(ht,), peak_detect=None)
    rt = lt.Renderer(device="cpu")
    first = rt._render_once(_const_rgb(_EMA_VALS[0], h, w)[1], tt,
                            pt).numpy()
    rt._render_once(_const_rgb(_EMA_VALS[1], h, w)[1], tt, pt)
    rt.reset_hook_state()
    again = rt._render_once(_const_rgb(_EMA_VALS[0], h, w)[1], tt,
                            pt).numpy()
    np.testing.assert_allclose(first, again, atol=1e-7)


def test_path_j_shader_texts_are_the_tests():
    """chip_smoke.py keeps its own copies of the two shaders (it imports
    nothing of the JAX package's tests): they are the texts of
    tests/test_mpv_hooks.py."""
    lut = chip_smoke.path_j_lut()
    assert lut.shape == (JT._RAVU_ROWS, JT._RAVU_TAPS, 4) and \
        lut.dtype == np.float16
    assert chip_smoke.path_j_ravu_shader(lut) == JT._ravu_lite_shader(lut)
    assert chip_smoke.PATH_J_EMA_SHADER == JT.TEMPORAL_EMA_SHADER
    assert chip_smoke.path_j_ema_shader(96, 64) == \
        JT.TEMPORAL_EMA_SHADER.replace("//!SIZE 48 32", "//!SIZE 96 64")


def test_path_j_small_matches_the_reference():
    """Path J at a small size (3 frames of config 2's content, 32x64 ->
    64x128 8-bit): params from Options().parse(PATH_J_OPTIONS) with both
    shaders through add_hook, in both packages.  MAIN is the doubled
    grid (the EMA's //!SIZE), no hook is disabled, the counter reads 3,
    each frame within config 5's gate; the hooked tail is plain (counted
    ineligible) and the CPU runs K2's and K3's plain versions (no
    launch)."""
    h, w = 32, 64
    yuvs = chip_smoke._flagship_yuv(3, h, w, seed=7)
    pt = chip_smoke.path_j_params(lt, w, h)
    oj = jopt.Options()
    oj.parse(chip_smoke.PATH_J_OPTIONS)
    oj.add_hook(chip_smoke.path_j_ravu_shader(chip_smoke.path_j_lut()))
    oj.add_hook(chip_smoke.path_j_ema_shader(2 * w, 2 * h))
    pj = oj.params
    assert pt.upscaler == pj.upscaler == "ewa_lanczos"
    assert pt.error_diffusion == pj.error_diffusion == "sierra-lite"
    main_shapes = []
    rec = lt.Hook(lt.HookStage.RGB,
                  lambda img, p: main_shapes.append(tuple(img.shape)),
                  name="main_size")
    pt = dataclasses.replace(pt, hooks=(rec,) + tuple(pt.hooks))
    jt, tt = _targets(2 * w, 2 * h, bit_depth=8)
    rj, rt = jr.Renderer(), lt.Renderer(device="cpu")
    color = dict(primaries="bt.709", transfer="bt.1886")
    for m in (k2, k3):
        m.launches = 0
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    for y, u, v in yuvs:
        jf = jfr.frame_from_yuv420p(
            y, u, v, color=jcs.ColorSpace(**color),
            repr=jcs.ColorRepr(sys=jcs.ColorSystem.BT_709,
                               levels=jcs.ColorLevels.LIMITED,
                               bits=jcs.BitEncoding(8, 8, 0)))
        tf = chip_smoke._frame(lt, (y, u, v), "cpu", config="config2")
        out_j = np.asarray(rj.render(jf, jt, pj))
        out_t = rt.render(tf, tt, pt).numpy()
        d = np.abs(out_t - out_j)
        assert (d > LSB + 1e-6).mean() <= 5e-4 and (d > 1e-6).mean() < 0.12
    assert main_shapes == [(3, 2 * h, 2 * w)] * 3
    assert rt.get_errors() == (frozenset(), frozenset())
    assert not rj._disabled_hooks
    ema = pt.hooks[2]
    assert float(rt._hook_states[(ema.signature, "buf:frames")][0]) == 3.0
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == \
        (0, 0, 3)
    assert k2.launches == k3.launches == 0
    acc_j = np.asarray(rj._hook_states[(pj.hooks[1].signature, "tex:ACC")])
    acc_t = rt._hook_states[(ema.signature, "tex:ACC")].numpy()
    np.testing.assert_allclose(acc_t, acc_j, rtol=0, atol=1e-5)

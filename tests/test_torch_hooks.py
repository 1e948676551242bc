"""PyTorch port: user hooks (render/hooks.py and the renderer's sixteen
hook sites) against the JAX package on the CPU.

A recording hook at each stage — the same callable for both packages,
`img * 0.9 + 0.05` — records what its stage receives (the JAX side
through jax.debug.callback inside the jitted render) and changes the
image, so every later stage sees the change.  Tolerances, measured on
these inputs and stated per stage in `_STAGE_ATOL`: the raw planes and
the chroma merge exactly; the decode's known last ulp (ROADMAP §3 F1)
within 2.4e-7; the transfer curves within PyTorch's pow against XLA's
(rtol 2e-5, as tests/test_torch_mix.py states for them); after the
scaler and in the output the frames within the gate of the plain tail
(every value within 1 LSB, fewer than 1e-3 of them differing, as
tests/test_torch_core.py::test_outside_the_slice_raises holds
the plain tails of its cases; an XYZ frame's ST 428 curve within 1 LSB
on < 1e-2, the gate of pow-based tails in
tests/test_torch_color_tails.py).  Hooks that resize, with a declared
offset: the sampling rects equal and the frames within the same gate.
The cross-frame state over 3 frames within 1e-6 (a mean of the output);
a raising hook disabled in both with the same signature set and one log
record each; a KernelError raised by a hook propagates.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import log as jlog
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import hooks as jhooks
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.core import log as tlog
from libplacebo_tpu_torch.render import hooks as thooks
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0
H, W = 64, 128


def _assert_frame_gate(out_t, out_j, frac=1e-3):
    d = np.abs(out_t - out_j)
    assert d.max() <= LSB + 1e-6, d.max()
    assert (d > 1e-6).mean() < frac, (d > 1e-6).mean()


def _recording(rec):
    """The same hook for both packages: records its input (a torch
    tensor directly, a traced jnp array through a host callback) and
    returns img * 0.9 + 0.05."""
    def hook(img, params):
        if isinstance(img, torch.Tensor):
            rec.append(img.detach().cpu().numpy().copy())
        else:
            jax.debug.callback(lambda x: rec.append(np.array(x)), img)
        return img * 0.9 + 0.05
    return hook


def _rng_planes(seed, alpha=False):
    """An 8-bit limited 4:2:0 frame's normalized planes (Y, then CbCr,
    then a half-size alpha plane)."""
    rng = np.random.default_rng(seed)
    y = ((rng.random((1, H, W)) * 219 + 16).round() / 255).astype(np.float32)
    uv = ((rng.random((2, H // 2, W // 2)) * 224 + 16).round()
          / 255).astype(np.float32)
    planes = [(y, (0,)), (uv, (1, 2))]
    if alpha:
        planes.append((rng.random((1, H // 2, W // 2)).astype(np.float32),
                       (3,)))
    return planes


def _frames(planes, sys, color_j, color_t, levels="limited"):
    jf = jfr.Frame(planes=[jfr.Plane(jax.numpy.asarray(d), m)
                           for d, m in planes],
                   repr=jcs.ColorRepr(sys=sys, levels=levels),
                   color=color_j)
    tf = carry.frame_from_numpy(planes, lt.ColorRepr(sys=sys, levels=levels),
                                color_t, device="cpu")
    return jf, tf


def _case(stage):
    """(JAX frame, port frame) that reaches `stage`: BT.709 4:2:0 for
    the main stages, RGB for RGB_INPUT, XYZ for XYZ_INPUT, and a frame
    with a half-size alpha plane for the alpha stages."""
    if stage == "RGB_INPUT":
        rgb = np.random.default_rng(3).random((3, H, W)).astype(np.float32)
        color = dict(primaries="bt.709", transfer="bt.1886")
        return (jfr.frame_from_rgb(rgb, color=jcs.ColorSpace(**color)),
                lt.frame_from_rgb(rgb, color=lt.ColorSpace(**color),
                                  device="cpu"))
    if stage == "XYZ_INPUT":
        xyz = np.random.default_rng(4).random((3, H, W)).astype(np.float32)
        color = dict(primaries="dci-p3", transfer="st428")
        return _frames([(xyz, (0, 1, 2))], "xyz", jcs.ColorSpace(**color),
                       lt.ColorSpace(**color), levels="full")
    planes = _rng_planes(2, alpha=stage.startswith("ALPHA"))
    color = dict(primaries="bt.709", transfer="bt.1886")
    return _frames(planes, "bt.709", jcs.ColorSpace(**color),
                   lt.ColorSpace(**color))


# per stage: the atol of what the stage receives (None: the frame gate)
_STAGE_ATOL = {
    "RGB_INPUT": 0.0, "LUMA_INPUT": 0.0, "CHROMA_INPUT": 0.0,
    "ALPHA_INPUT": 0.0, "XYZ_INPUT": 0.0, "CHROMA_SCALED": 0.0,
    "ALPHA_SCALED": 0.0, "NATIVE": 2.4e-7, "RGB": 2.4e-7,
    "LINEAR": 2e-5, "SIGMOID": 2e-5, "PRE_KERNEL": 2e-5,
    "POST_KERNEL": None, "SCALED": None, "PRE_OUTPUT": None,
    "OUTPUT": None}


def _render_pair(jf, tf, jhook_list, thook_list, tgt_bits=8, **kw):
    jt = jr.Target(w=2 * W, h=2 * H, color=jcs.CSP_SRGB, bit_depth=tgt_bits)
    tt = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=tgt_bits)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    out_j = np.asarray(jrend.render(jf, jt, jr.RenderParams(
        hooks=tuple(jhook_list), **kw)))
    jax.effects_barrier()
    out_t = trend.render(tf, tt, lt.RenderParams(hooks=tuple(thook_list),
                                                 **kw)).numpy()
    return out_j, out_t, jrend, trend


@pytest.mark.parametrize("stage", list(_STAGE_ATOL))
def test_recording_hook_at_each_stage(stage):
    """What each of the sixteen stages receives, and the frame after the
    hook changed it, against the reference; the tail is plain in both
    (hooks make it ineligible) and counted so."""
    jf, tf = _case(stage)
    rec_j, rec_t = [], []
    fn_j, fn_t = _recording(rec_j), _recording(rec_t)
    jh = jhooks.Hook(getattr(jhooks.HookStage, stage), fn_j, name=stage)
    th = thooks.Hook(getattr(thooks.HookStage, stage), fn_t, name=stage)
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    out_j, out_t, jrend, trend = _render_pair(jf, tf, [jh], [th])
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (0, 0, 1)
    assert len(rec_j) == len(rec_t) >= 1, (len(rec_j), len(rec_t))
    for a_t, a_j in zip(rec_t, rec_j):
        assert a_t.shape == a_j.shape, (a_t.shape, a_j.shape)
        atol = _STAGE_ATOL[stage]
        if atol is None:
            _assert_frame_gate(a_t, a_j)
        elif atol == 2e-5:
            np.testing.assert_allclose(a_t, a_j, rtol=2e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(a_t, a_j, rtol=0, atol=atol)
    assert out_t.shape == out_j.shape
    # ST 428's pow-based curve: the gate tests/test_torch_color_tails.py
    # holds pow-based plain tails to (measured 1.25e-3 differing)
    _assert_frame_gate(out_t, out_j,
                       frac=1e-2 if stage == "XYZ_INPUT" else 1e-3)
    assert trend.get_errors() == (frozenset(), frozenset())
    assert jrend.get_errors() == (frozenset(), frozenset())


def _doubler(xp):
    """A LUMA_INPUT 2x doubler, nearest, declaring the half-texel shift
    of its output grid (mpv's //!OFFSET): `xp` is the array module."""
    def hook(img, params):
        if xp == "torch":
            out = img.repeat_interleave(2, dim=-2).repeat_interleave(2,
                                                                     dim=-1)
        else:
            out = jax.numpy.repeat(jax.numpy.repeat(img, 2, axis=-2), 2,
                                   axis=-1)
        params.rect.apply_pass(2.0, 2.0, off=(0.5, 0.5))
        return out
    return hook


def _native_widener(xp):
    """A NATIVE hook doubling the width, declaring a quarter-texel x
    offset: under rotation=1 both turn into the crop's y axis."""
    def hook(img, params):
        if xp == "torch":
            out = img.repeat_interleave(2, dim=-1)
        else:
            out = jax.numpy.repeat(img, 2, axis=-1)
        params.rect.apply_pass(2.0, 1.0, off=(0.25, 0.0))
        return out
    return hook


@pytest.mark.parametrize("case", ["luma_doubler", "native_rotated"])
def test_resizing_hooks_with_offsets(case):
    """A resizing LUMA_INPUT hook (the reference grid follows the hooked
    luma, the chroma aligns to it with the declared offset), and a
    resizing NATIVE hook under rotation=1 (its scale and offset fold
    into the turned crop): the sampling rects the main scaler gets and
    the frames against the reference."""
    from libplacebo_tpu.ops import polar as jpolar
    from libplacebo_tpu.ops import sampling as jsamp
    from libplacebo_tpu_torch.ops import polar as tpolar
    from libplacebo_tpu_torch.ops import sampling as tsamp
    jf, tf = _case("LUMA_INPUT")
    stage, make = (("LUMA_INPUT", _doubler) if case == "luma_doubler"
                   else ("NATIVE", _native_widener))
    if case == "native_rotated":
        jf.rotation = tf.rotation = 1
    jh = jhooks.Hook(getattr(jhooks.HookStage, stage), make("jax"))
    th = thooks.Hook(getattr(thooks.HookStage, stage), make("torch"))
    # every sampler call's input shape and rect (the 5th argument of
    # both samplers), in order
    rects = {"j": [], "t": []}
    spied = [(m, name, side) for side, mods in (("j", (jpolar, jsamp)),
                                                ("t", (tpolar, tsamp)))
             for m, name in zip(mods, ("sample_polar", "resize_separable"))]
    reals = [getattr(m, name) for m, name, _ in spied]

    def spy(real, side):
        def run(*a, **k):
            rects[side].append((tuple(a[0].shape), a[4] if len(a) > 4
                                else k.get("rect")))
            return real(*a, **k)
        return run
    for (m, name, side), real in zip(spied, reals):
        setattr(m, name, spy(real, side))
    try:
        out_j, out_t, jrend, trend = _render_pair(
            jf, tf, [jh], [th], upscaler="ewa_lanczos")
    finally:
        for (m, name, _), real in zip(spied, reals):
            setattr(m, name, real)
    assert rects["j"] and len(rects["t"]) == len(rects["j"])
    for (shape_t, r_t), (shape_j, r_j) in zip(rects["t"], rects["j"]):
        assert shape_t == shape_j
        np.testing.assert_allclose([r_t.x0, r_t.y0, r_t.x1, r_t.y1],
                                   [r_j.x0, r_j.y0, r_j.x1, r_j.y1],
                                   rtol=0, atol=1e-12)
    main_rect = rects["t"][-1][1]
    assert (main_rect.x0, main_rect.y0) != (0.0, 0.0)
    _assert_frame_gate(out_t, out_j)
    assert trend.get_errors() == jrend.get_errors() == (frozenset(),
                                                        frozenset())


def _exposure(xp):
    """A PRE_OUTPUT auto-exposure: a running mean of the frame's
    intensity, carried across frames, sets a small gain."""
    def hook(img, params):
        mean = params.state_in["mean"]
        cur = img.mean()
        new = mean * 0.75 + cur * 0.25
        params.state_out["mean"] = new
        return img * (1.0 + (0.5 - new) * 0.1)
    return hook


def test_state_spec_hook_over_three_frames():
    """The carried state equals the reference's after each of 3 frames;
    carry.hook_states_from_numpy starts the port from the reference's
    state, and reset_hook_state starts it over from the spec."""
    jh = jhooks.Hook(jhooks.HookStage.PRE_OUTPUT, _exposure("jax"))
    th = thooks.Hook(thooks.HookStage.PRE_OUTPUT, _exposure("torch"))
    jh.state_spec = th.state_spec = {"mean": np.float32(0.5)}
    jt = jr.Target(w=2 * W, h=2 * H, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    jp = jr.RenderParams(hooks=(jh,))
    tp = lt.RenderParams(hooks=(th,))
    for seed in range(3):
        planes = _rng_planes(10 + seed)
        color = dict(primaries="bt.709", transfer="bt.1886")
        jf, tf = _frames(planes, "bt.709", jcs.ColorSpace(**color),
                         lt.ColorSpace(**color))
        out_j = np.asarray(jrend.render(jf, jt, jp))
        out_t = trend.render(tf, tt, tp).numpy()
        _assert_frame_gate(out_t, out_j)
        sj = float(np.asarray(jrend._hook_states[(jh.signature, "mean")]))
        st = float(trend._hook_states[(th.signature, "mean")])
        assert abs(st - sj) <= 1e-6, (st, sj)
    assert len(trend._cache) == 1       # new state, no new plan
    fresh = carry.hook_states_from_numpy(
        {(th.signature, "mean"): np.asarray(
            jrend._hook_states[(jh.signature, "mean")])}, device="cpu")
    assert float(fresh._hook_states[(th.signature, "mean")]) == sj
    trend.reset_hook_state()
    assert not trend._hook_states


def test_raising_hook_is_disabled_and_logged(monkeypatch):
    """A hook that raises is disabled by signature in both packages, the
    frame renders without it, and each package logs it once."""
    def broken(img, params):
        raise RuntimeError("synthetic hook failure")
    logs = {"j": [], "t": []}
    monkeypatch.setattr(jlog, "default_log", lambda: jlog.Log(
        level=jlog.LogLevel.ERR,
        callback=lambda lvl, msg: logs["j"].append(msg)))
    monkeypatch.setattr(tlog, "default_log", lambda: tlog.Log(
        level=tlog.LogLevel.ERR,
        callback=lambda lvl, msg: logs["t"].append(msg)))
    jf, tf = _case("RGB")
    jh = jhooks.Hook(jhooks.HookStage.RGB, broken, name="broken")
    th = thooks.Hook(thooks.HookStage.RGB, broken, name="broken")
    out_j, out_t, jrend, trend = _render_pair(jf, tf, [jh], [th])
    _assert_frame_gate(out_t, out_j)
    assert jrend.get_errors() == trend.get_errors() == (
        frozenset(), frozenset({id(broken)}))
    assert len(logs["j"]) == len(logs["t"]) == 1
    assert "synthetic hook failure" in logs["t"][0]
    moved = carry.renderer_errors_from_jax(*jrend.get_errors(),
                                           device="cpu")
    assert moved.get_errors() == jrend.get_errors()
    trend.reset_errors(hooks=[id(broken)])
    assert trend.get_errors() == (frozenset(), frozenset())


def test_kernel_error_in_a_hook_propagates():
    """A KernelError (or a CUDA error) from a hook is never swallowed:
    it leaves Renderer.render, and nothing is disabled."""
    def kernel_fails(img, params):
        raise lt.KernelError("K1 launch failed: synthetic")

    def cuda_fails(img, params):
        raise RuntimeError("CUDA error: an illegal memory access")
    _, tf = _case("RGB")
    tt = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    for fn, exc in ((kernel_fails, lt.KernelError),
                    (cuda_fails, RuntimeError)):
        r = lt.Renderer(device="cpu")
        with pytest.raises(exc, match="synthetic|CUDA error"):
            r.render(tf, tt, lt.RenderParams(
                hooks=(thooks.Hook(thooks.HookStage.RGB, fn),)))
        assert r.get_errors() == (frozenset(), frozenset())


def test_hook_sets_key_their_plans():
    """Two hook sets give two plan keys (the reference keys on the
    signatures); the port's RenderParams has the reference's fields."""
    a = thooks.Hook(thooks.HookStage.RGB, lambda img, p: img)
    b = thooks.Hook(thooks.HookStage.RGB, lambda img, p: img * 1.0)
    pa, pb = lt.RenderParams(hooks=(a,)), lt.RenderParams(hooks=(b,))
    assert pa.key() != pb.key() != lt.RenderParams().key()
    assert pa.key() == lt.RenderParams(hooks=(a,)).key()
    _, tf = _case("RGB")
    tt = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    r = lt.Renderer(device="cpu")
    r.render(tf, tt, pa)
    r.render(tf, tt, pb)
    assert len(r._cache) == 2
    assert [f.name for f in dataclasses.fields(lt.RenderParams)] == \
        [f.name for f in dataclasses.fields(jr.RenderParams)]


def test_hook_rect_and_stage_parity():
    """HookStage's members and HookRect's arithmetic equal the
    reference's."""
    assert [s.name for s in thooks.HookStage] == \
        [s.name for s in jhooks.HookStage]
    assert [s.value for s in thooks.HookStage] == \
        [s.value for s in jhooks.HookStage]
    rt, rj = thooks.HookRect(), jhooks.HookRect()
    for r in (rt, rj):
        r.apply_pass(2.0, 2.0, off=(0.5, -0.25))
        r.apply_pass(1.5, 1.0, off=(0.125, 0.0))
        r.rotate(3)
    assert (rt.ox, rt.oy, rt.align) == (rj.ox, rj.oy, rj.align)
    for r in (rt, rj):
        r.apply_pass(1.0, 1.0, align=True)
    assert (rt.ox, rt.oy, rt.align) == (rj.ox, rj.oy, rj.align)

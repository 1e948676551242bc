"""PyTorch port: mpv .hook user shaders (render/mpv_hooks.py) against the
JAX package on the CPU — the text format, Options.add_hook, and fragment
passes at the run_hooks level.

Every case of tests/test_mpv_hooks.py has a parity case under the same
name here or in test_torch_mpv_hooks_compute.py (compute passes,
buffers, atomics, storage) and test_torch_mpv_hooks_render.py (the
renderer cases and path J small).  The shader texts are that module's.
The same seeded numpy input goes through both packages' hooks; each
case asserts that both accept or both auto-disable the shader, and
holds the outputs:
  * run_hooks outputs within ATOL = 2e-6 absolute (most are exact: the
    interpreter runs the same float32 ops in the same order);
  * data-dependent LUT lookups (the RAVU cases) within RAVU_ATOL = 1e-6:
    the port indexes the table and blends the two (four) taps where the
    JAX package contracts one-/two-hot matrices with it, the same
    products summed in another order;
  * sums over the frame (atomicAdd) within ATOMIC_RTOL = 1e-6 relative:
    torch's summation order differs from XLA's.
Parse results are equal field for field.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mpv_hooks as JT
from libplacebo_tpu.core import options as jopt
from libplacebo_tpu.render import hooks as jhooks
from libplacebo_tpu.render import mpv_hooks as jm

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import options as topt
from libplacebo_tpu_torch.render import hooks as thooks
from libplacebo_tpu_torch.render import mpv_hooks as tm

ATOL = 2e-6
RAVU_ATOL = 1e-6
ATOMIC_RTOL = 1e-6


def _img(h=8, w=12, seed=0, c=3):
    return np.random.default_rng(seed).random((c, h, w)).astype(np.float32)


def run_both(text, stages, img, parameters=None, frames=1, **ctx):
    """Run one shader's hook in both packages over `stages` (names of
    HookStage members) for `frames` frames on the same numpy input.
    Returns (JAX output, port output, JAX disabled?, port disabled?);
    asserts that both disabled the hook or neither did."""
    hj = jm.user_shader_hook(text, parameters=parameters)
    ht = tm.user_shader_hook(text, parameters=parameters)
    dj, dt = set(), set()
    for _ in range(frames):
        xj, xt = jnp.asarray(img), torch.from_numpy(img.copy())
        for st in stages:
            xj = jhooks.run_hooks([hj], jhooks.HookStage[st], xj, dj, **ctx)
            xt = thooks.run_hooks([ht], thooks.HookStage[st], xt, dt, **ctx)
    out_j, out_t = np.asarray(xj), xt.numpy()
    assert (hj.signature in dj) == (ht.signature in dt), (dj, dt)
    assert out_j.shape == out_t.shape
    return out_j, out_t, hj.signature in dj, ht.signature in dt


def assert_close(out_j, out_t, atol=ATOL):
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=atol)


def _pass_fields(p):
    return dataclasses.asdict(p)


def _assert_parse_equal(text):
    sj, st = jm.parse_user_shader(text), tm.parse_user_shader(text)
    assert [_pass_fields(p) for p in st.passes] == \
        [_pass_fields(p) for p in sj.passes]
    assert sorted(st.textures) == sorted(sj.textures)
    for n, tj in sj.textures.items():
        tt = st.textures[n]
        assert (tt.filter, tt.border, tt.storage) == \
            (tj.filter, tj.border, tj.storage)
        assert tt.data.dtype == tj.data.dtype
        np.testing.assert_array_equal(tt.data, tj.data)
    assert {n: dataclasses.asdict(p) for n, p in st.params.items()} == \
        {n: dataclasses.asdict(p) for n, p in sj.params.items()}
    assert sorted(st.buffers) == sorted(sj.buffers)
    for n, bj in sj.buffers.items():
        bt = st.buffers[n]
        assert (bt.name, bt.storage) == (bj.name, bj.storage)
        assert [dataclasses.asdict(v) for v in bt.vars] == \
            [dataclasses.asdict(v) for v in bj.vars]
        for k, vj in bj.values.items():
            vt = bt.values[k]
            assert type(vt) is type(vj)
            np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    return sj, st


# an atomicAdd of a position-derived (host) value: a device sum in the
# JAX package (jnp.sum), read by the next pass's per-pixel condition
ATOMIC_POSITION = """\
//!BUFFER stats
//!STORAGE
//!VAR float total

//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    atomicAdd(total, HOOKED_pos.x);
    return HOOKED_texOff(0);
}

//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    if (total > 10.0) {
        return HOOKED_texOff(0) * 0.5;
    }
    return vec4(total, 0.0, 0.0, 1.0);
}
"""

_RAVU_LUT = np.random.default_rng(42).uniform(
    -0.2, 0.5, (JT._RAVU_ROWS, JT._RAVU_TAPS, 4)).astype(np.float16)
ALL_SHADERS = {
    "SAVE_LOAD": JT.SAVE_LOAD_SHADER, "DISCO": JT.DISCO_SHADER,
    "PARAM": JT.PARAM_SHADER, "UNSHARP": JT.UNSHARP_SHADER,
    "UNSHARP_REAL": JT.UNSHARP_REAL, "FSRCNN_STYLE": JT.FSRCNN_STYLE,
    "IF": JT.IF_HOOK, "EARLY_RETURN": JT.EARLY_RETURN_HOOK,
    "BOTH_RETURN": JT.BOTH_RETURN_HOOK,
    "NESTED_RETURN": JT.NESTED_RETURN_HOOK,
    "LOOP_RETURN": JT.LOOP_RETURN_HOOK, "STATIC_IF": JT.STATIC_IF_HOOK,
    "FSRCNNX_LIKE": JT.FSRCNNX_LIKE,
    "RAVU_LITE": JT._ravu_lite_shader(_RAVU_LUT),
    "BUFFER_UNIFORM": JT._uniform_buffer_shader(),
    "STORAGE_AVG": JT.STORAGE_AVG_SHADER,
    "COMPUTE_IDENTITY": JT.COMPUTE_IDENTITY_HOOK,
    "COMPUTE_IDS": JT.COMPUTE_IDS_HOOK,
    "COMPUTE_SHARED_BLUR": JT.COMPUTE_SHARED_BLUR_HOOK,
    "COMPUTE_GUARD": JT.COMPUTE_GUARD_HOOK,
    "FOUR_ARG_COMPUTE": JT.FOUR_ARG_COMPUTE,
    "ATOMIC_GUARDED": JT.ATOMIC_GUARDED_COMPUTE,
    "ATOMIC_TRACED_IF": JT.ATOMIC_TRACED_IF,
    "ATOMIC_IF_ELSE_BOTH": JT.ATOMIC_IF_ELSE_BOTH,
    "ATOMIC_TWO_SIBLING_IFS": JT.ATOMIC_TWO_SIBLING_IFS,
    "STORAGE_PLAIN_COND_ASSIGN": JT.STORAGE_PLAIN_COND_ASSIGN % "1.0",
    "STORAGE_ATOMIC_THEN_PLAIN_ELSE":
        JT.STORAGE_ATOMIC_THEN_PLAIN_ELSE % "1.0",
    "LUMA_DOUBLER_OFFSET": JT.LUMA_DOUBLER_OFFSET,
    "MAIN_IDENTITY_OFFSET": JT.MAIN_IDENTITY_OFFSET,
    "TEMPORAL_EMA": JT.TEMPORAL_EMA_SHADER,
    "ATOMIC_POSITION": ATOMIC_POSITION,
}


# -- the text format ---------------------------------------------------

@pytest.mark.parametrize("name", list(ALL_SHADERS))
def test_parse_fields_equal(name):
    """Passes (hooks, binds, SAVE, sizes, //!WHEN, OFFSET, COMPUTE),
    textures (data, filter, border, STORAGE), params and buffers (std140
    / std430 values) equal field for field; the built hooks' stages,
    parameters and state specs equal too.  A shader the JAX package
    cannot parse (UNSHARP_SHADER's stray //!PARAM) raises the same error
    in the port."""
    try:
        jm.parse_user_shader(ALL_SHADERS[name])
    except jm.MpvHookError as e:
        with pytest.raises(tm.MpvHookError) as et:
            tm.parse_user_shader(ALL_SHADERS[name])
        assert str(et.value) == str(e)
        return
    _assert_parse_equal(ALL_SHADERS[name])
    hj = jm.user_shader_hook(ALL_SHADERS[name])
    ht = tm.user_shader_hook(ALL_SHADERS[name])
    assert ht.stages.value == hj.stages.value
    assert ht.parameters == hj.parameters
    sj = getattr(hj, "state_spec", None) or {}
    st = getattr(ht, "state_spec", None) or {}
    assert sorted(st) == sorted(sj)
    for k in sj:
        assert st[k].dtype == sj[k].dtype
        np.testing.assert_array_equal(st[k], sj[k])


@pytest.mark.parametrize("text", [
    "//!HOOK MAIN\n//!OFFSET 1\nvec4 hook() { return vec4(0.0); }\n",
    "//!HOOK MAIN\n//!COMPUTE 8\nvoid hook() { }\n",
    "//!HOOK MAIN\n//!FROB 1\nvec4 hook() { return vec4(0.0); }\n",
    "//!TEXTURE T\n//!SIZE 1 1\n//!FORMAT rgba99\n00000000\n",
    "//!TEXTURE T\n//!SIZE 2 1\n//!FORMAT r8\n00\n",
    "//!TEXTURE T\n//!FORMAT r8\n//!STORAGE\n\n",
    "//!BUFFER B\n//!VAR float x[0]\n",
    "//!BUFFER B\n//!VAR dmat2 x\n00000000\n",
    "//!BUFFER B\n//!VAR vec4 x\n0000\n",
    "//!PARAM p\n//!TYPE float\n//!FOO 1\n1.0\n",
    "//!HOOK MAIN\n//!WHEN 1x >\nvec4 hook() { return vec4(0.0); }\n",
])
def test_parse_errors_equal(text):
    """Malformed shaders raise MpvHookError (or the same exception type)
    with the same message in both packages."""
    with pytest.raises(Exception) as ej:
        jm.parse_user_shader(text)
    with pytest.raises(Exception) as et:
        tm.parse_user_shader(text)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_parse_save_load_shader():
    _, sh = _assert_parse_equal(JT.SAVE_LOAD_SHADER)
    assert len(sh.passes) == 2
    p0, p1 = sh.passes
    assert p0.hook_texs == ["NATIVE"]
    assert p0.save_tex == "NATIVEBIG"
    assert p0.width is not None and p0.cond is not None
    assert p1.bind_texs == ["NATIVEBIG"]


def test_buffer_uniform_parse_std140():
    _, sh = _assert_parse_equal(JT._uniform_buffer_shader())
    buf = sh.buffers["params_buf"]
    assert not buf.storage
    assert [v.name for v in buf.vars] == ["gain", "tint", "lut"]
    assert buf.values["gain"] == pytest.approx(2.0)
    np.testing.assert_allclose(buf.values["tint"], [0.1, 0.2, 0.3],
                               rtol=1e-6)
    np.testing.assert_allclose(buf.values["lut"].ravel(), [0.05, 0.07],
                               rtol=1e-6)


def test_buffer_storage_empty_payload_zero_init():
    _, sh = _assert_parse_equal(JT.STORAGE_AVG_SHADER)
    assert sh.buffers["stats"].storage
    assert sh.buffers["stats"].values["total"] == 0.0


def test_hook_rect_compose_and_rotate():
    for mod in (jhooks, thooks):
        hr = mod.HookRect()
        hr.apply_pass(2.0, 2.0, (-0.5, -0.5))
        hr.apply_pass(1.0, 1.0, (0.25, 0.0))
        assert (hr.ox, hr.oy) == (-0.25, -0.5)
        hr.apply_pass(3.0, 3.0)
        assert (hr.ox, hr.oy) == (-0.75, -1.5)
        hr.apply_pass(1.0, 1.0, align=True)
        assert hr.align and (hr.ox, hr.oy) == (0.0, 0.0)
        hr2 = mod.HookRect(ox=1.0, oy=2.0)
        hr2.rotate(1)
        assert (hr2.ox, hr2.oy) == (2.0, -1.0)
        hr2.rotate(3)
        assert (hr2.ox, hr2.oy) == (1.0, 2.0)


def test_stage_names_and_exports():
    """The stage map the parallel halo planner reads, and the public
    names, as the JAX package has them."""
    assert {k: v.name for k, v in tm._STAGE_MAP.items()} == \
        {k: v.name for k, v in jm._STAGE_MAP.items()}
    assert {k.name: v for k, v in tm._STAGE_NAME.items()} == \
        {k.name: v for k, v in jm._STAGE_NAME.items()}
    for name in ("parse_user_shader", "user_shader_hook", "UserShader",
                 "MpvHookError", "probe_recording"):
        assert hasattr(tm, name), name
    from libplacebo_tpu_torch import render
    assert render.parse_user_shader is lt.parse_user_shader is \
        tm.parse_user_shader
    assert render.user_shader_hook is lt.user_shader_hook is \
        tm.user_shader_hook
    assert issubclass(tm.MpvHookError, ValueError)


def test_probe_recording_equal():
    """The stencil probe records the same passes, position flag and row
    accesses (the halo planner's input) in both packages."""
    img = _img(10, 14, seed=2)
    recs = []
    for m, hm, x in ((jm, jhooks, jnp.asarray(img)),
                     (tm, thooks, torch.from_numpy(img))):
        rec = {}
        with m.probe_recording(rec):
            hm.run_hooks([m.user_shader_hook(JT.UNSHARP_REAL)],
                         hm.HookStage.RGB, x, set())
            hm.run_hooks([m.user_shader_hook(JT._ravu_lite_shader(
                _RAVU_LUT))], hm.HookStage.LUMA_INPUT, x[:1], set(),
                dst_w=28, dst_h=20)
        recs.append(rec)
    rj, rt = recs
    assert rt["passes"] == rj["passes"] == 3
    assert rt["pos_value"] == rj["pos_value"]
    assert len(rt["accesses"]) == len(rj["accesses"]) > 0
    for (pj, ij, hj), (pt, it, ht) in zip(rj["accesses"], rt["accesses"]):
        assert (pt, ht) == (pj, hj)
        np.testing.assert_array_equal(it, ij)


# -- Options.add_hook / insert_hook / remove_hook_at --------------------

_OPT_HOOK = ("//!HOOK LUMA\n//!BIND HOOKED\n"
             "vec4 hook() { return 2.0 * HOOKED_texOff(vec2(0.0)); }\n")


def test_options_hook_management():
    """add_hook / insert_hook / remove_hook_at as the JAX package's: the
    hooks land in params.hooks in order, a parse failure and a shader
    that hooks no stage raise OptionError in both."""
    for mod in (jopt, topt):
        o = mod.Options()
        o.add_hook(_OPT_HOOK)
        assert len(o.params.hooks) == 1
        o.insert_hook(0, JT.UNSHARP_REAL)
        assert len(o.params.hooks) == 2
        assert o.params.hooks[0].parameters == {"strength": 0.5}
        o.remove_hook_at(1)
        assert len(o.params.hooks) == 1
        with pytest.raises(mod.OptionError, match="no known stage"):
            o.add_hook("//!not a shader at all\x00")
        with pytest.raises(mod.OptionError,
                           match="failed parsing user shader: "
                                 "Unrecognized command 'FROB'"):
            o.add_hook("//!HOOK MAIN\n//!FROB\nvec4 hook() { }\n")
        with pytest.raises(IndexError):
            o.remove_hook_at(5)
    assert isinstance(o.params.hooks[0], thooks.Hook)


def test_options_hooks_run_in_the_renderer():
    """A shader added through Options renders in the port as in the JAX
    package (an 8x8 RGB frame, the unsharp hook at MAIN)."""
    from libplacebo_tpu.core.colorspace import CSP_SRGB
    from libplacebo_tpu.render.frame import frame_from_rgb
    from libplacebo_tpu.render.renderer import Renderer, Target
    rgb = np.random.default_rng(5).random((8, 8, 3)).astype(np.float32)
    outs = []
    for mod, render in (
            (jopt, lambda p: np.asarray(Renderer()._render_once(
                frame_from_rgb(rgb, color=CSP_SRGB),
                Target(w=8, h=8, color=CSP_SRGB), p))),
            (topt, lambda p: lt.Renderer(device="cpu")._render_once(
                lt.frame_from_rgb(rgb, color=lt.CSP_SRGB, device="cpu"),
                lt.Target(w=8, h=8, color=lt.CSP_SRGB), p).numpy())):
        o = mod.Options()
        o.parse("peak_detect=no,dither=no,linear_scaling=no")
        o.add_hook(JT.UNSHARP_REAL)
        outs.append(render(o.params))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=ATOL)


# -- fragment passes ------------------------------------------------------

def test_save_load_runs_with_when_gating():
    """NATIVE saves a 10x bilinear upscale (the image itself passes
    through), MAIN samples it back; with the render's sizes given, both
    passes run in both packages."""
    img = _img(8, 12)
    out_j, out_t, dj, _ = run_both(JT.SAVE_LOAD_SHADER, ["NATIVE"], img,
                                   dst_w=24, dst_h=16)
    assert not dj
    np.testing.assert_array_equal(out_t, img)
    out_j, out_t, dj, _ = run_both(JT.SAVE_LOAD_SHADER, ["NATIVE", "RGB"],
                                   img, dst_w=24, dst_h=16)
    assert not dj and out_t.shape == (3, 8, 12)
    assert_close(out_j, out_t)
    assert np.abs(out_t - img).max() < 0.1


def test_when_gating_blocks_large_frames():
    img = _img(8, 600)
    out_j, out_t, _, _ = run_both(JT.SAVE_LOAD_SHADER, ["NATIVE", "RGB"],
                                  img, dst_w=600, dst_h=8)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t, img)


def test_disco_texture_shader():
    out_j, out_t, _, dt = run_both(JT.DISCO_SHADER, ["RGB"],
                                   _img(6, 9, seed=1))
    assert not dt and out_t.shape == (3, 6, 9)
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("params", [None, {"intensity": 2.0},
                                    {"intensity": 1e6}])
def test_param_when_gating(params):
    out_j, out_t, _, _ = run_both(JT.PARAM_SHADER, ["RGB"], _img(),
                                  parameters=params)
    assert_close(out_j, out_t)
    if params is None:
        np.testing.assert_allclose(out_t, _img(), atol=1e-6)
    assert tm.user_shader_hook(JT.PARAM_SHADER, parameters=params) \
        .parameters == jm.user_shader_hook(JT.PARAM_SHADER,
                                           parameters=params).parameters


def test_unsharp_community_hook():
    out_j, out_t, _, _ = run_both(JT.UNSHARP_REAL, ["RGB"],
                                  _img(10, 14, seed=2),
                                  parameters={"strength": 1.5})
    assert_close(out_j, out_t)


def test_glsl_subset_math():
    src = """\
//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    vec3 t = clamp(c.rgb * 2.0 - 0.25, 0.0, 1.0);
    float luma = dot(t, vec3(0.25, 0.5, 0.25));
    t = mix(t, vec3(luma), 0.5);
    t = pow(max(t, 0.0), vec3(1.2));
    t = t + 0.01 * vec3(smoothstep(0.2, 0.8, luma), step(0.5, c.g),
                        fract(c.b * 3.0));
    t.r = t.r + 0.01 * (abs(sin(c.r)) + cos(c.g) + exp2(-c.b) +
                        inversesqrt(c.r + 1.0) + sign(c.g - 0.5) +
                        length(c.rg) + distance(c.rg, c.ba) +
                        mod(c.r * 7.0, 2.0) + atan(c.g, c.b + 0.1) +
                        floor(c.b * 4.0) + ceil(c.r) + round(c.g * 3.0) +
                        trunc(c.b * 5.0) + saturate(c.r * 2.0) +
                        log2(c.g + 1.0) + sqrt(c.r));
    t.g = c.r > 0.5 && c.g < 0.5 ? t.g : (c.b > 0.3 || c.r < 0.1 ?
                                          1.0 - t.g : t.g * 0.5);
    return vec4(normalize(t + 0.1), 1.0);
}
"""
    out_j, out_t, dj, _ = run_both(src, ["RGB"], _img(4, 6, seed=3))
    assert not dj
    assert_close(out_j, out_t)


def test_data_dependent_sampling_rejected():
    src = """\
//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    return HOOKED_tex(HOOKED_pos + c.xy);
}
"""
    out_j, out_t, dj, dt = run_both(src, ["RGB"], _img())
    assert dj and dt
    np.testing.assert_array_equal(out_t, _img())


def test_for_loop_hook():
    out_j, out_t, _, _ = run_both(JT.FSRCNN_STYLE, ["RGB"],
                                  _img(6, 12, seed=4))
    assert_close(out_j, out_t)


def test_per_pixel_if_hook():
    """Predicated if/else on a per-pixel condition."""
    out_j, out_t, dj, _ = run_both(JT.IF_HOOK, ["RGB"], _img(5, 7, seed=6))
    assert not dj
    assert_close(out_j, out_t)


def test_per_pixel_early_return():
    out_j, out_t, _, _ = run_both(JT.EARLY_RETURN_HOOK, ["RGB"],
                                  _img(5, 7, seed=9))
    assert_close(out_j, out_t)


def test_per_pixel_if_else_both_return():
    out_j, out_t, _, _ = run_both(JT.BOTH_RETURN_HOOK, ["RGB"],
                                  _img(4, 6, seed=10))
    assert_close(out_j, out_t)


def test_nested_per_pixel_early_return():
    out_j, out_t, _, _ = run_both(JT.NESTED_RETURN_HOOK, ["RGB"],
                                  _img(5, 6, seed=11))
    assert_close(out_j, out_t)


def test_early_return_inside_loop():
    out_j, out_t, _, _ = run_both(JT.LOOP_RETURN_HOOK, ["RGB"],
                                  _img(5, 7, seed=12))
    assert_close(out_j, out_t)


@pytest.mark.parametrize("params", [None, {"mode": 0}])
def test_static_if_with_define(params):
    out_j, out_t, _, _ = run_both(JT.STATIC_IF_HOOK, ["RGB"],
                                  _img(4, 6, seed=7), parameters=params)
    assert_close(out_j, out_t)
    np.testing.assert_allclose(out_t, (2.0 if params is None else 0.5)
                               * _img(4, 6, seed=7), atol=1e-6)


_CONST_ARRAY_SH = r"""
//!DESC array tables
//!HOOK LUMA
//!BIND HOOKED
vec4 hook() {
    const vec2 offsets[4] = vec2[](vec2(1.0, 0.0), vec2(-1.0, 0.0),
                                   vec2(0.0, 1.0), vec2(0.0, -1.0));
    const float W[4] = float[4](0.4, 0.3, 0.2, 0.1);
    float ws[2] = float[](0.25, 0.75);
    ws[0] = ws[0] + 0.05;
    float acc = 0.0;
    for (int i = 0; i < 4; i++) {
        acc += W[i] * HOOKED_texOff(offsets[i]).x;
    }
    float c = HOOKED_tex(HOOKED_pos).x;
    return vec4(mix(c, acc, ws[0]), 0.0, 0.0, 1.0);
}
"""


def test_const_array_tables():
    img = _img(32, 48, c=1)
    out_j, out_t, dj, _ = run_both(_CONST_ARRAY_SH, ["LUMA_INPUT"], img)
    assert not dj
    assert_close(out_j, out_t)
    # a data-dependent index is rejected (auto-disabled) by both
    bad = _CONST_ARRAY_SH.replace("W[i]", "W[int(c * 3.0)]").replace(
        "float c = HOOKED_tex(HOOKED_pos).x;\n", "").replace(
        "vec4 hook() {",
        "vec4 hook() {\n    float c = HOOKED_tex(HOOKED_pos).x;")
    out_j, out_t, dj, dt = run_both(bad, ["LUMA_INPUT"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_ravu_lite_class_hook():
    """Data-dependent LUT row (NEAREST //!TEXTURE indexed by computed
    coords), a 2-pass SAVE and the subpixel interleave with a per-pixel
    vector index, against the JAX package and its numpy oracle."""
    rng = np.random.default_rng(42)
    lut = rng.uniform(-0.2, 0.5,
                      (JT._RAVU_ROWS, JT._RAVU_TAPS, 4)).astype(np.float16)
    H, W = 24, 40
    img = rng.uniform(0, 1, (H, W)).astype(np.float32)
    out_j, out_t, dj, _ = run_both(JT._ravu_lite_shader(lut),
                                   ["LUMA_INPUT"], img[None],
                                   dst_w=2 * W, dst_h=2 * H)
    assert not dj and out_t.shape == (1, 2 * H, 2 * W)
    assert_close(out_j, out_t, RAVU_ATOL)
    np.testing.assert_allclose(out_t[0], JT._ravu_lite_oracle(img, lut),
                               atol=2e-5)


def test_ravu_lite_when_gate_respects_output():
    rng = np.random.default_rng(1)
    lut = rng.uniform(-0.2, 0.5,
                      (JT._RAVU_ROWS, JT._RAVU_TAPS, 4)).astype(np.float16)
    img = rng.uniform(0, 1, (1, 16, 24)).astype(np.float32)
    out_j, out_t, _, _ = run_both(JT._ravu_lite_shader(lut),
                                  ["LUMA_INPUT"], img, dst_w=24, dst_h=16)
    np.testing.assert_array_equal(out_t, img)
    np.testing.assert_array_equal(out_t, out_j)


def _ravu_zoom_shader(zlut, ZR, ZC):
    return f"""\
//!DESC ravu-zoom-class
//!HOOK LUMA
//!BIND HOOKED
//!BIND zoom_lut
//!WIDTH OUTPUT.w
//!HEIGHT OUTPUT.h

#define S(x, y) HOOKED_tex((base + vec2(x, y) + vec2(0.5)) * HOOKED_pt).x

vec4 hook() {{
    vec2 pos = HOOKED_pos * HOOKED_size - vec2(0.5);
    vec2 base = floor(pos);
    vec2 sub = pos - base;
    float gx = S(1.0, 0.0) - S(-1.0, 0.0);
    float gy = S(0.0, 1.0) - S(0.0, -1.0);
    float strength = min(floor(sqrt(gx * gx + gy * gy) * 4.0), 3.0);
    vec4 w = texture(zoom_lut, vec2(sub.x, (strength + sub.y) / {ZR}.0));
    float res = S(0.0, 0.0) * w.x + S(1.0, 0.0) * w.y + S(0.0, 1.0) * w.z + S(1.0, 1.0) * w.w;
    return vec4(res, 0.0, 0.0, 1.0);
}}

//!TEXTURE zoom_lut
//!SIZE {ZC} {ZR}
//!FORMAT rgba16hf
//!FILTER LINEAR
{zlut.tobytes().hex()}
"""


def test_ravu_zoom_class_hook():
    """LINEAR LUT indexed by (host subpixel x, data-dependent strength +
    host subpixel y); the source sampled at floor()-derived positions."""
    rng = np.random.default_rng(7)
    ZR, ZC = 4, 16
    zlut = rng.uniform(0.0, 0.5, (ZR, ZC, 4)).astype(np.float16)
    img = rng.uniform(0, 1, (1, 24, 40)).astype(np.float32)
    out_j, out_t, dj, _ = run_both(_ravu_zoom_shader(zlut, ZR, ZC),
                                   ["LUMA_INPUT"], img, dst_w=64, dst_h=40)
    assert not dj and out_t.shape == (1, 40, 64)
    assert_close(out_j, out_t, RAVU_ATOL)


def test_dynamic_lut_both_axes_and_borders():
    """Both coordinates data-dependent (the flattened-table path), LINEAR
    and NEAREST, under each border mode, against the JAX package."""
    lut = np.random.default_rng(3).uniform(0, 1, (8, 6, 4)).astype(
        np.float16)
    img = _img(12, 16, seed=14)
    for filt in ("LINEAR", "NEAREST"):
        for border in ("CLAMP", "REPEAT", "MIRROR"):
            src = f"""\
//!HOOK MAIN
//!BIND HOOKED
//!BIND small_lut
vec4 hook()
{{
    vec4 c = HOOKED_texOff(0);
    return texture(small_lut, c.xy * 1.6 - 0.3);
}}

//!TEXTURE small_lut
//!SIZE 6 8
//!FORMAT rgba16hf
//!FILTER {filt}
//!BORDER {border}
{lut.tobytes().hex()}
"""
            out_j, out_t, dj, _ = run_both(src, ["RGB"], img)
            assert not dj, (filt, border)
            assert_close(out_j, out_t, RAVU_ATOL)


def test_dynamic_sampling_of_image_texture_still_rejected():
    src = """\
//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    return HOOKED_tex(HOOKED_pos + c.xy * HOOKED_pt);
}
"""
    img = _img(16, 24)
    out_j, out_t, dj, dt = run_both(src, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)
    big = np.zeros((128, 64, 4), np.float16)     # 8192 > 4096 texels
    src2 = f"""\
//!HOOK MAIN
//!BIND HOOKED
//!BIND big_lut
vec4 hook()
{{
    vec4 c = HOOKED_texOff(0);
    return texture(big_lut, c.xy);
}}

//!TEXTURE big_lut
//!SIZE 64 128
//!FORMAT rgba16hf
{big.tobytes().hex()}
"""
    out_j, out_t, dj, dt = run_both(src2, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_buffer_uniform_vars_in_body():
    out_j, out_t, dj, _ = run_both(JT._uniform_buffer_shader(), ["RGB"],
                                   _img(8, 12))
    assert not dj
    assert_close(out_j, out_t)


def test_buffer_storage_atomic_add_across_passes():
    out_j, out_t, dj, _ = run_both(JT.STORAGE_AVG_SHADER, ["RGB"],
                                   _img(6, 10, seed=1))
    assert not dj
    assert_close(out_j, out_t)


def test_buffer_storage_resets_each_frame():
    """Without the renderer's state channel, buffers start over each
    frame: the second frame equals the first, in both."""
    img = _img(6, 10, seed=2)
    one_j, one_t, _, _ = run_both(JT.STORAGE_AVG_SHADER, ["RGB"], img)
    two_j, two_t, _, _ = run_both(JT.STORAGE_AVG_SHADER, ["RGB"], img,
                                  frames=2)
    np.testing.assert_array_equal(two_t, one_t)
    np.testing.assert_array_equal(two_j, one_j)


@pytest.mark.parametrize("bad", [
    JT._uniform_buffer_shader().replace(
        "vec4 c = HOOKED_texOff(0);",
        "vec4 c = HOOKED_texOff(0); gain = 3.0;"),
    JT._uniform_buffer_shader().replace(
        "vec4 c = HOOKED_texOff(0);",
        "vec4 c = HOOKED_texOff(0); lut[0] = 3.0;"),
    JT._uniform_buffer_shader().replace(
        "vec4 c = HOOKED_texOff(0);",
        "vec4 c = HOOKED_texOff(0); atomicAdd(gain, 1.0);")])
def test_buffer_uniform_assignment_rejected(bad):
    img = np.zeros((3, 4, 4), np.float32)
    out_j, out_t, dj, dt = run_both(bad, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_buffer_storage_per_pixel_write_rejected():
    bad = JT.STORAGE_AVG_SHADER.replace(
        "atomicAdd(total, HOOKED_texOff(0).x);",
        "total = HOOKED_texOff(0).x;")
    img = np.zeros((3, 4, 4), np.float32)
    out_j, out_t, dj, dt = run_both(bad, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_offset_on_save_pass_auto_disables():
    text = """\
//!HOOK MAIN
//!BIND HOOKED
//!SAVE SOMETEX
//!OFFSET -0.5 -0.5
vec4 hook() {
    return HOOKED_tex(HOOKED_pos);
}

//!HOOK MAIN
//!BIND SOMETEX
vec4 hook() {
    return SOMETEX_tex(HOOKED_pos);
}
"""
    img = _img(8, 12, seed=13)
    out_j, out_t, dj, dt = run_both(text, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


@pytest.mark.parametrize("body", [
    "return HOOKED_texOff(HOOKED_pos);",
    "vec4 c = HOOKED_texOff(0); return c.xyzk;",
    "vec4 c = HOOKED_texOff(0); for (int i = 0; i < int(c.x); i++) "
    "{ c = c * 0.5; } return c;",
    "vec4 c = HOOKED_texOff(0); c = c + undefined_name; return c;",
    "vec4 c = HOOKED_texOff(0); return vec4(c.x, c.y);",
    "vec4 c = HOOKED_texOff(0); for (int i = 0; i < 3; i++) "
    "{ return c; } return c;",
    "vec4 c = HOOKED_texOff(0); float v[2] = float[](1.0, 2.0); "
    "return vec4(v[int(c.x * 2.0)]);",
    "return;",
    "vec4 c = HOOKED_texOff(0);",
    "return texture(NOPE, HOOKED_pos);",
    "vec4 c = HOOKED_texOff(0); return vec4(c[4]);",
])
def test_rejected_bodies_auto_disable_in_both(body):
    """Unsupported constructs raise inside the interpreter and the hook
    engine auto-disables the hook, in both packages alike."""
    text = "//!HOOK MAIN\n//!BIND HOOKED\nvec4 hook() {\n    " + body + \
        "\n}\n"
    img = _img(4, 6, seed=15)
    out_j, out_t, dj, dt = run_both(text, ["RGB"], img)
    assert dj and dt, body
    np.testing.assert_array_equal(out_t, img)


# -- provenance: the same kind of value at every expression ---------------

# shader -> (stages, input channels, h, w, run_hooks context)
_RUNS = {
    "SAVE_LOAD": (["NATIVE", "RGB"], 3, 8, 12, dict(dst_w=24, dst_h=16)),
    "DISCO": (["RGB"], 3, 6, 9, {}),
    "PARAM": (["RGB"], 3, 8, 12, {}),
    "UNSHARP_REAL": (["RGB"], 3, 10, 14, {}),
    "FSRCNN_STYLE": (["RGB"], 3, 6, 12, {}),
    "IF": (["RGB"], 3, 5, 7, {}),
    "EARLY_RETURN": (["RGB"], 3, 5, 7, {}),
    "BOTH_RETURN": (["RGB"], 3, 4, 6, {}),
    "NESTED_RETURN": (["RGB"], 3, 5, 6, {}),
    "LOOP_RETURN": (["RGB"], 3, 5, 7, {}),
    "STATIC_IF": (["RGB"], 3, 4, 6, {}),
    "FSRCNNX_LIKE": (["LUMA_INPUT"], 1, 16, 24, dict(dst_w=48, dst_h=32)),
    "RAVU_LITE": (["LUMA_INPUT"], 1, 12, 20, dict(dst_w=40, dst_h=24)),
    "BUFFER_UNIFORM": (["RGB"], 3, 8, 12, {}),
    "STORAGE_AVG": (["RGB"], 3, 6, 10, {}),
    "COMPUTE_IDENTITY": (["RGB"], 3, 9, 13, {}),
    "COMPUTE_IDS": (["RGB"], 3, 7, 19, {}),
    "COMPUTE_SHARED_BLUR": (["RGB"], 3, 24, 37, {}),
    "COMPUTE_GUARD": (["RGB"], 3, 6, 8, {}),
    "FOUR_ARG_COMPUTE": (["RGB"], 3, 16, 24, {}),
    "ATOMIC_GUARDED": (["RGB"], 3, 6, 10, {}),
    "ATOMIC_TRACED_IF": (["RGB"], 3, 6, 10, {}),
    "ATOMIC_IF_ELSE_BOTH": (["RGB"], 3, 6, 10, {}),
    "ATOMIC_TWO_SIBLING_IFS": (["RGB"], 3, 6, 10, {}),
    "STORAGE_PLAIN_COND_ASSIGN": (["RGB"], 3, 6, 10, {}),
    "STORAGE_ATOMIC_THEN_PLAIN_ELSE": (["RGB"], 3, 6, 10, {}),
    "TEMPORAL_EMA": (["RGB"], 3, 32, 48, {}),
    "ATOMIC_POSITION": (["RGB"], 3, 6, 10, {}),
}


def _kind(x, traced):
    if isinstance(x, traced):
        return "device"
    if isinstance(x, np.ndarray):
        return f"host array {x.dtype}"
    if isinstance(x, np.generic):
        return f"numpy {x.dtype}"
    return f"python {type(x).__name__}"


def _record_kinds(mod, traced, log):
    """Patch mod._BodyRunner._expr to log the kind of every component of
    every expression value, in evaluation order; returns the undo."""
    real = mod._BodyRunner._expr

    def expr(self):
        v = real(self)
        comps = getattr(v, "comps", None)
        log.append("position" if comps is None else
                   tuple(_kind(c, traced) for c in comps))
        return v
    mod._BodyRunner._expr = expr
    return lambda: setattr(mod._BodyRunner, "_expr", real)


@pytest.mark.parametrize("name", list(_RUNS))
def test_provenance_matches_value_for_value(name):
    """Every expression the interpreter evaluates yields the same kind of
    value in both packages, component by component: a device array (a
    jax array, a torch tensor) where the JAX package has one, a host
    array of the same dtype, a numpy scalar or a Python number where it
    has those — so the same branches run and the same shaders are
    rejected."""
    import jax
    stages, c, h, w, ctx = _RUNS[name]
    img = _img(h, w, seed=40, c=c)
    logs = {}
    for key, mod, traced, hooks_mod, to_dev in (
            ("jax", jm, jax.Array, jhooks, jnp.asarray),
            ("torch", tm, torch.Tensor, thooks, torch.from_numpy)):
        logs[key] = []
        undo = _record_kinds(mod, traced, logs[key])
        try:
            hook = mod.user_shader_hook(ALL_SHADERS[name])
            x, dis = to_dev(img.copy()), set()
            for st in stages:
                x = hooks_mod.run_hooks([hook], hooks_mod.HookStage[st], x,
                                        dis, **ctx)
        finally:
            undo()
        assert not dis, (key, name)
    assert len(logs["torch"]) == len(logs["jax"]) > 0
    for i, (kt, kj) in enumerate(zip(logs["torch"], logs["jax"])):
        assert kt == kj, (i, kt, kj)

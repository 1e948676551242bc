"""PyTorch port: mpv .hook compute passes, STORAGE buffers, atomicAdd and
STORAGE textures (render/mpv_hooks.py) against the JAX package on the
CPU, at the run_hooks level, under the names of tests/test_mpv_hooks.py.

Tolerances (see test_torch_mpv_hooks_fragment.py): outputs within
ATOL = 2e-6; values that are sums over the frame (atomicAdd totals
written to the output) within ATOMIC_RTOL = 1e-6 relative, since
torch's summation order differs from XLA's.  Every case asserts that
both packages accept or both auto-disable the shader.
"""
import numpy as np
import pytest
import torch

import test_mpv_hooks as JT
from test_torch_mpv_hooks_fragment import (ATOMIC_POSITION, ATOMIC_RTOL,
                                           _img, assert_close, run_both)

from libplacebo_tpu_torch.render import hooks as thooks
from libplacebo_tpu_torch.render import mpv_hooks as tm


def _assert_sums(out_j, out_t):
    np.testing.assert_allclose(out_t, out_j, rtol=ATOMIC_RTOL, atol=0)


def test_compute_identity_store():
    img = _img(9, 13, seed=3)
    out_j, out_t, dj, _ = run_both(JT.COMPUTE_IDENTITY_HOOK, ["RGB"], img)
    assert not dj
    assert_close(out_j, out_t)
    np.testing.assert_allclose(out_t, 2 * img, atol=1e-6)


def test_compute_invocation_ids():
    out_j, out_t, dj, _ = run_both(JT.COMPUTE_IDS_HOOK, ["RGB"],
                                   _img(7, 19, seed=1))
    assert not dj
    np.testing.assert_array_equal(out_t, out_j)


def test_compute_shared_fill_replay():
    out_j, out_t, dj, _ = run_both(JT.COMPUTE_SHARED_BLUR_HOOK, ["RGB"],
                                   _img(24, 37, seed=5))
    assert not dj
    assert_close(out_j, out_t)


def test_compute_oob_guard_bare_return():
    out_j, out_t, dj, _ = run_both(JT.COMPUTE_GUARD_HOOK, ["RGB"],
                                   _img(6, 8, seed=9))
    assert not dj
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(out_t[:, :, 4:], 0.0)


def test_compute_threads_neq_block():
    img = _img(16, 24, seed=2)
    out_j, out_t, dj, _ = run_both(JT.FOUR_ARG_COMPUTE, ["RGB"], img)
    assert not dj
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_allclose(out_t, img * 0.5, atol=1e-7)


def test_compute_scatter_stores():
    """Stores at host coordinates other than the invocation's own pixel
    (a flip, a half-size target, an out-of-range column and a host
    guard): the port's index_put scatter against the JAX package's."""
    text = """\
//!HOOK MAIN
//!BIND HOOKED
//!COMPUTE 8 8
void hook()
{
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = HOOKED_texOff(0);
    if (p.y >= 5) return;
    imageStore(out_image, ivec2(11 - p.x, p.y), c);
    imageStore(out_image, ivec2(p.x + 3, p.y + 2), c * 0.5);
}
"""
    out_j, out_t, dj, _ = run_both(text, ["RGB"], _img(7, 12, seed=16))
    assert not dj
    assert_close(out_j, out_t)


def test_atomic_add_respects_compute_dead_mask():
    out_j, out_t, dj, _ = run_both(JT.ATOMIC_GUARDED_COMPUTE, ["RGB"],
                                   _img(6, 10, seed=3))
    assert not dj
    _assert_sums(out_j, out_t)
    np.testing.assert_allclose(out_t[0], 30.0, rtol=1e-6)


def test_atomic_add_respects_traced_if_mask():
    img = _img(6, 10, seed=4)
    out_j, out_t, dj, _ = run_both(JT.ATOMIC_TRACED_IF, ["RGB"], img)
    assert not dj
    _assert_sums(out_j, out_t)
    np.testing.assert_allclose(out_t[0], float(np.sum(img[0] > 0.5)))


def test_atomic_add_traced_if_else_composes():
    out_j, out_t, dj, _ = run_both(JT.ATOMIC_IF_ELSE_BOTH, ["RGB"],
                                   _img(6, 10, seed=5))
    assert not dj
    _assert_sums(out_j, out_t)


def test_atomic_add_of_a_host_value():
    """atomicAdd of a position-derived value sums on the device (as the
    JAX package's jnp.sum does), and the next pass's condition on the
    total is per-pixel predication in both: the sum of u over a 10-wide
    frame of 6 rows is 30, so the second pass halves the image."""
    img = _img(6, 10, seed=13)
    out_j, out_t, dj, _ = run_both(ATOMIC_POSITION, ["RGB"], img)
    assert not dj
    _assert_sums(out_j, out_t)
    np.testing.assert_allclose(out_t, img * 0.5, rtol=1e-6)


def test_atomic_add_survives_branch_return():
    shader = JT.ATOMIC_TRACED_IF.replace(
        """    if (c.x > 0.5) {
        atomicAdd(total, 1.0);
    }""",
        """    if (c.x > 0.5) {
        atomicAdd(total, 1.0);
        return c;
    }""")
    out_j, out_t, dj, _ = run_both(shader, ["RGB"], _img(6, 10, seed=6))
    assert not dj
    _assert_sums(out_j, out_t)


@pytest.mark.parametrize("thresh,expect", [("1.0", 1.0), ("1e9", 0.0)])
def test_storage_plain_assign_keeps_condition(thresh, expect):
    out_j, out_t, dj, _ = run_both(JT.STORAGE_PLAIN_COND_ASSIGN % thresh,
                                   ["RGB"], _img(6, 10, seed=8))
    assert not dj
    _assert_sums(out_j, out_t)
    np.testing.assert_allclose(out_t[0], expect, rtol=1e-6)


def test_storage_plain_assign_per_pixel_cond_rejected():
    shader = """\
//!BUFFER stats
//!STORAGE
//!VAR float flag

//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    if (c.x > 0.5) {
        flag = 5.0;
    }
    return c;
}
"""
    img = _img(6, 10, seed=9)
    out_j, out_t, dj, dt = run_both(shader, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_atomic_add_two_sibling_ifs_same_member():
    out_j, out_t, dj, _ = run_both(JT.ATOMIC_TWO_SIBLING_IFS, ["RGB"],
                                   _img(6, 10, seed=10))
    assert not dj
    _assert_sums(out_j, out_t)


@pytest.mark.parametrize("thresh,expect_count", [("1.0", 60.0),
                                                 ("1e9", 5.0)])
def test_atomic_then_plain_else_keeps_condition(thresh, expect_count):
    out_j, out_t, dj, _ = run_both(
        JT.STORAGE_ATOMIC_THEN_PLAIN_ELSE % thresh, ["RGB"],
        _img(6, 10, seed=11))
    assert not dj
    _assert_sums(out_j, out_t)
    np.testing.assert_allclose(out_t[0], expect_count, rtol=1e-6)


def test_atomic_then_plain_else_per_pixel_rejected():
    shader = """\
//!BUFFER stats
//!STORAGE
//!VAR float count

//!HOOK MAIN
//!BIND HOOKED
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    if (c.x > 0.5) {
        atomicAdd(count, 1.0);
    } else {
        count = 5.0;
    }
    return c;
}
"""
    img = _img(6, 10, seed=12)
    out_j, out_t, dj, dt = run_both(shader, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


def test_compute_conditional_value_return_rejected():
    bad = JT.COMPUTE_IDENTITY_HOOK.replace(
        "vec4 c = HOOKED_texOff(0);",
        "vec4 c = HOOKED_texOff(0);\n"
        "    if (c.x > 0.5) return c;")
    img = _img(6, 8, seed=7)
    out_j, out_t, dj, dt = run_both(bad, ["RGB"], img)
    assert dj and dt
    np.testing.assert_array_equal(out_t, img)


@pytest.mark.parametrize("body", [
    # a data-dependent imageStore position
    "vec4 c = HOOKED_texOff(0); "
    "imageStore(out_image, ivec2(c.xy * 4.0), c);",
    # no imageStore at all
    "vec4 c = HOOKED_texOff(0);",
    # a store to an image that is neither out_image nor STORAGE
    "imageStore(HOOKED, ivec2(gl_GlobalInvocationID.xy), vec4(1.0));",
    # a conditional store at other than the invocation's pixel
    "vec4 c = HOOKED_texOff(0); if (c.x > 0.5) "
    "imageStore(out_image, ivec2(0, 0), c);",
    # a loop bound that varies per invocation with no shared array
    "for (uint i = gl_LocalInvocationIndex; i < 4u; i += 64u) { } "
    "imageStore(out_image, ivec2(gl_GlobalInvocationID.xy), vec4(1.0));",
])
def test_compute_rejections_auto_disable_in_both(body):
    text = ("//!HOOK MAIN\n//!BIND HOOKED\n//!COMPUTE 8 8\nvoid hook() {\n"
            + body + "\n}\n")
    img = _img(6, 8, seed=17)
    out_j, out_t, dj, dt = run_both(text, ["RGB"], img)
    assert dj and dt, body
    np.testing.assert_array_equal(out_t, img)


def test_storage_texture_readback_in_second_pass():
    sh = """\
//!TEXTURE SCRATCH
//!SIZE 12 8
//!FORMAT rgba32f
//!STORAGE

//!HOOK MAIN
//!BIND HOOKED
//!BIND SCRATCH
//!COMPUTE 8 8
void hook()
{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = HOOKED_texOff(0);
    imageStore(SCRATCH, pos, c * 0.5);
    imageStore(out_image, pos, c);
}

//!HOOK MAIN
//!BIND HOOKED
//!BIND SCRATCH
//!COMPUTE 8 8
void hook()
{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageStore(out_image, pos, imageLoad(SCRATCH, pos) * 2.0);
}
"""
    img = _img(8, 12, seed=21)
    out_j, out_t, dj, _ = run_both(sh, ["RGB"], img)
    assert not dj
    assert_close(out_j, out_t)
    np.testing.assert_allclose(out_t, img, atol=1e-6)


def test_storage_texture_stateless_harness_resets():
    text = JT.TEMPORAL_EMA_SHADER.replace("48 32", "12 8")
    img = _img(8, 12, seed=22)
    one_j, one_t, _, _ = run_both(text, ["RGB"], img)
    two_j, two_t, _, _ = run_both(text, ["RGB"], img, frames=2)
    np.testing.assert_array_equal(two_t, one_t)
    np.testing.assert_array_equal(one_t, one_j)


def test_storage_state_carried_through_run_hooks():
    """The cross-frame channel at the run_hooks level: the port's hook
    writes its STORAGE texture and buffer to state_out as tensors of the
    spec's shapes, and reading them back as the next frame's state_in
    advances the EMA as the JAX package's does."""
    import jax.numpy as jnp
    from libplacebo_tpu.render import hooks as jhooks
    from libplacebo_tpu.render import mpv_hooks as jm
    text = JT.TEMPORAL_EMA_SHADER.replace("48 32", "12 8")
    hj, ht = jm.user_shader_hook(text), tm.user_shader_hook(text)
    sj = {k: jnp.asarray(v) for k, v in hj.state_spec.items()}
    st = {k: torch.from_numpy(v.copy()) for k, v in ht.state_spec.items()}
    for i in range(3):
        img = _img(8, 12, seed=30 + i)
        nj, nt = {}, {}
        oj = jhooks.run_hooks([hj], jhooks.HookStage.RGB, jnp.asarray(img),
                              set(), states={hj.signature: (sj, nj)})
        ot = thooks.run_hooks([ht], thooks.HookStage.RGB,
                              torch.from_numpy(img), set(),
                              states={ht.signature: (st, nt)})
        assert sorted(nt) == sorted(nj) == ["buf:frames", "tex:ACC"]
        for k in nj:
            assert tuple(nt[k].shape) == tuple(nj[k].shape)
            assert nt[k].dtype == torch.float32
            assert_close(np.asarray(nj[k]), nt[k].numpy())
        assert_close(np.asarray(oj), ot.numpy())
        sj, st = nj, nt
    assert float(st["buf:frames"][0]) == 3.0

"""PyTorch port vs the JAX package: H.274 film grain, on the CPU at small
sizes.

The same inputs, made from a seed, go through the JAX function (jitted,
as the renderer runs it) and its port.  Every comparison is exact
(measured: 0 differing values, so 0 blocks select another intensity
interval, on random 8-bit planes with flat blocks placed on the
interval bounds):
- the grain database and the aligned tile stack;
- the PCG3D hash over every block of a 1080p frame's grid (135 x 240
  blocks), for several seeds;
- `apply_h274_grain` on luma alone, on all three components (YCbCr,
  chroma scales halved) and on RGB, at sizes that are and are not
  multiples of 8;
- the renderer with H.274 grain, a new seed each frame, through one
  plan (the reference replans every seed);
- the carried grain description (`carry.film_grain_from_fields`).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core.film_grain import FilmGrainData as JGrain
from libplacebo_tpu.core.film_grain import H274GrainData as JH274
from libplacebo_tpu.ops import film_grain_h274 as jh
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.ops import film_grain_h274 as th

# luma and chroma models, as a broadcast SEI carries them: two luma
# intensity intervals, one a chroma component
MODELS = dict(
    model_id=0, blending_mode_id=0, log2_scale_factor=2,
    component_model_present=(True, True, True),
    num_intensity_intervals=(2, 1, 1), num_model_values=(3, 2, 3),
    intensity_interval_lower_bound=((0, 128), (0,), (0,)),
    intensity_interval_upper_bound=((127, 255), (255,), (200,)),
    comp_model_value=(((100, 8, 8), (60, 10, 6)), ((80, 5),),
                      ((70, 4, 12),)))
LUMA_ONLY = dict(MODELS, component_model_present=(True, False, False))


def grain_pair(models, seed):
    """The same grain description in both packages."""
    return (JGrain(type="h274", seed=seed, h274=JH274(**models)),
            lt.FilmGrainData(type="h274", seed=seed,
                             h274=lt.H274GrainData(**models)))


def _plane(shape, seed):
    """8-bit values with flat blocks on the luma intervals' bounds (block
    averages of exactly 127/255 and 128/255)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, shape) / 255.0).astype(np.float32)
    x[..., :8, :8] = np.float32(127 / 255)
    x[..., 8:16, :8] = np.float32(128 / 255)
    return x


def test_grain_db_and_tile_stack_exact():
    np.testing.assert_array_equal(th.generate_grain_db(),
                                  jh.generate_grain_db())
    np.testing.assert_array_equal(th._aligned_tile_stack(),
                                  jh._aligned_tile_stack())


@pytest.mark.parametrize("seed", [0, 1234, 0xFFFFFFFF, 2 ** 31 + 17])
def test_pcg3d_exact_over_a_1080p_grid(seed):
    """The host hash in numpy uint32 against the reference's jnp uint32
    hash, over every block of a 1080p luma plane."""
    nby, nbx = 135, 240
    wx = np.broadcast_to(np.arange(nbx, dtype=np.uint32)[None, :] // 2,
                         (nby, nbx))
    wy = np.broadcast_to(np.arange(nby, dtype=np.uint32)[:, None] // 2,
                         (nby, nbx))
    ref = jax.jit(jh._pcg3d, static_argnums=0)(seed, jnp.asarray(wx),
                                               jnp.asarray(wy))
    out = th._pcg3d(seed, wx, wy)
    for a, b in zip(out, ref):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case", [
    ("luma", (1, 64, 96), (0,), True),
    ("ycbcr", (3, 60, 100), (0, 1, 2), True),
    ("rgb", (3, 60, 100), (0, 1, 2), False),
    ("chroma_plane", (1, 30, 50), (2,), True)])
def test_apply_matches_jax(case):
    """apply_h274_grain on luma only, all components (YCbCr and RGB) and
    a lone chroma plane: exact."""
    name, shape, chans, ycc = case
    jd, td = grain_pair(LUMA_ONLY if name == "luma" else MODELS, 1234)
    x = _plane(shape, 7)
    ref = np.asarray(jax.jit(lambda a: jh.apply_h274_grain(
        a, jd, chans, is_ycbcr=ycc))(jnp.asarray(x)))
    out = th.apply_h274_grain(torch.from_numpy(x), td, chans,
                              is_ycbcr=ycc).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, np.clip(x, 0, 1))


def test_carried_grain_is_the_same():
    jd, td = grain_pair(MODELS, 99)
    assert carry.film_grain_from_fields(dataclasses.asdict(jd)) == td
    assert th.needs_fg_h274(td) and not th.needs_fg_h274(
        lt.FilmGrainData(type="h274", seed=1,
                         h274=lt.H274GrainData()))


def test_renderer_new_seed_each_frame():
    """Frames carrying H.274 grain with a new seed each, through one
    port Renderer (one plan) and the reference's (plain tail): no value
    more than 1 LSB apart, fewer than 1e-3 differing (measured 0 on both
    frames); the seed changes the frame."""
    h, w = 32, 64
    rng = np.random.default_rng(4)
    jt = JTarget(w=2 * w, h=2 * h, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * w, h=2 * h, color=lt.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
    u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    outs = []
    for seed in (11, 12):
        jd, td = grain_pair(MODELS, seed)
        jf = j_frame(y, u, v, color=jcs.ColorSpace(
            jcs.ColorPrimaries.BT_709, jcs.ColorTransfer.BT_1886))
        jf.film_grain = jd
        tf_ = lt.frame_from_yuv420p(y, u, v, device="cpu",
                                    color=lt.ColorSpace(
                                        lt.ColorPrimaries.BT_709,
                                        lt.ColorTransfer.BT_1886))
        tf_.film_grain = td
        ref = np.asarray(jr._render_once(jf, jt, JParams()))
        out = tr.render(tf_, tt, lt.RenderParams()).numpy()
        d = np.abs(out.astype(np.float64) - ref)
        assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-6).mean() < 1e-3
        outs.append(out)
    assert len(tr._cache) == 1
    assert not np.array_equal(outs[0], outs[1])

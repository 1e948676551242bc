"""PyTorch port vs the JAX package: affine distortion, and the renderer's
distortion phase (config 2's frame rotated, bicubic), on the CPU at small
sizes.

The same inputs, made from a seed, go through the JAX function (jitted,
as the renderer runs it: its inverse map and bicubic weights are
constants that XLA folds) and its port.  Tolerances, with the measured
figure beside each (CPU, this file's inputs):
- `distort_image`, bilinear and bicubic x clamp / repeat / mirror x no
  alpha / independent / premultiplied alpha, each with a plain,
  `unscaled` or `constrain` geometry: exact;
- a singular transform raises RenderError, alone and in the renderer;
- the distortion phase, one frame 64x128 -> 128x256 (the tail plain, as
  in the reference, counted as ineligible for K1) against the
  reference's renderer: no value more than 1 LSB apart, fewer than 1e-3
  differing (measured 0).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.ops import distort as jdist
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.ops import distort as tdist
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128
_GEOMETRY = ({}, dict(unscaled=True), dict(constrain=True))


@pytest.mark.parametrize("alpha", [None, "independent", "premultiplied"])
@pytest.mark.parametrize("mode", ["clamp", "repeat", "mirror"])
@pytest.mark.parametrize("bicubic", [False, True])
def test_distort_matches_jax(bicubic, mode, alpha):
    """Every filter x address mode x alpha mode, the geometry (plain,
    unscaled, constrain) cycling with the alpha mode: exact."""
    geometry = _GEOMETRY[[None, "independent", "premultiplied"].index(alpha)]
    kw = dict(transform=((0.9, -0.3), (0.35, 1.1)), offset=(0.1, -0.05),
              bicubic=bicubic, address_mode=mode, alpha_mode=alpha,
              **geometry)
    x = np.random.default_rng(0).random((3, 24, 40)).astype(np.float32)
    jp, tp = jdist.DistortParams(**kw), tdist.DistortParams(**kw)
    ref = np.asarray(jax.jit(lambda a: jdist.distort_image(a, 56, 32, jp))(
        jnp.asarray(x)))
    out = tdist.distort_image(torch.from_numpy(x), 56, 32, tp).numpy()
    assert out.shape == ref.shape == (4 if alpha else 3, 32, 56)
    np.testing.assert_array_equal(out, ref)


def test_rotation_matches_jax():
    assert tdist.DistortParams.rotation(0.2).key() == \
        jdist.DistortParams.rotation(0.2).key()


def test_singular_transform_raises():
    singular = lt.DistortParams(transform=((1.0, 0.0), (2.0, 0.0)))
    with pytest.raises(lt.RenderError, match="singular"):
        tdist.distort_image(torch.zeros(3, 8, 8), 8, 8, singular)
    frame, target, _ = _phase(lt, "cpu")
    with pytest.raises(lt.RenderError, match="singular"):
        lt.Renderer(device="cpu").render(frame, target,
                                         lt.RenderParams(distort=singular))


def _phase(mod, device=None, seed=3):
    """The distortion phase's frame (config 2's: 8-bit limited BT.709
    BT.1886 yuv420p), target and distortion (a 0.2 rad rotation,
    bicubic)."""
    rng = np.random.default_rng(seed)
    y = (rng.random((SRC_H, SRC_W)) * 219 + 16).astype(np.uint8)
    u = (rng.random((SRC_H // 2, SRC_W // 2)) * 224 + 16).astype(np.uint8)
    v = (rng.random((SRC_H // 2, SRC_W // 2)) * 224 + 16).astype(np.uint8)
    color = mod.ColorSpace(mod.ColorPrimaries.BT_709,
                           mod.ColorTransfer.BT_1886)
    rep = mod.ColorRepr(sys=mod.ColorSystem.BT_709,
                        levels=mod.ColorLevels.LIMITED,
                        bits=mod.BitEncoding(8, 8, 0))
    if mod is jcs:
        frame = j_frame(y, u, v, color=color, repr=rep)
        target = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB,
                         bit_depth=8)
        rot = jdist.DistortParams.rotation(0.2)
        return frame, target, jdist.DistortParams(transform=rot.transform,
                                                  bicubic=True)
    frame = lt.frame_from_yuv420p(y, u, v, color=color, repr=rep,
                                  device=device)
    target = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB,
                       bit_depth=8)
    rot = lt.DistortParams.rotation(0.2)
    return frame, target, lt.DistortParams(transform=rot.transform,
                                           bicubic=True)


def test_distortion_phase_matches_jax():
    """Config 2's frame rotated by 0.2 rad (bicubic) through the renderer
    against the reference's: no value more than 1 LSB apart, fewer than
    1e-3 differing; the tail is plain and counted as ineligible."""
    jf, jt, jd = _phase(jcs)
    tf_, tt, td = _phase(lt, "cpu")
    ref = np.asarray(JRenderer()._render_once(jf, jt, JParams(distort=jd)))
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    out = lt.Renderer(device="cpu").render(
        tf_, tt, lt.RenderParams(distort=td)).numpy()
    assert (trender.k1_tails, trender.plain_tails,
            trender.ineligible_tails) == (0, 0, 1)
    assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
    d = np.abs(out.astype(np.float64) - ref)
    assert d.max() <= LSB + 1e-6 and (d > 1e-6).mean() < 1e-3, \
        (d.max() / LSB, (d > 1e-6).mean())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_distortion_phase_on_card_matches_cpu(cuda_device):
    """The distortion phase on the card against the CPU render: mean <
    1e-4, more than 1 LSB on <= 5e-4 of values; the tail ineligible."""
    fg, tt, td = _phase(lt, cuda_device)
    fc, _, _ = _phase(lt, "cpu")
    p = lt.RenderParams(distort=td)
    trender.ineligible_tails = trender.plain_tails = 0
    g = lt.Renderer(device=cuda_device).render(fg, tt, p).cpu().numpy()
    c = lt.Renderer(device="cpu").render(fc, tt, p).numpy()
    d = np.abs(g.astype(np.float64) - c)
    assert d.mean() < 1e-4 and (d > LSB + 1e-6).mean() <= 5e-4
    assert trender.ineligible_tails == 2 and trender.plain_tails == 0

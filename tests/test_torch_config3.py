"""PyTorch port vs the JAX package end to end: BASELINE config 3, the
scaling slice ("polar EWA-Jinc upscale with anti-ringing + sigmoidal
gamma-correct scaling"), on the CPU at a small size.

Source: config 2's frame, 8-bit limited BT.709 yuv420p BT.1886, 64x128
-> 128x256 8-bit sRGB with `RenderParams(upscaler="ewa_lanczos4sharpest",
antiringing_strength=0.8)`: the bilinear chroma merge (anti-ringing
asked for but off, bilinear has no negative lobes), decode, BT.1886
linearize, sigmoidize, EWA on the phased path with anti-ringing,
desigmoidize, and K1's pass-through tail with the blue-noise dither
(its plain version here).  The JAX side runs its fused tail
(LPTPU_FUSED_COLORMAP=1), as tests/test_torch_config4.py does.

Gate (config 2's, tests/test_torch_config4.py): over 3 chained frames,
mean |diff| < 1e-4, more than 1 LSB on <= 5e-4 of the 8-bit values,
PSNR >= 45 dB.  Measured on seeds 3-5: no value more than 1 LSB apart,
1 LSB apart on 0 or 1.0e-5 of the values, PSNR >= 98.1 dB (200 dB where
equal) — `PYTHONPATH=. python tests/test_torch_config3.py` prints the
figures.  The `cuda`-marked test renders on the card and holds it
against the CPU render.
"""
import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128
CONFIG3 = dict(upscaler="ewa_lanczos4sharpest", antiringing_strength=0.8)


def yuv_frames(n, seed=3, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
        u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        out.append((y, u, v))
    return out


def _source(mod):
    return (mod.ColorSpace(mod.ColorPrimaries.BT_709,
                           mod.ColorTransfer.BT_1886),
            mod.ColorRepr(sys=mod.ColorSystem.BT_709,
                          levels=mod.ColorLevels.LIMITED,
                          bits=mod.BitEncoding(8, 8, 0)))


def port_frame(yuv, device="cpu"):
    color, repr = _source(lt)
    return lt.frame_from_yuv420p(*yuv, color=color, repr=repr, device=device)


def _target(mod):
    return mod.Target(w=2 * SRC_W, h=2 * SRC_H, color=mod.CSP_SRGB,
                      bit_depth=8)


def render_pair(n=3, seed=3):
    """The JAX renders and the port's CPU renders of n chained frames,
    with the port's (K1, plain) tail counts."""
    color, repr = _source(jcs)
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    jp, tp = JParams(**CONFIG3), lt.RenderParams(**CONFIG3)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = 0
    res = []
    for yuv in yuv_frames(n, seed):
        ref = np.asarray(jr._render_once(j_frame(*yuv, color=color,
                                                 repr=repr), jt, jp))
        res.append((tr.render(port_frame(yuv), _target(lt), tp).numpy(),
                    ref))
    return res, (trender.k1_tails, trender.plain_tails)


def _gate(out, ref):
    d = np.abs(out.astype(np.float64) - ref)
    psnr = 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))
    return d.mean(), (d > LSB + 1e-6).mean(), psnr, d.max()


def test_config3_render_three_frames(monkeypatch):
    """Three chained frames against the reference's renderer: mean
    |diff| < 1e-4, > 1 LSB on <= 5e-4 of values, PSNR >= 45 dB; every
    tail on K1 (its plain version here)."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    res, tails = render_pair()
    for out, ref in res:
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        mean, above, psnr, _ = _gate(out, ref)
        assert mean < 1e-4 and above <= 5e-4 and psnr >= 45.0, \
            (mean, above, psnr)
    assert tails == (3, 0)


def test_config3_scaler_is_the_phased_antiringing_path():
    """The renderer hands the main scaler the parameters' strength
    (`antiringing_strength or cfg.antiring`), and the EWA takes the
    phased path with it."""
    from libplacebo_tpu_torch.ops import polar
    calls = []
    real = polar.sample_polar

    def spy(img, cfg, dst_h, dst_w, rect=None, antiring=0.0):
        calls.append((cfg.name, antiring, polar._route(
            polar.plan_polar(cfg, img.shape[-2], img.shape[-1], dst_h,
                             dst_w, rect), dst_h, dst_w, antiring)))
        return real(img, cfg, dst_h, dst_w, rect, antiring)

    polar.sample_polar = spy
    try:
        for strength, want in ((0.8, 0.8), (0.0, 0.8), (0.3, 0.3)):
            calls.clear()
            params = lt.RenderParams(upscaler="ewa_lanczos4sharpest",
                                     antiringing_strength=strength)
            lt.Renderer(device="cpu").render(port_frame(yuv_frames(1)[0]),
                                             _target(lt), params)
            assert calls == [("ewa_lanczos4sharpest", want, "phased")]
    finally:
        polar.sample_polar = real


def test_config3_chroma_merge_antiring_is_off():
    """The chroma merge gets anti-ringing 0.8 too; bilinear has no
    negative lobes, so sample_ortho turns it off by the reference's rule:
    the merged planes equal the JAX package's and those without it."""
    import jax
    y, u, v = yuv_frames(1, seed=8)[0]
    color, repr = _source(jcs)
    jf = j_frame(y, u, v, color=color, repr=repr)
    mk = jf.meta_key()[0]
    jr = JRenderer()
    ref = jax.jit(lambda *p: jr._merge_planes(
        p, (mk, repr.sys), JParams(**CONFIG3))[0])(
        *[p.data for p in jf.planes])
    tr = lt.Renderer(device="cpu")
    planes = [torch.from_numpy(np.array(p.data)) for p in jf.planes]
    out = tr._merge_planes(planes, mk, lt.RenderParams(**CONFIG3))[0]
    plain = tr._merge_planes(planes, mk, lt.RenderParams(
        upscaler="ewa_lanczos4sharpest"))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(out, plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_config3_on_card_matches_cpu(cuda_device):
    """Config 3 on the card: every tail on K1 (one launch a frame, plain
    tails 0), and the frames hold the CPU render's gate."""
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    tp = lt.RenderParams(**CONFIG3)
    rg, rc = lt.Renderer(device=cuda_device), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = 0
    k1.launches = 0
    for yuv in yuv_frames(3, seed=5):
        g = rg.render(port_frame(yuv, cuda_device), _target(lt), tp)
        c = rc.render(port_frame(yuv), _target(lt), tp).numpy()
        mean, above, psnr, _ = _gate(g.cpu().numpy(), c)
        assert mean < 1e-4 and above <= 5e-4 and psnr >= 45.0
    assert (trender.k1_tails, trender.plain_tails) == (6, 0)
    assert k1.launches == 3


def _measure():
    """Print the divergence figures behind the gate."""
    import os
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    for seed in (3, 4, 5):
        res, tails = render_pair(seed=seed)
        for i, (out, ref) in enumerate(res):
            mean, above, psnr, mx = _gate(out, ref)
            d = np.abs(out - ref)
            print(f"config3 seed {seed} frame {i}: mean {mean:.2e}, "
                  f"differing {(d > 1e-6).mean():.2e}, > 1 LSB "
                  f"{above:.2e}, max {mx / LSB:.2f} LSB, PSNR {psnr:.1f} "
                  f"dB; tails {tails}")


if __name__ == "__main__":
    _measure()

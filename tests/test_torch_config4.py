"""PyTorch port vs the JAX package end to end: BASELINE config 4 (HDR10
-> SDR with BT.2390 and softclip) and SDR sources with default
parameters (config 2's color path), on the CPU at small sizes.

Config 4: 10-bit limited BT.2020-NC yuv420p PQ with mastering metadata
(0.005-1000 nits) -> 8-bit sRGB, EWA Lanczos, `bt2390` tone curve on
the detected peak (allow_delayed, so K1 measures the partials),
`softclip` gamut map with its hue shift, blue-noise dither.  Config 2's
color path: 8-bit limited BT.709 yuv420p BT.1886 -> 8-bit sRGB with
`RenderParams()` (separable Lanczos, sigmoidized linear scaling, K1's
pass-through tail: delinearize, encode, dither).  The JAX side runs its
fused tail (LPTPU_FUSED_COLORMAP=1), as tests/test_torch_render.py
does.

Gate (the flagship's, ISSUE and tests/test_torch_render.py): over 3
chained frames, mean |diff| < 1e-4, more than 1 LSB on <= 5e-4 of the
8-bit values, PSNR >= 45 dB, peak state atol 1e-5.  Measured figures
are in ROADMAP §3 (`PYTHONPATH=. python tests/test_torch_config4.py`
prints them).  The `cuda`-marked tests render both paths on the card
and hold them against the CPU render.
"""
import dataclasses

import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128


def yuv_frames(n, bits, seed=3, h=SRC_H, w=SRC_W):
    """The flagship's seeded content at 8 or 10 bits (limited range)."""
    rng = np.random.default_rng(seed)
    lo, span_y, span_c = (16, 219, 224) if bits == 8 else (64, 876, 896)
    dt = np.uint8 if bits == 8 else np.uint16
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * span_y + lo).astype(dt)
        u = (rng.random((h // 2, w // 2)) * span_c + lo).astype(dt)
        v = (rng.random((h // 2, w // 2)) * span_c + lo).astype(dt)
        out.append((y, u, v))
    return out


def _spaces(mod, case):
    """(source color, repr, bit depth) of a case, in module `mod`."""
    if case.startswith("config4"):
        color = dataclasses.replace(mod.CSP_BT2100_PQ, hdr=mod.HdrMetadata(
            min_luma=0.005, max_luma=1000.0))
        return color, mod.ColorRepr(sys=mod.ColorSystem.BT_2020_NC,
                                    levels=mod.ColorLevels.LIMITED,
                                    bits=mod.BitEncoding(10, 10, 0)), 10
    color = mod.ColorSpace(mod.ColorPrimaries.BT_709,
                           mod.ColorTransfer.BT_1886)
    return color, mod.ColorRepr(sys=mod.ColorSystem.BT_709,
                                levels=mod.ColorLevels.LIMITED,
                                bits=mod.BitEncoding(8, 8, 0)), 8


# case -> RenderParams fields; config4_same_frame and config4_static run
# K1 with same-frame detect_peak and the static metadata curve
CASES = {
    "config4": dict(upscaler="ewa_lanczos", tone_mapping_function="bt2390",
                    gamut_mapping="softclip"),
    "config2": {},
    "config4_same_frame": dict(upscaler="ewa_lanczos",
                               tone_mapping_function="bt2390",
                               gamut_mapping="softclip",
                               peak_detect="same_frame"),
    "config4_static": dict(upscaler="ewa_lanczos",
                           tone_mapping_function="bt2390",
                           gamut_mapping="softclip", peak_detect=None),
}
K1_CASES = ("config4", "config2")


def params_for(case, mod_params, peak_cls):
    kw = dict(CASES[case])
    if kw.get("peak_detect") == "same_frame":
        kw["peak_detect"] = peak_cls(allow_delayed=False)
    return mod_params(**kw)


def port_frame(case, yuv, device="cpu"):
    color, repr, bits = _spaces(tcs, case)
    return lt.frame_from_yuv420p(*yuv, color=color, repr=repr,
                                 bit_depth=bits, device=device)


def render_pair(case, n=3, seed=3):
    """The JAX renders and the port's CPU renders of n chained frames,
    with their peak states and the port's tail counts."""
    from libplacebo_tpu.ops.peak_detect import PeakDetectParams as JPeak
    color, repr, bits = _spaces(jcs, case)
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    jp = params_for(case, JParams, JPeak)
    tp = params_for(case, lt.RenderParams, lt.PeakDetectParams)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = 0
    res = []
    for yuv in yuv_frames(n, bits, seed):
        jf = j_frame(*yuv, color=color, repr=repr, bit_depth=bits)
        ref = np.asarray(jr._render_once(jf, jt, jp))
        out = tr.render(port_frame(case, yuv), tt, tp).numpy()
        res.append((out, ref, tr._peak_state.numpy().copy(),
                    np.asarray(jr._peak_state)))
    return res, (trender.k1_tails, trender.plain_tails)


def _gate(out, ref):
    d = np.abs(out.astype(np.float64) - ref)
    psnr = 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))
    return d.mean(), (d > LSB + 1e-6).mean(), psnr, d.max()


@pytest.mark.parametrize("case", list(CASES))
def test_render_three_frames(monkeypatch, case):
    """Three chained frames 64x128 -> 128x256 against the reference's
    renderer: mean |diff| < 1e-4, > 1 LSB on <= 5e-4 of values, PSNR
    >= 45 dB, peak state atol 1e-5; every tail runs on K1 (its plain
    version here), each on the instance compiled for its tail."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    res, (k1_tails, plain_tails) = render_pair(case)
    for out, ref, state, jstate in res:
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        mean, above, psnr, _ = _gate(out, ref)
        assert mean < 1e-4 and above <= 5e-4 and psnr >= 45.0, \
            (mean, above, psnr)
        np.testing.assert_allclose(state, jstate, atol=1e-5)
    # every tail runs on K1
    assert (k1_tails, plain_tails) == (3, 0)
    if case.startswith("config4") and CASES[case].get("peak_detect", 1):
        assert res[-1][2][1] > 0


def test_ten_bit_upload_normalizes_by_1023():
    """A 10-bit plane uploads raw (widened to int32 on the host) and
    normalizes by a true divide by 1023, as the reference does."""
    y, u, v = yuv_frames(1, 10, seed=9)[0]
    jf = j_frame(y, u, v, bit_depth=10)
    tf = lt.frame_from_yuv420p(y, u, v, bit_depth=10, device="cpu")
    for jp, tp in zip(jf.planes, tf.planes):
        np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(
        tf.planes[0].data.numpy()[0], (y.astype(np.float32) /
                                       np.float32(1023.0)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES)
def test_render_on_card_matches_cpu(cuda_device, case):
    """Config 4 and config 2 on the card: every tail runs on K1 (plain
    tails 0), and the frames hold the CPU render's gate."""
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    tp = params_for(case, lt.RenderParams, lt.PeakDetectParams)
    rg, rc = lt.Renderer(device=cuda_device), lt.Renderer(device="cpu")
    bits = _spaces(tcs, case)[2]
    trender.k1_tails = trender.plain_tails = 0
    k1.launches = 0
    for yuv in yuv_frames(3, bits, seed=5):
        g = rg.render(port_frame(case, yuv, cuda_device), tt, tp)
        c = rc.render(port_frame(case, yuv), tt, tp).numpy()
        mean, above, psnr, _ = _gate(g.cpu().numpy(), c)
        assert mean < 1e-4 and above <= 5e-4 and psnr >= 45.0
    assert (trender.k1_tails, trender.plain_tails) == (6, 0)
    assert k1.launches == 3
    np.testing.assert_allclose(rg._peak_state.cpu().numpy(),
                               rc._peak_state.numpy(), atol=1e-5)


def _measure():
    """Print the divergence figures behind the gate (ROADMAP §3)."""
    import os
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    for case in CASES:
        for seed in (3, 4, 5):
            res, counts = render_pair(case, seed=seed)
            for i, (out, ref, state, jstate) in enumerate(res):
                mean, above, psnr, mx = _gate(out, ref)
                print(f"{case} seed {seed} frame {i}: mean {mean:.2e}, "
                      f"> 1 LSB {above:.2e}, max {mx / LSB:.2f} LSB, PSNR "
                      f"{psnr:.1f} dB, state diff "
                      f"{np.abs(state - jstate).max():.1e}; tails {counts}")


if __name__ == "__main__":
    _measure()

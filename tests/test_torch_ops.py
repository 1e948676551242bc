"""PyTorch port vs the JAX package, module by module, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function
(jitted, as the renderer runs it) and its port.  The port rounds where
the reference's XLA lowering rounds (core/fastmath.py), so most stages
agree bit for bit; each test states its tolerance, with the measured
error beside it.  What still rounds apart: XLA's exp/log differ
from PyTorch's in the last ulp (the exact PQ curves, sRGB), a few
channel mixes contract differently (decode), and the EWA sum runs in
another order (one convolution)."""
import numpy as np
import pytest
import torch

import jax

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import filters as jflt
from libplacebo_tpu.core import transfer as jtf
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.ops import dithering as jdith
from libplacebo_tpu.ops import peak_detect as jpeak
from libplacebo_tpu.ops import polar as jpolar
from libplacebo_tpu.ops import tone_dynamic as jtone
from libplacebo_tpu.render import frame as jframe
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import color_map_stage as jcms
from libplacebo_tpu.utils import upload as jupload

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import filters as tflt
from libplacebo_tpu_torch.core import transfer as ttf
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import dithering as tdith
from libplacebo_tpu_torch.ops import peak_detect as tpeak
from libplacebo_tpu_torch.ops import polar as tpolar
from libplacebo_tpu_torch.ops import tone_dynamic as ttone
from libplacebo_tpu_torch.render import renderer as trender
from libplacebo_tpu_torch.utils import upload as tupload

H, W = 32, 64
_J_REPR = jcs.ColorRepr(sys=jcs.ColorSystem.BT_2020_NC,
                        levels=jcs.ColorLevels.LIMITED,
                        bits=jcs.BitEncoding(8, 8, 0))
_T_REPR = tcs.ColorRepr(sys=tcs.ColorSystem.BT_2020_NC,
                        levels=tcs.ColorLevels.LIMITED,
                        bits=tcs.BitEncoding(8, 8, 0))
_J_SRC, _J_DST = jcs.color_space_infer_map(jcs.CSP_BT2100_PQ, jcs.CSP_SRGB)
_T_SRC, _T_DST = tcs.color_space_infer_map(tcs.CSP_BT2100_PQ, tcs.CSP_SRGB)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _yuv(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
    u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    return y, u, v


def _linear(seed=1, scale=4.0):
    rng = np.random.default_rng(seed)
    return (rng.random((3, H, W)) * scale).astype(np.float32)


def test_frame_upload_normalize_bit_exact():
    """frame_from_yuv420p: a true divide by 255 on both sides — exact."""
    y, u, v = _yuv()
    jf = jframe.frame_from_yuv420p(y, u, v, repr=_J_REPR)
    tf = lt.frame_from_yuv420p(y, u, v, repr=_T_REPR, device="cpu")
    for jp, tp in zip(jf.planes, tf.planes):
        np.testing.assert_array_equal(np.asarray(jp.data), tp.data.numpy())
        assert (jp.shift_x, jp.component_mapping) == \
            (tp.shift_x, tp.component_mapping)


@pytest.mark.parametrize("case", ["planar8", "shift16", "packed565",
                                  "float"])
def test_upload_plane_bit_exact(case):
    """utils/upload.py device-norm path — exact."""
    rng = np.random.default_rng(2)
    if case == "planar8":
        kw = dict(data=rng.integers(0, 256, (8, 16, 3), dtype=np.uint8),
                  component_map=(0, 1, 2))
    elif case == "shift16":
        kw = dict(data=(rng.integers(0, 1024, (8, 16), dtype=np.uint16)
                        << 6).astype(np.uint16), bit_depth=10, bit_shift=6)
    elif case == "packed565":
        kw = dict(data=rng.integers(0, 1 << 16, (8, 16), dtype=np.uint16),
                  component_map=(2, 1, 0), component_size=(5, 6, 5))
    else:
        kw = dict(data=rng.random((8, 16, 2), dtype=np.float32),
                  component_map=(1, 2))
    jp = jupload.upload_plane(jupload.PlaneData(**kw))
    tp = tupload.upload_plane(tupload.PlaneData(**kw), device="cpu")
    np.testing.assert_array_equal(np.asarray(jp.data), tp.data.numpy())


def test_chroma_merge_bilinear():
    """Bilinear 2x chroma alignment with the -0.5 siting: atol 1e-5
    (the phased tap sums round like XLA's; measured exact)."""
    y, u, v = _yuv()
    jf = jframe.frame_from_yuv420p(y, u, v, repr=_J_REPR)
    mk = jf.meta_key()[0]
    jr = JRenderer()
    ref = jax.jit(lambda *p: jr._merge_planes(
        p, (mk, _J_REPR.sys), JParams(upscaler="ewa_lanczos"))[0])(
        *[p.data for p in jf.planes])
    tr = lt.Renderer(device="cpu")
    out = tr._merge_planes([_t(p.data) for p in jf.planes], mk,
                           lt.RenderParams(upscaler="ewa_lanczos"))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_and_encode():
    """Matrix decode (limited-range BT.2020-NC) and the identity RGB
    encode: atol 1e-5 (measured 4.8e-7: XLA contracts one product of
    the decode matrix where the port's rule does not)."""
    x = np.random.default_rng(3).random((3, H, W)).astype(np.float32)
    ref = jax.jit(lambda a: jcolor.decode_color(a, _J_REPR,
                                                _J_SRC.primaries))(x)
    np.testing.assert_allclose(tcolor.decode_color(_t(x), _T_REPR).numpy(),
                               np.asarray(ref), atol=1e-5)
    jt = jcs.ColorRepr(sys=jcs.ColorSystem.RGB, levels=jcs.ColorLevels.FULL)
    tt = tcs.ColorRepr(sys=tcs.ColorSystem.RGB, levels=tcs.ColorLevels.FULL)
    ref = jax.jit(lambda a: jcolor.encode_color(a, jt))(x)
    np.testing.assert_allclose(tcolor.encode_color(_t(x), tt).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_linearize_pq_and_delinearize_srgb():
    """PQ linearize (the pow-free curve): relative 1e-5 (measured
    exact); sRGB delinearize of [0, 1] light: atol 1e-5 (measured
    1.2e-7)."""
    x = np.random.default_rng(4).random((3, H, W)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jcolor.linearize(a, _J_SRC))(x))
    out = tcolor.linearize(_t(x), _T_SRC).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    ref = np.asarray(jax.jit(lambda a: jcolor.delinearize(a, _J_DST))(x))
    np.testing.assert_allclose(tcolor.delinearize(_t(x), _T_DST).numpy(),
                               ref, atol=1e-5)


@pytest.mark.parametrize("curve", ["pq_eotf", "pq_oetf"])
def test_exact_pq_curves(curve):
    """The exact PQ curves (pow_pos = exp(p log x)): rtol 1e-4 (XLA's
    exp/log differ from PyTorch's by an ulp, which the curves' exponents
    and the EOTF's cancellation near black amplify; measured 4.4e-5)."""
    x = np.random.default_rng(10).random((3, H, W)).astype(np.float32)
    ref = np.asarray(jax.jit(getattr(jtf, curve))(x))
    out = getattr(ttf, curve)(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-7)


def test_polar_direct_ewa():
    """_polar_direct 2x EWA Lanczos on PQ linear light: atol 1e-5 of the
    frame's peak (one convolution sums the taps in another order;
    measured 1.4e-7)."""
    x = _linear(5, 49.0)
    ref = np.asarray(jax.jit(lambda a: jpolar.sample_polar(
        a, jflt.find_filter_config("ewa_lanczos"), 2 * H, 2 * W,
        JRectF(0, 0, W, H)))(x))
    out = tpolar.sample_polar(_t(x), tflt.find_filter_config("ewa_lanczos"),
                              2 * H, 2 * W, TRectF(0, 0, W, H)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("avg,peak", [(0.0, 0.75), (0.3, 0.75),
                                      (0.45, 0.62)])
def test_tone_map_dynamic_spline(avg, peak):
    """Spline with detected stats: atol 1e-5 (measured exact)."""
    I = np.random.default_rng(6).random((H, W)).astype(np.float32)
    lo, hi = 0.0833, 0.5807
    ref = jax.jit(lambda a, s0, s1: jtone.tone_map_dynamic(
        a, "spline", s1, s0, lo, hi))(I, np.float32(avg), np.float32(peak))
    out = ttone.tone_map_dynamic(_t(I), "spline", torch.tensor(peak),
                                 torch.tensor(avg), lo, hi)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_color_map_ipt_perceptual(scale):
    """color_map_stage (spline + perceptual, one IPT round trip) on
    linear BT.2020 light: atol 1e-5 (measured exact)."""
    x = _linear(7, scale)
    stats = (np.float32(0.3), np.float32(0.75))
    ref = np.asarray(jax.jit(lambda a, s0, s1: jcms(
        a, _J_SRC, _J_DST, JParams(), (s0, s1)))(x, *stats))
    out = trender.color_map_stage(_t(x), _T_SRC, _T_DST, lt.RenderParams(),
                                  tuple(torch.tensor(s) for s in stats))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_dither_same_bias_exact():
    """Blue-noise dither to 8 bits with the same bias: exact."""
    x = np.random.default_rng(8).random((3, H, W)).astype(np.float32)
    jp = jdith.DitherParams(transfer=jcs.ColorTransfer.SRGB)
    tp = tdith.DitherParams(transfer=tcs.ColorTransfer.SRGB)
    bias = tdith.bias_matrix(tp, H, W)
    np.testing.assert_array_equal(bias, jdith._bias_matrix(jp, H, W))
    ref = jax.jit(lambda a, b: jdith.dither(a, 8, jp, bias=b))(x, bias)
    out = tdith.dither(_t(x), 8, tp, bias=_t(bias))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_peak_partials_and_finish():
    """block_partials + finish_from_packed: histogram exact, stripe sums
    rtol 1e-5 (summation order), state atol 1e-6."""
    x = _linear(9, 20.0)
    params_j = jpeak.PeakDetectParams()
    params_t = tpeak.PeakDetectParams()
    blocks = [x[:, i:i + 8] for i in range(0, H, 8)]
    jp = np.stack([np.asarray(jax.jit(lambda a: jpeak.block_partials(
        a, params_j))(b)) for b in blocks])
    tp = torch.stack([tpeak.block_partials(_t(b), params_t)
                      for b in blocks])
    np.testing.assert_array_equal(tp[:, 0].numpy(), jp[:, 0])
    np.testing.assert_allclose(tp[:, 1, :3].numpy(), jp[:, 1, :3],
                               rtol=1e-5)
    state = np.asarray([0.4, 0.7], np.float32)
    for st in (np.zeros(2, np.float32), state):
        _, _, js = jax.jit(lambda p, s: jpeak.finish_from_packed(
            p, s, params_j))(jp, st)
        _, _, ts = tpeak.finish_from_packed(_t(jp), _t(st), params_t)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    pct_j = jpeak.PeakDetectParams(percentile=99.5)
    pct_t = tpeak.PeakDetectParams(percentile=99.5)
    _, _, js = jax.jit(lambda p, s: jpeak.finish_from_packed(
        p, s, pct_j))(jp, state)
    _, _, ts = tpeak.finish_from_packed(_t(jp), _t(state), pct_t)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)

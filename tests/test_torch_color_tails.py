"""PyTorch port vs the JAX package: the rest of the color pipeline — the
remaining transfer curves, the non-linear decode systems, white-noise
and low-depth dither, custom LUTs, ICC profiles — and K1 on every kind
of tail, on the CPU at small sizes.

The same numpy inputs, made from a seed, go through the JAX function
(jitted, as the renderer runs it; K1's tails through fused_pointwise in
interpret mode, forced with LPTPU_FUSED_COLORMAP=1) and its port.
Tolerances, with the measured figure beside each (CPU, this file's
inputs); ROADMAP §3 records every one that is not exact:
- linearize: rtol 2e-5 (measured <= 1.6e-5, S-Log's 10**x magnifying
  XLA's exp/log against PyTorch's); scRGB and PQ exact; delinearize
  atol 2.5e-7 (measured <= 1.2e-7);
- decode/encode of BT.2020-C, XYZ and ICtCp HLG: atol 1e-5 (measured
  <= 6.1e-6); ICtCp PQ runs the exact PQ curves both ways, whose steep
  toe magnifies the exp/log ulps: decode atol 2e-4 (measured 1.5e-4 on
  0.6% of values), encode 1e-4 (measured 7.2e-5);
- white noise: the bias and the dithered frame exact;
- K1's plain version vs the reference's fused tail (or, for an HLG or
  ICtCp target, which the reference's kernel cannot trace, its plain
  stages): dithered, within 1 LSB on < 1e-3 of values, peak partials'
  histograms equal and stripe sums rtol 1e-5; the
  static st2094-10, the inverse bt2446a and the ICtCp encode, whose
  pow-based curves magnify XLA's exp/log/pow ulps, on < 1e-2 (measured
  4.9e-3, 1.3e-3, 1.1e-3);
- custom LUTs: each mode within 1e-6 of the JAX package's (measured 0
  for the exact paths, 1.8e-7 for the low-rank one), the low-rank path
  within _CP_TOL of the exact one;
- ICC encode/decode: atol 1e-5 (measured 0 and 6e-8);
- paths A and B end to end over 3 chained frames: no value more than
  1 LSB of the target's depth apart, PSNR >= 80 dB (measured 95.2-98.7
  on path A); path B >= 75 dB (measured 77.0-78.1: a divergence of
  ulps magnified by the ICC encode's toe, bisected in ROADMAP §3).
The `cuda`-marked tests hold K1's instance of each tail against its
plain version on the card (bit for bit) and the GPU renders of both
paths against the CPU renders.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import icc as jicc
from libplacebo_tpu.core import lut as jlut
from libplacebo_tpu.core.common import RectF as JRectF
from libplacebo_tpu.core.dither import DitherMethod as JDitherMethod
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.ops import dithering as jdith
from libplacebo_tpu.ops import icc as jops_icc
from libplacebo_tpu.ops import lut as jops_lut
from libplacebo_tpu.ops.peak_detect import PeakDetectParams as JPeak
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget
from libplacebo_tpu.render.renderer import color_map_stage as jcms

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import icc as ticc
from libplacebo_tpu_torch.core import lut as tlut
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import dithering as tdith
from libplacebo_tpu_torch.ops import icc as tops_icc
from libplacebo_tpu_torch.ops import lut as tops_lut
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

from test_icc_h274 import _icc_header, _icc_tags, _make_profile, _mft2_b2a

_HDR10 = dict(min_luma=0.005, max_luma=1000.0)


def _csp(mod, prim, trc, hdr=None):
    c = mod.ColorSpace(mod.ColorPrimaries(prim), mod.ColorTransfer(trc))
    return dataclasses.replace(c, hdr=mod.HdrMetadata(**hdr)) if hdr else c


def _repr(mod, sys, levels, bits=0):
    return mod.ColorRepr(sys=mod.ColorSystem(sys),
                         levels=mod.ColorLevels(levels),
                         bits=mod.BitEncoding(bits, bits, 0) if bits
                         else mod.BitEncoding())


# ---------------------------------------------------------------------------
# Transfer curves and decode systems
# ---------------------------------------------------------------------------

NEW_TRCS = ("hlg", "v-log", "s-log1", "s-log2", "scrgb", "prophoto",
            "st428")


@pytest.mark.parametrize("prim", ["bt.2020", "bt.709"])
@pytest.mark.parametrize("trc", NEW_TRCS)
def test_transfer_curve_matches_jax(trc, prim):
    """linearize (HLG with its OOTF, the camera curves without display
    scaling, scRGB keeping negatives) and delinearize vs the jitted
    reference: rtol 2e-5 and atol 2.5e-7 (scRGB exact)."""
    x = (np.random.default_rng(3).random((3, 16, 32)) * 1.1 - 0.05) \
        .astype(np.float32)
    jc, tc = _csp(jcs, prim, trc), _csp(tcs, prim, trc)
    jl = np.asarray(jax.jit(lambda v: jcolor.linearize(v, jc))(x))
    tl = tcolor.linearize(torch.from_numpy(x), tc).numpy()
    jd = np.asarray(jax.jit(lambda v: jcolor.delinearize(v, jc))(jl))
    td = tcolor.delinearize(torch.from_numpy(jl), tc).numpy()
    if trc == "scrgb":
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)
        assert (tl < 0).any()
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(td, jd, rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("levels", ["limited", "full"])
@pytest.mark.parametrize("sys", ["bt.2100-pq", "bt.2100-hlg", "bt.2020-c",
                                 "xyz"])
def test_decode_system_matches_jax(sys, levels):
    """decode_color / encode_color of the non-linear systems with their
    primaries argument vs the jitted reference: atol 1e-5 (ICtCp PQ:
    decode 2e-4, encode 1e-4, the exact PQ curves' toe)."""
    x = np.random.default_rng(3).random((3, 16, 32)).astype(np.float32)
    jr, tr = _repr(jcs, sys, levels, 10), _repr(tcs, sys, levels, 10)
    jp, tp = jcs.ColorPrimaries.BT_2020, tcs.ColorPrimaries.BT_2020
    jd = np.asarray(jax.jit(lambda v: jcolor.decode_color(v, jr, jp))(x))
    td = tcolor.decode_color(torch.from_numpy(x), tr, tp).numpy()
    je = np.asarray(jax.jit(lambda v: jcolor.encode_color(v, jr, jp))(jd))
    te = tcolor.encode_color(torch.from_numpy(jd), tr, tp).numpy()
    dec, enc = (2e-4, 1e-4) if sys == "bt.2100-pq" else (1e-5, 1e-5)
    np.testing.assert_allclose(td, jd, rtol=0, atol=dec)
    np.testing.assert_allclose(te, je, rtol=0, atol=enc)


def test_dolby_vision_still_refuses():
    """Dolby Vision's decode is ported (tests/test_torch_dovi.py); it
    still refuses a Dolby Vision repr without its RPU metadata, as the
    reference does."""
    with pytest.raises(ValueError, match="dovi metadata"):
        tcolor.decode_color(torch.zeros(3, 2, 2),
                            tcs.ColorRepr(sys=tcs.ColorSystem.DOLBYVISION))


# ---------------------------------------------------------------------------
# Dither
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame_index", [0, 5])
def test_white_noise_is_the_reference_draw(frame_index):
    """The white-noise bias is the reference's host draw bit for bit, and
    the dithered frame equals the jitted reference's."""
    jp = jdith.DitherParams(method=JDitherMethod.WHITE_NOISE)
    tp = tdith.DitherParams(method=lt.DitherMethod.WHITE_NOISE)
    bias = tdith.bias_matrix(tp, 24, 40, frame_index)
    np.testing.assert_array_equal(
        bias, jdith._bias_matrix(jp, 24, 40, frame_index))
    x = np.random.default_rng(1).random((3, 24, 40)).astype(np.float32)
    ref = jax.jit(lambda a: jdith.dither(a, 8, jp, frame_index))(x)
    out = tdith.dither(torch.from_numpy(x), 8, tp, frame_index)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth", [1, 3])
def test_low_depth_gamma_dither_matches_jax(depth):
    """<= 4-bit dither with a gamma transfer dithers between the
    linearized levels (_APPROX_GAMMA): equal but for 1 LSB on < 1e-3 of
    values (torch.pow against XLA's pow)."""
    jp = jdith.DitherParams(transfer=jcs.ColorTransfer.SRGB)
    tp = tdith.DitherParams(transfer=tcs.ColorTransfer.SRGB)
    x = np.random.default_rng(2).random((3, 32, 64)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jdith.dither(a, depth, jp))(x))
    out = tdith.dither(torch.from_numpy(x), depth, tp).numpy()
    d = np.abs(out - ref)
    assert d.max() <= 1.0 / ((1 << depth) - 1) + 1e-6
    assert (d > 0).mean() < 1e-3


# ---------------------------------------------------------------------------
# K1 against the reference's fused tail
# ---------------------------------------------------------------------------

_STATIC = ("clip", "st2094-40", "st2094-10", "bt2390", "bt2446a", "spline",
           "reinhard", "mobius", "hable", "gamma", "linear", "linearlight")
# case -> (source (prim, trc, hdr), target (prim, trc, hdr), params,
#          target bit depth, target (sys, levels))
TAILS = {}
for _tm in _STATIC:
    # the static metadata curve; clip gamut: with perceptual the fitted
    # boundary's envelope at the top of the range makes the chroma
    # ill-conditioned (ROADMAP §3)
    TAILS[f"static-{_tm}"] = (("bt.2020", "pq", _HDR10), ("bt.709", "srgb"),
                              dict(tone_mapping_function=_tm,
                                   peak_detect=None, gamut_mapping="clip"),
                              8, None)
TAILS["static-inverse-bt2446a"] = (
    ("bt.709", "bt.1886"), ("bt.2020", "pq", dict(max_luma=1000.0)),
    dict(tone_mapping_function="bt2446a", inverse_tone_mapping=True), 10,
    None)
for _g in ("relative", "desaturate", "linear", "darken", "absolute",
           "highlight"):
    TAILS[f"gamut-{_g}"] = (("bt.2020", "pq", _HDR10), ("bt.709", "srgb"),
                            dict(gamut_mapping=_g), 8, None)
TAILS["same-frame-bt2390"] = (("bt.2020", "pq", _HDR10), ("bt.709", "srgb"),
                              dict(tone_mapping_function="bt2390",
                                   gamut_mapping="softclip",
                                   peak_detect=dict(allow_delayed=False)),
                              8, None)
for _trc in ("pq", "bt.1886", "gamma2.2", "prophoto", "st428", "v-log",
             "s-log1", "s-log2", "scrgb", "linear", "hlg"):
    TAILS[f"target-{_trc}"] = (("bt.2020", "pq", _HDR10), ("bt.709", _trc),
                               {}, 10, None)
TAILS["encode-ycbcr"] = (("bt.2020", "pq", _HDR10), ("bt.709", "bt.1886"),
                         {}, 10, ("bt.709", "limited"))
TAILS["encode-ictcp"] = (("bt.2020", "pq", _HDR10), ("bt.2020", "pq"),
                         dict(tone_mapping_function="bt2446a"), 10,
                         ("bt.2100-pq", "limited"))
TAILS["white-noise"] = (("bt.2020", "pq", _HDR10), ("bt.709", "srgb"),
                        dict(dither="white"), 8, None)
TAILS["show-clipping"] = (("bt.2020", "pq", _HDR10), ("bt.709", "srgb"),
                          dict(show_clipping=True), 8, None)
TAILS["low-depth-gamma"] = (("bt.709", "bt.1886"), ("bt.709", "srgb"),
                            {}, 3, None)
TAILS["pass-pq-target"] = (("bt.709", "bt.1886"), ("bt.2020", "pq"), {}, 10,
                           None)
# the chains of color_map_stage on the players' paths, into 8-bit sRGB
# with blue-noise dither: the pass-through chain (with a gamut clip), and
# the IPT round trip with no tone curve or a dynamic one with delayed
# stats under clip, perceptual and softclip (the players' own tail:
# chain-spline-perceptual)
TAILS["chain-pass"] = (("bt.709", "bt.1886"), ("bt.709", "srgb"), {}, 8,
                       None)
TAILS["chain-pass-clip"] = (("bt.2020", "bt.1886"), ("bt.709", "srgb"),
                            dict(gamut_mapping="clip"), 8, None)
for _g in ("perceptual", "softclip"):
    TAILS[f"chain-sdr-{_g}"] = (("bt.2020", "bt.1886"), ("bt.709", "srgb"),
                                dict(gamut_mapping=_g), 8, None)
for _tm in ("spline", "bt2390", "st2094-40", "st2094-10"):
    for _g in ("clip", "perceptual", "softclip"):
        TAILS[f"chain-{_tm}-{_g}"] = (("bt.2020", "pq"), ("bt.709", "srgb"),
                                      dict(tone_mapping_function=_tm,
                                           gamut_mapping=_g), 8, None)
# tails the reference's kernel cannot trace (its HLG delinearize and
# ICtCp encode capture array constants): held against its plain stages
_REF_PLAIN = ("target-hlg", "encode-ictcp")
# tails through pow-based curves of the exact PQ transfer or of tensor
# exponents, whose XLA exp/log/pow ulps flip more dithered values by
# 1 LSB (measured: 4.9e-3, 1.3e-3, 1.1e-3 of values; ROADMAP §3)
_FLIPS = {"static-st2094-10": 1e-2, "static-inverse-bt2446a": 1e-2,
          "encode-ictcp": 1e-2}


def _params(mod_params, peak_cls, kw, jax_side):
    kw = dict(kw)
    if kw.get("dither") == "white":
        kw["dither"] = (jdith.DitherParams(method=JDitherMethod.WHITE_NOISE)
                        if jax_side else
                        tdith.DitherParams(method=lt.DitherMethod.WHITE_NOISE))
    if isinstance(kw.get("peak_detect"), dict):
        kw["peak_detect"] = peak_cls(**kw["peak_detect"])
    return mod_params(**kw)


def _tail_setup(key, h, w):
    """(port tail, JAX tail or None, JAX (src, dst, params, target), port
    (src, dst, params, target), use_peak) of a case."""
    src, dst, kw, bits, rep = TAILS[key]
    js, jd = jcs.color_space_infer_map(_csp(jcs, *src), _csp(jcs, *dst))
    ts, td = tcs.color_space_infer_map(_csp(tcs, *src), _csp(tcs, *dst))
    jp = _params(JParams, JPeak, kw, True)
    tp = _params(lt.RenderParams, lt.PeakDetectParams, kw, False)
    jrep = _repr(jcs, *rep) if rep else JTarget(w=1, h=1).repr
    trep = _repr(tcs, *rep) if rep else lt.Target(w=1, h=1).repr
    jt = JTarget(w=w, h=h, color=_csp(jcs, *dst), bit_depth=bits, repr=jrep)
    tt = lt.Target(w=w, h=h, color=_csp(tcs, *dst), bit_depth=bits,
                   repr=trep)
    use_peak = (tp.peak_detect is not None and ts.is_hdr() and
                tp.tone_mapping_function in
                ("spline", "bt2390", "st2094-40", "st2094-10"))
    jtail = None if key in _REF_PLAIN else JRenderer._fused_tail(
        jp, js, jd, jt, use_peak, None, False, w, h, JRectF(0, 0, w, h))
    ttail = lt.Renderer(device="cpu")._fused_tail(tp, ts, td, tt, use_peak,
                                                  w, h, TRectF(0, 0, w, h))
    return ttail, jtail, (js, jd, jp, jt), (ts, td, tp, tt), use_peak


def _tail_input(h, w, hdr, seed=21):
    scale = 30.0 if hdr else 1.2
    rng = np.random.default_rng(seed)
    return (rng.random((3, h, w)) * scale - scale / 30.0).astype(np.float32)


def _capture_plan(monkeypatch):
    seen = []
    launch = k1.color_map_tail

    def capture(img, plan, tone, lut):
        seen.append((img, plan, tone, lut))
        return launch(img, plan, tone, lut)
    monkeypatch.setattr(k1, "color_map_tail", capture)
    return seen


@pytest.mark.parametrize("key", list(TAILS))
def test_k1_generic_plain_matches_reference_tail(monkeypatch, key):
    """K1's plain version of each tail vs the reference's fused tail
    (interpret mode) on the same input and stats — or its plain stages
    where its kernel cannot trace the tail: within 1 LSB on < 1e-3 of
    values, partials' histograms equal and sums rtol 1e-5; the tail runs
    on K1."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    seen = _capture_plan(monkeypatch)
    h, w = 16, 128
    ttail, jtail, (js, jd, jp, jt), _, use_peak = _tail_setup(key, h, w)
    assert ttail is not None
    x = _tail_input(h, w, js.is_hdr())
    stats = (np.float32(0.31), np.float32(0.74))
    out, tpart = ttail(torch.from_numpy(x), tuple(torch.tensor(s)
                                                  for s in stats)
                       if use_peak else None)
    assert isinstance(seen[0][1], k1.TailPlan)
    jpart = None
    if jtail is None:
        dp = dataclasses.replace(jp.dither, transfer=jd.transfer)

        def stages(v, a, b):
            y = jcms(v, js, jd, jp, (a, b) if use_peak else None)
            y = jcolor.delinearize(y, jd)
            y = jcolor.encode_color(y, jt.repr, jd.primaries)
            return jdith.dither(y, jt.bit_depth, dp)
        ref = np.asarray(jax.jit(stages)(x, *stats))
    else:
        jres = jtail(jnp.asarray(x), tuple(jnp.float32(s) for s in stats)
                     if use_peak else None)
        fused = isinstance(jres, tuple)
        ref = np.asarray(jres[0] if fused else jres)
        jpart = np.asarray(jres[1]) if fused else None
    lsb = 1.0 / ((1 << jt.bit_depth) - 1)
    d = np.abs(out.numpy() - ref)
    assert d.max() <= lsb + 1e-6, d.max()
    assert (d > 1e-6).mean() < _FLIPS.get(key, 1e-3), (d > 1e-6).mean()
    if jpart is not None:
        np.testing.assert_array_equal(tpart[:, 0].numpy(), jpart[:, 0])
        np.testing.assert_allclose(tpart[:, 1, :3].numpy(),
                                   jpart[:, 1, :3], rtol=1e-5)


def test_static_curve_base_floored_at_black():
    """Fault F3 (ROADMAP §3): on the card PyTorch divides by a host float
    through its reciprocal, so `_bt1886_oetf` of the input's lower end
    can round below 0, and the static st2094-40 and hable curves took
    that base to the power 2.4: NaN for black pixels.  The base is
    floored at 0, on the host (float64) and the device alike."""
    from libplacebo_tpu_torch.core import tone_mapping as ttm
    x = torch.tensor([-1e-7, 0.0, 0.25], dtype=torch.float32)
    y = ttm._bt1886_eotf(x, 0.0, 1.0, xp=ttm._TorchXP)
    assert torch.isfinite(y).all() and y[0] == 0.0
    np.testing.assert_array_equal(
        ttm._bt1886_eotf(np.array([0.0, 0.5]), 0.001, 1.0),
        ((1.0 - 0.001 ** (1 / 2.4)) * np.array([0.0, 0.5]) +
         0.001 ** (1 / 2.4)) ** 2.4)


def _eligible_grid():
    """(params kwargs, target) pairs over tone curves x gamut operators x
    target transfers and encodes x dither modes."""
    out = []
    for tm in ("spline", "bt2390", "st2094-40", "st2094-10", "bt2446a",
               "hable", "clip"):
        for g in ("perceptual", "softclip", "relative", "desaturate",
                  "saturation", "linear", "darken", "absolute", "highlight",
                  "clip"):
            for delayed in (True, False, None):
                out.append((dict(tone_mapping_function=tm, gamut_mapping=g,
                                 peak_detect=None if delayed is None else
                                 dict(allow_delayed=delayed)),
                            ("bt.709", "srgb"), None, 8))
    for trc in ("pq", "hlg", "bt.1886", "gamma2.8", "s-log2", "scrgb"):
        for rep in (None, ("bt.709", "limited"), ("bt.2100-pq", "full"),
                    ("bt.2020-c", "limited"), ("xyz", "full")):
            for bits in (8, 4, 0):
                out.append((dict(show_clipping=bits == 4), ("bt.709", trc),
                            rep, bits))
    return out


def test_k1_plan_covers_every_tail_the_reference_fuses(monkeypatch):
    """K1 has a plan for every tail the reference's _fused_tail admits
    (the grid of tone curves, gamut operators, same-frame and delayed
    stats, targets, encodes, dither depths and show_clipping), and for
    none it does not."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    h, w = 8, 128
    n_fused = 0
    for kw, dst, rep, bits in _eligible_grid():
        jp = _params(JParams, JPeak, kw, True)
        tp = _params(lt.RenderParams, lt.PeakDetectParams, kw, False)
        src = ("bt.2020", "pq", _HDR10)
        js, jd = jcs.color_space_infer_map(_csp(jcs, *src), _csp(jcs, *dst))
        ts, td = tcs.color_space_infer_map(_csp(tcs, *src), _csp(tcs, *dst))
        jt = JTarget(w=w, h=h, color=_csp(jcs, *dst), bit_depth=bits,
                     repr=_repr(jcs, *rep) if rep else JTarget(1, 1).repr)
        tt = lt.Target(w=w, h=h, color=_csp(tcs, *dst), bit_depth=bits,
                       repr=_repr(tcs, *rep) if rep else
                       lt.Target(1, 1).repr)
        use_peak = (tp.peak_detect is not None and
                    tp.tone_mapping_function in
                    ("spline", "bt2390", "st2094-40", "st2094-10"))
        jtail = JRenderer._fused_tail(jp, js, jd, jt, use_peak, None, False,
                                      w, h, JRectF(0, 0, w, h))
        ttail = lt.Renderer(device="cpu")._fused_tail(
            tp, ts, td, tt, use_peak, w, h, TRectF(0, 0, w, h))
        assert (ttail is not None) == (jtail is not None), (kw, dst, rep)
        if ttail is not None:
            n_fused += isinstance(ttail.plan, k1.TailPlan)
    assert n_fused > 200


def test_k1_generic_plan_layout():
    """The generic plan's constants fit the kernel's parameters; its ids
    name the parts of the chain; the mix codes read the float64 weights
    (a weight of 1 is no product, a zero is skipped, the first pair
    swaps where the pending weight < 0 < the next)."""
    assert k1.PARAM_BYTES + 2 * 8 + len(k1.GenericMode._fields) * 4 \
        <= k1.PARAM_LIMIT
    assert k1._mix_code([1.0, 0.5, -0.25]) == 0b111 + (1 << 3)
    assert k1._mix_code([0.0, -2.0, 3.0]) == 0b110 + (1 << 6)
    assert k1._mix_code([0.5, 0.0, 0.0], 0.1) == 0b001 + (1 << 7)
    h, w = 16, 128
    ttail, *_ = _tail_setup("target-pq", h, w)
    mode = ttail.plan.generic.mode
    assert k1.G_TRCS[mode.trc] == "pq" and mode.tone_kind == 1
    assert k1.G_GAMUTS[mode.gamut] == "perceptual"
    assert k1.G_DITHER[mode.dither] == "lut"
    assert mode.flags & k1.GFLAG_PEAK


# ---------------------------------------------------------------------------
# Custom LUTs
# ---------------------------------------------------------------------------

def _cube_3d(n=17):
    """A smooth creative 3D LUT (contrast, a warm tint, a cross term)."""
    g = np.linspace(0.0, 1.0, n)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r, gg, b], axis=-1)
    out = np.clip(0.92 * rgb + 0.06 * rgb[..., ::-1] ** 2 + 0.02, 0.0, 1.0)
    return "\n".join([f"LUT_3D_SIZE {n}", "TITLE \"warm\""] +
                     [" ".join(f"{v:.6f}" for v in row)
                      for row in out.reshape(-1, 3)])


def _cube_1d(n=33):
    g = np.linspace(0.0, 1.0, n)
    out = np.stack([g ** 0.8, g ** 1.1, np.sqrt(g)], axis=-1)
    return "\n".join([f"LUT_1D_SIZE {n}", "DOMAIN_MIN 0 0 0",
                      "DOMAIN_MAX 1 1 1.5"] +
                     [" ".join(f"{v:.6f}" for v in row) for row in out])


@pytest.mark.parametrize("kind, fast", [("1d", "never"), ("3d", "never"),
                                        ("3d", "always")])
def test_custom_lut_matches_jax(kind, fast):
    """parse_cube and apply_lut vs the JAX package in the same mode:
    within 1e-6; the low-rank path within _CP_TOL of the exact one."""
    text = _cube_3d() if kind == "3d" else _cube_1d()
    jl, tl = jlut.parse_cube(text), tlut.parse_cube(text)
    np.testing.assert_array_equal(tl.data, jl.data)
    assert (tl.size, tl.domain_min, tl.domain_max) == \
        (jl.size, jl.domain_min, jl.domain_max)
    x = (np.random.default_rng(5).random((3, 16, 32)) * 1.2 - 0.1) \
        .astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jops_lut.apply_lut(v, jl, fast))(x))
    out = tops_lut.apply_lut(torch.from_numpy(x), tl, fast).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    if fast == "always":
        exact = tops_lut.apply_lut(torch.from_numpy(x), tl, "never").numpy()
        assert np.abs(out - exact).max() <= tops_lut._CP_TOL


def test_custom_lut_dispatch_follows_the_reference():
    """"auto" takes the low-rank path at >= 1M pixels and the exact one
    below; a LUT the fit cannot reach stays exact under "auto"."""
    lut = tlut.parse_cube(_cube_3d(9))
    small = torch.rand(3, 8, 8)
    np.testing.assert_array_equal(
        tops_lut.apply_lut(small, lut).numpy(),
        tops_lut.apply_lut(small, lut, "never").numpy())
    assert tops_lut._FAST_MIN_PIXELS == 1 << 20
    assert tops_lut._cp_plan(lut) is not None


# ---------------------------------------------------------------------------
# ICC profiles
# ---------------------------------------------------------------------------

def _f(enc):
    return enc / (0.6 + 0.4 * enc)


_PROFILES = {
    "matrix-trc": lambda: _make_profile(2.2),
    "mft2-b2a": lambda: bytes(_icc_header()) + _icc_tags(
        [(b"B2A0", _mft2_b2a(_f))]),
    "mft2-a2b": lambda: bytes(_icc_header()) + _icc_tags(
        [(b"A2B0", _mft2_b2a(lambda e: 0.8 * e + 0.1 * e ** 2))]),
}


@pytest.mark.parametrize("name", list(_PROFILES))
def test_icc_parser_on_the_reference_fixtures(name):
    """parse_icc reads the JAX tests' byte fixtures as the reference
    does: the same kind, curves, matrices, LUT tables and signature."""
    data = _PROFILES[name]()
    jp, tp = jicc.parse_icc(data), ticc.parse_icc(data)
    assert (tp.color_space, tp.pcs, tp.version, tp.signature) == \
        (jp.color_space, jp.pcs, jp.version, jp.signature)
    for a, b in ((tp.rgb2xyz, jp.rgb2xyz), (tp.chad, jp.chad)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert [c.kind for c in tp.trc] == [c.kind for c in jp.trc]
    for lt_, lj in ((tp.a2b, jp.a2b), (tp.b2a, jp.b2a)):
        assert (lt_ is None) == (lj is None)
        if lt_ is not None:
            pts = np.random.default_rng(0).random((50, 3))
            np.testing.assert_array_equal(lt_.eval(pts), lj.eval(pts))


@pytest.mark.parametrize("name", list(_PROFILES))
def test_icc_encode_decode_match_jax(name):
    """encode_profile (matrix/TRC: the fitted inverse TRCs; cLUT: the
    baked B2A) and decode_profile vs the jitted reference: atol 1e-5."""
    data = _PROFILES[name]()
    jp, tp = jicc.parse_icc(data), ticc.parse_icc(data)
    jprim = jcs.primaries_get(jcs.ColorPrimaries.BT_709)
    tprim = tcs.primaries_get(tcs.ColorPrimaries.BT_709)
    x = (np.random.default_rng(0).random((3, 12, 16)) * 1.2) \
        .astype(np.float32)
    if jp.rgb2xyz is not None or jp.b2a is not None:
        ref = np.asarray(jax.jit(lambda v: jops_icc.encode_profile(
            v, jp, jprim))(x))
        out = tops_icc.encode_profile(torch.from_numpy(x), tp, tprim).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if jp.rgb2xyz is not None or jp.a2b is not None:
        s = np.clip(x, 0, 1)
        ref = np.asarray(jax.jit(lambda v: jops_icc.decode_profile(
            v, jp, jprim))(s))
        out = tops_icc.decode_profile(torch.from_numpy(s), tp, tprim).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_icc_black_point_compensation_matches_jax():
    """force_bpc on a cLUT profile's bake, as pl_icc_params.force_bpc."""
    data = bytes(_icc_header()) + _icc_tags(
        [(b"A2B0", _mft2_b2a(lambda e: 0.02 + 0.9 * e)),
         (b"B2A0", _mft2_b2a(_f))])
    jp, tp = jicc.parse_icc(data), ticc.parse_icc(data)
    x = np.random.default_rng(1).random((3, 8, 8)).astype(np.float32)
    ref = np.asarray(jops_icc.encode_profile(
        jnp.asarray(x), jp, jcs.primaries_get(jcs.ColorPrimaries.BT_709),
        force_bpc=True))
    out = tops_icc.encode_profile(
        torch.from_numpy(x), tp, tcs.primaries_get(tcs.ColorPrimaries.BT_709),
        force_bpc=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_target_icc_keys_the_plan():
    """Two ICC profiles with different bytes never share a cached plan:
    the profile's signature is part of Target.meta_key (and of
    Frame.meta_key), the same bytes give the same key."""
    p1 = ticc.parse_icc(_make_profile(2.2))
    p2 = ticc.parse_icc(_make_profile(2.4))
    p1b = ticc.parse_icc(_make_profile(2.2))
    t = [lt.Target(w=64, h=32, color=lt.CSP_SRGB, bit_depth=8, icc=p)
         for p in (p1, p2, p1b)]
    assert t[0].meta_key() != t[1].meta_key()
    assert t[0].meta_key() == t[2].meta_key()
    y = np.full((16, 32), 120, np.uint8)
    uv = np.full((8, 16), 128, np.uint8)
    frame = lt.frame_from_yuv420p(y, uv, uv, device="cpu")
    r = lt.Renderer(device="cpu")
    params = lt.RenderParams(dither=None)
    outs = [r.render(frame, tt, params) for tt in t]
    assert len(r._cache) == 2
    assert not torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    assert frame.meta_key() != dataclasses.replace(frame, icc=p1).meta_key()


# ---------------------------------------------------------------------------
# Paths A and B end to end
# ---------------------------------------------------------------------------

SRC_H, SRC_W = 64, 128


def _yuv(n, bits, seed, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    lo, sy, sc = (16, 219, 224) if bits == 8 else (64, 876, 896)
    dt = np.uint8 if bits == 8 else np.uint16
    return [((rng.random((h, w)) * sy + lo).astype(dt),
             (rng.random((h // 2, w // 2)) * sc + lo).astype(dt),
             (rng.random((h // 2, w // 2)) * sc + lo).astype(dt))
            for _ in range(n)]


def _path(mod, path, jax_side):
    """(source color, repr, bits, target, params) of path A or B."""
    if path == "A":
        color = mod.ColorSpace(mod.ColorPrimaries.BT_2020,
                               mod.ColorTransfer.HLG)
        rep = _repr(mod, "bt.2020-nc", "limited", 10)
        tcolor_ = _csp(mod, "bt.2020", "pq", dict(max_luma=600.0))
        tgt = dict(color=tcolor_, bit_depth=10)
        params = dict(upscaler="ewa_lanczos", tone_mapping_function="bt2446a")
        return color, rep, 10, tgt, params
    color = mod.ColorSpace(mod.ColorPrimaries.BT_709,
                           mod.ColorTransfer.BT_1886)
    rep = _repr(mod, "bt.709", "limited", 8)
    prof = (jicc if jax_side else ticc).parse_icc(_display_p3_profile())
    lut = (jlut if jax_side else tlut).parse_cube(_cube_3d(33))
    tgt = dict(color=mod.ColorSpace(mod.ColorPrimaries.DISPLAY_P3,
                                    mod.ColorTransfer.GAMMA22),
               bit_depth=8, icc=prof)
    return color, rep, 8, tgt, dict(lut=lut, lut_type="native")


def _display_p3_profile():
    """A matrix/TRC display profile with Display P3 primaries (D50-adapted
    colorants) and a gamma 2.2 TRC, in _make_profile's byte layout."""
    import struct
    p3 = tcs.primaries_get(tcs.ColorPrimaries.DISPLAY_P3)
    m = tcs.rgb_to_xyz_matrix(p3).m
    m = tcs.adapt_white_matrix(p3.white, tcs.CIE_D50).m @ m

    def xyz_tag(v):
        return b"XYZ " + b"\0" * 4 + struct.pack(
            ">3i", *(int(round(x * 65536)) for x in v))

    def curv(g):
        return b"curv" + b"\0" * 4 + struct.pack(">I", 1) + \
            struct.pack(">H", int(round(g * 256)))

    tags = {b"rXYZ": xyz_tag(m[:, 0]), b"gXYZ": xyz_tag(m[:, 1]),
            b"bXYZ": xyz_tag(m[:, 2]), b"rTRC": curv(2.2),
            b"gTRC": curv(2.2), b"bTRC": curv(2.2),
            b"wtpt": xyz_tag((0.9642, 1.0, 0.8249))}
    header = bytearray(128)
    header[8] = 4
    header[16:20] = b"RGB "
    header[20:24] = b"XYZ "
    body = struct.pack(">I", len(tags))
    offset = 132 + 12 * len(tags)
    table = blob = b""
    for sig, d in tags.items():
        table += struct.pack(">4sII", sig, offset, len(d))
        blob += d
        offset += len(d)
    out = bytes(header) + body + table + blob
    return struct.pack(">I", len(out)) + out[4:]


def _render_path(path, n=3, seed=3):
    from libplacebo_tpu.render.frame import frame_from_yuv420p as jff
    jcolor_, jrep, bits, jtgt, jkw = _path(jcs, path, True)
    tcolor_, trep, _, ttgt, tkw = _path(tcs, path, False)
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, **jtgt)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, **ttgt)
    jp, tp = JParams(**jkw), lt.RenderParams(**tkw)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    res = []
    for yuv in _yuv(n, bits, seed):
        jf = jff(*yuv, color=jcolor_, repr=jrep, bit_depth=bits)
        ref = np.asarray(jr._render_once(jf, jt, jp))
        tf_ = lt.frame_from_yuv420p(*yuv, color=tcolor_, repr=trep,
                                    bit_depth=bits, device="cpu")
        res.append((tr.render(tf_, tt, tp).numpy(), ref))
    return res, (trender.k1_tails, trender.plain_tails,
                 trender.ineligible_tails), jt.bit_depth


# path B's frames miss 80 dB: the scaler's and desigmoidize's ulps,
# magnified by the IPT round trip and the ICC encode's steep toe, flip
# 1.0-1.3e-3 of the 8-bit values by 1 LSB (77.0-78.1 dB; bisected in
# ROADMAP §3)
_MIN_PSNR = {"A": 80.0, "B": 75.0}


@pytest.mark.parametrize("path", ["A", "B"])
def test_path_three_frames(monkeypatch, path):
    """Path A (HLG broadcast on a 600-nit PQ display: HLG's OOTF, EWA,
    static bt2446a on K1, PQ target, 10-bit dither) and path B (SDR on
    a calibrated Display P3 monitor: a 33^3 native LUT, the target's ICC
    profile, a plain tail as in the reference) over 3 chained frames
    64x128 -> 128x256 against the reference's renderer: no value more
    than 1 LSB apart, PSNR >= 80 dB (path B >= 75 dB, measured
    77.0-78.1)."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    res, counts, bits = _render_path(path)
    lsb = 1.0 / ((1 << bits) - 1)
    for out, ref in res:
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        d = np.abs(out.astype(np.float64) - ref)
        psnr = 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))
        assert d.max() <= lsb + 1e-6 and psnr >= _MIN_PSNR[path], \
            (d.max() / lsb, psnr)
    assert counts == ((3, 0, 0) if path == "A" else (0, 0, 3))


@pytest.mark.parametrize("case", ["frame_icc", "conversion_lut",
                                  "ignore_icc"])
def test_icc_and_lut_stages_render_like_the_reference(monkeypatch, case):
    """The other ICC and LUT wirings end to end on one frame against the
    reference's renderer: a frame's ICC profile decodes the source
    (pl_icc_decode), a conversion LUT runs after delinearize (the tail
    stays plain, as in the reference), ignore_icc_profiles falls back
    to the colorimetry: no value more than 1 LSB apart."""
    from libplacebo_tpu.render.frame import frame_from_yuv420p as jff
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    yuv = _yuv(1, 8, seed=6)[0]
    data = _make_profile(2.4)
    jc = jcs.ColorSpace(jcs.ColorPrimaries.BT_709, jcs.ColorTransfer.BT_1886)
    tc = tcs.ColorSpace(tcs.ColorPrimaries.BT_709, tcs.ColorTransfer.BT_1886)
    jf = jff(*yuv, color=jc, repr=_repr(jcs, "bt.709", "limited", 8))
    tf_ = lt.frame_from_yuv420p(*yuv, color=tc, device="cpu",
                                repr=_repr(tcs, "bt.709", "limited", 8))
    jkw, tkw = {}, {}
    jt_kw, tt_kw = {}, {}
    if case == "frame_icc":
        jf.icc, tf_.icc = jicc.parse_icc(data), ticc.parse_icc(data)
    elif case == "conversion_lut":
        jkw = dict(lut=jlut.parse_cube(_cube_3d()), lut_type="conversion")
        tkw = dict(lut=tlut.parse_cube(_cube_3d()), lut_type="conversion")
    else:
        jkw = tkw = dict(ignore_icc_profiles=True)
        jt_kw = dict(icc=jicc.parse_icc(data))
        tt_kw = dict(icc=ticc.parse_icc(data))
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8,
                 **jt_kw)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8,
                   **tt_kw)
    ref = np.asarray(JRenderer()._render_once(jf, jt, JParams(**jkw)))
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    out = lt.Renderer(device="cpu").render(tf_, tt, lt.RenderParams(**tkw))
    d = np.abs(out.numpy().astype(np.float64) - ref)
    assert d.max() <= 1.0 / 255 + 1e-6, d.max() * 255
    assert trender.plain_tails == 0
    assert trender.ineligible_tails == (case == "conversion_lut")


def _measure():
    """Print the divergence figures behind the paths' gate."""
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    for path in ("A", "B"):
        for seed in (3, 4):
            res, counts, bits = _render_path(path, seed=seed)
            lsb = 1.0 / ((1 << bits) - 1)
            for i, (out, ref) in enumerate(res):
                d = np.abs(out.astype(np.float64) - ref)
                psnr = 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))
                print(f"path {path} seed {seed} frame {i}: max "
                      f"{d.max() / lsb:.2f} LSB, differing {(d > 0).mean():.2e},"
                      f" PSNR {psnr:.1f} dB; tails {counts}")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def generic_libraries():
    """Every TAILS case's instance (dithered and not, as the tests below
    plan them), compiled side by side in one build_all before the first
    test launches one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plans = []
    with pytest.MonkeyPatch.context() as mp:
        for key in TAILS:
            for dither in (True, False):
                src, dst, kw, bits, rep = TAILS[key]
                if not dither:
                    if bits <= 4:
                        continue
                    mp.setitem(TAILS, key, (src, dst, kw, 0, rep))
                ttail, *_ = _tail_setup(key, 64, 256)
                plans.append(ttail.plan)
                mp.setitem(TAILS, key, (src, dst, kw, bits, rep))
    return k1.libraries(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dither", [True, False])
@pytest.mark.parametrize("key", list(TAILS))
def test_k1_generic_matches_plain_on_card(cuda_device, generic_libraries,
                                          monkeypatch, key, dither):
    """K1's instance on the card vs its plain version (the port's
    stages) on the same input, dithered and not: bit for bit, partials'
    histograms equal and sums rtol 1e-5; two launches give identical
    outputs.  Each runs its own compiled instance (built up front by
    the module's fixture)."""
    seen = _capture_plan(monkeypatch)
    h, w = 64, 256
    if not dither:
        src, dst, kw, bits, rep = TAILS[key]
        if bits <= 4:
            pytest.skip("a low-depth case is about its dither")
        monkeypatch.setitem(TAILS, key, (src, dst, kw, 0, rep))
    ttail, _, (js, *_), _, use_peak = _tail_setup(key, h, w)
    x = _tail_input(h, w, js.is_hdr(), seed=23)
    stats = (torch.tensor(0.3), torch.tensor(0.72)) if use_peak else None
    ttail(torch.from_numpy(x), stats)
    _, plan, tone, lut = seen[0]
    assert plan.header in generic_libraries
    img = torch.from_numpy(x).to(cuda_device)
    tone = tone.to(cuda_device) if tone is not None else None
    lut = lut.to(cuda_device) if lut is not None else None
    before = k1.launches
    out, part = k1.color_map_tail(img, plan, tone, lut)
    out2, _ = k1.color_map_tail(img, plan, tone, lut)
    assert k1.launches == before + 2
    ref, rpart = k1.tail_plain(img, plan, tone, lut)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    bad = torch.nonzero(diff > 0)[:3].tolist()
    print(f"K1 generic {key}: max {diff.max().item():.3g}, differing "
          f"{(diff > 0).float().mean().item():.3g} at "
          f"{[(b, img[:, b[1], b[2]].tolist(), out[tuple(b)].item(),
               ref[tuple(b)].item()) for b in bad]}")
    assert torch.equal(out, ref)
    assert torch.equal(out, out2)
    assert (part is None) == (rpart is None)
    if part is not None:
        assert torch.equal(part[:, 0], rpart[:, 0])
        torch.testing.assert_close(part[:, 1, :3], rpart[:, 1, :3],
                                   rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("key", [k for k in TAILS if k.startswith("static")])
def test_k1_static_curve_matches_apply_device_on_card(cuda_device,
                                                      generic_libraries,
                                                      key):
    """Each static curve of K1's instance alone, on PQ values
    over [0, 1], against core/tone_mapping.py::apply_device run by
    PyTorch on the card: bit for bit (NaN where both are NaN: a curve's
    BT.1886 helpers take a power of a rounding-negative base at the
    input's lower end, in the reference as well).  The curve runs in
    the plan's own library."""
    from libplacebo_tpu_torch.core import tone_mapping as ttm
    ttail, _, _, (ts, td, tp, tt), _ = _tail_setup(key, 16, 128)
    assert ttail.plan.header in generic_libraries
    chain = trender.color_chain(ts, td, tp, False)
    tparams = trender._static_tone_params(ts, tp, chain)
    x = torch.linspace(0.0, 1.0, 1 << 16, device=cuda_device)
    got = k1.static_tone_on_card(x, ttail.plan)
    want = ttm.apply_device(x, tparams)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, 0.0, (got - want).abs().nan_to_num(1.0))
    bad = torch.nonzero(diff > 0).flatten()[:4].tolist()
    print(f"static {key}: differing {(diff > 0).sum().item()}, max "
          f"{diff.max().item():.3g}, at {[(x[i].item(), got[i].item(),
                                           want[i].item()) for i in bad]}")
    assert same.all()


@pytest.mark.cuda
def test_k1_generic_build_failure_raises_and_launches_nothing(cuda_device,
                                                               monkeypatch):
    """A generic tail whose instance does not build (its generated header
    made to fail) raises KernelError when the renderer plans it: no
    kernel launches, nothing degrades, and no other instance or plain
    tail renders it."""
    real = k1.generic_header
    monkeypatch.setattr(k1, "generic_header", lambda key: real(key) +
                        "#error synthetic build failure\n")
    tcolor_, trep, bits, ttgt, tkw = _path(tcs, "A", False)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, **ttgt)
    rg = lt.Renderer(device=cuda_device)
    before = k1.launches
    trender.k1_tails = trender.plain_tails = 0
    yuv = _yuv(1, bits, seed=5)[0]
    with pytest.raises(lt.KernelError, match="synthetic build failure"):
        rg.render(lt.frame_from_yuv420p(*yuv, color=tcolor_, repr=trep,
                                        bit_depth=bits, device=cuda_device),
                  tt, lt.RenderParams(**tkw))
    torch.cuda.synchronize()
    assert k1.launches == before
    assert trender.k1_tails == trender.plain_tails == 0
    assert rg.get_errors() == (frozenset(), frozenset())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["A", "B"])
def test_path_on_card_matches_cpu(cuda_device, path):
    """Paths A and B on the card against the CPU render of the port:
    mean < 1e-4, more than 1 LSB on <= 5e-4 of values; path A's tails on
    K1 (plain 0), path B's ineligible as in the reference."""
    tcolor_, trep, bits, ttgt, tkw = _path(tcs, path, False)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, **ttgt)
    tp = lt.RenderParams(**tkw)
    rg, rc = lt.Renderer(device=cuda_device), lt.Renderer(device="cpu")
    lsb = 1.0 / ((1 << tt.bit_depth) - 1)
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    for yuv in _yuv(3, bits, seed=5):
        g = rg.render(lt.frame_from_yuv420p(*yuv, color=tcolor_, repr=trep,
                                            bit_depth=bits,
                                            device=cuda_device), tt, tp)
        c = rc.render(lt.frame_from_yuv420p(*yuv, color=tcolor_, repr=trep,
                                            bit_depth=bits, device="cpu"),
                      tt, tp).numpy()
        d = np.abs(g.cpu().numpy().astype(np.float64) - c)
        assert d.mean() < 1e-4 and (d > lsb + 1e-6).mean() <= 5e-4
    assert trender.plain_tails == 0
    if path == "A":
        assert trender.k1_tails == 6
    else:
        assert trender.ineligible_tails == 6


if __name__ == "__main__":
    _measure()

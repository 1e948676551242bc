"""Gamut mapping in IPT/ICh space: the 10 operators and the 3D-LUT
generator (host numpy, float64).

Counterpart of libplacebo_tpu/core/gamut_mapping.py (reference
src/gamut_mapping.c): the IPT matrices (Ebner & Fairchild over
PQ-encoded HPE LMS with 4% crosstalk), the `_Gamut` helper, vectorized
bisection / golden-section searches for the boundary chroma and the
hue-wise peaks (which ops/gamut.py's boundary fits use), softclip's
hue-shift spline, the operators, and the (h, C, I) IPT->IPT LUT.
`generate` builds the LUT in native code (a copy of the reference
package's native/gamut.cc, built with g++ at first use; a failed build
raises); `generate_plain` is the same algorithm in numpy, the plain
version the tests hold it against.  Luminances are PQ-encoded; linear
RGB is normalized to 10k nits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from .colorspace import (CIE_D65, RawPrimaries, adapt_white_matrix,
                         primaries_superset, rgb_to_xyz_matrix)

__all__ = [
    "GamutMapConstants", "GamutMapParams", "GamutMapFunction",
    "GAMUT_MAP_FUNCTIONS", "find_gamut_map_function", "generate", "sample",
    "ipt_rgb2lms", "ipt_lms2rgb", "LMS2IPT", "IPT2LMS", "params_noop",
    "generate_plain",
]

# PQ constants (ST 2084)
_M1 = 2610.0 / 16384
_M2 = 2523.0 / 4096 * 128
_C1 = 3424.0 / 4096
_C2 = 2413.0 / 4096 * 32
_C3 = 2392.0 / 4096 * 32


def _pq_eotf(x):
    x = np.clip(x, 0.0, 1.0)
    p = np.power(x, 1.0 / _M2)
    return np.power(np.maximum(p - _C1, 0.0) / (_C2 - _C3 * p), 1.0 / _M1)


def _pq_oetf(y):
    p = np.power(np.maximum(y, 0.0), _M1)
    return np.power((_C1 + _C2 * p) / (1.0 + _C3 * p), _M2)


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# HPE XYZ->LMS (D65), reference colorspace.c:1353
_HPE = np.array([
    [0.40024, 0.70760, -0.08081],
    [-0.22630, 1.16532, 0.04570],
    [0.00000, 0.00000, 0.91822],
])

# Ebner & Fairchild LMS'->IPT and its inverse (colorspace.c:1385-1396)
LMS2IPT = np.array([
    [0.4000, 0.4000, 0.2000],
    [4.4550, -4.8510, 0.3960],
    [0.8056, 0.3572, -1.1628],
])
IPT2LMS = np.array([
    [1.0, 0.0975689, 0.205226],
    [1.0, -0.1138760, 0.133217],
    [1.0, 0.0326151, -0.676887],
])


def ipt_lms2rgb(prim: RawPrimaries) -> np.ndarray:
    """Inverse of ipt_rgb2lms (reference pl_ipt_lms2rgb,
    colorspace.c:1373)."""
    return np.linalg.inv(ipt_rgb2lms(prim))


def ipt_rgb2lms(prim: RawPrimaries) -> np.ndarray:
    """RGB(prim) -> HPE LMS with 4% crosstalk, adapted to D65
    (reference pl_ipt_rgb2lms, colorspace.c:1351)."""
    c = 0.04
    crosstalk = np.full((3, 3), c) + np.eye(3) * (1 - 3 * c)
    m = crosstalk @ _HPE
    m = m @ adapt_white_matrix(prim.white, CIE_D65).m
    return m @ rgb_to_xyz_matrix(prim).m


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GamutMapConstants:
    """Defaults mirror PL_GAMUT_MAP_CONSTANTS (gamut_mapping.h:61-66)."""
    colorimetric_gamma: float = 1.80
    softclip_knee: float = 0.70
    softclip_desat: float = 0.35
    perceptual_deadzone: float = 0.30
    perceptual_strength: float = 0.80

    def fixed(self) -> "GamutMapConstants":
        return GamutMapConstants(
            colorimetric_gamma=float(np.clip(self.colorimetric_gamma, 0, 10)),
            softclip_knee=float(np.clip(self.softclip_knee, 0, 1)),
            softclip_desat=float(np.clip(self.softclip_desat, 0, 1)),
            perceptual_deadzone=float(np.clip(self.perceptual_deadzone, 0, 1)),
            perceptual_strength=float(np.clip(self.perceptual_strength, 0, 1)),
        )


@dataclass(frozen=True)
class GamutMapFunction:
    name: str
    description: str
    map: Callable     # (ipt (...,3), params, src_gamut, dst_gamut) -> (...,3)
    bidirectional: bool = False


@dataclass(frozen=True)
class GamutMapParams:
    function: Optional[GamutMapFunction] = None
    input_gamut: RawPrimaries = field(default_factory=RawPrimaries)
    output_gamut: RawPrimaries = field(default_factory=RawPrimaries)
    min_luma: float = 0.0        # PQ-encoded
    max_luma: float = 1.0        # PQ-encoded
    constants: GamutMapConstants = field(default_factory=GamutMapConstants)
    lut_size_I: int = 48
    lut_size_C: int = 32
    lut_size_h: int = 256


# ---------------------------------------------------------------------------
# Gamut helper (reference `struct gamut`, gamut_mapping.c:258-297)
# ---------------------------------------------------------------------------

class _Gamut:
    def __init__(self, prim: RawPrimaries, min_luma: float, max_luma: float):
        eps = 1e-6
        self.rgb2lms = ipt_rgb2lms(prim)
        self.lms2rgb = np.linalg.inv(self.rgb2lms)
        self.min_luma = min_luma
        self.max_luma = max_luma
        self.min_rgb = float(_pq_eotf(min_luma)) - eps
        self.max_rgb = float(_pq_eotf(max_luma)) + eps


def _rgb2ipt(rgb, gamut: _Gamut):
    lms = rgb @ gamut.rgb2lms.T
    lmsp = _pq_oetf(lms)
    return lmsp @ LMS2IPT.T


def _ipt2rgb(ipt, gamut: _Gamut):
    lmsp = ipt @ IPT2LMS.T
    lms = _pq_eotf(lmsp)
    return lms @ gamut.lms2rgb.T


def _ipt2ich(ipt):
    I, P, T = ipt[..., 0], ipt[..., 1], ipt[..., 2]
    return np.stack([I, np.hypot(P, T), np.arctan2(T, P)], axis=-1)


def _ich2ipt(ich):
    I, C, h = ich[..., 0], ich[..., 1], ich[..., 2]
    return np.stack([I, C * np.cos(h), C * np.sin(h)], axis=-1)


def _ingamut(ipt, gamut: _Gamut):
    """Boolean mask: color representable in gamut
    (reference gamut_mapping.c:340)."""
    lmsp = ipt @ IPT2LMS.T
    ok = np.all((lmsp >= gamut.min_luma) & (lmsp <= gamut.max_luma), axis=-1)
    rgb = _pq_eotf(lmsp) @ gamut.lms2rgb.T
    ok &= np.all((rgb >= gamut.min_rgb) & (rgb <= gamut.max_rgb), axis=-1)
    return ok


_MAX_DELTA = 5e-5
_BISECT_ITERS = 20      # 0.5 * 2^-20 < I*maxDelta for any relevant I
_GOLDEN_ITERS = 22      # (max-min) * invphi^22 < maxDelta


def _desat_bounded(I, h, Cmin, Cmax, gamut: _Gamut):
    """Bisect for the gamut boundary chroma at (I, h); vectorized
    (reference desat_bounded, gamut_mapping.c:488)."""
    I = np.asarray(I, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    Cmin = np.broadcast_to(np.asarray(Cmin, dtype=np.float64),
                           np.broadcast_shapes(I.shape, h.shape)).copy()
    Cmax = np.broadcast_to(np.asarray(Cmax, dtype=np.float64),
                           Cmin.shape).copy()
    Ib = np.broadcast_to(I, Cmin.shape)
    hb = np.broadcast_to(h, Cmin.shape)
    C = (Cmin + Cmax) / 2
    for _ in range(_BISECT_ITERS):
        test = _ich2ipt(np.stack([Ib, C, hb], axis=-1))
        ok = _ingamut(test, gamut)
        Cmin = np.where(ok, C, Cmin)
        Cmax = np.where(ok, Cmax, C)
        C = (Cmin + Cmax) / 2
    # return the proven-inside bound (the reference returns the midpoint,
    # which can land epsilon-outside; inside is strictly safer)
    C = Cmin
    # clamp at luma extremes (achromatic end points)
    C = np.where((Ib <= gamut.min_luma) | (Ib >= gamut.max_luma), 0.0, C)
    I_out = np.clip(Ib, gamut.min_luma, gamut.max_luma)
    return np.stack([I_out, C, hb], axis=-1)


def _saturate(hue, gamut: _Gamut):
    """Maximally saturated in-gamut ICh color for each hue; golden-section
    search over I, vectorized (reference saturate, gamut_mapping.c:511)."""
    hue = np.asarray(hue, dtype=np.float64)
    invphi = 0.6180339887498948
    invphi2 = 0.38196601125010515
    lo = np.full(hue.shape, gamut.min_luma)
    hi = np.full(hue.shape, gamut.max_luma)
    de = hi - lo
    aI = lo + invphi2 * de
    bI = lo + invphi * de
    a = _desat_bounded(aI, hue, 0.0, 0.5, gamut)
    b = _desat_bounded(bI, hue, 0.0, 0.5, gamut)
    for _ in range(_GOLDEN_ITERS):
        de = de * invphi
        a_gt = a[..., 1] > b[..., 1]
        # if a.C > b.C: hi=b; b=a; a = desat(lo + invphi2*de)
        # else:         lo=a; a=b; b = desat(lo + invphi *de)
        new_lo = np.where(a_gt, lo, a[..., 0])
        aI_new = new_lo + invphi2 * de
        bI_new = new_lo + invphi * de
        probe_I = np.where(a_gt, aI_new, bI_new)
        probe = _desat_bounded(probe_I, hue, 0.0, 0.5, gamut)
        new_a = np.where(a_gt[..., None], probe, b)
        new_b = np.where(a_gt[..., None], a, probe)
        lo = new_lo
        a, b = new_a, new_b
    return np.where((a[..., 1] > b[..., 1])[..., None], a, b)


def _mix_exp(ich, x, gamma, base):
    """Exponential mix curve (reference mix_exp, gamut_mapping.c:465)."""
    I = base + (ich[..., 0] - base) * np.power(np.maximum(x, 0.0), gamma)
    return np.stack([I, ich[..., 1] * x, ich[..., 2]], axis=-1)


def _scale_gamma(gamma, ich, peak, gamut: _Gamut):
    Imin = gamut.min_luma
    Irel = np.maximum((ich[..., 0] - Imin) / (peak[..., 0] - Imin), 0.0)
    return gamma * Irel**3 * np.minimum(
        ich[..., 1] / np.maximum(peak[..., 1], 1e-9), 1.0)


def _clip_gamma(ipt, gamma, gamut: _Gamut):
    """Clip along exponential curves toward the peak (reference clip_gamma,
    gamut_mapping.c:548); gamma=0 gives pure desaturation."""
    ich = _ipt2ich(ipt)
    in_g = _ingamut(ipt, gamut)
    below = ipt[..., 0] <= gamut.min_luma

    if not gamma:
        border = _desat_bounded(ich[..., 0], ich[..., 2], 0.0,
                                np.maximum(ich[..., 1], 1e-9), gamut)
        mapped = _ich2ipt(border)
    else:
        peak = _saturate(ich[..., 2], gamut)
        g = _scale_gamma(gamma, ich, peak, gamut)
        lo = np.zeros(ich.shape[:-1])
        hi = np.ones(ich.shape[:-1])
        x = np.full(ich.shape[:-1], 0.5)
        for _ in range(_BISECT_ITERS):
            I = peak[..., 0] + (ich[..., 0] - peak[..., 0]) * \
                np.power(np.maximum(x, 0.0), g)
            test = np.stack([I, ich[..., 1] * x, ich[..., 2]], axis=-1)
            # NB: the test color is ICh and must convert to IPT before
            # the gamut check (golden-parity bug found in round 2: the
            # raw ICh triple was fed to _ingamut, which reads P/T —
            # collapsing all out-of-gamut colors to achromatic)
            ok = _ingamut(_ich2ipt(test), gamut)
            lo = np.where(ok, x, lo)
            hi = np.where(ok, hi, x)
            x = (lo + hi) / 2
        I = peak[..., 0] + (ich[..., 0] - peak[..., 0]) * \
            np.power(np.maximum(x, 0.0), g)
        mapped = _ich2ipt(np.stack([I, ich[..., 1] * x, ich[..., 2]], axis=-1))

    out = np.where(in_g[..., None], ipt, mapped)
    black = np.zeros_like(ipt)
    black[..., 0] = gamut.min_luma
    return np.where(below[..., None], black, out)


def _softclip_scalar(value, source, target, knee):
    """Mobius soft clip (reference softclip, gamut_mapping.c:577);
    vectorized over arrays."""
    target = np.asarray(target, dtype=np.float64)
    safe_target = np.where(target == 0, 1.0, target)
    peak = source / safe_target
    x = np.minimum(value / safe_target, peak)
    j = knee
    # mobius params (guard divide-by-zero where peak <= 1: unused there)
    denom_a = j * j - 2.0 * j + peak
    a = -j * j * (peak - 1.0) / np.where(np.abs(denom_a) < 1e-12, 1e-12, denom_a)
    b = (j * j - 2.0 * j * peak + peak) / np.maximum(1e-6, peak - 1.0)
    scale = (b * b + 2.0 * b * j + j * j) / (b - a)
    mapped = scale * (x + a) / (x + b) * safe_target
    passthru = (x <= j) | (peak <= 1.0)
    out = np.where(passthru, value, mapped)
    return np.where(target == 0, 0.0, out)


# ---------------------------------------------------------------------------
# Operators (each: ipt (...,3) -> (...,3))
# ---------------------------------------------------------------------------

def _map_noop(ipt, params, src, dst):
    return ipt


def _map_perceptual(ipt, params, src, dst):
    """Perceptual soft mapping (reference perceptual, gamut_mapping.c:711)."""
    c = params.constants
    ich = _ipt2ich(ipt)
    hue = ich[..., 2]
    src_peak = _saturate(hue, src)
    dst_peak = _saturate(hue, dst)
    mapped = _rgb2ipt(_ipt2rgb(ipt, src), dst)

    maxC = np.maximum(src_peak[..., 1], dst_peak[..., 1])
    k = _smoothstep(c.perceptual_deadzone, 1.0,
                    ich[..., 1] / np.maximum(maxC, 1e-9))
    k = (k * c.perceptual_strength)[..., None]
    ipt = ipt + (mapped - ipt) * k

    rgb = _ipt2rgb(ipt, dst)
    maxRGB = rgb.max(axis=-1, keepdims=True)
    rgb = np.maximum(
        _softclip_scalar(rgb, maxRGB, dst.max_rgb, c.softclip_knee),
        dst.min_rgb)
    return _rgb2ipt(rgb, dst)


def _hueshift_prepare(src: _Gamut, dst: _Gamut):
    """Cubic-spline hue-shift table between gamuts (reference
    hueshift_prepare, gamut_mapping.c:628)."""
    S = 12
    N = S + 2
    O = float(_pq_eotf(src.min_luma))
    X = float(_pq_eotf(src.max_luma))
    M = (O + X) / 2.0
    refpoints = np.array([
        [X, O, O], [O, X, O], [O, O, X],
        [O, X, X], [X, O, X], [X, X, O],
        [O, X, M], [X, O, M], [X, M, O],
        [O, M, X], [M, O, X], [M, X, O],
    ])
    ich_src = _ipt2ich(_rgb2ipt(refpoints, src))
    ich_dst = _ipt2ich(_rgb2ipt(refpoints, dst))
    delta = ich_dst[:, 2] - ich_src[:, 2]
    delta = np.where(delta > np.pi, delta - 2 * np.pi,
                     np.where(delta < -np.pi, delta + 2 * np.pi, delta))
    order = np.argsort(ich_src[:, 2], kind="stable")
    hues = np.empty(N)
    deltas = np.empty(N)
    hues[1:S + 1] = ich_src[order, 2]
    deltas[1:S + 1] = delta[order]
    hues[0] = hues[S] - 2 * np.pi
    deltas[0] = deltas[S]
    hues[S + 1] = hues[1] + 2 * np.pi
    deltas[S + 1] = deltas[1]

    dh = np.zeros(N)
    dddh = np.zeros(N)
    for i in range(N - 1, 0, -1):
        dh[i - 1] = hues[i] - hues[i - 1]
        dddh[i] = (deltas[i] - deltas[i - 1]) / dh[i - 1]
    # natural cubic spline via gaussian elimination (reference exact steps)
    tmp = np.zeros((N, N))
    for i in range(1, N - 1):
        tmp[i][i] = 2 * (dh[i - 1] + dh[i])
        if i != 1:
            tmp[i][i - 1] = tmp[i - 1][i] = dh[i - 1]
        tmp[i][N - 1] = 6 * (dddh[i + 1] - dddh[i])
    for i in range(1, N - 2):
        q = tmp[i + 1][i] / tmp[i][i]
        tmp[i + 1, 1:N] -= q * tmp[i, 1:N]
    K = np.zeros(N)
    for i in range(N - 2, 0, -1):
        s = float(np.dot(tmp[i, i:N - 1], K[i:N - 1]))
        K[i] = (tmp[i][N - 1] - s) / tmp[i][i]
    return hues, deltas, dh, dddh, K


def _hueshift_apply(table, h):
    """Evaluate the hue-shift spline at hues h (vectorized; reference
    hueshift_apply, gamut_mapping.c:682)."""
    hues, deltas, dh, dddh, K = table
    N = len(hues)
    # interval index: first i with hues[i+1] > h
    idx = np.searchsorted(hues, h, side="right") - 1
    idx = np.clip(idx, 0, N - 2)
    a = (K[idx + 1] - K[idx]) / (6 * dh[idx])
    b = K[idx] / 2
    c = dddh[idx + 1] - (2 * dh[idx] * K[idx] + K[idx + 1] * dh[idx]) / 6
    d = deltas[idx]
    x = h - hues[idx]
    delta = ((a * x + b) * x + c) * x + d
    return h + delta


def _map_softclip(ipt, params, src, dst):
    """Hue-aware soft clipping (reference softclip_map,
    gamut_mapping.c:748)."""
    c = params.constants
    table = _hueshift_prepare(src, dst)

    ich = _ipt2ich(ipt)
    I, C, h = ich[..., 0], ich[..., 1], ich[..., 2]
    achromatic = C <= 1e-2
    below = I <= dst.min_luma

    shifted_h = _hueshift_apply(table, h)
    has_shift = np.abs(shifted_h - h) >= 1e-3

    src_border = _desat_bounded(I, h, 0.0, 0.5, src)
    dst_border = _desat_bounded(I, h, 0.0, 0.5, dst)
    k = _smoothstep(dst_border[..., 1] * c.softclip_knee,
                    np.maximum(src_border[..., 1], 1e-9), C)
    h_new = np.where(has_shift, h + (shifted_h - h) * k, h)
    shift_border = _desat_bounded(I, h_new, 0.0, 0.5, src)
    margin = np.where(
        has_shift,
        np.maximum(1.0, src_border[..., 1] /
                   np.maximum(shift_border[..., 1], 1e-9)),
        1.0)

    source = _saturate(h_new, src)
    target = _saturate(h_new, dst)
    border = _desat_bounded(I, h_new, 0.0, target[..., 1], dst)
    chromaticity = target[..., 1] + \
        (border[..., 1] - target[..., 1]) * c.softclip_desat
    C_new = _softclip_scalar(C, margin * source[..., 1], chromaticity,
                             c.softclip_knee)

    saturated = np.stack([I, chromaticity, h_new], axis=-1)
    peak_rgb = _ipt2rgb(_ich2ipt(saturated), dst)
    rgb = _ipt2rgb(_ich2ipt(np.stack([I, C_new, h_new], axis=-1)), dst)
    rgb = np.maximum(
        _softclip_scalar(rgb, peak_rgb, dst.max_rgb, c.softclip_knee),
        dst.min_rgb)
    mapped = _rgb2ipt(rgb, dst)

    out = np.where((achromatic | below)[..., None], ipt, mapped)
    # below min_luma: zero out chroma, keep intensity (reference behavior)
    desat = np.stack([ipt[..., 0], np.zeros_like(I), np.zeros_like(I)],
                     axis=-1)
    return np.where(below[..., None], desat, out)


def _map_relative(ipt, params, src, dst):
    return _clip_gamma(ipt, params.constants.colorimetric_gamma, dst)


def _map_desaturate(ipt, params, src, dst):
    return _clip_gamma(ipt, 0.0, dst)


def _map_saturation(ipt, params, src, dst):
    return _rgb2ipt(_ipt2rgb(ipt, src), dst)


def _map_absolute(ipt, params, src, dst):
    m = adapt_white_matrix(params.output_gamut.white,
                           params.input_gamut.white).m
    rgb = _ipt2rgb(ipt, dst) @ m.T
    ipt = _rgb2ipt(rgb, dst)
    return _clip_gamma(ipt, params.constants.colorimetric_gamma, dst)


def _map_highlight(ipt, params, src, dst):
    bad = ~_ingamut(ipt, dst)
    hi = np.stack([
        np.minimum(ipt[..., 0] + 0.1, 1.0),
        np.clip(-1.2 * ipt[..., 1], -0.5, 0.5),
        np.clip(-1.2 * ipt[..., 2], -0.5, 0.5),
    ], axis=-1)
    return np.where(bad[..., None], hi, ipt)


def _map_linear(ipt, params, src, dst):
    hues = np.arange(-math.pi, math.pi, 0.1)
    gain = float(np.min(np.minimum(
        1.0,
        _saturate(hues, dst)[..., 1] /
        np.maximum(_saturate(hues, src)[..., 1], 1e-9))))
    ich = _ipt2ich(ipt)
    ich[..., 1] *= gain
    return _ich2ipt(ich)


def _map_darken(ipt, params, src, dst):
    points = np.array([
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [0, 1, 1], [1, 0, 1], [1, 1, 0],
    ], dtype=np.float64)
    p = _ipt2rgb(_rgb2ipt(points, src), dst)
    gain = float(np.min(1.0 / p.max(axis=-1)))
    rgb = _ipt2rgb(ipt, dst) * gain
    ipt = _rgb2ipt(rgb, dst)
    return _clip_gamma(ipt, params.constants.colorimetric_gamma, dst)


GAMUT_MAP_CLIP = GamutMapFunction("clip", "No gamut mapping (hard clip)", _map_noop)
GAMUT_MAP_PERCEPTUAL = GamutMapFunction("perceptual", "Perceptual mapping", _map_perceptual, bidirectional=True)
GAMUT_MAP_SOFTCLIP = GamutMapFunction("softclip", "Soft clipping", _map_softclip)
GAMUT_MAP_RELATIVE = GamutMapFunction("relative", "Colorimetric clip", _map_relative)
GAMUT_MAP_SATURATION = GamutMapFunction("saturation", "Saturation mapping", _map_saturation, bidirectional=True)
GAMUT_MAP_ABSOLUTE = GamutMapFunction("absolute", "Absolute colorimetric clip", _map_absolute)
GAMUT_MAP_DESATURATE = GamutMapFunction("desaturate", "Desaturating clip", _map_desaturate)
GAMUT_MAP_DARKEN = GamutMapFunction("darken", "Darken and clip", _map_darken)
GAMUT_MAP_HIGHLIGHT = GamutMapFunction("highlight", "Highlight out-of-gamut pixels", _map_highlight)
GAMUT_MAP_LINEAR = GamutMapFunction("linear", "Linear desaturate", _map_linear)

GAMUT_MAP_FUNCTIONS = [
    GAMUT_MAP_CLIP, GAMUT_MAP_PERCEPTUAL, GAMUT_MAP_SOFTCLIP,
    GAMUT_MAP_RELATIVE, GAMUT_MAP_SATURATION, GAMUT_MAP_ABSOLUTE,
    GAMUT_MAP_DESATURATE, GAMUT_MAP_DARKEN, GAMUT_MAP_HIGHLIGHT,
    GAMUT_MAP_LINEAR,
]

_BY_NAME: Dict[str, GamutMapFunction] = {f.name: f for f in GAMUT_MAP_FUNCTIONS}


def find_gamut_map_function(name: str) -> Optional[GamutMapFunction]:
    return _BY_NAME.get(name)


def params_noop(params: GamutMapParams) -> bool:
    """True if mapping would be an identity (reference
    pl_gamut_map_params_noop)."""
    fun = params.function or GAMUT_MAP_CLIP
    if fun.map is _map_noop:
        return True
    src, dst = params.input_gamut, params.output_gamut
    need_map = not primaries_superset(dst, src)
    need_map |= (abs(src.white.x - dst.white.x) > 1e-6 or
                 abs(src.white.y - dst.white.y) > 1e-6)
    if fun.bidirectional:
        need_map |= src != dst
    return not need_map


# ---------------------------------------------------------------------------
# LUT generation & sampling (reference pl_gamut_map_generate / _sample)
# ---------------------------------------------------------------------------

def _fixed(params: GamutMapParams) -> GamutMapParams:
    """`params` with its function defaulted and its constants clamped."""
    return GamutMapParams(
        function=params.function or GAMUT_MAP_CLIP,
        input_gamut=params.input_gamut, output_gamut=params.output_gamut,
        min_luma=params.min_luma, max_luma=params.max_luma,
        constants=params.constants.fixed(), lut_size_I=params.lut_size_I,
        lut_size_C=params.lut_size_C, lut_size_h=params.lut_size_h)


def generate(params: GamutMapParams) -> np.ndarray:
    """The (h, C, I, 3) float32 IPT->IPT mapping 3D LUT over I in
    [min_luma, max_luma], C in [0, 0.5], h in [-pi, pi] (the reference's
    layout, gamut_mapping.c:379-427), built by native/gamut.cc: each
    entry scalar, with the reference's one-item per-hue peak cache."""
    from ..native import gamut_lut_native
    params = _fixed(params)
    fun, consts = params.function, params.constants
    src = _Gamut(params.input_gamut, params.min_luma, params.max_luma)
    dst = _Gamut(params.output_gamut, params.min_luma, params.max_luma)
    adapt = np.eye(3)
    if fun.name == "absolute":
        adapt = adapt_white_matrix(params.output_gamut.white,
                                   params.input_gamut.white).m
    return gamut_lut_native(
        fun.name, src.rgb2lms, src.lms2rgb, dst.rgb2lms, dst.lms2rgb, adapt,
        params.min_luma, params.max_luma,
        (consts.colorimetric_gamma, consts.softclip_knee,
         consts.softclip_desat, consts.perceptual_deadzone,
         consts.perceptual_strength),
        params.lut_size_I, params.lut_size_C, params.lut_size_h)


def generate_plain(params: GamutMapParams) -> np.ndarray:
    """`generate`'s LUT computed in numpy over the whole grid at once
    (the reference's Python path; seconds at 48x32x256).  The hue-shifted
    operators (softclip, absolute, darken) differ from the native LUT by
    the peak cache's bounded deviation."""
    params = _fixed(params)
    NI, NC, Nh = params.lut_size_I, params.lut_size_C, params.lut_size_h
    Ix = np.linspace(params.min_luma, params.max_luma, NI)
    Cx = np.linspace(0.0, 0.5, NC)
    hx = np.linspace(-math.pi, math.pi, Nh)
    # broadcast grid: (Nh, NC, NI) with hue leading (hue-only math = O(Nh))
    I = Ix[None, None, :]
    C = Cx[None, :, None]
    h = hx[:, None, None]
    shape = (Nh, NC, NI)
    ich = np.stack([np.broadcast_to(I, shape),
                    np.broadcast_to(C, shape),
                    np.broadcast_to(h, shape)], axis=-1)
    ipt = _ich2ipt(ich)
    src = _Gamut(params.input_gamut, params.min_luma, params.max_luma)
    dst = _Gamut(params.output_gamut, params.min_luma, params.max_luma)
    out = params.function.map(ipt, params, src, dst)
    return np.asarray(out, dtype=np.float32)


def sample(ipt: np.ndarray, params: GamutMapParams) -> np.ndarray:
    """Map IPT color(s) directly (reference pl_gamut_map_sample)."""
    fun = params.function or GAMUT_MAP_CLIP
    consts = params.constants.fixed()
    params = GamutMapParams(
        function=fun, input_gamut=params.input_gamut,
        output_gamut=params.output_gamut, min_luma=params.min_luma,
        max_luma=params.max_luma, constants=consts)
    src = _Gamut(params.input_gamut, params.min_luma, params.max_luma)
    dst = _Gamut(params.output_gamut, params.min_luma, params.max_luma)
    return np.asarray(fun.map(np.asarray(ipt, dtype=np.float64),
                              params, src, dst), dtype=np.float32)

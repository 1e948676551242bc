"""Tone-mapping curve library: host LUT generation and the closed-form
device curve.

Counterpart of libplacebo_tpu/core/tone_mapping.py (reference
src/tone_mapping.c): the 12 operators (clip, st2094-40, st2094-10,
bt2390, bt2446a, spline, reinhard, mobius, hable, gamma, linear,
linearlight) as vectorized functions over an array namespace `xp` —
numpy in float64 for `generate`/`sample`, and a PyTorch namespace
(`_TorchXP`) for `apply_device`, which evaluates the same curve per
pixel on a float32 tensor.  Each curve runs in its native scaling
(NORM / PQ / NITS); inputs are rescaled into it and outputs back out of
it (tone_mapping.c:115-167).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .colorspace import (COLOR_SDR_WHITE, HdrMetadata, HdrScaling,
                         hdr_rescale)
from .fastmath import rcp, sqrt

__all__ = [
    "ToneMapConstants", "ToneMapParams", "ToneMapFunction",
    "TONE_MAP_FUNCTIONS", "find_tone_map_function", "generate", "sample",
    "params_noop", "params_infer", "apply_device",
]


def _smoothstep(edge0, edge1, x):
    if edge0 == edge1:
        return np.where(np.asarray(x) >= edge0, 1.0, 0.0)
    t = np.clip((np.asarray(x, dtype=np.float64) - edge0) / (edge1 - edge0),
                0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mix(a, b, t):
    return a + (b - a) * t


def _bt1886_eotf(x, lo, hi, xp=np):
    """((lw - lb) x + lb) ** 2.4, its base floored at 0: a base that
    rounds below 0 (on the card, where PyTorch divides by a host float
    through its reciprocal, `_bt1886_oetf` of the input's lower end can)
    would give NaN."""
    lb = lo ** (1 / 2.4)
    lw = hi ** (1 / 2.4)
    return xp.maximum((lw - lb) * x + lb, 0.0) ** 2.4


def _bt1886_oetf(x, lo, hi, xp=np):
    lb = lo ** (1 / 2.4)
    lw = hi ** (1 / 2.4)
    return (xp.maximum(x, 0.0) ** (1 / 2.4) - lb) / (lw - lb)


class _TorchXP:
    """The few array functions the curves call, on float32 tensors (a
    Python float stands for a scalar, as in numpy)."""

    @staticmethod
    def asarray(x):
        return x

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, b) if torch.is_tensor(b) else \
            torch.clamp_min(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, b) if torch.is_tensor(b) else \
            torch.clamp_max(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def log1p(x):
        return torch.log1p(x)


# ---------------------------------------------------------------------------
# Parameter structs (reference tone_mapping.h:86-160)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ToneMapConstants:
    """Tunable constants; defaults mirror PL_TONE_MAP_CONSTANTS
    (tone_mapping.h:116-127)."""
    knee_adaptation: float = 0.4
    knee_minimum: float = 0.1
    knee_maximum: float = 0.8
    knee_default: float = 0.4
    knee_offset: float = 1.0
    slope_tuning: float = 1.5
    slope_offset: float = 0.2
    spline_contrast: float = 0.5
    reinhard_contrast: float = 0.5
    linear_knee: float = 0.3
    exposure: float = 1.0

    def fixed(self) -> "ToneMapConstants":
        """Clamp all constants into their legal ranges
        (tone_mapping.c fix_constants)."""
        eps = 1e-6
        c = self
        knee_min = float(np.clip(c.knee_minimum, eps, 0.5 - eps))
        knee_max = float(np.clip(c.knee_maximum, 0.5 + eps, 1.0 - eps))
        return ToneMapConstants(
            knee_adaptation=float(np.clip(c.knee_adaptation, 0.0, 1.0)),
            knee_minimum=knee_min,
            knee_maximum=knee_max,
            knee_default=float(np.clip(c.knee_default, knee_min, knee_max)),
            knee_offset=float(np.clip(c.knee_offset, 0.5, 2.0)),
            slope_tuning=float(np.clip(c.slope_tuning, 0.0, 10.0)),
            slope_offset=float(np.clip(c.slope_offset, 0.0, 1.0)),
            spline_contrast=float(np.clip(c.spline_contrast, 0.0, 1.5)),
            reinhard_contrast=float(np.clip(c.reinhard_contrast, eps,
                                            1 - eps)),
            linear_knee=float(np.clip(c.linear_knee, eps, 1 - eps)),
            exposure=float(np.clip(c.exposure, eps, 10.0)),
        )


@dataclass(frozen=True)
class ToneMapFunction:
    name: str
    description: str
    scaling: HdrScaling = HdrScaling.NORM
    map: Optional[Callable] = None            # (x, params) -> y, vectorized
    map_inverse: Optional[Callable] = None
    param_desc: str = ""
    param_min: float = 0.0
    param_def: float = 0.0
    param_max: float = 0.0


@dataclass(frozen=True)
class ToneMapParams:
    """Reference pl_tone_map_params. All luminances interpreted in
    `input_scaling`/`output_scaling` units."""
    function: Optional[ToneMapFunction] = None
    param: float = 0.0        # legacy single tuning parameter
    constants: ToneMapConstants = field(default_factory=ToneMapConstants)
    input_scaling: HdrScaling = HdrScaling.PQ
    output_scaling: HdrScaling = HdrScaling.PQ
    lut_size: int = 256
    input_min: float = 0.0
    input_max: float = 1.0
    input_avg: float = 0.0
    output_min: float = 0.0
    output_max: float = 1.0
    hdr: HdrMetadata = field(default_factory=HdrMetadata)


def params_infer(p: ToneMapParams) -> ToneMapParams:
    """Apply defaulting/clamping rules (reference pl_tone_map_params_infer)."""
    fun = p.function or TONE_MAP_CLIP
    consts = p.constants
    if p.param:
        if fun.name in ("st2094-40", "st2094-10"):
            consts = replace(consts, knee_adaptation=p.param)
        elif fun.name == "bt2390":
            consts = replace(consts, knee_offset=p.param)
        elif fun.name == "spline":
            consts = replace(consts, spline_contrast=p.param)
        elif fun.name == "reinhard":
            consts = replace(consts, reinhard_contrast=p.param)
        elif fun.name in ("mobius", "gamma"):
            consts = replace(consts, linear_knee=p.param)
        elif fun.name in ("linear", "linearlight"):
            consts = replace(consts, exposure=p.param)
    consts = consts.fixed()

    # Constrain input peak to ≥ max(output_max, 100 nits)
    sdr = hdr_rescale(p.output_scaling, p.input_scaling, p.output_max)
    sdr = min(sdr, hdr_rescale(HdrScaling.NITS, p.input_scaling, 100.0))
    input_max = max(p.input_max, sdr)

    output_max = p.output_max
    if fun.map_inverse is None:
        scaled = hdr_rescale(p.input_scaling, p.output_scaling, input_max)
        output_max = min(output_max, scaled)

    return replace(p, function=fun, constants=consts,
                   input_max=input_max, output_max=output_max)


def params_noop(p: ToneMapParams) -> bool:
    """True if tone mapping would be an identity (pl_tone_map_params_noop)."""
    in_min = hdr_rescale(p.input_scaling, HdrScaling.NITS, p.input_min)
    in_max = hdr_rescale(p.input_scaling, HdrScaling.NITS, p.input_max)
    out_min = hdr_rescale(p.output_scaling, HdrScaling.NITS, p.output_min)
    out_max = hdr_rescale(p.output_scaling, HdrScaling.NITS, p.output_max)
    fun = p.function or TONE_MAP_CLIP
    can_inverse = fun.map_inverse is not None
    return (abs(in_min - out_min) < 1e-4 and
            in_max < out_max + 1e-2 and
            (out_max < in_max + 1e-2 or not can_inverse))


def _fix_params(p: ToneMapParams) -> ToneMapParams:
    """Infer + rescale endpoints into the function's native scaling."""
    p = params_infer(p)
    fun = p.function
    return replace(
        p,
        input_scaling=fun.scaling, output_scaling=fun.scaling,
        input_min=hdr_rescale(p.input_scaling, fun.scaling, p.input_min),
        input_max=hdr_rescale(p.input_scaling, fun.scaling, p.input_max),
        input_avg=hdr_rescale(p.input_scaling, fun.scaling, p.input_avg)
        if p.input_avg else 0.0,
        output_min=hdr_rescale(p.output_scaling, fun.scaling, p.output_min),
        output_max=hdr_rescale(p.output_scaling, fun.scaling, p.output_max),
    )


# Relative rescaling helpers (tone_mapping.c:185-205)

def _rescale_in(x, p):
    return (x - p.input_min) / (p.input_max - p.input_min)


def _rescale(x, p):
    return (x - p.input_min) / (p.output_max - p.output_min)


def _rescale_out(x, p):
    return x * (p.output_max - p.output_min) + p.output_min


# ---------------------------------------------------------------------------
# Knee-point selection (reference st2094_pick_knee, tone_mapping.c:227-268)
# ---------------------------------------------------------------------------

def _st2094_pick_knee(p: ToneMapParams):
    to_pq = lambda s, v: hdr_rescale(s, HdrScaling.PQ, v)
    src_min = to_pq(p.input_scaling, p.input_min)
    src_max = to_pq(p.input_scaling, p.input_max)
    src_avg = to_pq(p.input_scaling, p.input_avg) if p.input_avg else 0.0
    dst_min = to_pq(p.output_scaling, p.output_min)
    dst_max = to_pq(p.output_scaling, p.output_max)

    c = p.constants
    src_knee_min = _mix(src_min, src_max, c.knee_minimum)
    src_knee_max = _mix(src_min, src_max, c.knee_maximum)
    dst_knee_min = _mix(dst_min, dst_max, c.knee_minimum)
    dst_knee_max = _mix(dst_min, dst_max, c.knee_maximum)

    src_knee = src_avg or _mix(src_min, src_max, c.knee_default)
    src_knee = float(np.clip(src_knee, src_knee_min, src_knee_max))

    target = (src_knee - src_min) / (src_max - src_min)
    adapted = _mix(dst_min, dst_max, target)

    tuning = 1.0 - float(_smoothstep(c.knee_maximum, c.knee_default, target) *
                         _smoothstep(c.knee_minimum, c.knee_default, target))
    adaptation = _mix(c.knee_adaptation, 1.0, tuning)
    dst_knee = _mix(src_knee, adapted, adaptation)
    dst_knee = float(np.clip(dst_knee, dst_knee_min, dst_knee_max))

    return (hdr_rescale(HdrScaling.PQ, p.input_scaling, src_knee),
            hdr_rescale(HdrScaling.PQ, p.output_scaling, dst_knee))


# ---------------------------------------------------------------------------
# Operators — each is (x_array, fixed_params) -> y_array
# ---------------------------------------------------------------------------

def _map_clip(x, p, xp=np):
    return xp.asarray(x)


def _st2094_intercept(N, Kx, Ky):
    if Kx <= 0 or Ky >= 1:
        return 1.0 / N
    slope = Ky / Kx * (1 - Kx) / (1 - Ky)
    return min(slope / N, 1.0)


def _st2094_40_knots(p):
    """The bezier's host constants (Kx, Ky, P[0..N]) of ST 2094-40."""
    D = p.output_max
    ootf = p.hdr.ootf
    if ootf is not None and len(ootf.anchors) > 0:
        Kx = float(np.clip(ootf.knee_x, 0, 1))
        Ky = float(np.clip(ootf.knee_y, 0, 1))
        T = float(np.clip(ootf.target_luma, p.input_min, p.input_max))
        N = len(ootf.anchors) + 1
        P = np.zeros(N + 1)
        P[1:N] = ootf.anchors
        P[N] = 1.0
    else:
        src_knee, dst_knee = _st2094_pick_knee(p)
        Kx = src_knee / p.input_max
        Ky = dst_knee / p.output_max
        slope = Ky / Kx * (1 - Kx) / (1 - Ky)
        N = int(np.clip(math.ceil(slope), 2, 16))
        P = np.zeros(N + 1)
        P[1] = _st2094_intercept(N, Kx, Ky)
        P[2:] = 1.0
        T = D

    if D < T:
        u = max(0.0, D / T)
        Kx *= u
        Ky *= u
        beta = N * Kx / (1 - Kx) if Kx < 1 else 1e9
        Kxy = min(Kx * p.input_max / D, beta / (beta + 1))
        Ky = _mix(Kxy, Ky, u)
        P[2:] = _mix(1.0, P[2:], u)
        P[1] = _mix(_st2094_intercept(N, Kx, Ky), P[1], u)
    elif D > T:
        w = (1 - (D - T) / (p.input_max - T)) ** 1.4
        Ky *= T / D
        Kxy = Kx * D / p.input_max
        Ky = _mix(Kxy, Ky, w)
        anchors_lin = np.arange(2, N) / N
        P[2:N] = _mix(anchors_lin, P[2:N], w)
        P[1] = _mix(_st2094_intercept(N, Kx, Ky), P[1], w)
    return Kx, Ky, P


def _map_st2094_40(x, p, xp=np):
    """SMPTE ST 2094-40 Annex B (HDR10+ OOTF bezier), tone_mapping.c:409."""
    Kx, Ky, P = _st2094_40_knots(p)
    N = len(P) - 1
    x = xp.asarray(x)
    x = _bt1886_oetf(x, p.input_min, p.input_max, xp)
    x = _bt1886_eotf(x, 0.0, 1.0, xp)

    # Bezier section (vectorized Bernstein evaluation)
    t = (x - Kx) / max(1 - Kx, 1e-9)
    t = xp.clip(t, 0.0, 1.0)
    from math import comb
    bez = xp.zeros_like(x)
    for i in range(N + 1):
        bez = bez + comb(N, i) * t**i * (1 - t)**(N - i) * float(P[i])
    bez = Ky + (1 - Ky) * bez
    lin = x * (Ky / Kx if Kx else 0.0)
    y = xp.where((x <= Kx) & (Kx > 0), lin, bez)

    y = _bt1886_oetf(y, 0.0, 1.0, xp)
    y = _bt1886_eotf(y, p.output_min, p.output_max, xp)
    return y


def _st2094_10_coefs(p):
    """(c1, c2, c3) of the ST 2094-10 rational curve."""
    src_knee, dst_knee = _st2094_pick_knee(p)
    x1, x2, x3 = p.input_min, src_knee, p.input_max
    y1, y2, y3 = p.output_min, dst_knee, p.output_max
    cmat = np.array([
        [x2 * x3 * (y2 - y3), x1 * x3 * (y3 - y1), x1 * x2 * (y1 - y2)],
        [x3 * y3 - x2 * y2, x1 * y1 - x3 * y3, x2 * y2 - x1 * y1],
        [x3 - x2, x1 - x3, x2 - x1],
    ])
    coeffs = cmat @ np.array([y1, y2, y3])
    k = 1.0 / (x3 * y3 * (x1 - x2) + x2 * y2 * (x3 - x1) + x1 * y1 * (x2 - x3))
    return tuple(float(v) for v in k * coeffs)


def _map_st2094_10(x, p, xp=np):
    """SMPTE ST 2094-10 Annex B.2 rational curve, tone_mapping.c:451."""
    c1, c2, c3 = _st2094_10_coefs(p)
    x = xp.asarray(x)
    return (c1 + c2 * x) / (1 + c3 * x)


def _bt2390_consts(p):
    """(minLum, maxLum, ks, bp, gain) of the BT.2390 EETF."""
    minLum = float(_rescale_in(p.output_min, p))
    maxLum = float(_rescale_in(p.output_max, p))
    offset = p.constants.knee_offset
    ks = (1 + offset) * maxLum - offset
    bp = min(1 / minLum, 4) if minLum > 0 else 4.0
    gain_inv = 1 + minLum / maxLum * (1 - maxLum) ** bp
    gain = 1 / gain_inv if maxLum < 1 else 1.0
    return minLum, maxLum, ks, bp, gain


def _map_bt2390(x, p, xp=np):
    """BT.2390 EETF hermite spline (PQ domain), tone_mapping.c:496."""
    minLum, maxLum, ks, bp, gain = _bt2390_consts(p)
    x = _rescale_in(xp.asarray(x), p)
    if ks < 1:
        tb = (x - ks) / (1 - ks)
        tb2, tb3 = tb * tb, tb**3
        pb = ((2 * tb3 - 3 * tb2 + 1) * ks +
              (tb3 - 2 * tb2 + tb) * (1 - ks) +
              (-2 * tb3 + 3 * tb2) * maxLum)
        x = xp.where(x < ks, x, pb)
    mask = x < 1
    x_bpc = x + minLum * xp.where(mask, (1 - xp.minimum(x, 1.0)) ** bp, 0.0)
    x_bpc = xp.where(mask, gain * (x_bpc - minLum) + minLum, x_bpc)
    x = xp.where(mask, x_bpc, x)
    return x * (p.input_max - p.input_min) + p.input_min


def _bt2446a_consts(p):
    """(phdr, psdr) of BT.2446 method A."""
    return (1 + 32 * (p.input_max / 10000.0) ** (1 / 2.4),
            1 + 32 * (p.output_max / 10000.0) ** (1 / 2.4))


def _map_bt2446a(x, p, xp=np):
    """BT.2446 Method A (nits domain), tone_mapping.c:544."""
    phdr, psdr = _bt2446a_consts(p)
    x = xp.asarray(x)
    y = xp.maximum(_rescale_in(x, p), 0.0) ** (1 / 2.4)
    y = xp.log1p((phdr - 1) * y) / math.log(phdr)
    y = xp.where(y <= 0.7399, 1.0770 * y,
                 xp.where(y < 0.9909, (-1.1510 * y + 2.7811) * y - 0.6302,
                          0.5 * y + 0.5))
    y = (psdr ** y - 1) / (psdr - 1)
    return _bt1886_eotf(y, p.output_min, p.output_max, xp)


def _map_bt2446a_inv(x, p, xp=np):
    x = xp.asarray(x)
    y = _bt1886_oetf(x, p.input_min, p.input_max, xp) * 255.0
    hi = xp.maximum(y, 1e-9) ** ((2.8305e-6 * y - 7.4622e-4) * y + 1.2528)
    lo = xp.maximum(y, 1e-9) ** ((1.8712e-5 * y - 2.7334e-3) * y + 1.3141)
    y = xp.where(y > 70, hi, lo)
    y = (y / 1000.0) ** 2.4
    return _rescale_out(y, p)


def _spline_consts(p):
    """(src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc) of the spline."""
    src_pivot, dst_pivot = _st2094_pick_knee(p)
    slope = (dst_pivot - p.output_min) / (src_pivot - p.input_min)
    ratio = p.input_max / p.output_max - 1.0
    ratio = float(np.clip(p.constants.slope_tuning * ratio,
                          p.constants.slope_offset,
                          1.0 + p.constants.slope_offset))
    slope = slope ** ((1.0 - p.constants.spline_contrast) * ratio)

    in_min = p.input_min - src_pivot
    in_max = p.input_max - src_pivot
    out_min = p.output_min - dst_pivot
    out_max = p.output_max - dst_pivot

    Pa = (out_min - slope * in_min) / (in_min * in_min)
    Pb = slope
    t = 2 * in_max * in_max
    Qa = (slope * in_max - out_max) / (in_max * t)
    Qb = -3 * (slope * in_max - out_max) / t
    Qc = slope
    return src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc


def _map_spline(x, p, xp=np):
    """Single-pivot polynomial spline (default op; PQ domain),
    tone_mapping.c:601."""
    src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc = _spline_consts(p)
    x = xp.asarray(x) - src_pivot
    y = xp.where(x > 0,
                 ((Qa * x + Qb) * x + Qc) * x,
                 (Pa * x + Pb) * x)
    return y + dst_pivot


def _reinhard_consts(p):
    """(offset, scale) of Reinhard."""
    peak = float(_rescale(p.input_max, p))
    contrast = p.constants.reinhard_contrast
    offset = (1.0 - contrast) / contrast
    return offset, (peak + offset) / peak


def _map_reinhard(x, p, xp=np):
    offset, scale = _reinhard_consts(p)
    x = _rescale(xp.asarray(x), p)
    return _rescale_out(scale * x / (x + offset), p)


def _mobius_consts(p):
    """(j, a, b, scale) of Mobius."""
    peak = float(_rescale(p.input_max, p))
    j = p.constants.linear_knee
    a = -j * j * (peak - 1.0) / (j * j - 2.0 * j + peak)
    b = (j * j - 2.0 * j * peak + peak) / max(1e-6, peak - 1.0)
    return j, a, b, (b * b + 2.0 * b * j + j * j) / (b - a)


def _map_mobius(x, p, xp=np):
    j, a, b, scale = _mobius_consts(p)
    x = _rescale(xp.asarray(x), p)
    y = xp.where(x <= j, x, scale * (x + a) / (x + b))
    return _rescale_out(y, p)


def _hable(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def _hable_consts(p):
    """(peak, scale) of Hable's filmic curve."""
    peak = p.input_max / p.output_max
    return peak, 1.0 / _hable(peak)


def _map_hable(x, p, xp=np):
    peak, scale = _hable_consts(p)
    x = xp.asarray(x)
    y = _bt1886_oetf(x, p.input_min, p.input_max, xp)
    y = _bt1886_eotf(y, 0.0, peak, xp)
    y = scale * _hable(y)
    y = _bt1886_oetf(y, 0.0, 1.0, xp)
    return _bt1886_eotf(y, p.output_min, p.output_max, xp)


def _gamma_consts(p):
    """(peak, cutoff, gamma) of the knee gamma curve."""
    peak = float(_rescale(p.input_max, p))
    cutoff = p.constants.linear_knee
    return peak, cutoff, math.log(cutoff) / math.log(cutoff / peak)


def _map_gamma(x, p, xp=np):
    peak, cutoff, gamma = _gamma_consts(p)
    x = _rescale(xp.asarray(x), p)
    y = xp.where(x > cutoff, xp.maximum(x / peak, 1e-9) ** gamma, x)
    return _rescale_out(y, p)


def _map_linear(x, p, xp=np):
    x = _rescale_in(xp.asarray(x), p)
    return _rescale_out(x * p.constants.exposure, p)


# ---------------------------------------------------------------------------
# Registry (reference pl_tone_map_functions[])
# ---------------------------------------------------------------------------

TONE_MAP_CLIP = ToneMapFunction(
    "clip", "No tone mapping (clip)", HdrScaling.NORM,
    _map_clip, _map_clip)
TONE_MAP_ST2094_40 = ToneMapFunction(
    "st2094-40", "SMPTE ST 2094-40 Annex B", HdrScaling.NITS,
    _map_st2094_40, None, "Knee point target", 0.0, 0.7, 1.0)
TONE_MAP_ST2094_10 = ToneMapFunction(
    "st2094-10", "SMPTE ST 2094-10 Annex B.2", HdrScaling.NITS,
    _map_st2094_10, None, "Knee point target", 0.0, 0.7, 1.0)
TONE_MAP_BT2390 = ToneMapFunction(
    "bt2390", "ITU-R BT.2390 EETF", HdrScaling.PQ,
    _map_bt2390, None, "Knee offset", 0.5, 1.0, 2.0)
TONE_MAP_BT2446A = ToneMapFunction(
    "bt2446a", "ITU-R BT.2446 Method A", HdrScaling.NITS,
    _map_bt2446a, _map_bt2446a_inv)
TONE_MAP_SPLINE = ToneMapFunction(
    "spline", "Single-pivot polynomial spline", HdrScaling.PQ,
    _map_spline, _map_spline, "Contrast", 0.0, 0.5, 1.5)
TONE_MAP_REINHARD = ToneMapFunction(
    "reinhard", "Reinhard", HdrScaling.NORM,
    _map_reinhard, None, "Contrast", 0.001, 0.5, 0.99)
TONE_MAP_MOBIUS = ToneMapFunction(
    "mobius", "Mobius", HdrScaling.NORM,
    _map_mobius, None, "Knee point", 0.0, 0.3, 0.99)
TONE_MAP_HABLE = ToneMapFunction(
    "hable", "Filmic tone-mapping (Hable)", HdrScaling.NORM, _map_hable)
TONE_MAP_GAMMA = ToneMapFunction(
    "gamma", "Gamma function with knee", HdrScaling.NORM,
    _map_gamma, None, "Knee point", 0.001, 0.3, 1.0)
TONE_MAP_LINEAR = ToneMapFunction(
    "linear", "Perceptually linear stretch", HdrScaling.PQ,
    _map_linear, _map_linear, "Exposure", 0.001, 1.0, 10.0)
TONE_MAP_LINEAR_LIGHT = ToneMapFunction(
    "linearlight", "Linear light stretch", HdrScaling.NORM,
    _map_linear, _map_linear, "Exposure", 0.001, 1.0, 10.0)

TONE_MAP_FUNCTIONS = [
    TONE_MAP_CLIP, TONE_MAP_ST2094_40, TONE_MAP_ST2094_10, TONE_MAP_BT2390,
    TONE_MAP_BT2446A, TONE_MAP_SPLINE, TONE_MAP_REINHARD, TONE_MAP_MOBIUS,
    TONE_MAP_HABLE, TONE_MAP_GAMMA, TONE_MAP_LINEAR, TONE_MAP_LINEAR_LIGHT,
]

_BY_NAME: Dict[str, ToneMapFunction] = {f.name: f for f in TONE_MAP_FUNCTIONS}


def find_tone_map_function(name: str) -> Optional[ToneMapFunction]:
    return _BY_NAME.get(name)


# ---------------------------------------------------------------------------
# LUT generation & pointwise sampling (tone_mapping.c:147-183)
# ---------------------------------------------------------------------------

def _map_vals(x, p: ToneMapParams, xp=np):
    fun = p.function
    if p.output_max > p.input_max + 1e-4:
        assert fun.map_inverse is not None
        return fun.map_inverse(x, p, xp=xp)
    return fun.map(x, p, xp=xp)


def generate(params: ToneMapParams) -> np.ndarray:
    """Sample the tone curve into a float32 LUT of `params.lut_size`
    entries over [input_min, input_max] in `input_scaling` units, outputs
    in `output_scaling` units (reference pl_tone_map_generate)."""
    fixed = _fix_params(params)
    fun = fixed.function
    xs = np.linspace(params.input_min, params.input_max, params.lut_size)
    xs_native = hdr_rescale(params.input_scaling, fun.scaling, xs)
    ys = _map_vals(np.asarray(xs_native, dtype=np.float64), fixed)
    ys = np.clip(ys, fixed.output_min, fixed.output_max)
    ys = hdr_rescale(fun.scaling, params.output_scaling, ys)
    return np.asarray(ys, dtype=np.float32)


def sample(x: float, params: ToneMapParams) -> float:
    """Single-value tone map (reference pl_tone_map_sample)."""
    fixed = _fix_params(params)
    fun = fixed.function
    x = float(np.clip(x, params.input_min, params.input_max))
    xn = hdr_rescale(params.input_scaling, fun.scaling, x)
    y = _map_vals(np.asarray([xn], dtype=np.float64), fixed)[0]
    y = float(np.clip(y, fixed.output_min, fixed.output_max))
    return hdr_rescale(fun.scaling, params.output_scaling, y)


# ---------------------------------------------------------------------------
# Device-side application: the curve in closed form on a float32 tensor
# (the reference samples a LUT texture; the JAX package evaluates the
# curve per pixel, and so does this port)
# ---------------------------------------------------------------------------

def _hdr_rescale_dev(frm: HdrScaling, to: HdrScaling, x):
    """Luminance rescaling between NORM/SQRT/NITS/PQ on a tensor."""
    if frm == to:
        return x
    from . import transfer as tf
    if frm == HdrScaling.NORM:
        nits = x * COLOR_SDR_WHITE
    elif frm == HdrScaling.SQRT:
        nits = (x * x) * COLOR_SDR_WHITE
    elif frm == HdrScaling.NITS:
        nits = x
    elif frm == HdrScaling.PQ:
        nits = tf.pq_eotf(x) * 10000.0
    else:
        raise ValueError(frm)
    if to == HdrScaling.NORM:
        return nits * rcp(COLOR_SDR_WHITE)
    if to == HdrScaling.SQRT:
        return sqrt(torch.clamp_min(nits, 0.0) * rcp(COLOR_SDR_WHITE))
    if to == HdrScaling.NITS:
        return nits
    if to == HdrScaling.PQ:
        return tf.pq_oetf(torch.clamp(nits, 0.0, 10000.0) * rcp(10000.0))
    raise ValueError(to)


def apply_device(x, params: ToneMapParams):
    """Apply the tone curve to a float32 tensor `x` (in
    params.input_scaling units) in closed form: `generate`'s LUT sampled
    at infinite resolution."""
    fixed = _fix_params(params)
    fun = fixed.function
    x = torch.clamp(x, params.input_min, params.input_max)
    xn = _hdr_rescale_dev(params.input_scaling, fun.scaling, x)
    y = _map_vals(xn, fixed, xp=_TorchXP)
    y = torch.clamp(y, fixed.output_min, fixed.output_max)
    return _hdr_rescale_dev(fun.scaling, params.output_scaling, y)

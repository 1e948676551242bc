"""Dynamic tone mapping with scene statistics held on the device.

Counterpart of libplacebo_tpu/ops/tone_dynamic.py: the four curves the
detected (avg_pq, max_pq) can drive — spline (reference
tone_mapping.c:601-664), bt2390 (:496-538), st2094-40 without HDR10+
anchors (:409) and st2094-10 (:451).  Each curve splits in two:
`tone_params` turns the stats into the curve's scalars — once per
frame, as 0-dim float32 tensors on the frame's device — and
`tone_apply` evaluates the curve per pixel.  The color-map kernel (K1)
reads the same scalars, packed by `tone_vector` in `TONE_KEYS` order.
The scalars stay tensors: PyTorch's CUDA divide by a host float
multiplies by its reciprocal, which the kernel does not.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.colorspace import HdrScaling, hdr_rescale
from ..core.tone_mapping import ToneMapConstants
from ..core.fastmath import fma, rcp
from ..core.transfer import pow_pos, pq_eotf, pq_oetf

__all__ = ["tone_map_dynamic", "tone_params", "tone_vector", "tone_apply",
           "TONE_KEYS", "TONE_VECTOR_LEN", "DYNAMIC_TONE_FUNCTIONS"]

# curves evaluable with detected scene statistics (the reference allows
# peak detection with any function by regenerating its LUT per frame;
# these four cover its PQ/NITS-domain dynamic operators)
DYNAMIC_TONE_FUNCTIONS = ("spline", "bt2390", "st2094-40", "st2094-10")

def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) * rcp(e1 - e0 + 1e-12), 0.0, 1.0)
    return t * t * fma(t, -2.0, 3.0)


def _pick_knee(src_min, src_max, src_avg, dst_min, dst_max,
               c: ToneMapConstants):
    """st2094_pick_knee (tone_mapping.c:227-268); src_max/src_avg are
    0-dim tensors, the rest host floats."""
    src_knee_min = src_min + (src_max - src_min) * c.knee_minimum
    src_knee_max = src_min + (src_max - src_min) * c.knee_maximum
    dst_knee_min = dst_min + (dst_max - dst_min) * c.knee_minimum
    dst_knee_max = dst_min + (dst_max - dst_min) * c.knee_maximum

    def_knee = src_min + (src_max - src_min) * c.knee_default
    src_knee = torch.where(src_avg > 0, src_avg, def_knee)
    src_knee = torch.minimum(torch.maximum(src_knee, src_knee_min),
                             src_knee_max)
    target = (src_knee - src_min) / torch.clamp_min(src_max - src_min, 1e-6)
    adapted = fma(target, dst_max - dst_min, dst_min)
    tuning = fma(-_smoothstep(c.knee_maximum, c.knee_default, target),
                 _smoothstep(c.knee_minimum, c.knee_default, target), 1.0)
    adaptation = fma(tuning, 1.0 - c.knee_adaptation, c.knee_adaptation)
    dst_knee = fma(adapted - src_knee, adaptation, src_knee)
    dst_knee = torch.clamp(dst_knee, dst_knee_min, dst_knee_max)
    return src_knee, dst_knee


def _cmin(x, v):
    return torch.clamp_max(x, v)


def _pos(v):
    return torch.clamp_min(v, 0.0) if torch.is_tensor(v) else max(v, 0.0)


def _spline_params(src_max, src_avg, dst_min, dst_max, c):
    """The spline (reference tone_mapping.c:601-664) with src_min = 0,
    in TONE_KEYS["spline"] order."""
    src_pivot, dst_pivot = _pick_knee(0.0, src_max, src_avg, dst_min,
                                      dst_max, c)
    slope = (dst_pivot - dst_min) / torch.clamp_min(src_pivot, 1e-6)
    ratio = fma(src_max, rcp(dst_max), -1.0)
    ratio = torch.clamp(c.slope_tuning * ratio, c.slope_offset,
                        1.0 + c.slope_offset)
    slope = pow_pos(slope, (1.0 - c.spline_contrast) * ratio)

    in_min = -src_pivot
    in_max = src_max - src_pivot
    out_min = dst_min - dst_pivot
    out_max = dst_max - dst_pivot
    Pa = fma(-slope, in_min, out_min) / torch.clamp_min(in_min * in_min,
                                                         1e-9)
    t = 2 * in_max * in_max
    q = fma(slope, in_max, -out_max)
    Qa = q / torch.clamp_min(in_max * t, 1e-9)
    Qb = -3 * q / torch.clamp_min(t, 1e-9)
    return (src_max, src_pivot, dst_pivot, Pa, slope, Qa, Qb, slope)


def _spline_apply(x, p):
    """The reference's `select(...) + dst_pivot` compiles to one fused
    multiply-add per branch, and so it is written here."""
    src_max, src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc = p
    xs = _cmin(torch.clamp_min(x, 0.0), src_max) - src_pivot
    return torch.where(xs > 0,
                       fma(fma(fma(xs, Qa, Qb), xs, Qc), xs, dst_pivot),
                       fma(fma(xs, Pa, Pb), xs, dst_pivot))


def _bt2390_params(src_max, src_avg, dst_min, dst_max, c):
    """bt2390 (reference tone_mapping.c:496-538) with src_min = 0."""
    rng = torch.clamp_min(src_max, 1e-6)
    min_lum = dst_min / rng
    max_lum = dst_max / rng
    offset = c.knee_offset
    ks = fma(max_lum, 1.0 + offset, -offset)
    bp = torch.where(min_lum > 0,
                     torch.clamp_max(1.0 / torch.clamp_min(min_lum, 1e-9),
                                     4.0), torch.full_like(min_lum, 4.0))
    gain_inv = fma(min_lum / torch.clamp_min(max_lum, 1e-9),
                   pow_pos(torch.clamp_min(1.0 - max_lum, 0.0), bp), 1.0)
    gain = torch.where(max_lum < 1, 1.0 / gain_inv,
                       torch.ones_like(gain_inv))
    one_m_ks = 1.0 - ks
    return (src_max, rng, min_lum, max_lum, ks,
            torch.clamp_min(one_m_ks, 1e-9), bp, gain, one_m_ks)


# (the scalars' own arithmetic stays in the params functions, so that
# each pixel's sequence is the kernel's)
def _bt2390_apply(x, p):
    src_max, rng, min_lum, max_lum, ks, ks_den, bp, gain, one_m_ks = p
    xs = _cmin(torch.clamp_min(x, 0.0), src_max) / rng
    tb = (xs - ks) / ks_den
    tb2 = tb * tb
    tb3 = tb2 * tb
    h0 = fma(tb3, 2.0, -(tb2 * 3.0)) + 1.0
    h1 = fma(tb2, -2.0, tb3) + tb
    h2 = fma(tb3, -2.0, tb2 * 3.0)
    pb = fma(h2, max_lum, fma(h0, ks, h1 * one_m_ks))
    xs = torch.where((xs >= ks) & (ks < 1), pb, xs)
    mask = xs < 1
    lift = pow_pos(torch.clamp_min(1.0 - torch.clamp_max(xs, 1.0), 0.0), bp)
    x_b = fma(torch.where(mask, lift, torch.zeros_like(lift)), min_lum, xs)
    x_b = fma(x_b - min_lum, gain, min_lum)
    return torch.where(mask, x_b, xs) * rng


def _nits(pq_value):
    return pq_eotf(pq_value) * 10000.0


def _st2094_10_params(src_max, src_avg, dst_min, dst_max, c):
    """st2094-10 (reference tone_mapping.c:451) in nits, src_min = 0:
    the rational curve through (0, dmin), the knee and (peak, dmax)."""
    sm = _nits(src_max)
    dmin = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_min)
    dmax = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_max)
    knee_src, knee_dst = _pick_knee(0.0, src_max, src_avg, dst_min,
                                    dst_max, c)
    x2, x3 = _nits(knee_src), sm
    y1, y2, y3 = dmin, _nits(knee_dst), dmax
    # x1 = 0 drops every term it multiplies
    coef1 = x2 * x3 * (y2 - y3) * y1
    coef2 = fma(x3, y3, -(x2 * y2)) * y1 - x3 * y3 * y2 + x2 * y2 * y3
    coef3 = (x3 - x2) * y1 - x3 * y2 + x2 * y3
    k = 1.0 / (x2 * y2 * x3 - x3 * y3 * x2)
    return (src_max, k * coef1, k * coef2, k * coef3)


def _st2094_10_apply(x, p):
    src_max, kc1, kc2, kc3 = p
    xn = _nits(_cmin(torch.clamp_min(x, 0.0), src_max))
    y = fma(xn, kc2, kc1) / fma(xn, kc3, 1.0)
    return pq_oetf(torch.clamp_min(y, 0.0) * rcp(10000.0))


_INV_GAMMA = 1.0 / 2.4


def _st2094_40_params(src_max, src_avg, dst_min, dst_max, c):
    """st2094-40 Annex B without HDR10+ anchors (reference
    tone_mapping.c:409 with T = D): linear below the knee, above it the
    Bernstein sum with P = [0, P1, 1, ..., 1] in its closed form
    1 - B0 - (1 - P1) B1, in BT.1886-normalized nits."""
    sm = _nits(src_max)
    dmin = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_min)
    dmax = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_max)
    knee_src, knee_dst = _pick_knee(0.0, src_max, src_avg, dst_min,
                                    dst_max, c)
    src_knee, dst_knee = _nits(knee_src), _nits(knee_dst)
    lb0 = float(pow_pos(torch.zeros((), dtype=torch.float32), _INV_GAMMA))
    lw = pow_pos(sm, _INV_GAMMA)
    src_den = torch.clamp_min(lw - lb0, 1e-9)
    kx = torch.clamp(src_knee / torch.clamp_min(sm, 1e-9), 1e-6, 1.0)
    ky = torch.clamp(dst_knee * rcp(max(dmax, 1e-9)), 0.0, 1.0 - 1e-6)
    slope = ky / kx * (1.0 - kx) / torch.clamp_min(1.0 - ky, 1e-9)
    n = torch.clamp(torch.ceil(slope), 2.0, 16.0)
    p1 = torch.clamp_max(slope / n, 1.0)
    lbd, lwd = (float(pow_pos(torch.tensor(v, dtype=torch.float32),
                              _INV_GAMMA)) for v in (dmin, dmax))
    return (src_max, src_den, kx, torch.clamp_min(1.0 - kx, 1e-9), ky,
            1.0 - ky, n, n - 1.0, p1 - 1.0,
            torch.full_like(sm, lb0), torch.full_like(sm, 1.0 - lb0),
            torch.full_like(sm, max(1.0 - lb0, 1e-9)),
            torch.full_like(sm, lbd), torch.full_like(sm, lwd - lbd))


def _st2094_40_apply(x, p):
    (src_max, src_den, kx, kx_den, ky, one_m_ky, n, n_m_1, neg_one_m_p1,
     lb0, span01, den01, lbd, span_d) = p
    xn = _nits(_cmin(torch.clamp_min(x, 0.0), src_max))
    o = (pow_pos(torch.clamp_min(xn, 0.0), _INV_GAMMA) - lb0) / src_den
    xb = pow_pos(fma(o, span01, lb0), 2.4)
    t = torch.clamp((xb - kx) / kx_den, 0.0, 1.0)
    omt = torch.clamp_min(1.0 - t, 0.0)
    b0 = pow_pos(omt, n)
    b1 = n * t * pow_pos(omt, n_m_1)
    bez = fma(b1, neg_one_m_p1, 1.0 - b0)
    bez = fma(bez, one_m_ky, ky)
    yb = torch.where(xb <= kx, xb * ky / kx, bez)
    o2 = (pow_pos(torch.clamp_min(yb, 0.0), _INV_GAMMA) - lb0) / den01
    y = pow_pos(fma(o2, span_d, lbd), 2.4)
    return pq_oetf(torch.clamp_min(y, 0.0) * rcp(10000.0))


_CURVES = {
    "spline": (_spline_params, _spline_apply),
    "bt2390": (_bt2390_params, _bt2390_apply),
    "st2094-40": (_st2094_40_params, _st2094_40_apply),
    "st2094-10": (_st2094_10_params, _st2094_10_apply),
}

# the per-frame scalars of each curve, in the order K1 reads them
TONE_KEYS = {
    "spline": ("src_max", "src_pivot", "dst_pivot", "Pa", "Pb", "Qa", "Qb",
               "Qc"),
    "bt2390": ("src_max", "rng", "min_lum", "max_lum", "ks", "ks_den",
               "bp", "gain", "one_m_ks"),
    "st2094-40": ("src_max", "src_den", "kx", "kx_den", "ky", "one_m_ky",
                  "n", "n_m_1", "neg_one_m_p1", "lb0", "span01", "den01",
                  "lbd", "span_d"),
    "st2094-10": ("src_max", "kc1", "kc2", "kc3"),
}
TONE_VECTOR_LEN = 16


def _check_function(function: str):
    if function not in _CURVES:
        raise ValueError(f"dynamic tone mapping unsupported for "
                         f"{function!r}")


def tone_params(function: str, src_max, src_avg, dst_min: float,
                dst_max: float,
                constants: Optional[ToneMapConstants] = None):
    """The curve's per-frame scalars (0-dim float32 tensors) in
    TONE_KEYS[function] order, from the detected stats."""
    _check_function(function)
    c = (constants or ToneMapConstants()).fixed()
    # constrain the input peak to >= the output peak (params_infer)
    src_max = torch.clamp_min(src_max, dst_max)
    return _CURVES[function][0](src_max, src_avg, dst_min, dst_max, c)


def tone_vector(function: str, src_max, src_avg, dst_min: float,
                dst_max: float,
                constants: Optional[ToneMapConstants] = None):
    """The per-frame scalars as one (TONE_VECTOR_LEN,) float32 tensor,
    zero-padded — K1's per-frame input."""
    p = tone_params(function, src_max, src_avg, dst_min, dst_max,
                    constants)
    v = torch.stack([torch.as_tensor(t, dtype=torch.float32,
                                     device=src_max.device) for t in p])
    return torch.cat([v, v.new_zeros(TONE_VECTOR_LEN - v.numel())]) \
        .contiguous()


def tone_apply(function: str, x, p, dst_min: float, dst_max: float):
    """Evaluate the curve with scalars `p` (tone_params: 0-dim tensors)
    on PQ-encoded `x`."""
    _check_function(function)
    return torch.clamp(_CURVES[function][1](x, tuple(p)), dst_min, dst_max)


def tone_map_dynamic(x, function: str, src_max, src_avg,
                     dst_min: float, dst_max: float,
                     constants: Optional[ToneMapConstants] = None):
    """Map PQ-encoded `x` with dynamic source stats (0-dim tensors)."""
    p = tone_params(function, src_max, src_avg, dst_min, dst_max,
                    constants)
    return tone_apply(function, x, p, dst_min, dst_max)

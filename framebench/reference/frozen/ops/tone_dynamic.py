"""Dynamic tone mapping with scene statistics held on the device.

Counterpart of libplacebo_tpu/ops/tone_dynamic.py, cut to the spline
curve (reference tone_mapping.c:601-664): `tone_params` turns the
detected (avg_pq, max_pq) into the curve's scalars, once per frame, as
0-dim float32 tensors, and `tone_apply` evaluates the curve per pixel."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.tone_mapping import ToneMapConstants
from ..core.fastmath import fma, rcp
from ..core.transfer import pow_pos

__all__ = ["tone_map_dynamic", "tone_params", "tone_apply", "TONE_KEYS"]

# curves evaluable with detected scene statistics (the reference allows
# peak detection with any function by regenerating its LUT per frame;
# these four cover its PQ/NITS-domain dynamic operators)

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


_CURVES = {
    "spline": (_spline_params, _spline_apply),
}

# the per-frame scalars of each curve, in the order K1 reads them
TONE_KEYS = {
    "spline": ("src_max", "src_pivot", "dst_pivot", "Pa", "Pb", "Qa", "Qb",
               "Qc"),
}


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

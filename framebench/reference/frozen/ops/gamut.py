"""Device gamut mapping in IPT/ICh space, fused with the tone map.

Counterpart of libplacebo_tpu/ops/gamut.py, cut to `color_map_ipt`
(tone curve + gamut operator in one IPT round trip, reference
pl_shader_color_map_ex, shaders/colorspace.c:1790-1980) with the
perceptual operator.  The host fits each gamut's boundary C_max(I, h)
and its hue-wise peaks once as Fourier series in hue (times a
polynomial in intensity for the boundary; `fit_boundary`, float64, from
the exact bisection searches); the device evaluates them closed-form
with the hue kept in (cos, sin) form."""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import gamut_mapping as gm
from ..core.colorspace import RawPrimaries
from ..core.gamut_mapping import GamutMapConstants, IPT2LMS, LMS2IPT
from ..core.fastmath import f32_mul, fma, mix, rcp, sqrt
from ..core.transfer import pq_eotf_fast, pq_oetf_fast
from .color import mat_pointwise

__all__ = ["GamutBoundary", "fit_boundary", "color_map_ipt", "boundary_rows", "HARMONICS", "POLY_DEG"]


HARMONICS = 8
POLY_DEG = 6
_NI, _NH = 49, 96


@dataclass(frozen=True)
class GamutBoundary:
    """Fitted C_max(I, h): a (2H+1, D+1) coefficient matrix over
    [1, cos(kh), sin(kh)] x [env(I)·I_rel^d], the hue-wise peaks
    (I_peak(h), C_peak(h)) as (2H+1,) Fourier coefficients, plus the
    gamut's matrices, RGB range and primaries."""
    coefs: Optional[Tuple]
    peak_i: Optional[Tuple]
    peak_c: Optional[Tuple]
    min_luma: float
    max_luma: float
    max_rgb: float
    min_rgb: float
    rgb2lms: Tuple
    lms2rgb: Tuple
    prim: Optional[RawPrimaries] = None


def _fourier_design(h: np.ndarray) -> np.ndarray:
    cols = [np.ones_like(h)]
    for k in range(1, HARMONICS + 1):
        cols.append(np.cos(k * h))
        cols.append(np.sin(k * h))
    return np.stack(cols, axis=-1)


@lru_cache(maxsize=16)
def fit_boundary(prim: RawPrimaries, min_luma: float, max_luma: float,
                 ) -> GamutBoundary:
    """Least-squares fit of the exact boundary on a 96-hue x 49-luma
    grid (envelope sqrt(I_rel)·(1 - I_rel) pins both achromatic ends)."""
    g = gm._Gamut(prim, min_luma, max_luma)
    Is = np.linspace(min_luma, max_luma, _NI)
    hs = np.linspace(-math.pi, math.pi, _NH, endpoint=False)
    bound = gm._desat_bounded(Is[None, :], hs[:, None], 0.0, 0.5, g)[..., 1]
    I_rel = (Is - min_luma) / max(max_luma - min_luma, 1e-9)
    env = np.sqrt(I_rel) * (1.0 - I_rel)
    P = np.stack([env * I_rel ** d for d in range(POLY_DEG + 1)], axis=-1)
    F = _fourier_design(hs)
    A = (F[:, None, :, None] * P[None, :, None, :]).reshape(
        _NH * _NI, (2 * HARMONICS + 1) * (POLY_DEG + 1))
    coef, *_ = np.linalg.lstsq(A, bound.reshape(-1), rcond=None)
    coefs = coef.reshape(2 * HARMONICS + 1, POLY_DEG + 1)
    # hue-wise peak (saturate) tables
    peaks = gm._saturate(hs, g)
    pi_coef, *_ = np.linalg.lstsq(F, peaks[:, 0], rcond=None)
    pc_coef, *_ = np.linalg.lstsq(F, peaks[:, 1], rcond=None)
    return GamutBoundary(
        coefs=tuple(map(tuple, coefs.astype(np.float64))),
        peak_i=tuple(pi_coef.astype(np.float64)),
        peak_c=tuple(pc_coef.astype(np.float64)),
        min_luma=min_luma, max_luma=max_luma,
        max_rgb=g.max_rgb, min_rgb=g.min_rgb,
        rgb2lms=tuple(map(tuple, g.rgb2lms)),
        lms2rgb=tuple(map(tuple, g.lms2rgb)), prim=prim)


def boundary_rows(b: GamutBoundary) -> np.ndarray:
    """float32 (2H+1, D+1) coefficients with the reference's row pruning
    folded in: a row whose |coefficients| sum to <= 2e-3 contributes
    < 1e-3 chroma and is skipped, which equals zeroing it (row 0, the
    constant term, is always kept)."""
    coefs = np.asarray(b.coefs, np.float32).copy()
    keep = np.abs(coefs).sum(axis=1) > 2e-3
    keep[0] = True
    coefs[~keep] = 0.0
    return coefs


# ---------------------------------------------------------------------------
# Device evaluation
# ---------------------------------------------------------------------------

def _fourier_basis(cos_h, sin_h):
    """cos(kh), sin(kh), k=1..H, by the angle-addition recurrence."""
    cs = [cos_h]
    sn = [sin_h]
    for _ in range(2, HARMONICS + 1):
        cs.append(fma(cs[-1], cos_h, -(sn[-1] * sin_h)))
        sn.append(fma(sn[-1], cos_h, cs[-2] * sin_h))
    return cs, sn


def _ipowers(b: GamutBoundary, I):
    """env(I)·I_rel^d for d = 0..D, shared by both gamuts' fits."""
    I_rel = torch.clamp((I - b.min_luma) *
                        rcp(max(b.max_luma - b.min_luma, 1e-9)), 0.0, 1.0)
    powers = [sqrt(I_rel) * (1.0 - I_rel)]
    for _ in range(POLY_DEG):
        powers.append(powers[-1] * I_rel)
    return powers


def _boundary_eval_dev(b: GamutBoundary, basis, powers):
    """C_max(I, h) from the shared Fourier basis and intensity powers."""
    coefs = boundary_rows(b)
    cs, sn = basis

    def poly_eval(row):
        ds = [d for d in range(coefs.shape[1]) if coefs[row, d] != 0.0]
        if not ds:
            return torch.zeros_like(powers[0])
        return mix([powers[d] for d in ds], [float(coefs[row, d])
                                             for d in ds])

    out = poly_eval(0)
    for k in range(1, HARMONICS + 1):
        if coefs[2 * k - 1].any():
            out = fma(poly_eval(2 * k - 1), cs[k - 1], out)
        if coefs[2 * k].any():
            out = fma(poly_eval(2 * k), sn[k - 1], out)
    return torch.clamp_min(out, 1e-5)


def _rgb2ich_dev(rgb, b: GamutBoundary):
    """RGB -> (I, C, cos_h, sin_h); the hue never leaves (cos, sin)."""
    lms = mat_pointwise(rgb, np.asarray(b.rgb2lms))
    lmsp = pq_oetf_fast(torch.clamp_min(lms, 0.0))
    ipt = mat_pointwise(lmsp, LMS2IPT)
    I = ipt[..., 0, :, :]
    P = ipt[..., 1, :, :]
    T = ipt[..., 2, :, :]
    C = sqrt(fma(P, P, T * T) + 1e-18)
    return I, C, P / C, T / C


def _ich2rgb_dev(I, C, cos_h, sin_h, b: GamutBoundary):
    ipt = torch.stack([I, C * cos_h, C * sin_h], dim=-3)
    lms = pq_eotf_fast(mat_pointwise(ipt, IPT2LMS))
    return mat_pointwise(lms, np.asarray(b.lms2rgb))


def _softclip_dev(value, source, target, knee: float):
    """Reference softclip (gamut_mapping.c:577) per pixel, with the
    passthrough <-> mapped switch smoothstep-blended over peak in
    [1, 1.02] and the rational denominators kept away from zero (the
    reference evaluates it on LUT grid points, where trilinear sampling
    smooths the same discontinuity).  The constants in `knee` combine on
    the host in float64, as in the reference.  `target` is a tensor or a
    constant; for a constant, XLA divides by multiplying with its float32
    reciprocal r and folds r into the constant factor of `2j·peak`, and
    so does this function."""
    j = knee
    if torch.is_tensor(target):
        safe_t = torch.clamp_min(target, 1e-9)
        peak = source / safe_t
        x = torch.minimum(value / safe_t, peak)
        bb_num = fma(peak, -2.0 * j, j * j) + peak
    else:
        safe_t = max(target, 1e-9)
        r = rcp(safe_t)
        peak = source * r
        x = torch.minimum(value * r, peak)
        bb_num = fma(source, -f32_mul(2.0 * j, r), j * j) + peak
    denom_a = j * j - 2.0 * j + peak
    a = -j * j * (peak - 1.0) / torch.where(
        torch.abs(denom_a) < 1e-9, torch.full_like(denom_a, 1e-9), denom_a)
    bb = bb_num / torch.clamp_min(peak - 1.0, 1e-2)
    scale = (fma(bb, bb, 2.0 * bb * j) + j * j) / (bb - a)
    denom = x + bb
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-6),
                       torch.full_like(denom, 1e-6))
    denom = torch.where(torch.abs(denom) < 1e-6, tiny, denom)
    # mapped = scale·(x + a)/denom·safe_t; its last product fuses into
    # `mapped - value`
    mapped_m_value = fma(scale * (x + a) / denom, safe_t, -value)
    t = torch.clamp((peak - 1.0) * rcp(0.02), 0.0, 1.0)
    w = t * t * fma(t, -2.0, 3.0)
    blended = fma(mapped_m_value, w, value)
    return torch.where(x <= j, value, blended)


def _rgb_softclip(out, dst: GamutBoundary, knee: float):
    """The final RGB soft-clip against the display range (per pixel
    from the largest channel), floored at its minimum."""
    max_rgb = torch.amax(out, dim=-3, keepdim=True)
    return torch.clamp_min(
        _softclip_dev(out, torch.clamp_min(max_rgb, dst.max_rgb),
                      dst.max_rgb, knee), dst.min_rgb)


def _gamut_ich_to_rgb(function, I, C, cos_h, sin_h, src: GamutBoundary,
                      dst: GamutBoundary, c: GamutMapConstants,
                      to_norm: float):
    """Apply the perceptual gamut operator in ICh space and convert to
    linear RGB in dst primaries (divided back by to_norm): chroma
    soft-compression toward the dst boundary, intensity kept
    (reference softclip_map)."""
    if function != "perceptual":
        raise ValueError(f"gamut operator {function!r} is not kept in "
                         f"this copy")
    basis = _fourier_basis(cos_h, sin_h)
    powers = _ipowers(dst, I)
    # the renderer fits both boundaries over the dst luma range
    powers_src = powers if (src.min_luma, src.max_luma) == \
        (dst.min_luma, dst.max_luma) else _ipowers(src, I)
    C_src = _boundary_eval_dev(src, basis, powers_src)
    C_dst = _boundary_eval_dev(dst, basis, powers)
    knee = c.softclip_knee
    C_new = _softclip_dev(C, torch.maximum(C_src, C_dst), C_dst, knee)
    C_new = fma(C_new - C, c.perceptual_strength, C)
    out = _ich2rgb_dev(I, C_new, cos_h, sin_h, dst)
    return _rgb_softclip(out, dst, knee) * rcp(to_norm)


def color_map_ipt(rgb_linear_src, tone_fn, gamut_function: Optional[str],
                  src: GamutBoundary, dst: GamutBoundary,
                  to_norm: float = 1.0,
                  constants: Optional[GamutMapConstants] = None):
    """Tone + gamut mapping through one IPT round trip: linear RGB in
    src primaries -> ICh; tone-map I with the cubic-hull chroma
    adjustment (colorspace.c:1930); the gamut operator; linear RGB in
    dst primaries.  `tone_fn` maps PQ intensity -> PQ intensity (None:
    no tone map); `gamut_function` None/"clip"/"saturation" clamps."""
    c = (constants or GamutMapConstants()).fixed()
    x = rgb_linear_src * to_norm
    I, C, cos_h, sin_h = _rgb2ich_dev(x, src)
    if tone_fn is not None:
        i_orig = I
        I = tone_fn(I)
        hull_new = fma(I - 6.0, I, 9.0) * I
        hull_old = fma(i_orig - 6.0, i_orig, 9.0) * i_orig
        C = C * torch.minimum(i_orig / torch.clamp_min(I, 1e-6),
                              hull_new / torch.clamp_min(hull_old, 1e-6))
    if gamut_function in (None, "", "none", "clip", "saturation"):
        out = _ich2rgb_dev(I, C, cos_h, sin_h, dst)
        return torch.clamp(out, dst.min_rgb, dst.max_rgb) * rcp(to_norm)
    return _gamut_ich_to_rgb(gamut_function, I, C, cos_h, sin_h, src, dst,
                             c, to_norm)

"""Device gamut mapping in IPT/ICh space, fused with the tone map.

Counterpart of libplacebo_tpu/ops/gamut.py: `color_map_ipt` (tone curve
+ gamut operator in one IPT round trip, reference
pl_shader_color_map_ex, shaders/colorspace.c:1790-1980), `map_gamut`
(an operator alone) and every operator of the reference package:
perceptual, softclip (with its Fourier-fitted hue shift), relative,
desaturate, saturation, clip, linear, darken, absolute and highlight,
plus show_clipping's colorization.  The host fits each gamut's
boundary C_max(I, h) and its hue-wise peaks once as Fourier series in
hue (times a polynomial in intensity for the boundary; `fit_boundary`,
float64, from the exact bisection searches); the device evaluates them
closed-form with the hue kept in (cos, sin) form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import gamut_mapping as gm
from ..core.colorspace import RawPrimaries, adapt_white_matrix, pq_eotf_np
from ..core.gamut_mapping import GamutMapConstants, IPT2LMS, LMS2IPT
from ..core.fastmath import f32_mul, fma, mix, rcp, sqrt
from ..core.transfer import pq_eotf_fast, pq_oetf_fast
from .color import mat_pointwise

__all__ = ["GamutBoundary", "fit_boundary", "ipt_space", "color_map_ipt",
           "map_gamut", "boundary_rows", "hueshift_fourier",
           "GAMUT_DEVICE_OPS", "HARMONICS", "POLY_DEG"]

GAMUT_DEVICE_OPS = ("clip", "perceptual", "softclip", "relative",
                    "desaturate", "saturation", "linear", "darken",
                    "absolute", "highlight")

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


@lru_cache(maxsize=16)
def ipt_space(prim: RawPrimaries, min_luma: float, max_luma: float,
              ) -> GamutBoundary:
    """Matrices-only GamutBoundary (no boundary fit)."""
    g = gm._Gamut(prim, min_luma, max_luma)
    return GamutBoundary(
        coefs=None, peak_i=None, peak_c=None, min_luma=min_luma,
        max_luma=max_luma, max_rgb=g.max_rgb, min_rgb=g.min_rgb,
        rgb2lms=tuple(map(tuple, g.rgb2lms)),
        lms2rgb=tuple(map(tuple, g.lms2rgb)), prim=prim)


@lru_cache(maxsize=16)
def hueshift_fourier(src: GamutBoundary, dst: GamutBoundary
                     ) -> Optional[Tuple]:
    """(2H+1,) Fourier fit of the reference's cubic-spline hue shift
    delta(h) between two gamuts (hueshift_prepare/apply,
    gamut_mapping.c:628-700), or None when the gamuts induce no shift
    of 1e-3 or more anywhere (or lack primaries)."""
    if src.prim is None or dst.prim is None:
        return None
    gs = gm._Gamut(src.prim, src.min_luma, src.max_luma)
    gd = gm._Gamut(dst.prim, dst.min_luma, dst.max_luma)
    table = gm._hueshift_prepare(gs, gd)
    hs = np.linspace(-math.pi, math.pi, 720, endpoint=False)
    delta = gm._hueshift_apply(table, hs) - hs
    if np.abs(delta).max() < 1e-3:
        return None
    c, *_ = np.linalg.lstsq(_fourier_design(hs), delta, rcond=None)
    return tuple(c.astype(np.float64))


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


def _fourier_eval(coefs, basis):
    """A (2H+1,) Fourier series on the shared (cos kh, sin kh) basis:
    the constant, then one fused multiply-add a term."""
    cs, sn = basis
    c = np.asarray(coefs, np.float32)
    out = torch.full_like(cs[0], float(c[0]))
    for k in range(1, HARMONICS + 1):
        out = fma(cs[k - 1], float(c[2 * k - 1]), out)
        out = fma(sn[k - 1], float(c[2 * k]), out)
    return out


def _rgb_softclip(out, dst: GamutBoundary, knee: float):
    """The final RGB soft-clip against the display range (per pixel
    from the largest channel), floored at its minimum."""
    max_rgb = torch.amax(out, dim=-3, keepdim=True)
    return torch.clamp_min(
        _softclip_dev(out, torch.clamp_min(max_rgb, dst.max_rgb),
                      dst.max_rgb, knee), dst.min_rgb)


def _softclip_hue(C, cos_h, sin_h, src, dst, c, powers, C_src, C_dst,
                  hue_coefs, basis):
    """softclip's chroma map with the hue shift: the hue turns by
    delta(h) scaled by a smoothstep from the dst deadzone to the src
    boundary, then the chroma soft-clips toward the shifted hue's
    peaks (reference softclip_map, gamut_mapping.c:748).  Returns
    (C_new, cos h', sin h')."""
    knee = c.softclip_knee
    delta = _fourier_eval(hue_coefs, basis)
    num = fma(C_dst, -knee, C)
    den = torch.clamp_min(fma(C_dst, -knee, C_src), 1e-9)
    t = torch.clamp(num / den, 0.0, 1.0)
    delta = delta * (t * t * fma(t, -2.0, 3.0))
    cosd, sind = torch.cos(delta), torch.sin(delta)
    ch2 = fma(cos_h, cosd, -(sin_h * sind))
    sh2 = fma(sin_h, cosd, cos_h * sind)
    basis2 = _fourier_basis(ch2, sh2)
    C_src2 = _boundary_eval_dev(src, basis2, powers[0])
    margin = torch.clamp_min(C_src / torch.clamp_min(C_src2, 1e-9), 1.0)
    C_dst2 = _boundary_eval_dev(dst, basis2, powers[1])
    source_c = torch.clamp_min(_fourier_eval(src.peak_c, basis2), 1e-5)
    target_c = torch.clamp_min(_fourier_eval(dst.peak_c, basis2), 1e-5)
    border_c = torch.minimum(C_dst2, target_c)
    chroma = fma(border_c - target_c, c.softclip_desat, target_c)
    C_new = _softclip_dev(C, torch.maximum(margin * source_c, chroma),
                          chroma, knee)
    return C_new, ch2, sh2


def _gamut_ich_to_rgb(function, I, C, cos_h, sin_h, src: GamutBoundary,
                      dst: GamutBoundary, c: GamutMapConstants,
                      to_norm: float):
    """Apply one gamut operator in ICh space and convert to linear RGB
    in dst primaries (divided back by to_norm)."""
    if function == "absolute":
        # colorimetric clip without white-point adaptation: the inverse
        # chromatic adaptation (dst white -> src white), then relative
        m = np.eye(3)
        if src.prim is not None and dst.prim is not None:
            m = np.asarray(adapt_white_matrix(dst.prim.white,
                                              src.prim.white).m)
        rgb = mat_pointwise(_ich2rgb_dev(I, C, cos_h, sin_h, dst),
                            np.asarray(m, np.float32))
        I2, C2, ch2, sh2 = _rgb2ich_dev(rgb, dst)
        return _gamut_ich_to_rgb("relative", I2, C2, ch2, sh2, src, dst,
                                 c, to_norm)

    if function == "highlight":
        # debug view: out-of-gamut pixels brighten and invert their hue
        P, T = C * cos_h, C * sin_h
        lmsp = mat_pointwise(torch.stack([I, P, T], dim=-3), IPT2LMS)
        ok_l = ((lmsp >= dst.min_luma) & (lmsp <= dst.max_luma)).all(dim=-3)
        rgb = mat_pointwise(pq_eotf_fast(lmsp), np.asarray(dst.lms2rgb))
        ok_r = ((rgb >= dst.min_rgb) & (rgb <= dst.max_rgb)).all(dim=-3)
        bad = ~(ok_l & ok_r)
        I2 = torch.where(bad, torch.clamp_max(I + 0.1, 1.0), I)
        P2 = torch.where(bad, torch.clamp(-1.2 * P, -0.5, 0.5), P)
        T2 = torch.where(bad, torch.clamp(-1.2 * T, -0.5, 0.5), T)
        lms = pq_eotf_fast(mat_pointwise(torch.stack([I2, P2, T2], dim=-3),
                                         IPT2LMS))
        return mat_pointwise(lms, np.asarray(dst.lms2rgb)) * rcp(to_norm)

    basis = _fourier_basis(cos_h, sin_h)
    powers = _ipowers(dst, I)
    # the renderer fits both boundaries over the dst luma range
    powers_src = powers if (src.min_luma, src.max_luma) == \
        (dst.min_luma, dst.max_luma) else _ipowers(src, I)

    if function in ("relative", "desaturate"):
        Cb = _boundary_eval_dev(dst, basis, powers)
        C_new = torch.minimum(C, Cb)
        if function == "relative":
            # the gamma-curve clip, approximated: colors past the
            # boundary also darken toward the hue peak
            peak_i = _fourier_eval(dst.peak_i, basis)
            peak_c = torch.clamp_min(_fourier_eval(dst.peak_c, basis), 1e-5)
            over = torch.clamp_min(C / torch.clamp_min(Cb, 1e-6) - 1.0, 0.0)
            i_rel = torch.clamp((I - dst.min_luma) * rcp(
                max(dst.max_luma - dst.min_luma, 1e-9)), 0.0, 1.0)
            gamma = c.colorimetric_gamma * (i_rel * i_rel * i_rel) * \
                torch.clamp_max(C / peak_c, 1.0)
            shift = torch.clamp(gamma * over / (1.0 + over), 0.0, 1.0)
            I = fma((peak_i - I) * shift, 0.5, I)
        out = _ich2rgb_dev(I, C_new, cos_h, sin_h, dst)
        return torch.clamp(out, dst.min_rgb, dst.max_rgb) * rcp(to_norm)

    if function == "linear":
        out = _ich2rgb_dev(I, C * _linear_gain(src, dst), cos_h, sin_h, dst)
        return torch.clamp(out, dst.min_rgb, dst.max_rgb) * rcp(to_norm)

    if function == "darken":
        out = _ich2rgb_dev(I, C, cos_h, sin_h, dst) * _darken_gain(src, dst)
        return torch.clamp(out, dst.min_rgb, dst.max_rgb) * rcp(to_norm)

    if function not in ("perceptual", "softclip"):
        raise ValueError(f"unknown gamut operator {function!r}")
    # perceptual / softclip: chroma soft-compression toward the dst
    # boundary, intensity kept (reference softclip_map)
    C_src = _boundary_eval_dev(src, basis, powers_src)
    C_dst = _boundary_eval_dev(dst, basis, powers)
    knee = c.softclip_knee
    if function == "perceptual":
        C_new = _softclip_dev(C, torch.maximum(C_src, C_dst), C_dst, knee)
        C_new = fma(C_new - C, c.perceptual_strength, C)
    else:
        hue = hueshift_fourier(src, dst)
        if hue is not None:
            C_new, cos_h, sin_h = _softclip_hue(
                C, cos_h, sin_h, src, dst, c, (powers_src, powers), C_src,
                C_dst, hue, basis)
        else:
            target = fma(C_dst, 1.0 - c.softclip_desat,
                         torch.minimum(C_dst, C) * c.softclip_desat)
            C_new = _softclip_dev(C, torch.maximum(C_src, C_dst), target,
                                  knee)
    out = _ich2rgb_dev(I, C_new, cos_h, sin_h, dst)
    return _rgb_softclip(out, dst, knee) * rcp(to_norm)


def _colorize_clipping(color, clip_hi, clip_lo):
    """show_clipping's colorization (reference colorspace.c:1997-2010)
    of linear dst RGB: high clips become the saturated complement,
    fading to red for achromatic clips; low clips get a 50% teal
    tint."""
    k = (color[..., 0, :, :] + color[..., 1, :, :] +
         color[..., 2, :, :]) * (2.0 / 3.0)
    comp = torch.clamp(k[..., None, :, :] - color, 0.0, 1.0)
    cmin = torch.amin(comp, dim=-3, keepdim=True)
    cmax = torch.amax(comp, dim=-3, keepdim=True)
    delta = cmax - cmin
    t = torch.clamp((comp - (cmin - 1e-6)) /
                    torch.clamp_min(cmax - (cmin - 1e-6), 1e-9), 0.0, 1.0)
    sat = t * t * fma(t, -2.0, 3.0)
    red = torch.cat([torch.ones_like(color[..., :1, :, :]),
                     torch.zeros_like(color[..., :2, :, :])], dim=-3)
    w = torch.clamp(delta * rcp(0.3), 0.0, 1.0)
    w = w * w * fma(w, -2.0, 3.0)
    hi_color = fma(sat - red, w, red)
    teal = torch.cat([torch.zeros_like(color[..., :1, :, :]),
                      torch.full_like(color[..., :2, :, :], 0.3)], dim=-3)
    lo_color = fma(teal - color, 0.5, color)
    ch = clip_hi[..., None, :, :]
    cl = clip_lo[..., None, :, :]
    return torch.where(ch, hi_color, torch.where(cl, lo_color, color))


def map_gamut(rgb_linear_dst, function: str, src: GamutBoundary,
              dst: GamutBoundary,
              constants: Optional[GamutMapConstants] = None,
              to_norm: float = 1.0):
    """Map linear RGB already in *dst* primaries (NORM units, `to_norm`
    scales them to 10k-normalized) through one gamut operator."""
    c = (constants or GamutMapConstants()).fixed()
    if function in ("clip", "saturation"):
        return torch.clamp(rgb_linear_dst, dst.min_rgb / to_norm,
                           dst.max_rgb / to_norm)
    I, C, cos_h, sin_h = _rgb2ich_dev(rgb_linear_dst * to_norm, dst)
    return _gamut_ich_to_rgb(function, I, C, cos_h, sin_h, src, dst, c,
                             to_norm)


def color_map_ipt(rgb_linear_src, tone_fn, gamut_function: Optional[str],
                  src: GamutBoundary, dst: GamutBoundary,
                  to_norm: float = 1.0,
                  constants: Optional[GamutMapConstants] = None,
                  show_clip_bounds: Optional[Tuple[float, float]] = None):
    """Tone + gamut mapping through one IPT round trip: linear RGB in
    src primaries -> ICh; tone-map I with the cubic-hull chroma
    adjustment (colorspace.c:1930); the gamut operator; linear RGB in
    dst primaries.  `tone_fn` maps PQ intensity -> PQ intensity (None:
    no tone map); `gamut_function` None/"clip"/"saturation" clamps.
    `show_clip_bounds` = (in_min_pq, in_max_pq) colorizes the pixels
    outside the input range (reference show_clipping)."""
    c = (constants or GamutMapConstants()).fixed()
    x = rgb_linear_src * to_norm
    I, C, cos_h, sin_h = _rgb2ich_dev(x, src)
    clip_hi = clip_lo = None
    if show_clip_bounds is not None:
        eps = 1e-6
        in_min_pq, in_max_pq = show_clip_bounds
        hi_lin = float(pq_eotf_fast(torch.tensor(in_max_pq,
                                                 dtype=torch.float32)))
        lo_lin = float(pq_eotf_fast(torch.tensor(in_min_pq,
                                                 dtype=torch.float32)))
        clip_hi = (torch.amax(x, dim=-3) > hi_lin + eps) | \
            (I > in_max_pq + eps)
        clip_lo = (torch.amin(x, dim=-3) < lo_lin - eps) | \
            (I < in_min_pq - eps)
    if tone_fn is not None:
        i_orig = I
        I = tone_fn(I)
        hull_new = fma(I - 6.0, I, 9.0) * I
        hull_old = fma(i_orig - 6.0, i_orig, 9.0) * i_orig
        C = C * torch.minimum(i_orig / torch.clamp_min(I, 1e-6),
                              hull_new / torch.clamp_min(hull_old, 1e-6))
    if gamut_function in (None, "", "none", "clip", "saturation"):
        out = _ich2rgb_dev(I, C, cos_h, sin_h, dst)
        out = torch.clamp(out, dst.min_rgb, dst.max_rgb) * rcp(to_norm)
    else:
        out = _gamut_ich_to_rgb(gamut_function, I, C, cos_h, sin_h, src,
                                dst, c, to_norm)
    if clip_hi is not None:
        out = _colorize_clipping(out, clip_hi, clip_lo)
    return out


def _np_peak_c(b: GamutBoundary, hs: np.ndarray) -> np.ndarray:
    """Host evaluation of the fitted peak chroma at hues hs."""
    coefs = np.asarray(b.peak_c)
    out = np.full_like(hs, coefs[0])
    for k in range(1, HARMONICS + 1):
        out = out + coefs[2 * k - 1] * np.cos(k * hs) \
            + coefs[2 * k] * np.sin(k * hs)
    return np.maximum(out, 1e-6)


@lru_cache(maxsize=16)
def _linear_gain(src: GamutBoundary, dst: GamutBoundary) -> float:
    """Host: the uniform desaturation of `linear`, the worst-case ratio
    of the peak chromas."""
    hs = np.arange(-math.pi, math.pi, 0.1)
    g_src, g_dst = _np_peak_c(src, hs), _np_peak_c(dst, hs)
    return float(np.min(np.minimum(1.0, g_dst / np.maximum(g_src, 1e-9))))


class _Matrices:
    """The matrices of a gamut, all gm._rgb2ipt/_ipt2rgb read."""

    def __init__(self, b: GamutBoundary):
        self.rgb2lms = np.asarray(b.rgb2lms)
        self.lms2rgb = np.asarray(b.lms2rgb)


@lru_cache(maxsize=16)
def _darken_gain(src: GamutBoundary, dst: GamutBoundary) -> float:
    """Host: the reference darken gain over the six RGBCMY corners."""
    X = float(pq_eotf_np(src.max_luma))
    points = np.array([[X, 0, 0], [0, X, 0], [0, 0, X],
                       [0, X, X], [X, 0, X], [X, X, 0]])
    p = gm._ipt2rgb(gm._rgb2ipt(points, _Matrices(src)), _Matrices(dst))
    return float(min(1.0, (1.0 / p.max(axis=-1)).min()))

"""The gamut searches behind the perceptual operator's boundary fits (host
numpy, float64).

Counterpart of libplacebo_tpu/core/gamut_mapping.py (reference
src/gamut_mapping.c), cut to the IPT matrices (Ebner & Fairchild over
PQ-encoded HPE LMS with 4% crosstalk), the constants, the `_Gamut`
helper and the vectorized bisection / golden-section searches for the
boundary chroma and the hue-wise peaks, which ops/gamut.py fits.
Luminances are PQ-encoded; linear RGB is normalized to 10k nits."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .colorspace import (CIE_D65, RawPrimaries, adapt_white_matrix,
                         rgb_to_xyz_matrix)

__all__ = ["GamutMapConstants", "ipt_rgb2lms", "LMS2IPT", "IPT2LMS"]

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


class _Gamut:
    def __init__(self, prim: RawPrimaries, min_luma: float, max_luma: float):
        eps = 1e-6
        self.rgb2lms = ipt_rgb2lms(prim)
        self.lms2rgb = np.linalg.inv(self.rgb2lms)
        self.min_luma = min_luma
        self.max_luma = max_luma
        self.min_rgb = float(_pq_eotf(min_luma)) - eps
        self.max_rgb = float(_pq_eotf(max_luma)) + eps


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

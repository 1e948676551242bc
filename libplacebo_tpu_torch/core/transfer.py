"""Transfer functions on (C, H, W) float32 tensors.

Counterpart of libplacebo_tpu/core/transfer.py (and its exact-division
core/fastmath.py: here every division between tensors is a true IEEE
divide).  Linear values are NORM (1.0 == SDR white).

Constant divisors and multiply-adds round as core/fastmath.py says.
"""
from __future__ import annotations

import numpy as np
import torch

from .colorspace import COLOR_SDR_WHITE, ColorTransfer
from .fastmath import fma, rcp, sqrt

__all__ = ["pow_pos", "pq_eotf", "pq_oetf", "pq_eotf_fast",
           "pq_oetf_fast", "hlg_oetf", "hlg_oetf_inv", "srgb_eotf",
           "srgb_oetf", "linearize", "delinearize", "LOG10",
           "ST428_SCALE"]


def pow_pos(x, p):
    """x**p for non-negative x as exp(p·log x) — the reference's
    formulation (not torch.pow), which decides the low bits."""
    return torch.exp(p * torch.log(torch.clamp_min(x, 1e-36)))


PQ_M1 = 2610.0 / 16384
PQ_M2 = 2523.0 / 4096 * 128
PQ_C1 = 3424.0 / 4096
PQ_C2 = 2413.0 / 4096 * 32
PQ_C3 = 2392.0 / 4096 * 32


def pq_eotf(x):
    """PQ signal [0,1] -> linear [0,1] (1.0 = 10000 nits), exact curve."""
    x = torch.clamp(x, 0.0, 1.0)
    p = pow_pos(x, 1.0 / PQ_M2)
    num = torch.clamp_min(p - PQ_C1, 0.0)
    den = fma(p, -PQ_C3, PQ_C2)
    return pow_pos(num / den, 1.0 / PQ_M1)


def pq_oetf(y):
    """Linear [0,1] -> PQ signal [0,1], exact curve."""
    y = torch.clamp(y, 0.0, 1.0)
    p = pow_pos(y, PQ_M1)
    return pow_pos(fma(p, PQ_C2, PQ_C1) / fma(p, PQ_C3, 1.0), PQ_M2)


# HLG (ARIB STD-B67 / BT.2100): scene-referred, 0..12
HLG_A = 0.17883277
HLG_B = 0.28466892
HLG_C = 0.55991073


def hlg_oetf_inv(x):
    """HLG signal [0, 1] -> scene-linear [0, 12]."""
    x = torch.clamp_min(x, 0.0)
    lo = (x * 4.0) * x
    hi = torch.exp((x - HLG_C) * rcp(HLG_A)) + HLG_B
    return torch.where(x <= 0.5, lo, hi)


def hlg_oetf(y):
    """Scene-linear [0, 12] -> HLG signal [0, 1]."""
    y = torch.clamp_min(y, 0.0)
    lo = sqrt(y) * 0.5
    hi = fma(torch.log(torch.clamp_min(y - HLG_B, 1e-9)), HLG_A, HLG_C)
    return torch.where(y <= 1.0, lo, hi)


def srgb_eotf(x):
    return torch.where(
        x < 0.04045, x * rcp(12.92),
        pow_pos((torch.clamp_min(x, 0.04045) + 0.055) * rcp(1.055), 2.4))


def srgb_oetf(y):
    return torch.where(
        y < 0.0031308, y * 12.92,
        fma(pow_pos(torch.clamp_min(y, 0.0031308), 1.0 / 2.4), 1.055,
            -0.055))


def prophoto_eotf(x):
    return torch.where(x < 0.03125, x * rcp(16.0),
                       pow_pos(torch.clamp_min(x, 0.03125), 1.8))


def prophoto_oetf(y):
    return torch.where(y < 0.001953125, y * 16.0,
                       pow_pos(torch.clamp_min(y, 0.001953125), 1.0 / 1.8))


# 10**t is exp(t * ln 10) (the reference's pow_pos with a constant base,
# whose log XLA folds); log10(x) is log(x) / ln 10, a constant divisor
LOG10 = float(np.float32(np.log(10.0)))
_RCP_LOG10 = rcp(LOG10)
VLOG_B = 0.00873
VLOG_C = 0.241514
VLOG_D = 0.598206


def _exp10(t):
    return torch.exp(t * LOG10)


def _log10(x):
    return torch.log(x) * _RCP_LOG10


def vlog_eotf(x):
    lo = (x - 0.125) * rcp(5.6)
    hi = _exp10((x - VLOG_D) * rcp(VLOG_C)) - VLOG_B
    return torch.where(x < 0.181, lo, hi)


def vlog_oetf(y):
    lo = fma(y, 5.6, 0.125)
    hi = fma(_log10(torch.clamp_min(y + VLOG_B, 1e-9)), VLOG_C, VLOG_D)
    return torch.where(y < 0.01, lo, hi)


def _slog_exp(x):
    return _exp10(((x - 0.616596) - 0.03) * rcp(0.432699))


def slog1_eotf(x):
    return _slog_exp(x) - 0.037584


def slog1_oetf(y):
    return fma(_log10(torch.clamp_min(y + 0.037584, 1e-9)), 0.432699,
               0.616596) + 0.03


_SLOG2_LO = 0.030001222851889303
_SLOG2_SLOPE = 3.53881278538813


def slog2_eotf(x):
    lo = (x - _SLOG2_LO) * rcp(_SLOG2_SLOPE)
    hi = ((_slog_exp(x) - 0.037584) * 219.0) * rcp(155.0)
    return torch.where(x < _SLOG2_LO, lo, hi)


def slog2_oetf(y):
    lo = fma(y, _SLOG2_SLOPE, _SLOG2_LO)
    hi = fma(_log10(torch.clamp_min(fma(y * 155.0, rcp(219.0), 0.037584),
                                    1e-9)), 0.432699, 0.616596) + 0.03
    return torch.where(y < 0.0, lo, hi)


_PURE_GAMMA = {
    ColorTransfer.GAMMA18: 1.8,
    ColorTransfer.GAMMA20: 2.0,
    ColorTransfer.GAMMA22: 2.2,
    ColorTransfer.GAMMA24: 2.4,
    ColorTransfer.GAMMA26: 2.6,
    ColorTransfer.GAMMA28: 2.8,
}
_PQ_SCALE = 10000.0 / COLOR_SDR_WHITE
ST428_SCALE = 52.37 / 48.0          # DCDM constant (SMPTE ST 428-1)
_HLG_PEAK = 12.0 / 3.17955025       # transfer_nominal_peak(HLG)


def linearize(x, trc: ColorTransfer):
    """Signal -> linear light (NORM), without black-point scaling."""
    if trc in (ColorTransfer.LINEAR, ColorTransfer.UNKNOWN,
               ColorTransfer.SCRGB):
        return x
    if trc == ColorTransfer.SRGB:
        return srgb_eotf(x)
    if trc == ColorTransfer.BT_1886:
        return pow_pos(torch.clamp_min(x, 0.0), 2.4)
    if trc in _PURE_GAMMA:
        return pow_pos(torch.clamp_min(x, 0.0), _PURE_GAMMA[trc])
    if trc == ColorTransfer.PRO_PHOTO:
        return prophoto_eotf(x)
    if trc == ColorTransfer.ST428:
        return pow_pos(torch.clamp_min(x, 0.0), 2.6) * ST428_SCALE
    if trc == ColorTransfer.PQ:
        return pq_eotf(x) * _PQ_SCALE
    if trc == ColorTransfer.HLG:
        return hlg_oetf_inv(x) * (_HLG_PEAK / 12.0)
    if trc == ColorTransfer.V_LOG:
        return vlog_eotf(x)
    if trc == ColorTransfer.S_LOG1:
        return slog1_eotf(x)
    if trc == ColorTransfer.S_LOG2:
        return slog2_eotf(x)
    raise ValueError(f"unsupported transfer {trc}")


def delinearize(y, trc: ColorTransfer):
    """Linear light (NORM) -> signal; inverse of `linearize`."""
    if trc in (ColorTransfer.LINEAR, ColorTransfer.UNKNOWN,
               ColorTransfer.SCRGB):
        return y
    if trc == ColorTransfer.SRGB:
        return srgb_oetf(y)
    if trc == ColorTransfer.BT_1886:
        return pow_pos(torch.clamp_min(y, 0.0), 1.0 / 2.4)
    if trc in _PURE_GAMMA:
        return pow_pos(torch.clamp_min(y, 0.0), 1.0 / _PURE_GAMMA[trc])
    if trc == ColorTransfer.PRO_PHOTO:
        return prophoto_oetf(y)
    if trc == ColorTransfer.ST428:
        return pow_pos(torch.clamp_min(y, 0.0) * rcp(ST428_SCALE),
                       1.0 / 2.6)
    if trc == ColorTransfer.PQ:
        return pq_oetf(y * rcp(_PQ_SCALE))
    if trc == ColorTransfer.HLG:
        return hlg_oetf(y * (12.0 / _HLG_PEAK))
    if trc == ColorTransfer.V_LOG:
        return vlog_oetf(y)
    if trc == ColorTransfer.S_LOG1:
        return slog1_oetf(y)
    if trc == ColorTransfer.S_LOG2:
        return slog2_oetf(y)
    raise ValueError(f"unsupported transfer {trc}")


# ---------------------------------------------------------------------------
# Pow-free PQ: repeated square roots plus small polynomials, fitted once
# at import with np.polyfit (deterministic; the coefficients equal the
# reference package's, which a test pins).
# ---------------------------------------------------------------------------

def _fit(xs, ys, deg):
    return np.polyfit(xs, ys, deg).astype(np.float32)


_U_GRID = np.linspace(0.13, 1.0, 4001)
OETF_P_COEF = _fit(_U_GRID, _U_GRID ** (8 * PQ_M1 - 1), 10)
_V_GRID = np.linspace(PQ_C1, (PQ_C1 + PQ_C2) / (1 + PQ_C3), 2001)
OETF_T_COEF = _fit(_V_GRID, _V_GRID ** (PQ_M2 - 78), 4)
_U2_GRID = np.linspace(0.74, 1.0, 4001)
EOTF_P_COEF = _fit(_U2_GRID, _U2_GRID ** (64 / PQ_M2), 6)
_S_GRID = np.linspace(0.0, 1.0, 4001)
EOTF_T_COEF = _fit(_S_GRID, _S_GRID ** (8 * (1 / PQ_M1 - 6)), 8)
# The EOTF's last Horner step p = u*q + c feeds p - C1, which XLA folds
# into u*q + (c - C1) with c - C1 rounded in float32; the product u*q
# then has two uses, so neither sum contracts it into a fused multiply-add
EOTF_P_LAST_M_C1 = float(EOTF_P_COEF[-1] - np.float32(PQ_C1))


def _polyval(coef, x):
    """Horner's rule, one fused multiply-add per coefficient."""
    out = torch.full_like(x, float(coef[0]))
    for c in coef[1:]:
        out = fma(x, out, float(c))
    return out


def pq_oetf_fast(y):
    """Pow-free pq_oetf; |err| < 5e-6 over [1e-7, 1]."""
    y = torch.clamp(y, 1e-7, 1.0)
    u = sqrt(sqrt(sqrt(y)))
    p = u * _polyval(OETF_P_COEF, u)
    v = fma(p, PQ_C2, PQ_C1) / fma(p, PQ_C3, 1.0)
    v2 = v * v
    v4 = v2 * v2
    v8 = v4 * v4
    v16 = v8 * v8
    v32 = v16 * v16
    v64 = v32 * v32
    return v64 * v8 * v4 * v2 * _polyval(OETF_T_COEF, v)


def pq_eotf_fast(x):
    """Pow-free pq_eotf; relative err < 1e-5 over [0, 1]."""
    x = torch.clamp(x, 1e-8, 1.0)
    u = x
    for _ in range(6):
        u = sqrt(u)
    uq = u * _polyval(EOTF_P_COEF[:-1], u)
    p = uq + float(EOTF_P_COEF[-1])
    r = torch.clamp_min(uq + EOTF_P_LAST_M_C1, 0.0) / fma(p, -PQ_C3, PQ_C2)
    s = sqrt(sqrt(sqrt(torch.clamp_min(r, 0.0))))
    r2 = r * r
    return r2 * r2 * r2 * _polyval(EOTF_T_COEF, s)

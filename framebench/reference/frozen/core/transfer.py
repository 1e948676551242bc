"""The pow-free PQ curves on float32 tensors that the tone and gamut
stages use.

Counterpart of libplacebo_tpu/core/transfer.py, cut to `pow_pos` and
the fitted `pq_oetf_fast` / `pq_eotf_fast`.  Constant divisors and
multiply-adds round as core/fastmath.py says."""
from __future__ import annotations

import numpy as np
import torch

from .fastmath import fma, sqrt

__all__ = ["pow_pos", "pq_eotf_fast", "pq_oetf_fast"]


def pow_pos(x, p):
    """x**p for non-negative x as exp(p·log x) — the reference's
    formulation (not torch.pow), which decides the low bits."""
    return torch.exp(p * torch.log(torch.clamp_min(x, 1e-36)))


PQ_M1 = 2610.0 / 16384
PQ_M2 = 2523.0 / 4096 * 128
PQ_C1 = 3424.0 / 4096
PQ_C2 = 2413.0 / 4096 * 32
PQ_C3 = 2392.0 / 4096 * 32


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

"""Custom LUT application (1D LUTs and 3D LUTs) on (3, H, W) tensors.

Counterpart of libplacebo_tpu/ops/lut.py (reference
pl_shader_custom_lut, src/shaders/lut.c:212-330), with the reference's
dispatch: a 1D LUT interpolates linearly per channel; a 3D LUT is
trilinear over its 8 corners (`fast="never"`, and any image under
`_FAST_MIN_PIXELS`), or under `"auto"` at >= 1M pixels the gather-free
low-rank path: a CP decomposition of the table fitted on the host by
ALS, each factor a Chebyshev polynomial, validated within `_CP_TOL` of
the trilinear result (`_cp_plan`; a LUT that does not fit keeps the
exact path).  The reference's one-hot matmuls are a TPU gather
workaround; here the corners are read by direct indexing, the same
function.  The host fits are numpy, seeded as in the reference, so both
packages pick the same rank and coefficients.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.fastmath import fma, rcp
from ..core.lut import CustomLut

__all__ = ["apply_lut"]

_CP_TOL = 1.5e-3        # max abs error allowed for the fast path
_CP_RANKS = (8, 16, 32)
_CP_POLY_DEG = 14
_FAST_MIN_PIXELS = 1 << 20
_CP_CACHE: dict = {}


def _normalized(img, lut: CustomLut):
    """(img - domain_min) / (domain_max - domain_min), the division a
    product with the float32 reciprocal of the constant range."""
    dmin = np.asarray(lut.domain_min, np.float32)
    span = np.asarray(lut.domain_max, np.float32) - dmin
    return [(img[..., c, :, :] - float(dmin[c])) * rcp(float(span[c]))
            for c in range(3)]


def _apply_1d(img, lut: CustomLut):
    """Per-channel 1D LUT, linear interpolation between the two
    neighbouring entries."""
    n = lut.size[0]
    table = torch.from_numpy(np.ascontiguousarray(lut.data)).to(img.device)
    outs = []
    for c, x in enumerate(_normalized(img, lut)):
        t = torch.clamp(x * float(n - 1), 0.0, n - 1.0)
        lo = torch.floor(t)
        frac = t - lo
        lo_i = lo.to(torch.int64)
        hi_i = torch.clamp_max(lo_i + 1, n - 1)
        col = table[:, c]
        lo_v, hi_v = col[lo_i], col[hi_i]
        outs.append(fma(frac, hi_v - lo_v, lo_v))
    return torch.stack(outs, dim=-3)


def _apply_3d(img, lut: CustomLut):
    """Trilinear 3D LUT: the exact 8-corner read of the flattened
    (B, G, R) table."""
    R, G, B = lut.size
    table = torch.from_numpy(np.ascontiguousarray(
        lut.data.reshape(-1, 3))).to(img.device)
    x = _normalized(img, lut)
    pos = [torch.clamp(x[c] * float(n - 1), 0.0, n - 1.0)
           for c, n in enumerate((R, G, B))]
    i0 = [torch.floor(p).to(torch.int64) for p in pos]
    f = [p - i.to(torch.float32) for p, i in zip(pos, i0)]
    i1 = [torch.clamp_max(i + 1, n - 1) for i, n in zip(i0, (R, G, B))]
    (r0, g0, b0), (r1, g1, b1) = i0, i1
    fr, fg, fb = (v[..., None] for v in f)

    def corner(bi, gi, ri):
        return table[(bi * G + gi) * R + ri]            # (..., H, W, 3)

    c00 = fma(fr, corner(b0, g0, r1) - corner(b0, g0, r0),
              corner(b0, g0, r0))
    c01 = fma(fr, corner(b0, g1, r1) - corner(b0, g1, r0),
              corner(b0, g1, r0))
    c10 = fma(fr, corner(b1, g0, r1) - corner(b1, g0, r0),
              corner(b1, g0, r0))
    c11 = fma(fr, corner(b1, g1, r1) - corner(b1, g1, r0),
              corner(b1, g1, r0))
    c0 = fma(fg, c01 - c00, c00)
    c1 = fma(fg, c11 - c10, c10)
    return torch.movedim(fma(fb, c1 - c0, c0), -1, -3)


# ---------------------------------------------------------------------------
# 3D LUT fast path: L[b,g,r,c] ~= sum_s U_c[b,s] V_c[g,s] W_c[r,s] (ALS),
# each factor column a Chebyshev polynomial of its axis; trilinear
# interpolation distributes over the separable terms
# ---------------------------------------------------------------------------

def _kr(A, B):
    """Khatri-Rao (column-wise Kronecker) product."""
    return (A[:, None, :] * B[None, :, :]).reshape(-1, A.shape[1])


def _cp_als(T, rank: int, iters: int = 30, seed: int = 0):
    """ALS CP fit of T (Nb, Ng, Nr) -> U (Nb,S), V (Ng,S), W (Nr,S)."""
    rng = np.random.default_rng(seed)
    Nb, Ng, Nr = T.shape
    U = rng.standard_normal((Nb, rank))
    V = rng.standard_normal((Ng, rank))
    W = rng.standard_normal((Nr, rank))
    T0 = T.reshape(Nb, -1)
    T1 = T.transpose(1, 0, 2).reshape(Ng, -1)
    T2 = T.transpose(2, 0, 1).reshape(Nr, -1)
    eye = np.eye(rank) * 1e-10
    for _ in range(iters):
        U = T0 @ _kr(V, W) @ np.linalg.pinv((V.T @ V) * (W.T @ W) + eye)
        V = T1 @ _kr(U, W) @ np.linalg.pinv((U.T @ U) * (W.T @ W) + eye)
        W = T2 @ _kr(U, V) @ np.linalg.pinv((U.T @ U) * (V.T @ V) + eye)
    return U, V, W


def _cheb_fit(ys: np.ndarray, deg: int):
    """Chebyshev coefficients (deg+1, S) of each column of ys (N, S),
    fitted to its piecewise-linear interpolant on a dense grid over
    [0, 1] (the target of trilinear filtering between nodes)."""
    N = ys.shape[0]
    deg = min(deg, max(3, (3 * N) // 4))
    x = np.linspace(0.0, 1.0, N)
    xd = np.linspace(0.0, 1.0, 8 * N)
    yd = np.stack([np.interp(xd, x, ys[:, s])
                   for s in range(ys.shape[1])], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.RankWarning)
        return np.polynomial.chebyshev.chebfit(2 * xd - 1, yd, deg)


def _cp_validate(data, chans, size_bgr):
    """Max abs error of the polynomial CP form against exact trilinear
    interpolation on a 2x-oversampled grid (float64)."""
    B, G, R = size_bgr

    def lerp_axis(T, x, n, axis):
        pos = x * (n - 1)
        i0 = np.clip(np.floor(pos).astype(int), 0, n - 1)
        i1 = np.minimum(i0 + 1, n - 1)
        f = (pos - i0).reshape([-1 if a == axis else 1
                                for a in range(T.ndim)])
        lo = np.take(T, i0, axis=axis)
        hi = np.take(T, i1, axis=axis)
        return lo + (hi - lo) * f

    def cheb(coef, x):
        return np.polynomial.chebyshev.chebval(2 * x - 1, coef)

    xb, xg, xr = (np.linspace(0.0, 1.0, 2 * n - 1) for n in (B, G, R))
    worst = 0.0
    for c in range(3):
        T = data[..., c]
        ref = lerp_axis(lerp_axis(lerp_axis(T, xb, B, 0), xg, G, 1),
                        xr, R, 2)
        cu, cv, cw = chans[c]
        rec = np.einsum("sb,sg,sr->bgr", cheb(cu, xb), cheb(cv, xg),
                        cheb(cw, xr))
        worst = max(worst, float(np.abs(rec - ref).max()))
    return worst


def _cp_plan(lut: CustomLut):
    """Host: the fast path's per-channel (cu, cv, cw) Chebyshev
    coefficients and its validated error, or None (cached by the LUT's
    signature)."""
    key = lut.signature
    if key in _CP_CACHE:
        return _CP_CACHE[key]
    R, G, B = lut.size
    data = np.asarray(lut.data, np.float64)         # (B, G, R, 3)
    plan = None
    for rank in _CP_RANKS:
        chans = []
        for c in range(3):
            U, V, W = _cp_als(data[..., c], rank, seed=c)
            chans.append((_cheb_fit(U, _CP_POLY_DEG),
                          _cheb_fit(V, _CP_POLY_DEG),
                          _cheb_fit(W, _CP_POLY_DEG)))
        err = _cp_validate(data, chans, (B, G, R))
        if err <= _CP_TOL:
            plan = (chans, err)
            break
    _CP_CACHE[key] = plan
    return plan


def _cheb_eval(coef: np.ndarray, x):
    """Clenshaw evaluation of (D+1, S) Chebyshev coefficients at x in
    [0, 1]: (..., S) values, rounding as the reference's jitted form."""
    c = torch.from_numpy(np.asarray(coef, np.float32)).to(x.device)
    t = (fma(x, 2.0, -1.0) * 2.0)[..., None]
    b0 = torch.zeros(x.shape + (c.shape[1],), dtype=x.dtype, device=x.device)
    b1 = b0
    for k in range(c.shape[0] - 1, 0, -1):
        b0, b1 = torch.addcmul(-b1, t, b0) + c[k], b0
    return torch.addcmul(-b1, t * 0.5, b0) + c[0]


def _apply_3d_cp(img, lut: CustomLut, chans):
    """The low-rank path: per output channel, sum_s u_s(b) v_s(g) w_s(r)
    with no gathers."""
    r, g, b = (torch.clamp(v, 0.0, 1.0) for v in _normalized(img, lut))
    outs = []
    for c in range(3):
        cu, cv, cw = chans[c]
        u, v, w = _cheb_eval(cu, b), _cheb_eval(cv, g), _cheb_eval(cw, r)
        outs.append(torch.sum(u * v * w, dim=-1))
    return torch.stack(outs, dim=-3)


def apply_lut(img, lut: CustomLut, fast: str = "auto"):
    """Apply a custom LUT to a (..., 3, H, W) image.  `fast`: "auto" takes
    the low-rank path for a 3D LUT on >= 1M pixels when its host fit is
    within _CP_TOL; "never" forces the 8-corner path; "always" forces
    the low-rank path (raises if the LUT does not fit)."""
    if lut.is_3d:
        pixels = img.shape[-1] * img.shape[-2]
        if fast == "always" or (fast == "auto"
                                and pixels >= _FAST_MIN_PIXELS):
            plan = _cp_plan(lut)
            if plan is not None:
                return _apply_3d_cp(img, lut, plan[0])
            if fast == "always":
                raise ValueError("LUT does not admit the CP fast path "
                                 f"within tol={_CP_TOL}")
        return _apply_3d(img, lut)
    return _apply_1d(img, lut)

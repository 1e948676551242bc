"""Dolby Vision reshaping (RPU polynomial / MMR).

Counterpart of libplacebo_tpu/ops/dovi.py (the reference's
pl_shader_dovi_reshape, src/shaders/colorspace.c:106-260): per-component
piecewise reshaping with up to 8 segments, each a quadratic polynomial
or an MMR (multivariate multiple regression) expansion of order <= 3
over the (Y, Cb, Cr) triple, selected by pivot.

A stream carries a new RPU every frame, so the coefficients are never
part of the render plan: `pack_dovi` packs them on the host each frame
and `dovi_reshape_packed` evaluates the frame's own segments, its
coefficients passed as float32 Python scalars (no upload, no wait).
The arithmetic is the reference's jitted `dovi_reshape_packed`: every
product fused into its sum (`fma`), zero coefficients kept, powers as
repeated products, the signal clipped to [0, 1] even for a component
without segments.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.colorspace import DoviMetadata
from ..core.fastmath import fma

__all__ = ["DoviPacked", "pack_dovi", "dovi_reshape", "dovi_reshape_packed",
           "dovi_offset"]


def _get(comp, key):
    return comp[key] if isinstance(comp, dict) else getattr(comp, key)


def _f32(v) -> float:
    return float(np.float32(v))


def _mmr_eval(sig, const: float, coeffs, order: int):
    """MMR expansion (reference reshape_mmr, colorspace.c:52-98): per
    order j, coeffs[j] = [c_x, c_y, c_z, c_xy, c_xz, c_yz, c_xyz] on the
    j-th powers, each product fused into the running sum."""
    sx, sy, sz = sig
    xy, xz, yz = sx * sy, sx * sz, sy * sz
    bases = [(sx, sy, sz, xy, xz, yz, xy * sz)]
    if order >= 2:
        bases.append(tuple(b * b for b in bases[0]))
    if order >= 3:
        bases.append(tuple((b * b) * b for b in bases[0]))
    s = torch.full_like(sx, const)
    for row, powers in zip(coeffs, bases):
        for c, b in zip(row, powers):
            s = fma(b, _f32(c), s)
    return s


def dovi_reshape(img, dovi: Optional[DoviMetadata]):
    """Apply DV reshaping to (..., 3, H, W) base-layer signal values in
    [0, 1] (the reference's structured `dovi_reshape`: the same values as
    `dovi_reshape_packed`)."""
    if dovi is None or not dovi.comp:
        return img
    return dovi_reshape_packed(img, pack_dovi(dovi))


class DoviPacked(NamedTuple):
    """One RPU's reshaping and matrices as host float32 / int32 arrays
    (the reference's DoviPacked layout)."""
    nonlinear: np.ndarray      # (3, 3) YCC->RGB matrix (pre-PQ)
    nonlinear_off: np.ndarray  # (3,)
    linear: np.ndarray         # (3, 3) LMS->RGB matrix (post-PQ)
    pivots: np.ndarray         # (3, 9), padded with 1e9
    nseg: np.ndarray           # (3,) number of segments
    method: np.ndarray         # (3, 8) 0 poly / 1 mmr
    poly: np.ndarray           # (3, 8, 3)
    mmr_const: np.ndarray      # (3, 8)
    mmr_order: np.ndarray      # (3, 8)
    mmr: np.ndarray            # (3, 8, 3, 7)
    lo: np.ndarray             # (3,) clamp bounds
    hi: np.ndarray             # (3,)


def pack_dovi(dovi: DoviMetadata) -> DoviPacked:
    """Host: pack an RPU's reshape data and matrices (reference
    pack_dovi, ops/dovi.py:87-133)."""
    nonlinear = np.asarray(dovi.nonlinear, np.float32).reshape(3, 3) \
        if dovi.nonlinear else np.eye(3, dtype=np.float32)
    nl_off = np.asarray(dovi.nonlinear_offset, np.float32)
    linear = np.asarray(dovi.linear, np.float32).reshape(3, 3) \
        if dovi.linear else np.eye(3, dtype=np.float32)
    pivots = np.full((3, 9), 1e9, np.float32)
    nseg = np.zeros(3, np.int32)
    method = np.zeros((3, 8), np.int32)
    poly = np.zeros((3, 8, 3), np.float32)
    mmr_const = np.zeros((3, 8), np.float32)
    mmr_order = np.ones((3, 8), np.int32)
    mmr = np.zeros((3, 8, 3, 7), np.float32)
    lo = np.zeros(3, np.float32)
    hi = np.ones(3, np.float32)
    for c in range(3):
        comp = dovi.comp[c]
        n = int(_get(comp, "num_pivots"))
        if n < 2:
            continue
        nseg[c] = n - 1
        pivots[c, :n] = np.asarray(_get(comp, "pivots")[:n], np.float32)
        lo[c] = pivots[c, 0]
        hi[c] = pivots[c, n - 1]
        for i in range(n - 1):
            method[c, i] = int(_get(comp, "method")[i])
            if method[c, i] == 0:
                poly[c, i] = np.asarray(_get(comp, "poly_coeffs")[i],
                                        np.float32)
            else:
                mmr_const[c, i] = float(_get(comp, "mmr_constant")[i])
                mmr_order[c, i] = int(_get(comp, "mmr_order")[i])
                coeffs = np.asarray(_get(comp, "mmr_coeffs")[i], np.float32)
                mmr[c, i, :coeffs.shape[0]] = coeffs
    return DoviPacked(nonlinear, nl_off, linear, pivots, nseg, method, poly,
                      mmr_const, mmr_order, mmr, lo, hi)


def dovi_reshape_packed(img, packed: DoviPacked):
    """The renderer's DV reshape of (..., 3, H, W) signal values with one
    frame's packed RPU (reference dovi_reshape_packed, ops/dovi.py:
    160-196): the same values, evaluating only the frame's segments."""
    sig = torch.clamp(img, 0.0, 1.0)
    chans = tuple(sig[..., c, :, :] for c in range(3))
    out = []
    for c in range(3):
        s = chans[c]
        n = int(packed.nseg[c])
        if n == 0:
            out.append(s)
            continue
        acc = None
        for i in range(n):
            if packed.method[c, i] == 0:
                p = packed.poly[c, i]
                seg = fma(s, fma(s, _f32(p[2]), _f32(p[1])), _f32(p[0]))
            else:
                order = int(packed.mmr_order[c, i])
                seg = _mmr_eval(chans, _f32(packed.mmr_const[c, i]),
                                packed.mmr[c, i, :order], order)
            acc = seg if acc is None else torch.where(
                s >= _f32(packed.pivots[c, i]), seg, acc)
        out.append(torch.clamp(acc, _f32(packed.lo[c]),
                               _f32(packed.hi[c])))
    return torch.stack(out, dim=-3)


def dovi_offset(packed: DoviPacked) -> np.ndarray:
    """nonlinear @ nonlinear_off in float32, each product fused into the
    running sum (the reference computes it on the device)."""
    m = packed.nonlinear.astype(np.float64)
    o = packed.nonlinear_off.astype(np.float64)
    out = np.zeros(3, np.float32)
    for r in range(3):
        acc = np.float32(m[r, 0] * o[0])
        for k in (1, 2):
            acc = np.float32(m[r, k] * o[k] + np.float64(acc))
        out[r] = acc
    return out

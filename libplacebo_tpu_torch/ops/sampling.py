"""Separable (orthogonal) resampling and the direct samplers.

Counterpart of libplacebo_tpu/ops/sampling.py.  `sample_ortho`
resamples one axis with the reference's dispatch:
  * "phased": when consecutive outputs of one phase read source taps
    exactly one texel apart with identical weights (2:1, 3:2, ...), each
    (phase, tap) is a contiguous slice times a host-computed float32
    weight, summed in tap order, and the phases interleave once;
  * otherwise "gather" along H (a row gather a tap, times the per-output
    weight) and "matmul" along W (a dense (dst, src) banded matrix,
    float32 with TF32 off).
Weights are exact per output position, computed on the host in float64
(`ortho_weights`, cached).  Anti-ringing clamps each output toward the
[min, max] of its two central taps, only when upscaling along the axis
and only for filters with negative lobes (sampling.c:1061-1099).
`sample_nearest`, `sample_bilinear` and `sample_oversample` are the
reference's direct samplers (sampling.c:277-436).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import filters as flt
from ..core.common import RectF
from ..core.fastmath import tap_sum

__all__ = ["ortho_weights", "sample_ortho", "resize_separable",
           "sample_nearest", "sample_bilinear", "sample_oversample"]

_MAX_ORTHO_PHASES = 8


@lru_cache(maxsize=256)
def _ortho_weights(cfg: flt.FilterConfig, src_size: int, dst_size: int,
                   s0: float, s1: float) -> Tuple[np.ndarray, np.ndarray]:
    scale = (s1 - s0) / dst_size
    f_scale = max(1.0, scale)
    radius, _ = flt.filter_cutoffs(cfg, 0.0)
    taps = max(2, 2 * int(math.ceil(radius * f_scale)))
    o = np.arange(dst_size, dtype=np.float64)
    center = s0 + (o + 0.5) * scale - 0.5
    base = np.floor(center).astype(np.int64) - (taps // 2 - 1)
    idx = base[:, None] + np.arange(taps)[None, :]
    w = flt.sample_filter(cfg, (center[:, None] - idx) / f_scale)
    wsum = w.sum(axis=1, keepdims=True)
    # all-zero rows (degenerate configs) fall back to nearest
    bad = np.abs(wsum[:, 0]) < 1e-12
    if bad.any():
        w[bad] = 0.0
        nearest = np.clip(np.round(center[bad]).astype(np.int64) - base[bad],
                          0, taps - 1)
        w[np.nonzero(bad)[0], nearest] = 1.0
        wsum = w.sum(axis=1, keepdims=True)
    w = w / wsum
    idx = np.clip(idx, 0, src_size - 1)
    return idx.astype(np.int32), w.astype(np.float32)


def ortho_weights(cfg: flt.FilterConfig, src_size: int, dst_size: int,
                  s0: float = 0.0, s1: Optional[float] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(idx (dst, T) int32, w (dst, T) float32) mapping source pixels
    [s0, s1) onto [0, dst); rows normalized, indices edge-clamped."""
    if s1 is None:
        s1 = float(src_size)
    return _ortho_weights(cfg, src_size, dst_size, float(s0), float(s1))


@lru_cache(maxsize=64)
def _device_weights(cfg, src_size, dst_size, s0, s1, device, dense: bool):
    """ortho_weights on `device` once: the (T, dst) indices and weights,
    or the dense (dst, src) matrix."""
    idx, w = _ortho_weights(cfg, src_size, dst_size, s0, s1)
    if dense:
        m = np.zeros((dst_size, src_size), dtype=np.float32)
        np.add.at(m, (np.arange(dst_size)[:, None], idx), w)
        return torch.from_numpy(m).to(device)
    return (torch.from_numpy(idx.T.astype(np.int64).copy()).to(device),
            torch.from_numpy(w.T.copy()).to(device))


def _ar_mix(out, lo, hi, strength: float):
    """The reference's anti-ringing blend (sampling.c:1099):
    ca = mix(ca, clamp(ca, lo, hi), antiring)."""
    return out + strength * (torch.minimum(torch.maximum(out, lo), hi) - out)


def _central(c0, c1):
    return torch.minimum(c0, c1), torch.maximum(c0, c1)


def _apply_gather(img, key, antiring: float = 0.0):
    """Banded weighted sum along H: a row gather a tap, times the
    per-output weight, in tap order; anti-ringing reads the two central
    taps' rows."""
    idx, w = _device_weights(*key, img.device, False)
    taps = idx.shape[0]
    out = c0 = c1 = None
    for t in range(taps):
        rows = img.index_select(-2, idx[t])              # (..., dst, W)
        if t == taps // 2 - 1:
            c0 = rows
        elif t == taps // 2:
            c1 = rows
        term = rows * w[t][:, None]
        out = term if out is None else out + term
    if antiring > 0.0:
        out = _ar_mix(out, *_central(c0, c1), antiring)
    return out


def _apply_matmul(img, key, axis: int, antiring: float = 0.0):
    """Banded weighted sum as a dense (dst, src) float32 product (TF32
    off); anti-ringing selects the two central taps (min and max are not
    linear, so they cannot ride the product) by index, the exact
    selection the reference's one-hot products make."""
    m = _device_weights(*key, img.device, True)
    if axis == -1:
        out = torch.matmul(img, m.t())
    else:
        out = torch.matmul(m, img)
    if antiring > 0.0:
        idx, _ = _device_weights(*key, img.device, False)
        taps = idx.shape[0]
        c0 = img.index_select(axis, idx[taps // 2 - 1])
        c1 = img.index_select(axis, idx[taps // 2])
        out = _ar_mix(out, *_central(c0, c1), antiring)
    return out


@lru_cache(maxsize=256)
def _phase_plan(cfg: flt.FilterConfig, src_size: int, dst_size: int,
                s0: float, s1: float):
    """(period, taps, [(base, weights (T,))]) of a periodic unit-stride
    tap pattern, or None; planned once per geometry."""
    scale = (s1 - s0) / dst_size
    f_scale = max(1.0, scale)
    radius, _ = flt.filter_cutoffs(cfg, 0.0)
    taps = max(2, 2 * int(math.ceil(radius * f_scale)))
    o = np.arange(dst_size, dtype=np.float64)
    center = s0 + (o + 0.5) * scale - 0.5
    base = np.floor(center).astype(np.int64) - (taps // 2 - 1)
    frac = center - np.floor(center)
    for P in range(1, min(_MAX_ORTHO_PHASES, dst_size) + 1):
        if dst_size % P or len(base) <= P:
            continue
        if not (np.all(base[P:] - base[:-P] == 1) and
                np.abs(frac[P:] - frac[:-P]).max() < 1e-9):
            continue
        phases = []
        for p in range(P):
            dist = (center[p] - (base[p] + np.arange(taps))) / f_scale
            w = flt.sample_filter(cfg, dist)
            wsum = w.sum()
            if abs(wsum) < 1e-12:
                return None
            phases.append((int(base[p]), (w / wsum).astype(np.float32)))
        return P, taps, phases
    return None


def _edge_pad(img, axis: int, lo: int, hi: int):
    """Replicate the border along H (axis -2) or W (axis -1)."""
    pad = (lo, hi, 0, 0) if axis == -1 else (0, 0, lo, hi)
    y = F.pad(img.reshape((-1,) + tuple(img.shape[-3:])), pad,
              mode="replicate")
    return y.reshape(tuple(img.shape[:-2]) + tuple(y.shape[-2:]))


def _apply_phased(img, axis: int, dst_size: int, src_size: int, plan,
                  antiring: float = 0.0):
    """Phase-sliced unit-stride tap sums along `axis` (-1 or -2); the
    edge padding equals the gather and matmul paths' clamped indices.
    Anti-ringing's two central taps are slices of the same padding."""
    P, taps, phases = plan
    n = dst_size // P
    lo = max(0, -min(b for b, _ in phases))
    hi = max(0, max(b for b, _ in phases) + taps - 1 + (n - 1)
             - (src_size - 1))
    imgp = _edge_pad(img, axis, lo, hi)
    outs = []
    for base, wts in phases:
        b = base + lo
        ts = [t for t in range(taps) if wts[t] != 0.0]
        acc = tap_sum([imgp.narrow(axis, b + t, n) for t in ts],
                      [float(wts[t]) for t in ts])
        if antiring > 0.0:
            acc = _ar_mix(acc, *_central(
                imgp.narrow(axis, b + taps // 2 - 1, n),
                imgp.narrow(axis, b + taps // 2, n)), antiring)
        outs.append(acc)
    if axis == -1:
        st = torch.stack(outs, dim=-1)        # (..., H, n, P)
        return st.reshape(*st.shape[:-2], n * P)
    st = torch.stack(outs, dim=-2)            # (..., n, P, W)
    return st.reshape(*st.shape[:-3], n * P, st.shape[-1])


def sample_ortho(img, cfg: flt.FilterConfig, dst_size: int, axis: int,
                 s0: float = 0.0, s1: Optional[float] = None,
                 mode: str = "auto", antiring: float = 0.0):
    """Resample one axis (-2 = H, -1 = W) of (..., H, W) images
    (reference pl_shader_sample_ortho2, sampling.c:950).  Like the
    reference, anti-ringing applies only when upscaling along the axis
    and only for filters with negative lobes (an all-positive kernel
    cannot ring)."""
    axis = axis - img.ndim if axis >= 0 else axis
    src_size = img.shape[axis]
    if s1 is None:
        s1 = float(src_size)
    s0, s1 = float(s0), float(s1)
    if antiring > 0.0 and not (dst_size > (s1 - s0)):
        antiring = 0.0                  # a downscale pass: no ringing
    if mode == "auto":
        plan = _phase_plan(cfg, src_size, dst_size, s0, s1)
        if plan is not None:
            if antiring > 0.0 and not any(
                    w.min() < 0.0 for _, w in plan[2]):
                antiring = 0.0          # no negative lobes
            return _apply_phased(img, axis, dst_size, src_size, plan,
                                 antiring)
        mode = "gather" if axis == -2 else "matmul"
    key = (cfg, src_size, dst_size, s0, s1)
    if antiring > 0.0 and _ortho_weights(*key)[1].min() >= 0.0:
        antiring = 0.0                  # no negative lobes
    if mode == "gather" and axis == -1:
        # gather along W: transpose, gather rows, transpose back
        out = _apply_gather(img.transpose(-1, -2), key, antiring)
        return out.transpose(-1, -2)
    if mode == "gather":
        return _apply_gather(img, key, antiring)
    return _apply_matmul(img, key, axis, antiring)


def resize_separable(img, dst_h: int, dst_w: int, cfg: flt.FilterConfig,
                     rect: Optional[RectF] = None,
                     cfg_down: Optional[flt.FilterConfig] = None,
                     mode: str = "auto", antiring: float = 0.0):
    """2D separable resize of (..., C, H, W); `rect` crops the source in
    pixel coordinates (may be fractional), `cfg_down` overrides the
    filter on downscaled axes, `antiring` is each upscaling pass's
    anti-ringing strength (sample_ortho gates it)."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    r = rect or RectF(0, 0, src_w, src_h)

    def cfg_for(axis_scale):
        if cfg_down is not None and axis_scale > 1.0:
            return cfg_down
        return cfg

    sy = (r.y1 - r.y0) / dst_h
    sx = (r.x1 - r.x0) / dst_w
    cy, cx = cfg_for(sy), cfg_for(sx)
    # do the pass that shrinks the intermediate most first
    if dst_h * src_w <= src_h * dst_w:
        out = sample_ortho(img, cy, dst_h, -2, r.y0, r.y1, mode, antiring)
        return sample_ortho(out, cx, dst_w, -1, r.x0, r.x1, mode, antiring)
    out = sample_ortho(img, cx, dst_w, -1, r.x0, r.x1, mode, antiring)
    return sample_ortho(out, cy, dst_h, -2, r.y0, r.y1, mode, antiring)


# ---------------------------------------------------------------------------
# Direct samplers (reference sampling.c:277-436)
# ---------------------------------------------------------------------------

def _axis_positions(dst_size, s0, s1):
    o = np.arange(dst_size, dtype=np.float64)
    return s0 + (o + 0.5) * ((s1 - s0) / dst_size)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).to(device)


def sample_nearest(img, dst_h: int, dst_w: int,
                   rect: Optional[RectF] = None):
    """Nearest-neighbor resize (reference PL_TEX_SAMPLE_NEAREST path)."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    r = rect or RectF(0, 0, src_w, src_h)
    ys = np.clip(np.floor(_axis_positions(dst_h, r.y0, r.y1)), 0, src_h - 1)
    xs = np.clip(np.floor(_axis_positions(dst_w, r.x0, r.x1)), 0, src_w - 1)
    out = img.index_select(-2, _index(ys, img.device))
    return out.index_select(-1, _index(xs, img.device))


def sample_bilinear(img, dst_h: int, dst_w: int,
                    rect: Optional[RectF] = None):
    """Bilinear resize == separable triangle filter."""
    return resize_separable(img, dst_h, dst_w,
                            flt.find_filter_config("bilinear"), rect)


def sample_oversample(img, dst_h: int, dst_w: int,
                      rect: Optional[RectF] = None, threshold: float = 0.0):
    """Aspect-preserving nearest with edge blending (reference
    pl_shader_sample_oversample, sampling.c:436): like nearest, but pixels
    straddling a source-texel boundary are linearly interpolated; with
    `threshold`, near-integer coverage snaps to nearest."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    r = rect or RectF(0, 0, src_w, src_h)

    def coeffs(src_size, dst_size, a0, a1):
        pos = _axis_positions(dst_size, a0, a1)
        scale = (a1 - a0) / dst_size
        center = pos - 0.5
        lo = np.floor(center).astype(np.int64)
        frac = center - lo
        # fraction of the output pixel covered by the upper texel
        w_hi = np.clip((frac - 0.5) / max(scale, 1e-9) + 0.5, 0.0, 1.0) \
            if scale < 1 else frac
        if threshold > 0:
            w_hi = np.where(w_hi < threshold, 0.0, w_hi)
            w_hi = np.where(w_hi > 1 - threshold, 1.0, w_hi)
        return (_index(np.clip(lo, 0, src_size - 1), img.device),
                _index(np.clip(lo + 1, 0, src_size - 1), img.device),
                torch.from_numpy(w_hi.astype(np.float32)).to(img.device))

    y0, y1, wy = coeffs(src_h, dst_h, r.y0, r.y1)
    x0, x1, wx = coeffs(src_w, dst_w, r.x0, r.x1)
    wy = wy[:, None]
    rows = img.index_select(-2, y0) * (1 - wy) + \
        img.index_select(-2, y1) * wy
    return rows.index_select(-1, x0) * (1 - wx) + \
        rows.index_select(-1, x1) * wx

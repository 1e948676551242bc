"""Polar (EWA) resampling.

Counterpart of libplacebo_tpu/ops/polar.py, with its dispatch
(`sample_polar`): periodic scales (both axes repeat their tap pattern
within `_MAX_PHASES` outputs) take the direct path for pure upscales
with at most 4 phases, source stride 1 and no anti-ringing, else the
phased path; every other scale takes the gather path.

Direct and phased.  The host plans each phase's (taps x taps) radial
weights in float64, exactly as the reference does.  On the device the
phase sums are one grouped `conv2d` of the edge-padded source (one
output channel per phase, every phase's window placed in a common
kernel footprint, strided by the axes' source stride; TF32 is off) and
one interleave of the phases: the reference's strided-slice sum in
another summation order (a recorded rounding divergence, ROADMAP §3).
Anti-ringing reads only the taps inside the main lobe (`radius_zero`,
4 taps a phase at 2x): they are stacked in one copy, (taps, phases, C,
Hp, Wp), so the soft extrema take a fixed number of launches whatever
the phase count (about 45 a frame at 2x: 16 for the tap-by-tap sums).

Gather.  Each output reads its own (taps x taps) window through index
gathers, its weights through the reference's 256-entry radial LUT
(`jnp.interp`, reproduced by `_interp`).  Anti-ringing needs every
tap's value after the taps' extrema are known: a second walk over the
taps gathers them again and accumulates the soft sums as it goes, so
the memory held stays a few frames whatever the tap count.

Anti-ringing follows the reference (sampling.c:524-554, with its
scaled softmax for values outside [0, 1]): `_soft_extrema` and
`_apply_ar`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import filters as flt
from ..core.common import RectF
from ..core.fastmath import sqrt as fsqrt

__all__ = ["sample_polar", "plan_polar", "polar_weights"]

SCALER_LUT_SIZE = 256
SCALER_LUT_CUTOFF = 1e-3
_MAX_PHASES = 16


@dataclass(frozen=True)
class _AxisPlan:
    base: np.ndarray       # (dst,) int64: leftmost tap source index
    frac: np.ndarray       # (dst,) float64: src position - (base + 0.5)
    period: int            # 0 if aperiodic, else phase count
    stride: int            # source step per period (valid if periodic)


def _plan_axis(src_size: int, dst_size: int, s0: float, s1: float,
               taps: int) -> _AxisPlan:
    scale = (s1 - s0) / dst_size
    o = np.arange(dst_size, dtype=np.float64)
    center = s0 + (o + 0.5) * scale - 0.5
    base = np.floor(center).astype(np.int64) - (taps // 2 - 1)
    frac = center - np.floor(center)
    period, stride = 0, 0
    for P in range(1, min(_MAX_PHASES, dst_size) + 1):
        d_base = base[P:] - base[:-P]
        d_frac = frac[P:] - frac[:-P]
        if len(d_base) == 0:
            period, stride = dst_size, 0
            break
        if np.all(np.abs(d_frac) < 1e-9) and np.all(d_base == d_base[0]):
            period, stride = P, int(d_base[0])
            break
    return _AxisPlan(base, frac, period, stride)


def plan_polar(cfg: flt.FilterConfig, src_h: int, src_w: int,
               dst_h: int, dst_w: int, rect: RectF):
    """Host-side plan: tap geometry and per-axis phase structure."""
    sy = (rect.y1 - rect.y0) / dst_h
    sx = (rect.x1 - rect.x0) / dst_w
    f = max(1.0, sy, sx)
    radius, radius_zero = flt.filter_cutoffs(cfg, SCALER_LUT_CUTOFF)
    taps = 2 * int(math.ceil(radius * f))
    return dict(f=f, radius=radius, radius_zero=radius_zero, taps=taps,
                plan_y=_plan_axis(src_h, dst_h, rect.y0, rect.y1, taps),
                plan_x=_plan_axis(src_w, dst_w, rect.x0, rect.x1, taps))


def _route(plan, dst_h: int, dst_w: int, antiring: float) -> str:
    """The reference's dispatch (sample_polar): "direct", "phased" or
    "gather"."""
    py, px = plan["plan_y"], plan["plan_x"]
    if (py.period and px.period and py.period <= _MAX_PHASES
            and px.period <= _MAX_PHASES
            and dst_h % py.period == 0 and dst_w % px.period == 0):
        if (antiring == 0.0 and py.stride == 1 and px.stride == 1
                and py.period * px.period <= 4):
            return "direct"
        return "phased"
    return "gather"


def _phase_distances(plan, phy: int, phx: int) -> np.ndarray:
    """(taps, taps) float64 distances of one phase's taps, in source
    pixels over the kernel's widening."""
    py, px = plan["plan_y"], plan["plan_x"]
    taps, f = plan["taps"], plan["f"]
    c0 = taps // 2 - 1
    dy = (np.arange(taps) - c0 - py.frac[phy]) / f
    dx = (np.arange(taps) - c0 - px.frac[phx]) / f
    return np.sqrt(dy[:, None] ** 2 + dx[None, :] ** 2)


def polar_weights(cfg: flt.FilterConfig, plan, phy: int, phx: int
                  ) -> np.ndarray:
    """(taps, taps) float32 weights of one output phase, normalized."""
    d = _phase_distances(plan, phy, phx)
    w = flt.sample_filter(cfg, d)
    w = np.where(d <= plan["radius"], w, 0.0)
    return (w / w.sum()).astype(np.float32)


@dataclass(frozen=True)
class _PhasePlan:
    """The direct and phased paths' host plan of one geometry."""
    Py: int
    Px: int
    sy: int                 # source stride of a phase's outputs
    sx: int
    pad: tuple              # edge padding (left, right, top, bottom)
    oy: int                 # the common tap footprint in the padded source
    ox: int
    wk: np.ndarray          # (Py*Px, ky, kx) float32 phase kernels
    ar_pos: np.ndarray      # (T, Py*Px, 2) int64 footprint offsets of the
                            # main-lobe taps of each phase, tap order
    ar_w: np.ndarray        # (T, Py*Px) float32 their weights (0 = padding)


@lru_cache(maxsize=64)
def _phase_plan(cfg: flt.FilterConfig, src_h: int, src_w: int, dst_h: int,
                dst_w: int, rect: RectF, antiring: float):
    """Host plan of the direct or phased path, once per geometry; None
    where the reference takes its gather path."""
    plan = plan_polar(cfg, src_h, src_w, dst_h, dst_w, rect)
    route = _route(plan, dst_h, dst_w, antiring)
    if route == "gather":
        return None
    py, px, taps = plan["plan_y"], plan["plan_x"], plan["taps"]
    pad = (max(0, -int(px.base.min())),
           max(0, int(px.base.max()) + taps - src_w),
           max(0, -int(py.base.min())),
           max(0, int(py.base.max()) + taps - src_h))
    # every phase's (taps x taps) window placed in one common footprint
    y0s = [int(py.base[p]) + pad[2] for p in range(py.period)]
    x0s = [int(px.base[p]) + pad[0] for p in range(px.period)]
    oy, ox = min(y0s), min(x0s)
    P = py.period * px.period
    wk = np.zeros((P, taps + max(y0s) - oy, taps + max(x0s) - ox),
                  np.float32)
    lobes = []
    for phy, y0 in enumerate(y0s):
        for phx, x0 in enumerate(x0s):
            w = polar_weights(cfg, plan, phy, phx)
            wk[phy * px.period + phx, y0 - oy:y0 - oy + taps,
               x0 - ox:x0 - ox + taps] = w
            # anti-ringing's taps: nonzero weights inside the main lobe,
            # row by row as the reference walks them
            d = _phase_distances(plan, phy, phx)
            lobes.append([(y0 - oy + iy, x0 - ox + ix, w[iy, ix])
                          for iy in range(taps) for ix in range(taps)
                          if w[iy, ix] != 0.0
                          and d[iy, ix] <= plan["radius_zero"]])
    T = max(1, max(len(lobe) for lobe in lobes))
    ar_pos = np.zeros((T, P, 2), np.int64)
    ar_w = np.zeros((T, P), np.float32)
    for p, lobe in enumerate(lobes):
        # padding repeats a tap at weight 0: it moves neither extremum
        # nor any sum (a phase without main-lobe taps gets no weight,
        # so its bounds open and anti-ringing leaves it as it is)
        first = lobe[0][:2] if lobe else (0, 0)
        for t in range(T):
            if t < len(lobe):
                ar_pos[t, p] = lobe[t][:2]
                ar_w[t, p] = lobe[t][2]
            else:
                ar_pos[t, p] = first
    return _PhasePlan(py.period, px.period, max(py.stride, 1),
                      max(px.stride, 1), pad, oy, ox, wk, ar_pos, ar_w)


@lru_cache(maxsize=64)
def _conv_weight(key, channels: int, device: torch.device):
    """The phase plan's kernel for `channels` groups and the main-lobe
    weights, on `device` once (a copy from pageable host memory would
    block the host every frame)."""
    pp = _phase_plan(*key)
    wk = torch.from_numpy(np.tile(pp.wk, (channels, 1, 1))[:, None])
    ar_w = torch.from_numpy(pp.ar_w[:, :, None, None, None].copy())
    return wk.to(device), ar_w.to(device)


def _window(imgp, y: int, x: int, n_y: int, n_x: int, sy: int, sx: int):
    """imgp[..., y + i*sy, x + j*sx] for i < n_y, j < n_x (a view)."""
    return imgp[..., y:y + (n_y - 1) * sy + 1:sy, x:x + (n_x - 1) * sx + 1:sx]


def _polar_phased(img, key, dst_h: int, dst_w: int, antiring: float):
    """The direct and phased paths: phase sums as one grouped
    convolution, anti-ringing on the phases, one interleave."""
    pp = _phase_plan(*key)
    src_h, src_w = img.shape[-2], img.shape[-1]
    Py, Px, sy, sx = pp.Py, pp.Px, pp.sy, pp.sx
    Hp, Wp = dst_h // Py, dst_w // Px
    C, ky, kx = img.shape[-3], pp.wk.shape[1], pp.wk.shape[2]
    wk, ar_w = _conv_weight(key, C, img.device)
    # phase output (i, j) = sum_taps w * edge-clamped source (oy + i*sy +
    # a, ox + j*sx + b): one grouped convolution, an output channel per
    # phase
    imgp = F.pad(img.reshape(1, C, src_h, src_w), pp.pad, mode="replicate")
    src = imgp[:, :, pp.oy:pp.oy + (Hp - 1) * sy + ky,
               pp.ox:pp.ox + (Wp - 1) * sx + kx]
    out = F.conv2d(src, wk, stride=(sy, sx), groups=C)
    # (phases, C, Hp, Wp), a view
    out = out.reshape(C, Py * Px, Hp, Wp).transpose(0, 1)
    if antiring > 0.0:
        # the main-lobe taps of every phase in one copy, (T, phases, C,
        # Hp, Wp)
        T = pp.ar_pos.shape[0]
        vals = torch.stack([_window(src[0], int(y), int(x), Hp, Wp, sy, sx)
                            for y, x in pp.ar_pos.reshape(-1, 2)])
        vals = vals.reshape(T, Py * Px, C, Hp, Wp)
        out = _apply_ar(out, *_soft_extrema(vals, ar_w), antiring)
    out = out.reshape(Py, Px, C, Hp, Wp)
    return out.permute(2, 3, 0, 4, 1).reshape(C, dst_h, dst_w)


def _softmax_terms(u, w, mask=None):
    """The softmax terms of scaled tap values u with tap weights w:
    (t_lo, s_lo, t_hi, s_hi), s = w * max(cc + 0.1, 0)^32 (five
    squarings, as the reference) and t = s * cc, for cc = 1 - u (lo)
    and u (hi); `mask` zeroes a tap's terms where it is False."""
    out = []
    for cc in (1.0 - u, u):
        s = (cc + 0.10).clamp_(min=0.0)
        for _ in range(5):
            s.mul_(s)
        s = s.mul_(w) if mask is None else torch.where(mask, w * s, 0.0)
        out += [s * cc, s]
    return out


def _soft_extrema(vals, w):
    """The reference's anti-ringing soft (min, max) (sampling.c:539-554)
    of taps stacked along dim 0 of `vals` (T, ...), weighted by `w`
    (broadcast to vals).  The softmax runs in a per-pixel scaled space
    u = v / max(1, vmax, 1 - vmin), exactly 1 for values in [0, 1], with
    its bases clamped at 0, so linear light above 1 cannot overflow; the
    sums go tap by tap in order."""
    vmax, vmin = vals.amax(dim=0), vals.amin(dim=0)
    scale = torch.clamp_min(torch.maximum(vmax, 1.0 - vmin), 1.0)
    terms = _softmax_terms(vals * (1.0 / scale), w)
    sums = []
    for term in terms:
        acc = term[0] + term[1] if vals.shape[0] > 1 else term[0]
        for k in range(2, vals.shape[0]):
            acc.add_(term[k])
        sums.append(acc)
    return _extrema_from_sums(*sums, scale)


def _extrema_from_sums(ar_lo, ww_lo, ar_hi, ww_hi, scale):
    """soft (min, max) from the softmax sums; where a side has no weight
    (no tap in the lobe) its bound opens to -+3e38 and anti-ringing does
    nothing there."""
    has_lo, has_hi = ww_lo > 0, ww_hi > 0
    soft_min = torch.where(
        has_lo, (1.0 - ar_lo / torch.where(has_lo, ww_lo, 1.0)) * scale,
        -3e38)
    soft_max = torch.where(
        has_hi, (ar_hi / torch.where(has_hi, ww_hi, 1.0)) * scale, 3e38)
    return soft_min, soft_max


def _apply_ar(color, soft_min, soft_max, strength: float):
    clamped = torch.minimum(torch.maximum(color, soft_min), soft_max)
    avg = 0.5 * (soft_min + soft_max)
    clamped = torch.where(soft_min > soft_max, avg, clamped)
    return color + (clamped - color) * strength


def _interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for ascending xp, float32, the same
    arithmetic (constant ends outside [xp[0], xp[-1]])."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0,
                    f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@lru_cache(maxsize=16)
def _gather_plan(cfg: flt.FilterConfig, src_h: int, src_w: int, dst_h: int,
                 dst_w: int, rect: RectF, device: torch.device):
    """The gather path's tables on `device`: per axis the clamped source
    index of every (output, tap) and the squared float32 tap distance,
    and the radial LUT with its abscissae."""
    plan = plan_polar(cfg, src_h, src_w, dst_h, dst_w, rect)
    py, px, taps, f = plan["plan_y"], plan["plan_x"], plan["taps"], plan["f"]
    radius = plan["radius"]
    c0 = taps // 2 - 1
    lut = flt.sample_filter(cfg, np.linspace(0.0, radius, SCALER_LUT_SIZE))

    def axis(p, size):
        idx = np.clip(p.base[:, None] + np.arange(taps)[None, :], 0,
                      size - 1).astype(np.int64)
        d = (np.arange(taps)[None, :] - c0 - p.frac[:, None]) / f
        return (torch.from_numpy(idx.T.copy()).to(device),
                torch.from_numpy((d * d).astype(np.float32).T.copy()
                                 ).to(device))

    idx_y, dy2 = axis(py, src_h)
    idx_x, dx2 = axis(px, src_w)
    xp = torch.from_numpy(np.linspace(0.0, radius, SCALER_LUT_SIZE,
                                      dtype=np.float32)).to(device)
    fp = torch.from_numpy(lut.astype(np.float32)).to(device)
    return (taps, np.float32(radius), np.float32(plan["radius_zero"]),
            idx_y, dy2, idx_x, dx2, xp, fp)


def _polar_gather(img, key, dst_h: int, dst_w: int, antiring: float):
    cfg, src_h, src_w, _, _, rect, _ = key
    taps, radius, radius_zero, idx_y, dy2, idx_x, dx2, xp, fp = \
        _gather_plan(cfg, src_h, src_w, dst_h, dst_w, rect, img.device)
    radius, radius_zero = float(radius), float(radius_zero)

    def tap(iy, ix, rows):
        vals = rows.index_select(-1, idx_x[ix])
        d = fsqrt(dy2[iy][:, None] + dx2[ix][None, :])
        w = torch.where(d <= radius, _interp(d, xp, fp), 0.0)
        return vals, w, d <= radius_zero

    acc = wsum = vmax = vmin = None
    for iy in range(taps):
        rows = img.index_select(-2, idx_y[iy])       # (C, dst_h, W)
        for ix in range(taps):
            vals, w, m = tap(iy, ix, rows)
            term = vals * w
            acc = term if acc is None else acc + term
            wsum = w if wsum is None else wsum + w
            if antiring > 0:
                hiv = torch.where(m, vals, -3e38)
                lov = torch.where(m, vals, 3e38)
                vmax = hiv if vmax is None else torch.maximum(vmax, hiv)
                vmin = lov if vmin is None else torch.minimum(vmin, lov)
    out = acc / wsum
    if antiring <= 0:
        return out
    # the soft sums: every tap gathered again, accumulated as it comes
    scale = torch.clamp_min(torch.maximum(vmax, 1.0 - vmin), 1.0)
    inv = 1.0 / scale
    sums = None
    for iy in range(taps):
        rows = img.index_select(-2, idx_y[iy])
        for ix in range(taps):
            vals, w, m = tap(iy, ix, rows)
            terms = _softmax_terms(vals * inv, w, m)
            sums = terms if sums is None else [
                a.add_(b) for a, b in zip(sums, terms)]
    lo, hi = _extrema_from_sums(*sums, scale)
    return _apply_ar(out, lo, hi, antiring)


def sample_polar(img, cfg: flt.FilterConfig, dst_h: int, dst_w: int,
                 rect: Optional[RectF] = None, antiring: float = 0.0):
    """EWA-resample (C, H, W) -> (C, dst_h, dst_w); `antiring` > 0
    clamps each output toward the soft extrema of its main-lobe taps,
    mixed by that strength."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    r = rect or RectF(0, 0, src_w, src_h)
    key = (cfg, src_h, src_w, dst_h, dst_w, r, float(antiring))
    if _phase_plan(*key) is not None:
        return _polar_phased(img, key, dst_h, dst_w, antiring)
    return _polar_gather(img, key, dst_h, dst_w, antiring)

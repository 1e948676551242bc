"""Affine distortion (reference pl_shader_distort, sampling.c:1108).

Counterpart of libplacebo_tpu/ops/distort.py: each output pixel maps
back through the inverse of a 2x2 affine transform (with the canvas
normalization) and samples the source bilinearly or bicubically
(Catmull-Rom) with a clamp, repeat or mirror address mode.  The source
is aspect-normalized so its longer side spans [-1, 1], the user
transform applies there, and the result maps onto a [-1, 1]^2 canvas
(y up); `unscaled` keeps source pixels 1:1 with canvas pixels,
`constrain` shrinks the transform so the mapped source fits.

The inverse mapping depends on the shapes and the parameters only, so
`plan_distort` computes it once on the host and keeps it on the device
— int32 base texels x0 / y0, float32 fractions fx / fy (and the
bicubic weights), the coverage alpha — and every frame wraps the taps
and gathers on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["DistortParams", "DistortPlan", "plan_distort", "distort_image"]


@dataclass(frozen=True)
class DistortParams:
    """Reference pl_distort_params (shaders/sampling.h:204-236)."""
    # row-major 2x2 matrix ((a, b), (c, d)) + offset (x, y)
    transform: Tuple[Tuple[float, float], Tuple[float, float]] = \
        ((1.0, 0.0), (0.0, 1.0))
    offset: Tuple[float, float] = (0.0, 0.0)
    unscaled: bool = False
    constrain: bool = False
    bicubic: bool = False
    address_mode: str = "clamp"          # clamp | repeat | mirror
    alpha_mode: Optional[str] = None     # None | "independent" |
    #                                      "premultiplied": OOB -> alpha 0

    def key(self):
        return (self.transform, self.offset, self.unscaled, self.constrain,
                self.bicubic, self.address_mode, self.alpha_mode)

    @staticmethod
    def rotation(radians: float) -> "DistortParams":
        c, s = math.cos(radians), math.sin(radians)
        return DistortParams(transform=((c, -s), (s, c)))


def _wrap(idx: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """The address mode on integer texel indices."""
    if mode == "repeat":
        return torch.remainder(idx, size)
    if mode == "mirror":
        period = 2 * size
        m = torch.remainder(idx, period)
        return torch.where(m >= size, period - 1 - m, m)
    return torch.clamp(idx, 0, size - 1)


def _cubic_weights(t):
    """Catmull-Rom weights of the 4-tap axis, each operation rounded on
    its own: the reference's weights are constants of its jitted
    computation, which XLA folds without fusing products."""
    t2 = t * t
    t3 = t2 * t
    return ((t3 * -0.5 + t2) - t * 0.5,
            (t3 * 1.5 - t2 * 2.5) + 1.0,
            (t3 * -1.5 + t2 * 2.0) + t * 0.5,
            t3 * 0.5 - t2 * 0.5)


class DistortPlan(NamedTuple):
    """One (source shape, output shape, parameters) inverse mapping on
    the device."""
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    params: DistortParams
    x0: torch.Tensor                # (out_h, out_w) int32
    y0: torch.Tensor
    fx: torch.Tensor                # (out_h, out_w) float32
    fy: torch.Tensor
    wx: Optional[tuple]             # bicubic: the 4 tap weights an axis
    wy: Optional[tuple]
    alpha: Optional[torch.Tensor]   # (1, out_h, out_w) coverage, or None


def plan_distort(src_h: int, src_w: int, out_w: int, out_h: int,
                 params: DistortParams, device) -> DistortPlan:
    """The inverse mapping of `distort_image` (reference geometry,
    ops/distort.py:90-138), computed on the host in float64.  A singular
    transform raises the renderer's RenderError."""
    rx, ry = 1.0, 1.0
    if src_w > src_h:
        ry = src_h / src_w
    else:
        rx = src_w / src_h
    t2n = np.array([[2 * rx, 0.0], [0.0, -2 * ry]])
    t2n_c = np.array([-rx, ry])
    sx = src_w / out_w if params.unscaled else 1.0
    sy = src_h / out_h if params.unscaled else 1.0
    n2c = np.array([[sx / rx, 0.0], [0.0, sy / ry]])
    user = np.asarray(params.transform, np.float64)
    user_c = np.asarray(params.offset, np.float64)
    M = n2c @ user @ t2n
    c = n2c @ (user @ t2n_c + user_c)
    if params.constrain:
        corners = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64)
        mapped = corners @ M.T + c
        bb_w = mapped[:, 0].max() - mapped[:, 0].min()
        bb_h = mapped[:, 1].max() - mapped[:, 1].min()
        scale = 2.0 / max(bb_w, bb_h, 2.0)
        M = M * scale
        c = c * scale
    if abs(np.linalg.det(M)) < 1e-12:
        from ..render.renderer import RenderError
        raise RenderError(
            "distortion transform is singular (det ~ 0); check "
            "distort_scale_x/y and shear values")
    Minv = np.linalg.inv(M)
    xs = (np.arange(out_w) + 0.5) / out_w * 2.0 - 1.0
    ys = 1.0 - (np.arange(out_h) + 0.5) / out_h * 2.0
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    u = Minv[0, 0] * (cx - c[0]) + Minv[0, 1] * (cy - c[1])
    v = Minv[1, 0] * (cx - c[0]) + Minv[1, 1] * (cy - c[1])
    px = u * src_w - 0.5
    py = v * src_h - 0.5
    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    alpha = None
    if params.alpha_mode:
        oob = (u < 0.0) | (u > 1.0) | (v < 0.0) | (v > 1.0)
        alpha = torch.from_numpy((~oob).astype(np.float32)[None]).to(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fx, fy = dev(fx), dev(fy)
    wx = wy = None
    if params.bicubic:
        wx, wy = _cubic_weights(fx), _cubic_weights(fy)
    return DistortPlan(src_h, src_w, out_h, out_w, params,
                       dev(x0.astype(np.int32)), dev(y0.astype(np.int32)),
                       fx, fy, wx, wy, alpha)


def _fused_sum(terms):
    (a0, w0), (a1, w1) = terms[:2]
    acc = torch.addcmul(a1 * w1, a0, w0)
    for a, w in terms[2:]:
        acc = torch.addcmul(acc, a, w)
    return acc


def distort_image(img, out_w: int, out_h: int, params: DistortParams,
                  plan: Optional[DistortPlan] = None):
    """Distort (..., C, H, W) -> (..., C or C+1, out_h, out_w); with
    `alpha_mode` a coverage alpha is appended (premultiplied multiplies
    the color by it).  `plan` is `plan_distort`'s, made here if None."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    if plan is None:
        plan = plan_distort(src_h, src_w, out_w, out_h, params, img.device)
    mode = params.address_mode
    flat_img = img.reshape(*img.shape[:-2], src_h * src_w)
    rows, cols = {}, {}

    def tap(dy: int, dx: int):
        if dy not in rows:
            rows[dy] = _wrap(plan.y0 + dy, src_h, mode) * src_w
        if dx not in cols:
            cols[dx] = _wrap(plan.x0 + dx, src_w, mode)
        flat = (rows[dy] + cols[dx]).reshape(-1)
        return flat_img.index_select(-1, flat).reshape(
            *img.shape[:-2], out_h, out_w)

    if params.bicubic:
        # sum_k tap_k * w_k: the first product fused into the second,
        # each later one into the sum; the rows likewise
        lines = [_fused_sum([(tap(jy - 1, jx - 1), w)
                             for jx, w in enumerate(plan.wx)])
                 for jy in range(4)]
        out = _fused_sum(list(zip(lines, plan.wy)))
    else:
        t00, t01 = tap(0, 0), tap(0, 1)
        t10, t11 = tap(1, 0), tap(1, 1)
        top = torch.addcmul(t00, t01 - t00, plan.fx)
        bot = torch.addcmul(t10, t11 - t10, plan.fx)
        out = torch.addcmul(top, bot - top, plan.fy)

    if params.alpha_mode:
        alpha = plan.alpha.expand(*out.shape[:-3], 1, out_h, out_w)
        if params.alpha_mode == "premultiplied":
            out = out * alpha
        out = torch.cat([out, alpha], dim=-3)
    return out

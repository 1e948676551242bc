"""Ordered dithering against a tiled bias matrix, and error diffusion.

Counterpart of `DitherParams`, `_bias_matrix`, `dither`,
`error_diffusion` and `error_diffusion_scan` in
libplacebo_tpu/ops/dithering.py (reference pl_shader_dither,
shaders/dithering.c:109, and pl_shader_error_diffusion, :326).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import dither as dth
from ..core.colorspace import ColorTransfer
from ..core.dither import DitherMethod, ErrorDiffusionKernel
from ..core.fastmath import fma, rcp
from .cuda import error_diffusion as k2
from .cuda import shear as k3

__all__ = ["DitherParams", "dither", "dither_lut", "bias_matrix",
           "error_diffusion", "error_diffusion_scan"]


@dataclass(frozen=True)
class DitherParams:
    """Reference pl_dither_params (shaders/dithering.h)."""
    method: DitherMethod = DitherMethod.BLUE_NOISE
    lut_size: int = 6            # log2 of the LUT dimension (64x64)
    temporal: bool = False
    transfer: ColorTransfer = ColorTransfer.UNKNOWN


# gamma approximations for gamma-correct low-depth dithering
# (reference approx_gamma, shaders/dithering.c:82-106)
_APPROX_GAMMA = {
    ColorTransfer.UNKNOWN: 1.0, ColorTransfer.LINEAR: 1.0,
    ColorTransfer.SCRGB: 1.0, ColorTransfer.PRO_PHOTO: 1.8,
    ColorTransfer.GAMMA18: 1.8, ColorTransfer.GAMMA20: 2.0,
    ColorTransfer.GAMMA24: 2.4, ColorTransfer.GAMMA26: 2.6,
    ColorTransfer.ST428: 2.6, ColorTransfer.GAMMA28: 2.8,
    ColorTransfer.SRGB: 2.2, ColorTransfer.BT_1886: 2.2,
    ColorTransfer.GAMMA22: 2.2,
    ColorTransfer.PQ: 2.0, ColorTransfer.HLG: 2.0,
    ColorTransfer.V_LOG: 2.0, ColorTransfer.S_LOG1: 2.0,
    ColorTransfer.S_LOG2: 2.0,
}


def dither_lut(params: DitherParams, frame_index: int = 0) -> np.ndarray:
    """The square dither LUT for this frame (temporal rotation/mirroring
    every frame, dithering.c:185-204); white noise has none (its bias is
    a whole frame, `bias_matrix`)."""
    if params.method == DitherMethod.WHITE_NOISE:
        raise ValueError("white-noise dither has no square LUT: its bias "
                         "is bias_matrix's whole frame")
    if params.method == DitherMethod.ORDERED_FIXED:
        lut = dth.bayer_matrix(16)
    elif params.method == DitherMethod.ORDERED_LUT:
        lut = dth.bayer_matrix(1 << params.lut_size)
    else:
        lut = dth.blue_noise(params.lut_size)
    if params.temporal:
        phase = frame_index % 8
        lut = np.rot90(lut, phase % 4)
        if phase >= 4:
            lut = lut.T
    return np.ascontiguousarray(lut, dtype=np.float32)


def bias_matrix(params: DitherParams, h: int, w: int,
                frame_index: int = 0) -> np.ndarray:
    """(h, w) bias in [0,1): the dither LUT tiled over the image, or for
    white noise the reference's host draw, the same numpy call and seed
    (libplacebo_tpu/ops/dithering.py::_bias_matrix), so bit for bit the
    same frame."""
    if params.method == DitherMethod.WHITE_NOISE:
        return dth.white_noise(h, 0x9E3779B9 ^ frame_index, width=w)
    lut = dither_lut(params, frame_index)
    size = lut.shape[0]
    reps = (h + size - 1) // size, (w + size - 1) // size
    return np.tile(lut, reps)[:h, :w].astype(np.float32)


def dither(img, new_depth: int, params: Optional[DitherParams] = None,
           frame_index: int = 0, bias=None):
    """Quantize a (C, H, W) [0,1] image to `new_depth` bits with the
    dither bias; depths <= 4 with a known gamma dither between the
    linearized quantization levels."""
    params = params or DitherParams()
    if new_depth <= 0 or new_depth > 16:
        return img
    h, w = img.shape[-2], img.shape[-1]
    if bias is None:
        bias = torch.from_numpy(bias_matrix(params, h, w, frame_index)) \
            .to(img.device)
    scale = float((1 << new_depth) - 1)
    gamma = _APPROX_GAMMA.get(params.transfer, 1.0)
    if gamma != 1.0 and new_depth <= 4:
        color_lin = torch.pow(torch.clamp_min(img, 0.0), gamma)
        if new_depth == 1:
            low = torch.zeros_like(img)
            high = torch.ones_like(img)
            offset = color_lin
        else:
            low = torch.floor(img * scale) * rcp(scale)
            high = torch.ceil(img * scale) * rcp(scale)
            offset = (color_lin - torch.pow(low, gamma)) / torch.clamp_min(
                torch.pow(high, gamma) - torch.pow(low, gamma), 1e-6)
        return torch.where(offset > bias, high, low)
    return torch.floor(fma(img, scale, bias)) * rcp(scale)


# ---------------------------------------------------------------------------
# Error diffusion (reference pl_shader_error_diffusion, dithering.c:326)
# ---------------------------------------------------------------------------

def error_diffusion(img, new_depth: int,
                    kernel: Optional[ErrorDiffusionKernel] = None):
    """Error-diffusion dither of a (..., C, H, W) image to `new_depth`
    bits: shear the frame into the column-major wavefront layout (kernel
    K3), walk it (kernel K2), and unshear the integer codes back into a
    contiguous (..., C, H, W) frame scaled back and clipped (K3, the
    scale and clip in the same pass).  Nothing is padded: the result
    does not depend on padding."""
    k = kernel or dth.ED_FLOYD_STEINBERG
    *lead, H, W = img.shape
    x = img.reshape(-1, H, W)
    colmaj = k3.shear_chw(x, k.shift)                       # (Wsp, C, H)
    codes = k2.wavefront(colmaj, k, new_depth, W, H)
    out = k3.unshear_chw(codes, k.shift, W,
                         rcp(float((1 << new_depth) - 1)))
    return out.reshape(*lead, H, W)


def error_diffusion_scan(img, new_depth: int,
                         kernel: Optional[ErrorDiffusionKernel] = None):
    """The reference's scan formulation (its oracle for the wavefront
    kernel): gather-shear the image, walk the sheared columns with a
    (C, H, max_off) pending window, gather-unshear.  Kept as the tests'
    oracle for `error_diffusion`."""
    k = kernel or dth.ED_FLOYD_STEINBERG
    *lead, H, W = img.shape
    x = img.reshape(-1, H, W)
    s = k.shift
    scale = float((1 << new_depth) - 1)
    Ws = W + (H - 1) * s
    offsets = torch.arange(H)[:, None] * s
    col = torch.arange(Ws)[None, :] - offsets                 # (H, Ws)
    valid = ((col >= 0) & (col < W)).to(img.device)
    idx = col.clamp(0, W - 1).to(img.device).expand(x.shape[0], H, Ws)
    sheared = torch.where(valid, torch.gather(x, 2, idx), 0.0)
    taps = k2.taps_for(k)
    max_off = max(off for _, off, _ in taps)
    pending = torch.zeros((x.shape[0], H, max_off), device=img.device)
    quants = []
    for j in range(Ws):
        cur = sheared[:, :, j] + pending[:, :, 0]
        r = torch.round(cur * scale)
        quants.append(r * rcp(scale))
        err = torch.where(valid[:, j], fma(r, -rcp(scale), cur), 0.0)
        pending = torch.cat([pending[:, :, 1:],
                             torch.zeros_like(pending[:, :, :1])], dim=2)
        for dy, off, wgt in taps:
            contrib = torch.nn.functional.pad(err[:, :H - dy], (dy, 0)) \
                if dy else err
            pending[:, :, off - 1] = fma(contrib, wgt, pending[:, :, off - 1])
    out_sheared = torch.stack(quants, dim=2)                  # (C, H, Ws)
    back = (torch.arange(W)[None, :] + offsets).to(img.device)
    out = torch.gather(out_sheared, 2, back.expand(x.shape[0], H, W))
    return torch.clamp(out, 0.0, 1.0).reshape(*lead, H, W)

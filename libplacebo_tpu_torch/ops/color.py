"""Color decoding/encoding & (de)linearization on (C, H, W) tensors.

Counterpart of libplacebo_tpu/ops/color.py for the matrix color systems
and the transfer curves of the main path.  Channel mixes are unrolled
per-channel multiply-adds with float32 weights and zero weights skipped
— the reference's `mat_pointwise` — rounding where XLA rounds the
reference's (core/fastmath.py), so every mix sums like the reference
and like the hand-written kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core import transfer as tf
from ..core.fastmath import fma, mix, rcp
from ..core.colorspace import (COLOR_SDR_WHITE, ColorRepr, ColorSpace,
                               ColorTransfer, color_repr_decode)

__all__ = ["mat_pointwise", "decode_color",
           "encode_color", "linearize", "delinearize", "nominal_luma_norm",
           "SigmoidParams", "sigmoidize", "desigmoidize"]


def mat_pointwise(img, mat, bias=None):
    """out[c] = sum_k mat[c, k] * img[k] (+ bias[c]) as unrolled
    multiply-adds; `mat` is a host (C, K) array, zero weights skipped."""
    mat = np.asarray(mat, dtype=np.float64)
    chans = []
    for c in range(mat.shape[0]):
        ks = [k for k in range(mat.shape[1]) if float(mat[c, k]) != 0.0]
        b = float(bias[c]) if bias is not None else 0.0
        if not ks:
            acc = torch.zeros_like(img[..., 0, :, :])
            chans.append(acc + b if b else acc)
            continue
        chans.append(mix([img[..., k, :, :] for k in ks],
                         [float(mat[c, k]) for k in ks], b))
    return torch.stack(chans, dim=-3)


def nominal_luma_norm(csp: ColorSpace) -> Tuple[float, float]:
    """(min, max) display luminance in NORM units."""
    inf = csp.infer()
    return (inf.hdr.min_luma / COLOR_SDR_WHITE,
            inf.hdr.max_luma / COLOR_SDR_WHITE)


def decode_color(img, repr: ColorRepr):
    """Encoded (sampled, normalized) planes -> full-range RGB."""
    tr, _ = color_repr_decode(repr)
    return mat_pointwise(img, tr.mat.m, tr.c)


def encode_color(img, repr: ColorRepr):
    """Full-range RGB -> encoded representation (inverse decode)."""
    tr, _ = color_repr_decode(repr)
    inv = tr.invert()
    return mat_pointwise(img, inv.mat.m, inv.c)


_SCENE_REFERRED = (ColorTransfer.V_LOG, ColorTransfer.S_LOG1,
                   ColorTransfer.S_LOG2)
_UNPORTED = (ColorTransfer.HLG, ColorTransfer.SCRGB) + _SCENE_REFERRED


def _check_trc(trc):
    if trc in _UNPORTED:
        raise NotImplementedError(
            f"transfer {trc.value} is not ported (ROADMAP slice 3: the "
            "remaining transfer curves)")


def linearize(img, csp: ColorSpace):
    """Signal -> linear light (NORM) with the colorspace's black-point /
    peak scaling (reference pl_shader_linearize)."""
    trc = csp.infer().transfer
    if trc == ColorTransfer.LINEAR:
        return img
    _check_trc(trc)
    lo, hi = nominal_luma_norm(csp)
    img = torch.clamp_min(img, 0.0)
    if trc == ColorTransfer.BT_1886:
        lb = lo ** (1 / 2.4)
        lw = hi ** (1 / 2.4)
        a = (lw - lb) ** 2.4
        b = lb / (lw - lb)
        return a * tf.pow_pos(img + b, 2.4)
    if trc == ColorTransfer.PQ:
        return tf.pq_eotf_fast(img) * (10000.0 / COLOR_SDR_WHITE)
    lin = tf.linearize(img, trc)
    if hi != 1.0 or lo != 0.0:
        lin = fma(lin, hi - lo, lo)
    return lin


def delinearize(img, csp: ColorSpace):
    """Linear light (NORM) -> signal; inverse of `linearize`."""
    trc = csp.infer().transfer
    if trc == ColorTransfer.LINEAR:
        return img
    _check_trc(trc)
    lo, hi = nominal_luma_norm(csp)
    if trc not in (ColorTransfer.PQ, ColorTransfer.BT_1886):
        if hi != 1.0 or lo != 0.0:
            img = (img - lo) * rcp(hi - lo)
    img = torch.clamp_min(img, 0.0)
    if trc == ColorTransfer.BT_1886:
        lb = lo ** (1 / 2.4)
        lw = hi ** (1 / 2.4)
        a = (lw - lb) ** 2.4
        b = lb / (lw - lb)
        return tf.pow_pos(torch.clamp_min(img, 0.0) * rcp(a),
                          1 / 2.4) - b
    if trc == ColorTransfer.PQ:
        return tf.pq_oetf_fast(img * (COLOR_SDR_WHITE / 10000.0))
    return tf.delinearize(img, trc)


# ---------------------------------------------------------------------------
# Sigmoidization (reference pl_shader_sigmoidize, shaders/colorspace.c:851)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SigmoidParams:
    """Reference pl_sigmoid_params: defaults center=0.75, slope=6.5."""
    center: float = 0.75
    slope: float = 6.5

    def key(self):
        return (self.center, self.slope)


def _sigmoid_range(params: SigmoidParams):
    center, slope = params.center, params.slope
    offset = 1.0 / (1 + math.exp(slope * center))
    scale = 1.0 / (1 + math.exp(slope * (center - 1))) - offset
    return offset, scale


def sigmoidize(img, params: SigmoidParams = SigmoidParams()):
    """Nonlinear [0, 1] -> the sigmoid domain, for ringing-resistant
    linear scaling; passes through (0, 0) and (1, 1)."""
    offset, scale = _sigmoid_range(params)
    x = torch.clamp(img, 0.0, 1.0)
    return fma(torch.log(1.0 / fma(x, scale, offset) - 1.0),
               -(1.0 / params.slope), params.center)


def desigmoidize(img, params: SigmoidParams = SigmoidParams()):
    """The inverse of `sigmoidize`."""
    offset, scale = _sigmoid_range(params)
    x = torch.clamp(img, 0.0, 1.0)
    return (1.0 / scale) / (1.0 + torch.exp(
        (params.center - x) * params.slope)) - offset / scale

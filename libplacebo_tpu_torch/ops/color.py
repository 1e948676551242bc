"""Color decoding/encoding & (de)linearization on (C, H, W) tensors.

Counterpart of libplacebo_tpu/ops/color.py: the matrix color systems,
the non-linear ones (ICtCp PQ/HLG, BT.2020 constant luminance, XYZ,
Dolby Vision),
and every transfer curve (HLG with its OOTF, the scene-referred camera
curves without display scaling, scRGB keeping negatives).  Channel
mixes are unrolled per-channel multiply-adds with float32 weights and
zero weights skipped — the reference's `mat_pointwise` — rounding where
XLA rounds the reference's (core/fastmath.py), so every mix sums like
the reference and like the hand-written kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core import transfer as tf
from ..core.fastmath import fma, mix, rcp
from ..core.colorspace import (COLOR_SDR_WHITE, ColorPrimaries, ColorRepr,
                               ColorSpace, ColorSystem, ColorTransfer,
                               color_repr_decode, ictcp_matrices,
                               luma_coeffs, primaries_get,
                               rgb_to_xyz_matrix, xyz_to_rgb_matrix)

__all__ = ["mat_pointwise", "decode_color", "cone_distort",
           "encode_color", "linearize", "delinearize", "nominal_luma_norm",
           "hlg_constants", "SigmoidParams", "sigmoidize", "desigmoidize"]


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


# ---------------------------------------------------------------------------
# Decode / encode (reference pl_shader_decode_color / encode_color)
# ---------------------------------------------------------------------------

# Rec. BT.2020-2 OETF constants (the constant-luminance system's gamma
# round trip)
_B2020_A = 1.0993
_B2020_B = 0.0181


def _bt2020_oetf(lin):
    lin = torch.clamp_min(lin, 0.0)
    return torch.where(lin < _B2020_B, lin * 4.5,
                       fma(tf.pow_pos(lin, 0.45), _B2020_A,
                           -(_B2020_A - 1.0)))


def _bt2020_eotf(e):
    e = torch.clamp_min(e, 0.0)
    return torch.where(e < 4.5 * _B2020_B, e * rcp(4.5),
                       tf.pow_pos(((e + _B2020_A) - 1.0) * rcp(_B2020_A),
                                  1.0 / 0.45))


def _pick(cond, a: float, b: float):
    return torch.where(cond, torch.full_like(cond, a, dtype=torch.float32),
                       torch.full_like(cond, b, dtype=torch.float32))


def _mat_traced(img, mat: np.ndarray, off=None):
    """out[c] = sum_k mat[c, k] * img[k] (- off[c]) with every weight
    kept, zeros too, rounded as XLA rounds a product with a traced
    matrix: the first product fused into the second, the third fused
    into the sum."""
    chans = []
    for c in range(3):
        w = [float(v) for v in np.asarray(mat[c], np.float32)]
        acc = fma(img[..., 0, :, :], w[0], img[..., 1, :, :] * w[1])
        acc = fma(img[..., 2, :, :], w[2], acc)
        chans.append(acc - float(off[c]) if off is not None else acc)
    return torch.stack(chans, dim=-3)


def cone_distort(img, csp: ColorSpace, params, already_linear=False):
    """Color-blindness simulation (reference pl_shader_cone_distort): the
    cone matrix in linear light; with `already_linear` the image is
    linear already (the renderer's linear-light section), else it is
    linearized and delinearized around the matrix."""
    from ..core.colorspace import Cone, cone_matrix
    if params is None or Cone(params.cones) == Cone.NONE:
        return img
    m = cone_matrix(params, primaries_get(csp.infer().primaries))
    if already_linear:
        return mat_pointwise(img, m.m)
    return delinearize(mat_pointwise(linearize(img, csp), m.m), csp)


def _decode_dovi(img, repr: ColorRepr, dovi_packed, adjustment=None):
    """Dolby Vision: reshape -> the nonlinear (YCC -> RGB) matrix -> PQ
    linearize -> the linear (LMS -> RGB) matrix -> back to PQ-encoded
    RGB, so the uniform linearize downstream applies (reference
    decode_color, ops/color.py:218-241).  With `dovi_packed` (the
    renderer's per-frame RPU) the matrices are the frame's data."""
    from . import dovi as ops_dovi
    if dovi_packed is not None:
        img = ops_dovi.dovi_reshape_packed(img, dovi_packed)
        img = _mat_traced(img, dovi_packed.nonlinear,
                          ops_dovi.dovi_offset(dovi_packed))
        lms = tf.pq_eotf_fast(torch.clamp_min(img, 0.0))
        rgb = _mat_traced(lms, dovi_packed.linear)
        return tf.pq_oetf_fast(torch.clamp_min(rgb, 0.0))
    img = ops_dovi.dovi_reshape(img, repr.dovi)
    tr, _ = color_repr_decode(repr, adjustment)
    img = mat_pointwise(img, tr.mat.m, tr.c)
    lms = tf.pq_eotf_fast(torch.clamp_min(img, 0.0))
    rgb = mat_pointwise(lms, np.asarray(repr.dovi.linear,
                                        np.float64).reshape(3, 3))
    return tf.pq_oetf_fast(torch.clamp_min(rgb, 0.0))


def decode_color(img, repr: ColorRepr,
                 prim: ColorPrimaries = ColorPrimaries.UNKNOWN,
                 dovi_packed=None, adjustment=None):
    """Encoded (sampled, normalized) planes -> full-range RGB, with the
    non-linear steps of ICtCp, BT.2020-C, XYZ and Dolby Vision (reference
    pl_shader_decode_color, shaders/colorspace.c:275).  ICtCp runs the
    exact PQ curves, as the reference's container transforms do.  The
    color adjustment (core.colorspace.ColorAdjustment) is folded into
    the decode matrix (a per-frame RPU's packed matrices leave it out,
    as in the reference); its gamma ends the matrix systems' decode."""
    sys = repr.sys
    if sys == ColorSystem.DOLBYVISION:
        if repr.dovi is None and dovi_packed is None:
            raise ValueError("DOLBYVISION repr requires dovi metadata")
        return _decode_dovi(img, repr, dovi_packed, adjustment)
    tr, _ = color_repr_decode(repr, adjustment)
    img = mat_pointwise(img, tr.mat.m, tr.c)
    if sys == ColorSystem.XYZ:
        # ST 428 linearization, XYZ -> RGB, back to a 2.6 gamma signal
        img = tf.pow_pos(torch.clamp_min(img, 0.0), 2.6) * tf.ST428_SCALE
        img = mat_pointwise(img, xyz_to_rgb_matrix(primaries_get(prim)).m)
        return tf.pow_pos(torch.clamp_min(img * rcp(tf.ST428_SCALE), 0.0),
                          1 / 2.6)
    if sys in (ColorSystem.BT_2100_PQ, ColorSystem.BT_2100_HLG):
        rgb2lms, _ = ictcp_matrices(sys)
        lms2rgb = np.linalg.inv(rgb2lms)
        if sys == ColorSystem.BT_2100_PQ:
            rgb = mat_pointwise(tf.pq_eotf(img), lms2rgb)
            return tf.pq_oetf(torch.clamp_min(rgb, 0.0))
        rgb = mat_pointwise(tf.hlg_oetf_inv(img) * rcp(12.0), lms2rgb)
        return tf.hlg_oetf(torch.clamp_min(rgb, 0.0) * 12.0)
    if sys == ColorSystem.BT_2020_C:
        # constant luminance (Rec. BT.2020-2 table 4): B' and R' around
        # gamma luma with the piecewise chroma denominators, G through
        # linear light
        yp, cb, cr = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
        bp = fma(cb, _pick(cb <= 0, 1.9404, 1.5816), yp)
        rp = fma(cr, _pick(cr <= 0, 1.7184, 0.9936), yp)
        yl, bl, rl = _bt2020_eotf(yp), _bt2020_eotf(bp), _bt2020_eotf(rp)
        gl = fma(bl, -0.0593, fma(rl, -0.2627, yl)) * rcp(0.6780)
        return torch.stack([rp, _bt2020_oetf(gl), bp], dim=-3)
    return _apply_gamma(img, adjustment)


def _apply_gamma(img, adjustment):
    """The adjustment's aesthetic gamma, in non-linear light at the end
    of the decode (reference shaders/colorspace.c:440-456)."""
    if adjustment is None or adjustment.gamma == 1.0:
        return img
    if adjustment.gamma == 0.0:
        return torch.zeros_like(img)
    return tf.pow_pos(torch.clamp_min(img, 0.0), 1.0 / adjustment.gamma)


def encode_color(img, repr: ColorRepr,
                 prim: ColorPrimaries = ColorPrimaries.UNKNOWN):
    """Full-range RGB -> encoded representation (inverse of
    decode_color; reference pl_shader_encode_color)."""
    sys = repr.sys
    tr, _ = color_repr_decode(repr)
    inv = tr.invert()
    if sys in (ColorSystem.BT_2100_PQ, ColorSystem.BT_2100_HLG):
        rgb2lms, _ = ictcp_matrices(sys)
        if sys == ColorSystem.BT_2100_PQ:
            lms = mat_pointwise(tf.pq_eotf(img), rgb2lms)
            img = tf.pq_oetf(torch.clamp_min(lms, 0.0))
        else:
            lms = mat_pointwise(tf.hlg_oetf_inv(img) * rcp(12.0), rgb2lms)
            img = tf.hlg_oetf(torch.clamp_min(lms, 0.0) * 12.0)
    elif sys == ColorSystem.XYZ:
        lin = tf.pow_pos(torch.clamp_min(img, 0.0), 2.6) * tf.ST428_SCALE
        xyz = mat_pointwise(lin, rgb_to_xyz_matrix(primaries_get(prim)).m)
        img = tf.pow_pos(torch.clamp_min(xyz * rcp(tf.ST428_SCALE), 0.0),
                         1 / 2.6)
    elif sys == ColorSystem.BT_2020_C:
        r, g, b = img[..., 0, :, :], img[..., 1, :, :], img[..., 2, :, :]
        yl = mix([_bt2020_eotf(r), _bt2020_eotf(g), _bt2020_eotf(b)],
                 [0.2627, 0.6780, 0.0593])
        yp = _bt2020_oetf(yl)
        db, dr = b - yp, r - yp
        img = torch.stack([yp, db / _pick(db <= 0, 1.9404, 1.5816),
                           dr / _pick(dr <= 0, 1.7184, 0.9936)], dim=-3)
    return mat_pointwise(img, inv.mat.m, inv.c)


# ---------------------------------------------------------------------------
# Linearize / delinearize (reference pl_shader_linearize:589)
# ---------------------------------------------------------------------------

_SCENE_REFERRED = (ColorTransfer.V_LOG, ColorTransfer.S_LOG1,
                   ColorTransfer.S_LOG2)
_HLG_REF = 1000.0 / COLOR_SDR_WHITE
_SCRGB_WHITE = 80.0 / COLOR_SDR_WHITE


def hlg_constants(csp: ColorSpace):
    """HLG's (system gamma y, black lift b, float32 luma weights) for the
    colorspace's display range (reference: BT.2100's OOTF with the
    1.111^log2(Lw/1000) gamma adjustment)."""
    lo, hi = nominal_luma_norm(csp)
    y = 1.2 * math.pow(1.111, math.log2(hi / _HLG_REF))
    b = math.sqrt(3 * math.pow(lo / hi, 1 / y))
    lw = luma_coeffs(primaries_get(csp.infer().primaries)).astype(np.float32)
    return y, b, [float(w) for w in lw]


def linearize(img, csp: ColorSpace):
    """Signal -> linear light (NORM) with the colorspace's black-point /
    peak scaling (reference pl_shader_linearize)."""
    trc = csp.infer().transfer
    if trc == ColorTransfer.LINEAR:
        return img
    lo, hi = nominal_luma_norm(csp)
    if trc != ColorTransfer.SCRGB:
        img = torch.clamp_min(img, 0.0)
    if trc == ColorTransfer.BT_1886:
        lb = lo ** (1 / 2.4)
        lw = hi ** (1 / 2.4)
        a = (lw - lb) ** 2.4
        b = lb / (lw - lb)
        return a * tf.pow_pos(img + b, 2.4)
    if trc == ColorTransfer.PQ:
        return tf.pq_eotf_fast(img) * (10000.0 / COLOR_SDR_WHITE)
    if trc == ColorTransfer.HLG:
        y, b, lw = hlg_constants(csp)
        scene = tf.hlg_oetf_inv(fma(img, 1 - b, b)) * rcp(12.0)
        luma = mix([scene[..., c, :, :] for c in range(3)], lw)
        return (scene * hi) * tf.pow_pos(
            torch.clamp_min(luma, 0.0), y - 1)[..., None, :, :]
    if trc == ColorTransfer.SCRGB:
        return img * _SCRGB_WHITE
    lin = tf.linearize(img, trc)
    # the camera curves are scene-referred: no display scaling
    if trc in _SCENE_REFERRED:
        return lin
    if hi != 1.0 or lo != 0.0:
        lin = fma(lin, hi - lo, lo)
    return lin


def delinearize(img, csp: ColorSpace):
    """Linear light (NORM) -> signal; inverse of `linearize`."""
    trc = csp.infer().transfer
    if trc == ColorTransfer.LINEAR:
        return img
    lo, hi = nominal_luma_norm(csp)
    if trc not in (ColorTransfer.PQ, ColorTransfer.HLG, ColorTransfer.SCRGB,
                   ColorTransfer.BT_1886) + _SCENE_REFERRED:
        if hi != 1.0 or lo != 0.0:
            img = (img - lo) * rcp(hi - lo)
    if trc != ColorTransfer.SCRGB:
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
    if trc == ColorTransfer.HLG:
        y, b, lw = hlg_constants(csp)
        disp = img * rcp(hi)
        luma = mix([disp[..., c, :, :] for c in range(3)], lw)
        scene = (disp * 12.0) * tf.pow_pos(
            torch.clamp_min(luma, 1e-6), (1 - y) / y)[..., None, :, :]
        return (tf.hlg_oetf(scene) - b) * rcp(1 - b)
    if trc == ColorTransfer.SCRGB:
        return img * rcp(_SCRGB_WHITE)
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

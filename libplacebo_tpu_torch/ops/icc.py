"""ICC profile application on (3, H, W) tensors.

Counterpart of libplacebo_tpu/ops/icc.py (reference pl_icc_decode /
pl_icc_encode, src/shaders/icc.c:624-720): the reference bakes an lcms2
transform into a 3D LUT and samples it per pixel.  Matrix/TRC display
profiles need no 3D LUT: the device runs a gamut matrix plus per-channel
TRCs, the forward TRCs and the inverse TRCs (encode) each fitted once
per profile on the host as degree-12 polynomials in a y^(1/4) basis.
cLUT profiles bake their A2B / B2A pipelines into a 3D LUT on the host
(with black-point compensation on request) and apply it with
ops/lut.py.  The host fits are the reference's numpy code.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.colorspace import (CIE_D50, COLOR_SDR_WHITE, RawPrimaries,
                               adapt_white_matrix, color_mapping_matrix,
                               xyz_to_rgb_matrix)
from ..core.fastmath import fma, rcp, sqrt
from ..core.icc import IccProfile

__all__ = ["encode_profile", "decode_profile", "params_kwargs"]


def params_kwargs(params, encode: bool = False) -> dict:
    """Map the pl_icc_params analogs carried in
    RenderParams.compat_flags (options icc_size_r/g/b, icc_max_luma,
    icc_force_bpc — reference icc.h pl_icc_params) to
    encode_profile/decode_profile keyword arguments."""
    d = dict(getattr(params, "compat_flags", ()) or ())
    kw = {}
    sizes = tuple(int(d.get(f"icc_size_{c}") or 0) for c in "rgb")
    if any(sizes):
        kw["sizes"] = sizes
    max_luma = float(d.get("icc_max_luma") or 0.0)
    if max_luma > 0:
        # profile-relative 1.0 = a display of max_luma nits; NORM 1.0
        # stays 203-nit SDR white (pl_icc_params.max_luma)
        kw["peak_norm"] = max_luma / COLOR_SDR_WHITE
    if encode and d.get("icc_force_bpc"):
        kw["force_bpc"] = True
    return kw

# default cLUT bake resolution (reference icc.c defaults to 64^3 via
# pl_icc_params.size_*; 33^3 with trilinear interp keeps host bake
# < 100 ms at equivalent accuracy for smooth display transforms).
# pl_icc_params.size_r/g/b map to the `sizes` argument below.
_BAKE_N = 33
_BAKE_GAMMA = 2.4    # B2A bake grid shaping exponent (see _baked_b2a_lut)


def _black_point(prof: "IccProfile") -> Optional[np.ndarray]:
    """Profile black point in D50-relative XYZ (the lcms
    cmsDetectDestinationBlackPoint analog): where the device maps
    signal (0,0,0)."""
    if prof.a2b is None:
        return None
    bp = prof.a2b_to_xyz(np.zeros((1, 3)))[0]
    return bp if np.all(np.isfinite(bp)) and bp[1] > 1e-6 else None


def _bpc_adjust(xyz: np.ndarray, bp: np.ndarray) -> np.ndarray:
    """lcms-style black point compensation: linear XYZ map taking
    0 -> bp and the D50 white to itself, so shadow detail lands inside
    the device's reproducible range instead of clipping."""
    wp = np.asarray(CIE_D50.to_XYZ(), np.float64)
    scale = (wp - bp) / wp
    return xyz * scale + bp


@lru_cache(maxsize=8)
def _baked_b2a_lut(profile_id: int, prim: RawPrimaries,
                   sizes: Tuple[int, int, int] = (_BAKE_N,) * 3,
                   bpc: bool = False):
    """Sample linear-RGB(src primaries) -> device signal through the
    profile's B2A pipeline into a 3D CustomLut (= the reference's
    lcms-transform-to-3D-texture bake, icc.c:624-720).  `sizes` is the
    per-channel grid resolution (pl_icc_params.size_r/g/b); `bpc`
    applies black point compensation (pl_icc_params.force_bpc)."""
    from ..core.lut import CustomLut
    prof = _PROFILES[profile_id]
    rgb2xyz = np.linalg.inv(xyz_to_rgb_matrix(prim).m)
    adapt = adapt_white_matrix(prim.white, CIE_D50).m
    # grid in a gamma-shaped basis (u = lin^(1/2.4)): linear-domain
    # sampling puts almost no nodes where the encode curve is steepest
    # (near black); the device pre-shapes the image the same way
    nr, ng, nb = sizes
    gr, gg, gb = (np.linspace(0.0, 1.0, n) ** _BAKE_GAMMA
                  for n in (nr, ng, nb))
    b, g, r = np.meshgrid(gb, gg, gr, indexing="ij")
    rgb = np.stack([r, g, b], axis=-1)          # (B,G,R,3), r fastest
    xyz = rgb @ (adapt @ rgb2xyz).T
    if bpc:
        bp = _black_point(prof)
        if bp is not None:
            xyz = _bpc_adjust(xyz, bp)
    sig = prof.xyz_to_b2a(xyz)
    return CustomLut(data=np.clip(sig, 0.0, 1.0).astype(np.float32),
                     size=(nr, ng, nb))


@lru_cache(maxsize=8)
def _baked_a2b_lut(profile_id: int, prim: RawPrimaries,
                   sizes: Tuple[int, int, int] = (_BAKE_N,) * 3):
    """Device signal -> linear RGB (dst primaries), via A2B."""
    from ..core.lut import CustomLut
    prof = _PROFILES[profile_id]
    adapt = adapt_white_matrix(CIE_D50, prim.white).m
    xyz2rgb = xyz_to_rgb_matrix(prim).m
    nr, ng, nb = sizes
    gr, gg, gb = (np.linspace(0.0, 1.0, n) for n in (nr, ng, nb))
    b, g, r = np.meshgrid(gb, gg, gr, indexing="ij")
    sig = np.stack([r, g, b], axis=-1)
    xyz = prof.a2b_to_xyz(sig)
    rgb = xyz @ (xyz2rgb @ adapt).T
    return CustomLut(data=np.clip(rgb, 0.0, 2.0).astype(np.float32),
                     size=(nr, ng, nb))

_DEG = 12


@lru_cache(maxsize=8)
def _inverse_trc_coefs(profile_id: int) -> Tuple:
    prof = _PROFILES[profile_id]
    coefs = []
    for curve in prof.trc:
        ys = np.linspace(0.0, 1.0, 4096)
        xs = curve.eval_inverse(ys)
        u = ys ** 0.25
        c = np.polyfit(u, xs, _DEG)
        err = np.abs(np.polyval(c, u) - xs).max()
        coefs.append((tuple(c.astype(np.float64)), float(err)))
    return tuple(coefs)


@lru_cache(maxsize=8)
def _forward_trc_coefs(profile_id: int) -> Tuple:
    prof = _PROFILES[profile_id]
    coefs = []
    for curve in prof.trc:
        xs = np.linspace(0.0, 1.0, 4096)
        ys = curve.eval(xs)
        u = xs ** 0.25
        c = np.polyfit(u, ys, _DEG)
        coefs.append(tuple(c.astype(np.float64)))
    return tuple(coefs)


# profiles aren't hashable; register by id for the lru caches
_PROFILES = {}


def _register(prof: IccProfile) -> int:
    pid = id(prof)
    _PROFILES[pid] = prof
    return pid


def _polyval(coef, x):
    """Horner's rule, one fused multiply-add a coefficient (the
    reference's jitted `out * x + c`)."""
    out = torch.full_like(x, float(coef[0]))
    for c in coef[1:]:
        out = fma(out, x, float(c))
    return out


def _gamut_matrix(prof: IccProfile, src_prim: RawPrimaries) -> np.ndarray:
    return color_mapping_matrix(src_prim, prof.containing_primaries()).m


def _sizes(sizes):
    return tuple(int(s) if s else _BAKE_N
                 for s in (sizes or (_BAKE_N,) * 3))


def encode_profile(img_linear, prof: IccProfile, src_prim: RawPrimaries,
                   peak_norm: float = 1.0,
                   sizes: Optional[Tuple[int, int, int]] = None,
                   force_bpc: bool = False):
    """Linear NORM RGB (src primaries) -> profile signal values.
    `peak_norm` maps NORM 1.0 (SDR white) to profile-relative 1.0;
    `sizes` / `force_bpc` are pl_icc_params.size_r/g/b and .force_bpc
    on the cLUT bake path."""
    from . import lut as ops_lut
    from .color import mat_pointwise
    pid = _register(prof)
    if prof.rgb2xyz is None:
        # cLUT-only profile: the baked B2A 3D LUT, indexed in the
        # u = lin^(1/2.4) shaped basis
        lut3d = _baked_b2a_lut(pid, src_prim, _sizes(sizes), force_bpc)
        u = torch.pow(torch.clamp(img_linear * rcp(peak_norm), 0.0, 1.0),
                      1 / _BAKE_GAMMA)
        return ops_lut.apply_lut(u, lut3d)
    x = mat_pointwise(img_linear, _gamut_matrix(prof, src_prim)) * \
        rcp(peak_norm)
    u = sqrt(sqrt(torch.clamp(x, 0.0, 1.0)))
    coefs = _inverse_trc_coefs(pid)
    return torch.stack([torch.clamp(_polyval(coefs[c][0], u[..., c, :, :]),
                                    0.0, 1.0) for c in range(3)], dim=-3)


def decode_profile(img_signal, prof: IccProfile, dst_prim: RawPrimaries,
                   peak_norm: float = 1.0,
                   sizes: Optional[Tuple[int, int, int]] = None):
    """Profile signal -> linear NORM RGB in dst primaries."""
    from . import lut as ops_lut
    from .color import mat_pointwise
    pid = _register(prof)
    if prof.rgb2xyz is None:
        lut3d = _baked_a2b_lut(pid, dst_prim, _sizes(sizes))
        return ops_lut.apply_lut(torch.clamp(img_signal, 0.0, 1.0),
                                 lut3d) * peak_norm
    u = sqrt(sqrt(torch.clamp(img_signal, 0.0, 1.0)))
    coefs = _forward_trc_coefs(pid)
    lin = torch.stack([_polyval(coefs[c], u[..., c, :, :])
                       for c in range(3)], dim=-3)
    m = np.linalg.inv(_gamut_matrix(prof, dst_prim))
    return mat_pointwise(lin, m) * peak_norm

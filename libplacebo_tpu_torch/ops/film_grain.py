"""AV1 film grain synthesis: application to the planes.

Counterpart of libplacebo_tpu/ops/film_grain.py (the GPU half of the
reference's pl_shader_fg_av1, src/shaders/film_grain_av1.c:605-1015).
Grain offsets have a 16x16 alphabet, so each LUT has only 256 possible
32x32 grain tiles: the host builds the tile stacks (plus the edge stacks
the overlap blend reads) once per seed, and the device gathers whole
tiles by block index, blends the block overlaps with the AV1 27/17 and
23/22 weights, and scales the grain by the spec's fixed-point scaling LUT
sampled with linear filtering.  The reference's one-hot matrix products
are a TPU device for table lookups; here they are plain indexing, which
selects the same values exactly.

Grain tables change with the per-frame seed, so they are per-frame
inputs (`prepare_av1_grain`), never part of the cached render plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import film_grain as fg
from ..core.fastmath import fma
from ..core.film_grain import BLOCK_SIZE, FilmGrainData
from ..utils.device import arrays_to_device, device_constant

__all__ = ["needs_fg", "needs_film_grain", "GrainCfg", "grain_cfg_for",
           "prepare_av1_grain", "apply_av1_grain", "subsample_nearest"]


def needs_fg(data: Optional[FilmGrainData]) -> bool:
    """Reference pl_needs_fg (film_grain.h:124)."""
    if data is None or data.type != "av1" or data.av1 is None:
        return False
    a = data.av1
    return (a.num_points_y > 0 or a.num_points_uv[0] > 0 or
            a.num_points_uv[1] > 0 or a.chroma_scaling_from_luma)


def needs_film_grain(data: Optional[FilmGrainData],
                     channels: Tuple[int, ...] = (0, 1, 2)) -> bool:
    """Whether AV1 grain must be applied to a plane carrying `channels`
    (canonical ids 0=Y, 1=Cb, 2=Cr) (reference pl_needs_film_grain,
    film_grain.c:21, film_grain_av1.c:551)."""
    if data is None or data.type != "av1" or data.av1 is None:
        return False
    a = data.av1
    has = (a.num_points_y > 0,
           a.num_points_uv[0] > 0 or a.chroma_scaling_from_luma,
           a.num_points_uv[1] > 0 or a.chroma_scaling_from_luma)
    return any(0 <= ch < 3 and has[ch] for ch in channels)


@dataclass(frozen=True)
class GrainCfg:
    """Static grain configuration of one plane (part of the render
    plan); channels are the canonical ids the plane carries."""
    channels: Tuple[int, ...]
    active: Tuple[bool, ...]          # per channel: grain applied?
    overlap: bool = True
    chroma_scaling_from_luma: bool = False
    sub_x: int = 0
    sub_y: int = 0
    bits: int = 8
    limited_range: bool = True
    is_ycbcr: bool = True


class ChannelTables(NamedTuple):
    tiles: torch.Tensor     # (256, bh, bw)
    right: torch.Tensor     # (256, bh, n_ox)
    bottom: torch.Tensor    # (256, n_oy, bw)
    corner: torch.Tensor    # (256, n_oy, n_ox)
    scaling: torch.Tensor   # (256,) spec scaling LUT (includes 1/2^shift)
    uv_consts: Tuple[float, float, float]  # [mult_luma, mult, offset]


class GrainTables(NamedTuple):
    offsets: torch.Tensor           # (nby, nbx) int32 (packed uint32 bits)
    chans: Tuple[Optional[ChannelTables], ...]


@lru_cache(maxsize=16)
def _tile_stacks_np(data, seed: int, channel: int, sub_x: int, sub_y: int,
                    bits: int):
    if channel == 0:
        lut, _ = fg.generate_grain_y(data, seed, bits)
    else:
        lut = fg.generate_grain_uv(data, seed, channel, sub_x, sub_y, bits)
    bw = BLOCK_SIZE >> sub_x
    bh = BLOCK_SIZE >> sub_y
    ox_scale = 1 if sub_x else 2
    oy_scale = 1 if sub_y else 2
    n_ox = max(2 >> sub_x, 1)
    n_oy = max(2 >> sub_y, 1)
    tiles = np.zeros((256, bh, bw), np.float32)
    right = np.zeros((256, bh, n_ox), np.float32)
    bottom = np.zeros((256, n_oy, bw), np.float32)
    corner = np.zeros((256, n_oy, n_ox), np.float32)
    for v in range(256):
        ox = (v >> 4) * ox_scale
        oy = (v & 0xF) * oy_scale
        tiles[v] = lut[oy:oy + bh, ox:ox + bw]
        right[v] = lut[oy:oy + bh, ox + bw:ox + bw + n_ox]
        bottom[v] = lut[oy + bh:oy + bh + n_oy, ox:ox + bw]
        corner[v] = lut[oy + bh:oy + bh + n_oy, ox + bw:ox + bw + n_ox]
    return tiles, right, bottom, corner


def grain_cfg_for(data: FilmGrainData, channels: Tuple[int, ...],
                  bits: int = 8, sub_x: int = 0, sub_y: int = 0,
                  limited_range: bool = True,
                  is_ycbcr: bool = True) -> GrainCfg:
    a = data.av1
    active = tuple(
        (a.num_points_y > 0) if ch == 0 else
        (a.num_points_uv[ch - 1] > 0 or a.chroma_scaling_from_luma)
        for ch in channels)
    return GrainCfg(channels=channels, active=active, overlap=a.overlap,
                    chroma_scaling_from_luma=a.chroma_scaling_from_luma,
                    sub_x=sub_x, sub_y=sub_y, bits=bits,
                    limited_range=limited_range, is_ycbcr=is_ycbcr)


def prepare_av1_grain(data: FilmGrainData, cfg: GrainCfg, h: int, w: int,
                      device) -> GrainTables:
    """The per-frame grain tables of an h x w plane on `device` (host
    generation cached per seed, one upload per call)."""
    device = torch.device(device)
    a = data.av1
    bw = BLOCK_SIZE >> cfg.sub_x
    bh = BLOCK_SIZE >> cfg.sub_y
    offsets = fg.generate_offsets(data.seed, (w + bw - 1) // bw,
                                  (h + bh - 1) // bh)
    grain_scale = 1.0 / ((1 << cfg.bits) - 1)
    host, uvs = [offsets.view(np.int32)], []
    for ch, act in zip(cfg.channels, cfg.active):
        if not act:
            uvs.append(None)
            continue
        stacks = _tile_stacks_np(a, data.seed, ch, cfg.sub_x if ch else 0,
                                 cfg.sub_y if ch else 0, cfg.bits)
        if ch == 0 or cfg.chroma_scaling_from_luma:
            pts = a.points_y
            uv = np.zeros(3, np.float32)
        else:
            pts = a.points_uv[ch - 1]
            uv = np.array([a.uv_mult_luma[ch - 1] / 64.0,
                           a.uv_mult[ch - 1] / 64.0,
                           (a.uv_offset[ch - 1] << (cfg.bits - 8)) *
                           grain_scale], np.float32)
        host += [*stacks, fg.generate_scaling(tuple(pts), a.scaling_shift)]
        uvs.append(tuple(float(v) for v in uv))
    dev = iter(arrays_to_device(host, device))
    offsets_t = next(dev)
    chans = tuple(None if uv is None else ChannelTables(
        *[next(dev) for _ in range(5)], uv) for uv in uvs)
    return GrainTables(offsets_t, chans)


def _assemble_plane(offsets, ct: ChannelTables, h, w, sub_x, sub_y,
                    overlap, grain_min, grain_max):
    """The (h, w) grain plane: a tile per block by its offset, the block
    overlaps blended, clipped."""
    bw = BLOCK_SIZE >> sub_x
    bh = BLOCK_SIZE >> sub_y
    nbx = (w + bw - 1) // bw
    nby = (h + bh - 1) // bh
    n_ox = max(2 >> sub_x, 1)
    n_oy = max(2 >> sub_y, 1)
    off = offsets[:nby, :nbx].reshape(-1).long()
    idx_n, idx_l = off & 0xFF, (off >> 8) & 0xFF
    idx_t, idx_tl = (off >> 16) & 0xFF, (off >> 24) & 0xFF

    g = ct.tiles[idx_n].reshape(nby, nbx, bh, bw)
    if overlap:
        wx_n, wx_o = ((27.0, 17.0), (17.0, 27.0)) if n_ox == 2 else \
            ((23.0,), (22.0,))
        wy_n, wy_o = ((27.0, 17.0), (17.0, 27.0)) if n_oy == 2 else \
            ((23.0,), (22.0,))
        dev = g.device
        wxa, wxb, wya, wyb = (device_constant(tuple(v / 32.0 for v in t),
                                              dev)
                              for t in (wx_n, wx_o, wy_n, wy_o))
        has_l = (torch.arange(nbx, device=dev) > 0)[None, :, None, None]
        has_t = (torch.arange(nby, device=dev) > 0)[:, None, None, None]

        gl = ct.right[idx_l].reshape(nby, nbx, bh, n_ox)
        g[..., :n_ox] = torch.where(has_l, _blend(gl, wxa, g[..., :n_ox], wxb),
                                    g[..., :n_ox])
        gt = ct.bottom[idx_t].reshape(nby, nbx, n_oy, bw)
        gc = ct.corner[idx_tl].reshape(nby, nbx, n_oy, n_ox)
        gt[..., :n_ox] = torch.where(
            has_l, _blend(gc, wxa, gt[..., :n_ox], wxb), gt[..., :n_ox])
        g[..., :n_oy, :] = torch.where(
            has_t, _blend(gt, wya[:, None], g[..., :n_oy, :], wyb[:, None]),
            g[..., :n_oy, :])
        g = torch.clamp(g, grain_min, grain_max)
    return g.permute(0, 2, 1, 3).reshape(nby * bh, nbx * bw)[:h, :w]


def _blend(a, wa, b, wb):
    """a*wa + b*wb with the reference's rounding: the first product fused
    into the sum."""
    return fma(a, wa, b * wb)


def _scaling_eval(v, lut):
    """Sample the 256-entry scaling LUT with linear filtering, as the
    reference samples its LUT texture (film_grain_av1.c:794)."""
    x = torch.clamp(v, 0.0, 1.0) * 255.0
    lo = torch.floor(x)
    f = x - lo
    lo_i = lo.long()
    hi_i = torch.clamp_max(lo_i + 1, fg.SCALING_LUT_SIZE - 1)
    return fma(lut[lo_i], 1.0 - f, lut[hi_i] * f)


def subsample_nearest(x, sub_x: int, sub_y: int, ph: int, pw: int):
    """Nearest-neighbour subsample of a full-resolution plane to a chroma
    grid (reference texelFetch at pos << sub, film_grain_av1.c:812)."""
    return x[..., ::1 << sub_y, :][..., :ph, ::1 << sub_x][..., :pw]


def apply_av1_grain(img, tables: GrainTables, cfg: GrainCfg,
                    scaling_shift: int, luma=None):
    """Apply AV1 grain to a plane (..., C, H, W); `luma` is the frame's
    luma at this plane's grid (the chroma grain's scaling input; a luma
    plane reads its own)."""
    h, w = img.shape[-2], img.shape[-1]
    bits = cfg.bits
    grain_center = 128 << (bits - 8)
    grain_scale = 1.0 / ((1 << bits) - 1)
    grain_min = -grain_center * grain_scale
    grain_max = ((256 << (bits - 8)) - 1 - grain_center) * grain_scale
    if cfg.limited_range:
        out_scale = (1 << bits) / ((1 << bits) - 1.0)
        min_value = 16 / 256.0 * out_scale
        max_luma = 235 / 256.0 * out_scale
        max_chroma = (240 / 256.0 * out_scale) if cfg.is_ycbcr else max_luma
    else:
        min_value, max_luma, max_chroma = 0.0, 1.0, 1.0
    if luma is None and 0 in cfg.channels:
        luma = img[..., cfg.channels.index(0), :, :]

    out = []
    for ci, (ch, act) in enumerate(zip(cfg.channels, cfg.active)):
        comp = img[..., ci, :, :]
        if not act:
            out.append(comp)
            continue
        ct = tables.chans[ci]
        grain = _assemble_plane(tables.offsets, ct, h, w,
                                cfg.sub_x if ch else 0,
                                cfg.sub_y if ch else 0, cfg.overlap,
                                grain_min, grain_max)
        if ch == 0 or cfg.chroma_scaling_from_luma:
            scale_in = comp if ch == 0 else luma
            vmax = max_luma if ch == 0 else max_chroma
        else:
            u = ct.uv_consts
            scale_in = fma(luma, u[0], comp * u[1]) + u[2]
            vmax = max_chroma
        scaling = _scaling_eval(scale_in, ct.scaling)
        out.append(torch.clamp(fma(scaling, grain, comp), min_value, vmax))
    return torch.stack(out, dim=-3)

"""H.274 / SMPTE RDD-5 film grain synthesis.

Counterpart of libplacebo_tpu/ops/film_grain_h274.py (the reference's
src/shaders/film_grain_h274.c): the 13x13 grain-slice database is
generated on the host from the spec tables (Gaussian LUT, seed LUT, R64T
integer transform — a data file of the port); per 8x8 block the average
intensity selects a (scale, h, v) model, a PCG3D hash of the 16x16
macroblock position jitters the slice offset, and the scaled grain is
added.

Every reachable slice offset is 8-row / 4-col aligned, so the host
builds the stack of all aligned 8x8 tiles once (104 x 207 tiles,
5.5 MB, kept on each device for the process) and the device gathers one
whole tile per block.  The hash depends on the seed and the block grid
only, so the host computes it in numpy uint32 (PyTorch has no complete
uint32 arithmetic) and uploads each channel's tile offsets and signs in
one pinned copy a frame (`prepare_h274`); the device adds the offset of
the model its block average selects.  The block average sums the 64
texels in row-major order, each add rounded, as the reference's
reduction does.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.fastmath import fma
from ..core.film_grain import FilmGrainData
from ..utils.device import arrays_to_device

__all__ = ["generate_grain_db", "apply_h274_grain", "needs_fg_h274",
           "prepare_h274", "H274Tables"]

_DB_SLICES = 13
_TILE_ROWS = 104     # 8-row aligned tile origins over the 832-row DB
_TILE_COLS = 207     # 4-col aligned origins of 8 columns over 832


def needs_fg_h274(data: Optional[FilmGrainData]) -> bool:
    if data is None or data.type != "h274" or data.h274 is None:
        return False
    return any(data.h274.component_model_present)


@lru_cache(maxsize=1)
def _tables():
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "h274_tables.npz")
    z = np.load(os.path.abspath(path))
    return (z["gaussian"].astype(np.int32), z["seed"].astype(np.uint64),
            z["r64t"].astype(np.int64))


def _prng_shift(state: int) -> int:
    feedback = 1 ^ (state >> 2) ^ (state >> 30)
    return ((state << 1) | (feedback & 1)) & 0xFFFFFFFF


def _generate_slice(h: int, v: int) -> np.ndarray:
    """One 64x64 grain slice (reference generate_slice,
    film_grain_h274.c:28-105): sparse random frequency coefficients,
    the inverse R64 transform on both axes, deblocked rows."""
    gauss, seed_lut, r64t = _tables()
    freq_h = ((h + 3) << 2) - 1
    freq_v = ((v + 3) << 2) - 1
    seed = int(seed_lut[h + v * 13])

    grain = np.zeros((64, 64), np.int64)       # indexed [x][y]
    for y in range(freq_v + 1):
        for x in range(0, freq_h + 1, 4):
            offset = seed % 2048
            grain[x:x + 4, y] = gauss[offset:offset + 4]
            seed = _prng_shift(seed)
    grain[0][0] = 0

    tmp = (grain[:, :freq_v + 1] @ r64t[:, :freq_v + 1].T).T
    tmp = (tmp + 128) >> 8
    out = tmp[:, :freq_h + 1] @ r64t[:, :freq_h + 1].T
    out = np.clip((out + 128) >> 8, -127, 127).astype(np.float64)

    deblock_factors = np.array([64, 71, 77, 84, 90, 96, 103, 109, 116,
                                122, 128, 128, 128], np.int64)
    dc = int(deblock_factors[v])
    res = out.copy()
    for y in range(64):
        if y % 8 in (0, 7):
            res[y] = (out[y].astype(np.int64) * dc) >> 7
    return (res / 255.0).astype(np.float32)


@lru_cache(maxsize=1)
def generate_grain_db() -> np.ndarray:
    """The (13*64, 13*64) grain database in the reference's
    fill_grain_lut layout (film_grain_h274.c:108-126): slice (h, v)
    fills rows [64h, 64h+64), cols [64v, 64v+64) — and the fetch side
    indexes rows by v and cols by h, the reference's own orientation,
    reproduced on both sides."""
    db = np.zeros((_DB_SLICES * 64, _DB_SLICES * 64), np.float32)
    for hh in range(_DB_SLICES):
        for v in range(_DB_SLICES):
            db[64 * hh:64 * hh + 64, 64 * v:64 * v + 64] = \
                _generate_slice(hh, v)
    return db


def _pcg3d(seed: int, wx: np.ndarray, wy: np.ndarray):
    """PCG3D hash (reference GLSL, film_grain_h274.c:164-176) in numpy
    uint32: wrapping products and sums, logical shifts."""
    u = np.uint32
    a, c = u(1664525), u(1013904223)
    x = np.full(np.broadcast(wx, wy).shape, seed & 0xFFFFFFFF, u)
    y = np.broadcast_to(np.asarray(wx, u), x.shape).copy()
    z = np.broadcast_to(np.asarray(wy, u), x.shape).copy()
    x = x * a + c
    y = y * a + c
    z = z * a + c
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> u(16))
    y = y ^ (y >> u(16))
    z = z ^ (z >> u(16))
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


@lru_cache(maxsize=1)
def _aligned_tile_stack() -> np.ndarray:
    """All 8-row / 4-col aligned 8x8 tiles of the grain DB, (104 * 207,
    8, 8): tile t = (oy // 8) * 207 + (ox // 4)."""
    win = np.lib.stride_tricks.sliding_window_view(generate_grain_db(),
                                                   (8, 8))
    tiles = win[::8, ::4]
    assert tiles.shape[:2] == (_TILE_ROWS, _TILE_COLS)
    return np.ascontiguousarray(tiles.reshape(-1, 8, 8).astype(np.float32))


@lru_cache(maxsize=8)
def _tiles_on(device: str) -> torch.Tensor:
    """The tile stack on `device`, uploaded once per process."""
    return torch.from_numpy(_aligned_tile_stack()).to(device)


class H274Tables(NamedTuple):
    """One plane's per-frame grain inputs: per channel of the plane,
    None (no model) or the (nby, nbx) int32 tile index of the block's
    jittered offset within slice (0, 0) and its float32 sign."""
    chans: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]


def _block_offsets(data: FilmGrainData, channels: Sequence[int], h: int,
                   w: int, row0: int = 0):
    """Host: per channel, (base tile index, sign) over the block grid of
    an h x w plane whose first row is plane row `row0` (a multiple of 8:
    the blocks of a row block are the plane's; reference
    film_grain_h274.c:230-242)."""
    nbx, nby = (w + 7) // 8, (h + 7) // 8
    bx = np.arange(nbx, dtype=np.int64)[None, :]
    by = row0 // 8 + np.arange(nby, dtype=np.int64)[:, None]
    pcg = _pcg3d(data.seed, (bx // 2).astype(np.uint32),
                 (by // 2).astype(np.uint32))
    out = []
    for ch in channels:
        if not data.h274.component_model_present[ch]:
            out.append(None)
            continue
        rand = pcg[ch]
        # the model's slice origin (h*64, v*64) is aligned to 8, so the
        # jitter's alignment masks apply to the jitter alone
        rx = (((rand >> np.uint32(16)) % np.uint32(52)).astype(np.int64)
              & ~3) + 8 * (bx % 2)
        ry = (((rand & np.uint32(0xFFFF)).astype(np.int64) % 56) & ~7) \
            + 8 * (by % 2)
        base = (ry >> 3) * _TILE_COLS + (rx >> 2)
        sign = np.where((rand & np.uint32(1)) == 1, -1.0, 1.0)
        out.append((base.astype(np.int32), sign.astype(np.float32)))
    return out


def prepare_h274(data: FilmGrainData, planes: Sequence[Tuple[Tuple[int, ...],
                                                             int, int]],
                 device, row0s: Optional[Sequence[int]] = None,
                 ) -> Tuple[Optional[H274Tables], ...]:
    """One frame's grain inputs for every plane — `planes` gives each
    plane's (channels, h, w), channels () for a plane without grain —
    uploaded in one pinned copy.  `row0s`: each plane's first row when
    the planes are row blocks of the frame's (multiples of 8)."""
    row0s = row0s or (0,) * len(planes)
    host = [_block_offsets(data, chans, h, w, r0) if chans else None
            for (chans, h, w), r0 in zip(planes, row0s)]
    flat = [a for plane in host if plane for ch in plane if ch for a in ch]
    dev = iter(arrays_to_device(flat, device)) if flat else iter(())
    out = []
    for plane in host:
        if plane is None:
            out.append(None)
            continue
        out.append(H274Tables(tuple(
            (next(dev), next(dev)) if ch is not None else None
            for ch in plane)))
    return tuple(out)


def _block_mean(x: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """(..., nby*8, nbx*8) -> (..., nby, nbx) block means: the 64 texels
    summed in row-major order, each add rounded, then / 64 (exact)."""
    t = x.reshape(*x.shape[:-2], nby, 8, nbx, 8)
    acc = t[..., 0, :, 0]
    for k in range(1, 64):
        acc = acc + t[..., k // 8, :, k % 8]
    return acc * (1.0 / 64.0)


def apply_h274_grain(img, data: FilmGrainData, channels: Tuple[int, ...],
                     is_ycbcr: bool = True,
                     tables: Optional[H274Tables] = None):
    """Apply H.274 grain to (..., C, H, W) [0, 1] plane values, whose C
    channels carry the canonical ids `channels` (reference
    apply_h274_grain, ops/film_grain_h274.py:154-230).  `tables` is the
    plane's `prepare_h274` entry; without it the hash runs here."""
    d = data.h274
    H, W = img.shape[-2], img.shape[-1]
    if tables is None:
        tables = prepare_h274(data, [(tuple(channels), H, W)],
                              img.device)[0]
    scale_factor = 1.0 / (1 << (d.log2_scale_factor + 6))
    nbx, nby = (W + 7) // 8, (H + 7) // 8
    Hp, Wp = nby * 8, nbx * 8
    x = torch.nn.functional.pad(img, (0, Wp - W, 0, Hp - H))
    avg = _block_mean(x, nby, nbx)
    tiles = _tiles_on(str(img.device))

    out_comps = []
    for ci, ch in enumerate(channels):
        comp = x[..., ci, :, :]
        if tables.chans[ci] is None:
            out_comps.append(comp)
            continue
        base, sign = tables.chans[ci]
        cavg = avg[..., ci, :, :]
        # the intensity interval's model; the first interval that holds
        # the block average wins, no interval scales the grain by 0
        val_scale = torch.zeros_like(cavg)
        tile_off = torch.zeros(cavg.shape, dtype=torch.int32,
                               device=img.device)
        hit = torch.zeros(cavg.shape, dtype=torch.bool, device=img.device)
        nmv = d.num_model_values[ch]
        for i in range(d.num_intensity_intervals[ch]):
            lo = float(np.float32(d.intensity_interval_lower_bound[ch][i]
                                  / 255.0))
            hi = float(np.float32(d.intensity_interval_upper_bound[ch][i]
                                  / 255.0))
            mv = d.comp_model_value[ch][i]
            hh = int(np.clip(mv[1] if nmv > 1 else 8, 2, 14)) - 2
            vv = int(np.clip(mv[2] if nmv > 2 else (mv[1] if nmv > 1
                                                     else 8), 2, 14)) - 2
            scale = int(mv[0])
            if ch > 0 and is_ycbcr:
                scale >>= 1
            m = (cavg >= lo) & (cavg <= hi) & ~hit
            val_scale = torch.where(m, float(np.float32(scale *
                                                        scale_factor)),
                                    val_scale)
            # slice (h, v) starts at row 64 v, col 64 h of the DB: 8 v
            # tile rows and 16 h tile columns on
            tile_off = torch.where(m, vv * 8 * _TILE_COLS + hh * 16,
                                   tile_off)
            hit = hit | m
        grain = tiles[(base + tile_off).reshape(-1)].reshape(nby, nbx, 8, 8)
        k = (val_scale * sign)[..., None, None]
        # comp + grain * k in one rounding, block by block
        blocks = comp.reshape(*comp.shape[:-2], nby, 8, nbx, 8).transpose(
            -3, -2)
        out_comps.append(fma(grain, k, blocks).transpose(-3, -2).reshape(
            comp.shape))
    out = torch.stack(out_comps, dim=-3)
    return torch.clamp(out[..., :H, :W], 0.0, 1.0)


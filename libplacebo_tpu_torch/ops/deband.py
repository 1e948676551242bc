"""Debanding + grain injection.

Counterpart of libplacebo_tpu/ops/deband.py (reference pl_shader_deband,
src/shaders/sampling.c:183-277): each iteration draws K candidate offset
vectors on the host, averages the 4-point rolled samples of each, and
every pixel picks one candidate with a per-pixel random index; the
average replaces the pixel where it stays within the threshold.  Then
uniform grain is added, scaled down near the plane's neutral value.

The per-pixel random tables are the reference's `jax.random` draws,
reproduced bit for bit on the host (core/threefry.py).  They depend only
on the plane's shape, the seed and the parameters, so the renderer draws
them once per signature and keeps them on the device.  The sharded
branch of the reference is multi-device work (ROADMAP slice 5).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import threefry
from ..core.colorspace import (ColorLevels, levels_guess,
                               system_is_ycbcr_like)
from ..core.fastmath import fma
from ..utils.device import device_constant

__all__ = ["DebandParams", "deband", "deband_rng_tables", "deband_tables",
           "plane_grain_neutral"]


@dataclass(frozen=True)
class DebandParams:
    """Reference pl_deband_params (shaders/sampling.h:66-104); defaults
    mirror pl_deband_default_params."""
    iterations: int = 1
    threshold: float = 3.0
    radius: float = 16.0
    grain: float = 4.0
    grain_neutral: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    candidates: int = 8          # offset draws per iteration

    def key(self):
        return (self.iterations, self.threshold, self.radius, self.grain,
                self.grain_neutral, self.candidates)


def plane_grain_neutral(repr, mapping) -> Tuple[float, ...]:
    """Per-plane-channel grain neutral values (reference
    renderer.c:1716-1761): limited-range luma rests at 16/256, chroma at
    0.5 (both rescaled by the sample depth's out_scale); non-YCbCr
    systems use the luma neutral for every channel; alpha gets 0."""
    bits = repr.bits.sample_depth
    out_scale = (1 << bits) / ((1 << bits) - 1.0) if bits else 1.0
    neutral_luma = 0.0
    neutral_chroma = 0.5 * out_scale
    if levels_guess(repr) == ColorLevels.LIMITED:
        neutral_luma = 16 / 256.0 * out_scale
    if not system_is_ycbcr_like(repr.sys):
        neutral_chroma = neutral_luma
    return tuple(0.0 if c == 3 else
                 (neutral_luma if c == 0 else neutral_chroma)
                 for c in mapping)


def _offset_draws(p: DebandParams, seed: int):
    """Host-side candidate offset vectors per iteration (numpy RNG,
    deterministic by seed): [(dxs, dys), ...]."""
    rng = np.random.default_rng(0xDEBA5D ^ seed)
    draws = []
    for i in range(1, p.iterations + 1):
        dists = rng.random(p.candidates) * i * p.radius
        angles = rng.random(p.candidates) * 2 * math.pi
        dxs = np.rint(dists * np.cos(angles)).astype(int)
        dys = np.rint(dists * np.sin(angles)).astype(int)
        draws.append((dxs, dys))
    return draws


@lru_cache(maxsize=16)
def deband_rng_tables(p: DebandParams, shape: Tuple[int, ...], seed: int):
    """The per-pixel random tables of one plane (..., C, H, W), as the
    reference draws them with jax.random: per iteration an (H, W) int32
    candidate choice, and the grain noise (shape, float32; None without
    grain).  numpy arrays; cached, so treat them as read-only."""
    h, w = shape[-2], shape[-1]
    key = threefry.PRNGKey(seed)
    choices = []
    for _ in range(p.iterations):
        key, sub = threefry.split(key)
        choices.append(threefry.randint(sub, (h, w), 0, p.candidates))
    noise = None
    if p.grain > 0:
        key, sub = threefry.split(key)
        noise = threefry.uniform(sub, tuple(shape))
    return choices, noise


def deband_tables(p: DebandParams, shape, seed: int, device):
    """deband_rng_tables as tensors on `device`."""
    choices, noise = deband_rng_tables(p, tuple(shape), seed)
    return ([torch.from_numpy(c).to(device) for c in choices],
            torch.from_numpy(noise).to(device) if noise is not None
            else None)


def deband(img, params: Optional[DebandParams] = None, seed: int = 0,
           scale: float = 1.0, tables=None, neutral=None):
    """Deband a (..., C, H, W) plane.  `scale` is the color scale of the
    samples (thresholds are in 8-bit-like units, divided by it);
    `tables` are (choices, noise) from deband_tables (drawn here when
    None); `neutral` gives this plane's per-channel grain neutral
    values (plane_grain_neutral), overriding params.grain_neutral."""
    p = params or DebandParams()
    if tables is None:
        tables = deband_tables(p, img.shape, seed, img.device)
    choices, noise = tables

    res = img
    if p.iterations > 0:
        threshold = p.threshold / (1000.0 * scale)
        for it, (dxs, dys) in enumerate(_offset_draws(p, seed)):
            avg = torch.zeros_like(res)
            for k in range(p.candidates):
                dx, dy = int(dxs[k]), int(dys[k])
                s = torch.roll(res, dy, -2) + torch.roll(res, -dy, -2)
                a = (torch.roll(s, dx, -1) + torch.roll(s, -dx, -1)) * 0.25
                avg = torch.where(choices[it] == k, a, avg)
            diff = torch.abs(res - avg)
            res = torch.where(diff > threshold / (it + 1), res, avg)

    if p.grain > 0:
        c = res.shape[-3]
        ntr = np.asarray(p.grain_neutral if neutral is None else neutral,
                         np.float32).ravel()
        ntr = np.pad(ntr[:c], (0, max(0, c - ntr[:c].size))) / scale
        ntr = device_constant(tuple(ntr.astype(np.float32).tolist()),
                              res.device).reshape(-1, 1, 1)
        strength = torch.clamp_max(torch.abs(res - ntr),
                                   p.grain / (1000.0 * scale))
        res = fma(strength, noise - 0.5, res)
    return res

"""Film-grain metadata (AV1 and H.274) and AV1's host-side tables.

Counterpart of libplacebo_tpu/core/film_grain.py (the CPU half of the
reference's src/shaders/film_grain_av1.c: generate_grain_y:303,
generate_grain_uv:351, generate_offsets:434, generate_scaling:468).  The
grain LUTs and the per-block offsets come from the native copy of the
reference package's `grain.cc` (AV1 spec §7.18.3 arithmetic: the LFSR,
the gaussian sequence, the auto-regressive filter with fixed-point
rounding); the scaling LUT is the spec's fixed-point piecewise-linear
table.  The 2048-entry gaussian sequence is a data file of the port.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from .. import native

__all__ = ["AV1GrainData", "H274GrainData", "FilmGrainData", "sample_grain",
           "generate_grain_y",
           "generate_grain_uv", "generate_offsets", "generate_scaling",
           "BLOCK_SIZE", "SCALING_LUT_SIZE"]

BLOCK_SIZE = 32
SCALING_LUT_SIZE = 256


@lru_cache(maxsize=1)
def _gaussian_sequence() -> np.ndarray:
    return np.load(os.path.join(os.path.dirname(__file__), "..", "data",
                                "av1_gaussian_sequence.npy"))


@dataclass(frozen=True)
class AV1GrainData:
    """Reference pl_av1_grain_data (shaders/film_grain.h:40-80)."""
    num_points_y: int = 0
    points_y: Tuple[Tuple[int, int], ...] = ()
    chroma_scaling_from_luma: bool = False
    num_points_uv: Tuple[int, int] = (0, 0)
    points_uv: Tuple[Tuple[Tuple[int, int], ...], ...] = ((), ())
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: Tuple[int, ...] = ()
    ar_coeffs_uv: Tuple[Tuple[int, ...], ...] = ((), ())
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    uv_mult: Tuple[int, int] = (0, 0)
    uv_mult_luma: Tuple[int, int] = (0, 0)
    uv_offset: Tuple[int, int] = (0, 0)
    overlap: bool = True


@dataclass(frozen=True)
class H274GrainData:
    """Reference pl_h274_grain_data (SMPTE RDD-5 / H.274 SEI)."""
    model_id: int = 0
    blending_mode_id: int = 0
    log2_scale_factor: int = 0
    component_model_present: Tuple[bool, bool, bool] = (False, False, False)
    num_intensity_intervals: Tuple[int, ...] = (0, 0, 0)
    num_model_values: Tuple[int, ...] = (0, 0, 0)
    intensity_interval_lower_bound: Tuple = ((), (), ())
    intensity_interval_upper_bound: Tuple = ((), (), ())
    comp_model_value: Tuple = ((), (), ())


@dataclass(frozen=True)
class FilmGrainData:
    """Reference pl_film_grain_data (film_grain.h:82-100): AV1 or H.274
    grain; the seed may change every frame."""
    type: str = "av1"            # "av1" | "h274" | "none"
    seed: int = 0
    av1: Optional[AV1GrainData] = None
    h274: Optional[H274GrainData] = None


def sample_grain(seed: int = 7391) -> FilmGrainData:
    """A representative AV1 grain description (values typical of AV1
    streams): 6 luma and 2+2 chroma scaling points, lag-3
    auto-regression, overlap on.  The same integers as the reference
    package's grain tests (tests/test_film_grain.py::GRAIN), so both
    packages can be given the same grain."""
    rng = np.random.default_rng
    return FilmGrainData(type="av1", seed=seed, av1=AV1GrainData(
        num_points_y=6,
        points_y=((0, 4), (20, 5), (39, 5), (59, 5), (78, 5), (255, 40)),
        chroma_scaling_from_luma=False,
        num_points_uv=(2, 2),
        points_uv=(((0, 8), (255, 18)), ((0, 6), (255, 14))),
        scaling_shift=11,
        ar_coeff_lag=3,
        ar_coeffs_y=tuple(int(v) for v in rng(5).integers(-30, 30, 24)),
        ar_coeffs_uv=(tuple(int(v) for v in rng(6).integers(-20, 20, 25)),
                      tuple(int(v) for v in rng(7).integers(-20, 20, 25))),
        ar_coeff_shift=7,
        grain_scale_shift=0,
        uv_mult=(64, 64), uv_mult_luma=(32, 32), uv_offset=(0, 0),
        overlap=True))


@lru_cache(maxsize=32)
def generate_grain_y(data: AV1GrainData, seed: int, bits: int = 8,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(lut (64, 64) float32 normalized, raw int16 (73, 82) buffer); the
    raw buffer feeds chroma generation."""
    return native.grain_y_native(
        _gaussian_sequence(), seed, bits, data.grain_scale_shift,
        data.ar_coeff_lag, data.ar_coeffs_y, data.ar_coeff_shift)


@lru_cache(maxsize=32)
def generate_grain_uv(data: AV1GrainData, seed: int, channel: int,
                      sub_x: int, sub_y: int, bits: int = 8) -> np.ndarray:
    """Chroma grain LUT for channel 1 (Cb) or 2 (Cr); shape
    (64 >> sub_y, 64 >> sub_x) float32."""
    _, buf_y = generate_grain_y(data, seed, bits)
    return native.grain_uv_native(
        _gaussian_sequence(), seed, channel, sub_x, sub_y, bits,
        data.grain_scale_shift, data.num_points_y, data.ar_coeff_lag,
        data.ar_coeffs_uv[channel - 1], data.ar_coeff_shift, buf_y)


@lru_cache(maxsize=64)
def generate_offsets(seed: int, blocks_w: int, blocks_h: int) -> np.ndarray:
    """Per-block packed offsets, uint32 = tl<<24 | t<<16 | l<<8 | n, each
    an 8-bit random (high nibble x, low nibble y)."""
    return native.grain_offsets_native(seed, blocks_w, blocks_h)


def generate_scaling(points: Tuple[Tuple[int, int], ...],
                     scaling_shift: int) -> np.ndarray:
    """256-entry piecewise-linear scaling LUT with the spec's fixed-point
    delta arithmetic (reference generate_scaling,
    film_grain_av1.c:468-497)."""
    data = np.zeros(SCALING_LUT_SIZE, np.float32)
    if not points:
        return data
    rng = float(1 << scaling_shift)
    pts = list(points)
    data[:pts[0][0]] = pts[0][1] / rng
    for i in range(len(pts) - 1):
        bx, by = pts[i]
        dx = pts[i + 1][0] - bx
        dy = pts[i + 1][1] - by
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        for x in range(dx):
            data[bx + x] = (by + ((x * delta + 0x8000) >> 16)) / rng
    data[pts[-1][0]:] = pts[-1][1] / rng
    return data

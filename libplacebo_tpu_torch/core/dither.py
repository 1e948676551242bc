"""Dither matrices (host numpy): Bayer and blue noise, and the
error-diffusion kernels.

Counterpart of libplacebo_tpu/core/dither.py.  Blue noise comes only
from the native void-and-cluster generator (native/dither.cc): the
reference package's pure-Python fallback orders ranks differently, so
the port has no fallback and raises if the native build fails.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["DitherMethod", "bayer_matrix", "blue_noise",
           "ErrorDiffusionKernel", "ERROR_DIFFUSION_KERNELS",
           "ED_FLOYD_STEINBERG", "find_error_diffusion_kernel"]


class DitherMethod(enum.Enum):
    BLUE_NOISE = "blue"
    ORDERED_LUT = "ordered_lut"   # bayer via LUT
    ORDERED_FIXED = "ordered"     # bayer 16x16
    WHITE_NOISE = "white"


@lru_cache(maxsize=16)
def bayer_matrix(size: int) -> np.ndarray:
    """Normalized `size`x`size` Bayer matrix in [0,1) (no centering)."""
    assert size >= 1 and (size & (size - 1)) == 0, "size must be power of 2"
    m = np.zeros((1, 1), dtype=np.int64)
    n = 1
    while n < size:
        m = np.block([[4 * m + 0, 4 * m + 2],
                      [4 * m + 3, 4 * m + 1]])
        n *= 2
    return (m.astype(np.float64) / (size * size)).astype(np.float32)


@lru_cache(maxsize=8)
def blue_noise(shift: int) -> np.ndarray:
    """(2^shift)x(2^shift) blue-noise matrix in [0,1)."""
    from ..native import blue_noise_native
    return blue_noise_native(shift)


# ---------------------------------------------------------------------------
# Error-diffusion kernels (reference dither.c:192-305).  The 5x3 pattern is
# centered on column index 2; `shift` is the horizontal block shift of the
# wavefront: row y+1 may start `shift` columns after row y.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ErrorDiffusionKernel:
    name: str
    description: str
    shift: int
    pattern: Tuple[Tuple[int, ...], ...]   # 3 rows x 5 cols, centered at [0][2]
    divisor: int


ED_SIMPLE = ErrorDiffusionKernel(
    "simple", "Simple error diffusion", 1,
    ((0, 0, 0, 1, 0), (0, 0, 1, 0, 0), (0, 0, 0, 0, 0)), 2)
ED_FALSE_FS = ErrorDiffusionKernel(
    "false-fs", "False Floyd-Steinberg kernel", 1,
    ((0, 0, 0, 3, 0), (0, 0, 3, 2, 0), (0, 0, 0, 0, 0)), 8)
ED_SIERRA_LITE = ErrorDiffusionKernel(
    "sierra-lite", "Sierra Lite kernel", 2,
    ((0, 0, 0, 2, 0), (0, 1, 1, 0, 0), (0, 0, 0, 0, 0)), 4)
ED_FLOYD_STEINBERG = ErrorDiffusionKernel(
    "floyd-steinberg", "Floyd Steinberg kernel", 2,
    ((0, 0, 0, 7, 0), (0, 3, 5, 1, 0), (0, 0, 0, 0, 0)), 16)
ED_ATKINSON = ErrorDiffusionKernel(
    "atkinson", "Atkinson kernel", 2,
    ((0, 0, 0, 1, 1), (0, 1, 1, 1, 0), (0, 0, 1, 0, 0)), 8)
ED_JARVIS_JUDICE_NINKE = ErrorDiffusionKernel(
    "jarvis-judice-ninke", "Jarvis, Judice & Ninke kernel", 3,
    ((0, 0, 0, 7, 5), (3, 5, 7, 5, 3), (1, 3, 5, 3, 1)), 48)
ED_STUCKI = ErrorDiffusionKernel(
    "stucki", "Stucki kernel", 3,
    ((0, 0, 0, 8, 4), (2, 4, 8, 4, 2), (1, 2, 4, 2, 1)), 42)
ED_BURKES = ErrorDiffusionKernel(
    "burkes", "Burkes kernel", 3,
    ((0, 0, 0, 8, 4), (2, 4, 8, 4, 2), (0, 0, 0, 0, 0)), 32)
ED_SIERRA2 = ErrorDiffusionKernel(
    "sierra-2", "Two-row Sierra", 3,
    ((0, 0, 0, 4, 3), (1, 2, 3, 2, 1), (0, 0, 0, 0, 0)), 16)
ED_SIERRA3 = ErrorDiffusionKernel(
    "sierra-3", "Three-row Sierra", 3,
    ((0, 0, 0, 5, 3), (2, 4, 5, 4, 2), (0, 2, 3, 2, 0)), 32)

ERROR_DIFFUSION_KERNELS = [
    ED_SIMPLE, ED_FALSE_FS, ED_SIERRA_LITE, ED_FLOYD_STEINBERG, ED_ATKINSON,
    ED_JARVIS_JUDICE_NINKE, ED_STUCKI, ED_BURKES, ED_SIERRA2, ED_SIERRA3,
]

_ED_BY_NAME: Dict[str, ErrorDiffusionKernel] = {
    k.name: k for k in ERROR_DIFFUSION_KERNELS}


def find_error_diffusion_kernel(name: str) -> Optional[ErrorDiffusionKernel]:
    return _ED_BY_NAME.get(name)

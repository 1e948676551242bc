"""Custom LUT (.cube) parsing.

Counterpart of libplacebo_tpu/core/lut.py (reference pl_lut_parse_cube,
src/shaders/lut.c:35-210): Adobe/Resolve .cube 1D and 3D LUT parsing
with DOMAIN_MIN/MAX support and the conversion hints the reference
exposes (pl_lut.repr_in/out etc. are left to the caller here).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

__all__ = ["CustomLut", "parse_cube"]


@dataclass
class CustomLut:
    """Reference pl_custom_lut (shaders/lut.h)."""
    data: np.ndarray             # 1D: (N, 3); 3D: (B, G, R, 3) float32
    size: Tuple[int, ...] = ()   # (N,) or (R, G, B)
    domain_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    domain_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    signature: int = 0

    @property
    def is_3d(self) -> bool:
        return len(self.size) == 3


def parse_cube(text: str) -> CustomLut:
    """Parse a .cube file's contents (reference pl_lut_parse_cube)."""
    size_1d = 0
    size_3d = 0
    dmin = (0.0, 0.0, 0.0)
    dmax = (1.0, 1.0, 1.0)
    values = []

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "TITLE":
            continue
        try:
            if key == "LUT_1D_SIZE":
                size_1d = int(parts[1])
                continue
            if key == "LUT_3D_SIZE":
                size_3d = int(parts[1])
                continue
            if key == "DOMAIN_MIN":
                dmin = (float(parts[1]), float(parts[2]), float(parts[3]))
                continue
            if key == "DOMAIN_MAX":
                dmax = (float(parts[1]), float(parts[2]), float(parts[3]))
                continue
        except (IndexError, ValueError) as e:
            raise ValueError(f"invalid .cube header line: {raw!r}") from e
        if size_1d < 0 or size_3d < 0 or size_1d > 1 << 20 \
                or size_3d > 512:
            raise ValueError("unreasonable .cube LUT size")
        try:
            values.append([float(x) for x in parts[:3]])
        except ValueError as e:
            raise ValueError(f"invalid .cube line: {raw!r}") from e

    arr = np.asarray(values, dtype=np.float32)
    sig = hash((size_1d, size_3d, dmin, dmax, arr.tobytes())) & (2**63 - 1)
    if size_3d:
        expect = size_3d ** 3
        if arr.shape != (expect, 3):
            raise ValueError(
                f"expected {expect} 3DLUT entries, got {arr.shape[0]}")
        # .cube files iterate R fastest, then G, then B
        data = arr.reshape(size_3d, size_3d, size_3d, 3)  # (B, G, R, 3)
        return CustomLut(data=data, size=(size_3d,) * 3,
                         domain_min=dmin, domain_max=dmax, signature=sig)
    if size_1d:
        if arr.shape != (size_1d, 3):
            raise ValueError(
                f"expected {size_1d} 1DLUT entries, got {arr.shape[0]}")
        return CustomLut(data=arr, size=(size_1d,),
                         domain_min=dmin, domain_max=dmax, signature=sig)
    raise ValueError("missing LUT_1D_SIZE / LUT_3D_SIZE")

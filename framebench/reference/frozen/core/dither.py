"""The blue-noise dither matrix (host numpy).

Counterpart of libplacebo_tpu/core/dither.py, cut to `blue_noise`, which
comes from the native void-and-cluster generator (native/dither.cc)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["blue_noise"]


@lru_cache(maxsize=8)
def blue_noise(shift: int) -> np.ndarray:
    """(2^shift)x(2^shift) blue-noise matrix in [0,1)."""
    from ..native import blue_noise_native
    return blue_noise_native(shift)

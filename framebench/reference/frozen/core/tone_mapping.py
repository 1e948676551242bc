"""Tone-mapping constants (reference tone_mapping.h:86-160).

Counterpart of libplacebo_tpu/core/tone_mapping.py, cut to what the
benchmark's reference reads: the spline curve itself is
`ops/tone_dynamic.py`'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ToneMapConstants:
    """Tunable constants; defaults mirror PL_TONE_MAP_CONSTANTS
    (tone_mapping.h:116-127)."""
    knee_adaptation: float = 0.4
    knee_minimum: float = 0.1
    knee_maximum: float = 0.8
    knee_default: float = 0.4
    knee_offset: float = 1.0
    slope_tuning: float = 1.5
    slope_offset: float = 0.2
    spline_contrast: float = 0.5
    reinhard_contrast: float = 0.5
    linear_knee: float = 0.3
    exposure: float = 1.0

    def fixed(self) -> "ToneMapConstants":
        """Clamp all constants into their legal ranges
        (tone_mapping.c fix_constants)."""
        eps = 1e-6
        c = self
        knee_min = float(np.clip(c.knee_minimum, eps, 0.5 - eps))
        knee_max = float(np.clip(c.knee_maximum, 0.5 + eps, 1.0 - eps))
        return ToneMapConstants(
            knee_adaptation=float(np.clip(c.knee_adaptation, 0.0, 1.0)),
            knee_minimum=knee_min,
            knee_maximum=knee_max,
            knee_default=float(np.clip(c.knee_default, knee_min, knee_max)),
            knee_offset=float(np.clip(c.knee_offset, 0.5, 2.0)),
            slope_tuning=float(np.clip(c.slope_tuning, 0.0, 10.0)),
            slope_offset=float(np.clip(c.slope_offset, 0.0, 1.0)),
            spline_contrast=float(np.clip(c.spline_contrast, 0.0, 1.5)),
            reinhard_contrast=float(np.clip(c.reinhard_contrast, eps,
                                            1 - eps)),
            linear_knee=float(np.clip(c.linear_knee, eps, 1 - eps)),
            exposure=float(np.clip(c.exposure, eps, 10.0)),
        )

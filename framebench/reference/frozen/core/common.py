"""3x3 matrices on numpy float64 for host planning.

Counterpart of libplacebo_tpu/core/common.py (reference common.h), cut
to `Matrix3x3`."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Matrix3x3"]


# ---------------------------------------------------------------------------
# Matrices (reference: common.h pl_matrix3x3 / pl_transform3x3)
# ---------------------------------------------------------------------------

def _ident3() -> np.ndarray:
    return np.eye(3, dtype=np.float64)


@dataclass
class Matrix3x3:
    m: np.ndarray = field(default_factory=_ident3)

    def __post_init__(self):
        self.m = np.asarray(self.m, dtype=np.float64).reshape(3, 3)

    @classmethod
    def identity(cls) -> "Matrix3x3":
        return cls(_ident3())

"""Geometry & small linear-algebra primitives used by host planning
(counterpart of libplacebo_tpu/core/common.py: the rect and 3x3 matrix
types the main path reaches)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["RectF", "Matrix3x3", "Transform3x3"]


@dataclass(frozen=True)
class RectF:
    x0: float = 0.0
    y0: float = 0.0
    x1: float = 0.0
    y1: float = 0.0

    @property
    def w(self) -> float:
        return abs(self.x1 - self.x0)

    @property
    def h(self) -> float:
        return abs(self.y1 - self.y0)

    def normalized(self) -> "RectF":
        return RectF(min(self.x0, self.x1), min(self.y0, self.y1),
                     max(self.x0, self.x1), max(self.y0, self.y1))


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

    def apply(self, vec) -> np.ndarray:
        return self.m @ np.asarray(vec, dtype=np.float64)

    def invert(self) -> "Matrix3x3":
        return Matrix3x3(np.linalg.inv(self.m))

    def __matmul__(self, other: "Matrix3x3") -> "Matrix3x3":
        return Matrix3x3(self.m @ other.m)


@dataclass
class Transform3x3:
    """Affine transform: out = mat @ in + c."""
    mat: Matrix3x3 = field(default_factory=Matrix3x3.identity)
    c: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def __post_init__(self):
        if not isinstance(self.mat, Matrix3x3):
            self.mat = Matrix3x3(self.mat)
        self.c = np.asarray(self.c, dtype=np.float64).reshape(3)

    def invert(self) -> "Transform3x3":
        inv = self.mat.invert()
        return Transform3x3(inv, -inv.apply(self.c))

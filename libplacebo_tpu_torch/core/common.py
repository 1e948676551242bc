"""Geometry & small linear-algebra primitives for host planning.

Counterpart of libplacebo_tpu/core/common.py (reference src/common.c,
common.h): integer and float rects with the reference's aspect, stretch,
zoom, offset and rotation helpers, 2x2 and 3x3 matrices and affine
transforms on Python floats / numpy float64, and `Rotation`, quarter
turns as an `int` subclass.  None of it touches a tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Rect",
    "RectF",
    "Matrix3x3",
    "Transform3x3",
    "Matrix2x2",
    "Transform2x2",
    "Rotation",
    "aspect_rotate",
]


# ---------------------------------------------------------------------------
# Rects (reference: common.h `pl_rect2d` / `pl_rect2df`)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rect:
    """Integer rectangle; follows the reference convention that x0/y0 need not
    be smaller than x1/y1 (a flipped rect implies a flipped image)."""
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0

    @property
    def w(self) -> int:
        return abs(self.x1 - self.x0)

    @property
    def h(self) -> int:
        return abs(self.y1 - self.y0)

    def normalized(self) -> "Rect":
        return Rect(min(self.x0, self.x1), min(self.y0, self.y1),
                    max(self.x0, self.x1), max(self.y0, self.y1))

    def __bool__(self) -> bool:
        return self.w != 0 and self.h != 0


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

    def rounded(self) -> Rect:
        return Rect(int(round(self.x0)), int(round(self.y0)),
                    int(round(self.x1)), int(round(self.y1)))

    def aspect(self) -> float:
        return (self.w / self.h) if self.h else 0.0

    def midx(self) -> float:
        return (self.x0 + self.x1) / 2.0

    def midy(self) -> float:
        return (self.y0 + self.y1) / 2.0

    def stretch(self, aspect: float, panscan: float = 0.0) -> "RectF":
        """Set the aspect of the rect while keeping its midpoint fixed
        (reference `pl_rect2df_aspect_set`, common.h:~180). `panscan` blends
        between letterbox (0.0) and pan&scan crop (1.0)."""
        if aspect <= 0 or not self.h:
            return self
        cur = self.aspect()
        if cur == 0:
            return self
        scale_x, scale_y = 1.0, 1.0
        if aspect > cur:
            # target wider: either pad left/right (letterbox ⇒ shrink y)
            scale_x = (aspect / cur) ** panscan
            scale_y = (cur / aspect) ** (1.0 - panscan)
        else:
            scale_x = (aspect / cur) ** (1.0 - panscan)
            scale_y = (cur / aspect) ** panscan
        mx, my = self.midx(), self.midy()
        hw, hh = self.w / 2.0 * scale_x, self.h / 2.0 * scale_y
        sx = 1.0 if self.x1 >= self.x0 else -1.0
        sy = 1.0 if self.y1 >= self.y0 else -1.0
        return RectF(mx - sx * hw, my - sy * hh, mx + sx * hw, my + sy * hh)

    def stretch_xy(self, stretch_x: float, stretch_y: float) -> "RectF":
        """Scale the rect around its midpoint (reference
        `pl_rect2df_stretch`, common.c:445)."""
        mx, my = self.midx(), self.midy()
        return RectF(self.x0 * stretch_x + mx * (1.0 - stretch_x),
                     self.y0 * stretch_y + my * (1.0 - stretch_y),
                     self.x1 * stretch_x + mx * (1.0 - stretch_x),
                     self.y1 * stretch_y + my * (1.0 - stretch_y))

    def zoom(self, z: float) -> "RectF":
        """Uniform stretch (reference `pl_rect2df_zoom`, common.h:203)."""
        return self.stretch_xy(z, z)

    def offset(self, offset_x: float, offset_y: float) -> "RectF":
        """Shift the rect, respecting flipped axes (reference
        `pl_rect2df_offset`, common.c:456): a flipped axis inverts the
        offset direction so "right/down" stays in content space."""
        if self.x1 < self.x0:
            offset_x = -offset_x
        if self.y1 < self.y0:
            offset_y = -offset_y
        return RectF(self.x0 + offset_x, self.y0 + offset_y,
                     self.x1 + offset_x, self.y1 + offset_y)

    def aspect_copy(self, src: "RectF", panscan: float = 0.0) -> "RectF":
        """Adopt `src`'s aspect ratio (reference `pl_rect2df_aspect_copy`,
        common.h:187)."""
        return self.stretch(src.aspect(), panscan)

    def aspect_fit(self, src: "RectF", panscan: float = 0.0) -> "RectF":
        """Shrink-to-fit `src`'s dimensions while preserving this rect's
        midpoint: downscale if `src` is smaller in either dimension, else
        just adopt its aspect (reference `pl_rect2df_aspect_fit`,
        common.c:426)."""
        ow, oh = self.w, self.h
        if not ow or not oh:
            return self
        scale_x, scale_y = src.w / ow, src.h / oh
        if scale_x > 1.0 or scale_y > 1.0:
            return self.aspect_copy(src, panscan)
        return self.stretch_xy(scale_x, scale_y)

    def rotate(self, rot: "Rotation") -> "RectF":
        """Rotate the rect's coordinate SYSTEM by `rot` (reference
        `pl_rect2df_rotate`, common.c:469): 180° swaps both corner pairs,
        90° maps (x,y)→(y1..y0, x0..x1)."""
        rot = Rotation(rot)
        x0, y0, x1, y1 = self.x0, self.y0, self.x1, self.y1
        if rot >= Rotation.ROT_180:
            rot = Rotation(rot - Rotation.ROT_180)
            x0, x1 = x1, x0
            y0, y1 = y1, y0
        if rot == Rotation.ROT_0:
            return RectF(x0, y0, x1, y1)
        return RectF(y1, x0, y0, x1)


def aspect_rotate(aspect: float, rot: "Rotation") -> float:
    """Aspect ratio in a rotated frame of reference (reference
    `pl_aspect_rotate`, common.h:231)."""
    return (1.0 / aspect) if (Rotation(rot).transposed and aspect) else aspect


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

    def apply(self, vec) -> np.ndarray:
        return self.m @ np.asarray(vec, dtype=np.float64)

    def invert(self) -> "Matrix3x3":
        return Matrix3x3(np.linalg.inv(self.m))

    def scale(self, s: float) -> "Matrix3x3":
        """Reference pl_matrix3x3_scale (common.c)."""
        return Matrix3x3(self.m * s)

    def __matmul__(self, other: "Matrix3x3") -> "Matrix3x3":
        return Matrix3x3(self.m @ other.m)

    def __eq__(self, other) -> bool:
        return isinstance(other, Matrix3x3) and np.allclose(self.m, other.m)


@dataclass
class Transform3x3:
    """Affine transform: out = mat @ in + c (reference pl_transform3x3)."""
    mat: Matrix3x3 = field(default_factory=Matrix3x3.identity)
    c: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def __post_init__(self):
        if not isinstance(self.mat, Matrix3x3):
            self.mat = Matrix3x3(self.mat)
        self.c = np.asarray(self.c, dtype=np.float64).reshape(3)

    @classmethod
    def identity(cls) -> "Transform3x3":
        return cls()

    def apply(self, vec) -> np.ndarray:
        return self.mat.apply(vec) + self.c

    def invert(self) -> "Transform3x3":
        inv = self.mat.invert()
        return Transform3x3(inv, -inv.apply(self.c))

    def compose(self, inner: "Transform3x3") -> "Transform3x3":
        """self ∘ inner: apply `inner` first, then `self`."""
        return Transform3x3(self.mat @ inner.mat, self.mat.apply(inner.c) + self.c)

    def scale(self, s: float) -> "Transform3x3":
        """Reference pl_transform3x3_scale (common.c)."""
        return Transform3x3(self.mat.scale(s), self.c * s)


@dataclass
class Matrix2x2:
    m: np.ndarray = field(default_factory=lambda: np.eye(2))

    def __post_init__(self):
        self.m = np.asarray(self.m, dtype=np.float64).reshape(2, 2)

    @classmethod
    def identity(cls) -> "Matrix2x2":
        return cls(np.eye(2))

    @classmethod
    def rotation(cls, radians: float) -> "Matrix2x2":
        """Counter-clockwise rotation matrix (reference
        pl_matrix2x2_rotation, common.c:252)."""
        c, s = math.cos(radians), math.sin(radians)
        return cls(np.array([[c, -s], [s, c]]))

    def apply(self, vec) -> np.ndarray:
        return self.m @ np.asarray(vec, dtype=np.float64)

    def apply_rc(self, rc: RectF) -> RectF:
        """Map both corners through the matrix (reference
        pl_matrix2x2_apply_rc, common.c:268)."""
        x0, y0 = self.apply((rc.x0, rc.y0))
        x1, y1 = self.apply((rc.x1, rc.y1))
        return RectF(float(x0), float(y0), float(x1), float(y1))

    def invert(self) -> "Matrix2x2":
        return Matrix2x2(np.linalg.inv(self.m))

    def scale(self, s: float) -> "Matrix2x2":
        return Matrix2x2(self.m * s)

    def __matmul__(self, other: "Matrix2x2") -> "Matrix2x2":
        return Matrix2x2(self.m @ other.m)

    def __eq__(self, other) -> bool:
        return isinstance(other, Matrix2x2) and np.allclose(self.m, other.m)


@dataclass
class Transform2x2:
    """Affine 2D transform: out = mat @ in + c (reference pl_transform2x2,
    common.h + ops common.c:325-397)."""
    mat: Matrix2x2 = field(default_factory=Matrix2x2)
    c: np.ndarray = field(default_factory=lambda: np.zeros(2))

    def __post_init__(self):
        if not isinstance(self.mat, Matrix2x2):
            self.mat = Matrix2x2(self.mat)
        self.c = np.asarray(self.c, dtype=np.float64).reshape(2)

    @classmethod
    def identity(cls) -> "Transform2x2":
        return cls()

    def apply(self, vec) -> np.ndarray:
        return self.mat.apply(vec) + self.c

    def apply_rc(self, rc: RectF) -> RectF:
        """Reference pl_transform2x2_apply_rc (common.c:334)."""
        out = self.mat.apply_rc(rc)
        return RectF(out.x0 + self.c[0], out.y0 + self.c[1],
                     out.x1 + self.c[0], out.y1 + self.c[1])

    def compose(self, inner: "Transform2x2") -> "Transform2x2":
        """self ∘ inner: apply `inner` first, then `self` (reference
        pl_transform2x2_mul's a ← a∘b, common.c:344)."""
        return Transform2x2(self.mat @ inner.mat, self.apply(inner.c))

    def invert(self) -> "Transform2x2":
        """Reference pl_transform2x2_invert (common.c:366)."""
        inv = self.mat.invert()
        return Transform2x2(inv, -inv.apply(self.c))

    def scale(self, s: float) -> "Transform2x2":
        """Reference pl_transform2x2_scale (common.c:358)."""
        return Transform2x2(self.mat.scale(s), self.c * s)

    def bounds(self, rc: RectF) -> RectF:
        """Axis-aligned bounding box of the transformed rect (reference
        pl_transform2x2_bounds, common.c:376) — used to size the output
        of affine distortion."""
        pts = [self.apply((x, y)) for x in (rc.x0, rc.x1)
               for y in (rc.y0, rc.y1)]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        return RectF(min(xs), min(ys), max(xs), max(ys))


# ---------------------------------------------------------------------------
# Rotation (reference: pl_rotation, common.h)
# ---------------------------------------------------------------------------

class Rotation(int):
    """Rotation in multiples of 90° counter-clockwise; normalized mod 4."""
    ROT_0, ROT_90, ROT_180, ROT_270 = 0, 1, 2, 3

    def __new__(cls, quarters: int = 0):
        return super().__new__(cls, quarters % 4)

    @property
    def transposed(self) -> bool:
        return self % 2 == 1

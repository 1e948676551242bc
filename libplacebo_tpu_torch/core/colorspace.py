"""Colorimetry metadata & host-side matrix math (numpy float64).

Counterpart of libplacebo_tpu/core/colorspace.py, cut to what the main
render path reaches: the enums, `ColorRepr`/`ColorSpace` with their
inference rules, the primaries tables and RGB<->XYZ / adaptation
matrices, the gamut clip used by perceptual mapping, and the decode
transform of the linear (matrix) YCbCr systems.  Conventions are the
reference's: linear light is NORM (1.0 == 203 cd/m² SDR white).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np

from .common import Matrix3x3, Transform3x3

__all__ = [
    "ColorSystem", "ColorLevels", "AlphaMode", "ColorPrimaries",
    "ColorTransfer", "HdrScaling", "CIExy", "RawPrimaries", "BitEncoding",
    "HdrMetadata", "DoviMetadata", "ColorRepr", "ColorSpace",
    "COLOR_SDR_WHITE",
    "COLOR_HDR_BLACK", "CSP_SRGB", "CSP_BT2100_PQ",
    "hdr_rescale", "primaries_get", "primaries_guess",
    "color_space_infer_map", "rgb_to_xyz_matrix", "adapt_white_matrix",
    "color_mapping_matrix", "primaries_compatible", "primaries_clip",
    "color_repr_decode", "luma_coeffs", "transfer_is_hdr",
    "ictcp_matrices", "xyz_to_rgb_matrix",
    "transfer_nominal_peak", "levels_guess", "system_is_ycbcr_like",
    "ColorAdjustment", "COLOR_ADJUSTMENT_NEUTRAL", "white_from_temp",
    "daylight_from_temp", "blackbody_from_temp", "Cone", "ConeParams",
    "cone_matrix", "CSP_BT709",
]

COLOR_SDR_WHITE = 203.0   # cd/m² of SDR reference white
COLOR_HDR_BLACK = 1e-6    # sentinel: lowest positive black level


def coerce_enum(val, enum_cls, what: str):
    """Accept an enum member or its string form (value, or a
    punctuation-insensitive alias such as "bt2020")."""
    if isinstance(val, enum_cls):
        return val
    if isinstance(val, str):
        try:
            return enum_cls(val)
        except ValueError:
            pass
        key = val.lower().replace(".", "").replace("-", "") \
                         .replace("_", "").replace(" ", "")
        for m in enum_cls:
            if (str(m.value).lower().replace(".", "").replace("-", "")
                    .replace("_", "") == key
                    or m.name.lower().replace("_", "") == key):
                return m
        raise ValueError(
            f"unknown {what}: {val!r} (valid: "
            f"{[m.value for m in enum_cls]})")
    raise TypeError(f"{what} must be {enum_cls.__name__} or str, "
                    f"got {type(val).__name__}")


class ColorSystem(enum.Enum):
    UNKNOWN = "unknown"
    BT_601 = "bt.601"
    BT_709 = "bt.709"
    SMPTE_240M = "smpte-240m"
    BT_2020_NC = "bt.2020-nc"
    BT_2020_C = "bt.2020-c"
    BT_2100_PQ = "bt.2100-pq"
    BT_2100_HLG = "bt.2100-hlg"
    DOLBYVISION = "dolbyvision"
    YCGCO = "ycgco"
    YCGCO_RE = "ycgco-re"
    YCGCO_RO = "ycgco-ro"
    RGB = "rgb"
    XYZ = "xyz"


class ColorLevels(enum.Enum):
    UNKNOWN = "auto"
    LIMITED = "limited"
    FULL = "full"


class AlphaMode(enum.Enum):
    UNKNOWN = "auto"
    INDEPENDENT = "independent"
    PREMULTIPLIED = "premultiplied"
    NONE = "none"


class ColorPrimaries(enum.Enum):
    UNKNOWN = "auto"
    BT_601_525 = "bt.601-525"
    BT_601_625 = "bt.601-625"
    BT_709 = "bt.709"
    BT_470M = "bt.470m"
    EBU_3213 = "ebu3213"
    BT_2020 = "bt.2020"
    APPLE = "apple"
    ADOBE = "adobe"
    PRO_PHOTO = "prophoto"
    CIE_1931 = "cie1931"
    DCI_P3 = "dci-p3"
    DISPLAY_P3 = "display-p3"
    V_GAMUT = "v-gamut"
    S_GAMUT = "s-gamut"
    FILM_C = "film-c"
    ACES_AP0 = "aces-ap0"
    ACES_AP1 = "aces-ap1"


class ColorTransfer(enum.Enum):
    UNKNOWN = "auto"
    BT_1886 = "bt.1886"
    SRGB = "srgb"
    LINEAR = "linear"
    GAMMA18 = "gamma1.8"
    GAMMA20 = "gamma2.0"
    GAMMA22 = "gamma2.2"
    GAMMA24 = "gamma2.4"
    GAMMA26 = "gamma2.6"
    GAMMA28 = "gamma2.8"
    PRO_PHOTO = "prophoto"
    ST428 = "st428"
    PQ = "pq"
    HLG = "hlg"
    V_LOG = "v-log"
    S_LOG1 = "s-log1"
    S_LOG2 = "s-log2"
    SCRGB = "scrgb"


class HdrScaling(enum.Enum):
    NORM = "norm"     # 1.0 = SDR white (203 nits)
    SQRT = "sqrt"
    NITS = "nits"
    PQ = "pq"         # PQ-encoded [0,1]


_PQ_M1 = 2610.0 / 16384
_PQ_M2 = 2523.0 / 4096 * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = 2413.0 / 4096 * 32
_PQ_C3 = 2392.0 / 4096 * 32


def pq_eotf_np(x):
    """PQ signal [0,1] -> linear [0,1] (1.0 = 10000 nits), float64."""
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    p = np.power(x, 1.0 / _PQ_M2)
    return np.power(np.maximum(p - _PQ_C1, 0.0) / (_PQ_C2 - _PQ_C3 * p),
                    1.0 / _PQ_M1)


def pq_oetf_np(y):
    y = np.maximum(np.asarray(y, dtype=np.float64), 0.0)
    p = np.power(y, _PQ_M1)
    return np.power((_PQ_C1 + _PQ_C2 * p) / (1.0 + _PQ_C3 * p), _PQ_M2)


def hdr_rescale(frm: HdrScaling, to: HdrScaling, x):
    """Convert a luminance value between scalings, in float64."""
    if frm == to:
        return x
    x = np.asarray(x, dtype=np.float64)
    if frm == HdrScaling.NORM:
        nits = x * COLOR_SDR_WHITE
    elif frm == HdrScaling.SQRT:
        nits = (x * x) * COLOR_SDR_WHITE
    elif frm == HdrScaling.NITS:
        nits = x
    elif frm == HdrScaling.PQ:
        nits = pq_eotf_np(x) * 10000.0
    else:
        raise ValueError(frm)
    if to == HdrScaling.NORM:
        out = nits / COLOR_SDR_WHITE
    elif to == HdrScaling.SQRT:
        out = np.sqrt(np.maximum(nits, 0.0) / COLOR_SDR_WHITE)
    elif to == HdrScaling.NITS:
        out = nits
    elif to == HdrScaling.PQ:
        out = pq_oetf_np(np.clip(nits, 0.0, 10000.0) / 10000.0)
    else:
        raise ValueError(to)
    if np.ndim(x) == 0:
        return float(out)
    return out


@dataclass(frozen=True)
class CIExy:
    x: float = 0.0
    y: float = 0.0

    def to_XYZ(self, Y: float = 1.0) -> np.ndarray:
        if self.y == 0:
            return np.zeros(3)
        return np.array([Y * self.x / self.y, Y,
                         Y * (1 - self.x - self.y) / self.y])

    def __bool__(self):
        return bool(self.x != 0.0 or self.y != 0.0)


CIE_D50 = CIExy(0.3457, 0.3585)
CIE_D65 = CIExy(0.3127, 0.3290)
CIE_C = CIExy(0.3100, 0.3160)
CIE_E = CIExy(1.0 / 3.0, 1.0 / 3.0)
CIE_DCI = CIExy(0.3140, 0.3510)
CIE_ACES = CIExy(0.32168, 0.33767)


@dataclass(frozen=True)
class RawPrimaries:
    red: CIExy = field(default_factory=CIExy)
    green: CIExy = field(default_factory=CIExy)
    blue: CIExy = field(default_factory=CIExy)
    white: CIExy = field(default_factory=CIExy)

    def valid(self) -> bool:
        return bool(self.red) and bool(self.green) and bool(self.blue) \
            and bool(self.white)


_PRIMARIES_TABLE = {
    ColorPrimaries.BT_470M: RawPrimaries(CIExy(0.670, 0.330), CIExy(0.210, 0.710), CIExy(0.140, 0.080), CIE_C),
    ColorPrimaries.BT_601_525: RawPrimaries(CIExy(0.630, 0.340), CIExy(0.310, 0.595), CIExy(0.155, 0.070), CIE_D65),
    ColorPrimaries.BT_601_625: RawPrimaries(CIExy(0.640, 0.330), CIExy(0.290, 0.600), CIExy(0.150, 0.060), CIE_D65),
    ColorPrimaries.BT_709: RawPrimaries(CIExy(0.640, 0.330), CIExy(0.300, 0.600), CIExy(0.150, 0.060), CIE_D65),
    ColorPrimaries.BT_2020: RawPrimaries(CIExy(0.708, 0.292), CIExy(0.170, 0.797), CIExy(0.131, 0.046), CIE_D65),
    ColorPrimaries.APPLE: RawPrimaries(CIExy(0.625, 0.340), CIExy(0.280, 0.595), CIExy(0.115, 0.070), CIE_D65),
    ColorPrimaries.ADOBE: RawPrimaries(CIExy(0.640, 0.330), CIExy(0.210, 0.710), CIExy(0.150, 0.060), CIE_D65),
    ColorPrimaries.PRO_PHOTO: RawPrimaries(CIExy(0.7347, 0.2653), CIExy(0.1596, 0.8404), CIExy(0.0366, 0.0001), CIE_D50),
    ColorPrimaries.CIE_1931: RawPrimaries(CIExy(0.7347, 0.2653), CIExy(0.2738, 0.7174), CIExy(0.1666, 0.0089), CIE_E),
    ColorPrimaries.DCI_P3: RawPrimaries(CIExy(0.680, 0.320), CIExy(0.265, 0.690), CIExy(0.150, 0.060), CIE_DCI),
    ColorPrimaries.DISPLAY_P3: RawPrimaries(CIExy(0.680, 0.320), CIExy(0.265, 0.690), CIExy(0.150, 0.060), CIE_D65),
    ColorPrimaries.V_GAMUT: RawPrimaries(CIExy(0.730, 0.280), CIExy(0.165, 0.840), CIExy(0.100, -0.03), CIE_D65),
    ColorPrimaries.S_GAMUT: RawPrimaries(CIExy(0.730, 0.280), CIExy(0.140, 0.855), CIExy(0.100, -0.05), CIE_D65),
    ColorPrimaries.FILM_C: RawPrimaries(CIExy(0.681, 0.319), CIExy(0.243, 0.692), CIExy(0.145, 0.049), CIE_C),
    ColorPrimaries.EBU_3213: RawPrimaries(CIExy(0.630, 0.340), CIExy(0.295, 0.605), CIExy(0.155, 0.077), CIE_D65),
    ColorPrimaries.ACES_AP0: RawPrimaries(CIExy(0.7347, 0.2653), CIExy(0.0, 1.0), CIExy(0.0001, -0.0770), CIE_ACES),
    ColorPrimaries.ACES_AP1: RawPrimaries(CIExy(0.713, 0.293), CIExy(0.165, 0.830), CIExy(0.128, 0.044), CIE_ACES),
}

_WIDE_GAMUT = {
    ColorPrimaries.BT_2020, ColorPrimaries.APPLE, ColorPrimaries.ADOBE,
    ColorPrimaries.PRO_PHOTO, ColorPrimaries.CIE_1931, ColorPrimaries.DCI_P3,
    ColorPrimaries.DISPLAY_P3, ColorPrimaries.V_GAMUT, ColorPrimaries.S_GAMUT,
    ColorPrimaries.ACES_AP0, ColorPrimaries.ACES_AP1,
}


def primaries_get(prim: ColorPrimaries) -> RawPrimaries:
    if prim in (ColorPrimaries.UNKNOWN,):
        prim = ColorPrimaries.BT_709
    return _PRIMARIES_TABLE[prim]


def primaries_is_wide_gamut(prim: ColorPrimaries) -> bool:
    return prim in _WIDE_GAMUT


def primaries_guess(width: int, height: int) -> ColorPrimaries:
    """Conservative guess by resolution; never returns wide gamut."""
    if width >= 1280 or height > 576:
        return ColorPrimaries.BT_709
    if height == 576:
        return ColorPrimaries.BT_601_625
    if height in (480, 486):
        return ColorPrimaries.BT_601_525
    return ColorPrimaries.BT_709


def daylight_from_temp(temp: float) -> CIExy:
    """CIE daylight illuminant for a correlated color temperature,
    clamped to [1000, 25000] K (reference pl_daylight_from_temp)."""
    temp = float(np.clip(temp, 1000, 25000))
    ti = 1000.0 / temp
    ti2, ti3 = ti * ti, ti * ti * ti
    if temp <= 7000:
        x = 0.244063 + 0.09911 * ti + 2.9678 * ti2 - 4.6070 * ti3
    else:
        x = 0.237040 + 0.24748 * ti + 1.9018 * ti2 - 2.0064 * ti3
    y = -3.0 * x * x + 2.87 * x - 0.275
    return CIExy(x, y)


def blackbody_from_temp(temp: float) -> CIExy:
    """CIE xy of a Planckian radiator for a temperature in [1667, 25000]
    K (reference pl_blackbody_from_temp; Kim et al.'s cubic spline)."""
    temp = float(np.clip(temp, 1667, 25000))
    ti = 1000.0 / temp
    ti2, ti3 = ti * ti, ti * ti * ti
    if temp <= 4000:
        x = -0.2661239 * ti3 - 0.2343580 * ti2 + 0.8776956 * ti + 0.179910
    else:
        x = -3.0258469 * ti3 + 2.1070379 * ti2 + 0.2226347 * ti + 0.240390
    x2, x3 = x * x, x * x * x
    if temp <= 2222:
        y = -1.1063814 * x3 - 1.34811020 * x2 + 2.18555832 * x - 0.20219683
    elif temp <= 4000:
        y = -0.9549476 * x3 - 1.37418593 * x2 + 2.09137015 * x - 0.16748867
    else:
        y = 3.0817580 * x3 - 5.87338670 * x2 + 3.75112997 * x - 0.37001483
    return CIExy(x, y)


def white_from_temp(temp: float) -> CIExy:
    """Daylight above 4000 K blending into a pure blackbody below 2500 K
    (reference pl_white_from_temp)."""
    a = blackbody_from_temp(temp)
    b = daylight_from_temp(temp)
    f = float(np.clip((temp - 2500.0) / (4000.0 - 2500.0), 0.0, 1.0))
    return CIExy(a.x + (b.x - a.x) * f, a.y + (b.y - a.y) * f)


def rgb_to_xyz_matrix(prim: RawPrimaries) -> Matrix3x3:
    """RGB->XYZ from chromaticities + white point (white maps to Y=1)."""
    M = np.stack([prim.red.to_XYZ(), prim.green.to_XYZ(), prim.blue.to_XYZ()],
                 axis=1)
    W = prim.white.to_XYZ(1.0)
    S = np.linalg.solve(M, W)
    return Matrix3x3(M * S[None, :])


def xyz_to_rgb_matrix(prim: RawPrimaries) -> Matrix3x3:
    return rgb_to_xyz_matrix(prim).invert()


# CAT16 cone response matrix (CIECAM16)
_M_CAT16_ADAPT = np.array([
    [0.401288, 0.650173, -0.051461],
    [-0.250268, 1.204414, 0.045854],
    [-0.002079, 0.048952, 0.953127],
])


def adapt_white_matrix(src_white: CIExy, dst_white: CIExy) -> Matrix3x3:
    """Linear von-Kries chromatic adaptation in CAT16 cone space."""
    if (abs(src_white.x - dst_white.x) < 1e-6 and
            abs(src_white.y - dst_white.y) < 1e-6):
        return Matrix3x3.identity()
    src = _M_CAT16_ADAPT @ src_white.to_XYZ()
    dst = _M_CAT16_ADAPT @ dst_white.to_XYZ()
    gain = np.diag(dst / src)
    return Matrix3x3(np.linalg.inv(_M_CAT16_ADAPT) @ gain @ _M_CAT16_ADAPT)


def color_mapping_matrix(src: RawPrimaries, dst: RawPrimaries) -> Matrix3x3:
    """RGB(src gamut) -> RGB(dst gamut) with white adaptation."""
    xyz = rgb_to_xyz_matrix(src)
    adapt = adapt_white_matrix(src.white, dst.white)
    back = xyz_to_rgb_matrix(dst)
    return back @ adapt @ xyz


def _test_point_line(p: CIExy, a: CIExy, b: CIExy) -> float:
    return (p.x - b.x) * (a.y - b.y) - (a.x - b.x) * (p.y - b.y)


def primaries_compatible(a: RawPrimaries, b: RawPrimaries) -> bool:
    """True when each of a's primaries is closest to the same-named
    primary of b."""
    def d2(p: CIExy, q: CIExy) -> float:
        return (p.x - q.x) ** 2 + (p.y - q.y) ** 2
    return (d2(a.red, b.red) < d2(a.red, b.green)
            and d2(a.red, b.red) < d2(a.red, b.blue)
            and d2(a.green, b.green) < d2(a.green, b.red)
            and d2(a.green, b.green) < d2(a.green, b.blue)
            and d2(a.blue, b.blue) < d2(a.blue, b.red)
            and d2(a.blue, b.blue) < d2(a.blue, b.green))


def _line_intersection(a: CIExy, b: CIExy, c: CIExy, d: CIExy) -> CIExy:
    det = (a.x - b.x) * (c.y - d.y) - (a.y - b.y) * (c.x - d.x)
    if det == 0:
        return CIExy(0.0, 0.0)
    t = ((a.x - c.x) * (c.y - d.y) - (a.y - c.y) * (c.x - d.x)) / det
    return CIExy(a.x + t * (b.x - a.x), a.y + t * (b.y - a.y))


def _clip_point(x: CIExy, y: CIExy, z: CIExy,
                a: CIExy, b: CIExy, c: CIExy) -> CIExy:
    d1 = _test_point_line(y, a, b)
    d2 = _test_point_line(y, b, c)
    if d1 <= 0.0 and d2 <= 0.0:
        return y
    if d1 > 0.0 and d2 > 0.0:
        return b
    if d1 > 0.0:
        return _line_intersection(a, b, y, z)
    return _line_intersection(x, y, b, c)


def primaries_clip(src: RawPrimaries, dst: RawPrimaries) -> RawPrimaries:
    """Clip gamut `src` against `dst`, keeping src's white."""
    return RawPrimaries(
        red=_clip_point(src.green, src.red, src.blue,
                        dst.green, dst.red, dst.blue),
        green=_clip_point(src.blue, src.green, src.red,
                          dst.blue, dst.green, dst.red),
        blue=_clip_point(src.red, src.blue, src.green,
                         dst.red, dst.blue, dst.green),
        white=src.white)


def luma_coeffs(prim: RawPrimaries) -> np.ndarray:
    return rgb_to_xyz_matrix(prim).m[1].copy()


@dataclass(frozen=True)
class BitEncoding:
    sample_depth: int = 0
    color_depth: int = 0
    bit_shift: int = 0

    def __bool__(self):
        return self.sample_depth != 0 or self.color_depth != 0 \
            or self.bit_shift != 0


@dataclass(frozen=True)
class DoviMetadata:
    """Parsed Dolby Vision RPU (reference pl_dovi_metadata,
    colorspace.h:135-155). Reshape data grouped per component."""
    nonlinear_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    nonlinear: Tuple = ()      # 3x3, applied before PQ ("ycc_to_rgb")
    linear: Tuple = ()         # 3x3, applied after PQ ("rgb_to_lms")
    # per component c in 0..2: dict with keys
    #   pivots: tuple[float,...]  (num_pivots entries, normalized)
    #   method: tuple[int,...]    (0 = polynomial, 1 = MMR)
    #   poly_coeffs: tuple[tuple[f,f,f],...]
    #   mmr_order/mmr_constant/mmr_coeffs
    comp: Tuple = ()


@dataclass(frozen=True)
class ColorRepr:
    """Encoded-color representation; enum fields accept string names."""
    sys: ColorSystem = ColorSystem.UNKNOWN
    levels: ColorLevels = ColorLevels.UNKNOWN
    alpha: AlphaMode = AlphaMode.UNKNOWN
    bits: BitEncoding = field(default_factory=BitEncoding)
    dovi: Optional[DoviMetadata] = None

    def __post_init__(self):
        object.__setattr__(self, "sys", coerce_enum(
            self.sys, ColorSystem, "color system"))
        object.__setattr__(self, "levels", coerce_enum(
            self.levels, ColorLevels, "color levels"))
        object.__setattr__(self, "alpha", coerce_enum(
            self.alpha, AlphaMode, "alpha mode"))


def system_is_ycbcr_like(sys: ColorSystem) -> bool:
    return sys not in (ColorSystem.UNKNOWN, ColorSystem.RGB, ColorSystem.XYZ)


def levels_guess(repr: ColorRepr) -> ColorLevels:
    if repr.levels != ColorLevels.UNKNOWN:
        return repr.levels
    if repr.sys == ColorSystem.XYZ:
        return ColorLevels.FULL
    return ColorLevels.LIMITED if system_is_ycbcr_like(repr.sys) \
        else ColorLevels.FULL


def color_repr_normalize(repr: ColorRepr) -> Tuple[float, ColorRepr]:
    """(scale, repr') making color_depth == sample_depth, no bit shift."""
    bits = repr.bits
    sample = bits.sample_depth or bits.color_depth or 8
    color = bits.color_depth or sample
    scale = (2.0 ** sample - 1) / (2.0 ** color - 1)
    scale /= 2.0 ** bits.bit_shift
    return scale, replace(repr, bits=BitEncoding(sample, sample, 0))


def _luma_for_system(sys: ColorSystem) -> Tuple[float, float]:
    if sys == ColorSystem.BT_601:
        return 0.299, 0.114
    if sys == ColorSystem.BT_709:
        return 0.2126, 0.0722
    if sys == ColorSystem.SMPTE_240M:
        return 0.212, 0.087
    if sys == ColorSystem.BT_2020_NC:
        return 0.2627, 0.0593
    raise ValueError(f"no luma coefficients for {sys}")


def _ycbcr_matrix(kr: float, kb: float) -> np.ndarray:
    """Full-range YCbCr -> RGB 3x3 for given luma weights."""
    kg = 1.0 - kr - kb
    to_ycbcr = np.array([
        [kr, kg, kb],
        [-kr / (2 * (1 - kb)), -kg / (2 * (1 - kb)), 0.5],
        [0.5, -kg / (2 * (1 - kr)), -kb / (2 * (1 - kr))],
    ])
    return np.linalg.inv(to_ycbcr)


# ICtCp (BT.2100): BT.2020 linear RGB -> LMS, and L'M'S' -> ICtCp for
# the PQ and the HLG variant
_RGB2020_TO_LMS = np.array([
    [1688.0, 2146.0, 262.0],
    [683.0, 2951.0, 462.0],
    [99.0, 309.0, 3688.0],
]) / 4096.0
_ICTCP_PQ_LMS = np.array([
    [2048.0, 2048.0, 0.0],
    [6610.0, -13613.0, 7003.0],
    [17933.0, -17390.0, -543.0],
]) / 4096.0
_ICTCP_HLG_LMS = np.array([
    [2048.0, 2048.0, 0.0],
    [3625.0, -7465.0, 3840.0],
    [9500.0, -9212.0, -288.0],
]) / 4096.0


def ictcp_matrices(variant: ColorSystem) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb2020 -> LMS, L'M'S' -> ICtCp) of the PQ or HLG variant."""
    if variant == ColorSystem.BT_2100_PQ:
        return _RGB2020_TO_LMS, _ICTCP_PQ_LMS
    if variant == ColorSystem.BT_2100_HLG:
        return _RGB2020_TO_LMS, _ICTCP_HLG_LMS
    raise ValueError(variant)


@dataclass(frozen=True)
class ColorAdjustment:
    """User color adjustment (reference pl_color_adjustment), folded into
    the decode matrix: hue and saturation rotate and scale the chroma,
    contrast scales the gain, brightness lifts the bias, temperature
    adapts the white point; gamma is a separate non-linear step of
    ops.color.decode_color."""
    brightness: float = 0.0      # -1..1 black lift/boost
    contrast: float = 1.0        # 0..100 gain
    saturation: float = 1.0      # 0..100 chroma gain
    hue: float = 0.0             # radians, chroma rotation
    gamma: float = 1.0           # 0..100 aesthetic gamma
    temperature: float = 0.0     # -1..1 of +-3500 K around 6500 K

    def is_neutral(self) -> bool:
        return self == COLOR_ADJUSTMENT_NEUTRAL


COLOR_ADJUSTMENT_NEUTRAL = ColorAdjustment()


def color_repr_decode(repr: ColorRepr,
                      adjustment: Optional[ColorAdjustment] = None,
                      ) -> Tuple[Transform3x3, ColorRepr]:
    """Affine transform taking sampled (normalized) texture values to
    full-range RGB — for the non-linear systems (ICtCp, BT.2020-C, XYZ,
    Dolby Vision), their linear pre-matrix — with the user's color
    adjustment folded in (reference pl_color_repr_decode,
    colorspace.c:1717)."""
    adj = adjustment or COLOR_ADJUSTMENT_NEUTRAL
    sys = repr.sys if repr.sys != ColorSystem.UNKNOWN else ColorSystem.RGB
    if sys == ColorSystem.DOLBYVISION and repr.dovi is None:
        raise ValueError("DOLBYVISION repr requires dovi metadata")
    levels = levels_guess(repr)
    scale, norm_repr = color_repr_normalize(repr)
    depth = norm_repr.bits.sample_depth or 8

    if sys in (ColorSystem.RGB, ColorSystem.XYZ, ColorSystem.BT_2020_C):
        # BT.2020-C: only the range expands here (identity matrix)
        M = np.eye(3)
    elif sys == ColorSystem.BT_2100_PQ:
        # ICtCp -> L'M'S': the published inverse (H-series Supplement
        # 18), as the reference hard-codes it
        M = np.array([[1.0, 0.008609, 0.111029625],
                      [1.0, -0.008609, -0.111029625],
                      [1.0, 0.560031, -0.320627]])
    elif sys == ColorSystem.BT_2100_HLG:
        M = np.array([[1.0, 0.01571858011, 0.2095810681],
                      [1.0, -0.01571858011, -0.2095810681],
                      [1.0, 1.02127108, -0.605274491]])
    elif sys == ColorSystem.YCGCO:
        M = np.array([[1.0, -1.0, 1.0], [1.0, 1.0, 0.0], [1.0, -1.0, -1.0]])
    elif sys in (ColorSystem.YCGCO_RE, ColorSystem.YCGCO_RO):
        M = np.array([[1.0, -0.5, 0.5], [1.0, 0.5, 0.0], [1.0, -0.5, -0.5]])
    elif sys == ColorSystem.DOLBYVISION:
        M = np.asarray(repr.dovi.nonlinear, dtype=np.float64).reshape(3, 3)
    else:
        M = _ycbcr_matrix(*_luma_for_system(sys))
    off = np.zeros(3)
    if sys == ColorSystem.DOLBYVISION:
        off = -M @ np.asarray(repr.dovi.nonlinear_offset, dtype=np.float64)
    ycbcr = system_is_ycbcr_like(sys)
    # hue and saturation rotate and scale the chroma subvector; other
    # systems go through BT.709's YCbCr model, as in the reference
    if adj.saturation != 1.0 or adj.hue != 0.0:
        huecos = adj.saturation * math.cos(adj.hue)
        huesin = adj.saturation * math.sin(adj.hue)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, huecos, huesin],
                        [0.0, -huesin, huecos]])
        if ycbcr:
            M = M @ rot
        else:
            yuv2rgb = _ycbcr_matrix(0.2126, 0.0722)
            M = (yuv2rgb @ rot) @ np.linalg.inv(yuv2rgb) @ M
    # temperature: adaptation from 6500 K, through BT.709's RGB <-> XYZ
    # anchored at the source white
    if adj.temperature:
        src_w = white_from_temp(6500.0)
        dst_w = white_from_temp(6500.0 + 3500.0 * adj.temperature)
        prim = replace(primaries_get(ColorPrimaries.BT_709), white=src_w)
        r2x = rgb_to_xyz_matrix(prim).m
        adapt = np.linalg.inv(r2x) @ adapt_white_matrix(src_w, dst_w).m \
            @ r2x
        M = adapt @ M
        off = adapt @ off

    imax = (1 << depth) - 1
    coff = ((128 << (depth - 8)) / imax) if ycbcr else 0.0
    if levels == ColorLevels.LIMITED:
        ymul = imax / ((219 << (depth - 8)))
        cmul = imax / ((224 << (depth - 8)))
        yoff = (16 << (depth - 8)) / imax
    else:
        ymul = 1.0
        yoff = 0.0
        cmul = 0.5 / (1.0 - coff) if ycbcr else 1.0
    if sys == ColorSystem.DOLBYVISION:
        # the RPU matrix already includes the levels: only the signalled
        # nonlinear offsets apply (reference: mul = 1, black = offsets)
        pre_mul = np.eye(3)
        pre_off = np.zeros(3)
    elif ycbcr:
        pre_mul = np.diag([ymul, cmul, cmul])
        pre_off = np.array([-yoff * ymul, -coff * cmul, -coff * cmul])
    else:
        pre_mul = np.diag([ymul, ymul, ymul])
        pre_off = np.array([-yoff * ymul] * 3)
    if adj.contrast != 1.0:
        pre_mul = pre_mul * adj.contrast
        pre_off = pre_off * adj.contrast
    full = M @ pre_mul * scale
    full_off = M @ pre_off + off + adj.brightness
    out_repr = replace(norm_repr, sys=ColorSystem.RGB,
                       levels=ColorLevels.FULL)
    return Transform3x3(Matrix3x3(full), full_off), out_repr


_HLG_75 = 3.17955025

_TRANSFER_PEAKS = {
    ColorTransfer.PQ: 10000.0 / COLOR_SDR_WHITE,
    ColorTransfer.HLG: 12.0 / _HLG_75,
    ColorTransfer.V_LOG: 46.0855,
    ColorTransfer.S_LOG1: 6.52,
    ColorTransfer.S_LOG2: 9.212,
}


def transfer_nominal_peak(trc: ColorTransfer) -> float:
    return _TRANSFER_PEAKS.get(trc, 1.0)


def transfer_is_hdr(trc: ColorTransfer) -> bool:
    return transfer_nominal_peak(trc) > 1.0 or trc == ColorTransfer.SCRGB


@dataclass(frozen=True)
class HdrMetadata:
    """Static + dynamic HDR metadata (reference pl_hdr_metadata)."""
    prim: RawPrimaries = field(default_factory=RawPrimaries)
    min_luma: float = 0.0
    max_luma: float = 0.0
    max_cll: float = 0.0
    max_fall: float = 0.0
    scene_max: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scene_avg: float = 0.0
    ootf: Optional[object] = None
    max_pq_y: float = 0.0
    avg_pq_y: float = 0.0


@dataclass(frozen=True)
class ColorSpace:
    """Colorimetry of light (reference pl_color_space)."""
    primaries: ColorPrimaries = ColorPrimaries.UNKNOWN
    transfer: ColorTransfer = ColorTransfer.UNKNOWN
    hdr: HdrMetadata = field(default_factory=HdrMetadata)

    def __post_init__(self):
        object.__setattr__(self, "primaries", coerce_enum(
            self.primaries, ColorPrimaries, "color primaries"))
        object.__setattr__(self, "transfer", coerce_enum(
            self.transfer, ColorTransfer, "transfer function"))

    def is_hdr(self) -> bool:
        return transfer_is_hdr(self.transfer)

    def is_black_scaled(self) -> bool:
        return self.transfer not in (
            ColorTransfer.BT_1886, ColorTransfer.PQ, ColorTransfer.SCRGB,
            ColorTransfer.V_LOG, ColorTransfer.S_LOG1, ColorTransfer.S_LOG2)

    def infer(self, width: int = 0, height: int = 0) -> "ColorSpace":
        """Fill unknown fields with defaults (pl_color_space_infer)."""
        prim = self.primaries
        trc = self.transfer
        if prim == ColorPrimaries.UNKNOWN:
            prim = primaries_guess(width, height)
        if trc == ColorTransfer.UNKNOWN:
            trc = ColorTransfer.BT_1886
        hdr = self.hdr
        min_luma, max_luma = hdr.min_luma, hdr.max_luma
        if transfer_is_hdr(trc):
            if not max_luma:
                max_luma = hdr.max_cll or \
                    transfer_nominal_peak(trc) * COLOR_SDR_WHITE
            if not min_luma:
                min_luma = COLOR_HDR_BLACK
        else:
            if not max_luma:
                max_luma = COLOR_SDR_WHITE
            if not min_luma:
                min_luma = max_luma / 1000.0
        return ColorSpace(prim, trc,
                          replace(hdr, min_luma=min_luma, max_luma=max_luma))

    def infer_ref(self, ref: "ColorSpace") -> "ColorSpace":
        """Fill unknown fields with defaults taken from `ref`."""
        ref = ref.infer()
        prim, trc = self.primaries, self.transfer
        if prim == ColorPrimaries.UNKNOWN:
            prim = ColorPrimaries.BT_709 \
                if primaries_is_wide_gamut(ref.primaries) else ref.primaries
        if trc == ColorTransfer.UNKNOWN:
            if ref.transfer in (ColorTransfer.BT_1886, ColorTransfer.SRGB,
                                ColorTransfer.GAMMA22):
                trc = ref.transfer
            elif ref.transfer in (ColorTransfer.PQ, ColorTransfer.HLG,
                                  ColorTransfer.V_LOG, ColorTransfer.S_LOG1,
                                  ColorTransfer.S_LOG2):
                trc = ColorTransfer.BT_1886
            elif ref.transfer == ColorTransfer.PRO_PHOTO:
                trc = ColorTransfer.SRGB
            else:
                trc = ColorTransfer.GAMMA22
        return ColorSpace(prim, trc, self.hdr).infer()

    def nominal_peak_norm(self) -> float:
        return self.infer().hdr.max_luma / COLOR_SDR_WHITE

    def nominal_luma(self, metadata: str = "any"
                     ) -> Tuple[float, float, float]:
        """(min, max, avg) display luminance in nits with HDR metadata
        source selection (pl_color_space_nominal_luma_ex)."""
        hdr = self.hdr
        min_luma = max_luma = avg_luma = 0.0
        if metadata != "none":
            min_luma = hdr.min_luma
            max_luma = hdr.max_luma or hdr.max_cll

        def compat(tier):
            return metadata in ("any", tier)
        if compat("hdr10plus") and hdr.scene_avg > 0:
            maxscl = max(hdr.scene_max)
            if maxscl:
                prim = hdr.prim if hdr.prim.valid() else \
                    primaries_get(self.primaries)
                coefs = luma_coeffs(prim)
                y = float(coefs[0] * hdr.scene_max[0] +
                          coefs[1] * hdr.scene_max[1] +
                          coefs[2] * hdr.scene_max[2])
                max_luma = y
                avg_luma = (y / maxscl) * hdr.scene_avg
        if compat("cie_y") and hdr.max_pq_y:
            max_luma = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS,
                                   hdr.max_pq_y)
            avg_luma = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS,
                                   hdr.avg_pq_y)
        hdr_max = 10000.0
        if max_luma:
            max_luma = min(max(max_luma, COLOR_HDR_BLACK), hdr_max)
        if min_luma:
            min_luma = min(max(min_luma, COLOR_HDR_BLACK), hdr_max)
        if (max_luma and min_luma >= max_luma) or min_luma >= hdr_max:
            min_luma = max_luma = 0.0
        if not max_luma:
            if self.transfer == ColorTransfer.HLG:
                max_luma = 1000.0
            else:
                max_luma = transfer_nominal_peak(self.transfer) * \
                    COLOR_SDR_WHITE
        if not min_luma:
            if transfer_is_hdr(self.transfer):
                min_luma = COLOR_HDR_BLACK
            else:
                min_luma = max_luma / 1000.0
        if avg_luma:
            avg_luma = min(max(avg_luma, min_luma), max_luma)
        return min_luma, max_luma, avg_luma


def color_space_infer_map(src: ColorSpace,
                          dst: ColorSpace) -> Tuple[ColorSpace, ColorSpace]:
    """Jointly infer source and target colorspaces
    (pl_color_space_infer_map, colorspace.c:946)."""
    unknown_src_contrast = not src.hdr.min_luma
    unknown_dst_contrast = not dst.hdr.min_luma
    dst = dst.infer_ref(src)
    src_i = src.infer()
    dynamic_src_contrast = src_i.is_black_scaled() or \
        src_i.transfer == ColorTransfer.BT_1886
    if unknown_src_contrast and dynamic_src_contrast:
        src_i = ColorSpace(src_i.primaries, src_i.transfer,
                           replace(src_i.hdr, min_luma=dst.hdr.min_luma))
    if unknown_dst_contrast and not src_i.is_hdr() and not dst.is_hdr():
        dst = ColorSpace(dst.primaries, dst.transfer,
                         replace(dst.hdr, min_luma=src_i.hdr.min_luma))
    if src_i.transfer == ColorTransfer.HLG and dst.is_hdr():
        src_i = ColorSpace(src_i.primaries, src_i.transfer,
                           replace(src_i.hdr, max_luma=dst.hdr.max_luma))
    return src_i, dst


CSP_SRGB = ColorSpace(ColorPrimaries.BT_709, ColorTransfer.SRGB)
CSP_BT709 = ColorSpace(ColorPrimaries.BT_709, ColorTransfer.BT_1886)
CSP_BT2100_PQ = ColorSpace(ColorPrimaries.BT_2020, ColorTransfer.PQ)


# ---------------------------------------------------------------------------
# Cone distortion: color blindness simulation (reference pl_cone_params,
# pl_get_cone_matrix; libplacebo_tpu/core/colorspace.py:1161-1255)
# ---------------------------------------------------------------------------

class Cone(enum.IntFlag):
    """The cone types the simulated vision lacks or is deficient in."""
    NONE = 0
    L = 1
    M = 2
    S = 4
    LM = L | M
    MS = M | S
    LS = L | S
    LMS = L | M | S


@dataclass(frozen=True)
class ConeParams:
    """strength: 1.0 = unaffected, 0.0 = full blindness of `cones`."""
    cones: Cone = Cone.NONE
    strength: float = 0.0


VISION_NORMAL = ConeParams(Cone.NONE, 1.0)
VISION_PROTANOMALY = ConeParams(Cone.L, 0.5)
VISION_PROTANOPIA = ConeParams(Cone.L, 0.0)
VISION_DEUTERANOMALY = ConeParams(Cone.M, 0.5)
VISION_DEUTERANOPIA = ConeParams(Cone.M, 0.0)
VISION_TRITANOMALY = ConeParams(Cone.S, 0.5)
VISION_TRITANOPIA = ConeParams(Cone.S, 0.0)
VISION_MONOCHROMACY = ConeParams(Cone.LM, 0.0)
VISION_ACHROMATOPSIA = ConeParams(Cone.LMS, 0.0)


def cone_matrix(params: ConeParams, prim: RawPrimaries) -> Matrix3x3:
    """Linear RGB -> RGB matrix simulating the cone deficiency in the
    given primaries: in CAT16 LMS, each affected cone's response becomes
    `strength` of itself plus (1 - strength) of the combination of the
    others that preserves neutral and the primary farthest from it (blue
    for L/M, red for S); two affected cones keep neutral only; all three
    follow the rod-cell approximation."""
    cones = Cone(params.cones)
    c = float(params.strength)
    if cones == Cone.NONE:
        return Matrix3x3(np.eye(3))
    rgb2lms = _M_CAT16_ADAPT @ rgb_to_xyz_matrix(prim).m
    lms_w = rgb2lms @ np.ones(3)
    distort = np.eye(3)
    single = {Cone.L: 0, Cone.M: 1, Cone.S: 2}
    pair = {Cone.LM: (0, 1, 2), Cone.MS: (1, 2, 0), Cone.LS: (0, 2, 1)}
    if cones in single:
        k = single[cones]
        others = [i for i in range(3) if i != k]
        anchor = rgb2lms @ (np.array([0.0, 0.0, 1.0]) if k != 2
                            else np.array([1.0, 0.0, 0.0]))
        A = np.array([[lms_w[others[0]], lms_w[others[1]]],
                      [anchor[others[0]], anchor[others[1]]]])
        ab = np.linalg.solve(A, np.array([lms_w[k], anchor[k]]))
        row = np.zeros(3)
        row[k] = c
        row[others[0]] = (1.0 - c) * ab[0]
        row[others[1]] = (1.0 - c) * ab[1]
        distort[k] = row
    elif cones in pair:
        i1, i2, j = pair[cones]
        for i in (i1, i2):
            row = np.zeros(3)
            row[i] = c
            row[j] = (1.0 - c) * lms_w[i] / lms_w[j]
            distort[i] = row
    else:
        w = np.array([0.3605, 0.6415, -0.002])
        distort = (1.0 - c) * w[None, :] * lms_w[:, None] / lms_w[None, :] \
            + c * np.eye(3)
    return Matrix3x3(np.linalg.inv(rgb2lms) @ distort @ rgb2lms)

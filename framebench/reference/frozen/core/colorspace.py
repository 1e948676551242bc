"""Colorimetry metadata & host-side matrix math (numpy float64).

Counterpart of libplacebo_tpu/core/colorspace.py, cut to what the
benchmark's reference reaches: the enums, `ColorRepr`/`ColorSpace` with
their inference rules, the primaries tables, RGB->XYZ and adaptation
matrices, and the gamut clip used by perceptual mapping.  Conventions
are the reference's: linear light is NORM (1.0 == 203 cd/m² SDR white)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np

from .common import Matrix3x3

__all__ = ["ColorSystem", "ColorLevels", "AlphaMode", "ColorPrimaries", "ColorTransfer", "HdrScaling", "CIExy", "RawPrimaries", "BitEncoding", "HdrMetadata", "DoviMetadata", "ColorRepr", "ColorSpace", "COLOR_SDR_WHITE", "COLOR_HDR_BLACK", "hdr_rescale", "primaries_get", "primaries_guess", "color_space_infer_map", "rgb_to_xyz_matrix", "adapt_white_matrix", "primaries_compatible", "primaries_clip", "transfer_is_hdr", "transfer_nominal_peak", "HdrBezier"]

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


def rgb_to_xyz_matrix(prim: RawPrimaries) -> Matrix3x3:
    """RGB->XYZ from chromaticities + white point (white maps to Y=1)."""
    M = np.stack([prim.red.to_XYZ(), prim.green.to_XYZ(), prim.blue.to_XYZ()],
                 axis=1)
    W = prim.white.to_XYZ(1.0)
    S = np.linalg.solve(M, W)
    return Matrix3x3(M * S[None, :])


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


@dataclass(frozen=True)
class BitEncoding:
    sample_depth: int = 0
    color_depth: int = 0
    bit_shift: int = 0


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


# ICtCp (BT.2100): BT.2020 linear RGB -> LMS, and L'M'S' -> ICtCp for
# the PQ and the HLG variant


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
class HdrBezier:
    """HDR10+ (SMPTE 2094-40) per-scene OOTF: the target luminance
    (cd/m²), the knee point and the Bezier anchors (reference
    pl_hdr_bezier)."""
    target_luma: float = 0.0
    knee_x: float = 0.0
    knee_y: float = 0.0
    anchors: Tuple[float, ...] = ()


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
    ootf: Optional[HdrBezier] = None
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

"""Reconstruction-filter kernels and configs (host numpy, float64).

Counterpart of libplacebo_tpu/core/filters.py: the 29 kernel functions
(`FILTER_FUNCTIONS`), the 30 named configs (`FILTER_CONFIGS`, with
their blur, taper, clamp, anti-ringing and parameter overrides),
`find_filter_config`'s usage filter, `sample_filter` and
`filter_cutoffs` (the reference's pl_filter_sample and cutoff-root
scan, filters.c:82-152) and `generate` (the weight LUTs,
pl_filter_generate).  The same float64 numpy arithmetic as the JAX
package, so every value is equal to it bit for bit.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "FilterFunction", "FilterConfig", "Filter", "FilterUsage",
    "FILTER_FUNCTIONS", "FILTER_CONFIGS", "find_filter_config",
    "find_filter_function", "sample_filter", "filter_cutoffs", "generate",
    "JINC_ZERO3", "JINC_ZERO4",
]


class FilterUsage(enum.IntFlag):
    """Where a config may/should be used (reference pl_filter_usage)."""
    UPSCALING = 1 << 0
    DOWNSCALING = 1 << 1
    FRAME_MIXING = 1 << 2
    SCALING = UPSCALING | DOWNSCALING
    ALL = SCALING | FRAME_MIXING


# ---------------------------------------------------------------------------
# Kernel functions — vectorized over |x| (valid on [0, radius])
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FilterFunction:
    name: str
    weight: Callable          # (x: ndarray, radius, p0, p1) -> ndarray
    radius: float
    resizable: bool = False
    params: Tuple[float, float] = (0.0, 0.0)
    tunable: Tuple[bool, bool] = (False, False)
    opaque: bool = False      # placeholder (oversample) — never evaluated


def _w_box(x, r, p0, p1):
    return np.ones_like(x)


def _w_triangle(x, r, p0, p1):
    return 1.0 - x / r


def _w_cosine(x, r, p0, p1):
    return np.cos(x)


def _w_hann(x, r, p0, p1):
    return 0.5 + 0.5 * np.cos(np.pi * x)


def _w_hamming(x, r, p0, p1):
    return 0.54 + 0.46 * np.cos(np.pi * x)


def _w_welch(x, r, p0, p1):
    return 1.0 - x * x


def _bessel_i0(x):
    # power series, converges quickly for the small arguments used here
    x = np.asarray(x, dtype=np.float64)
    s = np.ones_like(x)
    y = x * x / 4.0
    t = y.copy()
    for i in range(2, 40):
        s = s + t
        t = t * y / (i * i)
    return s


def _w_kaiser(x, r, p0, p1):
    alpha = max(p0, 0.0)
    scale = float(_bessel_i0(alpha))
    return _bessel_i0(alpha * np.sqrt(np.maximum(1.0 - x * x, 0.0))) / scale


def _w_blackman(x, r, p0, p1):
    a = p0
    a0, a1, a2 = (1 - a) / 2.0, 0.5, a / 2.0
    px = np.pi * x
    return a0 + a1 * np.cos(px) + a2 * np.cos(2 * px)


def _w_bohman(x, r, p0, p1):
    px = np.pi * x
    return (1.0 - x) * np.cos(px) + np.sin(px) / np.pi


def _w_gaussian(x, r, p0, p1):
    return np.exp(-2.0 * x * x / p0)


def _w_quadratic(x, r, p0, p1):
    return np.where(x < 0.5, 1.0 - 4.0 / 3.0 * x * x,
                    2.0 / 3.0 * (x - 1.5) ** 2)


def _w_sinc(x, r, p0, p1):
    px = np.pi * np.maximum(x, 1e-8)
    return np.where(x < 1e-8, 1.0, np.sin(px) / px)


def _j1(x):
    """Bessel J1: rational series below 8, asymptotic form above."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 8.0
    # series for small x
    xs = np.where(small, x, 0.0)
    y = xs * xs
    num = xs * (72362614232.0 + y * (-7895059235.0 + y * (242396853.1 +
              y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606))))))
    den = 144725228442.0 + y * (2300535178.0 + y * (18583304.74 +
              y * (99447.43394 + y * (376.9991397 + y))))
    r_small = num / den
    # asymptotic for large x
    ax = np.where(small, 8.0, np.abs(x))
    z = 8.0 / ax
    y2 = z * z
    xx = ax - 2.356194491
    p0 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4 +
             y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p1 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5 +
             y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    r_large = np.sqrt(0.636619772 / ax) * \
        (np.cos(xx) * p0 - z * np.sin(xx) * p1)
    r_large = np.where(x < 0, -r_large, r_large)
    return np.where(small, r_small, r_large)


def _w_jinc(x, r, p0, p1):
    px = np.pi * np.maximum(x, 1e-8)
    return np.where(x < 1e-8, 1.0, 2.0 * _j1(px) / px)


def _w_sphinx(x, r, p0, p1):
    px = np.pi * np.maximum(x, 1e-8)
    return np.where(x < 1e-8, 1.0,
                    3.0 * (np.sin(px) - px * np.cos(px)) / px**3)


def _w_cubic(x, r, b, c):
    p0 = 6.0 - 2.0 * b
    p2 = -18.0 + 12.0 * b + 6.0 * c
    p3 = 12.0 - 9.0 * b - 6.0 * c
    q0 = 8.0 * b + 24.0 * c
    q1 = -12.0 * b - 48.0 * c
    q2 = 6.0 * b + 30.0 * c
    q3 = -b - 6.0 * c
    lo = (p0 + x * x * (p2 + x * p3)) / p0
    hi = (q0 + x * (q1 + x * (q2 + x * q3))) / p0
    return np.where(x < 1.0, lo, hi)


def _w_spline16(x, r, p0, p1):
    lo = ((x - 9.0 / 5.0) * x - 1.0 / 5.0) * x + 1.0
    x1 = x - 1
    hi = ((-1.0 / 3.0 * x1 + 4.0 / 5.0) * x1 - 7.0 / 15.0) * x1
    return np.where(x < 1.0, lo, hi)


def _w_spline36(x, r, p0, p1):
    lo = ((13.0 / 11.0 * x - 453.0 / 209.0) * x - 3.0 / 209.0) * x + 1.0
    x1, x2 = x - 1, x - 2
    mid = ((-6.0 / 11.0 * x1 + 270.0 / 209.0) * x1 - 156.0 / 209.0) * x1
    hi = ((1.0 / 11.0 * x2 - 45.0 / 209.0) * x2 + 26.0 / 209.0) * x2
    return np.where(x < 1.0, lo, np.where(x < 2.0, mid, hi))


def _w_spline64(x, r, p0, p1):
    x1, x2, x3 = x - 1, x - 2, x - 3
    s0 = ((49.0 / 41.0 * x - 6387.0 / 2911.0) * x - 3.0 / 2911.0) * x + 1.0
    s1 = ((-24.0 / 41.0 * x1 + 4032.0 / 2911.0) * x1 - 2328.0 / 2911.0) * x1
    s2 = ((6.0 / 41.0 * x2 - 1008.0 / 2911.0) * x2 + 582.0 / 2911.0) * x2
    s3 = ((-1.0 / 41.0 * x3 + 168.0 / 2911.0) * x3 - 97.0 / 2911.0) * x3
    return np.where(x < 1.0, s0, np.where(x < 2.0, s1,
                    np.where(x < 3.0, s2, s3)))


def _w_oversample(x, r, p0, p1):
    return np.zeros_like(x)


JINC_ZERO1 = 1.2196698912665045
JINC_ZERO3 = 3.2383154841662362076499
JINC_ZERO4 = 4.2410628637960698819573
SPHINX_ZERO = 1.4302966531242027
_SQRT2 = math.sqrt(2.0)

FF_BOX = FilterFunction("box", _w_box, 1.0, resizable=True)
FF_DIRICHLET = replace(FF_BOX, name="dirichlet")
FF_TRIANGLE = FilterFunction("triangle", _w_triangle, 1.0, resizable=True)
FF_COSINE = FilterFunction("cosine", _w_cosine, math.pi / 2.0)
FF_HANN = FilterFunction("hann", _w_hann, 1.0)
FF_HANNING = replace(FF_HANN, name="hanning")
FF_HAMMING = FilterFunction("hamming", _w_hamming, 1.0)
FF_WELCH = FilterFunction("welch", _w_welch, 1.0)
FF_KAISER = FilterFunction("kaiser", _w_kaiser, 1.0,
                           params=(2.0, 0.0), tunable=(True, False))
FF_BLACKMAN = FilterFunction("blackman", _w_blackman, 1.0,
                             params=(0.16, 0.0), tunable=(True, False))
FF_BOHMAN = FilterFunction("bohman", _w_bohman, 1.0)
FF_GAUSSIAN = FilterFunction("gaussian", _w_gaussian, 2.0, resizable=True,
                             params=(1.0, 0.0), tunable=(True, False))
FF_QUADRATIC = FilterFunction("quadratic", _w_quadratic, 1.5)
FF_QUADRIC = replace(FF_QUADRATIC, name="quadric")
FF_SINC = FilterFunction("sinc", _w_sinc, 1.0, resizable=True)
FF_JINC = FilterFunction("jinc", _w_jinc, JINC_ZERO1, resizable=True)
FF_SPHINX = FilterFunction("sphinx", _w_sphinx, SPHINX_ZERO, resizable=True)
FF_CUBIC = FilterFunction("cubic", _w_cubic, 2.0,
                          params=(1.0, 0.0), tunable=(True, True))
FF_HERMITE = FilterFunction("hermite", _w_cubic, 1.0, params=(0.0, 0.0))
FF_BICUBIC = replace(FF_CUBIC, name="bicubic")
FF_BCSPLINE = replace(FF_CUBIC, name="bcspline")
FF_CATMULL_ROM = FilterFunction("catmull_rom", _w_cubic, 2.0,
                                params=(0.0, 0.5), tunable=(True, True))
FF_MITCHELL = FilterFunction("mitchell", _w_cubic, 2.0,
                             params=(1 / 3.0, 1 / 3.0), tunable=(True, True))
FF_ROBIDOUX = FilterFunction(
    "robidoux", _w_cubic, 2.0,
    params=(12 / (19 + 9 * _SQRT2), 113 / (58 + 216 * _SQRT2)),
    tunable=(True, True))
FF_ROBIDOUXSHARP = FilterFunction(
    "robidouxsharp", _w_cubic, 2.0,
    params=(6 / (13 + 7 * _SQRT2), 7 / (2 + 12 * _SQRT2)),
    tunable=(True, True))
FF_SPLINE16 = FilterFunction("spline16", _w_spline16, 2.0)
FF_SPLINE36 = FilterFunction("spline36", _w_spline36, 3.0)
FF_SPLINE64 = FilterFunction("spline64", _w_spline64, 4.0)
FF_OVERSAMPLE = FilterFunction("oversample", _w_oversample, 0.0,
                               params=(0.0, 0.0), tunable=(True, False),
                               opaque=True)

FILTER_FUNCTIONS = [
    FF_BOX, FF_DIRICHLET, FF_TRIANGLE, FF_COSINE, FF_HANN, FF_HANNING,
    FF_HAMMING, FF_WELCH, FF_KAISER, FF_BLACKMAN, FF_BOHMAN, FF_GAUSSIAN,
    FF_QUADRATIC, FF_QUADRIC, FF_SINC, FF_JINC, FF_SPHINX, FF_CUBIC,
    FF_HERMITE, FF_BICUBIC, FF_BCSPLINE, FF_CATMULL_ROM, FF_MITCHELL,
    FF_ROBIDOUX, FF_ROBIDOUXSHARP, FF_SPLINE16, FF_SPLINE36, FF_SPLINE64,
    FF_OVERSAMPLE,
]

_FF_BY_NAME = {f.name: f for f in FILTER_FUNCTIONS}


def find_filter_function(name: str) -> Optional[FilterFunction]:
    return _FF_BY_NAME.get(name)


# ---------------------------------------------------------------------------
# Filter configs (reference pl_filter_config, filters.c:667-934)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FilterConfig:
    name: str
    kernel: FilterFunction = FF_BOX
    window: Optional[FilterFunction] = None
    radius: float = 0.0          # overrides kernel radius if resizable
    clamp: float = 0.0           # 1.0 = clip negative lobes
    blur: float = 0.0            # kernel width scale (>1 = blur)
    taper: float = 0.0           # flat center region
    polar: bool = False          # EWA (radial 2D) vs separable
    antiring: float = 0.0        # anti-ringing strength
    params: Tuple[float, float] = (0.0, 0.0)    # kernel tuning overrides
    wparams: Tuple[float, float] = (0.0, 0.0)   # window tuning overrides
    description: str = ""
    allowed: FilterUsage = FilterUsage.ALL
    recommended: FilterUsage = FilterUsage(0)

    def radius_bound(self) -> float:
        """Maximum possible radius (reference pl_filter_radius_bound,
        filters.h:22-26): the blur coefficient scales the kernel's
        support (omitting it mis-stretches the window and widens the
        cutoff of the *sharp variants)."""
        if self.radius and self.kernel.resizable:
            r = self.radius
        else:
            r = self.radius or self.kernel.radius
        return r * self.blur if self.blur > 0.0 else r

    def key(self) -> tuple:
        """Hashable identity for LUT caching."""
        return (self.name, self.kernel.name,
                self.window.name if self.window else None, self.radius,
                self.clamp, self.blur, self.taper, self.polar,
                self.antiring, self.params, self.wparams)


def _eff_params(fn: FilterFunction, override: Tuple[float, float]):
    return tuple(override[i] if fn.tunable[i] else fn.params[i]
                 for i in range(2))


def sample_filter(c: FilterConfig, x) -> np.ndarray:
    """Evaluate the filter kernel (with window/blur/taper/clamp) at |x|
    (reference pl_filter_sample, filters.c:82-124). Vectorized."""
    radius = c.radius_bound()
    x = np.abs(np.asarray(x, dtype=np.float64))
    inside = x <= radius

    kx = np.where(x <= c.taper, 0.0,
                  (x - c.taper) / (1.0 - c.taper / radius)) \
        if c.taper > 0 else x
    if c.blur > 0.0:
        kx = kx / c.blur
    kp = _eff_params(c.kernel, c.params)
    k = c.kernel.weight(kx, radius, *kp)

    if c.window is not None:
        wx = x / radius * c.window.radius
        wp = _eff_params(c.window, c.wparams)
        k = k * c.window.weight(wx, c.window.radius, *wp)

    if c.clamp > 0:
        k = np.where(k < 0, (1 - c.clamp) * k, k)
    return np.where(inside, k, 0.0)


def filter_cutoffs(c: FilterConfig, cutoff: float = 0.0,
                   ) -> Tuple[float, float]:
    """Scan for the effective radius where |weight| falls below `cutoff`
    permanently; returns (radius, radius_zero) like the reference
    (filters.c:126-152). radius_zero is the first zero crossing (main lobe).
    """
    bound = c.radius_bound()
    # include one sample beyond the bound (where the kernel is exactly 0)
    # so the final zero crossing at the bound itself is detected, matching
    # the reference's float-accumulated loop behavior
    xs = np.arange(0.0, bound + 2e-2, 1e-2)
    fs = sample_filter(c, xs)
    radius = radius_zero = bound
    found = False
    for i in range(1, len(xs)):
        fprev, fx = fs[i - 1], fs[i]
        if (fprev > cutoff and fx <= cutoff) or \
                (fprev < -cutoff and fx >= -cutoff):
            denom = fx - fprev
            root = xs[i] - fx * (xs[i] - xs[i - 1]) / denom if denom else xs[i]
            root = min(root, bound)
            radius = root
            if not found:
                radius_zero = root
            found = True
    if not found:
        radius = radius_zero = bound
    return float(radius), float(radius_zero)


# ---------------------------------------------------------------------------
# Generated filter (weights LUT) — reference pl_filter_generate
# ---------------------------------------------------------------------------

@dataclass
class Filter:
    config: FilterConfig
    radius: float                 # effective (cutoff) radius
    radius_zero: float            # first zero crossing
    weights: np.ndarray           # polar: (lut_entries,) ; ortho: (lut_entries, row_size)
    row_size: int = 0             # taps per row (separable only)
    insufficient: bool = False


def generate(config: FilterConfig, lut_entries: int = 64,
             cutoff: float = 0.0, max_row_size: int = 0) -> Filter:
    """Generate the weight LUT for a filter config.

    polar=True : 1-D LUT of lut_entries weights indexed by radius
                 (r/radius * (n-1)); fed to the EWA sampler.
    polar=False: 2-D LUT (lut_entries x row_size) of *normalized* rows
                 indexed by subpixel phase offset in [0, 1]; fed to the
                 separable sampler. Rows are energy-normalized.
    """
    radius, radius_zero = filter_cutoffs(config, cutoff)
    insufficient = False

    if config.polar:
        xs = radius * np.arange(lut_entries) / (lut_entries - 1)
        weights = sample_filter(config, xs).astype(np.float32)
        return Filter(config, radius, radius_zero, weights)

    row_size = int(math.ceil(radius)) * 2
    if max_row_size and row_size > max_row_size:
        row_size = max_row_size
        insufficient = True
    base = row_size / 2 - 1
    offsets = np.arange(lut_entries) / (lut_entries - 1)     # phases [0,1]
    idx = np.arange(row_size)
    # distance of each tap from the sampled position, per phase
    dist = idx[None, :] - (base + offsets[:, None])
    rows = sample_filter(config, dist)
    wsum = rows.sum(axis=1, keepdims=True)
    rows = rows / wsum
    return Filter(config, radius, radius_zero, rows.astype(np.float32),
                  row_size=row_size, insufficient=insufficient)


# ---------------------------------------------------------------------------
# Named configs (reference filters.c:667-934)
# ---------------------------------------------------------------------------

_U, _D, _S, _F, _A = (FilterUsage.UPSCALING, FilterUsage.DOWNSCALING,
                      FilterUsage.SCALING, FilterUsage.FRAME_MIXING,
                      FilterUsage.ALL)

FILTER_CONFIGS = [
    FilterConfig("spline16", FF_SPLINE16, description="Spline (2 taps)", allowed=_A),
    FilterConfig("spline36", FF_SPLINE36, description="Spline (3 taps)", allowed=_A),
    FilterConfig("spline64", FF_SPLINE64, description="Spline (4 taps)", allowed=_A),
    FilterConfig("nearest", FF_BOX, radius=0.5, description="Nearest neighbor", allowed=_U, recommended=_U),
    FilterConfig("box", FF_BOX, radius=0.5, description="Box averaging", allowed=_S, recommended=_D),
    FilterConfig("bilinear", FF_TRIANGLE, description="Bilinear", allowed=_A, recommended=_S),
    FilterConfig("linear", FF_TRIANGLE, description="Linear mixing", allowed=_F, recommended=_F),
    FilterConfig("triangle", FF_TRIANGLE, allowed=_S),
    FilterConfig("gaussian", FF_GAUSSIAN, params=(1.0, 0.0), description="Gaussian", allowed=_A, recommended=_S),
    FilterConfig("sinc", FF_SINC, radius=2.0, description="Sinc (unwindowed)", allowed=_A),
    FilterConfig("lanczos", FF_SINC, FF_SINC, radius=3.0, description="Lanczos", allowed=_A, recommended=_S),
    FilterConfig("ginseng", FF_SINC, FF_JINC, radius=3.0, description="Ginseng (Jinc-Sinc)", allowed=_A),
    FilterConfig("ewa_jinc", FF_JINC, radius=JINC_ZERO3, polar=True, description="EWA Jinc (unwindowed)", allowed=_S),
    FilterConfig("ewa_lanczos", FF_JINC, FF_JINC, radius=JINC_ZERO3, polar=True, description="Jinc (EWA Lanczos)", allowed=_S, recommended=_U),
    FilterConfig("ewa_lanczossharp", FF_JINC, FF_JINC, radius=JINC_ZERO3,
                 blur=0.98125058372237073562493, polar=True,
                 description="Sharpened Jinc", allowed=_S, recommended=_U),
    FilterConfig("ewa_lanczos4sharpest", FF_JINC, FF_JINC, radius=JINC_ZERO4,
                 blur=0.88451209326050047745788, antiring=0.8, polar=True,
                 description="Sharpened Jinc-AR, 4 taps", allowed=_S, recommended=_U),
    FilterConfig("ewa_ginseng", FF_JINC, FF_SINC, radius=JINC_ZERO3, polar=True, description="EWA Ginseng", allowed=_S),
    FilterConfig("ewa_hann", FF_JINC, FF_HANN, radius=JINC_ZERO3, polar=True, description="EWA Hann", allowed=_S),
    FilterConfig("ewa_hanning", FF_JINC, FF_HANN, radius=JINC_ZERO3, polar=True, allowed=_S),
    FilterConfig("bicubic", FF_CUBIC, params=(1.0, 0.0), description="Bicubic", allowed=_S, recommended=_S),
    FilterConfig("cubic", FF_CUBIC, params=(1.0, 0.0), description="Cubic", allowed=_F),
    FilterConfig("hermite", FF_HERMITE, description="Hermite", allowed=_A, recommended=_D | _F),
    FilterConfig("catmull_rom", FF_CUBIC, params=(0.0, 0.5), description="Catmull-Rom", allowed=_A, recommended=_S),
    FilterConfig("mitchell", FF_CUBIC, params=(1 / 3.0, 1 / 3.0), description="Mitchell-Netravali", allowed=_A, recommended=_D),
    FilterConfig("mitchell_clamp", FF_CUBIC, params=(1 / 3.0, 1 / 3.0), clamp=1.0, description="Mitchell (clamped)", allowed=_A),
    FilterConfig("robidoux", FF_CUBIC, params=(12 / (19 + 9 * _SQRT2), 113 / (58 + 216 * _SQRT2)), description="Robidoux", allowed=_A),
    FilterConfig("robidouxsharp", FF_CUBIC, params=(6 / (13 + 7 * _SQRT2), 7 / (2 + 12 * _SQRT2)), description="RobidouxSharp", allowed=_A),
    FilterConfig("ewa_robidoux", FF_CUBIC, params=(12 / (19 + 9 * _SQRT2), 113 / (58 + 216 * _SQRT2)), polar=True, description="EWA Robidoux", allowed=_S),
    FilterConfig("ewa_robidouxsharp", FF_CUBIC, params=(6 / (13 + 7 * _SQRT2), 7 / (2 + 12 * _SQRT2)), polar=True, description="EWA RobidouxSharp", allowed=_S),
    FilterConfig("oversample", FF_OVERSAMPLE, params=(0.0, 0.0), description="Oversampling", allowed=_U | _F, recommended=_U | _F),
]

_FC_BY_NAME: Dict[str, FilterConfig] = {c.name: c for c in FILTER_CONFIGS}


def find_filter_config(name: str,
                       usage: FilterUsage = FilterUsage.ALL,
                       ) -> Optional[FilterConfig]:
    c = _FC_BY_NAME.get(name)
    if c is not None and not (c.allowed & usage):
        return None
    return c

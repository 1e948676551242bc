"""Native host code, copies of the reference package's native sources so
that the port's tables are bit-identical to it:

- `dither.cc`: the void-and-cluster blue-noise generator;
- `grain.cc`: AV1 film-grain table generation (the grain LUTs' LFSR and
  auto-regressive filter, and the per-block offsets);
- `gamut.cc`: the gamut-mapping 3D LUT (core/gamut_mapping.generate),
  each entry scalar with the reference's one-item per-hue peak cache;
- `copy.cc`: the upload's host copy of a plane into pinned memory on
  several threads (utils/device.copy_in_bands), the port's own.

Each is built with g++ into `build/` at first use; a build that fails
raises (for the tables there is no equivalent fallback).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .._build import load_shared

__all__ = ["build_specs", "blue_noise_native", "grain_y_native", "grain_uv_native",
           "grain_offsets_native", "gamut_lut_native", "GAMUT_OP_IDS",
           "copy_rows_native"]

_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17"]


def _host_spec(name: str, source: str):
    return (name, [os.path.join("native", source)],
            os.environ.get("CXX", "g++"), _CXX_FLAGS)


def build_specs():
    """The host libraries' build specs (_build.build_all)."""
    return [_host_spec("plnative_dither", "dither.cc"),
            _host_spec("plnative_grain", "grain.cc"),
            _host_spec("plnative_gamut", "gamut.cc"),
            _host_spec("plnative_copy", "copy.cc")]


def _host_lib(name: str, source: str) -> ctypes.CDLL:
    return load_shared(*_host_spec(name, source))


def blue_noise_native(shift: int) -> np.ndarray:
    """(2^shift)^2 blue-noise rank matrix in [0, 1)."""
    fn = _host_lib("plnative_dither", "dither.cc").pl_blue_noise
    fn.argtypes = [ctypes.c_int, np.ctypeslib.ndpointer(
        np.float32, flags="C_CONTIGUOUS")]
    fn.restype = None
    size = 1 << shift
    out = np.zeros((size, size), np.float32)
    fn(shift, out)
    return out


@functools.lru_cache(maxsize=None)
def _grain_lib() -> ctypes.CDLL:
    lib = _host_lib("plnative_grain", "grain.cc")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c = ctypes
    lib.pl_av1_grain_y.argtypes = [
        i16p, c.c_uint32, c.c_int, c.c_int, c.c_int, i32p, c.c_int,
        f32p, i16p]
    lib.pl_av1_grain_uv.argtypes = [
        i16p, c.c_uint32, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, i32p, c.c_int, i16p, f32p]
    lib.pl_av1_grain_offsets.argtypes = [c.c_uint32, c.c_int, c.c_int, u32p]
    for fn in (lib.pl_av1_grain_y, lib.pl_av1_grain_uv,
               lib.pl_av1_grain_offsets):
        fn.restype = None
    return lib


def grain_y_native(gauss: np.ndarray, seed: int, bits: int,
                   grain_scale_shift: int, ar_coeff_lag: int,
                   ar_coeffs_y, ar_coeff_shift: int):
    """(64, 64) float32 luma grain LUT and the raw (73, 82) int16 buffer
    that chroma generation reads."""
    lut = np.zeros((64, 64), np.float32)
    buf = np.zeros((73, 82), np.int16)
    coeffs = np.zeros(24, np.int32)
    cy = np.asarray(ar_coeffs_y, np.int32)
    coeffs[:len(cy)] = cy
    _grain_lib().pl_av1_grain_y(
        np.ascontiguousarray(gauss, np.int16), seed & 0xFFFF, bits,
        grain_scale_shift, ar_coeff_lag, coeffs, ar_coeff_shift, lut, buf)
    return lut, buf


def grain_uv_native(gauss: np.ndarray, seed: int, channel: int,
                    sub_x: int, sub_y: int, bits: int,
                    grain_scale_shift: int, num_points_y: int,
                    ar_coeff_lag: int, ar_coeffs_uv, ar_coeff_shift: int,
                    buf_y: np.ndarray) -> np.ndarray:
    """(64 >> sub_y, 64 >> sub_x) float32 chroma grain LUT."""
    lut = np.zeros((64 >> sub_y, 64 >> sub_x), np.float32)
    coeffs = np.zeros(25, np.int32)
    cu = np.asarray(ar_coeffs_uv, np.int32)
    coeffs[:len(cu)] = cu
    _grain_lib().pl_av1_grain_uv(
        np.ascontiguousarray(gauss, np.int16), seed & 0xFFFF, channel,
        sub_x, sub_y, bits, grain_scale_shift, num_points_y, ar_coeff_lag,
        coeffs, ar_coeff_shift, np.ascontiguousarray(buf_y, np.int16), lut)
    return lut


def grain_offsets_native(seed: int, blocks_w: int,
                         blocks_h: int) -> np.ndarray:
    """(blocks_h, blocks_w) packed per-block offsets, uint32."""
    out = np.zeros((blocks_h, blocks_w), np.uint32)
    _grain_lib().pl_av1_grain_offsets(seed & 0xFFFF, blocks_w, blocks_h, out)
    return out


# operator ids shared with gamut.cc (enum Op)
GAMUT_OP_IDS = {
    "clip": 0, "perceptual": 1, "softclip": 2, "relative": 3,
    "saturation": 4, "absolute": 5, "desaturate": 6, "darken": 7,
    "highlight": 8, "linear": 9,
}


@functools.lru_cache(maxsize=None)
def _gamut_lib() -> ctypes.CDLL:
    lib = _host_lib("plnative_gamut", "gamut.cc")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c = ctypes
    lib.plg_gamut_generate.argtypes = [
        c.c_int, f64p, f64p, f64p, f64p, f64p, c.c_double, c.c_double,
        f64p, c.c_int, c.c_int, c.c_int, f32p]
    lib.plg_gamut_generate.restype = c.c_int
    return lib


def gamut_lut_native(op_name: str, src_rgb2lms, src_lms2rgb,
                     dst_rgb2lms, dst_lms2rgb, adapt,
                     min_luma: float, max_luma: float, consts,
                     NI: int, NC: int, Nh: int) -> np.ndarray:
    """The (Nh, NC, NI, 3) float32 gamut-mapping LUT from gamut.cc (the
    reference package's native/__init__.py:164).  An unknown operator
    raises KeyError, a non-zero return code RuntimeError."""
    op = GAMUT_OP_IDS[op_name]
    out = np.zeros((Nh, NC, NI, 3), np.float32)

    def m9(x):
        return np.ascontiguousarray(np.asarray(x, np.float64).reshape(9))
    rc = _gamut_lib().plg_gamut_generate(
        op, m9(src_rgb2lms), m9(src_lms2rgb), m9(dst_rgb2lms),
        m9(dst_lms2rgb), m9(adapt), float(min_luma), float(max_luma),
        np.ascontiguousarray(np.asarray(consts, np.float64).reshape(5)),
        NI, NC, Nh, out)
    if rc != 0:
        raise RuntimeError(f"plg_gamut_generate returned {rc}")
    return out


@functools.lru_cache(maxsize=None)
def _copy_lib() -> ctypes.CDLL:
    lib = _host_lib("plnative_copy", "copy.cc")
    c = ctypes
    lib.pl_copy_rows.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                 c.c_int64, c.c_int64, c.c_int64, c.c_int,
                                 c.c_int64]
    lib.pl_copy_rows.restype = None
    return lib


def copy_rows_native(dst: np.ndarray, src: np.ndarray, threads: int,
                     bands: int) -> None:
    """dst[...] = src, for arrays of one shape and dtype whose rows (first
    axis) are each contiguous, in `bands` bands of whole rows that the
    calling thread and up to `threads` - 1 helper threads claim in turn
    (copy.cc); the interpreter's lock is released meanwhile."""
    if dst.shape != src.shape or dst.dtype != src.dtype or src.ndim < 2 \
            or not (dst[0].flags.c_contiguous and src[0].flags.c_contiguous
                    and dst.flags.writeable) or threads < 1 or bands < 1:
        raise ValueError("copy_rows_native needs two arrays of one shape "
                         "and dtype with contiguous rows, a writable dst")
    _copy_lib().pl_copy_rows(
        dst.ctypes.data, src.ctypes.data, src.shape[0], src[0].nbytes,
        dst.strides[0], src.strides[0], threads, bands)

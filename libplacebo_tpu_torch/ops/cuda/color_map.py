"""K1 — the fused color-map tail — as a hand-written Hopper kernel, with
its plain PyTorch version beside it.

Replaces libplacebo_tpu/ops/pallas/color_map.py::fused_pointwise for
the chain `Renderer._fused_tail` builds on the main path: spline tone
map + perceptual gamut map (one IPT round trip), sRGB delinearize,
identity RGB encode, ordered dither, and the per-stripe peak partials.
The Pallas kernel traces whatever tail it is given; a hand-written
kernel cannot, so `plan_tail` says which chains this one covers (None
for any other: the renderer then runs the plain stages, as the
reference does when its tail is not eligible).

Everything static is planned on the host in float64 and packed once
into one float32 vector (`LAYOUT`), kept in host memory: each launch
copies it into the kernel's parameters, where the kernel reads every
coefficient at a compile-time offset, with no staging in shared memory.  The per-frame spline scalars
form a second, 8-long vector on the device.  The kernel
(csrc/color_map.cu) and the plain version (`color_map_plain`) both read
those two vectors, so they cannot compute their constants apart.  The
plain version repeats the kernel's arithmetic operation for operation.

`color_map_tail` is the entry: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (and counts the launch in `launches`)
or raises.  The kernel is built with nvcc at first use; see
csrc/color_map.cu for what bounds it on the card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ...core import transfer as tf
from ...core.fastmath import f32_mul, fma, mix, rcp, sqrt
from ...core.colorspace import (COLOR_SDR_WHITE, ColorTransfer,
                                color_repr_decode)
from ...core.gamut_mapping import IPT2LMS, LMS2IPT
from ..color import nominal_luma_norm
from ..gamut import GamutBoundary, boundary_rows, HARMONICS, POLY_DEG
from ..peak_detect import stripe_partials

__all__ = ["LAYOUT", "TailPlan", "RowMasks", "plan_tail", "pack_constants",
           "row_masks", "color_map_tail", "color_map_plain",
           "pick_block_rows", "launches", "ops_per_pixel", "sqrt_check",
           "build", "build_spec"]

_NCOEF = (2 * HARMONICS + 1) * (POLY_DEG + 1)

# name -> length of every constant the chain reads, in packing order
LAYOUT = (
    ("to_norm", 1), ("rcp_to_norm", 1),
    ("src_rgb2lms", 9), ("lms2ipt", 9), ("ipt2lms", 9), ("dst_lms2rgb", 9),
    ("pq_c1", 1), ("pq_c2", 1), ("pq_c3", 1),
    ("oetf_p", len(tf.OETF_P_COEF)), ("oetf_t", len(tf.OETF_T_COEF)),
    ("eotf_p", len(tf.EOTF_P_COEF)), ("eotf_t", len(tf.EOTF_T_COEF)),
    ("eotf_p_m_c1", 1),
    ("dst_min_pq", 1), ("dst_max_pq", 1),
    ("luma_min", 1), ("luma_rcp", 1),
    ("src_coefs", _NCOEF), ("dst_coefs", _NCOEF),
    ("dst_max_rgb", 1), ("dst_min_rgb", 1), ("rgb_safe", 1), ("rgb_rcp", 1),
    ("knee", 1), ("knee_jj", 1), ("knee_neg_jj", 1), ("knee_jj_m_2j", 1),
    ("knee_2j", 1), ("knee_2j_rcp", 1), ("rcp_blend", 1), ("strength", 1),
    ("lin_lo", 1), ("lin_rcp", 1), ("srgb", 5),
    ("dither_scale", 1), ("dither_rcp", 1),
    ("peak_norm", 1), ("black_cutoff", 1),
)
_OFF: Dict[str, int] = {}
_n = 0
for _name, _len in LAYOUT:
    _OFF[_name] = _n
    _n += _len
NCONST = _n

# The kernel takes the packed vector by value among its parameters,
# which may hold 4096 bytes; the rest of its list is 5 pointers and 9
# ints (csrc/color_map.cu checks the same with a static_assert).
PARAM_LIMIT = 4096
PARAM_BYTES = 4 * NCONST + 5 * 8 + 9 * 4
assert PARAM_BYTES <= PARAM_LIMIT, (PARAM_BYTES, PARAM_LIMIT)

# FP32 operations per pixel of the kernel's chain, counted from
# csrc/color_map.cu (each add, multiply, divide, sqrt, exp, log, min,
# max, compare or floor counts 1, a fused multiply-add 2).  Always run:
# peak partials 61, RGB->ICh 190 (three pow-free PQ curves at 49 each),
# spline + hull 26, Fourier basis + intensity powers 55, chroma softclip
# 44, ICh->RGB 179, the RGB softclip's per-pixel terms from the largest
# channel 27 (peak 1, bb's numerator 3, a 5, bb 3, scale 7, blend weight
# 8), then per channel the softclip's rest + delinearize + sRGB 3 x 25,
# the largest channel 3, and each boundary fit's floor 1.
_OPS_FIXED = 61 + 190 + 26 + 55 + 44 + 179 + 27 + 3 * 25 + 3 + 2
_OPS_ROW0 = 13          # a fit's constant row: 1 multiply + 6 FMAs
_OPS_ROW = 15           # any other kept row, then times its basis term
_OPS_DITHER = 3 * 4     # per channel an FMA, a floor and a multiply

launches = 0
_SUB = 64 + 3          # a kernel block's partials record (csrc: kSub)
_COLS = 128            # columns a kernel block (csrc: kThreads)


def pick_block_rows(h: int, budget_rows: int = 8) -> int:
    """Rows per stripe: the reference kernel's partition
    (color_map.py::_pick_block_rows) — the largest divisor of h up to
    the budget, preferring multiples of 8."""
    best = 0
    for bh in range(budget_rows, 0, -1):
        if h % bh == 0 and bh % 8 == 0:
            return bh
        if h % bh == 0 and best == 0:
            best = bh
    return best or budget_rows


_MATRICES = ("src_rgb2lms", "lms2ipt", "ipt2lms", "dst_lms2rgb")


class RowMasks(NamedTuple):
    """Bit r of `*_kept`: row r of that boundary fit has a nonzero
    coefficient (the kernel skips the others); bit r of `*_swap`: its
    first two products fuse in the other order (c[0] < 0 < c[1]);
    bit 3 m + i of `mat_swap`: row i of matrix m of `_MATRICES` fuses
    its second product first (w0 == 1, or w0 < 0 < w1 != 1) — the
    rounding of core/fastmath.py::mix."""
    src_kept: int
    dst_kept: int
    src_swap: int
    dst_swap: int
    mat_swap: int


def _fit_rows(consts, name):
    c = np.asarray(consts, np.float32)
    return c[_OFF[name]:_OFF[name] + _NCOEF].reshape(
        2 * HARMONICS + 1, POLY_DEG + 1)


def _matrix(consts, name):
    c = np.asarray(consts, np.float32)
    return c[_OFF[name]:_OFF[name] + 9].reshape(3, 3)


def _bits(flags) -> int:
    return sum(1 << r for r, f in enumerate(flags) if f)


def row_masks(consts) -> RowMasks:
    """The kernel's RowMasks of the packed constants (host memory)."""
    src, dst = _fit_rows(consts, "src_coefs"), _fit_rows(consts, "dst_coefs")
    m = np.concatenate([_matrix(consts, name) for name in _MATRICES])
    return RowMasks(_bits((src != 0).any(axis=1)),
                    _bits((dst != 0).any(axis=1)),
                    _bits((src[:, 0] < 0) & (src[:, 1] > 0)),
                    _bits((dst[:, 0] < 0) & (dst[:, 1] > 0)),
                    _bits((m[:, 0] == 1) | ((m[:, 0] < 0) & (m[:, 1] > 0)
                                            & (m[:, 1] != 1))))


@dataclass(frozen=True)
class TailPlan:
    """Host plan of one K1 chain: the packed constants (kept as a
    read-only copy), the dither LUT (None = no dither), and the row masks,
    always derived from those constants."""
    consts: np.ndarray
    lut: Optional[np.ndarray] = None
    rows: RowMasks = field(init=False)

    def __post_init__(self):
        consts = np.array(self.consts, np.float32)
        consts.setflags(write=False)
        object.__setattr__(self, "consts", consts)
        object.__setattr__(self, "rows", row_masks(consts))


def pack_constants(b_src: GamutBoundary, b_dst: GamutBoundary,
                   dst_min_pq: float, dst_max_pq: float, gamut_constants,
                   dst_color, bit_depth: int, black_cutoff: float
                   ) -> np.ndarray:
    """Every static constant of the chain, derived in float64 exactly as
    the reference's stage functions derive them, then rounded once to
    float32 in LAYOUT order."""
    c = gamut_constants.fixed()
    j = c.softclip_knee
    to_norm = COLOR_SDR_WHITE / 10000.0
    lo, hi = nominal_luma_norm(dst_color)
    scaled = hi != 1.0 or lo != 0.0
    scale = float((1 << bit_depth) - 1) if bit_depth else 0.0
    rgb_safe = max(b_dst.max_rgb, 1e-9)
    vals = dict(
        to_norm=to_norm, rcp_to_norm=rcp(to_norm),
        src_rgb2lms=np.ravel(b_src.rgb2lms), lms2ipt=np.ravel(LMS2IPT),
        ipt2lms=np.ravel(IPT2LMS), dst_lms2rgb=np.ravel(b_dst.lms2rgb),
        pq_c1=tf.PQ_C1, pq_c2=tf.PQ_C2, pq_c3=tf.PQ_C3,
        oetf_p=tf.OETF_P_COEF, oetf_t=tf.OETF_T_COEF,
        eotf_p=tf.EOTF_P_COEF, eotf_t=tf.EOTF_T_COEF,
        eotf_p_m_c1=tf.EOTF_P_LAST_M_C1,
        dst_min_pq=dst_min_pq, dst_max_pq=dst_max_pq,
        luma_min=b_dst.min_luma,
        luma_rcp=rcp(max(b_dst.max_luma - b_dst.min_luma, 1e-9)),
        src_coefs=boundary_rows(b_src).ravel(),
        dst_coefs=boundary_rows(b_dst).ravel(),
        dst_max_rgb=b_dst.max_rgb, dst_min_rgb=b_dst.min_rgb,
        rgb_safe=rgb_safe, rgb_rcp=rcp(rgb_safe),
        knee=j, knee_jj=j * j, knee_neg_jj=-j * j,
        knee_jj_m_2j=j * j - 2.0 * j, knee_2j=2.0 * j,
        knee_2j_rcp=f32_mul(2.0 * j, rcp(rgb_safe)),
        rcp_blend=rcp(0.02), strength=c.perceptual_strength,
        lin_lo=lo if scaled else 0.0,
        lin_rcp=rcp(hi - lo) if scaled else 1.0,
        srgb=(0.0031308, 12.92, 1.055, 1.0 / 2.4, 0.055),
        dither_scale=scale, dither_rcp=rcp(scale) if scale else 0.0,
        peak_norm=COLOR_SDR_WHITE / 10000.0,
        black_cutoff=black_cutoff / 100.0)
    out = np.zeros(NCONST, np.float32)
    for name, n in LAYOUT:
        v = np.asarray(vals[name], np.float64).ravel()
        assert v.size == n, (name, v.size, n)
        out[_OFF[name]:_OFF[name] + n] = v.astype(np.float32)
    return out


def plan_tail(params, dst_color, target, b_src, b_dst, dst_min_pq,
              dst_max_pq, fused_peak: bool, dither_lut) -> Optional[TailPlan]:
    """The K1 plan for this tail, or None when the chain is not the one
    the kernel implements: spline tone map with detected stats measured
    in the same pass (allow_delayed), perceptual gamut map between two
    fitted boundaries over one luma range, an sRGB target with an
    identity encode, and an ordered dither or none.  `dither_lut` is
    the square LUT (None = no dither)."""
    if not (fused_peak and params.tone_mapping_function == "spline"
            and params.gamut_mapping == "perceptual"
            and b_src.coefs is not None and b_dst.coefs is not None
            and (b_src.min_luma, b_src.max_luma) ==
            (b_dst.min_luma, b_dst.max_luma)
            and dst_color.transfer == ColorTransfer.SRGB
            and not params.show_clipping):
        return None
    enc, _ = color_repr_decode(target.repr)
    if not (np.array_equal(enc.mat.m, np.eye(3)) and not enc.c.any()):
        return None
    for b in (b_src, b_dst):
        # the kernel sums a kept row as a plain multiply-add chain, which
        # is `mix` only when no coefficient of it is 0 or 1
        rows = boundary_rows(b)
        if not all((r == 0).all() or ((r != 0) & (r != 1)).all()
                   for r in rows):
            return None
    consts = pack_constants(b_src, b_dst, dst_min_pq, dst_max_pq,
                            params.gamut_constants, dst_color,
                            target.bit_depth if dither_lut is not None
                            else 0, params.peak_detect.black_cutoff)
    # the kernel mixes every matrix row as three products (`mix` skips a
    # zero weight, which no pair of real primaries gives)
    if any((_matrix(consts, name) == 0).any() for name in _MATRICES):
        return None
    return TailPlan(consts, dither_lut)


def ops_per_pixel(consts) -> int:
    """FP32 operations the kernel runs per pixel with these packed
    constants: the fixed chain, every boundary-fit row that
    `boundary_rows` kept (the kernel skips an all-zero, pruned row), and
    the dither where the plan dithers (a nonzero dither scale)."""
    c = np.asarray(consts)
    ops = _OPS_FIXED
    for kept in row_masks(c)[:2]:
        ops += _OPS_ROW0 * (kept & 1) + _OPS_ROW * bin(kept >> 1).count("1")
    if c[_OFF["dither_scale"]] != 0:
        ops += _OPS_DITHER
    return ops


# ---------------------------------------------------------------------------
# The plain version: the kernel's arithmetic in PyTorch
# ---------------------------------------------------------------------------

def _unpack(consts: torch.Tensor) -> Dict[str, object]:
    vals = consts.tolist()
    return {name: (vals[_OFF[name]] if n == 1 else
                   vals[_OFF[name]:_OFF[name] + n]) for name, n in LAYOUT}


def _poly(c, x):
    out = torch.full_like(x, c[0])
    for ci in c[1:]:
        out = fma(x, out, ci)
    return out


def _pq_oetf(k, y):
    y = torch.clamp(y, 1e-7, 1.0)
    u = sqrt(sqrt(sqrt(y)))
    p = u * _poly(k["oetf_p"], u)
    v = fma(p, k["pq_c2"], k["pq_c1"]) / fma(p, k["pq_c3"], 1.0)
    v2 = v * v
    v4 = v2 * v2
    v8 = v4 * v4
    v16 = v8 * v8
    v32 = v16 * v16
    v64 = v32 * v32
    return v64 * v8 * v4 * v2 * _poly(k["oetf_t"], v)


def _pq_eotf(k, x):
    u = torch.clamp(x, 1e-8, 1.0)
    for _ in range(6):
        u = sqrt(u)
    uq = u * _poly(k["eotf_p"][:-1], u)
    p = uq + k["eotf_p"][-1]
    r = torch.clamp_min(uq + k["eotf_p_m_c1"], 0.0) / \
        fma(p, -k["pq_c3"], k["pq_c2"])
    s = sqrt(sqrt(sqrt(torch.clamp_min(r, 0.0))))
    r2 = r * r
    return r2 * r2 * r2 * _poly(k["eotf_t"], s)


def _mat3(m, xs):
    """3x3 channel mix, zero weights skipped, rounded like mat_pointwise."""
    out = []
    for i in range(3):
        row = [(x, w) for x, w in zip(xs, m[3 * i:3 * i + 3]) if w != 0.0]
        out.append(mix([x for x, _ in row], [w for _, w in row])
                   if row else torch.zeros_like(xs[0]))
    return out


def _softclip(k, value, source, target=None):
    """Soft-clip against a tensor `target`, or (None) against the
    constant dst_max_rgb, whose divisions are products with its
    reciprocal (ops/gamut.py::_softclip_dev)."""
    if target is not None:
        safe_t = torch.clamp_min(target, 1e-9)
        peak = source / safe_t
        x = torch.minimum(value / safe_t, peak)
        bb_num = fma(peak, -k["knee_2j"], k["knee_jj"]) + peak
    else:
        safe_t = k["rgb_safe"]
        peak = source * k["rgb_rcp"]
        x = torch.minimum(value * k["rgb_rcp"], peak)
        bb_num = fma(source, -k["knee_2j_rcp"], k["knee_jj"]) + peak
    denom_a = k["knee_jj_m_2j"] + peak
    denom_a = torch.where(torch.abs(denom_a) < 1e-9,
                          torch.full_like(denom_a, 1e-9), denom_a)
    a = k["knee_neg_jj"] * (peak - 1.0) / denom_a
    bb = bb_num / torch.clamp_min(peak - 1.0, 1e-2)
    scale = (fma(bb, bb, 2.0 * bb * k["knee"]) + k["knee_jj"]) / (bb - a)
    denom = x + bb
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-6),
                       torch.full_like(denom, 1e-6))
    denom = torch.where(torch.abs(denom) < 1e-6, tiny, denom)
    mapped_m_value = fma(scale * (x + a) / denom, safe_t, -value)
    t = torch.clamp((peak - 1.0) * k["rcp_blend"], 0.0, 1.0)
    w = t * t * fma(t, -2.0, 3.0)
    return torch.where(x <= k["knee"], value, fma(mapped_m_value, w, value))


def _boundary(coefs, cs, sn, pw):
    """C_max(I, h); an all-zero (pruned) row is skipped."""
    n = POLY_DEG + 1
    out = None
    for r in range(2 * HARMONICS + 1):
        c = coefs[r * n:(r + 1) * n]
        ds = [d for d in range(n) if c[d] != 0.0]
        if r == 0:
            out = mix([pw[d] for d in ds], [c[d] for d in ds]) if ds \
                else torch.zeros_like(pw[0])
        elif ds:
            basis = cs[(r - 1) // 2] if r % 2 else sn[r // 2 - 1]
            out = fma(mix([pw[d] for d in ds], [c[d] for d in ds]), basis,
                      out)
    return torch.clamp_min(out, 1e-5)


def color_map_plain(img, consts, spline, lut=None):
    """The kernel's function in plain PyTorch, on any device: (3, H, W)
    linear light in -> ((3, H, W) dithered signal, (G, 8, 128) peak
    partials)."""
    k = _unpack(consts)
    s = spline.tolist()
    src_max, src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc = s
    H, W = img.shape[-2], img.shape[-1]
    r, g, b = img[0], img[1], img[2]

    maxrgb = torch.clamp_min(torch.maximum(torch.maximum(r, g), b), 0.0)
    pq = torch.clamp(_pq_oetf(k, maxrgb * k["peak_norm"]), 0.0, 1.0)
    pq14 = torch.round(pq * 16383.0).to(torch.int32)
    active = pq > k["black_cutoff"]
    bins = torch.clamp((pq14 >> 7) - 64, 0, 63)
    partials = stripe_partials(pq, active, bins, pick_block_rows(H))

    lms = _mat3(k["src_rgb2lms"], [r * k["to_norm"], g * k["to_norm"],
                                   b * k["to_norm"]])
    lms = [_pq_oetf(k, torch.clamp_min(v, 0.0)) for v in lms]
    I, P, T = _mat3(k["lms2ipt"], lms)
    C = sqrt(fma(P, P, T * T) + 1e-18)
    cos_h, sin_h = P / C, T / C

    i_orig = I
    xs = torch.clamp(torch.clamp_min(I, 0.0), max=src_max) - src_pivot
    yv = torch.where(xs > 0, fma(fma(fma(xs, Qa, Qb), xs, Qc), xs, dst_pivot),
                     fma(fma(xs, Pa, Pb), xs, dst_pivot))
    I = torch.clamp(yv, k["dst_min_pq"], k["dst_max_pq"])
    hull_new = fma(I - 6.0, I, 9.0) * I
    hull_old = fma(i_orig - 6.0, i_orig, 9.0) * i_orig
    C = C * torch.minimum(i_orig / torch.clamp_min(I, 1e-6),
                          hull_new / torch.clamp_min(hull_old, 1e-6))

    cs, sn = [cos_h], [sin_h]
    for _ in range(1, HARMONICS):
        cs.append(fma(cs[-1], cos_h, -(sn[-1] * sin_h)))
        sn.append(fma(sn[-1], cos_h, cs[-2] * sin_h))
    i_rel = torch.clamp((I - k["luma_min"]) * k["luma_rcp"], 0.0, 1.0)
    pw = [sqrt(i_rel) * (1.0 - i_rel)]
    for _ in range(POLY_DEG):
        pw.append(pw[-1] * i_rel)
    c_src = _boundary(k["src_coefs"], cs, sn, pw)
    c_dst = _boundary(k["dst_coefs"], cs, sn, pw)
    c_new = _softclip(k, C, torch.maximum(c_src, c_dst), c_dst)
    c_new = fma(c_new - C, k["strength"], C)

    lmsp = _mat3(k["ipt2lms"], [I, c_new * cos_h, c_new * sin_h])
    rgb = _mat3(k["dst_lms2rgb"], [_pq_eotf(k, v) for v in lmsp])
    src_c = torch.clamp_min(torch.maximum(torch.maximum(rgb[0], rgb[1]),
                                          rgb[2]), k["dst_max_rgb"])
    sg = k["srgb"]
    outs = []
    for v in rgb:
        v = torch.clamp_min(_softclip(k, v, src_c),
                            k["dst_min_rgb"]) * k["rcp_to_norm"]
        v = torch.clamp_min((v - k["lin_lo"]) * k["lin_rcp"], 0.0)
        v = torch.where(v < sg[0], v * sg[1],
                        fma(tf.pow_pos(torch.clamp_min(v, sg[0]), sg[3]),
                            sg[2], -sg[4]))
        outs.append(v)
    out = torch.stack(outs)
    if lut is not None:
        n = lut.shape[0]
        reps = (-(-H // n), -(-W // n))
        bias = lut.to(img.device).tile(reps)[:H, :W]
        out = torch.floor(fma(out, k["dither_scale"], bias)) * \
            k["dither_rcp"]
    return out, partials


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def kernel_flags():
    """nvcc flags of K1: sm_90a, no fast-math, no FMA contraction beyond
    the source's explicit fmaf(), ptxas's register and spill report (kept
    beside the library, see _build.build_log), and the constant layout
    as macros."""
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             f"-DK1_NCONST={NCONST}",
             f"-DK1_N_OETF_P={len(tf.OETF_P_COEF)}",
             f"-DK1_N_OETF_T={len(tf.OETF_T_COEF)}",
             f"-DK1_N_EOTF_P={len(tf.EOTF_P_COEF)}",
             f"-DK1_N_EOTF_T={len(tf.EOTF_T_COEF)}"] + \
        [f"-DK1_OFF_{name}={off}" for name, off in _OFF.items()]


def build_spec():
    """The kernel library's build spec (_build.build_all)."""
    from ..._build import nvcc_path
    return ("k1_color_map", ["csrc/color_map.cu"], nvcc_path(),
            kernel_flags())


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    fn = lib.k1_color_map_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k1_sqrt_check_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k1_sqrt_check_launch.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _kernel_lib()


def sqrt_check(device) -> int:
    """How many floats the kernel's check-free square root (csrc:
    sqrt_in_range) rounds otherwise than sqrtf over the range the PQ
    curves clamp its operands into (csrc: kSqrtLo..kSqrtHi): 0 is
    exact."""
    lib = _kernel_lib()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    rc = lib.k1_sqrt_check_launch(
        bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 sqrt check failed: " +
                           lib.k1_error_string(rc).decode())
    return int(bad.item())


def _check(t, name, shape=None):
    if t.device.type != "cuda" or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"K1: {name} must be a contiguous float32 CUDA "
                         f"tensor, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"K1: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def color_map_tail(img, plan, spline, lut):
    """Run K1 on a (3, H, W) float32 frame of linear light.  `plan` is
    the chain's TailPlan (its packed constants in host memory and their
    row masks), `spline` the 8 per-frame spline scalars, `lut` the
    (n, n) dither LUT tensor (plan.lut on the frame's device) or None.
    Returns (out, (H / block_rows, 8, 128) peak partials)."""
    global launches
    if not isinstance(plan, TailPlan) or plan.consts.shape != (NCONST,):
        raise ValueError(f"K1: plan must be a TailPlan of {NCONST} "
                         f"constants")
    consts = plan.consts
    if img.device.type == "cpu":
        return color_map_plain(img, consts, spline, lut)
    if img.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {img.device}")
    C, H, W = img.shape
    _check(img, "img", (3, H, W))
    _check(spline, "spline", (8,))
    n = 0
    if lut is not None:
        n = lut.shape[0]
        _check(lut, "lut", (n, n))
        if n & (n - 1):
            raise ValueError(f"K1: dither LUT size {n} is not a power of 2")
    bh = pick_block_rows(H)
    if H % bh or W % _COLS:
        raise ValueError(f"K1: a {H}x{W} frame does not split into "
                         f"{bh}-row stripes of {_COLS}-column blocks")
    stripes = H // bh
    out = torch.empty_like(img)
    sub = torch.empty((stripes, W // _COLS, _SUB), dtype=torch.float32,
                      device=img.device)
    partials = torch.empty((stripes, 8, 128), dtype=torch.float32,
                           device=img.device)
    lib = _kernel_lib()
    rc = lib.k1_color_map_launch(
        img.data_ptr(), out.data_ptr(), sub.data_ptr(),
        partials.data_ptr(), consts.ctypes.data,
        spline.data_ptr(), lut.data_ptr() if lut is not None else None,
        n, H, W, bh, *plan.rows,
        torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: " +
                           lib.k1_error_string(rc).decode())
    launches += 1
    return out, partials

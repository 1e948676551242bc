"""K1 — the fused color-map tail — as a hand-written Hopper kernel, with
its plain PyTorch version beside it.

Replaces libplacebo_tpu/ops/pallas/color_map.py::fused_pointwise for
the chains `Renderer._fused_tail` builds: `color_map_stage` (a dynamic
tone curve — spline, bt2390, st2094-40, st2094-10 — or none, and the
gamut operator clip, perceptual or softclip through one IPT round trip,
or the pass-through fast path), sRGB delinearize, identity RGB encode,
ordered dither, and with a dynamic tone curve the per-stripe peak
partials.  The Pallas kernel traces whatever tail it is given; a
hand-written kernel cannot, so the tone function and the gamut operator
are template parameters of the kernel and `plan_tail` says which
chains the built instances cover (None for any other: the renderer
then runs the plain stages, as the reference does when its tail is not
eligible).

Everything static is planned on the host in float64 and packed once
into one float32 vector (`LAYOUT`), kept in host memory: each launch
copies it into the kernel's parameters, where the kernel reads every
coefficient at a compile-time offset, with no staging in shared memory.  The per-frame tone-curve
scalars form a second, 16-long vector on the device
(ops/tone_dynamic.py::tone_vector).  The kernel
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
from .. import tone_dynamic as ops_tone
from ..color import nominal_luma_norm
from ..gamut import (GamutBoundary, boundary_rows, hueshift_fourier,
                     HARMONICS, POLY_DEG)
from ..peak_detect import stripe_partials

__all__ = ["LAYOUT", "TailPlan", "RowMasks", "plan_tail", "pack_constants",
           "row_masks", "color_map_tail", "color_map_plain",
           "pick_block_rows", "launches", "ops_per_pixel", "sqrt_check",
           "build", "build_specs", "INSTANCES", "TONES", "GAMUTS",
           "instance_name"]

_NCOEF = (2 * HARMONICS + 1) * (POLY_DEG + 1)
_NFOURIER = 2 * HARMONICS + 1

# the kernel's template parameters: tone curve (0 none) and gamut
# operator (0 the pass-through fast path, 1 clamp in IPT, 2 perceptual,
# 3 softclip); a dynamic tone curve always comes with the peak partials
TONES = (None,) + ops_tone.DYNAMIC_TONE_FUNCTIONS
GAMUTS = ("pass", "clamp", "perceptual", "softclip")
# the (tone, gamut) instances built, each with and without dither: the
# chains color_map_stage can run with detected stats or none
INSTANCES = tuple([(0, 0), (0, 2), (0, 3)] +
                  [(t, g) for t in range(1, len(TONES)) for g in (1, 2, 3)])
# a chain's runtime flags, which travel in bits 16.. of the kernel's
# matrix-swap word
FLAG_PASS_MATRIX, FLAG_PASS_CLAMP, FLAG_HUESHIFT = 1, 2, 4
FLAG_SHIFT = 16
# (tone, gamut, flags) of the flagship chain: spline + perceptual
FLAGSHIP = (1, 2, 0)

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
    # appended for the chains beyond the flagship's (its offsets stay)
    ("desat", 1), ("one_m_desat", 1), ("hue_coefs", _NFOURIER),
    ("src_peak_c", _NFOURIER), ("dst_peak_c", _NFOURIER),
    ("pass_mat", 9), ("pass_lo", 1), ("pass_hi", 1),
    ("pq_inv_m2", 1), ("pq_inv_m1", 1), ("pq_m1", 1), ("pq_m2", 1),
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

# FP32 operations per pixel of each part of a chain, counted from
# csrc/color_map.cu (each add, multiply, divide, sqrt, exp, log, min,
# max, compare, select or floor counts 1, a fused multiply-add 2): the
# peak partials 61; RGB->ICh 190 (three pow-free PQ curves at 49 each);
# the tone curve (spline 12, bt2390 41, st2094-40 89 and st2094-10 44,
# the last two with two exact PQ curves at 16 and 15) and the cubic-hull
# chroma adjustment 14; the Fourier basis and intensity powers 55; the
# chroma soft-clip (perceptual 44 with its strength blend, softclip 46
# with its desaturated target, or 217 with the hue shift: the shift's
# series 33, its weight 13, cos and sin, the turned basis 48, margin 3,
# both peak series 68, the chroma target 4 and the soft-clip 42, plus
# each kept fit row and floor a second time); ICh->RGB 179; the RGB
# soft-clip 69 (its per-pixel terms from the largest channel 27 and 3,
# then 13 a channel) or the clamp 9; and the output, 12 a channel
# (delinearize, sRGB).  The pass-through chain mixes 15 and clamps 6.
_OPS_PEAK, _OPS_TO_ICH, _OPS_HULL, _OPS_BASIS = 61, 190, 14, 55
_OPS_TONE = {"spline": 12, "bt2390": 41, "st2094-40": 89, "st2094-10": 44}
_OPS_CHROMA = {"perceptual": 44, "softclip": 46}
_OPS_HUE = 217
_OPS_TO_RGB, _OPS_RGB_CLIP, _OPS_CLAMP, _OPS_OUT = 179, 69, 9, 36
_OPS_PASS_MIX, _OPS_PASS_CLAMP = 15, 6
_OPS_ROW0 = 13          # a fit's constant row: 1 multiply + 6 FMAs
_OPS_ROW = 15           # any other kept row, then times its basis term
_OPS_FLOOR = 1          # a fit's floor at 1e-5
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
    bit 3 m + i of `mat_swap`: row i of matrix m of `_MATRICES` (and,
    m = 4, of the pass-through chain's matrix) fuses its second product
    first (w0 == 1, or w0 < 0 < w1 != 1) — the rounding of
    core/fastmath.py::mix."""
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
    m = np.concatenate([_matrix(consts, name)
                        for name in _MATRICES + ("pass_mat",)])
    return RowMasks(_bits((src != 0).any(axis=1)),
                    _bits((dst != 0).any(axis=1)),
                    _bits((src[:, 0] < 0) & (src[:, 1] > 0)),
                    _bits((dst[:, 0] < 0) & (dst[:, 1] > 0)),
                    _bits((m[:, 0] == 1) | ((m[:, 0] < 0) & (m[:, 1] > 0)
                                            & (m[:, 1] != 1))))


@dataclass(frozen=True)
class TailPlan:
    """Host plan of one K1 chain: the packed constants (kept as a
    read-only copy), the dither LUT (None = no dither), the kernel
    instance (`tone` index into TONES, `gamut` into GAMUTS), its runtime
    `flags` (FLAG_*), and the row masks, always derived from those
    constants."""
    consts: np.ndarray
    lut: Optional[np.ndarray] = None
    tone: int = 1
    gamut: int = 2
    flags: int = 0
    rows: RowMasks = field(init=False)

    def __post_init__(self):
        if (self.tone, self.gamut) not in INSTANCES:
            raise ValueError(f"K1 has no instance for tone {self.tone}, "
                             f"gamut {self.gamut}")
        consts = np.array(self.consts, np.float32)
        consts.setflags(write=False)
        object.__setattr__(self, "consts", consts)
        object.__setattr__(self, "rows", row_masks(consts))

    @property
    def instance(self):
        """(tone, gamut, flags): what the plain version and the
        operation count need beside the constants."""
        return (self.tone, self.gamut, self.flags)


def _fit_or_zeros(b: GamutBoundary) -> np.ndarray:
    return boundary_rows(b) if b.coefs is not None else \
        np.zeros((_NFOURIER, POLY_DEG + 1), np.float32)


def pack_constants(b_src: GamutBoundary, b_dst: GamutBoundary,
                   dst_min_pq: float, dst_max_pq: float, gamut_constants,
                   dst_color, bit_depth: int, black_cutoff: float,
                   hue_coefs=None, pass_matrix=None, pass_clamp=None
                   ) -> np.ndarray:
    """Every static constant of the chain, derived in float64 exactly as
    the reference's stage functions derive them, then rounded once to
    float32 in LAYOUT order (what a chain does not read is zero, or the
    identity for the pass-through matrix)."""
    c = gamut_constants.fixed()
    j = c.softclip_knee
    to_norm = COLOR_SDR_WHITE / 10000.0
    lo, hi = nominal_luma_norm(dst_color)
    scaled = hi != 1.0 or lo != 0.0
    scale = float((1 << bit_depth) - 1) if bit_depth else 0.0
    rgb_safe = max(b_dst.max_rgb, 1e-9)
    zeros = np.zeros(_NFOURIER)
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
        src_coefs=_fit_or_zeros(b_src).ravel(),
        dst_coefs=_fit_or_zeros(b_dst).ravel(),
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
        black_cutoff=black_cutoff / 100.0,
        desat=c.softclip_desat, one_m_desat=1.0 - c.softclip_desat,
        hue_coefs=hue_coefs if hue_coefs is not None else zeros,
        src_peak_c=b_src.peak_c if b_src.peak_c is not None else zeros,
        dst_peak_c=b_dst.peak_c if b_dst.peak_c is not None else zeros,
        pass_mat=np.ravel(pass_matrix) if pass_matrix is not None
        else np.ravel(np.eye(3)),
        pass_lo=pass_clamp[0] if pass_clamp else 0.0,
        pass_hi=pass_clamp[1] if pass_clamp else 0.0,
        pq_inv_m2=1.0 / tf.PQ_M2, pq_inv_m1=1.0 / tf.PQ_M1,
        pq_m1=tf.PQ_M1, pq_m2=tf.PQ_M2)
    out = np.zeros(NCONST, np.float32)
    for name, n in LAYOUT:
        v = np.asarray(vals[name], np.float64).ravel()
        assert v.size == n, (name, v.size, n)
        out[_OFF[name]:_OFF[name] + n] = v.astype(np.float32)
    return out


def _mix_ok(m) -> bool:
    """The kernel mixes a matrix row as three products (`mix` skips a
    zero weight, which no pair of real primaries gives)."""
    return not (np.asarray(m, np.float32) == 0).any()


def plan_tail(chain, params, dst_color, target, fused_peak: bool,
              dither_lut) -> Optional[TailPlan]:
    """The K1 plan for this tail (`chain`: the renderer's ColorChain),
    or None when no built instance implements it.  Admitted: the
    pass-through chain, or the IPT round trip with no tone curve or a
    dynamic one whose stats are measured in the same pass
    (allow_delayed: the peak partials), and the gamut operator clip /
    saturation / none (clamp), perceptual or softclip between two
    boundaries fitted over one luma range; an sRGB target with an
    identity encode; an ordered dither or none (`dither_lut`, the square
    LUT, or None)."""
    if dst_color.transfer != ColorTransfer.SRGB or params.show_clipping:
        return None
    enc, _ = color_repr_decode(target.repr)
    if not (np.array_equal(enc.mat.m, np.eye(3)) and not enc.c.any()):
        return None
    bit_depth = target.bit_depth if dither_lut is not None else 0
    black_cutoff = params.peak_detect.black_cutoff \
        if params.peak_detect is not None else 0.0
    if chain.kind == "pass":
        flags = 0
        matrix = chain.matrix
        if matrix is not None and not np.array_equal(matrix, np.eye(3)):
            if not _mix_ok(matrix):
                return None
            flags |= FLAG_PASS_MATRIX
        if chain.clamp is not None:
            flags |= FLAG_PASS_CLAMP
        from ..gamut import ipt_space
        from ...core.colorspace import primaries_get
        b = ipt_space(primaries_get(dst_color.primaries), chain.dst_min_pq,
                      chain.dst_max_pq)
        consts = pack_constants(b, b, chain.dst_min_pq, chain.dst_max_pq,
                                params.gamut_constants, dst_color,
                                bit_depth, black_cutoff,
                                pass_matrix=matrix, pass_clamp=chain.clamp)
        return TailPlan(consts, dither_lut, tone=0, gamut=0, flags=flags)
    if chain.tone == "static" or (chain.tone == "dynamic" and
                                  not fused_peak):
        return None
    tone = TONES.index(params.tone_mapping_function) \
        if chain.tone == "dynamic" else 0
    gamut = {None: 1, "clip": 1, "saturation": 1, "perceptual": 2,
             "softclip": 3}.get(chain.gamut)
    if gamut is None or (tone, gamut) not in INSTANCES:
        return None
    b_src, b_dst = chain.b_src, chain.b_dst
    flags, hue = 0, None
    if gamut >= 2:
        if b_src.coefs is None or b_dst.coefs is None or \
                (b_src.min_luma, b_src.max_luma) != \
                (b_dst.min_luma, b_dst.max_luma):
            return None
        for b in (b_src, b_dst):
            # the kernel sums a kept row as a plain multiply-add chain,
            # which is `mix` only when no coefficient of it is 0 or 1
            rows = boundary_rows(b)
            if not all((r == 0).all() or ((r != 0) & (r != 1)).all()
                       for r in rows):
                return None
        if gamut == 3:
            hue = hueshift_fourier(b_src, b_dst)
            if hue is not None:
                flags |= FLAG_HUESHIFT
    consts = pack_constants(b_src, b_dst, chain.dst_min_pq,
                            chain.dst_max_pq, params.gamut_constants,
                            dst_color, bit_depth, black_cutoff,
                            hue_coefs=hue)
    if not all(_mix_ok(_matrix(consts, name)) for name in _MATRICES):
        return None
    return TailPlan(consts, dither_lut, tone=tone, gamut=gamut, flags=flags)


def ops_per_pixel(consts, instance=FLAGSHIP) -> int:
    """FP32 operations the kernel runs per pixel for these packed
    constants and instance (TailPlan.instance): the parts of its chain,
    every boundary-fit row that `boundary_rows` kept (the kernel skips
    an all-zero, pruned row; softclip's hue shift evaluates both fits
    twice), and the dither where the plan dithers (a nonzero dither
    scale)."""
    c = np.asarray(consts)
    tone, gamut, flags = instance
    ops = _OPS_OUT
    if gamut == 0:
        ops += _OPS_PASS_MIX * bool(flags & FLAG_PASS_MATRIX) + \
            _OPS_PASS_CLAMP * bool(flags & FLAG_PASS_CLAMP)
    else:
        ops += _OPS_TO_ICH + _OPS_TO_RGB
        if tone:
            ops += _OPS_PEAK + _OPS_HULL + _OPS_TONE[TONES[tone]]
        if gamut == 1:
            ops += _OPS_CLAMP
        else:
            fits = 2 if flags & FLAG_HUESHIFT else 1
            ops += _OPS_BASIS + _OPS_RGB_CLIP
            ops += _OPS_HUE if fits == 2 else _OPS_CHROMA[GAMUTS[gamut]]
            for kept in row_masks(c)[:2]:
                ops += fits * (_OPS_ROW0 * (kept & 1) + _OPS_FLOOR +
                               _OPS_ROW * bin(kept >> 1).count("1"))
    if c[_OFF["dither_scale"]] != 0:
        ops += _OPS_DITHER
    return ops


# ---------------------------------------------------------------------------
# The plain version: the kernel's arithmetic in PyTorch
# ---------------------------------------------------------------------------

def _unpack(consts) -> Dict[str, object]:
    vals = np.asarray(consts, np.float32).tolist()
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


def _fourier(coefs, cs, sn):
    """A Fourier series on the basis: the constant, then one fused
    multiply-add a term (ops/gamut.py::_fourier_eval)."""
    out = torch.full_like(cs[0], coefs[0])
    for k in range(1, HARMONICS + 1):
        out = fma(cs[k - 1], coefs[2 * k - 1], out)
        out = fma(sn[k - 1], coefs[2 * k], out)
    return out


def _basis(cos_h, sin_h):
    cs, sn = [cos_h], [sin_h]
    for _ in range(1, HARMONICS):
        cs.append(fma(cs[-1], cos_h, -(sn[-1] * sin_h)))
        sn.append(fma(sn[-1], cos_h, cs[-2] * sin_h))
    return cs, sn


def _softclip_chroma(k, C, cos_h, sin_h, pw, flags):
    """softclip's chroma map (ops/gamut.py): toward the desaturated dst
    boundary, or with the hue shift toward the turned hue's peaks.
    Returns (C_new, cos h', sin h')."""
    cs, sn = _basis(cos_h, sin_h)
    c_src = _boundary(k["src_coefs"], cs, sn, pw)
    c_dst = _boundary(k["dst_coefs"], cs, sn, pw)
    if not flags & FLAG_HUESHIFT:
        target = fma(c_dst, k["one_m_desat"],
                     torch.minimum(c_dst, C) * k["desat"])
        return (_softclip(k, C, torch.maximum(c_src, c_dst), target),
                cos_h, sin_h)
    delta = _fourier(k["hue_coefs"], cs, sn)
    t = torch.clamp(fma(c_dst, -k["knee"], C) / torch.clamp_min(
        fma(c_dst, -k["knee"], c_src), 1e-9), 0.0, 1.0)
    delta = delta * (t * t * fma(t, -2.0, 3.0))
    cosd, sind = torch.cos(delta), torch.sin(delta)
    ch2 = fma(cos_h, cosd, -(sin_h * sind))
    sh2 = fma(sin_h, cosd, cos_h * sind)
    cs, sn = _basis(ch2, sh2)
    c_src2 = _boundary(k["src_coefs"], cs, sn, pw)
    margin = torch.clamp_min(c_src / torch.clamp_min(c_src2, 1e-9), 1.0)
    c_dst2 = _boundary(k["dst_coefs"], cs, sn, pw)
    source_c = torch.clamp_min(_fourier(k["src_peak_c"], cs, sn), 1e-5)
    target_c = torch.clamp_min(_fourier(k["dst_peak_c"], cs, sn), 1e-5)
    border_c = torch.minimum(c_dst2, target_c)
    chroma = fma(border_c - target_c, k["desat"], target_c)
    return (_softclip(k, C, torch.maximum(margin * source_c, chroma),
                      chroma), ch2, sh2)


def color_map_plain(img, consts, tone, lut=None, instance=FLAGSHIP):
    """The kernel's function in plain PyTorch, on any device: (3, H, W)
    linear light in -> ((3, H, W) dithered signal, (G, 8, 128) peak
    partials, or None for a chain without a tone curve).  `tone` is the
    per-frame tone vector (None without a tone curve), `instance` the
    plan's (tone, gamut, flags)."""
    k = _unpack(consts)
    tone_i, gamut, flags = instance
    H, W = img.shape[-2], img.shape[-1]
    r, g, b = img[0], img[1], img[2]
    partials = None

    if gamut == 0:
        # the pass-through fast path: a primaries matrix, a clamp
        rgb = [r, g, b]
        if flags & FLAG_PASS_MATRIX:
            rgb = _mat3(k["pass_mat"], rgb)
        if flags & FLAG_PASS_CLAMP:
            rgb = [torch.clamp(v, k["pass_lo"], k["pass_hi"]) for v in rgb]
        lin = rgb
    else:
        if tone_i:
            maxrgb = torch.clamp_min(torch.maximum(torch.maximum(r, g), b),
                                     0.0)
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

        if tone_i:
            i_orig = I
            if TONES[tone_i] == "spline":
                src_max, src_pivot, dst_pivot, Pa, Pb, Qa, Qb, Qc = \
                    tone[:8].tolist()
                xs = torch.clamp(torch.clamp_min(I, 0.0), max=src_max) - \
                    src_pivot
                yv = torch.where(
                    xs > 0, fma(fma(fma(xs, Qa, Qb), xs, Qc), xs, dst_pivot),
                    fma(fma(xs, Pa, Pb), xs, dst_pivot))
                I = torch.clamp(yv, k["dst_min_pq"], k["dst_max_pq"])
            else:
                # the scalars as 0-dim tensors: PyTorch's CUDA divide by a
                # host float multiplies by its reciprocal instead
                name = TONES[tone_i]
                I = ops_tone.tone_apply(
                    name, I, list(tone[:len(ops_tone.TONE_KEYS[name])]),
                    k["dst_min_pq"], k["dst_max_pq"])
            hull_new = fma(I - 6.0, I, 9.0) * I
            hull_old = fma(i_orig - 6.0, i_orig, 9.0) * i_orig
            C = C * torch.minimum(i_orig / torch.clamp_min(I, 1e-6),
                                  hull_new / torch.clamp_min(hull_old, 1e-6))

        if gamut >= 2:
            i_rel = torch.clamp((I - k["luma_min"]) * k["luma_rcp"], 0.0,
                                1.0)
            pw = [sqrt(i_rel) * (1.0 - i_rel)]
            for _ in range(POLY_DEG):
                pw.append(pw[-1] * i_rel)
        if gamut == 2:
            cs, sn = _basis(cos_h, sin_h)
            c_src = _boundary(k["src_coefs"], cs, sn, pw)
            c_dst = _boundary(k["dst_coefs"], cs, sn, pw)
            c_new = _softclip(k, C, torch.maximum(c_src, c_dst), c_dst)
            c_new = fma(c_new - C, k["strength"], C)
        elif gamut == 3:
            c_new, cos_h, sin_h = _softclip_chroma(k, C, cos_h, sin_h, pw,
                                                   flags)
        else:
            c_new = C

        lmsp = _mat3(k["ipt2lms"], [I, c_new * cos_h, c_new * sin_h])
        rgb = _mat3(k["dst_lms2rgb"], [_pq_eotf(k, v) for v in lmsp])
        if gamut == 1:
            lin = [torch.clamp(v, k["dst_min_rgb"], k["dst_max_rgb"]) *
                   k["rcp_to_norm"] for v in rgb]
        else:
            src_c = torch.clamp_min(torch.maximum(
                torch.maximum(rgb[0], rgb[1]), rgb[2]), k["dst_max_rgb"])
            lin = [torch.clamp_min(_softclip(k, v, src_c),
                                   k["dst_min_rgb"]) * k["rcp_to_norm"]
                   for v in rgb]
    sg = k["srgb"]
    outs = []
    for v in lin:
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


def instance_name(tone: int, gamut: int, dither: bool) -> str:
    """The kernel instance's mangled-name stem (as cuobjdump prints
    it)."""
    return f"k1_color_mapILi{tone}ELi{gamut}ELb{int(dither)}EE"


def build_specs():
    """The kernel libraries' build specs (_build.build_all): one library
    a tone curve, holding that curve's (gamut, dither) instances, so the
    compilers run side by side."""
    from ..._build import nvcc_path
    tones = sorted({t for t, _ in INSTANCES})
    return [(f"k1_color_map_t{t}", ["csrc/color_map.cu"], nvcc_path(),
             kernel_flags() + [f"-DK1_TONE={t}"]) for t in tones]


@functools.lru_cache(maxsize=None)
def _kernel_lib(tone: int = 1):
    """The loaded, typed library of one tone curve's instances (built at
    first use; looked up once, since finding the compiler costs more
    than a launch)."""
    from ..._build import load_shared
    spec, = [sp for sp in build_specs() if sp[0].endswith(f"_t{tone}")]
    lib = load_shared(*spec)
    fn = lib.k1_color_map_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k1_sqrt_check_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k1_sqrt_check_launch.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib


def libraries():
    """Every K1 library, built and loaded: {tone index: library}."""
    from ..._build import build_all
    build_all(build_specs())
    return {t: _kernel_lib(t) for t in sorted({t for t, _ in INSTANCES})}


def build():
    """Compile (once) and load every K1 library; returns the flagship
    chain's (the spline's)."""
    return libraries()[1]


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


def color_map_tail(img, plan, tone, lut):
    """Run K1 on a (3, H, W) float32 frame of linear light.  `plan` is
    the chain's TailPlan (its packed constants in host memory, row masks
    and kernel instance), `tone` the per-frame tone vector
    (ops/tone_dynamic.py::tone_vector; None for a chain without a tone
    curve), `lut` the (n, n) dither LUT tensor (plan.lut on the frame's
    device) or None.  Returns (out, (H / block_rows, 8, 128) peak
    partials), the partials None without a tone curve."""
    global launches
    if not isinstance(plan, TailPlan) or plan.consts.shape != (NCONST,):
        raise ValueError(f"K1: plan must be a TailPlan of {NCONST} "
                         f"constants")
    if (tone is None) != (plan.tone == 0):
        raise ValueError("K1: a tone vector goes with a tone curve, and "
                         "only with one")
    consts = plan.consts
    if img.device.type == "cpu":
        return color_map_plain(img, consts, tone, lut, plan.instance)
    if img.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {img.device}")
    C, H, W = img.shape
    _check(img, "img", (3, H, W))
    if tone is not None:
        _check(tone, "tone", (ops_tone.TONE_VECTOR_LEN,))
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
    sub = partials = None
    if plan.tone:
        sub = torch.empty((stripes, W // _COLS, _SUB), dtype=torch.float32,
                          device=img.device)
        partials = torch.empty((stripes, 8, 128), dtype=torch.float32,
                               device=img.device)
    lib = _kernel_lib(plan.tone)
    rows = plan.rows
    rc = lib.k1_color_map_launch(
        img.data_ptr(), out.data_ptr(),
        sub.data_ptr() if sub is not None else None,
        partials.data_ptr() if partials is not None else None,
        consts.ctypes.data, tone.data_ptr() if tone is not None else None,
        lut.data_ptr() if lut is not None else None,
        n, H, W, bh, rows.src_kept, rows.dst_kept, rows.src_swap,
        rows.dst_swap, rows.mat_swap | (plan.flags << FLAG_SHIFT),
        plan.gamut, torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: " +
                           lib.k1_error_string(rc).decode())
    launches += 1
    return out, partials

"""K1 — the fused color-map tail — as a hand-written Hopper kernel, with
its plain PyTorch version beside it.

Replaces libplacebo_tpu/ops/pallas/color_map.py::fused_pointwise for
every tail `Renderer._fused_tail` admits.  The Pallas kernel traces
whatever tail it is given; a hand-written kernel cannot, so K1 comes in
two kinds:
- templated instances, a template over (tone, gamut operator, dither),
  for the chains of the main paths: `color_map_stage` (a dynamic tone
  curve — spline, bt2390, st2094-40, st2094-10 — measured in the same
  pass, or none, and the gamut operator clip, perceptual or softclip
  through one IPT round trip, or the pass-through fast path), sRGB
  delinearize, identity RGB encode, ordered dither, and with a tone
  curve the per-stripe peak partials (`plan_tail`, `INSTANCES`);
- one generic instance for every other tail (`plan_generic`): a static
  curve or a dynamic one with same-frame stats, all nine gamut
  operators, every target transfer, non-identity encodes, show_clipping
  and white-noise or low-depth gamma dither, its parts chosen by ids
  uniform across a launch (`GenericMode`).  Its plain version is the
  port's own stages (`GenericSpec.plain`, built by the renderer).

Everything static is planned on the host in float64 and packed once
into one float32 vector (`LAYOUT`), kept in host memory: each launch
copies it into the kernel's parameters, where the kernel reads every
coefficient at a compile-time offset, with no staging in shared memory.  The per-frame tone-curve
scalars form a second, 16-long vector on the device
(ops/tone_dynamic.py::tone_vector).  The templated instances
(csrc/color_map.cu) and their plain version (`color_map_plain`) both
read those two vectors, so they cannot compute their constants apart;
that plain version repeats the kernel's arithmetic operation for
operation.

`color_map_tail` is the entry: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (and counts the launch in `launches`)
or raises.  The kernels are built with nvcc at first use; see
csrc/color_map.cu for what bounds them on the card.
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
from ...core.dither import DitherMethod
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
    # appended for the generic instance (`plan_generic`)
    ("g_tone", 56), ("g_trc", 16), ("g_enc", 12), ("g_enc_pre", 9),
    ("g_clip", 4), ("dst_peak_i", 2 * HARMONICS + 1), ("g_gam", 4),
    ("g_abs", 9), ("g_dith", 1), ("dst_rgb2lms", 9), ("g_mix", 27),
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
    generic: Optional[GenericSpec] = None
    rows: RowMasks = field(init=False)

    def __post_init__(self):
        if self.tone == GENERIC:
            if self.generic is None or self.gamut != GENERIC:
                raise ValueError("K1's generic instance needs its "
                                 "GenericSpec")
        elif (self.tone, self.gamut) not in INSTANCES:
            raise ValueError(f"K1 has no instance for tone {self.tone}, "
                             f"gamut {self.gamut}")
        consts = np.array(self.consts, np.float32)
        consts.setflags(write=False)
        object.__setattr__(self, "consts", consts)
        object.__setattr__(self, "rows", row_masks(consts))

    @property
    def instance(self):
        """(tone, gamut, flags): what the plain version and the
        operation count need beside the constants (the generic
        instance's flags are its GenericMode)."""
        if self.tone == GENERIC:
            return (GENERIC, GENERIC, self.generic.mode)
        return (self.tone, self.gamut, self.flags)


def _fit_or_zeros(b: GamutBoundary) -> np.ndarray:
    return boundary_rows(b) if b.coefs is not None else \
        np.zeros((_NFOURIER, POLY_DEG + 1), np.float32)


def pack_constants(b_src: GamutBoundary, b_dst: GamutBoundary,
                   dst_min_pq: float, dst_max_pq: float, gamut_constants,
                   dst_color, bit_depth: int, black_cutoff: float,
                   hue_coefs=None, pass_matrix=None, pass_clamp=None,
                   extra=None) -> np.ndarray:
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
    vals.update(extra or {})
    out = np.zeros(NCONST, np.float32)
    for name, n in LAYOUT:
        if name not in vals:
            continue        # a generic constant this chain does not read
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


# ---------------------------------------------------------------------------
# The generic instance: every other tail the reference's kernel runs
# ---------------------------------------------------------------------------
#
# One more kernel (csrc/color_map.cu, built with -DK1_TONE=-1) takes the
# chain's parts as ids that are uniform across a launch: the static tone
# curve or a dynamic one (its stats measured in the same pass or the
# frame before), every gamut operator, every target transfer, the encode
# (a matrix, or the non-linear systems), show_clipping, and an ordered,
# white-noise or low-depth gamma dither.  Its plain version is the
# port's own stages (`GenericSpec.plain`, built by the renderer); the
# kernel repeats their arithmetic as PyTorch runs it on the card.

GENERIC = -1
# ids shared with csrc/color_map.cu (passed as -DK1G_* macros)
G_GAMUTS = ("clamp", "perceptual", "softclip", "relative", "desaturate",
            "linear", "darken", "absolute", "highlight")
G_STATIC = ("clip", "st2094-40", "st2094-10", "bt2390", "bt2446a",
            "spline", "reinhard", "mobius", "hable", "gamma", "linear",
            "bt2446a_inv")
G_SCALINGS = ("norm", "pq", "nits")
G_TRCS = ("linear", "bt1886", "pq", "hlg", "scrgb", "srgb", "gamma",
          "prophoto", "st428", "vlog", "slog1", "slog2")
G_ENCODES = ("none", "matrix", "ictcp_pq", "ictcp_hlg", "xyz", "bt2020c")
G_DITHER = ("none", "lut", "table")


class GenericMode(NamedTuple):
    """The generic instance's launch-uniform ids (csrc: K1Mode)."""
    kind: int = 1          # 0 the pass-through chain, 1 the IPT round trip
    gamut: int = 0         # G_GAMUTS
    tone_kind: int = 0     # 0 none, 1 dynamic (TONES), 2 static (G_STATIC)
    curve: int = 0
    scaling: int = 1       # the static curve's native scaling (G_SCALINGS)
    flags: int = 0         # FLAG_* (pass matrix / clamp, hue shift) and
    #                        GFLAG_* below
    trc: int = 0           # G_TRCS
    encode: int = 0        # G_ENCODES
    dither: int = 0        # G_DITHER


# generic flags, beside FLAG_PASS_MATRIX / FLAG_PASS_CLAMP / FLAG_HUESHIFT
GFLAG_SHOW_CLIP, GFLAG_PEAK, GFLAG_DITHER_GAMMA = 8, 16, 32


@dataclass(frozen=True)
class GenericSpec:
    """The generic instance's plan beyond its constants: the ids, the
    dynamic curve's name (the tone vector's), and the plain version
    plain(img, tone, bias) -> (out, partials or None)."""
    mode: GenericMode
    dynamic: Optional[str] = None
    plain: Optional[object] = field(default=None, compare=False)


def _g_trc(dst_color):
    """(G_TRCS id, its constants) of the target transfer, as
    ops/color.py::delinearize reads them."""
    from ..color import hlg_constants
    trc = dst_color.infer().transfer
    lo, hi = nominal_luma_norm(dst_color)
    c = np.zeros(16)
    T = ColorTransfer
    exempt = (T.PQ, T.HLG, T.SCRGB, T.BT_1886, T.V_LOG, T.S_LOG1, T.S_LOG2)
    if trc not in exempt and (hi != 1.0 or lo != 0.0):
        c[0], c[1], c[2] = 1.0, lo, rcp(hi - lo)
    gammas = {T.GAMMA18: 1.8, T.GAMMA20: 2.0, T.GAMMA22: 2.2,
              T.GAMMA24: 2.4, T.GAMMA26: 2.6, T.GAMMA28: 2.8}
    if trc in (T.LINEAR, T.UNKNOWN):
        name = "linear"
    elif trc == T.BT_1886:
        lb, lw = lo ** (1 / 2.4), hi ** (1 / 2.4)
        name = "bt1886"
        c[3], c[4], c[5] = rcp((lw - lb) ** 2.4), 1 / 2.4, lb / (lw - lb)
    elif trc == T.PQ:
        name = "pq"
        c[3] = COLOR_SDR_WHITE / 10000.0
    elif trc == T.HLG:
        y, b, lw = hlg_constants(dst_color)
        name = "hlg"
        c[3], c[4], c[5], c[6] = rcp(hi), lw[0], lw[1], lw[2]
        c[7], c[8], c[9] = (1 - y) / y, b, rcp(1 - b)
    elif trc == T.SCRGB:
        name = "scrgb"
        c[3] = rcp(80.0 / COLOR_SDR_WHITE)
    elif trc == T.SRGB:
        name = "srgb"
    elif trc in gammas:
        name = "gamma"
        c[3] = 1.0 / gammas[trc]
    elif trc == T.PRO_PHOTO:
        name = "prophoto"
        c[3] = 1.0 / 1.8
    elif trc == T.ST428:
        name = "st428"
        c[3], c[4] = rcp(tf.ST428_SCALE), 1 / 2.6
    else:
        name = {T.V_LOG: "vlog", T.S_LOG1: "slog1", T.S_LOG2: "slog2"}[trc]
        c[3] = rcp(tf.LOG10)
        c[4], c[5], c[6] = tf.VLOG_B, tf.VLOG_C, tf.VLOG_D
        c[7], c[8] = rcp(219.0), tf._SLOG2_SLOPE
        c[9] = tf._SLOG2_LO
    return G_TRCS.index(name), c


def _g_encode(repr, prim):
    """(G_ENCODES id, the 3x4 [matrix | offset], the pre-matrix) of
    ops/color.py::encode_color."""
    from ...core.colorspace import (ColorSystem, ictcp_matrices,
                                    primaries_get, rgb_to_xyz_matrix)
    tr, _ = color_repr_decode(repr)
    inv = tr.invert()
    enc = np.concatenate([np.ravel(inv.mat.m), np.ravel(inv.c)])
    pre = np.ravel(np.eye(3))
    sys = repr.sys
    if sys in (ColorSystem.BT_2100_PQ, ColorSystem.BT_2100_HLG):
        pre = np.ravel(ictcp_matrices(sys)[0])
        name = "ictcp_pq" if sys == ColorSystem.BT_2100_PQ else "ictcp_hlg"
    elif sys == ColorSystem.XYZ:
        pre = np.ravel(rgb_to_xyz_matrix(primaries_get(prim)).m)
        name = "xyz"
    elif sys == ColorSystem.BT_2020_C:
        name = "bt2020c"
    elif np.array_equal(inv.mat.m, np.eye(3)) and not inv.c.any():
        name = "none"
    else:
        name = "matrix"
    return G_ENCODES.index(name), enc, pre


def _mix_code(row, bias: float = 0.0) -> int:
    """How core/fastmath.py::mix sums one matrix row (ops/color.py::
    mat_pointwise skips its zero weights), decided on the float64
    weights: bit k a nonzero weight, bit 3 + k a weight of 1, bit 6 the
    first pair's swapped fusing order (its pending weight < 0 < the
    next, which is not 1), bit 7 a nonzero bias."""
    row = [float(w) for w in np.ravel(row)]
    ks = [k for k, w in enumerate(row) if w != 0.0]
    swap = len(ks) >= 2 and row[ks[0]] != 1.0 and row[ks[1]] != 1.0 and \
        row[ks[0]] < 0.0 < row[ks[1]]
    return (sum(1 << k for k in ks) +
            sum(1 << (3 + k) for k, w in enumerate(row) if w == 1.0) +
            (int(swap) << 6) + (int(float(bias) != 0.0) << 7))


def _mix_codes(*mats_biases) -> list:
    """The mix codes of every row of the given (matrix, bias) pairs."""
    out = []
    for m, b in mats_biases:
        m = np.asarray(m, np.float64).reshape(3, 3)
        b = np.zeros(3) if b is None else np.ravel(b)
        out += [_mix_code(m[i], b[i]) for i in range(3)]
    return out


def _trcp(c: float) -> float:
    """What PyTorch's CUDA `x / c` multiplies by for a host float c: the
    float64 reciprocal rounded to float32 (not core/fastmath.py::rcp,
    the float32 reciprocal of float32(c), which the port's own stages
    write out).  The static curves' shared numpy/PyTorch code divides by
    host floats."""
    return float(np.float32(1.0 / c))


def _bt1886_pair(lo, hi):
    """(lb, lw - lb) of the static curves' BT.1886 helpers."""
    lb, lw = lo ** (1 / 2.4), hi ** (1 / 2.4)
    return lb, lw - lb


def _g_static_tone(tp):
    """(G_STATIC id, G_SCALINGS id, the 56 constants) of the static curve
    core/tone_mapping.py::apply_device evaluates for `tp`: the input
    clamp, the native scaling, the curve's host constants (its
    `_*_consts`), the output clamp."""
    from ...core import tone_mapping as tm
    fixed = tm._fix_params(tp)
    fun = fixed.function
    inverse = fixed.output_max > fixed.input_max + 1e-4
    name = fun.name
    if name == "linearlight":
        name = "linear"
    if inverse and name == "bt2446a":
        name = "bt2446a_inv"
    c = [tp.input_min, tp.input_max, fixed.output_min, fixed.output_max,
         rcp(COLOR_SDR_WHITE), rcp(10000.0)]
    lo_i, hi_i = fixed.input_min, fixed.input_max
    lo_o, hi_o = fixed.output_min, fixed.output_max
    if name == "st2094-40":
        from math import comb
        Kx, Ky, P = tm._st2094_40_knots(fixed)
        N = len(P) - 1
        lb, span = _bt1886_pair(lo_i, hi_i)
        lbo, spano = _bt1886_pair(lo_o, hi_o)
        c += [lb, _trcp(span), Kx, _trcp(max(1 - Kx, 1e-9)), Ky, 1 - Ky,
              Ky / Kx if Kx else 0.0, 1.0 if Kx > 0 else 0.0, spano, lbo, N]
        c += [comb(N, i) for i in range(17)][:N + 1] + [0.0] * (16 - N)
        c += [float(v) for v in P] + [0.0] * (16 - N)
    elif name == "st2094-10":
        c += list(tm._st2094_10_coefs(fixed))
    elif name == "bt2390":
        minLum, maxLum, ks, bp, gain = tm._bt2390_consts(fixed)
        c += [lo_i, _trcp(hi_i - lo_i), ks, _trcp(1 - ks), maxLum, minLum, bp,
              gain, hi_i - lo_i, 1.0 if ks < 1 else 0.0, 1 - ks]
    elif name == "bt2446a":
        phdr, psdr = tm._bt2446a_consts(fixed)
        lbo, spano = _bt1886_pair(lo_o, hi_o)
        c += [lo_i, _trcp(hi_i - lo_i), phdr - 1, _trcp(np.log(phdr)), psdr,
              _trcp(psdr - 1), spano, lbo]
    elif name == "bt2446a_inv":
        lb, span = _bt1886_pair(lo_i, hi_i)
        c += [lb, _trcp(span), hi_o - lo_o, lo_o, _trcp(1000.0)]
    elif name == "spline":
        c += list(tm._spline_consts(fixed))
    elif name == "reinhard":
        offset, scale = tm._reinhard_consts(fixed)
        c += [lo_i, _trcp(hi_o - lo_o), offset, scale, hi_o - lo_o, lo_o]
    elif name == "mobius":
        j, a, b, scale = tm._mobius_consts(fixed)
        c += [lo_i, _trcp(hi_o - lo_o), j, a, b, scale, hi_o - lo_o, lo_o]
    elif name == "hable":
        peak, scale = tm._hable_consts(fixed)
        lb, span = _bt1886_pair(lo_i, hi_i)
        lbo, spano = _bt1886_pair(lo_o, hi_o)
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        c += [lb, _trcp(span), _bt1886_pair(0.0, peak)[1], scale, A, C * B,
              D * E, B, D * F, E / F, spano, lbo]
    elif name == "gamma":
        peak, cutoff, gamma = tm._gamma_consts(fixed)
        c += [lo_i, _trcp(hi_o - lo_o), cutoff, _trcp(peak), gamma,
              hi_o - lo_o, lo_o]
    elif name == "linear":
        c += [lo_i, _trcp(hi_i - lo_i), fixed.constants.exposure,
              hi_o - lo_o, lo_o]
    c += [0.0] * (56 - len(c))
    return (G_STATIC.index(name), G_SCALINGS.index(fun.scaling.value), c)


def plan_generic(chain, params, src_color, dst_color, target,
                 fused_peak: bool, dither, plain, static_tone=None,
                 show_bounds=None) -> Optional[TailPlan]:
    """The generic instance's plan for a tail no templated instance runs:
    `dither` is None or (DitherParams, bias, low-depth gamma path) with
    the bias a square LUT (ordered) or the (H, W) frame (white noise);
    `static_tone` the static curve's ToneMapParams; `show_bounds` the
    (hi_lin + eps, in_max_pq + eps, lo_lin - eps, in_min_pq - eps)
    thresholds of show_clipping; `plain` the stages' closure.  None
    where a boundary fit has a row the kernel cannot sum like `mix` (a
    coefficient of exactly 0 or 1 in a kept row), or the luma ranges of
    the two fits differ."""
    from ...core.colorspace import adapt_white_matrix
    from ..dithering import _APPROX_GAMMA
    bit_depth = target.bit_depth if dither is not None else 0
    black_cutoff = params.peak_detect.black_cutoff \
        if params.peak_detect is not None else 0.0
    gc = params.gamut_constants.fixed()
    trc, trc_c = _g_trc(dst_color)
    enc, enc_m, enc_pre = _g_encode(target.repr, dst_color.primaries)
    dmode, dgamma = 0, 1.0
    flags = 0
    if dither is not None:
        dp, bias, gamma_path = dither
        dmode = 2 if dp.method == DitherMethod.WHITE_NOISE else 1
        if gamma_path:
            flags |= GFLAG_DITHER_GAMMA
            dgamma = _APPROX_GAMMA.get(dp.transfer, 1.0)
    extra = dict(g_trc=trc_c, g_enc=enc_m, g_enc_pre=enc_pre,
                 g_dith=dgamma)
    from ...core.colorspace import primaries_get
    if chain.kind == "pass":
        matrix = chain.matrix
        if matrix is not None and not np.array_equal(matrix, np.eye(3)):
            flags |= FLAG_PASS_MATRIX
        if chain.clamp is not None:
            flags |= FLAG_PASS_CLAMP
        from ..gamut import ipt_space
        b = ipt_space(primaries_get(dst_color.primaries), chain.dst_min_pq,
                      chain.dst_max_pq)
        extra["g_mix"] = _mix_codes(
            (matrix if matrix is not None else np.eye(3), None)) + \
            [0] * 15 + _mix_codes((enc_m[:9], enc_m[9:]), (enc_pre, None),
                                  (np.eye(3), None))
        consts = pack_constants(b, b, chain.dst_min_pq, chain.dst_max_pq,
                                params.gamut_constants, dst_color,
                                bit_depth, black_cutoff, pass_matrix=matrix,
                                pass_clamp=chain.clamp, extra=extra)
        mode = GenericMode(kind=0, flags=flags, trc=trc, encode=enc,
                           dither=dmode)
        return TailPlan(consts, dither[1] if dither else None, tone=GENERIC,
                        gamut=GENERIC, generic=GenericSpec(mode, None, plain))
    b_src, b_dst = chain.b_src, chain.b_dst
    gamut = G_GAMUTS.index(chain.gamut if chain.gamut not in
                           (None, "clip", "saturation") else "clamp")
    hue = None
    if b_dst.coefs is not None:
        if b_src.coefs is not None and (b_src.min_luma, b_src.max_luma) != \
                (b_dst.min_luma, b_dst.max_luma):
            return None
        for bb in (b_src, b_dst):
            if bb.coefs is None:
                continue
            rows = boundary_rows(bb)
            if not all((r == 0).all() or ((r != 0) & (r != 1)).all()
                       for r in rows):
                return None
        if chain.gamut == "softclip":
            hue = hueshift_fourier(b_src, b_dst)
            if hue is not None:
                flags |= FLAG_HUESHIFT
    tone_kind = curve = 0
    scaling = 1
    dynamic = None
    if chain.tone == "dynamic":
        tone_kind, dynamic = 1, params.tone_mapping_function
        curve = TONES.index(dynamic)
        if fused_peak:
            flags |= GFLAG_PEAK
    elif chain.tone == "static":
        tone_kind = 2
        curve, scaling, extra["g_tone"] = _g_static_tone(static_tone)
    if show_bounds is not None:
        flags |= GFLAG_SHOW_CLIP
        extra["g_clip"] = show_bounds
    if b_dst.peak_i is not None:
        extra["dst_peak_i"] = b_dst.peak_i
    gains = [gc.colorimetric_gamma, 1.0, 1.0, b_dst.max_luma]
    if chain.gamut == "linear":
        from ..gamut import _linear_gain
        gains[1] = _linear_gain(b_src, b_dst)
    elif chain.gamut == "darken":
        from ..gamut import _darken_gain
        gains[2] = _darken_gain(b_src, b_dst)
    extra["g_gam"] = gains
    if chain.gamut == "absolute" and b_src.prim is not None and \
            b_dst.prim is not None:
        extra["g_abs"] = np.ravel(np.asarray(adapt_white_matrix(
            b_dst.prim.white, b_src.prim.white).m, np.float32))
    else:
        extra["g_abs"] = np.ravel(np.eye(3))
    extra["dst_rgb2lms"] = np.ravel(b_dst.rgb2lms)
    extra["g_mix"] = _mix_codes(
        (np.eye(3), None), (b_src.rgb2lms, None), (LMS2IPT, None),
        (IPT2LMS, None), (b_dst.lms2rgb, None), (b_dst.rgb2lms, None),
        (enc_m[:9], enc_m[9:]), (enc_pre, None), (extra["g_abs"], None))
    consts = pack_constants(b_src, b_dst, chain.dst_min_pq, chain.dst_max_pq,
                            params.gamut_constants, dst_color, bit_depth,
                            black_cutoff, hue_coefs=hue, extra=extra)
    mode = GenericMode(kind=1, gamut=gamut, tone_kind=tone_kind, curve=curve,
                       scaling=scaling, flags=flags, trc=trc, encode=enc,
                       dither=dmode)
    return TailPlan(consts, dither[1] if dither else None, tone=GENERIC,
                    gamut=GENERIC, generic=GenericSpec(mode, dynamic, plain))


# FP32 operations a pixel of the generic instance's parts, counted from
# csrc/color_map.cu as above (a pow, exp, log or log1p counts 1): each
# static curve (st2094-40 adds 6 a Bernstein term), its conversions into
# and out of its scaling (an exact PQ curve 15), each gamut operator
# beyond the RGB -> ICh -> RGB round trip, each target transfer's
# delinearize (three channels), each encode, and the low-depth dither
_G_OPS_STATIC = {"clip": 0, "st2094-40": 26, "st2094-10": 5, "bt2390": 42,
                 "bt2446a": 25, "bt2446a_inv": 22, "spline": 12,
                 "reinhard": 7, "mobius": 10, "hable": 27, "gamma": 9,
                 "linear": 5}
_G_OPS_SCALING = {"norm": 2 + 17 + 19, "pq": 2, "nits": 2 + 16 + 18}
_G_OPS_GAMUT = {"relative": 55 + 64 + 20, "desaturate": 55 + 1,
                "linear": 1, "darken": 3,
                "absolute": 15 + 190 + 55 + 64 + 20, "highlight": 205 + 18}
_G_OPS_TRC = {"linear": 0, "bt1886": 24, "pq": 153, "hlg": 50, "scrgb": 3,
              "srgb": 36, "gamma": 15, "prophoto": 24, "st428": 18,
              "vlog": 24, "slog1": 21, "slog2": 27}
_G_OPS_ENC = {"none": 0, "matrix": 18, "ictcp_pq": 144, "ictcp_hlg": 66,
              "xyz": 66, "bt2020c": 50}
_G_OPS_SHOW_CLIP, _G_OPS_DITHER_GAMMA = 53, 3 * 14


def _generic_ops(consts, mode: GenericMode) -> int:
    """FP32 operations a pixel of the generic instance's chain (an
    estimate from the source's parts, as ops_per_pixel's)."""
    c = np.asarray(consts)
    ops = _G_OPS_TRC[G_TRCS[mode.trc]] + _G_OPS_ENC[G_ENCODES[mode.encode]]
    if mode.kind == 0:
        ops += _OPS_PASS_MIX * bool(mode.flags & FLAG_PASS_MATRIX) + \
            _OPS_PASS_CLAMP * bool(mode.flags & FLAG_PASS_CLAMP)
    else:
        ops += 3 + _OPS_TO_ICH + _OPS_TO_RGB
        if mode.flags & GFLAG_PEAK:
            ops += _OPS_PEAK
        if mode.tone_kind == 1:
            ops += _OPS_TONE[TONES[mode.curve]] + _OPS_HULL
        elif mode.tone_kind == 2:
            name = G_STATIC[mode.curve]
            ops += _OPS_HULL + _G_OPS_STATIC[name] + \
                _G_OPS_SCALING[G_SCALINGS[mode.scaling]]
            if name == "st2094-40":
                ops += 6 * (int(c[_OFF["g_tone"] + 16]) + 1)
        gamut = G_GAMUTS[mode.gamut]
        if gamut in ("perceptual", "softclip"):
            fits = 2 if mode.flags & FLAG_HUESHIFT else 1
            ops += _OPS_BASIS + _OPS_RGB_CLIP
            ops += _OPS_HUE if fits == 2 else _OPS_CHROMA[gamut]
            for kept in row_masks(c)[:2]:
                ops += fits * (_OPS_ROW0 * (kept & 1) + _OPS_FLOOR +
                               _OPS_ROW * bin(kept >> 1).count("1"))
        else:
            ops += _OPS_CLAMP + _G_OPS_GAMUT.get(gamut, 0)
            if gamut in ("relative", "desaturate", "absolute"):
                kept = row_masks(c).dst_kept
                ops += _OPS_ROW0 * (kept & 1) + _OPS_FLOOR + \
                    _OPS_ROW * bin(kept >> 1).count("1")
        if mode.flags & GFLAG_SHOW_CLIP:
            ops += _G_OPS_SHOW_CLIP
    if mode.dither:
        ops += _G_OPS_DITHER_GAMMA if mode.flags & GFLAG_DITHER_GAMMA \
            else _OPS_DITHER
    return ops


def ops_per_pixel(consts, instance=FLAGSHIP) -> int:
    """FP32 operations the kernel runs per pixel for these packed
    constants and instance (TailPlan.instance): the parts of its chain,
    every boundary-fit row that `boundary_rows` kept (the kernel skips
    an all-zero, pruned row; softclip's hue shift evaluates both fits
    twice), and the dither where the plan dithers (a nonzero dither
    scale)."""
    c = np.asarray(consts)
    tone, gamut, flags = instance
    if tone == GENERIC:
        return _generic_ops(c, flags)
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


def _partials(k, img):
    """The per-stripe peak partials of the linear input."""
    r, g, b = img[0], img[1], img[2]
    maxrgb = torch.clamp_min(torch.maximum(torch.maximum(r, g), b), 0.0)
    pq = torch.clamp(_pq_oetf(k, maxrgb * k["peak_norm"]), 0.0, 1.0)
    pq14 = torch.round(pq * 16383.0).to(torch.int32)
    active = pq > k["black_cutoff"]
    bins = torch.clamp((pq14 >> 7) - 64, 0, 63)
    return stripe_partials(pq, active, bins, pick_block_rows(img.shape[-2]))


def tail_plain(img, plan, tone, lut=None):
    """K1's plain version for any plan: (out, partials or None)."""
    if plan.tone == GENERIC:
        out = plan.generic.plain(img, tone, lut)
        partials = _partials(_unpack(plan.consts), img) \
            if plan.generic.mode.flags & GFLAG_PEAK else None
        return out, partials
    return color_map_plain(img, plan.consts, tone, lut, plan.instance)


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
            partials = _partials(k, img)

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
        [f"-DK1_OFF_{name}={off}" for name, off in _OFF.items()] + \
        [f"-DK1G_{prefix}_{name.upper().replace('-', '_')}={i}"
         for prefix, names in (("GAMUT", G_GAMUTS), ("STATIC", G_STATIC),
                               ("SCALING", G_SCALINGS), ("TRC", G_TRCS),
                               ("ENC", G_ENCODES), ("DITHER", G_DITHER))
         for i, name in enumerate(names)] + \
        [f"-DK1G_FLAG_{n}={v}" for n, v in (
            ("SHOW_CLIP", GFLAG_SHOW_CLIP), ("PEAK", GFLAG_PEAK),
            ("DITHER_GAMMA", GFLAG_DITHER_GAMMA))]


def instance_name(tone: int, gamut: int, dither: bool) -> str:
    """The kernel instance's mangled-name stem (as cuobjdump prints
    it)."""
    return f"k1_color_mapILi{tone}ELi{gamut}ELb{int(dither)}EE"


def build_specs():
    """The kernel libraries' build specs (_build.build_all): one library
    a tone curve, holding that curve's (gamut, dither) instances, so the
    compilers run side by side."""
    from ..._build import nvcc_path
    tones = sorted({t for t, _ in INSTANCES}) + [GENERIC]
    return [(f"k1_color_map_t{t}" if t >= 0 else "k1_color_map_generic",
             ["csrc/color_map.cu"], nvcc_path(),
             kernel_flags() + [f"-DK1_TONE={t}"]) for t in tones]


@functools.lru_cache(maxsize=None)
def _kernel_lib(tone: int = 1):
    """The loaded, typed library of one tone curve's instances (built at
    first use; looked up once, since finding the compiler costs more
    than a launch)."""
    from ..._build import load_shared
    suffix = f"_t{tone}" if tone >= 0 else "_generic"
    spec, = [sp for sp in build_specs() if sp[0].endswith(suffix)]
    lib = load_shared(*spec)
    if tone >= 0:
        fn = lib.k1_color_map_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
    else:
        fn = lib.k1_generic_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
            [ctypes.c_int] * len(GenericMode._fields) + [ctypes.c_void_p]
        st = lib.k1_static_tone_launch
        st.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        st.restype = ctypes.c_int
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
    return {t: _kernel_lib(t)
            for t in sorted({t for t, _ in INSTANCES}) + [GENERIC]}


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
    wants_tone = plan.generic.mode.tone_kind == 1 if plan.generic \
        else plan.tone != 0
    if (tone is None) == wants_tone:
        raise ValueError("K1: a tone vector goes with a dynamic tone "
                         "curve, and only with one")
    consts = plan.consts
    if img.device.type == "cpu":
        return tail_plain(img, plan, tone, lut)
    if img.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {img.device}")
    if plan.tone == GENERIC:
        return _launch_generic(img, plan, tone, lut)
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


def _launch_generic(img, plan, tone, bias):
    """Launch the generic instance (csrc: k1_generic_launch); `bias` is
    the square dither LUT, the (H, W) white-noise frame or None."""
    global launches
    C, H, W = img.shape
    _check(img, "img", (3, H, W))
    mode = plan.generic.mode
    if tone is not None:
        _check(tone, "tone", (ops_tone.TONE_VECTOR_LEN,))
    n = 0
    if mode.dither == 1:
        n = bias.shape[0]
        _check(bias, "lut", (n, n))
        if n & (n - 1):
            raise ValueError(f"K1: dither LUT size {n} is not a power of 2")
    elif mode.dither == 2:
        _check(bias, "bias", (H, W))
    elif bias is not None:
        raise ValueError("K1: a dither bias without a dither mode")
    bh = pick_block_rows(H)
    if H % bh or W % _COLS:
        raise ValueError(f"K1: a {H}x{W} frame does not split into "
                         f"{bh}-row stripes of {_COLS}-column blocks")
    stripes = H // bh
    out = torch.empty_like(img)
    sub = partials = None
    if mode.flags & GFLAG_PEAK:
        sub = torch.empty((stripes, W // _COLS, _SUB), dtype=torch.float32,
                          device=img.device)
        partials = torch.empty((stripes, 8, 128), dtype=torch.float32,
                               device=img.device)
    lib = _kernel_lib(GENERIC)
    rows = plan.rows
    rc = lib.k1_generic_launch(
        img.data_ptr(), out.data_ptr(),
        sub.data_ptr() if sub is not None else None,
        partials.data_ptr() if partials is not None else None,
        plan.consts.ctypes.data,
        tone.data_ptr() if tone is not None else None,
        bias.data_ptr() if bias is not None else None,
        n, H, W, bh, rows.src_kept, rows.dst_kept, rows.src_swap,
        rows.dst_swap, *mode, torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: " +
                           lib.k1_error_string(rc).decode())
    launches += 1
    return out, partials


def static_tone_on_card(x, plan):
    """The generic instance's static curve alone on a 1D CUDA tensor of
    PQ values (a test hook for `plan`'s static tone)."""
    mode = plan.generic.mode
    if mode.tone_kind != 2:
        raise ValueError("K1: the plan has no static tone curve")
    _check(x, "x")
    y = torch.empty_like(x)
    lib = _kernel_lib(GENERIC)
    rc = lib.k1_static_tone_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), plan.consts.ctypes.data,
        mode.curve, mode.scaling,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: " +
                           lib.k1_error_string(rc).decode())
    return y

"""K1 — the fused color-map tail — as one hand-written Hopper kernel,
compiled once for each tail it runs.

Replaces libplacebo_tpu/ops/pallas/color_map.py::fused_pointwise for
every tail `Renderer._fused_tail` admits.  The Pallas kernel traces
whatever tail it is given; the hand-written one is compiled for it
instead: `plan_generic` plans the tail on the host, and the tail's ids
(`GenericMode`), matrix-row mix codes, fit-row masks and switches become
a generated header (`generic_header`), so the instance a launch runs has
every launch-uniform choice made at compile time (`prepare`, called by
the renderer when it plans the tail; equal tails share a library).  A
tail is the pass-through chain or the IPT round trip of
`color_map_stage` — a dynamic tone curve (its stats measured in the
same pass, the peak partials, or the frame before), a static one or
none, and any gamut operator — then any target transfer, any encode,
show_clipping, and an ordered, white-noise or low-depth gamma dither.

Everything static is planned on the host in float64 and packed once
into one float32 vector (`LAYOUT`), kept in host memory: each launch
copies it into the kernel's parameters, where the kernel reads every
coefficient at a compile-time offset, with no staging in shared memory.
The per-frame tone-curve scalars form a second, 16-long vector on the
device (ops/cuda/peak_tone.py).  The plain version is the port's own
stages (`GenericSpec.plain`, built by the renderer): the kernel repeats
their arithmetic as PyTorch runs it on the card, bit for bit.

`color_map_tail` is the entry: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (and counts the launch in `launches`)
or raises.  See csrc/color_map.cu for what bounds it on the card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..._build import KernelError, kernel_work
from ...core import transfer as tf
from ...core.fastmath import f32_mul, rcp
from ...core.colorspace import (COLOR_SDR_WHITE, ColorTransfer,
                                color_repr_decode)
from ...core.dither import DitherMethod
from ...core.gamut_mapping import IPT2LMS, LMS2IPT
from .. import tone_dynamic as ops_tone
from ..color import nominal_luma_norm
from ..gamut import (GamutBoundary, boundary_rows, hueshift_fourier,
                     HARMONICS, POLY_DEG)
from ..peak_detect import stripe_partials

__all__ = ["LAYOUT", "TailPlan", "RowMasks", "pack_constants", "row_masks",
           "plan_generic", "color_map_tail", "tail_plain", "pick_block_rows",
           "launches", "ops_per_pixel", "sqrt_check", "build_specs",
           "libraries", "GenericMode", "GenericSpec", "GenericKey",
           "generic_key", "generic_header", "generic_spec", "prepare"]

_NCOEF = (2 * HARMONICS + 1) * (POLY_DEG + 1)
_NFOURIER = 2 * HARMONICS + 1

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
    ("dither_scale", 1), ("dither_rcp", 1),
    ("peak_norm", 1), ("black_cutoff", 1),
    ("desat", 1), ("one_m_desat", 1), ("hue_coefs", _NFOURIER),
    ("src_peak_c", _NFOURIER), ("dst_peak_c", _NFOURIER),
    ("pass_mat", 9), ("pass_lo", 1), ("pass_hi", 1),
    ("pq_inv_m2", 1), ("pq_inv_m1", 1), ("pq_m1", 1), ("pq_m2", 1),
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
# which may hold 4096 bytes; the rest of its list is 5 pointers and 4
# ints (csrc/color_map.cu checks the same with a static_assert).
PARAM_LIMIT = 4096
PARAM_BYTES = 4 * NCONST + 5 * 8 + 4 * 4
assert PARAM_BYTES <= PARAM_LIMIT, (PARAM_BYTES, PARAM_LIMIT)

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


class RowMasks(NamedTuple):
    """Bit r of `*_kept`: row r of that boundary fit has a nonzero
    coefficient (the kernel skips the others); bit r of `*_swap`: its
    first two products fuse in the other order (c[0] < 0 < c[1]), the
    rounding of core/fastmath.py::mix."""
    src_kept: int
    dst_kept: int
    src_swap: int
    dst_swap: int


def _fit_rows(consts, name):
    c = np.asarray(consts, np.float32)
    return c[_OFF[name]:_OFF[name] + _NCOEF].reshape(
        2 * HARMONICS + 1, POLY_DEG + 1)


def _bits(flags) -> int:
    return sum(1 << r for r, f in enumerate(flags) if f)


def row_masks(consts) -> RowMasks:
    """The kernel's RowMasks of the packed constants (host memory)."""
    src, dst = _fit_rows(consts, "src_coefs"), _fit_rows(consts, "dst_coefs")
    return RowMasks(_bits((src != 0).any(axis=1)),
                    _bits((dst != 0).any(axis=1)),
                    _bits((src[:, 0] < 0) & (src[:, 1] > 0)),
                    _bits((dst[:, 0] < 0) & (dst[:, 1] > 0)))


@dataclass(frozen=True)
class TailPlan:
    """Host plan of one K1 tail: the packed constants (kept as a
    read-only copy), its GenericSpec, the dither bias (the square LUT or
    the white-noise frame; None = no dither), and what is derived from
    them: the row masks and the header its instance is compiled with
    (`generic_header`)."""
    consts: np.ndarray
    generic: GenericSpec
    lut: Optional[np.ndarray] = None
    rows: RowMasks = field(init=False)
    header: str = field(init=False, compare=False)

    def __post_init__(self):
        if not isinstance(self.generic, GenericSpec):
            raise ValueError("K1: a plan needs its GenericSpec")
        consts = np.array(self.consts, np.float32)
        consts.setflags(write=False)
        object.__setattr__(self, "consts", consts)
        object.__setattr__(self, "rows", row_masks(consts))
        object.__setattr__(self, "header", generic_header(generic_key(self)))

    @property
    def instance(self) -> GenericMode:
        """What the operation count needs beside the constants: the
        tail's ids."""
        return self.generic.mode


def _fit_or_zeros(b: GamutBoundary) -> np.ndarray:
    return boundary_rows(b) if b.coefs is not None else \
        np.zeros((_NFOURIER, POLY_DEG + 1), np.float32)


def pack_constants(b_src: GamutBoundary, b_dst: GamutBoundary,
                   dst_min_pq: float, dst_max_pq: float, gamut_constants,
                   bit_depth: int, black_cutoff: float, hue_coefs=None,
                   pass_matrix=None, pass_clamp=None,
                   extra=None) -> np.ndarray:
    """Every static constant of the chain, derived in float64 exactly as
    the reference's stage functions derive them, then rounded once to
    float32 in LAYOUT order (what a chain does not read is zero, or the
    identity for the pass-through matrix)."""
    c = gamut_constants.fixed()
    j = c.softclip_knee
    to_norm = COLOR_SDR_WHITE / 10000.0
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
            continue        # a constant this chain does not read
        v = np.asarray(vals[name], np.float64).ravel()
        assert v.size == n, (name, v.size, n)
        out[_OFF[name]:_OFF[name] + n] = v.astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# The tail's ids
# ---------------------------------------------------------------------------
#
# The ids, the mix codes of the chain's matrix rows, the fit-row masks
# and a few switches of the plan form its GenericKey; each key is
# compiled into a library of its own from a generated header
# (`generic_header`), so none of them is a runtime value in the kernel.

# ids shared with csrc/color_map.cu (passed as -DK1G_* macros; the
# dynamic curves' as the header's kG_curve, csrc: kToneLen)
G_DYNAMIC = (None,) + ops_tone.DYNAMIC_TONE_FUNCTIONS
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
    """The tail's part ids (csrc: the header's kG_*)."""
    kind: int = 1          # 0 the pass-through chain, 1 the IPT round trip
    gamut: int = 0         # G_GAMUTS
    tone_kind: int = 0     # 0 none, 1 dynamic (G_DYNAMIC), 2 static
    curve: int = 0
    scaling: int = 1       # the static curve's native scaling (G_SCALINGS)
    flags: int = 0         # FLAG_* and GFLAG_* below
    trc: int = 0           # G_TRCS
    encode: int = 0        # G_ENCODES
    dither: int = 0        # G_DITHER


# a tail's flags (csrc: kFlag*, K1G_FLAG_*)
FLAG_PASS_MATRIX, FLAG_PASS_CLAMP, FLAG_HUESHIFT = 1, 2, 4
GFLAG_SHOW_CLIP, GFLAG_PEAK, GFLAG_DITHER_GAMMA = 8, 16, 32


@dataclass(frozen=True)
class GenericSpec:
    """A tail's plan beyond its constants: the ids, the dynamic curve's
    name (the tone vector's), and the plain version
    plain(img, tone, bias) -> out."""
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
    """K1's plan for this tail (`chain`: the renderer's ColorChain):
    `dither` is None or (DitherParams, bias, low-depth gamma path) with
    the bias a square LUT (ordered) or the (H, W) frame (white noise);
    `static_tone` the static curve's ToneMapParams; `show_bounds` the
    (hi_lin + eps, in_max_pq + eps, lo_lin - eps, in_min_pq - eps)
    thresholds of show_clipping; `plain` the stages' closure.  None
    where a boundary fit has a row the kernel cannot sum like `mix` (a
    coefficient of exactly 0 or 1 in a kept row), or the luma ranges of
    the two fits differ."""
    from ...core.colorspace import adapt_white_matrix, primaries_get
    from ..dithering import _APPROX_GAMMA
    from ..gamut import ipt_space
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
    bias = dither[1] if dither else None
    if chain.kind == "pass":
        matrix = chain.matrix
        if matrix is not None and not np.array_equal(matrix, np.eye(3)):
            flags |= FLAG_PASS_MATRIX
        if chain.clamp is not None:
            flags |= FLAG_PASS_CLAMP
        b = ipt_space(primaries_get(dst_color.primaries), chain.dst_min_pq,
                      chain.dst_max_pq)
        extra["g_mix"] = _mix_codes(
            (matrix if matrix is not None else np.eye(3), None)) + \
            [0] * 15 + _mix_codes((enc_m[:9], enc_m[9:]), (enc_pre, None),
                                  (np.eye(3), None))
        consts = pack_constants(b, b, chain.dst_min_pq, chain.dst_max_pq,
                                params.gamut_constants, bit_depth,
                                black_cutoff, pass_matrix=matrix,
                                pass_clamp=chain.clamp, extra=extra)
        mode = GenericMode(kind=0, flags=flags, trc=trc, encode=enc,
                           dither=dmode)
        return TailPlan(consts, GenericSpec(mode, None, plain), bias)
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
            # the kernel sums a kept row as a plain multiply-add chain,
            # which is `mix` only when no coefficient of it is 0 or 1
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
        curve = G_DYNAMIC.index(dynamic)
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
                            params.gamut_constants, bit_depth, black_cutoff,
                            hue_coefs=hue, extra=extra)
    mode = GenericMode(kind=1, gamut=gamut, tone_kind=tone_kind, curve=curve,
                       scaling=scaling, flags=flags, trc=trc, encode=enc,
                       dither=dmode)
    return TailPlan(consts, GenericSpec(mode, dynamic, plain), bias)


# the exponents torch.pow special-cases on the card (csrc: tpow_case), in
# the order it tests them; any other takes powf
_POW_CASES = (0.0, 1.0, 0.5, -1.0, 2.0, 3.0)
# the plan's switches a tail's instance is compiled with, beside its
# ids, mix codes and fit-row masks (csrc: the header's kG_<name>)
G_SWITCHES = ("bezier", "st40_linear", "bt2390_knee", "tone_pow",
              "trc_scaled", "dither_steps", "dither_pow")
_G_ROWS = ("src_kept", "dst_kept", "src_swap", "dst_swap")


def _pow_case(e) -> int:
    """torch.pow's case of the float32 exponent `e` (csrc: tpow_case)."""
    e = float(np.float32(e))
    return _POW_CASES.index(e) if e in _POW_CASES else len(_POW_CASES)


class GenericKey(NamedTuple):
    """Everything the instance of one tail is compiled with: the
    ids, the 27 matrix rows' mix codes (g_mix), the fit-row masks the
    gamut operator reads (`_G_ROWS`; 0 where it reads none) and the
    switches (`G_SWITCHES`; 0 where the chain has no such part)."""
    mode: GenericMode
    mix: tuple
    rows: tuple
    switches: tuple


def generic_key(plan: TailPlan) -> GenericKey:
    """The GenericKey of a generic plan, read from its ids and packed
    (float32) constants, as the kernel would read them at run time."""
    mode = plan.generic.mode
    c = plan.consts
    mix = tuple(int(v) for v in c[_OFF["g_mix"]:_OFF["g_mix"] + 27])
    gamut = G_GAMUTS[mode.gamut] if mode.kind else None
    r = plan.rows
    if gamut in ("perceptual", "softclip"):
        rows = (r.src_kept, r.dst_kept, r.src_swap, r.dst_swap)
    elif gamut in ("relative", "desaturate", "absolute"):
        rows = (0, r.dst_kept, 0, r.dst_swap)
    else:
        rows = (0, 0, 0, 0)
    q = c[_OFF["g_tone"] + 6:_OFF["g_tone"] + 56]
    curve = G_STATIC[mode.curve] if mode.kind and mode.tone_kind == 2 \
        else None
    gamma_dither = bool(mode.dither and mode.flags & GFLAG_DITHER_GAMMA)
    sw = dict(
        bezier=int(q[10]) if curve == "st2094-40" else 0,
        st40_linear=int(curve == "st2094-40" and q[7] != 0),
        bt2390_knee=int(curve == "bt2390" and q[9] != 0),
        tone_pow=_pow_case(q[6]) if curve == "bt2390" else
        _pow_case(q[4]) if curve == "gamma" else 0,
        trc_scaled=int(G_TRCS[mode.trc] != "linear" and
                       c[_OFF["g_trc"]] != 0),
        dither_steps=int(gamma_dither and c[_OFF["dither_scale"]] != 1),
        dither_pow=_pow_case(c[_OFF["g_dith"]]) if gamma_dither else 0)
    return GenericKey(mode, mix, rows, tuple(sw[n] for n in G_SWITCHES))


def generic_header(key: GenericKey) -> str:
    """The C++ header `k1_generic.h` that compiles K1's instance for
    one tail (csrc/color_map.cu includes it): each id, fit-row mask and
    switch as `constexpr int kG_<name> = <value>;` and the mix codes as
    the table of `gmix`.  A function of the key alone, so equal tails
    share a library."""
    lines = ["// Generated by ops/cuda/color_map.py::generic_header: one",
             "// tail of K1's instance, every launch-uniform choice",
             "// a constant.",
             "// ids (GenericMode)"]
    lines += [f"constexpr int kG_{n} = {v};"
              for n, v in zip(GenericMode._fields, key.mode)]
    lines.append("// the boundary fits' row masks (RowMasks)")
    lines += [f"constexpr int kG_{n} = {v};" for n, v in zip(_G_ROWS,
                                                             key.rows)]
    lines.append("// the plan's switches (color_map.py::generic_key)")
    lines += [f"constexpr int kG_{n} = {v};"
              for n, v in zip(G_SWITCHES, key.switches)]
    lines += ["// the matrix rows' mix codes (color_map.py::_mix_code)",
              "__host__ __device__ constexpr int gmix(int i) {",
              "  constexpr int kCodes[27] = {" +
              ", ".join(str(v) for v in key.mix) + "};",
              "  return kCodes[i];", "}", ""]
    return "\n".join(lines)


# FP32 operations a pixel of each part of a tail, counted from
# csrc/color_map.cu (each add, multiply, divide, sqrt, exp, log, pow,
# log1p, min, max, compare, select or floor counts 1, a fused
# multiply-add 2): the peak partials 61; RGB->ICh 190 (the three
# multiplies into 10000-nit scale, two matrices, three pow-free PQ
# curves at 49 each); the dynamic tone curve (spline 12, bt2390 41,
# st2094-40 89 and st2094-10 44, the last two with two exact PQ curves
# at 16 and 15) or a static one (st2094-40 adds 6 a Bernstein term, and
# each its conversions into and out of its scaling, an exact PQ curve
# 15), then the cubic-hull chroma adjustment 14; the Fourier basis and
# intensity powers 55; the chroma soft-clip (perceptual 44 with its
# strength blend, softclip 46 with its desaturated target, or 217 with
# the hue shift: the shift's series 33, its weight 13, cos and sin, the
# turned basis 48, margin 3, both peak series 68, the chroma target 4
# and the soft-clip 42, plus each kept fit row and floor a second time);
# ICh->RGB 179; the RGB soft-clip 69 (its per-pixel terms from the
# largest channel 27 and 3, then 13 a channel) or the clamp 9, each other
# gamut operator beyond the round trip; each target transfer's
# delinearize (three channels; sRGB with its black scaling 36), each
# encode, show_clipping, and the dither.  The pass-through chain mixes
# 15 and clamps 6.
_OPS_PEAK, _OPS_TO_ICH, _OPS_HULL, _OPS_BASIS = 61, 190, 14, 55
_OPS_TONE = {"spline": 12, "bt2390": 41, "st2094-40": 89, "st2094-10": 44}
_OPS_CHROMA = {"perceptual": 44, "softclip": 46}
_OPS_HUE = 217
_OPS_TO_RGB, _OPS_RGB_CLIP, _OPS_CLAMP = 179, 69, 9
_OPS_PASS_MIX, _OPS_PASS_CLAMP = 15, 6
_OPS_ROW0 = 13          # a fit's constant row: 1 multiply + 6 FMAs
_OPS_ROW = 15           # any other kept row, then times its basis term
_OPS_FLOOR = 1          # a fit's floor at 1e-5
_OPS_DITHER = 3 * 4     # per channel an FMA, a floor and a multiply
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


def _fit_ops(kept: int, fits: int) -> int:
    """The kept rows of one boundary fit, evaluated `fits` times."""
    return fits * (_OPS_ROW0 * (kept & 1) + _OPS_FLOOR +
                   _OPS_ROW * bin(kept >> 1).count("1"))


def ops_per_pixel(consts, mode: GenericMode) -> int:
    """FP32 operations the kernel runs a pixel for a tail's packed
    constants and ids (TailPlan.instance): the parts of its chain, every
    boundary-fit row that `boundary_rows` kept (the kernel skips an
    all-zero, pruned row; softclip's hue shift evaluates both fits
    twice), and the dither where the tail dithers."""
    c = np.asarray(consts)
    ops = _G_OPS_TRC[G_TRCS[mode.trc]] + _G_OPS_ENC[G_ENCODES[mode.encode]]
    if mode.kind == 0:
        ops += _OPS_PASS_MIX * bool(mode.flags & FLAG_PASS_MATRIX) + \
            _OPS_PASS_CLAMP * bool(mode.flags & FLAG_PASS_CLAMP)
    else:
        ops += _OPS_TO_ICH + _OPS_TO_RGB
        if mode.flags & GFLAG_PEAK:
            ops += _OPS_PEAK
        if mode.tone_kind == 1:
            ops += _OPS_TONE[G_DYNAMIC[mode.curve]] + _OPS_HULL
        elif mode.tone_kind == 2:
            name = G_STATIC[mode.curve]
            ops += _OPS_HULL + _G_OPS_STATIC[name] + \
                _G_OPS_SCALING[G_SCALINGS[mode.scaling]]
            if name == "st2094-40":
                ops += 6 * (int(c[_OFF["g_tone"] + 16]) + 1)
        gamut = G_GAMUTS[mode.gamut]
        rows = row_masks(c)
        if gamut in ("perceptual", "softclip"):
            fits = 2 if mode.flags & FLAG_HUESHIFT else 1
            ops += _OPS_BASIS + _OPS_RGB_CLIP
            ops += _OPS_HUE if fits == 2 else _OPS_CHROMA[gamut]
            ops += _fit_ops(rows.src_kept, fits) + \
                _fit_ops(rows.dst_kept, fits)
        else:
            ops += _OPS_CLAMP + _G_OPS_GAMUT.get(gamut, 0)
            if gamut in ("relative", "desaturate", "absolute"):
                ops += _fit_ops(rows.dst_kept, 1)
        if mode.flags & GFLAG_SHOW_CLIP:
            ops += _G_OPS_SHOW_CLIP
    if mode.dither:
        ops += _G_OPS_DITHER_GAMMA if mode.flags & GFLAG_DITHER_GAMMA \
            else _OPS_DITHER
    return ops


# ---------------------------------------------------------------------------
# The plain version: the port's stages, and the peak partials
# ---------------------------------------------------------------------------

def _partials(consts, img):
    """The per-stripe peak partials of the linear input, as the kernel
    measures them (ops/peak_detect.py::_pixel_pq, with the plan's
    constants)."""
    maxrgb = torch.clamp_min(torch.amax(img, dim=-3), 0.0)
    pq = torch.clamp(tf.pq_oetf_fast(maxrgb * float(consts[
        _OFF["peak_norm"]])), 0.0, 1.0)
    pq14 = torch.round(pq * 16383.0).to(torch.int32)
    active = pq > float(consts[_OFF["black_cutoff"]])
    bins = torch.clamp((pq14 >> 7) - 64, 0, 63)
    return stripe_partials(pq, active, bins, pick_block_rows(img.shape[-2]))


def tail_plain(img, plan, tone, lut=None):
    """K1's plain version, on any device: (3, H, W) linear light in ->
    ((3, H, W) signal, (H / block_rows, 8, 128) peak partials, or None
    where the tail measures no peak)."""
    out = plan.generic.plain(img, tone, lut)
    partials = _partials(plan.consts, img) \
        if plan.generic.mode.flags & GFLAG_PEAK else None
    return out, partials


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def kernel_flags():
    """nvcc flags of K1: sm_90a, no fast-math, no FMA contraction beyond
    the source's explicit fmaf(), ptxas's register and spill report (kept
    beside the library, see _build.build_log), and the constant layout
    and part ids as macros."""
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


_GENERIC_H = "k1_generic.h"


def generic_spec(header: str):
    """The build spec of the instance compiled with `header`
    (TailPlan.header): the header written as build/gen-<hash>/
    k1_generic.h, the library named by the same hash."""
    from ..._build import generated_include, include_digest, nvcc_path
    inc = generated_include(_GENERIC_H, header)
    return (f"k1_color_map_g{include_digest(_GENERIC_H, header)}",
            ["csrc/color_map.cu"], nvcc_path(),
            kernel_flags() + ["-I", inc])


def build_specs(plans):
    """The build specs (_build.build_all) of the tails `plans`
    (TailPlans): one library a distinct tail, so the compilers run side
    by side."""
    return [generic_spec(h) for h in dict.fromkeys(p.header for p in plans)]


@functools.lru_cache(maxsize=None)
def _generic_lib(header: str):
    """The loaded, typed library of the instance compiled with `header`
    (built at first use; looked up once, since finding the compiler
    costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*generic_spec(header))
    fn = lib.k1_generic_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    st = lib.k1_static_tone_launch
    st.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    st.restype = ctypes.c_int
    lib.k1_sqrt_check_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k1_sqrt_check_launch.restype = ctypes.c_int
    lib.k1_error_string.argtypes = [ctypes.c_int]
    lib.k1_error_string.restype = ctypes.c_char_p
    return lib


def prepare(plan: TailPlan):
    """Compile (once) and load the library a plan launches: the renderer
    calls it when it plans the tail, so no launch waits for a build.  A
    failure raises KernelError (no other instance, and no plain tail,
    runs in its place).  Returns the library."""
    with kernel_work("K1"):
        return _generic_lib(plan.header)


def libraries(plans):
    """The libraries of the tails `plans`, built side by side and loaded:
    {TailPlan.header: library}."""
    from ..._build import build_all
    plans = list(plans)
    build_all(build_specs(plans))
    return {p.header: _generic_lib(p.header) for p in plans}


def sqrt_check(plan: TailPlan, device) -> int:
    """How many floats the kernel's check-free square root (csrc:
    sqrt_in_range) rounds otherwise than sqrtf over the range the PQ
    curves clamp its operands into (csrc: kSqrtLo..kSqrtHi), in the
    library of `plan`: 0 is exact."""
    with kernel_work("K1"):
        lib = _generic_lib(plan.header)
        bad = torch.zeros(1, dtype=torch.int64, device=device)
        rc = lib.k1_sqrt_check_launch(
            bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise KernelError("K1 sqrt check failed: " +
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


def color_map_tail(img, plan, tone, bias):
    """Run K1 on a (3, H, W) float32 frame of linear light.  `plan` is
    the tail's TailPlan (its packed constants in host memory and the
    header of its instance), `tone` the per-frame tone vector
    (ops/cuda/peak_tone.py; None without a dynamic tone curve), `bias`
    the tail's dither bias on the frame's device — the (n, n) LUT
    (plan.lut) or the (H, W) white-noise frame — or None.  Returns (out,
    (H / block_rows, 8, 128) peak partials), the partials None where the
    tail measures no peak."""
    global launches
    if not isinstance(plan, TailPlan) or plan.consts.shape != (NCONST,):
        raise ValueError(f"K1: plan must be a TailPlan of {NCONST} "
                         f"constants")
    mode = plan.generic.mode
    if (tone is None) == (mode.tone_kind == 1):
        raise ValueError("K1: a tone vector goes with a dynamic tone "
                         "curve, and only with one")
    if img.device.type == "cpu":
        return tail_plain(img, plan, tone, bias)
    if img.device.type != "cuda":
        raise ValueError(f"K1: unsupported device {img.device}")
    C, H, W = img.shape
    _check(img, "img", (3, H, W))
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
    with kernel_work("K1"):
        out = torch.empty_like(img)
        sub = partials = None
        if mode.flags & GFLAG_PEAK:
            sub = torch.empty((stripes, W // _COLS, _SUB), dtype=torch.float32,
                              device=img.device)
            partials = torch.empty((stripes, 8, 128), dtype=torch.float32,
                                   device=img.device)
        lib = _generic_lib(plan.header)
        rc = lib.k1_generic_launch(
            img.data_ptr(), out.data_ptr(),
            sub.data_ptr() if sub is not None else None,
            partials.data_ptr() if partials is not None else None,
            plan.consts.ctypes.data,
            tone.data_ptr() if tone is not None else None,
            bias.data_ptr() if bias is not None else None,
            n, H, W, bh, torch.cuda.current_stream(img.device).cuda_stream)
        if rc != 0:
            raise KernelError("K1 launch failed: " +
                               lib.k1_error_string(rc).decode())
    launches += 1
    return out, partials


def static_tone_on_card(x, plan):
    """The static curve of a plan alone, on a 1D CUDA tensor of PQ
    values, through the plan's own library (a test hook)."""
    if plan.generic.mode.tone_kind != 2:
        raise ValueError("K1: the plan has no static tone curve")
    _check(x, "x")
    with kernel_work("K1"):
        y = torch.empty_like(x)
        lib = _generic_lib(plan.header)
        rc = lib.k1_static_tone_launch(
            x.data_ptr(), y.data_ptr(), x.numel(), plan.consts.ctypes.data,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise KernelError("K1 launch failed: " +
                               lib.k1_error_string(rc).decode())
    return y

"""The renderer: frame -> target image.

Counterpart of libplacebo_tpu/render/renderer.py, keeping the reference
package's stage order (`_trace_pipeline`): per plane deinterlacing,
deband, H.274 and AV1 film grain -> merge planes (bilinear chroma
alignment) -> split off the alpha plane -> decode (Dolby Vision's
reshaping with the frame's RPU; the user's color adjustment folded into
the matrix) -> rotation -> linearize (and sigmoidize, for SDR sources)
-> main scaler (EWA or separable, with anti-ringing; the alpha plane
with the same sampler) -> desigmoidize -> cone distortion -> the
color-map tail (with contrast recovery and the tone-curve visualizer)
-> alpha back on -> affine distortion -> border fill around a target
crop -> corner rounding -> dither or error diffusion (kernels K3, K2,
K3) -> target blending -> overlays, with a native custom LUT after the
decode and, with ICC profiles, the frame's decoding the source and the
target's encoding the output.  The tail runs on kernel K1 (tone +
gamut + delinearize + encode, with the peak partials, and the dither
unless error diffusion quantizes) wherever the reference's kernel would
run it (the instance compiled for the tail, `ops/cuda/color_map.py`),
and as plain stages where the reference runs it plain too (an ICC
target, a conversion LUT, a distortion, a target crop, alpha, corner
rounding, contrast recovery, the visualizer); `k1_tails`, `plain_tails`
and `ineligible_tails` count which ran.  Planning (color inference,
boundary fits, filter weights, K1's packed constants, deband's random
tables, the distortion's inverse map, the border canvas, the corner
mask, the plain dither's bias) happens once per signature on the host
and is cached, on the card where it is an image; the per-frame inputs
(`FrameInputs`) are not: the grain tables (AV1's generated on the host,
cached by seed as the reference caches them; H.274's block hash)
uploaded every frame, the neighbor frames of a field, the frame's Dolby
Vision RPU, packed on the host, the target's contents to blend onto and
the overlay bitmaps and the hooks' carried state.  PyTorch then runs the
stages eagerly.  User hooks (render/hooks.py) run at the reference's
sixteen sites; a hooked frame's tail is plain, as in the reference.  A
render that fails on a plain stage goes down the reference's degradation
ladder (`errors`, `get_errors`); a kernel's failure to build or launch
and CUDA errors never degrade: they propagate.  `telemetry` times each
frame, one frame late; inside a torch.profiler session each stage runs
in a span (`render.merge`, `render.scale`, `render.tail`, ...:
render/profiler.py) and a plan-cache miss counts `render.plan_misses`.
`render_image_mix` blends a FrameMix window of rendered frames (frame
interpolation).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._build import KernelError, is_kernel_failure
from ..core import filters as flt
from ..core import log as core_log
from ..core.colorspace import (COLOR_HDR_BLACK, COLOR_SDR_WHITE, CSP_SRGB,
                               AlphaMode, ColorLevels, ColorPrimaries,
                               ColorRepr, ColorSpace, ColorSystem,
                               ColorTransfer, HdrMetadata, HdrScaling,
                               color_mapping_matrix, color_repr_decode,
                               color_space_infer_map,
                               hdr_rescale, levels_guess, primaries_clip,
                               primaries_compatible, primaries_get,
                               primaries_guess, system_is_ycbcr_like)
from ..core.common import RectF
from ..core.fastmath import fma
from ..core.dither import ED_FLOYD_STEINBERG, find_error_diffusion_kernel
from ..core.gamut_mapping import GamutMapConstants
from ..core import tone_mapping as tm
from ..core import transfer as tf
from ..core.tone_mapping import ToneMapConstants
from ..ops import color as ops_color
from ..ops import deband as ops_deband
from ..ops import deinterlace as ops_di
from ..ops import distort as ops_distort
from ..ops import dithering as ops_dither
from ..ops import dovi as ops_dovi
from ..ops import film_grain as ops_fg
from ..ops import film_grain_h274 as ops_h274
from ..ops import gamut as ops_gamut
from ..ops import icc as ops_icc
from ..ops import lut as ops_lut
from ..ops import peak_detect as ops_peak
from ..ops import polar as ops_polar
from ..ops import sampling as ops_sampling
from ..ops import tone_dynamic as ops_tone
from ..ops.cuda import color_map as k1
from ..ops.cuda import error_diffusion as k2
from ..ops.cuda import front
from ..ops.cuda import peak_tone
from ..ops.deband import DebandParams
from ..ops.dithering import DitherParams
from ..ops.peak_detect import PeakDetectParams
from ..runtime import GpuContext
from ..utils.device import resolve_device
from . import profiler
from .frame import Frame, icc_key
from .hooks import HookRect, HookStage, run_hooks
from .queue import frame_mix_nearest

__all__ = ["RenderParams", "Target", "Renderer", "render_image",
           "RenderError", "FrameInputs", "ColorChain", "color_chain",
           "color_map_stage", "tone_with_recovery", "ALPHA_OVERLAY",
           "FAST_PARAMS", "DEFAULT_PARAMS", "HIGH_QUALITY_PARAMS",
           "frames_infer", "frames_infer_mix", "translate_srgb_color",
           "clear_target", "clear_target_tiles", "render_image_mix",
           "k1_tails", "plain_tails", "ineligible_tails"]

# reference pl_alpha_overlay (gpu.h:1163): alpha compositing's factors
ALPHA_OVERLAY = ("src_alpha", "one_minus_src_alpha",
                 "one", "one_minus_src_alpha")

_MAX_CACHED_PIPELINES = 64

# color-map tails run, per frame: through kernel K1; as plain stages
# where the reference's kernel would have run them (a gap of the port);
# and as plain stages where the reference runs them plain too (an ICC
# target, a conversion LUT, ...: `_tail_eligible`).  What a caller reads
# to see which path a render took.
k1_tails = 0
plain_tails = 0
ineligible_tails = 0


class RenderError(Exception):
    """A render that cannot be carried out as asked (the reference's
    RenderError), e.g. a singular distortion transform."""


class FrameInputs(NamedTuple):
    """What a render plan takes every frame besides the planes: the AV1
    grain tables and H.274 block inputs (per plane, or None), the
    neighbor frames' planes of a field, the packed Dolby Vision RPU,
    the target's contents to blend onto, the bitmaps of the frame's then
    the target's overlays, and the values of the hooks' carried state
    (each stateful hook's names in sorted order)."""
    grain_tables: Optional[tuple] = None
    h274_tables: Optional[tuple] = None
    prev_planes: Optional[tuple] = None
    next_planes: Optional[tuple] = None
    dovi_packed: Optional[ops_dovi.DoviPacked] = None
    target_data: Optional[torch.Tensor] = None
    overlay_datas: tuple = ()
    hook_states: tuple = ()


@dataclass(frozen=True)
class Target:
    """Render target description (reference: the target pl_frame)."""
    w: int
    h: int
    repr: ColorRepr = field(default_factory=lambda: ColorRepr(
        sys=ColorSystem.RGB, levels=ColorLevels.FULL))
    color: ColorSpace = field(default_factory=ColorSpace)
    bit_depth: int = 0           # 0 = no dither/quantization
    crop: Optional[RectF] = None
    # display ICC profile (core.icc.IccProfile): when set, the output is
    # encoded through it instead of the nominal transfer
    icc: Optional[object] = None
    # the target's contents (C, h, w) that RenderParams.blend composites
    # onto: per-frame data, keyed by presence only
    data: Optional[object] = field(default=None, compare=False)
    # OSD overlays drawn on the output (default coords dst_frame)
    overlays: tuple = field(default=(), compare=False)

    def meta_key(self):
        return (self.w, self.h, self.repr.sys, self.repr.levels,
                self.repr.alpha, self.repr.bits, self.color.primaries,
                self.color.transfer, self.color.hdr, self.bit_depth,
                self.crop, icc_key(self.icc), self.data is not None,
                tuple(o.key() for o in self.overlays))


@dataclass(frozen=True)
class RenderParams:
    """The reference's RenderParams (pl_render_params), field for field;
    `hooks` are render.hooks.Hook instances."""
    upscaler: str = "lanczos"
    downscaler: str = "hermite"
    plane_upscaler: Optional[str] = "bilinear"
    plane_downscaler: Optional[str] = None
    correct_subpixel_offsets: bool = False
    # render_image_mix's mixer: "oversample" or a filter config's name
    frame_mixer: str = "oversample"
    antiringing_strength: float = 0.0
    linear_scaling: bool = True
    sigmoid: Optional[Tuple[float, float]] = (0.75, 6.5)
    dither: Optional[DitherParams] = field(default_factory=DitherParams)
    error_diffusion: Optional[str] = None
    disable_dither_gamma_correction: bool = False
    tone_mapping_function: str = "spline"
    tone_map_metadata: str = "any"
    gamut_mapping: str = "perceptual"
    # options accepted for compatibility (the reference's LUT, FBO and
    # shader machinery knobs; the ICC sizing knobs ops/icc.params_kwargs
    # reads): a sorted (key, value) tuple, so option strings round-trip
    compat_flags: Tuple = ()
    tone_constants: ToneMapConstants = field(
        default_factory=ToneMapConstants)
    gamut_constants: GamutMapConstants = field(
        default_factory=GamutMapConstants)
    peak_detect: Optional[PeakDetectParams] = field(
        default_factory=PeakDetectParams)
    deband: Optional[DebandParams] = None
    film_grain: bool = True      # honor frame-attached grain data
    # ops.deinterlace.DeinterlaceParams: applied to frames with a field
    deinterlace: Optional[ops_di.DeinterlaceParams] = None
    # HDR contrast recovery strength (0 = off) and its feature map's
    # downscale ratio
    contrast_recovery: float = 0.0
    contrast_smoothness: float = 3.5
    inverse_tone_mapping: bool = False
    gamut_expansion: bool = False
    show_clipping: bool = False
    # debug: the tone curve drawn into visualize_rect (fractions of the
    # frame: x0, y0, x1, y1)
    visualize_lut: bool = False
    visualize_rect: Tuple[float, float, float, float] = (0.0, 0.0,
                                                         1.0, 1.0)
    visualize_hue: float = 0.0
    visualize_theta: float = 0.0
    # core.colorspace.ConeParams: color-blindness simulation
    cone: Optional[object] = None
    # ops.distort.DistortParams: affine distortion of the output
    distort: Optional[ops_distort.DistortParams] = None
    # target blending onto Target.data: (src_rgb, dst_rgb, src_alpha,
    # dst_alpha) factors, each zero|one|src_alpha|one_minus_src_alpha
    blend: Optional[Tuple[str, str, str, str]] = None
    # core.colorspace.ColorAdjustment, folded into the decode
    color_adjustment: Optional[object] = None
    # the fill around a target crop: background color | tiles, border
    # None (= background) | color | tiles | skip (transparent black) |
    # blur (a blurred copy of the image covering the target)
    background: str = "color"
    border: Optional[str] = None
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    background_transparency: float = 0.0
    tile_colors: Tuple = ((0.93, 0.93, 0.93), (0.87, 0.87, 0.87))
    tile_size: int = 32
    blur_radius: float = 16.0
    skip_target_clearing: bool = False   # = border "skip"
    force_dither: bool = False
    # rounded corners, 0..1 of min(w, h) / 2
    corner_rounding: float = 0.0
    hooks: Tuple = ()
    lut: Optional[object] = None          # core.lut.CustomLut
    lut_type: str = "conversion"          # native | conversion
    ignore_icc_profiles: bool = False
    # render_image_mix's cache of rendered frames: kept across changed
    # params, and not filled by a lone frame
    preserve_mixing_cache: bool = False
    skip_caching_single_frame: bool = False
    skip_anti_aliasing: bool = False
    disable_linear_scaling: bool = False
    disable_fused_colormap: bool = False

    def key(self):
        return tuple(getattr(self, f) for f in self.__dataclass_fields__
                     if f not in ("hooks", "lut")) + (
            tuple(h.signature for h in self.hooks),
            self.lut.signature if self.lut is not None else None)


# preset bundles (reference renderer.c:203-224)
FAST_PARAMS = RenderParams(upscaler="bilinear", downscaler="bilinear",
                           linear_scaling=False, sigmoid=None,
                           dither=DitherParams(
                               method=ops_dither.DitherMethod.ORDERED_FIXED))
DEFAULT_PARAMS = RenderParams()
HIGH_QUALITY_PARAMS = RenderParams(
    upscaler="ewa_lanczossharp", downscaler="hermite",
    deband=DebandParams(), peak_detect=PeakDetectParams(percentile=99.995),
    contrast_recovery=0.30)


# The degradation ladder (reference renderer.py:60-90, pl_render_error,
# renderer.c:95-115): when a render fails, the renderer re-renders
# without one feature at a time, most expendable first, records the
# feature in `errors` and logs it.  Each rung is (flag, strip).
_DEGRADE_LADDER = (
    ("fused_colormap", lambda p: replace(p, disable_fused_colormap=True)),
    ("error_diffusion", lambda p: replace(p, error_diffusion=None)),
    ("contrast_recovery", lambda p: replace(p, contrast_recovery=0.0)),
    ("film_grain", lambda p: replace(p, film_grain=False)),
    ("deband", lambda p: replace(p, deband=None)),
    ("peak_detect", lambda p: replace(p, peak_detect=None)),
    ("gamut_mapping", lambda p: replace(p, gamut_mapping="clip")),
    ("dither", lambda p: replace(p, dither=None)),
    ("sampling", lambda p: replace(p, upscaler="bilinear",
                                   downscaler="bilinear",
                                   linear_scaling=False,
                                   sigmoid=None)),
)

# failures the ladder never degrades: the user's errors, as in the
# reference, and a kernel's failure to build, allocate or launch
# (KernelError, whatever failed inside the wrapper's work on the card) —
# the first rung would otherwise hide K1's failures behind a plain tail,
# the second K2's and K3's.  CUDA errors too (`is_kernel_failure`).
_NON_DEGRADABLE = (RenderError, ValueError, TypeError, KeyError, KernelError)


def _ladder(device: torch.device) -> tuple:
    """The rungs a renderer on `device` may take.  On the card the first
    rung would only swap K1 for its plain version: K1's own failures
    propagate (KernelError), so there it could only hide another stage's
    failure behind a plain tail, and it is left out."""
    return _DEGRADE_LADDER[1:] if device.type == "cuda" else _DEGRADE_LADDER


def _degradable(exc: BaseException) -> bool:
    return not isinstance(exc, _NON_DEGRADABLE) and \
        not is_kernel_failure(exc)


def _state_init(value, device) -> torch.Tensor:
    """A hook state's declared initial value as a tensor on `device`,
    64-bit types narrowed to 32 as the reference's arrays are."""
    t = torch.as_tensor(np.asarray(value))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.to(device)


# frames whose telemetry may wait for the card before the oldest is
# waited for
_MAX_PENDING_TIMINGS = 8


def _no_hook(stage, img, rect=None):
    return img


def _find_scaler(name: str) -> flt.FilterConfig:
    """The named filter config, as the reference resolves it
    (`find_filter_config` with its default usage, every use allowed)."""
    cfg = flt.find_filter_config(name)
    if cfg is None:
        raise RenderError(f"unknown filter: {name}")
    return cfg


def _plane_resample(ph: int, pw: int, H: int, W: int, sx: float, sy: float,
                    ox: float, oy: float, params: RenderParams,
                    up_cfg: flt.FilterConfig, down_cfg: flt.FilterConfig):
    """How the merge aligns a (ph, pw) plane sited at (sx, sy), offset
    by (ox, oy) of its own texels, to the (H, W) reference grid: None
    (taken as it is) or (the plane upscaler `up_cfg`, or `down_cfg` for
    a plane larger than the grid, the source RectF).  A same-size
    plane's subpixel siting snaps to the texel unless
    params.correct_subpixel_offsets."""
    if (ph, pw) == (H, W) and (sx or sy) and not ox and not oy \
            and not params.correct_subpixel_offsets:
        return None
    if (ph, pw) == (H, W) and not (sx or sy or ox or oy):
        return None
    cfg = down_cfg if (ph > H or pw > W) else up_cfg
    s0x = -sx * pw / W + ox
    s0y = -sy * ph / H + oy
    return cfg, RectF(s0x, s0y, s0x + pw, s0y + ph)


# the systems whose decode is the matrix alone (decode_color's last path)
_NONLINEAR_DECODE = (ColorSystem.DOLBYVISION, ColorSystem.XYZ,
                     ColorSystem.BT_2100_PQ, ColorSystem.BT_2100_HLG,
                     ColorSystem.BT_2020_C)


def _front_plan(plane_metas, params: RenderParams, frame_repr: ColorRepr,
                src_color: ColorSpace, plain, *, linear_next: bool,
                plain_planes: bool, frame_icc=None, rotation: int = 0):
    """The front (ops/cuda/front.py) that runs a signature's merge,
    decode and linearize in one pass, or None where the plain stages
    run: three planes of one channel each, taken as they are or sampled
    by a phased separable plane scaler; a system whose decode is the
    matrix alone, without the adjustment's gamma; a PQ source linearized
    by its nominal curve (no frame ICC profile) right after the decode
    (`linear_next`); no rotation, native LUT or hook, and nothing the
    merge does to a plane before sampling it (`plain_planes`: no
    deinterlacing, deband or film grain).  An alpha plane is a fourth
    plane.  `plain(*planes)` is the plain chain."""
    adj = params.color_adjustment
    if not (linear_next and plain_planes) or params.hooks or rotation or \
            frame_icc is not None or frame_repr.sys in _NONLINEAR_DECODE or \
            (adj is not None and adj.gamma != 1.0) or \
            (params.lut is not None and params.lut_type == "native") or \
            src_color.infer().transfer != ColorTransfer.PQ:
        return None
    if len(plane_metas) != 3 or sorted(
            m for _, m, _, _ in plane_metas) != [(0,), (1,), (2,)]:
        return None
    ref_shape = plane_metas[Renderer._ref_plane_index(plane_metas)][0]
    H, W = ref_shape[-2], ref_shape[-1]
    up_cfg = _find_scaler(params.plane_upscaler or params.upscaler)
    down_cfg = _find_scaler(params.plane_downscaler or params.downscaler)
    planes = [None] * 3
    for i, (shape, (ch,), sx, sy) in enumerate(plane_metas):
        ph, pw = shape[-2], shape[-1]
        resample = _plane_resample(ph, pw, H, W, sx, sy, 0.0, 0.0, params,
                                   up_cfg, down_cfg)
        if resample is not None:
            cfg, rect = resample
            resample = (cfg, rect, params.antiringing_strength or
                        cfg.antiring)
        planes[ch] = (i, ph, pw, resample)
    tr, _ = color_repr_decode(frame_repr, adj)
    return front.plan_front(planes, H, W, tr.mat.m, tr.c, plain)


def _boundaries(src: ColorSpace, dst: ColorSpace, params: RenderParams,
                dst_min_pq: float, dst_max_pq: float, need_gamut: bool):
    """(b_src, b_dst, gamut_fn) as the reference's color_map_stage
    plans them."""
    if need_gamut and params.gamut_mapping not in ("clip", "saturation"):
        dst_prim = primaries_get(dst.primaries)
        src_prim = primaries_get(src.primaries)
        if (not params.gamut_expansion
                and params.gamut_mapping in ("perceptual",)
                and primaries_compatible(dst_prim, src_prim)):
            dst_prim = primaries_clip(dst_prim, src_prim)
        return (ops_gamut.fit_boundary(src_prim, dst_min_pq, dst_max_pq),
                ops_gamut.fit_boundary(dst_prim, dst_min_pq, dst_max_pq),
                params.gamut_mapping)
    return (ops_gamut.ipt_space(primaries_get(src.primaries),
                                dst_min_pq, dst_max_pq),
            ops_gamut.ipt_space(primaries_get(dst.primaries),
                                dst_min_pq, dst_max_pq),
            "clip" if need_gamut else None)


def _dst_pq_range(dst: ColorSpace) -> Tuple[float, float]:
    dst_inf = dst.infer()
    return (hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, dst_inf.hdr.min_luma),
            hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, dst_inf.hdr.max_luma))


@dataclass(frozen=True)
class ColorChain:
    """How `color_map_stage` maps one color space to another, planned on
    the host: `kind` "pass" is the fast path without the IPT round trip
    (`matrix`, a primaries conversion or None, then `clamp`, the
    (lo, hi) range or None); "ipt" is the round trip with `tone` None,
    "dynamic" (detected stats) or "static" (metadata curve) and the
    gamut operator `gamut` (None clamps) between b_src and b_dst."""
    kind: str
    dst_min_pq: float
    dst_max_pq: float
    matrix: Optional[object] = None
    clamp: Optional[Tuple[float, float]] = None
    tone: Optional[str] = None
    gamut: Optional[str] = None
    b_src: Optional[object] = None
    b_dst: Optional[object] = None


def color_chain(src: ColorSpace, dst: ColorSpace, params: RenderParams,
                dynamic: bool) -> ColorChain:
    """The chain `color_map_stage` runs for src -> dst, with detected
    peak stats (`dynamic`) or without (reference
    pl_shader_color_map_ex's planning, colorspace.c:1651-1788)."""
    need_gamut = (src.primaries != dst.primaries and
                  params.gamut_mapping not in (None, "", "none"))
    _, src_max_n, _ = src.infer().nominal_luma(params.tone_map_metadata)
    src_peak = src_max_n / COLOR_SDR_WHITE
    dst_peak = dst.nominal_peak_norm()
    need_tone = dynamic or src_peak > dst_peak + 1e-3
    if params.inverse_tone_mapping and dst_peak > src_peak + 1e-3 \
            and not dynamic:
        need_tone = True
    dst_min_pq, dst_max_pq = _dst_pq_range(dst)
    if not need_tone and (not need_gamut or
                          params.gamut_mapping in ("clip", "saturation")):
        matrix = clamp = None
        if src.primaries != dst.primaries:
            matrix = color_mapping_matrix(primaries_get(src.primaries),
                                          primaries_get(dst.primaries)).m
        if need_gamut:
            b = ops_gamut.ipt_space(primaries_get(dst.primaries),
                                    dst_min_pq, dst_max_pq)
            to_norm = COLOR_SDR_WHITE / 10000.0
            clamp = (b.min_rgb / to_norm, b.max_rgb / to_norm)
        return ColorChain("pass", dst_min_pq, dst_max_pq, matrix=matrix,
                          clamp=clamp)
    b_src, b_dst, gamut_fn = _boundaries(src, dst, params, dst_min_pq,
                                         dst_max_pq, need_gamut)
    tone = ("dynamic" if dynamic else "static") if need_tone else None
    return ColorChain("ipt", dst_min_pq, dst_max_pq, tone=tone,
                      gamut=gamut_fn, b_src=b_src, b_dst=b_dst)


def _static_tone_params(src: ColorSpace, params: RenderParams,
                        chain: ColorChain) -> tm.ToneMapParams:
    """The static (metadata) curve's parameters, in PQ both ways."""
    def to_pq(nits):
        return hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, nits)
    src_inf = src.infer()
    src_min_n, src_max_n, src_avg_n = src_inf.nominal_luma(
        params.tone_map_metadata)
    fun = tm.find_tone_map_function(params.tone_mapping_function) \
        or tm.TONE_MAP_SPLINE
    return tm.ToneMapParams(
        function=fun, input_scaling=HdrScaling.PQ,
        output_scaling=HdrScaling.PQ, lut_size=256,
        constants=params.tone_constants, input_min=to_pq(src_min_n),
        input_max=to_pq(src_max_n),
        input_avg=to_pq(src_avg_n) if src_avg_n else 0.0,
        output_min=chain.dst_min_pq, output_max=chain.dst_max_pq,
        hdr=src_inf.hdr)


def _show_bounds(src: ColorSpace, params: RenderParams):
    """show_clipping's (in_min_pq, in_max_pq), or None."""
    if not params.show_clipping:
        return None
    src_inf = src.infer()
    return (hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, src_inf.hdr.min_luma),
            hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, src_inf.hdr.max_luma))


def _map_chain(img, chain: ColorChain, tone_fn, params: RenderParams,
               show_bounds):
    """Run a planned chain with the tone curve `tone_fn` (PQ -> PQ, or
    None)."""
    if chain.kind == "pass":
        if chain.matrix is not None:
            img = ops_color.mat_pointwise(img, chain.matrix)
        if chain.clamp is not None:
            img = torch.clamp(img, *chain.clamp)
        return img
    return ops_gamut.color_map_ipt(img, tone_fn, chain.gamut, chain.b_src,
                                   chain.b_dst,
                                   to_norm=COLOR_SDR_WHITE / 10000.0,
                                   constants=params.gamut_constants,
                                   show_clip_bounds=show_bounds)


def color_map_stage(img, src: ColorSpace, dst: ColorSpace,
                    params: RenderParams, peak_stats=None,
                    tone_recovery_impl=None):
    """Linear-light conversion: tone + gamut mapping through one IPT
    round trip (reference pl_shader_color_map_ex).  `peak_stats` =
    (avg_pq, max_pq) 0-dim tensors drive the dynamic tone curve;
    without them the curve is the static one from the metadata
    (core/tone_mapping.apply_device).  The curve runs with contrast
    recovery (`tone_recovery_impl(x, base, cr, out_min, out_max)`
    replaces tone_with_recovery: the sharded renderer's resizes the
    feature map over row halos), and visualize_lut draws it into the
    output."""
    chain = color_chain(src, dst, params, peak_stats is not None)
    tone_fn = None
    if chain.tone == "dynamic":
        avg_pq, max_pq = peak_stats
        base = lambda x: ops_tone.tone_map_dynamic(  # noqa: E731
            x, params.tone_mapping_function, src_max=max_pq,
            src_avg=avg_pq, dst_min=chain.dst_min_pq,
            dst_max=chain.dst_max_pq, constants=params.tone_constants)
    elif chain.tone == "static":
        tp = _static_tone_params(src, params, chain)
        base = lambda x: tm.apply_device(x, tp)  # noqa: E731
    if chain.tone is not None and tone_recovery_impl is not None:
        tone_fn = lambda x: tone_recovery_impl(  # noqa: E731
            x, base, params.contrast_recovery, chain.dst_min_pq,
            chain.dst_max_pq)
    elif chain.tone is not None:
        tone_fn = lambda x: tone_with_recovery(  # noqa: E731
            x, base, params.contrast_recovery, chain.dst_min_pq,
            chain.dst_max_pq, smoothness=params.contrast_smoothness)
    out = _map_chain(img, chain, tone_fn, params, _show_bounds(src, params))
    if params.visualize_lut and tone_fn is not None:
        # the curve fades out as theta turns toward the gamut view
        # (reference colorspace.c:2014-2016)
        alpha = math.cos(params.visualize_theta) ** 5 \
            if chain.gamut not in (None, "clip", "saturation") else 1.0

        def to_pq(nits):
            return hdr_rescale(HdrScaling.NITS, HdrScaling.PQ, nits)
        src_min_n, src_max_n, src_avg_n = src.infer().nominal_luma(
            params.tone_map_metadata)
        in_avg = peak_stats[0] if peak_stats is not None else \
            (to_pq(src_avg_n) if src_avg_n else 0.0)
        out = _visualize_tone_map(
            out, params.visualize_rect, max(alpha, 0.0), tone_fn,
            in_min=to_pq(src_min_n), in_max=to_pq(src_max_n),
            in_avg=in_avg, out_min=chain.dst_min_pq,
            out_max=chain.dst_max_pq)
    return out


def _visualize_tone_map(color, rect, alpha, tone_fn, in_min, in_max,
                        in_avg, out_min, out_max):
    """The reference's tone-curve visualizer (visualize_tone_map,
    shaders/colorspace.c:1424-1483): the PQ -> PQ curve, the source and
    target ranges, the diagonal, the inverse-tone-mapping region and the
    average marker, drawn into `rect` (fractions of the frame, y up)."""
    H, W = color.shape[-2], color.shape[-1]
    dev = color.device
    x0, y0, x1, y1 = rect
    px = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    py = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    pos_x = ((px - x0) / max(x1 - x0, 1e-6))[None, :]
    pos_y = (1.0 - (py - y0) / max(y1 - y0, 1e-6))[:, None]
    in_rect = (pos_x >= 0) & (pos_x <= 1) & (pos_y >= 0) & (pos_y <= 1)
    vv = tone_fn(torch.clamp(pos_x, 0.0, 1.0))
    a = float(np.float32(0.8 * alpha))

    def rgb(r, g, b):
        return torch.tensor([r, g, b], dtype=torch.float32,
                            device=dev)[:, None, None]

    viz = color[..., :3, :, :]
    amask = torch.where(in_rect, a, 0.0)
    inside_src = (pos_x >= in_min) & (pos_x <= in_max)
    inside_dst = (pos_y >= out_min) & (pos_y <= out_max)
    osrc_y = (pos_y < in_min) | (pos_y > in_max)
    m = inside_src & ~inside_dst
    viz = torch.where(m & osrc_y, rgb(0.1, 0.1, 0.5),
                      torch.where(m, rgb(0.2, 0.05, 0.05), viz))
    dom = inside_src & inside_dst
    diag = (pos_x - pos_y).abs() < 1e-3
    below = pos_y < vv
    brighter = (vv > pos_x) & (pos_y > pos_x)
    darker = (vv < pos_x) & (pos_y < pos_x)
    body = torch.where(brighter, rgb(0.5, 0.7, 0.05), rgb(0.05, 0.05, 0.05))
    outer = torch.where(darker, rgb(0.0, 0.1, 0.2), viz)
    viz = torch.where(dom & diag, rgb(0.2, 0.2, 0.2),
                      torch.where(dom & below, body,
                                  torch.where(dom, outer, viz)))
    amask = torch.where(dom & below & ~diag, amask * 0.6, amask)
    itm = dom & (pos_y > in_max)
    viz = torch.where(itm, fma(rgb(0.2, 0.5, 0.8) - viz, 0.5, viz), viz)
    blk = dom & (pos_y < in_min)
    viz = torch.where(blk, viz * 0.7, viz)
    if not isinstance(in_avg, (int, float)) or in_avg > 0:
        avg_line = dom & ((pos_x - in_avg).abs() < 1e-3) & (in_avg > 0)
        viz = torch.where(avg_line, rgb(0.5, 0.5, 0.5), viz)
    out_rgb = color[..., :3, :, :]
    out_rgb = fma(viz - out_rgb, amask, out_rgb)
    if color.shape[-3] > 3:
        return torch.cat([out_rgb, color[..., 3:, :, :]], dim=-3)
    return out_rgb


def tone_with_recovery(maxrgb_pq, tone_fn, cr: float, out_min: float,
                       out_max: float, smoothness: float = 3.5):
    """HDR contrast recovery (reference shaders/colorspace.c:1880-1920):
    tone-map a low-passed feature map (bilinear down by `smoothness`,
    bicubic back up) and re-inject the detail the low pass removed,
    mixed in by strength `cr`."""
    if cr <= 0 or smoothness <= 1:
        return tone_fn(maxrgb_pq)
    H, W = maxrgb_pq.shape[-2], maxrgb_pq.shape[-1]
    lh = max(1, int(math.ceil(H / smoothness)))
    lw = max(1, int(math.ceil(W / smoothness)))
    low = ops_sampling.sample_bilinear(maxrgb_pq, lh, lw)
    lowres = ops_sampling.resize_separable(
        low, H, W, flt.find_filter_config("bicubic"))
    base = tone_fn(maxrgb_pq)
    sharp = tone_fn(lowres) + (maxrgb_pq - lowres)
    return torch.clamp(fma(sharp - base, cr, base), out_min, out_max)


def _dither_params(params: RenderParams, dst_color: ColorSpace):
    dp = replace(params.dither, transfer=dst_color.transfer) \
        if params.dither.transfer == ColorTransfer.UNKNOWN else params.dither
    if params.disable_dither_gamma_correction:
        dp = replace(dp, transfer=ColorTransfer.LINEAR)
    return dp


def _tail_eligible(params: RenderParams, target: Target, dst_w, dst_h,
                   dst_crop, has_alpha: bool) -> bool:
    """The reference's gates for its fused tail (renderer.py:1565-1574):
    a pointwise tail of an opaque image over the whole target."""
    return (not params.disable_fused_colormap
            and not params.hooks and not has_alpha and target.icc is None
            and params.distort is None and not params.visualize_lut
            and (params.lut is None or params.lut_type != "conversion")
            and (dst_w, dst_h) == (target.w, target.h)
            and int(round(dst_crop.x0)) == 0 == int(round(dst_crop.y0))
            and params.corner_rounding <= 0
            and params.contrast_recovery == 0.0
            and dst_w % 128 == 0)


def _paste(canvas, img, y0: int, x0: int):
    """`img` written into `canvas` at (y0, x0), the offsets clamped so it
    fits (as jax.lax.dynamic_update_slice clamps them)."""
    y0 = min(max(y0, 0), canvas.shape[-2] - img.shape[-2])
    x0 = min(max(x0, 0), canvas.shape[-1] - img.shape[-1])
    canvas[..., y0:y0 + img.shape[-2], x0:x0 + img.shape[-1]] = img
    return canvas


def _corner_mask(strength: float, h: int, w: int, device) -> torch.Tensor:
    """The antialiased rounded-rectangle mask of corner rounding
    (reference renderer.c:2615), radius strength * min(w, h) / 2."""
    r_px = strength * min(h, w) / 2
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    cx = np.clip(xx, r_px, w - r_px)
    cy = np.clip(yy, r_px, h - r_px)
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    return torch.from_numpy(
        np.clip(r_px + 0.5 - d, 0.0, 1.0).astype(np.float32)).to(device)


class Renderer:
    """Holds the plan cache and the state carried across frames: the
    peak-detection state (2,) on the device, the frame index that
    rotates a temporal dither, the hooks' carried state, the degradation
    flags and disabled hooks, and the telemetry's pending frame.

    Built on a runtime.GpuContext (`Renderer(ctx)` or `ctx=`, as the
    reference's `Renderer(ctx)`), whose device it renders on and whose
    cache `save` / `load` serialize, or on a device (`Renderer(device)`
    or `device=`; None = "cuda") without a context."""

    def __init__(self, ctx=None, device=None):
        if ctx is not None and not isinstance(ctx, GpuContext):
            if device is not None:
                raise TypeError("Renderer takes a context or a device, "
                                f"not {ctx!r} and {device!r}")
            ctx, device = None, ctx
        if ctx is not None:
            if device is not None:
                raise TypeError("Renderer takes a context or a device, "
                                "not both")
            device = ctx.device
        self.ctx = ctx
        self.device = resolve_device(device)
        self._cache: Dict[tuple, object] = {}
        self._peak_state = ops_peak.peak_detect_state_init(self.device)
        self._frame_idx = 0
        # render_image_mix's rendered frames, by signature and plan, and
        # its dither's bias
        self._mix_cache: Dict[tuple, torch.Tensor] = {}
        self._mix_bias: Dict[tuple, torch.Tensor] = {}
        # features the degradation ladder disabled, and hooks disabled
        # by signature after they raised (reference rr->disabled_hooks)
        self.errors: set = set()
        self._disabled_hooks: set = set()
        # cross-frame hook state: (hook signature, name) -> tensor
        self._hook_states: Dict[tuple, torch.Tensor] = {}
        # render.profiler.Telemetry, or None
        self.telemetry = None
        # (start, end) of the frames timed but not yet recorded
        self._telemetry_pending: list = []

    @staticmethod
    def _ref_plane_index(plane_metas):
        ref_i, best = 0, -1
        for i, (shape, mapping, sx, sy) in enumerate(plane_metas):
            if 0 in mapping and shape[-2] * shape[-1] > best:
                best = shape[-2] * shape[-1]
                ref_i = i
        return ref_i

    @staticmethod
    def _plane_hook_stage(mapping, repr_sys=None):
        """(input stage, scaled stage) of the hooks a plane feeds
        (reference PL_HOOK_{LUMA,CHROMA,ALPHA,RGB,XYZ}_INPUT,
        renderer.c:1431; an XYZ frame's planes hook at XYZ_INPUT)."""
        ms = set(mapping)
        if ms == {0}:
            return HookStage.LUMA_INPUT, HookStage.LUMA_INPUT
        if ms <= {1, 2}:
            return HookStage.CHROMA_INPUT, HookStage.CHROMA_SCALED
        if ms == {3}:
            return HookStage.ALPHA_INPUT, HookStage.ALPHA_SCALED
        if {0, 1, 2} <= ms:
            if repr_sys == ColorSystem.XYZ:
                return HookStage.XYZ_INPUT, None
            return HookStage.RGB_INPUT, None
        return None, None

    def _merge_planes(self, planes, plane_metas, params: RenderParams,
                      deband=None, grain=None, fields=None, h274=None,
                      hook=None, repr_sys=None):
        """Per-plane deinterlacing, deband, film grain and input hooks,
        then alignment of every plane to the reference plane's grid and
        channel stacking (reference pass_read_image, renderer.c:1553, and
        _merge_planes, renderer.py:617-753: deinterlace -> plane_deband
        -> H.274 grain -> AV1 grain -> plane hooks -> sampler ->
        *_SCALED hooks).  `fields` is None or (field, first field, the
        previous frame's planes or None, the next's or None); `deband`
        holds per plane None or (DebandParams, neutral values, random
        tables); `h274` is None or (the grain data, per-plane H274Tables
        or None, whether the system is YCbCr-like); `grain` is None or
        (per-plane GrainCfg or None, the frame's AV1 grain tables,
        scaling shift); `hook` is the frame's hook runner, hook(stage,
        img, rect=None), or None for none.  Chroma grain scales with the
        frame's input luma, not the processed one.  Returns the stacked
        image, the (possibly hook-resized) reference grid (H, W) and the
        reference plane's declared offset, which shifts the main crop."""
        hook = hook or _no_hook
        ref_i = self._ref_plane_index(plane_metas)
        ref_mapping = plane_metas[ref_i][1]
        luma_full = planes[ref_i][..., ref_mapping.index(0), :, :] \
            if 0 in ref_mapping else None
        processed = []
        for i, ((shape, mapping, sx, sy), data) in enumerate(
                zip(plane_metas, planes)):
            ph, pw = data.shape[-2], data.shape[-1]
            if fields is not None:
                field, first, prev, nxt = fields
                data = ops_di.deinterlace(
                    data, field, params.deinterlace,
                    prev=prev[i] if prev is not None else None,
                    next=nxt[i] if nxt is not None else None,
                    first_field=first)
            if deband is not None and deband[i] is not None:
                dp, neutral, tables = deband[i]
                data = ops_deband.deband(data, dp, seed=i, tables=tables,
                                         neutral=neutral)
            if h274 is not None and h274[1][i] is not None:
                data = ops_h274.apply_h274_grain(
                    data, h274[0], tuple(mapping), is_ycbcr=h274[2],
                    tables=h274[1][i])
            if grain is not None and grain[0][i] is not None:
                cfgs, tables, scaling_shift = grain
                luma = None
                if 0 not in mapping and luma_full is not None:
                    luma = ops_fg.subsample_nearest(
                        luma_full, cfgs[i].sub_x, cfgs[i].sub_y, ph, pw)
                data = ops_fg.apply_av1_grain(data, tables[i], cfgs[i],
                                              scaling_shift, luma=luma)
            # input hooks may resize the plane (a luma doubler); each
            # plane's //!OFFSET accumulator (custom_mpv.c:1533-1551)
            stage_in, stage_scaled = self._plane_hook_stage(mapping, repr_sys)
            hr = HookRect()
            if stage_in is not None:
                data = hook(stage_in, data, rect=hr)
            processed.append((sx, sy, mapping, data, stage_scaled, hr))
        H, W = processed[ref_i][3].shape[-2], processed[ref_i][3].shape[-1]
        # the reference plane's own offset shifts the main crop instead;
        # it is never resampled at the merge
        hr_ref = processed[ref_i][5]
        if hr_ref.align:
            hr_ref.ox = hr_ref.oy = 0.0
        ref_off = (hr_ref.ox, hr_ref.oy)
        up_cfg = _find_scaler(params.plane_upscaler or params.upscaler)
        down_cfg = _find_scaler(params.plane_downscaler or params.downscaler)
        channels = {}
        for sx, sy, mapping, data, stage_scaled, hr in processed:
            ph, pw = data.shape[-2], data.shape[-1]
            if hr.align:
                sx = sy = 0.0     # ALIGN pins the plane to the ref grid
            # the plane's declared offset against the (offset) reference
            # grid, in its own texels
            ox = 0.0 if hr is hr_ref else hr.ox - ref_off[0] * pw / W
            oy = 0.0 if hr is hr_ref else hr.oy - ref_off[1] * ph / H
            resample = _plane_resample(ph, pw, H, W, sx, sy, ox, oy, params,
                                       up_cfg, down_cfg)
            if resample is not None:
                cfg, rect = resample
                antiring = params.antiringing_strength or cfg.antiring
                if cfg.polar:
                    data = ops_polar.sample_polar(data, cfg, H, W, rect,
                                                  antiring=antiring)
                else:
                    data = ops_sampling.resize_separable(
                        data, H, W, cfg, rect, antiring=antiring)
                if stage_scaled is not None:
                    data = hook(stage_scaled, data)
            for ci, ch in enumerate(mapping):
                channels[ch] = data[..., ci, :, :]
        order = sorted(channels)
        return torch.stack([channels[c] for c in order], dim=-3), (H, W), \
            ref_off

    def _grain_cfgs(self, plane_metas, frame_repr: ColorRepr,
                    frame_grain):
        """Per-plane static grain configs (None = no grain on the plane),
        and the scaling shift."""
        ref_shape = plane_metas[self._ref_plane_index(plane_metas)][0]
        H, W = ref_shape[-2], ref_shape[-1]
        bits = max(frame_repr.bits.color_depth or 8, 8)
        limited = levels_guess(frame_repr) == ColorLevels.LIMITED
        cfgs = []
        for shape, mapping, _, _ in plane_metas:
            cfg = ops_fg.grain_cfg_for(
                frame_grain, tuple(mapping), bits=min(bits, 12),
                sub_x=1 if shape[-1] * 2 <= W else 0,
                sub_y=1 if shape[-2] * 2 <= H else 0,
                limited_range=limited,
                is_ycbcr=system_is_ycbcr_like(frame_repr.sys))
            cfgs.append(cfg if any(cfg.active) else None)
        return cfgs, frame_grain.av1.scaling_shift

    def _trace_pipeline(self, frame_meta_key, target: Target,
                        params: RenderParams, frame_repr: ColorRepr,
                        frame_color: ColorSpace, crop: RectF,
                        frame_grain=None, dither_phase: int = 0,
                        frame_icc=None, field=None, first_field=None,
                        rotation: int = 0, overlays=()):
        """Plan one signature on the host and return the per-frame stage
        function pipeline(peak_state, inputs: FrameInputs, *planes) ->
        (image, new_state, the hooks' states out).  `overlays` is
        ((Overlay, is_target), ...), the frame's then the target's; their
        bitmaps come per frame."""
        if params.ignore_icc_profiles:
            # both ends fall back to their colorimetric metadata
            frame_icc = None
            target = replace(target, icc=None)
        plane_metas = frame_meta_key[0]
        ref_shape = plane_metas[self._ref_plane_index(plane_metas)][0]
        has_alpha = any(3 in mapping for _, mapping, _, _ in plane_metas)
        rotation = int(rotation) % 4
        dst_raw = target.color
        if dst_raw.primaries == ColorPrimaries.UNKNOWN:
            dst_raw = ColorSpace(primaries_guess(target.w, target.h),
                                 dst_raw.transfer, dst_raw.hdr)
        src_color, dst_color = color_space_infer_map(frame_color, dst_raw)
        grain_cfgs = scaling_shift = None
        if params.film_grain and ops_fg.needs_fg(frame_grain):
            grain_cfgs, scaling_shift = self._grain_cfgs(
                plane_metas, frame_repr, frame_grain)
        # H.274's models are the plan's; its seed enters with the
        # per-frame block inputs
        h274_grain = frame_grain if params.film_grain and \
            ops_h274.needs_fg_h274(frame_grain) else None
        is_ycbcr = system_is_ycbcr_like(frame_repr.sys)
        deinterlace = params.deinterlace is not None and field is not None
        deband = None
        if params.deband is not None:
            # reference plane_deband (renderer.c:1318-1342): the grain
            # amplitude is divided by the source's nominal peak; the
            # random tables depend on the plane's shape and index only
            db = params.deband
            if src_color.hdr.max_luma > 0:
                db = replace(db, grain=db.grain /
                             (src_color.hdr.max_luma / COLOR_SDR_WHITE))
            deband = [None if 3 in mapping else (
                db, ops_deband.plane_grain_neutral(frame_repr, mapping),
                ops_deband.deband_tables(db, shape, i, self.device))
                for i, (shape, mapping, _, _) in enumerate(plane_metas)]
        # peak detection drives every dynamic-capable curve; st2094-40
        # with HDR10+ OOTF anchors stays on the static curve
        _tm_fn = params.tone_mapping_function
        use_peak = (params.peak_detect is not None and src_color.is_hdr()
                    and (src_color.primaries != dst_color.primaries or
                         src_color.transfer != dst_color.transfer)
                    and _tm_fn in ops_tone.DYNAMIC_TONE_FUNCTIONS
                    and not (_tm_fn == "st2094-40"
                             and src_color.hdr.ootf is not None))
        dst_crop = target.crop or RectF(0, 0, target.w, target.h)
        dst_w = int(round(dst_crop.w))
        dst_h = int(round(dst_crop.h))
        x0, y0 = int(round(dst_crop.x0)), int(round(dst_crop.y0))
        hdr_src = src_color.is_hdr()

        def scale_plan(c: RectF, needs=None):
            """(needs_scale, use_linear, sigmoid, scaler, cfg_down,
            antiring) for the source crop `c`; `needs` forces the
            scale."""
            src_w, src_h = c.x1 - c.x0, c.y1 - c.y0
            if needs is None:
                needs = (abs(src_h - dst_h) > 1e-6 or
                         abs(src_w - dst_w) > 1e-6 or c.x0 != 0 or c.y0 != 0)
            up = dst_w > src_w or dst_h > src_h
            lin = (params.linear_scaling and needs
                   and not params.disable_linear_scaling)
            sg = ops_color.SigmoidParams(*params.sigmoid) \
                if lin and params.sigmoid is not None and not hdr_src \
                else None
            scaler = down = None
            antiring = 0.0
            if needs:
                scaler = _find_scaler(params.upscaler if up
                                      else params.downscaler)
                down = _find_scaler(params.downscaler)
                antiring = params.antiringing_strength or scaler.antiring
            return needs, lin, sg, scaler, down, antiring
        # ICC profiles replace the nominal transfer on their side, so
        # they force the conversion even between equal colorspaces
        need_color_map = (src_color.primaries != dst_color.primaries or
                          src_color.transfer != dst_color.transfer or
                          target.icc is not None or frame_icc is not None)
        icc_kw = ops_icc.params_kwargs(params)
        icc_enc_kw = ops_icc.params_kwargs(params, encode=True)

        def linearize_src(x):
            """Source signal -> linear light, through the frame's ICC
            profile when it has one (pl_icc_decode)."""
            if frame_icc is not None:
                return ops_icc.decode_profile(
                    x, frame_icc, primaries_get(src_color.primaries),
                    **icc_kw)
            return ops_color.linearize(x, src_color)

        def delinearize_to(x, csp):
            """Linear light -> the target signal, through the target's ICC
            profile when it has one (pl_icc_encode)."""
            if target.icc is not None:
                return ops_icc.encode_profile(
                    x, target.icc, primaries_get(csp.primaries),
                    **icc_enc_kw)
            return ops_color.delinearize(x, csp)
        fused_tail = None
        if need_color_map:
            fused_tail = self._fused_tail(params, src_color, dst_color,
                                          target, use_peak, dst_w, dst_h,
                                          dst_crop, has_alpha, dither_phase)
        src_max_pq = hdr_rescale(HdrScaling.NITS, HdrScaling.PQ,
                                 src_color.hdr.max_luma)

        def plain_front(*planes):
            """The front's plain version: merge, decode, linearize."""
            img, _, _ = self._merge_planes(planes, plane_metas, params)
            img = ops_color.decode_color(img, frame_repr, src_color.primaries,
                                         adjustment=params.color_adjustment)
            return linearize_src(img)
        # the linearize directly follows the decode where it opens the
        # linear-light scaling, or where nothing is scaled before the tail
        needs0, lin0, sig0, _, _, _ = scale_plan(crop)
        front_plan = _front_plan(
            plane_metas, params, frame_repr, src_color, plain_front,
            linear_next=sig0 is None and (lin0 or (
                need_color_map and not needs0 and params.cone is None)),
            plain_planes=not (deinterlace or params.deband is not None or
                              grain_cfgs is not None or
                              h274_grain is not None),
            frame_icc=frame_icc, rotation=rotation)
        # the card runs it; the CPU keeps the plain stages
        fused_front = front_plan if self.device.type == "cuda" else None
        if fused_front is not None:
            # the kernel's library, loaded now rather than at its first
            # launch (KernelError if it cannot be built)
            front.prepare()
        dp = _dither_params(params, dst_color) if params.dither else None
        quantize = target.bit_depth and (target.bit_depth < 16 or
                                         params.force_dither)
        # an unknown kernel name diffuses with Floyd-Steinberg, as in the
        # reference
        ed_kernel = find_error_diffusion_kernel(params.error_diffusion) \
            if params.error_diffusion else None
        if params.error_diffusion and self.device.type == "cuda":
            # the pattern's K2 instance, compiled now rather than at its
            # first launch (KernelError if it cannot be)
            k2.prepare(ed_kernel or ED_FLOYD_STEINBERG)

        tail_eligible = need_color_map and _tail_eligible(
            params, target, dst_w, dst_h, dst_crop, has_alpha)
        # the distortion's inverse map, once a plan (a singular transform
        # raises RenderError here)
        distort_plan = ops_distort.plan_distort(
            dst_h, dst_w, dst_w, dst_h, params.distort, self.device) \
            if params.distort is not None else None
        # the images a plan fills in once, on the card, by channel count
        # (a distortion with alpha adds one): the plain dither's bias,
        # the border canvas, the corner mask and its background
        planned: Dict[tuple, torch.Tensor] = {}

        def plan_image(key, make):
            if key not in planned:
                planned[key] = make()
            return planned[key]
        border = None
        if (dst_w, dst_h) != (target.w, target.h) or x0 or y0:
            border = "skip" if params.skip_target_clearing else \
                (params.border or params.background)
        frame_hw = (ref_shape[-2], ref_shape[-1])
        hooks = tuple(params.hooks)
        # cross-frame hook state: each stateful hook's names, in the
        # order FrameInputs.hook_states carries their values
        hook_state_specs = tuple(
            (h, tuple(sorted(getattr(h, "state_spec", None) or ())))
            for h in hooks if getattr(h, "state_spec", None))

        def pipeline(peak_state, inputs: FrameInputs, *planes):
            """-> (image, new peak state, the hook states carried out)."""
            global k1_tails, plain_tails, ineligible_tails
            grain = (grain_cfgs, inputs.grain_tables, scaling_shift) \
                if grain_cfgs is not None else None
            h274 = (h274_grain, inputs.h274_tables, is_ycbcr) \
                if h274_grain is not None else None
            fields = (field, first_field or field, inputs.prev_planes,
                      inputs.next_planes) if deinterlace else None
            hstates = None
            if hook_state_specs:
                vals = iter(inputs.hook_states)
                hstates = {h.signature: ({n: next(vals) for n in names}, {})
                           for h, names in hook_state_specs}

            def hook(stage, x, rect=None):
                return run_hooks(hooks, stage, x, self._disabled_hooks,
                                 states=hstates, rect=rect, dst_w=dst_w,
                                 dst_h=dst_h)
            with profiler.span("render.merge"):
                if fused_front is not None:
                    # merge, decode and linearize in one launch
                    img = front.run(fused_front, planes)
                    profiler.count("render.front_fused")
                    (h_act, w_act), ref_off = frame_hw, (0.0, 0.0)
                else:
                    img, (h_act, w_act), ref_off = self._merge_planes(
                        planes, plane_metas, params, deband, grain, fields,
                        h274, hook, frame_repr.sys)
            alpha = None
            if has_alpha:
                # the alpha plane runs beside the color, un-premultiplied
                # for processing
                alpha = img[..., -1:, :, :]
                img = img[..., :3, :, :]
                if frame_repr.alpha == AlphaMode.PREMULTIPLIED:
                    img = img / torch.clamp_min(alpha, 1e-6)
            # input hooks may resize the reference plane (a luma doubler):
            # the crop scales into the hooked grid
            crop_eff = crop
            if (h_act, w_act) != frame_hw:
                fy, fx = h_act / frame_hw[0], w_act / frame_hw[1]
                crop_eff = RectF(crop.x0 * fx, crop.y0 * fy,
                                 crop.x1 * fx, crop.y1 * fy)
            # the main image's //!OFFSET accumulator, seeded with the
            # reference plane's offset
            hr_main = HookRect(*ref_off)
            h_pre, w_pre = img.shape[-2], img.shape[-1]
            img = hook(HookStage.NATIVE, img, rect=hr_main)
            # a NATIVE resize folds into the crop, on the turned axes
            sx_n = img.shape[-1] / w_pre
            sy_n = img.shape[-2] / h_pre
            if rotation % 2:
                sx_n, sy_n = sy_n, sx_n
            if fused_front is None:
                with profiler.span("render.decode"):
                    img = ops_color.decode_color(
                        img, frame_repr, src_color.primaries,
                        dovi_packed=inputs.dovi_packed,
                        adjustment=params.color_adjustment)
                    if rotation:
                        # the decoded image turns before scaling; the
                        # crop lies in the turned image
                        img = torch.rot90(img, rotation, dims=(-2, -1))
                        if alpha is not None:
                            alpha = torch.rot90(alpha, rotation,
                                                dims=(-2, -1))
                        hr_main.rotate(rotation)
            h_rot, w_rot = img.shape[-2], img.shape[-1]
            img = hook(HookStage.RGB, img, rect=hr_main)

            def crop_with_hooks(c, img_now):
                """The main stages' resizes and the accumulated offset
                folded into the sampling crop (custom_mpv.c:1533-1541)."""
                fx = sx_n * (img_now.shape[-1] / w_rot)
                fy = sy_n * (img_now.shape[-2] / h_rot)
                if (fx, fy) == (1.0, 1.0) and \
                        not hr_main.ox and not hr_main.oy:
                    return c
                return RectF(c.x0 * fx + hr_main.ox, c.y0 * fy + hr_main.oy,
                             c.x1 * fx + hr_main.ox, c.y1 * fy + hr_main.oy)
            if params.lut is not None and params.lut_type == "native":
                with profiler.span("render.decode"):
                    img = ops_lut.apply_lut(img, params.lut)
            crop_probe = crop_with_hooks(crop_eff, img)
            needs_scale, use_linear, sig, scaler, cfg_down, antiring = \
                scale_plan(crop_probe)
            if use_linear:
                if fused_front is None:
                    with profiler.span("render.linearize"):
                        img = linearize_src(img)
                img = hook(HookStage.LINEAR, img, rect=hr_main)
                if sig is not None:
                    with profiler.span("render.linearize"):
                        img = ops_color.sigmoidize(img, sig)
                    img = hook(HookStage.SIGMOID, img, rect=hr_main)
            img = hook(HookStage.PRE_KERNEL, img, rect=hr_main)
            # the final sampling crop: every main-stage resize and offset
            # up to here folded in
            crop_eff = crop_with_hooks(crop_eff, img)
            if not needs_scale and (
                    crop_eff.x0 or crop_eff.y0 or
                    abs(crop_eff.h - dst_h) > 1e-6 or
                    abs(crop_eff.w - dst_w) > 1e-6):
                needs_scale = True
                _, _, _, scaler, cfg_down, antiring = scale_plan(
                    crop_probe, needs=True)
            if needs_scale:
                with profiler.span("render.scale"):
                    if scaler.polar:
                        img = ops_polar.sample_polar(
                            img, scaler, dst_h, dst_w, crop_eff,
                            antiring=antiring)
                        if alpha is not None:
                            alpha = ops_polar.sample_polar(
                                alpha, scaler, dst_h, dst_w, crop_eff)
                    else:
                        img = ops_sampling.resize_separable(
                            img, dst_h, dst_w, scaler, crop_eff,
                            cfg_down=cfg_down, antiring=antiring)
                        if alpha is not None:
                            alpha = ops_sampling.resize_separable(
                                alpha, dst_h, dst_w, scaler, crop_eff,
                                cfg_down=cfg_down)
            img = hook(HookStage.POST_KERNEL, img)
            if sig is not None:
                with profiler.span("render.linearize"):
                    img = ops_color.desigmoidize(img, sig)
            img = hook(HookStage.SCALED, img)
            if params.cone is not None:
                img = ops_color.cone_distort(img, src_color, params.cone,
                                             already_linear=use_linear)
            new_state = peak_state
            if need_color_map:
                if not use_linear and fused_front is None:
                    with profiler.span("render.linearize"):
                        img = linearize_src(img)
                with profiler.span("render.tail"):
                    if fused_tail is not None:
                        # with allow_delayed, K1 measures this frame's
                        # peak partials while it tone-maps with the
                        # previous frames' stats, which the tail reads
                        # from the state; else the stats are this frame's
                        stats = delayed = None
                        if use_peak and fused_tail.fused_peak:
                            delayed = peak_state
                        elif use_peak:
                            avg_pq, max_pq, new_state = \
                                ops_peak.applied_stats(
                                    img, peak_state, params.peak_detect,
                                    src_max_pq)
                            stats = (avg_pq, max_pq)
                        img, packed = fused_tail(img, stats, state=delayed)
                        if packed is not None:
                            _, _, new_state = ops_peak.finish_from_packed(
                                packed, peak_state, params.peak_detect)
                        k1_tails += 1
                    else:
                        stats = None
                        if use_peak:
                            avg_pq, max_pq, new_state = \
                                ops_peak.applied_stats(
                                    img, peak_state, params.peak_detect,
                                    src_max_pq)
                            stats = (avg_pq, max_pq)
                        img = color_map_stage(img, src_color, dst_color,
                                              params, stats)
                        img = delinearize_to(img, dst_color)
                        if tail_eligible:
                            plain_tails += 1
                        else:
                            ineligible_tails += 1
            elif use_linear:
                with profiler.span("render.linearize"):
                    img = delinearize_to(img, src_color)
            img = hook(HookStage.PRE_OUTPUT, img)
            if fused_tail is None:
                with profiler.span("render.encode"):
                    if params.lut is not None and \
                            params.lut_type == "conversion":
                        img = ops_lut.apply_lut(img, params.lut)
                    img = ops_color.encode_color(img, target.repr,
                                                 dst_color.primaries)
            img = hook(HookStage.OUTPUT, img)
            with profiler.span("render.output"):
                if alpha is not None:
                    if target.repr.alpha == AlphaMode.PREMULTIPLIED:
                        img = img * alpha
                    img = torch.cat([img, alpha], dim=-3)
                if distort_plan is not None:
                    img = ops_distort.distort_image(
                        img, dst_w, dst_h, params.distort, distort_plan)
                comps = img.shape[-3]
                if border is not None:
                    # composite into the whole target (reference
                    # clear_target, renderer.c:2491)
                    if border == "blur":
                        canvas = self._blur_border(params, img, target.h,
                                                   target.w)
                    else:
                        canvas = plan_image(("canvas", comps), lambda: (
                            torch.zeros((comps, target.h, target.w),
                                        device=self.device)
                            if border == "skip" else self._background(
                                params, comps, target.h, target.w,
                                self.device, mode=border))).clone()
                    img = _paste(canvas, img, y0, x0)
                if params.corner_rounding > 0:
                    mask = plan_image(("corners",), lambda: _corner_mask(
                        params.corner_rounding, target.h, target.w,
                        self.device))
                    bg = plan_image(("background", comps), lambda:
                                    self._background(params, comps,
                                                     target.h, target.w,
                                                     self.device))
                    img = fma(img - bg, mask, bg)
                # error diffusion needs the whole encoded frame, so it
                # runs after the tail, which then leaves out the ordered
                # dither
                if quantize and (fused_tail is None or
                                 params.error_diffusion):
                    if params.error_diffusion:
                        img = ops_dither.error_diffusion(
                            img, target.bit_depth, ed_kernel)
                    elif dp is not None:
                        h, w = img.shape[-2], img.shape[-1]
                        bias = plan_image(("bias", h, w), lambda:
                                          torch.from_numpy(
                                              ops_dither.bias_matrix(
                                                  dp, h, w, dither_phase)
                                          ).to(self.device))
                        img = ops_dither.dither(img, target.bit_depth, dp,
                                                frame_index=dither_phase,
                                                bias=bias)
                if params.blend is not None and \
                        inputs.target_data is not None:
                    img = self._blend_target(img, inputs.target_data,
                                             params.blend)
                # overlays (subtitles, OSD) blend after the dither, like
                # the reference's final vertex pass
                for (ov, is_tgt), ov_data in zip(overlays,
                                                 inputs.overlay_datas):
                    img = self._blend_overlay(img, ov_data, ov, is_tgt,
                                              target, dst_color, params,
                                              crop, dst_crop, rotation,
                                              frame_hw)
                img = torch.clamp(img, 0.0, 1.0)
            hs_out = ()
            if hook_state_specs:
                # a disabled or skipped hook carries its state through
                hs_out = tuple(
                    hstates[h.signature][1].get(n, hstates[h.signature][0][n])
                    for h, names in hook_state_specs for n in names)
            return img, new_state, hs_out

        # the front this signature takes on the card (None: the plain
        # stages there too)
        pipeline.front = front_plan
        return pipeline

    @staticmethod
    def _blend_target(src, dst, blend):
        """`src` over the target's contents `dst` with the (src_rgb,
        dst_rgb, src_alpha, dst_alpha) factors of reference
        pl_blend_params (gpu.h:1145-1158)."""
        src_rgb_f, dst_rgb_f, src_a_f, dst_a_f = blend
        has_a = src.shape[-3] > 3
        sa = src[..., 3:4, :, :] if has_a else \
            torch.ones_like(src[..., :1, :, :])
        dst_has_a = dst.shape[-3] > 3

        def factor(name, a):
            if name == "zero":
                return 0.0
            if name == "one":
                return 1.0
            if name == "src_alpha":
                return a
            if name == "one_minus_src_alpha":
                return 1.0 - a
            raise ValueError(f"unknown blend factor {name!r}")

        out_rgb = fma(src[..., :3, :, :], factor(src_rgb_f, sa),
                      dst[..., :3, :, :] * factor(dst_rgb_f, sa))
        if has_a or dst_has_a:
            da = dst[..., 3:4, :, :] if dst_has_a else torch.ones_like(sa)
            out_a = fma(sa, factor(src_a_f, sa), da * factor(dst_a_f, sa))
            return torch.cat([out_rgb, out_a], dim=-3)
        return out_rgb

    @staticmethod
    def _blur_border(params: RenderParams, img, th: int, tw: int):
        """border="blur": a blurred copy of the image stretched to cover
        the target (reference PL_CLEAR_BLUR, pass_blur renderer.c:2345):
        halve it with bilinear as many times as the reference's
        dual-filter pyramid has passes, then one cover-resize, the
        overflow cropped about the center."""
        radius = max(params.blur_radius, 1e-3)
        a_max = 1.8
        passes = int(math.ceil(
            math.log(1.0 + radius * radius / (a_max * a_max)) /
            math.log(4.0)))
        passes = min(max(passes, 2), 10)
        x = img
        for _ in range(passes):
            nh = max(1, x.shape[-2] // 2)
            nw = max(1, x.shape[-1] // 2)
            x = ops_sampling.sample_bilinear(x, nh, nw)
            if nh == 1 and nw == 1:
                break
        sh, sw = x.shape[-2], x.shape[-1]
        scale = max(th / sh, tw / sw)
        crop_h, crop_w = th / scale, tw / scale
        cy, cx = sh / 2, sw / 2
        rect = RectF(cx - crop_w / 2, cy - crop_h / 2,
                     cx + crop_w / 2, cy + crop_h / 2)
        return ops_sampling.resize_separable(x, th, tw,
                                             _find_scaler("bilinear"), rect)

    @staticmethod
    def _background(params: RenderParams, comps: int, h: int, w: int,
                    device, mode: Optional[str] = None):
        """The border fill on `device`: a solid color (alpha 1 minus the
        transparency) or the checkerboard of tile_colors (alpha 1)."""
        if (mode or params.background) == "tiles":
            ts = params.tile_size
            yy, xx = np.meshgrid(np.arange(h) // ts, np.arange(w) // ts,
                                 indexing="ij")
            sel = ((yy + xx) % 2).astype(np.float32)
            c0 = np.asarray(params.tile_colors[0], np.float32)
            c1 = np.asarray(params.tile_colors[1], np.float32)
            tiles = c0[:, None, None] * (1 - sel) + c1[:, None, None] * sel
            if comps > 3:
                tiles = np.concatenate(
                    [tiles, np.ones((comps - 3, h, w), np.float32)])
            return torch.from_numpy(
                np.ascontiguousarray(tiles[:comps])).to(device)
        col = np.zeros(comps, np.float32)
        col[:3] = np.asarray(params.background_color, np.float32)[:3]
        if comps > 3:
            col[3] = 1.0 - params.background_transparency
        return torch.from_numpy(col).to(device)[:, None, None].expand(
            comps, h, w).contiguous()

    @staticmethod
    def overlay_is_simple(ov) -> bool:
        """The whole-texture-at-target-rect shorthand: normal mode, auto
        coords, no parts, no encoding of its own."""
        return (ov.mode == "normal" and ov.coords == "auto"
                and not ov.parts and ov.rect is not None
                and ov.repr.sys in (ColorSystem.UNKNOWN, ColorSystem.RGB)
                and ov.repr.levels in (ColorLevels.UNKNOWN,
                                       ColorLevels.FULL)
                and ov.repr.alpha != AlphaMode.PREMULTIPLIED
                and ov.color == ColorSpace())

    @staticmethod
    def _overlay_rect_map(coords: str, is_target: bool, crop: RectF,
                          dst_crop: RectF, rotation: int,
                          frame_w: int, frame_h: int, target: Target):
        """The map from an overlay part's coordinates to the target's,
        and the content rotation to apply (reference draw_overlays,
        renderer.c:830-886).  "src_frame" parts lie in the unrotated
        frame and turn with the image; "src_crop" parts are relative to
        the crop, which lies in the rotated image (frames turn before
        they are cropped)."""
        if coords == "auto":
            coords = "dst_frame" if is_target else "src_frame"
        r = int(rotation) % 4
        if coords in ("src_frame", "src_crop"):
            rx = dst_crop.w / (crop.w or 1.0)
            ry = dst_crop.h / (crop.h or 1.0)

            def map_pt(x, y):
                if coords == "src_frame":
                    if r == 1:      # rot90 k=1: (x, y) -> (y, W - x)
                        x, y = y, frame_w - x
                    elif r == 2:
                        x, y = frame_w - x, frame_h - y
                    elif r == 3:
                        x, y = frame_h - y, x
                    u, v = x - crop.x0, y - crop.y0
                else:
                    u, v = x, y
                return (dst_crop.x0 + rx * u, dst_crop.y0 + ry * v)
            return map_pt, (r if coords == "src_frame" else 0)
        tcrop = (target.crop or RectF(0, 0, target.w, target.h)).normalized()
        ox = tcrop.x0 if coords == "dst_crop" else 0.0
        oy = tcrop.y0 if coords == "dst_crop" else 0.0
        return (lambda x, y: (x + ox, y + oy)), 0

    @staticmethod
    def _overlay_to_target(rgb, ov, target: Target, dst_color, params):
        """An overlay's color in the target's encoding: decode ->
        linearize -> primaries matrix -> clip into the target's range ->
        (ICC or) delinearize -> encode (the reference's OSD color map,
        renderer.c:962-991); unchanged when the overlay has no encoding
        of its own."""
        plain_repr = (ov.repr.sys in (ColorSystem.UNKNOWN, ColorSystem.RGB)
                      and ov.repr.levels in (ColorLevels.UNKNOWN,
                                             ColorLevels.FULL))
        if plain_repr and ov.color == ColorSpace() and target.icc is None:
            return rgb
        ol_color, _ = color_space_infer_map(ov.color, dst_color)
        x = ops_color.decode_color(rgb, ov.repr, ol_color.primaries)
        lin = ops_color.linearize(x, ol_color)
        if ol_color.primaries != dst_color.primaries:
            lin = ops_color.mat_pointwise(lin, color_mapping_matrix(
                primaries_get(ol_color.primaries),
                primaries_get(dst_color.primaries)).m)
        _, hi = ops_color.nominal_luma_norm(dst_color)
        lin = torch.clamp(lin, 0.0, hi)
        if target.icc is not None:
            sig = ops_icc.encode_profile(
                lin, target.icc, primaries_get(dst_color.primaries),
                **ops_icc.params_kwargs(params, encode=True))
        else:
            sig = ops_color.delinearize(lin, dst_color)
        return ops_color.encode_color(sig, target.repr, dst_color.primaries)

    @classmethod
    def _blend_overlay(cls, img, ov_data, ov, is_target: bool,
                       target: Target, dst_color, params, crop: RectF,
                       dst_crop: RectF, rotation: int, frame_hw):
        """Draw one overlay: each part mapped to target coordinates,
        clipped to the canvas, its texture region resized bilinearly,
        color-converted and alpha-blended over the output (reference
        draw_overlays, renderer.c:811-1025).  A monochrome bitmap's first
        channel is the coverage painted by the part's color."""
        frame_h, frame_w = frame_hw
        parts = ov.get_parts()
        # the bare-rect shorthand with coords left "auto" is in target
        # coordinates; an explicit coords choice wins
        coords = "dst_frame" if (not ov.parts and ov.rect is not None
                                 and ov.coords == "auto") else ov.coords
        map_pt, rot_c = cls._overlay_rect_map(
            coords, is_target, crop, dst_crop, rotation, frame_w, frame_h,
            target)
        th, tw = img.shape[-2], img.shape[-1]
        premul = ov.repr.alpha == AlphaMode.PREMULTIPLIED
        tex_h, tex_w = ov_data.shape[-2], ov_data.shape[-1]
        for part in parts:
            d = RectF(*map_pt(part.dst.x0, part.dst.y0),
                      *map_pt(part.dst.x1, part.dst.y1)).normalized()
            x0, y0 = int(round(d.x0)), int(round(d.y0))
            x1, y1 = int(round(d.x1)), int(round(d.y1))
            if x1 - x0 <= 0 or y1 - y0 <= 0:
                continue
            cx0, cy0 = max(x0, 0), max(y0, 0)    # clip to the canvas
            cx1, cy1 = min(x1, tw), min(y1, th)
            if cx0 >= cx1 or cy0 >= cy1:
                continue
            sr = part.src.normalized()
            sx0 = min(max(int(round(sr.x0)), 0), tex_w - 1)
            sy0 = min(max(int(round(sr.y0)), 0), tex_h - 1)
            sx1 = max(min(int(round(sr.x1)), tex_w), sx0 + 1)
            sy1 = max(min(int(round(sr.y1)), tex_h), sy0 + 1)
            tex = ov_data[..., sy0:sy1, sx0:sx1]
            if rot_c:
                tex = torch.rot90(tex, rot_c, dims=(-2, -1))
            ov_img = ops_sampling.sample_bilinear(tex, y1 - y0, x1 - x0)
            ov_img = ov_img[..., cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
            if ov.mode == "monochrome":
                mask = ov_img[..., :1, :, :]
                col = [float(c) for c in part.color]
                rgb = torch.tensor(col[:3], dtype=torch.float32,
                                   device=img.device)[:, None, None].expand(
                    3, cy1 - cy0, cx1 - cx0)
                a = torch.full_like(mask, col[3])
            else:
                rgb = ov_img[..., :3, :, :]
                a = ov_img[..., 3:4, :, :] if ov_img.shape[-3] > 3 else \
                    torch.ones_like(ov_img[..., :1, :, :])
            rgb = cls._overlay_to_target(rgb, ov, target, dst_color, params)
            if ov.mode == "monochrome":
                if premul:
                    rgb = rgb * mask
                a = a * mask
            # reference renderer.c:996-1001: src_rgb ONE if premultiplied
            # else SRC_ALPHA, src_alpha ONE, dst ONE_MINUS_SRC_ALPHA
            region = img[..., cy0:cy1, cx0:cx1]
            src_rgb = rgb if premul else rgb * a
            out = [fma(region[..., :3, :, :], 1 - a, src_rgb)]
            if img.shape[-3] > 3:
                out.append(fma(region[..., 3:, :, :], 1 - a, a))
            # `img` is the pipeline's own tensor: written in place
            region.copy_(torch.cat(out, dim=-3))
        return img

    def _fused_tail(self, params: RenderParams, src_color, dst_color,
                    target: Target, use_peak, dst_w, dst_h, dst_crop,
                    has_alpha=False, dither_phase=0):
        """The fused color tail — kernel K1 — or None when the tail is
        not eligible, in which case the plain stages run.  The gates are
        the reference's (renderer.py:1565-1574); an eligible tail runs
        K1's instance compiled for it (ops/cuda/color_map.py::
        plan_generic; on the card the instance is compiled here,
        k1.prepare), whose plain version is the stages composed here as
        the reference's tail_fn composes them."""
        if not _tail_eligible(params, target, dst_w, dst_h, dst_crop,
                              has_alpha):
            return None
        dither = None
        bit_depth = target.bit_depth
        if bit_depth and params.dither is not None and \
                params.error_diffusion is None and \
                (bit_depth < 16 or params.force_dither):
            dp = _dither_params(params, dst_color)
            gamma_path = bit_depth <= 4 and \
                ops_dither._APPROX_GAMMA.get(dp.transfer, 1.0) != 1.0
            if dp.method == ops_dither.DitherMethod.WHITE_NOISE:
                bias = ops_dither.bias_matrix(dp, dst_h, dst_w, dither_phase)
            else:
                bias = ops_dither.dither_lut(dp, dither_phase)
            dither = (dp, bias, gamma_path)
        fused_peak = bool(use_peak and params.peak_detect.allow_delayed)
        chain = color_chain(src_color, dst_color, params, use_peak)
        fn = params.tone_mapping_function
        static_tp = _static_tone_params(src_color, params, chain) \
            if chain.tone == "static" else None
        show = _show_bounds(src_color, params)
        thresholds = None
        if show is not None and chain.kind == "ipt":
            lo_lin, hi_lin = (float(tf.pq_eotf_fast(torch.tensor(
                v, dtype=torch.float32))) for v in show)
            thresholds = (hi_lin + 1e-6, show[1] + 1e-6,
                          lo_lin - 1e-6, show[0] - 1e-6)

        def plain(img, tone, bias_t):
            tone_fn = None
            if chain.tone == "dynamic":
                vals = list(tone[:len(ops_tone.TONE_KEYS[fn])])
                tone_fn = lambda x: ops_tone.tone_apply(  # noqa: E731
                    fn, x, vals, chain.dst_min_pq, chain.dst_max_pq)
            elif chain.tone == "static":
                tone_fn = lambda x: tm.apply_device(  # noqa: E731
                    x, static_tp)
            y = _map_chain(img, chain, tone_fn, params, show)
            y = ops_color.delinearize(y, dst_color)
            y = ops_color.encode_color(y, target.repr, dst_color.primaries)
            if dither is not None:
                h, w = y.shape[-2], y.shape[-1]
                n = bias_t.shape[0]
                full = bias_t if dither[0].method == \
                    ops_dither.DitherMethod.WHITE_NOISE else \
                    bias_t.tile((-(-h // n), -(-w // n)))[:h, :w]
                y = ops_dither.dither(y, bit_depth, dither[0], bias=full)
            return y
        plan = k1.plan_generic(chain, params, src_color, dst_color, target,
                               fused_peak, dither, plain,
                               static_tone=static_tp, show_bounds=thresholds)
        if plan is None:
            return None
        if self.device.type == "cuda":
            # the tail's own instance, compiled now rather than at its
            # first launch (KernelError if it cannot be)
            k1.prepare(plan)
        lut_t = torch.from_numpy(plan.lut).to(self.device) \
            if plan.lut is not None else None
        # the curve's per-frame scalars: on the card one launch a frame
        # (ops/cuda/peak_tone.py), however many 0-dim operations they are
        tone_plan = peak_tone.plan_tone(
            fn, chain.dst_min_pq, chain.dst_max_pq, params.tone_constants,
            hdr_rescale(HdrScaling.NITS, HdrScaling.PQ,
                        src_color.hdr.max_luma)) \
            if chain.tone == "dynamic" else None
        # a white-noise bias is the whole (dst_h, dst_w) frame; any other
        # dither is a square LUT tiled from the frame's origin
        bias_frame = plan.generic.mode.dither == 2

        def run(img, peak_stats, row0: int = 0, state=None):
            """K1 on `img` with a dynamic curve's stats `peak_stats`
            (avg_pq, max_pq), or those an allow_delayed frame takes from
            the peak `state` (ops/peak_detect.py::delayed_stats); `row0`
            is the frame row of img's first row when img is one row
            block of the frame (a sharded render), whose dither then
            reads its own rows of the frame's bias."""
            tone = None
            if tone_plan is not None:
                tone = peak_tone.delayed_tone_vector(tone_plan, state) \
                    if state is not None else \
                    peak_tone.tone_vector(tone_plan, *peak_stats)
                if tone.is_cuda:
                    profiler.count("render.tail_scalars")
            lut_r = lut_t
            if row0 and lut_t is not None:
                lut_r = lut_t[row0:row0 + img.shape[-2]] if bias_frame \
                    else torch.roll(lut_t, -(row0 % lut_t.shape[0]), 0)
                lut_r = lut_r.contiguous()
            return k1.color_map_tail(img.contiguous(), plan, tone, lut_r)
        run.fused_peak = fused_peak
        run.plan, run.lut = plan, lut_t
        return run

    # -- public API ----------------------------------------------------

    def render(self, frame: Frame, target: Target,
               params: Optional[RenderParams] = None) -> torch.Tensor:
        """Render `frame` into a (C, target.h, target.w) tensor on the
        renderer's device, C = 3, or 4 with alpha (reference
        pl_render_image).

        The frame and its fields' neighbor frames are acquired first
        (`Frame.acquire`; a refusal raises RenderError), and each one's
        `release` runs afterwards, after a failure too (reference
        renderer.py:1637-1652); the failure then propagates."""
        params = params or DEFAULT_PARAMS
        acq = [f for f in (frame, frame.prev, frame.next)
               if f is not None and f.acquire is not None]
        with profiler.span("render", frame.seq or profiler.next_seq()):
            try:
                for f in acq:
                    if not f.acquire(f):
                        raise RenderError(
                            "frame acquire() refused the frame")
                return self._render_acquired(frame, target, params)
            finally:
                for f in (frame, frame.prev, frame.next):
                    if f is not None and f.release is not None:
                        f.release(f)

    def _render_acquired(self, frame: Frame, target: Target,
                         params: RenderParams) -> torch.Tensor:
        """`render` after the acquire.

        A render that fails on a plain stage degrades as the reference's
        does: the renderer re-renders without one feature at a time (then
        cumulatively), records the feature in `errors`, logs it, and
        leaves it out of later frames.  The user's errors, a kernel's
        failure and CUDA errors propagate (`_NON_DEGRADABLE`); on the card
        no rung swaps a kernel for its plain version (`_ladder`)."""
        ladder = _ladder(self.device)
        for flag, strip in ladder:
            if flag in self.errors:
                params = strip(params)
        try:
            return self._render_once(frame, target, params)
        except Exception as e:
            if not _degradable(e):
                raise
            first_exc = e
        log = core_log.default_log()
        # one feature at a time, so that a broken stage does not take
        # unrelated features with it
        for flag, strip in ladder:
            stripped = strip(params)
            if stripped.key() == params.key():
                continue
            try:
                out = self._render_once(frame, target, stripped)
            except Exception as e:
                if not _degradable(e):
                    raise
                continue
            self.errors.add(flag)
            log.error(f"render failed ({type(first_exc).__name__}: "
                      f"{first_exc}); disabled {flag!r} and recovered")
            return out
        # a compound failure: strip cumulatively
        flags, cur = [], params
        for flag, strip in ladder:
            stripped = strip(cur)
            if stripped.key() == cur.key():
                continue
            cur = stripped
            flags.append(flag)
            try:
                out = self._render_once(frame, target, cur)
            except Exception as e:
                if not _degradable(e):
                    raise
                continue
            self.errors.update(flags)
            log.error(f"render failed ({type(first_exc).__name__}: "
                      f"{first_exc}); disabled {flags} and recovered")
            return out
        raise first_exc

    def _render_once(self, frame: Frame, target: Target,
                     params: RenderParams) -> torch.Tensor:
        if frame.device != self.device and not (
                frame.device.type == self.device.type == "cuda"):
            raise ValueError(f"frame lives on {frame.device}, the renderer "
                             f"on {self.device}")
        dither_phase = 0
        if params.dither is not None and params.dither.temporal and \
                target.bit_depth and target.bit_depth < 16:
            dither_phase = self._frame_idx % 8
        self._frame_idx += 1
        key = (frame.meta_key(), target.meta_key(), params.key(),
               dither_phase)
        fn = self._cache.pop(key, None)
        if fn is None:
            profiler.count("render.plan_misses")
            with profiler.span("render.plan"):
                fn = self._plan(frame, target, params, dither_phase)
        self._cache[key] = fn
        while len(self._cache) > _MAX_CACHED_PIPELINES:
            self._cache.pop(next(iter(self._cache)))
        with profiler.span("render.inputs"):
            inputs = self._frame_inputs(frame, params, target)
        timed = self.telemetry is not None
        if timed:
            if self.device.type == "cuda":
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
        out, self._peak_state, hs_out = fn(self._peak_state, inputs,
                                           *[p.data for p in frame.planes])
        if hs_out:
            names = [(h.signature, n) for h in params.hooks
                     for n in sorted(getattr(h, "state_spec", None) or ())]
            self._hook_states.update(zip(names, hs_out))
        if timed:
            if self.device.type == "cuda":
                t1 = torch.cuda.Event(enable_timing=True)
                t1.record()
            else:
                t1 = time.perf_counter()
            # recorded one frame late (reference renderer.py:1787-1799):
            # the earlier frames are read now that this one is queued,
            # each once the card has finished it, so the measurement
            # never holds the host back
            self._harvest_telemetry(block=False)
            self._telemetry_pending.append((t0, t1))
        return out

    def _plan(self, frame: Frame, target: Target, params: RenderParams,
              dither_phase: int = 0):
        """The per-frame stage function of `frame`'s signature
        (`_trace_pipeline`), planned anew."""
        return self._trace_pipeline(
            frame.meta_key(), target, params, frame.repr, frame.color,
            frame.get_crop(), frame.film_grain, dither_phase=dither_phase,
            frame_icc=frame.icc, field=frame.field,
            first_field=frame.first_field, rotation=int(frame.rotation),
            overlays=tuple((ov, False) for ov in frame.overlays)
            + tuple((ov, True) for ov in target.overlays))

    def _frame_inputs(self, frame: Frame, params: RenderParams,
                      target: Optional[Target] = None) -> FrameInputs:
        """The per-frame inputs of a plan: grain tables (the seed may
        change every frame; AV1's host generation cached by seed), the
        neighbor frames' planes, the frame's RPU, packed on the host, the
        target's contents and the overlay bitmaps (reference
        renderer.py:1741-1765)."""
        plane_metas = frame.meta_key()[0]
        grain_tables = h274_tables = None
        if params.film_grain and ops_fg.needs_fg(frame.film_grain):
            cfgs, _ = self._grain_cfgs(plane_metas, frame.repr,
                                       frame.film_grain)
            grain_tables = tuple(
                ops_fg.prepare_av1_grain(frame.film_grain, cfg, meta[0][-2],
                                         meta[0][-1], self.device)
                if cfg else None
                for cfg, meta in zip(cfgs, plane_metas))
        if params.film_grain and ops_h274.needs_fg_h274(frame.film_grain):
            h274_tables = ops_h274.prepare_h274(
                frame.film_grain,
                [(() if 3 in mapping else tuple(mapping), shape[-2],
                  shape[-1]) for shape, mapping, _, _ in plane_metas],
                self.device)
        deinterlace = params.deinterlace is not None and \
            frame.field is not None
        dovi_packed = None
        if frame.repr.sys == ColorSystem.DOLBYVISION and \
                frame.repr.dovi is not None:
            dovi_packed = ops_dovi.pack_dovi(frame.repr.dovi)
        target_data = None
        if target is not None and target.data is not None:
            target_data = torch.as_tensor(target.data, dtype=torch.float32,
                                          device=self.device)
        overlays = list(frame.overlays)
        if target is not None:
            overlays += list(target.overlays)
        return FrameInputs(
            grain_tables, h274_tables,
            tuple(p.data for p in frame.prev.planes)
            if deinterlace and frame.prev is not None else None,
            tuple(p.data for p in frame.next.planes)
            if deinterlace and frame.next is not None else None,
            dovi_packed, target_data,
            tuple(torch.as_tensor(o.data, dtype=torch.float32,
                                  device=self.device) for o in overlays),
            self._hook_state_inputs(params))

    def _hook_state_inputs(self, params: RenderParams) -> tuple:
        """The carried values of every stateful hook, in spec order; a
        value whose shape no longer matches its spec starts over from the
        spec (reference renderer.py:1766-1775)."""
        vals = []
        for h in params.hooks:
            spec = getattr(h, "state_spec", None) or {}
            for n in sorted(spec):
                cur = self._hook_states.get((h.signature, n))
                if cur is None or tuple(cur.shape) != np.shape(spec[n]):
                    cur = _state_init(spec[n], self.device)
                vals.append(cur)
        return tuple(vals)

    def _harvest_telemetry(self, block: bool):
        """Record the pending frames' times, oldest first: all of them
        when `block`, else those the card has finished (with
        _MAX_PENDING_TIMINGS pending, the oldest is waited for)."""
        pending = self._telemetry_pending
        if self.telemetry is None:
            pending.clear()
        while pending:
            t0, t1 = pending[0]
            if isinstance(t1, float):
                seconds = t1 - t0
            else:
                if not (block or t1.query() or
                        len(pending) >= _MAX_PENDING_TIMINGS):
                    break
                t1.synchronize()
                seconds = t0.elapsed_time(t1) / 1e3
            pending.pop(0)
            self.telemetry.record("frame", seconds)

    def flush_telemetry(self):
        """Record every pending frame's time (telemetry runs one frame
        late); waits for those the card has not finished."""
        self._harvest_telemetry(block=True)

    def reset_peak_detection(self):
        """Forget the peak-detection state (reference
        pl_renderer_flush_cache's peak reset)."""
        self._peak_state = ops_peak.peak_detect_state_init(self.device)

    def reset_hook_state(self):
        """Drop the hooks' carried state: each starts over from its
        declared value on the next frame."""
        self._hook_states.clear()

    def get_errors(self) -> tuple:
        """(degradation flags, disabled hook signatures): the features
        and hooks disabled after a failure (reference
        pl_renderer_get_errors)."""
        return (frozenset(self.errors), frozenset(self._disabled_hooks))

    def reset_errors(self, errors=None, hooks=None) -> None:
        """Clear degradation flags and disabled hooks so that they are
        tried again (reference pl_renderer_reset_errors): all of them, or
        the named flags and hook signatures."""
        if errors is None and hooks is None:
            self.errors.clear()
            self._disabled_hooks.clear()
            return
        for flag in errors or ():
            self.errors.discard(flag)
        for sig in hooks or ():
            self._disabled_hooks.discard(sig)

    def flush_cache(self):
        """Drop every render plan, the peak state and the hooks' state
        (reference pl_renderer_flush_cache)."""
        self._cache.clear()
        self.reset_peak_detection()
        self.reset_hook_state()

    def get_hdr_metadata(self) -> Optional[HdrMetadata]:
        """The measured HDR metadata of the peak-detection state, None
        before anything was measured (reference
        pl_renderer_get_hdr_metadata).  Reads the state back from the
        device."""
        avg_pq, max_pq = (float(v) for v in self._peak_state.cpu())
        if avg_pq == 0.0:
            return None
        return HdrMetadata(max_pq_y=max_pq, avg_pq_y=avg_pq)

    def save(self) -> bytes:
        """The context's cache serialized (reference pl_renderer_save,
        renderer.py:1860-1867); b"" without a context.  Compiled kernels
        live in the build directory instead
        (runtime.GpuContext.set_disk_cache)."""
        if self.ctx is not None:
            return self.ctx.cache.save()
        return b""

    def load(self, data: bytes) -> int:
        """Restore a blob from `save()` into the context's cache
        (reference pl_renderer_load); the number of objects restored, 0
        without a context."""
        if self.ctx is not None and data:
            return self.ctx.cache.load(data)
        return 0


_default_renderers: Dict[str, Renderer] = {}


def render_image(frame: Frame, target: Target,
                 params: Optional[RenderParams] = None,
                 device=None) -> torch.Tensor:
    """Module-level convenience mirroring pl_render_image, with one
    default Renderer per device (None = "cuda")."""
    dev = resolve_device(device)
    r = _default_renderers.get(str(dev))
    if r is None:
        r = _default_renderers[str(dev)] = Renderer(dev)
    return r.render(frame, target, params)


def frames_infer(frame: Frame, target: Target):
    """(frame', target') with their colorspaces defaulted as
    `Renderer.render` defaults them (reference pl_frames_infer): joint
    inference, unknown target primaries guessed from the target's size.
    The pixel data is shared."""
    dst_raw = target.color
    if dst_raw.primaries == ColorPrimaries.UNKNOWN:
        dst_raw = ColorSpace(primaries_guess(target.w, target.h),
                             dst_raw.transfer, dst_raw.hdr)
    src, dst = color_space_infer_map(frame.color, dst_raw)
    return (replace(frame, color=src),
            replace(target, color=dst))


def frames_infer_mix(mix, target: Target):
    """(target', nearest frame' or None): `frames_infer` against the mix's
    nearest frame, or the target alone for an empty mix (reference
    pl_frames_infer_mix)."""
    ref = frame_mix_nearest(mix)
    if ref is None:
        return replace(
            target, color=target.color.infer(target.w, target.h)), None
    ref2, target2 = frames_infer(ref, target)
    return target2, ref2


def translate_srgb_color(rgb, csp: ColorSpace) -> np.ndarray:
    """An sRGB color encoded in `csp` (reference translate_srgb_color,
    renderer.c:2555): linearized as sRGB (with the target's own curve for
    the SDR gamma family), primaries converted, delinearized with the
    target's transfer.  Host math, on the CPU."""
    csp = csp.infer()
    if csp.transfer in (ColorTransfer.BT_1886, ColorTransfer.SRGB,
                        ColorTransfer.GAMMA22):
        srgb = ColorSpace(ColorPrimaries.BT_709, csp.transfer,
                          HdrMetadata(min_luma=csp.hdr.min_luma))
    else:
        srgb = ColorSpace(CSP_SRGB.primaries, CSP_SRGB.transfer,
                          HdrMetadata(min_luma=COLOR_HDR_BLACK))
    col = np.asarray(rgb, np.float32)[:3].reshape(3, 1, 1)
    lin = ops_color.linearize(torch.from_numpy(col), srgb).numpy()
    m = color_mapping_matrix(primaries_get(srgb.primaries),
                             primaries_get(csp.primaries)).m
    lin = (m.astype(np.float64) @ lin.reshape(3, 1)).reshape(3, 1, 1)
    out = ops_color.delinearize(
        torch.from_numpy(lin.astype(np.float32)), csp).numpy()
    return out.reshape(3)


def _to_target_repr(enc, target: Target):
    """Full-range RGB values in the target's representation."""
    if target.repr.sys != ColorSystem.RGB:
        tr, _ = color_repr_decode(target.repr)
        minv = np.linalg.inv(tr.mat.m.astype(np.float64))
        return (minv @ (enc - tr.c)).astype(np.float32)
    return enc


def clear_target(target: Target, rgba=(0.0, 0.0, 0.0, 0.0),
                 device=None) -> torch.Tensor:
    """A solid fill in the target's encoding, (C, h, w) on `device` (None
    = "cuda"), for `Target.data` (reference pl_frame_clear_rgba): `rgba`
    is an sRGB color translated into the target's colorspace and repr;
    the alpha channel is left out when the target's alpha mode is
    NONE."""
    comps = 4 if target.repr.alpha != AlphaMode.NONE else 3
    enc = _to_target_repr(translate_srgb_color(rgba, target.color), target)
    a = float(rgba[3]) if len(rgba) > 3 else 1.0
    mult = a if target.repr.alpha == AlphaMode.PREMULTIPLIED else 1.0
    col = np.concatenate([mult * enc, [a]])[:comps].astype(np.float32)
    return torch.from_numpy(col).to(resolve_device(device))[
        :, None, None].expand(comps, target.h, target.w)


def clear_target_tiles(target: Target,
                       tile_colors=((0.93, 0.93, 0.93), (0.87, 0.87, 0.87)),
                       tile_size: int = 32, device=None) -> torch.Tensor:
    """A checkerboard of two sRGB colors in the target's encoding, (3, h,
    w) on `device` (reference pl_frame_clear_tiles)."""
    encs = [_to_target_repr(translate_srgb_color(tuple(c) + (1.0,),
                                                 target.color), target)
            for c in tile_colors]
    yy, xx = np.meshgrid(np.arange(target.h) // tile_size,
                         np.arange(target.w) // tile_size, indexing="ij")
    sel = ((yy + xx) % 2).astype(np.float32)
    c0 = np.asarray(encs[0], np.float32)[:, None, None]
    c1 = np.asarray(encs[1], np.float32)[:, None, None]
    return torch.from_numpy(c0 * (1 - sel) + c1 * sel).to(
        resolve_device(device))


# ---------------------------------------------------------------------------
# Frame mixing (reference pl_render_image_mix, renderer.c:3612)
# ---------------------------------------------------------------------------

def _mix_weights(params: RenderParams, timestamps, vsync_duration: float):
    """The frame mixer's weights at the frames' timestamps (vsyncs from
    the target's pts), normalized: "oversample" weighs the two frames
    around the vsync by their coverage of it (SmoothMotion); a filter
    config samples its kernel, the nearest frame alone when none is in
    reach."""
    cfg = _find_scaler(params.frame_mixer)
    ts = np.asarray(timestamps, dtype=np.float64)
    if cfg.name == "oversample":
        w = np.zeros(len(ts))
        if len(ts) == 1:
            w[0] = 1.0
        else:
            later = np.argmax(ts > 0) if np.any(ts > 0) else len(ts) - 1
            t1 = ts[later]
            ratio = np.clip(0.5 - t1 / max(vsync_duration, 1e-9), 0.0, 1.0) \
                if vsync_duration else (1.0 if t1 <= 0 else 0.0)
            w[later] = 1.0 - ratio if t1 > 0 else 1.0
            if later > 0:
                w[later - 1] = 1.0 - w[later]
    else:
        radius = cfg.radius_bound()
        w = flt.sample_filter(cfg, np.abs(ts) / max(radius, 1e-9) * radius)
        w = np.where(np.abs(ts) <= radius, w, 0.0)
        if w.sum() <= 0:
            w = np.zeros(len(ts))
            w[np.argmin(np.abs(ts))] = 1.0
    return (w / w.sum()).astype(np.float32)


def render_image_mix(renderer: Renderer, mix, target: Target,
                     params: Optional[RenderParams] = None) -> torch.Tensor:
    """Blend a FrameMix window into the target (reference
    pl_render_image_mix): each frame renders once, undithered, into an
    intermediate cached by its signature; the output is the weighted sum,
    dithered to the target's depth.  The intermediates keep the target's
    geometry and colorspace but not its overlays, contents or ICC
    profile, as in the reference."""
    params = params or DEFAULT_PARAMS
    inter_target = Target(w=target.w, h=target.h, repr=target.repr,
                          color=target.color, bit_depth=0,
                          crop=target.crop)
    inter_params = replace(params, dither=None, error_diffusion=None)
    pkey = (inter_target.meta_key(), inter_params.key())
    if not params.preserve_mixing_cache:
        # cached intermediates go stale when the params change
        for k in [k for k in renderer._mix_cache if k[1:] != pkey]:
            renderer._mix_cache.pop(k)
    # a lone frame is shown as it is: not cached with skip_caching_...
    cache_ok = len(mix.frames) > 1 or not params.skip_caching_single_frame
    rendered = []
    for frame in mix.frames:
        key = (frame.signature or id(frame),) + pkey
        img = renderer._mix_cache.get(key)
        if img is None:
            img = renderer.render(frame, inter_target, inter_params)
            if cache_ok:
                renderer._mix_cache[key] = img
                cap = max(16, 2 * len(mix.frames))
                while len(renderer._mix_cache) > cap:
                    renderer._mix_cache.pop(next(iter(renderer._mix_cache)))
        rendered.append(img)
    out = None
    for wi, img in zip(_mix_weights(params, mix.timestamps,
                                    mix.vsync_duration), rendered):
        if wi == 0.0:
            continue
        term = img * float(wi)
        out = term if out is None else out + term
    if out is None:
        out = rendered[0]
    if target.bit_depth and params.dither is not None:
        h, w = out.shape[-2], out.shape[-1]
        bias_key = (params.dither, h, w)
        if bias_key not in renderer._mix_bias:
            # made and uploaded once: an upload from pageable memory
            # would hold the host until the card is done
            renderer._mix_bias = {bias_key: torch.from_numpy(
                ops_dither.bias_matrix(params.dither, h, w)).to(out.device)}
        out = ops_dither.dither(out, target.bit_depth, params.dither,
                                bias=renderer._mix_bias[bias_key])
    return torch.clamp(out, 0.0, 1.0)

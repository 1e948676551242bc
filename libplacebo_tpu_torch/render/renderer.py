"""The renderer: frame -> target image.

Counterpart of libplacebo_tpu/render/renderer.py for the ported paths,
keeping the reference package's stage order (`_trace_pipeline`): per
plane deinterlacing, deband, H.274 and AV1 film grain -> merge planes
(bilinear chroma alignment) -> decode (Dolby Vision's reshaping with the
frame's RPU) -> linearize (and sigmoidize, for SDR sources) -> main
scaler (EWA or separable, with anti-ringing) -> desigmoidize -> the
color-map tail -> affine distortion -> dither or error diffusion
(kernels K3, K2, K3) -> finish the peak state, with a native custom LUT
after the decode and, with ICC profiles, the frame's decoding the source
and the target's encoding the output.  The tail runs on kernel K1
(tone + gamut + delinearize + encode, with the peak partials, and the
dither unless error diffusion quantizes) wherever the reference's
kernel would run it (a templated instance or the generic one,
`ops/cuda/color_map.py`), and as plain stages where the reference runs
it plain too (an ICC target, a conversion LUT, a distortion);
`k1_tails`, `plain_tails` and `ineligible_tails` count which ran.
Planning (color inference, boundary fits, filter weights, K1's packed
constants, deband's random tables, the distortion's inverse map)
happens once per signature on the host and is cached; the per-frame
inputs (`FrameInputs`) are not: the grain tables (AV1's generated on
the host, cached by seed as the reference caches them; H.274's block
hash) uploaded every frame, the neighbor frames of a field, and the
frame's Dolby Vision RPU, packed on the host.  PyTorch then runs the
stages eagerly.  Every parameter outside the ported slices raises
NotImplementedError naming the ROADMAP item that ports it —
nothing silently takes another path.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core import filters as flt
from ..core.colorspace import (COLOR_SDR_WHITE, ColorLevels, ColorPrimaries,
                               ColorRepr, ColorSpace, ColorSystem,
                               ColorTransfer, HdrScaling,
                               color_mapping_matrix, color_space_infer_map,
                               hdr_rescale, levels_guess, primaries_clip,
                               primaries_compatible, primaries_get,
                               primaries_guess, system_is_ycbcr_like)
from ..core.common import RectF
from ..core.dither import find_error_diffusion_kernel
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
from ..ops.deband import DebandParams
from ..ops.dithering import DitherParams
from ..ops.peak_detect import PeakDetectParams
from ..utils.device import resolve_device
from .frame import Frame, icc_key

__all__ = ["RenderParams", "Target", "Renderer", "render_image",
           "RenderError", "FrameInputs", "ColorChain", "color_chain",
           "color_map_stage", "k1_tails", "plain_tails", "ineligible_tails"]

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
    neighbor frames' planes of a field, and the packed Dolby Vision
    RPU."""
    grain_tables: Optional[tuple] = None
    h274_tables: Optional[tuple] = None
    prev_planes: Optional[tuple] = None
    next_planes: Optional[tuple] = None
    dovi_packed: Optional[ops_dovi.DoviPacked] = None


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
    data: Optional[object] = field(default=None, compare=False)
    overlays: tuple = field(default=(), compare=False)

    def meta_key(self):
        return (self.w, self.h, self.repr.sys, self.repr.levels,
                self.repr.bits, self.color.primaries, self.color.transfer,
                self.color.hdr, self.bit_depth, self.crop,
                icc_key(self.icc))


@dataclass(frozen=True)
class RenderParams:
    """The reference's RenderParams fields the main path reads, plus the
    ones whose non-default values lie outside this slice (they raise)."""
    upscaler: str = "lanczos"
    downscaler: str = "hermite"
    plane_upscaler: Optional[str] = "bilinear"
    plane_downscaler: Optional[str] = None
    correct_subpixel_offsets: bool = False
    antiringing_strength: float = 0.0
    linear_scaling: bool = True
    sigmoid: Optional[Tuple[float, float]] = (0.75, 6.5)
    dither: Optional[DitherParams] = field(default_factory=DitherParams)
    error_diffusion: Optional[str] = None
    disable_dither_gamma_correction: bool = False
    tone_mapping_function: str = "spline"
    tone_map_metadata: str = "any"
    gamut_mapping: str = "perceptual"
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
    contrast_recovery: float = 0.0
    inverse_tone_mapping: bool = False
    gamut_expansion: bool = False
    show_clipping: bool = False
    visualize_lut: bool = False
    cone: Optional[object] = None
    # ops.distort.DistortParams: affine distortion of the output
    distort: Optional[ops_distort.DistortParams] = None
    blend: Optional[Tuple[str, str, str, str]] = None
    color_adjustment: Optional[object] = None
    corner_rounding: float = 0.0
    hooks: Tuple = ()
    lut: Optional[object] = None          # core.lut.CustomLut
    lut_type: str = "conversion"          # native | conversion
    ignore_icc_profiles: bool = False
    force_dither: bool = False
    disable_linear_scaling: bool = False
    disable_fused_colormap: bool = False

    def key(self):
        return tuple(getattr(self, f) for f in self.__dataclass_fields__
                     if f not in ("hooks", "lut")) + (
            self.lut.signature if self.lut is not None else None,)


def _outside(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP {item})")


def _check_slice(params: RenderParams, target: Target, frame: Frame):
    """Raise for every requested feature outside the ported slice."""
    checks = (
        (params.hooks, "user hooks", "slice 3 item 22"),
        (params.cone is not None, "cone distortion", "slice 3 item 21"),
        (params.blend is not None or target.data is not None,
         "target blending", "slice 3 item 21"),
        (target.overlays or frame.overlays, "overlays", "slice 3 item 21"),
        (frame.rotation % 4, "frame rotation", "slice 3 item 21"),
        (params.color_adjustment is not None, "color adjustment",
         "slice 3 item 21"),
        (params.corner_rounding > 0, "corner rounding", "slice 3 item 21"),
        (params.contrast_recovery > 0, "contrast recovery",
         "slice 3 item 21"),
        (params.visualize_lut, "tone-curve visualization",
         "slice 3 item 21"),
        (any(3 in p.component_mapping for p in frame.planes),
         "alpha planes", "slice 3 item 21"),
    )
    for bad, what, item in checks:
        if bad:
            raise _outside(what, item)


def _find_scaler(name: str) -> flt.FilterConfig:
    """The named filter config, as the reference resolves it
    (`find_filter_config` with its default usage, every use allowed)."""
    cfg = flt.find_filter_config(name)
    if cfg is None:
        raise ValueError(f"unknown filter: {name}")
    return cfg


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
                    params: RenderParams, peak_stats=None):
    """Linear-light conversion: tone + gamut mapping through one IPT
    round trip (reference pl_shader_color_map_ex).  `peak_stats` =
    (avg_pq, max_pq) 0-dim tensors drive the dynamic tone curve;
    without them the curve is the static one from the metadata
    (core/tone_mapping.apply_device)."""
    chain = color_chain(src, dst, params, peak_stats is not None)
    tone_fn = None
    if chain.tone == "dynamic":
        avg_pq, max_pq = peak_stats
        tone_fn = lambda x: ops_tone.tone_map_dynamic(  # noqa: E731
            x, params.tone_mapping_function, src_max=max_pq,
            src_avg=avg_pq, dst_min=chain.dst_min_pq,
            dst_max=chain.dst_max_pq, constants=params.tone_constants)
    elif chain.tone == "static":
        tp = _static_tone_params(src, params, chain)
        tone_fn = lambda x: tm.apply_device(x, tp)  # noqa: E731
    return _map_chain(img, chain, tone_fn, params, _show_bounds(src, params))


def _dither_params(params: RenderParams, dst_color: ColorSpace):
    dp = replace(params.dither, transfer=dst_color.transfer) \
        if params.dither.transfer == ColorTransfer.UNKNOWN else params.dither
    if params.disable_dither_gamma_correction:
        dp = replace(dp, transfer=ColorTransfer.LINEAR)
    return dp


def _tail_eligible(params: RenderParams, target: Target, dst_w, dst_h,
                   dst_crop) -> bool:
    """The reference's gates for its fused tail (renderer.py:1565-1574):
    a pointwise tail over the whole target."""
    return (not params.disable_fused_colormap
            and not params.hooks and target.icc is None
            and params.distort is None and not params.visualize_lut
            and (params.lut is None or params.lut_type != "conversion")
            and (dst_w, dst_h) == (target.w, target.h)
            and int(round(dst_crop.x0)) == 0 == int(round(dst_crop.y0))
            and params.corner_rounding <= 0
            and params.contrast_recovery == 0.0
            and dst_w % 128 == 0)


class Renderer:
    """Holds the plan cache and the temporal state carried across
    frames: the peak-detection state (2,) on the device and the frame
    index that rotates a temporal dither."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, object] = {}
        self._peak_state = ops_peak.peak_detect_state_init(self.device)
        self._frame_idx = 0

    @staticmethod
    def _ref_plane_index(plane_metas):
        ref_i, best = 0, -1
        for i, (shape, mapping, sx, sy) in enumerate(plane_metas):
            if 0 in mapping and shape[-2] * shape[-1] > best:
                best = shape[-2] * shape[-1]
                ref_i = i
        return ref_i

    def _merge_planes(self, planes, plane_metas, params: RenderParams,
                      deband=None, grain=None, fields=None, h274=None):
        """Per-plane deinterlacing, deband and film grain, then alignment
        of every plane to the reference plane's grid and channel stacking
        (reference pass_read_image, renderer.c:1553, and _merge_planes,
        renderer.py:639-681: deinterlace -> plane_deband -> H.274 grain
        -> AV1 grain -> sampler).  `fields` is None or (field, first
        field, the previous frame's planes or None, the next's or None);
        `deband` holds per plane None or (DebandParams, neutral values,
        random tables); `h274` is None or (the grain data, per-plane
        H274Tables or None, whether the system is YCbCr-like); `grain`
        is None or (per-plane GrainCfg or None, the frame's AV1 grain
        tables, scaling shift).  Chroma grain scales with the frame's
        input luma, not the processed one."""
        ref_i = self._ref_plane_index(plane_metas)
        H, W = planes[ref_i].shape[-2], planes[ref_i].shape[-1]
        ref_mapping = plane_metas[ref_i][1]
        luma_full = planes[ref_i][..., ref_mapping.index(0), :, :] \
            if 0 in ref_mapping else None
        up_cfg = _find_scaler(params.plane_upscaler or params.upscaler)
        down_cfg = _find_scaler(params.plane_downscaler or params.downscaler)
        channels = {}
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
            if (ph, pw) == (H, W) and (sx or sy) and \
                    not params.correct_subpixel_offsets:
                pass    # a same-size subpixel siting snaps to the texel
            elif (ph, pw) != (H, W) or sx or sy:
                cfg = down_cfg if (ph > H or pw > W) else up_cfg
                s0x = -sx * pw / W
                s0y = -sy * ph / H
                rect = RectF(s0x, s0y, s0x + pw, s0y + ph)
                antiring = params.antiringing_strength or cfg.antiring
                if cfg.polar:
                    data = ops_polar.sample_polar(data, cfg, H, W, rect,
                                                  antiring=antiring)
                else:
                    data = ops_sampling.resize_separable(
                        data, H, W, cfg, rect, antiring=antiring)
            for ci, ch in enumerate(mapping):
                channels[ch] = data[..., ci, :, :]
        order = sorted(channels)
        return torch.stack([channels[c] for c in order], dim=-3)

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
                        frame_icc=None, field=None, first_field=None):
        """Plan one signature on the host and return the per-frame stage
        function pipeline(peak_state, inputs: FrameInputs, *planes) ->
        (image, new_state)."""
        if params.ignore_icc_profiles:
            # both ends fall back to their colorimetric metadata
            frame_icc = None
            target = replace(target, icc=None)
        plane_metas = frame_meta_key[0]
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
        if (dst_w, dst_h) != (target.w, target.h) or x0 or y0:
            raise _outside("target crops with border fill", "slice 3 item 21")
        src_w, src_h = crop.x1 - crop.x0, crop.y1 - crop.y0
        needs_scale = (abs(src_h - dst_h) > 1e-6 or abs(src_w - dst_w) > 1e-6
                       or crop.x0 != 0 or crop.y0 != 0)
        upscaling = dst_w > src_w or dst_h > src_h
        use_linear = (params.linear_scaling and needs_scale
                      and not params.disable_linear_scaling)
        sig = ops_color.SigmoidParams(*params.sigmoid) \
            if use_linear and params.sigmoid is not None and \
            not src_color.is_hdr() else None
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
                                          dst_crop, dither_phase)
        src_max_pq = hdr_rescale(HdrScaling.NITS, HdrScaling.PQ,
                                 src_color.hdr.max_luma)
        scaler = cfg_down = None
        if needs_scale:
            scaler = _find_scaler(params.upscaler if upscaling
                                  else params.downscaler)
            cfg_down = _find_scaler(params.downscaler)
            antiring = params.antiringing_strength or scaler.antiring
        dp = _dither_params(params, dst_color) if params.dither else None
        quantize = target.bit_depth and (target.bit_depth < 16 or
                                         params.force_dither)
        # an unknown kernel name diffuses with Floyd-Steinberg, as in the
        # reference
        ed_kernel = find_error_diffusion_kernel(params.error_diffusion) \
            if params.error_diffusion else None

        tail_eligible = need_color_map and _tail_eligible(
            params, target, dst_w, dst_h, dst_crop)
        # the distortion's inverse map, once a plan (a singular transform
        # raises RenderError here)
        distort_plan = ops_distort.plan_distort(
            dst_h, dst_w, dst_w, dst_h, params.distort, self.device) \
            if params.distort is not None else None

        def pipeline(peak_state, inputs: FrameInputs, *planes):
            global k1_tails, plain_tails, ineligible_tails
            grain = (grain_cfgs, inputs.grain_tables, scaling_shift) \
                if grain_cfgs is not None else None
            h274 = (h274_grain, inputs.h274_tables, is_ycbcr) \
                if h274_grain is not None else None
            fields = (field, first_field or field, inputs.prev_planes,
                      inputs.next_planes) if deinterlace else None
            img = self._merge_planes(planes, plane_metas, params, deband,
                                     grain, fields, h274)
            img = ops_color.decode_color(img, frame_repr,
                                         src_color.primaries,
                                         dovi_packed=inputs.dovi_packed)
            if params.lut is not None and params.lut_type == "native":
                img = ops_lut.apply_lut(img, params.lut)
            if use_linear:
                img = linearize_src(img)
                if sig is not None:
                    img = ops_color.sigmoidize(img, sig)
            if scaler is not None:
                if scaler.polar:
                    img = ops_polar.sample_polar(img, scaler, dst_h, dst_w,
                                                 crop, antiring=antiring)
                else:
                    img = ops_sampling.resize_separable(
                        img, dst_h, dst_w, scaler, crop, cfg_down=cfg_down,
                        antiring=antiring)
            if sig is not None:
                img = ops_color.desigmoidize(img, sig)
            new_state = peak_state
            if need_color_map:
                if not use_linear:
                    img = linearize_src(img)
                if fused_tail is not None:
                    # with allow_delayed, K1 measures this frame's peak
                    # partials while it tone-maps with the previous
                    # frames' stats; else the stats are this frame's
                    stats = None
                    if use_peak and fused_tail.fused_peak:
                        stats = ops_peak.delayed_stats(peak_state,
                                                       src_max_pq)
                    elif use_peak:
                        avg_pq, max_pq, new_state = ops_peak.applied_stats(
                            img, peak_state, params.peak_detect, src_max_pq)
                        stats = (avg_pq, max_pq)
                    img, packed = fused_tail(img, stats)
                    if packed is not None:
                        _, _, new_state = ops_peak.finish_from_packed(
                            packed, peak_state, params.peak_detect)
                    k1_tails += 1
                else:
                    stats = None
                    if use_peak:
                        avg_pq, max_pq, new_state = ops_peak.applied_stats(
                            img, peak_state, params.peak_detect, src_max_pq)
                        stats = (avg_pq, max_pq)
                    img = color_map_stage(img, src_color, dst_color, params,
                                          stats)
                    img = delinearize_to(img, dst_color)
                    if tail_eligible:
                        plain_tails += 1
                    else:
                        ineligible_tails += 1
            elif use_linear:
                img = delinearize_to(img, src_color)
            if fused_tail is None:
                if params.lut is not None and \
                        params.lut_type == "conversion":
                    img = ops_lut.apply_lut(img, params.lut)
                img = ops_color.encode_color(img, target.repr,
                                             dst_color.primaries)
            if distort_plan is not None:
                img = ops_distort.distort_image(img, dst_w, dst_h,
                                                params.distort, distort_plan)
            # error diffusion needs the whole encoded frame, so it runs
            # after the tail, which then leaves out the ordered dither
            if quantize and (fused_tail is None or params.error_diffusion):
                if params.error_diffusion:
                    img = ops_dither.error_diffusion(img, target.bit_depth,
                                                     ed_kernel)
                elif dp is not None:
                    img = ops_dither.dither(img, target.bit_depth, dp,
                                            frame_index=dither_phase)
            return torch.clamp(img, 0.0, 1.0), new_state

        return pipeline

    def _fused_tail(self, params: RenderParams, src_color, dst_color,
                    target: Target, use_peak, dst_w, dst_h, dst_crop,
                    dither_phase=0):
        """The fused color tail — kernel K1 — or None when the tail is
        not eligible, in which case the plain stages run.  The gates are
        the reference's (renderer.py:1565-1574); an eligible tail runs
        a templated K1 instance where one exists (ops/cuda/color_map.py::
        plan_tail), else the generic one (plan_generic), whose plain
        version is the stages composed here as the reference's tail_fn
        composes them."""
        if not _tail_eligible(params, target, dst_w, dst_h, dst_crop):
            return None
        lut = dither = None
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
                if not gamma_path:
                    lut = bias
            dither = (dp, bias, gamma_path)
        fused_peak = bool(use_peak and params.peak_detect.allow_delayed)
        chain = color_chain(src_color, dst_color, params, use_peak)
        fn = params.tone_mapping_function
        plan = None
        if dither is None or lut is not None:
            plan = k1.plan_tail(chain, params, dst_color, target, fused_peak,
                                lut)
        if plan is None:
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
                y = ops_color.encode_color(y, target.repr,
                                           dst_color.primaries)
                if dither is not None:
                    h, w = y.shape[-2], y.shape[-1]
                    n = bias_t.shape[0]
                    full = bias_t if dither[0].method == \
                        ops_dither.DitherMethod.WHITE_NOISE else \
                        bias_t.tile((-(-h // n), -(-w // n)))[:h, :w]
                    y = ops_dither.dither(y, bit_depth, dither[0], bias=full)
                return y
            plan = k1.plan_generic(chain, params, src_color, dst_color,
                                   target, fused_peak, dither, plain,
                                   static_tone=static_tp,
                                   show_bounds=thresholds)
        if plan is None:
            return None
        lut_t = torch.from_numpy(plan.lut).to(self.device) \
            if plan.lut is not None else None
        dyn = chain.tone == "dynamic"

        def run(img, peak_stats):
            tone = None
            if dyn:
                avg_pq, max_pq = peak_stats
                tone = ops_tone.tone_vector(
                    fn, max_pq, avg_pq, chain.dst_min_pq, chain.dst_max_pq,
                    params.tone_constants)
            return k1.color_map_tail(img.contiguous(), plan, tone, lut_t)
        run.fused_peak = fused_peak
        run.plan, run.lut = plan, lut_t
        return run

    # -- public API ----------------------------------------------------

    def render(self, frame: Frame, target: Target,
               params: Optional[RenderParams] = None) -> torch.Tensor:
        """Render `frame` into a (3, target.h, target.w) tensor on the
        renderer's device (reference pl_render_image)."""
        return self._render_once(frame, target, params or RenderParams())

    def _render_once(self, frame: Frame, target: Target,
                     params: RenderParams) -> torch.Tensor:
        if frame.device != self.device and not (
                frame.device.type == self.device.type == "cuda"):
            raise ValueError(f"frame lives on {frame.device}, the renderer "
                             f"on {self.device}")
        _check_slice(params, target, frame)
        dither_phase = 0
        if params.dither is not None and params.dither.temporal and \
                target.bit_depth and target.bit_depth < 16:
            dither_phase = self._frame_idx % 8
        self._frame_idx += 1
        key = (frame.meta_key(), target.meta_key(), params.key(),
               dither_phase)
        fn = self._cache.pop(key, None)
        if fn is None:
            fn = self._trace_pipeline(frame.meta_key(), target, params,
                                      frame.repr, frame.color,
                                      frame.get_crop(), frame.film_grain,
                                      dither_phase=dither_phase,
                                      frame_icc=frame.icc, field=frame.field,
                                      first_field=frame.first_field)
        self._cache[key] = fn
        while len(self._cache) > _MAX_CACHED_PIPELINES:
            self._cache.pop(next(iter(self._cache)))
        out, self._peak_state = fn(self._peak_state,
                                   self._frame_inputs(frame, params),
                                   *[p.data for p in frame.planes])
        return out

    def _frame_inputs(self, frame: Frame, params: RenderParams
                      ) -> FrameInputs:
        """The per-frame inputs of a plan: grain tables (the seed may
        change every frame; AV1's host generation cached by seed), the
        neighbor frames' planes, and the frame's RPU, packed on the host
        (reference renderer.py:1741-1765)."""
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
        return FrameInputs(
            grain_tables, h274_tables,
            tuple(p.data for p in frame.prev.planes)
            if deinterlace and frame.prev is not None else None,
            tuple(p.data for p in frame.next.planes)
            if deinterlace and frame.next is not None else None,
            dovi_packed)


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

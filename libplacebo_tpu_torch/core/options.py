"""Options: typed key/value reflection over RenderParams.

Counterpart of libplacebo_tpu/core/options.py (pl_options,
options.c:908-1179): the same table of typed option descriptors, in the
same order, with the same keys, bounds, choices and presets; string
parse/save in "preset=high_quality,upscaler=ewa_lanczos,deband=yes"
form, and iteration.  Option strings saved by the JAX package parse
here to equal RenderParams fields.  User shaders in mpv .hook text
(`add_hook`, `insert_hook`) need the GLSL translator, not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

__all__ = ["Options", "OptionError", "OPTION_TABLE", "find_option"]


class OptionError(ValueError):
    pass


@dataclass(frozen=True)
class _Opt:
    key: str
    type: str                 # bool | int | float | str | enum | preset
    get: Callable             # params -> value
    set: Callable             # (params, value) -> params
    minimum: float = 0.0
    maximum: float = 0.0
    choices: Tuple[str, ...] = ()
    description: str = ""


def _parse_bool(v: str) -> bool:
    s = v.strip().lower()
    if s in ("yes", "y", "on", "true", "enabled", "1"):
        return True
    if s in ("no", "n", "off", "false", "disabled", "0", "none"):
        return False
    raise OptionError(f"invalid boolean: {v!r}")


def _build_table() -> List[_Opt]:
    from ..core.colorspace import (ColorAdjustment, Cone, ConeParams,
                                   VISION_ACHROMATOPSIA,
                                   VISION_DEUTERANOMALY, VISION_DEUTERANOPIA,
                                   VISION_MONOCHROMACY, VISION_NORMAL,
                                   VISION_PROTANOMALY, VISION_PROTANOPIA,
                                   VISION_TRITANOMALY, VISION_TRITANOPIA)
    from ..core.dither import (DitherMethod, ERROR_DIFFUSION_KERNELS)
    from ..core.gamut_mapping import GamutMapConstants
    from ..core.tone_mapping import ToneMapConstants
    from ..ops.deband import DebandParams
    from ..ops.deinterlace import DeinterlaceAlgo, DeinterlaceParams
    from ..ops.distort import DistortParams
    from ..ops.dithering import DitherParams
    from ..ops.peak_detect import PeakDetectParams
    from ..render.renderer import ALPHA_OVERLAY

    _BLEND_MODES = ("zero", "one", "src_alpha", "one_minus_src_alpha")

    def _distort_mat(p, r, c, v):
        d = p.distort or DistortParams()
        m = [list(row) for row in d.transform]
        m[r][c] = v
        return replace(p, distort=replace(
            d, transform=tuple(tuple(row) for row in m)))

    def _blend_elem(p, i, v):
        b = list(p.blend or ALPHA_OVERLAY)
        b[i] = v
        return replace(p, blend=tuple(b))

    def r_presets():
        from ..render.renderer import (DEFAULT_PARAMS, FAST_PARAMS,
                                       HIGH_QUALITY_PARAMS)
        return FAST_PARAMS, DEFAULT_PARAMS, HIGH_QUALITY_PARAMS

    def compat_opt(key, typ="float", lo=0.0, hi=1e9, choices=()):
        """An option accepted for compatibility (the reference's
        LUT-size, FBO and GLSL machinery knobs, which shape nothing
        here).  Values round-trip through RenderParams.compat_flags."""
        def getv(p):
            return dict(p.compat_flags).get(key)

        def setv(p, v):
            d = dict(p.compat_flags)
            d[key] = v
            return replace(p, compat_flags=tuple(sorted(d.items())))
        return _Opt(key, typ, getv, setv, lo, hi, choices=choices)
    from .filters import FILTER_CONFIGS
    from .tone_mapping import TONE_MAP_FUNCTIONS

    filter_names = tuple(c.name for c in FILTER_CONFIGS)
    tm_names = tuple(f.name for f in TONE_MAP_FUNCTIONS)
    ed_names = tuple(k.name for k in ERROR_DIFFUSION_KERNELS)

    def field_opt(key, typ, field, lo=0.0, hi=0.0, choices=(), desc=""):
        """Direct RenderParams field."""
        return _Opt(key, typ,
                    get=lambda p, f=field: getattr(p, f),
                    set=lambda p, v, f=field: replace(p, **{f: v}),
                    minimum=lo, maximum=hi, choices=choices,
                    description=desc or key.replace("_", " "))

    def scaler_opt(key, field):
        return field_opt(key, "enum", field, choices=filter_names,
                         desc=f"{field} filter")

    def sub_opt(key, typ, holder, field, default_factory, lo=0.0, hi=0.0,
                choices=()):
        """Option on a nested params object; setting it enables the
        feature with defaults if currently disabled."""
        def get(p):
            sub = getattr(p, holder)
            return getattr(sub, field) if sub is not None else None

        def setv(p, v):
            sub = getattr(p, holder) or default_factory()
            return replace(p, **{holder: replace(sub, **{field: v})})
        return _Opt(key, typ, get, setv, lo, hi, choices)

    def const_opt(key, holder, field, lo, hi):
        """Option on an always-present constants struct
        (tone_constants / gamut_constants)."""
        def get(p):
            return getattr(getattr(p, holder), field)

        def setv(p, v):
            return replace(p, **{holder: replace(getattr(p, holder),
                                                 **{field: v})})
        return _Opt(key, "float", get, setv, lo, hi)

    def feature_toggle(key, holder, default_factory, desc=""):
        def get(p):
            return getattr(p, holder) is not None

        def setv(p, v):
            cur = getattr(p, holder)
            if v and cur is None:
                return replace(p, **{holder: default_factory()})
            if not v:
                return replace(p, **{holder: None})
            return p
        return _Opt(key, "bool", get, setv,
                    description=desc or f"enable {key}")

    def preset_opt(key, apply, choices, current=None):
        """Sub-object preset pseudo-option (reference OPT_PRESET):
        write-only in save() unless `current` recovers the name."""
        return _Opt(key, "preset",
                    get=current or (lambda p: None),
                    set=apply, choices=choices)

    vision_presets = {
        "normal": VISION_NORMAL, "protanomaly": VISION_PROTANOMALY,
        "protanopia": VISION_PROTANOPIA,
        "deuteranomaly": VISION_DEUTERANOMALY,
        "deuteranopia": VISION_DEUTERANOPIA,
        "tritanomaly": VISION_TRITANOMALY, "tritanopia": VISION_TRITANOPIA,
        "monochromacy": VISION_MONOCHROMACY,
        "achromatopsia": VISION_ACHROMATOPSIA,
    }
    cone_names = {"none": Cone.NONE, "l": Cone.L, "m": Cone.M, "s": Cone.S,
                  "lm": Cone.LM, "ms": Cone.MS, "ls": Cone.LS,
                  "lms": Cone.LMS}

    def tuple_elem_opt(key, field, idx, n=3, lo=0.0, hi=1.0, sub=None):
        """One element of a float tuple field (background/tile colors)."""
        def get(p):
            t = getattr(p, field)
            return (t[sub][idx] if sub is not None else t[idx])

        def setv(p, v):
            t = getattr(p, field)
            if sub is not None:
                inner = tuple(v if i == idx else x
                              for i, x in enumerate(t[sub]))
                t = tuple(inner if j == sub else tuple(x)
                          for j, x in enumerate(t))
            else:
                t = tuple(v if i == idx else x for i, x in enumerate(t))
            return replace(p, **{field: t})
        return _Opt(key, "float", get, setv, lo, hi)

    table = [
        # ---- scalers (options.c:915-920)
        scaler_opt("upscaler", "upscaler"),
        scaler_opt("downscaler", "downscaler"),
        scaler_opt("plane_upscaler", "plane_upscaler"),
        scaler_opt("plane_downscaler", "plane_downscaler"),
        field_opt("correct_subpixel_offsets", "bool",
                  "correct_subpixel_offsets"),
        scaler_opt("frame_mixer", "frame_mixer"),
        field_opt("antiringing_strength", "float", "antiringing_strength",
                  0.0, 1.0),

        # ---- debanding (options.c:922-932)
        feature_toggle("deband", "deband", DebandParams),
        preset_opt("deband_preset",
                   lambda p, v: replace(p, deband=DebandParams()),
                   ("default",)),
        sub_opt("deband_iterations", "int", "deband", "iterations",
                DebandParams, 0, 16),
        sub_opt("deband_threshold", "float", "deband", "threshold",
                DebandParams, 0.0, 1000.0),
        sub_opt("deband_radius", "float", "deband", "radius",
                DebandParams, 0.0, 1000.0),
        sub_opt("deband_grain", "float", "deband", "grain",
                DebandParams, 0.0, 1000.0),
        _Opt("deband_grain_neutral_r", "float",
             lambda p: p.deband.grain_neutral[0] if p.deband else None,
             lambda p, v: replace(p, deband=replace(
                 p.deband or DebandParams(),
                 grain_neutral=(v,) + tuple(
                     (p.deband or DebandParams()).grain_neutral[1:])))),
        _Opt("deband_grain_neutral_g", "float",
             lambda p: p.deband.grain_neutral[1] if p.deband else None,
             lambda p, v: replace(p, deband=replace(
                 p.deband or DebandParams(), grain_neutral=(
                     (p.deband or DebandParams()).grain_neutral[0], v,
                     (p.deband or DebandParams()).grain_neutral[2])))),
        _Opt("deband_grain_neutral_b", "float",
             lambda p: p.deband.grain_neutral[2] if p.deband else None,
             lambda p, v: replace(p, deband=replace(
                 p.deband or DebandParams(), grain_neutral=tuple(
                     (p.deband or DebandParams()).grain_neutral[:2]) + (v,)))),

        # ---- sigmoidization (options.c:934-939)
        _Opt("sigmoid", "bool",
             lambda p: p.sigmoid is not None,
             lambda p, v: replace(p, sigmoid=(0.75, 6.5) if v else None)),
        preset_opt("sigmoid_preset",
                   lambda p, v: replace(p, sigmoid=(0.75, 6.5)),
                   ("default",)),
        _Opt("sigmoid_center", "float",
             lambda p: p.sigmoid[0] if p.sigmoid else None,
             lambda p, v: replace(
                 p, sigmoid=(v, (p.sigmoid or (0.75, 6.5))[1])), 0.0, 1.0),
        _Opt("sigmoid_slope", "float",
             lambda p: p.sigmoid[1] if p.sigmoid else None,
             lambda p, v: replace(
                 p, sigmoid=((p.sigmoid or (0.75, 6.5))[0], v)), 1.0, 20.0),

        # ---- color adjustment (options.c:943-954)
        feature_toggle("color_adjustment", "color_adjustment",
                       ColorAdjustment),
        preset_opt("color_adjustment_preset",
                   lambda p, v: replace(p, color_adjustment=
                                        ColorAdjustment()),
                   ("neutral",)),
        sub_opt("brightness", "float", "color_adjustment", "brightness",
                ColorAdjustment, -1.0, 1.0),
        sub_opt("contrast", "float", "color_adjustment", "contrast",
                ColorAdjustment, 0.0, 100.0),
        sub_opt("saturation", "float", "color_adjustment", "saturation",
                ColorAdjustment, 0.0, 100.0),
        _Opt("hue", "float",
             lambda p: p.color_adjustment.hue if p.color_adjustment
             else None,
             lambda p, v: replace(p, color_adjustment=replace(
                 p.color_adjustment or ColorAdjustment(), hue=v))),
        sub_opt("gamma", "float", "color_adjustment", "gamma",
                ColorAdjustment, 0.0, 100.0),
        sub_opt("temperature", "float", "color_adjustment", "temperature",
                ColorAdjustment, (1667 - 6500) / 3500.0,
                (25000 - 6500) / 3500.0),

        # ---- peak detection (options.c:956-965)
        feature_toggle("peak_detect", "peak_detect", PeakDetectParams),
        preset_opt("peak_detect_preset",
                   lambda p, v: replace(p, peak_detect=(
                       PeakDetectParams(percentile=99.995)
                       if v == "high_quality" else PeakDetectParams())),
                   ("default", "high_quality")),
        sub_opt("peak_smoothing_period", "float", "peak_detect",
                "smoothing_period", PeakDetectParams, 0.0, 1000.0),
        sub_opt("scene_threshold_low", "float", "peak_detect",
                "scene_threshold_low", PeakDetectParams, 0.0, 100.0),
        sub_opt("scene_threshold_high", "float", "peak_detect",
                "scene_threshold_high", PeakDetectParams, 0.0, 100.0),
        sub_opt("peak_percentile", "float", "peak_detect", "percentile",
                PeakDetectParams, 0.0, 100.0),
        sub_opt("black_cutoff", "float", "peak_detect", "black_cutoff",
                PeakDetectParams, 0.0, 100.0),
        sub_opt("allow_delayed_peak", "bool", "peak_detect",
                "allow_delayed", PeakDetectParams),

        # ---- color mapping (options.c:967-1016)
        field_opt("gamut_mapping", "enum", "gamut_mapping",
                  choices=("clip", "perceptual", "softclip", "relative",
                           "desaturate", "saturation", "absolute",
                           "highlight", "linear", "darken", "none")),
        const_opt("perceptual_deadzone", "gamut_constants",
                  "perceptual_deadzone", 0.0, 1.0),
        const_opt("perceptual_strength", "gamut_constants",
                  "perceptual_strength", 0.0, 1.0),
        const_opt("colorimetric_gamma", "gamut_constants",
                  "colorimetric_gamma", 0.0, 10.0),
        const_opt("softclip_knee", "gamut_constants",
                  "softclip_knee", 0.0, 1.0),
        const_opt("softclip_desat", "gamut_constants",
                  "softclip_desat", 0.0, 1.0),
        field_opt("tone_mapping", "enum", "tone_mapping_function",
                  choices=tm_names),
        const_opt("knee_adaptation", "tone_constants", "knee_adaptation",
                  0.0, 1.0),
        const_opt("knee_minimum", "tone_constants", "knee_minimum",
                  0.0, 0.5),
        const_opt("knee_maximum", "tone_constants", "knee_maximum",
                  0.5, 1.0),
        const_opt("knee_default", "tone_constants", "knee_default",
                  0.0, 1.0),
        const_opt("knee_offset", "tone_constants", "knee_offset", 0.5, 2.0),
        const_opt("slope_tuning", "tone_constants", "slope_tuning",
                  0.0, 10.0),
        const_opt("slope_offset", "tone_constants", "slope_offset",
                  0.0, 1.0),
        const_opt("spline_contrast", "tone_constants", "spline_contrast",
                  0.0, 1.5),
        const_opt("reinhard_contrast", "tone_constants",
                  "reinhard_contrast", 0.0, 1.0),
        const_opt("linear_knee", "tone_constants", "linear_knee", 0.0, 1.0),
        const_opt("exposure", "tone_constants", "exposure", 0.0, 10.0),
        field_opt("contrast_recovery", "float", "contrast_recovery",
                  0.0, 2.0),
        field_opt("contrast_smoothness", "float", "contrast_smoothness",
                  1.0, 32.0),
        field_opt("inverse_tone_mapping", "bool", "inverse_tone_mapping"),
        field_opt("gamut_expansion", "bool", "gamut_expansion"),
        field_opt("show_clipping", "bool", "show_clipping"),

        # ---- dithering (options.c:1018-1028)
        feature_toggle("dither", "dither", DitherParams),
        preset_opt("dither_preset",
                   lambda p, v: replace(p, dither=DitherParams()),
                   ("default",)),
        sub_opt("dither_method", "enum", "dither", "method", DitherParams,
                choices=tuple(m.value for m in DitherMethod)),
        sub_opt("dither_lut_size", "int", "dither", "lut_size",
                DitherParams, 1, 8),
        sub_opt("dither_temporal", "bool", "dither", "temporal",
                DitherParams),
        field_opt("disable_dither_gamma_correction", "bool",
                  "disable_dither_gamma_correction"),

        # ---- cone distortion (options.c:1046-1069)
        feature_toggle("cone", "cone", lambda: ConeParams(Cone.NONE, 1.0)),
        preset_opt("cone_preset",
                   lambda p, v: replace(p, cone=vision_presets[v]),
                   tuple(vision_presets)),
        _Opt("cones", "enum",
             lambda p: (next((k for k, c in cone_names.items()
                              if p.cone is not None and
                              Cone(p.cone.cones) == c), None)),
             lambda p, v: replace(p, cone=replace(
                 p.cone or ConeParams(Cone.NONE, 1.0),
                 cones=cone_names[v])),
             choices=tuple(cone_names)),
        _Opt("cone_strength", "float",
             lambda p: p.cone.strength if p.cone else None,
             lambda p, v: replace(p, cone=replace(
                 p.cone or ConeParams(Cone.NONE, 1.0), strength=v)),
             0.0, 10.0),

        # ---- distortion (options.c:1096-1114)
        feature_toggle("distort", "distort", DistortParams),
        preset_opt("distort_preset",
                   lambda p, v: replace(p, distort=DistortParams()),
                   ("default",)),
        _Opt("distort_scale_x", "float",
             lambda p: p.distort.transform[0][0] if p.distort else None,
             lambda p, v: _distort_mat(p, 0, 0, v)),
        _Opt("distort_scale_y", "float",
             lambda p: p.distort.transform[1][1] if p.distort else None,
             lambda p, v: _distort_mat(p, 1, 1, v)),
        _Opt("distort_shear_x", "float",
             lambda p: p.distort.transform[0][1] if p.distort else None,
             lambda p, v: _distort_mat(p, 0, 1, v)),
        _Opt("distort_shear_y", "float",
             lambda p: p.distort.transform[1][0] if p.distort else None,
             lambda p, v: _distort_mat(p, 1, 0, v)),
        _Opt("distort_offset_x", "float",
             lambda p: p.distort.offset[0] if p.distort else None,
             lambda p, v: replace(p, distort=replace(
                 p.distort or DistortParams(),
                 offset=(v, (p.distort or DistortParams()).offset[1])))),
        _Opt("distort_offset_y", "float",
             lambda p: p.distort.offset[1] if p.distort else None,
             lambda p, v: replace(p, distort=replace(
                 p.distort or DistortParams(),
                 offset=((p.distort or DistortParams()).offset[0], v)))),
        sub_opt("distort_unscaled", "bool", "distort", "unscaled",
                DistortParams),
        sub_opt("distort_constrain", "bool", "distort", "constrain",
                DistortParams),
        sub_opt("distort_bicubic", "bool", "distort", "bicubic",
                DistortParams),
        sub_opt("distort_address_mode", "enum", "distort", "address_mode",
                DistortParams, choices=("clamp", "repeat", "mirror")),
        _Opt("distort_alpha_mode", "enum",
             lambda p: (p.distort.alpha_mode or "none")
             if p.distort else None,
             lambda p, v: replace(p, distort=replace(
                 p.distort or DistortParams(),
                 alpha_mode=None if v == "none" else v)),
             choices=("none", "independent", "premultiplied")),

        # ---- target blending (options.c:1116-1124)
        _Opt("blend", "bool",
             lambda p: p.blend is not None,
             lambda p, v: replace(p, blend=ALPHA_OVERLAY if v else None)),
        preset_opt("blend_preset",
                   lambda p, v: replace(p, blend=ALPHA_OVERLAY),
                   ("alpha_overlay",)),
        _Opt("blend_src_rgb", "enum",
             lambda p: p.blend[0] if p.blend else None,
             lambda p, v: _blend_elem(p, 0, v), choices=_BLEND_MODES),
        _Opt("blend_dst_rgb", "enum",
             lambda p: p.blend[1] if p.blend else None,
             lambda p, v: _blend_elem(p, 1, v), choices=_BLEND_MODES),
        _Opt("blend_src_alpha", "enum",
             lambda p: p.blend[2] if p.blend else None,
             lambda p, v: _blend_elem(p, 2, v), choices=_BLEND_MODES),
        _Opt("blend_dst_alpha", "enum",
             lambda p: p.blend[3] if p.blend else None,
             lambda p, v: _blend_elem(p, 3, v), choices=_BLEND_MODES),

        # ---- deinterlacing (options.c:1077-1090)
        feature_toggle("deinterlace", "deinterlace", DeinterlaceParams),
        sub_opt("deinterlace_algo", "enum", "deinterlace", "algo",
                DeinterlaceParams,
                choices=tuple(a.name.lower() for a in DeinterlaceAlgo)),
        sub_opt("deinterlace_skip_spatial", "bool", "deinterlace",
                "skip_spatial_check", DeinterlaceParams),

        # ---- output (options.c:1107-1165)
        field_opt("error_diffusion", "enum", "error_diffusion",
                  choices=ed_names + ("none",)),
        field_opt("lut_type", "enum", "lut_type",
                  choices=("native", "normalized", "conversion")),
        field_opt("background", "enum", "background",
                  choices=("color", "tiles")),
        # border=None follows `background`; the option reads as unset
        # until explicitly given (so save() stays minimal)
        _Opt("border", "enum",
             lambda p: p.border,
             lambda p, v: replace(p, border=v),
             choices=("color", "tiles", "skip", "blur")),
        field_opt("blur_radius", "float", "blur_radius", 0.0, 1000.0),
        field_opt("background_transparency", "float",
                  "background_transparency", 0.0, 1.0),
        field_opt("skip_target_clearing", "bool", "skip_target_clearing"),
        field_opt("force_dither", "bool", "force_dither"),
        tuple_elem_opt("background_r", "background_color", 0),
        tuple_elem_opt("background_g", "background_color", 1),
        tuple_elem_opt("background_b", "background_color", 2),
        tuple_elem_opt("tile_color_hi_r", "tile_colors", 0, sub=0),
        tuple_elem_opt("tile_color_hi_g", "tile_colors", 1, sub=0),
        tuple_elem_opt("tile_color_hi_b", "tile_colors", 2, sub=0),
        tuple_elem_opt("tile_color_lo_r", "tile_colors", 0, sub=1),
        tuple_elem_opt("tile_color_lo_g", "tile_colors", 1, sub=1),
        tuple_elem_opt("tile_color_lo_b", "tile_colors", 2, sub=1),
        field_opt("tile_size", "int", "tile_size", 2, 256),
        field_opt("corner_rounding", "float", "corner_rounding", 0.0, 1.0),

        # ---- misc render params (options.c:1150-1179)
        field_opt("linear_scaling", "bool", "linear_scaling"),
        field_opt("skip_anti_aliasing", "bool", "skip_anti_aliasing"),
        field_opt("disable_linear_scaling", "bool",
                  "disable_linear_scaling"),
        field_opt("film_grain", "bool", "film_grain",
                  desc="honor frame-attached film grain"),
        field_opt("preserve_mixing_cache", "bool",
                  "preserve_mixing_cache"),
        field_opt("skip_caching_single_frame", "bool",
                  "skip_caching_single_frame"),

        # ---- global + umbrella presets (options.c:908-931)
        preset_opt("preset",
                   lambda p, v: {"fast": r_presets()[0],
                                 "default": r_presets()[1],
                                 "high_quality": r_presets()[2]}[v],
                   ("fast", "default", "high_quality")),
        # "color_map" enable: off = neither tone nor gamut mapping
        _Opt("color_map", "bool",
             lambda p: not (p.gamut_mapping in ("none", "") and
                            p.tone_mapping_function == "clip"),
             lambda p, v: p if v else replace(
                 p, gamut_mapping="none", tone_mapping_function="clip")),
        preset_opt("color_map_preset",
                   lambda p, v: replace(
                       p, gamut_mapping="perceptual",
                       tone_mapping_function="spline",
                       contrast_recovery=0.30 if v == "high_quality"
                       else 0.0),
                   ("default", "high_quality")),
        preset_opt("deinterlace_preset",
                   lambda p, v: replace(p, deinterlace=DeinterlaceParams()),
                   ("default",)),
        field_opt("tone_map_metadata", "enum", "tone_map_metadata",
                  choices=("any", "none", "hdr10", "hdr10plus", "cie_y")),
        # deprecated alias (reference options.c): tiles behind alpha
        _Opt("blend_against_tiles", "bool",
             lambda p: p.background == "tiles",
             lambda p, v: replace(p, background="tiles" if v else "color")),

        # ---- ICC engine (options.c:1130-1148)
        _Opt("icc", "bool",
             lambda p: not p.ignore_icc_profiles,
             lambda p, v: replace(p, ignore_icc_profiles=not v)),
        field_opt("ignore_icc_profiles", "bool", "ignore_icc_profiles"),
        preset_opt("icc_preset", lambda p, v: replace(
            p, ignore_icc_profiles=False), ("default",)),
        # intent is honored by core.icc.parse_icc(intent=...); the
        # sizing/BPC/luma knobs are honored by the device path
        # (ops.icc.params_kwargs reads them back out of compat_flags):
        # size_r/g/b set the cLUT bake grid, force_bpc applies black
        # point compensation in the bake (matrix/TRC profiles map
        # black to black by construction, so it is a no-op there),
        # max_luma rescales profile-relative white
        compat_opt("icc_intent", "enum",
                   choices=("auto", "perceptual", "relative",
                            "saturation", "absolute")),
        compat_opt("icc_size_r", "int", 0, 256),
        compat_opt("icc_size_g", "int", 0, 256),
        compat_opt("icc_size_b", "int", 0, 256),
        compat_opt("icc_max_luma", "float", 0.0, 10000.0),
        compat_opt("icc_force_bpc", "bool"),

        # ---- knobs of the reference's GPU machinery, accepted for
        # compatibility (no LUTs, FBOs or shader text are generated)
        compat_opt("force_tone_mapping_lut", "bool"),
        compat_opt("tone_lut_size", "int", 0, 4096),
        compat_opt("lut3d_size_h", "int", 0, 1024),
        compat_opt("lut3d_tricubic", "bool"),
        compat_opt("lut_entries", "int", 0, 4096),
        compat_opt("polar_cutoff", "float", 0.0, 64.0),
        compat_opt("disable_builtin_scalers", "bool"),
        compat_opt("disable_fbos", "bool"),
        compat_opt("force_low_bit_depth_fbos", "bool"),
        compat_opt("dynamic_constants", "bool"),
        compat_opt("correct_subpixel_offset", "bool"),
        compat_opt("minimum_peak", "float", 0.0, 100.0),
        compat_opt("tone_mapping_param", "float", 0.0, 100.0),

        # ---- tone/gamut visualization (options.c:1010-1016)
        field_opt("visualize_lut", "bool", "visualize_lut"),
        field_opt("visualize_hue", "float", "visualize_hue",
                  -1e3, 1e3),
        field_opt("visualize_theta", "float", "visualize_theta",
                  -1e3, 1e3),
        tuple_elem_opt("visualize_lut_x0", "visualize_rect", 0),
        tuple_elem_opt("visualize_lut_y0", "visualize_rect", 1),
        tuple_elem_opt("visualize_lut_x1", "visualize_rect", 2),
        tuple_elem_opt("visualize_lut_y1", "visualize_rect", 3),
    ]
    return table


_TABLE: Optional[List[_Opt]] = None


def OPTION_TABLE() -> List[_Opt]:
    global _TABLE
    if _TABLE is None:
        _TABLE = _build_table()
    return _TABLE


class Options:
    """Reference pl_options: holds a RenderParams and lets you
    inspect/mutate it through typed string options."""

    def __init__(self, params=None):
        from ..render.renderer import DEFAULT_PARAMS
        self.params = params or DEFAULT_PARAMS
        self._by_key = {o.key: o for o in OPTION_TABLE()}

    # -- presets (reference "preset=" pseudo-option) -------------------

    def _apply_preset(self, name: str):
        from ..render import renderer as r
        presets = {"fast": r.FAST_PARAMS, "default": r.DEFAULT_PARAMS,
                   "high_quality": r.HIGH_QUALITY_PARAMS}
        if name not in presets:
            raise OptionError(f"unknown preset: {name!r}")
        self.params = presets[name]

    # -- set/get -------------------------------------------------------

    def set(self, key: str, value: str):
        """Reference pl_options_set_str."""
        if key == "preset":
            self._apply_preset(value)
            return
        opt = self._by_key.get(key)
        if opt is None:
            raise OptionError(f"unknown option: {key!r}")
        if opt.type == "bool":
            v = _parse_bool(value)
        elif opt.type == "int":
            try:
                v = int(value)
            except ValueError:
                raise OptionError(f"invalid integer for {key}: {value!r}")
            if opt.minimum != opt.maximum:
                v = int(min(max(v, opt.minimum), opt.maximum))
        elif opt.type == "float":
            try:
                v = float(value)
            except ValueError:
                raise OptionError(f"invalid number for {key}: {value!r}")
            if opt.minimum != opt.maximum:
                v = min(max(v, opt.minimum), opt.maximum)
        elif opt.type in ("enum", "preset"):
            if opt.choices and value not in opt.choices:
                raise OptionError(
                    f"invalid value {value!r} for {key}; "
                    f"choices: {', '.join(opt.choices)}")
            v = value
            if key == "dither_method":
                from .dither import DitherMethod
                v = DitherMethod(value)
            elif key == "deinterlace_algo":
                from ..ops.deinterlace import DeinterlaceAlgo
                v = DeinterlaceAlgo[value.upper()]
            elif key == "error_diffusion" and value == "none":
                v = None
        else:
            v = value
        self.params = opt.set(self.params, v)

    def get(self, key: str):
        opt = self._by_key.get(key)
        if opt is None:
            raise OptionError(f"unknown option: {key!r}")
        v = opt.get(self.params)
        import enum as _enum
        if isinstance(v, _enum.Enum):
            v = v.value if isinstance(v.value, str) else v.name.lower()
        return v

    def parse(self, s: str):
        """Parse "k=v,k=v" strings (reference pl_options_load)."""
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise OptionError(f"malformed option: {part!r}")
            k, v = part.split("=", 1)
            self.set(k.strip(), v.strip())

    def save(self) -> str:
        """Serialize non-default options (reference pl_options_save)."""
        from ..render.renderer import DEFAULT_PARAMS
        defaults = Options(DEFAULT_PARAMS)
        out = []
        for opt in OPTION_TABLE():
            if opt.type == "preset":
                continue           # write-only pseudo-options
            cur = self.get(opt.key)
            dfl = defaults.get(opt.key)
            if cur != dfl and cur is not None:
                if isinstance(cur, bool):
                    cur = "yes" if cur else "no"
                out.append(f"{opt.key}={cur}")
        return ",".join(out)

    def iterate(self):
        """Yield (key, value) for every real (non-preset) option."""
        for opt in OPTION_TABLE():
            if opt.type == "preset":
                continue
            yield opt.key, self.get(opt.key)

    # -- user-hook management (reference pl_options_add_hook /
    # pl_options_insert_hook / pl_options_remove_hook_at,
    # options.h:131-146: the options object owns parsed user shaders
    # and keeps params.hooks pointing at them) ------------------------

    def add_hook(self, shader_text: str):
        """Parse an mpv .hook user shader and append it to params.hooks
        (needs the GLSL translator: raises NotImplementedError)."""
        self.insert_hook(len(self.params.hooks or ()), shader_text)

    def insert_hook(self, idx: int, shader_text: str):
        raise NotImplementedError(
            "mpv .hook user shaders are not ported to the PyTorch package "
            "yet (ROADMAP slice 4 item 29, render/mpv_hooks.py); pass "
            "render.hooks.Hook callables in RenderParams.hooks instead")

    def remove_hook_at(self, idx: int):
        hooks = list(self.params.hooks or ())
        del hooks[idx]
        self.params = replace(self.params, hooks=tuple(hooks))

    def reset(self, params=None):
        """Reset the held params wholesale — to the given RenderParams,
        or to the recommended defaults when omitted (reference
        pl_options_reset, options.h:76)."""
        from ..render.renderer import DEFAULT_PARAMS
        self.params = params or DEFAULT_PARAMS


def find_option(key: str):
    """The option descriptor for `key`, or None (reference
    pl_find_option, options.h:197)."""
    for o in OPTION_TABLE():
        if o.key == key:
            return o
    return None

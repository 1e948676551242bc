"""The plain reference of one rendered frame: the same seeded integer
planes through libplacebo's chain for a 4:2:0 YCbCr source
(pl_render_image), in float32, and the carried peak-detection state
worked out again from the frames a run rendered.

normalize -> bilinear chroma merge at the frame's chroma siting ->
YCbCr decode -> PQ linearize -> main scaler in linear light (EWA for an
upscale, separable for a downscale) -> tone and gamut mapping with the
delayed peak (the previous frames' smoothed stats; this frame's
measurement goes into the state for the next) -> delinearize ->
blue-noise dither -> clip, and for a transcoder the YCbCr encode and the
encoder's pixel format.

Two sources:
- `stages.py`: every stage with a closed form (the curves, matrices,
  scalers, the peak measurement, quantization), written from the
  standards and libplacebo's definitions;
- `frozen/`: a frozen copy of the program's plain PyTorch for what has
  to follow libplacebo's algorithm step by step: colour-space inference,
  spline tone mapping, perceptual gamut mapping in IPT, the peak's
  temporal filter and the blue-noise matrix.

Nothing here imports the program; the configuration and traffic come in
as plain dicts.  A configuration that asks for a stage this chain does
not implement raises `Unsupported`.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np
import torch

from . import stages
from .frozen.core import colorspace as cs
from .frozen.core.colorspace import COLOR_HDR_BLACK, COLOR_SDR_WHITE
from .frozen.core.dither import blue_noise
from .frozen.core.gamut_mapping import GamutMapConstants
from .frozen.core.tone_mapping import ToneMapConstants
from .frozen.ops import gamut as ops_gamut
from .frozen.ops import peak_detect as ops_peak
from .frozen.ops import tone_dynamic as ops_tone


class Unsupported(ValueError):
    """The configuration asks for a stage or a parameter the reference
    does not implement; adding one means adding the stage here."""


# AVFrame names -> the frozen enums (libavutil's names)
_PRIM = {"bt2020": cs.ColorPrimaries.BT_2020, "bt709": cs.ColorPrimaries.BT_709}
_TRC = {"smpte2084": cs.ColorTransfer.PQ, "bt709": cs.ColorTransfer.BT_1886,
        "bt1886": cs.ColorTransfer.BT_1886, "srgb": cs.ColorTransfer.SRGB,
        "iec61966-2-1": cs.ColorTransfer.SRGB}
# chroma siting -> the chroma sample's (x, y) offset from the centre of
# its 2x2 luma block, in luma pixels
_SITING = {"left": (-0.5, 0.0), "center": (0.0, 0.0),
           "top_left": (-0.5, -0.5)}
# source pixel formats: bit depth
_DEPTH = {"yuv420p10le": 10, "yuv420p": 8}
# the encoder's pixel formats: (bits, chroma halved both ways)
OUT_FORMATS = {"yuv420p": (8, True)}


@dataclass(frozen=True)
class Params:
    """libplacebo's pl_render_default_params, the fields this chain
    reads, with the deployment's overrides."""
    upscaler: str = "lanczos"
    downscaler: str = "hermite"
    plane_upscaler: str = "bilinear"
    linear_scaling: bool = True
    tone_mapping_function: str = "spline"
    tone_map_metadata: str = "any"
    gamut_mapping: str = "perceptual"
    dither: bool = True
    peak_detect: bool = True


# what each implemented stage accepts
_IMPLEMENTED = {"plane_upscaler": ("bilinear",),
                "tone_mapping_function": ("spline",),
                "gamut_mapping": ("perceptual",),
                "tone_map_metadata": ("any",)}


def params_from(config: dict) -> Params:
    """The configuration's render parameters; raises Unsupported for a
    field or a value the chain does not implement."""
    given = dict(config.get("render_params", {}))
    known = {f.name for f in fields(Params)}
    extra = sorted(set(given) - known)
    if extra:
        raise Unsupported(f"render_params {extra} are not implemented by "
                          f"framebench/reference/chain.py")
    p = Params(**given)
    for k, ok in _IMPLEMENTED.items():
        if getattr(p, k) not in ok:
            raise Unsupported(f"{k}={getattr(p, k)!r} is not implemented "
                              f"by framebench/reference/chain.py")
    return p


def source_color(av: dict):
    """(ColorSpace, system name, bit depth) of a limited-range AVFrame-like
    dict, as libplacebo's pl_map_avframe reads its fields
    and HDR10 side data."""
    depth = _DEPTH[av["format"]]
    hdr = cs.HdrMetadata()
    mdm = av.get("mastering_display_metadata")
    if mdm:
        p = mdm["display_primaries"]
        hdr = cs.HdrMetadata(
            prim=cs.RawPrimaries(red=cs.CIExy(*p[0]), green=cs.CIExy(*p[1]),
                                 blue=cs.CIExy(*p[2]),
                                 white=cs.CIExy(*mdm["white_point"])),
            min_luma=float(mdm["min_luminance"]),
            max_luma=float(mdm["max_luminance"]))
    cll = av.get("content_light_level")
    if cll:
        hdr = cs.HdrMetadata(prim=hdr.prim, min_luma=hdr.min_luma,
                             max_luma=hdr.max_luma,
                             max_cll=float(cll["max_cll"]),
                             max_fall=float(cll["max_fall"]))
    color = cs.ColorSpace(_PRIM[av["color_primaries"]], _TRC[av["color_trc"]],
                          hdr)
    if av["colorspace"] not in stages.KR_KB or \
            av["color_range"] not in ("tv", "limited"):
        raise Unsupported(f"source {av['colorspace']!r} range "
                          f"{av['color_range']!r}")
    return color, av["colorspace"], depth


# ---------------------------------------------------------------------------
# colour mapping (libplacebo pl_shader_color_map_ex's planning)
# ---------------------------------------------------------------------------

def _dst_pq_range(dst):
    inf = dst.infer()
    return (cs.hdr_rescale(cs.HdrScaling.NITS, cs.HdrScaling.PQ,
                           inf.hdr.min_luma),
            cs.hdr_rescale(cs.HdrScaling.NITS, cs.HdrScaling.PQ,
                           inf.hdr.max_luma))


def color_map(img, src, dst, p: Params, peak_stats):
    """Linear light -> linear light in the target's primaries: the IPT
    round trip with the dynamic (or static) tone curve and the
    perceptual gamut operator."""
    dst_min_pq, dst_max_pq = _dst_pq_range(dst)
    src_prim = cs.primaries_get(src.primaries)
    dst_prim = cs.primaries_get(dst.primaries)
    if cs.primaries_compatible(dst_prim, src_prim):
        dst_prim = cs.primaries_clip(dst_prim, src_prim)
    b_src = ops_gamut.fit_boundary(src_prim, dst_min_pq, dst_max_pq)
    b_dst = ops_gamut.fit_boundary(dst_prim, dst_min_pq, dst_max_pq)
    avg_pq, max_pq = peak_stats

    def tone_fn(x):
        return ops_tone.tone_map_dynamic(
            x, p.tone_mapping_function, src_max=max_pq, src_avg=avg_pq,
            dst_min=dst_min_pq, dst_max=dst_max_pq,
            constants=ToneMapConstants())
    return ops_gamut.color_map_ipt(img, tone_fn, p.gamut_mapping, b_src,
                                   b_dst, to_norm=COLOR_SDR_WHITE / 10000.0,
                                   constants=GamutMapConstants())


# ---------------------------------------------------------------------------
# peak detection (libplacebo's measurement and temporal filter)
# ---------------------------------------------------------------------------

_PEAK = ops_peak.PeakDetectParams()


def measure_peak(img_linear):
    """(avg_pq, max_pq, share of tiles lit) of one linear frame
    (stages.measure_peak), libplacebo's black level where nothing is
    lit."""
    m = stages.measure_peak(img_linear, _PEAK.black_cutoff / 100.0)
    if m is None:
        black = torch.tensor(COLOR_HDR_BLACK)
        return black, black, torch.tensor(0.0)
    return m


def peak_states(measurements: dict, history: Sequence, wanted: Sequence[int]
                ) -> dict:
    """The (2,) state each frame of `history` at a position in `wanted`
    applies: the temporal filter run over every earlier frame, each
    frame's measurement looked up by its key."""
    state = ops_peak.peak_detect_state_init("cpu")
    want = set(wanted)
    out = {}
    for pos, key in enumerate(history):
        if pos in want:
            out[pos] = state.clone()
        avg, mx, bias = measurements[key]
        state = ops_peak._temporal_update(avg, mx, bias, state, _PEAK)[2]
    return out


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

class Chain:
    """One deployment's frame chain for one source geometry, planned
    once (boundary fits, the dither bias).  `precision` is "float32"
    (the reference) or "bfloat16", the control, which rounds every
    stage's image to bfloat16."""

    def __init__(self, config: dict, av: dict, width: int, height: int,
                 device, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise Unsupported(f"precision {precision!r}")
        self.device = torch.device(device)
        self.precision = precision
        self.p = params_from(config)
        src_raw, self.system, self.depth = source_color(av)
        self.siting = _SITING[av.get("chroma_location", "left")]
        t = config["target"]
        self.dst_w, self.dst_h = t["w"], t["h"]
        self.bit_depth = t["bit_depth"]
        self.src, self.dst = cs.color_space_infer_map(
            src_raw, cs.ColorSpace(_PRIM[t["primaries"]],
                                   _TRC[t["transfer"]]))
        if self.src.transfer != cs.ColorTransfer.PQ:
            raise Unsupported("only a PQ source is implemented")
        inf = self.dst.infer().hdr
        self.dst_black = inf.min_luma / COLOR_SDR_WHITE
        self.dst_white = inf.max_luma / COLOR_SDR_WHITE
        self.delinearize = {
            cs.ColorTransfer.SRGB: stages.srgb_delinearize,
            cs.ColorTransfer.BT_1886: stages.bt1886_delinearize,
        }.get(self.dst.transfer)
        if self.delinearize is None:
            raise Unsupported(f"target transfer {t['transfer']!r}")
        self.encode = config.get("encode")
        if self.encode is not None and (
                self.encode["format"] not in OUT_FORMATS or
                self.encode["levels"] not in ("tv", "limited")):
            raise Unsupported(f"output {self.encode['format']!r} levels "
                              f"{self.encode['levels']!r}")
        self.needs_scale = (width, height) != (self.dst_w, self.dst_h)
        self.up = self.dst_w >= width and self.dst_h >= height
        if self.needs_scale:
            name = self.p.upscaler if self.up else self.p.downscaler
            if (self.up, name) not in ((True, "ewa_lanczos"),
                                       (False, "hermite")):
                raise Unsupported(f"scaler {name!r} for this direction")
        self.lin = self.p.linear_scaling and self.needs_scale
        self.src_max_pq = cs.hdr_rescale(cs.HdrScaling.NITS,
                                         cs.HdrScaling.PQ,
                                         self.src.hdr.max_luma)
        self.bias = stages.tile(torch.from_numpy(blue_noise(6)),
                                self.dst_h, self.dst_w).to(self.device) \
            if self.p.dither else None

    def _q(self, x):
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def linear(self, planes_int: Sequence[np.ndarray]):
        """Integer planes -> the tail's input: normalized, merged,
        decoded, linearized and scaled to the target (linear light,
        1.0 = SDR white)."""
        y, cb, cr = (self._q(stages.normalize(p, self.depth, self.device))
                     for p in planes_int)
        H, W = y.shape[-2:]
        cb, cr = (stages.merge_chroma(c, H, W, self.siting) for c in (cb, cr))
        img = self._q(torch.cat([y, cb, cr], dim=0))
        img = self._q(stages.ycbcr_to_rgb(img, self.system, self.depth))
        if self.lin:
            img = self._q(stages.pq_linearize(img))
        if self.needs_scale:
            if self.up:
                img = stages.ewa(img, self.dst_h, self.dst_w)
            else:
                img = stages.hermite_scale(img, self.dst_h, self.dst_w)
            img = self._q(img)
        if not self.lin:
            img = self._q(stages.pq_linearize(img))
        return img

    def tail(self, img, state):
        """The output of the frame whose delayed peak state is `state`,
        as code planes: the display's (3, H, W) RGB, or the encoder's
        Y, Cb and Cr planes."""
        stats = ops_peak.delayed_stats(state.to(self.device),
                                       self.src_max_pq) \
            if self.p.peak_detect else (torch.tensor(0.0), torch.tensor(
                self.src_max_pq))
        out = self._q(color_map(img, self.src, self.dst, self.p, stats))
        out = self._q(self.delinearize(out, self.dst_black, self.dst_white))
        if self.bias is not None:
            out = stages.dither(out, self.bit_depth, self.bias)
        out = torch.clamp(out, 0.0, 1.0)
        if self.encode is None:
            return [codes(out, self.bit_depth)]
        bits, halve = OUT_FORMATS[self.encode["format"]]
        ycc = stages.rgb_to_ycbcr(out, self.encode["sys"], bits)
        planes = [ycc[0], ycc[1], ycc[2]]
        if halve:
            planes[1:] = [stages.box_420(p) for p in planes[1:]]
        return [codes(p, bits) for p in planes]


def codes(x, bits: int = 8):
    """[0, 1] values -> integer codes (float64 for exact differences),
    rounded half to even and clipped to the code range."""
    top = float((1 << bits) - 1)
    return torch.clamp(torch.round(x.double() * top), 0.0, top)


def compare(program: Sequence, reference: Sequence) -> dict:
    """The numbers `correct` is judged by, of one frame's code planes:
    the largest code difference, the share of values more than one code
    apart, the share that differ at all, the mean absolute difference in
    codes, and the largest mean absolute difference of one row of a
    plane (a (C, H, W) plane's row over all channels), which a row gone
    wrong raises however rare it is."""
    diffs = [(p.double().to(r.device) - r.double()).abs()
             for p, r in zip(program, reference)]
    if len(program) != len(reference) or any(
            p.shape != r.shape for p, r in zip(program, reference)):
        raise ValueError("the program's planes do not match the "
                         "reference's")
    n = float(sum(d.numel() for d in diffs))

    def row_means(d):
        return d.mean(dim=(0, 2)) if d.dim() == 3 else d.mean(dim=1)
    return {"max_code_diff": max(float(d.max()) for d in diffs),
            "share_over_1": sum(float((d > 1).sum()) for d in diffs) / n,
            "share_differing": sum(float((d > 0).sum()) for d in diffs) / n,
            "mean_abs_code_diff": sum(float(d.sum()) for d in diffs) / n,
            "max_row_mean_abs_diff": max(float(row_means(d).max())
                                         for d in diffs)}

"""Framework interop: frames from other array frameworks and from
decoders' frame descriptions.

Counterpart of libplacebo_tpu/utils/interop.py (the reference's
utils/libav.h and utils/dav1d.h mapping):

  * dlpack — `from_dlpack` / `to_dlpack` are torch's (zero copy where
    the producer's device allows); `from_torch` / `to_torch` are the
    identity, the port's arrays being tensors;
  * AVFrame-shaped dicts — `frame_from_avframe_like` maps the fields
    libav.h maps (pixel format with its planes, colorspace, range,
    primaries, transfer, chroma location, sample aspect ratio) and the
    side data (mastering display, content light level, HDR10+ into an
    `HdrBezier`, ICC profile, AV1 / H.274 film grain, Dolby Vision,
    display-matrix rotation into a `Rotation`, cropping), uploading the
    planes to `device` (None = "cuda"; raises without a GPU unless given
    device="cpu") through pinned memory without waiting;
  * `frame_from_pyav` (PyAV imported by the caller, not here) and
    `frame_from_dav1d_picture_like` build such a dict first;
    `frame_to_avframe_like` goes the other way.
"""
from __future__ import annotations

from dataclasses import replace as drep

import numpy as np
import torch
import torch.utils.dlpack

from ..core.colorspace import (BitEncoding, CIExy, ColorLevels,
                               ColorPrimaries, ColorRepr, ColorSpace,
                               ColorSystem, ColorTransfer, HdrBezier,
                               RawPrimaries)
from ..core.common import RectF, Rotation
from ..core.film_grain import AV1GrainData, FilmGrainData, H274GrainData
from ..core.icc import parse_icc
from ..core.log import default_log
from ..render.frame import Frame
from .upload import PlaneData, frame_from_planes

__all__ = ["from_dlpack", "to_dlpack", "from_torch", "to_torch",
           "frame_from_avframe_like", "frame_to_avframe_like",
           "frame_from_dav1d_picture_like", "frame_from_pyav",
           "AV_PIX_FMTS", "test_pixfmt"]


def from_dlpack(capsule_or_array) -> torch.Tensor:
    """Any __dlpack__-capable array (or a DLPack capsule) as a tensor,
    sharing its memory where the device allows."""
    return torch.from_dlpack(capsule_or_array)


def to_dlpack(tensor: torch.Tensor):
    """A tensor exported as a DLPack capsule."""
    return torch.utils.dlpack.to_dlpack(tensor)


def from_torch(tensor: torch.Tensor) -> torch.Tensor:
    """The identity: the port's arrays are tensors already."""
    return tensor


def to_torch(tensor: torch.Tensor) -> torch.Tensor:
    """The identity: the port's arrays are tensors already."""
    return tensor


# AVFrame-style pixel format descriptions: name -> (planes, subsampling,
# bit depth, component maps). Mirrors the formats utils/libav.h maps.
AV_PIX_FMTS = {
    "yuv420p": (3, (1, 1), 8, ((0,), (1,), (2,))),
    "yuv422p": (3, (1, 0), 8, ((0,), (1,), (2,))),
    "yuv444p": (3, (0, 0), 8, ((0,), (1,), (2,))),
    "yuv410p": (3, (2, 2), 8, ((0,), (1,), (2,))),
    "yuv411p": (3, (2, 0), 8, ((0,), (1,), (2,))),
    "yuv420p10le": (3, (1, 1), 10, ((0,), (1,), (2,))),
    "yuv422p10le": (3, (1, 0), 10, ((0,), (1,), (2,))),
    "yuv444p10le": (3, (0, 0), 10, ((0,), (1,), (2,))),
    "yuv420p12le": (3, (1, 1), 12, ((0,), (1,), (2,))),
    "yuv422p12le": (3, (1, 0), 12, ((0,), (1,), (2,))),
    "yuv444p12le": (3, (0, 0), 12, ((0,), (1,), (2,))),
    "yuv420p16le": (3, (1, 1), 16, ((0,), (1,), (2,))),
    "yuva420p": (4, (1, 1), 8, ((0,), (1,), (2,), (3,))),
    "yuva444p": (4, (0, 0), 8, ((0,), (1,), (2,), (3,))),
    "nv12": (2, (1, 1), 8, ((0,), (1, 2))),
    "nv21": (2, (1, 1), 8, ((0,), (2, 1))),
    "p010le": (2, (1, 1), 10, ((0,), (1, 2))),
    "p016le": (2, (1, 1), 16, ((0,), (1, 2))),
    "gray8": (1, (0, 0), 8, ((0,),)),
    "gray10le": (1, (0, 0), 10, ((0,),)),
    "gray16le": (1, (0, 0), 16, ((0,),)),
    "rgb24": (1, (0, 0), 8, ((0, 1, 2),)),
    "bgr24": (1, (0, 0), 8, ((2, 1, 0),)),
    "rgba": (1, (0, 0), 8, ((0, 1, 2, 3),)),
    "bgra": (1, (0, 0), 8, ((2, 1, 0, 3),)),
    "argb": (1, (0, 0), 8, ((3, 0, 1, 2),)),
    "rgba64le": (1, (0, 0), 16, ((0, 1, 2, 3),)),
    # ffmpeg GBR-planar: plane order is G, B, R (pixdesc: R lives in
    # plane 2, G in plane 0, B in plane 1)
    "gbrp": (3, (0, 0), 8, ((1,), (2,), (0,))),
    "gbrp10le": (3, (0, 0), 10, ((1,), (2,), (0,))),
    "gbrap": (4, (0, 0), 8, ((1,), (2,), (0,), (3,))),
}

# MSB-aligned formats: samples live in the TOP bits of each word and
# must shift right before UNORM normalization (ffmpeg stores p010/p012
# MSB-aligned, unlike the LSB-aligned yuvXXXpNNle family; the reference
# expresses this through pl_plane_data.shift)
_AV_PIX_FMT_SHIFT = {"p010le": 6, "p012le": 4}

_AVCOL_SPC = {
    "bt709": ColorSystem.BT_709, "bt470bg": ColorSystem.BT_601,
    "smpte170m": ColorSystem.BT_601, "smpte240m": ColorSystem.SMPTE_240M,
    "bt2020nc": ColorSystem.BT_2020_NC, "bt2020c": ColorSystem.BT_2020_C,
    "bt2020ncl": ColorSystem.BT_2020_NC,     # ffmpeg string aliases
    "bt2020cl": ColorSystem.BT_2020_C,
    "ictcp": ColorSystem.BT_2100_PQ, "ycgco": ColorSystem.YCGCO,
    "ycgco-re": ColorSystem.YCGCO_RE, "ycgco-ro": ColorSystem.YCGCO_RO,
    "rgb": ColorSystem.RGB,
    # fcc/smpte2085/chroma-derived/ipt-c2: no counterpart (the reference
    # maps them to UNKNOWN too, libav_internal.h:58-72)
}
_AVCOL_PRI = {
    "bt709": ColorPrimaries.BT_709, "bt470bg": ColorPrimaries.BT_601_625,
    "smpte170m": ColorPrimaries.BT_601_525,
    "smpte240m": ColorPrimaries.BT_601_525,
    "bt470m": ColorPrimaries.BT_470M,
    "bt2020": ColorPrimaries.BT_2020, "smpte432": ColorPrimaries.DISPLAY_P3,
    "smpte431": ColorPrimaries.DCI_P3, "film": ColorPrimaries.FILM_C,
    "smpte428": ColorPrimaries.CIE_1931,
    "jedec-p22": ColorPrimaries.EBU_3213,
}
_AVCOL_TRC = {
    "bt709": ColorTransfer.BT_1886, "iec61966-2-1": ColorTransfer.SRGB,
    "srgb": ColorTransfer.SRGB, "linear": ColorTransfer.LINEAR,
    "smpte2084": ColorTransfer.PQ, "arib-std-b67": ColorTransfer.HLG,
    "gamma22": ColorTransfer.GAMMA22, "gamma28": ColorTransfer.GAMMA28,
    # EOTF != OETF family: display-side BT.1886, like the reference
    # (libav_internal.h:197-211)
    "smpte170m": ColorTransfer.BT_1886,
    "smpte240m": ColorTransfer.BT_1886,
    "iec61966-2-4": ColorTransfer.BT_1886,
    "bt1361e": ColorTransfer.BT_1886,
    "bt2020-10": ColorTransfer.BT_1886,
    "bt2020-12": ColorTransfer.BT_1886,
    "smpte428": ColorTransfer.ST428,
}


def test_pixfmt(fmt: str) -> bool:
    """Whether `fmt` (an ffmpeg pixel-format name) can be ingested
    (reference pl_test_pixfmt, libav_internal.h — caps probing
    collapses to table membership: every supported layout uploads)."""
    return fmt in AV_PIX_FMTS


def frame_from_avframe_like(av: dict, device=None) -> Frame:
    """Map an AVFrame-shaped dict to a Frame (the role of
    pl_frame_from_avframe, utils/libav.h). Expected keys:
      format (str), data (list of ndarrays), optionally: colorspace,
      color_primaries, color_trc, color_range ('tv'|'pc'),
      chroma_location ('left'|'center'|...).
    """
    fmt = av["format"]
    if fmt not in AV_PIX_FMTS:
        raise ValueError(f"unsupported pixel format {fmt!r}")
    n_planes, _, depth, comp_maps = AV_PIX_FMTS[fmt]
    data = av["data"]
    if len(data) != n_planes:
        raise ValueError(f"{fmt} has {n_planes} planes, got {len(data)}")

    shift = _AV_PIX_FMT_SHIFT.get(fmt, 0)
    planes = [PlaneData(np.asarray(d), comp_maps[i], bit_depth=depth,
                        bit_shift=shift)
              for i, d in enumerate(data)]

    sys = _AVCOL_SPC.get(av.get("colorspace", ""), ColorSystem.UNKNOWN)
    if fmt.startswith(("rgb", "gbr", "bgra")) or fmt == "rgba":
        sys = ColorSystem.RGB
    levels = {"tv": ColorLevels.LIMITED, "mpeg": ColorLevels.LIMITED,
              "pc": ColorLevels.FULL, "jpeg": ColorLevels.FULL}.get(
        av.get("color_range", ""), ColorLevels.UNKNOWN)
    repr = ColorRepr(sys=sys, levels=levels,
                     bits=BitEncoding(depth, depth, 0))
    color = ColorSpace(
        primaries=_AVCOL_PRI.get(av.get("color_primaries", ""),
                                 ColorPrimaries.UNKNOWN),
        transfer=_AVCOL_TRC.get(av.get("color_trc", ""),
                                ColorTransfer.UNKNOWN))
    frame = frame_from_planes(
        planes, repr=repr, color=color,
        chroma_location=av.get("chroma_location", "left"), device=device)
    # anamorphic metadata (reference libav_internal.h:781 maps
    # AVFrame.sample_aspect_ratio into pl_frame.pixel_aspect_ratio)
    frame.pixel_aspect_ratio = float(av.get("sample_aspect_ratio", 0.0))
    return _map_side_data(av, frame)


def _map_side_data(av: dict, frame: Frame) -> Frame:
    """Apply AVFrame side data to the frame (the role of
    pl_map_avframe_ex's side-data walk, utils/libav_internal.h:384-460):
    mastering display metadata, content light level, HDR10+ dynamic
    metadata, ICC profile, AV1/H.274 film grain, Dolby Vision RPU
    coefficients, display-matrix rotation, and cropping."""
    hdr = frame.color.hdr
    mdm = av.get("mastering_display_metadata")
    if mdm:
        prim = RawPrimaries(
            red=CIExy(*mdm.get("display_primaries", [[0, 0]] * 3)[0]),
            green=CIExy(*mdm.get("display_primaries", [[0, 0]] * 3)[1]),
            blue=CIExy(*mdm.get("display_primaries", [[0, 0]] * 3)[2]),
            white=CIExy(*mdm.get("white_point", [0, 0])))
        hdr = drep(hdr, prim=prim,
                   min_luma=float(mdm.get("min_luminance", 0.0)),
                   max_luma=float(mdm.get("max_luminance", 0.0)))
    cll = av.get("content_light_level")
    if cll:
        hdr = drep(hdr, max_cll=float(cll.get("max_cll", 0.0)),
                   max_fall=float(cll.get("max_fall", 0.0)))
    dhp = av.get("hdr10plus") or av.get("dynamic_hdr_plus")
    if dhp:
        ootf = None
        if dhp.get("anchors") is not None:
            ootf = HdrBezier(
                target_luma=float(dhp.get("target_luma", 0.0)),
                knee_x=float(dhp.get("knee_x", 0.0)),
                knee_y=float(dhp.get("knee_y", 0.0)),
                anchors=tuple(float(a) for a in dhp["anchors"]))
        hdr = drep(hdr,
                   scene_max=tuple(float(x) for x in
                                   dhp.get("scene_max", (0.0,) * 3)),
                   scene_avg=float(dhp.get("scene_avg", 0.0)),
                   ootf=ootf)
    frame.color = drep(frame.color, hdr=hdr)

    icc = av.get("icc_profile")
    if icc:
        # a broken profile in the side data is ignored, as the reference
        # ignores it: the frame still maps
        try:
            frame.icc = parse_icc(bytes(icc))
        except Exception as e:  # noqa: BLE001 - any parse failure
            default_log().warn(f"ignoring the frame's ICC profile: "
                               f"{type(e).__name__}: {e}")

    fg = av.get("film_grain")
    if fg:
        if fg.get("type", "av1") == "av1":
            a = fg.get("av1", fg)
            frame.film_grain = FilmGrainData(
                type="av1", seed=int(fg.get("seed", 0)),
                av1=AV1GrainData(
                    num_points_y=int(a.get("num_points_y", 0)),
                    points_y=tuple(map(tuple, a.get("points_y", ()))),
                    chroma_scaling_from_luma=bool(
                        a.get("chroma_scaling_from_luma", False)),
                    num_points_uv=tuple(a.get("num_points_uv", (0, 0))),
                    points_uv=tuple(tuple(map(tuple, p))
                                    for p in a.get("points_uv", ((), ()))),
                    scaling_shift=int(a.get("scaling_shift", 8)),
                    ar_coeff_lag=int(a.get("ar_coeff_lag", 0)),
                    ar_coeffs_y=tuple(a.get("ar_coeffs_y", ())),
                    ar_coeffs_uv=tuple(map(tuple,
                                           a.get("ar_coeffs_uv",
                                                 ((), ())))),
                    ar_coeff_shift=int(a.get("ar_coeff_shift", 6)),
                    grain_scale_shift=int(a.get("grain_scale_shift", 0)),
                    uv_mult=tuple(a.get("uv_mult", (0, 0))),
                    uv_mult_luma=tuple(a.get("uv_mult_luma", (0, 0))),
                    uv_offset=tuple(a.get("uv_offset", (0, 0))),
                    overlap=bool(a.get("overlap", True))))
        elif fg.get("type") == "h274":
            h = fg.get("h274", fg)
            frame.film_grain = FilmGrainData(
                type="h274", seed=int(fg.get("seed", 0)),
                h274=H274GrainData(
                    model_id=int(h.get("model_id", 0)),
                    blending_mode_id=int(h.get("blending_mode_id", 0)),
                    log2_scale_factor=int(h.get("log2_scale_factor", 0)),
                    component_model_present=tuple(
                        bool(b) for b in h.get("component_model_present",
                                               (False,) * 3)),
                    num_intensity_intervals=tuple(
                        h.get("num_intensity_intervals", (0, 0, 0))),
                    num_model_values=tuple(
                        h.get("num_model_values", (0, 0, 0))),
                    intensity_interval_lower_bound=tuple(
                        tuple(v) for v in
                        h.get("intensity_interval_lower_bound",
                              ((), (), ()))),
                    intensity_interval_upper_bound=tuple(
                        tuple(v) for v in
                        h.get("intensity_interval_upper_bound",
                              ((), (), ()))),
                    comp_model_value=tuple(
                        tuple(map(tuple, v)) for v in
                        h.get("comp_model_value", ((), (), ())))))

    dovi = av.get("dovi")
    if dovi is not None:
        frame.repr = ColorRepr(
            sys=ColorSystem.DOLBYVISION, levels=frame.repr.levels,
            alpha=frame.repr.alpha, bits=frame.repr.bits, dovi=dovi)

    # display matrix rotation (degrees CCW like av_display_rotation_get)
    rot = av.get("rotation")
    if rot:
        frame.rotation = Rotation((int(round(rot / 90)) % 4))

    if any(k in av for k in ("crop_top", "crop_left", "crop_bottom",
                             "crop_right")):
        w = frame.w
        h = frame.h
        frame.crop = RectF(float(av.get("crop_left", 0)),
                           float(av.get("crop_top", 0)),
                           w - float(av.get("crop_right", 0)),
                           h - float(av.get("crop_bottom", 0)))
    return frame


def frame_to_avframe_like(frame: Frame) -> dict:
    """Export Frame metadata + planes back into an AVFrame-shaped dict
    (the role of pl_frame_to_avframe / pl_avframe_set_color,
    libav_internal.h:650-730)."""
    # first-wins inversion: the tables list the canonical av name first
    # and aliases after (the reference's pl->av direction picks these
    # same canonical values, libav_internal.h:86-108,228+)
    def _inv(table):
        inv = {}
        for k, v in table.items():
            inv.setdefault(v, k)
        return inv
    inv_spc = _inv(_AVCOL_SPC)
    inv_pri = _inv(_AVCOL_PRI)
    inv_trc = _inv(_AVCOL_TRC)
    def host(p):
        a = p.data.detach().cpu().numpy()
        return a.transpose(1, 2, 0) if a.ndim == 3 else a
    out = {
        "data": [host(p) for p in frame.planes],
        "colorspace": inv_spc.get(frame.repr.sys, "unknown"),
        "color_primaries": inv_pri.get(frame.color.primaries, "unknown"),
        "color_trc": inv_trc.get(frame.color.transfer, "unknown"),
        "color_range": {ColorLevels.LIMITED: "tv",
                        ColorLevels.FULL: "pc"}.get(
            frame.repr.levels, "unknown"),
    }
    hdr = frame.color.hdr
    if hdr.max_luma or hdr.min_luma:
        out["mastering_display_metadata"] = {
            "min_luminance": hdr.min_luma, "max_luminance": hdr.max_luma,
            "display_primaries": [[hdr.prim.red.x, hdr.prim.red.y],
                                  [hdr.prim.green.x, hdr.prim.green.y],
                                  [hdr.prim.blue.x, hdr.prim.blue.y]],
            "white_point": [hdr.prim.white.x, hdr.prim.white.y]}
    if hdr.max_cll or hdr.max_fall:
        out["content_light_level"] = {"max_cll": hdr.max_cll,
                                      "max_fall": hdr.max_fall}
    if frame.pixel_aspect_ratio:
        out["sample_aspect_ratio"] = frame.pixel_aspect_ratio
    return out


def frame_from_pyav(avframe, device=None) -> Frame:
    """Map a REAL PyAV av.VideoFrame to a Frame (the role of
    pl_map_avframe_ex over an actual AVFrame, utils/libav.h) — converts
    the live object into the dict shape frame_from_avframe_like maps,
    extracting plane buffers (stride-aware), color properties, and the
    side data the reference walks (mastering display, content light,
    display matrix rotation).  Requires the `av` package at runtime;
    everything else in this module works without it."""
    fmt = avframe.format.name
    if fmt not in AV_PIX_FMTS:
        raise ValueError(f"unsupported pixel format {fmt!r}")
    n_planes, (sub_x, sub_y), depth, comp_maps = AV_PIX_FMTS[fmt]

    data = []
    itemsize = 2 if depth > 8 else 1
    for i, plane in enumerate(avframe.planes):
        ph = avframe.height >> (sub_y if i in (1, 2) else 0)
        pw = avframe.width >> (sub_x if i in (1, 2) else 0)
        ncomp = len(comp_maps[i])
        buf = np.frombuffer(bytes(plane),
                            dtype=np.uint16 if itemsize == 2 else np.uint8)
        stride = plane.line_size // itemsize
        arr = buf.reshape(ph, stride)[:, :pw * ncomp]
        if ncomp > 1:
            arr = arr.reshape(ph, pw, ncomp)
        data.append(np.ascontiguousarray(arr))

    d = {
        "format": fmt,
        "data": data,
        "colorspace": str(getattr(avframe, "colorspace", "") or ""),
        "color_range": {1: "tv", 2: "pc"}.get(
            int(getattr(avframe, "color_range", 0) or 0), ""),
        "color_primaries": str(getattr(avframe, "color_primaries", "")
                               or ""),
        "color_trc": str(getattr(avframe, "color_trc", "") or ""),
    }
    sar = getattr(avframe, "sample_aspect_ratio", None)
    if sar:
        d["sample_aspect_ratio"] = float(sar)
    # side data (reference libav_internal.h:384-460); PyAV exposes the
    # registry via frame.side_data when built against a new ffmpeg
    sd = getattr(avframe, "side_data", None)
    if sd:
        for entry in sd:
            t = str(getattr(entry, "type", "")).lower()
            try:
                if "mastering" in t:
                    m = entry.to_dict() if hasattr(entry, "to_dict") else {}
                    if m:
                        d["mastering_display_metadata"] = m
                elif "content_light" in t:
                    m = entry.to_dict() if hasattr(entry, "to_dict") else {}
                    if m:
                        d["content_light_level"] = m
                elif "displaymatrix" in t or "display_matrix" in t:
                    if hasattr(entry, "to_display_rotation"):
                        d["rotation"] = entry.to_display_rotation()
            except (AttributeError, TypeError, ValueError):
                pass                     # tolerate older PyAV layouts
    return frame_from_avframe_like(d, device=device)


# ---------------------------------------------------------------------------
# dav1d interop (reference utils/dav1d.h + dav1d_internal.h, 616+129 LoC)
# ---------------------------------------------------------------------------

_DAV1D_LAYOUTS = {
    # pixel layout -> (n_planes, (sub_x, sub_y))
    "I400": (1, (0, 0)),
    "I420": (3, (1, 1)),
    "I422": (3, (1, 0)),
    "I444": (3, (0, 0)),
}

# Dav1dSequenceHeader color fields use the ISO/IEC 23091-4 (H.273) codes
_H273_MATRIX = {
    0: ColorSystem.RGB, 1: ColorSystem.BT_709, 5: ColorSystem.BT_601,
    6: ColorSystem.BT_601, 7: ColorSystem.SMPTE_240M,
    8: ColorSystem.YCGCO, 9: ColorSystem.BT_2020_NC,
    10: ColorSystem.BT_2020_C, 14: ColorSystem.BT_2100_PQ,
}
_H273_PRI = {
    1: ColorPrimaries.BT_709, 5: ColorPrimaries.BT_601_625,
    6: ColorPrimaries.BT_601_525, 8: ColorPrimaries.FILM_C,
    9: ColorPrimaries.BT_2020, 11: ColorPrimaries.DCI_P3,
    12: ColorPrimaries.DISPLAY_P3,
}
_H273_TRC = {
    1: ColorTransfer.BT_1886, 4: ColorTransfer.GAMMA22,
    5: ColorTransfer.GAMMA28, 8: ColorTransfer.LINEAR,
    13: ColorTransfer.SRGB, 16: ColorTransfer.PQ, 18: ColorTransfer.HLG,
}


def frame_from_dav1d_picture_like(pic: dict, device=None) -> Frame:
    """Map a Dav1dPicture-shaped dict to a Frame (the role of
    pl_frame_from_dav1dpicture, utils/dav1d.h). Expected keys:
      layout ('I400'|'I420'|'I422'|'I444'), bitdepth, data (list of
      ndarrays), optionally seq_hdr {mtrx, pri, trc, color_range (0/1),
      chr (chroma sample position: 1=left, 2=center)}, and
      frame_hdr {film_grain {...}} with dav1d-style AV1 grain params.
    """
    layout = pic["layout"]
    if layout not in _DAV1D_LAYOUTS:
        raise ValueError(f"unsupported dav1d layout {layout!r}")
    n_planes, _ = _DAV1D_LAYOUTS[layout]
    depth = int(pic.get("bitdepth", 8))
    data = pic["data"]
    if len(data) != n_planes:
        raise ValueError(f"{layout} has {n_planes} planes, got {len(data)}")

    comp_maps = (((0,),) if n_planes == 1 else ((0,), (1,), (2,)))
    # Dav1dPicture samples are LSB-aligned at every bitdepth
    planes = [PlaneData(np.asarray(d), comp_maps[i], bit_depth=depth)
              for i, d in enumerate(data)]

    seq = pic.get("seq_hdr", {})
    repr = ColorRepr(
        sys=_H273_MATRIX.get(seq.get("mtrx", -1), ColorSystem.UNKNOWN),
        levels=(ColorLevels.FULL if seq.get("color_range")
                else ColorLevels.LIMITED),
        bits=BitEncoding(depth, depth, 0))
    color = ColorSpace(
        primaries=_H273_PRI.get(seq.get("pri", -1),
                                ColorPrimaries.UNKNOWN),
        transfer=_H273_TRC.get(seq.get("trc", -1), ColorTransfer.UNKNOWN))
    chroma = {1: "left", 2: "center"}.get(seq.get("chr", 1), "left")
    frame = frame_from_planes(planes, repr=repr, color=color,
                              chroma_location=chroma, device=device)

    fh = pic.get("frame_hdr", {})
    fg = fh.get("film_grain") or pic.get("film_grain")
    if fg and (fg.get("num_y_points", fg.get("num_points_y", 0)) or
               any(fg.get("num_uv_points", fg.get("num_points_uv",
                                                  (0, 0))))):
        frame = _map_side_data({"film_grain": {
            "type": "av1", "seed": fg.get("seed", 0),
            "av1": {
                "num_points_y": fg.get("num_y_points",
                                       fg.get("num_points_y", 0)),
                "points_y": fg.get("y_points", fg.get("points_y", ())),
                "chroma_scaling_from_luma":
                    fg.get("chroma_scaling_from_luma", False),
                "num_points_uv": fg.get("num_uv_points",
                                        fg.get("num_points_uv", (0, 0))),
                "points_uv": fg.get("uv_points",
                                    fg.get("points_uv", ((), ()))),
                "scaling_shift": fg.get("scaling_shift", 8),
                "ar_coeff_lag": fg.get("ar_coeff_lag", 0),
                "ar_coeffs_y": fg.get("ar_coeffs_y", ()),
                "ar_coeffs_uv": fg.get("ar_coeffs_uv", ((), ())),
                "ar_coeff_shift": fg.get("ar_coeff_shift", 6),
                "grain_scale_shift": fg.get("grain_scale_shift", 0),
                "uv_mult": fg.get("uv_mult", (0, 0)),
                "uv_mult_luma": fg.get("uv_luma_mult",
                                       fg.get("uv_mult_luma", (0, 0))),
                "uv_offset": fg.get("uv_offset", (0, 0)),
                "overlap": fg.get("overlap_flag",
                                  fg.get("overlap", True)),
            }}}, frame)
    return frame

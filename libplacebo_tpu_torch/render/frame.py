"""Frame & plane representation.

Counterpart of libplacebo_tpu/render/frame.py: a frame is a list of
planar float32 (components, H, W) tensors on one device plus colorimetry
metadata; the metadata is static and keys the renderer's plan cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.colorspace import (BitEncoding, ColorLevels, ColorRepr,
                               ColorSpace, ColorSystem)
from ..core.common import RectF, Rotation
from ..core.film_grain import FilmGrainData
from ..utils.device import raw_to_device, resolve_device
from . import profiler

__all__ = ["Plane", "Frame", "Overlay", "OverlayPart", "frame_from_yuv420p",
           "frame_from_rgb", "icc_key"]


@dataclass
class Plane:
    """One image plane: (components, H, W) float32 in [0, 1]; each
    component carries canonical channel 0=R/Y, 1=G/Cb, 2=B/Cr, 3=A;
    shift_x/y is the subtexel siting in this plane's texels."""
    data: torch.Tensor
    component_mapping: Tuple[int, ...] = (0,)
    shift_x: float = 0.0
    shift_y: float = 0.0

    @property
    def components(self) -> int:
        return len(self.component_mapping)

    @property
    def h(self) -> int:
        return self.data.shape[-2]

    @property
    def w(self) -> int:
        return self.data.shape[-1]


@dataclass(frozen=True)
class OverlayPart:
    """One overlay quad (reference pl_overlay_part): `src` addresses the
    overlay texture in texels, `dst` lies in the overlay's `coords`
    space; `color` paints a monochrome overlay's coverage."""
    src: RectF
    dst: RectF
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclass
class Overlay:
    """A subtitle or OSD bitmap (reference pl_overlay).

    `data` is a (4, H, W) RGBA tensor for mode "normal" (premultiplied
    when `repr.alpha` says so), or a (1, H, W) coverage map for
    "monochrome", each part's `color` painting it (libass's bitmaps).
    `coords` is the space of the parts' `dst`: "auto" (src_frame on a
    frame, dst_frame on a target), "src_frame", "src_crop", "dst_frame"
    or "dst_crop".  Without `parts`, the whole texture is drawn at
    `rect` in target coordinates.  `repr` / `color` are the overlay's
    own encoding, converted to the target's when they differ.  The
    bitmap (a tensor, or an array the renderer uploads) is per-frame
    data: only its shape keys the render plan."""
    data: torch.Tensor
    rect: Optional[RectF] = None
    color: ColorSpace = field(default_factory=ColorSpace)
    repr: ColorRepr = field(default_factory=ColorRepr)
    mode: str = "normal"                 # "normal" | "monochrome"
    coords: str = "auto"
    parts: Tuple[OverlayPart, ...] = ()

    _MODES = ("normal", "monochrome")
    _COORDS = ("auto", "src_frame", "src_crop", "dst_frame", "dst_crop")

    def get_parts(self) -> Tuple[OverlayPart, ...]:
        """The parts to draw; the whole-texture `rect` shorthand becomes
        one part.  An unknown mode or coords raises ValueError."""
        if self.mode not in self._MODES:
            raise ValueError(f"unknown overlay mode {self.mode!r}; "
                             f"one of {self._MODES}")
        if self.coords not in self._COORDS:
            raise ValueError(f"unknown overlay coords {self.coords!r}; "
                             f"one of {self._COORDS}")
        if self.parts:
            return tuple(self.parts)
        h, w = self.data.shape[-2], self.data.shape[-1]
        dst = self.rect or RectF(0.0, 0.0, float(w), float(h))
        return (OverlayPart(RectF(0.0, 0.0, float(w), float(h)), dst),)

    def key(self) -> tuple:
        """What shapes the plan: the bitmap's shape (not its pixels),
        mode, coords, encoding and geometry."""
        return (tuple(self.data.shape), self.mode, self.coords,
                self.repr.sys, self.repr.levels, self.repr.alpha,
                self.color.primaries, self.color.transfer, self.color.hdr,
                self.rect if not self.parts else None,
                tuple((p.src, p.dst, p.color) for p in self.parts))


@dataclass
class Frame:
    """Reference pl_frame."""
    planes: List[Plane]
    repr: ColorRepr = field(default_factory=ColorRepr)
    color: ColorSpace = field(default_factory=ColorSpace)
    crop: Optional[RectF] = None
    # film grain metadata (reference pl_frame.film_grain); the seed may
    # change every frame without a new render plan
    film_grain: Optional[FilmGrainData] = None
    # image ICC profile (core.icc.IccProfile): when set, the renderer
    # linearizes through it instead of the nominal transfer
    icc: Optional[object] = None
    # quarter turns counter-clockwise (reference pl_rotation, an int);
    # the crop lies in the rotated image
    rotation: Rotation = Rotation(0)
    # aspect ratio of a raw (encoded, unrotated) pixel, 0 = square or
    # unknown: metadata for the application's target crop (reference
    # pl_frame.pixel_aspect_ratio); the renderer does not read it
    pixel_aspect_ratio: float = 0.0
    # lazy mapping (reference pl_frame.acquire/release): acquire(frame)
    # runs before the renderer reads the planes (False refuses the
    # render), release(frame) after it, a failure included; a field's
    # prev/next frames are acquired with it
    acquire: Optional[object] = None     # Callable[[Frame], bool]
    release: Optional[object] = None     # Callable[[Frame], None]
    # subtitles drawn with the frame (Overlay); their bitmaps are
    # per-frame data
    overlays: List[Overlay] = field(default_factory=list)
    # interlacing (reference pl_frame.field + pl_frame_mix's temporal
    # neighbors): the field shown now (ops.deinterlace.Field), the
    # stream's first field, and the previous / next frames
    field: Optional[object] = None
    first_field: Optional[object] = None
    prev: Optional["Frame"] = None
    next: Optional["Frame"] = None
    # presentation time and identity, for frame mixing
    pts: float = 0.0
    signature: int = 0
    # sequence number the upload gave the frame, carried by its spans
    # (render/profiler.py); 0 = none, the renderer then takes a new one
    seq: int = 0

    @property
    def ref_plane(self) -> Plane:
        """The largest plane carrying channel 0 (luma / red)."""
        best = self.planes[0]
        for p in self.planes:
            if 0 in p.component_mapping:
                if (p.w * p.h) >= (best.w * best.h) or \
                        0 not in best.component_mapping:
                    best = p
        return best

    @property
    def w(self) -> int:
        return self.ref_plane.w

    @property
    def h(self) -> int:
        return self.ref_plane.h

    @property
    def device(self) -> torch.device:
        return self.planes[0].data.device

    def get_crop(self) -> RectF:
        return self.crop or RectF(0, 0, self.w, self.h)

    def is_cropped(self) -> bool:
        """Whether the rounded, normalized crop covers less than the
        reference plane (reference pl_frame_is_cropped)."""
        c = self.get_crop()
        x0 = round(min(c.x0, c.x1))
        y0 = round(min(c.y0, c.y1))
        x1 = round(max(c.x0, c.x1))
        y1 = round(max(c.y0, c.y1))
        if not x0 and not x1:
            x1 = self.w
        if not y0 and not y1:
            y1 = self.h
        return x0 > 0 or y0 > 0 or x1 < self.w or y1 < self.h

    def set_chroma_location(self, loc: str) -> None:
        """Give every subsampled plane the siting `loc` ("left",
        "center", "top_left", ...; utils.upload.CHROMA_OFFSETS) (reference
        pl_frame_set_chroma_location)."""
        from ..utils.upload import chroma_location_offset
        sx, sy = chroma_location_offset(loc)
        ref_w, ref_h = self.w, self.h
        for p in self.planes:
            if p.w < ref_w or p.h < ref_h:
                p.shift_x, p.shift_y = sx, sy

    def meta_key(self) -> tuple:
        """Static signature of everything that shapes the render plan.
        The grain's structure (AV1: which channels, overlap, scaling
        shift; H.274: the models) is static; its seed is not — a new
        seed only swaps the per-frame grain inputs.  A Dolby Vision RPU
        keys by presence only: its coefficients are per-frame data.
        Fields key by the field shown, the first field and whether the
        neighbor frames are present."""
        grain_static = None
        if self.film_grain is not None and self.film_grain.av1 is not None:
            a = self.film_grain.av1
            grain_static = (self.film_grain.type, a.num_points_y > 0,
                            a.num_points_uv[0] > 0, a.num_points_uv[1] > 0,
                            a.chroma_scaling_from_luma, a.overlap,
                            a.scaling_shift)
        elif self.film_grain is not None and \
                self.film_grain.type == "h274":
            grain_static = ("h274", self.film_grain.h274)
        elif self.film_grain is not None:
            grain_static = (self.film_grain.type,)
        return (
            tuple((tuple(p.data.shape), p.component_mapping, p.shift_x,
                   p.shift_y) for p in self.planes),
            self.repr.sys, self.repr.levels, self.repr.alpha,
            self.repr.bits, self.repr.dovi is not None,
            self.color.primaries, self.color.transfer,
            self.color.hdr, self.get_crop(), str(self.device), grain_static,
            icc_key(self.icc), self.field, self.first_field,
            self.prev is not None, self.next is not None,
            int(self.rotation) % 4, tuple(o.key() for o in self.overlays))


def icc_key(icc) -> Optional[int]:
    """A profile's plan-cache key: its content signature (crc32 of its
    bytes), else its identity."""
    if icc is None:
        return None
    return getattr(icc, "signature", 0) or id(icc)


def frame_from_yuv420p(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       repr: Optional[ColorRepr] = None,
                       color: Optional[ColorSpace] = None,
                       bit_depth: int = 8, device=None) -> Frame:
    """Build a Frame from planar YUV 4:2:0 data on `device` (None =
    "cuda").  Integer planes upload raw and normalize on the device by a
    true divide by 2^depth - 1 — the divisor is a device tensor, since a
    Python scalar divisor lets CUDA multiply by the reciprocal instead,
    one ulp off.  Planes may be numpy arrays or integer torch tensors;
    a tensor in pinned host memory uploads without holding the host."""
    dev = resolve_device(device)

    def norm(x):
        if isinstance(x, torch.Tensor):
            raw = x.to(dev, non_blocking=x.is_pinned())
            if raw.is_floating_point():
                return raw.to(torch.float32)
            div = torch.full((), float(2 ** bit_depth - 1),
                             dtype=torch.float32, device=dev)
            return raw.to(torch.float32) / div
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            raw = raw_to_device(x, dev)
            div = torch.full((), float(2 ** bit_depth - 1),
                             dtype=torch.float32, device=dev)
            return raw.to(torch.float32) / div
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    h, w = tuple(y.shape) if isinstance(y, torch.Tensor) else np.shape(y)
    repr = repr or ColorRepr(
        sys=ColorSystem.BT_709 if w >= 1280 else ColorSystem.BT_601,
        levels=ColorLevels.LIMITED,
        bits=BitEncoding(bit_depth, bit_depth, 0))
    color = color or ColorSpace()
    seq = profiler.next_seq()
    with profiler.span("upload", seq):
        # MPEG-2 ("left") chroma siting: -0.5 ref-pixel shift
        planes = [
            Plane(norm(y)[None], (0,)),
            Plane(norm(u)[None], (1,), shift_x=-0.5),
            Plane(norm(v)[None], (2,), shift_x=-0.5),
        ]
    return Frame(planes=planes, repr=repr, color=color, seq=seq)


def frame_from_rgb(rgb: np.ndarray, color: Optional[ColorSpace] = None,
                   levels: ColorLevels = ColorLevels.FULL,
                   device=None) -> Frame:
    """A frame from an interleaved (H, W, 3 or 4) or planar (3 or 4, H,
    W) RGB(A) float array on `device` (None = "cuda"); a fourth
    component is alpha."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if rgb.ndim == 3 and rgb.shape[-1] in (3, 4):
        rgb = np.moveaxis(rgb, -1, 0)
    data = torch.from_numpy(np.ascontiguousarray(rgb)).to(
        resolve_device(device))
    return Frame(planes=[Plane(data, tuple(range(rgb.shape[0])))],
                 repr=ColorRepr(sys=ColorSystem.RGB, levels=levels),
                 color=color or ColorSpace())

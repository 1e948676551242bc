"""Plane upload with device-side normalization.

Counterpart of the device-norm path of libplacebo_tpu/utils/upload.py
(:164-197): raw integer texels upload as they are and the UNORM
normalization, the packed-word unpacking and the (H, W, C) -> (C, H, W)
relayout run on the device, like a GPU sampler's UNORM conversion.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.colorspace import BitEncoding, ColorRepr, ColorSpace
from ..render.frame import Frame, Plane
from .device import raw_to_device, resolve_device

__all__ = ["PlaneData", "upload_plane", "frame_from_planes",
           "plane_data_from_mask", "plane_data_from_comps",
           "plane_data_align", "CHROMA_OFFSETS", "chroma_location_offset"]

# reference pl_chroma_location_offset (colorspace.c:978): the chroma
# sample's shift from centered, in reference-plane pixels
CHROMA_OFFSETS = {
    "left": (-0.5, 0.0),
    "center": (0.0, 0.0),
    "top_left": (-0.5, -0.5),
    "top_center": (0.0, -0.5),
    "bottom_left": (-0.5, 0.5),
    "bottom_center": (0.0, 0.5),
}


def chroma_location_offset(loc: str) -> Tuple[float, float]:
    """The (x, y) shift of a chroma siting; unknown names are "left"."""
    return CHROMA_OFFSETS.get(loc, CHROMA_OFFSETS["left"])


@dataclass
class PlaneData:
    """Reference pl_plane_data: a (H, W) or (H, W, C) array with one
    element per component sample, or (with `component_size`) a (H, W)
    array of packed integer words unpacked LSB-first."""
    data: np.ndarray
    component_map: Tuple[int, ...] = (0,)
    bit_depth: int = 0                   # 0 = infer from dtype
    bit_shift: int = 0
    shift_x: float = 0.0
    shift_y: float = 0.0
    component_size: Tuple[int, ...] = ()
    component_pad: Tuple[int, ...] = ()


def plane_data_from_comps(sizes, shifts):
    """(component_size, component_pad, component_map) from per-component
    bit sizes and shifts in RGBA order (reference
    pl_plane_data_from_comps, upload.c:47)."""
    comps = sorted(
        ((shifts[i], sizes[i], i) for i in range(len(sizes)) if sizes[i]),
        key=lambda c: c[0])
    size, pad, cmap = [], [], []
    offset = 0
    for shift, sz, order in comps:
        if shift < offset:
            raise ValueError("overlapping component bit ranges")
        size.append(sz)
        pad.append(shift - offset)
        cmap.append(order)
        offset += sz + (shift - offset)
    return tuple(size), tuple(pad), tuple(cmap)


def plane_data_from_mask(masks):
    """plane_data_from_comps from per-component bit masks, each a
    contiguous run of set bits (reference pl_plane_data_from_mask)."""
    sizes, shifts = [], []
    for m in masks:
        m = int(m)
        size = bin(m).count("1")
        shift = (m & -m).bit_length() - 1 if m else 0
        if m and (((1 << size) - 1) << shift) != m:
            raise ValueError(f"non-contiguous component mask {m:#x}")
        sizes.append(size)
        shifts.append(shift)
    return plane_data_from_comps(sizes, shifts)


def plane_data_align(size, pad):
    """Widen byte-misaligned packed components to byte boundaries
    (reference pl_plane_data_align, upload.c:96: left padding becomes a
    bit shift, right padding ignored zeros).  (size', pad', BitEncoding)
    when every component aligns the same way, else None."""
    size, pad = list(size), list(pad)
    color_depth = sample_depth = bit_shift = None
    offset = 0
    for i in range(len(size)):
        if color_depth is None:
            color_depth = size[i]
        elif color_depth != size[i]:
            return None
        comp_start = offset + pad[i]
        left = min(comp_start - ((comp_start - 7 + 7) & ~7), pad[i])
        pad[i] -= left
        size[i] += left
        if bit_shift is None:
            bit_shift = left
        elif bit_shift != left:
            return None
        comp_end = comp_start + size[i] - left
        right = ((comp_end + 7) & ~7) - comp_end
        if i + 1 == len(size):
            size[i] += right
        else:
            right = min(right, pad[i + 1])
            size[i] += right
            pad[i + 1] -= right
        if sample_depth is None:
            sample_depth = size[i]
        elif sample_depth != size[i]:
            return None
        offset += pad[i] + size[i]
    if sample_depth is None:
        return None
    return (tuple(size), tuple(pad),
            BitEncoding(sample_depth=sample_depth, color_depth=color_depth,
                        bit_shift=bit_shift))


def _unpack_words(raw, divs, layout):
    """(H, W) packed words -> (C, H, W) float32; the divisors are a
    device tensor, so each divide is a true one."""
    xu = raw.to(torch.int64)
    comps = [((xu >> off) & ((1 << sz) - 1)).to(torch.float32) / divs[i]
             for i, (off, sz) in enumerate(layout)]
    return torch.stack(comps, dim=0)


def upload_plane(pd: PlaneData, device=None) -> Plane:
    """Normalize + upload one plane (reference pl_upload_plane)."""
    dev = resolve_device(device)
    arr = np.asarray(pd.data)
    if pd.component_size:
        if arr.ndim != 2 or not np.issubdtype(arr.dtype, np.integer) \
                or arr.dtype.itemsize > 4:
            raise ValueError("packed layout needs a 2D integer word array "
                             "of at most 32 bits")
        pads = pd.component_pad or (0,) * len(pd.component_size)
        layout, offset = [], 0
        for sz, pad in zip(pd.component_size, pads):
            offset += pad
            layout.append((offset, sz))
            offset += sz
        raw = raw_to_device(arr, dev)
        divs = torch.tensor([float((1 << sz) - 1) for _, sz in layout],
                            dtype=torch.float32, device=dev)
        data = _unpack_words(raw, divs, layout)
    else:
        if arr.ndim == 2:
            arr = arr[..., None]
        assert arr.shape[-1] == len(pd.component_map)
        if np.issubdtype(arr.dtype, np.integer):
            depth = pd.bit_depth or arr.dtype.itemsize * 8
            raw = raw_to_device(arr, dev)
            if pd.bit_shift:
                raw = raw >> pd.bit_shift
            f = raw.to(torch.float32) * (1.0 / float(2 ** depth - 1))
        else:
            f = torch.from_numpy(np.ascontiguousarray(
                arr.astype(np.float32))).to(dev)
        data = f.permute(2, 0, 1).contiguous()
    return Plane(data=data, component_mapping=tuple(pd.component_map),
                 shift_x=pd.shift_x, shift_y=pd.shift_y)


def frame_from_planes(planes: Sequence[PlaneData],
                      repr: Optional[ColorRepr] = None,
                      color: Optional[ColorSpace] = None,
                      chroma_location: str = "left",
                      device=None) -> Frame:
    """A Frame from raw plane descriptions on `device` (None = "cuda");
    subsampled planes without a shift of their own get the chroma
    siting's."""
    ref_w = max(np.asarray(p.data).shape[1] for p in planes)
    ref_h = max(np.asarray(p.data).shape[0] for p in planes)
    cx, cy = chroma_location_offset(chroma_location)
    out = []
    for p in planes:
        h, w = np.asarray(p.data).shape[:2]
        if (w < ref_w or h < ref_h) and not (p.shift_x or p.shift_y):
            p = replace(p, shift_x=cx if w < ref_w else 0.0,
                        shift_y=cy if h < ref_h else 0.0)
        out.append(upload_plane(p, device))
    return Frame(planes=out, repr=repr or ColorRepr(),
                 color=color or ColorSpace())

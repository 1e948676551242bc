"""YUV4MPEG2 (.y4m) reader/writer + PNG still-image I/O.

Counterpart of libplacebo_tpu/utils/y4m.py (numpy on the host, the same
bytes in and out): an ASCII `YUV4MPEG2` header line with tagged
parameters, then `FRAME\n` and the packed planes of each frame.

`Y4MReader.read_raw` returns the integer planes as numpy arrays;
`read_frame` (and iteration) returns the port's `Frame`, its planes
normalized on the host in float32 exactly as the reference normalizes
them and uploaded to the reader's device (None = "cuda"; raises without
a GPU unless given device="cpu") from pinned memory.  Chroma siting
follows the C tag (C420jpeg center, C420mpeg2 / C420 left, C420paldv
top-left), the range the XCOLORRANGE tag (limited by default), the
matrix the width (BT.709 at >= 1280, else BT.601), and the field order
the interlace tag.

`Y4MWriter.write` takes full-resolution (C, H, W) planes (numpy or
tensors, float in [0, 1] or integer codes) and box-averages chroma in
float64 for 4:2:0 and 4:2:2, as the reference does.  PNG goes through
PIL, imported at first use.
"""
from __future__ import annotations

import fractions
import os
from dataclasses import dataclass
from typing import IO, Iterator, Optional, Tuple, Union

import numpy as np

import torch

from ..core.colorspace import (BitEncoding, ColorLevels, ColorRepr,
                               ColorSpace, ColorSystem)
from ..ops.deinterlace import Field
from ..render.frame import Frame, Plane
from .device import resolve_device
from .upload import chroma_location_offset

__all__ = ["Y4MInfo", "Y4MReader", "Y4MWriter", "read_y4m", "write_png",
           "read_png"]


# C-tag -> (sub_x, sub_y, bit_depth, n_planes, chroma siting)
_CSP_TAGS = {
    "420jpeg":  (1, 1, 8, 3, "center"),
    "420mpeg2": (1, 1, 8, 3, "left"),
    "420paldv": (1, 1, 8, 3, "top_left"),
    "420":      (1, 1, 8, 3, "left"),
    "422":      (1, 0, 8, 3, "left"),
    "444":      (0, 0, 8, 3, "center"),
    "mono":     (0, 0, 8, 1, "center"),
}
for _d in (9, 10, 12, 14, 16):
    _CSP_TAGS[f"420p{_d}"] = (1, 1, _d, 3, "left")
    _CSP_TAGS[f"422p{_d}"] = (1, 0, _d, 3, "left")
    _CSP_TAGS[f"444p{_d}"] = (0, 0, _d, 3, "center")
    _CSP_TAGS[f"mono{_d}"] = (0, 0, _d, 1, "center")


@dataclass
class Y4MInfo:
    """Parsed YUV4MPEG2 stream header."""
    width: int
    height: int
    fps: fractions.Fraction = fractions.Fraction(25, 1)
    interlace: str = "p"            # p / t / b / m
    aspect: fractions.Fraction = fractions.Fraction(0, 1)
    csp: str = "420mpeg2"           # C tag (without the leading C)
    extensions: tuple = ()          # unrecognized X tags, verbatim

    @property
    def layout(self):
        return _CSP_TAGS[self.csp]

    @property
    def bit_depth(self) -> int:
        return self.layout[2]

    @property
    def frame_bytes(self) -> int:
        sx, sy, depth, n_planes, _ = self.layout
        bpp = 2 if depth > 8 else 1
        luma = self.width * self.height
        chroma = ((self.width + sx) >> sx) * ((self.height + sy) >> sy)
        return bpp * (luma + (n_planes - 1) * chroma)


def _parse_ratio(text: str) -> fractions.Fraction:
    num, _, den = text.partition(":")
    den = int(den or 1)
    if den == 0:
        return fractions.Fraction(0, 1)
    return fractions.Fraction(int(num), den)


def _parse_header(line: bytes) -> Y4MInfo:
    parts = line.decode("ascii", "replace").split()
    if not parts or parts[0] != "YUV4MPEG2":
        raise ValueError("not a YUV4MPEG2 stream (bad magic)")
    info = dict(width=0, height=0)
    exts = []
    for tag in parts[1:]:
        key, val = tag[0], tag[1:]
        if key == "W":
            info["width"] = int(val)
        elif key == "H":
            info["height"] = int(val)
        elif key == "F":
            info["fps"] = _parse_ratio(val)
        elif key == "I":
            info["interlace"] = val or "p"
        elif key == "A":
            info["aspect"] = _parse_ratio(val)
        elif key == "C":
            csp = val.lower()
            if csp not in _CSP_TAGS:
                raise ValueError(f"unsupported colorspace tag C{val}")
            info["csp"] = csp
        elif key == "X":
            exts.append(val)
    out = Y4MInfo(extensions=tuple(exts), **info)
    if out.width <= 0 or out.height <= 0:
        raise ValueError("YUV4MPEG2 header missing W/H")
    return out


class Y4MReader:
    """Streaming .y4m demuxer yielding `Frame` objects.

    >>> with Y4MReader("clip.y4m") as r:
    ...     for frame in r:          # render.frame.Frame, planar float
    ...         out = renderer.render(frame, target)
    """

    def __init__(self, path_or_file: Union[str, os.PathLike, IO[bytes]],
                 device=None):
        if hasattr(path_or_file, "read"):
            self._f, self._owns = path_or_file, False
        else:
            self._f, self._owns = open(path_or_file, "rb"), True
        self.info = _parse_header(self._f.readline().rstrip(b"\n"))
        # where read_frame puts the planes (resolved there, so that
        # read_raw needs no device)
        self.device = device

    # -- context manager / iteration ------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._owns:
            self._f.close()

    def __iter__(self) -> Iterator[Frame]:
        while True:
            frame = self.read_frame()
            if frame is None:
                return
            yield frame

    # -- decoding --------------------------------------------------------
    def read_raw(self) -> Optional[Tuple[np.ndarray, ...]]:
        """Next frame as raw integer planes ((H,W) y [, u, v]) or None."""
        line = self._f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad frame marker: {line[:20]!r}")
        info = self.info
        sx, sy, depth, n_planes, _ = info.layout
        dtype = np.dtype("<u2") if depth > 8 else np.dtype("u1")
        data = self._f.read(info.frame_bytes)
        if len(data) < info.frame_bytes:
            raise ValueError("truncated FRAME payload")
        w, h = info.width, info.height
        cw, ch = (w + sx) >> sx, (h + sy) >> sy
        buf = np.frombuffer(data, dtype=dtype)
        y = buf[:w * h].reshape(h, w)
        if n_planes == 1:
            return (y,)
        u = buf[w * h:w * h + cw * ch].reshape(ch, cw)
        v = buf[w * h + cw * ch:].reshape(ch, cw)
        return (y, u, v)

    def read_frame(self) -> Optional[Frame]:
        dev = resolve_device(self.device)
        raw = self.read_raw()
        if raw is None:
            return None
        info = self.info
        sx, sy, depth, n_planes, siting = info.layout
        scale = np.float32(1.0 / ((1 << depth) - 1))

        def norm(p):
            # the reference's host arithmetic: a float32 product
            t = torch.from_numpy(np.asarray(p, np.float32) * scale)
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t

        # siting offsets in ref-pixel units (utils/upload.py table)
        off_x, off_y = chroma_location_offset(siting)
        if n_planes == 1:
            planes = [Plane(norm(raw[0])[None], (0,))]
            repr_ = ColorRepr(sys=ColorSystem.RGB, levels=ColorLevels.FULL,
                              bits=BitEncoding(depth, depth, 0))
        else:
            planes = [
                Plane(norm(raw[0])[None], (0,)),
                Plane(norm(raw[1])[None], (1,),
                      shift_x=off_x if sx else 0.0,
                      shift_y=off_y if sy else 0.0),
                Plane(norm(raw[2])[None], (2,),
                      shift_x=off_x if sx else 0.0,
                      shift_y=off_y if sy else 0.0),
            ]
            # x264/ffmpeg emit an XCOLORRANGE extension tag; default is
            # limited (studio) range per the mjpegtools convention
            levels = ColorLevels.LIMITED
            if any(e.upper() == "COLORRANGE=FULL"
                   for e in info.extensions):
                levels = ColorLevels.FULL
            repr_ = ColorRepr(
                sys=(ColorSystem.BT_709 if info.width >= 1280
                     else ColorSystem.BT_601),
                levels=levels,
                bits=BitEncoding(depth, depth, 0))
        first_field = None
        if info.interlace in ("t", "b"):
            first_field = Field.TOP if info.interlace == "t" \
                else Field.BOTTOM
        return Frame(planes=planes, repr=repr_, color=ColorSpace(),
                     first_field=first_field)


def read_y4m(path, device=None) -> Tuple[Y4MInfo, list]:
    """Eagerly read a whole .y4m file -> (info, [Frame, ...])."""
    with Y4MReader(path, device=device) as r:
        return r.info, list(r)


def _host(p) -> np.ndarray:
    """A plane as a host array (a tensor is copied off its device)."""
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


class Y4MWriter:
    """Streaming .y4m muxer.

    Accepts full-resolution planes and downsamples chroma itself, so a
    `Renderer` output encoded to YUV writes straight to a file other
    tools can read.  `extensions` are X tags appended to the header
    ("COLORRANGE=LIMITED" writes XCOLORRANGE=LIMITED); without them the
    bytes are the reference writer's.
    """

    def __init__(self, path_or_file, width: int, height: int,
                 fps=(25, 1), csp: str = "420mpeg2",
                 interlace: str = "p", extensions: Tuple[str, ...] = ()):
        csp = csp.lower().lstrip("c")
        if csp not in _CSP_TAGS:
            raise ValueError(f"unsupported colorspace tag C{csp}")
        if hasattr(path_or_file, "write"):
            self._f, self._owns = path_or_file, False
        else:
            self._f, self._owns = open(path_or_file, "wb"), True
        self.info = Y4MInfo(width=width, height=height,
                            fps=fractions.Fraction(*fps), csp=csp,
                            interlace=interlace,
                            extensions=tuple(extensions))
        fr = self.info.fps
        hdr = (f"YUV4MPEG2 W{width} H{height} "
               f"F{fr.numerator}:{fr.denominator} I{interlace} A0:0 "
               f"C{csp}" + "".join(f" X{e}" for e in extensions) + "\n")
        self._f.write(hdr.encode("ascii"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._owns:
            self._f.close()

    def _quantize(self, p: np.ndarray) -> np.ndarray:
        depth = self.info.bit_depth
        dtype = np.dtype("<u2") if depth > 8 else np.dtype("u1")
        p = np.asarray(p)
        if np.issubdtype(p.dtype, np.integer):
            return p.astype(dtype)
        maxv = (1 << depth) - 1
        return np.clip(np.rint(np.asarray(p, np.float64) * maxv),
                       0, maxv).astype(dtype)

    def write(self, planes) -> None:
        """Write one frame. `planes` is (3, H, W) / (1, H, W) (or a
        tuple of per-plane arrays, already-subsampled allowed); float
        in [0,1] or integers at the target depth."""
        info = self.info
        sx, sy, _, n_planes, _ = info.layout
        w, h = info.width, info.height
        cw, ch = (w + sx) >> sx, (h + sy) >> sy
        if isinstance(planes, (tuple, list)):
            parts = [_host(p) for p in planes]
        else:
            arr = _host(planes)
            if arr.ndim != 3:
                raise ValueError("expected (C, H, W) planes")
            parts = [arr[i] for i in range(arr.shape[0])]
        if len(parts) != n_planes:
            raise ValueError(f"C{info.csp} needs {n_planes} planes, "
                             f"got {len(parts)}")
        out = []
        for i, p in enumerate(parts):
            tw, th = (w, h) if i == 0 else (cw, ch)
            if p.shape != (th, tw):
                if p.shape != (h, w):
                    raise ValueError(
                        f"plane {i}: expected {(th, tw)} or full-res "
                        f"{(h, w)}, got {p.shape}")
                # box-average downsample (even dims; y4m requires them
                # for subsampled formats anyway)
                if w % (1 << sx) or h % (1 << sy):
                    raise ValueError("subsampled y4m needs even W/H")
                p = np.asarray(p, np.float64)
                if np.issubdtype(np.asarray(parts[i]).dtype, np.integer):
                    p = p / ((1 << info.bit_depth) - 1)
                if sy:
                    p = 0.5 * (p[0::2] + p[1::2])
                if sx:
                    p = 0.5 * (p[:, 0::2] + p[:, 1::2])
            out.append(self._quantize(p))
        self._f.write(b"FRAME\n")
        for p in out:
            self._f.write(np.ascontiguousarray(p).tobytes())


# ---------------------------------------------------------------------------
# PNG stills (PIL-backed; import deferred so the module stays optional)
# ---------------------------------------------------------------------------

def write_png(path, rgb: np.ndarray, depth: int = 8) -> None:
    """Save (3, H, W) / (H, W, 3) float [0,1] (or integer) RGB as PNG.
    depth 16 writes 16-bit grayscale/RGB PNGs."""
    from PIL import Image
    arr = _host(rgb)
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and \
            arr.shape[0] < arr.shape[-1]:
        arr = np.moveaxis(arr, 0, -1)
    if np.issubdtype(arr.dtype, np.floating):
        maxv = (1 << depth) - 1
        arr = np.clip(np.rint(arr.astype(np.float64) * maxv),
                      0, maxv).astype(np.uint16 if depth > 8 else np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.dtype == np.uint16:
        if arr.ndim == 2:
            Image.fromarray(arr).save(path)      # PIL picks I;16
        else:
            # PIL lacks 16-bit RGB; split channels into one PNG each is
            # overkill — round to 8-bit with a note in the docstring
            arr = (arr >> 8).astype(np.uint8)
            Image.fromarray(arr).save(path)
    else:
        Image.fromarray(arr).save(path)


def read_png(path) -> np.ndarray:
    """Load an image file -> planar (C, H, W) float32 in [0,1]."""
    from PIL import Image
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16 or arr.dtype == np.int32:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = np.moveaxis(arr, -1, 0)
    return arr

"""ICC profile parsing (host, numpy).

Counterpart of libplacebo_tpu/core/icc.py (reference src/shaders/icc.c,
built on lcms2): profile parsing, gamut/TRC inference, and the host
transforms the decode/encode stages are built from.  A self-contained
parser for the ICC v2/v4 profiles displays use:

* matrix/TRC profiles (rXYZ/gXYZ/bXYZ + curv/para TRCs + wtpt, chad)
* cLUT profiles: lut8/lut16 ('mft1'/'mft2') and v4 lutAToB/lutBToA
  ('mAB '/'mBA ') pipelines with XYZ or Lab PCS, evaluated on the host
  and baked into a 3D LUT for the device (the reference's lcms transform
  sampled into a 3D texture, icc.c:624).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .colorspace import (CIE_D50, CIExy, RawPrimaries, adapt_white_matrix)

__all__ = ["IccProfile", "IccError", "IccLut", "parse_icc"]


class IccError(ValueError):
    pass


def _s15f16(v: int) -> float:
    return v / 65536.0


@dataclass
class IccCurve:
    """A TRC: either a pure gamma, a sampled table, or parametric."""
    kind: str                  # "gamma" | "table" | "para"
    gamma: float = 1.0
    table: Optional[np.ndarray] = None      # normalized [0,1]
    para: Tuple[float, ...] = ()
    para_type: int = 0

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Signal -> linear, vectorized (numpy array)."""
        if self.kind == "gamma":
            return np.maximum(x, 0.0) ** self.gamma
        if self.kind == "table":
            t = np.clip(x, 0.0, 1.0) * (len(self.table) - 1)
            lo = np.floor(t).astype(np.int64)
            hi = np.minimum(lo + 1, len(self.table) - 1)
            f = t - lo
            return self.table[lo] * (1 - f) + self.table[hi] * f
        # parametric (ICC paraCurveType): types 0-4
        p = self.para
        g = p[0]
        x = np.asarray(x, dtype=np.float64)
        if self.para_type == 0:
            return np.maximum(x, 0.0) ** g
        if self.para_type == 1:
            a, b = p[1], p[2]
            return np.where(x >= -b / a, np.maximum(a * x + b, 0.0) ** g, 0.0)
        if self.para_type == 2:
            a, b, c = p[1], p[2], p[3]
            return np.where(x >= -b / a,
                            np.maximum(a * x + b, 0.0) ** g + c, c)
        if self.para_type == 3:  # sRGB-style
            a, b, c, d = p[1], p[2], p[3], p[4]
            return np.where(x >= d, np.maximum(a * x + b, 0.0) ** g, c * x)
        if self.para_type == 4:
            a, b, c, d, e, f = p[1], p[2], p[3], p[4], p[5], p[6]
            return np.where(x >= d,
                            np.maximum(a * x + b, 0.0) ** g + e, c * x + f)
        raise IccError(f"unsupported parametric curve type {self.para_type}")

    def eval_inverse(self, y: np.ndarray, samples: int = 4096) -> np.ndarray:
        """Numeric inverse via a monotone resampled table."""
        xs = np.linspace(0.0, 1.0, samples)
        ys = self.eval(xs)
        return np.interp(np.clip(y, ys[0], ys[-1]), ys, xs)


@dataclass
class IccProfile:
    """Parsed profile (subset of pl_icc_object, shaders/icc.h)."""
    color_space: str
    pcs: str
    version: int
    white: CIExy
    rgb2xyz: Optional[np.ndarray] = None       # to PCS (D50) XYZ
    trc: Tuple[IccCurve, ...] = ()
    chad: Optional[np.ndarray] = None
    description: str = ""
    a2b: Optional["IccLut"] = None             # device -> PCS (decode)
    b2a: Optional["IccLut"] = None             # PCS -> device (encode)
    # content signature (crc32 of the raw profile bytes): the stable plan
    # cache key — id() would alias a new profile reusing a freed address
    # (reference: pl_icc caches by a 64-bit signature, icc.c)
    signature: int = 0

    # -- cLUT transforms through the PCS (reference uses lcms transforms;
    # icc.c:624-720 then bakes them into a 3D texture) -------------------
    def a2b_to_xyz(self, signal: np.ndarray) -> np.ndarray:
        """Device signal (...,3) in [0,1] -> PCS XYZ (D50-relative)."""
        if self.a2b is None:
            raise IccError("profile has no A2B LUT")
        out = self.a2b.eval(np.clip(signal, 0.0, 1.0))
        wp = np.asarray(CIE_D50.to_XYZ(), np.float64)
        if self.pcs == "Lab":
            return lab_to_xyz(lab_decode(out, self.a2b.legacy), wp)
        return out / XYZ16_SCALE

    def xyz_to_b2a(self, xyz: np.ndarray) -> np.ndarray:
        """PCS XYZ (D50-relative) -> device signal (...,3) in [0,1]."""
        if self.b2a is None:
            raise IccError("profile has no B2A LUT")
        wp = np.asarray(CIE_D50.to_XYZ(), np.float64)
        if self.pcs == "Lab":
            enc = lab_encode(xyz_to_lab(xyz, wp), self.b2a.legacy)
        else:
            enc = np.asarray(xyz) * XYZ16_SCALE
        return self.b2a.eval(np.clip(enc, 0.0, 1.0))

    def containing_primaries(self) -> RawPrimaries:
        """Infer the gamut from the matrix columns (reference
        pl_icc_open's gamut detection)."""
        if self.rgb2xyz is None:
            raise IccError("no matrix to infer primaries")
        m = self.rgb2xyz
        # undo chromatic adaptation to D50 to get display-white XYZ
        adapt = adapt_white_matrix(self.white, CIE_D50).invert().m \
            if self.white else np.eye(3)
        cols = adapt @ m
        prims = []
        for i in range(3):
            X, Y, Z = cols[:, i]
            s = X + Y + Z
            prims.append(CIExy(X / s, Y / s))
        W = cols @ np.ones(3)
        ws = W.sum()
        white = CIExy(W[0] / ws, W[1] / ws)
        return RawPrimaries(red=prims[0], green=prims[1], blue=prims[2],
                            white=white)

    def decode(self, rgb: np.ndarray) -> np.ndarray:
        """Signal RGB (...,3) -> linear display RGB (per-channel TRC)."""
        out = np.stack([self.trc[i].eval(rgb[..., i]) for i in range(3)],
                       axis=-1)
        return out

    def encode(self, rgb_linear: np.ndarray) -> np.ndarray:
        return np.stack([self.trc[i].eval_inverse(rgb_linear[..., i])
                         for i in range(3)], axis=-1)


@dataclass
class IccLut:
    """A parsed cLUT pipeline (lut8/lut16/lutAToB/lutBToA types).

    Canonical stage order (input -> output):
      matrix_pre -> in_curves -> clut -> m_curves -> matrix_post -> b_curves
    where unused stages are None.  mft1/mft2 populate matrix_pre +
    in_curves + clut + out_curves(b_curves); mAB populates
    in_curves(A) + clut + m_curves + matrix_post + b_curves; mBA is
    stored pre-reversed into the same canonical order
    (B -> matrix -> M -> clut -> A) via the `mba` flag.
    """
    clut: np.ndarray                     # (g1, g2, g3, out_ch)
    in_curves: Optional[Tuple[IccCurve, ...]] = None
    b_curves: Optional[Tuple[IccCurve, ...]] = None
    m_curves: Optional[Tuple[IccCurve, ...]] = None
    matrix: Optional[np.ndarray] = None  # (3,4): 3x3 + offset column
    mba: bool = False                    # lutBToA stage order
    legacy: bool = False                 # mft1/mft2 (v2 PCS encodings)
    # mft1/mft2 matrix: applies to the INPUT (only meaningful when the
    # input side is PCS XYZ, i.e. B2A direction) — §10.9/10.10
    matrix_pre: Optional[np.ndarray] = None

    @staticmethod
    def _curves(curves, x):
        if curves is None:
            return x
        return np.stack([curves[i].eval(x[..., i])
                         for i in range(x.shape[-1])], axis=-1)

    def _apply_matrix(self, x):
        if self.matrix is None:
            return x
        return x @ self.matrix[:, :3].T + self.matrix[:, 3]

    def _apply_clut(self, x):
        g = self.clut.shape[:-1]
        out = self.clut.shape[-1]
        idx = [np.clip(x[..., i], 0.0, 1.0) * (g[i] - 1) for i in range(3)]
        lo = [np.floor(t).astype(np.int64) for t in idx]
        hi = [np.minimum(l + 1, g[i] - 1) for i, l in enumerate(lo)]
        f = [t - l for t, l in zip(idx, lo)]
        acc = np.zeros(x.shape[:-1] + (out,))
        for corner in range(8):
            ii = [(hi if (corner >> k) & 1 else lo)[k] for k in range(3)]
            w = np.ones(x.shape[:-1])
            for k in range(3):
                w = w * (f[k] if (corner >> k) & 1 else 1.0 - f[k])
            acc += w[..., None] * self.clut[ii[0], ii[1], ii[2]]
        return acc

    def eval(self, x: np.ndarray) -> np.ndarray:
        """x: (..., 3) in the type's raw normalized input encoding;
        returns (..., out) raw normalized output."""
        x = np.asarray(x, dtype=np.float64)
        if self.mba:   # B -> matrix -> M -> CLUT -> A
            x = self._curves(self.b_curves, x)
            x = self._apply_matrix(x)
            x = self._curves(self.m_curves, x)
            x = self._apply_clut(np.clip(x, 0.0, 1.0))
            return self._curves(self.in_curves, np.clip(x, 0.0, 1.0))
        # (matrix_pre) -> A/in -> CLUT -> M -> matrix -> B/out
        if self.matrix_pre is not None:
            x = x @ self.matrix_pre[:, :3].T + self.matrix_pre[:, 3]
        x = self._curves(self.in_curves, np.clip(x, 0.0, 1.0))
        x = self._apply_clut(np.clip(x, 0.0, 1.0))
        x = self._curves(self.m_curves, np.clip(x, 0.0, 1.0))
        x = self._apply_matrix(x)
        return self._curves(self.b_curves, np.clip(x, 0.0, 1.0))


def _table_curve(vals: np.ndarray) -> IccCurve:
    return IccCurve("table", table=np.asarray(vals, np.float64))


def _parse_mft(data: bytes) -> IccLut:
    """lut8Type ('mft1') / lut16Type ('mft2'), ICC v2 §10.9/10.10."""
    sig = data[:4]
    in_ch, out_ch, g = data[8], data[9], data[10]
    if in_ch != 3:
        raise IccError(f"unsupported cLUT input channels {in_ch}")
    mat = np.array([_s15f16(v) for v in
                    struct.unpack(">9i", data[12:48])]).reshape(3, 3)
    matrix = None
    if not np.allclose(mat, np.eye(3)):
        matrix = np.concatenate([mat, np.zeros((3, 1))], axis=1)
    if sig == b"mft1":
        n_in = n_out = 256
        pos = 48
        raw = np.frombuffer(data[pos:], dtype=np.uint8).astype(np.float64)
        scale = 255.0
    else:
        n_in, n_out = struct.unpack(">HH", data[48:52])
        pos = 52
        raw = np.frombuffer(data[pos:], dtype=">u2").astype(np.float64)
        scale = 65535.0
    raw = raw / scale
    o = 0
    in_curves = tuple(_table_curve(raw[o + i * n_in:o + (i + 1) * n_in])
                      for i in range(in_ch))
    o += in_ch * n_in
    n_clut = g ** in_ch * out_ch
    clut = raw[o:o + n_clut].reshape((g,) * in_ch + (out_ch,))
    o += n_clut
    out_curves = tuple(_table_curve(raw[o + i * n_out:o + (i + 1) * n_out])
                       for i in range(out_ch))
    return IccLut(clut=clut, in_curves=in_curves, b_curves=out_curves,
                  matrix_pre=matrix, legacy=True)


def _parse_mab(data: bytes) -> IccLut:
    """lutAToBType ('mAB ') / lutBToAType ('mBA '), ICC v4 §10.12/10.13."""
    sig = data[:4]
    in_ch, out_ch = data[8], data[9]
    off_b, off_mat, off_m, off_clut, off_a = struct.unpack(
        ">5I", data[12:32])

    def curves(off, n):
        if off == 0:
            return None
        out, pos = [], off
        for _ in range(n):
            c, size = _parse_curve_sized(data[pos:])
            out.append(c)
            pos += (size + 3) & ~3          # 4-byte aligned
        return tuple(out)

    matrix = None
    if off_mat:
        vals = [_s15f16(v) for v in
                struct.unpack(">12i", data[off_mat:off_mat + 48])]
        m = np.array(vals[:9]).reshape(3, 3)
        offv = np.array(vals[9:])
        matrix = np.concatenate([m, offv[:, None]], axis=1)

    clut = None
    if off_clut:
        grid = list(data[off_clut:off_clut + 16])
        prec = data[off_clut + 16]
        nin = in_ch if sig == b"mAB " else 3
        g = grid[:nin]
        n = int(np.prod(g)) * out_ch if sig == b"mAB " \
            else int(np.prod(g)) * out_ch
        body = data[off_clut + 20:]
        if prec == 1:
            vals = np.frombuffer(body[:n], np.uint8).astype(np.float64) / 255
        else:
            vals = np.frombuffer(body[:2 * n],
                                 ">u2").astype(np.float64) / 65535
        clut = vals.reshape(tuple(g) + (out_ch,))
    if clut is None:
        raise IccError("cLUT-less mAB/mBA not supported")

    if sig == b"mAB ":   # A -> CLUT -> M -> matrix -> B
        if in_ch != 3:
            raise IccError(f"unsupported mAB input channels {in_ch}")
        return IccLut(clut=clut, in_curves=curves(off_a, in_ch),
                      m_curves=curves(off_m, out_ch), matrix=matrix,
                      b_curves=curves(off_b, out_ch))
    # mBA: B -> matrix -> M -> CLUT -> A
    return IccLut(clut=clut, in_curves=curves(off_a, out_ch),
                  m_curves=curves(off_m, in_ch), matrix=matrix,
                  b_curves=curves(off_b, in_ch), mba=True)


def _parse_curve_sized(data: bytes) -> Tuple[IccCurve, int]:
    """Parse a curv/para element and return (curve, bytes consumed)."""
    sig = data[:4]
    if sig == b"curv":
        (count,) = struct.unpack(">I", data[8:12])
        return _parse_curve(data), 12 + 2 * count
    if sig == b"para":
        (ptype,) = struct.unpack(">H", data[8:10])
        nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ptype]
        return _parse_curve(data), 12 + 4 * nparams
    raise IccError(f"unsupported embedded curve {sig!r}")


def _parse_lut_tag(data: bytes) -> IccLut:
    sig = data[:4]
    if sig in (b"mft1", b"mft2"):
        return _parse_mft(data)
    if sig in (b"mAB ", b"mBA "):
        return _parse_mab(data)
    raise IccError(f"unsupported LUT tag type {sig!r}")


# --- PCS encodings (ICC v2/v4 §6.3.4) --------------------------------------

def lab_decode(v: np.ndarray, legacy: bool) -> np.ndarray:
    """Normalized [0,1] PCS-Lab samples -> (L, a, b)."""
    v = np.asarray(v, np.float64)
    if legacy:     # 16-bit v2: L over 0..0xFF00/0xFFFF, ab = v*255.996-128
        L = v[..., 0] * (65535.0 / 65280.0) * 100.0
        a = v[..., 1] * (65535.0 / 256.0) - 128.0
        b = v[..., 2] * (65535.0 / 256.0) - 128.0
    else:
        L = v[..., 0] * 100.0
        a = v[..., 1] * 255.0 - 128.0
        b = v[..., 2] * 255.0 - 128.0
    return np.stack([L, a, b], axis=-1)


def lab_encode(lab: np.ndarray, legacy: bool) -> np.ndarray:
    lab = np.asarray(lab, np.float64)
    if legacy:
        return np.stack([lab[..., 0] / 100.0 * (65280.0 / 65535.0),
                         (lab[..., 1] + 128.0) * (256.0 / 65535.0),
                         (lab[..., 2] + 128.0) * (256.0 / 65535.0)], axis=-1)
    return np.stack([lab[..., 0] / 100.0,
                     (lab[..., 1] + 128.0) / 255.0,
                     (lab[..., 2] + 128.0) / 255.0], axis=-1)


_LAB_D = 6.0 / 29.0


def lab_to_xyz(lab: np.ndarray, wp: np.ndarray) -> np.ndarray:
    """CIELAB -> XYZ relative to white point XYZ `wp` (PCS: D50)."""
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = fy + lab[..., 1] / 500.0
    fz = fy - lab[..., 2] / 200.0

    def finv(t):
        return np.where(t > _LAB_D, t ** 3, 3 * _LAB_D ** 2 * (t - 4 / 29))
    return np.stack([wp[0] * finv(fx), wp[1] * finv(fy), wp[2] * finv(fz)],
                    axis=-1)


def xyz_to_lab(xyz: np.ndarray, wp: np.ndarray) -> np.ndarray:
    def f(t):
        t = np.maximum(t, 0.0)
        return np.where(t > _LAB_D ** 3, np.cbrt(t),
                        t / (3 * _LAB_D ** 2) + 4 / 29)
    fx = f(xyz[..., 0] / wp[0])
    fy = f(xyz[..., 1] / wp[1])
    fz = f(xyz[..., 2] / wp[2])
    return np.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)],
                    axis=-1)


# lut16 XYZ PCS encoding: 0x8000 == 1.0
XYZ16_SCALE = 32768.0 / 65535.0


def _parse_curve(data: bytes) -> IccCurve:
    sig = data[:4]
    if sig == b"curv":
        (count,) = struct.unpack(">I", data[8:12])
        if count == 0:
            return IccCurve("gamma", 1.0)
        if count == 1:
            (g,) = struct.unpack(">H", data[12:14])
            return IccCurve("gamma", g / 256.0)
        vals = np.frombuffer(data[12:12 + 2 * count],
                             dtype=">u2").astype(np.float64) / 65535.0
        return IccCurve("table", table=vals)
    if sig == b"para":
        (ptype,) = struct.unpack(">H", data[8:10])
        nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ptype)
        if nparams is None:
            raise IccError(f"bad parametric curve type {ptype}")
        raw = struct.unpack(f">{nparams}i", data[12:12 + 4 * nparams])
        return IccCurve("para", para=tuple(_s15f16(v) for v in raw),
                        para_type=ptype)
    raise IccError(f"unsupported curve tag {sig!r}")


def _parse_xyz(data: bytes) -> np.ndarray:
    if data[:4] != b"XYZ ":
        raise IccError("bad XYZ tag")
    x, y, z = struct.unpack(">3i", data[8:20])
    return np.array([_s15f16(x), _s15f16(y), _s15f16(z)])


def parse_icc(data: bytes, intent: str = "perceptual") -> IccProfile:
    """Parse an ICC profile (reference pl_icc_open, shaders/icc.c:523).

    `intent` selects which cLUT table pair serves the transform
    (reference pl_icc_params.intent): perceptual (A2B0/B2A0),
    relative/absolute colorimetric (*1), saturation (*2); missing
    tables fall back to whichever intent the profile provides."""
    if len(data) < 132:
        raise IccError("profile too small")
    size, = struct.unpack(">I", data[:4])
    color_space = data[16:20].decode("ascii", "replace").strip()
    pcs = data[20:24].decode("ascii", "replace").strip()
    version = data[8]

    (tag_count,) = struct.unpack(">I", data[128:132])
    if len(data) < 132 + 12 * tag_count:
        raise IccError("truncated tag table")
    tags: Dict[bytes, bytes] = {}
    for i in range(tag_count):
        off = 132 + 12 * i
        sig, toff, tsize = struct.unpack(">4sII", data[off:off + 12])
        if toff + tsize <= len(data):
            tags[sig] = data[toff:toff + tsize]

    if color_space != "RGB":
        raise IccError(f"unsupported profile color space {color_space!r}")
    has_matrix = all(t in tags for t in
                     (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC", b"gTRC", b"bTRC"))
    # A2B0/B2A0 = perceptual, *1 = (relative) colorimetric,
    # *2 = saturation (ICC v4 §9.2.1); `intent` picks the table, with
    # fallback to whichever exists (matching lcms/the reference's
    # intent-selection behavior, icc.c pl_icc_params.intent)
    intent_idx = {"perceptual": 0, "auto": 0, "relative": 1,
                  "absolute": 1, "saturation": 2}.get(intent, 0)

    def _load_lut(base: str):
        order = [intent_idx] + [i for i in range(3) if i != intent_idx]
        for i in order:
            tag = f"{base}{i}".encode()
            if tag not in tags:
                continue
            try:
                return _parse_lut_tag(tags[tag])
            except IccError:
                if not has_matrix:
                    raise
                return None
            except Exception as e:   # truncated/malformed tag body
                if not has_matrix:
                    raise IccError(
                        f"malformed {tag.decode()} tag: {e}") from e
                return None
        return None

    a2b = _load_lut("A2B")
    b2a = _load_lut("B2A")
    if not has_matrix and a2b is None and b2a is None:
        raise IccError("profile has neither matrix/TRC nor usable cLUTs")

    m = None
    trc = ()
    if has_matrix:
        m = np.stack([_parse_xyz(tags[b"rXYZ"]), _parse_xyz(tags[b"gXYZ"]),
                      _parse_xyz(tags[b"bXYZ"])], axis=1)
        trc = tuple(_parse_curve(tags[t])
                    for t in (b"rTRC", b"gTRC", b"bTRC"))

    white = CIE_D50
    if b"wtpt" in tags:
        W = _parse_xyz(tags[b"wtpt"])
        s = W.sum()
        if s > 0:
            white = CIExy(W[0] / s, W[1] / s)

    chad = None
    if b"chad" in tags and tags[b"chad"][:4] == b"sf32":
        vals = struct.unpack(">9i", tags[b"chad"][8:44])
        chad = np.array([_s15f16(v) for v in vals]).reshape(3, 3)
        # derive the actual display white by undoing the adaptation
        W = np.linalg.inv(chad) @ np.array(
            [CIE_D50.to_XYZ()[0], 1.0, CIE_D50.to_XYZ()[2]])
        s = W.sum()
        white = CIExy(W[0] / s, W[1] / s)

    desc = ""
    for dtag in (b"desc", b"dscm"):
        if dtag in tags and tags[dtag][:4] == b"desc":
            (dlen,) = struct.unpack(">I", tags[dtag][8:12])
            desc = tags[dtag][12:12 + dlen].decode("ascii", "replace")\
                .rstrip("\x00")
            break

    import zlib
    return IccProfile(color_space=color_space, pcs=pcs, version=version,
                      white=white, rgb2xyz=m, trc=trc, chad=chad,
                      description=desc, a2b=a2b, b2a=b2a,
                      signature=zlib.crc32(data))

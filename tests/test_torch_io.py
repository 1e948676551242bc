"""The port's YUV4MPEG2 / PNG I/O (utils/y4m.py) and framework interop
(utils/interop.py) against the JAX package's: the same bytes written,
the same raw planes and frames read, and the same frames mapped from
AVFrame-like and Dav1dPicture-like dicts and a PyAV stand-in, side data
included (tests/test_utils.py's cases)."""
import dataclasses
import enum
import io

import numpy as np
import pytest
import torch

from libplacebo_tpu.utils import interop as jinterop
from libplacebo_tpu.utils import y4m as jy4m
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core.common import Rotation
from libplacebo_tpu_torch.utils import interop as tinterop
from libplacebo_tpu_torch.utils import y4m as ty4m

CSPS = [("420mpeg2", 8), ("420jpeg", 8), ("420paldv", 8), ("422", 8),
        ("444", 8), ("mono", 8), ("420p10", 10), ("422p12", 12),
        ("444p16", 16), ("mono10", 10)]


def _fields(x):
    """A dataclass / enum / tuple tree as plain values, to compare the two
    packages' objects."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _same_frame(t, j):
    """Planes bit for bit, and the metadata, of a port and a JAX frame."""
    assert len(t.planes) == len(j.planes)
    for tp, jp in zip(t.planes, j.planes):
        np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
        assert tp.component_mapping == tuple(jp.component_mapping)
        assert (tp.shift_x, tp.shift_y) == (jp.shift_x, jp.shift_y)
        assert tp.components == jp.components
    assert _fields(t.repr) == _fields(j.repr)
    assert _fields(t.color) == _fields(j.color)
    assert int(t.rotation) == int(j.rotation)
    assert isinstance(t.rotation, Rotation)
    assert t.pixel_aspect_ratio == j.pixel_aspect_ratio
    assert t.crop == (None if j.crop is None else
                      type(t.crop)(j.crop.x0, j.crop.y0, j.crop.x1,
                                   j.crop.y1))
    assert (t.first_field is None) == (j.first_field is None)
    if t.first_field is not None:
        assert t.first_field.value == j.first_field.value
    assert _fields(t.film_grain) == _fields(j.film_grain)


# -- YUV4MPEG2 ------------------------------------------------------------

def _planes(w, h, csp, n, seed):
    sx, sy, d, n_planes, _ = ty4m._CSP_TAGS[csp]
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if d > 8 else np.uint8
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    out = []
    for _ in range(n):
        p = [rng.integers(0, 1 << d, (h, w)).astype(dtype)]
        p += [rng.integers(0, 1 << d, (ch, cw)).astype(dtype)
              for _ in range(n_planes - 1)]
        out.append(p)
    return out


def _write(mod, frames, w, h, csp, interlace="p"):
    buf = io.BytesIO()
    wr = mod.Y4MWriter(buf, w, h, fps=(30000, 1001), csp=csp,
                       interlace=interlace)
    for p in frames:
        wr.write(p)
    return buf.getvalue()


@pytest.mark.parametrize("csp,depth", CSPS)
def test_y4m_round_trip_matches_the_reference(csp, depth):
    """The port's writer writes the reference writer's bytes; the port's
    reader returns its raw planes; and the frames equal the reference
    reader's bit for bit (host float32 normalization)."""
    frames = _planes(16, 8, csp, 2, seed=depth)
    data = _write(ty4m, frames, 16, 8, csp)
    assert data == _write(jy4m, frames, 16, 8, csp)
    r = ty4m.Y4MReader(io.BytesIO(data), device="cpu")
    assert (r.info.csp, r.info.bit_depth) == (csp, depth)
    assert float(r.info.fps) == pytest.approx(30000 / 1001)
    for want in frames:
        for a, b in zip(want, r.read_raw()):
            np.testing.assert_array_equal(a, b)
    assert r.read_raw() is None
    got = list(ty4m.Y4MReader(io.BytesIO(data), device="cpu"))
    ref = list(jy4m.Y4MReader(io.BytesIO(data)))
    assert len(got) == len(ref) == 2
    for t, j in zip(got, ref):
        _same_frame(t, j)


@pytest.mark.parametrize("csp,interlace", [("420jpeg", "t"),
                                           ("420paldv", "b"),
                                           ("420mpeg2", "m"),
                                           ("444", "p")])
def test_y4m_interlace_and_siting_tags(csp, interlace):
    frames = _planes(1280, 4, csp, 1, seed=3)       # BT.709 by width
    data = _write(ty4m, frames, 1280, 4, csp, interlace)
    t = ty4m.read_y4m(io.BytesIO(data), device="cpu")[1][0]
    j = jy4m.read_y4m(io.BytesIO(data))[1][0]
    _same_frame(t, j)
    assert t.repr.sys == tcs.ColorSystem.BT_709


@pytest.mark.parametrize("tag", [b" XCOLORRANGE=FULL", b" XCOLORRANGE=LIMITED",
                                 b""])
def test_y4m_colorrange_extension_tag(tag):
    data = _write(ty4m, _planes(16, 8, "420mpeg2", 1, 4), 16, 8, "420mpeg2")
    head, _, rest = data.partition(b"\n")
    data = head + tag + b"\n" + rest
    r = ty4m.Y4MReader(io.BytesIO(data), device="cpu")
    assert r.info.extensions == jy4m.Y4MReader(io.BytesIO(data)).info \
        .extensions
    _same_frame(r.read_frame(), jy4m.Y4MReader(io.BytesIO(data))
                .read_frame())


def test_y4m_writer_extension_tags():
    buf = io.BytesIO()
    ty4m.Y4MWriter(buf, 4, 2, csp="420p10",
                   extensions=("COLORRANGE=LIMITED",)).write(
        _planes(4, 2, "420p10", 1, 5)[0])
    assert buf.getvalue().startswith(
        b"YUV4MPEG2 W4 H2 F25:1 Ip A0:0 C420p10 XCOLORRANGE=LIMITED\n")
    info = jy4m.Y4MReader(io.BytesIO(buf.getvalue())).info
    assert info.extensions == ("COLORRANGE=LIMITED",)


@pytest.mark.parametrize("csp", ["420jpeg", "420mpeg2", "422", "444",
                                 "420p10"])
@pytest.mark.parametrize("kind", ["float", "int", "tensor"])
def test_y4m_writer_downsamples_as_the_reference(csp, kind):
    """Full-resolution planes — float in [0, 1], integer codes, or
    tensors — are box-averaged in float64 and quantized with rint: the
    same bytes as the reference writer's."""
    w, h = 8, 4
    d = ty4m._CSP_TAGS[csp][2]
    rng = np.random.default_rng(1)
    yuv = rng.random((3, h, w)).astype(np.float32)
    if kind == "int":
        yuv = (yuv * ((1 << d) - 1)).astype(np.uint16 if d > 8
                                            else np.uint8)
    arg = torch.from_numpy(yuv) if kind == "tensor" else yuv
    got, want = io.BytesIO(), io.BytesIO()
    ty4m.Y4MWriter(got, w, h, csp=csp).write(arg)
    jy4m.Y4MWriter(want, w, h, csp=csp).write(yuv)
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("case", ["magic", "csp", "wh", "truncated",
                                  "writer_csp", "writer_planes"])
def test_y4m_errors_match(case):
    data = {"magic": b"JUNK W2 H2\n", "csp": b"YUV4MPEG2 W2 H2 C999\n",
            "wh": b"YUV4MPEG2 F25:1\n",
            "truncated": b"YUV4MPEG2 W4 H4\nFRAME\nxx"}.get(case)

    def run(mod):
        if case == "writer_csp":
            mod.Y4MWriter(io.BytesIO(), 4, 4, csp="nope")
        elif case == "writer_planes":
            mod.Y4MWriter(io.BytesIO(), 4, 4).write(np.zeros((2, 4, 4)))
        else:
            mod.Y4MReader(io.BytesIO(data)).read_raw()
    msgs = []
    for mod in (ty4m, jy4m):
        with pytest.raises(ValueError) as e:
            run(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_png_round_trip_matches(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(2)
    rgb = rng.random((3, 6, 5)).astype(np.float32)
    for depth, img in ((8, rgb), (16, rgb[:1])):
        a, b = tmp_path / f"t{depth}.png", tmp_path / f"j{depth}.png"
        ty4m.write_png(a, torch.from_numpy(img), depth=depth)
        jy4m.write_png(b, img, depth=depth)
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(ty4m.read_png(a), jy4m.read_png(b))


# -- interop: AVFrame-like dicts -----------------------------------------

def _av_data(fmt, h=8, w=16, seed=0):
    n_planes, (sx, sy), depth, comps = tinterop.AV_PIX_FMTS[fmt]
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if depth > 8 else np.uint8
    shift = tinterop._AV_PIX_FMT_SHIFT.get(fmt, 0)
    data = []
    for i in range(n_planes):
        sub = i in (1, 2) and n_planes >= 3 or (n_planes == 2 and i == 1)
        ph, pw = (h >> sy, w >> sx) if sub else (h, w)
        shape = (ph, pw) if len(comps[i]) == 1 else (ph, pw, len(comps[i]))
        data.append((rng.integers(0, 1 << depth, shape) << shift)
                    .astype(dtype))
    return data


@pytest.mark.parametrize("fmt", sorted(tinterop.AV_PIX_FMTS))
def test_avframe_formats_match(fmt):
    av = dict(format=fmt, data=_av_data(fmt), colorspace="bt709",
              color_range="tv", color_trc="bt709", color_primaries="bt709",
              chroma_location="top_left")
    _same_frame(tinterop.frame_from_avframe_like(av, device="cpu"),
                jinterop.frame_from_avframe_like(av))


def test_avframe_tables_and_errors():
    assert tinterop.AV_PIX_FMTS == jinterop.AV_PIX_FMTS
    assert tinterop._AV_PIX_FMT_SHIFT == jinterop._AV_PIX_FMT_SHIFT
    for name in ("_AVCOL_SPC", "_AVCOL_PRI", "_AVCOL_TRC", "_H273_MATRIX",
                 "_H273_PRI", "_H273_TRC"):
        assert _fields(getattr(tinterop, name)) == \
            _fields(getattr(jinterop, name)), name
    for fmt in ("yuv420p", "p010le", "weird", "p012le"):
        assert tinterop.test_pixfmt(fmt) == jinterop.test_pixfmt(fmt)
    with pytest.raises(ValueError):
        tinterop.frame_from_avframe_like(dict(format="weird", data=[]),
                                         device="cpu")
    with pytest.raises(ValueError, match="planes"):
        tinterop.frame_from_avframe_like(
            dict(format="yuv420p", data=[np.zeros((4, 4), np.uint8)]),
            device="cpu")


def _side_data(kind):
    from libplacebo_tpu_torch.utils.dolbyvision import parse_rpu
    base = dict(colorspace="bt2020nc", color_trc="smpte2084",
                color_primaries="bt2020", color_range="tv")
    if kind == "hdr10":
        base.update(mastering_display_metadata={
            "display_primaries": [[0.680, 0.320], [0.265, 0.690],
                                  [0.150, 0.060]],
            "white_point": [0.3127, 0.3290], "min_luminance": 0.0001,
            "max_luminance": 1000.0},
            content_light_level={"max_cll": 1000.0, "max_fall": 400.0})
    elif kind == "hdr10plus":
        base.update(hdr10plus={"scene_max": [500.0, 400.0, 300.0],
                               "scene_avg": 120.0, "target_luma": 400.0,
                               "knee_x": 0.2, "knee_y": 0.3,
                               "anchors": [0.1, 0.4, 0.7]})
    elif kind == "hdr10plus_no_curve":
        base.update(dynamic_hdr_plus={"scene_max": [500.0] * 3,
                                      "scene_avg": 100.0})
    elif kind == "av1_grain":
        base.update(film_grain={"type": "av1", "seed": 7, "av1": {
            "num_points_y": 2, "points_y": ((0, 32), (255, 64)),
            "ar_coeff_lag": 1, "ar_coeffs_y": (1, 2, 3, 4),
            "num_points_uv": (1, 0), "points_uv": (((0, 20),), ())}})
    elif kind == "h274_grain":
        base.update(film_grain={"type": "h274", "seed": 3, "h274": {
            "model_id": 0, "log2_scale_factor": 2,
            "component_model_present": (True, False, False),
            "num_intensity_intervals": (1, 0, 0),
            "num_model_values": (1, 0, 0),
            "intensity_interval_lower_bound": ((0,), (), ()),
            "intensity_interval_upper_bound": ((255,), (), ()),
            "comp_model_value": (((100,),), (), ())}})
    elif kind == "rotation_crop_sar":
        base.update(rotation=-90, crop_left=2, crop_top=1, crop_right=4,
                    sample_aspect_ratio=4 / 3)
    elif kind == "icc":
        from tests.test_icc_h274 import _make_profile
        base.update(icc_profile=_make_profile(gamma=2.6))
    elif kind == "broken_icc":
        base.update(icc_profile=b"acsp" * 3)
    elif kind == "dovi":
        with open("tests/golden/dovi/profile5.bin", "rb") as f:
            rpu = f.read()
        return base, parse_rpu(rpu)
    return base, None


@pytest.mark.parametrize("kind", ["hdr10", "hdr10plus", "hdr10plus_no_curve",
                                  "av1_grain", "h274_grain",
                                  "rotation_crop_sar", "icc", "broken_icc",
                                  "dovi"])
def test_avframe_side_data_matches(kind):
    """Mastering display, content light level, HDR10+ (its curve an
    HdrBezier), AV1 and H.274 grain, rotation (a Rotation), cropping,
    the sample aspect ratio, an ICC profile (a broken one ignored) and
    Dolby Vision metadata map as the reference maps them."""
    extra, rpu = _side_data(kind)
    av = dict(format="yuv420p10le", data=_av_data("yuv420p10le", seed=1),
              **extra)
    jav = dict(av)
    if rpu is not None:
        from libplacebo_tpu.utils.dolbyvision import rpu_to_dovi as j_r2d
        from libplacebo_tpu.utils.dolbyvision import parse_rpu as j_parse
        from libplacebo_tpu_torch.utils.dolbyvision import rpu_to_dovi
        with open("tests/golden/dovi/profile5.bin", "rb") as f:
            data = f.read()
        av["dovi"] = rpu_to_dovi(rpu)
        jav["dovi"] = j_r2d(j_parse(data))
    t = tinterop.frame_from_avframe_like(av, device="cpu")
    j = jinterop.frame_from_avframe_like(jav)
    _same_frame(t, j)
    assert (t.icc is None) == (j.icc is None)
    if kind == "hdr10plus":
        assert isinstance(t.color.hdr.ootf, tcs.HdrBezier)
        assert t.color.hdr.ootf.anchors == (0.1, 0.4, 0.7)
    if kind == "dovi":
        assert t.repr.sys == tcs.ColorSystem.DOLBYVISION
        assert _fields(t.repr.dovi) == _fields(j.repr.dovi)
    if kind == "icc":
        np.testing.assert_array_equal(t.icc.rgb2xyz, j.icc.rgb2xyz)
        assert t.icc.signature == j.icc.signature


@pytest.mark.parametrize("layout,depth", [("I400", 8), ("I420", 10),
                                          ("I422", 8), ("I444", 12)])
def test_dav1d_picture_matches(layout, depth):
    n_planes, (sx, sy) = tinterop._DAV1D_LAYOUTS[layout]
    rng = np.random.default_rng(2)
    dtype = np.uint16 if depth > 8 else np.uint8
    data = [rng.integers(0, 1 << depth, (8, 16)).astype(dtype)]
    data += [rng.integers(0, 1 << depth, (8 >> sy, 16 >> sx)).astype(dtype)
             for _ in range(n_planes - 1)]
    pic = {"layout": layout, "bitdepth": depth, "data": data,
           "seq_hdr": {"mtrx": 9, "pri": 9, "trc": 16, "color_range": 0,
                       "chr": 2},
           "frame_hdr": {"film_grain": {"seed": 3, "num_y_points": 1,
                                        "y_points": ((128, 40),)}}}
    _same_frame(tinterop.frame_from_dav1d_picture_like(pic, device="cpu"),
                jinterop.frame_from_dav1d_picture_like(pic))


class _PyAVPlane:
    def __init__(self, arr, pad):
        arr = np.pad(arr, ((0, 0), (0, pad)))     # a decoder's line stride
        self._b = arr.tobytes()
        self.line_size = arr.shape[1] * arr.itemsize

    def __bytes__(self):
        return self._b


class _SideData:
    def __init__(self, type_, d):
        self.type, self._d = type_, d

    def to_dict(self):
        return self._d


@pytest.mark.parametrize("fmt", ["yuv420p", "yuv420p10le", "nv12"])
def test_pyav_stand_in_matches(fmt):
    """frame_from_pyav on a duck-typed av.VideoFrame (PyAV is not
    installed): padded line strides, color properties, side data."""
    n_planes, (sx, sy), depth, comps = tinterop.AV_PIX_FMTS[fmt]
    rng = np.random.default_rng(3)
    dtype = np.uint16 if depth > 8 else np.uint8

    class Fmt:
        name = fmt

    class Frame:
        format = Fmt()
        width, height = 32, 16
        colorspace, color_primaries, color_trc = "bt709", "bt709", "bt709"
        color_range = 2
        sample_aspect_ratio = 1.25
        side_data = (_SideData("MASTERING_DISPLAY_METADATA", {
            "display_primaries": [[0.68, 0.32], [0.265, 0.69],
                                   [0.15, 0.06]],
            "white_point": [0.3127, 0.329], "min_luminance": 0.01,
            "max_luminance": 600.0}),
            _SideData("CONTENT_LIGHT_LEVELS", {"max_cll": 500.0,
                                               "max_fall": 100.0}))

        def __init__(self):
            self.planes = []
            for i in range(n_planes):
                h, w = (16, 32) if i == 0 else (16 >> sy, 32 >> sx)
                arr = rng.integers(0, 1 << depth,
                                   (h, w * len(comps[i]))).astype(dtype)
                self.planes.append(_PyAVPlane(arr, 3))
    f = Frame()
    _same_frame(tinterop.frame_from_pyav(f, device="cpu"),
                jinterop.frame_from_pyav(f))


def test_frame_to_avframe_like_matches():
    av = dict(format="yuv420p", data=_av_data("yuv420p", seed=4),
              colorspace="bt709", color_trc="bt709", color_primaries="bt709",
              color_range="tv", sample_aspect_ratio=0.75,
              content_light_level={"max_cll": 600.0, "max_fall": 200.0},
              mastering_display_metadata={
                  "display_primaries": [[0.64, 0.33], [0.3, 0.6],
                                        [0.15, 0.06]],
                  "white_point": [0.3127, 0.329], "min_luminance": 0.05,
                  "max_luminance": 400.0})
    got = tinterop.frame_to_avframe_like(
        tinterop.frame_from_avframe_like(av, device="cpu"))
    want = jinterop.frame_to_avframe_like(
        jinterop.frame_from_avframe_like(av))
    assert got.keys() == want.keys()
    for a, b in zip(got.pop("data"), want.pop("data")):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got == want


def test_dlpack_and_torch_interop():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = tinterop.from_dlpack(x)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), x)
    back = tinterop.from_dlpack(tinterop.to_dlpack(t))
    assert back.data_ptr() == t.data_ptr()
    assert tinterop.from_torch(t) is t and tinterop.to_torch(t) is t

"""The host API the port gained for the transcoder's path (rects and
transforms, Rotation, HdrBezier and the colorspace helpers, the Frame's
pixel aspect, crop test and chroma siting, white noise, the contrast
recovery features, the gamut-mapping host API) against the JAX package:
exact, host math being the same numpy on both sides."""
import dataclasses
import enum
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import common as jcm
from libplacebo_tpu.core import dither as jdither
from libplacebo_tpu.core import gamut_mapping as jgm
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_yuv
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import common as tcm
from libplacebo_tpu_torch.core import dither as tdither
from libplacebo_tpu_torch.core import gamut_mapping as tgm
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import dithering as tdithering
from libplacebo_tpu_torch.render.frame import frame_from_yuv420p as t_yuv


def _fields(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _rect_pair(r):
    return tcm.RectF(*r), jcm.RectF(*r)


RECTS = [(0.0, 0.0, 1920.0, 1080.0), (10.5, 20.25, 650.0, 300.0),
         (640.0, 480.0, 0.0, 0.0), (5.0, 7.0, 5.0, 90.0)]


@pytest.mark.parametrize("rect", RECTS)
def test_rectf_methods_match(rect):
    t, j = _rect_pair(rect)
    src_t, src_j = _rect_pair((0.0, 0.0, 720.0, 576.0))
    assert t.rounded() == tcm.Rect(*dataclasses.astuple(j.rounded()))
    assert bool(t.rounded()) == bool(j.rounded())
    assert t.rounded().normalized() == tcm.Rect(
        *dataclasses.astuple(j.rounded().normalized()))
    assert (t.aspect(), t.midx(), t.midy()) == (j.aspect(), j.midx(),
                                                j.midy())
    checks = []
    for aspect, panscan in itertools.product((0.0, 4 / 3, 2.39), (0.0, 0.5,
                                                                  1.0)):
        checks.append((t.stretch(aspect, panscan),
                       j.stretch(aspect, panscan)))
    for sx, sy in ((1.0, 1.0), (0.5, 2.0), (1.25, 0.75)):
        checks.append((t.stretch_xy(sx, sy), j.stretch_xy(sx, sy)))
        checks.append((t.offset(sx, -sy), j.offset(sx, -sy)))
    checks += [(t.zoom(1.5), j.zoom(1.5)),
               (t.aspect_copy(src_t, 0.3), j.aspect_copy(src_j, 0.3)),
               (t.aspect_fit(src_t), j.aspect_fit(src_j)),
               (t.aspect_fit(src_t.zoom(4.0), 1.0),
                j.aspect_fit(src_j.zoom(4.0), 1.0))]
    for rot in range(-1, 6):
        checks.append((t.rotate(rot), j.rotate(rot)))
        assert tcm.aspect_rotate(t.aspect(), rot) == \
            jcm.aspect_rotate(j.aspect(), rot)
    for a, b in checks:
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


@pytest.mark.parametrize("q", [-5, -1, 0, 1, 2, 3, 4, 7])
def test_rotation_is_an_int(q):
    t, j = tcm.Rotation(q), jcm.Rotation(q)
    assert isinstance(t, int) and int(t) == int(j)
    assert t.transposed == j.transposed
    assert (t.ROT_0, t.ROT_90, t.ROT_180, t.ROT_270) == (0, 1, 2, 3)


def test_matrices_and_transforms_match():
    rng = np.random.default_rng(0)
    m3, c3 = rng.random((3, 3)) + np.eye(3), rng.random(3)
    m2, c2 = rng.random((2, 2)) + np.eye(2), rng.random(2)
    v3, v2 = rng.random(3), rng.random(2)
    t3, j3 = tcm.Transform3x3(m3, c3), jcm.Transform3x3(m3, c3)
    inner = (rng.random((3, 3)), rng.random(3))
    pairs = [
        (tcm.Matrix3x3(m3).scale(0.7).m, jcm.Matrix3x3(m3).scale(0.7).m),
        (t3.apply(v3), j3.apply(v3)),
        (t3.compose(tcm.Transform3x3(*inner)).mat.m,
         j3.compose(jcm.Transform3x3(*inner)).mat.m),
        (t3.compose(tcm.Transform3x3(*inner)).c,
         j3.compose(jcm.Transform3x3(*inner)).c),
        (t3.scale(2.5).c, j3.scale(2.5).c),
        (t3.invert().mat.m, j3.invert().mat.m),
        (tcm.Transform3x3.identity().mat.m, jcm.Transform3x3.identity().mat.m),
        (tcm.Matrix2x2.rotation(0.3).m, jcm.Matrix2x2.rotation(0.3).m),
        (tcm.Matrix2x2(m2).apply(v2), jcm.Matrix2x2(m2).apply(v2)),
        (tcm.Matrix2x2(m2).invert().m, jcm.Matrix2x2(m2).invert().m),
        (tcm.Matrix2x2(m2).scale(3.0).m, jcm.Matrix2x2(m2).scale(3.0).m)]
    t2, j2 = tcm.Transform2x2(m2, c2), jcm.Transform2x2(m2, c2)
    rt, rj = _rect_pair(RECTS[1])
    pairs += [(t2.apply(v2), j2.apply(v2)),
              (t2.compose(t2.invert()).c, j2.compose(j2.invert()).c),
              (t2.scale(0.5).mat.m, j2.scale(0.5).mat.m),
              (dataclasses.astuple(t2.apply_rc(rt)),
               dataclasses.astuple(j2.apply_rc(rj))),
              (dataclasses.astuple(t2.bounds(rt)),
               dataclasses.astuple(j2.bounds(rj))),
              (dataclasses.astuple(tcm.Matrix2x2(m2).apply_rc(rt)),
               dataclasses.astuple(jcm.Matrix2x2(m2).apply_rc(rj)))]
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tcm.Matrix3x3(m3) == tcm.Matrix3x3(m3.copy())
    assert tcm.Matrix2x2(m2) != tcm.Matrix2x2(m2 * 2)


PRIMS = [p for p in tcs.ColorPrimaries if p != tcs.ColorPrimaries.UNKNOWN]


@pytest.mark.parametrize("a", PRIMS, ids=lambda p: p.value)
def test_primaries_helpers_match(a):
    ja = jcs.ColorPrimaries(a.value)
    for b in PRIMS:
        jb = jcs.ColorPrimaries(b.value)
        pt, pj = tcs.primaries_get(a), jcs.primaries_get(ja)
        qt, qj = tcs.primaries_get(b), jcs.primaries_get(jb)
        assert tcs.primaries_superset(pt, qt) == jcs.primaries_superset(pj,
                                                                         qj)
        assert pt.similar(qt) == pj.similar(qj)
    assert tcs.primaries_valid(tcs.primaries_get(a)) == \
        jcs.primaries_valid(jcs.primaries_get(ja))
    partial_t = tcs.RawPrimaries(red=tcs.CIExy(0.7, 0.0),
                                 white=tcs.CIExy(0.0, 0.33))
    partial_j = jcs.RawPrimaries(red=jcs.CIExy(0.7, 0.0),
                                 white=jcs.CIExy(0.0, 0.33))
    assert _fields(partial_t.merge(tcs.primaries_get(a))) == \
        _fields(partial_j.merge(jcs.primaries_get(ja)))
    assert not tcs.primaries_valid(partial_t)


@pytest.mark.parametrize("sys", list(tcs.ColorSystem), ids=lambda s: s.value)
def test_system_helpers_match(sys):
    js = jcs.ColorSystem(sys.value)
    assert tcs.system_is_linear(sys) == jcs.system_is_linear(js)
    for w, h in ((720, 480), (720, 576), (1280, 720), (3840, 2160)):
        assert tcs.system_guess_ycbcr(w, h).value == \
            jcs.system_guess_ycbcr(w, h).value
    if sys in (tcs.ColorSystem.DOLBYVISION,):
        return
    for levels, depth in (("limited", 8), ("full", 10), ("limited", 12)):
        rt = tcs.ColorRepr(sys=sys, levels=levels,
                           bits=tcs.BitEncoding(16, depth, 0))
        rj = jcs.ColorRepr(sys=js, levels=levels,
                           bits=jcs.BitEncoding(16, depth, 0))
        for a, b in zip(tcs.get_scaled_decoding_matrix(rt),
                        jcs.get_scaled_decoding_matrix(rj)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert _fields(rt.merge(tcs.ColorRepr(alpha="premultiplied"))) == \
            _fields(rj.merge(jcs.ColorRepr(alpha="premultiplied")))
        assert _fields(tcs.ColorRepr().merge(rt)) == \
            _fields(jcs.ColorRepr().merge(rj))


def _hdr(mod, **kw):
    ootf = kw.pop("ootf", None)
    prim = kw.pop("prim", None)
    return mod.HdrMetadata(
        ootf=None if ootf is None else mod.HdrBezier(*ootf),
        prim=mod.primaries_get(mod.ColorPrimaries(prim)) if prim
        else mod.RawPrimaries(), **kw)


HDRS = [dict(), dict(max_luma=1000.0, min_luma=0.005, prim="display-p3"),
        dict(max_cll=800.0, max_fall=300.0),
        dict(scene_max=(500.0, 400.0, 300.0), scene_avg=120.0,
             ootf=(400.0, 0.2, 0.3, (0.1, 0.5))),
        dict(max_pq_y=0.7, avg_pq_y=0.2), dict(ootf=(0.0, 0.1, 0.1, ()))]


@pytest.mark.parametrize("i", range(len(HDRS)))
def test_hdr_metadata_helpers_match(i):
    for k in range(len(HDRS)):
        at, aj = _hdr(tcs, **dict(HDRS[i])), _hdr(jcs, **dict(HDRS[i]))
        bt, bj = _hdr(tcs, **dict(HDRS[k])), _hdr(jcs, **dict(HDRS[k]))
        assert bool(at) == bool(aj)
        assert _fields(at.merge(bt)) == _fields(aj.merge(bj))
        for kind in ("none", "any", "hdr10", "hdr10plus", "cie_y"):
            assert at.contains(kind) == aj.contains(kind)
        ct = tcs.ColorSpace("bt.2020", "pq", at)
        cj = jcs.ColorSpace("bt.2020", "pq", aj)
        ut = tcs.ColorSpace(hdr=bt)
        uj = jcs.ColorSpace(hdr=bj)
        assert _fields(ut.merge(ct)) == _fields(uj.merge(cj))
        assert ut.equal(ct) == uj.equal(cj)
        assert ct.nominal_luma("hdr10plus") == cj.nominal_luma("hdr10plus")
    with pytest.raises(ValueError):
        tcs.HdrMetadata().contains("dolby")


def _frames(chroma_w=4):
    rng = np.random.default_rng(1)
    y = rng.integers(16, 235, (8, 8)).astype(np.uint8)
    uv = rng.integers(16, 240, (4, chroma_w)).astype(np.uint8)
    return t_yuv(y, uv, uv, device="cpu"), j_yuv(y, uv, uv)


@pytest.mark.parametrize("loc", ["left", "center", "top_left", "top_center",
                                 "bottom_left", "bottom_center", "unknown"])
def test_frame_chroma_location_matches(loc):
    t, j = _frames()
    t.set_chroma_location(loc)
    j.set_chroma_location(loc)
    assert [(p.shift_x, p.shift_y) for p in t.planes] == \
        [(p.shift_x, p.shift_y) for p in j.planes]
    assert [p.components for p in t.planes] == \
        [p.components for p in j.planes]


@pytest.mark.parametrize("crop", [None, (0, 0, 8, 8), (0, 0, 0, 0),
                                  (1, 0, 8, 8), (0, 0, 8, 7.4),
                                  (8, 8, 0, 0), (0.4, 0.4, 7.6, 7.6)])
def test_frame_is_cropped_matches(crop):
    t, j = _frames()
    assert t.pixel_aspect_ratio == j.pixel_aspect_ratio == 0.0
    if crop is not None:
        t.crop, j.crop = tcm.RectF(*crop), jcm.RectF(*crop)
    assert t.is_cropped() == j.is_cropped()


@pytest.mark.parametrize("size,seed", [(1, 0), (16, 0), (64, 7),
                                       (128, 0x9E3779B9)])
def test_white_noise_matches(size, seed):
    np.testing.assert_array_equal(tdither.white_noise(size, seed),
                                  jdither.white_noise(size, seed))


def test_white_noise_bias_is_the_draw():
    """The plain dither's white-noise bias is white_noise's draw."""
    params = tdithering.DitherParams(method=tdither.DitherMethod.WHITE_NOISE)
    bias = tdithering.bias_matrix(params, 24, 40, frame_index=3)
    rng = np.random.default_rng(0x9E3779B9 ^ 3)
    np.testing.assert_array_equal(bias, rng.random((24, 40),
                                                   dtype=np.float32))
    np.testing.assert_array_equal(tdither.white_noise(24, 5, width=24),
                                  jdither.white_noise(24, 5))


@pytest.mark.parametrize("csp", [("bt.2020", "pq"), ("display-p3", "linear"),
                                 ("bt.709", "bt.1886"), ("bt.709", "srgb")])
@pytest.mark.parametrize("already_linear", [False, True])
def test_extract_features_matches(csp, already_linear):
    """The PQ IPT intensity against the reference's jitted function:
    exact through PQ and linear light; through a pow-based transfer
    (BT.1886, sRGB) XLA's pow differs in the last ulps (ROADMAP §3's
    toolchain rounding: within 2.5e-6 here)."""
    rng = np.random.default_rng(0)
    x = rng.random((3, 16, 32)).astype(np.float32)
    got = tcolor.extract_features(torch.from_numpy(x),
                                  tcs.ColorSpace(*csp), already_linear)
    want = jax.jit(lambda v: jcolor.extract_features(
        v, jcs.ColorSpace(*csp), already_linear))(jnp.asarray(x))
    assert tuple(got.shape) == (1, 16, 32)
    pow_based = csp[1] in ("bt.1886", "srgb") and not already_linear
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2.5e-6 if pow_based else 0.0)


def _gm_pair(name, src="bt.2020", dst="bt.709", **kw):
    out = []
    for mod, cs in ((tgm, tcs), (jgm, jcs)):
        out.append(mod.GamutMapParams(
            function=mod.find_gamut_map_function(name),
            input_gamut=cs.primaries_get(cs.ColorPrimaries(src)),
            output_gamut=cs.primaries_get(cs.ColorPrimaries(dst)),
            min_luma=float(mod._pq_oetf(0.005 / 1e4)),
            max_luma=float(mod._pq_oetf(1000 / 1e4)), **kw))
    return out


GAMUT_OPS = [f.name for f in jgm.GAMUT_MAP_FUNCTIONS]


@pytest.mark.parametrize("name", GAMUT_OPS)
def test_gamut_map_host_api_matches(name):
    """find_gamut_map_function, params_noop and sample (the operator at
    arbitrary IPT colors), exact."""
    tf, jf = tgm.find_gamut_map_function(name), \
        jgm.find_gamut_map_function(name)
    assert (tf.name, tf.description, tf.bidirectional) == \
        (jf.name, jf.description, jf.bidirectional)
    for src, dst in (("bt.2020", "bt.709"), ("bt.709", "bt.2020"),
                     ("bt.709", "bt.709"), ("dci-p3", "display-p3")):
        t, j = _gm_pair(name, src, dst)
        assert tgm.params_noop(t) == jgm.params_noop(j)
    rng = np.random.default_rng(2)
    ipt = np.stack([rng.random(64) * 0.8, rng.random(64) - 0.5,
                    rng.random(64) - 0.5], axis=-1)
    t, j = _gm_pair(name)
    np.testing.assert_array_equal(tgm.sample(ipt, t), jgm.sample(ipt, j))


def test_gamut_map_lookups_and_matrices():
    assert [f.name for f in tgm.GAMUT_MAP_FUNCTIONS] == GAMUT_OPS
    assert tgm.find_gamut_map_function("nope") is None
    for p in ("bt.709", "bt.2020", "display-p3", "aces-ap0"):
        np.testing.assert_array_equal(
            tgm.ipt_lms2rgb(tcs.primaries_get(tcs.ColorPrimaries(p))),
            jgm.ipt_lms2rgb(jcs.primaries_get(jcs.ColorPrimaries(p))))
    assert _fields(tgm.GamutMapConstants(softclip_knee=2.0).fixed()) == \
        _fields(jgm.GamutMapConstants(softclip_knee=2.0).fixed())


def test_carry_takes_the_new_frame_fields():
    """carry.py carries a reference frame's rotation (as a Rotation),
    pixel aspect and HDR metadata with its mastering primaries and HDR10+
    curve (as an HdrBezier)."""
    from libplacebo_tpu_torch import carry
    hdr = _hdr(jcs, max_luma=1000.0, prim="display-p3",
               scene_max=(500.0, 400.0, 300.0), scene_avg=120.0,
               ootf=(400.0, 0.2, 0.3, (0.1, 0.5)))
    jcolor_space = jcs.ColorSpace("bt.2020", "pq", hdr)
    got = carry.colorspace_from_fields(dataclasses.asdict(jcolor_space))
    assert isinstance(got.hdr.ootf, tcs.HdrBezier)
    assert _fields(got) == _fields(jcolor_space)
    _, jf = _frames()
    jf.rotation, jf.pixel_aspect_ratio = jcm.Rotation(3), 1.5
    tf = carry.frame_from_numpy(
        [(np.asarray(p.data), p.component_mapping) for p in jf.planes],
        tcs.ColorRepr(), got, device="cpu", rotation=jf.rotation,
        pixel_aspect_ratio=jf.pixel_aspect_ratio)
    assert isinstance(tf.rotation, tcm.Rotation) and int(tf.rotation) == 3
    assert tf.pixel_aspect_ratio == 1.5

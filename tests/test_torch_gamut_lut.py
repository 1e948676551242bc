"""The gamut-mapping 3D LUT: the port's native generator (its copy of
native/gamut.cc) bit for bit against the JAX package's, and its numpy
plain version against the native LUT as
tests/test_gamut_mapping.py::test_native_lut_matches_python holds the
reference's."""
import numpy as np
import pytest

from libplacebo_tpu.core import gamut_mapping as jgm
from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu_torch import _build, native
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core import gamut_mapping as tgm

OPS = [f.name for f in jgm.GAMUT_MAP_FUNCTIONS]
# the reference's tolerances: the hue-shifted operators search at shifted
# hues, where the native one-item peak cache deviates boundedly
PLAIN_TOL = {"softclip": 5e-4, "absolute": 5e-4, "darken": 5e-3}


def _params(mod, cs, name, src, dst, **kw):
    return mod.GamutMapParams(
        function=mod.find_gamut_map_function(name),
        input_gamut=cs.primaries_get(cs.ColorPrimaries(src)),
        output_gamut=cs.primaries_get(cs.ColorPrimaries(dst)),
        min_luma=float(mod._pq_oetf(0.005 / 1e4)),
        max_luma=float(mod._pq_oetf(1000 / 1e4)),
        lut_size_I=16, lut_size_C=9, lut_size_h=9, **kw)


@pytest.mark.parametrize("src,dst", [("bt.2020", "bt.709"),
                                     ("display-p3", "bt.709"),
                                     ("bt.709", "bt.2020")])
@pytest.mark.parametrize("name", OPS)
def test_native_lut_matches_the_reference(name, src, dst):
    """9 hues x 9 chromas x 16 intensities, every operator: bit for bit
    against the JAX package's native LUT (the same gamut.cc)."""
    got = tgm.generate(_params(tgm, tcs, name, src, dst))
    want = jgm.generate(_params(jgm, jcs, name, src, dst))
    assert got.shape == (9, 9, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_lut_takes_the_constants():
    consts = dict(constants=tgm.GamutMapConstants(
        perceptual_deadzone=0.1, perceptual_strength=0.5,
        softclip_knee=0.6, softclip_desat=0.2, colorimetric_gamma=2.0))
    jconsts = dict(constants=jgm.GamutMapConstants(
        **{k: getattr(consts["constants"], k) for k in (
            "perceptual_deadzone", "perceptual_strength", "softclip_knee",
            "softclip_desat", "colorimetric_gamma")}))
    for name in ("perceptual", "softclip", "saturation"):
        np.testing.assert_array_equal(
            tgm.generate(_params(tgm, tcs, name, "bt.2020", "bt.709",
                                 **consts)),
            jgm.generate(_params(jgm, jcs, name, "bt.2020", "bt.709",
                                 **jconsts)))


@pytest.mark.parametrize("name", OPS)
def test_plain_lut_matches_native(name, monkeypatch):
    """generate_plain (numpy over the grid) against the native LUT, at
    the reference's tolerances, and against the reference's own Python
    path exactly."""
    p = _params(tgm, tcs, name, "bt.2020", "bt.709")
    plain = tgm.generate_plain(p)
    np.testing.assert_allclose(tgm.generate(p), plain,
                               atol=PLAIN_TOL.get(name, 1e-6), rtol=0)
    monkeypatch.setenv("LPTPU_NATIVE_GAMUT", "0")
    ref = jgm.generate(_params(jgm, jcs, name, "bt.2020", "bt.709"))
    np.testing.assert_array_equal(plain, ref)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A gamut.cc that does not build raises; there is no fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    native._gamut_lib.cache_clear()
    try:
        with pytest.raises(_build.KernelError, match="plnative_gamut"):
            tgm.generate(_params(tgm, tcs, "clip", "bt.2020", "bt.709"))
    finally:
        native._gamut_lib.cache_clear()
    with pytest.raises(KeyError):
        native.gamut_lut_native("no-such-op", *[np.eye(3)] * 5, 0.0, 1.0,
                                (1.8, 0.7, 0.35, 0.3, 0.8), 2, 2, 2)

"""PyTorch port: the upload helpers (utils/upload.py) and
frame_from_rgb against the JAX package on the CPU — chroma siting
offsets, the packed-layout helpers (from sizes and shifts, from masks,
byte alignment), frame_from_planes for planar, interleaved, bit-shifted
and packed-word planes, and RGB(A) frames.

Tolerance: exact.  The layout helpers are the same integer arithmetic;
the uploaded planes are the same float32 operations (a shift, a product
with float32(1 / (2^depth - 1)) or a true divide by (2^size - 1)) on
the same integers.
"""
import numpy as np
import pytest

from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.utils import upload as jup

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.utils import upload as tup


@pytest.mark.parametrize("loc", ["left", "center", "top_left", "top_center",
                                 "bottom_left", "bottom_center", "bogus"])
def test_chroma_location_offset(loc):
    assert tup.chroma_location_offset(loc) == jup.chroma_location_offset(loc)
    assert tup.CHROMA_OFFSETS == jup.CHROMA_OFFSETS


_COMPS = [((5, 6, 5, 0), (11, 5, 0, 0)),          # rgb565
          ((10, 10, 10, 2), (20, 10, 0, 30)),     # x2rgb10 / rgb10a2
          ((8, 8, 8, 8), (16, 8, 0, 24)),         # bgra8
          ((8, 8, 8, 0), (0, 8, 16, 0)),          # rgb24
          ((12, 12, 12, 0), (4, 20, 36, 0))]      # xyz12 in 16-bit words


@pytest.mark.parametrize("sizes, shifts", _COMPS)
def test_plane_data_from_comps_and_mask(sizes, shifts):
    assert tup.plane_data_from_comps(sizes, shifts) == \
        jup.plane_data_from_comps(sizes, shifts)
    masks = [((1 << s) - 1) << sh if s else 0
             for s, sh in zip(sizes, shifts)]
    assert tup.plane_data_from_mask(masks) == jup.plane_data_from_mask(masks)


def test_plane_data_errors():
    for mod in (tup, jup):
        with pytest.raises(ValueError, match="overlapping"):
            mod.plane_data_from_comps((8, 8), (0, 4))
        with pytest.raises(ValueError, match="non-contiguous"):
            mod.plane_data_from_mask((0b1011,))


@pytest.mark.parametrize("size, pad", [
    ((10, 10, 10), (0, 6, 6)), ((12, 12, 12), (4, 4, 4)), ((5, 6, 5), (0, 0, 0)),
    ((8, 8, 8), (0, 0, 0)), ((10, 10, 10), (2, 0, 0)), ((6, 6, 6), (2, 2, 2)),
    ((), ())])
def test_plane_data_align(size, pad):
    got, want = tup.plane_data_align(size, pad), jup.plane_data_align(size,
                                                                      pad)
    if want is None:
        assert got is None
    else:
        assert got[:2] == want[:2]
        assert (got[2].sample_depth, got[2].color_depth, got[2].bit_shift) \
            == (want[2].sample_depth, want[2].color_depth, want[2].bit_shift)


def _planes(kind, rng):
    """PlaneData field dicts of one layout."""
    if kind == "yuv420p8":
        return [dict(data=rng.integers(0, 256, (16, 32), dtype=np.uint8)),
                dict(data=rng.integers(0, 256, (8, 16), dtype=np.uint8),
                     component_map=(1,)),
                dict(data=rng.integers(0, 256, (8, 16), dtype=np.uint8),
                     component_map=(2,))]
    if kind == "p010":           # 10 bits in the top of 16-bit words
        y = (rng.integers(0, 1024, (16, 32)) << 6).astype(np.uint16)
        uv = (rng.integers(0, 1024, (8, 16, 2)) << 6).astype(np.uint16)
        return [dict(data=y, bit_depth=10, bit_shift=6),
                dict(data=uv, component_map=(1, 2), bit_depth=10,
                     bit_shift=6)]
    if kind == "rgba_float":
        return [dict(data=rng.random((16, 32, 4)).astype(np.float32),
                     component_map=(0, 1, 2, 3))]
    if kind == "rgb565":
        return [dict(data=rng.integers(0, 1 << 16, (16, 32),
                                       dtype=np.uint16),
                     component_map=(2, 1, 0), component_size=(5, 6, 5),
                     component_pad=(0, 0, 0))]
    # rgb10a2 in 32-bit words
    return [dict(data=rng.integers(0, 1 << 32, (16, 32), dtype=np.uint32),
                 component_map=(0, 1, 2, 3),
                 component_size=(10, 10, 10, 2),
                 component_pad=(0, 0, 0, 0))]


@pytest.mark.parametrize("kind", ["yuv420p8", "p010", "rgba_float",
                                  "rgb565", "rgb10a2"])
@pytest.mark.parametrize("loc", ["left", "top_left"])
def test_frame_from_planes(kind, loc):
    """The planes' data, mappings and chroma shifts equal the
    reference's."""
    fields = _planes(kind, np.random.default_rng(3))
    jf = jup.frame_from_planes([jup.PlaneData(**f) for f in fields],
                               chroma_location=loc)
    tf = tup.frame_from_planes([tup.PlaneData(**f) for f in fields],
                               chroma_location=loc, device="cpu")
    assert len(tf.planes) == len(jf.planes)
    for tp, jp in zip(tf.planes, jf.planes):
        assert tp.component_mapping == jp.component_mapping
        assert (tp.shift_x, tp.shift_y) == (jp.shift_x, jp.shift_y)
        np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))


@pytest.mark.parametrize("comps", [3, 4])
@pytest.mark.parametrize("interleaved", [True, False])
def test_frame_from_rgb(comps, interleaved):
    arr = np.random.default_rng(4).random((12, 20, comps)).astype(
        np.float32)
    if not interleaved:
        arr = np.ascontiguousarray(np.moveaxis(arr, -1, 0))
    jf = jfr.frame_from_rgb(arr)
    tf = lt.frame_from_rgb(arr, device="cpu")
    assert tf.planes[0].component_mapping == \
        jf.planes[0].component_mapping == tuple(range(comps))
    np.testing.assert_array_equal(tf.planes[0].data.numpy(),
                                  np.asarray(jf.planes[0].data))
    assert (tf.repr.sys.value, tf.repr.levels.value) == \
        (jf.repr.sys.value, jf.repr.levels.value)

"""The upload's host copy into its staging block (utils/device.py,
`copy_in_bands`, native/copy.cc), on the CPU: for each element size, row
count and layout a decoder hands over, and 1, 2 and 4 host threads, the
bytes are numpy's copy's, no warning is raised, the thread count is left
as it was, `upload.parallel` counts only planes of BAND_MIN_BYTES or more
of several rows copied on more than one thread, and `raw_to_device` on
the CPU returns the tensor it returned before the band copy.

Tolerance: exact (a copy of bytes)."""
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from libplacebo_tpu_torch.native import copy_rows_native
from libplacebo_tpu_torch.render import profiler
from libplacebo_tpu_torch.utils.device import (BAND_MIN_BYTES,
                                               copy_in_bands, raw_to_device)

# what raw_to_device uploads each unsigned type as, and widens it to
SIGNED = {np.uint16: (np.int16, torch.int32),
          np.uint32: (np.int32, torch.int64)}


def _codes(shape, dtype, seed=0):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(
        info.min, info.max, shape, dtype=dtype, endpoint=True)


def _read_only(shape, dtype):
    """A decoder's plane: np.frombuffer over immutable bytes."""
    return np.frombuffer(_codes(shape, dtype).tobytes(),
                         dtype).reshape(shape)


def _row_strided(shape, dtype):
    """A linesize wider than the row: a view of a wider buffer."""
    h, w = shape
    return _codes((h, w + 40), dtype)[:, :w]


def _flipped(shape, dtype):
    """Rows in reverse order: a negative stride."""
    return _codes(shape, dtype)[::-1]


# name -> plane; each at or above the threshold unless its name says so
CASES = {
    "uint8 1001 rows": lambda: _codes((1001, 8400), np.uint8),
    "int16 515 rows": lambda: _codes((515, 8200), np.int16),
    "uint16 2160p luma": lambda: _codes((2160, 3840), np.uint16),
    "uint32 257 rows": lambda: _codes((257, 8200), np.uint32),
    "int16 one row": lambda: _codes((1, BAND_MIN_BYTES // 2), np.int16),
    "uint8 at the threshold": lambda: _codes((8, BAND_MIN_BYTES // 8),
                                             np.uint8),
    "uint8 4 bytes below": lambda: _codes((4, BAND_MIN_BYTES // 4 - 1),
                                          np.uint8),
    "uint16 1080p luma, below": lambda: _codes((1080, 1920), np.uint16),
    "uint16 32x64 frame": lambda: _codes((32, 64), np.uint16),
    "uint16 read-only": lambda: _read_only((2160, 3840), np.uint16),
    "uint16 row-strided": lambda: _row_strided((2160, 3840), np.uint16),
    "int16 negative stride": lambda: _flipped((1081, 3900), np.int16),
    "uint16 (H, W, 1)": lambda: _codes((1080, 3900, 1), np.uint16),
}


@pytest.fixture(params=[1, 2, 4])
def threads(request):
    """The host threads PyTorch grants, set for the test and restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    try:
        yield request.param
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("case", list(CASES))
def test_staging_copy(case, threads):
    plane = CASES[case]()
    signed, wide = SIGNED.get(plane.dtype.type, (plane.dtype.type, None))
    arr = plane.view(signed)
    dst = torch.empty(arr.shape, dtype=torch.from_numpy(
        np.empty(0, signed)).dtype)
    banded = profiler.counters().get("upload.parallel", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        copy_in_bands(dst, arr)
    banded = profiler.counters().get("upload.parallel", 0) - banded
    assert torch.get_num_threads() == threads
    assert dst.numpy().tobytes() == np.ascontiguousarray(arr).tobytes()
    # bands of whole rows, each row contiguous: every layout here but
    # the single row
    rows = arr.shape[0] > 1 and arr[0].flags.c_contiguous
    assert banded == int(arr.nbytes >= BAND_MIN_BYTES and threads > 1
                         and rows)

    # the CPU device's upload is the plane's codes, widened as before
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = raw_to_device(plane, torch.device("cpu"))
    expect = torch.from_numpy(np.array(arr))
    if wide is not None:
        expect = torch.from_numpy(plane.astype(np.int64)).to(wide)
    assert t.dtype == expect.dtype and torch.equal(t, expect)
    assert torch.get_num_threads() == threads


def test_staging_copies_from_many_threads():
    """Twelve threads (more than the cores) copying planes at once, with
    the interpreter switching threads often: each copy exact, every
    thread done in time (the band copy's helpers are shared)."""
    planes = [_codes((1100, 3840), np.int16, seed) for seed in range(12)]
    bad, before = [], sys.getswitchinterval()
    threads = torch.get_num_threads()

    def copy(plane):
        for _ in range(10):
            dst = torch.empty(plane.shape, dtype=torch.int16)
            copy_in_bands(dst, plane)
            if not np.array_equal(dst.numpy(), plane):
                bad.append(plane)

    torch.set_num_threads(4)
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=copy, args=(p,)) for p in planes]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(before)
        torch.set_num_threads(threads)
    assert not any(w.is_alive() for w in workers)
    assert not bad


def test_native_row_copy_checks_its_arrays():
    """The native copy writes through raw pointers, so it refuses arrays
    of another shape or dtype, rows that are not contiguous and a
    read-only destination."""
    src = _codes((64, 32), np.int16)
    for dst, arr in ((np.empty((64, 31), np.int16), src),
                     (np.empty((64, 32), np.int32), src),
                     (np.empty((64, 32), np.int16), src[:, ::-1]),
                     (np.frombuffer(bytes(src.nbytes), np.int16)
                      .reshape(64, 32), src)):
        with pytest.raises(ValueError):
            copy_rows_native(dst, arr, 4, 8)
    dst = np.empty_like(src)
    copy_rows_native(dst, src, 4, 8)
    assert np.array_equal(dst, src)

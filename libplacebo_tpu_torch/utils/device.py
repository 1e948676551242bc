"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it."""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..native import copy_rows_native
from ..render import profiler

__all__ = ["resolve_device", "raw_to_device", "copy_in_bands",
           "arrays_to_device", "device_constant"]


def resolve_device(device=None) -> torch.device:
    """None means "cuda"; a CUDA device without a GPU raises instead of
    quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


_TORCH_INTS = (np.uint8, np.int8, np.int16, np.int32, np.int64)
# unsigned types torch lacks arithmetic for: uploaded as the signed type
# of their width and widened on the device, (signed, wide, mask)
_UNSIGNED = {np.dtype(np.uint16): (np.int16, torch.int32, 0xFFFF),
             np.dtype(np.uint32): (np.int32, torch.int64, 0xFFFFFFFF)}


# a plane of at least this many bytes is copied on several host threads.
# Below it the helpers' wake-up and hand-back cost about what they save
# (a 4 MB plane on 4 threads of an H100 host: 0.15 ms less at the median,
# milliseconds more at the 99th percentile; PERF.md)
BAND_MIN_BYTES = 8 << 20
# bands a thread: a helper that wakes late finds bands left to take
BANDS_PER_THREAD = 4


def copy_in_bands(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy `arr` into the CPU tensor `dst` of its shape and dtype.  A
    plane of at least BAND_MIN_BYTES, where PyTorch grants more than one
    host thread (`torch.get_num_threads()`, read and never set), is cut
    into BANDS_PER_THREAD bands of whole rows a thread, which the
    calling thread and up to that many - 1 helper threads claim in turn
    (native/copy.cc): the call returns once every band is in place, and
    never waits for a helper that has not woken.  The counter
    `upload.parallel` counts such planes.  A smaller plane, a single
    row, or a layout whose rows are not each contiguous or whose byte
    order is not the destination's, takes numpy's single copy on the
    calling thread."""
    out = dst.numpy()
    threads = torch.get_num_threads()
    if arr.nbytes < BAND_MIN_BYTES or threads < 2 or arr.ndim < 2 \
            or arr.shape[0] < 2 or arr.shape != out.shape \
            or arr.dtype != out.dtype or not arr[0].flags.c_contiguous:
        out[...] = arr
        return
    copy_rows_native(out, arr, threads,
                     min(arr.shape[0], BANDS_PER_THREAD * threads))
    profiler.count("upload.parallel")


def raw_to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload integer texels as they are: 16- and 32-bit unsigned ones
    as their signed bits, widened on the device (int32, int64).  On a GPU
    the bytes are staged in pinned memory and copied without waiting: a
    copy from pageable memory would hold the host until the card had
    finished the work queued before it.  The host copy into pinned
    memory is `copy_in_bands`: a plane of 8 MiB or more is copied in
    bands of whole rows on the host threads PyTorch grants (read from
    `torch.get_num_threads()`, never set); a smaller plane, or a layout
    it cannot cut into rows, in one copy on the calling thread.
    Read-only arrays (a decoder's np.frombuffer), row-strided and
    negative-stride planes are accepted.  The staging is the span
    `upload.stage`, its pinned allocation `upload.pin`
    (render/profiler.py)."""
    arr = np.asarray(arr)
    widen = _UNSIGNED.get(arr.dtype)
    if widen is not None:
        arr = arr.view(widen[0])
    elif arr.dtype.type not in _TORCH_INTS:
        arr = arr.astype(np.int64)
    if dev.type == "cuda":
        with profiler.span("upload.stage"):
            with profiler.span("upload.pin"):
                host = torch.empty(arr.shape, dtype=torch.from_numpy(
                    np.empty(0, arr.dtype)).dtype, pin_memory=True)
            copy_in_bands(host, arr)
        t = host.to(dev, non_blocking=True)
    else:
        with profiler.span("upload.stage"):
            t = torch.from_numpy(np.array(arr) if not arr.flags.writeable
                                 else np.ascontiguousarray(arr)).to(dev)
    if widen is not None:
        t = t.to(widen[1]) & widen[2]
    return t


def arrays_to_device(arrays, dev: torch.device) -> list:
    """Host arrays of 4-byte types as tensors on `dev`, in one copy.  On
    a GPU the bytes go through pinned memory without waiting: a copy from
    pageable memory would hold the host until the card had finished all
    the work queued before it."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    assert all(a.dtype.itemsize == 4 for a in arrays)
    with profiler.span("upload.stage"):
        host = torch.from_numpy(np.concatenate(
            [a.reshape(-1).view(np.uint8) for a in arrays]))
        if dev.type == "cuda":
            with profiler.span("upload.pin"):
                pinned = torch.empty_like(host, pin_memory=True)
            host = pinned.copy_(host)
    flat = host.to(dev, non_blocking=dev.type == "cuda")
    out, at = [], 0
    for a in arrays:
        part = flat[at:at + a.nbytes]
        out.append(part.view(torch.from_numpy(a[:0]).dtype).view(a.shape))
        at += a.nbytes
    return out


@lru_cache(maxsize=64)
def device_constant(values: Tuple[float, ...], device) -> torch.Tensor:
    """A small float32 constant vector, uploaded once per device: a
    per-frame upload from host memory would make the host wait for the
    card.  Shared between callers, so never write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)

"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it."""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["resolve_device", "raw_to_device", "arrays_to_device",
           "device_constant"]


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


def raw_to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Upload integer texels as they are (unsigned types torch lacks
    arithmetic for widen on the host first: 16-bit ones to int32)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.type not in _TORCH_INTS:
        arr = arr.astype(np.int32 if arr.dtype.itemsize <= 2 else np.int64)
    return torch.from_numpy(arr).to(dev)


def arrays_to_device(arrays, dev: torch.device) -> list:
    """Host arrays of 4-byte types as tensors on `dev`, in one copy.  On
    a GPU the bytes go through pinned memory without waiting: a copy from
    pageable memory would hold the host until the card had finished all
    the work queued before it."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    assert all(a.dtype.itemsize == 4 for a in arrays)
    host = torch.from_numpy(np.concatenate(
        [a.reshape(-1).view(np.uint8) for a in arrays]))
    if dev.type == "cuda":
        flat = host.pin_memory().to(dev, non_blocking=True)
    else:
        flat = host.to(dev)
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

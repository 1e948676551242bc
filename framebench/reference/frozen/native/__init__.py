"""Native host code of the frozen reference: the blue-noise generator
(`dither.cc`, libplacebo's void-and-cluster), a copy of the program's
native source as of the freeze.  Each is built with g++ at
first use into `build/framebench_reference/` at the root of the
checkout (a fixed path, so only a checkout's first run builds), and a
build that fails raises."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["blue_noise_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, *[".."] * 4, "build", "framebench_reference")
_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


@functools.lru_cache(maxsize=None)
def _host_lib(name: str, source: str) -> ctypes.CDLL:
    path = os.path.join(_HERE, source)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode()) \
            .hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.abspath(os.path.join(BUILD_DIR, f"{name}_{digest}.so"))
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS, path,
                        "-o", tmp], check=True)
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


def blue_noise_native(shift: int) -> np.ndarray:
    """(2^shift)^2 blue-noise rank matrix in [0, 1)."""
    fn = _host_lib("plnative_dither", "dither.cc").pl_blue_noise
    fn.argtypes = [ctypes.c_int, np.ctypeslib.ndpointer(
        np.float32, flags="C_CONTIGUOUS")]
    fn.restype = None
    size = 1 << shift
    out = np.zeros((size, size), np.float32)
    fn(shift, out)
    return out

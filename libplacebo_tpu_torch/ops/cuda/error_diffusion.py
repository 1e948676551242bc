"""K2 — the error-diffusion wavefront — as a hand-written Hopper kernel,
with its plain PyTorch version beside it.

Replaces libplacebo_tpu/ops/pallas/error_diffusion.py::
error_diffusion_pallas (its `_kernel_body`).  The input is the sheared
column-major image (Wsp, C, Hp) that K3 builds: column j holds image
pixel (y, j - s*y) of every row y, so every tap of the diffusion pattern
points at a later column and one column's rows are independent.  The
walk over columns is serial:

    cur   = x[j] + pending[j]
    r     = round(cur * scale)            (half to even)
    err   = cur - r * (1/scale)           where (y, j - s*y) is in the image, else 0
                                          (one rounding: a fused multiply-add)
    code  = clip(r, 0, scale)             int16 (int32 above 15 bits)
    pending[j + off] += wgt * err[y - dy]  for each tap, in pattern order (fused)

`taps` orders the pattern's nonzero weights by row then column, as the
reference does, so every destination receives its additions in the same
order.  The plain version (`wavefront_plain`) is that loop, a column at
a time; the kernel (csrc/error_diffusion.cu) repeats its arithmetic
operation for operation, so the two agree bit for bit.

`wavefront` is the entry: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel (counted in `launches`) or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from ...core.dither import ErrorDiffusionKernel
from ...core.fastmath import fma, rcp

__all__ = ["taps_for", "code_dtype", "wavefront", "wavefront_plain",
           "launches", "build", "build_spec"]

launches = 0

_MAX_TAPS = 15        # 3 x 5 pattern (csrc: kMaxTaps)


def taps_for(kernel: ErrorDiffusionKernel) -> List[Tuple[int, int, float]]:
    """(dy, column offset in the sheared image, weight) of every nonzero
    weight, row by row, left to right; weights are float32 (pattern /
    divisor in float32, as the reference normalizes them)."""
    kern = np.asarray(kernel.pattern, dtype=np.float32) / kernel.divisor
    return [(dy, dx + dy * kernel.shift, float(kern[dy, dx + 2]))
            for dy in range(3) for dx in range(-2, 3)
            if kern[dy, dx + 2] != 0.0]


def code_dtype(new_depth: int) -> torch.dtype:
    """The codes' type: int16 while every code fits, int32 above."""
    return torch.int16 if (1 << new_depth) - 1 < 32000 else torch.int32


def wavefront_plain(colmaj: torch.Tensor, kernel: ErrorDiffusionKernel,
                    new_depth: int, W: int, H: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the column
    walk, one sheared column (C, Hp) per step."""
    taps = taps_for(kernel)
    max_off = max(off for _, off, _ in taps)
    Wsp, C, Hp = colmaj.shape
    scale = float((1 << new_depth) - 1)
    inv = rcp(scale)
    dev = colmaj.device
    rows = torch.arange(Hp, device=dev)
    start = rows * kernel.shift
    dys = sorted({dy for dy, _, _ in taps if dy > 0})
    pending = [torch.zeros((C, Hp), device=dev) for _ in range(max_off)]
    out = torch.empty((Wsp, C, Hp), dtype=code_dtype(new_depth), device=dev)
    zero = torch.zeros((), device=dev)
    for j in range(Wsp):
        cur = colmaj[j] + pending[0]
        r = torch.round(cur * scale)
        valid = (j >= start) & (j < start + W) & (rows < H)
        err = torch.where(valid, fma(r, -inv, cur), zero)
        out[j] = torch.clamp(r, 0.0, scale).to(out.dtype)
        shifted = {0: err}
        for dy in dys:
            shifted[dy] = torch.nn.functional.pad(err[:, :Hp - dy], (dy, 0))
        pending = pending[1:] + [torch.zeros_like(err)]
        for dy, off, wgt in taps:
            pending[off - 1] = fma(shifted[dy], wgt, pending[off - 1])
    return out


def build_spec():
    """The kernel library's build spec (_build.build_all)."""
    from ..._build import nvcc_path
    return ("k2_error_diffusion", ["csrc/error_diffusion.cu"], nvcc_path(),
            ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             f"-DK2_MAX_TAPS={_MAX_TAPS}"])


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    fn = lib.k2_wavefront_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_float,
                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _kernel_lib()


def wavefront(colmaj: torch.Tensor, kernel: ErrorDiffusionKernel,
              new_depth: int, W: int, H: int) -> torch.Tensor:
    """Error-diffuse the sheared column-major (Wsp, C, Hp) float32 image
    of a W x H frame to `new_depth` bits: (Wsp, C, Hp) integer codes."""
    global launches
    if colmaj.device.type == "cpu":
        return wavefront_plain(colmaj, kernel, new_depth, W, H)
    if colmaj.device.type != "cuda":
        raise ValueError(f"K2: unsupported device {colmaj.device}")
    if colmaj.dim() != 3 or colmaj.dtype != torch.float32 or \
            not colmaj.is_contiguous():
        raise ValueError(f"K2: needs a contiguous (Wsp, C, Hp) float32 "
                         f"CUDA tensor, got {colmaj.dtype} "
                         f"{tuple(colmaj.shape)}")
    Wsp, C, Hp = colmaj.shape
    if H > Hp or not 1 <= new_depth <= 16:
        raise ValueError(f"K2: {H} rows in {Hp}, depth {new_depth}")
    taps = taps_for(kernel)
    n = len(taps)
    dys = (ctypes.c_int * n)(*[t[0] for t in taps])
    offs = (ctypes.c_int * n)(*[t[1] for t in taps])
    wgts = (ctypes.c_float * n)(*[t[2] for t in taps])
    scale = float((1 << new_depth) - 1)
    dt = code_dtype(new_depth)
    out = torch.empty((Wsp, C, Hp), dtype=dt, device=colmaj.device)
    lib = _kernel_lib()
    rc = lib.k2_wavefront_launch(
        colmaj.data_ptr(), out.data_ptr(), int(dt == torch.int32), Wsp, C,
        Hp, W, H, kernel.shift, n, dys, offs, wgts, scale, rcp(scale),
        torch.cuda.current_stream(colmaj.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K2 launch failed: " +
                           lib.k2_error_string(rc).decode())
    launches += 1
    return out

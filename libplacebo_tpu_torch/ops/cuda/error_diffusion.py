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
tensor launches the kernel (counted in `launches`) or raises.  The
kernel is compiled for the patterns of `ERROR_DIFFUSION_KERNELS`, its
tap tables generated from them (`tap_table_header`); any other pattern
whose taps reach at most `CUSTOM_SLOTS` sheared columns ahead runs on
one more instance that takes its taps with the launch (`custom_taps`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from ..._build import KernelError, kernel_work
from ...core.dither import ERROR_DIFFUSION_KERNELS, ErrorDiffusionKernel
from ...core.fastmath import fma, rcp

__all__ = ["taps_for", "tap_table_header", "custom_taps", "code_dtype",
           "wavefront", "wavefront_plain", "launches", "build", "build_spec",
           "geometry", "CUSTOM_SLOTS"]

launches = 0
# the custom-pattern instance's window (kCustomSlots in the kernel)
CUSTOM_SLOTS = 16


def taps_for(kernel: ErrorDiffusionKernel) -> List[Tuple[int, int, float]]:
    """(dy, column offset in the sheared image, weight) of every nonzero
    weight, row by row, left to right; weights are float32 (pattern /
    divisor in float32, as the reference normalizes them)."""
    kern = np.asarray(kernel.pattern, dtype=np.float32) / kernel.divisor
    return [(dy, dx + dy * kernel.shift, float(kern[dy, dx + 2]))
            for dy in range(3) for dx in range(-2, 3)
            if kern[dy, dx + 2] != 0.0]


def tap_table_header() -> str:
    """The tap tables the kernel is compiled with, as the C++ header
    `k2_taps.h` that csrc/error_diffusion.cu includes: `kPatterns` and
    `pattern(p)`, the shift and `taps_for` of pattern p of
    ERROR_DIFFUSION_KERNELS (weights as exact hex float literals)."""
    lines = ["// Generated from core/dither.py::ERROR_DIFFUSION_KERNELS by",
             "// ops/cuda/error_diffusion.py::tap_table_header.",
             f"constexpr int kPatterns = {len(ERROR_DIFFUSION_KERNELS)};",
             "__host__ __device__ constexpr Pattern pattern(int p) {",
             "  switch (p) {"]
    for p, kernel in enumerate(ERROR_DIFFUSION_KERNELS):
        taps = taps_for(kernel)
        dys, offs, wgts = (", ".join(v) for v in zip(
            *[(str(dy), str(off), float(w).hex() + "f")
              for dy, off, w in taps]))
        lines += [f"    case {p}:  // {kernel.name}",
                  f"      return {{{kernel.shift}, {len(taps)}, {{{dys}}}, "
                  f"{{{offs}}}, {{{wgts}}}}};"]
    lines += ["    default:", "      return {0, 0, {}, {}, {}};", "  }", "}",
              ""]
    return "\n".join(lines)


def custom_taps(kernel: ErrorDiffusionKernel) -> np.ndarray:
    """The kernel's `CustomTaps` launch parameter for `kernel`, as 32-bit
    words: the shift, a bit mask a pending slot (bit dy: a tap from row
    y - dy lands on sheared offset slot + 1), then each slot's three
    float32 weights by dy.  Raises for a pattern that reaches outside
    the window (an offset below 1 or above CUSTOM_SLOTS)."""
    words = np.zeros(1 + CUSTOM_SLOTS * 4, np.uint32)
    rows = words[1:1 + CUSTOM_SLOTS]
    wgts = words[1 + CUSTOM_SLOTS:].view(np.float32).reshape(CUSTOM_SLOTS, 3)
    words[0] = kernel.shift
    for dy, off, w in taps_for(kernel):
        if not 1 <= off <= CUSTOM_SLOTS:
            raise ValueError(
                f"K2: pattern {kernel.name!r} reaches sheared offset {off}; "
                f"the kernel takes 1..{CUSTOM_SLOTS}")
        rows[off - 1] |= 1 << dy
        wgts[off - 1, dy] = w
    return words


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
    """The kernel library's build spec (_build.build_all); writes the
    tap tables' header into the build directory."""
    from ..._build import generated_include, nvcc_path
    taps = generated_include("k2_taps.h", tap_table_header())
    return ("k2_error_diffusion", ["csrc/error_diffusion.cu"], nvcc_path(),
            ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", taps])


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    fn = lib.k2_wavefront_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k2_geometry.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.k2_geometry.restype = None
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _kernel_lib()


def geometry(Wsp: int, C: int, Hp: int) -> Tuple[int, int, int]:
    """(scratch words the wrapper clears, blocks, threads a block) of the
    kernel's launch on a (Wsp, C, Hp) image."""
    words, blocks, threads = (ctypes.c_longlong(), ctypes.c_int(),
                              ctypes.c_int())
    _kernel_lib().k2_geometry(Wsp, C, Hp, ctypes.byref(words),
                              ctypes.byref(blocks), ctypes.byref(threads))
    return words.value, blocks.value, threads.value


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
    # a built-in pattern's compiled instance, else the custom one
    if kernel in ERROR_DIFFUSION_KERNELS:
        index, custom = ERROR_DIFFUSION_KERNELS.index(kernel), None
    else:
        index, custom = -1, custom_taps(kernel)
    with kernel_work("K2"):
        scale = float((1 << new_depth) - 1)
        dt = code_dtype(new_depth)
        out = torch.empty((Wsp, C, Hp), dtype=dt, device=colmaj.device)
        # the band ticket and the boundary words, zero at every launch
        scratch = torch.zeros(geometry(Wsp, C, Hp)[0], dtype=torch.int32,
                              device=colmaj.device)
        lib = _kernel_lib()
        rc = lib.k2_wavefront_launch(
            colmaj.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            int(dt == torch.int32), index, Wsp, C, Hp, W, H, scale, rcp(scale),
            None if custom is None else custom.ctypes.data,
            torch.cuda.current_stream(colmaj.device).cuda_stream)
        if rc != 0:
            raise KernelError("K2 launch failed: " +
                               lib.k2_error_string(rc).decode())
    launches += 1
    return out

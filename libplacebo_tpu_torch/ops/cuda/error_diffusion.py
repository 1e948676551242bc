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
tensor launches the kernel (counted in `launches`, and by library in
`launches_by`) or raises.  The kernel is a template over the pattern,
its tap table compiled in from a generated header (`tap_table_header`).
One library holds the patterns of `ERROR_DIFFUSION_KERNELS`; any other
pattern is compiled into a library of its own, keyed by its shift and
taps (`pattern_key`, so a renamed copy of a built-in pattern runs the
built-in's instance).  `prepare` builds a pattern's library ahead of
its first launch (the renderer calls it when it plans the frame); a
failed build raises KernelError: nothing runs in the kernel's place.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..._build import KernelError, kernel_work
from ...core.dither import (ED_FLOYD_STEINBERG, ERROR_DIFFUSION_KERNELS,
                            ErrorDiffusionKernel)
from ...core.fastmath import fma, rcp

__all__ = ["taps_for", "pattern_key", "tap_table_header", "code_dtype",
           "wavefront", "wavefront_plain", "launches", "build", "build_spec",
           "library_name", "prepare", "geometry", "launches_by"]

launches = 0
# launches by library (library_name): the built-in patterns' and each
# pattern's own
launches_by: dict = {}


def taps_for(kernel: ErrorDiffusionKernel) -> List[Tuple[int, int, float]]:
    """(dy, column offset in the sheared image, weight) of every nonzero
    weight, row by row, left to right; weights are float32 (pattern /
    divisor in float32, as the reference normalizes them)."""
    kern = np.asarray(kernel.pattern, dtype=np.float32) / kernel.divisor
    return [(dy, dx + dy * kernel.shift, float(kern[dy, dx + 2]))
            for dy in range(3) for dx in range(-2, 3)
            if kern[dy, dx + 2] != 0.0]


def pattern_key(kernel: ErrorDiffusionKernel) -> tuple:
    """What the kernel computes with: the shift and, in taps_for order,
    each tap's (dy, sheared offset, float32 weight bits).  Not the name:
    patterns with one key share their compiled instance."""
    return (kernel.shift,) + tuple(
        (dy, off, int(np.float32(w).view(np.uint32)))
        for dy, off, w in taps_for(kernel))


def tap_table_header(kernels=None) -> str:
    """The tap tables a K2 library is compiled with, as the C++ header
    `k2_taps.h` that csrc/error_diffusion.cu includes: `kPatterns` and
    `pattern(p)`, the shift and taps_for of pattern p (weights as exact
    hex float literals).  By default the patterns of
    ERROR_DIFFUSION_KERNELS, commented with their names; a list of other
    patterns is written from their keys alone."""
    builtin = kernels is None
    kernels = ERROR_DIFFUSION_KERNELS if builtin else list(kernels)
    lines = ["// Generated by ops/cuda/error_diffusion.py::tap_table_header"
             + (" from core/dither.py::ERROR_DIFFUSION_KERNELS." if builtin
                else "."),
             f"constexpr int kPatterns = {len(kernels)};",
             "__host__ __device__ constexpr Pattern pattern(int p) {",
             "  switch (p) {"]
    for p, kernel in enumerate(kernels):
        taps = taps_for(kernel)
        dys, offs, wgts = (", ".join(v) for v in zip(
            *[(str(dy), str(off), float(w).hex() + "f")
              for dy, off, w in taps]))
        lines += [f"    case {p}:" + (f"  // {kernel.name}" if builtin
                                      else ""),
                  f"      return {{{kernel.shift}, {len(taps)}, {{{dys}}}, "
                  f"{{{offs}}}, {{{wgts}}}}};"]
    lines += ["    default:", "      return {0, 0, {}, {}, {}};", "  }", "}",
              ""]
    return "\n".join(lines)


# a built-in pattern's key -> its instance in the built-in library
_BUILTIN = {pattern_key(k): i for i, k in enumerate(ERROR_DIFFUSION_KERNELS)}


@functools.lru_cache(maxsize=None)
def _header_of(kernel: ErrorDiffusionKernel):
    """(header of the library that runs `kernel`, its index there): the
    built-in library's for a built-in key, else the pattern's own."""
    if any(off < 1 for _, off, _ in taps_for(kernel)):
        raise ValueError(f"K2: pattern {kernel.name!r} has a tap on or "
                         f"before its own pixel")
    index = _BUILTIN.get(pattern_key(kernel))
    if index is not None:
        return None, index
    return tap_table_header([kernel]), 0


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


@functools.lru_cache(maxsize=None)
def library_name(header=None) -> str:
    """The name of the library compiled with `header` (None: the
    built-in patterns'): a pattern's own is named by its header's hash."""
    from ..._build import include_digest
    if header is None:
        return "k2_error_diffusion"
    return "k2_error_diffusion_p" + include_digest("k2_taps.h", header)


def build_spec(header=None):
    """The build spec (_build.build_all) of the library compiled with
    `header` (tap_table_header's text; None: the built-in patterns');
    writes the header into the build directory."""
    from ..._build import generated_include, nvcc_path
    taps = generated_include("k2_taps.h", header or tap_table_header())
    return (library_name(header), ["csrc/error_diffusion.cu"], nvcc_path(),
            ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", taps])


@functools.lru_cache(maxsize=None)
def _library(header=None):
    """The loaded, typed library compiled with `header` (built at first
    use; looked up once, since finding the compiler costs more than a
    launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec(header))
    fn = lib.k2_wavefront_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k2_geometry.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.k2_geometry.restype = None
    lib.k2_max_window.argtypes = []
    lib.k2_max_window.restype = ctypes.c_int
    lib.k2_error_string.argtypes = [ctypes.c_int]
    lib.k2_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the built-in patterns' library."""
    return _library()


def prepare(kernel: ErrorDiffusionKernel):
    """Compile (once) and load the library that runs `kernel`: the
    renderer calls it when it plans the frame, and a caller of
    ops.dithering.error_diffusion with a pattern of its own before the
    first call, so no launch waits for a build.  A failure raises KernelError (nothing else diffuses the
    frame on the card).  Returns (library, the pattern's index there)."""
    header, index = _header_of(kernel)
    with kernel_work("K2"):
        return _library(header), index


def geometry(Wsp: int, C: int, Hp: int,
             kernel: Optional[ErrorDiffusionKernel] = None
             ) -> Tuple[int, int, int]:
    """(scratch words the wrapper clears, blocks, threads a block) of the
    kernel's launch on a (Wsp, C, Hp) image with `kernel` (default
    Floyd-Steinberg)."""
    lib, index = prepare(kernel or ED_FLOYD_STEINBERG)
    words, blocks, threads = (ctypes.c_longlong(), ctypes.c_int(),
                              ctypes.c_int())
    lib.k2_geometry(index, Wsp, C, Hp, ctypes.byref(words),
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
    lib, index = prepare(kernel)
    with kernel_work("K2"):
        scale = float((1 << new_depth) - 1)
        dt = code_dtype(new_depth)
        out = torch.empty((Wsp, C, Hp), dtype=dt, device=colmaj.device)
        # the band ticket and the boundary words, zero at every launch
        scratch = torch.zeros(geometry(Wsp, C, Hp, kernel)[0],
                              dtype=torch.int32, device=colmaj.device)
        rc = lib.k2_wavefront_launch(
            colmaj.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            int(dt == torch.int32), index, Wsp, C, Hp, W, H, scale, rcp(scale),
            torch.cuda.current_stream(colmaj.device).cuda_stream)
        if rc != 0:
            raise KernelError("K2 launch failed: " +
                               lib.k2_error_string(rc).decode())
    launches += 1
    name = library_name(_header_of(kernel)[0])
    launches_by[name] = launches_by.get(name, 0) + 1
    return out

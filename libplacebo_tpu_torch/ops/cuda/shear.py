"""K3 — the error-diffusion shear and unshear — as a hand-written Hopper
kernel, with its plain PyTorch versions beside it.

Replaces libplacebo_tpu/ops/pallas/shear.py::_shear_body, reached
through `shear_to_colmaj` and `unshear_from_colmaj`.  The wavefront
(kernel K2) walks a *sheared* column-major image (Wsp, C, Hp), in which
every dependency of the error-diffusion pattern points at an earlier
column: pixel (c, y, x) of the frame sits at column x + s*y.

Two layouts of the frame, each with its own kernel bodies in
csrc/shear.cu:
- the renderer's (C, H, W), which `ops/dithering.py::error_diffusion`
  uses: `shear_chw` (float32 frame, any strides -> (W + (H-1)*s, C, H))
  and `unshear_chw` (codes -> contiguous (C, H, W), optionally scaled
  to float32 and clipped, error diffusion's last step, in the same
  pass); plain versions `shear_chw_plain`, `unshear_chw_plain`;
- the reference's padded column-major (Wp, C, Hp), with its explicit
  widths (`Wsp`, `Wp`), shift `s` and true size (`W`, `H`), so the
  module tests compare like with like: `shear_to_colmaj`,
  `unshear_from_colmaj` (one body, coalesced along the column), plain
  version `shear_plain`.

Each entry runs the plain version on a CPU tensor and launches the
kernel (counted in `launches`) on a CUDA tensor, or raises.  See
csrc/shear.cu for what bounds it on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..._build import KernelError, kernel_work

__all__ = ["shear_chw", "unshear_chw", "shear_chw_plain",
           "unshear_chw_plain", "shear_to_colmaj", "unshear_from_colmaj",
           "shear_plain", "sheared_width", "launches", "build",
           "build_spec"]

launches = 0

_DTYPES = {torch.float32: 0, torch.int16: 1, torch.int32: 2}
_TILE_COLS = 128      # a tile's sheared columns (csrc/shear.cu)


def sheared_width(W: int, H: int, s: int) -> int:
    """Columns of a W x H frame sheared by s, unpadded."""
    return W + (H - 1) * s


def shear_plain(x: torch.Tensor, w_out: int, s: int, W: int, H: int,
                forward: bool) -> torch.Tensor:
    """The (W, C, H) entries' function in plain PyTorch, on any device: a
    slice copy per image row into a zeroed (w_out, C, Hp) tensor."""
    _, C, Hp = x.shape
    out = torch.zeros((w_out, C, Hp), dtype=x.dtype, device=x.device)
    for y in range(H):
        if forward:
            out[s * y:s * y + W, :, y] = x[:W, :, y]
        else:
            out[:W, :, y] = x[s * y:s * y + W, :, y]
    return out


def shear_chw_plain(x: torch.Tensor, s: int) -> torch.Tensor:
    """`shear_chw` in plain PyTorch: (C, H, W) -> (Wsp, C, H), a slice
    copy per row into zeros."""
    C, H, W = x.shape
    out = torch.zeros((sheared_width(W, H, s), C, H), dtype=x.dtype,
                      device=x.device)
    for y in range(H):
        out[s * y:s * y + W, :, y] = x[:, y, :].T
    return out


def unshear_chw_plain(codes: torch.Tensor, s: int, W: int,
                      inv_scale: Optional[float] = None) -> torch.Tensor:
    """`unshear_chw` in plain PyTorch: (Wsp, C, H) -> (C, H, W), a slice
    copy per row; with `inv_scale`, float32 codes * inv_scale clamped to
    [0, 1]."""
    _, C, H = codes.shape
    out = torch.empty((C, H, W), dtype=codes.dtype, device=codes.device)
    for y in range(H):
        out[:, y, :] = codes[s * y:s * y + W, :, y].T
    if inv_scale is None:
        return out
    return torch.clamp(out.to(torch.float32) * inv_scale, 0.0, 1.0)


def build_spec():
    """The kernel library's build spec (_build.build_all)."""
    from ..._build import nvcc_path
    return ("k3_shear", ["csrc/shear.cu"], nvcc_path(),
            ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    fn = lib.k3_shear_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.k3_unshear_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.k3_colmaj_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k3_error_string.argtypes = [ctypes.c_int]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _library()


def _check_card(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {t.device}")
    if t.dim() != 3 or t.dtype not in _DTYPES:
        raise ValueError(f"K3: needs a 3-d float32, int16 or int32 {what}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _run(src: torch.Tensor, shape, dtype, call):
    """Allocate the output (`shape`, `dtype`) and launch `call(lib, dst,
    stream)`, one kernel, counted."""
    global launches
    with kernel_work("K3"):
        dst = torch.empty(shape, dtype=dtype, device=src.device)
        lib = _library()
        rc = call(lib, dst,
                  torch.cuda.current_stream(src.device).cuda_stream)
        if rc != 0:
            raise KernelError("K3 launch failed: " +
                               lib.k3_error_string(rc).decode())
    launches += 1
    return dst


def _check_fits(C: int, Hp: int, Wsp: int, s: int):
    if Wsp + _TILE_COLS + s * Hp >= 2 ** 31 or C > 65535 or \
            max(-(-Wsp // _TILE_COLS), -(-Hp // 32)) > 65535:
        raise ValueError(f"K3: {C} channels, a sheared width of {Wsp} "
                         f"columns and a shift of {s} over {Hp} rows do "
                         f"not fit its 32-bit indices and grid")


def shear_chw(x: torch.Tensor, s: int) -> torch.Tensor:
    """(C, H, W) float32 frame -> (W + (H-1)*s, C, H) sheared
    column-major: out[w, c, y] = x[c, y, w - s*y] (0 out of range).  On
    the card the frame may be any strided view (coalesced where its rows
    are contiguous)."""
    if x.device.type == "cpu":
        return shear_chw_plain(x, s)
    _check_card(x, "(C, H, W) frame")
    if x.dtype != torch.float32 or s < 0:
        raise ValueError(f"K3: needs a float32 frame and s >= 0, got "
                         f"{x.dtype}, s = {s}")
    C, H, W = x.shape
    Wsp = sheared_width(W, H, s)
    _check_fits(C, H, Wsp, s)
    sc, sy, sx = x.stride()
    return _run(x, (Wsp, C, H), x.dtype, lambda lib, dst, st:
                lib.k3_shear_launch(x.data_ptr(), dst.data_ptr(),
                                    _DTYPES[x.dtype], C, H, W, H, Wsp, s,
                                    sc, sy, sx, st))


def unshear_chw(codes: torch.Tensor, s: int, W: int,
                inv_scale: Optional[float] = None) -> torch.Tensor:
    """(Wsp, C, H) sheared column-major -> (C, H, W) contiguous:
    out[c, y, x] = codes[x + s*y, c, y]; with `inv_scale` (integer
    codes) the float32 codes * inv_scale clamped to [0, 1]."""
    if codes.device.type == "cpu":
        return unshear_chw_plain(codes, s, W, inv_scale)
    _check_card(codes, "(Wsp, C, H) sheared image")
    Wsp, C, H = codes.shape
    if not codes.is_contiguous() or s < 0 or \
            sheared_width(W, H, s) > Wsp or \
            (inv_scale is not None and codes.dtype == torch.float32):
        raise ValueError(f"K3: {codes.dtype} {tuple(codes.shape)} cannot "
                         f"be unsheared to width {W} by {s}"
                         + (" and scaled" if inv_scale is not None else ""))
    _check_fits(C, H, Wsp, s)
    dt = torch.float32 if inv_scale is not None else codes.dtype
    return _run(codes, (C, H, W), dt, lambda lib, dst, st:
                lib.k3_unshear_launch(
                    codes.data_ptr(), dst.data_ptr(), _DTYPES[codes.dtype],
                    int(inv_scale is not None), C, H, W, H, Wsp, s,
                    inv_scale or 0.0, st))


def _colmaj(x: torch.Tensor, w_out: int, s: int, W: int, H: int,
            forward: bool) -> torch.Tensor:
    """The (W, C, H) entries on the card: checked, then one k3_colmaj
    launch, which writes every position of the (w_out, C, Hp) output."""
    _check_card(x, "(W, C, H) image")
    w_in, C, Hp = x.shape
    if not x.is_contiguous() or H > Hp or s < 0 or \
            sheared_width(W, H, s) > (w_out if forward else w_in) or \
            W > (w_in if forward else w_out):
        raise ValueError(f"K3: widths {w_in}->{w_out} cannot hold a "
                         f"{W}x{H} image sheared by {s}")
    _check_fits(C, Hp, max(w_in, w_out), s)
    return _run(x, (w_out, C, Hp), x.dtype, lambda lib, dst, st:
                lib.k3_colmaj_launch(x.data_ptr(), dst.data_ptr(),
                                     _DTYPES[x.dtype], int(forward), w_in,
                                     w_out, C, Hp, s, W, H, st))


def shear_to_colmaj(xcm: torch.Tensor, Wsp: int, s: int, W: int,
                    H: int) -> torch.Tensor:
    """(Wp, C, Hp) column-major image -> (Wsp, C, Hp) sheared
    column-major: out[w, c, y] = xcm[w - s*y, c, y] (0 out of range)."""
    if xcm.device.type == "cpu":
        return shear_plain(xcm, Wsp, s, W, H, True)
    return _colmaj(xcm, Wsp, s, W, H, True)


def unshear_from_colmaj(colmaj: torch.Tensor, Wp: int, s: int, W: int,
                        H: int) -> torch.Tensor:
    """(Wsp, C, Hp) sheared column-major -> (Wp, C, Hp) column-major:
    out[w, c, y] = colmaj[w + s*y, c, y] (0 in the pad)."""
    if colmaj.device.type == "cpu":
        return shear_plain(colmaj, Wp, s, W, H, False)
    return _colmaj(colmaj, Wp, s, W, H, False)

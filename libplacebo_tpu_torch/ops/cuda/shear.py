"""K3 — the error-diffusion shear and unshear — as a hand-written Hopper
kernel, with its plain PyTorch version beside it.

Replaces libplacebo_tpu/ops/pallas/shear.py::_shear_body, reached
through `shear_to_colmaj` and `unshear_from_colmaj`.  The wavefront
(kernel K2) walks a *sheared* column-major image, in which every
dependency of the error-diffusion pattern points at an earlier column:

    forward  out[w, c, y] = x[w - s*y, c, y]   (0 unless 0 <= w-s*y < W, y < H)
    inverse  out[w, c, y] = x[w + s*y, c, y]   (0 unless w < W and y < H)

The signatures keep the reference's explicit widths (`Wsp`, `Wp`), the
shift `s` and the true image size (`W`, `H`), so the module tests
compare like with like; the port's dispatch (ops/dithering.py) pads
nothing.  The forward pass moves float32, the inverse the int16 (or
int32) codes K2 writes.

`shear_to_colmaj` / `unshear_from_colmaj` are the entries: a CPU tensor
runs the plain version (`shear_plain`: one slice copy per row), a CUDA
tensor launches the kernel (counted in `launches`) or raises.  See
csrc/shear.cu for what bounds it on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["shear_to_colmaj", "unshear_from_colmaj", "shear_plain",
           "launches", "build", "build_spec"]

launches = 0

_DTYPES = {torch.float32: 0, torch.int16: 1, torch.int32: 2}


def shear_plain(x: torch.Tensor, w_out: int, s: int, W: int, H: int,
                forward: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: a slice
    copy per image row into a zeroed (w_out, C, Hp) tensor."""
    _, C, Hp = x.shape
    out = torch.zeros((w_out, C, Hp), dtype=x.dtype, device=x.device)
    for y in range(H):
        if forward:
            out[s * y:s * y + W, :, y] = x[:W, :, y]
        else:
            out[:W, :, y] = x[s * y:s * y + W, :, y]
    return out


def build_spec():
    """The kernel library's build spec (_build.build_all)."""
    from ..._build import nvcc_path
    return ("k3_shear", ["csrc/shear.cu"], nvcc_path(),
            ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    fn = lib.k3_shear_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k3_error_string.argtypes = [ctypes.c_int]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _kernel_lib()


def _shear(x: torch.Tensor, w_out: int, s: int, W: int, H: int,
           forward: bool) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return shear_plain(x, w_out, s, W, H, forward)
    if x.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"K3: needs a contiguous (W, C, H) float32, int16 "
                         f"or int32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    w_in, C, Hp = x.shape
    if H > Hp or W + s * (H - 1) > (w_out if forward else w_in) or \
            W > (w_in if forward else w_out) or s < 0:
        raise ValueError(f"K3: widths {w_in}->{w_out} cannot hold a "
                         f"{W}x{H} image sheared by {s}")
    out = torch.empty((w_out, C, Hp), dtype=x.dtype, device=x.device)
    lib = _kernel_lib()
    rc = lib.k3_shear_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], int(forward),
        w_in, w_out, C, Hp, s, W, H,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("K3 launch failed: " +
                           lib.k3_error_string(rc).decode())
    launches += 1
    return out


def shear_to_colmaj(xcm: torch.Tensor, Wsp: int, s: int, W: int,
                    H: int) -> torch.Tensor:
    """(Wp, C, Hp) column-major image -> (Wsp, C, Hp) sheared
    column-major: out[w, c, y] = xcm[w - s*y, c, y] (0 out of range)."""
    return _shear(xcm, Wsp, s, W, H, True)


def unshear_from_colmaj(colmaj: torch.Tensor, Wp: int, s: int, W: int,
                        H: int) -> torch.Tensor:
    """(Wsp, C, Hp) sheared column-major -> (Wp, C, Hp) column-major:
    out[w, c, y] = colmaj[w + s*y, c, y] (0 in the pad)."""
    return _shear(colmaj, Wp, s, W, H, False)

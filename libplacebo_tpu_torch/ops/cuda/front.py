"""The front — chroma merge -> decode -> PQ linearize — as one
hand-written Hopper kernel, with the plain chain as its plain version.

Replaces no Pallas kernel: the JAX package's renderer runs
`_merge_planes`, `decode_color` and `linearize` as jnp that XLA fuses
into the jitted frame step.  Eagerly, the bilinear 4:2:0 merge, the
decode matrix and the pow-free PQ curve are ~90 launches over the whole
frame; here they are one (csrc/front.cu), from the uploaded float32
planes to the contiguous (3, H, W) linear-light frame.

`plan_front` plans a frame signature on the host: for each channel its
plane, taken as it is or resampled by ops/sampling.py's phased
separable path (each axis's `_phase_plan`, in `resize_separable`'s pass
order), the decode matrix's rows as core/fastmath.py::mix rounds them,
and the PQ fit's coefficients.  It returns None for a geometry the
kernel does not take (a polar or unphased plane scaler, more than
MAX_TAPS nonzero taps in a phase, anti-ringing that would apply); the
renderer decides which frames reach it (render/renderer.py::
_front_plan).  One library serves every plan: the plan's numbers are
the launch's parameters, copied from host memory at each launch.

`run(plan, planes)` is the entry: CPU planes run the plan's plain
version (the renderer's own stages, `FrontPlan.plain`), CUDA planes
launch the kernel (counted in `launches`) or raise.  The kernel equals
the plain chain run on the card bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._build import KernelError, kernel_work
from ...core import transfer as tf
from ...core.colorspace import COLOR_SDR_WHITE
from .. import sampling as ops_sampling

__all__ = ["PQ_LAYOUT", "MAX_PHASES", "MAX_TAPS", "FrontPlan", "plan_front",
           "run", "launches", "ops_per_pixel", "bytes_per_frame", "build",
           "build_spec", "prepare"]

launches = 0

MAX_PHASES = ops_sampling._MAX_ORTHO_PHASES
MAX_TAPS = 2
# the PQ fit's coefficients and the NORM scale, in the kernel's order
# (csrc: FR(name))
PQ_LAYOUT = (("eotf_p", len(tf.EOTF_P_COEF)), ("eotf_t", len(tf.EOTF_T_COEF)),
             ("eotf_p_m_c1", 1), ("pq_c2", 1), ("pq_c3", 1), ("scale", 1))
_OFF = {}
_n = 0
for _name, _len in PQ_LAYOUT:
    _OFF[_name] = _n
    _n += _len
NPQ = _n
del _n, _name, _len
# the plain chain's linearize, FP32 operations a channel: clamp_min (1),
# pq_eotf_fast (clamp 2, six square roots, the first fit's five FMAs and
# product, two sums and a clamp, an FMA, the divide, a clamp and three
# square roots, three products and the second fit's eight FMAs, its
# product) and the scale (1); an FMA is two
_OPS_LINEARIZE = 1 + 2 + 6 + 10 + 1 + 2 + 1 + 2 + 1 + 1 + 3 + 3 + 16 + 1 + 1
# csrc/front.cu's plane modes
AS_IS, ROWS_FIRST, COLS_FIRST = 0, 1, 2


class _Axis(ctypes.Structure):
    _fields_ = [("phases", ctypes.c_int),
                ("base", ctypes.c_int * MAX_PHASES),
                ("ntaps", ctypes.c_int * MAX_PHASES),
                ("off", (ctypes.c_int * MAX_TAPS) * MAX_PHASES),
                ("w", (ctypes.c_float * MAX_TAPS) * MAX_PHASES)]


class _Plane(ctypes.Structure):
    _fields_ = [("h", ctypes.c_int), ("w", ctypes.c_int),
                ("mode", ctypes.c_int), ("ax", _Axis * 2)]


class _Row(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("one", ctypes.c_int),
                ("has_b", ctypes.c_int), ("chan", ctypes.c_int * 3),
                ("w", ctypes.c_float * 3), ("b", ctypes.c_float)]


class _Params(ctypes.Structure):
    """csrc/front.cu's FrontParams."""
    _fields_ = [("v", ctypes.c_float * NPQ), ("row", _Row * 3),
                ("plane", _Plane * 3)]


def kernel_flags():
    """nvcc flags: sm_90a, no fast-math, no FMA contraction beyond the
    source's explicit fmaf(), ptxas's report, and the layout as macros."""
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-DFR_NPQ={NPQ}", f"-DFR_MAX_PHASES={MAX_PHASES}",
            f"-DFR_MAX_TAPS={MAX_TAPS}",
            f"-DFR_N_EOTF_P={len(tf.EOTF_P_COEF)}",
            f"-DFR_N_EOTF_T={len(tf.EOTF_T_COEF)}"] + \
        [f"-DFR_OFF_{name}={off}" for name, off in _OFF.items()]


def build_spec():
    """The kernel library's build spec (_build.build_all): one library
    for every plan."""
    from ..._build import nvcc_path
    return ("front", ["csrc/front.cu"], nvcc_path(), kernel_flags())


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    lib.fr_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    lib.fr_launch.restype = ctypes.c_int
    lib.fr_error_string.argtypes = [ctypes.c_int]
    lib.fr_error_string.restype = ctypes.c_char_p
    lib.fr_params_bytes.restype = ctypes.c_int
    if lib.fr_params_bytes() != ctypes.sizeof(_Params):
        raise KernelError(f"front: FrontParams is {lib.fr_params_bytes()} "
                          f"bytes, its mirror {ctypes.sizeof(_Params)}")
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _library()


def prepare():
    """Compile (once) and load the library: the renderer calls it when it
    plans a front, so no launch waits for a build.  A failure raises
    KernelError."""
    with kernel_work("front"):
        return _library()


@dataclass(frozen=True)
class FrontPlan:
    """A frame signature's front: the reference grid (H, W); for each
    channel the index of its plane in the frame, that plane's (h, w) and
    mode (AS_IS, ROWS_FIRST, COLS_FIRST) and, resampled, each axis's
    phases as (P, ((base, ((tap, weight), ...)), ...)) for rows then
    columns; the decode rows as (terms ((channel, weight), ...), bias);
    the kernel's parameters (host memory) and the plain chain
    `plain(*planes)`."""
    H: int
    W: int
    channels: Tuple
    rows: Tuple
    params: _Params = field(compare=False, repr=False)
    plain: Callable = field(compare=False, repr=False)


def _axis_plan(cfg, src: int, dst: int, s0: float, s1: float,
               antiring: float):
    """The axis's phases as sample_ortho's phased path runs them, or
    None where it takes another path or anti-ringing applies."""
    plan = ops_sampling._phase_plan(cfg, src, dst, float(s0), float(s1))
    if plan is None:
        return None
    P, _, phases = plan
    if antiring > 0.0 and dst > (s1 - s0) and \
            any(w.min() < 0.0 for _, w in phases):
        return None
    out = []
    for base, wts in phases:
        taps = tuple((t, float(wts[t])) for t in range(len(wts))
                     if wts[t] != 0.0)
        if not 0 < len(taps) <= MAX_TAPS:
            return None
        out.append((int(base), taps))
    return P, tuple(out)


def _fill_axis(ax: _Axis, plan):
    P, phases = plan
    ax.phases = P
    for p, (base, taps) in enumerate(phases):
        ax.base[p] = base
        ax.ntaps[p] = len(taps)
        for k, (t, w) in enumerate(taps):
            ax.off[p][k] = t
            ax.w[p][k] = w


def _decode_rows(mat, bias):
    """ops/color.py::mat_pointwise's rows: each row's nonzero terms
    (channel, weight as a host float) in order, and its bias (0.0: none)."""
    mat = np.asarray(mat, dtype=np.float64)
    rows = []
    for c in range(3):
        terms = tuple((k, float(mat[c, k])) for k in range(3)
                      if float(mat[c, k]) != 0.0)
        rows.append((terms, float(bias[c]) if bias is not None else 0.0))
    return tuple(rows)


def plan_front(planes: Sequence, H: int, W: int, mat, bias,
               plain: Callable) -> Optional[FrontPlan]:
    """The front of a frame whose merged channels 0, 1, 2 come from
    `planes`: per channel (index of its plane in the frame, plane h,
    plane w, resample), the resample None (taken as it is on the (H, W)
    grid) or (filter config, source RectF, anti-ringing strength) as the
    merge resamples it; decoded by the (3, 3) matrix `mat` and `bias`
    (color_repr_decode), then PQ-linearized into NORM light;
    `plain(*planes)` is the plain chain.  None where the kernel does not
    take the geometry."""
    if 3 * H * W >= 2 ** 31:
        return None             # the kernel's offsets are 32-bit
    prm = _Params()
    channels = []
    for c, (index, ph, pw, resample) in enumerate(planes):
        pl = prm.plane[c]
        pl.h, pl.w = ph, pw
        if resample is None:
            if (ph, pw) != (H, W):
                return None
            pl.mode = AS_IS
            channels.append((index, (ph, pw), AS_IS, None))
            continue
        cfg, rect, antiring = resample
        if cfg.polar:
            return None
        axes = (_axis_plan(cfg, ph, H, rect.y0, rect.y1, antiring),
                _axis_plan(cfg, pw, W, rect.x0, rect.x1, antiring))
        if axes[0] is None or axes[1] is None:
            return None
        # resize_separable's order: the pass that shrinks the
        # intermediate most first
        pl.mode = ROWS_FIRST if H * pw <= ph * W else COLS_FIRST
        for ax, plan in zip(pl.ax, axes):
            _fill_axis(ax, plan)
        channels.append((index, (ph, pw), pl.mode, axes))
    rows = _decode_rows(mat, bias)
    for r, (terms, b) in zip(prm.row, rows):
        r.n = len(terms)
        r.one = sum(1 << i for i, (_, w) in enumerate(terms) if w == 1.0)
        r.has_b = int(b != 0.0)
        r.b = b
        for i, (k, w) in enumerate(terms):
            r.chan[i], r.w[i] = k, w
    v = dict(eotf_p=tf.EOTF_P_COEF, eotf_t=tf.EOTF_T_COEF,
             eotf_p_m_c1=tf.EOTF_P_LAST_M_C1, pq_c2=tf.PQ_C2,
             pq_c3=tf.PQ_C3, scale=10000.0 / COLOR_SDR_WHITE)
    for name, n in PQ_LAYOUT:
        prm.v[_OFF[name]:_OFF[name] + n] = [
            float(x) for x in np.asarray(v[name], np.float32).reshape(n)]
    return FrontPlan(H, W, tuple(channels), rows, prm, plain)


def _mix_ops(terms, b: float) -> int:
    """FP32 operations of core/fastmath.py::mix over `terms` (an FMA is
    two): a weight of 1 is no product."""
    if not terms:
        return int(b != 0.0)
    products = sum(w != 1.0 for _, w in terms)
    return products + (len(terms) - 1) + int(b != 0.0)


def _tap_ops(taps) -> int:
    return sum(w != 1.0 for _, w in taps) + len(taps) - 1


def ops_per_pixel(plan: FrontPlan) -> float:
    """FP32 operations of the plain chain a pixel: each resampled
    channel's two passes (averaged over the output phases), the decode
    rows and the linearize."""
    ops = 3 * _OPS_LINEARIZE + sum(_mix_ops(t, b) for t, b in plan.rows)
    for _, _, mode, axes in plan.channels:
        if mode == AS_IS:
            continue
        # the second pass sums the first pass's outputs: per output, the
        # second axis's taps, each a first-axis tap sum
        first, second = axes if mode == ROWS_FIRST else axes[::-1]
        total = 0
        for _, t1 in first[1]:
            for _, t2 in second[1]:
                total += len(t2) * _tap_ops(t1) + _tap_ops(t2)
        ops += total / (len(first[1]) * len(second[1]))
    return ops


def bytes_per_frame(plan: FrontPlan) -> int:
    """Bytes the kernel must move a frame: each plane read once, the
    float32 (3, H, W) frame written once."""
    return sum(4 * h * w for _, (h, w), _, _ in plan.channels) + \
        12 * plan.H * plan.W


def run(plan: FrontPlan, planes):
    """The front of a frame's planes (in frame order, each (1, h, w)
    float32): the (3, H, W) linear-light frame.  CPU planes run the plain
    chain; CUDA planes launch the kernel."""
    global launches
    if not isinstance(plan, FrontPlan):
        raise ValueError("front: plan must be a FrontPlan")
    ins = []
    for index, (h, w), _, _ in plan.channels:
        x = planes[index]
        if not torch.is_tensor(x) or x.dtype != torch.float32 or \
                tuple(x.shape) != (1, h, w):
            raise ValueError(f"front: plane {index} must be a (1, {h}, {w}) "
                             f"float32 tensor, got "
                             f"{getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))}")
        ins.append(x)
    dev = ins[0].device
    if any(x.device != dev for x in ins):
        raise ValueError("front: planes on different devices")
    if dev.type == "cpu":
        return plan.plain(*planes)
    if dev.type != "cuda":
        raise ValueError(f"front: unsupported device {dev}")
    with kernel_work("front"):
        ins = [x.contiguous() for x in ins]
        out = torch.empty((3, plan.H, plan.W), dtype=torch.float32,
                          device=dev)
        lib = _library()
        rc = lib.fr_launch(ctypes.addressof(plan.params),
                           *[x.data_ptr() for x in ins], out.data_ptr(),
                           plan.H, plan.W,
                           torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise KernelError("front launch failed: " +
                              lib.fr_error_string(rc).decode())
    launches += 1
    return out

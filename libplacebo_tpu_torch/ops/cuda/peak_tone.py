"""The colour tail's per-frame scalars — the dynamic tone curve's vector
and the peak state's temporal finish — as one hand-written Hopper
kernel library, with the plain PyTorch chain as their plain version.

Replaces no Pallas kernel: the JAX package's scalar chains
(libplacebo_tpu/ops/tone_dynamic.py::tone_params,
libplacebo_tpu/ops/peak_detect.py::finish_from_packed) are plain jnp that
XLA fuses into the jitted frame step.  Eagerly, each 0-dim operation of
`ops/tone_dynamic.py::tone_vector`, `ops/peak_detect.py::delayed_stats`
and `finish_from_packed` is a launch of its own, ~130 a frame around
K1's one; here they are two (csrc/peak_tone.cu):
- the prologue, `tone_vector` (from (avg_pq, max_pq)) and
  `delayed_tone_vector` (from the (2,) peak state, by delayed_stats'
  rule): K1's (TONE_VECTOR_LEN,) tone vector for any curve of
  DYNAMIC_TONE_FUNCTIONS, which the plan (`plan_tone`) names;
- the epilogue, `peak_finish`: K1's (G, 8, 128) peak partials and the
  old state to a fresh (2,) new state (`ops/peak_detect.py::
  finish_from_packed` dispatches a CUDA tensor here).

Every Python float the plain chain uses is computed here once a plan, in
float64 as the chain computes it, and handed to the kernel as the
float32 PyTorch would round it to (`TONE_LAYOUT`, `PEAK_LAYOUT`), so the
kernel repeats the chain operation for operation: the tone vector bit
for bit, the state but for the order in which the stripe means are
added (a few ulps, csrc/peak_tone.cu).  Each entry checks its
arguments, runs the plain chain on a CPU tensor, and launches the kernel
(counted in `launches`) on a CUDA tensor, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..._build import KernelError, kernel_work
from ...core.colorspace import COLOR_HDR_BLACK, HdrScaling, hdr_rescale
from ...core.fastmath import rcp
from ...core.tone_mapping import ToneMapConstants
from ...core.transfer import PQ_C1, PQ_C2, PQ_C3, PQ_M1, PQ_M2, pow_pos
from .. import peak_detect as ops_peak
from .. import tone_dynamic as ops_tone
from ..tone_dynamic import _INV_GAMMA

__all__ = ["TONE_LAYOUT", "PEAK_LAYOUT", "TonePlan", "plan_tone",
           "tone_vector", "delayed_tone_vector", "peak_finish", "launches",
           "build", "build_spec"]

launches = 0

# the prologue's host constants, in the kernel's order (csrc: T(name))
TONE_LAYOUT = (
    "src_max_pq", "dst_min", "dst_max", "dst_range",
    "knee_min", "knee_max", "knee_def", "dst_knee_min", "dst_knee_max",
    "ss_max_rcp", "ss_min_rcp", "one_m_adapt", "adapt",
    "rcp_dst_max", "slope_tuning", "slope_lo", "slope_hi", "one_m_contrast",
    "one_p_offset", "neg_offset",
    "pq_inv_m2", "pq_c1", "pq_neg_c3", "pq_c2", "pq_inv_m1",
    "nits_min", "nits_max", "inv_gamma", "lb0", "rcp_nits_max", "ky_hi",
    "one_m_lb0", "den01", "lbd", "span_d")
# the epilogue's (csrc: P(name))
PEAK_LAYOUT = ("coeff", "eps", "cut_lo", "cut_rcp", "pct", "rcp_pq_max",
               "black")
_REC = ops_peak.PARTIAL_SHAPE[0] * ops_peak.PARTIAL_SHAPE[1]


def kernel_flags():
    """nvcc flags: sm_90a, no fast-math, no FMA contraction beyond the
    source's explicit __fmaf_rn, ptxas's report, and the layouts and the
    partials record's shape as macros."""
    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-DPT_NTONE={len(TONE_LAYOUT)}",
            f"-DPT_NPEAK={len(PEAK_LAYOUT)}",
            f"-DPT_VECTOR_LEN={ops_tone.TONE_VECTOR_LEN}",
            f"-DPT_HIST_BINS={ops_peak.HIST_BINS}",
            f"-DPT_HIST_BIAS={ops_peak.HIST_BIAS}",
            f"-DPT_HIST_SHIFT={ops_peak.PQ_BITS - ops_peak.HIST_BITS}",
            f"-DPT_REC={_REC}", f"-DPT_ROW1={ops_peak.PARTIAL_SHAPE[1]}"] + \
        [f"-DPT_T_{n}={i}" for i, n in enumerate(TONE_LAYOUT)] + \
        [f"-DPT_P_{n}={i}" for i, n in enumerate(PEAK_LAYOUT)]


def build_spec():
    """The kernel library's build spec (_build.build_all): one library
    for every curve."""
    from ..._build import nvcc_path
    return ("peak_tone", ["csrc/peak_tone.cu"], nvcc_path(), kernel_flags())


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded, typed kernel library (built at first use; looked up
    once, since finding the compiler costs more than a launch)."""
    from ..._build import load_shared
    lib = load_shared(*build_spec())
    lib.pt_tone_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.pt_tone_launch.restype = ctypes.c_int
    lib.pt_finish_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.pt_finish_launch.restype = ctypes.c_int
    lib.pt_error_string.argtypes = [ctypes.c_int]
    lib.pt_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile (once) and load the kernel library."""
    return _library()


@dataclass(frozen=True)
class TonePlan:
    """A tail's dynamic curve: its name and index, the arguments of the
    plain `ops/tone_dynamic.py::tone_vector`, the metadata peak that
    delayed_stats applies while the state is unset, and the prologue's
    constants (TONE_LAYOUT, float32, host memory)."""
    function: str
    curve: int
    dst_min: float
    dst_max: float
    constants: Optional[ToneMapConstants]
    src_max_pq: float
    consts: np.ndarray = field(compare=False, repr=False)


def _pow_pos_cpu(v: float) -> float:
    """pow_pos(v, 1/2.4) as the plain chain computes it: on the CPU."""
    return float(pow_pos(torch.tensor(v, dtype=torch.float32), _INV_GAMMA))


def plan_tone(function: str, dst_min: float, dst_max: float,
              constants: Optional[ToneMapConstants],
              src_max_pq: float) -> TonePlan:
    """The prologue's plan for `function` mapping into [dst_min, dst_max]
    (PQ) with `constants` (None: the defaults); `src_max_pq` is the
    metadata peak (PQ) that `delayed_tone_vector` applies while the state
    is unset."""
    if function not in ops_tone.DYNAMIC_TONE_FUNCTIONS:
        raise ValueError(f"peak_tone: no dynamic tone curve {function!r}")
    c = (constants or ToneMapConstants()).fixed()
    nmin = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_min)
    nmax = hdr_rescale(HdrScaling.PQ, HdrScaling.NITS, dst_max)
    lb0 = _pow_pos_cpu(0.0)
    lbd, lwd = _pow_pos_cpu(nmin), _pow_pos_cpu(nmax)
    v = dict(
        src_max_pq=src_max_pq, dst_min=dst_min, dst_max=dst_max,
        dst_range=dst_max - dst_min,
        knee_min=c.knee_minimum, knee_max=c.knee_maximum,
        knee_def=c.knee_default,
        dst_knee_min=dst_min + (dst_max - dst_min) * c.knee_minimum,
        dst_knee_max=dst_min + (dst_max - dst_min) * c.knee_maximum,
        ss_max_rcp=rcp(c.knee_default - c.knee_maximum + 1e-12),
        ss_min_rcp=rcp(c.knee_default - c.knee_minimum + 1e-12),
        one_m_adapt=1.0 - c.knee_adaptation, adapt=c.knee_adaptation,
        rcp_dst_max=rcp(dst_max), slope_tuning=c.slope_tuning,
        slope_lo=c.slope_offset, slope_hi=1.0 + c.slope_offset,
        one_m_contrast=1.0 - c.spline_contrast,
        one_p_offset=1.0 + c.knee_offset, neg_offset=-c.knee_offset,
        pq_inv_m2=1.0 / PQ_M2, pq_c1=PQ_C1, pq_neg_c3=-PQ_C3, pq_c2=PQ_C2,
        pq_inv_m1=1.0 / PQ_M1,
        nits_min=nmin, nits_max=nmax, inv_gamma=_INV_GAMMA, lb0=lb0,
        rcp_nits_max=rcp(max(nmax, 1e-9)), ky_hi=1.0 - 1e-6,
        one_m_lb0=1.0 - lb0, den01=max(1.0 - lb0, 1e-9), lbd=lbd,
        span_d=lwd - lbd)
    return TonePlan(function,
                    ops_tone.DYNAMIC_TONE_FUNCTIONS.index(function),
                    float(dst_min), float(dst_max), constants,
                    float(src_max_pq),
                    np.array([v[n] for n in TONE_LAYOUT], dtype=np.float32))


@functools.lru_cache(maxsize=64)
def _peak_consts(params: ops_peak.PeakDetectParams):
    """(constants, use_pct, scene_cut) of the epilogue for `params`, as
    ops/peak_detect.py's _percentile_max and _temporal_update compute
    them."""
    p = params
    lo, hi = p.scene_threshold_low * 1e-2, p.scene_threshold_high * 1e-2
    scene_cut = p.scene_threshold_low > 0 and p.scene_threshold_high > 0
    v = dict(
        coeff=1.0 - float(np.exp(-1.0 / p.smoothing_period))
        if p.smoothing_period > 0 else 1.0,
        eps=1.0 / ops_peak.PQ_MAX,
        cut_lo=lo, cut_rcp=rcp(hi - lo) if scene_cut else 0.0,
        pct=p.percentile / 100.0, rcp_pq_max=rcp(ops_peak.PQ_MAX),
        black=COLOR_HDR_BLACK)
    consts = np.array([v[n] for n in PEAK_LAYOUT], dtype=np.float32)
    return consts, int(0 < p.percentile < 100), int(scene_cut)


def _check(t, name, shape):
    if not torch.is_tensor(t) or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"peak_tone: {name} must be a contiguous float32 "
                         f"tensor, got {getattr(t, 'dtype', type(t))}")
    if len(shape) != t.dim() or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"peak_tone: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("peak_tone: arguments on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"peak_tone: unsupported device {dev}")
    return dev


def _launch_tone(plan: TonePlan, a, b, delayed: bool):
    global launches
    with kernel_work("peak_tone"):
        out = torch.empty(ops_tone.TONE_VECTOR_LEN, dtype=torch.float32,
                          device=a.device)
        lib = _library()
        rc = lib.pt_tone_launch(
            a.data_ptr(), b.data_ptr(), int(delayed), plan.curve,
            plan.consts.ctypes.data, out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise KernelError("peak_tone launch failed: " +
                              lib.pt_error_string(rc).decode())
    launches += 1
    return out


def tone_vector(plan: TonePlan, avg_pq, max_pq):
    """K1's tone vector from the applied stats (0-dim float32 tensors):
    ops/tone_dynamic.py::tone_vector of the plan's curve."""
    if not isinstance(plan, TonePlan):
        raise ValueError("peak_tone: plan must be a TonePlan")
    _check(avg_pq, "avg_pq", ())
    _check(max_pq, "max_pq", ())
    if _device(avg_pq, max_pq).type == "cpu":
        return ops_tone.tone_vector(plan.function, max_pq, avg_pq,
                                    plan.dst_min, plan.dst_max,
                                    plan.constants)
    return _launch_tone(plan, avg_pq, max_pq, False)


def delayed_tone_vector(plan: TonePlan, state):
    """K1's tone vector for an allow_delayed frame: the (2,) peak state's
    stats, or the plan's metadata peak while it is unset
    (ops/peak_detect.py::delayed_stats), through the plan's curve."""
    if not isinstance(plan, TonePlan):
        raise ValueError("peak_tone: plan must be a TonePlan")
    _check(state, "state", (2,))
    if _device(state).type == "cpu":
        avg_pq, max_pq = ops_peak.delayed_stats(state, plan.src_max_pq)
        return ops_tone.tone_vector(plan.function, max_pq, avg_pq,
                                    plan.dst_min, plan.dst_max,
                                    plan.constants)
    return _launch_tone(plan, state, state[1:], True)


def peak_finish(packed, state, params: ops_peak.PeakDetectParams):
    """The new (2,) peak state from K1's (G, 8, 128) partials and the
    old (2,) state (ops/peak_detect.py::finish_from_packed), in a fresh
    tensor: the old state is never written."""
    global launches
    _check(packed, "packed", (None,) + ops_peak.PARTIAL_SHAPE)
    _check(state, "state", (2,))
    if packed.shape[0] < 1:
        raise ValueError("peak_tone: no partials records")
    if _device(packed, state).type == "cpu":
        return ops_peak.finish_from_packed_plain(packed, state, params)[2]
    consts, use_pct, scene_cut = _peak_consts(params)
    with kernel_work("peak_tone"):
        out = torch.empty(2, dtype=torch.float32, device=state.device)
        lib = _library()
        rc = lib.pt_finish_launch(
            packed.data_ptr(), packed.shape[0], state.data_ptr(),
            consts.ctypes.data, use_pct, scene_cut, out.data_ptr(),
            torch.cuda.current_stream(state.device).cuda_stream)
        if rc != 0:
            raise KernelError("peak_tone launch failed: " +
                              lib.pt_error_string(rc).decode())
    launches += 1
    return out

#!/usr/bin/env python3
"""Per-pass micro-benchmark of the port, mirroring the reference's pass
list (src/tests/bench.c:514-560): every shader routine timed standalone
at 1920x1080 float32 on the card, plus the host<->device transfer paths
and the flagship's K1 tail.

Each pass: its inputs made from a seed on the card, one warm-up call,
then `--n` calls back to back between two CUDA events (the host clock
on the CPU, where the times say nothing of a GPU).  Beside each pass's
ms it records its device operations a call (kernels, copies and fills),
their summed device ms and the device's span between the call's two
marker kernels, from one torch.profiler session after every pass is
timed, each pass called PROFILE_ROUNDS times there (its reading is
the slowest call among those whose operations fit their span: one
stream's operations cannot take longer, so a call whose sum exceeds its
span holds another pass's activity and is left out); its byte floor
(the bytes of its inputs and outputs over 3.35 TB/s, the H100's HBM
rate); and, for the passes that run the
hand-written kernels, their bound on the inputs the pass gave them (K1:
its bytes or its operations over 67 TFLOP/s; K2 and K3: their bytes and
operations).  These bound helpers are the only copy: the smoke test
computes its kernels' bounds with them.  A pass is timed as an eager caller pays
for it: host work an op redoes every call (a dither LUT, a white-noise
draw) is in its ms, where the renderer plans it once.

A pass that fails is recorded and printed with its error; the run goes
on and exits 1 at the end.

Usage:
    python3 -m libplacebo_tpu_torch.tools.bench_micro          # card, 1080p
    python3 -m libplacebo_tpu_torch.tools.bench_micro --cpu --size 128x96 --n 1
    python3 -m libplacebo_tpu_torch.tools.bench_micro --passes polar,deband \\
        --json out.json
--ed is accepted and changes nothing: error diffusion always runs.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..demos import (add_device_args, device_from, flagship_frames,
                     synchronize)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_OPS_PER_S = 67e12        # H100 SXM, FP32 outside the tensor cores
# the marker between the profiled calls (torch.cuda._sleep's kernel)
MARK_KERNEL, MARK_CYCLES = "spin_kernel", 1000
# a pass's profiled device ms against its timed ms: one profiled call's
# device operations must fit in the time a call takes back to back, x1.25,
# plus the tracer's cost, 0.01 ms an operation (deband's 84 operations
# trace 0.6-0.85 ms longer than its untimed ms)
DEVICE_MS_MARGIN, TRACE_MS_PER_OP = 1.25, 0.01
# profiled calls a pass (its device ms is the slowest's that fits its
# span), and the timestamps' rounding allowed when a call's operations
# are held to the span between its markers
PROFILE_ROUNDS, SPAN_SLACK_MS = 3, 0.002
# the passes that launch nothing on the device (a view)
NO_DEVICE_OPS = ("weave",)
# the passes whose one operation is a copy to or from pageable host
# memory: traced, the copy spans the driver's staging through pinned
# buffers (3.9 and 9.5 ms on the H100 against 2.0 and 1.9 ms untraced),
# so its device ms is not held to its ms
PAGEABLE_COPIES = ("tex_upload ptr", "tex_download ptr")


def nbytes(x) -> int:
    """Bytes of every tensor or array in a (nested) result or args."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, (tuple, list)):
        return sum(nbytes(v) for v in x)
    return 0


def bound_ms(nbytes_: int, ops: int = 0):
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the FP32 operations over the FP32 peak."""
    b = nbytes_ / HBM_BYTES_PER_S * 1e3
    o = ops / FP32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def k1_bound(img, plan, tone, lut, partials, ops_per_pixel):
    """K1's bound on these inputs: the frame read and written, the
    constants, the tone vector, the LUT and the peak partials; its
    operations a pixel from the plan."""
    npix = img.shape[-2] * img.shape[-1]
    return bound_ms(2 * 3 * npix * 4 + plan.consts.nbytes
                    + nbytes(partials) + nbytes(tone) + nbytes(lut),
                    ops_per_pixel * npix)


def k2_bound(colmaj, kernel, depth: int, w: int, h: int):
    """K2's bound on one call's inputs (its wrapper's arguments): it reads
    the W x H frame's pixels and writes their codes, 7 operations a pixel
    and a fused multiply-add a tap."""
    from ..ops.cuda import error_diffusion as k2
    n_px = w * colmaj.shape[1] * h
    code_bytes = torch.empty(0, dtype=k2.code_dtype(depth)).element_size()
    return bound_ms(n_px * (4 + code_bytes),
                    n_px * (7 + 2 * len(k2.taps_for(kernel))))


def k3_bytes(forward: bool, args) -> int:
    """The bytes one K3 call must move (its wrapper's arguments: forward
    shear_chw's (x, s), inverse unshear_chw's (codes, s, W, inv_scale)):
    forward it reads the (C, H, W) frame and writes the whole sheared
    (Wsp, C, H) image; inverse it reads the W x H codes of each channel
    it keeps and writes them, as float32 where it scales them."""
    from ..ops.cuda import shear as k3
    if forward:
        x, s = args
        C, H, W = x.shape
        return (C * H * W + k3.sheared_width(W, H, s) * C * H) * \
            x.element_size()
    codes, _, W, inv_scale = args
    n = codes.shape[1] * codes.shape[2] * W
    return n * (codes.element_size() +
                (4 if inv_scale is not None else codes.element_size()))


def k3_run(forward: bool, args, plain: bool = False):
    """One captured K3 call (`capture_ed`'s (forward, args)) again,
    through the wrapper or its plain version."""
    from ..ops.cuda import shear as k3
    if forward:
        return (k3.shear_chw_plain if plain else k3.shear_chw)(*args)
    return (k3.unshear_chw_plain if plain else k3.unshear_chw)(*args)


def capture_ed(x, depth: int, kernel):
    """One error-diffusion call of `x` with K2's and K3's arguments
    captured: (K2's (colmaj, kernel, depth, w, h), [K3's (forward,
    args)], forward first)."""
    from ..ops import dithering as ops_dither
    from ..ops.cuda import error_diffusion as k2
    from ..ops.cuda import shear as k3
    k2_args, k3_calls = [], []
    real = (k2.wavefront, k3.shear_chw, k3.unshear_chw)

    def cap_k2(*a):
        k2_args.append(a)
        return real[0](*a)

    def cap_k3(i, forward):
        def run(*a):
            k3_calls.append((forward, a + (None,) * (4 - len(a))
                             if not forward else a))
            return real[i](*a)
        return run
    k2.wavefront = cap_k2
    k3.shear_chw, k3.unshear_chw = cap_k3(1, True), cap_k3(2, False)
    try:
        ops_dither.error_diffusion(x, depth, kernel)
    finally:
        k2.wavefront, k3.shear_chw, k3.unshear_chw = real
    if len(k2_args) != 1 or len(k3_calls) != 2:
        raise RuntimeError(f"error diffusion ran K2 {len(k2_args)} and K3 "
                           f"{len(k3_calls)} times, not 1 and 2")
    return k2_args[0], k3_calls


def ed_bounds(k2_args, k3_calls) -> dict:
    """K3 forward, K2 and K3 inverse's bounds on one error-diffusion
    call's captured arguments (`capture_ed`)."""
    out = {"k2": k2_bound(*k2_args)}
    for forward, args in k3_calls:
        out["k3_forward" if forward else "k3_inverse"] = bound_ms(
            k3_bytes(forward, args))
    return out


def profile_violations(passes: dict) -> list:
    """The passes whose profiled device operations do not fit their
    timing: none recorded (but for NO_DEVICE_OPS), or more device ms than
    a call takes back to back (DEVICE_MS_MARGIN, TRACE_MS_PER_OP; but for
    PAGEABLE_COPIES)."""
    bad = []
    for name, p in passes.items():
        n, busy, ms = p.get("launches"), p.get("device_ms"), p["ms"]
        if n is None or busy is None:
            bad.append((name, "not profiled"))
        elif name not in NO_DEVICE_OPS and not (n >= 1 and busy > 0):
            bad.append((name, f"{n} device operations, {busy} ms"))
        elif name not in PAGEABLE_COPIES and \
                busy > DEVICE_MS_MARGIN * ms + TRACE_MS_PER_OP * n:
            bad.append((name, f"device {busy:.4f} ms in {n} operations > "
                              f"{ms:.4f} ms a call"))
    return bad


def card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, args, n: int, dev: torch.device) -> float:
    """ms a call: one warm-up, then n calls back to back between two
    CUDA events (the host clock on the CPU)."""
    fn(*args)
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / n


def split_rounds(ops, names, rounds: int) -> dict:
    """Split one profiler session's device operations at its marker
    kernels.  `ops` are (name, start us, duration us) in start order;
    each of the passes `names` was called `rounds` times, a marker
    before every call and after the last.  Returns {pass: [(operations,
    their summed ms, span ms), ...] a round}, the span being the
    device's time between the round's two markers (the end of the one
    before to the start of the one after)."""
    marks = [i for i, op in enumerate(ops) if MARK_KERNEL in op[0]]
    if len(marks) != len(names) * rounds + 1:
        gaps = [round(ops[j][1] - ops[i][1]) for i, j in zip(marks,
                                                              marks[1:])]
        raise RuntimeError(
            f"the profiler recorded {len(marks)} of the "
            f"{len(names) * rounds + 1} markers ({len(ops)} device "
            f"operations; before the first marker "
            f"{marks[0] if marks else None}; us between markers {gaps})")
    out = {}
    for p, name in enumerate(names):
        out[name] = []
        for r in range(rounds):
            a, b = marks[p * rounds + r], marks[p * rounds + r + 1]
            seg = ops[a + 1:b]
            out[name].append((len(seg), sum(d for _, _, d in seg) / 1e3,
                              (ops[b][1] - ops[a][1] - ops[a][2]) / 1e3))
    return out


def pass_reading(rounds):
    """A pass's (operations, device ms, span ms) from its profiled rounds
    (split_rounds): the slowest round by device ms among those whose
    operations fit between their markers, so the gate holds every round
    that can be read.  Operations on one stream cannot take more than
    that span, so a round whose sum exceeds it holds an activity of
    another pass (or a misread one) and is left out; None when no round
    fits: the split is wrong."""
    fits = [r for r in rounds if r[1] <= r[2] + SPAN_SLACK_MS]
    return max(fits, key=lambda r: r[1]) if fits else None


def device_ops(timed, dev: torch.device):
    """split_rounds of one call of each (name, fn, args), called
    PROFILE_ROUNDS times in turn — kernels, copies and fills, as
    torch.profiler records them on the card ({} on the CPU).  One profiler session for every
    pass (short sessions back to back lose activities).  A marker kernel
    (`torch.cuda._sleep`) runs to its end before each call and after the
    last, and each call ends synchronized, so on the device's own
    timeline every operation of a call starts between its two markers:
    a call's operations are those, whatever launched them (the profiler
    links the hand-written kernels, launched through the driver API from
    their own libraries, to no host op).  A pass whose ms is well above
    its device ms is held back by the host (per-call planning, launch
    issue)."""
    if dev.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile, schedule

    def mark():
        torch.cuda._sleep(MARK_CYCLES)
        synchronize(dev)
    synchronize(dev)
    # a warm-up step first, so the tracer is running before the recorded
    # step begins, and a prologue of throwaway operations in that step
    # before its first marker: in a process that had profiled before,
    # the step's first device activity went missing (the first marker,
    # with the warm-up step and 0.1 s of idle device around the step)
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        torch.zeros(1).to(dev).add_(1)
        synchronize(dev)
        prof.step()
        time.sleep(0.1)
        for _ in range(3):
            torch.zeros(1, device=dev).add_(1)
        synchronize(dev)
        for _, fn, args in timed:
            for _ in range(PROFILE_ROUNDS):
                mark()
                fn(*args)
                synchronize(dev)
        mark()
        time.sleep(0.1)
        prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted(((e.name, e.time_range.start, e.time_range.elapsed_us())
                  for e in events if e.device_type == cuda),
                 key=lambda op: op[1])
    return split_rounds(ops, [name for name, _, _ in timed],
                        PROFILE_ROUNDS)


def define_passes(W: int, H: int, dev: torch.device):
    """[(name, setup)]: setup() -> (fn, args, per, bounds) where fn(*args)
    is one call, `per` the frames a call handles and `bounds` the
    hand-written kernels' {name: (ms, "bytes" | "operations")} at the
    pass's shapes."""
    from ..core import filters as flt
    from ..core import tone_mapping as tm
    from ..core.colorspace import ColorPrimaries, HdrScaling, primaries_get
    from ..core.common import RectF
    from ..core.dither import DitherMethod, find_error_diffusion_kernel
    from ..core.film_grain import AV1GrainData, FilmGrainData, H274GrainData
    from ..ops import deband as ops_deband
    from ..ops import deinterlace as ops_di
    from ..ops import dithering as ops_dither
    from ..ops import dovi as ops_dovi
    from ..ops import film_grain as ops_fg
    from ..ops import film_grain_h274 as ops_h274
    from ..ops import gamut as ops_gamut
    from ..ops import peak_detect as ops_peak
    from ..ops import polar as ops_polar
    from ..ops import sampling as ops_samp
    from ..utils import upload as up

    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(dev)

    img = rand(3, H, W)
    img1 = img[:1].contiguous()
    host = rng.random((3, H, W), np.float32)
    passes = []

    def add(name, setup):
        passes.append((name, setup))

    def simple(fn, *args):
        return lambda: (fn, args, 1, {})

    # --- host<->device transfers (bench.c:458-497) -----------------------
    def pinned(a):
        t = torch.from_numpy(a)
        return t.pin_memory() if dev.type == "cuda" else t
    add("tex_upload ptr", simple(lambda h: torch.from_numpy(h).to(dev), host))
    hosts8 = [pinned(host + np.float32(i)) for i in range(8)]
    add("tex_upload ptr async", lambda: (
        lambda *hs: [h.to(dev, non_blocking=True) for h in hs], hosts8, 8,
        {}))
    host_u8 = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    host_u16 = rng.integers(0, 1 << 16, (H, W, 3)).astype(np.uint16)
    add("tex_upload u8 device-norm", simple(
        lambda a: up.upload_plane(up.PlaneData(a, (0, 1, 2)),
                                  device=dev).data, host_u8))
    add("tex_upload p010 device-norm", simple(
        lambda a: up.upload_plane(up.PlaneData(a, (0, 1, 2), bit_depth=10,
                                               bit_shift=6),
                                  device=dev).data, host_u16))
    add("tex_download ptr", simple(lambda x: x.cpu(), img + 1.0))

    # --- samplers (bench.c:205-223,249-268): src -> same-size target,
    # quarter-texel offset so nothing collapses to a copy ----------------
    rect = RectF(0.25, 0.25, W + 0.25, H + 0.25)
    add("bilinear", simple(lambda x: ops_samp.sample_bilinear(x, H, W, rect),
                           img))
    for name in ("bicubic", "hermite", "gaussian"):
        cfg = flt.find_filter_config(name)
        add(name, simple(lambda x, c=cfg: ops_samp.resize_separable(
            x, H, W, c, rect), img))
    lcz = flt.find_filter_config("lanczos")
    up_rect = RectF(0.25, 0.25, W // 2 + 0.25, H // 2 + 0.25)
    add("lanczos_up (separable 2x)", simple(
        lambda x: ops_samp.resize_separable(x, H, W, lcz, up_rect), img))
    add("lanczos_up_antiring", simple(
        lambda x: ops_samp.resize_separable(x, H, W, lcz, up_rect,
                                            antiring=0.8), img))
    add("lanczos_down (separable 2x)", simple(
        lambda x: ops_samp.resize_separable(x, H // 2, W // 2, lcz, rect),
        img))
    add("oversample", simple(
        lambda x: ops_samp.sample_oversample(x, H, W, rect), img))
    ewa = flt.find_filter_config("ewa_lanczos")
    add("polar (ewa_lanczos)", simple(
        lambda x: ops_polar.sample_polar(x, ewa, H, W, rect), img))
    # the reference's second variant exercises its non-compute fallback;
    # the port's is the phased path anti-ringing forces
    add("polar antiring", simple(
        lambda x: ops_polar.sample_polar(x, ewa, H, W, rect, antiring=0.8),
        img))

    # --- deband (bench.c:190-203) ----------------------------------------
    add("deband", simple(lambda x: ops_deband.deband(x), img1))
    heavy = ops_deband.DebandParams(iterations=4, threshold=4.0, radius=4.0,
                                    grain=16.0)
    add("deband_heavy", simple(lambda x: ops_deband.deband(x, heavy), img1))

    # --- deinterlacers (bench.c:314-364) ---------------------------------
    prev, nxt = rand(3, H, W), rand(3, H, W)
    for algo in ("weave", "bob", "yadif", "bwdif"):
        p = ops_di.DeinterlaceParams(algo=ops_di.DeinterlaceAlgo(algo))
        add(algo, simple(lambda x, pv, nx, p=p: ops_di.deinterlace(
            x, ops_di.Field.TOP, p, prev=pv, next=nx), img, prev, nxt))

    # --- dithering (bench.c:225-247) -------------------------------------
    for name, method in (("dither_blue", DitherMethod.BLUE_NOISE),
                         ("dither_white", DitherMethod.WHITE_NOISE),
                         ("dither_ordered_fixed",
                          DitherMethod.ORDERED_FIXED)):
        dp = ops_dither.DitherParams(method=method)
        add(name, simple(lambda x, dp=dp: ops_dither.dither(x, 8, dp), img))
    for name, kname in (("error_diffusion (FS)", "floyd-steinberg"),
                        ("error_diffusion (JJN)", "jarvis-judice-ninke")):
        def ed_setup(kname=kname):
            kern = find_error_diffusion_kernel(kname)
            bounds = ed_bounds(*capture_ed(img, 8, kern))
            return (lambda x: ops_dither.error_diffusion(x, 8, kern), (img,),
                    1, bounds)
        add(name, ed_setup)

    # --- HDR peak detect + color map (bench.c:270-312) --------------------
    state = ops_peak.peak_detect_state_init(dev)
    add("hdr_peakdetect", simple(lambda x, s: ops_peak.detect_peak(
        x * 2.0, s, ops_peak.PeakDetectParams())[2], img, state))
    add("hdr_peakdetect_hq", simple(lambda x, s: ops_peak.detect_peak(
        x * 2.0, s, ops_peak.PeakDetectParams(percentile=99.995))[2],
        img, state))
    norm = 203.0 / 10000.0
    b_src = ops_gamut.ipt_space(primaries_get(ColorPrimaries.BT_2020),
                                0.0, 0.58)
    b_dst = ops_gamut.ipt_space(primaries_get(ColorPrimaries.BT_709),
                                0.0, 0.58)
    tp = tm.ToneMapParams(function=tm.find_tone_map_function("spline"),
                          input_scaling=HdrScaling.PQ,
                          output_scaling=HdrScaling.PQ, lut_size=256,
                          input_min=0.0, input_max=0.82,
                          output_min=0.0, output_max=0.58)
    add("hdr_lut (spline tone)", simple(
        lambda x: ops_gamut.color_map_ipt(
            x * 2.0, lambda v: tm.apply_device(v, tp), None, b_src, b_dst,
            to_norm=norm), img))
    add("hdr_clip", simple(lambda x: ops_gamut.color_map_ipt(
        x * 2.0, None, "clip", b_src, b_dst, to_norm=norm), img))
    add("k1 color_map_tail (flagship)", lambda: k1_setup(W, H, dev))

    # --- film grain (bench.c:366-416) -------------------------------------
    grain = AV1GrainData(
        num_points_y=6,
        points_y=((0, 4), (20, 5), (39, 5), (59, 5), (78, 5), (255, 40)),
        chroma_scaling_from_luma=False, num_points_uv=(2, 2),
        points_uv=(((0, 8), (255, 18)), ((0, 6), (255, 14))),
        scaling_shift=11, ar_coeff_lag=3,
        ar_coeffs_y=tuple(int(v) for v in
                          np.random.default_rng(5).integers(-30, 30, 24)),
        ar_coeffs_uv=(
            tuple(int(v) for v in
                  np.random.default_rng(6).integers(-20, 20, 25)),
            tuple(int(v) for v in
                  np.random.default_rng(7).integers(-20, 20, 25))),
        ar_coeff_shift=7, grain_scale_shift=0,
        uv_mult=(64, 64), uv_mult_luma=(32, 32), uv_offset=(0, 0),
        overlap=True)

    def grain_setup(data, channels, x):
        def setup():
            cfg = ops_fg.grain_cfg_for(data, channels)
            tables = ops_fg.prepare_av1_grain(data, cfg, H, W, dev)
            return (lambda v: ops_fg.apply_av1_grain(
                v, tables, cfg, grain.scaling_shift), (x,), 1, {})
        return setup
    from dataclasses import replace
    fgdata = FilmGrainData(type="av1", seed=7391, av1=grain)
    add("av1_grain (luma)", grain_setup(fgdata, (0,), img1))
    add("av1_grain (3 planes)", grain_setup(fgdata, (0, 1, 2), img))
    # the reference pairs av1_grain (no overlap) with av1_grain_lap
    # (overlap, bench.c:383-398); the base data overlaps, so the explicit
    # variant here is the one without
    add("av1_grain_nolap (3 planes)", grain_setup(
        FilmGrainData(type="av1", seed=7391,
                      av1=replace(grain, overlap=False)), (0, 1, 2), img))
    h274 = H274GrainData(
        model_id=0, blending_mode_id=0, log2_scale_factor=2,
        component_model_present=(True, False, False),
        num_intensity_intervals=(2, 0, 0), num_model_values=(3, 0, 0),
        intensity_interval_lower_bound=((0, 128), (), ()),
        intensity_interval_upper_bound=((127, 255), (), ()),
        comp_model_value=(((100, 8, 8), (60, 10, 6)), (), ()))
    hdata = FilmGrainData(type="h274", seed=1234, h274=h274)
    add("h274_grain", simple(
        lambda x: ops_h274.apply_h274_grain(x, hdata, (0,)), img1))
    # the reference benches h274 on 3 components (bench.c:401-414)
    add("h274_grain (3 planes)", simple(
        lambda x: ops_h274.apply_h274_grain(x, hdata, (0, 1, 2)), img))

    # --- Dolby Vision reshaping (bench.c:418-456) --------------------------
    from ..core.colorspace import DoviMetadata
    poly = dict(num_pivots=9, pivots=tuple(np.linspace(0.0, 1.0, 9)),
                method=(0,) * 8,
                poly_coeffs=tuple((0.05, 0.9, 0.05) for _ in range(8)),
                mmr_order=(1,) * 8, mmr_constant=(0.0,) * 8,
                mmr_coeffs=tuple((((0.0,) * 7,)) for _ in range(8)))
    ident = dict(num_pivots=2, pivots=(0.0, 1.0), method=(0,),
                 poly_coeffs=((0.0, 1.0, 0.0),), mmr_order=(1,),
                 mmr_constant=(0.0,), mmr_coeffs=(((0.0,) * 7,),))
    mmr = dict(num_pivots=2, pivots=(0.0, 1.0), method=(1,),
               poly_coeffs=((0, 0, 0),), mmr_order=(3,),
               mmr_constant=(0.1,),
               mmr_coeffs=((tuple(0.02 * i for i in range(7)),
                            tuple(0.01 * i for i in range(7)),
                            tuple(0.005 * i for i in range(7))),))
    for name, comp in (("reshape_poly", poly), ("reshape_mmr", mmr)):
        packed = ops_dovi.pack_dovi(DoviMetadata(comp=(comp, ident, ident)))
        add(name, simple(lambda x, pk=packed: ops_dovi.dovi_reshape_packed(
            x, pk), img))
    return passes


def k1_setup(W: int, H: int, dev: torch.device):
    """K1 on the flagship's tail at W x H: a seeded 8-bit PQ yuv420p
    frame rendered 1:1 to 8-bit sRGB captures K1's inputs (its linear
    light, plan, tone vector and dither LUT); the pass is K1's wrapper
    on them."""
    from ..core.colorspace import CSP_SRGB
    from ..ops.cuda import color_map as k1
    from ..render.renderer import RenderParams, Renderer, Target
    frame = flagship_frames(np.random.default_rng(1), 1, H, W, dev)[0]
    captured = []
    real = k1.color_map_tail

    def capture(img, plan, tone, lut):
        captured.append((img.clone(), plan,
                         tone.clone() if tone is not None else None, lut))
        return real(img, plan, tone, lut)
    k1.color_map_tail = capture
    try:
        Renderer(device=dev).render(
            frame, Target(w=W, h=H, color=CSP_SRGB, bit_depth=8),
            RenderParams(upscaler="ewa_lanczos"))
    finally:
        k1.color_map_tail = real
    if len(captured) != 1:
        raise RuntimeError(f"the flagship tail ran K1 {len(captured)} "
                           "times, not once")
    img, plan, tone, lut = captured[0]
    _, partials = real(img, plan, tone, lut)
    bound = k1_bound(img, plan, tone, lut, partials,
                     k1.ops_per_pixel(plan.consts, plan.instance))
    return (lambda *a: k1.color_map_tail(*a), (img, plan, tone, lut), 1,
            {"k1": bound})


def run(W: int, H: int, n: int, dev: torch.device, want=None) -> dict:
    """Time every pass (those whose name holds one of `want`'s
    substrings), then profile each PROFILE_ROUNDS times; returns the
    artifact's dict."""
    results, failed, timed = {}, {}, []
    for name, setup in define_passes(W, H, dev):
        if want and not any(w in name for w in want):
            continue
        try:
            fn, args, per, bounds = setup()
            ms = time_ms(fn, args, n, dev) / per
            out = fn(*args)
            synchronize(dev)
        except Exception as e:          # noqa: BLE001 - recorded, exit 1
            failed[name] = f"{type(e).__name__}: {e}"
            print(f"{name:28s}    FAILED ({failed[name]})", flush=True)
            continue
        nb = (nbytes(args) + nbytes(out)) / per
        floor = nb / HBM_BYTES_PER_S * 1e3
        results[name] = {"ms": ms, "bytes": int(nb), "byte_floor_ms": floor,
                         "kernel_bounds": {
                             k: {"ms": b, "by": by}
                             for k, (b, by) in bounds.items()}}
        timed.append((name, fn, args, per))
        print(f"{name:28s} {ms:9.3f} ms", flush=True)
    # the device operations a call, profiled after every pass is timed
    # (the profiler's tracing slows the host's launches after it)
    try:
        ops = device_ops([(name, fn, args) for name, fn, args, _ in timed],
                         dev)
    except Exception as e:              # noqa: BLE001 - recorded, exit 1
        failed["profiler"] = f"{type(e).__name__}: {e}"
        ops = {}
    for name, fn, args, per in timed:
        r = results[name]
        got = pass_reading(ops[name]) if name in ops else None
        n_ops, busy, span = got if got is not None else (None,) * 3
        r["launches"] = n_ops / per if n_ops is not None else None
        r["device_ms"] = busy / per if busy is not None else None
        r["device_span_ms"] = span / per if span is not None else None
        if name in ops:
            r["profile_rounds"] = [list(rd) for rd in ops[name]]
        kb = "".join(f", {k} bound {v['ms']:.4f} ms ({v['by']})"
                     for k, v in r["kernel_bounds"].items())
        dv = (f"{r['launches']:g} launches, device {r['device_ms']:.3f} ms "
              f"(span {r['device_span_ms']:.3f})" if n_ops is not None else
              "split wrong: " + ", ".join(
                  f"{b_:.3f} ms in a {s_:.3f} ms span"
                  for _, b_, s_ in ops[name]) if name in ops else
              "launches not measured (CPU)")
        print(f"{name:28s} {r['ms']:9.3f} ms, {dv}, byte floor "
              f"{r['byte_floor_ms']:.4f} ms "
              f"(x{r['ms'] / r['byte_floor_ms']:.1f}){kb}", flush=True)
    return {"size": [W, H], "n": n, "device": str(dev),
            "card": card_line(dev), "passes": results, "failed": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_micro")
    add_device_args(ap)
    ap.add_argument("--size", default="1920x1080", metavar="WxH")
    ap.add_argument("--n", type=int, default=30,
                    help="calls timed back to back per pass")
    ap.add_argument("--passes", default=None,
                    help="comma-separated substring filter")
    ap.add_argument("--ed", action="store_true",
                    help="accepted for the JAX tool's command lines; error "
                         "diffusion always runs")
    ap.add_argument("--json", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    dev = device_from(args)
    W, H = (int(v) for v in args.size.lower().split("x"))
    print(f"# {dev} {W}x{H} n={args.n}", flush=True)
    res = run(W, H, args.n, dev,
              args.passes.split(",") if args.passes else None)
    print(f"# {res['card']}: {len(res['passes'])} passes timed, "
          f"{len(res['failed'])} failed", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())

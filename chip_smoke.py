#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each runs uncaught: any failure exits non-zero):
 1. build the hand-written kernels from csrc/ (one nvcc a library — K1
    is one library a tone curve — all at once) and the native host code
    (blue noise, film grain), keeping ptxas's register and spill report,
    and read K1's pixel loop out of its SASS (libplacebo_tpu_torch/
    _sass.py: instructions an iteration by class, calls, ptxas's stack
    frame), for the flagship instance and the two of phase 7;
 2. the flagship path: render 3 chained frames — 1080p 8-bit limited
    BT.2020-NC yuv420p PQ -> 3840x2160 8-bit sRGB, EWA Lanczos, peak
    state carried — through libplacebo_tpu_torch.Renderer on "cuda",
    every kernel's launch count set to 0 just before and read just after
    (K1 3 times, K2 and K3 never);
 3. hold K1 against its plain PyTorch version on frame 2's linear-light
    input at 4K, and the GPU render against the CPU render (plain
    versions) on a small input;
 4. the config-5 path: the same frames with AV1 film grain (seed 7391 + i)
    under deband (2 iterations), film grain and Floyd-Steinberg error
    diffusion to 8 bits, counts read as before (K1 without dither 3, K2
    3, K3 6 times); the output must be 8-bit codes;
 5. hold K1 without dither, K2 and K3 (both ways) against their plain
    versions on frame 2's inputs at 4K (K2 also for Jarvis-Judice-Ninke,
    s = 3, on the same frame sheared for it), and the config-5 GPU render
    against the CPU render on a small input;
 6. time the renders (config 5 with a new grain seed every frame),
    every kernel, its plain version, K3's one-call PyTorch counterpart
    (torch.gather), deband, grain, and the host's making of one frame's
    grain tables; K2's timed runs must all return the codes of its first
    (a race between its bands would show as a difference), and K2 is
    timed on one 32-row band and on one channel of the same columns,
    which splits its time into the column step and the pipeline's fill;
    K1's instruction floor from its SASS count and the SM clock read
    while it runs;
 7. config 4 (the flagship's content at 10 bits with 0.005-1000-nit
    mastering metadata, bt2390 tone curve, softclip gamut map: K1's
    <bt2390, softclip> instance with dither) and config 2's color path
    (8-bit BT.709 BT.1886 with RenderParams(): sigmoidized separable
    Lanczos, K1's pass-through instance), 3 chained frames each, counts
    read as before (K1 3 times each); hold each instance against its
    plain version on frame 2's input at 4K, and each GPU render against
    the CPU render on a small input; time both renders and instances;
 8. config 3, the scaling slice (config 2's frames, RenderParams(
    upscaler="ewa_lanczos4sharpest", antiringing_strength=0.8): the EWA
    on its phased path with anti-ringing inside sigmoidized light, K1's
    pass-through instance), 3 chained frames, counts read as before (K1
    3 times); hold the instance against its plain version on frame 2's
    input at 4K and the GPU render against the CPU render on a small
    input; time the render and the anti-ringing EWA alone on frame 2's
    1080p input (`ewa_ar_ms`, its launches a call and its bound);
 9. K2 on a pattern outside the compiled ten (taps given at launch)
    against its plain version on config 5's sheared frame at 4K: exact,
    and timed beside the compiled Floyd-Steinberg instance;
10. path A, "HLG broadcast on an HDR10 display" (`path_cell`): config
    4's 10-bit content as limited BT.2020-NC HLG -> 3840x2160 10-bit
    full-range BT.2020 PQ at 600 nits, RenderParams(upscaler=
    "ewa_lanczos", tone_mapping_function="bt2446a"): HLG's OOTF, the
    EWA, and K1's generic instance (the reference adapts the HLG source
    to the display's peak, so the tail is the pass-through chain into a
    PQ target with 10-bit dither), 3 chained frames, counts read as
    before (K1 3 times); the instance against its plain version on
    frame 2's input at 4K (bit for bit) and the GPU render against the
    CPU render on a small input; timed;
11. path B, "SDR on a calibrated wide-gamut monitor": config 2's frames
    -> 3840x2160 8-bit through a Display P3 gamma 2.2 ICC profile built
    in code, with a 33^3 native LUT (its low-rank path at 1080p); the
    tail is plain, as in the reference (an ICC target), so K1 never
    launches; the same checks and timings, and the LUT and the ICC
    encode alone;
12. K1's generic instance on twelve more tails at 4K (`GENERIC_CASES`:
    static curves, same-frame stats, the other gamut operators, HLG and
    BT.1886 targets, YCbCr and ICtCp encodes, white noise,
    show_clipping, 3-bit gamma dither), each bit for bit against its
    plain version and timed (in `k1_instances`), and the host's draw
    of a 4K white-noise bias (`white_noise_host_ms`);
13. path C, "Dolby Vision profile 5 on an SDR display": 1920x1080
    10-bit full-range yuv420p Dolby Vision frames, BT.2020 PQ, each
    with a new RPU parsed that frame (tests/golden/dovi/profile5.bin
    with profile81.bin's L1 block, its chroma MMR rewritten frame by
    frame with the port's write_rpu; `color.hdr` from the L1 block) ->
    3840x2160 8-bit sRGB, RenderParams(upscaler="ewa_lanczos"): the
    chroma merge, the RPU reshape and decode, PQ, the EWA and K1's
    <spline, perceptual> instance with dither, 3 chained frames through
    one plan, counts read as before (K1 3 times);
14. path D, "1080i broadcast deinterlaced to 4K": 1920x1080 8-bit
    limited BT.709 BT.1886 yuv420p with woven fields, top field first,
    carrying an H.274 SEI (luma and chroma models, a new seed each
    frame); source frames 1 and 2 each rendered as their top then
    bottom field with their neighbors, RenderParams(deinterlace=
    DeinterlaceParams(BWDIF)): bwdif and H.274 grain on every plane,
    then config 2's path (K1's pass-through instance with dither),
    counts read as before (K1 4 times);
15. the distortion phase: config 2's frames -> 3840x2160 with
    distort=DistortParams.rotation(0.2), bicubic: the tail plain, as in
    the reference, so K1 never launches and the tails count as
    ineligible;
    then paths C's and D's K1 launches against their plain versions at
    4K, their GPU renders (and the distortion phase's) against the CPU
    renders on a small input, and timings: the frames, and the
    plain stages alone (`dovi_decode_1080p_ms`, `h274_1080p_ms` with
    `h274_host_ms`, `deinterlace_1080p_ms`, `distort_4k_ms`);
16. path E, "a 23.976 fps HDR film with subtitles and an OSD on a 60 Hz
    SDR display, with frame interpolation": 1920x1080 10-bit limited
    BT.2020-NC PQ yuv420p (config 4's content) carrying monochrome
    subtitles (two seeded coverage masks, src_frame coordinates, a new
    bitmap every third frame) and a premultiplied RGBA OSD (dst_frame
    coordinates), a source frame every 2.5025 vsyncs, each vsync's
    FrameMix through render_image_mix (oversample) -> 3840x2160 8-bit
    sRGB, RenderParams(upscaler="ewa_lanczos", color_adjustment=
    ColorAdjustment(brightness=0.02, contrast=1.05, saturation=1.1)):
    10 vsyncs counted (K1's <spline, perceptual> instance without dither
    once a new source frame, 5 times; the rest mix-cache hits; the final
    dither plain), K1 bit for bit against its plain version, timed a
    vsync;
17. path F, "a 2.39:1 HDR10 film letterboxed on a 4K SDR display":
    1920x800 10-bit limited BT.2020-NC PQ at 1000 nits -> 3840x2160
    8-bit sRGB with the crop (0, 280, 3840, 1880) and the default black
    border, HIGH_QUALITY_PARAMS (ewa_lanczossharp, deband, percentile
    99.995, contrast recovery 0.30): the tail plain, as in the reference
    (a crop and contrast recovery), counted ineligible; the bars black;
    then paths E's and F's GPU renders and six presentation cases
    (`presentation_cases`: a quarter turn pillarboxed with a blurred
    border, tiles, corner rounding, an RGBA frame blended onto the
    target's contents, cone distortion, the tone-curve visualizer)
    against the CPU renders on a small input, and timings.
18. path G, "a player's loop": a 23.976 fps HDR10 film (config 4's
    content, 10-bit limited BT.2020-NC PQ, 24 seeded source frames) on a
    60 Hz SDR 4K display, driven as mpv drives libplacebo: the params
    from an option string (Options().parse, `PATH_G_OPTIONS`: EWA
    Lanczos, the mitchell_clamp frame mixer, spline + perceptual), a
    decoder thread push_blocking lazy SourceFrames into a FrameQueue
    (`PathGDecoder`: planes "decoded" into pinned host memory, uploaded
    by `map`), 60 vsyncs each a queue update (INTERPOLATE) and
    render_image_mix, telemetry installed; counted as one run (K1's
    <spline, perceptual> instance without dither once a source frame,
    every other mix entry a mix-cache hit; each frame mapped once and
    unmapped, the rest discarded), vsyncs 1-29 timed synchronized and
    30-59 back to back; K1 bit for bit against its plain version;
19. path H, "config 5 with user hooks": config 5's frames and params (8
    frames, a new grain seed each) with a LUMA_INPUT 2x luma doubler (a
    seeded 3x3 convolution to 4 channels and a pixel shuffle, declaring
    its offset) and a PRE_OUTPUT auto-exposure carrying a running mean
    across frames (`path_h_hooks`): the hooked tail plain, as in the
    reference (counted ineligible), K2 once and K3 twice a frame, each
    exact against its plain version on the frame's own input;
    then paths G's and H's GPU renders against the CPU renders on a
    small input, and timings (path G: the vsyncs, the telemetry beside a
    new frame's render timed by CUDA events, a source frame's map alone;
    path H: the frames);
20. path I, "a 4K HDR10 clip transcoded to 1080p SDR" (ffmpeg's
    vf_libplacebo with tonemapping and w=1920:h=1080, for an SDR
    client): 8 seeded 3840x2160 10-bit limited BT.2020-NC PQ 4:2:0 frames
    written with the port's Y4MWriter (C420p10, XCOLORRANGE=LIMITED) to
    a temporary directory, each read back as raw planes, mapped as a
    decoder's AVFrame with HDR10 side data (interop.
    frame_from_avframe_like, pinned staging), rendered with
    RenderParams() on Renderer(ctx=runtime.create()) to 1920x1080 8-bit
    BT.709 BT.1886 (hermite downscale in linear light, spline +
    perceptual, peak detection, blue noise: K1's <spline, perceptual>
    instance with dither), encoded to limited BT.709 YCbCr on the card,
    downloaded through a pinned buffer and written as a 420jpeg y4m
    (`PathITranscoder`), counted on its own (K1 8 times, no plain tail,
    acquire and release 8 times each); the file read back (header, 8
    frames, frame 0's codes), the context's cache (the transcoder's
    gamut LUT) through save() and a fresh renderer's load(), the context
    alive; timed (synchronized and back to back, the context's timer
    beside CUDA events, each host stage); a small clip's GPU transcode
    against the CPU one (the flagship's gate); K1's launch against its
    plain version;
21. path J, "an mpv user's shaders" (glsl-shaders=): 8 seeded 1920x1080
    8-bit limited BT.709 BT.1886 yuv420p frames (config 2's content) ->
    3840x2160 8-bit sRGB, the params from Options().parse(
    PATH_J_OPTIONS) (EWA Lanczos, Sierra Lite error diffusion) with two
    mpv .hook shaders through Options.add_hook: a RAVU-lite-class LUMA
    doubler (a data-dependent row of a seeded float16 (96, 3, 4) LUT,
    then a 2x subpixel interleave: luma 1920x1080 -> 3840x2160) and a
    temporal-EMA //!COMPUTE 8 8 hook at MAIN (a STORAGE image at MAIN's
    3840x2160 and a STORAGE buffer counter carried across the frames),
    run by the port's GLSL interpreter (render/mpv_hooks.py, plain torch
    ops); counted on its own (`path_j_phase`): the hooked tail plain, as
    in the reference (K1 0, counted ineligible), K2 8 and K3 16, no hook
    disabled, the counter 8; a warm frame's hooks under
    torch.cuda.set_sync_debug_mode("error"), uploading nothing; K2 and
    K3 exact against their plain versions on frame 2's own input; the
    GPU render of a small input against the CPU render (the flagship's
    gate); timed (synchronized and back to back, the hooks' host issue,
    device ms by pass, launches a hook call);
22. the GPU-vs-JAX gate (tools/gpu_vs_cpu.py): eight presets rendered
    by the port on the card against the JAX package's CPU renders
    committed in libplacebo_tpu_torch/data/gpu_vs_cpu.npz (the hook
    preset: the temporal-EMA hook over 4 frames), PSNR >= 45 dB and the
    LSB guards;
23. path K (`path_k_phase`), the multi-device layer (parallel/) on the
    one mesh one card gives: GpuContext().make_mesh() starts a one-rank
    NCCL group; build_sharded_pipeline renders 8 flagship frames (two a
    call, the peak state threaded per lane) on the halo step (K1 in each
    shard's tail, 8 launches) and 4 config-5 frames on the replicated
    step (K1 without dither 4, K2 4, K3 8), counted on their own; each
    output within one LSB of the single-card Renderer on <= 1e-3 of the
    values, none beyond; the halo state within 1e-6 of the single-card
    whole-frame detection, the replicated state bit for bit; K1, K2 and
    K3 on the path's own inputs against their plain versions; both
    steps' collective_stats and routes, timed beside the single-card
    renders of the same frames; the group destroyed after;
24. path L (`path_l_phase`), the port's demos and tools through their
    main()s at full width, each counted on its own: plplay --hdr
    1920x1080 -> 3840x2160 for 60 vsyncs (K1 once a source frame; fps,
    host and CUDA-event ms a vsync) and small on the card against the
    CPU (mean < 1e-4, > 1 LSB on <= 5e-4), video_filtering (1080p PNG ->
    4K), image_viewer (4K PNG with an OSD and a LUT -> 1080p; again with
    the Display P3 ICC profile), colors (4K, 60 frames into a y4m),
    multichip_bench (one-rank NCCL mesh, 1080p -> 4K), bench_micro over
    every pass at 1080p (the artifact to chiprun_out/
    bench_micro_h100.json; any failed pass fails the run),
    bench_playback and profile_stages 8; K1 on plplay's first new frame,
    K2 and K3 on bench_micro's first Floyd-Steinberg call against their
    plain versions;
25. the degradation ladder, last: deband made to raise RuntimeError
    recovers (get_errors() shows it, the log records it); K1's launcher
    made to raise KernelError, and the exception torch raises for a
    CUDA error, each propagate out of Renderer.render with get_errors()
    empty, and so does an out-of-memory error raised inside K1's wrapper
    (as a KernelError); everything restored, and no renderer of any path
    has a feature or a hook disabled.
On every path but B, F, H, J and the distortion phase the renderer must
count K1 tails only (no plain tails); their tails count as ineligible
(plain in the reference).

Prints the card's name and power limit (nvidia-smi), a `kernels` JSON
line, a `timings` JSON line, and last `{"ok": true, "device": ...}`.
Without a GPU, or without the package beside it, it exits non-zero and
prints no result.  A copy of the numbers goes to
chiprun_out/chip_smoke.json.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

LSB = 1.0 / 255.0
GRAIN_SEED = 7391


def _flagship_yuv(n, h, w, seed=0, bits=8):
    """The flagship's seeded content, limited range, at 8 or 10 bits."""
    rng = np.random.default_rng(seed)
    lo, span_y, span_c = (16, 219, 224) if bits == 8 else (64, 876, 896)
    dt = np.uint8 if bits == 8 else np.uint16
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * span_y + lo).astype(dt)
        u = (rng.random((h // 2, w // 2)) * span_c + lo).astype(dt)
        v = (rng.random((h // 2, w // 2)) * span_c + lo).astype(dt)
        out.append((y, u, v))
    return out


def _frame(lt, yuv, device, grain=None, config="flagship"):
    """A frame of the flagship (and config 5), config 4 (10 bits,
    1000-nit mastering metadata) or config 2 (BT.709 BT.1886)."""
    color, system, bits = lt.CSP_BT2100_PQ, lt.ColorSystem.BT_2020_NC, 8
    if config == "config4":
        color = lt.ColorSpace(lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
                              lt.HdrMetadata(min_luma=0.005,
                                             max_luma=1000.0))
        bits = 10
    elif config == "config2":
        color = lt.ColorSpace(lt.ColorPrimaries.BT_709,
                              lt.ColorTransfer.BT_1886)
        system = lt.ColorSystem.BT_709
    f = lt.frame_from_yuv420p(
        *yuv, color=color, device=device, bit_depth=bits,
        repr=lt.ColorRepr(sys=system, levels=lt.ColorLevels.LIMITED,
                          bits=lt.BitEncoding(bits, bits, 0)))
    f.film_grain = grain
    return f


def _frame_cell(lt, yuv, device, color, repr, bits):
    return lt.frame_from_yuv420p(*yuv, color=color, device=device,
                                 bit_depth=bits, repr=repr)


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _render_run(renderer, frames, target, params, counters):
    """Render `frames` in a chain with every launch count, and the
    renderer's tail counts, set to 0 just before; returns the outputs,
    the launch counts just after and the (K1, plain, ineligible) tail
    counts (ineligible: plain in the reference too, e.g. an ICC
    target)."""
    import torch
    from libplacebo_tpu_torch.render import renderer as trender
    for mod in counters.values():
        mod.launches = 0
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    outs = [renderer.render(f, target, params) for f in frames]
    torch.cuda.synchronize()
    return outs, {name: mod.launches for name, mod in counters.items()}, \
        (trender.k1_tails, trender.plain_tails, trender.ineligible_tails)


def _mix_run(renderer, frames, target, params, counters, vsyncs, lt):
    """Path E's `_render_run`: render_image_mix of each vsync's FrameMix;
    also returns the mix-cache hits (frames a mix reused, not
    rendered)."""
    import torch
    from libplacebo_tpu_torch.render import renderer as trender
    for mod in counters.values():
        mod.launches = 0
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    outs, refs = [], 0
    for v in vsyncs:
        mix = path_e_mix(lt, frames, v)
        refs += len(mix.frames)
        outs.append(lt.render_image_mix(renderer, mix, target, params))
    torch.cuda.synchronize()
    tails = (trender.k1_tails, trender.plain_tails, trender.ineligible_tails)
    return outs, {name: mod.launches for name, mod in counters.items()}, \
        tails, refs - sum(tails)


def _check_k1(k1, args):
    """K1 vs its plain version on the same inputs (comparison launches
    are not counted by the caller)."""
    import torch
    img, plan, tone, lut = args
    out_k, part_k = k1.color_map_tail(img, plan, tone, lut)
    out_p, part_p = k1.color_map_plain(img, plan.consts, tone, lut,
                                       plan.instance)
    torch.cuda.synchronize()
    diff = (out_k - out_p).abs()
    max_abs_err = float(diff.max())
    frac = float((diff > 1e-6).float().mean())
    assert max_abs_err <= LSB + 1e-6, max_abs_err
    assert frac < 1e-3, frac
    if plan.tone:
        assert torch.equal(part_k[:, 0, :64], part_p[:, 0, :64])
        torch.testing.assert_close(part_k[:, 1, :3], part_p[:, 1, :3],
                                   rtol=1e-5, atol=0.0)
    else:
        assert part_k is None and part_p is None
    return max_abs_err, frac, part_k


def _k1_entry(k1, name, args, part, launches, max_abs_err, ms, plain_ms):
    from libplacebo_tpu_torch.tools.bench_micro import k1_bound
    plan = args[1]
    bound, by = k1_bound(*args, part,
                         k1.ops_per_pixel(plan.consts, plan.instance))
    return {"name": name, "route": "cuda",
            "source": "libplacebo_tpu_torch/csrc/color_map.cu",
            "replaces": "libplacebo_tpu/ops/pallas/color_map.py:150",
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _k2_k3_entries(k2, k3, k2_args, k3_calls, path, launches, k2_reps):
    """K2 on its captured arguments and K3 on each captured (x, w_out, s,
    w, h, forward) call, exact against their plain versions (comparison
    launches are not counted by the caller), each timed beside its plain
    version (K3 also beside torch.gather's relayout), with its bound from
    bench_micro's helpers.  Returns the kernels line's K2 and K3 entries
    for `path`, with `launches` ({"k2": n, "k3": n}) from its run."""
    import torch
    from libplacebo_tpu_torch.tools.bench_micro import (bound_ms, k2_bound,
                                                        k3_bytes)
    got, want = k2.wavefront(*k2_args), k2.wavefront_plain(*k2_args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"K2 on {path}"
    k2_err = float((got.float() - want.float()).abs().max())
    del got, want
    k3_err = k3_ms = k3_plain_ms = k3_lib_ms = 0.0
    for x, w_out, s, w, h, fwd in k3_calls:
        wrapper = k3.shear_to_colmaj if fwd else k3.unshear_from_colmaj
        got = wrapper(x, w_out, s, w, h)
        want = k3.shear_plain(x, w_out, s, w, h, fwd)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (f"K3 on {path}", fwd)
        k3_err = max(k3_err, float((got.float() - want.float()).abs().max()))
        del got, want
        k3_ms += _cuda_ms(lambda: wrapper(x, w_out, s, w, h), 20)
        k3_plain_ms += _cuda_ms(
            lambda: k3.shear_plain(x, w_out, s, w, h, fwd), 2)
        k3_lib_ms += _cuda_ms(_gather_shear(x, w_out, s, w, h, fwd), 20)
    k2_b, k2_by = k2_bound(*k2_args)
    k3_b, k3_by = bound_ms(sum(k3_bytes(x, w_out, w, h, fwd)
                               for x, w_out, _, w, h, fwd in k3_calls))
    return [
        {"name": f"k2_error_diffusion_{path}", "route": "cuda",
         "source": "libplacebo_tpu_torch/csrc/error_diffusion.cu",
         "replaces": "libplacebo_tpu/ops/pallas/error_diffusion.py:226",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": _cuda_ms(lambda: k2.wavefront(*k2_args), k2_reps),
         "plain_ms": _cuda_ms(lambda: k2.wavefront_plain(*k2_args), 1),
         "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None},
        {"name": f"k3_shear_{path}", "route": "cuda",
         "source": "libplacebo_tpu_torch/csrc/shear.cu",
         "replaces": "libplacebo_tpu/ops/pallas/shear.py:149",
         "launches": launches["k3"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_b,
         "bound_by": k3_by, "library_ms": k3_lib_ms}]


def _k1_instance_table(lt, k1, trender, ops_dither, sass_of, npix, lanes,
                       mhz, W, H, dev):
    """Every K1 instance, with and without dither, at W x H: its
    operations a pixel (`ops_per_pixel` of the plan its chain gets), its
    byte and operation bounds, its pixel loop's SASS instructions and
    the instruction floor at the SM clock `mhz`, and the kernel against
    its plain version (checked and timed) on seeded linear light (to 30
    for an HDR source, 1.2 for SDR; fixed stats avg 0.3, max 0.72 PQ).
    The chains: SDR BT.709 (pass-through), SDR BT.2020 (no tone curve)
    and the flagship's PQ source (each dynamic curve), to sRGB, gamut
    clip / perceptual / softclip."""
    import torch
    from libplacebo_tpu_torch.core import colorspace as tcs
    from libplacebo_tpu_torch.ops import tone_dynamic as ops_tone
    from libplacebo_tpu_torch.tools.bench_micro import (FP32_OPS_PER_S,
                                                        HBM_BYTES_PER_S)
    sdr = {p: tcs.ColorSpace(p, tcs.ColorTransfer.BT_1886)
           for p in (tcs.ColorPrimaries.BT_709, tcs.ColorPrimaries.BT_2020)}
    chains = {(0, 0): (sdr[tcs.ColorPrimaries.BT_709], {}),
              (0, 2): (sdr[tcs.ColorPrimaries.BT_2020],
                       dict(gamut_mapping="perceptual")),
              (0, 3): (sdr[tcs.ColorPrimaries.BT_2020],
                       dict(gamut_mapping="softclip"))}
    for t, name in enumerate(k1.TONES[1:], 1):
        for g, op in ((1, "clip"), (2, "perceptual"), (3, "softclip")):
            chains[(t, g)] = (tcs.CSP_BT2100_PQ,
                              dict(tone_mapping_function=name,
                                   gamut_mapping=op))
    target = lt.Target(w=W, h=H, color=lt.CSP_SRGB, bit_depth=8)
    gen = torch.Generator(device=dev).manual_seed(23)
    noise = torch.rand((3, H, W), device=dev, generator=gen)
    stats = (torch.tensor(0.72, device=dev), torch.tensor(0.3, device=dev))
    table = {}
    for (tone, gamut), (src, kw) in sorted(chains.items()):
        for dither in (True, False):
            params = lt.RenderParams(**kw) if dither else \
                lt.RenderParams(**kw, dither=None)
            s, d = tcs.color_space_infer_map(src, tcs.CSP_SRGB)
            lut = ops_dither.dither_lut(trender._dither_params(params, d),
                                        0) if dither else None
            chain = trender.color_chain(s, d, params, s.is_hdr())
            plan = k1.plan_tail(chain, params, d, target, s.is_hdr(), lut)
            assert (plan.tone, plan.gamut) == (tone, gamut), (tone, gamut)
            args = (noise * (30.0 if s.is_hdr() else 1.2), plan,
                    ops_tone.tone_vector(
                        params.tone_mapping_function, *stats,
                        chain.dst_min_pq, chain.dst_max_pq,
                        params.tone_constants) if plan.tone else None,
                    torch.from_numpy(lut).to(dev) if lut is not None
                    else None)
            err, frac, _ = _check_k1(k1, args)
            ops = k1.ops_per_pixel(plan.consts, plan.instance)
            nbytes = (2 * 3 * npix + plan.consts.size) * 4
            if tone:
                nbytes += (H // k1.pick_block_rows(H) * 8 * 128 + 16) * 4
            if lut is not None:
                nbytes += lut.size * 4
            sass = sass_of(tone, k1.instance_name(tone, gamut, dither))
            table[f"{tone},{gamut},{'dither' if dither else 'none'}"] = {
                "ops_per_pixel": ops,
                "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "ops_bound_ms": ops * npix / FP32_OPS_PER_S * 1e3,
                "sass_per_pixel": sass,
                "instruction_floor_ms": sass * npix / (lanes * mhz * 1e6)
                * 1e3,
                "max_abs_err": err, "differing_fraction": frac,
                "ms": _cuda_ms(lambda: k1.color_map_tail(*args), 10),
                "plain_ms": _cuda_ms(lambda: k1.color_map_plain(
                    args[0], plan.consts, *args[2:], plan.instance), 2)}
    return table


def display_p3_profile():
    """A matrix/TRC display profile built in code: Display P3 primaries
    (colorants adapted to the D50 PCS) and a gamma 2.2 TRC, in the byte
    layout of tests/test_icc_h274.py::_make_profile."""
    import struct
    from libplacebo_tpu_torch.core import colorspace as tcs
    p3 = tcs.primaries_get(tcs.ColorPrimaries.DISPLAY_P3)
    m = tcs.adapt_white_matrix(p3.white, tcs.CIE_D50).m @ \
        tcs.rgb_to_xyz_matrix(p3).m

    def xyz_tag(v):
        return b"XYZ " + b"\0" * 4 + struct.pack(
            ">3i", *(int(round(x * 65536)) for x in v))

    def curv(g):
        return b"curv" + b"\0" * 4 + struct.pack(">I", 1) + \
            struct.pack(">H", int(round(g * 256)))

    tags = {b"rXYZ": xyz_tag(m[:, 0]), b"gXYZ": xyz_tag(m[:, 1]),
            b"bXYZ": xyz_tag(m[:, 2]), b"rTRC": curv(2.2),
            b"gTRC": curv(2.2), b"bTRC": curv(2.2),
            b"wtpt": xyz_tag((0.9642, 1.0, 0.8249))}
    header = bytearray(128)
    header[8] = 4
    header[16:20] = b"RGB "
    header[20:24] = b"XYZ "
    body = struct.pack(">I", len(tags))
    offset = 132 + 12 * len(tags)
    table = blob = b""
    for sig, d in tags.items():
        table += struct.pack(">4sII", sig, offset, len(d))
        blob += d
        offset += len(d)
    out = bytes(header) + body + table + blob
    return struct.pack(">I", len(out)) + out[4:]


def creative_cube(n=33):
    """A smooth creative 3D LUT as .cube text (contrast, a warm tint and
    a cross term), n^3 entries."""
    g = np.linspace(0.0, 1.0, n)
    b, gg, r = np.meshgrid(g, g, g, indexing="ij")
    rgb = np.stack([r, gg, b], axis=-1)
    out = np.clip(0.92 * rgb + 0.06 * rgb[..., ::-1] ** 2 + 0.02, 0.0, 1.0)
    return "\n".join([f"LUT_3D_SIZE {n}"] +
                     [" ".join(f"{v:.6f}" for v in row)
                      for row in out.reshape(-1, 3)])


def path_cell(lt, path, W, H):
    """(frame colorspace, repr, bits, target, params) of path A (HLG
    broadcast on a 600-nit PQ display: 10-bit limited BT.2020-NC HLG ->
    10-bit full-range BT.2020 PQ, EWA Lanczos, static bt2446a) or path B
    (SDR on a calibrated wide-gamut monitor: config 2's 8-bit BT.709
    frame -> 8 bits through a Display P3 gamma 2.2 ICC profile, with a
    33^3 native LUT) at a W x H target."""
    if path == "A":
        color = lt.ColorSpace(lt.ColorPrimaries.BT_2020,
                              lt.ColorTransfer.HLG)
        target = lt.Target(w=W, h=H, bit_depth=10, color=lt.ColorSpace(
            lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
            lt.HdrMetadata(max_luma=600.0)))
        return (color, lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                                    levels=lt.ColorLevels.LIMITED,
                                    bits=lt.BitEncoding(10, 10, 0)), 10,
                target, lt.RenderParams(upscaler="ewa_lanczos",
                                        tone_mapping_function="bt2446a"))
    color = lt.ColorSpace(lt.ColorPrimaries.BT_709, lt.ColorTransfer.BT_1886)
    target = lt.Target(w=W, h=H, bit_depth=8, icc=lt.parse_icc(
        display_p3_profile()), color=lt.ColorSpace(
            lt.ColorPrimaries.DISPLAY_P3, lt.ColorTransfer.GAMMA22))
    return (color, lt.ColorRepr(sys=lt.ColorSystem.BT_709,
                                levels=lt.ColorLevels.LIMITED,
                                bits=lt.BitEncoding(8, 8, 0)), 8, target,
            lt.RenderParams(lut=lt.parse_cube(creative_cube()),
                            lut_type="native"))


DOVI_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "golden", "dovi")


def path_c_rpus(lt, n):
    """n Dolby Vision RPUs, a new one every frame, written with the
    port's write_rpu: profile 5's fixture (IPT-PQ-c2, luma polynomial,
    chroma MMR) with profile 8.1's fixture's L1 block, its chroma MMR
    constant and coefficients scaled frame by frame; the L1 block, and so
    the render plan, stays the same."""
    import dataclasses

    def fixture(name):
        with open(os.path.join(DOVI_FIXTURES, name + ".bin"), "rb") as f:
            return f.read()
    rpu = lt.parse_rpu(fixture("profile5"))
    l1 = lt.parse_rpu(fixture("profile81")).ext_blocks[0]
    rpu = dataclasses.replace(rpu, ext_blocks=(l1,))
    out = []
    for k in range(n):
        c1 = rpu.curves[1]
        c1 = dataclasses.replace(
            c1, mmr_constant=tuple(v + 200000 * (k % 7)
                                   for v in c1.mmr_constant),
            mmr_coef=tuple(tuple(tuple(int(x * (1 + 0.1 * (k % 7)))
                                       for x in row) for row in piece)
                           for piece in c1.mmr_coef))
        out.append(lt.write_rpu(dataclasses.replace(
            rpu, curves=(rpu.curves[0], c1, rpu.curves[2]))))
    return out


def path_c_frame(lt, yuv, buf, device):
    """Path C's frame: 10-bit full-range yuv420p Dolby Vision, BT.2020
    PQ, its RPU parsed from `buf` and its HDR metadata from the RPU's L1
    block."""
    color = lt.ColorSpace(lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
                          lt.hdr_metadata_from_rpu(lt.HdrMetadata(), buf))
    rep = lt.ColorRepr(sys=lt.ColorSystem.DOLBYVISION,
                       levels=lt.ColorLevels.FULL,
                       bits=lt.BitEncoding(10, 10, 0),
                       dovi=lt.rpu_to_dovi(lt.parse_rpu(buf)))
    return lt.frame_from_yuv420p(*yuv, color=color, repr=rep, bit_depth=10,
                                 device=device)


def path_c_yuv(n, h, w, seed=11):
    """Path C's seeded 10-bit full-range content."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 1024, s).astype(np.uint16)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


# path D's film-grain SEI (H.274): luma and chroma models, two luma
# intensity intervals
H274_SEI = dict(
    model_id=0, blending_mode_id=0, log2_scale_factor=2,
    component_model_present=(True, True, True),
    num_intensity_intervals=(2, 1, 1), num_model_values=(3, 2, 2),
    intensity_interval_lower_bound=((0, 128), (0,), (0,)),
    intensity_interval_upper_bound=((127, 255), (255,), (255,)),
    comp_model_value=(((100, 8, 8), (60, 10, 6)), ((60, 6),), ((60, 6),)))
PATH_D_SEED = 2024


def path_d_sources(lt, yuvs, device):
    """Path D's source frames: 8-bit limited BT.709 BT.1886 yuv420p,
    woven fields."""
    color = lt.ColorSpace(lt.ColorPrimaries.BT_709, lt.ColorTransfer.BT_1886)
    rep = lt.ColorRepr(sys=lt.ColorSystem.BT_709,
                       levels=lt.ColorLevels.LIMITED,
                       bits=lt.BitEncoding(8, 8, 0))
    return [lt.frame_from_yuv420p(*f, color=color, repr=rep, device=device)
            for f in yuvs]


def path_d_field(lt, sources, k, field):
    """Source frame k shown as `field` ("TOP" or "BOTTOM"; top field
    first) with its neighbors, carrying the SEI with frame k's seed."""
    import copy
    f = copy.copy(sources[k])
    f.field, f.first_field = lt.Field[field], lt.Field.TOP
    f.prev = sources[k - 1] if k > 0 else None
    f.next = sources[k + 1] if k + 1 < len(sources) else None
    f.film_grain = lt.FilmGrainData(type="h274", seed=PATH_D_SEED + k,
                                    h274=lt.H274GrainData(**H274_SEI))
    return f


def path_d_params(lt):
    return lt.RenderParams(deinterlace=lt.DeinterlaceParams(
        lt.DeinterlaceAlgo.BWDIF))


def distort_params(lt):
    """The distortion phase's: a 0.2 rad rotation, bicubic."""
    return lt.RenderParams(distort=lt.DistortParams(
        transform=lt.DistortParams.rotation(0.2).transform, bicubic=True))


# path E: a 23.976 fps film on a 60 Hz display, a source frame every
# 2.5025 vsyncs
PATH_E_SPACING = 2.5025


def path_e_params(lt):
    return lt.RenderParams(upscaler="ewa_lanczos", frame_mixer="oversample",
                           color_adjustment=lt.ColorAdjustment(
                               brightness=0.02, contrast=1.05,
                               saturation=1.1))


def path_e_overlays(lt, src_w, src_h, dst_w, seed, device):
    """Path E's overlays for a src_w x src_h frame shown dst_w wide, at
    their 1080p / 4K sizes scaled to these: the subtitles, monochrome,
    two seeded coverage masks (1280x64 and 960x64 at 1920 wide) near the
    bottom of the frame in src_frame coordinates, colour (1, 1, 0.9, 1);
    and the OSD, premultiplied RGBA 960x128 at (64, 64) of a 3840-wide
    target in dst_frame coordinates.  Both ride on the frame:
    render_image_mix's intermediates carry no target overlays, as in the
    reference."""
    import torch
    s, t = src_w / 1920.0, dst_w / 3840.0
    rng = np.random.default_rng(seed)
    w1, w2, hm = round(1280 * s), round(960 * s), max(1, round(64 * s))
    cover = np.clip(rng.random((1, 2 * hm, w1)) * 1.6 - 0.6, 0.0, 1.0)
    cover[:, hm:, w2:] = 0.0
    gold = (1.0, 1.0, 0.9, 1.0)
    y1, y2 = src_h - round(150 * s), src_h - round(80 * s)
    sub = lt.Overlay(
        data=torch.from_numpy(cover.astype(np.float32)).to(device),
        mode="monochrome", coords="src_frame", parts=(
            lt.OverlayPart(lt.RectF(0, 0, w1, hm), lt.RectF(
                (src_w - w1) // 2, y1, (src_w - w1) // 2 + w1, y1 + hm),
                gold),
            lt.OverlayPart(lt.RectF(0, hm, w2, 2 * hm), lt.RectF(
                (src_w - w2) // 2, y2, (src_w - w2) // 2 + w2, y2 + hm),
                gold)))
    ow, oh, at = round(960 * t), max(1, round(128 * t)), round(64 * t)
    a = np.full((1, oh, ow), 0.75, np.float32)
    rgb = rng.random((3, oh, ow)).astype(np.float32) * a
    osd = lt.Overlay(
        data=torch.from_numpy(np.concatenate([rgb, a])).to(device),
        rect=lt.RectF(at, at, at + ow, at + oh), coords="dst_frame",
        repr=lt.ColorRepr(alpha=lt.AlphaMode.PREMULTIPLIED))
    return [sub, osd]


def path_e_frames(lt, yuvs, device, dst_w):
    """Path E's source frames: 10-bit limited BT.2020-NC PQ yuv420p
    (config 4's content), frame k at pts k * PATH_E_SPACING vsyncs with
    signature k + 1, a new subtitle bitmap every third frame."""
    rep = lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                       levels=lt.ColorLevels.LIMITED,
                       bits=lt.BitEncoding(10, 10, 0))
    out = []
    for k, yuv in enumerate(yuvs):
        f = lt.frame_from_yuv420p(*yuv, color=lt.CSP_BT2100_PQ, repr=rep,
                                  bit_depth=10, device=device)
        f.overlays = path_e_overlays(lt, f.w, f.h, dst_w, k // 3, device)
        f.pts, f.signature = k * PATH_E_SPACING, k + 1
        out.append(f)
    return out


def path_e_mix(lt, frames, v):
    """The FrameMix of vsync v: the source frames shown before and after
    it, timestamps in vsyncs from it."""
    k = int(v // PATH_E_SPACING)
    return lt.FrameMix(frames=[frames[k], frames[k + 1]],
                       timestamps=[frames[k].pts - v, frames[k + 1].pts - v],
                       vsync_duration=1.0)


def path_f_cell(lt, W, H, bar):
    """Path F, a 2.39:1 HDR10 film letterboxed on a 4K SDR display:
    (frame colorspace, repr, bits, target, params) — 10-bit limited
    BT.2020-NC PQ at 1000 nits -> W x H 8-bit sRGB with the crop (0, bar,
    W, H - bar) and the default border (black), HIGH_QUALITY_PARAMS."""
    color = lt.ColorSpace(lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
                          lt.HdrMetadata(max_luma=1000.0))
    rep = lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                       levels=lt.ColorLevels.LIMITED,
                       bits=lt.BitEncoding(10, 10, 0))
    target = lt.Target(w=W, h=H, color=lt.CSP_SRGB, bit_depth=8,
                       crop=lt.RectF(0, bar, W, H - bar))
    return color, rep, 10, target, lt.HIGH_QUALITY_PARAMS


def presentation_cases(lt, yuv, device):
    """The small-input gate's presentation cases on a 64x128 frame (`yuv`,
    8-bit) -> 128x256: name -> (frame, target, params)."""
    flag = lambda: _frame(lt, yuv, device)   # noqa: E731
    sdr = lambda: _frame(lt, yuv, device, config="config2")  # noqa: E731
    tgt = dict(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    ewa = dict(upscaler="ewa_lanczos")
    rot = sdr()
    rot.rotation, rot.crop = 1, lt.RectF(0, 0, 64, 128)
    rng = np.random.default_rng(31)
    rgba = rng.random((64, 128, 4)).astype(np.float32)
    base = rng.random((3, 128, 256)).astype(np.float32)
    return {
        # a quarter turn, pillarboxed with a blurred border
        "rotation_blur": (rot, lt.Target(crop=lt.RectF(96, 0, 160, 128),
                                         **tgt),
                          lt.RenderParams(border="blur", **ewa)),
        "tiles": (flag(), lt.Target(crop=lt.RectF(32, 16, 224, 112), **tgt),
                  lt.RenderParams(background="tiles", tile_size=16, **ewa)),
        "corners": (flag(), lt.Target(**tgt),
                    lt.RenderParams(corner_rounding=0.3, **ewa)),
        "rgba_blend": (lt.frame_from_rgb(rgba, color=lt.CSP_SRGB,
                                         device=device),
                       lt.Target(data=base, **tgt),
                       lt.RenderParams(blend=lt.ALPHA_OVERLAY, **ewa)),
        "cone": (flag(), lt.Target(**tgt), lt.RenderParams(
            cone=lt.ConeParams(lt.Cone.M, 0.2), **ewa)),
        "visualize": (flag(), lt.Target(**tgt),
                      lt.RenderParams(visualize_lut=True, **ewa))}


# path G: a 23.976 fps HDR10 film on a 60 Hz SDR 4K display, driven as
# mpv drives libplacebo: the user's settings as an option string, a
# decoder thread feeding the frame queue, a queue update a vsync
PATH_G_FPS = 24000 / 1001
PATH_G_HZ = 60.0
PATH_G_OPTIONS = ("preset=default,upscaler=ewa_lanczos,frame_mixer="
                  "mitchell_clamp,tone_mapping=spline,"
                  "gamut_mapping=perceptual")


def path_g_params(lt):
    opts = lt.Options()
    opts.parse(PATH_G_OPTIONS)
    return opts.params


class PathGDecoder:
    """Path G's producer: source frame k (config 4's content, 10-bit
    limited BT.2020-NC PQ 4:2:0, pts k / 23.976 s) is "decoded" into
    pinned host memory (plain host memory on the CPU) and push_blocked
    as a lazy SourceFrame, whose `map` uploads its planes and sets its
    signature to the frame number (k + 1); maps, unmaps and discards are
    counted."""

    def __init__(self, lt, yuvs, device):
        import torch
        self.lt, self.yuvs = lt, yuvs
        self.device = torch.device(device)
        self.counts = {"map": 0, "unmap": 0, "discard": 0}
        self.rep = lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                                levels=lt.ColorLevels.LIMITED,
                                bits=lt.BitEncoding(10, 10, 0))

    def decode(self, k):
        """Frame k's planes as int16 tensors in pinned host memory."""
        import torch
        pin = self.device.type == "cuda"
        return [torch.from_numpy(p.astype(np.int16)).pin_memory() if pin
                else torch.from_numpy(p.astype(np.int16))
                for p in self.yuvs[k]]

    def source(self, k, planes):
        lt = self.lt

        def map_frame():
            self.counts["map"] += 1
            f = lt.frame_from_yuv420p(*planes, color=lt.CSP_BT2100_PQ,
                                      repr=self.rep, bit_depth=10,
                                      device=self.device)
            f.signature = k + 1
            return f

        def unmap(frame):
            self.counts["unmap"] += 1

        def discard():
            self.counts["discard"] += 1
        return lt.SourceFrame(pts=k / PATH_G_FPS, map=map_frame,
                              unmap=unmap, discard=discard)

    def run(self, queue, stop):
        """The decoder thread's body: every frame, then EOF, each
        push_block retried with a 0.1 s timeout until `stop` is set."""
        for item in [k for k in range(len(self.yuvs))] + [None]:
            src = None if item is None else self.source(item,
                                                        self.decode(item))
            while not stop.is_set():
                if queue.push_block(src, timeout=0.1):
                    break


def path_g_update(lt, queue, params, v):
    """Vsync v's queue update: (status, FrameMix or None)."""
    return queue.update(lt.QueueParams(
        pts=v / PATH_G_HZ, radius=lt.frame_mix_radius(params),
        vsync_duration=1 / PATH_G_HZ), lt.QueueMode.INTERPOLATE)


def path_g_play(lt, renderer, decoder, target, params, vsyncs,
                threaded=True, on_vsync=None):
    """Play vsyncs through a frame queue fed by `decoder` (on a thread,
    started after it has buffered FrameQueue.MAX_AHEAD frames, as a
    player pre-buffers; or, with threaded=False, every frame pushed up
    front): each vsync's queue update, then render_image_mix of its mix.
    `on_vsync(v, status, mix, out)` sees each vsync (mix and out None
    unless the status is OK).  Returns the statuses, in order."""
    import threading
    queue = lt.FrameQueue()
    stop = threading.Event()
    thread = None
    if threaded:
        thread = threading.Thread(target=decoder.run, args=(queue, stop),
                                  daemon=True)
        thread.start()
        deadline = time.monotonic() + 60.0
        while queue.num_frames < min(queue.MAX_AHEAD, len(decoder.yuvs)):
            assert time.monotonic() < deadline, "path G: decoder stalled"
            time.sleep(0.001)
    else:
        for k in range(len(decoder.yuvs)):
            queue.push(decoder.source(k, decoder.decode(k)))
        queue.push(None)
    statuses = []
    try:
        for v in vsyncs:
            status, mix = path_g_update(lt, queue, params, v)
            statuses.append(status)
            out = None
            if status == lt.QueueStatus.OK:
                out = lt.render_image_mix(renderer, mix, target, params)
            if on_vsync is not None:
                on_vsync(v, status, mix, out)
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
            assert not thread.is_alive(), "path G: decoder did not stop"
        queue.reset()
    return statuses


# path H: config 5 with user hooks — a luma doubler and an
# auto-exposure with state carried across frames
PATH_H_SEED = 4242


def path_h_hooks(lt, device):
    """Path H's hooks, as a user writes them in plain torch ops: a
    LUMA_INPUT 2x luma doubler shaped like FSRCNNX (a seeded 3x3
    convolution to 4 channels over the edge-padded luma, then a pixel
    shuffle; its phases sample half a texel right and down of each input
    texel, so it declares //!OFFSET -0.5 -0.5 of the doubled grid), and a
    PRE_OUTPUT auto-exposure (a running mean of the frame's intensity,
    carried across frames in its `state_spec`, sets a small gain)."""
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(PATH_H_SEED)
    w = rng.random((4, 1, 3, 3)) + 0.25
    w = (w / w.sum(axis=(1, 2, 3), keepdims=True)).astype(np.float32)
    weight = torch.from_numpy(w).to(device)

    def doubler(img, params):
        x = F.pad(img[None], (1, 1, 1, 1), mode="replicate")
        out = F.pixel_shuffle(F.conv2d(x, weight), 2)[0]
        params.rect.apply_pass(2.0, 2.0, off=(-0.5, -0.5))
        return out

    def exposure(img, params):
        mean = params.state_in["mean"] * 0.875 + img.mean() * 0.125
        params.state_out["mean"] = mean
        return img * (1.0 + (0.25 - mean) * 0.1)
    auto = lt.Hook(lt.HookStage.PRE_OUTPUT, exposure, name="auto_exposure")
    auto.state_spec = {"mean": np.float32(0.25)}
    return [lt.Hook(lt.HookStage.LUMA_INPUT, doubler, name="luma_doubler"),
            auto], w


def path_h_params(lt, hooks):
    """Config 5's params (deband, AV1 grain, Floyd-Steinberg to 8 bits)
    with path H's hooks."""
    return lt.RenderParams(upscaler="ewa_lanczos",
                           deband=lt.DebandParams(iterations=2),
                           film_grain=True, error_diffusion="floyd-steinberg",
                           hooks=tuple(hooks))


# path I: a transcoder (ffmpeg's vf_libplacebo, tonemapping with
# w=1920:h=1080) taking a 4K HDR10 clip to 1080p SDR for an SDR client
PATH_I_SEED = 31
PATH_I_FRAMES = 8
PATH_I_FPS = (24000, 1001)
# 10-bit limited luma codes: 64 black, 572 ~ 203 nits (SDR white), 722 ~
# 1000 nits (the mastering peak)
PATH_I_LUMA = (64, 722)


def path_i_yuv(n, h, w, seed=PATH_I_SEED):
    """n seeded 10-bit limited 4:2:0 frames, the flagship's kind of
    content (noise over the code range) with luma up to the 1000-nit
    mastering peak, ~23% of it above SDR white, and chroma over its whole
    range (colors outside BT.709)."""
    rng = np.random.default_rng(seed)
    lo, hi = PATH_I_LUMA
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * (hi - lo) + lo).astype(np.uint16)
        u = (rng.random((h // 2, w // 2)) * 896 + 64).astype(np.uint16)
        v = (rng.random((h // 2, w // 2)) * 896 + 64).astype(np.uint16)
        out.append((y, u, v))
    return out


def path_i_write_clip(path_or_file, yuvs):
    """The source clip through the port's Y4MWriter from integer planes:
    C420p10 with XCOLORRANGE=LIMITED."""
    from libplacebo_tpu_torch.utils import y4m
    h, w = yuvs[0][0].shape
    with y4m.Y4MWriter(path_or_file, w, h, fps=PATH_I_FPS, csp="420p10",
                       extensions=("COLORRANGE=LIMITED",)) as wr:
        for planes in yuvs:
            wr.write(planes)


def path_i_avframe(raw):
    """A decoder's AVFrame for raw planes (Y4MReader.read_raw): 10-bit
    4:2:0 BT.2020-NC PQ, limited range, left chroma siting, HDR10 side
    data (mastering display P3-D65 0.0001-1000 nits; MaxCLL 1000, MaxFALL
    400)."""
    return {"format": "yuv420p10le", "data": list(raw),
            "colorspace": "bt2020nc", "color_primaries": "bt2020",
            "color_trc": "smpte2084", "color_range": "tv",
            "chroma_location": "left",
            "mastering_display_metadata": {
                "display_primaries": [[0.680, 0.320], [0.265, 0.690],
                                      [0.150, 0.060]],
                "white_point": [0.3127, 0.3290],
                "min_luminance": 0.0001, "max_luminance": 1000.0},
            "content_light_level": {"max_cll": 1000.0, "max_fall": 400.0}}


def path_i_target(lt, w, h):
    """1920x1080 (or w x h) 8-bit BT.709 BT.1886: an SDR client."""
    return lt.Target(w=w, h=h, color=lt.ColorSpace(lt.ColorPrimaries.BT_709,
                                                   lt.ColorTransfer.BT_1886),
                     bit_depth=8)


def path_i_yuv_repr(lt):
    """The output's encoding: 8-bit BT.709 limited YCbCr."""
    return lt.ColorRepr(sys=lt.ColorSystem.BT_709,
                        levels=lt.ColorLevels.LIMITED,
                        bits=lt.BitEncoding(8, 8, 0))


def path_i_gamut_lut(lt):
    """The transcoder's BT.2020 -> BT.709 perceptual gamut LUT (the host
    3D-LUT generator), as a (cache key, bytes) pair it keeps in its
    context's cache across runs."""
    import hashlib
    from libplacebo_tpu_torch.core import gamut_mapping as gm
    from libplacebo_tpu_torch.core.colorspace import primaries_get
    params = gm.GamutMapParams(
        function=gm.find_gamut_map_function("perceptual"),
        input_gamut=primaries_get(lt.ColorPrimaries.BT_2020),
        output_gamut=primaries_get(lt.ColorPrimaries.BT_709),
        min_luma=float(gm._pq_oetf(1e-8)), max_luma=float(gm._pq_oetf(0.1)))
    key = int.from_bytes(hashlib.sha256(repr(params).encode()).digest()[:8],
                         "little")
    return key, gm.generate(params).tobytes()


class PathITranscoder:
    """Path I's loop over the y4m `src` into `dst`, a frame a `step()`:
    read the frame's raw planes (Y4MReader.read_raw), map them as a
    decoder's AVFrame (interop.frame_from_avframe_like, onto the
    renderer's device, with acquire / release counted), render to 1080p
    SDR (the target's size is the source's halved), encode to BT.709
    limited YCbCr on the device, download through a pinned buffer and
    write (Y4MWriter, 420jpeg).  With a `stats` dict, each stage's host
    time is appended under its name (the device synchronized around the
    render: "render_ms"), the context timer's readings under "timer_s",
    and the first frame's downloaded YCbCr kept as "first_yuv".  `frames`
    keeps the mapped frames."""

    def __init__(self, lt, src, dst, renderer, params=None, stats=None):
        import torch
        from libplacebo_tpu_torch.ops.color import encode_color
        from libplacebo_tpu_torch.utils import interop, y4m
        self.lt, self.renderer, self.stats = lt, renderer, stats
        self.params = params or lt.RenderParams()
        self.encode, self.interop = encode_color, interop
        self.dev = renderer.device
        self.cuda = self.dev.type == "cuda"
        self.counts = {"acquire": 0, "release": 0}
        self.frames = []
        self.timer = renderer.ctx.timer() if renderer.ctx is not None \
            else None
        self.reader = y4m.Y4MReader(src)
        info = self.reader.info
        self.target = path_i_target(lt, info.width // 2, info.height // 2)
        self.host = torch.empty((3, self.target.h, self.target.w),
                                dtype=torch.float32, pin_memory=self.cuda)
        self.writer = y4m.Y4MWriter(
            dst, self.target.w, self.target.h,
            fps=(info.fps.numerator, info.fps.denominator), csp="420jpeg")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.reader.close()
        self.writer.close()

    def _acquire(self, frame):
        self.counts["acquire"] += 1
        return True

    def _release(self, frame):
        self.counts["release"] += 1

    def _clock(self, name, t0):
        if self.stats is not None:
            self.stats.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    def _sync(self):
        import torch
        if self.cuda and self.stats is not None:
            torch.cuda.synchronize(self.dev)

    def _harvest(self):
        while self.stats is not None and self.timer is not None:
            reading = self.timer.query()
            if reading is None:
                return
            self.stats.setdefault("timer_s", []).append(reading)

    def step(self) -> bool:
        """Transcode the next frame; False at the end of the clip."""
        import torch
        t0 = time.perf_counter()
        raw = self.reader.read_raw()
        if raw is None:
            return False
        self._clock("read_host_ms", t0)
        t0 = time.perf_counter()
        frame = self.interop.frame_from_avframe_like(path_i_avframe(raw),
                                                     device=self.dev)
        frame.acquire, frame.release = self._acquire, self._release
        self._clock("map_host_ms", t0)
        self._sync()
        t0 = time.perf_counter()
        if self.timer is not None:
            self.timer.start()
        out = self.renderer.render(frame, self.target, self.params)
        if self.timer is not None:
            self.timer.stop(out)
        self._sync()
        self._clock("render_ms", t0)
        t0 = time.perf_counter()
        self.host.copy_(self.encode(out, path_i_yuv_repr(self.lt)),
                        non_blocking=self.cuda)
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()
        self._clock("encode_download_ms", t0)
        t0 = time.perf_counter()
        self.writer.write(self.host.numpy())
        self._clock("write_host_ms", t0)
        if self.stats is not None and "first_yuv" not in self.stats:
            self.stats["first_yuv"] = self.host.numpy().copy()
        self.frames.append(frame)
        self._harvest()
        return True


def path_i_transcode(lt, src, dst, renderer, params=None, stats=None):
    """The whole clip through PathITranscoder: (mapped frames, acquire /
    release counts)."""
    with PathITranscoder(lt, src, dst, renderer, params, stats) as t:
        while t.step():
            pass
    if stats is not None and t.timer is not None:
        if t.cuda:
            import torch
            torch.cuda.synchronize(t.dev)
        t._harvest()
    return t.frames, t.counts


def _y4m_codes(y4m, path):
    """(info, [each frame's planes joined as one uint8 array])."""
    with y4m.Y4MReader(path) as rd:
        out = []
        while (raw := rd.read_raw()) is not None:
            out.append(np.concatenate([p.reshape(-1) for p in raw]))
        return rd.info, out


def path_i_phase(lt, dev, counters, k1, W=3840, H=2160):
    """Path I at full size: an 8-frame 3840x2160 10-bit HDR10 clip written
    with the port's Y4MWriter into a temporary directory, transcoded to
    1920x1080 8-bit BT.709 SDR (PathITranscoder) on a Renderer built on
    runtime.create(), whose cache holds the transcoder's gamut LUT.  The
    launch counts are set to 0 just before the counted run (after a
    one-frame warm-up on another renderer) and read just after.  Checks:
    K1 once a frame and no plain tail, acquire and release 8 times each,
    the written file read back (header, 8 frames, frame 0's codes),
    save() restored by a fresh renderer's load(), the context alive, the
    GPU transcode of a small clip (output 256 wide) against the CPU one
    at the small-input gate; K1's launch against its plain version.
    Returns the figures, K1's captured input and its launches."""
    import shutil
    import tempfile
    from fractions import Fraction
    import torch
    from libplacebo_tpu_torch import runtime
    from libplacebo_tpu_torch.render import renderer as trender
    from libplacebo_tpu_torch.utils import y4m
    tmp = tempfile.mkdtemp(prefix="path_i_")
    try:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.y4m")
        yuvs = path_i_yuv(PATH_I_FRAMES, H, W)
        path_i_write_clip(src, yuvs)
        path_i_write_clip(os.path.join(tmp, "warm.y4m"), yuvs[:1])
        path_i_transcode(lt, os.path.join(tmp, "warm.y4m"),
                         os.path.join(tmp, "warm_out.y4m"),
                         lt.Renderer(ctx=runtime.create(device=dev)))
        ctx = runtime.create(device=dev)
        lut_key, lut = path_i_gamut_lut(lt)
        ctx.cache.set(lut_key, lut)
        renderer = lt.Renderer(ctx=ctx)
        captured, real = [], k1.color_map_tail

        def cap_k1(img, plan, tone, lut_t):
            if len(captured) < 2:
                captured.append((img.clone(), plan, tone.clone()
                                 if tone is not None else None, lut_t))
            return real(img, plan, tone, lut_t)
        stats = {}
        k1.color_map_tail = cap_k1
        try:
            for mod in counters.values():
                mod.launches = 0
            trender.k1_tails = trender.plain_tails = \
                trender.ineligible_tails = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames, counts = path_i_transcode(lt, src, dst, renderer,
                                              stats=stats)
            loop_s = time.perf_counter() - t0
            counts = dict(counts)      # the window below acquires again
            launches = {n: m.launches for n, m in counters.items()}
            tails = (trender.k1_tails, trender.plain_tails,
                     trender.ineligible_tails)
        finally:
            k1.color_map_tail = real
        assert launches == {"k1": 8, "k2": 0, "k3": 0}, launches
        assert tails == (8, 0, 0), tails
        assert counts == {"acquire": 8, "release": 8}, counts
        k1_args = captured[1]
        plan = k1_args[1]
        if plan.tone == k1.GENERIC:
            mode = plan.generic.mode
            instance = (f"generic (kind {mode.kind}, gamut "
                        f"{k1.G_GAMUTS[mode.gamut]}, tone kind "
                        f"{mode.tone_kind} {plan.generic.dynamic}, trc "
                        f"{k1.G_TRCS[mode.trc]}, encode "
                        f"{k1.G_ENCODES[mode.encode]}, dither "
                        f"{k1.G_DITHER[mode.dither]})")
        else:
            instance = k1.instance_name(plan.tone, plan.gamut,
                                        k1_args[3] is not None)
        # the written file, read back
        info, codes = _y4m_codes(y4m, dst)
        assert (info.width, info.height, info.csp, info.bit_depth) == \
            (W // 2, H // 2, "420jpeg", 8), info
        assert info.fps == Fraction(*PATH_I_FPS), info.fps
        assert len(codes) == PATH_I_FRAMES, len(codes)
        import io
        want = io.BytesIO()
        y4m.Y4MWriter(want, W // 2, H // 2, csp="420jpeg").write(
            stats["first_yuv"])
        want = np.frombuffer(want.getvalue().split(b"FRAME\n", 1)[1],
                             np.uint8)
        assert np.array_equal(codes[0], want)
        # the context's cache through save() and a fresh renderer's load()
        blob = renderer.save()
        fresh = lt.Renderer(ctx=runtime.create(device=dev))
        restored = fresh.load(blob)
        assert restored == ctx.cache.num_objects == \
            fresh.ctx.cache.num_objects == 1, restored
        assert fresh.ctx.cache.get(lut_key) == lut
        # back to back: the 8 mapped frames again, each bracketed by the
        # context's timer and by a pair of CUDA events
        target = path_i_target(lt, W // 2, H // 2)
        params = lt.RenderParams()
        timer = ctx.timer()
        assert timer.query() is None
        pairs = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in frames:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            timer.start()
            out = renderer.render(f, target, params)
            timer.stop(out)
            e1.record()
            pairs.append((e0, e1))
        end.record()
        torch.cuda.synchronize()
        window_ms = start.elapsed_time(end) / len(frames)
        event_ms = [a.elapsed_time(b) for a, b in pairs]
        timer_ms = [timer.query() * 1e3 for _ in frames]
        assert timer.query() is None
        assert tuple(out.shape) == (3, H // 2, W // 2), out.shape
        assert bool(torch.isfinite(out).all())
        c = out * 255.0
        assert float((c - torch.round(c)).abs().max()) <= 255e-6
        assert ctx.check_alive() and not ctx.is_failed
        del frames, out
        # the small-input gate: a 2-frame clip with a 256-wide output
        small_src = os.path.join(tmp, "small.y4m")
        path_i_write_clip(small_src, path_i_yuv(2, 128, 512, seed=7))
        small = {}
        for name, d in (("gpu", dev), ("cpu", "cpu")):
            out_path = os.path.join(tmp, f"small_{name}.y4m")
            ctx_s = runtime.create(device=d) if name == "gpu" else \
                runtime.create_dummy()
            _, n = path_i_transcode(lt, small_src, out_path,
                                    lt.Renderer(ctx=ctx_s))
            assert n == {"acquire": 2, "release": 2}, n
            small[name] = _y4m_codes(y4m, out_path)[1]
        small_gate = []
        for g, c_ in zip(small["gpu"], small["cpu"]):
            d = np.abs(g.astype(np.float64) - c_) / 255.0
            small_gate.append({"max": float(d.max()), "mean": float(d.mean()),
                               "above_1lsb": float((d > LSB + 1e-5).mean())})
            assert d.mean() < 1e-4 and (d > LSB + 1e-5).mean() <= 5e-4, \
                small_gate[-1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    med = statistics.median
    figures = {
        "path_i_frame_ms": med(stats["render_ms"]),
        "path_i_frame_ms_samples": stats["render_ms"],
        "path_i_window_ms": window_ms,
        "path_i_timer_ms": timer_ms, "path_i_event_ms": event_ms,
        "path_i_loop_timer_ms": [t * 1e3 for t in stats["timer_s"]],
        "path_i_fps": PATH_I_FRAMES / loop_s,
        "path_i_read_host_ms": med(stats["read_host_ms"]),
        "path_i_map_ms": med(stats["map_host_ms"]),
        "path_i_encode_download_ms": med(stats["encode_download_ms"]),
        "path_i_write_host_ms": med(stats["write_host_ms"]),
        "path_i_stage_ms": {k: v for k, v in stats.items()
                            if k.endswith("_ms")},
        "path_i_tails": tails, "path_i_acquire_release": counts,
        "path_i_k1_instance": instance,
        "path_i_cache_objects_restored": restored,
        "path_i_small_render": small_gate}
    return figures, k1_args, launches["k1"]


# path J: an mpv user's shaders (glsl-shaders=) — a RAVU-lite-class
# luma doubler and a stateful temporal-EMA compute hook, added through
# Options.add_hook to params set as mpv sets them
PATH_J_SEED = 5151
PATH_J_FRAMES = 8
PATH_J_OPTIONS = "upscaler=ewa_lanczos,error_diffusion=sierra-lite"
# the doubler's LUT: (angle, strength, coherence) rows x taps x 4 subpixels
_RAVU_QA, _RAVU_QS, _RAVU_QC = 8, 4, 3
_RAVU_ROWS = _RAVU_QA * _RAVU_QS * _RAVU_QC
_RAVU_TAPS = 3
_PI = 3.141592653589793


def path_j_lut(seed=PATH_J_SEED):
    """The doubler's seeded float16 weight LUT, (96, 3, 4)."""
    return np.random.default_rng(seed).uniform(
        -0.2, 0.5, (_RAVU_ROWS, _RAVU_TAPS, 4)).astype(np.float16)


def path_j_ravu_shader(lut):
    """A RAVU-lite-class 2x LUMA doubler in the structure RAVU generators
    emit: structure-tensor eigenanalysis -> quantized (angle, strength,
    coherence) -> a LUT row read at data-dependent coordinates ->
    weighted taps into 4 subpixels (step 1, //!SAVE ravu_int); step 2
    interleaves them 2x with a per-pixel vector index."""
    hexdata = lut.tobytes().hex()
    return f"""\
//!DESC ravu-lite-class step1
//!HOOK LUMA
//!BIND HOOKED
//!BIND ravu_lut
//!SAVE ravu_int
//!COMPONENTS 4
//!WHEN OUTPUT.w HOOKED.w / 1.2 >

#define L(x, y) HOOKED_texOff(vec2(x, y)).x

vec4 hook() {{
    vec3 abd = vec3(0.0);
    float gx, gy;
    gx = (L(0, 1) - L(0, -1)) / 2.0;
    gy = (L(1, 0) - L(-1, 0)) / 2.0;
    abd += vec3(gx * gx, gx * gy, gy * gy) * 0.5;
    gx = (L(1, 1) - L(-1, 1)) / 2.0;
    gy = (L(1, 1) - L(1, -1)) / 2.0;
    abd += vec3(gx * gx, gx * gy, gy * gy) * 0.25;
    gx = (L(-1, -1) - L(1, -1)) / 2.0;
    gy = (L(-1, 1) - L(-1, -1)) / 2.0;
    abd += vec3(gx * gx, gx * gy, gy * gy) * 0.25;
    float a = abd.x, b = abd.y, d = abd.z;
    float T = a + d, D = a * d - b * b;
    float delta = sqrt(max(T * T / 4.0 - D, 0.0));
    float L1 = T / 2.0 + delta, L2 = T / 2.0 - delta;
    float sqrtL1 = sqrt(L1), sqrtL2 = sqrt(L2);
    float theta = mix(mod(atan(b, L1 - a) + {_PI}, {_PI}), 0.0, abs(b) < 1.192092896e-7);
    float lambda = sqrtL1;
    float mu = mix((sqrtL1 - sqrtL2) / (sqrtL1 + sqrtL2), 0.0, sqrtL1 + sqrtL2 < 1.192092896e-7);
    float angle = floor(theta / {_PI} * {_RAVU_QA}.0);
    float strength = mix(mix(0.0, 1.0, lambda >= 0.004), mix(2.0, 3.0, lambda >= 0.05), lambda >= 0.016);
    float coherence = mix(mix(0.0, 1.0, mu >= 0.25), 2.0, mu >= 0.5);
    float coord_y = ((angle * {_RAVU_QS}.0 + strength) * {_RAVU_QC}.0 + coherence + 0.5) / {_RAVU_ROWS}.0;
    vec4 res = vec4(0.0);
    res += L(-1, -1) * texture(ravu_lut, vec2(0.5 / {_RAVU_TAPS}.0, coord_y));
    res += L(0, 0) * texture(ravu_lut, vec2(1.5 / {_RAVU_TAPS}.0, coord_y));
    res += L(1, 1) * texture(ravu_lut, vec2(2.5 / {_RAVU_TAPS}.0, coord_y));
    return res;
}}

//!DESC ravu-lite-class step2 (2x interleave)
//!HOOK LUMA
//!BIND ravu_int
//!WIDTH HOOKED.w 2 *
//!HEIGHT HOOKED.h 2 *

vec4 hook() {{
    vec2 pos = HOOKED_pos * ravu_int_size;
    vec2 sub = fract(pos);
    int idx = int(sub.y > 0.5) * 2 + int(sub.x > 0.5);
    vec2 tc = (floor(pos) + vec2(0.5)) * ravu_int_pt;
    vec4 q = ravu_int_tex(tc);
    return vec4(q[idx], 0.0, 0.0, 1.0);
}}

//!TEXTURE ravu_lut
//!SIZE {_RAVU_TAPS} {_RAVU_ROWS}
//!FORMAT rgba16hf
//!FILTER NEAREST
{hexdata}
"""


# a temporal EMA at MAIN: a STORAGE image and a STORAGE buffer counter
# carried across frames (//!SIZE set to MAIN's size by path_j_ema_shader)
PATH_J_EMA_SHADER = """\
//!TEXTURE ACC
//!SIZE 48 32
//!FORMAT rgba32f
//!STORAGE

//!BUFFER st
//!STORAGE
//!VAR float frames

//!HOOK MAIN
//!BIND HOOKED
//!BIND ACC
//!DESC temporal EMA accumulator
//!COMPUTE 8 8
void hook()
{
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = HOOKED_texOff(0);
    vec4 prev = imageLoad(ACC, pos);
    vec4 ema = (frames < 0.5) ? c : (0.3 * c + 0.7 * prev);
    imageStore(ACC, pos, ema);
    imageStore(out_image, pos, ema);
}

//!HOOK MAIN
//!BIND HOOKED
//!DESC frame counter bump
vec4 hook()
{
    frames = frames + 1.0;
    return HOOKED_texOff(0);
}
"""


def path_j_ema_shader(main_w, main_h):
    """The EMA hook with its STORAGE image at MAIN's size (the luma
    doubler makes MAIN the doubled grid)."""
    return PATH_J_EMA_SHADER.replace("//!SIZE 48 32",
                                     f"//!SIZE {main_w} {main_h}")


def path_j_params(lt, src_w, src_h):
    """Path J's params as mpv sets them: Options().parse(PATH_J_OPTIONS),
    then the doubler and the EMA through Options.add_hook (MAIN is the
    doubled grid: 2 src_w x 2 src_h)."""
    opts = lt.Options()
    opts.parse(PATH_J_OPTIONS)
    opts.add_hook(path_j_ravu_shader(path_j_lut()))
    opts.add_hook(path_j_ema_shader(2 * src_w, 2 * src_h))
    return opts.params


def path_j_phase(lt, dev, counters, k2, k3, W=1920, H=1080):
    """Path J at full width: 8 seeded W x H 8-bit limited BT.709 BT.1886
    yuv420p frames (config 2's content) -> 2W x 2H 8-bit sRGB with
    path_j_params (EWA Lanczos, Sierra Lite error diffusion, the RAVU-
    lite-class LUMA doubler and the temporal EMA at MAIN, both through
    Options.add_hook).  The launch counts are set to 0 just before the
    counted run and read just after.  Checks: K1 0 (the hooked tail is
    plain, counted ineligible), K2 once and K3 twice a frame, one plan,
    no hook disabled, the EMA's counter 8, 8-bit codes of the right
    shape; then a warm frame whose hooks run under
    torch.cuda.set_sync_debug_mode("error") and upload nothing; K2 and
    K3 exact against their plain versions on frame 2's own input; the
    GPU render of a small input (64x128 -> 128x256, 3 frames) against
    the CPU render at the flagship's gate.  Timed: the frames
    synchronized and back to back, the host ms to issue a frame's hooks,
    each pass's span on the card (CUDA events around it, host gaps
    included), each pass's kernel launches and busy ms (profiler), and a
    whole frame's launches and busy share (profiler).  Returns
    (figures, the kernels line's path J entries)."""
    import torch
    from libplacebo_tpu_torch.render import mpv_hooks as tm
    from libplacebo_tpu_torch.render import renderer as trender
    target = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    frames = [_frame(lt, f, dev, config="config2")
              for f in _flagship_yuv(PATH_J_FRAMES, H, W, seed=PATH_J_SEED)]
    params = path_j_params(lt, W, H)
    ravu, ema = params.hooks
    renderer = lt.Renderer(device=dev)

    # each hook call timed on the host (what issuing its work costs),
    # under sync debug mode "error" while `strict` is set
    calls, errors, strict = [], [], [False]

    def instrument(h):
        func = h.func

        def timed(img, hp):
            if strict[0]:
                torch.cuda.set_sync_debug_mode("error")
            t = time.perf_counter()
            try:
                return func(img, hp)
            except Exception as e:
                errors.append(f"{hp.stage.name}: {type(e).__name__}: {e}")
                raise
            finally:
                calls.append((hp.stage.name,
                              (time.perf_counter() - t) * 1e3))
                if strict[0]:
                    torch.cuda.set_sync_debug_mode(0)
        h.func = timed
    instrument(ravu)
    instrument(ema)

    # frame 2's K2 input and K3 inputs, kept for the exactness checks
    cap = {"k2": None, "k3": [], "n2": 0, "n3": 0}
    real = (k2.wavefront, k3.shear_to_colmaj, k3.unshear_from_colmaj)

    def cap_k2(colmaj, kernel, depth, w, h):
        if cap["n2"] == 2:
            cap["k2"] = (colmaj.clone(), kernel, depth, w, h)
        cap["n2"] += 1
        return real[0](colmaj, kernel, depth, w, h)

    def cap_k3(forward):
        def run(x, w_out, s, w, h):
            if cap["n3"] in (4, 5):
                cap["k3"].append((x.clone(), w_out, s, w, h, forward))
            cap["n3"] += 1
            return real[1 if forward else 2](x, w_out, s, w, h)
        return run
    k2.wavefront = cap_k2
    k3.shear_to_colmaj, k3.unshear_from_colmaj = cap_k3(True), cap_k3(False)
    try:
        for mod in counters.values():
            mod.launches = 0
        trender.k1_tails = trender.plain_tails = \
            trender.ineligible_tails = 0
        sync_ms, host_ms = [], []
        for f in frames:
            torch.cuda.synchronize()
            n = len(calls)
            t = time.perf_counter()
            out = renderer.render(f, target, params)
            torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t) * 1e3)
            host_ms.append(sum(ms for _, ms in calls[n:]))
        launches = {name: m.launches for name, m in counters.items()}
        tails = (trender.k1_tails, trender.plain_tails,
                 trender.ineligible_tails)
    finally:
        k2.wavefront, k3.shear_to_colmaj, k3.unshear_from_colmaj = real
    assert launches == {"k1": 0, "k2": 8, "k3": 16}, launches
    assert tails == (0, 0, 8), tails
    assert not errors and renderer.get_errors() == \
        (frozenset(), frozenset()), (errors, renderer.get_errors())
    assert len(renderer._cache) == 1
    counter = float(renderer._hook_states[(ema.signature, "buf:frames")][0])
    assert counter == 8.0, counter
    acc = renderer._hook_states[(ema.signature, "tex:ACC")]
    assert tuple(acc.shape) == (4, 2 * H, 2 * W), acc.shape
    assert tuple(out.shape) == (3, 2 * H, 2 * W), out.shape
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    codes = out * 255.0
    assert float((codes - torch.round(codes)).abs().max()) <= 255e-6
    assert len(cap["k3"]) == 2 and cap["k3"][0][5] and not cap["k3"][1][5]

    # a warm frame: the hooks synchronize nowhere and upload nothing
    uploads = (ravu.cache.uploads, ema.cache.uploads)
    torch.cuda.synchronize()
    strict[0] = True
    try:
        n = len(calls)
        renderer.render(frames[3], target, params)
    finally:
        strict[0] = False
    torch.cuda.synchronize()
    strict_calls = calls[n:]
    assert not errors and renderer.get_errors() == \
        (frozenset(), frozenset()), (errors, renderer.get_errors())
    assert [st for st, _ in strict_calls] == ["LUMA_INPUT", "RGB"], \
        strict_calls
    assert (ravu.cache.uploads, ema.cache.uploads) == uploads

    # K2 and K3 on frame 2's own input, exact against the plain versions
    # and timed
    entries = _k2_k3_entries(k2, k3, cap["k2"], cap["k3"], "path_j",
                             launches, 5)
    del cap

    # timings: back to back (CUDA events), the host's issue of the hooks,
    # each pass's device ms, and one hook call's launches (profiler)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = len(calls)
    start.record()
    for f in frames:
        renderer.render(f, target, params)
    end.record()
    torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / len(frames)
    window_host_ms = sum(ms for _, ms in calls[n:]) / len(frames)
    real_pass, pass_events = tm._run_pass, []

    def timed_pass(shader, p, img, *a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real_pass(shader, p, img, *a, **k)
        e1.record()
        # (the doubler's //!DESC lines precede its //!HOOK lines, where
        # the parser, like the reference's, does not read them)
        pass_events.append((f"{len(pass_events)}: {p.desc}", e0, e1))
        return res
    tm._run_pass = timed_pass
    try:
        torch.cuda.synchronize()
        renderer.render(frames[4], target, params)
        torch.cuda.synchronize()
    finally:
        tm._run_pass = real_pass
    pass_ms = {d: e0.elapsed_time(e1) for d, e0, e1 in pass_events}
    assert len(pass_ms) == 4, list(pass_ms)
    def kernels(prof):
        """(launches, busy ms) of a profile's device events."""
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3
    prof_passes = {}

    def profiled_pass(shader, p, img, *a, **k):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = real_pass(shader, p, img, *a, **k)
            torch.cuda.synchronize()
        n, busy = kernels(prof)
        prof_passes[f"{len(prof_passes)}: {p.desc}"] = {
            "launches": n, "busy_ms": busy}
        return res
    tm._run_pass = profiled_pass
    try:
        renderer.render(frames[5], target, params)
        torch.cuda.synchronize()
    finally:
        tm._run_pass = real_pass
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        renderer.render(frames[6], target, params)
        torch.cuda.synchronize()
    frame_launches, frame_busy_ms = kernels(prof)
    assert renderer.get_errors() == (frozenset(), frozenset())
    assert len(prof_passes) == 4 and all(
        v["launches"] > 0 for v in prof_passes.values()), prof_passes

    # the small-input gate: the GPU render against the CPU render
    small, st = [], lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    pg, pc = path_j_params(lt, 128, 64), path_j_params(lt, 128, 64)
    for f in _flagship_yuv(3, 64, 128, seed=7):
        g = rg.render(_frame(lt, f, dev, config="config2"), st, pg)
        c = rc.render(_frame(lt, f, "cpu", config="config2"), st, pc)
        d = np.abs(g.cpu().numpy() - c.numpy())
        small.append({"max": float(d.max()), "mean": float(d.mean()),
                      "above_1lsb": float((d > LSB + 1e-5).mean())})
        assert d.mean() < 1e-4 and (d > LSB + 1e-5).mean() <= 5e-4, \
            small[-1]
    assert rg.get_errors() == rc.get_errors() == (frozenset(), frozenset())

    med = statistics.median
    figures = {
        "path_j_first_frame_ms": sync_ms[0],
        "path_j_frame_ms": med(sync_ms[1:]),
        "path_j_frame_ms_samples": sync_ms,
        "path_j_window_ms": window_ms,
        "path_j_hooks_host_ms": med(host_ms[1:]),
        "path_j_hooks_host_ms_samples": host_ms,
        "path_j_hooks_host_ms_back_to_back": window_host_ms,
        "path_j_hooks_host_ms_sync_debug": sum(ms for _, ms in
                                               strict_calls),
        "path_j_pass_span_ms": pass_ms,
        "path_j_passes_profiled": prof_passes,
        "path_j_frame_launches": frame_launches,
        "path_j_frame_busy_ms": frame_busy_ms,
        "path_j_busy_share": frame_busy_ms / window_ms,
        "path_j_launches_per_frame": {k: v / PATH_J_FRAMES
                                      for k, v in launches.items()},
        "path_j_tails": tails, "path_j_counter": counter,
        "path_j_uploads": {"ravu": ravu.cache.uploads,
                           "ema": ema.cache.uploads},
        "path_j_small_render": small}
    return figures, entries


# path K: the multi-device layer (libplacebo_tpu_torch/parallel/) on the
# only mesh one card gives, one NCCL rank: the flagship through the halo
# step and config 5 through the replicated step, batch 2 a call
PATH_K_SEED = 6161
PATH_K_FRAMES = 8
PATH_K_CONFIG5_FRAMES = 4


def _path_k_gate(out, ref):
    """Within one LSB on <= 1e-3 of the values, none beyond; returns the
    largest difference and the fraction that differ."""
    d = (out - ref).abs()
    mx, frac = float(d.max()), float((d > 1e-6).float().mean())
    assert mx <= LSB + 1e-6 and frac <= 1e-3, (mx, frac)
    return mx, frac


def path_k_phase(lt, dev, counters, k1, k2, k3, W=1920, H=1080):
    """Path K at full width: GpuContext().make_mesh() starts a one-rank
    NCCL group (data = spatial = 1); build_sharded_pipeline renders
    PATH_K_FRAMES flagship frames (1080p yuv420p PQ -> 3840x2160 sRGB,
    EWA) on the halo step, two a call with the peak state threaded per
    lane, and PATH_K_CONFIG5_FRAMES config-5 frames (deband, AV1 grain a
    new seed a frame, Floyd-Steinberg) on the replicated step.  The
    launch counts are set to 0 just before each counted run and read
    just after (halo: K1 once a frame; replicated: K1 without dither
    once, K2 once and K3 twice a frame).  Each output is held against
    the single-card Renderer of the same lane (within one LSB on <= 1e-3
    of the values, none beyond), the halo step's state against the
    single-card whole-frame detection (its plain tail) within 1e-6, the
    replicated step's state bit for bit; K1, K2 and K3 on their captured
    inputs against their plain versions; both steps' collective_stats
    and routes; timed synchronized a call and back to back, beside the
    single-card renders of the same frames.  Returns the figures and the
    `kernels` entries."""
    import torch
    import torch.distributed as dist
    from dataclasses import replace
    from libplacebo_tpu_torch import runtime
    from libplacebo_tpu_torch.core import film_grain as cfg
    from libplacebo_tpu_torch.ops import film_grain as ops_fg
    from libplacebo_tpu_torch.parallel import (build_sharded_pipeline,
                                               shard_planes,
                                               sharded_state_init)
    from libplacebo_tpu_torch.parallel.analysis import collective_stats
    from libplacebo_tpu_torch.render import renderer as trender

    mesh = runtime.create(device=dev).make_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1}, mesh.shape
    assert dist.get_backend(mesh.group) == "nccl"
    target = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    yuvs = _flagship_yuv(PATH_K_FRAMES, H, W, seed=PATH_K_SEED)
    figures, entries = {"path_k_mesh": mesh.shape}, []

    def batch(frames, c):
        """Call c's local plane blocks: frames 2c and 2c + 1."""
        return shard_planes(mesh, [torch.stack(
            [frames[2 * c + b].planes[i].data for b in range(2)])
            for i in range(len(frames[0].planes))])

    def counted(run, calls):
        for mod in counters.values():
            mod.launches = 0
        trender.k1_tails = trender.plain_tails = \
            trender.ineligible_tails = 0
        outs, ms = [], []
        for c in range(calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(run(c))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return outs, ms, {n: m.launches for n, m in counters.items()}, (
            trender.k1_tails, trender.plain_tails, trender.ineligible_tails)

    def window(run, calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for c in range(calls):
            run(c)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (2 * calls)

    def profile(fn):
        """Device kernels of one fn() call: launches, busy ms and the
        eight names with the most device time (ms)."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        by = {}
        for e in kern:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        return {"launches": len(kern),
                "busy_ms": sum(by.values()),
                "top_ms": sorted(by.items(), key=lambda kv: -kv[1])[:8]}

    def single_ms(renderers, frames, params):
        """Single-card renders of the same frames, each pair
        synchronized (ms a frame)."""
        ms = []
        for c in range(len(frames) // 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for b in range(2):
                renderers[b].render(frames[2 * c + b], target, params)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3 / 2)
        return ms

    # ---- the flagship on the halo step
    params = lt.RenderParams(upscaler="ewa_lanczos")
    frames = [_frame(lt, f, dev) for f in yuvs]
    f0 = frames[0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, target, params)
    assert step.route == "halo", (step.route, step.reason)
    calls = PATH_K_FRAMES // 2
    batches = [batch(frames, c) for c in range(calls)]
    step(sharded_state_init(mesh, 2), *batches[0])      # warm-up
    captured, real_k1 = [], k1.color_map_tail

    def cap_k1(img, plan, tone, lut):
        if len(captured) < 2:
            captured.append((img.clone(), plan, tone.clone()
                             if tone is not None else None, lut))
        return real_k1(img, plan, tone, lut)
    box = {"state": sharded_state_init(mesh, 2), "states": []}

    def run_halo(c):
        out, box["state"] = step(box["state"], *batches[c])
        box["states"].append(box["state"].clone())
        return out
    k1.color_map_tail = cap_k1
    try:
        outs, halo_ms, launches, tails = counted(run_halo, calls)
    finally:
        k1.color_map_tail = real_k1
    assert launches == {"k1": PATH_K_FRAMES, "k2": 0, "k3": 0}, launches
    assert tails == (PATH_K_FRAMES, 0, 0), tails
    lanes = [lt.Renderer(device=dev) for _ in range(2)]
    plain_lanes = [lt.Renderer(device=dev) for _ in range(2)]
    plain_params = replace(params, disable_fused_colormap=True)
    halo_gate, state_err = [], 0.0
    for c in range(calls):
        for b in range(2):
            ref = lanes[b].render(frames[2 * c + b], target, params)
            halo_gate.append(_path_k_gate(outs[c][b], ref))
            plain_lanes[b].render(frames[2 * c + b], target, plain_params)
            err = float((box["states"][c][b] -
                         plain_lanes[b]._peak_state).abs().max())
            assert err <= 1e-6, (c, b, err)
            state_err = max(state_err, err)
    del outs
    halo_stats = collective_stats(step, sharded_state_init(mesh, 2),
                                  *batches[0])
    box["state"] = sharded_state_init(mesh, 2)
    halo_window = window(lambda c: run_halo(c), calls)
    single_flag_ms = single_ms([lt.Renderer(device=dev) for _ in range(2)],
                               frames, params)
    # one call (two frames) profiled beside two single-card renders
    box["state"] = sharded_state_init(mesh, 2)
    halo_prof = profile(lambda: run_halo(1))
    single_r = [lt.Renderer(device=dev) for _ in range(2)]
    single_prof = profile(lambda: [single_r[b].render(frames[2 + b], target,
                                                      params)
                                   for b in range(2)])
    k1_args = captured[1]
    k1_err, k1_frac, k1_part = _check_k1(k1, k1_args)
    k1_ms = _cuda_ms(lambda: k1.color_map_tail(*k1_args), 20)
    k1_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        k1_args[0], k1_args[1].consts, *k1_args[2:], k1_args[1].instance), 3)
    entries.append(_k1_entry(k1, "k1_color_map_path_k_halo", k1_args,
                             k1_part, launches["k1"], k1_err, k1_ms,
                             k1_plain_ms))
    figures.update({
        "path_k_halo_route": [step.route, step.reason],
        "path_k_halo_frame_ms": statistics.median(halo_ms) / 2,
        "path_k_halo_call_ms_samples": halo_ms,
        "path_k_halo_window_ms": halo_window,
        "path_k_single_card_flagship_frame_ms":
            statistics.median(single_flag_ms),
        "path_k_halo_gate": halo_gate, "path_k_halo_state_err": state_err,
        "path_k_halo_collectives": halo_stats,
        "path_k_halo_launches": launches, "path_k_halo_tails": tails,
        "path_k_halo_profile_2_frames": halo_prof,
        "path_k_single_card_profile_2_frames": single_prof})
    del batches, captured, k1_args

    # ---- config 5 on the replicated step, a new grain seed a frame
    params5 = lt.RenderParams(upscaler="ewa_lanczos",
                              deband=lt.DebandParams(iterations=2),
                              film_grain=True,
                              error_diffusion="floyd-steinberg")
    frames5 = [_frame(lt, f, dev, cfg.sample_grain(GRAIN_SEED + 100 + i))
               for i, f in enumerate(yuvs[:PATH_K_CONFIG5_FRAMES])]
    metas = frames5[0].meta_key()[0]
    step5 = build_sharded_pipeline(mesh, metas, frames5[0].repr,
                                   frames5[0].color, target, params5,
                                   frame_grain=frames5[0].film_grain)
    assert step5.route == "replicated", (step5.route, step5.reason)
    cfgs, _ = lt.Renderer(device=dev)._grain_cfgs(
        metas, frames5[0].repr, frames5[0].film_grain)

    def grain_tables(c):
        """Call c's per-frame AV1 tables (made on the host every frame,
        as the single-card renderer makes them)."""
        return [tuple(ops_fg.prepare_av1_grain(
            frames5[2 * c + b].film_grain, g, m[0][-2], m[0][-1], dev)
            if g else None for g, m in zip(cfgs, metas)) for b in range(2)]
    calls5 = PATH_K_CONFIG5_FRAMES // 2
    batches5 = [batch(frames5, c) for c in range(calls5)]
    step5(sharded_state_init(mesh, 2), *batches5[0],
          grain_tables=grain_tables(0))                    # warm-up
    cap = {"k1": [], "k2": [], "k3": []}
    real = (k1.color_map_tail, k2.wavefront, k3.shear_to_colmaj,
            k3.unshear_from_colmaj)

    def cap1(img, plan, tone, lut):
        if len(cap["k1"]) < 2:
            cap["k1"].append((img.clone(), plan, tone.clone()
                              if tone is not None else None, lut))
        return real[0](img, plan, tone, lut)

    def cap2(colmaj, kernel, depth, w, h):
        if len(cap["k2"]) < 2:
            cap["k2"].append((colmaj.clone(), kernel, depth, w, h))
        return real[1](colmaj, kernel, depth, w, h)

    def cap3(forward):
        def run(x, w_out, s, w, h):
            if len(cap["k3"]) < 4:
                cap["k3"].append((x.clone(), w_out, s, w, h, forward))
            return real[2 if forward else 3](x, w_out, s, w, h)
        return run
    box5 = {"state": sharded_state_init(mesh, 2), "states": []}

    def run_rep(c):
        out, box5["state"] = step5(box5["state"], *batches5[c],
                                   grain_tables=grain_tables(c))
        box5["states"].append(box5["state"].clone())
        return out
    k1.color_map_tail, k2.wavefront = cap1, cap2
    k3.shear_to_colmaj, k3.unshear_from_colmaj = cap3(True), cap3(False)
    try:
        outs5, rep_ms, launches5, tails5 = counted(run_rep, calls5)
    finally:
        (k1.color_map_tail, k2.wavefront, k3.shear_to_colmaj,
         k3.unshear_from_colmaj) = real
    n5 = PATH_K_CONFIG5_FRAMES
    assert launches5 == {"k1": n5, "k2": n5, "k3": 2 * n5}, launches5
    assert tails5 == (n5, 0, 0), tails5
    lanes5 = [lt.Renderer(device=dev) for _ in range(2)]
    rep_gate = []
    for c in range(calls5):
        for b in range(2):
            ref = lanes5[b].render(frames5[2 * c + b], target, params5)
            rep_gate.append(_path_k_gate(outs5[c][b], ref))
            assert torch.equal(box5["states"][c][b], lanes5[b]._peak_state)
    del outs5
    rep_stats = collective_stats(step5, sharded_state_init(mesh, 2),
                                 *batches5[0], grain_tables=grain_tables(0))
    box5["state"] = sharded_state_init(mesh, 2)
    rep_window = window(lambda c: run_rep(c), calls5)
    single_c5_ms = single_ms([lt.Renderer(device=dev) for _ in range(2)],
                             frames5, params5)
    # K1 without dither, K2 and K3 on the replicated step's own inputs
    k1n = cap["k1"][1]
    k1n_err, _, k1n_part = _check_k1(k1, k1n)
    k1n_ms = _cuda_ms(lambda: k1.color_map_tail(*k1n), 20)
    k1n_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        k1n[0], k1n[1].consts, *k1n[2:], k1n[1].instance), 3)
    entries.append(_k1_entry(k1, "k1_color_map_no_dither_path_k_replicated",
                             k1n, k1n_part, launches5["k1"], k1n_err, k1n_ms,
                             k1n_plain_ms))
    entries += _k2_k3_entries(k2, k3, cap["k2"][1], cap["k3"][2:],
                              "path_k_replicated", launches5, 5)
    figures.update({
        "path_k_replicated_route": [step5.route, step5.reason],
        "path_k_replicated_frame_ms": statistics.median(rep_ms) / 2,
        "path_k_replicated_call_ms_samples": rep_ms,
        "path_k_replicated_window_ms": rep_window,
        "path_k_single_card_config5_frame_ms":
            statistics.median(single_c5_ms),
        "path_k_replicated_gate": rep_gate,
        "path_k_replicated_collectives": rep_stats,
        "path_k_replicated_launches": launches5,
        "path_k_replicated_tails": tails5})
    for r in (*lanes, *plain_lanes, *lanes5):
        assert r.get_errors() == (frozenset(), frozenset())
    mesh.close()
    assert not dist.is_initialized()
    return figures, entries


# path L: the port's demos and tools (libplacebo_tpu_torch/demos/,
# libplacebo_tpu_torch/tools/) driven through their main()s at full width
PATH_L_SEED = 7171
PATH_L_PLPLAY = ["--hdr", "--frames", "24", "--fps", "23.976",
                 "--vsync", "60", "--zoom", "pad"]


def _seeded_png(path, w, h, seed, alpha=False):
    """A seeded picture: a gradient with noise (RGB, or RGBA)."""
    from libplacebo_tpu_torch.utils.y4m import write_png
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    c = 4 if alpha else 3
    img = (np.stack([xx * 200.0 / w, yy * 200.0 / h,
                     (xx + yy) * 100.0 / (w + h)] +
                    ([np.full((h, w), 180.0)] if alpha else []), -1)
           + rng.uniform(0, 40, (h, w, c)))
    write_png(path, np.clip(img, 0, 255).astype(np.uint8))


def _y4m_planes(path):
    """A y4m file's frames as uint8 arrays (header, [frame bytes])."""
    data = open(path, "rb").read()
    head, body = data.split(b"\n", 1)
    return head, [np.frombuffer(f, np.uint8)
                  for f in body.split(b"FRAME\n")[1:]]


def path_l_phase(lt, dev, counters, k1, k2, k3):
    """Path L: every demo and tool of the port that renders on the card,
    called in-process through its main() with an argv, on seeded inputs
    written to a temporary directory.  Each is driven with the launch
    counts set to 0 just before and read just after:
      - plplay --hdr 1920x1080 -> 3840x2160 (padded to the target: a 2x
        upscale), 24 source frames at 23.976 fps on a 60 Hz display, 60
        vsyncs free-running; K1 (no dither) once a source frame; its fps,
        host-clocked and CUDA-event ms a vsync; then the same argv at
        96x64 -> 192x128 with --write-y4m on the card and on the CPU,
        the two clips held to the GPU-vs-CPU gate (mean < 1e-4, more than
        one LSB on <= 5e-4);
      - video_filtering on a seeded 1920x1080 PNG -> 3840x2160 PNG;
      - image_viewer on a seeded 3840x2160 PNG with an OSD and a .cube
        LUT -> 1920x1080, then again with path B's Display P3 ICC profile;
      - colors 3840x2160, 60 frames into a y4m (its codes made on the
        card), then at 64x48 on the card and on the CPU: the same bytes;
      - multichip_bench on the one-rank NCCL mesh, 1920x1080 -> 4K, 3
        iterations (its outputs held against the single-card Renderer);
      - bench_micro at 1920x1080 over every pass (a failed pass, one
        without a time, or one whose profiled device operations do not
        fit its time — bench_micro.profile_violations — fails the run):
        K1 on the flagship tail, K2 and K3 in the error-diffusion passes;
      - bench_playback (u8 and p010, 6 frames a mode) and
        profile_stages 8;
      - the multi-device tools on the card, one NCCL rank: option_sweep_
        parity on five keys (every row rendered and within its gate),
        multichip_perf on a 1x1 mesh and multihost_smoke as one process
        joined over TCP.
    K1 on plplay's first new frame, and K2 and K3 on bench_micro's first
    Floyd-Steinberg call, are held against their plain versions.
    Returns (figures, the kernels line's path L entries)."""
    import tempfile
    import torch
    from libplacebo_tpu_torch.demos import (colors, image_viewer,
                                            multichip_bench, plplay,
                                            video_filtering)
    from libplacebo_tpu_torch.tools import (bench_micro, bench_playback,
                                            multichip_perf, multihost_smoke,
                                            option_sweep_parity,
                                            profile_stages)
    from libplacebo_tpu_torch.utils.y4m import read_png

    t_path = time.perf_counter()
    figures, seconds, launches = {}, {}, {}
    cap = {"k1": None, "k2": None, "k3": []}
    real = (k1.color_map_tail, k2.wavefront, k3.shear_to_colmaj,
            k3.unshear_from_colmaj)

    def cap_k1(img, plan, tone, lut):
        if cap["k1"] is None:
            cap["k1"] = (img.clone(), plan, tone.clone()
                         if tone is not None else None, lut)
        return real[0](img, plan, tone, lut)

    def cap_k2(colmaj, kernel, depth, w, h):
        if cap["k2"] is None:
            cap["k2"] = (colmaj.clone(), kernel, depth, w, h)
        return real[1](colmaj, kernel, depth, w, h)

    def cap_k3(forward):
        def run(x, w_out, s, w, h):
            if not any(c[5] == forward for c in cap["k3"]):
                cap["k3"].append((x.clone(), w_out, s, w, h, forward))
            return real[2 if forward else 3](x, w_out, s, w, h)
        return run

    def driven(name, fn):
        """fn() with every launch count set to 0 just before and read
        just after; its seconds kept."""
        for mod in counters.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = {n: m.launches for n, m in counters.items()}
        return res

    with tempfile.TemporaryDirectory() as tmp:
        def p(name):
            return os.path.join(tmp, name)
        _seeded_png(p("in1080.png"), 1920, 1080, PATH_L_SEED)
        _seeded_png(p("in2160.png"), 3840, 2160, PATH_L_SEED + 1)
        _seeded_png(p("osd.png"), 256, 96, PATH_L_SEED + 2, alpha=True)
        with open(p("creative.cube"), "w") as f:
            f.write(creative_cube(17))
        with open(p("p3.icc"), "wb") as f:
            f.write(display_p3_profile())

        # plplay at full width (K1 captured on its first new frame)
        k1.color_map_tail = cap_k1
        try:
            st = driven("plplay", lambda: plplay.main(
                PATH_L_PLPLAY + ["--size", "1920x1080", "--out",
                                 "3840x2160"]))
        finally:
            k1.color_map_tail = real[0]
        assert st["rendered"] == 60, st
        assert launches["plplay"] == st["launches"], (launches, st)
        assert launches["plplay"]["k1"] >= 24 and \
            launches["plplay"]["k2"] == launches["plplay"]["k3"] == 0, \
            launches["plplay"]
        figures["path_l_plplay"] = st
        # the same argv small, on the card and on the CPU
        for d in ("cuda", "cpu"):
            plplay.main(PATH_L_PLPLAY + ["--size", "96x64", "--out",
                                         "192x128", "--device", d,
                                         "--write-y4m", p(f"pl_{d}.y4m")])
        hg, fg = _y4m_planes(p("pl_cuda.y4m"))
        hc, fc = _y4m_planes(p("pl_cpu.y4m"))
        assert hg == hc and len(fg) == len(fc) == 60, (hg, hc, len(fg))
        d = np.abs(np.stack(fg).astype(np.int32)
                   - np.stack(fc).astype(np.int32))
        small = {"max_codes": int(d.max()), "mean": float(d.mean()) / 255,
                 "above_1lsb": float((d > 1).mean())}
        assert small["mean"] < 1e-4 and small["above_1lsb"] <= 5e-4, small
        figures["path_l_plplay_small_gate"] = small

        # video_filtering and image_viewer (PNG in, PNG out)
        res = driven("video_filtering", lambda: video_filtering.main(
            ["--input", p("in1080.png"), "--out", "3840x2160",
             "--output", p("vf.png")]))
        out = read_png(p("vf.png"))
        assert out.shape == (3, 2160, 3840) and res["frames"] == 1, \
            out.shape
        for icc in (False, True):
            name = "image_viewer_icc" if icc else "image_viewer"
            driven(name, lambda icc=icc: image_viewer.main(
                [p("in2160.png"), "--osd", p("osd.png"), "--lut",
                 p("creative.cube"), "--out", "1920x1080", "--output",
                 p(f"{name}.png")] + (["--icc", p("p3.icc")] if icc
                                      else [])))
            out = read_png(p(f"{name}.png"))
            assert out.shape[-2:] == (1080, 1920), out.shape
            assert np.isfinite(out).all() and out[:3].std() > 0.05

        # colors: 60 frames of 4K into a y4m
        driven("colors", lambda: colors.main(
            ["--size", "3840x2160", "--frames", "60", "--write-y4m",
             p("colors.y4m")]))
        head, frames_c = _y4m_planes(p("colors.y4m"))
        assert head.startswith(b"YUV4MPEG2 W3840 H2160") and \
            len(frames_c) == 60 and \
            frames_c[0].size == 3 * 3840 * 2160, (head, len(frames_c))
        del frames_c
        for d in ("cuda", "cpu"):
            colors.main(["--size", "64x48", "--frames", "60", "--device", d,
                         "--write-y4m", p(f"colors_{d}.y4m")])
        with open(p("colors_cuda.y4m"), "rb") as fg, \
                open(p("colors_cpu.y4m"), "rb") as fc:
            assert fg.read() == fc.read(), "colors: card vs CPU bytes"

    # multichip_bench on the one-rank NCCL mesh
    rows = driven("multichip_bench", lambda: multichip_bench.main(
        ["--size", "1920x1080", "--iters", "3"]))
    assert len(rows) == 1 and rows[0]["route"] == "halo", rows
    assert launches["multichip_bench"]["k1"] >= 3, launches
    figures["path_l_multichip_bench"] = rows[0]

    # bench_micro over every pass (K2, K3 captured on the first FS call)
    os.makedirs("chiprun_out", exist_ok=True)
    bm_json = os.path.join("chiprun_out", "bench_micro_h100.json")
    k2.wavefront = cap_k2
    k3.shear_to_colmaj, k3.unshear_from_colmaj = cap_k3(True), cap_k3(False)
    try:
        rc = driven("bench_micro", lambda: bench_micro.main(
            ["--size", "1920x1080", "--json", bm_json]))
    finally:
        k2.wavefront, k3.shear_to_colmaj, k3.unshear_from_colmaj = \
            real[1:]
    with open(bm_json) as f:
        bm = json.load(f)
    untimed = [n for n, v in bm["passes"].items()
               if not (v.get("ms") or 0) > 0]
    assert rc == 0 and not bm["failed"] and not untimed, \
        (rc, bm["failed"], untimed)
    bad = bench_micro.profile_violations(bm["passes"])
    assert not bad, bad
    assert all(launches["bench_micro"][n] > 0 for n in counters), launches

    # bench_playback and profile_stages
    pb_json = os.path.join("chiprun_out", "bench_playback_h100.json")
    assert driven("bench_playback", lambda: bench_playback.main(
        ["--frames", "6", "--out", pb_json])) == 0
    with open(pb_json) as f:
        figures["path_l_bench_playback"] = json.load(f)["formats"]
    assert driven("profile_stages", lambda: profile_stages.main(
        ["8"])) == 0

    # the multi-device tools on the card: one NCCL rank
    sweep_json = os.path.join("chiprun_out", "option_sweep_h100.json")
    assert driven("option_sweep_parity", lambda: option_sweep_parity.main(
        ["--keys", "deband,upscaler,dither,error_diffusion,peak_detect",
         "--out", sweep_json])) == 0
    with open(sweep_json) as f:
        sweep = json.load(f)
    assert sweep["summary"]["device"].startswith("cuda") and \
        all(r["status"] == "ok" for r in sweep["rows"]), sweep["summary"]
    mcp_json = os.path.join("chiprun_out", "multichip_perf_h100.json")
    assert driven("multichip_perf", lambda: multichip_perf.main(
        ["--mesh", "1x1", "--out", mcp_json])) == 0
    with open(mcp_json) as f:
        mcp = json.load(f)
    assert mcp["device"].startswith("cuda") and \
        set(mcp["routes"].values()) == {"halo"}, mcp["routes"]
    assert driven("multihost_smoke", lambda: multihost_smoke.main(
        ["--procs", "1"])) == 0
    figures["path_l_option_sweep"] = [
        (r["keys"], r["values"], r["route"], r["diff_mean"])
        for r in sweep["rows"]]
    figures["path_l_multichip_perf_1x1"] = mcp["configs"]

    # K1 on plplay's first new frame, K2 and K3 on bench_micro's first
    # Floyd-Steinberg call, against their plain versions
    k1_args = cap["k1"]
    k1_err, k1_frac, k1_part = _check_k1(k1, k1_args)
    k1_ms = _cuda_ms(lambda: k1.color_map_tail(*k1_args), 20)
    k1_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        k1_args[0], k1_args[1].consts, *k1_args[2:], k1_args[1].instance), 2)
    assert len(cap["k3"]) == 2, len(cap["k3"])
    ed_entries = _k2_k3_entries(k2, k3, cap["k2"], cap["k3"], "path_l",
                                launches["bench_micro"], 20)
    figures.update({
        "path_l_seconds": time.perf_counter() - t_path,
        "path_l_seconds_by_program": seconds,
        "path_l_launches": launches,
        "path_l_bench_micro_ms": {n: v["ms"] for n, v in
                                  bm["passes"].items()},
        "k1_path_l_differing_fraction": k1_frac})
    entries = [
        _k1_entry(k1, "k1_color_map_no_dither_path_l", k1_args, k1_part,
                  launches["plplay"]["k1"], k1_err, k1_ms, k1_plain_ms),
        *ed_entries]
    return figures, entries


# the K1 tails chip_smoke holds on the generic instance beside path A's:
# name -> (source (primaries, transfer, max nits or 0), target (primaries,
# transfer, max nits or 0), RenderParams fields, bit depth, target
# (system, levels) or None)
GENERIC_CASES = {
    "static_st2094_40": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                         dict(tone_mapping_function="st2094-40",
                              peak_detect=None), 8, None),
    "static_hable": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                     dict(tone_mapping_function="hable", peak_detect=None,
                          gamut_mapping="clip"), 8, None),
    "same_frame_bt2390_softclip": (
        ("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
        dict(tone_mapping_function="bt2390", gamut_mapping="softclip",
             peak_detect="same_frame"), 8, None),
    "gamut_relative": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                       dict(gamut_mapping="relative"), 8, None),
    "gamut_absolute": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                       dict(gamut_mapping="absolute"), 8, None),
    "gamut_highlight": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                        dict(gamut_mapping="highlight"), 8, None),
    "target_hlg": (("bt.2020", "pq", 1000.0), ("bt.2020", "hlg", 0), {}, 10,
                   None),
    "target_bt1886_ycbcr": (("bt.2020", "pq", 1000.0),
                            ("bt.709", "bt.1886", 0), {}, 10,
                            ("bt.709", "limited")),
    "encode_ictcp": (("bt.2020", "pq", 1000.0), ("bt.2020", "pq", 600.0),
                     dict(tone_mapping_function="bt2446a"), 10,
                     ("bt.2100-pq", "limited")),
    "white_noise": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                    dict(dither="white"), 8, None),
    "show_clipping": (("bt.2020", "pq", 1000.0), ("bt.709", "srgb", 0),
                      dict(show_clipping=True), 8, None),
    "low_depth_gamma": (("bt.709", "bt.1886", 0), ("bt.709", "srgb", 0),
                        {}, 3, None),
}


def _csp(lt, prim, trc, nits):
    return lt.ColorSpace(lt.ColorPrimaries(prim), lt.ColorTransfer(trc),
                         lt.HdrMetadata(min_luma=0.005, max_luma=nits)
                         if nits else lt.HdrMetadata())


def _generic_args(lt, k1, trender, case, W, H, dev, noise):
    """(img, plan, tone, bias) of a generic case's K1 tail at W x H on
    seeded linear light (to 30 for an HDR source, 1.2 for SDR)."""
    import torch
    from libplacebo_tpu_torch.core import colorspace as tcs
    from libplacebo_tpu_torch.core.common import RectF
    from libplacebo_tpu_torch.ops import tone_dynamic as ops_tone
    src, dst, kw, bits, rep = GENERIC_CASES[case]
    kw = dict(kw)
    if kw.get("dither") == "white":
        kw["dither"] = lt.DitherParams(method=lt.DitherMethod.WHITE_NOISE)
    if kw.get("peak_detect") == "same_frame":
        kw["peak_detect"] = lt.PeakDetectParams(allow_delayed=False)
    params = lt.RenderParams(**kw)
    s, d = tcs.color_space_infer_map(_csp(lt, *src), _csp(lt, *dst))
    target = lt.Target(
        w=W, h=H, color=_csp(lt, *dst), bit_depth=bits,
        repr=lt.ColorRepr(sys=lt.ColorSystem(rep[0]),
                          levels=lt.ColorLevels(rep[1])) if rep else
        lt.Target(w=1, h=1).repr)
    use_peak = (params.peak_detect is not None and s.is_hdr() and
                params.tone_mapping_function in
                ("spline", "bt2390", "st2094-40", "st2094-10"))
    run = lt.Renderer(device=dev)._fused_tail(params, s, d, target, use_peak,
                                              W, H, RectF(0, 0, W, H))
    assert run is not None and run.plan.tone == k1.GENERIC, case
    chain = trender.color_chain(s, d, params, use_peak)
    tone = ops_tone.tone_vector(
        params.tone_mapping_function, torch.tensor(0.72, device=dev),
        torch.tensor(0.3, device=dev), chain.dst_min_pq, chain.dst_max_pq,
        params.tone_constants) if run.plan.generic.dynamic else None
    return (noise * (30.0 if s.is_hdr() else 1.2), run.plan, tone, run.lut)


def _check_generic(k1, args):
    """The generic instance vs its plain version (the port's stages):
    bit for bit, partials' histograms equal, sums rtol 1e-5."""
    import torch
    out_k, part_k = k1.color_map_tail(*args)
    out_p, part_p = k1.tail_plain(*args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    assert torch.equal(out_k, out_p), err
    assert (part_k is None) == (part_p is None)
    if part_k is not None:
        assert torch.equal(part_k[:, 0, :64], part_p[:, 0, :64])
        torch.testing.assert_close(part_k[:, 1, :3], part_p[:, 1, :3],
                                   rtol=1e-5, atol=0.0)
    return err, part_k


def _k1_generic_table(lt, k1, trender, W, H, dev):
    """Every generic case at W x H: held against its plain version (bit
    for bit), timed with it, its operations a pixel and its bounds."""
    import torch
    from libplacebo_tpu_torch.tools.bench_micro import k1_bound
    gen = torch.Generator(device=dev).manual_seed(29)
    noise = torch.rand((3, H, W), device=dev, generator=gen)
    table = {}
    for case in GENERIC_CASES:
        args = _generic_args(lt, k1, trender, case, W, H, dev, noise)
        err, part = _check_generic(k1, args)
        ops = k1.ops_per_pixel(args[1].consts, args[1].instance)
        bound, by = k1_bound(*args, part, ops)
        table[case] = {
            "mode": args[1].generic.mode._asdict(), "max_abs_err": err,
            "ops_per_pixel": ops, "bound_ms": bound, "bound_by": by,
            "ms": _cuda_ms(lambda: k1.color_map_tail(*args), 10),
            "plain_ms": _cuda_ms(lambda: k1.tail_plain(*args), 2)}
        del args
    return table


def _gather_shear(x, w_out, s, W, H, forward):
    """K3's function as one torch.gather over the source with one zero
    column appended, its index built beforehand (set-up, not timed)."""
    import torch
    w_in, C, Hp = x.shape
    src = torch.arange(w_out, device=x.device)[:, None] + \
        (-s if forward else s) * torch.arange(Hp, device=x.device)[None, :]
    if forward:
        valid = (src >= 0) & (src < W)
    else:
        valid = torch.arange(w_out, device=x.device)[:, None] < W
    valid = valid & (torch.arange(Hp, device=x.device)[None, :] < H)
    idx = torch.where(valid, src, w_in)[:, None, :].expand(
        w_out, C, Hp).contiguous()
    xz = torch.cat([x, torch.zeros_like(x[:1])])
    return lambda: torch.gather(xz, 0, idx)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch import _sass, native
    from libplacebo_tpu_torch._build import build_all, build_log
    from libplacebo_tpu_torch.core import dither as cdither
    from libplacebo_tpu_torch.core import filters as flt
    from libplacebo_tpu_torch.core import film_grain as cfg
    from libplacebo_tpu_torch.core.common import RectF
    from libplacebo_tpu_torch.ops import deband as ops_deband
    from libplacebo_tpu_torch.ops import dithering as ops_dither
    from libplacebo_tpu_torch.ops import film_grain as ops_fg
    from libplacebo_tpu_torch.ops import polar
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    from libplacebo_tpu_torch.ops.cuda import error_diffusion as k2
    from libplacebo_tpu_torch.ops.cuda import shear as k3
    from libplacebo_tpu_torch.render import renderer as trender
    from libplacebo_tpu_torch.tools.bench_micro import bound_ms
    from libplacebo_tpu_torch.tools.bench_micro import k2_bound as k2_bound_of
    from libplacebo_tpu_torch.tools.bench_micro import k3_bytes as bm_k3_bytes

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    counters = {"k1": k1, "k2": k2, "k3": k3}

    # 1. build: one compiler process per library, all started together
    t0 = time.perf_counter()
    build_all([*k1.build_specs(), k2.build_spec(), k3.build_spec(),
               *native.build_specs()])
    cdither.blue_noise(6)
    cfg.generate_offsets(GRAIN_SEED, 1, 1)
    build_s = time.perf_counter() - t0
    ptxas = {n: build_log(m.build()) for n, m in counters.items()}
    k1_libs = k1.libraries()
    ptxas.update({f"k1_tone{t}": build_log(lib) for t, lib in k1_libs.items()
                  if t != 1})
    ptxas_lines = {n: [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
                   for n, log in ptxas.items()}
    # K1's shape: the pixel loop's instruction mix, read from the SASS
    # (cuobjdump from the toolkit or from Triton's package; none = fail)
    k1_sass_text = _sass.disassemble(k1.build()._name)
    k1_report = _sass.ptxas_report(ptxas["k1"])
    k1_sass, k1_ptxas = {}, {}
    for variant, inst in (("dither", k1.instance_name(1, 2, True)),
                          ("no_dither", k1.instance_name(1, 2, False))):
        k1_sass[variant] = _sass.loop_mix(k1_sass_text, inst)
        # one pixel an iteration: the count is a pixel's only without a
        # loop inside the pixel loop
        assert not k1_sass[variant]["inner_loops"], k1_sass[variant]
        report = [v for n, v in k1_report.items() if inst in n]
        assert len(report) == 1, k1_report
        k1_ptxas[variant] = report[0]
    # the instances of config 4 and config 2 (softclip's sincos keeps a
    # range-reduction loop on its slow path, which |delta| < pi never
    # takes; the count is of the fast path)
    for variant, (tone, gamut) in (("config4", (2, 3)), ("config2", (0, 0))):
        inst = k1.instance_name(tone, gamut, True)
        k1_sass[variant] = _sass.loop_mix(
            _sass.disassemble(k1_libs[tone]._name), inst)
        report = [v for n, v in _sass.ptxas_report(
            build_log(k1_libs[tone])).items() if inst in n]
        assert len(report) == 1
        k1_ptxas[variant] = report[0]

    # 2. the flagship path: 3 chained frames on the card
    H, W = 1080, 1920
    npix = 2 * H * 2 * W
    target = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    params = lt.RenderParams(upscaler="ewa_lanczos")
    yuvs = _flagship_yuv(3, H, W)
    frames = [_frame(lt, f, dev) for f in yuvs]
    captured = {"k1": [], "k2": [], "k3": [], "ewa": []}
    real = {"k1": k1.color_map_tail, "k2": k2.wavefront,
            "k3f": k3.shear_to_colmaj, "k3i": k3.unshear_from_colmaj,
            "ewa": polar.sample_polar}

    # at most this many K1 inputs kept (None: all): path G keeps two, so
    # its timed vsyncs copy no frame
    k1_keep = [None]

    def cap_k1(img, plan, tone, lut):
        if k1_keep[0] is None or len(captured["k1"]) < k1_keep[0]:
            captured["k1"].append((img.clone(), plan, tone.clone()
                                   if tone is not None else None, lut))
        return real["k1"](img, plan, tone, lut)

    def cap_k2(colmaj, kernel, depth, w, h):
        captured["k2"].append((colmaj.clone(), kernel, depth, w, h))
        return real["k2"](colmaj, kernel, depth, w, h)

    def cap_k3(forward):
        def run(x, w_out, s, w, h):
            captured["k3"].append((x.clone(), w_out, s, w, h, forward))
            return real["k3f" if forward else "k3i"](x, w_out, s, w, h)
        return run

    def cap_ewa(img, cfg, dst_h, dst_w, rect=None, antiring=0.0):
        captured["ewa"].append((img.clone(), cfg, dst_h, dst_w, rect,
                                antiring))
        return real["ewa"](img, cfg, dst_h, dst_w, rect, antiring)

    k1.color_map_tail = cap_k1
    k2.wavefront = cap_k2
    k3.shear_to_colmaj = cap_k3(True)
    k3.unshear_from_colmaj = cap_k3(False)
    renderer = lt.Renderer(device=dev)
    params4 = lt.RenderParams(upscaler="ewa_lanczos",
                              tone_mapping_function="bt2390",
                              gamut_mapping="softclip")
    params2 = lt.RenderParams()
    params3 = lt.RenderParams(upscaler="ewa_lanczos4sharpest",
                              antiringing_strength=0.8)
    yuvs4 = _flagship_yuv(3, H, W, bits=10)
    frames4 = [_frame(lt, f, dev, config="config4") for f in yuvs4]
    frames2 = [_frame(lt, f, dev, config="config2") for f in yuvs]
    try:
        outs, flag_launches, flag_tails = _render_run(
            renderer, frames, target, params, counters)
        flag_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 4. the config-5 path: the same frames with film grain
        params5 = lt.RenderParams(upscaler="ewa_lanczos",
                                  deband=lt.DebandParams(iterations=2),
                                  film_grain=True,
                                  error_diffusion="floyd-steinberg")
        frames5 = [_frame(lt, f, dev, cfg.sample_grain(GRAIN_SEED + i))
                   for i, f in enumerate(yuvs)]
        renderer5 = lt.Renderer(device=dev)
        t = time.perf_counter()
        outs5, c5_launches, c5_tails = _render_run(
            renderer5, frames5, target, params5, counters)
        c5_first_s = time.perf_counter() - t
        captured["c5_k1"] = captured["k1"][1]
        captured["k1"].clear()
        # 7. config 4 and config 2's color path
        renderer4, renderer2 = lt.Renderer(device=dev), lt.Renderer(device=dev)
        outs4, c4_launches, c4_tails = _render_run(
            renderer4, frames4, target, params4, counters)
        c4_k1 = captured["k1"][1]
        captured["k1"].clear()
        outs2, c2_launches, c2_tails = _render_run(
            renderer2, frames2, target, params2, counters)
        c2_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 8. config 3: config 2's frames through the anti-ringing EWA
        renderer3 = lt.Renderer(device=dev)
        polar.sample_polar = cap_ewa
        outs3, c3_launches, c3_tails = _render_run(
            renderer3, frames2, target, params3, counters)
        c3_k1, c3_ewa = captured["k1"][1], captured["ewa"][1]
        captured["k1"].clear()
        polar.sample_polar = real["ewa"]
        # 10. path A: HLG broadcast on a 600-nit PQ display (config 4's
        # 10-bit content as HLG)
        colA, repA, bitsA, targetA, paramsA = path_cell(lt, "A", 2 * W,
                                                        2 * H)
        framesA = [_frame_cell(lt, f, dev, colA, repA, bitsA)
                   for f in yuvs4]
        rendererA = lt.Renderer(device=dev)
        outsA, pa_launches, pa_tails = _render_run(
            rendererA, framesA, targetA, paramsA, counters)
        pa_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 11. path B: config 2's SDR frames on a calibrated Display P3
        # monitor (ICC profile) with a native 33^3 LUT
        colB, repB, bitsB, targetB, paramsB = path_cell(lt, "B", 2 * W,
                                                        2 * H)
        framesB = [_frame_cell(lt, f, dev, colB, repB, bitsB) for f in yuvs]
        rendererB = lt.Renderer(device=dev)
        outsB, pb_launches, pb_tails = _render_run(
            rendererB, framesB, targetB, paramsB, counters)
        # 13. path C: Dolby Vision profile 5, a new RPU parsed each frame
        yuvsC = path_c_yuv(3, H, W)
        framesC = [path_c_frame(lt, f, b, dev)
                   for f, b in zip(yuvsC, path_c_rpus(lt, 3))]
        rendererC = lt.Renderer(device=dev)
        outsC, pc_launches, pc_tails = _render_run(
            rendererC, framesC, target, params, counters)
        pc_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 14. path D: 1080i with an H.274 SEI, each source frame's top
        # then bottom field with its neighbors
        paramsD = path_d_params(lt)
        sourcesD = path_d_sources(lt, _flagship_yuv(8, H, W, seed=13), dev)
        fieldsD = [path_d_field(lt, sourcesD, k, fld) for k in (1, 2)
                   for fld in ("TOP", "BOTTOM")]
        rendererD = lt.Renderer(device=dev)
        outsD, pd_launches, pd_tails = _render_run(
            rendererD, fieldsD, target, paramsD, counters)
        pd_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 15. the distortion phase: config 2's frames rotated at 4K
        paramsX = distort_params(lt)
        rendererX = lt.Renderer(device=dev)
        outsX, px_launches, px_tails = _render_run(
            rendererX, frames2, target, paramsX, counters)
        # 16. path E: a 23.976 fps HDR film with subtitles and an OSD on
        # a 60 Hz display with frame interpolation, a FrameMix a vsync
        paramsE = path_e_params(lt)
        framesE = path_e_frames(lt, _flagship_yuv(12, H, W, seed=17,
                                                  bits=10), dev, 2 * W)
        rendererE = lt.Renderer(device=dev)
        outsE, pe_launches, pe_tails, pe_hits = _mix_run(
            rendererE, framesE, target, paramsE, counters, range(10), lt)
        pe_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 17. path F: a 2.39:1 HDR10 film letterboxed on a 4K display,
        # HIGH_QUALITY_PARAMS
        colF, repF, bitsF, targetF, paramsF = path_f_cell(lt, 2 * W, 2 * H,
                                                          280)
        framesF = [_frame_cell(lt, f, dev, colF, repF, bitsF)
                   for f in _flagship_yuv(3, 800, W, seed=19, bits=10)]
        rendererF = lt.Renderer(device=dev)
        outsF, pf_launches, pf_tails = _render_run(
            rendererF, framesF, targetF, paramsF, counters)
        # 18. path G: a player's loop — the user's option string, a
        # decoder thread push_blocking lazy source frames (10-bit HDR10,
        # 23.976 fps) from pinned memory into the frame queue, a queue
        # update and render_image_mix a vsync at 60 Hz, telemetry on.
        # A warm-up on another renderer first (plans and caches shared
        # by every renderer), then the counted run: vsyncs 0-29 each
        # synchronized, 30-59 back to back between two CUDA events
        paramsG = path_g_params(lt)
        yuvsG = _flagship_yuv(24, H, W, seed=23, bits=10)
        path_g_play(lt, lt.Renderer(device=dev),
                    PathGDecoder(lt, yuvsG[:4], dev), target, paramsG,
                    range(4), threaded=False)
        captured["k1"].clear()
        decoderG = PathGDecoder(lt, yuvsG, dev)
        rendererG = lt.Renderer(device=dev)
        rendererG.telemetry = lt.Telemetry()
        pg = {"ms": [], "outs": {}, "refs": 0, "t": None,
              "start": torch.cuda.Event(enable_timing=True),
              "end": torch.cuda.Event(enable_timing=True)}

        def on_vsync_g(v, status, mix, out):
            if mix is not None:
                pg["refs"] += len(mix.frames)
            if v % 10 == 9 and out is not None:
                pg["outs"][v] = out
            if v < 30:
                torch.cuda.synchronize()
                now = time.perf_counter()
                if pg["t"] is not None:
                    pg["ms"].append((now - pg["t"]) * 1e3)
                pg["t"] = now
                if v == 29:
                    pg["start"].record()
            elif v == 59:
                pg["end"].record()
        k1_keep[0] = 2
        for mod in counters.values():
            mod.launches = 0
        trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
        pg_statuses = path_g_play(lt, rendererG, decoderG, target, paramsG,
                                  range(60), on_vsync=on_vsync_g)
        torch.cuda.synchronize()
        pg_launches = {n: m.launches for n, m in counters.items()}
        pg_tails = (trender.k1_tails, trender.plain_tails,
                    trender.ineligible_tails)
        pg_frames = dict(decoderG.counts)
        k1_keep[0] = None
        pg_k1 = captured["k1"][1]
        captured["k1"].clear()
        # 19. path H: config 5 with user hooks (a LUMA_INPUT doubler, a
        # PRE_OUTPUT auto-exposure with carried state), 8 frames
        hooksH, _ = path_h_hooks(lt, dev)
        paramsH = path_h_params(lt, hooksH)
        yuvsH = _flagship_yuv(8, H, W, seed=29)
        framesH = [_frame(lt, f, dev, cfg.sample_grain(GRAIN_SEED + 100 + i))
                   for i, f in enumerate(yuvsH)]
        rendererH = lt.Renderer(device=dev)
        k2_at, k3_at = len(captured["k2"]), len(captured["k3"])
        outsH, ph_launches, ph_tails = _render_run(
            rendererH, framesH, target, paramsH, counters)
        ph_k2 = captured["k2"][k2_at + 2]
        ph_k3 = captured["k3"][k3_at + 4:k3_at + 6]
        del captured["k2"][k2_at:], captured["k3"][k3_at:]
    finally:
        polar.sample_polar = real["ewa"]
        k1.color_map_tail = real["k1"]
        k2.wavefront = real["k2"]
        k3.shear_to_colmaj = real["k3f"]
        k3.unshear_from_colmaj = real["k3i"]
    assert flag_launches == {"k1": 3, "k2": 0, "k3": 0}, flag_launches
    assert c5_launches == {"k1": 3, "k2": 3, "k3": 6}, c5_launches
    assert c4_launches == {"k1": 3, "k2": 0, "k3": 0}, c4_launches
    assert c2_launches == {"k1": 3, "k2": 0, "k3": 0}, c2_launches
    assert c3_launches == {"k1": 3, "k2": 0, "k3": 0}, c3_launches
    assert pa_launches == {"k1": 3, "k2": 0, "k3": 0}, pa_launches
    assert pb_launches == {"k1": 0, "k2": 0, "k3": 0}, pb_launches
    assert pc_launches == {"k1": 3, "k2": 0, "k3": 0}, pc_launches
    assert pd_launches == {"k1": 4, "k2": 0, "k3": 0}, pd_launches
    assert px_launches == {"k1": 0, "k2": 0, "k3": 0}, px_launches
    # path E: one K1 launch a new source frame (frames 0-4 over vsyncs
    # 0-9), the rest mix-cache hits; path F: the tail plain, as in the
    # reference (a target crop, contrast recovery): counted ineligible
    assert pe_launches == {"k1": 5, "k2": 0, "k3": 0}, pe_launches
    assert pe_tails == (5, 0, 0) and pe_hits == 15, (pe_tails, pe_hits)
    assert len(rendererE._cache) == 1
    assert (pe_k1[1].tone, pe_k1[1].gamut) == (1, 2) and \
        pe_k1[2] is not None and pe_k1[3] is None
    assert pf_launches == {"k1": 0, "k2": 0, "k3": 0}, pf_launches
    assert pf_tails == (0, 0, 3), pf_tails
    # path G: every vsync emitted a mix; each source frame shown was
    # mapped once and rendered once on K1 (<spline, perceptual> without
    # dither), the rest of each mix from the mix cache; the queue's reset
    # unmapped every mapped frame and discarded the rest unseen
    from collections import Counter
    pg_status_count = {st.value: n for st, n in Counter(pg_statuses).items()}
    assert pg_status_count == {"ok": 60}, pg_status_count
    pg_hits = pg["refs"] - pg_tails[0]
    assert pg_launches["k2"] == pg_launches["k3"] == 0, pg_launches
    assert pg_launches["k1"] == pg_tails[0] == pg_frames["map"] \
        and pg_tails[1:] == (0, 0), (pg_launches, pg_tails, pg_frames)
    assert 20 <= pg_tails[0] <= 24 and pg_hits > 0, (pg_tails, pg_hits)
    assert pg_frames["unmap"] == pg_frames["map"] and \
        pg_frames["map"] + pg_frames["discard"] == 24, pg_frames
    assert len(rendererG._cache) == 1
    assert (pg_k1[1].tone, pg_k1[1].gamut) == (1, 2) and \
        pg_k1[2] is not None and pg_k1[3] is None
    assert paramsG.frame_mixer == "mitchell_clamp" and \
        paramsG.upscaler == "ewa_lanczos"
    # path H: the hooked tail plain, as in the reference (counted
    # ineligible), then K2 and K3 a frame; one plan for the 8 frames
    # (the auto-exposure's state is frame data)
    assert ph_launches == {"k1": 0, "k2": 8, "k3": 16}, ph_launches
    assert ph_tails == (0, 0, 8), ph_tails
    assert len(rendererH._cache) == 1
    for out in list(pg["outs"].values()) + outsH:
        assert tuple(out.shape) == (3, 2 * H, 2 * W), out.shape
        assert bool(torch.isfinite(out).all())
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
        codes = out * 255.0
        assert float((codes - torch.round(codes)).abs().max()) <= 255e-6
    assert sorted(pg["outs"]) == [9, 19, 29, 39, 49, 59]
    # every tail of every path ran on K1, but path B's, which the
    # reference runs plain too (an ICC target)
    for tails in (flag_tails, c5_tails, c4_tails, c2_tails, c3_tails,
                  pa_tails, pc_tails):
        assert tails == (3, 0, 0), tails
    assert pd_tails == (4, 0, 0), pd_tails
    assert pb_tails == (0, 0, 3) and px_tails == (0, 0, 3), \
        (pb_tails, px_tails)
    # path C: one plan for every RPU (the coefficients are frame data),
    # the flagship's <spline, perceptual> instance with dither; path D:
    # one plan a field, the pass-through instance with dither
    assert len(rendererC._cache) == 1 and len(rendererD._cache) == 2
    assert (pc_k1[1].tone, pc_k1[1].gamut) == (1, 2) and \
        pc_k1[2] is not None and pc_k1[3] is not None
    assert (pd_k1[1].tone, pd_k1[1].gamut, pd_k1[1].flags) == (0, 0, 0) \
        and pd_k1[2] is None and pd_k1[3] is not None
    # path A as the reference plans it: the HLG source adapts to the
    # display's peak (color_space_infer_map), so no tone curve runs and
    # the tail is the pass-through chain into a PQ target
    pa_mode = pa_k1[1].generic.mode
    assert pa_k1[1].tone == k1.GENERIC and pa_mode.kind == 0 and \
        pa_mode.tone_kind == 0 and k1.G_TRCS[pa_mode.trc] == "pq" and \
        k1.G_DITHER[pa_mode.dither] == "lut" and pa_k1[2] is None
    assert (c4_k1[1].tone, c4_k1[1].gamut) == (2, 3) and \
        c4_k1[1].flags == k1.FLAG_HUESHIFT and c4_k1[3] is not None
    assert (c2_k1[1].tone, c2_k1[1].gamut, c2_k1[1].flags) == (0, 0, 0) \
        and c2_k1[2] is None and c2_k1[3] is not None
    assert (c3_k1[1].tone, c3_k1[1].gamut, c3_k1[1].flags) == (0, 0, 0) \
        and c3_k1[2] is None and c3_k1[3] is not None
    # the main scaler ran the phased path with the strength asked for
    ewa_key = (c3_ewa[1], H, W, 2 * H, 2 * W, RectF(0, 0, W, H), 0.8)
    assert c3_ewa[1].name == "ewa_lanczos4sharpest" and c3_ewa[5] == 0.8
    assert polar._route(polar.plan_polar(*ewa_key[:6]), 2 * H, 2 * W,
                        0.8) == "phased"
    for out in (outs + outs5 + outs4 + outs2 + outs3 + outsA + outsB +
                outsC + outsD + outsX):
        assert tuple(out.shape) == (3, 2 * H, 2 * W), out.shape
        assert bool(torch.isfinite(out).all())
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    for out in outsE + outsF:
        assert tuple(out.shape) == (3, 2 * H, 2 * W), out.shape
        assert bool(torch.isfinite(out).all())
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    for out in outsF:
        # the letterbox bars: black, and black stays 0 under the dither
        assert not out[:, :280].any() and not out[:, 1880:].any()
    for out in outs5 + outsE + outsF:
        codes = out * 255.0
        assert float((codes - torch.round(codes)).abs().max()) <= 255e-6
    for out in outsA:
        codes = out * 1023.0
        assert float((codes - torch.round(codes)).abs().max()) <= 1023e-6
    state = renderer._peak_state.cpu().numpy()
    state5 = renderer5._peak_state.cpu().numpy()
    state4 = renderer4._peak_state.cpu().numpy()
    assert np.isfinite(state).all() and state[1] > 0, state
    assert np.isfinite(state5).all() and state5[1] > 0, state5
    assert np.isfinite(state4).all() and state4[1] > 0, state4
    assert not renderer2._peak_state.any()
    assert not renderer3._peak_state.any()

    # 3a. K1 vs its plain version on frame 2's input at 4K (these
    # comparison launches do not count)
    k1_err, k1_frac, k1_part = _check_k1(k1, flag_k1)
    # K1's check-free square root vs sqrtf on every float of the range
    # its PQ curves clamp into
    assert k1.sqrt_check(dev) == 0

    # 3b. GPU render vs the CPU (plain) render on a small input
    small = _flagship_yuv(2, 64, 128, seed=7)
    st = lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    small_diff = []
    for f in small:
        g = rg.render(_frame(lt, f, dev), st, params).cpu().numpy()
        c = rc.render(_frame(lt, f, "cpu"), st, params).numpy()
        d = np.abs(g - c)
        small_diff.append(float(d.max()))
        assert d.mean() < 1e-4 and (d > LSB + 1e-5).mean() <= 5e-4, \
            (d.mean(), (d > LSB + 1e-5).mean())
    np.testing.assert_allclose(rg._peak_state.cpu().numpy(),
                               rc._peak_state.numpy(), atol=1e-5)

    # 5a. K1 without dither, K2 and K3 vs their plain versions on frame
    # 2's inputs at 4K (exact for K2 and K3)
    c5_k1 = captured["c5_k1"]
    assert c5_k1[3] is None
    k1n_err, k1n_frac, k1n_part = _check_k1(k1, c5_k1)
    colmaj, ed_kernel, depth, ed_w, ed_h = captured["k2"][1]
    shear_in, unshear_in = captured["k3"][2], captured["k3"][3]
    assert shear_in[5] and not unshear_in[5]
    jjn = cdither.find_error_diffusion_kernel("jarvis-judice-ninke")
    colmaj3 = k3.shear_to_colmaj(shear_in[0], ed_w + (ed_h - 1) * jjn.shift,
                                 jjn.shift, ed_w, ed_h)
    # the kernel writes every sheared position: whole arrays are exact
    k2_err = 0.0
    for args in ((colmaj, ed_kernel, depth, ed_w, ed_h),
                 (colmaj3, jjn, depth, ed_w, ed_h)):
        got = k2.wavefront(*args)
        want = k2.wavefront_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        k2_err = max(k2_err, err)
        assert torch.equal(got, want), (args[1].name, err)
        if args[1] is ed_kernel:
            codes_k = got
    del colmaj3, got, want
    k3_err = 0.0
    for x, w_out, s, w, h, fwd in (shear_in, unshear_in):
        got = (k3.shear_to_colmaj if fwd else k3.unshear_from_colmaj)(
            x, w_out, s, w, h)
        want = k3.shear_plain(x, w_out, s, w, h, fwd)
        lib = _gather_shear(x, w_out, s, w, h, fwd)()
        k3_err = max(k3_err, float((got.float() - want.float()).abs().max()))
        assert torch.equal(got, want) and torch.equal(lib, want)

    # 5b. config-5 GPU render vs the CPU render on a small input; error
    # diffusion turns ulp differences upstream into 1-LSB flips
    rg5, rc5 = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    small5 = []
    for i, f in enumerate(small):
        grain = cfg.sample_grain(GRAIN_SEED + i)
        g = rg5.render(_frame(lt, f, dev, grain), st, params5).cpu().numpy()
        c = rc5.render(_frame(lt, f, "cpu", grain), st, params5).numpy()
        d = np.abs(g - c)
        small5.append({"max": float(d.max()),
                       "differing": float((d > 1e-6).mean()),
                       "above_1lsb": float((d > LSB + 1e-6).mean())})
        assert (d > LSB + 1e-6).mean() <= 5e-4 and \
            (d > 1e-6).mean() < 0.12, small5[-1]
    np.testing.assert_allclose(rg5._peak_state.cpu().numpy(),
                               rc5._peak_state.numpy(), atol=1e-5)

    # 7b. config 4's and config 2's K1 instances vs their plain versions
    # on frame 2's input at 4K, and the GPU renders vs the CPU renders on
    # a small input (the flagship's gate)
    k1_4_err, k1_4_frac, k1_4_part = _check_k1(k1, c4_k1)
    k1_2_err, k1_2_frac, _ = _check_k1(k1, c2_k1)
    k1_3_err, k1_3_frac, _ = _check_k1(k1, c3_k1)
    small42 = {}
    for config, source, p in (("config4", "config4", params4),
                              ("config2", "config2", params2),
                              ("config3", "config2", params3)):
        rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
        small42[config] = []
        bits = 10 if config == "config4" else 8
        for f in _flagship_yuv(2, 64, 128, seed=7, bits=bits):
            g = rg.render(_frame(lt, f, dev, config=source), st,
                          p).cpu().numpy()
            c = rc.render(_frame(lt, f, "cpu", config=source), st,
                          p).numpy()
            d = np.abs(g - c)
            small42[config].append({
                "max": float(d.max()), "mean": float(d.mean()),
                "above_1lsb": float((d > LSB + 1e-5).mean())})
            assert d.mean() < 1e-4 and (d > LSB + 1e-5).mean() <= 5e-4, \
                small42[config][-1]
        np.testing.assert_allclose(rg._peak_state.cpu().numpy(),
                                   rc._peak_state.numpy(), atol=1e-5)

    # 10b/11b. path A's generic K1 case vs its plain version on frame
    # 2's input at 4K (bit for bit), and both paths' GPU renders vs their
    # CPU renders on a small input (the gate of configs 2-4, in LSB of
    # each target's depth)
    pa_err, pa_part = _check_generic(k1, pa_k1)
    small_paths = {}
    for path, yuv_bits in (("A", 10), ("B", 8)):
        col, rep, bits, tgt, p = path_cell(lt, path, 256, 128)
        lsb = 1.0 / ((1 << tgt.bit_depth) - 1)
        rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
        small_paths[path] = []
        for f in _flagship_yuv(2, 64, 128, seed=7, bits=yuv_bits):
            g = rg.render(_frame_cell(lt, f, dev, col, rep, bits), tgt,
                          p).cpu().numpy()
            c = rc.render(_frame_cell(lt, f, "cpu", col, rep, bits), tgt,
                          p).numpy()
            d = np.abs(g - c)
            small_paths[path].append({
                "max": float(d.max()), "mean": float(d.mean()),
                "above_1lsb": float((d > lsb + 1e-5).mean())})
            assert d.mean() < 1e-4 and (d > lsb + 1e-5).mean() <= 5e-4, \
                (path, small_paths[path][-1])

    # 13b-15b. paths C's and D's K1 launches vs their plain versions on
    # frame 2's input at 4K, and their GPU renders (and the distortion
    # phase's) vs the CPU renders on a small input (the flagship's gate)
    pc_err, pc_frac, pc_part = _check_k1(k1, pc_k1)
    pd_err, pd_frac, _ = _check_k1(k1, pd_k1)
    small_yuv = _flagship_yuv(4, 64, 128, seed=7)
    small_cases = {
        "C": (params, [(path_c_frame, (f, b)) for f, b in zip(
            path_c_yuv(2, 64, 128, seed=7), path_c_rpus(lt, 2))]),
        "D": (paramsD, [(lambda lt_, srcs, dv, k=k, fld=fld: path_d_field(
            lt_, path_d_sources(lt_, srcs, dv), k, fld), (small_yuv,))
            for k, fld in ((1, "TOP"), (1, "BOTTOM"), (2, "TOP"))]),
        "distort": (paramsX, [(lambda lt_, f, dv: _frame(
            lt_, f, dv, config="config2"), (f,)) for f in small_yuv[:2]])}
    for path, (p, makers) in small_cases.items():
        rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
        small_paths[path] = []
        for make, args in makers:
            g = rg.render(make(lt, *args, dev), st, p).cpu().numpy()
            c = rc.render(make(lt, *args, "cpu"), st, p).numpy()
            d = np.abs(g - c)
            small_paths[path].append({
                "max": float(d.max()), "mean": float(d.mean()),
                "above_1lsb": float((d > LSB + 1e-5).mean())})
            assert d.mean() < 1e-4 and (d > LSB + 1e-5).mean() <= 5e-4, \
                (path, small_paths[path][-1])

    # 16b/17b. path E's K1 launch vs its plain version on frame 2's
    # input at 4K (no dither: bit for bit), and the GPU renders of paths
    # E and F and of each presentation case vs the CPU renders on a
    # small input (the flagship's gate)
    pe_err, pe_frac, pe_part = _check_k1(k1, pe_k1)
    assert pe_err == 0.0, pe_err

    def gate(path, g, c, lsb=LSB):
        d = np.abs(g - c)
        small_paths.setdefault(path, []).append({
            "max": float(d.max()), "mean": float(d.mean()),
            "above_1lsb": float((d > lsb + 1e-5).mean())})
        assert d.mean() < 1e-4 and (d > lsb + 1e-5).mean() <= 5e-4, \
            (path, small_paths[path][-1])
    yuvE = _flagship_yuv(4, 64, 128, seed=7, bits=10)
    framesE_g = path_e_frames(lt, yuvE, dev, 256)
    framesE_c = path_e_frames(lt, yuvE, "cpu", 256)
    rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    for v in range(6):
        gate("E", lt.render_image_mix(rg, path_e_mix(lt, framesE_g, v), st,
                                      paramsE).cpu().numpy(),
             lt.render_image_mix(rc, path_e_mix(lt, framesE_c, v), st,
                                 paramsE).numpy())
    colF_s, repF_s, _, targetF_s, _ = path_f_cell(lt, 256, 128, 16)
    rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    for f in _flagship_yuv(3, 48, 128, seed=7, bits=10):
        gate("F", rg.render(_frame_cell(lt, f, dev, colF_s, repF_s, 10),
                            targetF_s, paramsF).cpu().numpy(),
             rc.render(_frame_cell(lt, f, "cpu", colF_s, repF_s, 10),
                       targetF_s, paramsF).numpy())
    np.testing.assert_allclose(rg._peak_state.cpu().numpy(),
                               rc._peak_state.numpy(), atol=1e-5)
    cases_g = presentation_cases(lt, small_yuv[0], dev)
    cases_c = presentation_cases(lt, small_yuv[0], "cpu")
    for name, (f, t, p) in cases_g.items():
        gate(name, lt.Renderer(device=dev).render(f, t, p).cpu().numpy(),
             lt.Renderer(device="cpu").render(*cases_c[name]).numpy())

    # 18b/19b. path G's K1 launch vs its plain version (no dither: bit
    # for bit) and path H's K2 and K3 vs theirs on frame 2's own inputs
    # (exact), then both paths' GPU renders vs the CPU renders on a
    # small input: path G over 12 vsyncs (the flagship's gate), path H
    # over 3 frames (config 5's gate: error diffusion turns ulp
    # differences upstream into 1-LSB flips)
    pg_err, pg_frac, pg_part = _check_k1(k1, pg_k1)
    assert pg_err == 0.0, pg_err
    assert ph_k3[0][5] and not ph_k3[1][5]
    yuvG_s = _flagship_yuv(8, 64, 128, seed=7, bits=10)
    outs_g = {}
    for name, d in (("gpu", dev), ("cpu", "cpu")):
        outs_g[name] = []
        path_g_play(lt, lt.Renderer(device=d), PathGDecoder(lt, yuvG_s, d),
                    lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8),
                    paramsG, range(12), threaded=False,
                    on_vsync=lambda v, status, mix, out, acc=outs_g[name]:
                    acc.append(out.cpu().numpy()))
    assert len(outs_g["gpu"]) == len(outs_g["cpu"]) == 12
    for g, c in zip(outs_g["gpu"], outs_g["cpu"]):
        gate("G", g, c)
    hooks_c, _ = path_h_hooks(lt, "cpu")
    hooks_g, _ = path_h_hooks(lt, dev)
    rg, rc = lt.Renderer(device=dev), lt.Renderer(device="cpu")
    small_paths["H"] = []
    for i, f in enumerate(_flagship_yuv(3, 64, 128, seed=7)):
        grain = cfg.sample_grain(GRAIN_SEED + i)
        g = rg.render(_frame(lt, f, dev, grain), st,
                      path_h_params(lt, hooks_g)).cpu().numpy()
        c = rc.render(_frame(lt, f, "cpu", grain), st,
                      path_h_params(lt, hooks_c)).numpy()
        d = np.abs(g - c)
        small_paths["H"].append({
            "max": float(d.max()), "differing": float((d > 1e-6).mean()),
            "above_1lsb": float((d > LSB + 1e-6).mean())})
        assert (d > LSB + 1e-6).mean() <= 5e-4 and \
            (d > 1e-6).mean() < 0.12, small_paths["H"][-1]
    assert rg.get_errors() == rc.get_errors() == (frozenset(), frozenset())

    # 6. timings (their launches are not counted).  Config 5's frames
    # carry a new grain seed each, as an AV1 stream's do, so every frame
    # generates and uploads its grain tables
    def frame_times(r, fs, p, tgt=target):
        """Host-clocked renders of fs[:8], each synchronized, then the
        mean frame of fs[8:] rendered back to back (CUDA events)."""
        samples = []
        for f in fs[:8]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            r.render(f, tgt, p)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in fs[8:]:
            r.render(f, tgt, p)
        end.record()
        torch.cuda.synchronize()
        return samples, start.elapsed_time(end) / len(fs[8:])

    n_timed = 12
    frame_ms, frame_window_ms = frame_times(
        renderer, [frames[k % 3] for k in range(n_timed)], params)
    c4_ms, c4_window_ms = frame_times(
        renderer4, [frames4[k % 3] for k in range(n_timed)], params4)
    c2_ms, c2_window_ms = frame_times(
        renderer2, [frames2[k % 3] for k in range(n_timed)], params2)
    c3_ms, c3_window_ms = frame_times(
        renderer3, [frames2[k % 3] for k in range(n_timed)], params3)
    timed5 = [_frame(lt, yuvs[k % 3], dev,
                     cfg.sample_grain(GRAIN_SEED + len(yuvs) + k))
              for k in range(n_timed)]
    c5_ms, c5_window_ms = frame_times(renderer5, timed5, params5)
    pa_ms, pa_window_ms = frame_times(
        rendererA, [framesA[k % 3] for k in range(n_timed)], paramsA,
        targetA)
    pb_ms, pb_window_ms = frame_times(
        rendererB, [framesB[k % 3] for k in range(n_timed)], paramsB,
        targetB)
    # path C: a new RPU every frame (parsed with the frame); path D: the
    # fields of source frames 1-6, each with its neighbors; the
    # distortion phase on config 2's frames
    framesC_t = [path_c_frame(lt, yuvsC[k % 3], b, dev)
                 for k, b in enumerate(path_c_rpus(lt, n_timed))]
    pc_ms, pc_window_ms = frame_times(rendererC, framesC_t, params)
    assert len(rendererC._cache) == 1
    pd_ms, pd_window_ms = frame_times(
        rendererD, [path_d_field(lt, sourcesD, 1 + k // 2,
                                 ("TOP", "BOTTOM")[k % 2])
                    for k in range(n_timed)], paramsD)
    px_ms, px_window_ms = frame_times(
        rendererX, [frames2[k % 3] for k in range(n_timed)], paramsX)
    # path E: vsyncs 10-17 synchronized, then 18-27 back to back (source
    # frames 3-11, rendered once each as they come in)
    pe_ms = []
    for v in range(10, 18):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lt.render_image_mix(rendererE, path_e_mix(lt, framesE, v), target,
                            paramsE)
        torch.cuda.synchronize()
        pe_ms.append((time.perf_counter() - t) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k1.launches = 0
    start.record()
    for v in range(18, 28):
        lt.render_image_mix(rendererE, path_e_mix(lt, framesE, v), target,
                            paramsE)
    end.record()
    torch.cuda.synchronize()
    pe_window_ms = start.elapsed_time(end) / 10
    pe_window_k1 = k1.launches
    pf_ms, pf_window_ms = frame_times(
        rendererF, [framesF[k % 3] for k in range(n_timed)], paramsF,
        targetF)
    # path G: its counted run's vsyncs (1-29 synchronized, 30-59 back to
    # back), the telemetry's frame times beside a new frame's render
    # timed here by CUDA events, and a source frame's map (the pinned
    # upload and normalize) alone
    pg_ms = pg["ms"]
    pg_window_ms = pg["start"].elapsed_time(pg["end"]) / 30
    rendererG.flush_telemetry()
    pg_tel = rendererG.telemetry.passes["frame"]
    pg_telemetry = {"summary": rendererG.telemetry.summary(),
                    "average_ms": pg_tel.average * 1e3,
                    "peak_ms": pg_tel.peak * 1e3, "count": pg_tel.count}
    rendererG.telemetry = None
    import dataclasses
    planesG = decoderG.decode(3)
    fG = decoderG.source(3, planesG).map()
    inter_tG = lt.Target(w=target.w, h=target.h, repr=target.repr,
                         color=target.color)
    inter_pG = dataclasses.replace(paramsG, dither=None,
                                   error_diffusion=None)
    pg_render_ms = _cuda_ms(lambda: rendererG.render(fG, inter_tG, inter_pG),
                            10)
    pg_map_ms = _cuda_ms(lambda: decoderG.source(3, planesG).map(), 10)
    pg_map_host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        decoderG.source(3, planesG).map()
        pg_map_host_ms.append((time.perf_counter() - t) * 1e3)
    del fG, planesG
    k1_pg_ms = _cuda_ms(lambda: k1.color_map_tail(*pg_k1), 20)
    k1_pg_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        pg_k1[0], pg_k1[1].consts, *pg_k1[2:], pg_k1[1].instance), 3)
    # path H: 12 frames, a new grain seed each (stream traffic)
    ph_ms, ph_window_ms = frame_times(
        rendererH, [_frame(lt, yuvsH[k % 8], dev,
                           cfg.sample_grain(GRAIN_SEED + 300 + k))
                    for k in range(n_timed)], paramsH)
    # K2 and K3 on path H's frame 2, exact against their plain versions
    ph_entries = _k2_k3_entries(k2, k3, ph_k2, ph_k3, "path_h", ph_launches,
                                5)
    # path F's stages by ablation: the back-to-back frame without
    # contrast recovery, without deband, and without both (the crop
    # keeps the tail plain)
    pf_ablation_ms = {}
    for name, p in (
            ("no_recovery", dataclasses.replace(paramsF,
                                                contrast_recovery=0.0)),
            ("no_deband", dataclasses.replace(paramsF, deband=None)),
            ("no_recovery_no_deband", dataclasses.replace(
                paramsF, deband=None, contrast_recovery=0.0))):
        pf_ablation_ms[name] = frame_times(
            lt.Renderer(device=dev), [framesF[k % 3] for k in range(12)],
            p, targetF)[1]
    # the host's parse of one frame's RPU (parse, map, L1 metadata)
    rpu_bufs = path_c_rpus(lt, 5)
    rpu_host_ms = []
    for b in rpu_bufs:
        t = time.perf_counter()
        lt.rpu_to_dovi(lt.parse_rpu(b))
        lt.hdr_metadata_from_rpu(lt.HdrMetadata(), b)
        rpu_host_ms.append((time.perf_counter() - t) * 1e3)
    # the new plain stages alone, on 1080p inputs as the renderer runs
    # them: the DoVi decode of a merged frame, H.274 grain and bwdif on
    # the three planes of a field, and the distortion at 4K
    from libplacebo_tpu_torch.ops import color as ops_color
    from libplacebo_tpu_torch.ops import deinterlace as ops_di
    from libplacebo_tpu_torch.ops import distort as ops_distort
    from libplacebo_tpu_torch.ops import dovi as ops_dovi
    from libplacebo_tpu_torch.ops import film_grain_h274 as ops_h274
    gen = torch.Generator(device=dev).manual_seed(37)
    sig1080 = torch.rand((3, H, W), device=dev, generator=gen)
    packed = ops_dovi.pack_dovi(framesC[1].repr.dovi)
    dovi_ms = _cuda_ms(lambda: ops_color.decode_color(
        sig1080, framesC[1].repr, dovi_packed=packed), 10)
    fD = fieldsD[1]
    planesD = [p.data for p in fD.planes]
    prevD = [p.data for p in fD.prev.planes]
    nextD = [p.data for p in fD.next.planes]
    shapesD = [(p.component_mapping, p.h, p.w) for p in fD.planes]
    h274_tables = ops_h274.prepare_h274(fD.film_grain, shapesD, dev)
    h274_ms = _cuda_ms(lambda: [ops_h274.apply_h274_grain(
        p, fD.film_grain, m, True, tb) for p, (m, _, _), tb in
        zip(planesD, shapesD, h274_tables)], 10)
    h274_host_ms = []
    for k in range(5):
        grain = lt.FilmGrainData(type="h274", seed=PATH_D_SEED + 100 + k,
                                 h274=lt.H274GrainData(**H274_SEI))
        torch.cuda.synchronize()
        t = time.perf_counter()
        ops_h274.prepare_h274(grain, shapesD, dev)
        h274_host_ms.append((time.perf_counter() - t) * 1e3)
    deint_ms = _cuda_ms(lambda: [ops_di.deinterlace(
        p, fD.field, paramsD.deinterlace, prev=pv, next=nx,
        first_field=fD.first_field) for p, pv, nx in
        zip(planesD, prevD, nextD)], 10)
    plan_x = ops_distort.plan_distort(2 * H, 2 * W, 2 * W, 2 * H,
                                      paramsX.distort, dev)
    enc4k = torch.rand((3, 2 * H, 2 * W), device=dev, generator=gen)
    distort_ms = _cuda_ms(lambda: ops_distort.distort_image(
        enc4k, 2 * W, 2 * H, paramsX.distort, plan_x), 5)
    del sig1080, enc4k, plan_x
    k1_pc_ms = _cuda_ms(lambda: k1.color_map_tail(*pc_k1), 20)
    k1_pc_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        pc_k1[0], pc_k1[1].consts, *pc_k1[2:], pc_k1[1].instance), 3)
    k1_pd_ms = _cuda_ms(lambda: k1.color_map_tail(*pd_k1), 20)
    k1_pd_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        pd_k1[0], pd_k1[1].consts, *pd_k1[2:], pd_k1[1].instance), 3)
    k1_pe_ms = _cuda_ms(lambda: k1.color_map_tail(*pe_k1), 20)
    k1_pe_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        pe_k1[0], pe_k1[1].consts, *pe_k1[2:], pe_k1[1].instance), 3)
    k1_pa_ms = _cuda_ms(lambda: k1.color_map_tail(*pa_k1), 20)
    k1_pa_plain_ms = _cuda_ms(lambda: k1.tail_plain(*pa_k1), 3)
    # path B's stages alone: the native LUT on a 1080p frame (the
    # low-rank path at >= 1M pixels), the ICC encode of a 4K frame
    from libplacebo_tpu_torch.ops import icc as ops_icc
    from libplacebo_tpu_torch.ops import lut as ops_lut
    from libplacebo_tpu_torch.core import colorspace as tcs
    gen = torch.Generator(device=dev).manual_seed(31)
    sig1080 = torch.rand((3, H, W), device=dev, generator=gen)
    lut_ms = _cuda_ms(lambda: ops_lut.apply_lut(sig1080, paramsB.lut), 5)
    lut_rank = len(ops_lut._cp_plan(paramsB.lut)[0][0][0][0])
    lin4k = torch.rand((3, 2 * H, 2 * W), device=dev, generator=gen)
    p3 = tcs.primaries_get(tcs.ColorPrimaries.DISPLAY_P3)
    icc_ms = _cuda_ms(lambda: ops_icc.encode_profile(lin4k, targetB.icc,
                                                     p3), 5)
    del sig1080, lin4k
    # white noise: the reference's host draw of a 4K bias frame and its
    # upload (once a render plan: the bias is part of the plan)
    wn = lt.DitherParams(method=lt.DitherMethod.WHITE_NOISE)
    white_noise_host_ms = []
    for k in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.from_numpy(ops_dither.bias_matrix(wn, 2 * H, 2 * W, k)).to(dev)
        torch.cuda.synchronize()
        white_noise_host_ms.append((time.perf_counter() - t) * 1e3)
    gen_lib = k1_libs[k1.GENERIC]
    k1_generic_sass = _sass.loop_mix(_sass.disassemble(gen_lib._name),
                                     "k1_generic")
    k1_generic_ptxas = [v for n, v in _sass.ptxas_report(
        build_log(gen_lib)).items() if "k1_generic" in n]
    k1_ms = _cuda_ms(lambda: k1.color_map_tail(*flag_k1), 20)
    k1_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        flag_k1[0], flag_k1[1].consts, *flag_k1[2:]), 3)
    k1n_ms = _cuda_ms(lambda: k1.color_map_tail(*c5_k1), 20)
    k1_4_ms = _cuda_ms(lambda: k1.color_map_tail(*c4_k1), 20)
    k1_4_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        c4_k1[0], c4_k1[1].consts, *c4_k1[2:], c4_k1[1].instance), 3)
    k1_2_ms = _cuda_ms(lambda: k1.color_map_tail(*c2_k1), 20)
    k1_2_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        c2_k1[0], c2_k1[1].consts, *c2_k1[2:], c2_k1[1].instance), 3)
    k1_3_ms = _cuda_ms(lambda: k1.color_map_tail(*c3_k1), 20)
    k1_3_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        c3_k1[0], c3_k1[1].consts, *c3_k1[2:], c3_k1[1].instance), 3)
    k1n_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
        c5_k1[0], c5_k1[1].consts, *c5_k1[2:]), 3)
    # the SM clock while K1 runs: ~0.5-1 s of launches queued, read
    # before they finish; the instruction floor is the pixel loop's
    # instructions (one pixel an iteration) over every scheduler's lanes
    # at that clock
    for _ in range(1000):
        k1.color_map_tail(*flag_k1)
    k1_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    torch.cuda.synchronize()
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32
    k1_floor_ms = {v: m["per_iteration"] * npix / (lanes * k1_mhz * 1e6) * 1e3
                   for v, m in k1_sass.items() if "dither" in v}
    # every instance's bounds and instruction floor at 4K
    disasm = {}

    def sass_of(tone, inst):
        if tone not in disasm:
            disasm[tone] = _sass.disassemble(k1_libs[tone]._name)
        return _sass.loop_mix(disasm[tone], inst)["per_iteration"]
    k1_instances = _k1_instance_table(lt, k1, trender, ops_dither, sass_of,
                                      npix, lanes, k1_mhz, 2 * W, 2 * H, dev)
    k1_instances.update({
        f"generic,{case}": v for case, v in
        _k1_generic_table(lt, k1, trender, 2 * W, 2 * H, dev).items()})
    ed_args = (colmaj, ed_kernel, depth, ed_w, ed_h)
    k2_runs = []
    k2_ms = _cuda_ms(lambda: k2_runs.append(k2.wavefront(*ed_args)), 5)
    assert all(torch.equal(r, codes_k) for r in k2_runs), \
        "K2's repeated runs differ"
    del k2_runs
    _, k2_blocks, k2_threads = k2.geometry(*colmaj.shape)
    # the column step against the pipeline's fill: the same columns
    # walked by one 32-row band alone, and by one channel's bands
    band = colmaj[:, :1, :32].contiguous()
    chan = colmaj[:, :1, :].contiguous()
    k2_band_ms = _cuda_ms(
        lambda: k2.wavefront(band, ed_kernel, depth, ed_w, 32), 5)
    k2_chan_ms = _cuda_ms(
        lambda: k2.wavefront(chan, ed_kernel, depth, ed_w, ed_h), 5)
    k2_chan_bands = k2.geometry(*chan.shape)[1]
    del band, chan
    k2_plain_ms = _cuda_ms(lambda: k2.wavefront_plain(*ed_args), 1)
    k3_ms, k3_plain_ms, k3_lib_ms = {}, {}, {}
    for x, w_out, s, w, h, fwd in (shear_in, unshear_in):
        d = "forward" if fwd else "inverse"
        wrapper = k3.shear_to_colmaj if fwd else k3.unshear_from_colmaj
        k3_ms[d] = _cuda_ms(lambda: wrapper(x, w_out, s, w, h), 20)
        k3_plain_ms[d] = _cuda_ms(
            lambda: k3.shear_plain(x, w_out, s, w, h, fwd), 2)
        k3_lib_ms[d] = _cuda_ms(_gather_shear(x, w_out, s, w, h, fwd), 20)
    # the bytes the function needs: forward, the image read and the whole
    # sheared frame written (K2 reads its zeros); inverse, only the
    # w x C x h codes that the unshear keeps, read and written
    k3_bytes = sum(bm_k3_bytes(x, w_out, w, h, fwd)
                   for x, w_out, _, w, h, fwd in (shear_in, unshear_in))
    lin = torch.rand((3, H, W), device=dev) * 49.0
    ewa_cfg = flt.find_filter_config("ewa_lanczos")
    ewa_ms = _cuda_ms(lambda: polar.sample_polar(
        lin, ewa_cfg, 2 * H, 2 * W, RectF(0, 0, W, H)), 5)
    # config 3's scaler alone on frame 2's sigmoidized 1080p input: the
    # phased EWA with anti-ringing, its launches a call (profiler) and its
    # bound (the input read once, the 4K output written once; operations
    # counted from the plan: a multiply-add a nonzero tap, and per
    # main-lobe tap and channel the extremum tests (2), scaling (2) and
    # both sides' softmax terms and sums (2 x 11), and 18 a pixel for the
    # scale, the ratios and the blend)
    ewa_ar_args = (c3_ewa[0],) + c3_ewa[1:]
    ewa_ar_ms = _cuda_ms(lambda: polar.sample_polar(*ewa_ar_args), 10)
    pp = polar._phase_plan(*ewa_key)
    n_out = 3 * 4 * H * W
    ewa_ar_ops = n_out * (2 * float(np.mean([(w != 0).sum() for w in pp.wk]))
                          + 26 * pp.ar_w.shape[0] + 18)
    ewa_ar_bytes = (c3_ewa[0].numel() + n_out) * 4
    ewa_ar_bound, ewa_ar_by = bound_ms(ewa_ar_bytes, ewa_ar_ops)
    # 9. K2 on a pattern outside the compiled ten, its taps given at
    # launch, on config 5's sheared frame (the same shift): exact against
    # the plain version, timed beside the compiled instance
    custom = cdither.ErrorDiffusionKernel(
        "custom-3row", "taps given at launch", ed_kernel.shift,
        ((0, 0, 0, 5, 2), (0, 3, 4, 1, 0), (0, 0, 1, 0, 0)), 16)
    assert custom not in cdither.ERROR_DIFFUSION_KERNELS
    k2_custom = k2.wavefront(colmaj, custom, depth, ed_w, ed_h)
    k2_custom_plain = k2.wavefront_plain(colmaj, custom, depth, ed_w, ed_h)
    torch.cuda.synchronize()
    assert torch.equal(k2_custom, k2_custom_plain), "K2 custom pattern"
    k2_custom_err = float((k2_custom.float() -
                           k2_custom_plain.float()).abs().max())
    del k2_custom, k2_custom_plain
    k2_custom_ms = _cuda_ms(
        lambda: k2.wavefront(colmaj, custom, depth, ed_w, ed_h), 5)
    # deband and grain of one frame's three planes, as the renderer runs
    # them (tables drawn beforehand, as the render plan holds them)
    planes = [p.data for p in frames5[1].planes]
    metas = frames5[1].meta_key()[0]
    dp = lt.DebandParams(iterations=2)
    db_args = [(p, i, ops_deband.deband_tables(dp, p.shape, i, dev),
                ops_deband.plane_grain_neutral(frames5[1].repr, m[1]))
               for i, (p, m) in enumerate(zip(planes, metas))]
    deband_ms = _cuda_ms(lambda: [ops_deband.deband(
        p, dp, seed=i, tables=tb, neutral=n) for p, i, tb, n in db_args], 5)
    cfgs, shift = renderer5._grain_cfgs(metas, frames5[1].repr,
                                        frames5[1].film_grain)

    def grain_tables(grain):
        return [ops_fg.prepare_av1_grain(grain, c, m[0][-2], m[0][-1], dev)
                for c, m in zip(cfgs, metas)]
    tables = grain_tables(frames5[1].film_grain)
    # host time to make and queue one frame's tables, a new seed each
    tables_host_ms = []
    for k in range(5):
        grain = cfg.sample_grain(GRAIN_SEED + 1000 + k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        grain_tables(grain)
        tables_host_ms.append((time.perf_counter() - t) * 1e3)
    luma = planes[0][0]
    grain_ms = _cuda_ms(lambda: [ops_fg.apply_av1_grain(
        p, tb, c, shift, luma=None if c.channels == (0,) else
        ops_fg.subsample_nearest(luma, c.sub_x, c.sub_y, p.shape[-2],
                                 p.shape[-1]))
        for p, tb, c in zip(planes, tables, cfgs)], 5)

    # the anti-ringing EWA's launches a call, counted by the profiler
    # last: its tracing slows the host's launches after it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        polar.sample_polar(*ewa_ar_args)
        torch.cuda.synchronize()
    ewa_ar_launches = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    # what the function needs: the ed_w x C x ed_h pixels of the frame
    # read, their codes written (the zeros outside the sheared image
    # change no code that the unshear keeps); per pixel: add, multiply,
    # round, fused err (2), clip (2), and a fused multiply-add (2) a tap
    k2_bound, k2_by = k2_bound_of(*ed_args)
    k3_bound, k3_by = bound_ms(k3_bytes)

    # 20. path I: a 4K HDR10 clip transcoded to 1080p SDR (counted on its
    # own), K1's launch against its plain version, timed
    # (the tail into a BT.1886 target runs K1's generic instance: bit for
    # bit against its plain version, as path A's)
    path_i, pi_k1, pi_launches = path_i_phase(lt, dev, counters, k1)
    if pi_k1[1].tone == k1.GENERIC:
        pi_err, pi_part = _check_generic(k1, pi_k1)
        pi_frac = 0.0
        k1_pi_plain_ms = _cuda_ms(lambda: k1.tail_plain(*pi_k1), 3)
    else:
        pi_err, pi_frac, pi_part = _check_k1(k1, pi_k1)
        k1_pi_plain_ms = _cuda_ms(lambda: k1.color_map_plain(
            pi_k1[0], pi_k1[1].consts, *pi_k1[2:], pi_k1[1].instance), 3)
    k1_pi_ms = _cuda_ms(lambda: k1.color_map_tail(*pi_k1), 20)

    # 21. path J: an mpv user's shaders (a RAVU-lite-class luma doubler
    # and a stateful temporal-EMA compute hook, through Options.add_hook)
    # at 4K, counted on its own; K2 and K3 on its frame against their
    # plain versions; the hooks under sync debug mode; timed
    path_j, pj_entries = path_j_phase(lt, dev, counters, k2, k3)

    # 22. the GPU-vs-JAX gate: the port's renders on the card against the
    # JAX package's CPU renders committed as fixtures (tools/gpu_vs_cpu.py)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gpu_vs_cpu", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tools", "gpu_vs_cpu.py"))
    gpu_vs_cpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gpu_vs_cpu)
    t = time.perf_counter()
    gate_lines, gate_ok = gpu_vs_cpu.run("cuda")
    gate_s = time.perf_counter() - t
    for line in gate_lines:
        print(json.dumps({"gpu_vs_jax": line}))
    assert gate_ok, gate_lines

    # 23. path K: the multi-device layer through a one-rank NCCL mesh,
    # the flagship on the halo step and config 5 on the replicated step
    # at 4K, each counted on its own
    path_k, pk_entries = path_k_phase(lt, dev, counters, k1, k2, k3)

    # 24. path L: the demos and tools through their main()s at full
    # width, each counted on its own; K1-K3 on its inputs against their
    # plain versions
    path_l, pl_entries = path_l_phase(lt, dev, counters, k1, k2, k3)

    # 25. the degradation ladder, last, everything restored after it:
    # (a) a plain stage made to fail (deband raising RuntimeError)
    # recovers, get_errors() shows `deband` and the log records it;
    # (b) K1's launcher raising KernelError and (c) raising the
    # exception type torch uses for a CUDA error (simulated: a real one
    # would leave the context unusable) each propagate out of
    # Renderer.render with get_errors() empty
    from libplacebo_tpu_torch.core import log as core_log
    ladder = {}
    logged = []
    real_log, real_deband = core_log.default_log, ops_deband.deband
    small_f = _flagship_yuv(1, 64, 128, seed=7)[0]

    def broken_deband(*a, **k):
        raise RuntimeError("synthetic deband failure")
    core_log.default_log = lambda: core_log.Log(
        level=core_log.LogLevel.ERR,
        callback=lambda lvl, msg: logged.append(msg))
    ops_deband.deband = broken_deband
    try:
        rl = lt.Renderer(device=dev)
        out = rl.render(_frame(lt, small_f, dev), st, lt.RenderParams(
            upscaler="ewa_lanczos", deband=lt.DebandParams()))
        torch.cuda.synchronize()
        ladder["a_errors"] = sorted(rl.get_errors()[0])
        ladder["a_log"] = list(logged)
        assert rl.get_errors() == (frozenset({"deband"}), frozenset())
        assert len(logged) == 1 and "deband" in logged[0] and \
            "synthetic deband failure" in logged[0], logged
        assert bool(torch.isfinite(out).all())
    finally:
        core_log.default_log, ops_deband.deband = real_log, real_deband
    cuda_error = getattr(torch, "AcceleratorError", RuntimeError)
    for case, exc in (
            ("b", lt.KernelError("K1 launch failed: synthetic")),
            ("c", cuda_error("CUDA error: an illegal memory access was "
                             "encountered (synthetic)"))):
        def failing_launch(*a, exc=exc, **k):
            raise exc
        k1.color_map_tail = failing_launch
        rl = lt.Renderer(device=dev)
        try:
            rl.render(_frame(lt, small_f, dev), st, params)
            raised = None
        except Exception as e:      # noqa: BLE001 - checked below
            raised = e
        finally:
            k1.color_map_tail = real["k1"]
        assert raised is exc, (case, raised)
        assert rl.get_errors() == (frozenset(), frozenset()), case
        ladder[f"{case}_raised"] = f"{type(raised).__name__}: {raised}"
    # (d) an out-of-memory error inside K1's own wrapper (its library
    # lookup made to raise one, after the wrapper's allocations) leaves
    # it as a KernelError and propagates; nothing degrades
    real_lib = k1._kernel_lib
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "95.00 MiB (synthetic)")

    def oom_lib(*a, **k):
        raise oom
    k1._kernel_lib = oom_lib
    rl = lt.Renderer(device=dev)
    try:
        rl.render(_frame(lt, small_f, dev), st, params)
        raised = None
    except Exception as e:      # noqa: BLE001 - checked below
        raised = e
    finally:
        k1._kernel_lib = real_lib
    assert isinstance(raised, lt.KernelError) and \
        raised.__cause__ is oom, raised
    assert rl.get_errors() == (frozenset(), frozenset())
    ladder["d_raised"] = f"{type(raised).__name__}: {raised}"
    # restored: the same renderer renders on K1 again
    k1.launches = 0
    rl.render(_frame(lt, small_f, dev), st, params)
    torch.cuda.synchronize()
    assert k1.launches == 1 and rl.get_errors() == (frozenset(), frozenset())
    # no feature and no hook was quietly disabled on any path
    for r in (renderer, renderer5, renderer4, renderer2, renderer3,
              rendererA, rendererB, rendererC, rendererD, rendererX,
              rendererE, rendererF, rendererG, rendererH):
        assert r.get_errors() == (frozenset(), frozenset()), r.get_errors()

    kernels = [
        _k1_entry(k1, "k1_color_map", flag_k1, k1_part,
                  flag_launches["k1"], k1_err, k1_ms, k1_plain_ms),
        _k1_entry(k1, "k1_color_map_no_dither", c5_k1, k1n_part,
                  c5_launches["k1"], k1n_err, k1n_ms, k1n_plain_ms),
        _k1_entry(k1, "k1_color_map_bt2390_softclip", c4_k1, k1_4_part,
                  c4_launches["k1"], k1_4_err, k1_4_ms, k1_4_plain_ms),
        _k1_entry(k1, "k1_color_map_pass", c2_k1, None, c2_launches["k1"],
                  k1_2_err, k1_2_ms, k1_2_plain_ms),
        _k1_entry(k1, "k1_color_map_pass_config3", c3_k1, None,
                  c3_launches["k1"], k1_3_err, k1_3_ms, k1_3_plain_ms),
        _k1_entry(k1, "k1_color_map_generic_path_a", pa_k1, pa_part,
                  pa_launches["k1"], pa_err, k1_pa_ms, k1_pa_plain_ms),
        _k1_entry(k1, "k1_color_map_path_c", pc_k1, pc_part,
                  pc_launches["k1"], pc_err, k1_pc_ms, k1_pc_plain_ms),
        _k1_entry(k1, "k1_color_map_pass_path_d", pd_k1, None,
                  pd_launches["k1"], pd_err, k1_pd_ms, k1_pd_plain_ms),
        _k1_entry(k1, "k1_color_map_no_dither_path_e", pe_k1, pe_part,
                  pe_launches["k1"], pe_err, k1_pe_ms, k1_pe_plain_ms),
        _k1_entry(k1, "k1_color_map_no_dither_path_g", pg_k1, pg_part,
                  pg_launches["k1"], pg_err, k1_pg_ms, k1_pg_plain_ms),
        _k1_entry(k1, "k1_color_map_path_i", pi_k1, pi_part, pi_launches,
                  pi_err, k1_pi_ms, k1_pi_plain_ms),
        *ph_entries, *pj_entries, *pk_entries, *pl_entries,
        {"name": "k2_error_diffusion", "route": "cuda",
         "source": "libplacebo_tpu_torch/csrc/error_diffusion.cu",
         "replaces": "libplacebo_tpu/ops/pallas/error_diffusion.py:226",
         "launches": c5_launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
        {"name": "k3_shear", "route": "cuda",
         "source": "libplacebo_tpu_torch/csrc/shear.cu",
         "replaces": "libplacebo_tpu/ops/pallas/shear.py:149",
         "launches": c5_launches["k3"], "max_abs_err": k3_err,
         "ms": sum(k3_ms.values()), "plain_ms": sum(k3_plain_ms.values()),
         "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": sum(k3_lib_ms.values())}]
    timings = {
        "card": card, "build_s": build_s,
        "frame_ms_median": statistics.median(frame_ms), "frame_ms": frame_ms,
        "frame_window_ms": frame_window_ms,
        "config5_frame_ms_median": statistics.median(c5_ms),
        "config5_frame_ms": c5_ms, "config5_window_ms": c5_window_ms,
        "config5_first_3_frames_s": c5_first_s,
        "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms,
        "k1_no_dither_ms": k1n_ms, "k1_no_dither_plain_ms": k1n_plain_ms,
        "k1_differing_fraction": k1_frac,
        "k1_no_dither_differing_fraction": k1n_frac,
        "k1_ops_per_pixel": k1.ops_per_pixel(flag_k1[1].consts),
        "k1_no_dither_ops_per_pixel": k1.ops_per_pixel(c5_k1[1].consts),
        "config4_frame_ms_median": statistics.median(c4_ms),
        "config4_frame_ms": c4_ms, "config4_window_ms": c4_window_ms,
        "config2_frame_ms_median": statistics.median(c2_ms),
        "config2_frame_ms": c2_ms, "config2_window_ms": c2_window_ms,
        "k1_config4_ms": k1_4_ms, "k1_config4_plain_ms": k1_4_plain_ms,
        "k1_config2_ms": k1_2_ms, "k1_config2_plain_ms": k1_2_plain_ms,
        "k1_config4_differing_fraction": k1_4_frac,
        "k1_config2_differing_fraction": k1_2_frac,
        "k1_config4_ops_per_pixel": k1.ops_per_pixel(c4_k1[1].consts,
                                                     c4_k1[1].instance),
        "k1_config2_ops_per_pixel": k1.ops_per_pixel(c2_k1[1].consts,
                                                     c2_k1[1].instance),
        "config3_frame_ms_median": statistics.median(c3_ms),
        "config3_frame_ms": c3_ms, "config3_window_ms": c3_window_ms,
        "k1_config3_ms": k1_3_ms, "k1_config3_plain_ms": k1_3_plain_ms,
        "k1_config3_differing_fraction": k1_3_frac,
        "ewa_ar_ms": ewa_ar_ms, "ewa_ar_launches_per_call": ewa_ar_launches,
        "ewa_ar_bound_ms": ewa_ar_bound, "ewa_ar_bound_by": ewa_ar_by,
        "ewa_ar_bytes": ewa_ar_bytes, "ewa_ar_ops": ewa_ar_ops,
        "k2_custom_ms": k2_custom_ms, "k2_custom_max_abs_err": k2_custom_err,
        "path_a_frame_ms_median": statistics.median(pa_ms),
        "path_a_frame_ms": pa_ms, "path_a_window_ms": pa_window_ms,
        "path_b_frame_ms_median": statistics.median(pb_ms),
        "path_b_frame_ms": pb_ms, "path_b_window_ms": pb_window_ms,
        "path_a_tails": pa_tails, "path_b_tails": pb_tails,
        "k1_path_a_ms": k1_pa_ms, "k1_path_a_plain_ms": k1_pa_plain_ms,
        "k1_path_a_ops_per_pixel": k1.ops_per_pixel(pa_k1[1].consts,
                                                    pa_k1[1].instance),
        "path_c_frame_ms_median": statistics.median(pc_ms),
        "path_c_frame_ms": pc_ms, "path_c_window_ms": pc_window_ms,
        "path_d_frame_ms_median": statistics.median(pd_ms),
        "path_d_frame_ms": pd_ms, "path_d_window_ms": pd_window_ms,
        "distort_frame_ms_median": statistics.median(px_ms),
        "distort_frame_ms": px_ms, "distort_window_ms": px_window_ms,
        "path_c_tails": pc_tails, "path_d_tails": pd_tails,
        "distort_tails": px_tails,
        "k1_path_c_ms": k1_pc_ms, "k1_path_c_plain_ms": k1_pc_plain_ms,
        "k1_path_c_differing_fraction": pc_frac,
        "k1_path_d_ms": k1_pd_ms, "k1_path_d_plain_ms": k1_pd_plain_ms,
        "k1_path_d_differing_fraction": pd_frac,
        "path_e_vsync_ms_median": statistics.median(pe_ms),
        "path_e_vsync_ms": pe_ms, "path_e_window_ms": pe_window_ms,
        "path_e_k1_launches_per_vsync": pe_launches["k1"] / 10,
        "path_e_window_k1_launches_per_vsync": pe_window_k1 / 10,
        "path_e_mix_cache_hits": pe_hits, "path_e_tails": pe_tails,
        "k1_path_e_ms": k1_pe_ms, "k1_path_e_plain_ms": k1_pe_plain_ms,
        "k1_path_e_differing_fraction": pe_frac,
        "path_f_frame_ms_median": statistics.median(pf_ms),
        "path_f_frame_ms": pf_ms, "path_f_window_ms": pf_window_ms,
        "path_f_tails": pf_tails, "path_f_ablation_window_ms":
        pf_ablation_ms,
        "path_g_vsync_ms_median": statistics.median(pg_ms),
        "path_g_vsync_ms": pg_ms, "path_g_window_ms": pg_window_ms,
        "path_g_k1_launches_per_vsync": pg_launches["k1"] / 60,
        "path_g_mix_cache_hits": pg_hits, "path_g_tails": pg_tails,
        "path_g_frames": pg_frames,
        "path_g_queue_status": pg_status_count,
        "path_g_telemetry": pg_telemetry,
        "path_g_render_ms": pg_render_ms, "path_g_map_ms": pg_map_ms,
        "path_g_map_host_ms": pg_map_host_ms,
        "k1_path_g_ms": k1_pg_ms, "k1_path_g_plain_ms": k1_pg_plain_ms,
        "path_h_frame_ms_median": statistics.median(ph_ms),
        "path_h_frame_ms": ph_ms, "path_h_window_ms": ph_window_ms,
        "path_h_k2_launches_per_frame": ph_launches["k2"] / 8,
        "path_h_k3_launches_per_frame": ph_launches["k3"] / 8,
        "path_h_tails": ph_tails, "k2_path_h_ms": ph_entries[0]["ms"],
        "k3_path_h_ms": ph_entries[1]["ms"], "ladder": ladder,
        **path_i, "k1_path_i_ms": k1_pi_ms,
        "k1_path_i_plain_ms": k1_pi_plain_ms,
        "k1_path_i_differing_fraction": pi_frac,
        "k1_path_i_ops_per_pixel": k1.ops_per_pixel(pi_k1[1].consts,
                                                    pi_k1[1].instance),
        **path_j, **path_k, **path_l,
        "gpu_vs_jax": gate_lines, "gpu_vs_jax_s": gate_s,
        "dovi_decode_1080p_ms": dovi_ms, "dovi_rpu_host_ms": rpu_host_ms,
        "h274_1080p_ms": h274_ms, "h274_host_ms": h274_host_ms,
        "deinterlace_1080p_ms": deint_ms, "distort_4k_ms": distort_ms,
        "path_b_lut_1080p_ms": lut_ms, "path_b_lut_rank": lut_rank,
        "path_b_icc_encode_4k_ms": icc_ms,
        "white_noise_host_ms": white_noise_host_ms,
        "small_path_render": small_paths,
        "k1_generic_sass": {k: k1_generic_sass[k] for k in (
            "per_iteration", "classes", "static_instructions", "calls",
            "inner_loops")},
        "k1_generic_ptxas": k1_generic_ptxas,
        "small_config4_config2_config3_render": small42,
        "config4_peak_state": state4.tolist(),
        "k1_sass": {v: {k: m[k] for k in (
            "per_iteration", "classes", "static_instructions",
            "slow_path_instructions", "calls",
            "slow_path_calls")} for v, m in k1_sass.items()},
        "k1_ptxas": k1_ptxas, "k1_sm_clock_mhz": k1_mhz,
        "k1_instances": k1_instances,
        "k1_instruction_floor_ms": k1_floor_ms,
        "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
        "k2_columns": colmaj.shape[0],
        "k2_ns_per_column": k2_ms * 1e6 / colmaj.shape[0],
        "k2_grid": [k2_blocks, k2_threads],
        "k2_one_band_ms": k2_band_ms, "k2_one_channel_ms": k2_chan_ms,
        "k2_step_ns": k2_band_ms * 1e6 / colmaj.shape[0],
        "k2_fill_us_per_band": (k2_chan_ms - k2_band_ms) * 1e3 /
        (k2_chan_bands - 1),
        "k3_ms": k3_ms, "k3_plain_ms": k3_plain_ms,
        "k3_gather_ms": k3_lib_ms, "k3_bytes": k3_bytes,
        "ewa_ms": ewa_ms, "deband_ms": deband_ms, "grain_ms": grain_ms,
        "grain_tables_host_ms": tables_host_ms,
        "ptxas": ptxas_lines, "small_render_max_diff": small_diff,
        "small_config5_render": small5, "peak_state": state.tolist(),
        "config5_peak_state": state5.tolist()}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "timings": timings,
                   "ptxas_report": ptxas, "k1_sass": k1_sass}, f, indent=1)
    with open(os.path.join("chiprun_out", "k1_sass.txt"), "w") as f:
        f.write(k1_sass_text)

    print(f"path G: a vsync {statistics.median(pg_ms):.3f} ms synchronized "
          f"(median of {len(pg_ms)}), {pg_window_ms:.3f} ms back to back; "
          f"K1 {pg_launches['k1'] / 60:.3f} launches a vsync, {pg_hits} "
          f"mix-cache hits; frames {pg_frames}; queue "
          f"{pg_status_count}; telemetry's frame {pg_tel.average * 1e3:.3f}"
          f" ms average ({pg_tel.count} frames) beside a new frame's render"
          f" {pg_render_ms:.3f} ms (CUDA events); a map {pg_map_ms:.3f} ms")
    print(f"path H: a frame {statistics.median(ph_ms):.3f} ms synchronized,"
          f" {ph_window_ms:.3f} ms back to back; K2 "
          f"{ph_launches['k2'] / 8:g} and K3 {ph_launches['k3'] / 8:g} "
          f"launches a frame; tails (K1, plain, ineligible) {ph_tails}")
    pi_entry = next(k for k in kernels if k["name"] == "k1_color_map_path_i")
    print(f"path I ({card}): a frame {path_i['path_i_frame_ms']:.3f} ms "
          f"synchronized (median of {PATH_I_FRAMES}), "
          f"{path_i['path_i_window_ms']:.3f} ms back to back; "
          f"{path_i['path_i_fps']:.3f} fps read->write; host ms: read "
          f"{path_i['path_i_read_host_ms']:.3f}, map "
          f"{path_i['path_i_map_ms']:.3f}, encode+download "
          f"{path_i['path_i_encode_download_ms']:.3f}, write "
          f"{path_i['path_i_write_host_ms']:.3f}; timer ms "
          f"{[round(t, 4) for t in path_i['path_i_timer_ms']]} beside CUDA "
          f"events {[round(t, 4) for t in path_i['path_i_event_ms']]}; K1 "
          f"{path_i['path_i_k1_instance']} {pi_entry['ms']:.4f} ms (bound "
          f"{pi_entry['bound_ms']:.4f} ms on {pi_entry['bound_by']}), "
          f"{pi_launches} launches; tails {path_i['path_i_tails']}")
    print(f"path J ({card}): a frame {path_j['path_j_frame_ms']:.3f} ms "
          f"synchronized (first {path_j['path_j_first_frame_ms']:.1f} ms), "
          f"{path_j['path_j_window_ms']:.3f} ms back to back, busy "
          f"{path_j['path_j_busy_share']:.1%} ({path_j['path_j_frame_launches']}"
          f" launches a frame); the hooks' host issue "
          f"{path_j['path_j_hooks_host_ms']:.3f} ms a frame; by pass "
          f"(launches, busy ms) "
          f"{ {d: (v['launches'], round(v['busy_ms'], 3)) for d, v in path_j['path_j_passes_profiled'].items()} }"
          f"; K1, K2, K3 launches a frame "
          f"{path_j['path_j_launches_per_frame']}; tails "
          f"{path_j['path_j_tails']}; counter {path_j['path_j_counter']:g}")
    print(f"path K ({card}): one-rank NCCL mesh {path_k['path_k_mesh']}; "
          f"halo step (route {path_k['path_k_halo_route']}) a flagship "
          f"frame {path_k['path_k_halo_frame_ms']:.3f} ms synchronized "
          f"(batch 2), {path_k['path_k_halo_window_ms']:.3f} ms back to "
          f"back, single card "
          f"{path_k['path_k_single_card_flagship_frame_ms']:.3f} ms; "
          f"replicated step (route {path_k['path_k_replicated_route']}) a "
          f"config-5 frame {path_k['path_k_replicated_frame_ms']:.3f} ms "
          f"synchronized, {path_k['path_k_replicated_window_ms']:.3f} ms "
          f"back to back, single card "
          f"{path_k['path_k_single_card_config5_frame_ms']:.3f} ms; "
          f"collectives halo {path_k['path_k_halo_collectives']}, "
          f"replicated {path_k['path_k_replicated_collectives']}; "
          f"launches halo {path_k['path_k_halo_launches']}, replicated "
          f"{path_k['path_k_replicated_launches']}")
    pl = path_l["path_l_plplay"]
    pl_seconds = {k: round(v, 1) for k, v in
                  path_l["path_l_seconds_by_program"].items()}
    print(f"path L ({card}): plplay {pl['rendered']} vsyncs at "
          f"{pl['fps']:.1f} fps, a vsync {pl['host_ms_per_vsync']:.3f} ms "
          f"host-clocked, {pl['event_ms_per_vsync']:.3f} ms CUDA events "
          f"(after the first vsync {pl['steady_host_ms_per_vsync']:.3f} and "
          f"{pl['steady_event_ms_per_vsync']:.3f}), K1 "
          f"{pl['launches']['k1']} launches; small plplay GPU vs CPU "
          f"{path_l['path_l_plplay_small_gate']}; multichip_bench "
          f"{path_l['path_l_multichip_bench']['ms_per_batch']:.3f} ms a "
          f"batch of 2; launches by program {path_l['path_l_launches']}; "
          f"seconds by program {pl_seconds}; path L "
          f"{path_l['path_l_seconds']:.1f} s")
    print(f"ladder: {ladder}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"timings": timings}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

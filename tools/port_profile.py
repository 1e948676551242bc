#!/usr/bin/env python3
"""Profile one of the PyTorch/CUDA port's renders on one GPU.

Run from the root of a checkout:
    python3 tools/port_profile.py [frames] [--config5 | --config4 | --config2
                                           | --config3 | --pathA | --pathB
                                           | --pathC | --pathD | --pathE
                                           | --pathF | --pathG | --pathH
                                           | --pathI]
                                          [--telemetry]

Renders the flagship cell (1080p PQ yuv420p -> 3840x2160 sRGB, EWA
Lanczos, K1 tail) or, with --config5, config 5 (the same frame carrying
AV1 film grain, with deband (2 iterations), film grain and
Floyd-Steinberg error diffusion: K1 without dither, K3, K2, K3; a new
grain seed every frame, as an AV1 stream carries), with --config4
config 4 (the same content at 10 bits with 1000-nit mastering metadata,
bt2390 tone curve and softclip gamut map on K1), or with --config2
config 2's color path (8-bit BT.709 BT.1886 -> sRGB with
RenderParams(): sigmoidized separable Lanczos, K1's pass-through tail),
or with --config3 config 3 (config 2's frame with
RenderParams(upscaler="ewa_lanczos4sharpest", antiringing_strength=0.8):
the phased EWA with anti-ringing in sigmoidized light, K1's pass-through
tail), with --pathA path A (config 4's content as 10-bit HLG -> 10-bit
BT.2020 PQ at 600 nits, EWA Lanczos, static bt2446a on K1's generic
instance) or with --pathB path B (config 2's frame through a 33^3
native LUT to a Display P3 gamma 2.2 ICC profile, a plain tail; both
defined by chip_smoke.py::path_cell), with --pathC path C (10-bit Dolby
Vision profile 5, a new RPU parsed every frame -> 3840x2160 sRGB, EWA
Lanczos, K1's <spline, perceptual> tail) or with --pathD path D (1080i
BT.709 with an H.274 SEI, a new seed every frame, each source frame's
fields rendered in turn with bwdif, then config 2's path; both defined by
chip_smoke.py's path_c_* and path_d_* helpers), with --pathE path E
(10-bit PQ at 23.976 fps with subtitles and an OSD -> a 60 Hz 3840x2160
sRGB display through render_image_mix, a FrameMix a vsync, oversample:
a "frame" below is a vsync) or with --pathF path F (1920x800 10-bit
HDR10 letterboxed into 3840x2160 sRGB with HIGH_QUALITY_PARAMS; both
defined by chip_smoke.py's path_e_* and path_f_cell), with --pathG path
G (a player's loop: the option string's params, lazy 10-bit HDR10
source frames at 23.976 fps in a FrameQueue, each mapped from pinned
memory when first shown, a queue update and render_image_mix a 60 Hz
vsync, mitchell_clamp mixer: a "frame" below is a vsync) or with
--pathH path H (config 5 with a LUMA_INPUT luma doubler and a
PRE_OUTPUT auto-exposure, a new grain seed every frame; both defined by
chip_smoke.py's path_g_* and path_h_* helpers) or with --pathI path I
(a transcoder's loop: a 3840x2160 10-bit HDR10 y4m clip in a temporary
directory, each frame read, mapped as a decoder's AVFrame, rendered to
1920x1080 8-bit BT.709 SDR on Renderer(ctx=runtime.create()), encoded to
YCbCr on the card, downloaded and written as a y4m: a "frame" below is
that whole step; chip_smoke.py's PathITranscoder) after two warm-up
frames, twice over:
 - unprofiled, `frames` renders back to back with no synchronisation
   between them, timed by CUDA events around the window;
 - the same renders under torch.profiler, for the device time by kernel
   name and the port's own spans: each "lt.*" range
   (libplacebo_tpu_torch/render/profiler.py) with its calls, host ms and
   the device ms of the kernels PyTorch launched inside it, a frame
   (K1-K3 launch through cuLaunchKernel and are attributed to no range).
With --telemetry the renderer carries a `Telemetry` (its cost: compare
runs with and without it in one call; the output file name gains
`_telemetry`).  Prints the unprofiled time, the spans, the table by
kernel and the card's name and power limit; the lot is also written to
chiprun_out/port_profile.txt (port_profile_<config>.txt with a config
flag).
"""
import os
import subprocess
import sys

import numpy as np


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import libplacebo_tpu_torch as lt
    from torch.profiler import ProfilerActivity, profile

    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    telemetry = "--telemetry" in flags
    flags = [a for a in flags if a != "--telemetry"]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if flags and flags not in (["--config5"], ["--config4"], ["--config2"],
                               ["--config3"], ["--pathA"], ["--pathB"],
                               ["--pathC"], ["--pathD"], ["--pathE"],
                               ["--pathF"], ["--pathG"], ["--pathH"],
                               ["--pathI"]):
        print(f"port_profile: unknown options {flags}", file=sys.stderr)
        return 2
    config = flags[0][2:] if flags else "flagship"
    n = int(args[0]) if args else 4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    H, W = 1080, 1920
    rng = np.random.default_rng(0)
    bits = 10 if config in ("config4", "pathA") else 8
    lo, span_y, span_c = (16, 219, 224) if bits == 8 else (64, 876, 896)
    dt = np.uint8 if bits == 8 else np.uint16
    y = (rng.random((H, W)) * span_y + lo).astype(dt)
    u = (rng.random((H // 2, W // 2)) * span_c + lo).astype(dt)
    v = (rng.random((H // 2, W // 2)) * span_c + lo).astype(dt)
    color, system = lt.CSP_BT2100_PQ, lt.ColorSystem.BT_2020_NC
    params = lt.RenderParams(upscaler="ewa_lanczos")
    if config == "config4":
        color = lt.ColorSpace(lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
                              lt.HdrMetadata(min_luma=0.005,
                                             max_luma=1000.0))
        params = lt.RenderParams(upscaler="ewa_lanczos",
                                 tone_mapping_function="bt2390",
                                 gamut_mapping="softclip")
    elif config in ("config2", "config3"):
        color = lt.ColorSpace(lt.ColorPrimaries.BT_709,
                              lt.ColorTransfer.BT_1886)
        system = lt.ColorSystem.BT_709
        params = lt.RenderParams() if config == "config2" else \
            lt.RenderParams(upscaler="ewa_lanczos4sharpest",
                            antiringing_strength=0.8)
    repr = lt.ColorRepr(sys=system, levels=lt.ColorLevels.LIMITED,
                        bits=lt.BitEncoding(bits, bits, 0))
    target = lt.Target(w=2 * W, h=2 * H, color=lt.CSP_SRGB, bit_depth=8)
    if config in ("pathA", "pathB"):
        from chip_smoke import path_cell
        color, repr, _, target, params = path_cell(lt, config[-1], 2 * W,
                                                   2 * H)
    frame = lt.frame_from_yuv420p(y, u, v, color=color, bit_depth=bits,
                                  repr=repr)
    # every render's frame, built beforehand: config 5's grain, path C's
    # RPU and path D's field change every frame
    count = 2 + 2 * n
    frames = [frame] * count
    if config in ("config5", "pathH"):
        import copy
        from libplacebo_tpu_torch.core.film_grain import sample_grain
        frames = [copy.copy(frame) for _ in range(count)]
        for k, f in enumerate(frames):
            f.film_grain = sample_grain(7391 + k)
        params = lt.RenderParams(upscaler="ewa_lanczos",
                                 deband=lt.DebandParams(iterations=2),
                                 film_grain=True,
                                 error_diffusion="floyd-steinberg")
        if config == "pathH":
            from chip_smoke import path_h_hooks, path_h_params
            params = path_h_params(lt, path_h_hooks(lt, "cuda")[0])
    elif config == "pathC":
        from chip_smoke import path_c_frame, path_c_rpus, path_c_yuv
        yuv = path_c_yuv(1, H, W)[0]
        frames = [path_c_frame(lt, yuv, b, "cuda")
                  for b in path_c_rpus(lt, count)]
        params = lt.RenderParams(upscaler="ewa_lanczos")
    elif config == "pathD":
        from chip_smoke import (_flagship_yuv, path_d_field, path_d_params,
                                path_d_sources)
        sources = path_d_sources(lt, _flagship_yuv(count // 2 + 2, H, W,
                                                   seed=13), "cuda")
        frames = [path_d_field(lt, sources, 1 + k // 2,
                               ("TOP", "BOTTOM")[k % 2])
                  for k in range(count)]
        params = path_d_params(lt)
    elif config == "pathF":
        from chip_smoke import _flagship_yuv, path_f_cell
        color, repr, _, target, params = path_f_cell(lt, 2 * W, 2 * H, 280)
        y, u, v = _flagship_yuv(1, 800, W, seed=19, bits=10)[0]
        frames = [lt.frame_from_yuv420p(y, u, v, color=color, bit_depth=10,
                                        repr=repr)] * count
    r = lt.Renderer()
    if telemetry:
        r.telemetry = lt.Telemetry()
    frame_iter = iter(frames)

    def render():
        r.render(next(frame_iter), target, params)
    if config == "pathE":
        from chip_smoke import (_flagship_yuv, path_e_frames, path_e_mix,
                                path_e_params, PATH_E_SPACING)
        src = path_e_frames(lt, _flagship_yuv(
            int(count / PATH_E_SPACING) + 2, H, W, seed=17, bits=10),
            "cuda", 2 * W)
        params = path_e_params(lt)
        vsyncs = iter(range(count))

        def render():
            lt.render_image_mix(r, path_e_mix(lt, src, next(vsyncs)),
                                target, params)

    if config == "pathG":
        from chip_smoke import (PATH_G_FPS, PATH_G_HZ, PathGDecoder,
                                _flagship_yuv, path_g_params, path_g_update)
        params = path_g_params(lt)
        decoder = PathGDecoder(lt, _flagship_yuv(
            int(count * PATH_G_FPS / PATH_G_HZ) + 4, H, W, seed=23,
            bits=10), "cuda")
        queue = lt.FrameQueue()
        for k in range(len(decoder.yuvs)):
            queue.push(decoder.source(k, decoder.decode(k)))
        queue.push(None)
        vsyncs = iter(range(count))

        def render():
            status, mix = path_g_update(lt, queue, params, next(vsyncs))
            assert status == lt.QueueStatus.OK, status
            lt.render_image_mix(r, mix, target, params)

    if config == "pathI":
        import shutil
        import tempfile
        from chip_smoke import (PathITranscoder, path_i_write_clip,
                                path_i_yuv)
        from libplacebo_tpu_torch import runtime
        tmp = tempfile.mkdtemp(prefix="path_i_")
        src = os.path.join(tmp, "in.y4m")
        path_i_write_clip(src, path_i_yuv(count, 2 * H, 2 * W))
        r = lt.Renderer(ctx=runtime.create())
        if telemetry:
            r.telemetry = lt.Telemetry()
        transcoder = PathITranscoder(lt, src, os.path.join(tmp, "out.y4m"),
                                     r)

        def render():
            assert transcoder.step()
            transcoder.frames.clear()

    for _ in range(2):
        render()
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        render()
    end.record()
    torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            render()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels only (the aten ops above them repeat their device time)
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    table = events.table(sort_by="self_cuda_time_total", row_limit=30)
    spans = [f"{'span':24s} {'calls':>6s} {'host ms':>9s} {'device ms':>9s}"
             "  (a frame)"]
    spans += [f"{e.key:24s} {e.count / n:6.2f} "
              f"{e.cpu_time_total / 1e3 / n:9.3f} "
              f"{e.device_time_total / 1e3 / n:9.3f}"
              for e in sorted(events, key=lambda e: e.key)
              if e.key.startswith("lt.")]
    lines = [card, config,
             f"frames {n} back to back, unprofiled: {window_ms:.3f} ms "
             f"({window_ms / n:.3f} ms/frame)",
             f"device time under the profiler: {dev_ms:.3f} ms "
             f"({dev_ms / n:.3f} ms/frame)",
             "\n".join(spans), table]
    if telemetry:
        r.flush_telemetry()
        lines.insert(3, f"telemetry: {r.telemetry.summary()}")
    if config == "pathI":
        transcoder.close()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "port_profile" + ("" if config == "flagship" else f"_{config}") \
        + ("_telemetry" if telemetry else "") + ".txt"
    with open(os.path.join("chiprun_out", name), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

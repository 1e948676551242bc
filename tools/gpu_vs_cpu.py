#!/usr/bin/env python3
"""The port's renders on the card held against the JAX package's on the
CPU: the end-to-end gate (PSNR >= 45 dB), modelled on tools/tpu_vs_cpu.py.

Two modes:

    python tools/gpu_vs_cpu.py --make-fixtures   # on a CPU host with JAX
    python3 tools/gpu_vs_cpu.py [--device cuda] [--presets a,b] [--out F]

`--make-fixtures` renders every preset through the JAX package on the
CPU (the only mode that imports it) and writes the inputs' seed and size
and the outputs to libplacebo_tpu_torch/data/gpu_vs_cpu.npz: float
outputs as 16-bit codes (round(x * 65535), within 7.7e-6 of the float),
8-bit outputs as their codes, path I's output as the bytes of its y4m
file.  The compare mode (the default) imports neither JAX nor the JAX
package: it re-creates the inputs from the seed with numpy, renders them
through the port on `--device` (the card unless told otherwise), and
prints one JSON line a preset (the largest difference, the share of
values differing by more than 1e-3, PSNR, for 8-bit presets the share
beyond 1.5 LSB, and the kernel launches the render made), then exits 1
if a preset misses its gate.

Presets, at --size 96x192 (outputs 192x384, a width K1 takes):
  hq         HIGH_QUALITY_PARAMS (deband, EWA, contrast recovery: a plain
             tail, as in the reference)
  hq_ar      hq with ewa_lanczos4sharpest + antiringing_strength=0.8
  sep        separable lanczos (K1)
  config5    deband + AV1 film grain + EWA + 8-bit blue-noise dither (K1)
  config5_ed the same with Floyd-Steinberg error diffusion (K1, K2, K3)
  ed_kernel  identical float input through ops.dithering.error_diffusion
             (K3, K2, K3)
  path_i     path I small: a 2-frame 10-bit HDR10 y4m clip at 384x768
             mapped as a decoder's AVFrame, rendered to 192x384 8-bit
             BT.709 SDR, encoded to limited YCbCr, written as a 420jpeg
             y4m; compared code for code

Gates (tools/tpu_vs_cpu.py:270-283): PSNR >= 45 dB on every preset;
float presets differ by more than 1e-3 on at most 1% of values; 8-bit
presets differ by more than 1 LSB on at most 1%; ed_kernel within 1 LSB
everywhere, flipped on at most 5%.
"""
import argparse
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, "libplacebo_tpu_torch", "data",
                        "gpu_vs_cpu.npz")
PRESETS = ("hq", "hq_ar", "sep", "config5", "config5_ed", "ed_kernel",
           "path_i")
EIGHT_BIT = ("config5", "config5_ed", "ed_kernel", "path_i")
PATH_I_FRAMES = 2
GRAIN_SEED = 7391


def _stress_yuv(h, w, seed):
    """tools/tpu_vs_cpu.py's stress frame: a smooth luma ramp under
    extreme random chroma (the gamut predicates' edges)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.1, 0.95, h)[:, None] * np.ones((1, w))
    y = (yy * 219 + 16).astype(np.uint8)
    u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
    return y, u, v


def _ed_input(h, w, seed):
    return np.random.default_rng(seed).random((3, 2 * h, 2 * w)) \
        .astype(np.float32)


def _path_i_source(h, w, seed):
    """Path I's small clip: (4h, 4w) frames, twice the presets' output
    size, as 4K is twice 1080p."""
    import chip_smoke
    return chip_smoke.path_i_yuv(PATH_I_FRAMES, 4 * h, 4 * w, seed)


def _y4m_planes(data: bytes):
    """Every frame's planes of a y4m byte string, flattened and joined."""
    head, _, rest = data.partition(b"\n")
    out = []
    for chunk in rest.split(b"FRAME\n")[1:]:
        out.append(np.frombuffer(chunk, np.uint8))
    return head, np.concatenate(out)


# -- the JAX side (--make-fixtures only) -------------------------------

def _jax_render(preset, h, w, seed):
    """The preset's output through the JAX package on the CPU."""
    import dataclasses
    import jax.numpy as jnp
    from libplacebo_tpu.core.colorspace import (BitEncoding, ColorLevels,
                                                ColorRepr, ColorSystem,
                                                CSP_BT2100_PQ, CSP_SRGB)
    from libplacebo_tpu.ops.deband import DebandParams
    from libplacebo_tpu.render.frame import frame_from_yuv420p
    from libplacebo_tpu.render.renderer import (HIGH_QUALITY_PARAMS,
                                                RenderParams, Renderer,
                                                Target)
    if preset == "ed_kernel":
        from libplacebo_tpu.ops.dithering import error_diffusion
        return np.asarray(error_diffusion(jnp.asarray(_ed_input(h, w, seed)),
                                          8))
    if preset == "path_i":
        import chip_smoke
        from libplacebo_tpu.core.colorspace import (ColorPrimaries,
                                                    ColorSpace,
                                                    ColorTransfer)
        from libplacebo_tpu.ops.color import encode_color
        from libplacebo_tpu.utils import interop, y4m
        src = io.BytesIO()
        with y4m.Y4MWriter(src, 4 * w, 4 * h, fps=chip_smoke.PATH_I_FPS,
                           csp="420p10") as wr:
            for planes in _path_i_source(h, w, seed):
                wr.write(planes)
        src.seek(0)
        target = Target(w=2 * w, h=2 * h, bit_depth=8, color=ColorSpace(
            ColorPrimaries.BT_709, ColorTransfer.BT_1886))
        yuv_repr = ColorRepr(sys=ColorSystem.BT_709,
                             levels=ColorLevels.LIMITED,
                             bits=BitEncoding(8, 8, 0))
        r = Renderer()
        dst = io.BytesIO()
        rd = y4m.Y4MReader(src)
        with y4m.Y4MWriter(dst, 2 * w, 2 * h, fps=chip_smoke.PATH_I_FPS,
                           csp="420jpeg") as wr:
            while (raw := rd.read_raw()) is not None:
                frame = interop.frame_from_avframe_like(
                    chip_smoke.path_i_avframe(raw))
                out = r.render(frame, target, RenderParams())
                wr.write(np.asarray(encode_color(out, yuv_repr)))
        return np.frombuffer(dst.getvalue(), np.uint8)

    y, u, v = _stress_yuv(h, w, seed)
    frame = frame_from_yuv420p(
        y, u, v, color=CSP_BT2100_PQ,
        repr=ColorRepr(sys=ColorSystem.BT_2020_NC,
                       levels=ColorLevels.LIMITED, bits=BitEncoding(8, 8, 0)))
    bit_depth = 8 if preset.startswith("config5") else 0
    target = Target(w=2 * w, h=2 * h, color=CSP_SRGB, bit_depth=bit_depth)
    if preset.startswith("config5"):
        from tests.test_film_grain import DATA as GRAIN_DATA
        assert GRAIN_DATA.seed == GRAIN_SEED
        frame.film_grain = GRAIN_DATA
        params = RenderParams(
            upscaler="ewa_lanczos", deband=DebandParams(iterations=2),
            film_grain=True,
            error_diffusion=("floyd-steinberg" if preset == "config5_ed"
                             else None))
    elif preset == "hq":
        params = HIGH_QUALITY_PARAMS
    elif preset == "hq_ar":
        params = dataclasses.replace(HIGH_QUALITY_PARAMS,
                                     upscaler="ewa_lanczos4sharpest",
                                     antiringing_strength=0.8)
    else:
        params = RenderParams(upscaler="lanczos")
    return np.asarray(Renderer()._render_once(frame, target, params))


def _encode(preset, out):
    """A preset's output as stored: 8-bit codes, y4m bytes, or 16-bit
    codes of a float image."""
    if preset == "path_i":
        return np.asarray(out, np.uint8)
    if preset in EIGHT_BIT:
        codes = np.rint(np.asarray(out, np.float64) * 255.0)
        assert np.abs(codes - np.asarray(out, np.float64) * 255.0).max() \
            < 1e-3, preset
        return codes.astype(np.uint8)
    return np.clip(np.rint(np.asarray(out, np.float64) * 65535.0), 0,
                   65535).astype(np.uint16)


def make_fixtures(h, w, seed, path=FIXTURES):
    import jax
    jax.config.update("jax_platforms", "cpu")
    arrays = {"seed": np.int64(seed), "size": np.array([h, w], np.int64)}
    for preset in PRESETS:
        arrays[preset] = _encode(preset, _jax_render(preset, h, w, seed))
        print(f"{preset}: {arrays[preset].dtype} {arrays[preset].shape}",
              flush=True)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


# -- the port's side (the compare mode) --------------------------------

def port_render(preset, h, w, seed, device):
    """The preset's output through the port on `device`, as a host array
    (float, 8-bit values in [0, 1], or path I's y4m bytes), and the
    kernel launches the render made."""
    import dataclasses
    import torch
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch import runtime
    from libplacebo_tpu_torch.core.film_grain import sample_grain
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    from libplacebo_tpu_torch.ops.cuda import error_diffusion as k2
    from libplacebo_tpu_torch.ops.cuda import shear as k3
    counters = {"k1": k1, "k2": k2, "k3": k3}
    for mod in counters.values():
        mod.launches = 0
    dev = torch.device(device)
    if preset == "ed_kernel":
        from libplacebo_tpu_torch.ops.dithering import error_diffusion
        out = error_diffusion(torch.from_numpy(_ed_input(h, w, seed)).to(dev),
                              8).cpu().numpy()
    elif preset == "path_i":
        import tempfile
        import chip_smoke
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "in.y4m")
            dst = os.path.join(tmp, "out.y4m")
            chip_smoke.path_i_write_clip(src, _path_i_source(h, w, seed))
            ctx = runtime.create(device=dev)
            chip_smoke.path_i_transcode(lt, src, dst, lt.Renderer(ctx=ctx))
            with open(dst, "rb") as f:
                out = np.frombuffer(f.read(), np.uint8)
    else:
        y, u, v = _stress_yuv(h, w, seed)
        frame = lt.frame_from_yuv420p(
            y, u, v, color=lt.CSP_BT2100_PQ, device=dev,
            repr=lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                              levels=lt.ColorLevels.LIMITED,
                              bits=lt.BitEncoding(8, 8, 0)))
        bit_depth = 8 if preset.startswith("config5") else 0
        target = lt.Target(w=2 * w, h=2 * h, color=lt.CSP_SRGB,
                           bit_depth=bit_depth)
        if preset.startswith("config5"):
            frame.film_grain = sample_grain(GRAIN_SEED)
            params = lt.RenderParams(
                upscaler="ewa_lanczos", deband=lt.DebandParams(iterations=2),
                film_grain=True,
                error_diffusion=("floyd-steinberg" if preset == "config5_ed"
                                 else None))
        elif preset == "hq":
            params = lt.HIGH_QUALITY_PARAMS
        elif preset == "hq_ar":
            params = dataclasses.replace(lt.HIGH_QUALITY_PARAMS,
                                         upscaler="ewa_lanczos4sharpest",
                                         antiringing_strength=0.8)
        else:
            params = lt.RenderParams(upscaler="lanczos")
        out = lt.Renderer(dev)._render_once(frame, target, params) \
            .cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, {name: mod.launches for name, mod in counters.items()}


def compare(preset, ref, got):
    """The gate's figures for one preset and whether it passes."""
    if preset == "path_i":
        head_r, ref = _y4m_planes(ref.tobytes())
        head_g, got = _y4m_planes(np.asarray(got, np.uint8).tobytes())
        if head_r != head_g or ref.shape != got.shape:
            return {"preset": preset, "header_ref": head_r.decode(),
                    "header_got": head_g.decode()}, False
        ref = ref.astype(np.float64) / 255.0
        got = got.astype(np.float64) / 255.0
    elif preset in EIGHT_BIT:
        # both sides as codes: the port's float32 code / 255 is a few
        # ulp from the float64 one
        codes = np.rint(np.asarray(got, np.float64) * 255.0)
        if np.abs(codes - np.asarray(got, np.float64) * 255.0).max() > 1e-3:
            return {"preset": preset, "error": "not 8-bit codes"}, False
        ref = ref.astype(np.float64) / 255.0
        got = codes / 255.0
    else:
        ref = ref.astype(np.float64) / 65535.0
    diff = np.abs(np.asarray(got, np.float64) - ref)
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    frac = float((diff > 1e-3).mean())
    line = {"preset": preset, "max": float(diff.max()),
            "frac_gt_1e3": frac, "psnr_db": float(psnr)}
    if preset == "ed_kernel":
        line["bit_exact"] = bool(diff.max() == 0.0)
        line["max_lsb"] = float(diff.max()) * 255.0
        ok = psnr >= 45.0 and line["max_lsb"] <= 1.001 and frac <= 0.05
    elif preset in EIGHT_BIT:
        line["frac_gt_1lsb"] = float((diff > 1.5 / 255.0).mean())
        ok = psnr >= 45.0 and line["frac_gt_1lsb"] <= 0.01
    else:
        ok = psnr >= 45.0 and frac <= 0.01
    return line, ok


def run(device="cuda", presets=PRESETS, path=FIXTURES):
    """Every preset through the port on `device` against the fixtures:
    ([result line, ...], all passed)."""
    fx = np.load(path)
    seed = int(fx["seed"])
    h, w = (int(v) for v in fx["size"])
    lines, ok_all = [], True
    for preset in presets:
        got, launches = port_render(preset, h, w, seed, device)
        line, ok = compare(preset, fx[preset], got)
        line.update(launches=launches, ok=ok)
        lines.append(line)
        ok_all &= ok
    return lines, ok_all


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make-fixtures", action="store_true",
                    help="render the presets through the JAX package on "
                         "the CPU and write the fixture file")
    ap.add_argument("--size", default="96x192",
                    help="source HxW for --make-fixtures (default 96x192)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--presets", default=",".join(PRESETS))
    ap.add_argument("--out", default=None,
                    help="also write the result lines to a JSON file")
    args = ap.parse_args()
    if args.make_fixtures:
        h, w = (int(t) for t in args.size.split("x"))
        make_fixtures(h, w, args.seed)
        return 0
    lines, ok = run(args.device, [p for p in args.presets.split(",") if p])
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": args.device, "presets": lines}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

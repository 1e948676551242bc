#!/usr/bin/env python3
"""Where the time of a runtime-dispatch K1 generic instance goes, on the
card: one library for every generic tail, each launch passing the
tail's part ids, matrix-row mix codes and fit-row masks as runtime
values (the design csrc/color_map.cu had before the generic instance was
compiled once a tail, as of commit 5240eec; give that file as --source).

It runs path I's tail (BT.2020 PQ 1000 nits -> BT.709 BT.1886 8-bit,
spline + perceptual, peak partials, ordered dither) at 1920x1080 on that
instance and on variants of it that make one group of those values
compile-time constants at a time (the mix codes, the part ids, the row
masks, the first two, all three), beside this tree's own instance of
the tail (`color_map.prepare`) and the templated flagship <1, 2, true>
on the same input.  Each is held bit for bit against the plain version
(histograms equal), timed with CUDA events in turns (4 rounds of 50
launches), and its pixel loop read from the SASS (`_sass.loop_mix`:
every instruction of the loop once, both sides of a branch), with
ptxas's registers, stack and spills.

    python3 -m libplacebo_tpu_torch.tools.k1_split --source OLD.cu \
        [--json OUT.json]

Exits non-zero without a CUDA device (nothing is measured on the CPU).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

W, H = 1920, 1080
ROUNDS, REPS = 4, 50
# variant -> (mix codes, part ids, row masks) made constants
VARIANTS = {"runtime": (False, False, False),
            "mix": (True, False, False),
            "mode": (False, True, False),
            "masks": (False, False, True),
            "mix_mode": (True, True, False),
            "all": (True, True, True)}


def variant_source(old: str, mode, mix, rows, const_mix: bool,
                   const_mode: bool, const_masks: bool) -> str:
    """The runtime-dispatch source with the chosen groups of launch
    values replaced by constants of this tail (the kernel's parameters
    stay, unread)."""
    text = old
    if const_mix:
        hook = ("template <int OFF, int CODE>\n__device__ __forceinline__ "
                "void gmat(")
        assert text.count(hook) == 1, "not the runtime-dispatch source"
        text = text.replace(hook, "__host__ __device__ constexpr int "
                            "gmix_c(int i) {\n  constexpr int t[27] = {" +
                            ", ".join(str(c) for c in mix) +
                            "};\n  return t[i];\n}\n" + hook)
        for s in ("CODE", "CODE + 1", "CODE + 2"):
            assert text.count(f"(int)G(g_mix, {s})") == 1
            text = text.replace(f"(int)G(g_mix, {s})", f"gmix_c({s})")
    sig = ("int block_rows, int src_kept,\n           int dst_kept, "
           "int src_swap, int dst_swap,\n           const __grid_constant__ "
           "K1Mode md) {")
    assert text.count(sig) == 1, "not the runtime-dispatch source"
    sfx = "_rt" if const_masks else ""
    new = (f"int block_rows, int src_kept{sfx}, int dst_kept{sfx}, "
           f"int src_swap{sfx}, int dst_swap{sfx}, const __grid_constant__ "
           f"K1Mode md{'_rt' if const_mode else ''}) {{\n")
    if const_masks:
        new += (f"  constexpr int src_kept = {rows[0]}, dst_kept = "
                f"{rows[1]}, src_swap = {rows[2]}, dst_swap = {rows[3]};\n")
    if const_mode:
        new += "  constexpr K1Mode md{" + ", ".join(str(v) for v in mode) + \
            "};\n"
    return text.replace(sig, new)


def _cuda_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def _tail(lt, k1, trender, dev, transfer):
    """(plan, tone vector, dither LUT) of the tail from BT.2020 PQ (1000
    nits) into BT.709 `transfer` 8-bit, planned on the CPU."""
    import torch
    from ..core import colorspace as tcs
    from ..core.common import RectF
    from ..ops import tone_dynamic as ops_tone
    hdr = lt.ColorSpace(lt.ColorPrimaries.BT_2020, lt.ColorTransfer.PQ,
                        lt.HdrMetadata(min_luma=0.005, max_luma=1000.0))
    dst = lt.ColorSpace(lt.ColorPrimaries.BT_709, transfer)
    params = lt.RenderParams()
    s, d = tcs.color_space_infer_map(hdr, dst)
    target = lt.Target(w=W, h=H, color=dst, bit_depth=8)
    run = lt.Renderer(device="cpu")._fused_tail(params, s, d, target, True,
                                                W, H, RectF(0, 0, W, H))
    chain = trender.color_chain(s, d, params, True)
    tone = ops_tone.tone_vector("spline", torch.tensor(0.72),
                                torch.tensor(0.3), chain.dst_min_pq,
                                chain.dst_max_pq, params.tone_constants)
    return run.plan, tone.to(dev), run.lut.to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True,
                    help="the runtime-dispatch csrc/color_map.cu")
    ap.add_argument("--json", help="write the figures here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_split: no CUDA device", file=sys.stderr)
        return 1
    import libplacebo_tpu_torch as lt
    from .. import _build, _sass
    from ..ops.cuda import color_map as k1
    from ..render import renderer as trender
    from .bench_micro import k1_bound

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    noise = torch.rand((3, H, W), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(29))
    img = noise * 30.0
    plan, tone, lut = _tail(lt, k1, trender, dev,
                            lt.ColorTransfer.BT_1886)
    fplan, ftone, flut = _tail(lt, k1, trender, dev, lt.ColorTransfer.SRGB)
    assert plan.tone == k1.GENERIC and (fplan.tone, fplan.gamut) == (1, 2)
    g_args, f_args = (img, plan, tone, lut), (img, fplan, ftone, flut)
    mode = tuple(plan.generic.mode)
    mix = [int(v) for v in plan.consts[k1._OFF["g_mix"]:
                                       k1._OFF["g_mix"] + 27]]
    rows = tuple(plan.rows)[:4]

    # the variants of the runtime-dispatch design, built side by side
    # with this tree's instance of the tail and the flagship's library
    with open(args.source) as f:
        old = f.read()
    srcdir = os.path.join(_build.BUILD_DIR, "k1_split")
    os.makedirs(srcdir, exist_ok=True)
    specs = []
    for name, groups in VARIANTS.items():
        path = os.path.join(srcdir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(old, mode, mix, rows, *groups))
        specs.append((f"k1_split_{name}", [path], _build.nvcc_path(),
                      k1.kernel_flags() + ["-DK1_TONE=-1"]))
    t0 = time.perf_counter()
    paths = _build.build_all(specs + k1.build_specs(generic=[plan]))
    build_s = time.perf_counter() - t0
    libs = {}
    for name, path in zip(VARIANTS, paths):
        lib = ctypes.CDLL(path)
        lib.k1_generic_launch.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 17 + [ctypes.c_void_p]
        lib.k1_generic_launch.restype = ctypes.c_int
        libs[name] = lib
    bh = k1.pick_block_rows(H)
    stripes = H // bh

    def launch(name):
        out = torch.empty_like(img)
        sub = torch.empty((stripes, W // 128, 67), device=dev)
        part = torch.empty((stripes, 8, 128), device=dev)
        r = plan.rows
        rc = libs[name].k1_generic_launch(
            img.data_ptr(), out.data_ptr(), sub.data_ptr(), part.data_ptr(),
            plan.consts.ctypes.data, tone.data_ptr(), lut.data_ptr(),
            lut.shape[0], H, W, bh, r.src_kept, r.dst_kept, r.src_swap,
            r.dst_swap, *mode, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out, part

    runs = {name: (lambda n=name: launch(n)) for name in VARIANTS}
    runs["specialized"] = lambda: k1.color_map_tail(*g_args)
    runs["flagship"] = lambda: k1.color_map_tail(*f_args)
    shape_of = {name: (libs[name]._name, "k1_generic") for name in VARIANTS}
    shape_of["specialized"] = (k1.prepare(plan)._name, "k1_generic")
    shape_of["flagship"] = (k1._kernel_lib(1)._name,
                            k1.instance_name(1, 2, True))
    ref, rpart = k1.tail_plain(*g_args)
    res = {"card": card, "size": [W, H], "mode": list(mode), "mix": mix,
           "rows": list(rows), "build_s": build_s, "runs": {}}
    for name, run in runs.items():
        out, part = run()
        torch.cuda.synchronize()
        lib_path, fn = shape_of[name]
        loop = _sass.loop_mix(_sass.disassemble(lib_path), fn)
        with open(f"{lib_path}.log") as f:
            report = [v for n, v in _sass.ptxas_report(f.read()).items()
                      if fn in n]
        res["runs"][name] = {
            "bit_exact": None if name == "flagship" else bool(
                torch.equal(out, ref) and
                torch.equal(part[:, 0, :64], rpart[:, 0, :64])),
            "sass_per_pixel": loop["per_iteration"],
            "static_instructions": loop["static_instructions"],
            "classes": loop["classes"], "inner_loops": loop["inner_loops"],
            "ptxas": report, "ms": []}
    order = list(runs)
    for rnd in range(ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            res["runs"][name]["ms"].append(_cuda_ms(torch, runs[name]))
    # the SM clock under load, for the instruction floors
    for _ in range(1000):
        runs["runtime"]()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    torch.cuda.synchronize()
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    res["sm_clock_mhz"] = mhz
    for v in res["runs"].values():
        v["ms_median"] = sorted(v["ms"])[len(v["ms"]) // 2]
        v["instruction_floor_ms"] = v["sass_per_pixel"] * W * H / (
            lanes * mhz * 1e6) * 1e3
    _, part = runs["runtime"]()
    res["bound_ms"] = k1_bound(*g_args, part, k1.ops_per_pixel(
        plan.consts, plan.instance))
    res["flagship_bound_ms"] = k1_bound(*f_args, part, k1.ops_per_pixel(
        fplan.consts, fplan.instance))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card)
    for name, v in res["runs"].items():
        print(f"{name:12s} {v['ms_median']:.4f} ms (rounds "
              f"{[round(m, 4) for m in v['ms']]}), SASS "
              f"{v['sass_per_pixel']} a pixel ({v['static_instructions']} "
              f"in the loop), floor {v['instruction_floor_ms']:.4f} ms, "
              f"ptxas {v['ptxas']}, exact {v['bit_exact']}")
    print(f"bound {res['bound_ms']}, flagship bound "
          f"{res['flagship_bound_ms']}, SM {mhz:g} MHz, built in "
          f"{build_s:.1f} s")
    bad = [n for n, v in res["runs"].items() if v["bit_exact"] is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""The rank side of the port's multi-rank tests (tests/test_torch_parallel_*.py).

No jax here: each rank is a process of its own, spawned by
`spawn_ranks` with a gloo group on a file store, and runs a file's
cases on its (data, spatial) mesh of the port.  A case is a spec (plain
data, in `cases.json` of the work directory); `objects(ns, spec, data)`
turns a spec into frames, target, params and step inputs for either
package (`ns` is a namespace of the package's classes), so the JAX
reference values, computed once in the pytest process and handed over
as `<case>.npz`, come from the same spec.  Each rank writes
`result_<rank>.json`: per case "ok" or the traceback.

Gates (rank 0 checks them on the gathered outputs):
- against the port's single-device Renderer: the halo leg of
  __graft_entry__._assert_parity (at most 1e-4 of the values differ,
  each by exactly one LSB; a float output within 1e-5 everywhere); the
  replicated step bit for bit;
- the peak state within 1e-6 of the single-device renderer's whole-frame
  detection (its plain tail, `disable_fused_colormap`): the sharded
  detection is the reference's 16x16 tiles, K1's fused detection 8-row
  stripes (ROADMAP §3, F5);
- against the JAX package's sharded pipeline: the port's single-device
  gates for the same render — dithered: < 1.2e-3 of the 8-bit values
  differ, <= 1e-4 beyond one LSB (ROADMAP §3, F1; error diffusion's
  own record); every value within the port's single-device difference
  from the reference there, plus 1e-5 (one LSB dithered; the
  reference's own bound where its sharded leg is not exact: F6) — and
  the state within 1e-6.
"""
from __future__ import annotations

import json
import os
import traceback
from datetime import timedelta
from types import SimpleNamespace

import numpy as np

LSB = 1.0 / 255.0


# ---------------------------------------------------------------------------
# Content, made from seeds with numpy (both packages read the same arrays)
# ---------------------------------------------------------------------------

def flagship_yuv(n, h, w, seed):
    """tests/test_parallel.py::_flagship_frames' planes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
        u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        out.append((y, u, v))
    return out


H274_MODELS = dict(
    model_id=0, blending_mode_id=0, log2_scale_factor=2,
    component_model_present=(True, True, True),
    num_intensity_intervals=(2, 1, 1), num_model_values=(3, 2, 3),
    intensity_interval_lower_bound=((0, 128), (0,), (0,)),
    intensity_interval_upper_bound=((127, 255), (255,), (200,)),
    comp_model_value=(((100, 8, 8), (60, 10, 6)), ((80, 5),),
                      ((70, 4, 12),)))

LUT_CUBE = ("LUT_3D_SIZE 2\n0 0 0\n1 0 0.1\n0 1 0\n1 1 0\n0 0 1\n"
            "0.9 0 1\n0 1 1\n1 1 1\n")


def port_ns():
    """The port's classes, as `objects` reads them."""
    import torch
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.core import film_grain as cfg
    from libplacebo_tpu_torch.core.colorspace import (ColorAdjustment, Cone,
                                                      ConeParams)
    from libplacebo_tpu_torch.core.film_grain import H274GrainData
    ns = SimpleNamespace(**{k: getattr(lt, k) for k in (
        "RenderParams", "Target", "RectF", "PeakDetectParams",
        "DebandParams", "DeinterlaceParams", "DeinterlaceAlgo", "Field",
        "parse_cube", "user_shader_hook", "Overlay", "Rotation",
        "CSP_BT2100_PQ", "CSP_SRGB", "ColorRepr", "ColorSystem",
        "ColorLevels", "BitEncoding", "FilmGrainData")})
    ns.ColorAdjustment, ns.Cone, ns.ConeParams = (ColorAdjustment, Cone,
                                                  ConeParams)
    ns.H274GrainData = H274GrainData
    ns.av1_grain = cfg.sample_grain
    ns.frame = lambda y, u, v, **kw: lt.frame_from_yuv420p(
        y, u, v, device="cpu", **kw)
    ns.array = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return ns


def _params(ns, p: dict, hooks):
    kw = dict(p)
    if "peak_detect" in kw and kw["peak_detect"] is not None:
        kw["peak_detect"] = ns.PeakDetectParams(**kw["peak_detect"])
    if "deband" in kw:
        kw["deband"] = ns.DebandParams(**kw["deband"])
    if "deinterlace" in kw:
        kw["deinterlace"] = ns.DeinterlaceParams(
            algo=getattr(ns.DeinterlaceAlgo, kw["deinterlace"]))
    if "cone" in kw:
        kw["cone"] = ns.ConeParams(getattr(ns.Cone, kw["cone"][0]),
                                   kw["cone"][1])
    if "color_adjustment" in kw:
        kw["color_adjustment"] = ns.ColorAdjustment(
            **kw["color_adjustment"])
    if kw.pop("lut", False):
        kw["lut"] = ns.parse_cube(LUT_CUBE)
    if "blend" in kw:
        kw["blend"] = tuple(kw["blend"])
    if hooks:
        kw["hooks"] = tuple(ns.user_shader_hook(t) for t in hooks)
    return ns.RenderParams(**kw)


def objects(ns, spec: dict, data: int) -> dict:
    """A spec's frames, target, params and global step inputs for the
    package `ns`.  The frames carry every attribute the single-device
    renderer reads (rotation, crop, grain, fields, overlays)."""
    per = spec.get("per_lane", 1)
    B = per * data
    h, w = spec["h"], spec["w"]
    repr_ = ns.ColorRepr(sys=getattr(ns.ColorSystem, spec.get(
        "system", "BT_2020_NC")), levels=ns.ColorLevels.LIMITED,
        bits=ns.BitEncoding(8, 8, 0))
    kw = dict(repr=repr_)
    if spec.get("hdr", True):
        kw["color"] = ns.CSP_BT2100_PQ
    yuvs = flagship_yuv(B, h, w, spec["seed"])
    frames = [ns.frame(*f, **kw) for f in yuvs]
    crop_t = spec.get("target_crop")
    target = ns.Target(w=spec["tw"], h=spec["th"], color=ns.CSP_SRGB,
                       bit_depth=spec.get("bits", 0),
                       crop=ns.RectF(*crop_t) if crop_t else None)
    params = _params(ns, spec["params"], spec.get("hooks"))
    build, glob = {}, {}
    rot = spec.get("rotation", 0)
    if rot:
        build["rotation"] = rot
        for f in frames:
            f.rotation = ns.Rotation(rot)
    if spec.get("crop"):
        c = ns.RectF(*spec["crop"])
        build["crop"] = c
        for f in frames:
            f.crop = c
    grain = spec.get("grain")
    if grain == "av1":
        for i, f in enumerate(frames):
            f.film_grain = ns.av1_grain(7391)
        build["frame_grain"] = frames[0].film_grain
    elif grain == "h274":
        g = ns.FilmGrainData(type="h274", seed=spec["seed"],
                             h274=ns.H274GrainData(**H274_MODELS))
        for f in frames:
            f.film_grain = g
        build["frame_grain"] = g
    if spec.get("deinterlace"):
        prev = flagship_yuv(B, h, w, spec["seed"] + 1)
        nxt = flagship_yuv(B, h, w, spec["seed"] + 2)
        build.update(field=ns.Field.TOP, first_field=ns.Field.TOP,
                     has_temporal=True)
        pf = [ns.frame(*p, **kw) for p in prev]
        nf = [ns.frame(*p, **kw) for p in nxt]
        for f, p, nx in zip(frames, pf, nf):
            f.field = f.first_field = ns.Field.TOP
            f.prev, f.next = p, nx
        glob["prev_planes"] = [np.stack([np.asarray(f.planes[i].data)
                                         for f in pf])
                               for i in range(len(pf[0].planes))]
        glob["next_planes"] = [np.stack([np.asarray(f.planes[i].data)
                                         for f in nf])
                               for i in range(len(nf[0].planes))]
    ovs = []
    for k, (shape, rect) in enumerate(spec.get("overlays", ())):
        rng = np.random.default_rng(100 + k)
        ovs.append((rng.random(shape).astype(np.float32), rect))
    if ovs:
        objs = tuple(ns.Overlay(data=ns.array(d), rect=ns.RectF(*r))
                     for d, r in ovs)
        for f in frames:
            f.overlays = list(objs)
        build["overlays"] = objs
        glob["overlay_datas"] = [np.stack([d] * B) for d, _ in ovs]
    if spec.get("target_data"):
        rng = np.random.default_rng(spec["seed"])
        glob["target_data"] = (rng.random((B, 3, spec["th"], spec["tw"]))
                               * 0.4).astype(np.float32)
    planes = [np.stack([np.asarray(f.planes[i].data) for f in frames])
              for i in range(len(frames[0].planes))]
    return dict(frames=frames, target=target, params=params, build=build,
                planes=planes, glob=glob)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def halo_gate(out, ref, lsb, what, loose=None):
    """The halo leg of __graft_entry__._assert_parity; `loose` = (the
    fraction of values that may differ, their largest difference) where
    a recorded rounding divergence (ROADMAP §3, F7) sets it instead."""
    diff = np.abs(out - ref)
    print(f"HALO {what}: max {diff.max():.3e} >1e-5 {(diff > 1e-5).mean():.3e}")
    if loose is not None:
        assert (diff > 1e-5).mean() <= loose[0], \
            f"{what}: {(diff > 1e-5).mean():.3%} values differ"
        assert diff.max() <= loose[1], f"{what}: max {diff.max():.2e}"
        return
    bad = diff > 1e-5
    assert bad.mean() <= 1e-4, f"{what}: {bad.mean():.3%} values differ"
    if bad.any():
        np.testing.assert_allclose(diff[bad], lsb, atol=1e-6,
                                   err_msg=what)


def jax_gate(out, ref, bits, what, single=None, tol=None,
             fracs=(1.2e-3, 1e-4)):
    """The port's single-device gates against the JAX package.
    Dithered: `fracs` = (the fraction of values that may differ, the
    fraction that may differ by more than one LSB), F1's by default,
    error diffusion's record for it (ROADMAP §3).  With `single` = (the port's, the JAX
    package's) single-device renders of the frame: every value of the
    sharded pair differs by at most the single-device pair's difference
    there plus `tol` (default: one LSB dithered, 1e-5 float) — F6: the
    port's single-device divergence from the reference on undithered
    HDR tails (ROADMAP §3), which the sharding must not widen."""
    diff = np.abs(out - ref)
    if bits:
        lsb = 1.0 / ((1 << bits) - 1)
        assert (diff > 1e-6).mean() < fracs[0], \
            f"{what}: {(diff > 1e-6).mean():.3%} values differ"
        assert (diff > lsb + 1e-6).mean() <= fracs[1], \
            f"{what}: {(diff > lsb + 1e-6).mean():.3%} beyond 1 LSB"
    if single is not None:
        tol = tol if tol is not None else \
            (1.0 / ((1 << bits) - 1) + 1e-6 if bits else 1e-5)
        d1 = np.abs(single[0] - single[1])
        over = diff - d1
        assert over.max() <= tol, \
            f"{what}: {over.max():.2e} beyond the single-device pair's " \
            f"difference on {(over > tol).mean():.3%} of values"


# ---------------------------------------------------------------------------
# The rank side of a case
# ---------------------------------------------------------------------------

class Ctx:
    def __init__(self, mesh, workdir):
        self.mesh = mesh
        self.workdir = workdir
        self.rank0 = mesh.rank == 0

    def ref(self, name):
        return np.load(os.path.join(self.workdir, name + ".npz"))


def _step_inputs(mesh, ob):
    """The step's local inputs from a spec's global ones."""
    from libplacebo_tpu_torch.ops import film_grain as ops_fg
    from libplacebo_tpu_torch.parallel import shard_planes
    from libplacebo_tpu_torch.render.renderer import Renderer
    kw = {}
    g = ob["glob"]
    bl = ob["planes"][0].shape[0] // mesh.data
    mine = range(mesh.data_index * bl, (mesh.data_index + 1) * bl)
    for k in ("prev_planes", "next_planes"):
        if k in g:
            kw[k] = shard_planes(mesh, g[k])
    if "target_data" in g:
        kw["target_data"] = shard_planes(mesh, [g["target_data"]])[0]
    if "overlay_datas" in g:
        import torch
        kw["overlay_datas"] = tuple(torch.from_numpy(d[list(mine)])
                                    for d in g["overlay_datas"])
    f0 = ob["frames"][0]
    if "frame_grain" in ob["build"] and \
            ob["build"]["frame_grain"].type == "av1":
        metas = f0.meta_key()[0]
        cfgs, _ = Renderer(device="cpu")._grain_cfgs(metas, f0.repr,
                                                     f0.film_grain)
        kw["grain_tables"] = [tuple(
            ops_fg.prepare_av1_grain(ob["frames"][b].film_grain, c,
                                     m[0][-2], m[0][-1], "cpu")
            if c else None for c, m in zip(cfgs, metas)) for b in mine]
    return kw


def single_device(ob, b, params=None):
    """The port's single-device render of frame b (and its state)."""
    from dataclasses import replace
    import libplacebo_tpu_torch as lt
    r = lt.Renderer(device="cpu")
    tgt = ob["target"]
    if "target_data" in ob["glob"]:
        tgt = replace(tgt, data=ob["glob"]["target_data"][b])
    out = r.render(ob["frames"][b], tgt, params or ob["params"])
    return out.numpy(), r._peak_state.numpy().copy()


def run_render(ctx, name, spec):
    """Build the sharded step for the spec, run it, hold the gathered
    output against the JAX reference and the port's single device."""
    from dataclasses import replace
    from libplacebo_tpu_torch.parallel import (build_sharded_pipeline,
                                               gather_rows, shard_planes,
                                               sharded_state_init)
    from libplacebo_tpu_torch.parallel.analysis import collective_stats
    mesh = ctx.mesh
    ns = port_ns()
    ob = objects(ns, spec, mesh.data)
    f0 = ob["frames"][0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, ob["target"], ob["params"],
                                  **ob["build"])
    assert step.route == spec["route"], (step.route, step.reason)
    xs = shard_planes(mesh, ob["planes"])
    B = ob["planes"][0].shape[0]
    state = sharded_state_init(mesh, B)
    kw = _step_inputs(mesh, ob)
    stats = collective_stats(step, state, *xs, **kw)
    res = step(state, *xs, **kw)
    out, new_state = res[0], res[1]
    th = ob["target"].h
    out_g = gather_rows(mesh, out, rows=th).numpy()
    st_g = gather_rows(mesh, new_state.unsqueeze(-2),
                       rows=1).numpy()[:, 0]
    if not ctx.rank0:
        return stats
    assert np.isfinite(out_g).all()
    bits = spec.get("bits", 0)
    lsb = 1.0 / ((1 << bits) - 1) if bits else 0.0
    jref = ctx.ref(name)
    use_peak = spec["params"].get("peak_detect", {}) is not None and \
        spec.get("hdr", True)
    for b in range(B):
        ref, st_single = single_device(ob, b)
        if spec["route"] == "replicated":
            np.testing.assert_array_equal(out_g[b], ref,
                                          err_msg=f"{name} frame {b}")
            np.testing.assert_array_equal(st_g[b], st_single,
                                          err_msg=f"{name} state {b}")
        else:
            halo_gate(out_g[b], ref, lsb, f"{name} frame {b}",
                      spec.get("halo_loose"))
        jax_gate(out_g[b], jref["out"][b], bits, f"{name} vs JAX frame {b}",
                 (ref, jref["single"][b]), spec.get("jax_tol"),
                 tuple(spec.get("jax_fracs", (1.2e-3, 1e-4))))
        if use_peak and spec["route"] == "halo":
            ob2 = objects(ns, spec, mesh.data)
            _, st_ref = single_device(ob2, b, replace(
                ob2["params"], disable_fused_colormap=True))
            np.testing.assert_allclose(st_g[b], st_ref, atol=1e-6,
                                       err_msg=f"{name} state {b}")
            np.testing.assert_allclose(st_g[b], jref["state"][b],
                                       atol=1e-6,
                                       err_msg=f"{name} state vs JAX {b}")
    bounds = spec.get("bounds")
    if bounds:
        check_bounds(stats, bounds, spec, mesh, B, ob["planes"])
    return stats


def check_bounds(stats, bounds, spec, mesh, B, planes=()):
    """The collective bounds of tests/test_parallel.py, on the port's
    recorder."""
    b_l = B // mesh.data
    if "no_gather" in bounds:
        assert "all-gather" not in stats, stats
        assert "all-to-all" not in stats, stats
        assert stats.get("collective-permute", {}).get("count", 0) > 0, \
            stats
    if "permute_quarter" in bounds:
        local_out = 3 * (spec["th"] // mesh.spatial) * spec["tw"] * 4
        # the reference's bound is on its batched collectives; the port
        # exchanges a frame at a time
        assert stats["collective-permute"]["max_bytes"] <= \
            b_l * local_out / 4, stats
    if "reduce_small" in bounds:
        assert stats.get("all-reduce", {}).get("max_bytes", 0) <= 4096, \
            stats
    if "gather_one_frame" in bounds:
        # each frame's planes gathered once: one source frame a device
        src_bytes = sum(int(np.prod(p.shape[1:])) * 4 for p in planes)
        assert stats["all-gather"]["total_bytes"] <= b_l * src_bytes, stats
        assert stats["all-gather"]["max_bytes"] <= src_bytes, stats
    if "rot90_block" in bounds:
        assert "all-gather" not in stats, stats
        frame_bytes = 3 * spec["th"] * spec["tw"] * 4
        total = sum(s["total_bytes"] for s in stats.values())
        assert total <= b_l * frame_bytes, (total, stats)


def run_extend_rows(ctx, name, spec):
    import torch
    from libplacebo_tpu_torch.parallel.halo import extend_rows
    mesh = ctx.mesh
    n = mesh.spatial
    rng = np.random.default_rng(spec["seed"])
    x = rng.random((2, 8 * n, 5)).astype(np.float32)
    hl = x.shape[-2] // n
    blk = torch.from_numpy(x[..., mesh.spatial_index * hl:
                             (mesh.spatial_index + 1) * hl, :].copy())
    ref = ctx.ref(name)
    for mode in ("edge", "reflect", "wrap"):
        for halo in (1, 3, hl - 1):
            got = extend_rows(blk, halo, mesh, mode).numpy()
            want = ref[f"{mode}_{halo}"][..., mesh.spatial_index *
                                         (hl + 2 * halo):
                                         (mesh.spatial_index + 1) *
                                         (hl + 2 * halo), :]
            np.testing.assert_array_equal(got, want, err_msg=(mode, halo))
            pad = {"edge": "edge", "reflect": "reflect", "wrap": "wrap"}
            full = np.pad(x, ((0, 0), (halo, halo), (0, 0)), pad[mode])
            np.testing.assert_array_equal(
                got, full[:, mesh.spatial_index * hl:
                          mesh.spatial_index * hl + hl + 2 * halo])


def run_detect_peak(ctx, name, spec):
    import torch
    from libplacebo_tpu_torch.ops import peak_detect as tpeak
    mesh = ctx.mesh
    ref = ctx.ref(name)
    pd = tpeak.PeakDetectParams(percentile=99.5)
    for rows in spec["rows"]:
        rng = np.random.default_rng(rows)
        img = (rng.random((3, rows, 64)) * 8.0).astype(np.float32)
        img[:, : rows // 3] *= 0.001          # a dark band, inactive
        hl = rows // mesh.spatial
        blk = torch.from_numpy(img[:, mesh.spatial_index * hl:
                                   (mesh.spatial_index + 1) * hl].copy())
        state = torch.tensor([0.3, 0.7], dtype=torch.float32)
        avg, mx, st = tpeak.detect_peak(blk, state, pd, group=mesh)
        got = np.array([float(avg), float(mx), *st.tolist()])
        np.testing.assert_allclose(got, ref[f"rows_{rows}"], atol=1e-6,
                                   err_msg=f"rows {rows}")
        if hl % 16 == 0:
            a1, m1, s1 = tpeak.detect_peak(torch.from_numpy(img), state, pd)
            np.testing.assert_allclose(
                got, [float(a1), float(m1), *s1.tolist()], atol=1e-6)


def run_temporal_hook(ctx, name, spec):
    """A stateful hook over 3 frames a lane, threading hook_states."""
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.parallel import (build_sharded_pipeline,
                                               gather_rows, shard_planes,
                                               sharded_state_init)
    from libplacebo_tpu_torch.parallel.analysis import collective_stats
    mesh = ctx.mesh
    ns = port_ns()
    ref = ctx.ref(name)
    seqs = []
    for t in range(3):
        s = dict(spec, seed=spec["seed"] + 1000 * t)
        seqs.append(objects(ns, s, mesh.data))
    ob0 = seqs[0]
    f0 = ob0["frames"][0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, ob0["target"], ob0["params"],
                                  **ob0["build"])
    assert step.route == spec["route"], (step.route, step.reason)
    B = ob0["planes"][0].shape[0]
    state = sharded_state_init(mesh, B)
    hs = None
    refs = [lt.Renderer(device="cpu") for _ in range(B)]
    rparams = _params(ns, spec["params"], spec.get("hooks"))
    stats = None
    for t, ob in enumerate(seqs):
        xs = shard_planes(mesh, ob["planes"])
        if t == 0:
            stats = collective_stats(step, state, *xs, hook_states=hs)
        out, state, hs = step(state, *xs, hook_states=hs)
        out_g = gather_rows(mesh, out, rows=spec["th"]).numpy()
        if ctx.rank0:
            for b in range(B):
                r = refs[b].render(ob["frames"][b], ob["target"], rparams)
                assert not refs[b]._disabled_hooks
                halo_gate(out_g[b], r.numpy(), 0.0, f"t {t} frame {b}")
                jax_gate(out_g[b], ref[f"out_{t}"][b], 0, f"vs JAX t {t}",
                         (r.numpy(), ref[f"single_{t}"][b]),
                         spec.get("jax_tol"))
    if ctx.rank0 and spec.get("bounds"):
        check_bounds(stats, spec["bounds"], spec, mesh, B, ob0["planes"])


def run_mix(ctx, name, spec):
    """sharded_render_mix with a stateful hook, two mixes."""
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.parallel import (build_sharded_pipeline,
                                               gather_rows, shard_planes,
                                               sharded_render_mix,
                                               sharded_state_init)
    mesh = ctx.mesh
    ns = port_ns()
    ref = ctx.ref(name)
    ob = objects(ns, dict(spec, bits=0), mesh.data)
    frames = ob["frames"]
    f0 = frames[0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, ob["target"], ob["params"],
                                  **ob["build"])
    assert step.route == spec["route"], (step.route, step.reason)
    frame_planes = [shard_planes(mesh, [np.asarray(f.planes[i].data)[None]
                                        for i in range(len(f.planes))])
                    for f in frames]
    state = sharded_state_init(mesh, 1)
    ts = spec["timestamps"]
    out, state, hs = sharded_render_mix(
        mesh, step, state, frame_planes, ts, 1.0, params=ob["params"],
        bit_depth=spec["bits"])
    np.testing.assert_allclose(hs[0].numpy(), 0.125 * 3, rtol=1e-6)
    out_g = gather_rows(mesh, out, rows=spec["th"]).numpy()
    out2, state, hs2 = sharded_render_mix(
        mesh, step, state, frame_planes, ts, 1.0, params=ob["params"],
        bit_depth=spec["bits"], hook_states=hs)
    np.testing.assert_allclose(hs2[0].numpy(), 0.125 * 6, rtol=1e-6)
    if not ctx.rank0:
        return
    ob1 = objects(ns, spec, 1)
    r = lt.Renderer(device="cpu")
    tgt = ns.Target(w=spec["tw"], h=spec["th"], color=ns.CSP_SRGB,
                    bit_depth=spec["bits"])
    mix = lt.FrameMix(frames=ob1["frames"], timestamps=ts,
                      vsync_duration=1.0)
    single = lt.render_image_mix(r, mix, tgt, ob1["params"]).numpy()
    assert not r._disabled_hooks
    halo_gate(out_g[0], single, LSB, "mix vs single device")
    jax_gate(out_g[0], ref["out"][0], spec["bits"], "mix vs JAX")


KINDS = {"render": run_render, "extend_rows": run_extend_rows,
         "detect_peak": run_detect_peak, "temporal_hook": run_temporal_hook,
         "mix": run_mix}


def _rank_main(rank, world, data, spatial, init_file, workdir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=180))
    from libplacebo_tpu_torch.parallel import make_mesh
    mesh = make_mesh(data, spatial, device="cpu")
    with open(os.path.join(workdir, "cases.json")) as f:
        specs = json.load(f)
    results = {}
    for name, spec in specs.items():
        try:
            KINDS[spec.get("kind", "render")](Ctx(mesh, workdir), name,
                                              spec)
            results[name] = "ok"
        except Exception:       # noqa: BLE001 - reported per case
            results[name] = traceback.format_exc()
        dist.barrier()
    with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def spawn_ranks(data: int, spatial: int, workdir: str, specs: dict) -> dict:
    """Run `specs` ({name: spec}) on data x spatial gloo ranks; returns
    {name: [each rank's "ok" or traceback]}."""
    import torch.multiprocessing as mp
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(specs, f)
    world = data * spatial
    init_file = os.path.join(workdir, "store")
    mp.spawn(_rank_main, args=(world, data, spatial, init_file, workdir),
             nprocs=world, join=True)
    out = {name: [] for name in specs}
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.json")) as f:
            for name, res in json.load(f).items():
                out[name].append(res)
    return out

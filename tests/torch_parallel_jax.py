"""The JAX side of the port's multi-rank tests: the reference package's
sharded pipeline on its virtual CPU devices, run once in the pytest
process for each case spec of tests/torch_parallel_ranks.py, and the
results written as `<case>.npz` for the ranks."""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import film_grain as jfg
from libplacebo_tpu.core.common import RectF, Rotation
from libplacebo_tpu.core.lut import parse_cube
from libplacebo_tpu.ops import deinterlace as jdi
from libplacebo_tpu.ops import film_grain as jops_fg
from libplacebo_tpu.ops.deband import DebandParams
from libplacebo_tpu.ops.peak_detect import PeakDetectParams
from libplacebo_tpu.parallel import (build_sharded_pipeline, make_mesh,
                                     shard_planes, sharded_render_mix,
                                     sharded_state_init)
from libplacebo_tpu.render.frame import Overlay, frame_from_yuv420p
from libplacebo_tpu.render.mpv_hooks import user_shader_hook
from libplacebo_tpu.render.renderer import RenderParams, Renderer, Target

import torch_parallel_ranks as tpr


def _av1_grain(seed):
    """The port's sample grain as the reference package's type."""
    from libplacebo_tpu_torch.core.film_grain import sample_grain
    g = sample_grain(seed)
    return jfg.FilmGrainData(type="av1", seed=g.seed, av1=jfg.AV1GrainData(
        **dataclasses.asdict(g.av1)))


NS = SimpleNamespace(
    RenderParams=RenderParams, Target=Target, RectF=RectF,
    PeakDetectParams=PeakDetectParams, DebandParams=DebandParams,
    DeinterlaceParams=jdi.DeinterlaceParams,
    DeinterlaceAlgo=jdi.DeinterlaceAlgo, Field=jdi.Field,
    parse_cube=parse_cube, user_shader_hook=user_shader_hook,
    Overlay=Overlay, Rotation=Rotation, CSP_BT2100_PQ=jcs.CSP_BT2100_PQ,
    CSP_SRGB=jcs.CSP_SRGB, ColorRepr=jcs.ColorRepr,
    ColorSystem=jcs.ColorSystem, ColorLevels=jcs.ColorLevels,
    BitEncoding=jcs.BitEncoding, FilmGrainData=jfg.FilmGrainData,
    H274GrainData=jfg.H274GrainData, ColorAdjustment=jcs.ColorAdjustment,
    Cone=jcs.Cone, ConeParams=jcs.ConeParams, av1_grain=_av1_grain,
    frame=frame_from_yuv420p, array=jnp.asarray)


def jax_mesh(data, spatial):
    return make_mesh(data=data, spatial=spatial,
                     devices=jax.devices()[:data * spatial])


def _step_kw(mesh, ob):
    kw = {}
    g = ob["glob"]
    for k in ("prev_planes", "next_planes"):
        if k in g:
            kw[k] = shard_planes(mesh, g[k])
    if "target_data" in g:
        kw["target_data"] = g["target_data"]
    if "overlay_datas" in g:
        kw["overlay_datas"] = tuple(g["overlay_datas"])
    bf = ob["build"].get("frame_grain")
    if bf is not None and bf.type == "av1":
        f0 = ob["frames"][0]
        metas = f0.meta_key()[0]
        cfgs, _ = Renderer._grain_cfgs(Renderer(), metas, f0.repr,
                                       f0.film_grain)
        per = [tuple(jops_fg.prepare_av1_grain(f.film_grain, c, m[0][-2],
                                               m[0][-1]) if c else None
                     for c, m in zip(cfgs, metas)) for f in ob["frames"]]
        kw["grain_tables"] = jtu.tree_map(lambda *xs: jnp.stack(xs), *per)
    return kw


def _build(mesh, ob):
    f0 = ob["frames"][0]
    return build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, ob["target"], ob["params"],
                                  **ob["build"])


def single_chip(ob, b):
    """The reference's single-chip render of frame b."""
    tgt = ob["target"]
    if "target_data" in ob["glob"]:
        tgt = dataclasses.replace(tgt, data=ob["glob"]["target_data"][b])
    return np.asarray(Renderer()._render_once(ob["frames"][b], tgt,
                                              ob["params"]))


def render_ref(spec, data, spatial):
    mesh = jax_mesh(data, spatial)
    ob = tpr.objects(NS, spec, data)
    step = _build(mesh, ob)
    xs = shard_planes(mesh, ob["planes"])
    state = sharded_state_init(mesh, ob["planes"][0].shape[0])
    res = step(state, *xs, **_step_kw(mesh, ob))
    single = np.stack([single_chip(ob, b) for b in range(len(ob["frames"]))])
    return {"out": np.asarray(res[0]), "state": np.asarray(res[1]),
            "single": single}


def extend_rows_ref(spec, data, spatial):
    """Each shard's extended block, concatenated (JAX extend_rows inside
    shard_map on the mesh's spatial axis)."""
    from jax.sharding import PartitionSpec as P
    from libplacebo_tpu.parallel.halo import extend_rows
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    mesh = jax_mesh(data, spatial)
    n = spatial
    rng = np.random.default_rng(spec["seed"])
    x = rng.random((2, 8 * n, 5)).astype(np.float32)
    out = {}
    for mode in ("edge", "reflect", "wrap"):
        for halo in (1, 3, 7):
            f = shard_map(lambda a, h=halo, m=mode: extend_rows(
                a, h, n, "spatial", mode=m), mesh=mesh,
                in_specs=P(None, "spatial", None),
                out_specs=P(None, "spatial", None), check_vma=False)
            out[f"{mode}_{halo}"] = np.asarray(jax.jit(f)(x))
    return out


def detect_peak_ref(spec, data, spatial):
    from jax.sharding import PartitionSpec as P
    from libplacebo_tpu.ops import peak_detect as jpeak
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    mesh = jax_mesh(data, spatial)
    pd = PeakDetectParams(percentile=99.5)
    out = {}
    for rows in spec["rows"]:
        rng = np.random.default_rng(rows)
        img = (rng.random((3, rows, 64)) * 8.0).astype(np.float32)
        img[:, : rows // 3] *= 0.001
        state = jnp.asarray([0.3, 0.7], jnp.float32)

        def f(a):
            avg, mx, st = jpeak.detect_peak(a, state, pd,
                                            axis_name="spatial")
            return jnp.concatenate([jnp.stack([avg, mx]), st])
        g = shard_map(f, mesh=mesh, in_specs=P(None, "spatial", None),
                      out_specs=P(), check_vma=False)
        out[f"rows_{rows}"] = np.asarray(jax.jit(g)(img))
    return out


def temporal_hook_ref(spec, data, spatial):
    mesh = jax_mesh(data, spatial)
    seqs = [tpr.objects(NS, dict(spec, seed=spec["seed"] + 1000 * t), data)
            for t in range(3)]
    step = _build(mesh, seqs[0])
    state = sharded_state_init(mesh, seqs[0]["planes"][0].shape[0])
    hs = None
    out = {}
    lanes = [Renderer() for _ in seqs[0]["frames"]]
    for t, ob in enumerate(seqs):
        xs = shard_planes(mesh, ob["planes"])
        o, state, hs = step(state, *xs, hook_states=hs)
        out[f"out_{t}"] = np.asarray(o)
        out[f"single_{t}"] = np.stack([np.asarray(r._render_once(
            f, ob["target"], ob["params"]))
            for r, f in zip(lanes, ob["frames"])])
    return out


def mix_ref(spec, data, spatial):
    mesh = jax_mesh(data, spatial)
    ob = tpr.objects(NS, dict(spec, bits=0), data)
    step = _build(mesh, ob)
    frame_planes = [shard_planes(mesh, [np.asarray(f.planes[i].data)[None]
                                        for i in range(len(f.planes))])
                    for f in ob["frames"]]
    out, _, _ = sharded_render_mix(
        mesh, step, sharded_state_init(mesh, 1), frame_planes,
        spec["timestamps"], 1.0, params=ob["params"],
        bit_depth=spec["bits"])
    return {"out": np.asarray(out)}


REFS = {"render": render_ref, "extend_rows": extend_rows_ref,
        "detect_peak": detect_peak_ref, "temporal_hook": temporal_hook_ref,
        "mix": mix_ref}


def run_file(specs, data, spatial, workdir):
    """The JAX references of `specs`, then the port's ranks; returns
    {case: [each rank's result]}."""
    for name, spec in specs.items():
        ref = REFS[spec.get("kind", "render")](spec, data, spatial)
        np.savez(os.path.join(workdir, name + ".npz"), **ref)
    return tpr.spawn_ranks(data, spatial, str(workdir), specs)


def case_result(results, name):
    """Assert every rank ran case `name` to its end."""
    bad = [r for r in results[name] if r != "ok"]
    assert not bad, bad[0]

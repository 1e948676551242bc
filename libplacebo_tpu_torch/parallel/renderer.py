"""One frame's render over several devices: the sharded renderer.

Counterpart of libplacebo_tpu/parallel/renderer.py on torch.distributed,
one process (rank) a device.  Frames are split over the mesh's 'data'
axis, the rows of each frame over its 'spatial' axis; arrays are local:
the step takes and returns this rank's blocks — planes (B/data, C,
ph/spatial, pw), the peak state (B/data, 2), the output (B/data, C,
target.h/spatial, target.w) — where the reference holds global sharded
arrays.  `shard_planes` cuts global host planes into this rank's
blocks; `gather_rows` assembles a global batch (the counterpart of
reading a global jax.Array back, for tests and checks).

The halo pipeline (`_build_halo_step`) keeps the single-device
renderer's arithmetic:
1. pointwise stages (decode, linearize, tone, gamut, encode, dither)
   run on the local rows as they are;
2. row resampling (the chroma merge, the main scaler, contrast
   recovery's feature map, deband's rolls, the deinterlacers, bounded
   hook stencils) runs on a block extended by the footprint's rows
   (parallel/halo.py), its source rect shifted by whole rows, which
   leaves every planned weight as the whole frame's;
3. frame-global reductions (the peak histogram and averages) finish
   with all-reduces (ops/peak_detect.py `group=`).
The 180-degree rotation is a local flip and a reversal of the ring;
90/270 a local rot90 and one all-to-all.  Each shard's color tail runs
kernel K1 wherever the single-device renderer would
(render/renderer.py `_tail_eligible`), reading its own rows of the
frame's dither bias; the peak state comes from the sharded detection,
as in the reference, not from K1's per-stripe partials.

What the halo pipeline cannot express (error diffusion, distortion,
blur/skip borders, the LUT visualizer, hooks with 90/270 rotation,
hooks not proven bounded stencils, geometry it does not split) runs on
`_build_replicated_step`: the counterpart of the reference's GSPMD step
(`_build_gspmd_step`, renderer.py:1057), which auto-partitions the
single-device trace.  Nothing in torch partitions automatically, so
every rank of the spatial group gathers the whole source frame, renders
it with the single-device pipeline (K1, K2 and K3 where it runs them)
and keeps its own output rows: n times the compute on n ranks, listed
in ROADMAP as a performance item.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.colorspace import (AlphaMode, ColorPrimaries, ColorRepr,
                               ColorSpace, HdrScaling, color_space_infer_map,
                               hdr_rescale, primaries_get, primaries_guess,
                               system_is_ycbcr_like, COLOR_SDR_WHITE)
from ..core.common import RectF
from ..core.fastmath import fma
from ..core import log as core_log
from ..ops import color as ops_color
from ..ops import deband as ops_deband
from ..ops import deinterlace as ops_di
from ..ops import dithering as ops_dither
from ..ops import film_grain as ops_fg
from ..ops import film_grain_h274 as ops_h274
from ..ops import icc as ops_icc
from ..ops import lut as ops_lut
from ..ops import peak_detect as ops_peak
from ..ops import polar as ops_polar
from ..ops import sampling as ops_sampling
from ..ops import tone_dynamic as ops_tone
from ..render import renderer as rmod
from ..render.hooks import HookStage, run_hooks
from ..render.renderer import (DEFAULT_PARAMS, FrameInputs, RenderError,
                               RenderParams, Renderer, Target, _corner_mask,
                               _dither_params, _find_scaler, _mix_weights,
                               _paste, _state_init, _tail_eligible,
                               color_map_stage)
from . import comm
from .halo import extend_rows

__all__ = ["build_sharded_pipeline", "shard_planes", "sharded_state_init",
           "sharded_render_mix", "gather_rows", "extend_rows"]


# ---------------------------------------------------------------------------
# Host-side halo planning, from the whole frame's plans (so an interior
# shard never clamps where the single-device plan would not)
# ---------------------------------------------------------------------------

def _halo_ortho(cfg, src_size: int, dst_size: int, s0: float, s1: float,
                n: int) -> int:
    idx, _ = ops_sampling.ortho_weights(cfg, src_size, dst_size, s0, s1)
    src_l, dst_l = src_size // n, dst_size // n
    lo = hi = 1
    for i in range(n):
        sl = idx[i * dst_l:(i + 1) * dst_l]
        lo = max(lo, i * src_l - int(sl.min()))
        hi = max(hi, int(sl.max()) + 1 - (i + 1) * src_l)
    return max(lo, hi)


def _halo_polar(cfg, src_h: int, src_w: int, dst_h: int, dst_w: int,
                rect: RectF, n: int) -> int:
    plan = ops_polar.plan_polar(cfg, src_h, src_w, dst_h, dst_w, rect)
    py, taps = plan["plan_y"], plan["taps"]
    src_l, dst_l = src_h // n, dst_h // n
    lo = hi = 1
    for i in range(n):
        b = py.base[i * dst_l:(i + 1) * dst_l]
        lo = max(lo, i * src_l - int(b.min()))
        hi = max(hi, int(b.max()) + taps - (i + 1) * src_l)
    return max(lo, hi)


# ---------------------------------------------------------------------------
# Local blocks
# ---------------------------------------------------------------------------

def _rows(mesh, total: int):
    """This rank's [r0, r1) of `total` rows (all of them when they do not
    split over the spatial axis)."""
    n = mesh.spatial
    if total % n:
        return 0, total
    hl = total // n
    return mesh.spatial_index * hl, (mesh.spatial_index + 1) * hl


def shard_planes(mesh, planes: Sequence) -> tuple:
    """This rank's blocks of global (B, C, ph, pw) planes, on the mesh's
    device: its data index's frames and its spatial index's rows.  A
    plane whose rows do not split over the spatial axis (only the
    replicated step takes one) is given whole."""
    out = []
    for p in planes:
        t = p if isinstance(p, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(np.asarray(p)))
        B = t.shape[0]
        if B % mesh.data:
            raise ValueError(f"shard_planes: batch {B} does not split over "
                             f"data {mesh.data}")
        bl = B // mesh.data
        r0, r1 = _rows(mesh, t.shape[-2])
        d = mesh.data_index
        out.append(t[d * bl:(d + 1) * bl, ..., r0:r1, :].to(
            mesh.device).contiguous())
    return tuple(out)


def sharded_state_init(mesh, batch: int) -> torch.Tensor:
    """The local per-frame peak-detection states, (batch / data, 2)."""
    if batch % mesh.data:
        raise ValueError(f"sharded_state_init: batch {batch} does not "
                         f"split over data {mesh.data}")
    return torch.zeros((batch // mesh.data, 2), dtype=torch.float32,
                       device=mesh.device)


def gather_rows(mesh, x: torch.Tensor, rows: Optional[int] = None
                ) -> torch.Tensor:
    """The global batch of a local (B/data, ..., rows/spatial, W) block,
    on every rank: the blocks of the whole mesh gathered and laid out by
    data index, then by rows.  With `rows` (the global row count) equal
    to the block's, the block is whole on every spatial rank (a
    replicated output) and only the batch is assembled."""
    parts = comm.all_gather(x.unsqueeze(0), mesh, 0, group="mesh")
    whole = rows is not None and x.shape[-2] == rows
    batch = []
    for d in range(mesh.data):
        blocks = parts[d * mesh.spatial:(d + 1) * mesh.spatial]
        batch.append(blocks[0] if whole else torch.cat(list(blocks), -2))
    return torch.cat(batch, 0)


def _check(cond, msg):
    if not cond:
        raise RenderError(f"sharded pipeline: {msg}")


class _HaloUnsupported(Exception):
    """The halo pipeline cannot express this configuration (rows that do
    not split over the mesh, halos larger than a block, partial row
    crops, ...); the caller falls back to the replicated step."""


def _require(cond, msg):
    if not cond:
        raise _HaloUnsupported(msg)


def _hook_specs(hooks):
    return tuple((h, tuple(sorted(getattr(h, "state_spec", None) or ())))
                 for h in (hooks or ()) if getattr(h, "state_spec", None))


def build_sharded_pipeline(mesh, plane_metas, frame_repr: ColorRepr,
                           frame_color: ColorSpace, target: Target,
                           params: Optional[RenderParams] = None,
                           crop: Optional[RectF] = None,
                           frame_grain=None, field=None, first_field=None,
                           frame_icc=None, has_temporal: bool = False,
                           overlays=(), rotation: int = 0):
    """Build the sharded render step for one frame signature.

    plane_metas: `Frame.meta_key()[0]`, with the planes' global shapes.

    Returns `step(state, *planes, grain_tables=None, dovi_packed=None,
    prev_planes=None, next_planes=None, overlay_datas=None,
    target_data=None, hook_states=None) -> (out, new_state)` (and the
    hook states out, third, with stateful hooks) on this rank's blocks:
    planes (B_l, C, ph/spatial, pw) (as shard_planes cuts them), state
    (B_l, 2), out (B_l, C_out, target.h/spatial, target.w) — the whole
    target.h on every spatial rank where the target's rows do not split.
    Per frame the output equals the single-device `Renderer.render`.

    grain_tables: per local frame, the tuple of each plane's
    ops.film_grain.prepare_av1_grain of the whole plane (or None).
    dovi_packed: per local frame, ops.dovi.pack_dovi of its RPU.
    prev/next_planes: the neighbor frames' local plane blocks.
    overlay_datas: per overlay, a (B_l, 4, h, w) bitmap batch.
    target_data: the target's contents, local (B_l, C, rows, target.w).
    hook_states: the stateful hooks' carried values, batched over the
    local frames (texture state as local rows); None starts from the
    hooks' declared values.

    `step.route` is "halo" or "replicated", `step.reason` why.  The step
    is stateless across frames: a temporal dither runs at phase 0 (the
    single-device renderer's first frame)."""
    params = params or DEFAULT_PARAMS
    border_mode = "skip" if params.skip_target_clearing else \
        (params.border or params.background)
    args = (mesh, plane_metas, frame_repr, frame_color, target, params,
            crop, frame_grain, field, first_field, frame_icc, has_temporal,
            overlays, rotation)
    if params.error_diffusion is not None or \
            params.distort is not None or \
            border_mode in ("blur", "skip") or \
            params.visualize_lut or \
            (rotation % 4 in (1, 3) and params.hooks):
        # visualize_lut draws at the frame's coordinates: a row block
        # would draw its own copy
        return _build_replicated_step(*args)
    hook_plan = None
    if params.hooks:
        from .hook_halo import plan_halo_hooks
        ref_i = Renderer._ref_plane_index(plane_metas)
        H_h, W_h = plane_metas[ref_i][0][-2], plane_metas[ref_i][0][-1]
        dc = target.crop or RectF(0, 0, target.w, target.h)
        hook_plan = plan_halo_hooks(
            params, plane_metas, frame_repr.sys, H_h, W_h,
            int(round(dc.w)), int(round(dc.h)), mesh.spatial,
            device=mesh.device)
        if hook_plan is None:
            return _build_replicated_step(*args)
        core_log.default_log().info(
            "sharded renderer: hooks proven bounded-stencil "
            "(probe + equivariance) -> halo pipeline, footprints "
            + str({k.name: v["F"] for k, v in hook_plan.items()
                   if k != "__sizes__"}))
    try:
        return _build_halo_step(*args, hook_plan=hook_plan)
    except _HaloUnsupported as e:
        core_log.default_log().info(
            f"sharded renderer: {e} -> replicated step (the whole frame "
            "gathered), not the halo pipeline")
        return _build_replicated_step(*args, why=str(e))


def _build_halo_step(mesh, plane_metas, frame_repr: ColorRepr,
                     frame_color: ColorSpace, target: Target, params,
                     crop, frame_grain, field, first_field, frame_icc,
                     has_temporal, overlays, rotation, hook_plan=None):
    """The halo pipeline (see build_sharded_pipeline); raises
    _HaloUnsupported for geometry it cannot express."""
    n_sp = mesh.spatial
    me = mesh.spatial_index
    dev = mesh.device
    renderer = Renderer(device=dev)

    # ---- bounded-stencil hooks: each runs on the block extended by the
    # stage's footprint, then is cropped (hook_halo proved the values
    # equal the whole frame's)
    hook_sizes = (hook_plan or {}).get("__sizes__", {})
    dst_crop_t = target.crop or RectF(0, 0, target.w, target.h)
    hook_state_specs = _hook_specs(params.hooks)
    # "cur": the frame's initial state values (every invocation reads
    # these, as single-device run_hooks hands each the frame-initial
    # state_in); "out": the values deposited, last write wins
    hs_ctx: dict = {"cur": None, "out": None}

    def hooks_at(stage, x):
        ent = (hook_plan or {}).get(stage)
        if not ent:
            return x
        F = ent["F"]
        rows_l = x.shape[-2]
        ext = extend_rows(x, F, mesh) if F else x
        states = None
        stage_stateful = ()
        if hs_ctx["cur"] is not None:
            stage_stateful = tuple((h, names) for h, names in
                                   hook_state_specs if h in ent["hooks"])
        if stage_stateful:
            states = {}
            for h, names in stage_stateful:
                sin = {}
                for nm in names:
                    v = hs_ctx["cur"][(h.signature, nm)]
                    if nm.startswith("tex:") and F:
                        v = extend_rows(v, F, mesh)
                    sin[nm] = v
                states[h.signature] = (sin, {})
        out = run_hooks(ent["hooks"], stage, ext, None, states=states,
                        dst_w=int(round(dst_crop_t.w)),
                        dst_h=int(round(dst_crop_t.h)),
                        size_override=hook_sizes.get(stage))
        if states:
            for h, names in stage_stateful:
                sout = states[h.signature][1]
                for nm in names:
                    if nm not in sout:
                        continue
                    v = sout[nm]
                    if nm.startswith("tex:") and F:
                        v = v[..., F:F + rows_l, :]
                    hs_ctx["out"][(h.signature, nm)] = v
        if out.shape[-2] != ext.shape[-2]:
            raise RenderError("halo-planned hook changed the row count at "
                              "execution time (plan violated)")
        return out[..., F:F + rows_l, :] if F else out

    # ---- a target sub-rect or corner rounding: the outer stage
    # composites the gathered image rows into the whole target
    x0_t = int(round(dst_crop_t.x0))
    y0_t = int(round(dst_crop_t.y0))
    needs_composite = (int(round(dst_crop_t.w)), int(round(dst_crop_t.h)),
                       x0_t, y0_t) != (target.w, target.h, 0, 0)
    needs_outer = needs_composite or params.corner_rounding > 0
    if needs_outer:
        _require(target.h % n_sp == 0,
                 f"target rows {target.h} % {n_sp} != 0")

    # ---- overlays: each shard blends the rows of the (whole-frame)
    # overlay rect that cross its block
    _require(not (getattr(target, "overlays", ()) or ()),
             "target overlays need the replicated step")
    for ov in (() if needs_outer else overlays):
        _require(Renderer.overlay_is_simple(ov),
                 "overlay with parts/mode/coords/encoding needs the "
                 "replicated step")
        r = ov.rect
        ow = max(1, int(round(r.x1 - r.x0)))
        _check(0 <= int(round(r.x0)) and int(round(r.x0)) + ow <= target.w,
               "overlay x range outside the target")

    if params.ignore_icc_profiles:
        frame_icc = None
        target = replace(target, icc=None)
    dst_raw = target.color
    if dst_raw.primaries == ColorPrimaries.UNKNOWN:
        dst_raw = ColorSpace(primaries_guess(target.w, target.h),
                             dst_raw.transfer, dst_raw.hdr)
    src_color, dst_color = color_space_infer_map(frame_color, dst_raw)

    ref_i = Renderer._ref_plane_index(plane_metas)
    H, W = plane_metas[ref_i][0][-2], plane_metas[ref_i][0][-1]
    frame_hw = (H, W)
    rot = rotation % 4
    if rot in (1, 3):
        _require(W % n_sp == 0,
                 f"rotated rows (src cols) {W} % {n_sp} != 0")
        H_r, W_r = W, H
    else:
        H_r, W_r = H, W
    crop = crop or RectF(0, 0, W, H)
    _require(crop.y0 == 0 and crop.y1 == H_r,
             "row crop must span the full frame (rows are the split axis)")
    dst_w = int(round(dst_crop_t.w))
    dst_h = int(round(dst_crop_t.h))
    _require(H % n_sp == 0, f"src rows {H} % {n_sp} != 0")
    _require(dst_h % n_sp == 0, f"dst rows {dst_h} % {n_sp} != 0")
    H_l, dst_l = H // n_sp, dst_h // n_sp
    H_rl = H_r // n_sp
    row0d = me * dst_l

    # ---- chroma merge plans (Renderer._merge_planes)
    merge_up = _find_scaler(params.plane_upscaler or params.upscaler)
    merge_down = _find_scaler(params.plane_downscaler or params.downscaler)
    merge_plans = []
    for shape, mapping, sx, sy in plane_metas:
        ph, pw = shape[-2], shape[-1]
        _require(ph % n_sp == 0, f"plane rows {ph} % {n_sp} != 0")
        if (ph, pw) == (H, W) and (sx or sy) and \
                not params.correct_subpixel_offsets:
            merge_plans.append(None)
        elif (ph, pw) != (H, W) or sx or sy:
            cfg_m = merge_down if (ph > H or pw > W) else merge_up
            _require(not cfg_m.polar,
                     "polar plane-merge scaler needs the replicated step")
            s0x = -sx * pw / W
            s0y = -sy * ph / H
            halo_m = _halo_ortho(cfg_m, ph, H, s0y, s0y + ph, n_sp)
            _require(halo_m <= ph // n_sp,
                     f"merge halo {halo_m} exceeds local rows {ph // n_sp}")
            rect_l = RectF(s0x, s0y + halo_m, s0x + pw,
                           s0y + halo_m + ph // n_sp)
            merge_plans.append((halo_m, rect_l, cfg_m))
        else:
            merge_plans.append(None)

    # ---- per-plane features: deinterlacing, deband, film grain
    di_on = params.deinterlace is not None and field is not None
    if di_on:
        for shape, _m, _sx, _sy in plane_metas:
            _require(shape[-2] // n_sp >= 4,
                     "deinterlace halo (4 rows) exceeds local rows")
    deband_plans = None
    if params.deband is not None:
        db = params.deband
        if src_color.hdr.max_luma > 0:
            db = replace(db, grain=db.grain /
                         (src_color.hdr.max_luma / COLOR_SDR_WHITE))
        deband_plans = []
        for i, (shape, mapping, _sx, _sy) in enumerate(plane_metas):
            if 3 in mapping:
                deband_plans.append(None)
                continue
            pl_rows = shape[-2] // n_sp
            halo_db = ops_deband.deband_halo(db, i)
            _require(halo_db <= pl_rows,
                     f"deband halo {halo_db} exceeds local rows {pl_rows}")
            # the plane's tables, this block's rows of them
            chs, nz = ops_deband.deband_tables(db, shape, i, dev)
            r0 = me * pl_rows
            deband_plans.append((
                db, ops_deband.plane_grain_neutral(frame_repr, mapping),
                ([c[r0:r0 + pl_rows].contiguous() for c in chs],
                 None if nz is None else
                 nz[..., r0:r0 + pl_rows, :].contiguous())))
    grain_cfgs = None
    scaling_shift = None
    h274_tables = None
    if params.film_grain and ops_fg.needs_fg(frame_grain):
        grain_cfgs, scaling_shift = renderer._grain_cfgs(
            plane_metas, frame_repr, frame_grain)
        for (shape, _m, _sx, _sy), cfg_g in zip(plane_metas, grain_cfgs):
            if cfg_g is not None:
                _require(H_l % (1 << cfg_g.sub_y) == 0,
                         "luma local rows must align with chroma "
                         "subsampling for grain scaling")
    elif params.film_grain and ops_h274.needs_fg_h274(frame_grain):
        for shape, _m, _sx, _sy in plane_metas:
            _require(shape[-2] // n_sp % 8 == 0,
                     "H.274 grain: local rows must be a multiple of the "
                     "8-row block")
        # the seed is the plan's here, as in the reference's sharded step
        h274_tables = ops_h274.prepare_h274(
            frame_grain,
            [(() if 3 in mapping else tuple(mapping), shape[-2] // n_sp,
              shape[-1]) for shape, mapping, _, _ in plane_metas],
            dev, row0s=[me * (shape[-2] // n_sp)
                        for shape, _m, _sx, _sy in plane_metas])
    is_ycbcr = system_is_ycbcr_like(frame_repr.sys)

    # ---- the main scaler (pass_scale_main)
    src_h_c = crop.y1 - crop.y0
    src_w_c = crop.x1 - crop.x0
    needs_scale = (abs(src_h_c - dst_h) > 1e-6 or
                   abs(src_w_c - dst_w) > 1e-6 or
                   crop.x0 != 0 or crop.y0 != 0)
    upscaling = dst_w > src_w_c or dst_h > src_h_c
    cfg_s = down = None
    halo_s = 0
    rect_s = None
    antiring = 0.0
    if needs_scale:
        up = _find_scaler(params.upscaler)
        down = _find_scaler(params.downscaler)
        cfg_s = up if upscaling else down
        if cfg_s.polar:
            halo_s = _halo_polar(cfg_s, H_r, W_r, dst_h, dst_w, crop, n_sp)
        else:
            cfg_v = down if (down is not None and src_h_c / dst_h > 1.0) \
                else cfg_s
            halo_s = _halo_ortho(cfg_v, H_r, dst_h, crop.y0, crop.y1, n_sp)
        _require(halo_s <= H_rl,
                 f"scaler halo {halo_s} exceeds local rows {H_rl}")
        rect_s = RectF(crop.x0, halo_s, crop.x1, halo_s + H_rl)
        antiring = params.antiringing_strength or cfg_s.antiring
    else:
        _require(dst_h == H_r, "pass-through requires matching row counts")

    use_linear = (params.linear_scaling and needs_scale
                  and not params.disable_linear_scaling)
    sig = ops_color.SigmoidParams(*params.sigmoid) \
        if use_linear and params.sigmoid is not None and \
        not src_color.is_hdr() else None
    need_color_map = (src_color.primaries != dst_color.primaries or
                      src_color.transfer != dst_color.transfer or
                      target.icc is not None or frame_icc is not None)
    fn_tm = params.tone_mapping_function
    use_peak = (params.peak_detect is not None and src_color.is_hdr()
                and need_color_map
                and fn_tm in ops_tone.DYNAMIC_TONE_FUNCTIONS
                and not (fn_tm == "st2094-40"
                         and src_color.hdr.ootf is not None))
    if use_peak and dst_l % 16 != 0:
        warnings.warn(
            f"sharded peak detect: local rows {dst_l} not a multiple of "
            "the 16-row stat tile; the frame average uses shard-local "
            "tiles (tiny deviation from single-device)")
    src_max_pq = hdr_rescale(HdrScaling.NITS, HdrScaling.PQ,
                             src_color.hdr.max_luma)

    # ---- contrast recovery: the feature map's 4x bilinear down and
    # bicubic up over their own halos (reference renderer.c:2089)
    recovery_impl = None
    if params.contrast_recovery > 0 and need_color_map \
            and params.contrast_smoothness > 1:
        lh = max(1, int(math.ceil(dst_h / params.contrast_smoothness)))
        lw = max(1, int(math.ceil(dst_w / params.contrast_smoothness)))
        _require(lh % n_sp == 0,
                 f"contrast recovery: feature rows {lh} % {n_sp} != 0 "
                 "(pick a contrast_smoothness dividing the row count)")
        lh_l = lh // n_sp
        cfg_bil = _find_scaler("bilinear")
        cfg_bic = _find_scaler("bicubic")
        halo_dn = _halo_ortho(cfg_bil, dst_h, lh, 0.0, dst_h, n_sp)
        halo_up = _halo_ortho(cfg_bic, lh, dst_h, 0.0, lh, n_sp)
        _require(halo_dn <= dst_l and halo_up <= lh_l,
                 "contrast recovery halo exceeds local rows")

        def recovery_impl(x, base, cr, out_min, out_max):
            if cr <= 0:
                return base(x)
            ext = extend_rows(x, halo_dn, mesh)
            low = ops_sampling.resize_separable(
                ext, lh_l, lw, cfg_bil,
                RectF(0, halo_dn, dst_w, halo_dn + dst_l))
            exl = extend_rows(low, halo_up, mesh)
            lowres = ops_sampling.resize_separable(
                exl, dst_l, dst_w, cfg_bic,
                RectF(0, halo_up, lw, halo_up + lh_l))
            b = base(x)
            sharp = base(lowres) + (x - lowres)
            return torch.clamp(fma(sharp - b, cr, b), out_min, out_max)

    # ---- the color tail: K1 where the single-device renderer runs it
    has_alpha = any(3 in mapping for _, mapping, _, _ in plane_metas)
    fused_tail = None
    tail_eligible = False
    if need_color_map:
        tail_eligible = _tail_eligible(params, target, dst_w, dst_h,
                                       dst_crop_t, has_alpha)
        fused_tail = renderer._fused_tail(params, src_color, dst_color,
                                          target, use_peak, dst_w, dst_h,
                                          dst_crop_t, has_alpha, 0)
    quantize = target.bit_depth and (target.bit_depth < 16 or
                                     params.force_dither)
    dp = _dither_params(params, dst_color) if params.dither else None
    bias_l = None
    if quantize and dp is not None and not needs_outer and \
            fused_tail is None:
        # this block's rows of the frame's bias
        bias_l = torch.from_numpy(np.ascontiguousarray(
            ops_dither.bias_matrix(dp, dst_h, dst_w, 0)[
                row0d:row0d + dst_l])).to(dev)
    icc_kw = ops_icc.params_kwargs(params)
    icc_enc_kw = ops_icc.params_kwargs(params, encode=True)

    def linearize_src(x):
        if frame_icc is not None:
            return ops_icc.decode_profile(
                x, frame_icc, primaries_get(src_color.primaries), **icc_kw)
        return ops_color.linearize(x, src_color)

    def delinearize_to(x, csp):
        if target.icc is not None:
            return ops_icc.encode_profile(
                x, target.icc, primaries_get(csp.primaries), **icc_enc_kw)
        return ops_color.delinearize(x, csp)

    def rot180(a):
        a = torch.flip(a, (-2, -1))
        if n_sp > 1:
            a = comm.ppermute(a, mesh, [(i, n_sp - 1 - i)
                                        for i in range(n_sp)])
        return a

    def rot90(a):
        # a local rot90 of (C, H_l, W) is this shard's column slab of
        # the turned image; one all-to-all hands the slabs out as rows
        a = torch.rot90(a, rot, dims=(-2, -1))
        if n_sp == 1:
            return a
        if rot == 3:
            a = comm.ppermute(a, mesh, [(i, n_sp - 1 - i)
                                        for i in range(n_sp)])
        return comm.all_to_all(a, mesh, split_dim=-2, concat_dim=-1)

    def frame_step(state, planes, grain_t, dovi_p, prev, nxt, ov_datas,
                   tgt, hs_vals):
        """One frame's local rows -> (image, new state, hook states)."""
        if hook_state_specs:
            vals = iter(hs_vals)
            hs_ctx["cur"] = {(h.signature, nm): next(vals)
                             for h, names in hook_state_specs
                             for nm in names}
            hs_ctx["out"] = {}
        else:
            hs_ctx["cur"] = hs_ctx["out"] = None
        luma_full = None
        if 0 in plane_metas[ref_i][1]:
            luma_full = planes[ref_i][
                ..., plane_metas[ref_i][1].index(0), :, :]
        channels = {}
        for i, ((shape, mapping, sx, sy), plan, data) in enumerate(zip(
                plane_metas, merge_plans, planes)):
            pl_rows = shape[-2] // n_sp
            row0 = me * pl_rows
            if di_on:
                ext = extend_rows(data, 4, mesh, mode="reflect")
                pe = extend_rows(prev[i], 4, mesh, mode="reflect") \
                    if prev is not None else None
                ne = extend_rows(nxt[i], 4, mesh, mode="reflect") \
                    if nxt is not None else None
                ext = ops_di.deinterlace(
                    ext, field, params.deinterlace, prev=pe, next=ne,
                    first_field=first_field or field,
                    row_offset=row0 - 4)
                data = ext[..., 4:4 + pl_rows, :]
            if deband_plans is not None and deband_plans[i] is not None:
                dbp, neutral, tables = deband_plans[i]
                data = ops_deband.deband(data, dbp, seed=i, tables=tables,
                                         neutral=neutral, shard=mesh)
            if h274_tables is not None and h274_tables[i] is not None:
                data = ops_h274.apply_h274_grain(
                    data, frame_grain, tuple(mapping), is_ycbcr=is_ycbcr,
                    tables=h274_tables[i])
            if grain_cfgs is not None and grain_cfgs[i] is not None:
                cfg_g = grain_cfgs[i]
                luma = None
                if 0 not in mapping and luma_full is not None:
                    luma = ops_fg.subsample_nearest(
                        luma_full, cfg_g.sub_x, cfg_g.sub_y, pl_rows,
                        shape[-1])
                data = ops_fg.apply_av1_grain(
                    data, grain_t[i], cfg_g, scaling_shift, luma=luma,
                    row0=row0)
            stage_in, stage_scaled = Renderer._plane_hook_stage(
                mapping, frame_repr.sys)
            if stage_in is not None:
                data = hooks_at(stage_in, data)
            if plan is not None:
                halo_m, rect_l, cfg_m = plan
                ext = extend_rows(data, halo_m, mesh)
                data = ops_sampling.resize_separable(
                    ext, H_l, W, cfg_m, rect_l,
                    antiring=params.antiringing_strength or cfg_m.antiring)
                if stage_scaled is not None:
                    data = hooks_at(stage_scaled, data)
            for ci, ch in enumerate(mapping):
                channels[ch] = data[..., ci, :, :]
        order = sorted(channels)
        img = torch.stack([channels[c] for c in order], dim=-3)
        alpha = None
        if 3 in order:
            alpha = img[..., -1:, :, :]
            img = img[..., :3, :, :]
            if frame_repr.alpha == AlphaMode.PREMULTIPLIED:
                img = img / torch.clamp_min(alpha, 1e-6)
        img = hooks_at(HookStage.NATIVE, img)
        img = ops_color.decode_color(img, frame_repr, src_color.primaries,
                                     dovi_packed=dovi_p,
                                     adjustment=params.color_adjustment)
        if rot == 2:
            img = rot180(img)
            if alpha is not None:
                alpha = rot180(alpha)
        elif rot in (1, 3):
            img = rot90(img)
            if alpha is not None:
                alpha = rot90(alpha)
        img = hooks_at(HookStage.RGB, img)
        if params.lut is not None and params.lut_type == "native":
            img = ops_lut.apply_lut(img, params.lut)

        # ---- pass_scale_main
        if use_linear:
            img = linearize_src(img)
            img = hooks_at(HookStage.LINEAR, img)
            if sig is not None:
                img = ops_color.sigmoidize(img, sig)
                img = hooks_at(HookStage.SIGMOID, img)
        img = hooks_at(HookStage.PRE_KERNEL, img)
        if needs_scale:
            ext = extend_rows(img, halo_s, mesh)
            if cfg_s.polar:
                img = ops_polar.sample_polar(ext, cfg_s, dst_l, dst_w,
                                             rect_s, antiring=antiring)
            else:
                img = ops_sampling.resize_separable(
                    ext, dst_l, dst_w, cfg_s, rect_s, cfg_down=down,
                    antiring=antiring)
            if alpha is not None:
                exta = extend_rows(alpha, halo_s, mesh)
                if cfg_s.polar:
                    alpha = ops_polar.sample_polar(exta, cfg_s, dst_l,
                                                   dst_w, rect_s)
                else:
                    alpha = ops_sampling.resize_separable(
                        exta, dst_l, dst_w, cfg_s, rect_s, cfg_down=down)
        img = hooks_at(HookStage.POST_KERNEL, img)
        if sig is not None:
            img = ops_color.desigmoidize(img, sig)
        img = hooks_at(HookStage.SCALED, img)

        # ---- pass_convert_colors
        if params.cone is not None:
            img = ops_color.cone_distort(img, src_color, params.cone,
                                         already_linear=use_linear)
        new_state = state
        if need_color_map:
            if not use_linear:
                img = linearize_src(img)
            stats = None
            if use_peak:
                avg_pq, max_pq, new_state = ops_peak.applied_stats(
                    img, state, params.peak_detect, src_max_pq, group=mesh)
                stats = (avg_pq, max_pq)
            if fused_tail is not None:
                # K1's peak partials are not the sharded detection's
                img, _ = fused_tail(img, stats, row0=row0d)
                rmod.k1_tails += 1
            else:
                img = color_map_stage(img, src_color, dst_color, params,
                                      stats, tone_recovery_impl=recovery_impl)
                img = delinearize_to(img, dst_color)
                if tail_eligible:
                    rmod.plain_tails += 1
                else:
                    rmod.ineligible_tails += 1
        elif use_linear:
            img = delinearize_to(img, src_color)

        # ---- pass_output_target
        img = hooks_at(HookStage.PRE_OUTPUT, img)
        if fused_tail is None:
            if params.lut is not None and params.lut_type == "conversion":
                img = ops_lut.apply_lut(img, params.lut)
            img = ops_color.encode_color(img, target.repr,
                                         dst_color.primaries)
        img = hooks_at(HookStage.OUTPUT, img)
        if alpha is not None:
            if target.repr.alpha == AlphaMode.PREMULTIPLIED:
                img = img * alpha
            img = torch.cat([img, alpha], dim=-3)
        hs_out = ()
        if hook_state_specs:
            hs_out = tuple(hs_ctx["out"].get((h.signature, nm),
                                             hs_ctx["cur"][(h.signature, nm)])
                           for h, names in hook_state_specs
                           for nm in names)
        if needs_outer:
            return img, new_state, hs_out
        if bias_l is not None:
            img = ops_dither.dither(img, target.bit_depth, dp, bias=bias_l)
        if params.blend is not None and tgt is not None:
            img = Renderer._blend_target(img, tgt, params.blend)
        # overlays blend after the dither: each shard the rows of the
        # overlay's (whole-frame) rect that cross its block
        for ov, ov_data in zip(overlays, ov_datas):
            r = ov.rect
            x0, y0 = int(round(r.x0)), int(round(r.y0))
            x1, y1 = int(round(r.x1)), int(round(r.y1))
            ov_l = replace(ov, rect=RectF(x0, y0 - row0d, x1, y1 - row0d))
            img = Renderer._blend_overlay(img, ov_data, ov_l, False, target,
                                          dst_color, params, crop,
                                          dst_crop_t, rotation, frame_hw)
        return torch.clamp(img, 0.0, 1.0), new_state, hs_out

    def outer_stage(img, ov_datas, tgt):
        """Composite the gathered image into the whole target, corner
        rounding, dither, blend and overlays as the single-device
        renderer runs them; this rank keeps its target rows."""
        img = comm.all_gather(img, mesh, -2)
        comps = img.shape[-3]
        th, tw = target.h, target.w
        if needs_composite:
            canvas = Renderer._background(params, comps, th, tw, dev,
                                          mode=border).clone()
            img = _paste(canvas, img, y0_t, x0_t)
        if params.corner_rounding > 0:
            mask = _corner_mask(params.corner_rounding, th, tw, dev)
            bg = Renderer._background(params, comps, th, tw, dev)
            img = fma(img - bg, mask, bg)
        if quantize and dp is not None:
            bias = torch.from_numpy(ops_dither.bias_matrix(
                dp, th, tw, 0)).to(dev)
            img = ops_dither.dither(img, target.bit_depth, dp, bias=bias)
        if params.blend is not None and tgt is not None:
            img = Renderer._blend_target(
                img, comm.all_gather(tgt, mesh, -2), params.blend)
        for ov, ov_data in zip(overlays, ov_datas):
            img = Renderer._blend_overlay(img, ov_data, ov, False, target,
                                          dst_color, params, crop,
                                          dst_crop_t, rotation, frame_hw)
        tl = th // n_sp
        return torch.clamp(img, 0.0, 1.0)[..., me * tl:(me + 1) * tl, :]

    border = params.border or params.background

    def run(state, *planes, grain_tables=None, dovi_packed=None,
            prev_planes=None, next_planes=None, overlay_datas=None,
            target_data=None, hook_states=None):
        if grain_cfgs is not None and grain_tables is None:
            raise RenderError(
                "frame carries AV1 grain: pass grain_tables= (per frame, "
                "ops.film_grain.prepare_av1_grain per plane)")
        if grain_cfgs is None and grain_tables is not None:
            raise RenderError(
                "grain_tables passed but the pipeline was built without "
                "frame_grain= (grain would be silently skipped)")
        if di_on and has_temporal and (prev_planes is None or
                                       next_planes is None):
            raise RenderError("temporal deinterlace: pass prev/next planes")
        if overlays and (overlay_datas is None or
                         len(overlay_datas) != len(overlays)):
            raise RenderError(
                "pipeline was built with overlays: pass overlay_datas= "
                "(batched (B, 4, h, w) per overlay)")
        if target_data is not None and params.blend is None:
            raise RenderError(
                "target_data passed but params.blend is None (the "
                "contents would be silently ignored)")
        b_l = planes[0].shape[0]
        if hook_state_specs and hook_states is None:
            hook_states = _initial_hook_states(hook_state_specs, b_l, mesh,
                                               rows_split=True)
        outs, states, hss = [], [], []
        for b in range(b_l):
            pick = (lambda seq: None if seq is None else
                    tuple(p[b] for p in seq))
            img, st, hs = frame_step(
                state[b], tuple(p[b] for p in planes),
                grain_tables[b] if grain_tables is not None else None,
                dovi_packed[b] if dovi_packed is not None else None,
                pick(prev_planes), pick(next_planes),
                tuple(o[b] for o in (overlay_datas or ())),
                target_data[b] if target_data is not None else None,
                tuple(h[b] for h in (hook_states or ())))
            if needs_outer:
                img = outer_stage(img, tuple(o[b] for o in
                                             (overlay_datas or ())),
                                  target_data[b] if target_data is not None
                                  else None)
            outs.append(img)
            states.append(st)
            hss.append(hs)
        out = torch.stack(outs)
        new_state = torch.stack(states)
        if hook_state_specs:
            return out, new_state, tuple(torch.stack(v) for v in zip(*hss))
        return out, new_state

    run.route, run.reason = "halo", None
    return run


def _initial_hook_states(specs, b_l: int, mesh, rows_split: bool) -> tuple:
    """The stateful hooks' declared initial values, batched over the
    local frames; texture state as this rank's rows when `rows_split`."""
    vals = []
    for h, names in specs:
        for nm in names:
            v = _state_init(h.state_spec[nm], mesh.device)
            if rows_split and nm.startswith("tex:"):
                r0, r1 = _rows(mesh, v.shape[-2])
                v = v[..., r0:r1, :]
            vals.append(v.unsqueeze(0).expand((b_l,) + tuple(v.shape))
                        .contiguous())
    return tuple(vals)


# ---------------------------------------------------------------------------
# The replicated step: every feature the halo pipeline cannot express
# ---------------------------------------------------------------------------

def _build_replicated_step(mesh, plane_metas, frame_repr, frame_color,
                           target, params, crop, frame_grain, field,
                           first_field, frame_icc, has_temporal, overlays,
                           rotation, why: Optional[str] = None):
    """The counterpart of the reference's `_build_gspmd_step`
    (libplacebo_tpu/parallel/renderer.py:1057), which runs the
    single-device trace under sharding constraints and lets XLA insert
    the collectives.  Here: every rank of the spatial group gathers the
    whole source frame (one all-gather a plane), renders it with the
    single-device pipeline (kernels K1, K2 and K3 where it runs them)
    and keeps its own output rows (all of them where the target's rows
    do not split).  The per-frame semantics are the single-device
    renderer's by construction; the cost is n times the compute on n
    ranks."""
    reason = ("user hooks" if params.hooks else
              f"rotation {rotation % 4 * 90}" if rotation % 4 in (1, 3) else
              "distortion" if params.distort is not None else
              "error diffusion (whole-frame serial scan, replicated pass)"
              if params.error_diffusion is not None else
              "blur/skip border" if (params.border or params.background)
              in ("blur", "skip") or params.skip_target_clearing else
              "halo-unsupported geometry")
    core_log.default_log().info(
        f"sharded renderer: {reason} -> replicated step (the whole frame "
        "gathered), not the halo pipeline")

    ref_i = Renderer._ref_plane_index(plane_metas)
    H, W = plane_metas[ref_i][0][-2], plane_metas[ref_i][0][-1]
    crop = crop or RectF(0, 0, W, H)
    dev = mesh.device
    renderer = Renderer(device=dev)
    all_overlays = tuple((ov, False) for ov in overlays) + \
        tuple((ov, True) for ov in (target.overlays or ()))
    pipeline = renderer._trace_pipeline(
        (plane_metas,), target, params, frame_repr, frame_color, crop,
        frame_grain, dither_phase=0, frame_icc=frame_icc, field=field,
        first_field=first_field, rotation=rotation, overlays=all_overlays)
    h274_tables = None
    if params.film_grain and ops_h274.needs_fg_h274(frame_grain):
        h274_tables = ops_h274.prepare_h274(
            frame_grain, [(() if 3 in mapping else tuple(mapping),
                           shape[-2], shape[-1])
                          for shape, mapping, _, _ in plane_metas], dev)
    tgt_ov_data = tuple(torch.as_tensor(o.data, dtype=torch.float32,
                                        device=dev)
                        for o in (target.overlays or ()))
    hook_specs = _hook_specs(params.hooks)
    r0, r1 = _rows(mesh, target.h)

    def whole(block, rows):
        """The whole plane from this rank's rows of it."""
        if block.shape[-2] == rows:
            return block
        return comm.all_gather(block, mesh, -2)

    def run(state, *planes, grain_tables=None, dovi_packed=None,
            prev_planes=None, next_planes=None, overlay_datas=None,
            target_data=None, hook_states=None):
        if overlays and (overlay_datas is None or
                         len(overlay_datas) != len(overlays)):
            raise RenderError(
                "pipeline was built with overlays: pass overlay_datas=")
        if target_data is not None and params.blend is None:
            raise RenderError(
                "target_data passed but params.blend is None (the "
                "contents would be silently ignored)")
        b_l = planes[0].shape[0]
        if hook_states is None:
            hook_states = _initial_hook_states(hook_specs, b_l, mesh,
                                               rows_split=False)
        rows = [meta[0][-2] for meta in plane_metas]
        outs, states, hss = [], [], []
        for b in range(b_l):
            full = tuple(whole(p[b], r) for p, r in zip(planes, rows))
            prev = tuple(whole(p[b], r) for p, r in
                         zip(prev_planes, rows)) if prev_planes else None
            nxt = tuple(whole(p[b], r) for p, r in
                        zip(next_planes, rows)) if next_planes else None
            inputs = FrameInputs(
                grain_tables[b] if grain_tables is not None else None,
                h274_tables, prev, nxt,
                dovi_packed[b] if dovi_packed is not None else None,
                whole(target_data[b], target.h)
                if target_data is not None else None,
                tuple(o[b] for o in (overlay_datas or ())) + tgt_ov_data,
                tuple(h[b] for h in hook_states))
            img, st, hs = pipeline(state[b], inputs, *full)
            outs.append(img[..., r0:r1, :])
            states.append(st)
            hss.append(hs)
        out = torch.stack(outs)
        new_state = torch.stack(states)
        if hook_specs:
            return out, new_state, tuple(torch.stack(v) for v in zip(*hss))
        return out, new_state

    run.route, run.reason = "replicated", why or reason
    return run


# ---------------------------------------------------------------------------
# Frame mixing
# ---------------------------------------------------------------------------

def sharded_render_mix(mesh, step, state, frame_planes, timestamps,
                       vsync_duration: float, params=None,
                       bit_depth: int = 0, dither_bias=None, **step_kw):
    """The sharded render_image_mix: run `step` (built with bit_depth 0
    on the target, so the intermediates stay continuous) once a mix
    frame and blend them with the single-device mixer's weights; the sum
    and the final dither stay on the local rows (reference
    pl_render_image_mix, renderer.c:3612).

    frame_planes: per mix frame, its local plane blocks.  The peak state
    threads through the frames in order, and so do the stateful hooks'
    values (`hook_states` in step_kw for the previous mix's); returns
    (out, state) or (out, state, hook_states).  `dither_bias`: this
    block's rows of the frame's bias (None: made here from the mesh)."""
    params = params or DEFAULT_PARAMS
    w = _mix_weights(params, timestamps, vsync_duration)
    out = img0 = None
    hs = step_kw.pop("hook_states", None)
    stateful = False
    for wi, planes in zip(w, frame_planes):
        res = step(state, *planes, hook_states=hs, **step_kw)
        if len(res) == 3:
            img, state, hs = res
            stateful = True
        else:
            img, state = res
        if img0 is None:
            img0 = img
        if wi == 0.0:
            continue
        term = img * float(wi)
        out = term if out is None else out + term
    if out is None:
        # all weights zero: the first frame as it is (rendering it again
        # would advance the carried state twice)
        out = img0
    if bit_depth and params.dither is not None and \
            (bit_depth < 16 or params.force_dither):
        if dither_bias is None:
            hl, wd = out.shape[-2], out.shape[-1]
            h = hl * mesh.spatial
            r0 = mesh.spatial_index * hl
            dither_bias = torch.from_numpy(np.ascontiguousarray(
                ops_dither.bias_matrix(params.dither, h, wd)[r0:r0 + hl])
            ).to(out.device)
        out = ops_dither.dither(out, bit_depth, params.dither,
                                bias=dither_bias)
    out = torch.clamp(out, 0.0, 1.0)
    if stateful:
        return out, state, hs
    return out, state

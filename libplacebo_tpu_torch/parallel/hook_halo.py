"""Which mpv user hooks ride the halo pipeline, and with what footprint.

Counterpart of libplacebo_tpu/parallel/hook_halo.py.  A bounded-stencil
hook runs on the row block extended by its footprint (`extend_rows`,
O(halo) bytes) and is cropped back; anything else goes to the
replicated step.  Eligibility is proven per (hook, stage), not assumed:

1. *Structural*: mpv shader hooks only (the interpreter is
   introspectable); every pass same-size (no WIDTH/HEIGHT); no //!OFFSET;
   no atomicAdd on STORAGE buffers (a frame-global reduction).  COMPUTE
   passes only with threads == block (the per-pixel invocation grid).
   Cross-frame state only when row-shardable: STORAGE textures sized
   exactly like the hooked stage, buffer variables with uniform updates;
   a stateful hook hooks exactly one executed stage.
2. *Probed*: the hook runs once on zeros of the stage's shape on the
   mesh's device under `mpv_hooks.probe_recording` (the reference runs
   it under jax.eval_shape).  The recording sees the row-index patterns
   of every image-derived texture access, not the values, and flags a
   sampling position that enters value arithmetic (position-dependent
   shading, not shift invariant).  The footprint is the sum over passes
   of the largest row deviation.  It costs one hook call at plan time.
3. *Verified*: the stage's whole hook composition runs concretely on
   random data, on an interior block and on the frame's first and last
   blocks (their frame-side halo edge-replicated as extend_rows builds
   it), and each block's rows must equal the whole image's exactly —
   outputs and carried state.  Compositions of stencils that edge
   replication cannot reproduce fail here.

//!WHEN conditions see the frame's sizes during sharded execution
(`HookParams.size_override`), in the probe and the check too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["plan_halo_hooks"]

# stencils larger than this are cheaper replicated
_MAX_FOOTPRINT = 64


def _structurally_eligible(hook) -> bool:
    shader = getattr(hook, "user_shader", None)
    if shader is None:
        return False                    # an opaque python hook
    state_spec = getattr(hook, "state_spec", None) or {}
    if any(k.startswith("buf:") for k in state_spec) and \
            any("atomicAdd" in p.body for p in shader.passes):
        return False                    # a reduction over the pixels
    for p in shader.passes:
        if p.width is not None or p.height is not None:
            return False                # a resizing pass
        if p.is_compute and (p.threads_w, p.threads_h) not in (
                (0, 0), (p.block_w, p.block_h)):
            return False                # workgroup-anchored geometry
        if p.offset != (0.0, 0.0) or p.offset_align:
            return False                # needs the rect channel
    return True


def _state_shardable(hook, stage_geom, executed_stages) -> bool:
    state_spec = getattr(hook, "state_spec", None) or {}
    if not state_spec:
        return True
    hooked = [st for st in executed_stages if hook.stages & st]
    if len(hooked) != 1:
        return False                    # per-stage state bookkeeping
    c, h, w = stage_geom[hooked[0]]
    for name, init in state_spec.items():
        if name.startswith("tex:"):
            shp = np.shape(init)
            if len(shp) != 3 or shp[-2:] != (h, w):
                return False            # not per-pixel at this stage
    return True


def _access_footprint(accesses) -> Optional[int]:
    """The sum of the passes' largest row deviations; None if an access
    is not one index set a row (a whole-row or single-row read)."""
    per_pass: Dict[int, float] = {}
    for pidx, iy, out_rows in accesses:
        arr = np.asarray(iy, np.float64)
        if arr.ndim == 0:
            return None
        flat = arr.reshape(arr.shape[0], -1)
        if arr.shape[0] != out_rows:
            return None
        rows = np.arange(out_rows, dtype=np.float64)
        dev = max(float((flat.max(1) - rows).max()),
                  float((rows - flat.min(1)).max()), 0.0)
        per_pass[pidx] = max(per_pass.get(pidx, 0.0), dev)
    return int(np.ceil(sum(per_pass.values())))


def _probe_footprint(hook, stage, c, h, w, dst_w, dst_h, size_override,
                     device) -> Optional[int]:
    from ..render.hooks import HookParams
    from ..render.mpv_hooks import probe_recording

    rec: dict = {}
    hp = HookParams(stage=stage, src_h=h, src_w=w, dst_w=dst_w,
                    dst_h=dst_h, components=c, size_override=size_override)
    try:
        with probe_recording(rec):
            out = hook.func(torch.zeros((c, h, w), dtype=torch.float32,
                                        device=device), hp)
    except Exception:
        return None
    if out is not None and tuple(out.shape) != (c, h, w):
        return None                     # changed size or components
    if rec["pos_value"]:
        return None                     # position-dependent shading
    return _access_footprint(rec["accesses"])


def _extend_np(arr, lo, hi, fp, hv):
    """Rows [lo, hi) of `arr` extended by fp rows each side, edge rows
    replicated at the frame's ends: what extend_rows(mode="edge")
    builds for that block."""
    if fp == 0:
        return arr[..., lo:hi, :]
    top = (np.repeat(arr[..., :1, :], fp, axis=-2) if lo == 0
           else arr[..., lo - fp:lo, :])
    bot = (np.repeat(arr[..., -1:, :], fp, axis=-2) if hi == hv
           else arr[..., hi:hi + fp, :])
    return np.concatenate([top, arr[..., lo:hi, :], bot], axis=-2)


def _verify_equivariance(hooks, stage, c, h, w, dst_w, dst_h,
                         size_override, fp: int, n_sp: int,
                         device) -> bool:
    """The composed hook list of `stage`, run on one block extended by
    the stage's total footprint (as the halo step's hooks_at runs it),
    equals the whole image's rows on an interior block and on the first
    and last blocks; see the module docstring, item 3."""
    from ..render.hooks import run_hooks

    state_specs = [(hk, tuple(sorted(hk.state_spec)))
                   for hk in hooks if getattr(hk, "state_spec", None)]
    rng = np.random.default_rng(12345)
    if state_specs:
        # carried texture state splits with the rows: the check runs at
        # the stage's real geometry (the shader fixes the state's size)
        hv, wv = h, w
        nb = h // n_sp
    else:
        hv = max(4 * fp + 16, 32)
        wv = min(w, 192)
        nb = max(fp + 3, 8)
    img = rng.random((c, hv, wv)).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    full_states = None
    if state_specs:
        # random carried state: equivariance for any state, with an
        # equivariant state out, gives multi-frame parity by induction
        full_states = {(hk.signature, nm): rng.random(
            np.shape(hk.state_spec[nm])).astype(np.float32)
            for hk, names in state_specs for nm in names}

    def mk_states(lo=None, hi=None):
        if not state_specs:
            return None
        states = {}
        for hk, names in state_specs:
            sin = {}
            for nm in names:
                v = full_states[(hk.signature, nm)]
                if nm.startswith("tex:") and lo is not None:
                    v = _extend_np(v, lo, hi, fp, hv)
                sin[nm] = dev(v)
            states[hk.signature] = (sin, {})
        return states

    def run(x, states):
        out = run_hooks(list(hooks), stage, dev(x), None, states=states,
                        dst_w=dst_w, dst_h=dst_h,
                        size_override=size_override)
        souts = {}
        if states:
            for hk, names in state_specs:
                sin, sout = states[hk.signature]
                for nm in names:
                    souts[(hk.signature, nm)] = \
                        sout.get(nm, sin[nm]).cpu().numpy()
        return out.cpu().numpy(), souts

    try:
        full, full_souts = run(img, mk_states())
    except Exception:
        return False
    if full.shape != (c, hv, wv):
        return False

    def check(lo: int, hi: int) -> bool:
        ext = _extend_np(img, lo, hi, fp, hv)
        try:
            part, souts = run(ext, mk_states(lo, hi))
        except Exception:
            return False
        if part.shape != (c, (hi - lo) + 2 * fp, wv):
            return False
        if not np.array_equal(part[..., fp:fp + (hi - lo), :]
                              if fp else part, full[..., lo:hi, :]):
            return False
        for key, v in souts.items():
            fv = full_souts[key]
            if key[1].startswith("tex:"):
                inner = v[..., fp:fp + (hi - lo), :] if fp else v
                if not np.array_equal(inner, fv[..., lo:hi, :]):
                    return False        # state not row-equivariant
            elif not np.array_equal(v, fv):
                return False            # buffer state varies by block
        return True

    mid = (hv - nb) // 2
    for lo, hi in dict.fromkeys([(mid, mid + nb), (0, nb), (hv - nb, hv)]):
        if not check(lo, hi):
            return False
    return True


def plan_halo_hooks(params, plane_metas, repr_sys, H: int, W: int,
                    dst_w: int, dst_h: int, n_sp: int,
                    device="cpu") -> Optional[dict]:
    """The halo plan of params.hooks, or None when some (hook, stage) is
    not provably a bounded row stencil (the caller then takes the
    replicated step).  Returns {stage: {"hooks": [...], "F": total
    footprint}} for every stage with a hook, and "__sizes__": each
    stage's size_override (the frame's sizes)."""
    from ..render.hooks import HookStage
    from ..render.mpv_hooks import _STAGE_NAME
    from ..render.renderer import Renderer

    chans = sorted({ch for meta in plane_metas for ch in meta[1]
                    if ch != 3})
    c_main = max(len(chans), 1)
    # per stage, the (channels, rows, cols) the hook sees in the frame
    stage_geom: Dict[HookStage, Tuple[int, int, int]] = {}
    for (shape, mapping, sx, sy) in plane_metas:
        st_in, st_scaled = Renderer._plane_hook_stage(mapping, repr_sys)
        ph, pw = shape[-2], shape[-1]
        if st_in is not None:
            stage_geom.setdefault(st_in, (len(mapping), ph, pw))
        if st_scaled is not None:
            stage_geom.setdefault(st_scaled, (len(mapping), H, W))
    for st in (HookStage.NATIVE, HookStage.RGB, HookStage.LINEAR,
               HookStage.SIGMOID, HookStage.PRE_KERNEL):
        stage_geom[st] = (c_main, H, W)
    for st in (HookStage.POST_KERNEL, HookStage.SCALED,
               HookStage.PRE_OUTPUT, HookStage.OUTPUT):
        stage_geom[st] = (c_main, dst_h, dst_w)

    plan: Dict = {}
    sizes: Dict = {}
    for hook in params.hooks:
        if not _structurally_eligible(hook):
            return None
        executed = [st for st in stage_geom if hook.stages & st]
        if not _state_shardable(hook, stage_geom, executed):
            return None
        for st in executed:
            c, h, w = stage_geom[st]
            override = {"HOOKED": (h, w), "NATIVE": (H, W)}
            stage_name = _STAGE_NAME.get(st)
            if stage_name:
                override[stage_name] = (h, w)
            fp = _probe_footprint(hook, st, c, h, w, dst_w, dst_h,
                                  override, device)
            if fp is None or fp > _MAX_FOOTPRINT:
                return None
            ent = plan.setdefault(st, {"hooks": [], "F": 0})
            ent["hooks"].append(hook)
            ent["F"] += fp
            sizes[st] = override
    for st, ent in plan.items():
        c, h, w = stage_geom[st]
        if h % n_sp != 0 or ent["F"] > h // n_sp:
            return None                 # the halo exceeds a block
        if not _verify_equivariance(ent["hooks"], st, c, h, w, dst_w,
                                    dst_h, sizes[st], ent["F"], n_sp,
                                    device):
            return None
    plan["__sizes__"] = sizes
    return plan

"""Carry state from the JAX reference package into the port.

The renderer has no weights; what crosses is the carried state (the
peak-detection state (2,) and the temporal frame index), the input
planes, the frame's film-grain description (AV1 or H.274), its Dolby
Vision metadata, its overlays, rotation and pixel aspect, its HDR
metadata (mastering primaries and an HDR10+ curve included), the user's
color adjustment and cone parameters, a frame-mix window, the hooks'
carried state, the degradation flags and disabled hooks, a context's
cache (as its saved bytes) and, for a test that wants to rule out the
random draws, deband's random tables.  The dither LUT
and the grain tables are regenerated bit-identically from the same
native sources.  The interface is numpy arrays and plain dicts, so this
module — like the rest of the port — never imports JAX.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.cache import Cache
from .core.colorspace import (BitEncoding, CIExy, ColorAdjustment,
                              ColorRepr, ColorSpace, Cone, ConeParams,
                              DoviMetadata, HdrBezier, HdrMetadata,
                              RawPrimaries)
from .core.common import RectF, Rotation
from .core.film_grain import AV1GrainData, FilmGrainData, H274GrainData
from .render.frame import Frame, Overlay, OverlayPart, Plane
from .render.queue import FrameMix
from .render.renderer import Renderer
from .utils.device import resolve_device

__all__ = ["renderer_state_from_jax", "frame_from_numpy",
           "film_grain_from_fields", "dovi_from_fields",
           "deband_tables_from_numpy", "repr_from_fields",
           "colorspace_from_fields", "overlay_from_fields",
           "color_adjustment_from_fields", "cone_params_from_fields",
           "frame_mix_from_fields", "hook_states_from_numpy",
           "renderer_errors_from_jax", "cache_from_saved"]


def renderer_state_from_jax(peak_state: np.ndarray, frame_idx: int,
                            renderer: Renderer = None,
                            device=None) -> Renderer:
    """Load a reference Renderer's carried state — np.asarray(
    r._peak_state) and r._frame_idx — into `renderer` (a new one on
    `device` if None) and return it."""
    state = np.asarray(peak_state, dtype=np.float32).reshape(2)
    r = renderer if renderer is not None else Renderer(device)
    r._peak_state = torch.from_numpy(state.copy()).to(r.device)
    r._frame_idx = int(frame_idx)
    return r


def frame_from_numpy(planes: Sequence, repr: ColorRepr, color: ColorSpace,
                     device=None, shifts=None, rotation: int = 0,
                     pixel_aspect_ratio: float = 0.0) -> Frame:
    """A Frame from normalized float planes: `planes` is a sequence of
    (data (C, H, W) float32, component_mapping) pairs, as
    [(np.asarray(p.data), p.component_mapping) for p in frame.planes];
    `shifts` optionally gives each plane's (shift_x, shift_y);
    `rotation` and `pixel_aspect_ratio` are the reference frame's."""
    dev = resolve_device(device)
    out = []
    for i, (data, mapping) in enumerate(planes):
        sx, sy = shifts[i] if shifts is not None else (0.0, 0.0)
        t = torch.from_numpy(np.array(data, np.float32)).to(dev)
        out.append(Plane(t, tuple(mapping), shift_x=sx, shift_y=sy))
    return Frame(planes=out, repr=repr, color=color,
                 rotation=Rotation(int(rotation)),
                 pixel_aspect_ratio=float(pixel_aspect_ratio))


def _ints(v):
    """Nested sequences of integers as nested tuples of Python ints."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_ints(x) for x in v)
    return int(v)


def film_grain_from_fields(d: dict) -> FilmGrainData:
    """The port's FilmGrainData from the fields of a reference one —
    dataclasses.asdict(frame.film_grain) — for AV1 or H.274 grain."""
    if d.get("type") == "h274" and d.get("h274") is not None:
        h = dict(d["h274"])
        h["component_model_present"] = tuple(
            bool(v) for v in h["component_model_present"])
        for name in ("model_id", "blending_mode_id", "log2_scale_factor"):
            h[name] = int(h[name])
        for name in ("num_intensity_intervals", "num_model_values",
                     "intensity_interval_lower_bound",
                     "intensity_interval_upper_bound", "comp_model_value"):
            h[name] = _ints(h[name])
        return FilmGrainData(type="h274", seed=int(d["seed"]),
                             h274=H274GrainData(**h))
    if d.get("type") != "av1" or d.get("av1") is None:
        raise ValueError(f"no AV1 or H.274 grain in {d.get('type')!r}")
    a = dict(d["av1"])
    for name in ("points_y", "num_points_uv", "points_uv", "ar_coeffs_y",
                 "ar_coeffs_uv", "uv_mult", "uv_mult_luma", "uv_offset"):
        a[name] = _ints(a[name])
    return FilmGrainData(type="av1", seed=int(d["seed"]),
                         av1=AV1GrainData(**a))


def _floats(v):
    """Nested sequences (or arrays) of numbers as nested float tuples."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_floats(x) for x in v)
    return float(v)


def dovi_from_fields(d: dict) -> DoviMetadata:
    """The port's DoviMetadata from the fields of a reference one —
    dataclasses.asdict(repr.dovi), whose per-component entries are
    dicts or numpy arrays."""
    comp = []
    for c in d["comp"]:
        comp.append({
            "num_pivots": int(c["num_pivots"]),
            "pivots": _floats(c["pivots"]),
            "method": _ints(c["method"]),
            "poly_coeffs": _floats(c["poly_coeffs"]),
            "mmr_order": _ints(c["mmr_order"]),
            "mmr_constant": _floats(c["mmr_constant"]),
            "mmr_coeffs": _floats(c["mmr_coeffs"])})
    return DoviMetadata(nonlinear_offset=_floats(d["nonlinear_offset"]),
                        nonlinear=_floats(d["nonlinear"]),
                        linear=_floats(d["linear"]), comp=tuple(comp))


def deband_tables_from_numpy(choices: Sequence, noise, device=None):
    """Deband random tables — the reference's deband_rng_tables output
    as numpy arrays: per-iteration (H, W) candidate choices and the grain
    noise (or None) — as the tensors `ops.deband.deband(tables=)`
    takes."""
    dev = resolve_device(device)
    return ([torch.from_numpy(np.array(c, np.int32)).to(dev)
             for c in choices],
            torch.from_numpy(np.array(noise, np.float32)).to(dev)
            if noise is not None else None)


def _value(v):
    """An enum member's value (the reference's enums cross as members
    of the reference's classes, or as their values)."""
    return getattr(v, "value", v)


def repr_from_fields(d: dict) -> ColorRepr:
    """The port's ColorRepr from dataclasses.asdict() of a reference one
    (without Dolby Vision metadata: see dovi_from_fields)."""
    return ColorRepr(sys=_value(d["sys"]), levels=_value(d["levels"]),
                     alpha=_value(d["alpha"]),
                     bits=BitEncoding(**{k: int(v)
                                         for k, v in d["bits"].items()}))


_HDR_SCALARS = ("min_luma", "max_luma", "max_cll", "max_fall", "scene_avg",
                "max_pq_y", "avg_pq_y")


def _xy(d) -> CIExy:
    return CIExy(float(d["x"]), float(d["y"])) if d else CIExy()


def colorspace_from_fields(d: dict) -> ColorSpace:
    """The port's ColorSpace from dataclasses.asdict() of a reference
    one: primaries, transfer and the HDR metadata (its scalars, scene
    maxima, mastering primaries and HDR10+ curve)."""
    hdr = d.get("hdr") or {}
    prim = hdr.get("prim") or {}
    ootf = hdr.get("ootf")
    return ColorSpace(_value(d["primaries"]), _value(d["transfer"]),
                      HdrMetadata(
                          prim=RawPrimaries(*(_xy(prim.get(k)) for k in (
                              "red", "green", "blue", "white"))),
                          scene_max=tuple(
                              float(v) for v in hdr.get("scene_max",
                                                        (0.0, 0.0, 0.0))),
                          ootf=None if ootf is None else HdrBezier(
                              float(ootf["target_luma"]),
                              float(ootf["knee_x"]), float(ootf["knee_y"]),
                              tuple(float(a) for a in ootf["anchors"])),
                          **{k: float(hdr.get(k, 0.0))
                             for k in _HDR_SCALARS}))


def _rect(v) -> RectF:
    if isinstance(v, dict):
        return RectF(float(v["x0"]), float(v["y0"]), float(v["x1"]),
                     float(v["y1"]))
    return RectF(*(float(x) for x in v))


def overlay_from_fields(d: dict, device=None) -> Overlay:
    """The port's Overlay from the fields of a reference one —
    dataclasses.asdict(overlay) with `data` as a numpy array, or the
    same fields as plain values (rects as dicts or 4-tuples)."""
    dev = resolve_device(device)
    parts = tuple(OverlayPart(_rect(p["src"]), _rect(p["dst"]),
                              tuple(float(c) for c in p["color"]))
                  for p in d.get("parts", ()))
    return Overlay(
        data=torch.from_numpy(np.array(d["data"], np.float32)).to(dev),
        rect=_rect(d["rect"]) if d.get("rect") is not None else None,
        color=colorspace_from_fields(d["color"]),
        repr=repr_from_fields(d["repr"]), mode=d.get("mode", "normal"),
        coords=d.get("coords", "auto"), parts=parts)


def color_adjustment_from_fields(d: dict) -> ColorAdjustment:
    """The port's ColorAdjustment from dataclasses.asdict() of a
    reference one."""
    return ColorAdjustment(**{k: float(v) for k, v in d.items()})


def cone_params_from_fields(d: dict) -> ConeParams:
    """The port's ConeParams from dataclasses.asdict() of a reference
    one (the cones as the reference's Cone flag or its integer)."""
    return ConeParams(Cone(int(d["cones"])), float(d["strength"]))


def frame_mix_from_fields(frames: Sequence[Frame], timestamps,
                          vsync_duration: float) -> FrameMix:
    """The port's FrameMix over frames already carried (frame_from_numpy)
    with a reference mix's timestamps and vsync duration."""
    return FrameMix(frames=list(frames),
                    timestamps=[float(t) for t in timestamps],
                    vsync_duration=float(vsync_duration))


def hook_states_from_numpy(states: dict, renderer: Renderer = None,
                           device=None) -> Renderer:
    """Load a reference Renderer's carried hook state — {(hook
    signature, name): np.asarray(value)} from r._hook_states — into
    `renderer` (a new one on `device` if None) and return it."""
    r = renderer if renderer is not None else Renderer(device)
    r._hook_states = {
        (sig, name): torch.from_numpy(np.array(v)).to(r.device)
        for (sig, name), v in states.items()}
    return r


def renderer_errors_from_jax(errors, disabled_hooks,
                             renderer: Renderer = None,
                             device=None) -> Renderer:
    """Load a reference Renderer's degradation state — r.errors and
    r._disabled_hooks (or r.get_errors()), as plain sets — into
    `renderer` (a new one on `device` if None) and return it."""
    r = renderer if renderer is not None else Renderer(device)
    r.errors = set(errors)
    r._disabled_hooks = set(disabled_hooks)
    return r


def cache_from_saved(blob: bytes, cache: Cache = None) -> Cache:
    """A reference context's cache — its `ctx.cache.save()` bytes (the
    two packages share the wire format) — loaded into `cache` (a new one
    if None), returned."""
    c = cache if cache is not None else Cache()
    c.load(blob)
    return c

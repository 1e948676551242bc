"""Carry state from the JAX reference package into the port.

The renderer has no weights; what crosses is the carried state (the
peak-detection state (2,) and the temporal frame index), the input
planes, the frame's film-grain description (AV1 or H.274), its Dolby
Vision metadata and, for a test that wants to rule out the random
draws, deband's random tables.  The dither LUT
and the grain tables are regenerated bit-identically from the same
native sources.  The interface is numpy arrays and plain dicts, so this
module — like the rest of the port — never imports JAX.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.colorspace import ColorRepr, ColorSpace, DoviMetadata
from .core.film_grain import AV1GrainData, FilmGrainData, H274GrainData
from .render.frame import Frame, Plane
from .render.renderer import Renderer
from .utils.device import resolve_device

__all__ = ["renderer_state_from_jax", "frame_from_numpy",
           "film_grain_from_fields", "dovi_from_fields",
           "deband_tables_from_numpy"]


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
                     device=None, shifts=None) -> Frame:
    """A Frame from normalized float planes: `planes` is a sequence of
    (data (C, H, W) float32, component_mapping) pairs, as
    [(np.asarray(p.data), p.component_mapping) for p in frame.planes];
    `shifts` optionally gives each plane's (shift_x, shift_y)."""
    dev = resolve_device(device)
    out = []
    for i, (data, mapping) in enumerate(planes):
        sx, sy = shifts[i] if shifts is not None else (0.0, 0.0)
        t = torch.from_numpy(np.array(data, np.float32)).to(dev)
        out.append(Plane(t, tuple(mapping), shift_x=sx, shift_y=sy))
    return Frame(planes=out, repr=repr, color=color)


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

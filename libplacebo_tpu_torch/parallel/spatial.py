"""The demo-friendly sharded step: full-range RGB batches in, rendered
batches out.

Counterpart of libplacebo_tpu/parallel/spatial.py, a thin shim over
build_sharded_pipeline: HDR10 (PQ, 1000-nit) decode -> resample to
(dst_h, dst_w) with `upscaler` -> tone map to SDR (when tone_map) ->
sRGB encode -> blue-noise dither to `bit_depth` (0 = off).  The halos
and the peak reduction happen inside build_sharded_pipeline.
"""
from __future__ import annotations

from dataclasses import replace

__all__ = ["sharded_render_step"]


def sharded_render_step(mesh, src_h: int, src_w: int, dst_h: int,
                        dst_w: int, upscaler: str = "lanczos",
                        tone_map: bool = True, bit_depth: int = 8):
    """A step for this rank's (B_l, 3, src_h / spatial, src_w) block of
    full-range RGB frames; returns run(rgb_block) -> (B_l, 3,
    dst_h / spatial, dst_w)."""
    from ..core.colorspace import CSP_BT2100_PQ, CSP_SRGB, ColorRepr
    from ..render.renderer import RenderParams, Target
    from .renderer import build_sharded_pipeline, sharded_state_init

    src_color = CSP_BT2100_PQ if tone_map else CSP_SRGB
    if tone_map and src_color.hdr.max_luma <= 0:
        src_color = replace(src_color,
                            hdr=replace(src_color.hdr, max_luma=1000.0))
    repr_ = ColorRepr(sys="rgb", levels="full")
    target = Target(w=dst_w, h=dst_h, repr=repr_, color=CSP_SRGB,
                    bit_depth=bit_depth)
    params = RenderParams(upscaler=upscaler, downscaler=upscaler,
                          plane_upscaler=None, peak_detect=None,
                          dither=None if bit_depth == 0
                          else RenderParams().dither)
    metas = (((3, src_h, src_w), (0, 1, 2), 0.0, 0.0),)
    step = build_sharded_pipeline(mesh, metas, repr_, src_color, target,
                                  params)

    def run(rgb_block):
        state = sharded_state_init(mesh, rgb_block.shape[0] * mesh.data)
        out, _ = step(state, rgb_block)
        return out

    run.step = step
    return run

"""User hooks: custom processing injected at fixed pipeline stages.

Counterpart of libplacebo_tpu/render/hooks.py (pl_hook, custom.h): a
hook is a Python callable on the (C, H, W) torch tensor of its stage, on
the renderer's device; it may return a new tensor (of another size at
the stages whose resizes the renderer follows) or None to leave the
image as it is.  The stage set is pl_hook_stage's.  A hook that raises
is disabled by its signature and logged, as in the reference — but a
kernel's failure or a CUDA error (`_build.is_kernel_failure`) is never
swallowed: it propagates out of the render.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .._build import is_kernel_failure
from ..core import log as core_log

__all__ = ["HookStage", "Hook", "HookParams", "HookRect", "run_hooks"]


class HookStage(enum.Flag):
    """Reference pl_hook_stage (custom.h:106-129)."""
    RGB_INPUT = enum.auto()      # decoded RGB input planes
    LUMA_INPUT = enum.auto()     # raw luma plane
    CHROMA_INPUT = enum.auto()   # raw chroma planes
    ALPHA_INPUT = enum.auto()
    XYZ_INPUT = enum.auto()      # raw planes of an XYZ-encoded frame
    CHROMA_SCALED = enum.auto()  # chroma after merge to luma grid
    ALPHA_SCALED = enum.auto()
    NATIVE = enum.auto()         # combined plane image, pre-decode
    RGB = enum.auto()            # after color decode
    LINEAR = enum.auto()         # linear light
    SIGMOID = enum.auto()        # sigmoidized light
    PRE_KERNEL = enum.auto()     # right before the main scaler
    POST_KERNEL = enum.auto()    # right after the main scaler
    SCALED = enum.auto()         # after scaling, original color space
    PRE_OUTPUT = enum.auto()     # before target color encoding
    OUTPUT = enum.auto()         # final output, pre-dither


@dataclass
class HookRect:
    """The sampling-rect transform hooks declare (the reference's
    pl_hook_res.rect, custom_mpv.c:1533-1551): each pass maps the rect
    as `new = scale * old + offset`.  The renderer keeps one for each
    site that can compensate an offset and uses only the residual offset;
    the scale follows from the image shapes."""
    ox: float = 0.0
    oy: float = 0.0
    align: bool = False          # //!OFFSET ALIGN: pin to the ref grid

    def apply_pass(self, scale_x: float, scale_y: float,
                   off=(0.0, 0.0), align: bool = False) -> None:
        # rect_n = s_n * rect_{n-1} + o_n  =>  acc = s * acc + o
        self.ox = self.ox * scale_x + off[0]
        self.oy = self.oy * scale_y + off[1]
        if align:
            # ALIGN re-anchors the rect to the scaled source rect: the
            # accumulated offset is dropped (custom_mpv.c:1544-1550)
            self.align = True
            self.ox = 0.0
            self.oy = 0.0

    def rotate(self, k: int) -> None:
        """The accumulated offset through a rot90(k) of the image: an
        offset vector (dx, dy) turns to (dy, -dx) each quarter turn (a
        NATIVE offset precedes the rotation; the crop it shifts lies in
        the turned image)."""
        for _ in range(int(k) % 4):
            self.ox, self.oy = self.oy, -self.ox


@dataclass
class HookParams:
    """What a hook sees (reference pl_hook_params, custom.h:167-259)."""
    stage: HookStage
    src_w: int = 0
    src_h: int = 0
    dst_w: int = 0
    dst_h: int = 0
    components: int = 3
    parameters: Dict[str, float] = field(default_factory=dict)
    # the sampling-rect accumulator where the renderer compensates
    # declared offsets; None elsewhere (declaring one there raises and
    # disables the hook)
    rect: Optional[HookRect] = None
    # cross-frame hook state: the carried values and the next frame's,
    # by name
    state_in: Optional[Dict] = None
    state_out: Optional[Dict] = None
    # size overrides (name -> (h, w)) for hooks run on part of a frame
    size_override: Optional[Dict] = None


@dataclass
class Hook:
    """A user hook (reference pl_hook, custom.h:300-340).

    func(img, params: HookParams) -> img or None.  A hook may also carry
    a `state_spec` attribute, {name: initial value}: state the renderer
    keeps across frames for it (params.state_in / state_out)."""
    stages: HookStage
    func: Callable
    name: str = ""
    # tunable parameters (the mpv PARAM model, custom_mpv.c:687)
    parameters: Dict[str, float] = field(default_factory=dict)
    signature: int = 0

    def __post_init__(self):
        if not self.signature:
            self.signature = id(self.func)


def run_hooks(hooks: Optional[List[Hook]], stage: HookStage, img,
              disabled: Optional[set] = None, states=None, **ctx):
    """Run every enabled hook of `stage` in order on `img`.

    `states` maps a hook's signature to its (state_in, state_out) dicts;
    a hook with a `state_spec` reads the carried values from state_in and
    leaves the next frame's in state_out."""
    if not hooks:
        return img
    params = HookParams(stage=stage,
                        src_h=img.shape[-2], src_w=img.shape[-1],
                        components=img.shape[-3] if img.ndim >= 3 else 1,
                        **ctx)
    for hook in hooks:
        if not (hook.stages & stage):
            continue
        if disabled is not None and hook.signature in disabled:
            continue
        params.parameters = dict(hook.parameters)
        if states is not None and hook.signature in states:
            params.state_in, params.state_out = states[hook.signature]
        else:
            params.state_in = params.state_out = None
        try:
            out = hook.func(img, params)
            if out is not None:
                img = out
        except Exception as e:
            if is_kernel_failure(e):
                raise
            # a misbehaving hook is disabled, not the frame failed
            # (reference rr->disabled_hooks, renderer.c:64-65); logged
            core_log.default_log().error(
                f"hook {hook.name or hook.signature!r} failed at stage "
                f"{stage.name}: {type(e).__name__}: {e}; disabled")
            if disabled is not None:
                disabled.add(hook.signature)
    return img

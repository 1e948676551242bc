"""libplacebo_tpu_torch — the PyTorch/CUDA port of libplacebo_tpu.

Renders frames on an NVIDIA GPU with PyTorch for the plain tensor stages
and hand-written Hopper kernels where the reference package has Pallas
kernels (ops/cuda, sources in csrc/: K1 the color-map tail, K2 the
error-diffusion wavefront, K3 its shear).  Entry points default to
device="cuda" and raise without a GPU unless given device="cpu", where
every kernel runs its plain PyTorch version.  The port never imports
JAX or the reference package.

All math is float32; TF32 is switched off for matmuls and convolutions
(the EWA scaler is a convolution), since it would keep only ~10 bits.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .core.colorspace import (AlphaMode, BitEncoding,  # noqa: E402
                              ColorAdjustment, ColorLevels, ColorPrimaries,
                              ColorRepr, ColorSpace, ColorSystem,
                              ColorTransfer, Cone, ConeParams,
                              CSP_BT2100_PQ, CSP_BT709, CSP_SRGB,
                              DoviMetadata, HdrBezier, HdrMetadata)
from .core.common import Rect, RectF, Rotation  # noqa: E402
from .core.dither import DitherMethod  # noqa: E402
from .core.film_grain import (AV1GrainData, FilmGrainData,  # noqa: E402
                              H274GrainData)
from .core.icc import IccProfile, parse_icc  # noqa: E402
from .core.log import Log, LogLevel, default_log, log_create  # noqa: E402
from .core.lut import CustomLut, parse_cube  # noqa: E402
from .core.options import Options  # noqa: E402
from .ops.deband import DebandParams  # noqa: E402
from .ops.deinterlace import (DeinterlaceAlgo, DeinterlaceParams,  # noqa: E402
                              Field)
from .ops.distort import DistortParams  # noqa: E402
from .ops.dithering import DitherParams  # noqa: E402
from .ops.peak_detect import PeakDetectParams  # noqa: E402
from .render.frame import (Frame, Overlay, OverlayPart, Plane,  # noqa: E402
                           frame_from_rgb, frame_from_yuv420p)
from .render.hooks import Hook, HookParams, HookRect, HookStage  # noqa: E402
from .render.profiler import Telemetry  # noqa: E402
from .render.queue import (FrameMix, FrameQueue, QueueMode,  # noqa: E402
                           QueueParams, QueueStatus, SourceFrame,
                           frame_mix_radius)
from ._build import KernelError  # noqa: E402
from .render.renderer import (ALPHA_OVERLAY, DEFAULT_PARAMS,  # noqa: E402
                              FAST_PARAMS, HIGH_QUALITY_PARAMS, RenderError,
                              RenderParams, Renderer, Target, clear_target,
                              clear_target_tiles, frames_infer,
                              frames_infer_mix, render_image,
                              render_image_mix)
from .utils.dolbyvision import (hdr_metadata_from_rpu, parse_rpu,  # noqa: E402
                                rpu_to_dovi, write_rpu)

__all__ = ["Renderer", "render_image", "render_image_mix", "RenderParams",
           "Target", "Frame", "Plane", "Overlay", "OverlayPart", "FrameMix",
           "frame_from_yuv420p", "frame_from_rgb", "frames_infer",
           "frames_infer_mix", "clear_target", "clear_target_tiles",
           "FAST_PARAMS", "DEFAULT_PARAMS", "HIGH_QUALITY_PARAMS",
           "ALPHA_OVERLAY", "ColorAdjustment", "Cone", "ConeParams",
           "AlphaMode", "Rect", "RectF", "Rotation", "HdrBezier", "CSP_BT709", "DitherParams", "DitherMethod",
           "DebandParams", "CustomLut", "parse_cube", "IccProfile",
           "parse_icc",
           "FilmGrainData", "AV1GrainData", "H274GrainData",
           "DoviMetadata", "parse_rpu", "write_rpu", "rpu_to_dovi",
           "hdr_metadata_from_rpu", "DeinterlaceParams", "DeinterlaceAlgo",
           "Field", "DistortParams", "RenderError",
           "PeakDetectParams", "BitEncoding", "ColorLevels",
           "ColorPrimaries", "ColorRepr", "ColorSpace", "ColorSystem",
           "ColorTransfer", "CSP_BT2100_PQ", "CSP_SRGB", "HdrMetadata",
           "Options", "FrameQueue", "SourceFrame", "QueueParams",
           "QueueMode", "QueueStatus", "frame_mix_radius", "Hook",
           "HookStage", "HookParams", "HookRect", "Telemetry", "Log",
           "LogLevel", "log_create", "default_log", "KernelError"]

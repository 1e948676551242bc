"""Device/runtime context — the pl_gpu analog on CUDA.

Counterpart of libplacebo_tpu/runtime.py: device discovery, capability
limits, the cache that `Renderer.save` / `load` serialize, the kernel
build directory (the port's compiled artifacts), uploads to the
context's device, timers, and the failed flag.  `create_dummy` gives a
CPU context (the reference's malloc-backed dummy backend) on which every
kernel runs its plain PyTorch version.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .core.cache import Cache
from .core.log import Log, default_log
from .utils.device import resolve_device

__all__ = ["GpuLimits", "GpuContext", "Timer", "create", "create_dummy"]


class Timer:
    """pl_timer analog (reference gpu.h:403-437): `start()` before
    queueing work, `stop()` after it, and `query()` returns the oldest
    finished measurement in seconds, in order, or None while nothing new
    has finished.  It never blocks.

    On a CUDA device a measurement is the device time between two CUDA
    events, read only once the closing event's `query()` says it has
    finished (reading an unfinished event would wait).  On the CPU, where
    PyTorch's work is done when the call returns, it is the wall-clock
    time from `start()` to `stop()`."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._pending: deque = deque()
        self._ready: deque = deque()
        self._t0 = None

    def start(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, out=None):
        """Close the measurement opened by `start()`.  `out`, the work's
        output, is accepted for the reference's signature; the work's end
        is the point in the stream where `stop` is called."""
        if self._t0 is None:
            raise RuntimeError("Timer.stop() without start()")
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._t0, end))
        else:
            self._ready.append(time.perf_counter() - self._t0)
        self._t0 = None

    def _poll(self):
        while self._pending and self._pending[0][1].query():
            t0, end = self._pending.popleft()
            self._ready.append(t0.elapsed_time(end) * 1e-3)

    def query(self) -> Optional[float]:
        """Oldest finished measurement in seconds, or None."""
        self._poll()
        return self._ready.popleft() if self._ready else None


@dataclass(frozen=True)
class GpuLimits:
    """Capability limits (the pl_gpu_limits analog, gpu.h:64-148), from
    torch.cuda.get_device_properties."""
    device_kind: str = ""
    num_devices: int = 1
    total_memory: int = 0                   # bytes of device memory
    multiprocessor_count: int = 0
    compute_capability: Tuple[int, int] = (0, 0)
    warp_size: int = 32
    shared_memory_per_block_optin: int = 0  # bytes
    supports_kernels: bool = False          # the hand-written kernels run
    supports_collectives: bool = False      # > 1 device


def _limits(device: torch.device) -> GpuLimits:
    if device.type != "cuda":
        return GpuLimits(device_kind="cpu")
    props = torch.cuda.get_device_properties(device)
    count = torch.cuda.device_count()
    return GpuLimits(
        device_kind=props.name, num_devices=count,
        total_memory=int(props.total_memory),
        multiprocessor_count=int(props.multi_processor_count),
        compute_capability=(int(props.major), int(props.minor)),
        warp_size=int(getattr(props, "warp_size", 32)),
        shared_memory_per_block_optin=int(
            getattr(props, "shared_memory_per_block_optin", 0)),
        supports_kernels=True, supports_collectives=count > 1)


class GpuContext:
    """Reference pl_gpu object: owns the device, its limits, the cache
    and the log; hands out renderers, timers and uploads."""

    def __init__(self, device=None, log: Optional[Log] = None,
                 cache: Optional[Cache] = None):
        self.device = resolve_device(device)
        self.devices: List[torch.device] = (
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if self.device.type == "cuda" else [self.device])
        self.log = log or default_log()
        self.cache = cache or Cache()
        self._failed = False
        self.limits = _limits(self.device)
        self.log.info(f"GpuContext: {self.limits.num_devices} x "
                      f"{self.limits.device_kind}")

    # -- reference pl_gpu_set_cache (gpu.h:255) ------------------------
    def set_cache(self, cache: Cache):
        self.cache = cache

    def set_disk_cache(self, path: str):
        """Keep the compiled kernels in `path` (reference: pipeline blobs
        through pl_cache).  The port's compiled artifacts are its kernel
        libraries, content-hashed, so the directory is portable between
        identical toolchains; builds this process has already made are
        not moved."""
        _build.set_build_dir(path)

    def make_mesh(self, data: int = 1, spatial: Optional[int] = None,
                  group=None):
        """This rank's (data, spatial) mesh on the context's device
        (parallel/mesh.py::make_mesh): alone, a one-rank group (NCCL on
        the card, gloo on the CPU); under torchrun, the group its
        environment describes."""
        from .parallel.mesh import make_mesh
        return make_mesh(data, spatial, device=self.device, group=group)

    # -- uploads (the pl_tex_upload analog) ----------------------------
    def upload(self, array, device=None) -> torch.Tensor:
        """A host array (or tensor) as a tensor on the context's device
        (or `device`)."""
        return torch.as_tensor(np.asarray(array)).to(
            device if device is not None else self.device)

    def renderer(self):
        from .render.renderer import Renderer
        return Renderer(ctx=self)

    def timer(self) -> Timer:
        """A pl_timer analog (reference pl_timer_create)."""
        return Timer(self.device)

    @property
    def is_failed(self) -> bool:
        """Reference pl_gpu_is_failed (gpu.h:1398): a flag, set by
        `mark_failed` or a failed `check_alive`."""
        return self._failed

    def mark_failed(self):
        """Record the device's loss."""
        self._failed = True

    def check_alive(self) -> bool:
        """Active probe: one tiny upload and read back.  A CUDA error
        sets the failed flag."""
        try:
            return float(self.upload(np.zeros(1, np.float32))[0]) == 0.0
        except RuntimeError:     # torch's CUDA errors
            self._failed = True
            return False


def create(log: Optional[Log] = None, device=None) -> GpuContext:
    """Bring up a context on the card (`device` None = "cuda"; raises
    without a GPU), the reference's pl_gpu_create path."""
    return GpuContext(device=device, log=log)


def create_dummy(log: Optional[Log] = None) -> GpuContext:
    """A CPU context for tests (reference src/dummy.c)."""
    return GpuContext(device="cpu", log=log)

"""The deployments a configuration names, driving the program under test
(libplacebo_tpu_torch) one frame at a time:

- "player": the decoded frame is mapped (utils/interop, upload issued
  from the decoder's host planes), rendered for the display and waited
  for, as a player that presents each frame does;
- "transcoder": the same, then the rendered frame is encoded to the
  configuration's YCbCr (ops.color.encode_color), put in the encoder's
  pixel format on the card (`encoder_planes`: integer codes, chroma
  averaged over each 2x2 block for 4:2:0) and downloaded into pinned
  host memory, and the host waits for the download, as a filter graph
  works.

`step` times each part on the host clock and, in a traced run, wraps it
in a profiler range named after the part, so the trace can say what the
host was doing while the card sat idle.
"""
from __future__ import annotations

import contextlib
import time

import torch

from framebench.reference.chain import OUT_FORMATS

_PRIM = {"bt2020": "BT_2020", "bt709": "BT_709"}
_TRC = {"smpte2084": "PQ", "bt709": "BT_1886", "bt1886": "BT_1886",
        "srgb": "SRGB"}
_SYS = {"bt2020nc": "BT_2020_NC", "bt709": "BT_709"}
_LEVELS = {"limited": "LIMITED", "tv": "LIMITED", "full": "FULL",
           "pc": "FULL"}


def encoder_planes(ycc, bits: int, halve: bool):
    """Normalized (3, H, W) Y'CbCr -> the encoder's integer planes: each
    value rounded to its code, chroma first averaged over each 2x2
    block where the format halves it."""
    top = float((1 << bits) - 1)
    y, c = ycc[0], ycc[1:]
    if halve:
        H, W = y.shape
        c = c.reshape(2, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    return [torch.clamp(torch.round(p * top), 0.0, top).to(torch.uint8)
            for p in (y, c[0], c[1])]


class Deployment:
    """One configuration's renderer, target and per-frame work on the
    program; `outputs[slot]` keeps the outputs of the frames sampled for
    the correctness check (the rendered tensor for a player, the
    downloaded host planes for a transcoder)."""

    def __init__(self, lt, config: dict, source, device, slots: int):
        from libplacebo_tpu_torch.ops.color import encode_color
        from libplacebo_tpu_torch.utils import interop
        self.lt, self.src, self.dev = lt, source, device
        self.kind = config["deployment"]
        if self.kind not in ("player", "transcoder"):
            raise ValueError(f"unknown deployment {self.kind!r}")
        self.meta = config["source_frame"]
        t = config["target"]
        self.target = lt.Target(
            w=t["w"], h=t["h"], bit_depth=t["bit_depth"],
            color=lt.ColorSpace(getattr(lt.ColorPrimaries,
                                        _PRIM[t["primaries"]]),
                                getattr(lt.ColorTransfer,
                                        _TRC[t["transfer"]])))
        self.params = lt.RenderParams(**config.get("render_params", {}))
        self.renderer = lt.Renderer(device=device)
        self.map = interop.frame_from_avframe_like
        self.encode_color = encode_color
        self.repr = None
        self.buffers = []
        if self.kind == "transcoder":
            e = config["encode"]
            self.repr = lt.ColorRepr(
                sys=getattr(lt.ColorSystem, _SYS[e["sys"]]),
                levels=getattr(lt.ColorLevels, _LEVELS[e["levels"]]),
                bits=lt.BitEncoding(e["bits"], e["bits"], 0))
            self.bits, self.halve = OUT_FORMATS[e["format"]]
            cw, ch = (t["w"] // 2, t["h"] // 2) if self.halve \
                else (t["w"], t["h"])
            pin = device.type == "cuda"
            # two sets of planes the frames take in turns, one a sampled
            # slot
            self.buffers = [
                [torch.empty((t["h"], t["w"]), dtype=torch.uint8,
                             pin_memory=pin)] +
                [torch.empty((ch, cw), dtype=torch.uint8, pin_memory=pin)
                 for _ in range(2)]
                for _ in range(2 + slots)]
        self.outputs = {}
        self.last = None
        self.stream = torch.cuda.current_stream(device) \
            if device.type == "cuda" else None

    def step(self, i: int, slot, trace: bool = False):
        """Frame i through the deployment; returns (latency s, render
        host s, whether the renderer had degraded).  `slot` keeps this
        frame's output for the check."""
        def span(name):
            return torch.profiler.record_function("fb." + name) if trace \
                else contextlib.nullcontext()
        t0 = time.perf_counter()
        with span("upload"):
            frame = self.map(self.src.avframe(i, self.meta), device=self.dev)
        t1 = time.perf_counter()
        with span("render"):
            out = self.renderer.render(frame, self.target, self.params)
        t2 = time.perf_counter()
        if self.kind == "transcoder":
            with span("encode_download"):
                buf = self.buffers[2 + slot] if slot is not None \
                    else self.buffers[i % 2]
                planes = encoder_planes(self.encode_color(out, self.repr),
                                        self.bits, self.halve)
                for host, dev in zip(buf, planes):
                    host.copy_(dev, non_blocking=self.stream is not None)
            out = buf
        with span("sync_wait"):
            if self.stream is not None:
                self.stream.synchronize()
        t3 = time.perf_counter()
        if slot is not None:
            self.outputs[slot] = out
        self.last = out
        return t3 - t0, t2 - t1, bool(self.renderer.errors)

    def close(self):
        """Drop the program's state (the renderer and its plans); the
        sampled outputs stay to be judged."""
        self.renderer = None

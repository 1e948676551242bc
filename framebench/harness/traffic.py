"""The one traffic generator: a traffic mix is a data file
(`traffic/<mix>.json`) that this module reads.

A mix gives the source geometry and bit depth, the ring of distinct
frames a decoder hands over (made on the card from the seed, in a few
large calls, then copied into ordinary pageable host memory, where a
software decoder leaves its output planes) and the code ranges of luma
and chroma.  Every seed gets the same sizes and the same amount of
work; only the content differs.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of the run's seed (splitmix64), so that
    the frames and the sample of frames checked draw from independent
    streams of any whole-number seed."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Source:
    """The source frames of one run: `ring` distinct 4:2:0 frames of
    integer planes (numpy uint16 codes) in pageable host memory."""

    def __init__(self, traffic: dict, seed: int, device):
        self.t = traffic
        self.w, self.h = traffic["width"], traffic["height"]
        self.ring = int(traffic["ring"])
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, 0))
        lo_y, hi_y = traffic["luma_codes"]
        lo_c, hi_c = traffic["chroma_codes"]
        n, h, w = self.ring, self.h, self.w
        y = torch.rand((n, h, w), generator=g, device=device)
        c = torch.rand((n, 2, h // 2, w // 2), generator=g, device=device)
        ys = (y * (hi_y - lo_y) + lo_y).to(torch.int16).cpu().numpy() \
            .view(np.uint16)
        cs = (c * (hi_c - lo_c) + lo_c).to(torch.int16).cpu().numpy() \
            .view(np.uint16)
        self.frames = [(ys[i], cs[i, 0], cs[i, 1]) for i in range(n)]

    def key(self, i: int) -> int:
        """What frame i is made of: its index in the ring.  Frames with
        one key render alike from one peak state."""
        return i % self.ring

    def avframe(self, i: int, meta: dict) -> dict:
        """Frame i as an AVFrame-like dict: the configuration's format,
        colour fields and HDR10 side data over the host planes."""
        av = dict(meta)
        av["data"] = list(self.frames[self.key(i)])
        return av


class Sampler:
    """A uniform sample, drawn from the seed, of `k` frames of a window
    whose length is not known in advance (reservoir sampling), plus the
    window's last frame.  `offer(i)` says whether frame i's output is to
    be kept, and in which slot; a slot's earlier frame is dropped."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(sub_seed(seed, 2))
        self.k = k
        self.slots = {}          # slot -> frame index

    def offer(self, i: int):
        if i < self.k:
            slot = i
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= self.k:
                return None
            slot = j
        self.slots[slot] = i
        return slot

"""Collective traffic of a sharded step.

Counterpart of libplacebo_tpu/parallel/analysis.py.  The halo
pipeline's contract is that traffic between ranks is O(halo), not
O(frame): row halos ride collective-permutes, the reductions (peak
histogram, frame statistics) small all-reduces, and nothing widens
silently into a frame-sized all-gather.  The reference reads its
collectives out of the compiled HLO (`compile_text` + a regex); the
port has no HLO, so `collective_stats` runs the step once under the
collective recorder of parallel/comm.py, through which every collective
of the sharded renderer goes, and returns the same dict under the same
HLO names.  There is no `compile_text` here.
"""
from __future__ import annotations

from typing import Dict

from . import comm

__all__ = ["collective_stats"]


def collective_stats(step, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """Run `step(*args, **kwargs)` once and return {op: {count,
    total_bytes, max_bytes}} of the collectives it issued on this rank,
    op one of "collective-permute", "all-reduce", "all-to-all",
    "all-gather"; the bytes are each call's result on this rank."""
    rec: Dict[str, Dict[str, int]] = {}
    with comm.recording(rec):
        step(*args, **kwargs)
    return rec

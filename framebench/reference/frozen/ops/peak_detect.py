"""HDR peak detection's state and temporal filter.

Counterpart of libplacebo_tpu/ops/peak_detect.py, cut to the carried
state, the delayed stats a frame applies and the reference's IIR
smoothing with its scene-change cut (colorspace.c:1122-1146); the
measurement itself is `reference/stages.py`'s."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.fastmath import fma, rcp

__all__ = ["PeakDetectParams", "peak_detect_state_init", "delayed_stats"]

PQ_BITS = 14
PQ_MAX = (1 << PQ_BITS) - 1


@dataclass(frozen=True)
class PeakDetectParams:
    """Reference pl_peak_detect_params; `allow_delayed` defaults True as
    in the reference package (tone-map with the previous frames' stats,
    so the current frame's histogram is measured inside K1)."""
    smoothing_period: float = 20.0
    scene_threshold_low: float = 1.0     # % PQ
    scene_threshold_high: float = 3.0    # % PQ
    percentile: float = 100.0
    black_cutoff: float = 1.0            # % PQ; ignore pixels below
    allow_delayed: bool = True


def peak_detect_state_init(device=None) -> torch.Tensor:
    """Carried state [avg_pq, max_pq]; zeros mean 'unset'."""
    return torch.zeros(2, dtype=torch.float32, device=device)


def delayed_stats(state, src_max_pq: float):
    """(avg_pq, max_pq) an allow_delayed frame applies: the previous
    state, or the static metadata peak while unset (0-dim tensors)."""
    prev_avg, prev_max = state[0], state[1]
    unset = prev_max == 0.0
    return (torch.where(unset, torch.zeros_like(prev_avg), prev_avg),
            torch.where(unset, torch.full_like(prev_max, src_max_pq),
                        prev_max))


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) * rcp(e1 - e0), 0.0, 1.0)
    return t * t * fma(t, -2.0, 3.0)


def _temporal_update(avg_cur, max_cur, wg_bias, state,
                     params: PeakDetectParams):
    """IIR smoothing + scene-change cut (update_peak_buf,
    colorspace.c:1122-1146)."""
    prev_avg, prev_max = state[0], state[1]
    unset = prev_avg == 0.0
    eps = 1.0 / PQ_MAX
    avg_in = torch.where(torch.abs(avg_cur - prev_avg) < eps, prev_avg,
                         avg_cur)
    max_in = torch.where(torch.abs(max_cur - prev_max) < eps, prev_max,
                         max_cur)
    coeff = 1.0 - float(np.exp(-1.0 / params.smoothing_period)) \
        if params.smoothing_period > 0 else 1.0
    avg_s = fma(avg_in - prev_avg, coeff, prev_avg)
    max_s = fma(max_in - prev_max, coeff, prev_max)
    if params.scene_threshold_low > 0 and params.scene_threshold_high > 0:
        t_lo = params.scene_threshold_low * 1e-2
        t_hi = params.scene_threshold_high * 1e-2
        delta = wg_bias * torch.abs(avg_in - prev_avg)
        mix = _smoothstep(t_lo, t_hi, delta)
        avg_s = fma(avg_in - avg_s, mix, avg_s)
        max_s = fma(max_in - max_s, mix, max_s)
    avg_out = torch.where(unset, avg_cur, avg_s)
    max_out = torch.where(unset, max_cur, max_s)
    return avg_out, max_out, torch.stack([avg_out, max_out]).float()



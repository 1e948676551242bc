"""HDR peak detection: same-frame detection, per-stripe partials and
their temporal finish.

Counterpart of libplacebo_tpu/ops/peak_detect.py.  Two ways in:
- `detect_peak` / `applied_stats` measure a whole frame before its tone
  map (16x16-tile averages, the 64-bin histogram's percentile), for
  `allow_delayed=False` and for tails the color-map kernel does not run;
- with `allow_delayed` the color-map kernel (K1) emits one (8, 128)
  partials record per row stripe — the 64-bin PQ histogram and
  [pq_sum_active, active_count, pq_max] — and `finish_from_packed`
  reduces them.
Both end in the reference's percentile interpolation and IIR smoothing
(colorspace.c:1020-1146).  The histogram layout is the reference's:
14-bit PQ, 7-bit bins biased by half the range, 64 bins.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.colorspace import COLOR_HDR_BLACK, COLOR_SDR_WHITE
from ..core.fastmath import fma, rcp
from ..core.transfer import pq_oetf_fast

__all__ = ["PeakDetectParams", "peak_detect_state_init", "delayed_stats",
           "detect_peak", "applied_stats", "block_partials",
           "stripe_partials", "finish_from_packed", "finish_from_partials",
           "PARTIAL_SHAPE"]

PQ_BITS = 14
PQ_MAX = (1 << PQ_BITS) - 1
HIST_BITS = 7
HIST_BIAS = 1 << (HIST_BITS - 1)
HIST_BINS = (1 << HIST_BITS) - HIST_BIAS   # 64
PARTIAL_SHAPE = (8, 128)


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


def _pixel_pq(img_linear, params: PeakDetectParams):
    """linear RGB -> (pq, active_mask, hist_bin) per pixel."""
    maxrgb = torch.amax(img_linear, dim=-3)
    pq = pq_oetf_fast(torch.clamp_min(maxrgb, 0.0) *
                      (COLOR_SDR_WHITE / 10000.0))
    pq = torch.clamp(pq, 0.0, 1.0)
    pq14 = torch.round(pq * PQ_MAX).to(torch.int32)
    active = pq > params.black_cutoff / 100.0
    bins = torch.clamp((pq14 >> (PQ_BITS - HIST_BITS)) - HIST_BIAS,
                       0, HIST_BINS - 1)
    return pq, active, bins


def stripe_partials(pq, active, bins, block_rows: int):
    """(G, 8, 128) partials records, one per stripe of `block_rows` rows
    of the per-pixel (pq, active, bins) maps: row 0 lanes 0..63 = the
    histogram, row 1 lanes 0..2 = [pq_sum_active, active_count,
    pq_max]."""
    H, W = pq.shape
    g = H // block_rows
    stripe = torch.arange(H, device=pq.device)[:, None] // block_rows
    key = (stripe * HIST_BINS + bins)[active]
    out = torch.zeros((g,) + PARTIAL_SHAPE, dtype=torch.float32,
                      device=pq.device)
    out[:, 0, :HIST_BINS] = torch.bincount(
        key, minlength=g * HIST_BINS).reshape(g, HIST_BINS).float()
    out[:, 1, 0] = torch.where(active, pq, torch.zeros_like(pq)) \
        .reshape(g, -1).sum(dim=1)
    out[:, 1, 1] = active.reshape(g, -1).float().sum(dim=1)
    out[:, 1, 2] = pq.reshape(g, -1).amax(dim=1)
    return out


def block_partials(img_block, params: PeakDetectParams):
    """One (8, 128) partials record for a whole (3, rows, W) block."""
    pq, active, bins = _pixel_pq(img_block, params)
    return stripe_partials(pq, active, bins, pq.shape[0])[0]


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


def _percentile_max(hist, frame_max, params: PeakDetectParams):
    """The measured peak: the 64-bin histogram's percentile, linearly
    interpolated in its bin (reference measure_peak,
    colorspace.c:1020-1065), or the frame max at percentile 100."""
    if not 0 < params.percentile < 100:
        return frame_max
    total = torch.sum(hist)
    target = torch.ceil(params.percentile / 100.0 * total)
    csum = torch.cumsum(hist, dim=0)
    bin_idx = torch.argmax((csum >= target).to(torch.int32))
    cl = csum[bin_idx] - hist[bin_idx]
    ch = cl + hist[bin_idx] + 1.0
    shift = PQ_BITS - HIST_BITS
    pq_low = ((bin_idx + HIST_BIAS) << shift).float() * rcp(PQ_MAX)
    pq_high0 = ((bin_idx + 1 + HIST_BIAS) << shift).float() * rcp(PQ_MAX)
    pq_high = torch.where(ch > total, frame_max, pq_high0)
    ratio = (target - cl) / torch.clamp_min(ch - cl, 1.0)
    measured = fma(pq_high - pq_low, ratio, pq_low)
    return torch.where(total > 0, measured, frame_max)


def detect_peak(img_linear, state, params: PeakDetectParams):
    """Measure a (3, H, W) linear-light frame (NORM units) and update
    the temporal state: (avg_pq, max_pq, new_state), 0-dim tensors and
    the (2,) state.  The average is the mean of the active 16x16 tiles'
    means (zero-padded at the ragged edge), as the reference's
    workgroups average."""
    pq, active, bins = _pixel_pq(img_linear, params)
    th = tw = 16
    H, W = pq.shape
    Hp, Wp = -(-H // th) * th, -(-W // tw) * tw
    pad = (0, Wp - W, 0, Hp - H)
    pq_pad = torch.nn.functional.pad(pq, pad)
    act = torch.nn.functional.pad(active, pad)
    tiles = pq_pad.reshape(Hp // th, th, Wp // tw, tw)
    acts = act.reshape(Hp // th, th, Wp // tw, tw)
    tile_sum = torch.where(acts, tiles, torch.zeros_like(tiles)) \
        .sum(dim=(1, 3))
    tile_cnt = acts.sum(dim=(1, 3)).float()
    tile_max = tiles.amax(dim=(1, 3))
    tile_avg = tile_sum / torch.clamp_min(tile_cnt, 1.0)
    wg_active = tile_cnt > 0
    wg_count = wg_active.sum().float()
    frame_avg = torch.where(wg_active, tile_avg,
                            torch.zeros_like(tile_avg)).sum() / \
        torch.clamp_min(wg_count, 1.0)
    frame_max = tile_max.amax()
    wg_bias = wg_count / float(wg_active.numel())
    hist = torch.bincount(bins[active], minlength=HIST_BINS).float()
    max_cur = _percentile_max(hist, frame_max, params)
    has_content = wg_count > 0
    black = torch.full_like(frame_max, COLOR_HDR_BLACK)
    avg_cur = torch.where(has_content, frame_avg, black)
    max_cur = torch.where(has_content, max_cur, black)
    return _temporal_update(avg_cur, max_cur, wg_bias, state, params)


def applied_stats(img_linear, state, params: PeakDetectParams,
                  src_max_pq: float):
    """detect_peak and the allow_delayed policy: the (avg_pq, max_pq)
    the tone map applies this frame — this frame's smoothed stats, or
    with `allow_delayed` the previous state (delayed_stats) — and the
    new state."""
    avg, mx, new_state = detect_peak(img_linear, state, params)
    if not params.allow_delayed:
        return avg, mx, new_state
    return delayed_stats(state, src_max_pq) + (new_state,)


def finish_from_packed(packed, state, params: PeakDetectParams):
    """finish_from_partials on (G, 8, 128) packed records."""
    g = packed.shape[0]
    stats = torch.cat([packed[:, 1, :3],
                       torch.ones((g, 1), dtype=torch.float32,
                                  device=packed.device)], dim=-1)
    return finish_from_partials(packed[:, 0, :HIST_BINS], stats, state,
                                params)


def finish_from_partials(hists, stats, state, params: PeakDetectParams):
    """Per-block partials -> (avg_pq, max_pq, new_state).  `stats` rows
    are [pq_sum_active, active_count, pq_max, blocks]; the frame average
    is the mean of the active blocks' means."""
    hist = torch.sum(hists, dim=0)
    n_blocks = torch.sum(stats[:, 3])
    blk_avg = stats[:, 0] / torch.clamp_min(stats[:, 1], 1.0)
    blk_active = stats[:, 1] > 0
    wg_count = torch.sum(blk_active).to(torch.float32)
    frame_avg = torch.sum(torch.where(blk_active, blk_avg,
                                      torch.zeros_like(blk_avg))) / \
        torch.clamp_min(wg_count, 1.0)
    frame_max = torch.amax(stats[:, 2])
    wg_bias = wg_count / torch.clamp_min(n_blocks, 1.0)

    max_cur = _percentile_max(hist, frame_max, params)
    has_content = wg_count > 0
    black = torch.full_like(frame_max, COLOR_HDR_BLACK)
    avg_cur = torch.where(has_content, frame_avg, black)
    max_cur = torch.where(has_content, max_cur, black)
    return _temporal_update(avg_cur, max_cur, wg_bias, state, params)

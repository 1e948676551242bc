"""Field deinterlacing: weave / bob / yadif / bwdif.

Counterpart of libplacebo_tpu/ops/deinterlace.py (the reference's
pl_shader_deinterlace, src/shaders/deinterlacing.c): every neighbor
fetch is a shifted view of a mirror-padded plane, so the filter is
plain elementwise tensor math.  Only the lines of the opposite field are
reconstructed; the current field's lines pass through.  yadif has its
edge-directed spatial predictor and temporal clamp, bwdif its 3-tap /
5-tap blended interpolation with the spec's coefficients (multiples of
1/8192, exact in float32), their products fused into the sums where the
reference's jitted lowering fuses them.  Each plane uses its own row
parity, so 4:2:0 chroma planes keep their own fields.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.fastmath import fma

__all__ = ["DeinterlaceAlgo", "DeinterlaceParams", "Field", "deinterlace"]


class DeinterlaceAlgo(enum.Enum):
    """Reference pl_deinterlace_algorithm (deinterlacing.h:93-131)."""
    WEAVE = "weave"   # no-op (show both fields)
    BOB = "bob"       # naive line doubling
    YADIF = "yadif"   # temporal/spatial adaptive
    BWDIF = "bwdif"   # yadif + w3fdif/cubic interpolation


class Field(enum.Enum):
    TOP = 0     # even lines (0, 2, 4...)
    BOTTOM = 1  # odd lines


@dataclass(frozen=True)
class DeinterlaceParams:
    algo: DeinterlaceAlgo = DeinterlaceAlgo.YADIF
    skip_spatial_check: bool = False

    def key(self):
        return (self.algo, self.skip_spatial_check)


_N = 4      # padding: the farthest fetch is 4 rows away


def _pad(img):
    """Mirror padding (reflect without repeating the edge) of the last
    two dimensions; PyTorch pads 2-D only on 3-D or 4-D tensors."""
    shape = img.shape
    x = img.reshape(-1, shape[-2], shape[-1])
    x = F.pad(x, (_N, _N, _N, _N), mode="reflect")
    return x.reshape(*shape[:-2], x.shape[-2], x.shape[-1])


def _abs_diff(a, b):
    return torch.abs(a - b)


def _yadif_spatial(get, cur):
    """Edge-directed spatial predictor (reference spatial_predictor,
    deinterlacing.c:131-160): each candidate is taken only if it beats
    every earlier one."""
    a, b, c, d, e, f, g = (get(cur, dx, -1) for dx in range(-3, 4))
    h, i, j, k, l, m, n_ = (get(cur, dx, 1) for dx in range(-3, 4))

    bias = 1 / 255.0
    pred = (d + k) * 0.5
    score = _abs_diff(c, j) + _abs_diff(d, k) + _abs_diff(e, l) - bias

    s1 = _abs_diff(b, k) + _abs_diff(c, l) + _abs_diff(d, m)
    take1 = s1 < score
    pred = torch.where(take1, (c + l) * 0.5, pred)
    score1 = torch.where(take1, s1, score)
    s2 = _abs_diff(a, l) + _abs_diff(b, m) + _abs_diff(c, n_)
    take2 = take1 & (s2 < score1)
    pred = torch.where(take2, (b + m) * 0.5, pred)
    score2 = torch.where(take2, s2, score1)

    s3 = _abs_diff(d, i) + _abs_diff(e, j) + _abs_diff(f, k)
    take3 = s3 < score2
    pred = torch.where(take3, (e + j) * 0.5, pred)
    score3 = torch.where(take3, s3, score2)
    s4 = _abs_diff(e, h) + _abs_diff(f, i) + _abs_diff(g, j)
    take4 = take3 & (s4 < score3)
    return torch.where(take4, (f + i) * 0.5, pred)


def deinterlace(cur, field: Field,
                params: Optional[DeinterlaceParams] = None,
                prev: Optional[torch.Tensor] = None,
                next: Optional[torch.Tensor] = None,
                first_field: Field = Field.TOP, row_offset: int = 0):
    """Deinterlace (..., C, H, W): reconstruct the lines of the opposite
    field of `cur` (with the neighbor frames `prev` / `next`, same shape,
    for the temporal algorithms).  `field` is the field of `cur` shown
    now (reference deinterlace, ops/deinterlace.py:113-209).
    `row_offset` is the frame row of cur's first row when cur is a row
    block (halo rows included) of a larger frame: the field parity is
    the frame's."""
    p = params or DeinterlaceParams()
    algo = p.algo
    if algo == DeinterlaceAlgo.WEAVE:
        return cur

    h, w = cur.shape[-2], cur.shape[-1]
    # the lines of the current field pass through
    keep = ((row_offset + torch.arange(h, device=cur.device)) % 2 ==
            field.value)[:, None]

    def get(src_p, dx, dy):
        return src_p[..., _N + dy:_N + dy + h, _N + dx:_N + dx + w]

    cur_p = _pad(cur)
    if algo == DeinterlaceAlgo.BOB:
        res = get(cur_p, 0, -1 if field == Field.TOP else 1)
        return torch.where(keep, cur, res)

    prev_p = _pad(prev) if prev is not None else cur_p
    next_p = _pad(next) if next is not None else cur_p
    prev2_p = prev_p if field == first_field else cur_p
    next2_p = cur_p if field == first_field else next_p

    if algo == DeinterlaceAlgo.YADIF:
        pred = _yadif_spatial(get, cur_p)
        A, B = get(prev_p, 0, -1), get(prev_p, 0, 1)
        C, D, E = (get(prev2_p, 0, o) for o in (-2, 0, 2))
        F_, G = get(cur_p, 0, -1), get(cur_p, 0, 1)
        H_, I, J = (get(next2_p, 0, o) for o in (-2, 0, 2))
        K, L = get(next_p, 0, -1), get(next_p, 0, 1)

        p0 = (C + H_) * 0.5
        p1 = F_
        p2 = (D + I) * 0.5
        p3 = G
        p4 = (E + J) * 0.5
        tdiff0 = _abs_diff(D, I) * 0.5
        tdiff1 = (_abs_diff(A, F_) + _abs_diff(B, G)) * 0.5
        tdiff2 = (_abs_diff(K, F_) + _abs_diff(G, L)) * 0.5
        diff = torch.maximum(tdiff0, torch.maximum(tdiff1, tdiff2))
        if not p.skip_spatial_check:
            maxi = torch.maximum(p2 - torch.minimum(p3, p1),
                                 torch.minimum(p0 - p1, p4 - p3))
            mini = torch.minimum(p2 - torch.maximum(p3, p1),
                                 torch.maximum(p0 - p1, p4 - p3))
            diff = torch.maximum(diff, torch.maximum(mini, -maxi))
        res = torch.minimum(torch.maximum(pred, p2 - diff), p2 + diff)
        return torch.where(keep, cur, res)

    if algo == DeinterlaceAlgo.BWDIF:
        lf = (4309.0 / 8192.0, 213.0 / 8192.0)
        hf = (5570.0 / 8192.0, 3801.0 / 8192.0, 1016.0 / 8192.0)
        sp = (5077.0 / 8192.0, 981.0 / 8192.0)

        c0, c1, c2, c3 = (get(cur_p, 0, o) for o in (-3, -1, 1, 3))

        def single(c, e):
            # sp0 (c + e) - sp1 (c0 + c3), the first product fused
            return fma(c + e, sp[0], (c0 + c3) * -sp[1])

        intra_only = (prev is None and field == first_field) or \
                     (next is None and field != first_field)
        if intra_only:
            return torch.where(keep, cur,
                               torch.clamp_min(single(c1, c2), 0.0))

        pv0, pv1 = get(prev_p, 0, -1), get(prev_p, 0, 1)
        nx0, nx1 = get(next_p, 0, -1), get(next_p, 0, 1)
        P = [get(prev2_p, 0, o) for o in (-4, -2, 0, 2, 4)]
        Nn = [get(next2_p, 0, o) for o in (-4, -2, 0, 2, 4)]

        s = P[2] + Nn[2]
        d = s * 0.5
        c, e = c1, c2
        tdiff0 = _abs_diff(P[2], Nn[2])
        tdiff1 = _abs_diff(pv0, c) + _abs_diff(pv1, e)
        tdiff2 = _abs_diff(nx0, c) + _abs_diff(nx1, e)
        diff = torch.maximum(tdiff0, torch.maximum(tdiff1, tdiff2)) * 0.5
        diff_zero = diff == 0.0

        bs = P[1] + Nn[1]
        fs = P[3] + Nn[3]
        b = bs * 0.5 - c
        f = fs * 0.5 - c
        dc = d - c
        de = d - e
        mmax = torch.maximum(de, torch.maximum(dc, torch.minimum(b, f)))
        mmin = torch.minimum(de, torch.minimum(dc, torch.maximum(b, f)))
        diff = torch.maximum(diff, torch.maximum(mmin, -mmax))

        # (hf0 s - hf1 (bs + fs) + hf2 (...)) / 4 + lf0 (c + e) - ...:
        # the quarter is a product fused with lf0's unfused one
        all_ = fma(s, hf[0], (bs + fs) * -hf[1])
        all_ = fma(((P[0] + Nn[0]) + P[4]) + Nn[4], hf[2], all_)
        all_ = fma(all_, 0.25, (c + e) * lf[0])
        all_ = fma(c0 + c3, -lf[1], all_)
        interpol = torch.where(torch.abs(c - e) > tdiff0, all_,
                               single(c, e))
        interpol = torch.minimum(torch.maximum(interpol, d - diff), d + diff)
        res = torch.where(diff_zero, d, interpol)
        return torch.where(keep, cur, res)

    raise ValueError(algo)

"""Ring halo exchange for row-split frames.

Counterpart of libplacebo_tpu/parallel/halo.py: extend this rank's
(..., Hl, W) row block by `halo` rows on each side.  Interior halos come
from the ring neighbors (`comm.ppermute`, batch_isend_irecv over the
mesh's spatial group); the frame's first and last rows follow `mode`,
chosen to reproduce the single-device padding exactly:

  edge    — replicate the border row (the scalers' edge clamp)
  reflect — mirror without repeating the edge (the deinterlacers'
            MIRROR addressing)
  wrap    — cyclic: shard 0's top halo is the frame's last rows
            (torch.roll's wrap-around; deband)
"""
from __future__ import annotations

import torch

from . import comm

__all__ = ["extend_rows"]


def extend_rows(x: torch.Tensor, halo: int, mesh, mode: str = "edge"
                ) -> torch.Tensor:
    """(..., Hl, W) -> (..., Hl + 2 * halo, W); needs halo <= Hl (only
    ring neighbors are reached; reflect: halo < Hl)."""
    if halo <= 0:
        return x
    if halo > x.shape[-2] - (mode == "reflect"):
        raise ValueError(f"extend_rows: a {mode} halo of {halo} rows "
                         f"exceeds the block's {x.shape[-2]} rows")
    if mode == "edge":
        top_edge = x[..., :1, :].expand(*x.shape[:-2], halo, x.shape[-1])
        bot_edge = x[..., -1:, :].expand(*x.shape[:-2], halo, x.shape[-1])
    elif mode == "reflect":
        top_edge = x[..., 1:halo + 1, :].flip(-2)
        bot_edge = x[..., -halo - 1:-1, :].flip(-2)
    elif mode == "wrap":
        top_edge = x[..., -halo:, :]
        bot_edge = x[..., :halo, :]
    else:
        raise ValueError(f"unknown halo mode {mode!r}")

    n = mesh.spatial
    if n == 1:
        return torch.cat([top_edge, x, bot_edge], dim=-2)

    me = mesh.spatial_index
    # shard i's bottom rows sit directly above shard i+1's block
    if mode == "wrap":
        from_above = comm.ppermute(x[..., -halo:, :], mesh,
                                   [(i, (i + 1) % n) for i in range(n)])
        from_below = comm.ppermute(x[..., :halo, :], mesh,
                                   [(i, (i - 1) % n) for i in range(n)])
        return torch.cat([from_above, x, from_below], dim=-2)
    from_above = comm.ppermute(x[..., -halo:, :], mesh,
                               [(i, i + 1) for i in range(n - 1)])
    from_below = comm.ppermute(x[..., :halo, :], mesh,
                               [(i, i - 1) for i in range(1, n)])
    if me == 0:
        from_above = top_edge
    if me == n - 1:
        from_below = bot_edge
    return torch.cat([from_above, x, from_below], dim=-2)

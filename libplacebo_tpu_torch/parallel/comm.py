"""Every collective of the sharded renderer, and the recorder that counts
them.

The sharded renderer moves data between ranks only through these four
functions, each the counterpart of one XLA collective of the reference
package (libplacebo_tpu/parallel/):
- `ppermute`: point-to-point row blocks by `batch_isend_irecv` over the
  mesh's spatial group (lax.ppermute; HLO collective-permute);
- `all_reduce`: SUM or MAX (psum / pmax; all-reduce);
- `all_to_all`: equal chunks exchanged (lax.all_to_all; all-to-all);
- `all_gather`: every rank's block, concatenated (all-gather).
The transport is the process group's: NCCL for CUDA tensors, gloo for
CPU tensors.  While a `recording` is active, each call adds its HLO
name, and the bytes of its result on this rank, to the record
(parallel/analysis.py reads it).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["recording", "ppermute", "all_reduce", "all_to_all",
           "all_gather"]

_RECORD: Optional[Dict[str, Dict[str, int]]] = None


class recording:
    """Context manager: record every collective into `rec`, as
    {op: {count, total_bytes, max_bytes}}."""

    def __init__(self, rec: dict):
        self.rec = rec

    def __enter__(self):
        global _RECORD
        self._prev = _RECORD
        _RECORD = self.rec
        return self.rec

    def __exit__(self, *exc):
        global _RECORD
        _RECORD = self._prev
        return False


def _note(op: str, nbytes: int) -> None:
    if _RECORD is None:
        return
    s = _RECORD.setdefault(op, {"count": 0, "total_bytes": 0,
                                "max_bytes": 0})
    s["count"] += 1
    s["total_bytes"] += int(nbytes)
    s["max_bytes"] = max(s["max_bytes"], int(nbytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ppermute(x: torch.Tensor, mesh, pairs: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """lax.ppermute over the mesh's spatial axis: for every (src, dst)
    pair of spatial indices, src's `x` arrives at dst.  A rank that
    receives nothing gets zeros (as in XLA).  Returns the received
    tensor."""
    x = x.contiguous()
    me = mesh.spatial_index
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, mesh.spatial_ranks[dst],
                                  group=mesh.spatial_group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, mesh.spatial_ranks[src],
                                  group=mesh.spatial_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _note("collective-permute", _nbytes(x))
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """psum / pmax over the mesh's spatial group: a reduced copy of `x`
    (x itself is left as it was)."""
    y = x.clone().contiguous()
    dist.all_reduce(y, _OPS[op], group=mesh.spatial_group)
    _note("all-reduce", _nbytes(y))
    return y


def all_to_all(x: torch.Tensor, mesh, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """lax.all_to_all(tiled=True) over the mesh's spatial group: `x` is
    cut into n equal chunks along split_dim, chunk j goes to spatial
    rank j, and the chunks received are concatenated along concat_dim
    in rank order."""
    n = mesh.spatial
    split_dim %= x.ndim
    concat_dim %= x.ndim
    chunks = x.movedim(split_dim, 0)
    size = chunks.shape[0] // n
    send = chunks.reshape((n, size) + tuple(chunks.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.spatial_group)
    # recv[j]: rank j's chunk for this rank, laid out as x's chunk
    parts = [recv[j].movedim(0, split_dim) for j in range(n)]
    out = torch.cat(parts, dim=concat_dim)
    _note("all-to-all", _nbytes(out))
    return out


def all_gather(x: torch.Tensor, mesh, dim: int,
               group: str = "spatial") -> torch.Tensor:
    """Every rank's `x` of the mesh's spatial group (or, with
    group="mesh", of the whole mesh), concatenated along `dim` in rank
    order."""
    x = x.contiguous()
    pg = mesh.spatial_group if group == "spatial" else mesh.group
    n = dist.get_world_size(pg)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=pg)
    out = torch.cat(parts, dim=dim)
    _note("all-gather", _nbytes(out))
    return out

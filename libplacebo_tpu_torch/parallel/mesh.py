"""Device meshes on torch.distributed: one process (rank) a device.

Counterpart of libplacebo_tpu/parallel/mesh.py.  A mesh is
(data, spatial): frames are split over 'data', the rows of each frame
over 'spatial'.  Rank r of the mesh's group sits at data index
r // spatial and spatial index r % spatial; each data index has its own
spatial sub-group, which carries the row halos and the frame-global
reductions.  Arrays are local: where the reference holds global sharded
arrays, the port's sharded step takes and returns this rank's blocks.

Under torchrun (one process a card, e.g. `torchrun --nproc-per-node 4
app.py`), `make_mesh(data=1, spatial=4)` joins the group torchrun's
environment describes and renders on `cuda:{LOCAL_RANK}`.  A process
alone (no default group, a world of one) gets a one-rank group on an
in-memory store: NCCL on the card, gloo on the CPU — no network.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm

__all__ = ["Mesh", "make_mesh", "shard_frame_batch"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A (data, spatial) mesh of ranks, seen from one rank: its device,
    its coordinates, the mesh's group, this rank's spatial sub-group and
    the global ranks of that sub-group in row order."""

    def __init__(self, data: int, spatial: int, device: torch.device,
                 group, spatial_group, spatial_ranks: Sequence[int],
                 rank: int, owns_group: bool):
        self.data = data
        self.spatial = spatial
        self.device = device
        self.group = group
        self.spatial_group = spatial_group
        self.spatial_ranks = tuple(spatial_ranks)
        self.rank = rank
        self.data_index = rank // spatial
        self.spatial_index = rank % spatial
        self._owns_group = owns_group

    @property
    def shape(self) -> dict:
        return {"data": self.data, "spatial": self.spatial}

    # the collectives, over this rank's spatial group (parallel/comm.py)
    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return comm.all_reduce(x, self, op)

    def close(self) -> None:
        """Destroy the one-rank group make_mesh started, if it did."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __repr__(self):
        return (f"Mesh(data={self.data}, spatial={self.spatial}, "
                f"rank={self.rank}, device={self.device})")


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass "
                               "device='cpu' for a gloo mesh on the CPU)")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type not in _BACKEND:
        raise ValueError(f"make_mesh: unsupported device {device}")
    return device


def make_mesh(data: int = 1, spatial: Optional[int] = None, device=None,
              group=None) -> Mesh:
    """This rank's view of a (data, spatial) mesh over `group` (default:
    the default process group).

    device: this rank's device; None = `cuda:{LOCAL_RANK}`, "cpu" for a
    gloo mesh.  Without a default group and with a world of one
    (WORLD_SIZE unset or 1), a one-rank group is started on a HashStore
    (NCCL for the card, gloo for the CPU); with WORLD_SIZE > 1 the group
    is initialized from the environment torchrun sets.  The backend must
    fit the device (NCCL: CUDA, gloo: CPU); a mismatch raises — there is
    no fallback.  Every rank must call make_mesh with the same arguments,
    in the same order (it creates the spatial sub-groups)."""
    device = _device(device)
    backend = _BACKEND[device.type]
    owns = False
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("make_mesh: a group without a default "
                             "process group")
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1,
                                    timeout=timedelta(seconds=300))
            owns = True
        else:
            dist.init_process_group(backend)
    pg = group if group is not None else dist.group.WORLD
    have = dist.get_backend(pg)
    if have != backend:
        raise ValueError(f"make_mesh: the process group's backend {have!r} "
                         f"does not fit {device} (needs {backend!r})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    n = dist.get_world_size(pg)
    if spatial is None:
        spatial = n // data
    if data < 1 or spatial < 1 or data * spatial != n:
        raise ValueError(f"make_mesh: data {data} x spatial {spatial} != "
                         f"{n} ranks")
    rank = dist.get_rank(pg)
    glob = [dist.get_global_rank(pg, r) if pg is not dist.group.WORLD
            else r for r in range(n)]
    rows = [glob[d * spatial:(d + 1) * spatial] for d in range(data)]
    mine = rows[rank // spatial]
    if data == 1:
        # the mesh's group is the one spatial group
        sp_group = pg
    else:
        sp_group, _ = dist.new_subgroups_by_enumeration(rows,
                                                        backend=backend)
    return Mesh(data, spatial, device, pg, sp_group, mine, rank, owns)


def shard_frame_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's block of a global (B, C, H, W) frame batch: its data
    index's B / data frames and its spatial index's H / spatial rows, on
    the mesh's device."""
    b = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch)
    B, H = b.shape[0], b.shape[-2]
    if B % mesh.data or H % mesh.spatial:
        raise ValueError(f"shard_frame_batch: {tuple(b.shape)} does not "
                         f"split over {mesh.shape}")
    bl, hl = B // mesh.data, H // mesh.spatial
    d, s = mesh.data_index, mesh.spatial_index
    return b[d * bl:(d + 1) * bl, ..., s * hl:(s + 1) * hl, :].to(
        mesh.device).contiguous()

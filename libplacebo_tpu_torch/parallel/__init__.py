"""Several devices: meshes, row-split frames, halo exchange.

Counterpart of libplacebo_tpu/parallel/ on torch.distributed, one
process (rank) a device: frames split over a mesh's 'data' axis, the
rows of each frame over its 'spatial' axis; scaler footprints exchange
row halos between ring neighbors (batch_isend_irecv), the peak
histogram finishes with all-reduces, and what the halo pipeline cannot
express renders replicated.  NCCL carries CUDA tensors, gloo CPU ones.
"""

from .mesh import Mesh, make_mesh, shard_frame_batch  # noqa: F401
from .spatial import sharded_render_step  # noqa: F401
from .renderer import (build_sharded_pipeline, gather_rows,  # noqa: F401
                       shard_planes, sharded_render_mix, sharded_state_init)

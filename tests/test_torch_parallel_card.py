"""The port's multi-device layer without the JAX package (this file
imports neither it nor JAX, so it runs where the card is): on the CPU,
a one-rank gloo mesh's halo step and the demo shim against the
single-device renderer; on the card, a one-rank NCCL mesh's halo step
with K1 in its tail against the single-card renderer."""
import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.parallel import (build_sharded_pipeline,
                                           make_mesh, shard_frame_batch,
                                           shard_planes,
                                           sharded_render_step,
                                           sharded_state_init)

import torch_parallel_ranks as tpr

_SPEC = dict(h=64, w=128, tw=256, th=128, bits=8, seed=0, per_lane=2,
             params=dict(upscaler="ewa_lanczos",
                         peak_detect=dict(percentile=99.5)))


def _halo_flagship(mesh, device):
    """The flagship's halo step on `mesh` and the single-device renders
    of the same frames."""
    ob = tpr.objects(tpr.port_ns(), _SPEC, 1)
    frames = [lt.frame_from_yuv420p(*yuv, color=lt.CSP_BT2100_PQ,
                                    repr=ob["frames"][0].repr, device=device)
              for yuv in tpr.flagship_yuv(2, _SPEC["h"], _SPEC["w"], 0)]
    f0 = frames[0]
    step = build_sharded_pipeline(mesh, f0.meta_key()[0], f0.repr,
                                  f0.color, ob["target"], ob["params"])
    assert step.route == "halo", step.reason
    planes = [torch.stack([f.planes[i].data for f in frames])
              for i in range(len(f0.planes))]
    out, _ = step(sharded_state_init(mesh, 2), *shard_planes(mesh, planes))
    refs = [lt.Renderer(device=device).render(f, ob["target"], ob["params"])
            for f in frames]
    return out, refs


def test_one_rank_gloo_mesh_halo_flagship_matches_single_device():
    """A process alone: make_mesh(device="cpu") starts a one-rank gloo
    group; the halo step equals the single-device render bit for bit."""
    mesh = make_mesh(device="cpu")
    try:
        assert mesh.shape == {"data": 1, "spatial": 1}
        out, refs = _halo_flagship(mesh, "cpu")
        for b, ref in enumerate(refs):
            assert torch.equal(out[b], ref), b
    finally:
        mesh.close()


def test_sharded_render_step_shim_and_frame_batch():
    """parallel.spatial's demo step on a one-rank gloo mesh: full-range
    RGB frames in, the renderer's image of each out; shard_frame_batch
    keeps the one rank's whole batch."""
    mesh = make_mesh(device="cpu")
    try:
        rng = np.random.default_rng(0)
        batch = rng.random((2, 3, 32, 64)).astype(np.float32)
        x = shard_frame_batch(mesh, batch)
        assert torch.equal(x, torch.from_numpy(batch))
        run = sharded_render_step(mesh, 32, 64, 64, 128, bit_depth=0)
        out = run(x)
        assert out.shape == (2, 3, 64, 128) and run.step.route == "halo"
        assert bool(torch.isfinite(out).all())
        again = run(x)
        assert torch.equal(out, again)
    finally:
        mesh.close()


@pytest.mark.cuda
def test_one_rank_nccl_mesh_halo_flagship_matches_single_card():
    """On the card: GpuContext.make_mesh() starts a one-rank NCCL group;
    the halo step renders the flagship with K1 in each frame's tail
    (launches counted) within one LSB of the single-card renderer on
    <= 1e-3 of the values, none beyond."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist
    from libplacebo_tpu_torch import runtime
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    mesh = runtime.create().make_mesh()
    try:
        assert dist.get_backend(mesh.group) == "nccl"
        k1.launches = 0
        out, refs = _halo_flagship(mesh, "cuda")
        torch.cuda.synchronize()
        assert k1.launches == 4          # 2 sharded + 2 single-card tails
        for b, ref in enumerate(refs):
            d = (out[b] - ref).abs()
            assert float(d.max()) <= tpr.LSB + 1e-6
            assert float((d > 1e-6).float().mean()) <= 1e-3
    finally:
        mesh.close()

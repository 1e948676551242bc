"""PyTorch port: mpv .hook user shaders on the device they are given,
without the JAX package (this file imports neither it nor JAX, so it
runs where the card is): a warm frame of a hook uploads nothing and adds
nothing to the hook's memo (on the CPU here), and, on the card, path J's
two hooks against their CPU runs, the warm frame under sync debug mode.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from libplacebo_tpu_torch.render import hooks as thooks
from libplacebo_tpu_torch.render import mpv_hooks as tm

# (shader, stage, input, run_hooks context): path J's two hooks small
_CASES = (
    (chip_smoke.path_j_ravu_shader(chip_smoke.path_j_lut()), "LUMA_INPUT",
     np.random.default_rng(3).random((1, 24, 40)).astype(np.float32),
     dict(dst_w=80, dst_h=48)),
    (chip_smoke.path_j_ema_shader(37, 24), "RGB",
     np.random.default_rng(4).random((3, 24, 37)).astype(np.float32), {}))


def _run(h, stage, x, ctx):
    return thooks.run_hooks([h], thooks.HookStage[stage], x, set(), **ctx)


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_warm_frame_uploads_nothing(case):
    """What the host computes from positions, invocation IDs and sizes is
    made and uploaded once: a second frame of the same size makes no
    upload, adds nothing to the hook's memo and gives the same image."""
    text, stage, img, ctx = _CASES[case]
    h = tm.user_shader_hook(text)
    x = torch.from_numpy(img)
    first = _run(h, stage, x, ctx)
    uploads, memo = h.cache.uploads, len(h.cache.host)
    assert uploads > 0
    again = _run(h, stage, x, ctx)
    assert h.cache.uploads == uploads and len(h.cache.host) == memo
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_path_j_hooks_on_the_card(case):
    """Path J's hooks on the card against the CPU, small: within 1e-5
    (CUDA divides by a host float as a product with its reciprocal, one
    ulp); the warm frame synchronizes nowhere and uploads nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hooks' device path")
    text, stage, img, ctx = _CASES[case]
    outs = {}
    for dev in ("cpu", "cuda"):
        h = tm.user_shader_hook(text)
        x = torch.from_numpy(img).to(dev)
        _run(h, stage, x, ctx)
        uploads = h.cache.uploads
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs[dev] = _run(h, stage, x, ctx)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        assert h.cache.uploads == uploads
    np.testing.assert_allclose(outs["cuda"].cpu().numpy(),
                               outs["cpu"].numpy(), rtol=0, atol=1e-5)

"""The port's multi-device layer against the JAX package, part 3: user
hooks on the halo pipeline, the replicated step and the frame mix, on a
(1, 2) mesh of gloo ranks (CPU): a bounded-stencil sharpen, a
//!COMPUTE shared-tile hook and a temporal STORAGE-state hook on the
halo step (O(halo) traffic); a two-pass blur the plan rejects, error
diffusion and a partial row crop on the replicated step (bit for bit
against the single device; one source frame gathered a frame); and
sharded_render_mix threading a stateful hook's value.

Gates: tests/torch_parallel_ranks.py.  `jax_tol` is the reference's
own bound for its leg in tests/test_parallel.py.
"""
import pytest

import tests.test_mpv_hooks as jmh
import tests.test_parallel as jtp
import torch_parallel_jax as tpj

MESH = (1, 2)
_BASE = dict(h=64, w=96, tw=192, th=128, bits=0, route="halo")


def _spec(**kw):
    d = dict(_BASE)
    d.update(kw)
    return d


_GAIN_SHADER = """\
//!BUFFER st
//!STORAGE
//!VAR float gain

//!HOOK MAIN
//!BIND HOOKED
//!DESC carried-gain scale
vec4 hook()
{
    vec4 c = HOOKED_texOff(0);
    gain = gain + 0.125;
    return c * (1.0 / (1.0 + 0.2 * gain));
}
"""

SPECS = {
    "sharpen_halo": _spec(seed=61, per_lane=2,
                          hooks=[jtp.SHARPEN_HOOK_TEXT],
                          params=dict(upscaler="lanczos"),
                          bounds=["no_gather", "permute_quarter",
                                  "reduce_small"]),
    "compute_hook_halo": _spec(seed=52, hooks=[jtp.COMPUTE_TILE_HOOK_TEXT],
                               params=dict(upscaler="lanczos"),
                               bounds=["no_gather"], jax_tol=3e-3),
    "temporal_state_halo": _spec(
        kind="temporal_hook", seed=101, h=32, w=48, tw=48, th=32,
        hooks=[jmh.TEMPORAL_EMA_SHADER],
        params=dict(peak_detect=None), bounds=["no_gather"],
        jax_tol=5e-3),
    "two_pass_hook_replicated": _spec(
        seed=62, route="replicated", hooks=[jtp.TWO_PASS_BLUR_HOOK_TEXT],
        params=dict(upscaler="lanczos"), jax_tol=3e-2),
    "error_diffusion_replicated": _spec(
        seed=9, bits=8, route="replicated",
        params=dict(upscaler="lanczos", peak_detect=None,
                    error_diffusion="floyd-steinberg"),
        bounds=["gather_one_frame"], jax_tol=2 / 255 + 1e-6,
        # ROADMAP §3's error-diffusion record: 7-9% of values differ
        # end to end, <= 4.1e-5 by more than one LSB
        jax_fracs=(0.12, 1e-4)),
    "indivisible_rows_replicated": _spec(
        seed=59, h=60, tw=128, th=96, route="replicated",
        crop=(4, 6, 68, 54), params=dict(upscaler="lanczos"),
        jax_tol=5e-3),
    "frame_mix_stateful": _spec(
        kind="mix", seed=88, h=32, w=48, tw=48, th=32, bits=8, per_lane=3,
        hooks=[_GAIN_SHADER], timestamps=[-0.6, 0.4, 1.4],
        params=dict(peak_detect=None, frame_mixer="oversample")),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tpj.run_file(SPECS, *MESH, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", list(SPECS))
def test_case(results, name):
    tpj.case_result(results, name)

"""The port's multi-device layer against the JAX package, part 2: the
per-plane features, presentation and rotation on the halo pipeline, on
a (1, 4) mesh of gloo ranks (CPU): deband (ring-wrap halos), AV1 and
H.274 grain (the plane's block rows), temporal deinterlacing (reflect
halos, the frame's field parity), contrast recovery (the feature map's
own halos), a conversion LUT with cone distortion and color adjustment,
overlays across block boundaries, a target sub-rect with corner
rounding (the outer stage), target blending, the 180-degree rotation
(ring reversal) and the 90/270 ones (one all-to-all; without a rotated
crop, the replicated step).

Gates: tests/torch_parallel_ranks.py.  Where the reference's own
sharded leg is not bit-exact against its single chip, the spec's
`jax_tol` is that leg's bound in tests/test_parallel.py.
"""
import pytest

import torch_parallel_jax as tpj

MESH = (1, 4)
_BASE = dict(h=64, w=96, tw=192, th=128, bits=0, route="halo")


def _spec(**kw):
    d = dict(_BASE)
    d.update(kw)
    return d


SPECS = {
    "deband": _spec(seed=11, params=dict(
        upscaler="lanczos",
        deband=dict(radius=2.0, iterations=2, grain=6.0))),
    "av1_grain": _spec(seed=12, grain="av1",
                       params=dict(upscaler="lanczos")),
    "h274_grain": _spec(seed=21, grain="h274",
                        params=dict(upscaler="lanczos")),
    "deinterlace": _spec(seed=14, tw=96, th=64, deinterlace=True,
                         params=dict(deinterlace="YADIF"),
                         # tests/test_parallel.py's deinterlace bound
                         jax_tol=1e-3),
    "contrast_recovery": _spec(seed=13, params=dict(
        upscaler="ewa_lanczos", peak_detect=dict(percentile=99.5),
        contrast_recovery=0.35, contrast_smoothness=4.0),
        jax_tol=2e-3, halo_loose=(5e-3, 2e-3)),
    "lut_cone_adjustment": _spec(seed=17, params=dict(
        upscaler="lanczos", lut=True, lut_type="conversion",
        cone=("M", 0.4), color_adjustment=dict(
            brightness=0.02, contrast=1.1, saturation=1.2, hue=0.1))),
    "overlays": _spec(seed=23, bits=8, params=dict(upscaler="lanczos"),
                      overlays=[((4, 12, 40), (10, 20, 70, 60)),
                                ((4, 8, 16), (100, 5, 124, 21))]),
    "target_subrect_corner": _spec(
        seed=29, bits=8, tw=256, th=192, target_crop=(32, 24, 224, 152),
        overlays=[((4, 10, 30), (5, 100, 95, 130))],
        params=dict(upscaler="lanczos", background="tiles",
                    corner_rounding=0.15)),
    "target_blend": _spec(seed=41, bits=8, target_data=True, params=dict(
        upscaler="lanczos", blend=("one", "one", "one", "zero"))),
    "target_blend_outer": _spec(
        seed=43, bits=8, tw=256, th=192, target_crop=(32, 24, 224, 152),
        target_data=True, params=dict(
            upscaler="lanczos", background="tiles",
            blend=("one", "one", "one", "zero"))),
    "rotation180": _spec(seed=31, rotation=2,
                         params=dict(upscaler="lanczos")),
    # a rotated-space crop: the halo pipeline (local rot90, all-to-all)
    "rotation90_halo": _spec(seed=81, rotation=1, crop=(0, 0, 64, 96),
                             tw=128, th=192, params=dict(upscaler="lanczos"),
                             bounds=["rot90_block"]),
    "rotation270_halo": _spec(seed=83, rotation=3, crop=(0, 0, 64, 96),
                              tw=128, th=192,
                              params=dict(upscaler="lanczos"),
                              bounds=["rot90_block"]),
    # the unrotated default crop: the replicated step
    "rotation90_replicated": _spec(seed=38, rotation=1, tw=128, th=192,
                                   route="replicated",
                                   params=dict(upscaler="lanczos"),
                                   jax_tol=5e-3),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tpj.run_file(SPECS, *MESH, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", list(SPECS))
def test_case(results, name):
    tpj.case_result(results, name)

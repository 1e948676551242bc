"""The port's multi-device layer (libplacebo_tpu_torch/parallel/) against
the JAX package's, part 1: the mesh, the halo exchange, the sharded peak
detection and the halo pipeline's flagship, on a (2, 2) mesh of gloo
ranks (CPU).

The JAX references run once in this process on its 8 virtual devices;
the port's four ranks run in processes of their own
(tests/torch_parallel_ranks.py, no jax there) and report each case.
The gates are the rank module's (its docstring); measured here:
the flagship within one LSB of the single-device render on no value
beyond it, the state within 1e-6 of the whole-frame detection.
"""
import os
import subprocess
import sys

import pytest

import tests.test_parallel as jtp
import torch_parallel_jax as tpj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2)

SPECS = {
    "extend_rows": dict(kind="extend_rows", seed=5),
    # 48 rows split 2 ways: 24-row blocks, not a multiple of the 16-row
    # tile (the reference's tiling is per shard); 64 rows: 32-row blocks
    "detect_peak": dict(kind="detect_peak", rows=[48, 64]),
    "flagship": dict(h=64, w=96, tw=192, th=128, bits=8, seed=0,
                     per_lane=2, route="halo",
                     params=dict(upscaler="ewa_lanczos",
                                 peak_detect=dict(percentile=99.5)),
                     bounds=["no_gather", "permute_quarter",
                             "reduce_small"]),
    "antiring": dict(h=64, w=96, tw=192, th=128, bits=0, seed=63,
                     route="halo",
                     params=dict(upscaler="lanczos",
                                 antiringing_strength=0.7)),
    "st2094": dict(h=64, w=96, tw=192, th=128, bits=0, seed=61,
                   route="halo",
                   params=dict(upscaler="lanczos",
                               tone_mapping_function="st2094-40",
                               peak_detect=dict(percentile=99.5))),
    "sdr_sigmoid": dict(h=64, w=96, tw=192, th=128, bits=0, seed=3,
                        route="halo", hdr=False, system="BT_709",
                        params=dict(upscaler="lanczos")),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tpj.run_file(SPECS, *MESH, tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", list(SPECS))
def test_case(results, name):
    tpj.case_result(results, name)


def test_port_parallel_imports_no_jax():
    """The package and every parallel module import with jax blocked."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import libplacebo_tpu_torch.parallel as p\n"
            "from libplacebo_tpu_torch.parallel import (mesh, halo, comm,"
            " analysis, renderer, hook_halo, spatial)\n"
            "assert not any(m == 'libplacebo_tpu' or "
            "m.startswith('libplacebo_tpu.') for m in sys.modules)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_make_mesh_defaults_to_the_card_and_checks_the_backend():
    """make_mesh() asks for the card (no CPU fallback); a gloo group
    with a CUDA device, the wrong pair, raises."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from libplacebo_tpu_torch.parallel import make_mesh\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        make_mesh(); raise SystemExit('no error')\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e)\n"
        "dist.init_process_group('gloo', store=dist.HashStore(), rank=0,"
        " world_size=1)\n"
        "try:\n"
        "    make_mesh(device='cuda'); raise SystemExit('no error')\n"
        "except ValueError as e:\n"
        "    assert 'nccl' in str(e), e\n"
        "m = make_mesh(device='cpu')\n"
        "assert m.shape == {'data': 1, 'spatial': 1}\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


HOOK_CASES = {
    "sharpen": [jtp.SHARPEN_HOOK_TEXT],
    "compute_tile": [jtp.COMPUTE_TILE_HOOK_TEXT],
    "two_pass": [jtp.TWO_PASS_BLUR_HOOK_TEXT],
    "two_sharpens": [jtp.SHARPEN_HOOK_TEXT, jtp.SHARPEN_HOOK_TEXT],
    "doubler": ["//!HOOK LUMA\n//!BIND HOOKED\n//!WIDTH LUMA.w 2 *\n"
                "//!HEIGHT LUMA.h 2 *\n"
                "vec4 hook() { return HOOKED_tex(HOOKED_pos); }\n"],
    "vignette": ["//!HOOK LUMA\n//!BIND HOOKED\nvec4 hook() {\n"
                 "    vec2 d = HOOKED_pos - vec2(0.5, 0.5);\n"
                 "    return HOOKED_texOff(0) * (1.0 - dot(d, d));\n}\n"],
    # tests/test_parallel.py::test_hook_halo_state_structural_gates
    "four_arg_compute": [
        "//!HOOK LUMA\n//!BIND HOOKED\n//!COMPUTE 16 16 8 8\n"
        "void hook() {\n"
        "    ivec2 pos = ivec2(gl_GlobalInvocationID.xy) * 2;\n"
        "    vec4 c = HOOKED_tex((vec2(pos) + vec2(0.5)) * HOOKED_pt);\n"
        "    imageStore(out_image, pos, 0.5 * c);\n"
        "    imageStore(out_image, pos + ivec2(1, 0), 0.5 * c);\n"
        "    imageStore(out_image, pos + ivec2(0, 1), 0.5 * c);\n"
        "    imageStore(out_image, pos + ivec2(1, 1), 0.5 * c);\n}\n"],
    "tiny_state": [
        "//!TEXTURE ACC\n//!SIZE 8 8\n//!FORMAT rgba32f\n//!STORAGE\n\n"
        "//!HOOK LUMA\n//!BIND HOOKED\n//!BIND ACC\nvec4 hook() {\n"
        "    vec4 prev = imageLoad(ACC, ivec2(0, 0));\n"
        "    imageStore(ACC, ivec2(0, 0), HOOKED_texOff(0));\n"
        "    return HOOKED_texOff(0) + 0.0 * prev;\n}\n"],
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_plan_halo_hooks_matches_the_reference(case):
    """plan_halo_hooks' verdict and footprints equal the JAX plan's."""
    from libplacebo_tpu.render.mpv_hooks import user_shader_hook as jhook
    from libplacebo_tpu.render.renderer import RenderParams as JParams
    from libplacebo_tpu.parallel.hook_halo import plan_halo_hooks as jplan
    import libplacebo_tpu_torch as lt
    from libplacebo_tpu_torch.parallel.hook_halo import plan_halo_hooks
    import torch_parallel_ranks as tpr
    texts = HOOK_CASES[case]
    jf = tpr.objects(tpj.NS, dict(h=64, w=96, tw=192, th=128, seed=1,
                                  params={}), 1)["frames"][0]
    tf = tpr.objects(tpr.port_ns(), dict(h=64, w=96, tw=192, th=128,
                                         seed=1, params={}), 1)["frames"][0]
    jp = jplan(JParams(hooks=tuple(jhook(t) for t in texts)),
               jf.meta_key()[0], jf.repr.sys, 64, 96, 192, 128, 4)
    tp = plan_halo_hooks(lt.RenderParams(hooks=tuple(
        lt.user_shader_hook(t) for t in texts)), tf.meta_key()[0],
        tf.repr.sys, 64, 96, 192, 128, 4)
    assert (jp is None) == (tp is None), (jp, tp)
    if jp is not None:
        assert {k.name: v["F"] for k, v in tp.items() if k != "__sizes__"} \
            == {k.name: v["F"] for k, v in jp.items() if k != "__sizes__"}
        assert {k.name: v for k, v in tp["__sizes__"].items()} == \
            {k.name: v for k, v in jp["__sizes__"].items()}

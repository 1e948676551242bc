"""The GPU-vs-JAX gate (tools/gpu_vs_cpu.py) on the CPU: the port's plain
path against the JAX package's renders committed as fixtures, at the
gate's thresholds; the fixtures re-rendered through the JAX package to
show they are not stale; path I at a small size against the JAX package
directly; and, on the card, the gate itself."""
import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gpu_vs_cpu", os.path.join(REPO, "tools", "gpu_vs_cpu.py"))
gvc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gvc)


def test_fixtures_hold_the_inputs_and_stay_small():
    fx = np.load(gvc.FIXTURES)
    assert int(fx["seed"]) == 7 and tuple(fx["size"]) == (96, 192)
    assert set(gvc.PRESETS) <= set(fx.files)
    assert os.path.getsize(gvc.FIXTURES) < 2 * 2 ** 20
    for p in gvc.PRESETS:
        want = np.uint8 if p in gvc.EIGHT_BIT else np.uint16
        assert fx[p].dtype == want, p


@pytest.mark.parametrize("preset", gvc.PRESETS)
def test_port_cpu_path_passes_the_gate(preset):
    """The port's CPU render of each preset against the JAX fixture:
    PSNR >= 45 dB and the preset's LSB guard (tools/tpu_vs_cpu.py's)."""
    fx = np.load(gvc.FIXTURES)
    h, w = (int(v) for v in fx["size"])
    got, launches = gvc.port_render(preset, h, w, int(fx["seed"]), "cpu")
    line, ok = gvc.compare(preset, fx[preset], got)
    assert ok, line
    assert line["psnr_db"] >= 45.0
    # the plain versions run on the CPU: no kernel launch is counted
    assert launches == {"k1": 0, "k2": 0, "k3": 0}
    if preset == "ed_kernel":
        assert line["bit_exact"], line


def test_fixtures_are_not_stale():
    """One preset re-rendered through the JAX package equals the
    committed fixture code for code."""
    fx = np.load(gvc.FIXTURES)
    h, w = (int(v) for v in fx["size"])
    out = gvc._jax_render("sep", h, w, int(fx["seed"]))
    np.testing.assert_array_equal(gvc._encode("sep", out), fx["sep"])


def test_path_i_small_matches_the_reference():
    """Path I at a small size (a 2-frame 64x256 clip to 32x128): y4m
    written, read raw, mapped as an AVFrame with HDR10 side data,
    rendered with RenderParams() to 8-bit BT.709, encoded and written,
    in both packages; the output codes within 1 LSB everywhere and
    differing on fewer than 1e-3 of them (the flagship's gate for K1's
    plain tails)."""
    ref = gvc._jax_render("path_i", 16, 64, 3)
    got, _ = gvc.port_render("path_i", 16, 64, 3, "cpu")
    head_r, r = gvc._y4m_planes(np.asarray(ref).tobytes())
    head_g, g = gvc._y4m_planes(np.asarray(got).tobytes())
    assert head_r == head_g == b"YUV4MPEG2 W128 H32 F24000:1001 Ip A0:0 " \
                               b"C420jpeg"
    d = np.abs(r.astype(np.int64) - g.astype(np.int64))
    assert r.size == 2 * 128 * 32 * 3 // 2
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                     (d > 0).mean())


@pytest.mark.cuda
def test_gate_on_the_card():
    """Every preset rendered by the port on the card against the JAX
    fixtures, at the gates (chip_smoke.py phase 21 runs the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    lines, ok = gvc.run("cuda")
    assert ok, lines
    by = {line["preset"]: line for line in lines}
    assert by["ed_kernel"]["bit_exact"]
    assert by["sep"]["launches"]["k1"] == 1
    assert by["config5_ed"]["launches"] == {"k1": 1, "k2": 1, "k3": 2}
